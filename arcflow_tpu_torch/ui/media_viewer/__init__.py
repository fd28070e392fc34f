from .grid_tools import grid_html, write_media_grid

__all__ = ['grid_html', 'write_media_grid']
