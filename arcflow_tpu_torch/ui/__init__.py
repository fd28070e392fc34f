"""User interfaces: the gradio text-to-image app (``gradio_app``, gradio
imported when the app is built) and the static media grid viewer."""

from .media_viewer.grid_tools import grid_html, write_media_grid

__all__ = ['grid_html', 'write_media_grid']
