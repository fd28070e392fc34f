from .checkerboard import CheckerboardData

__all__ = ['CheckerboardData']
