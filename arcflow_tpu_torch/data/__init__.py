from .builder import build_dataloader, build_dataset, collate
from .checkerboard import CheckerboardData
from .prefetch import Prefetcher

__all__ = ['CheckerboardData', 'Prefetcher', 'build_dataloader',
           'build_dataset', 'collate']
