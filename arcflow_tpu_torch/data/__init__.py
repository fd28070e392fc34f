from .builder import build_dataloader, build_dataset, collate
from .checkerboard import CheckerboardData
from .image_prompts import ImagePrompt, load_datalist
from .imagenet import ImageNet, adm_center_crop
from .prefetch import Prefetcher, batched_index_loader
from .samplers import BucketizedBatchSampler, build_bucketized_loader

__all__ = ['BucketizedBatchSampler', 'CheckerboardData', 'ImageNet',
           'ImagePrompt', 'adm_center_crop',
           'Prefetcher', 'batched_index_loader', 'build_bucketized_loader',
           'build_dataloader', 'build_dataset', 'collate', 'load_datalist']
