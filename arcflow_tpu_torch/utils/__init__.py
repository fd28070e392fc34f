from .io_utils import (get_file_backend, is_node_local_rank_zero, load_image,
                       local_file, register_backend, retry, save_image,
                       save_image_grid, uri_scheme)
from .quantize import (dequantize_weights, pack_int4, quantize_weights_int4,
                       unpack_int4)

__all__ = ['dequantize_weights', 'get_file_backend',
           'is_node_local_rank_zero', 'load_image', 'local_file',
           'pack_int4', 'quantize_weights_int4', 'register_backend', 'retry',
           'save_image', 'save_image_grid', 'uri_scheme', 'unpack_int4']
