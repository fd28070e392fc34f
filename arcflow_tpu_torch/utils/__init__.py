from .quantize import (dequantize_weights, pack_int4, quantize_weights_int4,
                       unpack_int4)

__all__ = ['dequantize_weights', 'pack_int4', 'quantize_weights_int4',
           'unpack_int4']
