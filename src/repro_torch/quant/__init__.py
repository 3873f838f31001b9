from .quantize import (NF4_BLOCK, NF4_LEVELS, dequantize, pack_nf4_codes, quantize,
                       quantize_pytree, shadow_nbytes, shadow_params,
                       simulate_quantization, unpack_nf4_codes)
from .transport import (SCHEMES, PackedWeight, PrecisionPolicy, TransportCodec,
                        UniformPolicy, get_codec, resolve_policy, transport_params)

__all__ = ["NF4_BLOCK", "NF4_LEVELS", "dequantize", "pack_nf4_codes", "quantize",
           "quantize_pytree", "shadow_nbytes", "shadow_params",
           "simulate_quantization", "unpack_nf4_codes", "SCHEMES", "PackedWeight",
           "PrecisionPolicy", "TransportCodec", "UniformPolicy", "get_codec",
           "resolve_policy", "transport_params"]
