from .quantize import (NF4_BLOCK, NF4_LEVELS, dequantize, dequantize_tiles,
                       nf4_pair_unpack, pack_nf4_codes, quantize, quantize_pytree,
                       shadow_nbytes, shadow_params, simulate_quantization,
                       unpack_nf4_codes)
from .transport import (SCHEMES, PackedWeight, PrecisionPolicy, TieredPolicy,
                        TransportCodec, UniformPolicy, device_layout,
                        expert_weight_shapes, get_codec, resolve_policy, tileable,
                        transport_expert_bytes, transport_params)

__all__ = ["NF4_BLOCK", "NF4_LEVELS", "dequantize", "dequantize_tiles",
           "nf4_pair_unpack", "pack_nf4_codes", "quantize", "quantize_pytree",
           "shadow_nbytes", "shadow_params", "simulate_quantization",
           "unpack_nf4_codes", "SCHEMES", "PackedWeight", "PrecisionPolicy",
           "TieredPolicy", "TransportCodec", "UniformPolicy", "device_layout",
           "expert_weight_shapes", "get_codec", "resolve_policy", "tileable",
           "transport_expert_bytes", "transport_params"]
