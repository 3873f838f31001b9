from .kernel import moe_ffn_kernel
from .ops import (combine_topk, grouped_topk_contrib, grouped_topk_contrib_packed, moe_ffn,
                  moe_ffn_packed)
from .packed import moe_ffn_packed_kernel, moe_ffn_packed_ref, packed_logical_f
from .ref import moe_ffn_ref

__all__ = ["combine_topk", "grouped_topk_contrib", "grouped_topk_contrib_packed",
           "moe_ffn", "moe_ffn_kernel", "moe_ffn_packed", "moe_ffn_packed_kernel",
           "moe_ffn_packed_ref", "moe_ffn_ref", "packed_logical_f"]
