from .kernel import moe_ffn_kernel
from .ops import combine_topk, grouped_topk_contrib, moe_ffn
from .ref import moe_ffn_ref

__all__ = ["combine_topk", "grouped_topk_contrib", "moe_ffn", "moe_ffn_kernel",
           "moe_ffn_ref"]
