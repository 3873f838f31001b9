"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (CUDA C++ in ``repro_torch/csrc``, built by ``_nvcc``):
``moe_gemm`` holds the grouped SwiGLU expert FFN and its packed-weight
twin that dequantizes in registers, ``flash_decode`` the single-token
GQA decode attention over a ring-buffer cache, ``ssd_scan`` the Mamba2
inter-chunk state recurrence, ``int8_matmul`` the w8a16 dequantizing
matmul, which, as in the JAX package, no model path calls.  The four
families are exported here as ``repro.kernels`` exports them."""
from .flash_decode import flash_decode, flash_decode_kernel, flash_decode_ref
from .int8_matmul import int8_matmul, int8_matmul_kernel, int8_matmul_ref
from .moe_gemm import (combine_topk, grouped_topk_contrib, grouped_topk_contrib_packed, moe_ffn,
                       moe_ffn_kernel, moe_ffn_packed, moe_ffn_packed_kernel, moe_ffn_ref)
from .ssd_scan import ssd_scan, ssd_scan_kernel, ssd_scan_ref

__all__ = [
    "flash_decode", "flash_decode_kernel", "flash_decode_ref",
    "int8_matmul", "int8_matmul_kernel", "int8_matmul_ref",
    "combine_topk", "grouped_topk_contrib", "grouped_topk_contrib_packed",
    "moe_ffn", "moe_ffn_kernel", "moe_ffn_packed",
    "moe_ffn_packed_kernel", "moe_ffn_ref",
    "ssd_scan", "ssd_scan_kernel", "ssd_scan_ref",
]
