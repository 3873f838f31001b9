"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (CUDA C++ in ``repro_torch/csrc``, built by ``_nvcc``):
``moe_gemm`` holds the grouped SwiGLU expert FFN and its packed-weight
twin that dequantizes in registers, ``flash_decode`` the single-token
GQA decode attention over a ring-buffer cache, ``ssd_scan`` the Mamba2
inter-chunk state recurrence, ``int8_matmul`` the w8a16 dequantizing
matmul, which, as in the JAX package, no model path calls."""
from .int8_matmul import int8_matmul, int8_matmul_kernel, int8_matmul_ref

__all__ = ["int8_matmul", "int8_matmul_kernel", "int8_matmul_ref"]
