"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (CUDA C++ in ``repro_torch/csrc``, built by ``_nvcc``):
``moe_gemm`` holds the grouped SwiGLU expert FFN and its packed-weight
twin that dequantizes in registers, ``flash_decode`` the single-token
GQA decode attention over a ring-buffer cache, ``ssd_scan`` the Mamba2
inter-chunk state recurrence.  The reference's ``int8_matmul`` waits
(ROADMAP.md queue 2)."""
