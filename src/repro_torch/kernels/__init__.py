"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``moe_gemm`` holds the grouped SwiGLU expert FFN and its
packed-weight twin that dequantizes in registers (CUDA C++ in
``repro_torch/csrc``, built by ``_nvcc``); the other reference kernels
wait (ROADMAP.md queue 2)."""
