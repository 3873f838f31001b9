"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``moe_gemm`` holds the grouped SwiGLU expert FFN (CUDA C++ in
``repro_torch/csrc``); the other reference kernels wait (ROADMAP.md
queue 2)."""
