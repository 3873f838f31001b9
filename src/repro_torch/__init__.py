"""PyTorch/CUDA port of the OD-MoE system (``repro``), for one NVIDIA
H100.  Imports neither ``jax`` nor ``repro``; entry points run on the
card unless the caller passes ``device="cpu"``."""
