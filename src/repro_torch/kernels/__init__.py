"""Hand-written Hopper kernels (CUDA C++ under each kernel's ``csrc/``).

skipper_match/ — the window tier and the global tier of the single-pass
matcher.
flash_attention/ — causal GQA attention with an optional sliding window.

Each kernel ships kernel.py (build, load, launch), ops.py (entry
points) and ref.py (the plain PyTorch versions the CPU path and the card's
comparisons use). ``_build.py`` builds every source with nvcc and loads
it with ctypes.
"""
