"""Hand-written Hopper kernels (CUDA C++ under each kernel's ``csrc/``).

skipper_match/ — the window tier and the global tier of the single-pass
matcher. Each kernel ships kernel.py (build, load, launch), ops.py (entry
points) and ref.py (the plain PyTorch versions the CPU path and the card's
comparisons use).
"""
