"""PyTorch + CUDA port of the Skipper single-pass maximal matcher.

The package mirrors ``src/repro/``'s layout (``core/``, ``graphs/``,
``kernels/skipper_match/``) so every module has one obvious counterpart in
the JAX reference. It imports ``torch`` and numpy only.

Entry points run on the CUDA device unless the caller asks for the CPU:
``kernels.skipper_match.skipper_match(edges)`` raises ``RuntimeError`` when
no CUDA device exists; tests pass ``device="cpu"``.
"""
