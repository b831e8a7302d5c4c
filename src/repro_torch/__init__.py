"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The layout mirrors ``src/repro/`` so each module's counterpart is found at
the same path. The port imports ``torch`` and never ``jax`` or anything of
``repro``; where it needs a jax-free helper of ``repro`` it keeps its own
copy. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
