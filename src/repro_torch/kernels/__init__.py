"""Hand-written Hopper kernels for the compute hot-spots.

Each kernel directory has:
  csrc/<name>.cu -- the CUDA C++ kernel for sm_90a, with a plain C entry
  <name>.py      -- its launcher: checks, allocates, launches, counts launches
  ops.py         -- the public op in the model layout; picks the CTA tile
  ref.py         -- the plain PyTorch version the kernel is held against

``enable_kernels(True)`` routes model attention and the Mamba-2 SSD scan
through ``ops``: there a CUDA tensor goes to the kernel and a CPU tensor to
the plain version (the role ``interpret=True`` played for the Pallas
kernels). With the switch off, the model takes its own reference paths
(chunked attention, the plain chunked SSD).
"""

_USE_KERNELS = False


def enable_kernels(value: bool = True) -> None:
    """Route model attention and SSD through the kernel ops (mirror of
    ``repro.kernels.enable_pallas``)."""
    global _USE_KERNELS
    _USE_KERNELS = bool(value)


def kernels_enabled() -> bool:
    return _USE_KERNELS
