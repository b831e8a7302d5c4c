"""Launcher of the CUDA SSD intra-chunk kernel (``csrc/ssd_scan.cu``).

The kernel reads x, dA, B and C in the model layout (b, l, nh, *) through
their strides; B and C may be expanded over heads with stride 0. This
module checks what the kernel takes and raises on anything else, allocates
the outputs, launches on the current stream and counts its launches in
``ssd_intra_chunk_cuda.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 1024  # the chunk length the kernel's shared-memory opt-in is sized for
MAX_DIM = 64  # largest head dim hp and state dim n


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_intra_chunk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = ctypes.c_int
        lib.ssd_smem_bytes.argtypes = [i]
        lib.ssd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(cl: int) -> int:
    """Dynamic shared memory of one CTA, as the kernel computes it."""
    return _lib().ssd_smem_bytes(cl)


def ssd_intra_chunk_cuda(
    x: torch.Tensor,  # (b, l, nh, hp) f32, dt-scaled
    dA: torch.Tensor,  # (b, l, nh) f32
    B: torch.Tensor,  # (b, l, nh, n) f32
    C: torch.Tensor,  # (b, l, nh, n) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch; returns new contiguous f32 tensors y_diag (b, l, nh, hp),
    S_c (b, nc, nh, n, hp) and dte (b, l, nh)."""
    ts = (("x", x), ("dA", dA), ("B", B), ("C", C))
    if not all(t.is_cuda and t.device == x.device for _, t in ts):
        raise ValueError("ssd_intra_chunk_cuda needs x/dA/B/C on one CUDA device, got "
                         + ", ".join(str(t.device) for _, t in ts))
    if any(t.dtype != torch.float32 for _, t in ts):
        raise TypeError("ssd_intra_chunk_cuda takes float32 only, got "
                        + ", ".join(str(t.dtype) for _, t in ts))
    if x.dim() != 4 or dA.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"shapes x{tuple(x.shape)} dA{tuple(dA.shape)} B{tuple(B.shape)} "
                         f"C{tuple(C.shape)}")
    b, l, nh, hp = x.shape
    n = B.shape[3]
    if dA.shape != (b, l, nh) or B.shape[:3] != (b, l, nh):
        raise ValueError(f"shapes x{tuple(x.shape)} dA{tuple(dA.shape)} B{tuple(B.shape)}: "
                         f"need the same (b, l, nh)")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"chunk {chunk} must divide l={l} and lie in [1, {MAX_CHUNK}]")
    if not (1 <= hp <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"hp={hp}, n={n}: the kernel takes both in [1, {MAX_DIM}]")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the last dim must be contiguous, strides {t.stride()}")
    nc = l // chunk
    y = torch.empty((b, l, nh, hp), dtype=torch.float32, device=x.device)
    S = torch.empty((b, nc, nh, n, hp), dtype=torch.float32, device=x.device)
    dte = torch.empty((b, l, nh), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_intra_chunk(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), S.data_ptr(), dte.data_ptr(), b, nh, nc, chunk, hp, n, strides,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"SSD intra-chunk launch failed with CUDA error {err}")
    ssd_intra_chunk_cuda.launches += 1
    return y, S, dte


ssd_intra_chunk_cuda.launches = 0
