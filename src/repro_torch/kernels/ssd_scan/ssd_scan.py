"""Launcher of the CUDA SSD intra-chunk kernel (``csrc/ssd_scan.cu``).

The kernel reads x, dA, B and C in the model layout (b, l, nh, *) through
their strides. Where B and C are expanded over the heads with stride 0 (one
group, as zamba2 passes them), a score kernel first writes each chunk's
C B^T once into scratch this module allocates, and the main kernel reads it
for every head; with per-head B/C each CTA builds its own scores. This
module checks what the kernel takes and raises on anything else, allocates
the outputs, launches on the current stream and counts each kernel it
launches in ``ssd_intra_chunk_cuda.launches``: two a call where the score
kernel runs, else one.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 1024  # the chunk length the kernel's shared-memory opt-in is sized for
MAX_DIM = 128  # largest head dim hp and state dim n
HP_SLICE = 64  # hp columns of one CTA; a wider head runs as slices in separate CTAs
TILE = 32  # steps of the chunk a CTA streams at a time


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_intra_chunk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = ctypes.c_int
        lib.ssd_smem_bytes.argtypes = [i, i, i]
        lib.ssd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(cl: int, n: int = 64, shared: bool = False) -> int:
    """Dynamic shared memory of one CTA of the main kernel, as it computes it."""
    return _lib().ssd_smem_bytes(cl, n, int(shared))


def smem_formula(cl: int, n: int = 64, shared: bool = False) -> int:
    """Dynamic shared memory of one CTA of the main kernel by its formula
    (the card holds it against the compiled ``ssd_smem_bytes``), for state
    dim n (rows of up to 64 or 128 state columns, padded by 4 floats): the
    chunk's cumulative decay as f64 offsets and f32 runs (cl rounded up to
    32); two stages of a 32-step tile of B and of x (rows of 64 + 4 floats)
    and, with ``shared`` scores, of 8 warps' 16 x 32 blocks of them (rows of
    40 floats); without, the C rows of 8 groups of 16 rows."""
    ld = (64 if n <= 64 else MAX_DIM) + 4
    clp = -(-cl // TILE) * TILE
    stage = TILE * ld + TILE * (HP_SLICE + 4) + (8 * 16 * (TILE + 8) if shared else 0)
    return 12 * clp + 4 * (2 * stage + (0 if shared else 8 * 16 * ld))


def check_shapes(b: int, l: int, nh: int, hp: int, n: int, chunk: int) -> None:
    """Raise unless the kernel takes these sizes."""
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"chunk {chunk} must divide l={l} and lie in [1, {MAX_CHUNK}]")
    if not (1 <= hp <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"hp={hp}, n={n}: the kernel takes both in [1, {MAX_DIM}]")
    if min(b, nh) < 1:
        raise ValueError(f"b={b}, nh={nh}: need at least one batch row and head")


def shares_scores(B: torch.Tensor, C: torch.Tensor) -> bool:
    """Whether one score block per chunk serves every head: B and C expanded
    over the heads with stride 0, or a single head."""
    return B.shape[2] == 1 or (B.stride(2) == 0 and C.stride(2) == 0)


def ssd_intra_chunk_cuda(
    x: torch.Tensor,  # (b, l, nh, hp) f32, dt-scaled
    dA: torch.Tensor,  # (b, l, nh) f32
    B: torch.Tensor,  # (b, l, nh, n) f32
    C: torch.Tensor,  # (b, l, nh, n) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call; returns new contiguous f32 tensors y_diag (b, l, nh, hp),
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
    check_shapes(b, l, nh, hp, n, chunk)
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the last dim must be contiguous, strides {t.stride()}")
    nc = l // chunk
    y = torch.empty((b, l, nh, hp), dtype=torch.float32, device=x.device)
    S = torch.empty((b, nc, nh, n, hp), dtype=torch.float32, device=x.device)
    dte = torch.empty((b, l, nh), dtype=torch.float32, device=x.device)
    scores = (torch.empty((b, nc, chunk, chunk), dtype=torch.float32, device=x.device)
              if shares_scores(B, C) else None)
    # a single head: any head stride is as good as 0
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dA.stride(), *B.stride()[:2], 0 if nh == 1 else B.stride(2),
        *C.stride()[:2], 0 if nh == 1 else C.stride(2))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_intra_chunk(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if scores is None else scores.data_ptr(), y.data_ptr(), S.data_ptr(),
            dte.data_ptr(), b, nh, nc, chunk, hp, n, strides,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"SSD intra-chunk launch failed with CUDA error {err}")
    if scores is not None:
        ssd_intra_chunk_cuda.launches += 1  # the score kernel
    ssd_intra_chunk_cuda.launches += 1  # the main kernel
    return y, S, dte


ssd_intra_chunk_cuda.launches = 0
