"""Launcher of the CUDA matmul kernel (``csrc/matmul.cu``).

The kernel reads A (M, K) and B (K, N) through their element strides, so a
transposed operand is read in place, and masks the ragged edges, so nothing
is padded. This module checks what the kernel takes and raises on anything
else, allocates the output, launches on the current stream and counts its
launches in ``matmul_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILES = (64, 128)  # compiled CTA tile sizes for bm and bn
BK_MULTIPLE = 16  # the K slice is a multiple of one bf16 MMA depth
SMEM_OPTIN = 232_448  # the 227 KB a CTA may opt into (the kernel's limit)
_STAGES, _PAD = 2, 4  # as in the kernel: two slices in a ring, rows padded by 4 floats
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    fn = lib.matmul_forward
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.matmul_smem_bytes.argtypes = [i, i, i]
        lib.matmul_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one CTA, by the kernel's formula (host
    arithmetic, so the planner can use it without a card)."""
    return _STAGES * bk * (bm + _PAD + bn + _PAD) * 4


def lib_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """The same, as the compiled kernel computes it."""
    return _lib().matmul_smem_bytes(bm, bn, bk)


def check_tiles(bm: int, bn: int, bk: int) -> None:
    """Raise unless (bm, bn, bk) is a CTA tile the kernel was compiled for
    and whose shared memory fits the opt-in."""
    if bm not in TILES or bn not in TILES:
        raise ValueError(f"tile ({bm}, {bn}): compiled CTA tiles are {TILES} x {TILES}")
    if bk < BK_MULTIPLE or bk % BK_MULTIPLE:
        raise ValueError(f"bk={bk}: the K slice must be a positive multiple of {BK_MULTIPLE}")
    if smem_bytes(bm, bn, bk) > SMEM_OPTIN:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) needs {smem_bytes(bm, bn, bk)} B of "
                         f"shared memory, over the {SMEM_OPTIN} B opt-in")


def matmul_cuda(
    x: torch.Tensor,  # (M, K)
    y: torch.Tensor,  # (K, N)
    *,
    bm: int,
    bn: int,
    bk: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """One launch of the kernel; returns a new contiguous (M, N) tensor."""
    if not (x.is_cuda and y.device == x.device):
        raise ValueError(f"matmul_cuda needs x and y on one CUDA device, got {x.device}, {y.device}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype or out_dtype not in _DTYPES:
        raise TypeError(f"dtypes {x.dtype}, {y.dtype} -> {out_dtype}: need x and y both "
                        f"float32 or both bfloat16, and a float32 or bfloat16 output")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"shapes x{tuple(x.shape)} y{tuple(y.shape)}: need (M, K) and (K, N)")
    M, K = x.shape
    N = y.shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"empty product ({M}, {N}, {K})")
    check_tiles(bm, bn, bk)
    if (M + bm - 1) // bm > 65535:
        raise ValueError(f"M={M}: more than 65535 row tiles of {bm}")
    if min(*x.stride(), *y.stride()) < 0:
        raise ValueError(f"negative strides {x.stride()}, {y.stride()}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.matmul_forward(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
            *x.stride(), *y.stride(), _DTYPES[x.dtype], _DTYPES[out_dtype], bm, bn, bk,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"matmul launch failed with CUDA error {err}")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
