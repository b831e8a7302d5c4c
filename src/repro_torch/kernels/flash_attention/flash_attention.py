"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The kernel reads q/k/v in the model layout (b, S, h, d) through their
strides, so a KV cache is attended in place. This module checks what the
kernel takes and raises on anything else, allocates the output, launches
on the current stream and counts its launches in
``flash_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128)  # compiled D instances
ROW_TILES = (1, 64)  # compiled BQ instances
MAX_BK = 128  # the KV tile the kernel's shared-memory opt-in is sized for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.fa_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [i, i, i]
        lib.fa_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Dynamic shared memory of one CTA, as the kernel computes it."""
    return _lib().fa_smem_bytes(bq, bk, d)


def check_blocks(bq: int, bk: int) -> None:
    """Raise unless (bq, bk) is a CTA tile the kernel was compiled for and
    whose shared memory fits (bk <= MAX_BK keeps it under 227 KB)."""
    if bq not in ROW_TILES:
        raise ValueError(f"bq={bq}: compiled row tiles are {ROW_TILES}")
    if not (32 <= bk <= MAX_BK and bk % 32 == 0):
        raise ValueError(f"bk={bk}: KV tile must be a multiple of 32 in [32, {MAX_BK}]")


def flash_attention_cuda(
    q: torch.Tensor,  # (b, Sq, hq, d)
    k: torch.Tensor,  # (b, Skv, hkv, d)
    v: torch.Tensor,  # (b, Skv, hkv, d)
    *,
    causal: bool,
    scale: float,
    q_offset: int,
    kv_len: int,
    bq: int,
    bk: int,
) -> torch.Tensor:
    """One launch of the kernel; returns a new (b, Sq, hq, d) tensor."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda needs q/k/v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need all float32 "
                        f"or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, Sq, hq, d = q.shape
    _, Skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv != 0:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)}: need the same "
                         f"b and d, and hq a multiple of hkv")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: compiled for {HEAD_DIMS}")
    check_blocks(bq, bk)
    if not 0 <= kv_len <= Skv or q_offset < 0:
        raise ValueError(f"kv_len={kv_len} must lie in [0, {Skv}] and q_offset={q_offset} >= 0")
    item = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous, strides {t.stride()}")
    for name, t in (("k", k), ("v", v)):  # the kernel loads K/V rows 16 bytes at a time
        if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned, strides {t.stride()}")
    out = torch.empty((b, Sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, Sq, Skv, d, strides, int(kv_len), int(q_offset), int(causal),
            float(scale), _DTYPES[q.dtype], bq, bk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash attention launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
