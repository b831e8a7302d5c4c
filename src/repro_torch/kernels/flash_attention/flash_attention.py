"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The kernel reads q/k/v in the model layout (b, S, h, d) through their
strides, so a KV cache is attended in place. This module checks what the
kernel takes and raises on anything else, allocates the output (and, for
a split decode, the f32 scratch of the per-split partials), launches on
the current stream and counts each call in ``flash_attention_cuda.launches``
and, by the compiled head dim it ran, in ``launches_by_dim``.

The checks that depend only on the layout (shapes, strides, dtypes,
devices and tile) run once per layout: :func:`_layout` caches them with
the kernel's ``FaLayout``, so a decode step's call does little more than
read the pointers.

The decode instance (``bq == 1``) cuts the live keys into ``n_split``
parts by :func:`n_split`; that rule is not planned. On request
(``lse=True``) it also returns each row's log-sum-exp of its scaled live
scores, f32 (b, Sq, hq), -inf for a row with no live key: the partial that
a rank holding one shard of a KV cache merges with the other shards'.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.architecture import H100_SXM
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128, 192)  # compiled D instances
# KV tiles of the bf16 tensor-core (many-row) instance at each D (dispatch_mma):
# at D = 192 it keeps Q, O and S in registers up to 64 keys
MMA_TILES = {**{D: (32, 64, 96, 128) for D in HEAD_DIMS}, 192: (32, 64)}
ROW_TILES = (1, 64)  # compiled BQ instances: decode, many rows
MAX_BK = 128  # the KV tile the kernel's shared-memory opt-in is sized for
SMEM_OPT_IN = H100_SXM["smem_optin_bytes"]  # the most shared memory a CTA can have
DECODE_ROWS = 8  # q-heads of one kv-head a decode CTA holds at once (kDecodeRows)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _FaLayout(ctypes.Structure):
    """The kernel's ``FaLayout``."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("B", "Hq", "Hkv", "Sq", "Skv", "D", "is_bf16", "bq", "bk", "device")] + [
        ("strides", ctypes.c_longlong * 12)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.fa_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.POINTER(_FaLayout), i, i, i, ctypes.c_float, i,
                       p]
        fn.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [i, i, i, i]
        lib.fa_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(bq: int, bk: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA, as the kernel computes it."""
    return _lib().fa_smem_bytes(bq, bk, d, _DTYPES[dtype])


def live_keys(Sq: int, kv_len: int, q_offset: int, causal: bool) -> int:
    """Keys any query row can see: the valid prefix, cut at the causal
    frontier of the last row."""
    return min(kv_len, q_offset + Sq) if causal else kv_len


def n_split(b: int, hkv: int, live: int, bk: int) -> int:
    """How many parts a decode cuts its live keys into: enough that the
    b * hkv * n_split CTAs cover every SM of the H100 at least once, never
    more parts than KV tiles of ``bk`` keys, and at least one."""
    return max(1, min(math.ceil(live / bk), math.ceil(H100_SXM["sms"] / (b * hkv))))


def compiled_dim(d: int, dv: int) -> int:
    """The compiled head dim the kernel runs (d, dv) at: the smallest D in
    ``HEAD_DIMS`` that holds both (q and k are zero-padded along d, v along
    dv). Raises above ``HEAD_DIMS[-1]``."""
    for D in HEAD_DIMS:
        if max(d, dv) <= D:
            return D
    raise ValueError(f"head dims d={d}, dv={dv}: the CUDA kernel takes d and dv up to "
                     f"{HEAD_DIMS[-1]}")


def max_bk(bq: int, d: int, dtype: torch.dtype) -> int:
    """The largest KV tile compiled for row tile bq, head dim d and dtype
    whose CTA fits the shared-memory opt-in (``MMA_TILES`` for the bf16
    many-row instance; the f32 one at D = 192 fits 96)."""
    bk = MMA_TILES[d][-1] if bq != 1 and dtype == torch.bfloat16 else MAX_BK
    while bk > 32 and smem_formula(bq, bk, d, dtype) > SMEM_OPT_IN:
        bk -= 32
    return bk


def smem_formula(bq: int, bk: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA by the kernel's formula (the card
    holds it against the compiled ``fa_smem_bytes``):

    - decode (bq == 1): 4 / itemsize stages (f32 one, bf16 two) of K and V
      tiles, rows of d elements + 16 bytes; f32 Q (8 x d), scores (8 x bk),
      m, l, alpha;
    - many rows, bf16 (tensor cores): two stages of K and V, rows of d + 8
      bf16;
    - many rows, f32 (FMA): Q (bq x d), K (bk x d+1), V (bk x d), scores
      (bq x bk), m, l, alpha, all f32.
    """
    item = 4 if dtype == torch.float32 else 2
    if bq == 1:
        return (4 // item) * 2 * bk * (d * item + 16) + 4 * DECODE_ROWS * (d + bk + 3)
    if dtype == torch.bfloat16:
        return 2 * 2 * bk * (d + 8) * 2
    return 4 * (bq * d + bk * (d + 1) + bk * d + bq * bk + 3 * bq)


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
    lse: bool = False,
):
    """One call of the kernel (a split decode also launches its merge);
    returns a new (b, Sq, hq, d) tensor, and with ``lse`` (decode only) the
    rows' f32 log-sum-exp (b, Sq, hq) beside it."""
    lay = _layout(q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
                  q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, bq, bk)
    if not 0 <= kv_len <= lay.Skv or q_offset < 0:
        raise ValueError(f"kv_len={kv_len} must lie in [0, {lay.Skv}] and q_offset={q_offset} >= 0")
    # the kernel copies q/k/v rows 16 bytes at a time (their strides were
    # checked with the layout); out is new, so aligned by the allocator
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k and v must start 16-byte aligned")
    if lse and bq != 1:
        raise ValueError(f"bq={bq}: only the decode instance (bq = 1) returns the log-sum-exp")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if lse else None
    parts, part = 1, None
    if bq == 1:
        parts = n_split(lay.B, lay.Hkv, live_keys(lay.Sq, kv_len, q_offset, causal), bk)
        if parts > 1:
            part = torch.empty(lay.B * lay.Sq * lay.Hq * parts * (lay.D + 2),
                               dtype=torch.float32, device=q.device)
    err = _lib().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if rows is None else rows.data_ptr(),
        ctypes.byref(lay), int(kv_len),
        int(q_offset), int(causal), float(scale), parts,
        torch._C._cuda_getCurrentRawStream(lay.device))
    if err:
        raise RuntimeError(f"flash attention launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_dim[lay.D] += 1
    return (out, rows) if lse else out


@functools.lru_cache(maxsize=256)
def _layout(q_shape, k_shape, v_shape, q_stride, k_stride, v_stride, q_dtype, k_dtype, v_dtype,
            q_device, k_device, v_device, bq, bk) -> _FaLayout:
    """Check what the kernel takes of a layout and raise on anything else;
    return its ``FaLayout``."""
    if not (q_device.type == "cuda" and k_device == q_device and v_device == q_device):
        raise ValueError(f"flash_attention_cuda needs q/k/v on one CUDA device, "
                         f"got {q_device}, {k_device}, {v_device}")
    if q_dtype not in _DTYPES or k_dtype != q_dtype or v_dtype != q_dtype:
        raise TypeError(f"dtypes {q_dtype}, {k_dtype}, {v_dtype}: need all float32 "
                        f"or all bfloat16")
    if len(q_shape) != 4 or len(k_shape) != 4 or v_shape != k_shape:
        raise ValueError(f"shapes q{tuple(q_shape)} k{tuple(k_shape)} v{tuple(v_shape)}")
    b, Sq, hq, d = q_shape
    _, Skv, hkv, _ = k_shape
    if k_shape[0] != b or k_shape[3] != d or hq % hkv != 0:
        raise ValueError(f"shapes q{tuple(q_shape)} k{tuple(k_shape)}: need the same "
                         f"b and d, and hq a multiple of hkv")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: compiled for {HEAD_DIMS}")
    check_blocks(bq, bk)
    if bk > max_bk(bq, d, q_dtype):
        raise ValueError(f"bk={bk}: at D={d} in {q_dtype} the kernel takes KV tiles up to "
                         f"{max_bk(bq, d, q_dtype)}")
    item = 4 if q_dtype == torch.float32 else 2
    for name, st in (("q", q_stride), ("k", k_stride), ("v", v_stride)):
        if st[3] != 1:
            raise ValueError(f"{name}: the head dim must be contiguous, strides {st}")
        if any(x * item % 16 for x in st[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned, strides {st}")
    out_stride = (Sq * hq * d, hq * d, d)  # torch.empty's contiguous (b, Sq, hq, d)
    return _FaLayout(b, hq, hkv, Sq, Skv, d, _DTYPES[q_dtype], bq, bk, q_device.index,
                     (ctypes.c_longlong * 12)(*q_stride[:3], *k_stride[:3], *v_stride[:3],
                                              *out_stride))


def reset_launches() -> None:
    """Set the total and per-compiled-D launch counts to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_dim = dict.fromkeys(HEAD_DIMS, 0)


reset_launches()
