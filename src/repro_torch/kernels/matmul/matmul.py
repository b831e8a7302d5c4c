"""Launchers of the two CUDA matmul instances, and the rule that routes a
product to one of them.

- ``wgmma``: the bf16 tensor-core instance (``csrc/matmul_wgmma.cu``): TMA
  loads into a ring of swizzled stages, ``wgmma`` products, f32
  accumulators. It takes bf16 operands that TMA can read.
- ``fma``: the IEEE f32 FMA instance (``csrc/matmul.cu``). It takes every
  shape and layout the op takes: f32, and bf16 that TMA cannot read.

:func:`instance_for` is the rule, a pure function of the operands' dtypes,
shapes, strides and base alignment: both operands bf16, each with a unit
stride on one dim, the other stride a multiple of 16 bytes (and at least
the contiguous extent) and a 16-byte aligned base, go to ``wgmma``; every
other product goes to ``fma``. Nothing falls back: a launch the chosen
instance refuses raises.

Both kernels read A (M, K) and B (K, N) through their strides, so a
transposed operand is read in place, and mask the ragged edges, so nothing
is padded. :func:`matmul_cuda` checks what the instance takes once per
layout (dtypes, shapes, strides, alignment, device, tile; cached), allocates
the output, launches on the current stream and counts the launch, in total
(``matmul_cuda.launches``) and per instance
(``matmul_cuda.launches_by_instance``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.architecture import H100_SMEM_BUDGET, H100_SXM
from repro_torch.kernels import _build

TILES = (64, 128)  # fma: compiled CTA tile sizes for bm and bn
BK_CHOICES = (16, 32, 48, 64)  # fma: K slices, compiled where three fit H100_SMEM_BUDGET
BK_MULTIPLE = 16  # fma: the K slice is a multiple of one bf16 MMA depth
TC_BM = (64, 128)  # wgmma: compiled bm (one consumer warpgroup per 64 rows)
TC_BN = (64, 128, 256)  # wgmma: compiled bn (the wgmma N)
TC_BK = 64  # wgmma: the K depth of one stage (one 128-byte swizzle row of bf16)
SMEM_OPTIN = H100_SXM["smem_optin_bytes"]  # the 227 KB a CTA may opt into (both kernels' limit)
INSTANCES = ("wgmma", "fma")
_STAGES = 3  # fma: K slices in its ring, as in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SCALAR, _VEC, _ASYNC = 0, 1, 2  # fma: how the kernel fills an operand's slices


class _FmaLayout(ctypes.Structure):
    """The fma kernel's ``FmaLayout``."""

    _fields_ = [(n, ctypes.c_longlong) for n in ("sa_m", "sa_k", "sb_k", "sb_n")] + [
        (n, ctypes.c_int) for n in ("M", "N", "K", "a_mode", "b_mode", "in_bf16", "out_bf16",
                                    "bm", "bn", "bk", "device")]


class _TcLayout(ctypes.Structure):
    """The wgmma kernel's ``TcLayout``."""

    _fields_ = [("lda", ctypes.c_longlong), ("ldb", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("M", "N", "K", "a_mn", "b_mn", "out_bf16", "bm", "bn",
                                    "stages", "device")]


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "matmul" and lib.matmul_forward.argtypes is None:
        lib.matmul_forward.argtypes = [p, p, p, ctypes.POINTER(_FmaLayout), p]
        lib.matmul_forward.restype = i
        lib.matmul_smem_bytes.argtypes = [i, i, i]
        lib.matmul_smem_bytes.restype = i
    if name == "matmul_wgmma" and lib.matmul_wgmma_forward.argtypes is None:
        lib.matmul_wgmma_forward.argtypes = [p, p, p, ctypes.POINTER(_TcLayout), p]
        lib.matmul_wgmma_forward.restype = i
        lib.matmul_wgmma_smem_bytes.argtypes = [i, i, i]
        lib.matmul_wgmma_smem_bytes.restype = i
        lib.matmul_wgmma_encode_ns.argtypes = [p, p, ctypes.POINTER(_TcLayout)]
        lib.matmul_wgmma_encode_ns.restype = ctypes.c_longlong
    return lib


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one fma CTA, by the kernel's formula (host
    arithmetic, so the planner can use it without a card): three f32
    slices of A and B."""
    return _STAGES * bk * (bm + bn) * 4


def tc_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one wgmma CTA whose ring holds ``bk`` of K
    (``bk // 64`` stages), by the kernel's formula: 1024 bytes of slack for
    the swizzle's alignment, the stages of bf16 A and B, and a full and an
    empty mbarrier a stage."""
    stages = bk // TC_BK
    return 1024 + stages * (bm + bn) * TC_BK * 2 + 16 * stages


def lib_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """:func:`smem_bytes` as the compiled kernel computes it."""
    return _lib("matmul").matmul_smem_bytes(bm, bn, bk)


def lib_tc_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """:func:`tc_smem_bytes` as the compiled kernel computes it."""
    return _lib("matmul_wgmma").matmul_wgmma_smem_bytes(bm, bn, bk // TC_BK)


def check_tiles(bm: int, bn: int, bk: int) -> None:
    """Raise unless (bm, bn, bk) is a CTA tile the fma kernel was compiled
    for: bm, bn in ``TILES``, bk in ``BK_CHOICES``, with shared memory
    within ``H100_SMEM_BUDGET`` (half the opt-in, so two CTAs share an SM)."""
    if bm not in TILES or bn not in TILES:
        raise ValueError(f"tile ({bm}, {bn}): compiled CTA tiles are {TILES} x {TILES}")
    if bk not in BK_CHOICES:
        raise ValueError(f"bk={bk}: the K slice must be one of {BK_CHOICES} "
                         f"(a multiple of {BK_MULTIPLE})")
    if smem_bytes(bm, bn, bk) > H100_SMEM_BUDGET:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) needs {smem_bytes(bm, bn, bk)} B of "
                         f"shared memory, over the {H100_SMEM_BUDGET} B the fma instances "
                         f"are compiled for")


def fma_tiles() -> list:
    """Every (bm, bn, bk) the fma kernel was compiled for."""
    return [(bm, bn, bk) for bm in TILES for bn in TILES for bk in BK_CHOICES
            if smem_bytes(bm, bn, bk) <= H100_SMEM_BUDGET]


def check_tc_tiles(bm: int, bn: int, bk: int) -> None:
    """Raise unless (bm, bn, bk) is a CTA tile the wgmma kernel was
    compiled for, with a ring of ``bk // 64`` stages that fits the opt-in."""
    if bm not in TC_BM or bn not in TC_BN:
        raise ValueError(f"tile ({bm}, {bn}): compiled wgmma tiles are {TC_BM} x {TC_BN}")
    if bk < TC_BK or bk % TC_BK:
        raise ValueError(f"bk={bk}: the wgmma ring holds a positive multiple of {TC_BK} of K")
    if tc_smem_bytes(bm, bn, bk) > SMEM_OPTIN:
        raise ValueError(f"wgmma tile ({bm}, {bn}, {bk}) needs {tc_smem_bytes(bm, bn, bk)} B "
                         f"of shared memory, over the {SMEM_OPTIN} B opt-in")


def _tma_lead(inner: int, outer: int, s_inner: int, s_outer: int) -> Optional[int]:
    """The row stride (elements) under which TMA reads a bf16 matrix whose
    ``inner`` dim is contiguous, or None: the inner stride must be 1, the
    row stride a multiple of 8 (16 bytes) and no smaller than a row. A dim
    of extent 1 has no stride that matters."""
    if s_inner != 1 and inner != 1:
        return None
    lead = s_outer if outer > 1 else -(-inner // 8) * 8
    return lead if lead % 8 == 0 and lead >= inner else None


def _tma_operands(x_shape, x_stride, y_shape, y_stride):
    """((lda, a_mn), (ldb, b_mn)) for the wgmma kernel, or None where TMA
    cannot read an operand. A is K-major (a_mn 0) or M-major (1); B is
    N-major (b_mn 1) or K-major (0)."""
    (M, K), (sa_m, sa_k) = x_shape, x_stride
    N, (sb_k, sb_n) = y_shape[1], y_stride
    a = _tma_lead(K, M, sa_k, sa_m)
    a = (a, 0) if a is not None else (_tma_lead(M, K, sa_m, sa_k), 1)
    b = _tma_lead(N, K, sb_n, sb_k)
    b = (b, 1) if b is not None else (_tma_lead(K, N, sb_k, sb_n), 0)
    return None if a[0] is None or b[0] is None else (a, b)


@functools.lru_cache(maxsize=1024)
def _instance(x_dtype, y_dtype, x_shape, x_stride, y_shape, y_stride, x_aligned, y_aligned) -> str:
    if not (x_dtype == y_dtype == torch.bfloat16 and x_aligned and y_aligned):
        return "fma"
    return "wgmma" if _tma_operands(x_shape, x_stride, y_shape, y_stride) else "fma"


def layout_key(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """What the route and the launch checks depend on: dtypes, shapes,
    strides, 16-byte alignment of the bases, devices."""
    return (x.dtype, y.dtype, tuple(x.shape), x.stride(), tuple(y.shape), y.stride(),
            x.data_ptr() % 16 == 0, y.data_ptr() % 16 == 0, x.device, y.device)


def instance_for(x: torch.Tensor, y: torch.Tensor) -> str:
    """The instance that computes x (M, K) . y (K, N): ``"wgmma"`` when both
    are bf16 and TMA can read both (a unit stride on one dim, the other
    stride a multiple of 16 bytes, a 16-byte aligned base), else ``"fma"``.
    A function of dtype, shape, strides and ``data_ptr() % 16`` only, so it
    answers for CPU and ``meta`` tensors as for CUDA ones."""
    return _instance(*layout_key(x, y)[:8])


def _fma_mode(dtype, aligned, s_mn, s_k, mn, k) -> int:
    """How the fma kernel fills one operand's slices: 16-byte cp.async
    along M/N, 16-byte loads along K through registers, or element by
    element (bf16, unaligned or strided)."""
    if dtype != torch.float32 or not aligned:
        return _SCALAR
    if s_mn == 1 and (s_k % 4 == 0 or k == 1):
        return _ASYNC
    if s_k == 1 and (s_mn % 4 == 0 or mn == 1):
        return _VEC
    return _SCALAR


@functools.lru_cache(maxsize=1024)
def _prepare(key, out_dtype, bm, bn, bk) -> Tuple[str, ctypes.Structure]:
    """Check what the routed instance takes of a layout (``layout_key``)
    and tile, and raise on anything else; return the instance and the
    kernel's layout struct."""
    x_dtype, y_dtype, x_shape, x_stride, y_shape, y_stride, x_aligned, y_aligned, dev, y_dev = key
    if not (dev.type == "cuda" and y_dev == dev):
        raise ValueError(f"matmul_cuda needs x and y on one CUDA device, got {dev}, {y_dev}")
    if x_dtype not in _DTYPES or y_dtype != x_dtype or out_dtype not in _DTYPES:
        raise TypeError(f"dtypes {x_dtype}, {y_dtype} -> {out_dtype}: need x and y both "
                        f"float32 or both bfloat16, and a float32 or bfloat16 output")
    if len(x_shape) != 2 or len(y_shape) != 2 or x_shape[1] != y_shape[0]:
        raise ValueError(f"shapes x{x_shape} y{y_shape}: need (M, K) and (K, N)")
    (M, K), N = x_shape, y_shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"empty product ({M}, {N}, {K})")
    if min(*x_stride, *y_stride) < 0:
        raise ValueError(f"negative strides {x_stride}, {y_stride}")
    inst = _instance(*key[:8])
    if inst == "wgmma":
        check_tc_tiles(bm, bn, bk)
    else:
        check_tiles(bm, bn, bk)
    if (M + bm - 1) // bm > 65535:
        raise ValueError(f"M={M}: more than 65535 row tiles of {bm}")
    out_bf16 = int(out_dtype == torch.bfloat16)
    if inst == "wgmma":
        (lda, a_mn), (ldb, b_mn) = _tma_operands(x_shape, x_stride, y_shape, y_stride)
        return inst, _TcLayout(lda, ldb, M, N, K, a_mn, b_mn, out_bf16, bm, bn, bk // TC_BK,
                               dev.index)
    (sa_m, sa_k), (sb_k, sb_n) = x_stride, y_stride
    return inst, _FmaLayout(sa_m, sa_k, sb_k, sb_n, M, N, K,
                            _fma_mode(x_dtype, x_aligned, sa_m, sa_k, M, K),
                            _fma_mode(y_dtype, y_aligned, sb_n, sb_k, N, K),
                            _DTYPES[x_dtype], out_bf16, bm, bn, bk, dev.index)


def launch(x: torch.Tensor, y: torch.Tensor, key: tuple, tiles: Tuple[int, int, int],
           out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`matmul_cuda` for a layout whose ``layout_key`` the caller has."""
    inst, lay = _prepare(key, out_dtype, *tiles)
    out = torch.empty((lay.M, lay.N), dtype=out_dtype, device=x.device)
    fn = (_lib("matmul_wgmma").matmul_wgmma_forward if inst == "wgmma"
          else _lib("matmul").matmul_forward)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), ctypes.byref(lay),
             torch._C._cuda_getCurrentRawStream(lay.device))
    if err:
        raise RuntimeError(f"matmul launch ({inst}, tile {tuple(tiles)}) failed with CUDA error "
                           f"{err}")
    matmul_cuda.launches += 1
    matmul_cuda.launches_by_instance[inst] += 1
    return out


def matmul_cuda(
    x: torch.Tensor,  # (M, K)
    y: torch.Tensor,  # (K, N)
    *,
    bm: int,
    bn: int,
    bk: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """One launch of the instance :func:`instance_for` picks, with CTA tile
    (bm, bn, bk) of that instance's space; returns a new contiguous (M, N)
    tensor."""
    return launch(x, y, layout_key(x, y), (bm, bn, bk), out_dtype)


def encode_ns(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int) -> int:
    """Host nanoseconds the wgmma launch of x . y spends encoding its two
    tensor maps (the mean of 1000 encodes; nothing is launched)."""
    inst, lay = _prepare(layout_key(x, y), torch.float32, bm, bn, bk)
    if inst != "wgmma":
        raise ValueError(f"{inst} encodes no tensor maps")
    ns = _lib("matmul_wgmma").matmul_wgmma_encode_ns(x.data_ptr(), y.data_ptr(), ctypes.byref(lay))
    if ns < 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    return ns


def reset_launches() -> None:
    """Set the total and per-instance launch counts to 0."""
    matmul_cuda.launches = 0
    matmul_cuda.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launches()
