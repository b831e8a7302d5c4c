"""Public matmul op: co-design planning, leading dims, autograd (port of
``repro/kernels/matmul/ops.py``).

The CTA tile comes from the co-design layer, one space per kernel
instance (``matmul.instance_for`` routes each product):

- :class:`MatmulSpace`, ``matmul_h100``: the f32 FMA instance (f32, and
  bf16 that TMA cannot read), planned in f32 words;
- :class:`MatmulBf16Space`, ``matmul_bf16_h100``: the bf16 wgmma + TMA
  instance, planned in bf16 words at wgmma-aligned tiles.

Each registers the GEMM ``Problem``, aligned ``Constraints`` and a binding
``legalize`` with ``repro_torch.codesign``; :func:`plan_tiles` is a thin
wrapper over ``codesign.plan`` (heuristic mapper x timeloop-like model
over ``h100_sm()``; the C1 temporal tile is the CTA tile). Plans are cached.

On a CUDA tensor the op launches a CUDA kernel; on a CPU tensor it runs the
plain version (``ref.matmul_ref``), planned as the card would plan it. Any
other device raises. The kernels mask ragged edges and read operands
through strides, so no pad or transposed copy is made. Gradients: two more
launches, ``g . y^T`` and ``x^T . g``, each routed and planned for its own
operands, as ``_matmul_bwd`` does in the JAX op.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import codesign
from repro_torch.codesign import KernelSpace, round_up
from repro_torch.core.constraints import tc_aligned
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem
from repro_torch.kernels.matmul.matmul import (
    BK_CHOICES,
    BK_MULTIPLE,
    SMEM_OPTIN,
    TC_BK,
    TC_BM,
    TC_BN,
    TILES,
    _instance,
    launch,
    layout_key,
    smem_bytes,
    tc_smem_bytes,
)
from repro_torch.kernels.matmul.ref import BF16_TOL, matmul_ref

ROW_ALIGN = 64  # one wgmma row group: the M and N alignment the planner works at
# the FMA instance's default K slice: on the card its 128x128 tile ran 9-10%
# faster at 16 than at 32 at every shape measured
DEFAULT_BK = 16


def tiles_from_mapping(mapping: Mapping, problem: Problem) -> Tuple[int, int, int]:
    """Read (bm, bn, bk) from the innermost level's temporal tile."""
    leaf = mapping.levels[-1]
    return leaf.tt("m"), leaf.tt("n"), leaf.tt("k")


def _pick_tile(b: int, dim: int, tiles: Tuple[int, ...] = TILES) -> int:
    """The compiled CTA tile for a dim of ``dim``: ``b`` when it is one and
    not larger than the dim rounded up to a row group, else the largest
    compiled tile within both."""
    cap = max(round_up(dim, ROW_ALIGN), tiles[0])
    if b in tiles and b <= cap:
        return b
    return max(t for t in tiles if t <= max(b, tiles[0]) and t <= cap)


class MatmulSpace(KernelSpace):
    """Co-design space of the f32 FMA instance: shape = (M, N, K),
    BlockConfig = (bm, bn, bk). Calibrated in f32, held to its plain
    version within ``tolerance`` (IEEE f32, sums in another order)."""

    name = "matmul_h100"
    dtype = torch.float32
    tolerance = 2e-5
    decode_dims = ("m", "n", "k")
    grid_dims = ("m", "n")
    search_budget = 400

    def problem(self, shape):
        M, N, K = shape
        # the kernel holds both operand slices as f32 in shared memory
        return Problem.gemm(M, N, K, word_bytes=4)

    def constraints(self, shape):
        return tc_aligned({"m": ROW_ALIGN, "n": ROW_ALIGN, "k": BK_MULTIPLE},
                          spatial_dims=self.grid_dims)

    def legalize(self, config, shape, smem_budget=None):
        """BINDING repair into a compiled tile: bm, bn in ``TILES``; bk in
        ``BK_CHOICES``, at most K rounded up to 16, with the kernel's three
        staged f32 slices within ``smem_budget``. Never raises."""
        bm, bn, bk = (int(c) for c in config)
        M, N, K = (int(s) for s in shape)
        budget = int(smem_budget or self.smem_budget)
        bm, bn = _pick_tile(bm, M), _pick_tile(bn, N)
        bk = bk // BK_MULTIPLE * BK_MULTIPLE if bk >= BK_MULTIPLE else DEFAULT_BK
        bk = min(bk, BK_CHOICES[-1], round_up(K, BK_MULTIPLE))
        while bk > BK_MULTIPLE and smem_bytes(bm, bn, bk) > budget:
            bk -= BK_MULTIPLE
        return (bm, bn, bk)

    def default_config(self, shape):
        return (TILES[-1], TILES[-1], DEFAULT_BK)

    def launched_shape(self, shape, config):
        return tuple(round_up(int(s), int(b)) for s, b in zip(shape, config))

    def example_inputs(self, shape, device, generator):
        M, N, K = shape
        return (
            torch.randn((M, K), generator=generator, device=device).to(self.dtype),
            torch.randn((K, N), generator=generator, device=device).to(self.dtype),
        )

    def run(self, inputs, config):
        x, y = inputs
        return matmul(x, y, tiles=tuple(config))

    def reference(self, inputs, config):
        return matmul_ref(*inputs)


class MatmulBf16Space(MatmulSpace):
    """Co-design space of the bf16 wgmma + TMA instance: shape = (M, N, K),
    BlockConfig = (bm, bn, bk), where bk is the K extent the CTA's ring of
    shared-memory stages holds at once (``bk // 64`` stages of 64).
    Calibrated in bf16, held to its plain version on the same bf16 inputs
    within ``tolerance`` (one bf16 rounding of the output).

    Its shared-memory budget is the whole 227 KB opt-in, not the half that
    the other spaces keep (``H100_SMEM_BUDGET``): this design runs one CTA
    per SM and hides the loads behind the ring's depth, not behind a second
    CTA."""

    name = "matmul_bf16_h100"
    dtype = torch.bfloat16
    tolerance = BF16_TOL
    smem_budget = SMEM_OPTIN

    def problem(self, shape):
        M, N, K = shape
        return Problem.gemm(M, N, K, word_bytes=2)

    def constraints(self, shape):
        return tc_aligned({"m": ROW_ALIGN, "n": ROW_ALIGN, "k": TC_BK},
                          spatial_dims=self.grid_dims)

    def legalize(self, config, shape, smem_budget=None):
        """BINDING repair into a compiled wgmma tile: bm in ``TC_BM``, bn in
        ``TC_BN``; bk a multiple of 64, at least 64 and at most K rounded
        up to 64, shrunk until the CTA (stages, mbarriers, alignment slack:
        ``tc_smem_bytes``) fits ``smem_budget``. Never raises."""
        bm, bn, bk = (int(c) for c in config)
        M, N, K = (int(s) for s in shape)
        budget = int(smem_budget or self.smem_budget)
        bm, bn = _pick_tile(bm, M, TC_BM), _pick_tile(bn, N, TC_BN)
        bk = min(max(bk // TC_BK, 1) * TC_BK, round_up(K, TC_BK))
        while bk > TC_BK and tc_smem_bytes(bm, bn, bk) > budget:
            bk -= TC_BK
        return (bm, bn, bk)

    def default_config(self, shape):
        return (TC_BM[-1], TC_BN[-1], 4 * TC_BK)

    def run(self, inputs, config):
        """One launch with a tile of this space: on the wgmma instance only,
        so a product that TMA cannot read raises rather than run another
        instance with this space's tile."""
        x, y = inputs
        if _instance(*layout_key(x, y)[:8]) != "wgmma":
            raise ValueError(f"{self.name}: x {tuple(x.shape)} {x.dtype} . y {tuple(y.shape)} "
                             f"{y.dtype} routes to the FMA instance, not this space's wgmma")
        return matmul(x, y, tiles=tuple(config))


MATMUL_H100 = codesign.register_space(MatmulSpace())
MATMUL_BF16_H100 = codesign.register_space(MatmulBf16Space())


def _space(dtype: torch.dtype) -> MatmulSpace:
    return MATMUL_BF16_H100 if dtype == torch.bfloat16 else MATMUL_H100


def planned_shape(M: int, N: int, K: int, dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """The shape a GEMM is planned at: M and N rounded up to a row group, K
    to the MMA depth (f32 space) or to a stage's 64 (bf16 space); the JAX
    op plans at the 128-aligned shape."""
    k_align = TC_BK if dtype == torch.bfloat16 else BK_MULTIPLE
    return round_up(M, ROW_ALIGN), round_up(N, ROW_ALIGN), round_up(K, k_align)


@functools.lru_cache(maxsize=512)
def plan_tiles(
    M: int, N: int, K: int, *, dtype: torch.dtype = torch.float32, mapper: str = "heuristic",
    budget: int = 400,
) -> Tuple[int, int, int]:
    """Plan the GEMM (M, N, K) via ``codesign.plan`` in the space of
    ``dtype`` (``matmul_bf16_h100`` for bf16, ``matmul_h100`` otherwise);
    return (bm, bn, bk)."""
    return codesign.plan(
        _space(dtype), planned_shape(M, N, K, dtype), mapper=mapper, budget=budget
    ).config


def plan_for(x: torch.Tensor, y: torch.Tensor) -> Tuple[int, int, int]:
    """The planned tile of x (M, K) . y (K, N) in the space of the instance
    the product routes to: a bf16 product that TMA cannot read runs on the
    FMA instance and plans in its space."""
    return _plan(layout_key(x, y))


@functools.lru_cache(maxsize=1024)
def _plan(key) -> Tuple[int, int, int]:
    (M, K), N = key[2], key[4][1]
    dtype = torch.bfloat16 if _instance(*key[:8]) == "wgmma" else torch.float32
    return plan_tiles(M, N, K, dtype=dtype)


def _product(x, y, tiles, out_dtype, key=None):
    if x.is_cuda:
        return launch(x, y, key or layout_key(x, y), tiles, out_dtype)
    return matmul_ref(x, y, out_dtype)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, tiles, out_dtype):
        ctx.save_for_backward(x, y)
        return _product(x, y, tiles, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            yt = y.t()
            dx = _product(g, yt, plan_for(g, yt), x.dtype)
        if ctx.needs_input_grad[1]:
            xt = x.t()
            dy = _product(xt, g, plan_for(xt, g), y.dtype)
        return dx, dy, None, None


def matmul(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    tiles: Optional[Tuple[int, int, int]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C = x . y for any shape; leading dims of ``x`` are flattened into M.
    Differentiable in x and y. ``tiles`` must be a tile of the routed
    instance's space; by default it is planned there."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"matmul has no path for device {x.device}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    M = math.prod(lead)
    K = x.shape[-1]
    if y.dim() != 2 or y.shape[0] != K:
        raise ValueError(f"matmul inner dims: x{tuple(x.shape)} y{tuple(y.shape)}")
    N = y.shape[1]
    x2 = x.reshape(M, K)
    key = layout_key(x2, y)
    tiles = tuple(tiles) if tiles is not None else _plan(key)
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        out = _Matmul.apply(x2, y, tiles, out_dtype)
    else:  # nothing to differentiate: skip autograd's dispatch
        out = _product(x2, y, tiles, out_dtype, key)
    return out.reshape(*lead, N)
