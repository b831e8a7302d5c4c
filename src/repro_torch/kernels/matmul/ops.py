"""Public matmul op: co-design planning, leading dims, autograd (port of
``repro/kernels/matmul/ops.py``).

The CTA tile comes from the co-design layer: :class:`MatmulSpace`
registers the GEMM ``Problem``, tensor-core-aligned ``Constraints`` and the
binding ``legalize`` with ``repro_torch.codesign`` under the name
``matmul_h100``, and :func:`plan_tiles` is a thin wrapper over
``codesign.plan`` (heuristic mapper x timeloop-like model over
``h100_sm()``; the C1 temporal tile is the CTA tile). Plans are cached.

On a CUDA tensor the op launches the CUDA kernel; on a CPU tensor it runs
the plain version (``ref.matmul_ref``). Any other device raises. The
kernel masks ragged edges and reads operands through strides, so no pad
or transposed copy is made. Gradients: two more launches, ``g . y^T`` and
``x^T . g``, with tiles replanned for those shapes, as ``_matmul_bwd``
does in the JAX op.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import codesign
from repro_torch.codesign import KernelSpace, round_up
from repro_torch.core.constraints import tc_aligned
from repro_torch.core.problem import Problem
from repro_torch.kernels.matmul.matmul import BK_MULTIPLE, TILES, matmul_cuda, smem_bytes
from repro_torch.kernels.matmul.ref import matmul_ref

ROW_ALIGN = 64  # one wgmma row group: the M and N alignment the planner works at
DEFAULT_BK = 32


def _pick_tile(b: int, dim: int) -> int:
    """The compiled CTA tile for a dim of ``dim``: ``b`` when it is one and
    not larger than the dim rounded up to a row group, else the largest
    compiled tile within both."""
    cap = max(round_up(dim, ROW_ALIGN), TILES[0])
    if b in TILES and b <= cap:
        return b
    return max(t for t in TILES if t <= max(b, TILES[0]) and t <= cap)


class MatmulSpace(KernelSpace):
    """Co-design space of the CUDA GEMM kernel: shape = (M, N, K),
    BlockConfig = (bm, bn, bk)."""

    name = "matmul_h100"
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
        """BINDING repair into a compiled tile: bm, bn in ``TILES``; bk a
        multiple of 16, at most K rounded up to 16, with the kernel's two
        staged f32 slices within ``smem_budget`` (f32 is the widest input,
        so one plan serves f32 and bf16). Never raises."""
        bm, bn, bk = (int(c) for c in config)
        M, N, K = (int(s) for s in shape)
        budget = int(smem_budget or self.smem_budget)
        bm, bn = _pick_tile(bm, M), _pick_tile(bn, N)
        bk = bk // BK_MULTIPLE * BK_MULTIPLE if bk >= BK_MULTIPLE else DEFAULT_BK
        bk = min(bk, round_up(K, BK_MULTIPLE))
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
            torch.randn((M, K), generator=generator, device=device),
            torch.randn((K, N), generator=generator, device=device),
        )

    def run(self, inputs, config):
        x, y = inputs
        return matmul(x, y, tiles=tuple(config))

    def reference(self, inputs, config):
        return matmul_ref(*inputs)


MATMUL_H100 = codesign.register_space(MatmulSpace())


def planned_shape(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """The shape a GEMM is planned at: M and N rounded up to a row group, K
    to the MMA depth (the JAX op plans at the 128-aligned shape)."""
    return round_up(M, ROW_ALIGN), round_up(N, ROW_ALIGN), round_up(K, BK_MULTIPLE)


@functools.lru_cache(maxsize=512)
def plan_tiles(
    M: int, N: int, K: int, *, mapper: str = "heuristic", budget: int = 400
) -> Tuple[int, int, int]:
    """Plan the GEMM (M, N, K) via ``codesign.plan``; return (bm, bn, bk)."""
    return codesign.plan(
        MATMUL_H100, planned_shape(M, N, K), mapper=mapper, budget=budget
    ).config


def _product(x, y, tiles, out_dtype):
    if x.is_cuda:
        bm, bn, bk = tiles
        return matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
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
        M, K = x.shape
        N = y.shape[1]
        dx = _product(g, y.t(), plan_tiles(M, K, N), x.dtype) if ctx.needs_input_grad[0] else None
        dy = _product(x.t(), g, plan_tiles(K, N, M), y.dtype) if ctx.needs_input_grad[1] else None
        return dx, dy, None, None


def matmul(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    tiles: Optional[Tuple[int, int, int]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C = x . y for any shape; leading dims of ``x`` are flattened into M.
    Differentiable in x and y."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"matmul has no path for device {x.device}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    M = math.prod(lead)
    K = x.shape[-1]
    if y.dim() != 2 or y.shape[0] != K:
        raise ValueError(f"matmul inner dims: x{tuple(x.shape)} y{tuple(y.shape)}")
    N = y.shape[1]
    tiles = tuple(tiles) if tiles is not None else plan_tiles(M, N, K)
    out = _Matmul.apply(x.reshape(M, K), y, tiles, out_dtype)
    return out.reshape(*lead, N)
