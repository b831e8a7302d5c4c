"""Public chunked-SSD op: the CUDA intra-chunk kernel + the inter-chunk
recurrence in plain torch (port of ``repro/kernels/ssd_scan/ops.py``).

Signature matches ``models.ssm._ssd_chunked`` so the model can swap it in.
The chunk length comes from the caller (the model passes ``min(256, l)``,
as JAX's does); without one, :func:`plan_chunk` plans it through the
co-design layer: :class:`SsdScanSpace` registers the intra-chunk score
GEMM with ``repro_torch.codesign`` under the name ``ssd_scan_h100``. Its
``legalize`` is binding on the CUDA kernel's working set (a shared-memory
footprint linear in the chunk: 78.8 KB at cl = 256 with B/C shared by the
heads, the larger of its two instances), not on the JAX VMEM rule, which
picks cl = 512 under 8 MiB. Its ``run`` times the intra-chunk kernel alone;
the whole op is held against ``ssd_chunked_ref`` by ``chip_smoke.py``.

On a CUDA tensor the intra-chunk part launches the kernel; on a CPU tensor
it runs the plain version (``ref.ssd_intra_chunk_ref``). Any other device
raises. The inter-chunk recurrence and the ``y_off`` einsum stay outside
the kernel, as in the JAX op. Differentiable: the backward recomputes
through ``ref.ssd_chunked_ref`` under autograd, as ``_ssd_bwd`` does, inside
the profiler range ``BACKWARD_RANGE``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch import codesign
from repro_torch.codesign import H100_SMEM_BUDGET, KernelSpace
from repro_torch.core.problem import Problem
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_intra_chunk_ref
from repro_torch.kernels.ssd_scan.ssd_scan import MAX_CHUNK, smem_formula, ssd_intra_chunk_cuda

MIN_CHUNK = 64  # the shortest chunk the planner proposes
BACKWARD_RANGE = "ssd_scan.backward"  # profiler range around the plain backward


class SsdScanSpace(KernelSpace):
    """Co-design space of the CUDA SSD intra-chunk kernel: shape = (hp, n),
    BlockConfig = (cl,) -- the chunk length."""

    name = "ssd_scan_h100"
    decode_dims = ("l",)
    grid_dims = ("l",)
    search_budget = 200

    def problem(self, shape):
        hp, n = shape
        # intra-chunk score GEMM C . B^T over the state dim: the chunk
        # appears as both free dims of the cl x cl score block; its proxy
        # extent is the largest chunk the kernel takes
        return Problem.from_einsum(
            "ssd_scores", "ln,mn->lm", {"l": MAX_CHUNK, "m": MAX_CHUNK, "n": n}, "GEMM", 4
        )

    def legalize(self, config, shape, smem_budget=None):
        """BINDING repair: the proposal rounded down to a power of two in
        [64, MAX_CHUNK] (a divisor of any power-of-two sequence), halved
        until the CTA fits ``smem_budget`` with B/C shared by the heads or
        per head. Never raises."""
        (cl,) = (int(c) for c in config)
        _hp, n = shape
        budget = int(smem_budget or self.smem_budget)
        cl = min(max(1 << (max(cl, 1).bit_length() - 1), MIN_CHUNK), MAX_CHUNK)
        while cl > MIN_CHUNK and max(smem_formula(cl, n, s) for s in (False, True)) > budget:
            cl //= 2
        return (cl,)

    def default_config(self, shape):
        return (256,)

    def block_tiles(self, shape, config):
        # the chunk is BOTH free dims of the score block (n stays full)
        (cl,) = config
        return {"l": cl, "m": cl}

    def example_inputs(self, shape, device, generator):
        hp, n = shape
        b, l, nh = 1, MAX_CHUNK, 8

        def randn(*s):
            return torch.randn(s, generator=generator, device=device)

        # B and C one group expanded over the heads, as the model passes them
        return (randn(b, l, nh, hp), -randn(b, l, nh).abs() * 0.1,
                randn(b, l, 1, n).expand(b, l, nh, n), randn(b, l, 1, n).expand(b, l, nh, n))

    def run(self, inputs, config):
        """The intra-chunk kernel alone (the inter-chunk recurrence is eager
        torch and outside the model)."""
        (cl,) = config
        return _intra_chunk(*inputs, min(int(cl), inputs[0].shape[1]))

    def reference(self, inputs, config):
        (cl,) = config
        return ssd_intra_chunk_ref(*inputs, min(int(cl), inputs[0].shape[1]))


SSD_SCAN_H100 = codesign.register_space(SsdScanSpace())


@functools.lru_cache(maxsize=64)
def plan_chunk(hp: int, n: int, smem_budget: int = H100_SMEM_BUDGET) -> int:
    """Plan the chunk length via ``codesign.plan`` (legalize is binding:
    a power-of-two chunk whose CTA fits ``smem_budget``)."""
    return codesign.plan(SSD_SCAN_H100, (hp, n), smem_budget=smem_budget).config[0]


def _intra_chunk(x, dA, B, C, chunk):
    if x.is_cuda:
        return ssd_intra_chunk_cuda(x, dA, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dA, B, C, chunk)
    raise ValueError(f"the SSD scan has no path for device {x.device}")


def _ssd_impl(x, dA, B, C, s0, chunk):
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    nc = l // chunk
    y_diag, S_c, dte = _intra_chunk(x, dA, B, C, chunk)  # S_c: (b, nc, nh, n, hp)
    dte = dte.reshape(b, nc, chunk, nh)
    chunk_decay = dte[:, :, -1]  # (b, nc, nh) = exp(full-chunk decay)
    S = s0.transpose(-1, -2)  # (b, nh, n, hp)
    S_ins = []
    for c in range(nc):
        S_ins.append(S)  # the state ENTERING chunk c
        S = S * chunk_decay[:, c][:, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_ins, dim=1)  # (b, nc, nh, n, hp)
    # inter-chunk contribution: y_off[l] = (C_l . S_in) * exp(cum_l)
    y_off = torch.einsum("bclhn,bchnp,bclh->bclhp", C.reshape(b, nc, chunk, nh, n), S_in, dte)
    return y_diag + y_off.reshape(b, l, nh, hp), S.transpose(-1, -2).contiguous()


class _SsdChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dA, B, C, s0, chunk):
        ctx.save_for_backward(x, dA, B, C, s0)
        ctx.chunk = chunk
        return _ssd_impl(x, dA, B, C, s0, chunk)

    @staticmethod
    def backward(ctx, gy, gS):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # the range lets a profile attribute the plain backward's device time
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            y, S = ssd_chunked_ref(*inputs[:4], chunk=ctx.chunk, init_state=inputs[4])
            grads = torch.autograd.grad((y, S), inputs, (gy, gS))
        return (*grads, None)


def ssd_chunked(
    x: torch.Tensor,  # (b, l, nh, hp) dt-scaled inputs (f32 or bf16)
    dA: torch.Tensor,  # (b, l, nh)
    B: torch.Tensor,  # (b, l, nh, n); may be expanded over heads with stride 0
    C: torch.Tensor,  # (b, l, nh, n)
    chunk: Optional[int] = None,
    init_state: Optional[torch.Tensor] = None,  # (b, nh, hp, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, l, nh, hp) f32, final_state (b, nh, hp, n) f32)."""
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    chunk = chunk or min(plan_chunk(hp, n), l)
    if l % chunk:
        raise ValueError(f"seq {l} % chunk {chunk} != 0")
    s0 = (init_state.float() if init_state is not None
          else torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device))
    return _SsdChunked.apply(x.float(), dA.float(), B.float(), C.float(), s0, chunk)
