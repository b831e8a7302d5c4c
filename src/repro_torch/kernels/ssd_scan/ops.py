"""Public chunked-SSD op: the CUDA intra-chunk kernel + the inter-chunk
recurrence in plain torch (port of ``repro/kernels/ssd_scan/ops.py``).

Signature matches ``models.ssm._ssd_chunked`` so the model can swap it in.
The chunk length comes from the caller (the model passes ``min(256, l)``);
without one, :func:`plan_chunk` applies a fixed rule. Planning the chunk on
an H100 hierarchy comes with the port's codesign layer (ROADMAP A2).

On a CUDA tensor the intra-chunk part launches the kernel; on a CPU tensor
it runs the plain version (``ref.ssd_intra_chunk_ref``). Any other device
raises. The inter-chunk recurrence and the ``y_off`` einsum stay outside
the kernel, as in the JAX op. Differentiable: the backward recomputes
through ``ref.ssd_chunked_ref`` under autograd, as ``_ssd_bwd`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.codesign import repair_tile
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_intra_chunk_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda

DEFAULT_CHUNK = 256


def plan_chunk(l: int) -> int:
    """Chunk length for a sequence of ``l`` steps: 256 when it divides
    ``l``, else the largest divisor reached by halving ``min(256, l)``. A
    fixed rule, like ``flash_attention.ops.plan_blocks``; planning the chunk
    on an H100 hierarchy comes with the codesign layer (ROADMAP A2)."""
    return repair_tile(DEFAULT_CHUNK, l, DEFAULT_CHUNK, min_tile=1)


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
        with torch.enable_grad():
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
    chunk = chunk or plan_chunk(l)
    if l % chunk:
        raise ValueError(f"seq {l} % chunk {chunk} != 0")
    s0 = (init_state.float() if init_state is not None
          else torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device))
    return _SsdChunked.apply(x.float(), dA.float(), B.float(), C.float(), s0, chunk)
