"""Plain PyTorch versions of the chunked SSD scan; the port of
``repro/kernels/ssd_scan/ref.py`` plus :func:`ssd_intra_chunk_ref`, the
function the CUDA kernel computes."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_recurrent_ref(
    x: torch.Tensor,  # (b, l, nh, hp) dt-scaled inputs
    dA: torch.Tensor,  # (b, l, nh) log decay per step
    B: torch.Tensor,  # (b, l, nh, n)
    C: torch.Tensor,  # (b, l, nh, n)
    init_state: Optional[torch.Tensor] = None,  # (b, nh, hp, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence: S_t = exp(dA_t) S_{t-1} + x_t B_t^T;
    y_t = S_t C_t. The slowest, most obviously-correct form."""
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    S = (init_state.float() if init_state is not None
         else torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(l):
        S = S * torch.exp(dA[:, t].float())[:, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].float(), B[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", S, C[:, t].float()))
    return torch.stack(ys, dim=1), S


def _segsum(x: torch.Tensor) -> torch.Tensor:
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked_ref(
    x: torch.Tensor,  # (b, l, nh, hp)
    dA: torch.Tensor,  # (b, l, nh)
    B: torch.Tensor,  # (b, l, nh, n)
    C: torch.Tensor,  # (b, l, nh, n)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel form, mathematically equal to ssd_recurrent_ref."""
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    assert l % chunk == 0
    nc = l // chunk
    xr = x.reshape(b, nc, chunk, nh, hp).float()
    dAr = dA.reshape(b, nc, chunk, nh).float()
    Br = B.reshape(b, nc, chunk, nh, n).float()
    Cr = C.reshape(b, nc, chunk, nh, n).float()

    Lmat = torch.exp(_segsum(dAr.permute(0, 1, 3, 2)))  # (b, nc, nh, cl, cl)
    scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xr)

    cum = torch.cumsum(dAr, dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_c = torch.einsum("bcshn,bcsh,bcshp->bchpn", Br, decay_to_end, xr)

    chunk_decay = torch.exp(cum[:, :, -1, :])
    S = (init_state.float() if init_state is not None
         else torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device))
    S_ins = []
    for c in range(nc):
        S_ins.append(S)
        S = S * chunk_decay[:, c][:, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_ins, dim=1)  # (b, nc, nh, hp, n)

    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cr, S_in, torch.exp(cum))
    return (y_diag + y_off).reshape(b, l, nh, hp), S


def ssd_intra_chunk_ref(
    x: torch.Tensor,  # (b, l, nh, hp) f32, dt-scaled
    dA: torch.Tensor,  # (b, l, nh) f32
    B: torch.Tensor,  # (b, l, nh, n) f32
    C: torch.Tensor,  # (b, l, nh, n) f32
    chunk: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``_ssd_kernel`` computes for every (b, h, c) program, in the CUDA
    kernel's layouts: y_diag (b, l, nh, hp), S_c (b, nc, nh, n, hp) and
    dte = exp(cum) (b, l, nh). L is ``exp(cum_i - cum_j)`` masked to j <= i,
    built from the inclusive cumsum as the kernel builds it. Computed in
    ``dtype`` (float64 gives the exact answer the f32 versions are held to)."""
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xr = x.reshape(b, nc, chunk, nh, hp).to(dtype)
    Br = B.reshape(b, nc, chunk, nh, n).to(dtype)
    Cr = C.reshape(b, nc, chunk, nh, n).to(dtype)
    cum = torch.cumsum(dA.reshape(b, nc, chunk, nh).to(dtype), dim=2)  # (b, nc, cl, nh)
    cum_h = cum.permute(0, 1, 3, 2)  # (b, nc, nh, cl)
    live = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.where(live, torch.exp(cum_h[..., :, None] - cum_h[..., None, :]), 0.0)
    scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br)  # C @ B^T
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * L, xr)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, cl, nh)
    S_c = torch.einsum("bcshn,bcshp->bchnp", Br, xr * decay_to_end[..., None])
    return y_diag.reshape(b, l, nh, hp), S_c, torch.exp(cum).reshape(b, l, nh)
