"""SSM blocks: Mamba-2 (SSD). Port of the Mamba-2 half of
``repro/models/ssm.py``; mLSTM and sLSTM wait for a later slice.

Training uses the chunkwise-parallel SSD form; decoding uses the O(1)-state
recurrent step. With kernels switched on, the chunked SSD goes through
``kernels.ssd_scan.ssd_chunked`` (the CUDA intra-chunk kernel on a CUDA
tensor); otherwise through the plain :func:`_ssd_chunked` here. The plain
functions keep JAX's rounding order: gate math in f32, ``silu`` as the
port's ``layers.silu``, softplus in f32 as ``jax.nn.softplus`` computes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import kernels as _kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked as _ssd_fast
from repro_torch.models.layers import DTYPE, Dense, _ones, rms_norm, silu

Cache = Dict[str, torch.Tensor]


# ===================================================================== #
# shared helpers
# ===================================================================== #
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (j<=i).

    x: (..., L) -> (..., L, L) lower-triangular log-decay matrix.
    """
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C), w: (W, C), b: (C,)."""
    W = w.shape[0]
    xp = nn.functional.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return out + b


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One causal-conv step. conv_state: (B, W-1, C); x_t: (B, C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, W, C)
    # the dot accumulates in f32 and rounds once, as XLA's bf16 einsum does
    y = torch.einsum("bwc,wc->bc", window.float(), w.float()).to(window.dtype) + b
    return window[:, 1:, :], y


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ===================================================================== #
# Mamba-2 (SSD)
# ===================================================================== #
class Mamba2(nn.Module):
    """Mamba-2 mixer. Projections are separate (z / x / B / C / dt) with the
    JAX leaf names of ``init_mamba2``; ``A_log``, ``D`` and ``dt_bias`` are
    float32, everything else bf16."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.in_z = Dense(d, di, **kw)
        self.in_x = Dense(d, di, **kw)
        self.in_B = Dense(d, g * n, **kw)
        self.in_C = Dense(d, g * n, **kw)
        self.in_dt = Dense(d, nh, **kw)

        def conv_w(c):
            x = torch.randn((cfg.conv_width, c), generator=generator, device=device)
            return nn.Parameter((x * 0.1).to(DTYPE))

        def zeros(c, dtype=DTYPE):
            return nn.Parameter(torch.zeros(c, dtype=dtype, device=device))

        self.conv_x_w, self.conv_x_b = conv_w(di), zeros(di)
        self.conv_B_w, self.conv_B_b = conv_w(g * n), zeros(g * n)
        self.conv_C_w, self.conv_C_b = conv_w(g * n), zeros(g * n)
        self.A_log = zeros(nh, torch.float32)  # A = -exp(A_log) = -1
        self.D = nn.Parameter(torch.ones(nh, dtype=torch.float32, device=device))
        self.dt_bias = zeros(nh, torch.float32)
        self.gate_norm = _ones(di, device)
        self.out_proj = Dense(di, d, **kw)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None, chunk: int = 256):
        return mamba2_apply(self, self.cfg, u, cache, chunk)


def _ssd_chunked(
    x: torch.Tensor,  # (b, l, nh, hp)  (already includes dt scaling)
    dA: torch.Tensor,  # (b, l, nh)      log decay per step (<= 0)
    B: torch.Tensor,  # (b, l, nh, n)
    C: torch.Tensor,  # (b, l, nh, n)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (b, nh, hp, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise SSD (Mamba-2 minimal). Returns (y, final_state)."""
    b, l, nh, hp = x.shape
    n = B.shape[-1]
    assert l % chunk == 0, f"seq {l} % chunk {chunk} != 0"
    nc = l // chunk
    xr = x.reshape(b, nc, chunk, nh, hp).float()
    dAr = dA.reshape(b, nc, chunk, nh).float()
    Br = B.reshape(b, nc, chunk, nh, n).float()
    Cr = C.reshape(b, nc, chunk, nh, n).float()

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dAr.permute(0, 1, 3, 2)))  # (b, nc, nh, cl, cl)
    scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xr)

    # chunk-final states: S_c = sum_j exp(cum_end - cum_j) B_j x_j^T
    cum = torch.cumsum(dAr, dim=2)  # (b, nc, cl, nh)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_c = torch.einsum("bcshn,bcsh,bcshp->bchpn", Br, decay_to_end, xr)

    # inter-chunk recurrence over nc chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, nh)
    S = (init_state.float() if init_state is not None
         else torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device))
    S_in = []
    for c in range(nc):
        S_in.append(S)  # the state ENTERING this chunk
        S = S * chunk_decay[:, c][:, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_in, dim=1)  # (b, nc, nh, hp, n)

    # inter-chunk contribution: y_off_i = (C_i . S_in) * exp(cum_i)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cr, S_in, torch.exp(cum))
    return (y_diag + y_off).reshape(b, l, nh, hp), S


def _heads(t: torch.Tensor, g: int, nh: int) -> torch.Tensor:
    """(..., g * n) -> (..., nh, n): each group shared by nh // g heads (the
    ``jnp.repeat`` of JAX). With one group it is a stride-0 view."""
    n = t.shape[-1] // g
    lead = t.shape[:-1]
    t = t.reshape(*lead, g, 1, n).expand(*lead, g, nh // g, n)
    return t.reshape(*lead, nh, n)


def mamba2_apply(
    p: Mamba2,
    cfg: ModelConfig,
    u: torch.Tensor,  # (b, L, d)
    cache: Optional[Cache] = None,  # {"conv_x", "conv_B", "conv_C": (b, W-1, c), "state": (b, nh, hp, n)}
    chunk: int = 256,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (y (b, L, d), new cache or None). With a cache, L == 1 and the
    cache dict is updated in place (JAX returns a new one)."""
    b, L, d = u.shape
    di, g, nh = cfg.d_inner, cfg.ssm_groups, cfg.n_ssm_heads
    hp = cfg.ssm_head_dim
    z = p.in_z(u)
    xs_r = p.in_x(u)
    B_r = p.in_B(u)
    C_r = p.in_C(u)
    dt_raw = p.in_dt(u)
    A = -torch.exp(p.A_log)  # (nh,)

    if cache is None:
        xs = silu(causal_conv1d(xs_r, p.conv_x_w, p.conv_x_b))
        B = silu(causal_conv1d(B_r, p.conv_B_w, p.conv_B_b))
        C = silu(causal_conv1d(C_r, p.conv_C_w, p.conv_C_b))
        xh = xs.reshape(b, L, nh, hp)
        # B/C widen to f32 per group before the heads share them: the kernel
        # then reads one group's rows through a stride-0 head dim
        Bh, Ch = _heads(B.float(), g, nh), _heads(C.float(), g, nh)
        dt = softplus(dt_raw.float() + p.dt_bias)  # (b, L, nh)
        ssd = _ssd_fast if _kernels.kernels_enabled() else _ssd_chunked
        y, _ = ssd(xh.float() * dt[..., None], dt * A, Bh, Ch, chunk=min(chunk, L))
        y = y + xh.float() * p.D[None, None, :, None]
    else:
        # single-token recurrent step; L == 1
        conv_x, x_t = conv_step(cache["conv_x"], xs_r[:, 0], p.conv_x_w, p.conv_x_b)
        conv_B, B_t = conv_step(cache["conv_B"], B_r[:, 0], p.conv_B_w, p.conv_B_b)
        conv_C, C_t = conv_step(cache["conv_C"], C_r[:, 0], p.conv_C_w, p.conv_C_b)
        x_t, B_t, C_t = silu(x_t), silu(B_t), silu(C_t)
        xh = x_t.reshape(b, nh, hp).float()
        Bh = _heads(B_t, g, nh).float()
        Ch = _heads(C_t, g, nh).float()
        dt = softplus(dt_raw[:, 0].float() + p.dt_bias)  # (b, nh)
        dA = torch.exp(dt * A)  # (b, nh)
        state = cache["state"] * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt, xh, Bh)
        y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p.D[None, :, None]
        y = y[:, None]  # (b, 1, nh, hp)
        cache.update(conv_x=conv_x, conv_B=conv_B, conv_C=conv_C, state=state)
    # gated RMSNorm + out projection
    y = y.reshape(b, L, di).to(u.dtype)
    y = rms_norm(y, p.gate_norm, cfg.rms_eps) * silu(z)
    return p.out_proj(y), cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, device="cuda") -> Cache:
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    W = cfg.conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, di), dtype=DTYPE, device=device),
        "conv_B": torch.zeros((batch, W - 1, g * n), dtype=DTYPE, device=device),
        "conv_C": torch.zeros((batch, W - 1, g * n), dtype=DTYPE, device=device),
        "state": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=torch.float32, device=device),
    }
