"""SSM / recurrent blocks: Mamba-2 (SSD), mLSTM and sLSTM (xLSTM). Port of
``repro/models/ssm.py``.

Training uses the chunkwise-parallel forms; decoding uses the O(1)-state
recurrent steps. With kernels switched on, the chunked SSD goes through
``kernels.ssd_scan.ssd_chunked`` (the CUDA intra-chunk kernel on a CUDA
tensor); otherwise through the plain :func:`_ssd_chunked` here. mLSTM and
sLSTM are plain torch, as the reference computes them in plain ``jnp``
outside any Pallas call: the scans over chunks (mLSTM) and positions
(sLSTM) are Python loops. The functions keep JAX's rounding order: gate
math in f32, ``silu`` and ``gelu`` as the port's ``layers`` versions,
softplus in f32 as ``jax.nn.softplus`` computes it (and ``log_sigmoid`` as
``-softplus(-x)``), bf16 constants rounded to bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import kernels as _kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked as _ssd_fast
from repro_torch.models.layers import DTYPE, WHOLE, Dense, Products, _ones, gelu, silu

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


def _conv_w(width: int, c: int, generator: Optional[torch.Generator], device) -> nn.Parameter:
    """A depthwise conv's (width, c) taps, N(0, 0.1^2) in bf16, as JAX draws them."""
    x = torch.randn((width, c), generator=generator, device=device)
    return nn.Parameter((x * 0.1).to(DTYPE))


def _zeros(c: int, device, dtype=DTYPE) -> nn.Parameter:
    return nn.Parameter(torch.zeros(c, dtype=dtype, device=device))


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
        W = cfg.conv_width
        self.conv_x_w, self.conv_x_b = _conv_w(W, di, generator, device), _zeros(di, device)
        self.conv_B_w, self.conv_B_b = _conv_w(W, g * n, generator, device), _zeros(g * n, device)
        self.conv_C_w, self.conv_C_b = _conv_w(W, g * n, generator, device), _zeros(g * n, device)
        self.A_log = _zeros(nh, device, torch.float32)  # A = -exp(A_log) = -1
        self.D = nn.Parameter(torch.ones(nh, dtype=torch.float32, device=device))
        self.dt_bias = _zeros(nh, device, torch.float32)
        self.gate_norm = _ones(di, device)
        self.out_proj = Dense(di, d, **kw)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None, chunk: int = 256,
                products: Products = WHOLE):
        return mamba2_apply(self, self.cfg, u, cache, chunk, products)


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
    products: Products = WHOLE,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (y (b, L, d), new cache or None). With a cache, L == 1 and the
    cache dict is updated in place (JAX returns a new one).

    Under tensor parallelism (``products`` of ``sharding/partition.py``: the
    train step's, with no cache, or the decode step's) the leaves hold this
    rank's heads: ``in_z``/``in_x``/``in_dt``
    columns, the x conv's channels, ``A_log``/``D``/``dt_bias``, the
    ``gate_norm`` slice and ``out_proj`` rows; ``in_B``/``in_C`` and their
    convs hold the groups those heads read (in decode every group; the
    cache may split their conv windows by channel). The head and group
    counts are the weights'."""
    hp = cfg.ssm_head_dim
    z, xs_r, B_r, C_r, dt_raw = products.columns(u, (p.in_z, p.in_x, p.in_B, p.in_C, p.in_dt))
    b, L = z.shape[:2]
    nh = dt_raw.shape[-1]
    di, g = nh * hp, B_r.shape[-1] // cfg.ssm_state
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
        def conv(state, x_t, w, bias):
            """A conv window that holds fewer channels than ``x_t`` (a
            partitioned decode's cache: this rank's) steps on those, and
            the step's outputs are gathered over the ranks."""
            c = state.shape[-1]
            if c == x_t.shape[-1]:
                return conv_step(state, x_t, w, bias)
            lo = products.first(c)
            state, y = conv_step(state, x_t[:, lo:lo + c], w[:, lo:lo + c], bias[lo:lo + c])
            return state, products.gather(y)

        conv_x, x_t = conv(cache["conv_x"], xs_r[:, 0], p.conv_x_w, p.conv_x_b)
        conv_B, B_t = conv(cache["conv_B"], B_r[:, 0], p.conv_B_w, p.conv_B_b)
        conv_C, C_t = conv(cache["conv_C"], C_r[:, 0], p.conv_C_w, p.conv_C_b)
        x_t, B_t, C_t = silu(x_t), silu(B_t), silu(C_t)
        xh = x_t.reshape(b, nh, hp).float()
        # every head's B/C (the groups are whole here), then this call's heads
        g, h0 = B_t.shape[-1] // cfg.ssm_state, products.first(nh)
        Bh = _heads(B_t, g, cfg.n_ssm_heads)[:, h0:h0 + nh].float()
        Ch = _heads(C_t, g, cfg.n_ssm_heads)[:, h0:h0 + nh].float()
        dt = softplus(dt_raw[:, 0].float() + p.dt_bias)  # (b, nh)
        dA = torch.exp(dt * A)  # (b, nh)
        state = cache["state"] * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt, xh, Bh)
        y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p.D[None, :, None]
        y = y[:, None]  # (b, 1, nh, hp)
        cache.update(conv_x=conv_x, conv_B=conv_B, conv_C=conv_C, state=state)
    # gated RMSNorm (over the whole d_inner) + out projection
    y = y.reshape(b, L, di).to(u.dtype)
    y = products.wide_norm(y, p.gate_norm, cfg.rms_eps, cfg.d_inner) * silu(z)
    return products.rows(y, p.out_proj), cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, device="cuda") -> Cache:
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    W = cfg.conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, di), dtype=DTYPE, device=device),
        "conv_B": torch.zeros((batch, W - 1, g * n), dtype=DTYPE, device=device),
        "conv_C": torch.zeros((batch, W - 1, g * n), dtype=DTYPE, device=device),
        "state": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=torch.float32, device=device),
    }


# ===================================================================== #
# mLSTM (xLSTM): matrix memory with exponential gating
# ===================================================================== #
class MLSTM(nn.Module):
    """mLSTM mixer with the JAX leaf names of ``init_mlstm``: ``up`` (d ->
    2 di: the cell input and the output gate), a causal conv, q/k/v (di ->
    di), the input and forget gate projections (d -> nh, with bias), the
    output norm and ``down``."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.up = Dense(d, 2 * di, **kw)
        self.conv_w = _conv_w(cfg.conv_width, di, generator, device)
        self.conv_b = _zeros(di, device)
        self.wq = Dense(di, di, **kw)
        self.wk = Dense(di, di, **kw)
        self.wv = Dense(di, di, **kw)
        self.w_i = Dense(d, nh, bias=True, **kw)
        self.w_f = Dense(d, nh, bias=True, **kw)
        self.out_norm = _ones(di, device)
        self.down = Dense(di, d, **kw)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None, chunk: int = 256,
                products: Products = WHOLE):
        return mlstm_apply(self, self.cfg, u, cache, chunk, products)


def _mlstm_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # (b, l, nh, dh)
    ilog: torch.Tensor, flog: torch.Tensor,  # (b, l, nh) raw i, log-sigmoid f
    chunk: int,
    init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,  # (C, n, m)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Chunkwise mLSTM in f32: within a chunk, attention-like weights
    exp(D - m_i) with the per-position stabiliser m_i = max(cf + m_prev,
    m_intra); across chunks, the (C, n, m) carry, starting at m = -inf.
    Returns (y (b, l, nh, dh), final (C, n, m))."""
    b, l, nh, dh = q.shape
    if l % chunk:
        raise ValueError(f"seq {l} % chunk {chunk} != 0")
    nc = l // chunk
    sc = 1.0 / math.sqrt(dh)
    qr = (q.float() * sc).reshape(b, nc, chunk, nh, dh)
    kr = k.float().reshape(b, nc, chunk, nh, dh)
    vr = v.float().reshape(b, nc, chunk, nh, dh)
    ir = ilog.float().reshape(b, nc, chunk, nh)
    fr = flog.float().reshape(b, nc, chunk, nh)
    cf = torch.cumsum(fr, dim=2)  # inclusive cumulative log-forget
    if init is None:
        C = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, nh, dh), dtype=torch.float32, device=q.device)
        m = torch.full((b, nh), -torch.inf, dtype=torch.float32, device=q.device)
    else:
        C, n, m = init

    # intra-chunk log weights: D[i, j] = cf_i - cf_j + ilog_j (j <= i), -inf above
    Dmat = _segsum(fr.permute(0, 1, 3, 2)) + ir.permute(0, 1, 3, 2)[:, :, :, None, :]
    m_intra = Dmat.amax(dim=-1)  # (b, nc, nh, cl)
    ys = []
    for c in range(nc):
        qc, kc, vc = qr[:, c], kr[:, c], vr[:, c]
        cfc, irc, Dm = cf[:, c], ir[:, c], Dmat[:, c]
        b_i = cfc.permute(0, 2, 1) + m[:, :, None]  # (b, nh, cl)
        m_i = torch.maximum(b_i, m_intra[:, c])
        inter_scale = torch.exp(b_i - m_i)
        num_inter = torch.einsum("blhd,bhde->bhle", qc, C) * inter_scale[..., None]
        den_inter = torch.einsum("blhd,bhd->bhl", qc, n) * inter_scale
        W = torch.einsum("blhd,bshd->bhls", qc, kc) * torch.exp(Dm - m_i[..., None])
        num = num_inter + torch.einsum("bhls,bshd->bhld", W, vc)
        den = den_inter + W.sum(dim=-1)
        h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
        ys.append(h.permute(0, 2, 1, 3))  # (b, cl, nh, dh)
        # chunk-boundary state update
        total = cfc[:, -1, :]  # (b, nh)
        gk = total[:, None, :] - cfc + irc  # (b, cl, nh)
        m_next = torch.maximum(total + m, gk.amax(dim=1))
        scale_old = torch.exp(total + m - m_next)
        gke = torch.exp(gk - m_next[:, None, :])
        C = C * scale_old[:, :, None, None] + torch.einsum("blh,blhd,blhe->bhde", gke, kc, vc)
        n = n * scale_old[:, :, None] + torch.einsum("blh,blhd->bhd", gke, kc)
        m = m_next
    return torch.stack(ys, dim=1).reshape(b, l, nh, dh), (C, n, m)


def mlstm_apply(
    p: MLSTM,
    cfg: ModelConfig,
    u: torch.Tensor,  # (b, L, d)
    cache: Optional[Cache] = None,  # {"conv": (b, W-1, di), "C": (b, nh, dh, dh), "n", "m"}
    chunk: int = 256,
    products: Products = WHOLE,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (y (b, L, d), the cache or None). Without a cache, the
    chunked form over chunks of min(chunk, L) (L must divide into them);
    with one, L == 1 and the cache dict is updated in place (JAX returns a
    new one).

    Under tensor parallelism (``products`` of ``sharding/partition.py``; no
    cache) the leaves hold this rank's heads: ``up``'s columns of their
    channels in each half, ``w_i``/``w_f`` columns, ``wq``/``wk``/``wv``
    columns, the ``out_norm`` slice and ``down`` rows; the conv is whole.
    The cell input is computed on this rank's channels and gathered whole
    (``products.gather``): every q/k/v head reads all of it. The head
    count is the gates'.

    The partitioned decode (``Partition.decode``) gives ``up``'s channels
    of this rank's heads, the conv window and taps of those channels, the
    ``out_norm`` slice and ``down`` rows of them, and either this rank's
    heads of the rest (the cache split by head) or every head's slice of
    dk in ``wq``/``wk`` with ``v`` and the gates whole (the cache split
    along dk: ``C``/``n`` slices, ``m`` whole). The cell input and the
    conv's output are gathered over the ranks' channels
    (``products.gather``); along dk the partial sums of ``q . C`` and
    ``q . n`` are summed over the ranks before the stabiliser's max
    (``products.contracted``) and the output, whole, is cut to this
    rank's channels (``products.slice_dk``)."""
    dh = cfg.d_inner // cfg.n_heads
    ag, i_raw, f_raw = products.columns(u, (p.up, p.w_i, p.w_f))
    a, gate = ag.chunk(2, dim=-1)
    b, L, nh = i_raw.shape
    ilog = i_raw.float()  # (b, L, nh)
    flog = -softplus(-f_raw.float())  # jax.nn.log_sigmoid
    if cache is None:
        a = products.gather(a)
        c = silu(causal_conv1d(a, p.conv_w, p.conv_b))
        q = p.wq(c).reshape(b, L, nh, dh)
        k = p.wk(c).reshape(b, L, nh, dh)
        v = p.wv(a).reshape(b, L, nh, dh)
        y, _ = _mlstm_chunked(q, k, v, ilog, flog, chunk=min(chunk, L))
    else:
        conv, c_t = conv_step(cache["conv"], a[:, 0], p.conv_w, p.conv_b)
        # every rank's channels of the cell input and the conv's output
        a_t, c_t = products.gather(torch.stack([a[:, 0], silu(c_t)], dim=1)).unbind(1)
        # q is scaled in its own dtype (sqrt(dh) rounded to it, as JAX's weak
        # constant is), THEN widened; the chunked path widens first. A
        # partitioned decode gives q and k this rank's heads, or every
        # head's slice of dk (the cache split along it)
        root = torch.tensor(math.sqrt(dh), dtype=c_t.dtype).item()
        q, k = products.columns(c_t, (p.wq, p.wk))
        q = (q.reshape(b, nh, -1) / root).float()
        k = k.reshape(b, nh, -1).float()
        v = products.columns(a_t, (p.wv,))[0].reshape(b, nh, -1).float()
        i_t, f_t = ilog[:, 0], flog[:, 0]  # (b, nh)
        m_prev, C_prev, n_prev = cache["m"], cache["C"], cache["n"]
        m_new = torch.maximum(f_t + m_prev, i_t)
        fp = torch.exp(f_t + m_prev - m_new)
        ip = torch.exp(i_t - m_new)
        C_new = C_prev * fp[:, :, None, None] + ip[:, :, None, None] * (
            k[:, :, :, None] * v[:, :, None, :])
        n_new = n_prev * fp[:, :, None] + ip[:, :, None] * k
        num = torch.einsum("bhd,bhde->bhe", q, C_new)
        den = torch.einsum("bhd,bhd->bh", q, n_new)
        num, den = products.contracted(num, den)
        y = (num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])[:, None]
        cache.update(conv=conv, C=C_new, n=n_new, m=m_new)
    y = products.slice_dk(y.reshape(b, L, nh * dh).to(u.dtype))
    y = products.wide_norm(y, p.out_norm, cfg.rms_eps, cfg.d_inner) * silu(gate)
    return products.rows(y, p.down), cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Cache:
    """The stabiliser m starts at -1e30, not -inf (as the chunked form's
    carry does) and not 0: the first step's m is then its input gate."""
    di, nh = cfg.d_inner, cfg.n_heads
    dh = di // nh
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=DTYPE, device=device),
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


# ===================================================================== #
# sLSTM (xLSTM): scalar memory, per-head block-diagonal recurrence
# ===================================================================== #
class SLSTM(nn.Module):
    """sLSTM mixer with the JAX leaf names of ``init_slstm``: ``wx`` (the
    z, i, f, o input paths, d -> 4d with bias), the per-head recurrent
    matrices ``r`` (4, nh, hd, hd), the output norm and a gelu FFN of width
    round(4d / 3 / 64) * 64."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        ffw = int(round(4 * d / 3 / 64)) * 64
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.wx = Dense(d, 4 * d, bias=True, **kw)
        r = torch.randn((4, nh, hd, hd), generator=generator, device=device)
        self.r = nn.Parameter((r * (1.0 / math.sqrt(d))).to(DTYPE))
        self.out_norm = _ones(d, device)
        self.ffn_up = Dense(d, ffw, **kw)
        self.ffn_down = Dense(ffw, d, **kw)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None, products: Products = WHOLE):
        return slstm_apply(self, self.cfg, u, cache, products)


def _slstm_cell(carry, gx: torch.Tensor, rw: torch.Tensor):
    """One sLSTM step. carry: (c, n, h, m), each (b, nh, hd) f32; gx: (b, 4,
    nh, hd) the input paths; rw: (nh, hd, 4 hd) f32, the recurrent matrices
    ``r`` (4, nh, hd, hd) as one operand per head (``_recurrent``)."""
    c, n, h, m = carry
    b, nh, hd = h.shape
    rec = torch.bmm(h.transpose(0, 1), rw).view(nh, b, 4, hd).permute(1, 2, 0, 3)  # (b, 4, nh, hd)
    z_r, i_r, f_r, o_r = [(gx[:, g] + rec[:, g]).float() for g in range(4)]
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    m_new = torch.maximum(f_r + m, i_r)
    ip = torch.exp(i_r - m_new)
    fp = torch.exp(f_r + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def _recurrent(r: torch.Tensor) -> torch.Tensor:
    """(4, nh, hd, hd) -> (nh, hd, 4 hd) f32, made once per call: inside the
    loop ``einsum("bhd,ghde->bghe")`` copied ``r`` so at every position,
    and autograd kept each copy for the backward (16 GiB a rank over 4096
    positions of one head at full width). The same products, bit for bit."""
    nh, hd = r.shape[1], r.shape[2]
    return r.float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)


def slstm_apply(
    p: SLSTM,
    cfg: ModelConfig,
    u: torch.Tensor,  # (b, L, d)
    cache: Optional[Cache] = None,  # {"c", "n", "h", "m"}: (b, nh, hd) f32
    products: Products = WHOLE,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (y (b, L, d), the cache or None). Without a cache, a loop
    over the L positions from (0, 0, 0, -1e30); with one, L == 1 and the
    cache dict is updated in place.

    Under tensor parallelism (``products`` of ``sharding/partition.py``; no
    cache) the leaves hold this rank's heads: ``wx``'s z/i/f/o columns of
    them, ``r[:, heads]``, the ``out_norm`` slice; the loop runs on those
    heads alone. The normed output is gathered over the channels
    (``products.gather``) for the column ``ffn_up`` and the row
    ``ffn_down``. The head count is ``r``'s. The partitioned decode
    gives this rank's heads as in training (the cache split by head), or
    ``wx`` and ``r`` whole with a cache split along hd: the ranks'
    ``c``/``n``/``h`` slices are gathered (``products.whole_dk``: the
    recurrent product reads every hd of a head), the cell runs whole
    (``m`` is whole), and each rank keeps its slices of the state and its
    channels of the output (``products.slice_dk``) for the ``out_norm``
    slice."""
    nh, hd = p.r.shape[1], cfg.d_model // cfg.n_heads
    gx = products.columns(u, (p.wx,))[0]
    b, L = gx.shape[:2]
    gx = gx.reshape(b, L, 4, nh, hd)
    r = _recurrent(p.r)
    if cache is None:
        zero = torch.zeros((b, nh, hd), dtype=torch.float32, device=u.device)
        carry = (zero, zero, zero, torch.full((b, nh, hd), -1e30, dtype=torch.float32,
                                              device=u.device))
        hs = []
        for t in range(L):
            carry = _slstm_cell(carry, gx[:, t], r)
            hs.append(carry[2])
        y = torch.stack(hs, dim=1).reshape(b, L, nh * hd)
    else:
        c, n, h = products.whole_dk(cache["c"], cache["n"], cache["h"])
        c, n, h, m = _slstm_cell((c, n, h, cache["m"]), gx[:, 0], r)
        y = h.reshape(b, 1, nh * hd)
        cache.update(c=products.slice_dk(c), n=products.slice_dk(n), h=products.slice_dk(h), m=m)
    y = products.slice_dk(y.to(u.dtype))
    y = products.gather(products.wide_norm(y, p.out_norm, cfg.rms_eps, cfg.d_model))
    return products.rows(gelu(p.ffn_up(y)), p.ffn_down), cache


def init_slstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Cache:
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zero, "n": zero.clone(), "h": zero.clone(),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device)}
