"""Core layers: norms, RoPE, dense, chunked attention (GQA), MLA, MLP.

Port of ``repro/models/layers.py``. The plain functions keep the JAX names
and rounding order (f32 where JAX computes in f32, bf16 where it rounds to
bf16); the parameterised layers are ``nn.Module``s whose attribute names
mirror the JAX params pytree, so ``models.convert`` maps one onto the other
by name. Weights keep JAX's (d_in, d_out) layout: ``dense`` is ``x @ w``.
Attention uses a q-chunked full-softmax reference; with kernels switched on
it goes to the flash-attention op instead (the kernel on a CUDA tensor).
MLA (DeepSeek-V2's latent-compressed KV cache) attends through the same
``mha`` at d = nope + rope and dv = v_head_dim.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import kernels as _kernels
from repro_torch.configs.base import ModelConfig

DTYPE = torch.bfloat16
NEG_INF = -1e30


def _randn(shape, scale: float, generator: Optional[torch.Generator], device) -> nn.Parameter:
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return nn.Parameter((x * scale).to(DTYPE))


def _ones(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=DTYPE, device=device))


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
def normed(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` before its weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return normed(x, eps) * w


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.dtype != w.dtype:  # promote as jnp does, e.g. a bf16 attention output into f32 weights
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * 1 / (1 + exp(-x))`` with every step rounded to ``x``'s dtype:
    the order in which XLA evaluates ``jax.nn.silu``. ``F.silu`` rounds once
    and gives another bf16 value for ~40% of inputs, which moves greedy
    tokens off the reference's."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form in XLA's order: every step, and
    each constant, rounded to ``x``'s dtype."""
    c0 = torch.tensor(0.044715, dtype=x.dtype).item()
    c1 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    inner = c1 * (x + c0 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu}[name]


class Products:
    """How a module computes its column products (``x`` through several
    weights split by output features), its row product (a weight split by
    input features) and its norms: whole, as here. ``Attention``, ``MLA``,
    ``MLP``, ``MoE``, ``Mamba2``, ``MLSTM`` and ``SLSTM`` take one; the
    partitioned train step gives them its tensor-parallel products
    (``sharding/partition.py``), which take this rank's sequence shard in
    and give this rank's shard of the residual back, and whose norms sum
    their weights' grads over the ranks' heads or tokens. The MoE also takes the whole sequence of a
    shard (``whole``), the offset of this rank's experts (``first``), every
    rank's expert outputs (``experts``), its routed sum (``routed``) and
    this rank's shard of a whole sequence (``shard``); attention and MLA
    write and read a decode cache through ``cache_write`` and ``attend``,
    which the partitioned decode step (``Partition.decode``) gives a cache
    split by head or by sequence, and take their positions, keys and
    attention through ``positions``, ``keys`` and ``attention``, which
    context parallelism gives this rank's query shard against every key;
    the xLSTM decode over a cache split along dk sums its contractions over
    the ranks (``contracted``), gathers its state's slices (``whole_dk``)
    and keeps this rank's (``slice_dk``); Mamba-2's gated norm and the mLSTM and sLSTM
    output norms sum their squares over the ranks' channels
    (``wide_norm``), and mLSTM's cell input and sLSTM's normed output are
    gathered over them (``gather``)."""

    @staticmethod
    def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(x, w, eps)

    @staticmethod
    def wide_norm(x: torch.Tensor, w: torch.Tensor, eps: float, width: int) -> torch.Tensor:
        """``rms_norm`` over ``width`` features, of which ``x`` (and ``w``)
        hold this rank's."""
        return rms_norm(x, w, eps)

    @staticmethod
    def columns(x: torch.Tensor, mods) -> list:
        return [m(x) for m in mods]

    @staticmethod
    def rows(y: torch.Tensor, mod: "Dense") -> torch.Tensor:
        return mod(y)

    @staticmethod
    def whole(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def gather(x: torch.Tensor) -> torch.Tensor:
        """Every rank's features of ``x`` side by side (the last dim)."""
        return x

    @staticmethod
    def shard(y: torch.Tensor) -> torch.Tensor:
        return y

    @staticmethod
    def first(n_local: int) -> int:
        return 0

    @staticmethod
    def experts(out: torch.Tensor) -> torch.Tensor:
        return out

    @staticmethod
    def routed(y: torch.Tensor) -> torch.Tensor:
        """The MoE's routed sum, complete here (a partitioned decode sums
        the ranks' partial sums of their experts)."""
        return y

    @staticmethod
    def cache_write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                    cache_len: int) -> int:
        """Write each of ``new`` (b, S, ...) into ``cache`` at ``cache_len``
        IN PLACE (JAX returns a new cache from dynamic_update_slice; here the
        caller's cache tensors are updated); returns the length of the
        cache to attend over. A partitioned decode writes where this rank's
        shard of the cache holds the positions."""
        for name, t in new.items():
            S = t.shape[1]
            if cache_len + S > cache[name].shape[1]:
                raise ValueError(f"cache of {cache[name].shape[1]} slots cannot take "
                                 f"{S} token(s) at position {cache_len}")
            cache[name][:, cache_len:cache_len + S] = t
        return cache_len + S

    @staticmethod
    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int, kv_len: int,
               sm_scale: Optional[float] = None) -> torch.Tensor:
        """The new tokens' attention over the cache (``cache_write``'s
        length); a partitioned decode merges the shards' partials."""
        return mha(q, k, v, causal=False, q_offset=q_offset, kv_len=kv_len, sm_scale=sm_scale)

    @staticmethod
    def positions(positions: torch.Tensor, S: int) -> torch.Tensor:
        """The global positions of this call's ``S`` tokens; context
        parallelism gives this rank's shard of the sequence's."""
        return positions

    @staticmethod
    def keys(*ts: torch.Tensor) -> tuple:
        """Every position's keys and values (or MLA's latent and rope key);
        context parallelism gathers them over the ranks' sequence shards."""
        return ts

    @staticmethod
    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
        """Attention of this call's queries over ``keys``' keys (no cache);
        context parallelism offsets the queries to this rank's shard."""
        return mha(q, k, v, causal=causal, q_offset=0, sm_scale=sm_scale)

    @staticmethod
    def contracted(*xs: torch.Tensor) -> tuple:
        """Sums over a contraction whose dim a partitioned decode splits over
        the ranks (an mLSTM cache split along dk): summed over them; whole
        here."""
        return xs

    @staticmethod
    def whole_dk(*xs: torch.Tensor) -> tuple:
        """Recurrent states whose last dim (a head's dk or hd) a partitioned
        decode splits over the ranks: every rank's slices side by side;
        whole here."""
        return xs

    @staticmethod
    def slice_dk(x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``x``'s last dim where a partitioned decode
        splits a head's dk or hd over the ranks; ``x`` here."""
        return x


WHOLE = Products()


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` of shape (d_in, d_out), as in JAX."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        self.w = _randn((d_in, d_out), 1.0 / math.sqrt(d_in), generator, device)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=DTYPE, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, dim//2) f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (b, S, h, d); cos/sin: (b, S, d//2) or (S, d//2)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# chunked multi-head attention with GQA grouping
# --------------------------------------------------------------------- #
def _auto_q_chunk(B: int, Sq: int, Skv: int, hq: int, budget: int = 1 << 31) -> int:
    """The q-chunk (the temporal tile of the attention problem's q dim) of
    the plain path: halved from 1024 (down to 128) until the f32 score
    chunk of one rank's batch and heads fits ``budget`` bytes inside a hint
    context (the reference's rule); 1024 outside one. The reference takes
    the global batch and divides it over dp, and the heads over tp; the
    port's ``mha`` is given one rank's tensors (the partitioned train step
    computes this dp rank's rows on this tp rank's heads), so B and hq are
    taken as they are."""
    from repro_torch.sharding import hints as _h

    qc = 1024
    if not _h._STATE["enabled"]:
        return qc
    while qc > 128 and B * qc * Skv * hq * 4 > budget:
        qc //= 2
    return qc


def mha(
    q: torch.Tensor,  # (b, Sq, hq, d)
    k: torch.Tensor,  # (b, Skv, hkv, d)
    v: torch.Tensor,  # (b, Skv, hkv, dv)
    *,
    causal: bool,
    q_offset: int = 0,  # global position of q[:, 0]
    kv_len: Optional[int] = None,  # valid cache length (decode)
    q_chunk: Optional[int] = None,  # the plain path's; None: _auto_q_chunk's
    sm_scale: Optional[float] = None,
    return_lse: bool = False,  # decode: (out, the rows' f32 log-sum-exp (b, Sq, hq))
):
    """With ``return_lse`` a row with no live key gives zeros and a
    log-sum-exp of -inf (a shard of a cache that holds none of its keys)."""
    b, Sq, hq, d = q.shape
    _, Skv, hkv, dv = v.shape
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if _kernels.kernels_enabled():  # the flash kernel takes no q chunk
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, sm_scale=scale,
            return_lse=return_lse,
        )
    if q_chunk is None:
        q_chunk = _auto_q_chunk(b, Sq, Skv, hq)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kpos = torch.arange(Skv, device=q.device)
    kf = k.float()

    def attend(qc: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        # qc: (b, c, hq, d); qpos: (c,) global positions. bf16 products are
        # exact in f32: this is JAX's preferred_element_type=f32 score.
        s = torch.einsum("bchd,bkhd->bhck", qc.float(), kf) * scale
        mask = torch.ones((qc.shape[1], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bhck,bkhd->bchd", p, v)
        if not return_lse:
            return out
        live = mask.any(dim=-1)  # (c,)
        lse = torch.where(live[None, None], torch.logsumexp(s, dim=-1), -torch.inf)
        return torch.where(live[None, :, None, None], out, 0.0), lse.permute(0, 2, 1)

    if return_lse:
        if Sq > q_chunk:
            raise ValueError(f"Sq={Sq}: the log-sum-exp is returned for one q chunk")
        return attend(q, q_offset + torch.arange(Sq, device=q.device))
    if Sq <= q_chunk:
        return attend(q, q_offset + torch.arange(Sq, device=q.device))
    if Sq % q_chunk:
        raise ValueError(f"Sq={Sq} must be a multiple of q_chunk={q_chunk}")
    outs = [
        attend(q[:, i:i + q_chunk], q_offset + i + torch.arange(q_chunk, device=q.device))
        for i in range(0, Sq, q_chunk)
    ]
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------- #
# GQA attention layer (with optional qk-norm, bias, KV cache)
# --------------------------------------------------------------------- #
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.wq = Dense(d, hq * hd, cfg.qkv_bias, **kw)
        self.wk = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wv = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wo = Dense(hq * hd, d, **kw)
        if cfg.qk_norm:
            self.q_norm = _ones(hd, device)
            self.k_norm = _ones(hd, device)

    def forward(
        self,
        x: torch.Tensor,  # (b, S, d)
        positions: torch.Tensor,  # (S,) global positions of x
        cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"}: (b, Smax, hkv, hd)
        cache_len: Optional[int] = None,  # filled length of the cache before this call
        products: Products = WHOLE,
    ) -> torch.Tensor:
        cfg = self.cfg
        # the head counts of the weights this call is given: the config's, or
        # one rank's under tensor parallelism (``sharding/partition.py``)
        hd = cfg.head_dim
        q, k, v = products.columns(x, (self.wq, self.wk, self.wv))
        # a partitioned decode gathers the new token's columns: every head
        hq, hkv = q.shape[-1] // hd, k.shape[-1] // hd
        b, S = q.shape[:2]
        q = q.reshape(b, S, hq, hd)
        k = k.reshape(b, S, hkv, hd)
        v = v.reshape(b, S, hkv, hd)
        if cfg.qk_norm:
            q = products.norm(q, self.q_norm, cfg.rms_eps)
            k = products.norm(k, self.k_norm, cfg.rms_eps)
        cos, sin = rope_cos_sin(products.positions(positions, S), hd, cfg.rope_theta)
        if not cfg.encoder_only:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if cache is not None:
            # decode: write the new k/v at cache_len, then attend over the cache
            kv_len = products.cache_write(cache, {"k": k, "v": v}, cache_len)
            out = products.attend(q, cache["k"], cache["v"], q_offset=cache_len, kv_len=kv_len)
        else:
            k, v = products.keys(k, v)
            out = products.attention(q, k, v, causal=not cfg.encoder_only)
        return products.rows(out.reshape(b, S, -1), self.wo)


# --------------------------------------------------------------------- #
# MLA attention (DeepSeek-V2): latent-compressed KV cache
# --------------------------------------------------------------------- #
class MLA(nn.Module):
    """Multi-head latent attention. The cache holds the normalised latent
    ``ckv`` (b, Smax, r) and the one rope key shared by all heads ``krope``
    (b, Smax, dr); every call up-projects the whole latent to per-head keys
    and values, as the reference does."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        r, dr, dn, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.wq = Dense(d, h * (dn + dr), **kw)
        self.kv_down = Dense(d, r + dr, **kw)  # latent + shared rope key
        self.kv_up = Dense(r, h * (dn + dv), **kw)
        self.wo = Dense(h * dv, d, **kw)
        self.latent_norm = _ones(r, device)

    def forward(
        self,
        x: torch.Tensor,  # (b, S, d)
        positions: torch.Tensor,  # (S,) global positions of x
        cache: Optional[Dict[str, torch.Tensor]] = None,  # {"ckv", "krope"}: (b, Smax, r | dr)
        cache_len: Optional[int] = None,  # filled length of the cache before this call
        products: Products = WHOLE,
    ) -> torch.Tensor:
        cfg = self.cfg
        r, dr, dn, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
        # under tensor parallelism ``wq``, ``kv_up`` and ``wo`` hold this
        # rank's heads, ``kv_down`` is whole: the latent and the rope key are
        # computed whole on every rank, from the whole sequence
        q, down = products.columns(x, (self.wq, self.kv_down))
        b, S = q.shape[:2]
        h = q.shape[-1] // (dn + dr)  # a partitioned decode gathers every head's
        q = q.reshape(b, S, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        ckv = products.norm(down[..., :r], self.latent_norm, cfg.rms_eps)
        cos, sin = rope_cos_sin(products.positions(positions, S), dr, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(down[..., r:].reshape(b, S, 1, dr), cos, sin)
        if cache is not None:
            # decode: write the latent and the rope key at cache_len, then
            # up-project the whole cache (a partitioned decode: its shard)
            kv_len = products.cache_write(
                cache, {"ckv": ckv, "krope": k_rope.reshape(b, S, dr)}, cache_len)
            ckv, k_rope = cache["ckv"], cache["krope"].reshape(b, -1, 1, dr)
        else:  # every position's latent and rope key (gathered under context parallelism)
            ckv, k_rope = products.keys(ckv, k_rope)
        Skv = ckv.shape[1]
        kv = self.kv_up(ckv).reshape(b, Skv, h, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        # the rope key is shared by the heads: a stride-0 view, copied once by cat
        k_full = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(b, Skv, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        scale = 1.0 / math.sqrt(dn + dr)
        if cache is not None:
            out = products.attend(q_full, k_full, v, q_offset=cache_len, kv_len=kv_len,
                                  sm_scale=scale)
        else:
            out = products.attention(q_full, k_full, v, causal=True, sm_scale=scale)
        return products.rows(out.reshape(b, S, -1), self.wo)


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
class MLP(nn.Module):
    """SwiGLU (``act == "silu"``: gate, up, down) or a plain two-layer MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device,
                 d_ff: Optional[int] = None) -> None:
        super().__init__()
        d = cfg.d_model
        ff = d_ff if d_ff is not None else cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.act = cfg.act
        self.gate = Dense(d, ff, **kw) if cfg.act == "silu" else None
        self.up = Dense(d, ff, **kw)
        self.down = Dense(ff, d, **kw)

    def forward(self, x: torch.Tensor, products: Products = WHOLE) -> torch.Tensor:
        f = act_fn(self.act)
        if self.gate is not None:
            g, u = products.columns(x, (self.gate, self.up))
            return products.rows(f(g) * u, self.down)
        return products.rows(f(*products.columns(x, (self.up,))), self.down)
