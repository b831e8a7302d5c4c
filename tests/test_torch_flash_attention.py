"""The port's flash-attention op and ``mha`` against the JAX package.

On the CPU the op runs its plain version; the same seeded numpy inputs go
through the JAX Pallas kernel in interpret mode. Tolerances are those of
``tests/test_kernels.py``: 2e-4 in float32, 3e-2 in bfloat16 (one bf16
rounding of P and of the output).
``test_torch_flash_attention_gpu.py`` holds the CUDA kernel against its
plain version on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import mha as jax_mha
from repro_torch import kernels as torch_kernels
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch import codesign
from repro_torch.codesign import H100_SMEM_BUDGET
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    SMEM_OPT_IN,
    check_blocks,
    compiled_dim,
    live_keys,
    max_bk,
    n_split,
)
from repro_torch.kernels.flash_attention.ops import (
    FLASH_ATTENTION_H100,
    _plain,
    pad_head_dims,
    plan_blocks,
    planned_shape,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.ref import attention_ref, split_kv_ref
from repro_torch.models.layers import mha

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP = [  # (b, sq, skv, hq, hkv, d, causal): test_flash_attention_sweep's shapes
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),  # GQA 4:1
    (1, 256, 256, 4, 1, 32, True),  # MQA
    (2, 64, 192, 4, 2, 64, False),  # bidirectional, cross-length
    (1, 100, 100, 2, 2, 16, True),  # ragged
]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture
def kernels_off():
    torch_kernels.enable_kernels(False)
    yield
    torch_kernels.enable_kernels(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", SWEEP)
def test_flash_attention_sweep_matches_jax(b, sq, skv, hq, hkv, d, causal, dtype):
    arrs = _qkv(0, b, sq, skv, hq, hkv, d)
    want = jax_flash_attention(*_jax(arrs, dtype), causal=causal, blocks=(64, 64),
                               interpret=True)
    got = flash_attention(*_torch(arrs, dtype), causal=causal)
    assert got.shape == (b, sq, hq, d) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_kv_len_mask_matches_jax():
    """Decode: 1 query over a 512-slot cache with only 300 valid entries."""
    arrs = _qkv(1, 2, 1, 512, 8, 2, 64)
    want = jax_flash_attention(*_jax(arrs, "float32"), causal=False, q_offset=299,
                               kv_len=jnp.int32(300), blocks=(8, 128), interpret=True)
    q, k, v = _torch(arrs, "float32")
    got = flash_attention(q, k, v, causal=False, q_offset=299, kv_len=300)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    # changing masked-out cache slots must not change the output
    k2 = k.clone()
    k2[:, 300:] = 99.0
    got2 = flash_attention(q, k2, v, causal=False, q_offset=299, kv_len=300)
    np.testing.assert_array_equal(_np(got2), _np(got))


def test_attention_ref_zeros_fully_masked_rows():
    q, k, v = _torch(_qkv(2, 1, 3, 8, 2, 2, 16), "float32")
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=False, scale=0.25, kv_len=0)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax(kernels_on, dtype, kernels_off):
    """Port ``mha`` (chunked reference, or the kernel op when switched on)
    against JAX ``mha``'s chunked reference, causal GQA."""
    arrs = _qkv(3, 2, 128, 128, 8, 2, 32)
    want = jax_mha(*_jax(arrs, dtype), causal=True, q_chunk=64)
    torch_kernels.enable_kernels(kernels_on)
    got = mha(*_torch(arrs, dtype), causal=True, q_chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_mha_decode_matches_jax(kernels_off):
    arrs = _qkv(4, 2, 1, 64, 4, 2, 16)
    want = jax_mha(*_jax(arrs, "float32"), causal=False, q_offset=40, kv_len=41)
    got = mha(*_torch(arrs, "float32"), causal=False, q_offset=40, kv_len=41)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,skv,d,want", [
    (1, 512, 128, (1, 96)),  # the serving decode shape: 128 keys would overrun the budget
    (1024, 1024, 64, (64, 128)),
    (64, 192, 32, (64, 32)),
    (100, 100, 16, (64, 32)),  # ragged: planned at (128, 128)
    (1, 160, 128, (1, 96)),
    (1, 96, 64, (1, 96)),
])
def test_plan_blocks_rule(sq, skv, d, want):
    """The tile is the planner's (codesign.plan on the H100 hierarchy), legal
    for the compiled kernel, and its CTA fits the shared-memory budget."""
    got = plan_blocks(sq, skv, d)
    assert got == want
    assert got == codesign.plan(FLASH_ATTENTION_H100, planned_shape(sq, skv, d)).config
    check_blocks(*got)
    assert smem_bytes(*got, d) <= H100_SMEM_BUDGET


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_qkv(5, 1, 4, 4, 2, 2, 16), "float32")
    # any head dims on the CPU, as the JAX op takes them
    got = flash_attention(q[..., :12], k[..., :12], v[..., :7], causal=True)
    np.testing.assert_allclose(_np(got), _np(_plain(q[..., :12], k[..., :12], v[..., :7], True,
                                                    1 / math.sqrt(12), 0, None)), rtol=1e-6,
                               atol=1e-6)
    wide = torch.zeros((1, 4, 2, 200))
    assert flash_attention(wide, wide, v, causal=True).shape == (1, 4, 2, 16)
    # the CUDA path pads to a compiled D up to 192 and refuses wider dims
    for d, dv in ((200, 128), (128, 193)):
        with pytest.raises(ValueError, match="up to 192"):
            compiled_dim(d, dv)
    with pytest.raises(ValueError, match="bq="):
        flash_attention(q, k, v, causal=True, blocks=(8, 128))
    with pytest.raises(ValueError, match="bk="):
        flash_attention(q, k, v, causal=True, blocks=(64, 256))
    with pytest.raises(ValueError, match="kv_len=5 must lie in"):
        flash_attention(q, k, v, causal=False, q_offset=4, kv_len=5)
    with pytest.raises(ValueError, match="no path for device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)
    # the kernel's launcher takes CUDA tensors only: no silent CPU fallback
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, k, v, causal=True, scale=0.25, q_offset=0, kv_len=4,
                             bq=64, bk=32)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 64, 64, 4, 4, 80, True),  # zamba2's head dim
    (2, 64, 64, 8, 2, 32, True),  # GQA 4:1
    (1, 32, 96, 2, 2, 16, False),  # bidirectional, cross-length
])
def test_flash_attention_grads_match_jax(b, sq, skv, hq, hkv, d, causal):
    """Grads through the op (forward on the plain path here, backward by
    recompute through ``attention_ref``) against ``jax.grad`` of the JAX op
    with its Pallas kernel in interpret mode; f32, 2e-4."""
    arrs = _qkv(9, b, sq, skv, hq, hkv, d)
    cot = np.random.default_rng(10).standard_normal((b, sq, hq, d)).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(q, k, v, causal=causal, blocks=(32, 32),
                                                    interpret=True) * cot),
        argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    ts = [t.requires_grad_() for t in _torch(arrs, "float32")]
    got = torch.autograd.grad(flash_attention(*ts, causal=causal), ts, torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)


def test_flash_attention_d80_forward_matches_jax():
    """Head dim 80, the zamba2 width, is a compiled instance; bf16, causal."""
    arrs = _qkv(11, 1, 128, 128, 4, 4, 80)
    want = jax_flash_attention(*_jax(arrs, "bfloat16"), causal=True, blocks=(64, 64),
                               interpret=True)
    got = flash_attention(*_torch(arrs, "bfloat16"), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("b,hkv,live,bk,want", [
    (8, 8, 512, 96, 3),  # qwen3-0.6b's decode at b=8: 64 CTAs x 3 cover 132 SMs
    (1, 8, 512, 96, 6),  # 17 splits would cover the SMs; 6 KV tiles cap it
    (1, 1, 512, 32, 16),
    (1, 1, 4096, 32, 128),
    (1, 1, 8192, 32, 132),  # one CTA per SM
    (32, 8, 512, 96, 1),  # 256 CTAs already cover the SMs
    (8, 8, 37, 96, 1),  # one tile
    (8, 8, 0, 96, 1),  # nothing live: one empty part
])
def test_split_rule(b, hkv, live, bk, want):
    got = n_split(b, hkv, live, bk)
    assert got == want
    tiles = -(-live // bk)
    assert got == 1 or (b * hkv * (got - 1) < 132 and got <= tiles)
    # the kernel's (and split_kv_ref's) cut: part s takes tiles [s n / parts, (s + 1) n / parts)
    bounds = [(s * tiles // got * bk, min((s + 1) * tiles // got * bk, live)) for s in range(got)]
    # the parts tile [0, live) in order, each on KV-tile boundaries
    assert bounds[0][0] == 0 and bounds[-1][1] == live
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
    assert all(lo % bk == 0 and lo <= hi for lo, hi in bounds)
    assert sum(hi > lo for lo, hi in bounds) == min(got, tiles)


def test_live_keys():
    assert live_keys(1, 300, 299, False) == 300
    assert live_keys(4, 512, 10, True) == 14  # the last row sees keys 0-13
    assert live_keys(4, 8, 10, True) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal,q_offset,kv_len,bk,parts", [
    (1, 256, False, 99, 100, 32, 3),  # decode, every part live
    (1, 256, False, 99, 100, 32, 8),  # more parts than the 4 live tiles: 4 empty
    (1, 256, False, 0, 0, 32, 3),  # kv_len 0: every part empty, zeros out
    (1, 256, False, 31, 32, 32, 1),  # kv_len == bk
    (1, 256, False, 30, 31, 32, 2),  # kv_len == bk - 1
    (1, 256, False, 255, 256, 64, 4),  # the whole cache
    (5, 96, True, 3, 7, 32, 3),  # several positions: row 0 sees 4 keys, later parts empty for it
    (3, 64, True, 0, None, 32, 2),  # causal from 0
])
def test_split_kv_ref_matches_jax(sq, skv, causal, q_offset, kv_len, bk, parts, dtype):
    """The split decode's plain arithmetic (per-part partials merged by
    log-sum-exp, with empty and fully masked parts) against the JAX
    package's attention_ref on the same seeded inputs."""
    b, hq, hkv, d = 2, 4, 2, 32
    arrs = _qkv(12, b, sq, skv, hq, hkv, d)
    to_bhsd = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in arrs]
    want = jax_attention_ref(*_jax(to_bhsd, dtype), causal=causal, scale=1.0 / math.sqrt(d),
                             q_offset=q_offset,
                             kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = split_kv_ref(*_torch(to_bhsd, dtype), causal=causal, scale=1.0 / math.sqrt(d),
                       bk=bk, parts=parts, q_offset=q_offset, kv_len=kv_len)
    assert got.shape == (b, hq, sq, d) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])
    if kv_len == 0:
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("bq,bk,d,dtype,want", [
    # decode: f32 one stage, bf16 two, rows of d elements + 16 bytes, then
    # f32 Q (8 x d), scores (8 x bk), m, l, alpha
    (1, 96, 128, torch.bfloat16, 2 * 2 * 96 * 272 + 4 * 8 * (128 + 96 + 3)),
    (1, 96, 128, torch.float32, 1 * 2 * 96 * 528 + 4 * 8 * (128 + 96 + 3)),
    # many rows, bf16: two stages of K and V, rows of d + 8 bf16
    (64, 96, 80, torch.bfloat16, 2 * 2 * 96 * 88 * 2),
    # many rows, f32: Q, K (d+1), V, scores, m/l/alpha, all f32
    (64, 96, 80, torch.float32, 4 * (64 * 80 + 96 * 81 + 96 * 80 + 64 * 96 + 3 * 64)),
])
def test_smem_formula_by_dtype(bq, bk, d, dtype, want):
    """The space's shared-memory formula per instance (the card holds it
    against the compiled ``fa_smem_bytes``, tests/test_torch_flash_attention_gpu.py),
    and legalize binds the larger of the two dtypes."""
    assert smem_bytes(bq, bk, d, dtype) == want
    both = [smem_bytes(bq, bk, d, t) for t in (torch.float32, torch.bfloat16)]
    assert smem_bytes(bq, bk, d) == max(both)


@pytest.mark.parametrize("bq,d", [(1, 128), (64, 80)])
def test_planned_decode_and_train_tiles_bind_by_the_larger_instance(bq, d):
    """At the serving decode width and the training width, 96 keys fit the
    budget in both dtypes and 128 do not in at least one: the planned tiles
    stay (1, 96) and (64, 96)."""
    assert smem_bytes(bq, 96, d) <= H100_SMEM_BUDGET < smem_bytes(bq, 128, d)


def test_calibration_space_is_bf16_with_its_tolerance():
    """The co-design loop calibrates the instance the models launch (bf16)
    and holds it to its plain version within the bf16 tolerance."""
    inputs = FLASH_ATTENTION_H100.example_inputs((64, 96, 80), "cpu",
                                                 torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.bfloat16 for t in inputs)
    assert FLASH_ATTENTION_H100.tolerance == TOL["bfloat16"]
    got = FLASH_ATTENTION_H100.run(inputs, (64, 96))
    want = FLASH_ATTENTION_H100.reference(inputs, (64, 96))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d,dv,want", [(12, 12, 16), (16, 16, 16), (80, 80, 80), (100, 40, 128),
                                       (192, 128, 192), (130, 100, 192), (40, 24, 64)])
def test_compiled_dim(d, dv, want):
    assert compiled_dim(d, dv) == want and want in HEAD_DIMS


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mla_dims_match_jax(causal):
    """deepseek-v2-lite's MLA dims (d = 192 for q and k, dv = 128 for v),
    GQA 2:1, through the op (the kernels-on path; plain here) against the
    JAX op with its Pallas kernel in interpret mode; f32, 2e-4."""
    b, sq, skv, hq, hkv, d, dv = 1, 64, 96 if not causal else 64, 4, 2, 192, 128
    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal(s, np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv))]
    want = jax_flash_attention(*_jax(arrs, "float32"), causal=causal, blocks=(32, 32),
                               interpret=True)
    torch_kernels.enable_kernels(True)
    try:
        got = mha(*_torch(arrs, "float32"), causal=causal)
    finally:
        torch_kernels.enable_kernels(False)
    assert got.shape == (b, sq, hq, dv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    direct = flash_attention(*_torch(arrs, "float32"), causal=causal)
    np.testing.assert_allclose(_np(direct), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d,dv", [(192, 128), (12, 12), (100, 40), (130, 100), (80, 80)])
def test_pad_head_dims_leaves_the_plain_output_unchanged(d, dv):
    """What the CUDA path does around the kernel, through the plain
    version: q, k zero-padded along d and v along dv to the compiled D,
    attention at scale 1 / sqrt(d), the output sliced back to dv."""
    rng = np.random.default_rng(d + dv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((2, 33, 4, d), (2, 40, 2, d), (2, 40, 2, dv)))
    D = compiled_dim(d, dv)
    qp, kp, vp = pad_head_dims(q, k, v, D)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == D
    assert (qp is q) == (d == D) and (vp is v) == (dv == D)
    assert not qp[..., d:].any() and not kp[..., d:].any() and not vp[..., dv:].any()
    for causal in (True, False):
        got = _plain(qp, kp, vp, causal, 1 / math.sqrt(d), 3, 37)[..., :dv]
        want = _plain(q, k, v, causal, 1 / math.sqrt(d), 3, 37)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bq", [1, 64])
def test_legalize_keeps_d192_within_the_opt_in(bq):
    """At D = 192 the tile fits the 227 KB opt-in in both dtypes and is a
    compiled one (bf16 many rows: up to 64 keys), whatever the budget."""
    shape = (1 if bq == 1 else 2048, 2048, 192)
    for budget in (None, SMEM_OPT_IN, 10 * SMEM_OPT_IN):
        got_bq, bk = FLASH_ATTENTION_H100.legalize((64, 128), shape, smem_budget=budget)
        assert got_bq == bq
        check_blocks(bq, bk)
        for dtype in (torch.float32, torch.bfloat16):
            assert bk <= max_bk(bq, 192, dtype)
            assert smem_bytes(bq, bk, 192, dtype) <= SMEM_OPT_IN
    assert max_bk(64, 192, torch.bfloat16) == 64 and max_bk(64, 192, torch.float32) == 96
    assert max_bk(1, 192, torch.float32) == max_bk(64, 128, torch.float32) == 128


# --------------------------------------------------------------------- #
# the decode instance's log-sum-exp (a partitioned decode merges shards by it)
# --------------------------------------------------------------------- #
LSE_CASES = [  # (b, skv, hq, hkv, d, dv, kv_len)
    (2, 64, 8, 2, 64, 64, 37),
    (1, 48, 4, 4, 16, 16, 48),
    (3, 40, 6, 2, 32, 24, 0),  # no live key: zeros, -inf
    (2, 32, 4, 4, 24, 16, 1),  # MLA-like d != dv
]


def _jax_lse(q, k, kv_len, scale):
    """The reference attention's log-sum-exp of the scaled live scores
    (-inf where none is live), from its own arrays: (b, 1, hq)."""
    g = q.shape[2] // k.shape[2]
    kk = jnp.repeat(k, g, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32), kk.astype(jnp.float32)) * scale
    live = jnp.arange(k.shape[1]) < kv_len
    s = jnp.where(live, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).transpose(0, 2, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d,dv,kv_len", LSE_CASES)
def test_plain_lse_matches_the_reference_attention(b, skv, hq, hkv, d, dv, kv_len, dtype):
    """The plain version's (out, lse) of one decode row: out against the
    reference's ``attention_ref``, lse against the log-sum-exp of the
    reference's scores (exactly -inf and zeros where kv_len is 0, no
    NaN); ``mha``'s plain path gives the same pair."""
    rng = np.random.default_rng(b + skv + kv_len)
    arrs = [rng.standard_normal(s, np.float32) for s in ((b, 1, hq, d), (b, skv, hkv, d),
                                                         (b, skv, hkv, dv))]
    q, k, v = _torch(arrs, dtype)
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_attention(q, k, v, causal=False, kv_len=kv_len, sm_scale=scale,
                               return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, 1, hq)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    jq, jk, _ = _jax(arrs, dtype)
    want = _jax_lse(jq, jk, kv_len, scale)
    if kv_len == 0:
        assert torch.all(lse == -torch.inf) and torch.count_nonzero(out) == 0
    else:
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
        jout = jax_attention_ref(*[jnp.swapaxes(a, 1, 2) for a in _jax(arrs, dtype)],
                                 causal=False, scale=scale, kv_len=kv_len)
        np.testing.assert_allclose(_np(out), _np(jnp.swapaxes(jout, 1, 2)), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    m_out, m_lse = mha(q, k, v, causal=False, kv_len=kv_len, sm_scale=scale, return_lse=True)
    assert torch.equal(m_lse, lse) if kv_len == 0 else torch.allclose(m_lse, lse, atol=1e-5)
    assert torch.allclose(m_out.float(), out.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shards", [2, 4])
def test_merging_shard_partials_is_the_whole_attention(shards):
    """A cache split into ``shards`` sequence shards, some past kv_len
    (empty): each shard's plain (out, lse) merged by ``merge_lse`` equals
    attention over the whole cache, output and log-sum-exp, in f32."""
    from repro_torch.kernels.flash_attention.ops import merge_lse

    rng = np.random.default_rng(shards)
    b, skv, hq, hkv, d, kv_len = 2, 64, 8, 2, 32, 21
    q, k, v = _torch([rng.standard_normal(s, np.float32) for s in
                      ((b, 1, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))], "float32")
    want, want_lse = flash_attention(q, k, v, causal=False, kv_len=kv_len, return_lse=True)
    n = skv // shards
    parts = []
    for j in range(shards):
        live = max(0, min(kv_len - j * n, n))
        o, lse = flash_attention(q, k[:, j * n:(j + 1) * n], v[:, j * n:(j + 1) * n],
                                 causal=False, kv_len=live, return_lse=True)
        parts.append(torch.cat([o, lse[..., None]], dim=-1))
    got = merge_lse(torch.stack(parts))
    torch.testing.assert_close(got[..., :-1], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[..., -1], want_lse, rtol=1e-6, atol=1e-6)
    empty = merge_lse(torch.stack([parts[-1], parts[-1]]))  # no shard holds a key
    assert torch.count_nonzero(empty[..., :-1]) == 0 and torch.all(empty[..., -1] == -torch.inf)


def test_lse_only_from_the_decode_instance():
    q = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="decode instance"):
        flash_attention(q, q, q, causal=True, return_lse=True)
