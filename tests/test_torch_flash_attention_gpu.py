"""The CUDA flash-attention kernel against its plain version, on the card.

Marked ``gpu``: each test skips without an NVIDIA GPU (the kernel has no
CPU mode). This file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_flash_attention_gpu.py

Tolerances are ``tests/test_kernels.py``'s: 2e-4 in float32, 3e-2 in bf16.
Besides the planned tiles, the bf16 tensor-core instance is swept over
every compiled head dim and KV tile, and the split decode over kv_len
edges and split counts, with the KV cache read in place through strides.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    MAX_BK,
    MMA_TILES,
    flash_attention_cuda,
    live_keys,
    n_split,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.ops import smem_bytes as smem_formula
from repro_torch.kernels.flash_attention.ref import attention_ref, split_kv_ref

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP = [  # (b, sq, skv, hq, hkv, d, causal): test_flash_attention_sweep's shapes
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),  # GQA 4:1
    (1, 256, 256, 4, 1, 32, True),  # MQA
    (2, 64, 192, 4, 2, 64, False),  # bidirectional, cross-length
    (1, 100, 100, 2, 2, 16, True),  # ragged
]
CASES = [(b, sq, skv, hq, hkv, d, causal, 0, None, dtype)
         for (b, sq, skv, hq, hkv, d, causal) in SWEEP
         for dtype in ("float32", "bfloat16")] + [
    # the serving decode shape: q at position kv_len-1 over a 512-slot cache
    (8, 1, 512, 16, 8, 128, False, kv - 1, kv, "bfloat16") for kv in (1, 37, 300, 512)
] + [(2, 1024, 1024, 16, 8, 128, True, 0, None, "bfloat16")] + [  # causal prefill
    # context parallelism: one rank's half of qwen3-0.6b's 2048 positions
    # against every key, q_offset its shard's start
    (1, 1024, 2048, 16, 8, 128, True, start, None, "bfloat16") for start in (0, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,q_offset,kv_len,dtype", CASES)
def test_flash_kernel_matches_plain_on_gpu(b, sq, skv, hq, hkv, d, causal, q_offset,
                                           kv_len, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device="cuda", dtype=getattr(torch, dtype))
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset,
                         kv_len=kv_len).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kv_len is not None:  # slots past kv_len are never read
        k[:, kv_len:] = 99.0
        v[:, kv_len:] = 99.0
        again = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
        assert torch.equal(again, got)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _inputs(seed, b, sq, skv, hq, hkv, d, dtype):
    """q (b, sq, hq, d), and k/v as views of one (b, skv, 2, hkv, d) cache:
    strided, read in place."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d), np.float32)).to("cuda", dt)
    kv = torch.from_numpy(rng.standard_normal((b, skv, 2, hkv, d), np.float32)).to("cuda", dt)
    return q, kv[:, :, 0], kv[:, :, 1]


def _want(q, k, v, **kw):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         **kw).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,bk", [(d, bk) for d in HEAD_DIMS for bk in MMA_TILES[d]])
def test_bf16_tensor_core_instance_matches_plain(d, bk, causal, offset):
    """The many-row bf16 instance (mma.sync) at every compiled head dim and
    KV tile (D = 192 up to 64 keys): ragged Sq and Skv (not multiples of 16
    or 64), GQA 2:1, and with ``offset`` a query offset with kv_len short
    of the cache."""
    _need_gpu()
    b, sq, skv, hq, hkv = 2, 77, 141, 4, 2
    q_offset, kv_len = (20, 130) if offset else (0, skv)
    q, k, v = _inputs(d + bk, b, sq, skv, hq, hkv, d, "bfloat16")
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset, kv_len=kv_len)
    got = flash_attention_cuda(q, k, v, bq=64, bk=bk, **kw)
    torch.cuda.synchronize()
    want = _want(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    k[:, kv_len:] = 99.0
    v[:, kv_len:] = 99.0
    assert torch.equal(flash_attention_cuda(q, k, v, bq=64, bk=bk, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [32, 96])
@pytest.mark.parametrize("edge", ["0", "1", "bk-1", "bk", "skv"])
def test_split_decode_kv_len_edges(edge, bk, dtype):
    """Decode over a strided cache with the rule's split count: kv_len 0,
    1, bk - 1, bk and the whole cache; slots past kv_len are never read."""
    _need_gpu()
    b, skv, hq, hkv, d = 2, 512, 8, 2, 128
    kv_len = {"0": 0, "1": 1, "bk-1": bk - 1, "bk": bk, "skv": skv}[edge]
    q_offset = max(kv_len - 1, 0)
    q, k, v = _inputs(kv_len, b, 1, skv, hq, hkv, d, dtype)
    kw = dict(causal=False, scale=1.0 / math.sqrt(d), q_offset=q_offset, kv_len=kv_len)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, bq=1, bk=bk, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1  # one call, split or not
    want = _want(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kv_len == 0:
        assert torch.count_nonzero(got) == 0
    k[:, kv_len:] = 99.0
    v[:, kv_len:] = 99.0
    assert torch.equal(flash_attention_cuda(q, k, v, bq=1, bk=bk, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", range(1, 11))
def test_split_decode_every_split_count(parts, dtype):
    """Each split count the rule gives at b=1, hkv=2 in tiles of 32 keys
    (kv_len sets the tiles, so 1 to 10 parts), against attention_ref and
    against the plain split arithmetic (split_kv_ref) on the same bounds."""
    _need_gpu()
    b, skv, hq, hkv, d, bk = 1, 384, 4, 2, 64, 32
    kv_len = 32 * parts - 5
    assert n_split(b, hkv, kv_len, bk) == parts
    q, k, v = _inputs(parts, b, 1, skv, hq, hkv, d, dtype)
    kw = dict(causal=False, scale=1.0 / math.sqrt(d), q_offset=kv_len - 1, kv_len=kv_len)
    got = flash_attention_cuda(q, k, v, bq=1, bk=bk, **kw)
    torch.cuda.synchronize()
    assert torch.equal(flash_attention_cuda(q, k, v, bq=1, bk=bk, **kw), got)
    for want in (_want(q, k, v, **kw),
                 split_kv_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              bk=bk, parts=parts, **kw).transpose(1, 2)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,q_offset,kv_len", [
    (2, 1, 200, 16, 1, 64, False, 150, 151),  # MQA: 16 q-heads, two groups of 8 rows; 5 parts
    (1, 1, 200, 24, 2, 80, False, 199, 200),  # 12 q-heads per kv-head; 7 parts
    (2, 5, 160, 4, 2, 32, True, 40, 45),  # bq = 1 at several causal positions; 2 parts
    (1, 60, 128, 2, 2, 16, True, 40, None),  # 4 parts; the first rows' later parts are empty
])
def test_split_decode_groups_and_positions(b, sq, skv, hq, hkv, d, causal, q_offset, kv_len,
                                           dtype):
    _need_gpu()
    q, k, v = _inputs(hq + sq, b, sq, skv, hq, hkv, d, dtype)
    kv_len_ = skv if kv_len is None else kv_len
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset)
    got = flash_attention_cuda(q, k, v, bq=1, bk=32, kv_len=kv_len_, **kw)
    torch.cuda.synchronize()
    want = _want(q, k, v, kv_len=kv_len, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    live = live_keys(sq, kv_len_, q_offset, causal)
    again = split_kv_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len=kv_len,
                         bk=32, parts=n_split(b, hkv, live, 32), **kw).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), again.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compiled_smem_equals_the_space_formula(dtype):
    """The compiled fa_smem_bytes equals ops.smem_bytes for every instance
    of each dtype (legalize binds the Python formula)."""
    _need_gpu()
    for bq in (1, 64):
        for bk in range(32, MAX_BK + 1, 32):
            for d in HEAD_DIMS:
                assert smem_bytes(bq, bk, d, dtype) == smem_formula(bq, bk, d, dtype), (bq, bk, d)


@pytest.mark.gpu
def test_split_decode_keeps_no_state_between_calls():
    """A split decode shares nothing between calls: calls in flight on two
    streams at once, and replays of a captured CUDA graph, give the bits of
    the eager call on the same inputs."""
    _need_gpu()
    b, skv, hq, hkv, d, bk, kv_len = 2, 512, 8, 2, 128, 32, 500
    kw = dict(causal=False, scale=1.0 / math.sqrt(d), q_offset=kv_len - 1, kv_len=kv_len,
              bq=1, bk=bk)
    assert n_split(b, hkv, kv_len, bk) > 1
    inputs = [_inputs(seed, b, 1, skv, hq, hkv, d, "bfloat16") for seed in (7, 8)]
    wants = [flash_attention_cuda(*x, **kw) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in inputs]
    outs = [[] for _ in inputs]
    for _ in range(20):
        for x, st, out in zip(inputs, streams, outs):
            with torch.cuda.stream(st):
                out.append(flash_attention_cuda(*x, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for out, want in zip(outs, wants) for o in out)

    q, k, v = inputs[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_cuda(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention_cuda(q, k, v, **kw)
    for seed in (9, 10):
        q.copy_(_inputs(seed, b, 1, skv, hq, hkv, d, "bfloat16")[0])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, flash_attention_cuda(q, k, v, **kw))


D192_CASES = [  # (b, sq, skv, hq, hkv, d, dv, causal, q_offset, kv_len)
    (2, 150, 150, 4, 2, 192, 192, True, 0, None),  # many rows, the compiled D
    (2, 150, 150, 4, 2, 192, 128, True, 0, None),  # deepseek-v2-lite's MLA dims, padded v
    (1, 96, 200, 4, 4, 192, 128, False, 0, None),
    (2, 70, 70, 2, 2, 130, 100, True, 0, None),  # both padded to 192
    (4, 1, 256, 8, 2, 192, 192, False, 180, 181),  # split decode at D = 192
    (4, 1, 256, 8, 2, 192, 128, False, 255, 256),
    (2, 1, 64, 4, 4, 40, 24, False, 20, 21),  # padded to 64
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,q_offset,kv_len", D192_CASES)
def test_head_dims_up_to_192_match_plain(b, sq, skv, hq, hkv, d, dv, causal, q_offset, kv_len,
                                         dtype):
    """The D = 192 instances of all three kernel families, and head dims
    that the op pads to a compiled D (q, k along d, v along dv), against
    the plain version on the unpadded tensors; scale 1 / sqrt(d)."""
    _need_gpu()
    rng = np.random.default_rng(d + dv + sq)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dt)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv)))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and got.shape == (b, sq, hq, dv)
    want = _want(q, k, v, scale=1.0 / math.sqrt(d), **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_head_dims_above_192_raise_on_the_card():
    _need_gpu()
    q = torch.zeros((1, 8, 2, 200), device="cuda")
    v = torch.zeros((1, 8, 2, 128), device="cuda")
    with pytest.raises(ValueError, match="up to 192"):
        flash_attention(q, q, v, causal=True)
    with pytest.raises(ValueError, match="up to 192"):
        flash_attention(v, v, q, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d,kv_len,bk", [
    (8, 128, 16, 8, 128, 77, 32),  # qwen3's heads, the keys in parts: the combine writes it
    (8, 128, 16, 8, 128, 128, 128),  # one part: the decode kernel writes the lse
    (8, 128, 16, 8, 128, 0, 32),  # an empty shard: zeros and -inf, no NaN
    (4, 256, 16, 16, 192, 200, 64),  # MLA's D = 192 instance over a latent shard
    (4, 256, 16, 16, 192, 0, 64),
])
def test_decode_lse_matches_plain_on_gpu(b, skv, hq, hkv, d, kv_len, bk, dtype):
    """The decode instance's f32 log-sum-exp (bq = 1), from the combine
    kernel where the rule splits the keys and from the decode kernel where
    it does not, against the plain version's; rows with no live key give
    zeros and -inf."""
    _need_gpu()
    q, k, v = _inputs(kv_len + d, b, 1, skv, hq, hkv, d, dtype)
    kw = dict(causal=False, scale=1.0 / math.sqrt(d), q_offset=0, kv_len=kv_len)
    out, lse = flash_attention_cuda(q, k, v, bq=1, bk=bk, lse=True, **kw)
    torch.cuda.synchronize()
    want, want_lse = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   return_lse=True, **kw)
    want, want_lse = want.transpose(1, 2), want_lse.transpose(1, 2)
    assert lse.shape == (b, 1, hq) and lse.dtype == torch.float32
    assert not torch.isnan(lse).any() and not torch.isnan(out).any()
    if kv_len == 0:
        assert torch.all(lse == -torch.inf) and torch.count_nonzero(out) == 0
    else:
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(flash_attention_cuda(q, k, v, bq=1, bk=bk, **kw), out)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 1024])
@pytest.mark.parametrize("hkv,d,dv", [(8, 128, 128), (16, 192, 128)], ids=["qwen3", "mla"])
def test_context_shape_forward_and_backward_match_plain(start, hkv, d, dv):
    """The context-parallel shapes (a 1024-query shard of 2048 positions,
    causal, ``q_offset`` the shard's start; qwen3-0.6b's 16 q / 8 kv heads
    of 128, deepseek-v2-lite's MLA at 16 heads of d 192 and dv 128) under
    autograd: the kernel's forward and its plain-recompute backward against
    ``attention_ref`` differentiated, bf16, at 3e-2 of each tensor's
    largest entry."""
    _need_gpu()
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device="cuda", dtype=torch.bfloat16).requires_grad_()
        for shape in ((1, 1024, 16, d), (1, 2048, hkv, d), (1, 2048, hkv, dv)))
    g = torch.from_numpy(rng.standard_normal((1, 1024, 16, dv), np.float32)).to(
        device="cuda", dtype=torch.bfloat16)
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v, causal=True, q_offset=start)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                         scale=1.0 / math.sqrt(d), q_offset=start).transpose(1, 2)
    wgrads = torch.autograd.grad(want, (q, k, v), g)
    for got_t, want_t in zip((out, *grads), (want, *wgrads)):
        got_t, want_t = got_t.float(), want_t.float()
        assert float((got_t - want_t).abs().max()) <= TOL["bfloat16"] * float(
            want_t.abs().max()) + 1e-6
    if start == 0:  # the first shard's queries read no key past the shard
        assert float(grads[1][:, 1024:].abs().max()) == 0.0
