"""The port's chunked SSD op and its plain versions against the JAX package.

On the CPU the op's intra-chunk part runs its plain version
(``ssd_intra_chunk_ref``); the same seeded numpy inputs go through the JAX
op with its Pallas kernel in interpret mode. Tolerance 1e-4, as
``tests/test_kernels.py`` (all f32; sums in another order).
``test_torch_ssd_scan_gpu.py`` holds the CUDA kernel against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunked as jax_ssd_chunked
from repro.kernels.ssd_scan.ref import ssd_recurrent_ref as jax_ssd_recurrent_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_pallas
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch import codesign
from repro_torch.codesign import H100_SMEM_BUDGET
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_H100, plan_chunk, smem_bytes
from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunked_ref,
    ssd_intra_chunk_ref,
    ssd_recurrent_ref,
)
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda

TOL = 1e-4
SWEEP = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 8, 4, 64), (2, 96, 1, 32, 16, 16)]  # test_ssd_sweep


def _inputs(seed, b, l, nh, hp, n):
    """x, dA = -softplus(N(0,1)), B, C as test_ssd_sweep draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hp)).astype(np.float32) * 0.5
    dA = -np.log1p(np.exp(rng.standard_normal((b, l, nh)))).astype(np.float32)
    B = rng.standard_normal((b, l, nh, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, nh, n)).astype(np.float32) * 0.5
    return x, dA, B, C


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,l,nh,hp,n,chunk", SWEEP)
def test_ssd_sweep_matches_jax(b, l, nh, hp, n, chunk):
    arrs = _inputs(0, b, l, nh, hp, n)
    y, S = ssd_chunked(*_t(arrs), chunk=chunk)
    y_j, S_j = jax_ssd_chunked(*_j(arrs), chunk=chunk, interpret=True)
    assert y.shape == (b, l, nh, hp) and S.shape == (b, nh, hp, n)
    _close(y, y_j)
    _close(S, S_j)
    y_r, S_r = jax_ssd_recurrent_ref(*_j(arrs))
    _close(y, y_r)
    _close(S, S_r)


@pytest.mark.parametrize("b,l,nh,hp,n,chunk", SWEEP)
def test_ssd_refs_match_jax_recurrence(b, l, nh, hp, n, chunk):
    """The port's recurrent and chunked plain versions equal JAX's
    token-by-token recurrence."""
    arrs = _inputs(1, b, l, nh, hp, n)
    y_r, S_r = jax_ssd_recurrent_ref(*_j(arrs))
    for y, S in (ssd_recurrent_ref(*_t(arrs)), ssd_chunked_ref(*_t(arrs), chunk=chunk)):
        _close(y, y_r)
        _close(S, S_r)


@pytest.mark.parametrize("b,l,nh,hp,n,chunk", SWEEP)
def test_intra_chunk_ref_matches_pallas(b, l, nh, hp, n, chunk):
    """``ssd_intra_chunk_ref`` computes the three outputs of ``_ssd_kernel``
    (JAX's blocked layout is moved to the port's for the comparison)."""
    x, dA, B, C = _inputs(2, b, l, nh, hp, n)
    nc = l // chunk

    def blocks(a):  # (b, l, nh, *) -> (b, nh, nc, cl, *)
        return jnp.asarray(a.reshape(b, nc, chunk, nh, -1).transpose(0, 3, 1, 2, 4))

    want = ssd_intra_chunk_pallas(
        blocks(x), blocks(dA[..., None])[..., 0], blocks(B), blocks(C), interpret=True)
    y, S_c, dte = ssd_intra_chunk_ref(*_t((x, dA, B, C)), chunk)
    assert S_c.shape == (b, nc, nh, n, hp)
    _close(y, np.asarray(want[0]).transpose(0, 2, 3, 1, 4).reshape(b, l, nh, hp))
    _close(S_c, np.asarray(want[1]).transpose(0, 2, 1, 3, 4))
    _close(dte, np.asarray(want[2]).transpose(0, 2, 3, 1).reshape(b, l, nh))


def test_ssd_chunk_invariance():
    """Chunk size is a pure performance knob -- results identical."""
    arrs = _t(_inputs(3, 1, 128, 2, 8, 4))
    y16, _ = ssd_chunked(*arrs, chunk=16)
    y64, _ = ssd_chunked(*arrs, chunk=64)
    _close(y16, y64)


def test_ssd_init_state_matches_jax():
    arrs = _inputs(4, 2, 64, 2, 8, 4)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 8, 4)).astype(np.float32)
    y, S = ssd_chunked(*_t(arrs), chunk=16, init_state=torch.from_numpy(s0))
    y_j, S_j = jax_ssd_chunked(*_j(arrs), chunk=16, init_state=jnp.asarray(s0),
                               interpret=True)
    _close(y, y_j)
    _close(S, S_j)


def test_ssd_grads_match_jax():
    """Grads of every input through the op (forward on the plain path here,
    backward by recompute through ``ssd_chunked_ref``) against ``jax.grad``
    of the JAX op with its Pallas kernel in interpret mode."""
    arrs = _inputs(5, 1, 64, 2, 8, 4)
    cot = np.random.default_rng(5).standard_normal((1, 64, 2, 8)).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_ssd_chunked(*a, chunk=32, interpret=True)[0] * cot),
        argnums=(0, 1, 2, 3))(*_j(arrs))
    ts = [t.requires_grad_() for t in _t(arrs)]
    got = torch.autograd.grad(ssd_chunked(*ts, chunk=32)[0], ts, torch.from_numpy(cot))
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_shared_bc_stride0_equals_materialised():
    """B/C of one group expanded over heads with stride 0 (as the model
    passes them) give the materialised result, values and grads."""
    x, dA, B, C = _inputs(6, 2, 64, 4, 8, 4)
    B1, C1 = torch.from_numpy(B[:, :, :1]), torch.from_numpy(C[:, :, :1])
    y_e, _ = ssd_chunked(torch.from_numpy(x), torch.from_numpy(dA),
                         B1.expand(2, 64, 4, 4), C1.expand(2, 64, 4, 4), chunk=32)
    y_m, _ = ssd_chunked(torch.from_numpy(x), torch.from_numpy(dA),
                         B1.repeat(1, 1, 4, 1), C1.repeat(1, 1, 4, 1), chunk=32)
    np.testing.assert_array_equal(y_e.numpy(), y_m.numpy())
    Bg = B1.clone().requires_grad_()
    y, _ = ssd_chunked(torch.from_numpy(x), torch.from_numpy(dA), Bg.expand(2, 64, 4, 4),
                       C1.expand(2, 64, 4, 4), chunk=32)
    y.sum().backward()
    assert Bg.grad.shape == (2, 64, 1, 4) and torch.isfinite(Bg.grad).all()


@pytest.mark.parametrize("hp,n,want", [(64, 64, 64), (16, 16, 128), (8, 4, 128), (64, 32, 128),
                                       (32, 64, 64)])
def test_plan_chunk_rule(hp, n, want):
    """The chunk is the planner's (codesign.plan on the H100 hierarchy): a
    power of two of whole 64-row tiles whose CTA fits the budget."""
    cl = plan_chunk(hp, n)
    assert cl == want == codesign.plan(SSD_SCAN_H100, (hp, n)).config[0]
    assert cl & (cl - 1) == 0 and 64 <= cl <= 1024
    assert smem_bytes(cl) <= H100_SMEM_BUDGET


def test_ssd_rejects_what_the_kernel_does_not_take():
    x, dA, B, C = _t(_inputs(7, 1, 64, 2, 8, 4))
    with pytest.raises(ValueError, match="% chunk"):
        ssd_chunked(x, dA, B, C, chunk=48)
    with pytest.raises(ValueError, match="no path for device"):
        ssd_chunked(x.to("meta"), dA.to("meta"), B.to("meta"), C.to("meta"), chunk=32)
    # the kernel's launcher takes CUDA tensors only: no silent CPU fallback
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_intra_chunk_cuda(x, dA, B, C, 32)
