"""The port's ``WaveServer`` against the JAX package's: greedy tokens.

Weights are the JAX smoke init cast to float32 in both packages (the KV
cache stays bf16, as both hard-code it). With bf16 weights the logits are
bf16, and on random weights JAX's own top-2 margin is within two bf16 ulps
on 10-16% of steps, so no tolerance above rounding noise would leave 90% of
the steps decisive. With float32 weights the two packages' logits agree to
``LOGIT_TOL`` (1e-3: a one-ulp flip of a bf16 cache entry moves a logit by
up to ~1e-3; the median difference is ~2e-7).

The rule: at every step where JAX's top-2 logit margin exceeds twice
``LOGIT_TOL``, the port's token equals JAX's, for as long as the request's
earlier tokens agree; such steps are at least 90% of all steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import model as jm
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps
from repro_torch.models import forward
from repro_torch.models.convert import params_from_jax

ARCH = "qwen3-0.6b_smoke"
LOGIT_TOL = 1e-3
SLOTS, MAX_LEN, MAX_NEW, N_REQ = 4, 64, 12, 8


@pytest.fixture
def kernels_reset():
    yield
    torch_kernels.enable_kernels(False)


def _jax_margins(jcfg, jp, wave):
    """JAX's top-2 logit margin at each step that produced ``wave``'s
    tokens, replaying the wave's prefill and its own tokens."""
    L = max(len(r.prompt) for r in wave)
    toks = np.zeros((SLOTS, L), np.int32)
    for i, r in enumerate(wave):
        toks[i, L - len(r.prompt):] = r.prompt
    feed = [toks[:, t] for t in range(L)]
    feed += [np.array([r.out[s] for r in wave]) for s in range(MAX_NEW - 1)]
    step = jax.jit(functools.partial(jm.decode_step, jcfg))
    cache = jm.init_cache(jcfg, SLOTS, MAX_LEN)
    margins = np.zeros((SLOTS, MAX_NEW))
    for t, tok in enumerate(feed):
        logits, cache = step(jp, cache, jnp.asarray(tok[:, None], jnp.int32), jnp.int32(t))
        if t >= L - 1:
            top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
            margins[:, t - (L - 1)] = top2[:, 1] - top2[:, 0]
    return margins


@pytest.mark.parametrize("kernels_on", [False, True])
def test_wave_server_tokens_match_jax(kernels_on, kernels_reset):
    _check_wave_server(ARCH, kernels_on)


@pytest.mark.parametrize("kernels_on", [False, True])
def test_moe_wave_server_tokens_match_jax(kernels_on, kernels_reset):
    """deepseek-v2-lite's smoke config: a dense MLA prefix layer, then MLA
    with a dropless MoE; the same rule."""
    _check_wave_server("deepseek-v2-lite-16b_smoke", kernels_on)


@pytest.mark.parametrize("kernels_on", [False, True])
def test_xlstm_wave_server_tokens_match_jax(kernels_on, kernels_reset):
    """xlstm's smoke config: every layer recurrent (5 mLSTM + 1 sLSTM), no
    attention, so the kernel switch changes nothing on its path; the same
    rule."""
    _check_wave_server("xlstm-1.3b_smoke", kernels_on)


def _check_wave_server(arch, kernels_on):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu").float()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    torch_kernels.enable_kernels(kernels_on)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12))).tolist()
               for _ in range(N_REQ)]
    js = jax_serve.WaveServer(jcfg, jp, batch_slots=SLOTS, max_len=MAX_LEN)
    ts = serve.WaveServer(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        js.submit(jax_serve.Request(rid, p, MAX_NEW))
        ts.submit(serve.Request(rid, p, MAX_NEW))
    jdone, tdone = js.run(), ts.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(N_REQ))

    decisive = 0
    for w in range(0, N_REQ, SLOTS):
        margins = _jax_margins(jcfg, jp, jdone[w:w + SLOTS])
        for i, (jr, tr) in enumerate(zip(jdone[w:w + SLOTS], tdone[w:w + SLOTS])):
            assert len(tr.out) == len(jr.out) == MAX_NEW
            assert all(0 <= t < cfg.vocab for t in tr.out)
            for s, (want, got) in enumerate(zip(jr.out, tr.out)):
                if margins[i, s] > 2 * LOGIT_TOL:
                    decisive += 1
                    assert got == want, (f"request {jr.rid} step {s}: port {got}, JAX {want}, "
                                         f"margin {margins[i, s]:.3g}")
                elif got != want:
                    break  # a near-tie went the other way; later steps see other histories
    assert decisive >= 0.9 * N_REQ * MAX_NEW, f"{decisive} decisive of {N_REQ * MAX_NEW}"


def test_prefill_step_is_the_last_position_of_forward():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 10)))
    got = steps.make_prefill_step(cfg)(model, {"tokens": toks})
    with torch.no_grad():
        want, _ = forward(cfg, model, {"tokens": toks})
    assert torch.equal(got, want[:, -1])


def test_serve_main_on_cpu(kernels_reset):
    out = serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                      "--max-new", "4", "--max-len", "32"])
    assert out == {"requests": 3, "tokens": 12, "tok_per_s": out["tok_per_s"], "device": "cpu"}
    assert not torch_kernels.kernels_enabled()


def test_serve_main_cuda_without_a_card_raises(kernels_reset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])
