"""The port's fault-tolerant runner: the reference's runner tests
(tests/test_runtime.py: transient retry, restore after exhausted retries,
giving up, the watchdog timeout, straggler flags) on torch tensors, and
the two ways the port's in-place train step could make a retry differ from
an unfailed step: a failure halfway through the update, and a step
abandoned by the watchdog that goes on writing the state. After either,
the state must equal an unfailed step's bit for bit (``torch.equal``).
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps
from repro_torch.optim import adamw, lion, sgd
from repro_torch.runtime import (
    FaultTolerantRunner,
    RunnerConfig,
    StepAbandonedError,
    StepTimeoutError,
)


def ok_step(state, batch):
    return state + batch, {"loss": state}


def test_transient_failure_retried():
    fails = {"n": 0}

    def hook(step):
        if step == 2 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected device error")

    r = FaultTolerantRunner(ok_step, RunnerConfig(max_retries_per_step=2), fault_hook=hook)
    s = torch.tensor(0.0)
    for i in range(4):
        s, _ = r.run_step(s, torch.tensor(1.0), i)
    assert float(s) == 4.0
    assert fails["n"] == 2
    assert [st.retried for st in r.stats] == [0, 0, 2, 0]


def test_exhausted_retries_restores_from_checkpoint():
    calls = {"restores": 0}

    def hook(step):
        if step == 1 and calls["restores"] == 0:
            raise RuntimeError("persistent failure")

    def restore_fn():
        calls["restores"] += 1
        return torch.tensor(100.0), 0

    r = FaultTolerantRunner(ok_step, RunnerConfig(max_retries_per_step=1),
                            restore_fn=restore_fn, fault_hook=hook)
    s = torch.tensor(0.0)
    s, _ = r.run_step(s, torch.tensor(1.0), 0)
    s, _ = r.run_step(s, torch.tensor(1.0), 1)  # fails twice -> restore -> ok
    assert calls["restores"] == 1
    assert float(s) == 101.0
    assert r.stats[-1].retried == 2


def test_gives_up_after_restores_exhausted():
    def hook(step):
        raise RuntimeError("unrecoverable")

    r = FaultTolerantRunner(
        ok_step, RunnerConfig(max_retries_per_step=0, max_restores=1),
        restore_fn=lambda: (torch.tensor(0.0), 0), fault_hook=hook,
    )
    with pytest.raises(RuntimeError, match="unrecoverable"):
        r.run_step(torch.tensor(0.0), torch.tensor(1.0), 0)


def test_straggler_watchdog_timeout():
    def slow_step(state, batch):
        time.sleep(1.0)
        return state, {}

    r = FaultTolerantRunner(slow_step, RunnerConfig(
        max_retries_per_step=0, max_restores=0, step_timeout_s=0.1))
    with pytest.raises(StepTimeoutError):
        r.run_step(torch.tensor(0.0), torch.tensor(1.0), 0)


def test_straggler_detection_flags_slow_step():
    delays = [0.01] * 10 + [0.2]

    def step(state, batch):
        time.sleep(delays.pop(0))
        return state, {}

    r = FaultTolerantRunner(step, RunnerConfig(straggler_slack=3.0))
    for i in range(11):
        r.run_step(torch.tensor(0.0), torch.tensor(1.0), i)
    assert r.stats[-1].straggler
    assert not any(st.straggler for st in r.stats[:-1])


def test_step_still_running_after_the_wait_is_not_retried():
    """A step that outlives its deadline and ``abandon_wait_s`` may still
    write the state: the runner gives up rather than retry beside it."""
    calls = {"n": 0}
    release = threading.Event()

    def hung_step(state, batch):
        calls["n"] += 1
        release.wait(5.0)
        return state, {}

    r = FaultTolerantRunner(hung_step, RunnerConfig(
        max_retries_per_step=2, step_timeout_s=0.05, abandon_wait_s=0.1),
        restore_fn=lambda: (torch.tensor(0.0), 0))
    with pytest.raises(StepAbandonedError):
        r.run_step(torch.tensor(0.0), torch.tensor(1.0), 0)
    release.set()
    assert calls["n"] == 1


# --------------------------------------------------------------------- #
# the port's in-place train step under the runner
# --------------------------------------------------------------------- #
ARCH = "qwen3-0.6b_smoke"
OPTIMIZERS = {"adamw": adamw, "lion": lion, "sgd": sgd}


def _state(cfg, opt):
    return steps.make_init_state(cfg, opt, "cpu")(torch.Generator().manual_seed(0))


def _batch(cfg, i):
    return {"tokens": torch.from_numpy(SyntheticLM(cfg.vocab, seed=0).batch(i, 2, 16)["tokens"])}


def _assert_states_equal(a, b):
    assert a["opt"]["step"] == b["opt"]["step"]
    for (n, p), (_, q) in zip(a["model"].named_parameters(), b["model"].named_parameters(),
                              strict=True):
        assert torch.equal(p, q), n
    for name in a["opt"]:
        if name != "step":
            for n, t in a["opt"][name].items():
                assert torch.equal(t, b["opt"][name][n]), (name, n)


def _unfailed(cfg, opt, n_steps):
    step_fn = steps.make_train_step(cfg, opt, remat=False)
    state, losses = _state(cfg, opt), []
    for i in range(n_steps):
        state, m = step_fn(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_failure_halfway_through_the_update_retries_exactly(opt_name):
    """The update raises after half the parameters are written (step 1 of
    2); the runner's retry finishes it: parameters, optimizer state, step
    and losses equal the unfailed run's bit for bit."""
    cfg = get_config(ARCH)
    opt = OPTIMIZERS[opt_name](1e-3)
    want, want_losses = _unfailed(cfg, opt, 2)
    half = len(list(want["model"].parameters())) // 2
    fired, current = [], {"step": 0}

    def update_hook(n):
        if n == half and current["step"] == 1 and not fired:
            fired.append(n)
            raise RuntimeError("injected failure after half the update")

    runner = FaultTolerantRunner(steps.make_train_step(cfg, opt, remat=False,
                                                       update_hook=update_hook))
    state, losses = _state(cfg, opt), []
    for i in range(2):
        current["step"] = i
        state, m = runner.run_step(state, _batch(cfg, i), i)
        losses.append(float(m["loss"]))
    assert fired == [half] and [s.retried for s in runner.stats] == [0, 1]
    assert losses == want_losses
    _assert_states_equal(state, want)


@pytest.mark.parametrize("outcome", ["finishes", "fails"])
def test_timed_out_step_retries_exactly(outcome):
    """A step's update stalls past the watchdog's deadline halfway through;
    the abandoned dispatch then either finishes its update or fails. The
    runner waits for it: the finished step's result is the retry's (the
    step is not called again), or a retry finishes the half-written
    update. The state equals the unfailed run's bit for bit, and no retry
    ran while the abandoned one did."""
    cfg = get_config(ARCH)
    opt = adamw(1e-3)
    want, want_losses = _unfailed(cfg, opt, 2)
    half = len(list(want["model"].parameters())) // 2
    events, stalled = [], []

    def update_hook(n):
        if n == half and not stalled:
            stalled.append(threading.current_thread())
            events.append("stall")
            time.sleep(0.5)  # past the 0.2 s deadline
            events.append("abandoned ends")
            if outcome == "fails":
                raise RuntimeError("the abandoned step fails after its deadline")

    train_step = steps.make_train_step(cfg, opt, remat=False, update_hook=update_hook)

    def step_fn(state, batch):
        events.append("attempt")
        return train_step(state, batch)

    runner = FaultTolerantRunner(step_fn, RunnerConfig(step_timeout_s=0.2, max_retries_per_step=1))
    state, m = runner.run_step(_state(cfg, opt), _batch(cfg, 0), 0)
    losses = [float(m["loss"])]
    # the next step unwatched: on a loaded machine a plain step may take 0.2 s
    state, m = step_fn(state, _batch(cfg, 1))
    losses.append(float(m["loss"]))
    retry = ["attempt"] if outcome == "fails" else []
    assert events == ["attempt", "stall", "abandoned ends", *retry, "attempt"]
    assert not stalled[0].is_alive() and runner.stats[0].retried == 1
    assert losses == want_losses
    _assert_states_equal(state, want)


def test_runtime_package_imports_neither_torch_nor_jax():
    code = ("import sys, repro_torch.runtime as r; r.FaultTolerantRunner; "
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules, sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": "src"},
                   cwd=Path(__file__).resolve().parents[1])
