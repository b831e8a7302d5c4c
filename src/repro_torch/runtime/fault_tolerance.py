"""Fault tolerance: the watchdog and retry core of the sweep executor (a
copy of the jax-free part of ``repro/runtime/fault_tolerance.py``).

A unit of work that raises is retried a bounded number of times; one that
hangs or straggles misses a watchdog deadline, and the caller abandons the
dispatch and runs it again:

  * :func:`call_with_deadline` -- run any callable under a watchdog
    deadline (raises :class:`CallTimeoutError` on a miss);
  * :class:`RetryPolicy` / :func:`retry_call` -- bounded retries with
    exponential backoff and DETERMINISTIC jitter (hashed from the call
    label + attempt, so concurrent retry storms de-synchronize without
    randomness that would break reproducible tests);
  * :class:`StragglerMeter` -- moving-average straggler detection;
  * :class:`CircuitBreaker` -- closed/open/half-open breaker with a
    count-based probe schedule, around the engine's torch backend in the
    long-lived mapping service.

  * :class:`FaultTolerantRunner` -- the training-loop shape (step_fn +
    checkpoint restore) expressed through the core above.

``repro_torch.core.sweep_exec`` wraps every group dispatch of
``union_opt_sweep`` in ``retry_call`` with a per-group deadline; those
deadlines time host work. The runner's deadline times a train step to its
end on the device (it synchronises the state's CUDA device). The module
imports neither torch nor jax, so spawned sweep workers import it cheaply;
the runner finds torch in ``sys.modules`` when its state holds tensors.
"""

from __future__ import annotations

import hashlib
import logging
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.runtime")


class CallTimeoutError(RuntimeError):
    """A watchdogged callable missed its deadline. ``abandoned`` is the
    thread still running it; ``outcome`` gets its result under "out" or its
    error under "err" once that thread ends."""

    def __init__(self, msg: str = "", abandoned: Optional[threading.Thread] = None,
                 outcome: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(msg)
        self.abandoned = abandoned
        self.outcome = outcome


class StepTimeoutError(CallTimeoutError):
    """Back-compat alias: a training step missed its deadline."""


# ------------------------------------------------------------------ #
# Generic watchdog / retry core
# ------------------------------------------------------------------ #
def call_with_deadline(fn: Callable[[], Any], deadline_s: Optional[float],
                       label: str = "call"):
    """Run ``fn()`` under a watchdog deadline.

    ``deadline_s=None`` calls inline (no thread). Otherwise the callable
    runs in a named daemon thread; a missed deadline raises
    :class:`CallTimeoutError` and the thread is ABANDONED (there is no
    portable way to cancel arbitrary Python work -- the thread keeps the
    GIL-yielding work alive until it returns, which is why hung work must
    itself be bounded, e.g. an injected hang sleeps past the deadline but
    not forever). On a completed call the thread is joined promptly, so
    an early exit never leaves a live watchdog behind.
    """
    if deadline_s is None:
        return fn()
    done = threading.Event()
    box: Dict[str, Any] = {}

    def work():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised in the caller below
            box["err"] = e
        finally:
            done.set()

    th = threading.Thread(target=work, name=f"deadline:{label}", daemon=True)
    th.start()
    if not done.wait(deadline_s):
        raise CallTimeoutError(f"{label} exceeded {deadline_s}s deadline", abandoned=th,
                               outcome=box)
    th.join()  # finished: reap promptly, no lingering thread on early exit
    if "err" in box:
        raise box["err"]
    return box.get("out")


@dataclass
class RetryPolicy:
    """Bounded-retry + deadline + backoff policy for one unit of work."""

    max_retries: int = 2                 # re-runs after the first attempt
    deadline_s: Optional[float] = None   # per-attempt watchdog (None = off)
    backoff_s: float = 0.0               # base backoff; exponential per retry
    backoff_cap_s: float = 30.0
    jitter: float = 0.25                 # +/- fraction of the backoff


@dataclass
class RetryStats:
    """Counters accumulated by :func:`retry_call` (shareable across calls)."""

    attempts: int = 0
    retries: int = 0
    timeouts: int = 0
    backoff_total_s: float = 0.0
    errors: List[str] = field(default_factory=list)


def backoff_delay(policy: RetryPolicy, attempt: int, label: str) -> float:
    """Exponential backoff with deterministic jitter.

    The jitter is hashed from (label, attempt), NOT drawn from a global
    RNG: retrying groups of a sweep de-synchronize from each other (their
    labels differ) while every run of the same sweep behaves identically
    -- a requirement for the crash/resume byte-identity tests.
    """
    base = min(policy.backoff_cap_s, policy.backoff_s * (2 ** (attempt - 1)))
    if base <= 0:
        return 0.0
    h = hashlib.sha256(f"{label}:{attempt}".encode()).digest()
    u = int.from_bytes(h[:8], "big") / 2**64
    return base * (1.0 + policy.jitter * (2.0 * u - 1.0))


def retry_call(
    fn: Callable[[int], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    label: str = "call",
    attempt_hook: Optional[Callable[[int], None]] = None,
    on_error: Optional[Callable[[int, BaseException], None]] = None,
    stats: Optional[RetryStats] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``fn(attempt)`` under ``policy``: per-attempt deadline, bounded
    retries, exponential backoff with deterministic jitter.

    ``attempt_hook(attempt)`` runs before each attempt and may raise --
    the fault-injection point the tests (and ``UNION_FAULT_SPEC``) use.
    ``on_error(attempt, exc)`` observes each failure before the retry
    decision. Returns ``(result, RetryStats)``; raises the last error
    once retries are exhausted. Pass ``stats`` to accumulate counters
    across several calls (e.g. one sweep-wide ledger).
    """
    policy = policy or RetryPolicy()
    st = stats if stats is not None else RetryStats()
    attempt = 0
    while True:
        st.attempts += 1
        try:
            if attempt_hook is not None:
                attempt_hook(attempt)
            out = call_with_deadline(
                lambda: fn(attempt), policy.deadline_s, label=f"{label}#{attempt}"
            )
            return out, st
        except Exception as e:  # noqa: BLE001 -- deliberate catch-all
            if isinstance(e, CallTimeoutError):
                st.timeouts += 1
            st.errors.append(f"{type(e).__name__}: {e}")
            if on_error is not None:
                on_error(attempt, e)
            log.warning("%s failed (%s: %s), attempt %d/%d", label,
                        type(e).__name__, e, attempt + 1,
                        policy.max_retries + 1)
            if attempt >= policy.max_retries:
                raise
            st.retries += 1
            attempt += 1
            d = backoff_delay(policy, attempt, label)
            if d > 0:
                st.backoff_total_s += d
                sleep(d)


class CircuitBreaker:
    """Closed/open/half-open circuit breaker with a DETERMINISTIC probe
    schedule.

    The sweep executor's backend degradation is one-way: a torch-backend
    failure flips the engine to numpy for the rest of its life. A
    long-lived process (the mapping-service daemon) needs the stateful,
    recoverable version: ``failure_threshold`` consecutive failures OPEN
    the circuit (callers take the fallback path without touching the
    protected backend), every ``probe_interval``-th denied call
    transitions to HALF-OPEN and admits exactly one probe, and the
    probe's outcome either CLOSES the circuit (recovery) or re-opens it
    (the probe counter restarts).

    The probe schedule counts *denied calls*, not wall-clock: tests (and
    the deterministic fault-injection drills) step the breaker through
    open -> half-open -> closed without sleeping, and two runs of the
    same request stream always probe at the same points. An optional
    ``cooldown_s`` adds a wall-clock floor between probes for production
    use (``clock`` is injectable for tests); by default it is 0 and the
    schedule is purely count-based.

    Thread-safe: the daemon's worker threads share one breaker. State
    transitions are recorded in ``transitions`` (capped) so services can
    export them as metrics.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: int = 3,
        probe_interval: int = 4,
        cooldown_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        label: str = "breaker",
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if probe_interval < 1:
            raise ValueError("probe_interval must be >= 1")
        self.failure_threshold = failure_threshold
        self.probe_interval = probe_interval
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.label = label
        self.state = self.CLOSED
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._denied_since_probe = 0
        self._opened_at = 0.0
        # counters / transition log (metrics surface)
        self.failures = 0
        self.successes = 0
        self.denied = 0
        self.probes = 0
        self.opened = 0
        self.recovered = 0
        self.transitions: List[str] = []

    # -------------------------------------------------------------- #
    def _transition(self, new_state: str) -> None:
        if new_state != self.state:
            self.transitions.append(f"{self.state}->{new_state}")
            del self.transitions[:-64]  # cap the log, keep the newest
            self.state = new_state

    def allow(self) -> bool:
        """May the protected backend be tried right now?

        CLOSED: always. OPEN: deny, but every ``probe_interval``-th
        denied call (past any ``cooldown_s``) flips to HALF-OPEN and
        admits that call as the single probe. HALF-OPEN: deny (one probe
        is already in flight; its record_success/record_failure decides).
        """
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.HALF_OPEN:
                self.denied += 1
                return False
            # OPEN
            if self.cooldown_s and (
                self.clock() - self._opened_at < self.cooldown_s
            ):
                self.denied += 1
                return False
            self._denied_since_probe += 1
            if self._denied_since_probe >= self.probe_interval:
                self._denied_since_probe = 0
                self.probes += 1
                self._transition(self.HALF_OPEN)
                log.warning("%s: half-open probe admitted", self.label)
                return True
            self.denied += 1
            return False

    def record_success(self) -> None:
        """A protected call completed: close from half-open (recovery),
        reset the consecutive-failure count when already closed."""
        with self._lock:
            self.successes += 1
            self._consecutive_failures = 0
            if self.state == self.HALF_OPEN:
                self.recovered += 1
                self._transition(self.CLOSED)
                log.warning("%s: probe succeeded -- circuit CLOSED", self.label)

    def record_failure(self) -> None:
        """A protected call failed: re-open from half-open (the probe
        lost), or open once ``failure_threshold`` consecutive closed-state
        failures accumulate."""
        with self._lock:
            self.failures += 1
            if self.state == self.HALF_OPEN:
                self.opened += 1
                self._opened_at = self.clock()
                self._denied_since_probe = 0
                self._transition(self.OPEN)
                log.warning("%s: probe failed -- circuit re-OPENED", self.label)
                return
            self._consecutive_failures += 1
            if (
                self.state == self.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self.opened += 1
                self._opened_at = self.clock()
                self._denied_since_probe = 0
                self._transition(self.OPEN)
                log.warning(
                    "%s: %d consecutive failures -- circuit OPEN",
                    self.label, self._consecutive_failures,
                )

    def stats_dict(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "failures": self.failures,
                "successes": self.successes,
                "denied": self.denied,
                "probes": self.probes,
                "opened": self.opened,
                "recovered": self.recovered,
                "transitions": list(self.transitions),
            }


class StragglerMeter:
    """Moving-average straggler detection: flags a duration slower than
    ``slack`` x the average of the last ``window`` durations."""

    def __init__(self, window: int = 20, slack: float = 3.0) -> None:
        self.window = window
        self.slack = slack
        self._durations: List[float] = []
        self.flagged = 0

    def note(self, dt: float) -> bool:
        w = self._durations[-self.window:]
        straggler = bool(w) and dt > self.slack * (sum(w) / len(w))
        self._durations.append(dt)
        if straggler:
            self.flagged += 1
        return straggler

    def avg(self) -> float:
        w = self._durations[-self.window:]
        return sum(w) / max(1, len(w))


# ------------------------------------------------------------------ #
# Train-step runner
# ------------------------------------------------------------------ #
@dataclass
class RunnerConfig:
    max_retries_per_step: int = 2       # transient-failure retries
    max_restores: int = 3               # checkpoint restores before giving up
    step_timeout_s: Optional[float] = None  # straggler deadline (None = off)
    # moving-average straggler detection: flag steps slower than
    # slack * avg of the last window steps
    straggler_window: int = 20
    straggler_slack: float = 3.0
    # after a missed deadline, how long to wait for the abandoned step to
    # end before giving up (None = as long as it takes)
    abandon_wait_s: Optional[float] = 600.0


@dataclass
class StepStats:
    step: int
    seconds: float
    retried: int       # failed attempts before this success (CUMULATIVE
    #                    across checkpoint restores)
    straggler: bool


class PeerStepError(RuntimeError):
    """This rank's attempt went well, another rank's failed: every rank
    retries the step."""


class StepAbandonedError(StepTimeoutError):
    """A step missed its deadline and was still running ``abandon_wait_s``
    later: it may still write the state, so nothing is retried."""


def _devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in a state/metrics tree."""
    torch = sys.modules.get("torch")
    if torch is None:
        return found
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, torch.nn.Module):
        found.update(p.device for p in tree.parameters() if p.is_cuda)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, found)
    return found


class FaultTolerantRunner:
    """Wraps a step function with retry/restore/straggler logic (port of the
    reference's runner).

    ``step_fn(state, batch) -> (state, metrics)``: on failure the runner
    calls it again with the same (state, batch). The reference's step is
    functional; the port's updates the model and optimizer state in place,
    so a retry is exact only because ``launch.steps.make_train_step``
    records a half-written update on the state and a retry finishes it. A
    step that misses its deadline is abandoned in a thread that may still
    be writing the state: the runner waits for that thread to end
    (``abandon_wait_s``) and gives up (:class:`StepAbandonedError`) if it
    does not. The timed-out attempt counts as failed; if the thread then
    ended with a result, that result is the retry's (running the step
    again would apply its update twice), else the retry calls ``step_fn``.
    Checkpoint restore (``restore_fn() -> (state, step)``) is the last line
    of defense once a step's retries are spent; the restored state then
    takes the step's batch, as in the reference.

    On a mesh, ``agree(ok) -> bool`` (a collective: True when every rank
    passed True) runs after ``fault_hook`` before each dispatch, so a fault
    on one rank fails the attempt on all and they retry together (the
    sharded step agrees again before its update commits).
    """

    def __init__(
        self,
        step_fn: Callable,
        cfg: RunnerConfig = RunnerConfig(),
        *,
        checkpoint_manager=None,
        restore_fn: Optional[Callable] = None,  # () -> (state, step)
        fault_hook: Optional[Callable[[int], None]] = None,  # test injection
        agree: Optional[Callable[[bool], bool]] = None,  # the ranks' outcome, on a mesh
    ) -> None:
        self.step_fn = step_fn
        self.cfg = cfg
        self.ckpt = checkpoint_manager
        self.restore_fn = restore_fn
        self.fault_hook = fault_hook
        self.agree = agree
        self._meter = StragglerMeter(cfg.straggler_window, cfg.straggler_slack)
        self._restores = 0
        self.stats: list[StepStats] = []

    # ---------------------------------------------------------------- #
    def _block(self, tree) -> None:
        """Wait for the device work of ``tree`` (the deadline times the step,
        not its launch); nothing to wait for on the CPU."""
        for dev in _devices(tree, set()):
            sys.modules["torch"].cuda.synchronize(dev)

    def _run_once(self, state, batch, step: int):
        """One dispatch with an optional watchdog deadline."""
        err = None
        try:
            if self.fault_hook is not None:
                self.fault_hook(step)  # may raise (injected fault)
        except Exception as e:  # noqa: BLE001 -- the ranks hear of it first
            err = e
        if self.agree is not None and not self.agree(err is None) and err is None:
            err = PeerStepError(f"step {step}: another rank failed before its dispatch")
        if err is not None:
            raise err

        def dispatch():
            out = self.step_fn(state, batch)
            self._block(out)
            return out

        try:
            return call_with_deadline(dispatch, self.cfg.step_timeout_s, label=f"step{step}")
        except CallTimeoutError as e:
            # the abandoned dispatch writes the state in place: nothing
            # goes on before it has ended
            e.abandoned.join(self.cfg.abandon_wait_s)
            if e.abandoned.is_alive():
                raise StepAbandonedError(f"{e}; still running {self.cfg.abandon_wait_s}s "
                                         f"later") from None
            raise StepTimeoutError(str(e), outcome=e.outcome) from None

    # ---------------------------------------------------------------- #
    def run_step(self, state, batch, step: int):
        """Returns (new_state, metrics). Raises only after exhausting both
        retries and checkpoint restores."""
        budget_used = 0     # retries since the last restore (the budget)
        failed_attempts = 0  # cumulative, for stats
        late = None  # the outcome of an attempt that ended after its deadline
        while True:
            t0 = time.time()
            try:
                if late is not None and "out" in late:
                    out, late = late["out"], None  # it finished: the retry's result
                else:
                    out = self._run_once(state, batch, step)
                dt = time.time() - t0
                straggler = self._meter.note(dt)
                if straggler:
                    log.warning("step %d straggled: %.2fs (avg %.2fs)",
                                step, dt, self._meter.avg())
                self.stats.append(StepStats(step, dt, failed_attempts, straggler))
                return out
            except StepAbandonedError:
                raise
            except Exception as e:  # noqa: BLE001 -- deliberate catch-all
                late = e.outcome if isinstance(e, StepTimeoutError) else None
                budget_used += 1
                failed_attempts += 1
                log.warning("step %d failed (%s: %s), retry %d/%d",
                            step, type(e).__name__, e, budget_used,
                            self.cfg.max_retries_per_step)
                if budget_used <= self.cfg.max_retries_per_step:
                    continue
                if self.restore_fn is not None and self._restores < self.cfg.max_restores:
                    self._restores += 1
                    log.warning("restoring from checkpoint (restore %d/%d)",
                                self._restores, self.cfg.max_restores)
                    state, _ = self.restore_fn()
                    late = None
                    budget_used = 0  # fresh budget; failed_attempts keeps history
                    continue
                raise
