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
  * :class:`StragglerMeter` -- moving-average straggler detection.

``repro_torch.core.sweep_exec`` wraps every group dispatch of
``union_opt_sweep`` in ``retry_call`` with a per-group deadline. The
deadlines time host work: nothing here synchronises a device. The module
imports neither torch nor jax, so spawned sweep workers import it cheaply.
The reference's ``CircuitBreaker`` (for the mapping service) and
``FaultTolerantRunner`` (the training-loop runner) are not ported yet.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.runtime")


class CallTimeoutError(RuntimeError):
    """A watchdogged callable missed its deadline."""


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
        raise CallTimeoutError(f"{label} exceeded {deadline_s}s deadline")
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
