"""Runtime: the retry and watchdog core the sweep executor runs on.

Imports neither torch nor jax: spawned sweep workers import it.
"""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    CallTimeoutError,
    RetryPolicy,
    RetryStats,
    StepTimeoutError,
    StragglerMeter,
    backoff_delay,
    call_with_deadline,
    retry_call,
)
