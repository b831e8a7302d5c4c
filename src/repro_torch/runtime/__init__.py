"""Runtime: the retry and watchdog core the sweep executor runs on, and the
circuit breaker of the mapping service.

Imports neither torch nor jax: spawned sweep workers import it.
"""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    CallTimeoutError,
    CircuitBreaker,
    RetryPolicy,
    RetryStats,
    StepTimeoutError,
    StragglerMeter,
    backoff_delay,
    call_with_deadline,
    retry_call,
)
