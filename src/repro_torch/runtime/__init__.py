"""Runtime: the retry and watchdog core the sweep executor runs on, the
circuit breaker of the mapping service, and the training loop's
fault-tolerant runner.

Imports neither torch nor jax: spawned sweep workers import it.
"""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    CallTimeoutError,
    CircuitBreaker,
    FaultTolerantRunner,
    RetryPolicy,
    RetryStats,
    RunnerConfig,
    StepAbandonedError,
    StepStats,
    StepTimeoutError,
    StragglerMeter,
    backoff_delay,
    call_with_deadline,
    retry_call,
)
