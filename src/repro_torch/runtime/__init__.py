"""Runtime: the retry and watchdog core the sweep executor runs on, the
circuit breaker of the mapping service, the training loop's
fault-tolerant runner, gradient compression and elastic mesh planning.

Imports neither torch nor jax: spawned sweep workers import it. The
compression and elastic exports (which need torch) load on first
attribute access (PEP 562), as the reference's lazy exports do.
"""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    CallTimeoutError,
    CircuitBreaker,
    FaultTolerantRunner,
    PeerStepError,
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

_LAZY = {
    "compress_int8": "repro_torch.runtime.compression",
    "decompress_int8": "repro_torch.runtime.compression",
    "error_feedback_update": "repro_torch.runtime.compression",
    "make_compressed_allreduce": "repro_torch.runtime.compression",
    "compressed_wire_bytes": "repro_torch.runtime.compression",
    "raw_wire_bytes": "repro_torch.runtime.compression",
    "plan_mesh": "repro_torch.runtime.elastic",
    "plan_mesh_shape": "repro_torch.runtime.elastic",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.runtime' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cached: later access skips __getattr__
    return value
