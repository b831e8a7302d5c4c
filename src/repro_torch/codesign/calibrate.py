"""Measured-vs-modeled calibration: the feedback half of the co-design
loop (the port's copy of ``repro/codesign/calibrate.py``).

This module times the port's kernel per (kernel, shape, BlockConfig) and
records the measured time next to the model's predicted cycles in a
:class:`CalibrationTable`. On a CUDA device it times the CUDA kernel with
CUDA events over many launches after a warm-up, and records the row with
``interpret=False``. On the CPU it times the kernel's plain version with
the host clock and records ``interpret=True``: such a row says how fast
PyTorch's CPU kernels are, never how fast the card is, and
:meth:`CalibrationTable.scale_for` never mixes the two kinds of row.

The table persists as ONE versioned JSON file with the same discipline as
``core/cost/store.py``: plain-data JSON (never pickle -- a table is meant
to be shared, and loading it must never be a
code-execution surface), writer-unique tmp + atomic rename under an
advisory flock, stale-tmp cleanup, and corrupt/version-mismatched
payloads tolerated (counted, then overwritten on next flush) rather than
fatal.

From the table two things flow back into the stack:

  * :meth:`CalibrationTable.scale_for` distills the records into a
    :class:`CalibrationScale` -- the geometric-mean ratio of measured to
    predicted seconds -- which plugs into any
    :class:`~repro_torch.core.cost.base.CostModel` via ``set_calibration()``.
    A calibrated model rescales every latency prediction by that factor
    and reports the calibration in ``store_key_parts()``, so calibrated
    and raw results never alias in a ``ResultStore``.
  * :meth:`CalibrationTable.model_error_report` summarizes the residual
    per-kernel x shape model error AFTER applying the scale -- the
    validation artifact ``chip_smoke.py`` prints.

A CPU row (``interpret=True``, the reference package's name for a run
that is not on the device) lets the CPU tests drive the loop end to end;
it says nothing about the card.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platform
    fcntl = None

from repro_torch.codesign.space import BlockConfig, KernelSpace

log = logging.getLogger("repro_torch.codesign")

CALIBRATION_VERSION = 1


@dataclass(frozen=True)
class CalibrationScale:
    """A distilled calibration: multiply predicted latency by ``scale``.

    ``key_parts()`` is what a calibrated :class:`CostModel` appends to its
    ``store_key_parts()`` -- it identifies the calibration (value +
    provenance), so results computed under different calibrations can
    never alias in a ResultStore."""

    scale: float
    n_records: int = 0
    source: str = ""  # e.g. "interpret:matmul" or "device:*"

    def __post_init__(self):
        if not (self.scale > 0.0 and math.isfinite(self.scale)):
            raise ValueError(
                f"calibration scale must be a finite positive number, "
                f"got {self.scale!r}"
            )

    def key_parts(self) -> Tuple[object, ...]:
        return ("calibrated", f"{self.scale:.6e}", self.source)


def _measured_key(kernel: str, shape, config) -> str:
    return f"{kernel}|{','.join(map(str, shape))}|{','.join(map(str, config))}"


class CalibrationTable:
    """Append-mostly table of measured-vs-predicted rows.

    Each row: ``{kernel, shape, config, model, predicted_cycles,
    frequency_hz, predicted_s, measured_s, interpret, repeats, ts}``.
    Re-recording the same (kernel, shape, config, model, interpret) cell
    replaces the old row -- measurements supersede, they do not
    accumulate. ``path=None`` keeps the table purely in memory."""

    def __init__(self, path: Optional[object] = None) -> None:
        self.path = Path(path) if path is not None else None
        self.rows: List[dict] = []
        # store.py-style health counters
        self.corrupt_payloads = 0
        self.version_mismatches = 0
        self.stale_tmps = 0
        if self.path is not None and self.path.exists():
            self._load()

    # -------------------------------------------------------------- #
    def _load(self) -> None:
        try:
            payload = json.loads(self.path.read_text())
            if not isinstance(payload, dict):
                raise ValueError("payload is not an object")
            if payload.get("version") != CALIBRATION_VERSION:
                self.version_mismatches += 1
                log.warning(
                    "calibration table %s: version %r != %d; starting "
                    "empty (file will be rewritten on flush)",
                    self.path, payload.get("version"), CALIBRATION_VERSION,
                )
                return
            rows = payload.get("rows")
            if not isinstance(rows, list):
                raise ValueError("rows is not a list")
            self.rows = [r for r in rows if self._row_ok(r)]
            dropped = len(rows) - len(self.rows)
            if dropped:
                self.corrupt_payloads += dropped
        except (OSError, ValueError):
            self.corrupt_payloads += 1
            log.warning(
                "calibration table %s: corrupt payload; starting empty",
                self.path,
            )

    @staticmethod
    def _row_ok(r) -> bool:
        try:
            return (
                isinstance(r, dict)
                and isinstance(r["kernel"], str)
                and float(r["predicted_s"]) > 0.0
                and float(r["measured_s"]) > 0.0
            )
        except (KeyError, TypeError, ValueError):
            return False

    # -------------------------------------------------------------- #
    def record(
        self,
        kernel: str,
        shape: Sequence[int],
        config: BlockConfig,
        model: Sequence[object],
        predicted_cycles: float,
        frequency_hz: float,
        measured_s: float,
        *,
        interpret: bool = True,
        repeats: int = 1,
    ) -> dict:
        row = {
            "kernel": str(kernel),
            "shape": [int(s) for s in shape],
            "config": [int(c) for c in config],
            "model": [repr(p) for p in model],
            "predicted_cycles": float(predicted_cycles),
            "frequency_hz": float(frequency_hz),
            "predicted_s": float(predicted_cycles) / float(frequency_hz),
            "measured_s": float(measured_s),
            "interpret": bool(interpret),
            "repeats": int(repeats),
            "ts": time.time(),
        }
        cell = (row["kernel"], row["shape"], row["config"], row["model"],
                row["interpret"])
        self.rows = [
            r for r in self.rows
            if (r["kernel"], r["shape"], r["config"], r["model"],
                r.get("interpret", True)) != cell
        ]
        self.rows.append(row)
        return row

    def _select(
        self, kernel: Optional[str], interpret: Optional[bool]
    ) -> List[dict]:
        out = []
        for r in self.rows:
            if kernel is not None and r["kernel"] != kernel:
                continue
            if interpret is not None and bool(r.get("interpret", True)) != interpret:
                continue
            out.append(r)
        return out

    # -------------------------------------------------------------- #
    def scale_for(
        self,
        kernel: Optional[str] = None,
        *,
        interpret: bool = True,
    ) -> Optional[CalibrationScale]:
        """Geometric-mean measured/predicted seconds over the matching
        rows (``kernel=None`` pools every kernel). Geomean, not mean:
        ratios compose multiplicatively and a geomean is insensitive to
        which side of the ratio you average. Returns ``None`` when no
        usable rows exist -- callers then simply leave the model
        uncalibrated."""
        rows = self._select(kernel, interpret)
        logs = [
            math.log(r["measured_s"] / r["predicted_s"])
            for r in rows
            if r["predicted_s"] > 0.0 and r["measured_s"] > 0.0
        ]
        if not logs:
            return None
        mode = "interpret" if interpret else "device"
        return CalibrationScale(
            scale=math.exp(sum(logs) / len(logs)),
            n_records=len(logs),
            source=f"{mode}:{kernel or '*'}",
        )

    def model_error_report(
        self,
        kernel: Optional[str] = None,
        *,
        interpret: bool = True,
    ) -> List[dict]:
        """Residual model error per (kernel, shape) AFTER applying this
        table's scale: ``error_pct = 100 * (scale*predicted_s -
        measured_s) / measured_s``. The per-kernel scale is used when that
        kernel has rows, the pooled scale otherwise."""
        report = []
        kernels = sorted({r["kernel"] for r in self._select(kernel, interpret)})
        for k in kernels:
            cal = self.scale_for(k, interpret=interpret) or self.scale_for(
                None, interpret=interpret
            )
            s = cal.scale if cal else 1.0
            for r in self._select(k, interpret):
                err = 100.0 * (s * r["predicted_s"] - r["measured_s"]) / r[
                    "measured_s"
                ]
                report.append(
                    {
                        "kernel": k,
                        "shape": list(r["shape"]),
                        "config": list(r["config"]),
                        "predicted_s": r["predicted_s"],
                        "measured_s": r["measured_s"],
                        "scale": s,
                        "error_pct": err,
                        "abs_error_pct": abs(err),
                        "interpret": bool(r.get("interpret", True)),
                    }
                )
        return report

    # -------------------------------------------------------------- #
    def _lock(self):
        """Advisory flock on ``<table>.lock`` (constant file, never
        unlinked -- same rationale as the ResultStore directory lock)."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            if fcntl is None or self.path is None:
                yield
                return
            with open(self.path.with_name(self.path.name + ".lock"), "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

        return cm()

    def flush(self) -> int:
        """Atomically write the table (writer-unique tmp + rename under
        the lock, stale ``.ctmp`` scratch cleaned). No-op in-memory."""
        if self.path is None:
            return 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": CALIBRATION_VERSION, "rows": self.rows}
        with self._lock():
            now = time.time()
            for tmp in self.path.parent.glob(f".{self.path.name}.*.ctmp"):
                try:
                    if fcntl is None and now - tmp.stat().st_mtime < 60.0:
                        continue
                    tmp.unlink()  # crashed writer's scratch
                    self.stale_tmps += 1
                except OSError:
                    pass
            tmp = self.path.with_name(
                f".{self.path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.ctmp"
            )
            tmp.write_text(json.dumps(payload, separators=(",", ":")))
            tmp.replace(self.path)
        return len(self.rows)

    def stats_dict(self) -> dict:
        return {
            "rows": len(self.rows),
            "kernels": sorted({r["kernel"] for r in self.rows}),
            "corrupt_payloads": self.corrupt_payloads,
            "version_mismatches": self.version_mismatches,
            "stale_tmps": self.stale_tmps,
        }


# ---------------------------------------------------------------------- #
# measurement
# ---------------------------------------------------------------------- #
def _timing_device(device):
    """``device`` as a torch.device the timers can time on: CUDA (raises
    without a card; nothing falls back to the CPU) or the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calibrate: device cuda requested but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"calibrate: no timing path for device {device}")
    return device


def time_launches(run, device="cuda", *, repeats: int = 3, iters: int = 10) -> float:
    """Seconds per call of ``run()``: the best of ``repeats`` windows of
    ``iters`` calls each, after one untimed call (best-of-N, because
    scheduling noise only ever adds time). On CUDA the windows are timed
    with CUDA events on the current stream; on the CPU with the host
    clock. ``device="cuda"`` without a card raises; it never falls back to
    the CPU."""
    import torch

    device = _timing_device(device)
    run()  # warm-up: builds and loads the kernel
    best = math.inf
    for _ in range(max(1, int(repeats))):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                run()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best


def measure_kernel(
    space: KernelSpace,
    shape: Sequence[int],
    config: BlockConfig,
    *,
    device="cuda",
    repeats: int = 3,
    iters: int = 10,
    seed: int = 0,
) -> float:
    """Seconds per launch at ``config`` on inputs made from ``seed``
    (:func:`time_launches`; on the CPU the plain version runs).
    ``device="cuda"`` without a card raises; it never falls back to the
    CPU."""
    import torch

    device = _timing_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = space.example_inputs(shape, device, gen)
    return time_launches(
        lambda: space.run(inputs, config), device, repeats=repeats, iters=iters
    )


def calibrate_kernel(
    space: KernelSpace,
    shapes: Sequence[Sequence[int]],
    table: Optional[CalibrationTable] = None,
    *,
    model: Optional[object] = None,
    device="cuda",
    repeats: int = 3,
    iters: int = 10,
    **plan_kwargs,
) -> CalibrationTable:
    """Plan, predict, measure, and record each shape; returns the table.

    Each shape goes through :func:`~repro_torch.codesign.planner.plan` (so
    calibration times exactly the BlockConfig the kernel would launch),
    the model's predicted cost for the legalized config is read off the
    plan, and the measured time lands next to it in the table, as a
    device row on CUDA and an ``interpret`` row on the CPU. Caller owns
    ``table.flush()``."""
    import torch

    from repro_torch.codesign.planner import _resolve_model, plan, predict_cost

    on_device = torch.device(device).type == "cuda"
    table = table if table is not None else CalibrationTable()
    cm = _resolve_model(space, model)
    for shape in shapes:
        p = plan(space, shape, model=cm, **plan_kwargs)
        cost = p.cost if p.cost is not None else predict_cost(space, shape, p.config, cm)
        measured = measure_kernel(
            space, shape, p.config, device=device, repeats=repeats, iters=iters
        )
        table.record(
            space.name,
            shape,
            p.config,
            cm.store_key_parts(),
            cost.latency_cycles,
            cost.frequency_hz,
            measured,
            interpret=not on_device,
            repeats=repeats,
        )
    return table
