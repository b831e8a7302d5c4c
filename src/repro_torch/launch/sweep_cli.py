"""Shared CLI plumbing for the fault-tolerant sweep executor (twin of
``benchmarks/sweep_cli.py``).

Every sweep entry point of the port drives ``union_opt_sweep``; this
module gives them one flag vocabulary for the executor knobs
(``--workers``, ``--pool``, ``--group-timeout``, ``--group-retries``,
``--journal``, ``--resume``)
and one place for the deterministic-stats convention the crash/resume
byte-identity check relies on (``UNION_DETERMINISTIC_STATS``: emit only
warm/cold-invariant counters and omit the ``result_store`` block, so a
killed-and-resumed run serializes byte-identically to an
uninterrupted one).
"""

from __future__ import annotations

import argparse
import os


def add_sweep_args(ap: argparse.ArgumentParser) -> None:
    """Add the sweep-executor flags shared by all figure benchmarks."""
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="concurrent engine-group dispatches (0/1 = serial; "
                         ">1 runs independent groups on a worker pool)")
    ap.add_argument("--pool", default="auto",
                    choices=["auto", "thread", "process", "serial"],
                    help="worker pool kind for --workers > 1 (auto = "
                         "process: spawned interpreters, the load-bearing "
                         "path since the numpy engine is GIL-bound)")
    ap.add_argument("--group-timeout", type=float, default=None,
                    metavar="SECS",
                    help="per-group watchdog deadline; a hung dispatch is "
                         "abandoned and retried (default: no deadline)")
    ap.add_argument("--group-retries", type=int, default=2, metavar="N",
                    help="bounded retries per group before the sweep fails")
    ap.add_argument("--journal", default=None, metavar="FILE",
                    help="crash-safe sweep journal (atomic per-group "
                         "flush); enables --resume")
    ap.add_argument("--resume", action="store_true",
                    help="replay groups already completed in --journal "
                         "instead of re-searching them (warm-starts the "
                         "rest from the result store)")


def sweep_kwargs(args: argparse.Namespace) -> dict:
    """``union_opt_sweep`` executor kwargs from parsed args."""
    if args.resume and not args.journal:
        raise SystemExit("--resume requires --journal FILE")
    return {
        "workers": args.workers,
        "pool": args.pool,
        "group_timeout_s": args.group_timeout,
        "max_group_retries": args.group_retries,
        "journal": args.journal,
        "resume": args.resume,
    }


def deterministic_stats() -> bool:
    """True when figure JSONs must contain only run-invariant content
    (see ``SearchResult.stats_dict``); figure scripts then omit their
    ``result_store`` block, whose hit/entry counts shift with warmth."""
    return bool(os.environ.get("UNION_DETERMINISTIC_STATS"))
