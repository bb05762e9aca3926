"""Profiling hooks: ``torch.profiler`` traces and per-phase wall timers.

(JAX counterpart: gmmvi_tpu/utils/profiling.py)

* :func:`trace`: a ``torch.profiler`` trace of a code region (CPU and,
  where there is a card, CUDA activity), written as a Chrome trace to
  ``log_dir``;
* :class:`PhaseTimers`: named accumulating wall timers for host-side
  phases.  ``parallel/reduce.py`` times every collective under the phase
  ``"collectives"`` when a :class:`PhaseTimers` is attached to it, which
  splits a meshed step into compute and collectives.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed region into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimers:
    """Accumulating wall timers keyed by phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
