"""Profiling hooks: ``torch.profiler`` traces, the training step's spans and
counters, and per-phase wall timers.

(JAX counterpart: gmmvi_tpu/utils/profiling.py)

* :func:`trace`: a ``torch.profiler`` trace of a code region (CPU and,
  where there is a card, CUDA activity), written as a Chrome trace to
  ``log_dir``, with the spans' and counters' :func:`summary` beside it as
  ``summary_<pid>_<ns>.json``;
* :func:`span`: a named range of the training step, ``gmmvi.<name>`` on
  the profiler's timeline (a ``record_function`` range, so it lands in the
  same trace as the kernels, on its clock) and timed into :data:`SPANS`;
* :func:`count`: a named counter in :data:`SPANS`;
* :func:`read`: a host read of a device value (``.item()``, or a callable
  that reads), inside a span ``read.<site>`` and counted under
  ``host_reads.<site>``: every point where the step makes the host wait
  for the card goes through it;
* :func:`gather_max`: a counter of device values (the fused search's
  trips) that stays on the device until :func:`summary` reads it;
* :func:`summary` and :func:`reset` of :data:`SPANS`;
* :class:`PhaseTimers`: named accumulating wall timers, nested: each
  phase's parent, its self time (its time less its children's), its
  entries and named counters.  :data:`SPANS` is the step's instance;
  ``parallel/reduce.py`` times every collective under the phase
  ``"collectives"`` when a :class:`PhaseTimers` is attached to it, which
  splits a meshed step into compute and collectives.

The switch: tracing is on while a ``torch.profiler`` session is open
(``torch.autograd.profiler._is_profiler_enabled``, which :func:`trace`
and any other session set); when it is off, a span, a counter or a read
costs that one attribute check beside the work itself.  What tracing
does when it is on stays on the host: it adds no host read to the step,
allocates nothing on the card and launches one device operation, the
reduction of :func:`gather_max` (one ``amax`` a step into a buffer of
:data:`GATHER_SLOTS` slots on the card, made at the first gather of a
traced step and read once, by :func:`summary`).

The spans of :meth:`GMMVI.train_iter <gmmvi_tpu_torch.optimization.gmmvi.
GMMVI.train_iter>`: ``train_iter`` around ``grow``, ``draw``,
``propose``, ``target`` (with ``target.call`` around each call into the
target), ``finalize``, ``estimate``, ``update``, ``weights`` and
``adapt``, and the ``read.<site>`` spans of the reads inside them.  The
counters: ``host_reads.<site>``, ``target.rows`` (rows the target
evaluated, a bucket's padding included), ``target.valid_rows`` (the
valid rows among them, where the host holds that count),
``tr_search.trips`` (the most trips any component's trust-region search
took in a step) and ``weight_search.trips`` (the weight search's trips).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "gmmvi."
# the per-step slots of a gather buffer; the last one is the fold's scratch
GATHER_SLOTS = 4096

try:
    _Range = torch._C._profiler._RecordFunctionFast
except AttributeError:          # an older torch: the public range
    _Range = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed region into ``log_dir``: the Chrome
    trace and the summary of the spans and counters recorded in it
    (:data:`SPANS` is reset on entry)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    SPANS.reset()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        stem = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
        with open(os.path.join(log_dir, f"summary_{stem}.json"), "w") as fh:
            json.dump(SPANS.summary(), fh, indent=1)


class _Phase:
    """One entry of a :class:`PhaseTimers` phase, optionally a profiler
    range beside it."""

    __slots__ = ("timers", "name", "marked", "range")

    def __init__(self, timers: "PhaseTimers", name: str, marked: bool):
        self.timers, self.name, self.marked = timers, name, marked

    def __enter__(self):
        if self.marked:
            self.range = _Range(SPAN_PREFIX + self.name)
            self.range.__enter__()
        self.timers.enter(self.name)
        return self

    def __exit__(self, *exc):
        self.timers.exit()
        if self.marked:
            self.range.__exit__(*exc)
        return False


class _DeviceMax:
    """Per-step maxima of device tensors, kept on their device: slot ``i``
    of ``buf`` takes step ``i``'s ``amax``; when the slots are full they
    are summed, on the device, into slot 0 (through the scratch slot), and
    the steps go on from slot 1."""

    def __init__(self, like: torch.Tensor):
        self.slots = GATHER_SLOTS
        self.buf = torch.zeros((self.slots + 1,), dtype=like.dtype,
                               device=like.device)
        self.used = 0

    def add(self, values: torch.Tensor) -> None:
        if self.used == self.slots:
            scratch = self.buf[self.slots]
            torch.sum(self.buf[:self.slots], dim=0, dtype=self.buf.dtype,
                      out=scratch)
            self.buf[0].copy_(scratch)
            self.used = 1
        torch.amax(values, dim=0, out=self.buf[self.used])
        self.used += 1

    def total(self) -> int:
        return int(self.buf[:self.used].sum()) if self.used else 0


class PhaseTimers:
    """Accumulating wall timers keyed by phase name, nested: ``totals``
    (seconds), ``counts`` (entries), ``self_s`` (seconds less the time of
    the phases entered inside), ``parents`` (the phase open around a
    phase when it was first entered; None at the top) and ``counters``
    (named counts, :meth:`count` and :meth:`gather_max`)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.self_s: Dict[str, float] = defaultdict(float)
        self.parents: Dict[str, Optional[str]] = {}
        self.counters: Dict[str, int] = defaultdict(int)
        # (counter, device) -> its buffer on that device
        self._gathered: Dict[tuple, _DeviceMax] = {}
        # open phases: [name, start, seconds of the phases inside]
        self._stack: List[list] = []

    def phase(self, name: str) -> _Phase:
        """A context manager that times one entry of ``name``."""
        return _Phase(self, name, False)

    def enter(self, name: str) -> None:
        stack = self._stack
        if name not in self.parents:
            self.parents[name] = stack[-1][0] if stack else None
        stack.append([name, time.perf_counter(), 0.0])

    def exit(self) -> None:
        name, start, inside = self._stack.pop()
        seconds = time.perf_counter() - start
        self.totals[name] += seconds
        self.counts[name] += 1
        self.self_s[name] += seconds - inside
        if self._stack:
            self._stack[-1][2] += seconds

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    def gather_max(self, name: str, values: torch.Tensor) -> None:
        """Add ``values``' largest entry to the counter ``name`` without
        reading it: the maximum stays in a buffer on ``values``' device
        until :meth:`summary`."""
        key = (name, values.device)
        if key not in self._gathered:
            self._gathered[key] = _DeviceMax(values)
        self._gathered[key].add(values)

    def summary(self) -> dict:
        """``{"spans": {name: {"count", "total_s", "self_s", "parent"}},
        "counters": {name: n}}``; reads each gathered buffer once."""
        counters = dict(self.counters)
        for (name, _), ring in self._gathered.items():
            if ring.used:
                counters[name] = counters.get(name, 0) + ring.total()
        return {
            "spans": {name: {"count": self.counts[name],
                             "total_s": self.totals[name],
                             "self_s": self.self_s[name],
                             "parent": self.parents.get(name)}
                      for name in self.totals},
            "counters": counters}

    def reset(self) -> None:
        """Forget every phase and counter (a gathered buffer is kept, its
        slots freed)."""
        for d in (self.totals, self.counts, self.self_s, self.parents,
                  self.counters):
            d.clear()
        for ring in self._gathered.values():
            ring.used = 0
        self._stack.clear()


# the training step's spans and counters
SPANS = PhaseTimers()
_OFF = contextlib.nullcontext()


def span(name: str):
    """The step's span ``name``: a profiler range ``gmmvi.<name>`` timed
    into :data:`SPANS`, or nothing while tracing is off."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Phase(SPANS, name, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.count(name, n)


def gather_max(name: str, values: torch.Tensor) -> None:
    """Add the largest entry of the device tensor ``values`` to the counter
    ``name`` while tracing is on, with no host read
    (:meth:`PhaseTimers.gather_max`)."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.gather_max(name, values)


def read(value, site: str):
    """``value.item()`` (or ``value()`` for a callable that reads the card
    on the host): the host waits for the card here.  While tracing is on,
    inside a span ``read.<site>`` and counted under
    ``host_reads.<site>``."""
    if not _autograd_profiler._is_profiler_enabled:
        return value() if callable(value) else value.item()
    with _Phase(SPANS, "read." + site, True):
        out = value() if callable(value) else value.item()
    SPANS.count("host_reads." + site)
    return out


def summary() -> dict:
    """:meth:`PhaseTimers.summary` of :data:`SPANS`."""
    return SPANS.summary()


def reset() -> None:
    """:meth:`PhaseTimers.reset` of :data:`SPANS`."""
    SPANS.reset()
