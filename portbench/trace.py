"""The traced run's record: what the profiler, the benchmark's spans and
its counters saw over one replayed block.

Device busy time is the union of the kernel, copy and set intervals on the
card (one stream: they do not overlap), the idle share ``1 - busy /
window``; device-to-host copies are the ``Memcpy DtoH`` events; the target's
device time comes from CUDA events around each of its calls, through
:class:`TimedTarget`, which keeps the target's two flags so the step takes
the same route.  The hand-written kernels are the ``__global__`` functions
of the program's ``csrc/*.cu``; each launch's shapes are recorded by
wrappers around the program's kernel functions (:class:`LaunchRecorder`),
so a kernel's bound is counted from the shapes it was given.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
# the program's functions that launch a hand-written kernel, by module
KERNEL_FUNCTIONS = {
    "gmmvi_tpu_torch.ops.density": ("density_pack", "densities"),
    "gmmvi_tpu_torch.ops.density_large": ("densities_large",
                                          "mixture_logpdf_large",
                                          "density_grads_large"),
    "gmmvi_tpu_torch.ops.background": ("background_logpdf",),
    "gmmvi_tpu_torch.ops.mixture_logpdf": ("mixture_logpdf",),
    "gmmvi_tpu_torch.ops.stein": ("stein_smom",),
    "gmmvi_tpu_torch.ops.trust_region": ("tr_kl", "tr_search"),
    "gmmvi_tpu_torch.ops.more": ("more_grams",),
}


def kernel_symbols(csrc: Path) -> List[str]:
    """The ``__global__`` function names of the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            head = re.split(r"[{;]", text[m.end():m.end() + 600], 1)[0]
            head = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ", head)
            name = re.search(r"(\w+)\s*\(", head)
            if name:
                names.add(name.group(1))
    return sorted(names)


class TimedTarget:
    """The program's target with CUDA events around each call; the flags
    ``use_log_density_and_grad`` and ``safe_for_jit`` are the target's."""

    def __init__(self, inner):
        self.inner = inner
        self.events: List[Tuple[object, object]] = []
        self.use_log_density_and_grad = inner.use_log_density_and_grad
        self.safe_for_jit = inner.safe_for_jit

    def _timed(self, fn, x):
        with torch.profiler.record_function(SPAN_PREFIX + "target"):
            if not x.is_cuda:
                return fn(x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
        self.events.append((start, end))
        return out

    def log_density(self, x):
        return self._timed(self.inner.log_density, x)

    def log_density_and_grad(self, x):
        return self._timed(self.inner.log_density_and_grad, x)

    def log_density_and_autograd(self, x):
        return self._timed(self.inner.log_density_and_autograd, x)

    def get_num_dimensions(self):
        return self.inner.get_num_dimensions()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def device_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


class LaunchRecorder:
    """Wraps every kernel function of :data:`KERNEL_FUNCTIONS` wherever a
    module of the program holds it, and records each launch: the kernels
    whose ``ops.cuda.LAUNCHES`` counts rose during the call (less those a
    nested wrapped call claimed), the shapes of its tensor arguments and,
    where it has one, its log-weight vector (to count the live
    components after the block)."""

    def __init__(self):
        self.records: List[dict] = []
        self._undo: List[Tuple[object, str, object]] = []

    def __enter__(self):
        from gmmvi_tpu_torch.ops import cuda

        originals = {}
        for mod_name, fns in KERNEL_FUNCTIONS.items():
            mod = sys.modules.get(mod_name)
            for fn in fns:
                if mod is not None and hasattr(mod, fn):
                    originals[id(getattr(mod, fn))] = getattr(mod, fn)
        wrappers = {key: self._wrap(fn, cuda.LAUNCHES)
                    for key, fn in originals.items()}
        for name, mod in list(sys.modules.items()):
            if not name.startswith("gmmvi_tpu_torch") or mod is None:
                continue
            for attr, value in list(vars(mod).items()):
                if callable(value) and id(value) in wrappers:
                    self._undo.append((mod, attr, value))
                    setattr(mod, attr, wrappers[id(value)])
        return self

    def __exit__(self, *exc):
        for mod, attr, value in reversed(self._undo):
            setattr(mod, attr, value)
        self._undo.clear()

    def _wrap(self, fn, launches: Dict[str, int]):
        records = self.records

        def wrapper(*args, **kw):
            before = dict(launches)
            first = len(records)
            out = fn(*args, **kw)
            delta = {k: launches[k] - before[k] for k in launches
                     if launches[k] != before[k]}
            for rec in records[first:]:
                for k, v in rec["kernels"].items():
                    delta[k] = delta.get(k, 0) - v
            delta = {k: v for k, v in delta.items() if v > 0}
            if delta:
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                inp = next((a for a in args if hasattr(a, "_fields")), None)
                if inp is not None:
                    tensors += [t for t in inp if isinstance(t, torch.Tensor)]
                records.append({
                    "function": fn.__name__, "kernels": delta,
                    "shapes": [tuple(t.shape) for t in tensors],
                    "log_weights": _log_weights(fn.__name__, args)})
            return out

        wrapper.__name__ = fn.__name__
        wrapper.__wrapped__ = fn
        return wrapper


def _log_weights(name: str, args) -> Optional[torch.Tensor]:
    """The call's per-component vector whose live entries are the live
    components: the log weights of the density kernels, the active mask of
    the search."""
    if name == "tr_search":
        return args[4]
    if name in ("density_pack", "densities", "densities_large",
                "mixture_logpdf_large", "density_grads_large",
                "background_logpdf", "mixture_logpdf"):
        return args[2]
    return None


def live_counts(records: List[dict]) -> None:
    """Replace each record's log-weight vector by its count of live
    entries (finite log weights, True flags); one read per record."""
    for rec in records:
        lw = rec.pop("log_weights", None)
        if lw is None:
            rec["live"] = None
        elif lw.dtype == torch.bool:
            rec["live"] = int(lw.sum())
        else:
            rec["live"] = int(torch.isfinite(lw).sum())


def _ns(ev, which: str) -> float:
    for attr in (f"{which}_ns", f"{which}_us"):
        fn = getattr(ev, attr, None)
        if fn is not None:
            return float(fn()) * (1.0 if attr.endswith("ns") else 1e3)
    raise AttributeError(which)


def _thread(ev) -> int:
    fn = getattr(ev, "start_thread_id", None)
    return int(fn()) if fn is not None else 0


def _is_work(ev) -> bool:
    """A kernel, copy or set on the card: not a host event, nor a span's
    mark on the device's timeline."""
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    mark = getattr(ev, "is_user_annotation", None)
    if mark is not None and mark():
        return False
    return not ev.name().startswith(SPAN_PREFIX)


def device_busy_s(prof) -> float:
    """The seconds in which the card ran a kernel, a copy or a set during
    one profiler session: the union of their intervals (one stream: they
    do not overlap, and the union holds where they would)."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    spans = sorted((_ns(ev, "start"), _ns(ev, "start") + _ns(ev, "duration"))
                   for ev in results.events() if _is_work(ev))
    busy, cur_e = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, cur_e))
        cur_e = max(cur_e, e)
    return busy * 1e-9


class DeviceBusy:
    """A context-manager factory for :func:`portbench.core.run_window`'s
    ``session``: each session profiles the card alone (no host events);
    :meth:`busy_s`, called after the window, sums their busy seconds, so
    that reading the profiles takes no time inside it."""

    def __init__(self):
        self.profiles: list = []

    def __call__(self):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        self.profiles.append(prof)
        return prof

    def busy_s(self) -> float:
        busy = sum(device_busy_s(prof) for prof in self.profiles)
        self.profiles.clear()
        return busy


def reduce_profile(prof, symbols: List[str]) -> dict:
    """Device busy time, the device's idle gaps named by what the host was
    doing (the innermost benchmark span and host operation open when the
    gap began), device time by kernel name and device-to-host copies."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    device, host = [], []
    for ev in results.events():
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if _is_work(ev):
            device.append((start, start + dur, ev.name()))
        elif not str(ev.device_type()).endswith("CUDA"):
            host.append((start, start + dur, ev.name(), _thread(ev)))
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    if not spans:
        raise RuntimeError("no benchmark span in the profile")
    main = max({h[3] for h in spans},
               key=lambda th: sum(1 for h in spans if h[3] == th))
    host = sorted((s, e, n) for s, e, n, th in host if th == main)
    first = min(s for s, _, _, _ in spans)
    last = max(e for _, e, _, _ in spans)
    device = sorted(d for d in device if d[1] > first and d[0] < last)
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_e = first
    for s, e, _ in device:
        s = max(s, first)
        e = min(e, last)
        if s > cur_e:
            gaps.append((cur_e, s))
        busy += max(0.0, e - max(s, cur_e))
        cur_e = max(cur_e, e)
    if last > cur_e:
        gaps.append((cur_e, last))
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    hand: Dict[str, float] = {}
    for name, seconds in by_name.items():
        kernel = _hand_written(name, symbols)
        if kernel is not None:
            hand[kernel] = hand.get(kernel, 0.0) + seconds
    d2h = sum(1 for _, _, name in device if "DtoH" in name)
    idle: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    gi = 0
    for s, e, name in host + [(float("inf"), float("inf"), "")]:
        while gi < len(gaps) and gaps[gi][0] < s:
            t0 = gaps[gi][0]
            while stack and stack[-1][1] < t0:
                stack.pop()
            label = _label(stack)
            idle[label] = idle.get(label, 0.0) \
                + (gaps[gi][1] - gaps[gi][0]) * 1e-9
            gi += 1
        while stack and stack[-1][1] < s:
            stack.pop()
        stack.append((s, e, name))
    return {"busy_s": busy * 1e-9, "window_s": (last - first) * 1e-9,
            "device_ops": len(device), "d2h_copies": d2h,
            "device_s_by_name": by_name, "hand_written_s": hand,
            "idle_s_by_host": idle}


def _hand_written(name: str, symbols: List[str]) -> Optional[str]:
    """The ``__global__`` function a device event's name is an instance
    of (``(anonymous namespace)::large_comp_kernel(float const*, ...)``,
    ``void background_kernel<10>(...)``), or None."""
    m = re.match(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)\s*[<(]",
                 name)
    if m and m.group(1) in symbols:
        return m.group(1)
    return None


def _label(stack) -> str:
    """``<benchmark span>:<innermost host operation>`` for an open stack of
    host events."""
    span = next((n[len(SPAN_PREFIX):] for _, _, n in reversed(stack)
                 if n.startswith(SPAN_PREFIX)), "outside")
    op = stack[-1][2] if stack else "idle host"
    if op.startswith(SPAN_PREFIX):
        op = "python"
    return f"{span}:{op}"
