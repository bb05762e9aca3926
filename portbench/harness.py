"""One run of one cell: build, warm up, measure, trace, judge, report.

:func:`measure` is the whole run after the look for a card, so the tests
drive it on the CPU at a tiny size; ``portbench/run.py`` is the command.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from portbench import check, core, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "gmmvi_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one the port may not load."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def measure(cell_name: str, cfg_spec: dict, mix_spec: dict, seed: int,
            seconds: float, traced: bool, device, limits: Dict[str, float],
            metric_names=(), per_layer=(), started: Optional[float] = None,
            max_iterations: Optional[int] = None) -> dict:
    """The result of one run (the contract's last line, ``checks`` last)."""
    started = time.perf_counter() if started is None else started
    cfg, replay = core.prepare(cfg_spec, mix_spec, seed, device)
    opt, device = replay.opt, replay.device
    sizes = core.built_sizes(opt)
    capture = check.Capture(opt, check.comp_rows(seed, sizes["window_rows"]))
    # untraced, the card's busy time is read over the whole window, one
    # card-only profiler session a block; the profiler is started once in
    # set-up, over the window's first iteration, so that it starts warm
    busy = (trace.DeviceBusy() if device.type == "cuda" and not traced
            else None)
    if busy is not None:
        with busy():
            replay.restore()
            opt.train_iter()
            core.synchronize(device)
        busy.profiles.clear()
    setup_s = time.perf_counter() - started

    _reset_peak(device)
    window = core.run_window(
        replay, seconds,
        before=lambda i: capture.arm() if i == 0 else None,
        after=lambda i: capture.disarm() if i == 0 else None,
        max_iterations=max_iterations, session=busy)
    peak = _peak(device)
    busy_s = None if busy is None else busy.busy_s()
    metrics: Dict[str, dict] = {}
    e2e = {
        "step_device_ms": (None if busy_s is None
                           else busy_s / window.iterations * 1e3, "ms"),
        "peak_mem_mb": (peak / 2 ** 20, "MiB"),
        "setup_s": (setup_s, "s"),
    }
    record = None
    if traced:
        record = traced_block(replay, capture, cfg_spec, window, device)
        for name in per_layer:
            reader = core.plugin("metrics", name)
            value = None if reader is None else reader.read(record)
            if value is not None:
                metrics[name] = {"value": float(value),
                                 "unit": reader.UNIT}
    else:
        for name in metric_names:
            if name in e2e and e2e[name][0] is not None:
                metrics[name] = {"value": e2e[name][0], "unit": e2e[name][1]}
    # the program's live state goes before the reference runs
    opt.state = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.judge(capture.data, cfg, replay.snapshot, device)
    correct, checks = check.verdict(numbers, limits)
    out = {
        "correct": bool(correct),
        "attempted": window.iterations,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, peak, record),
        "workload": cell_name, "seed": int(seed),
        "window": {"seconds": window.seconds,
                   "iterations": window.iterations,
                   "blocks": window.blocks,
                   "device_busy_s": busy_s,
                   "iteration_ms": {
                       q: core.percentile(window.iteration_s, q) * 1e3
                       for q in (5, 25, 50, 75, 95, 100)}},
    }
    if record is not None:
        out["breakdown"] = breakdown(record)
    out["checks"] = checks
    return out


def device_info(device, peak: int, record: Optional[dict]) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    if record is not None:
        info["busy_s"] = record["trace"]["busy_s"]
        info["window_s"] = record["trace"]["window_s"]
    return info


def traced_block(replay: core.Replay, capture: check.Capture, cfg_spec: dict,
                 window: core.Window, device) -> dict:
    """One block under ``torch.profiler``, with the target timed by CUDA
    events and each kernel launch's shapes recorded; the record the
    per-layer metrics read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opt = replay.opt
    target = opt.target_distribution
    timed = trace.TimedTarget(target)
    opt.target_distribution = timed
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        with trace.LaunchRecorder() as recorder, \
                profile(activities=activities) as prof:
            block = core.run_window(replay, math.inf, span=record_function,
                                    max_iterations=replay.block)
        fevals = (int(opt.state.db.num_samples_written)
                  - int(replay.snapshot.db.num_samples_written))
    finally:
        opt.target_distribution = target
    trace.live_counts(recorder.records)
    symbols = trace.kernel_symbols(
        core.ROOT / "gmmvi_tpu_torch" / "csrc")
    reduced = trace.reduce_profile(prof, symbols)
    data = capture.data
    snap = replay.snapshot
    model = snap.model
    return {
        "trace": reduced,
        "profiled_iterations": block.iterations,
        "profiled_seconds": block.seconds,
        "unprofiled": {"iterations": window.iterations,
                       "seconds": window.seconds,
                       "iteration_s": list(window.iteration_s)},
        "launches": recorder.records,
        "target_ms": (timed.device_ms() if device.type == "cuda"
                      else None),
        "fevals_per_step": fevals / block.iterations,
        "state": {
            "num_dimensions": model.num_dimensions,
            "max_components": model.max_components,
            "max_background_dists": opt.selector_cfg.max_background_dists,
            "active": int(model.num_active),
            "window_rows": int(data["window"].valid.shape[0]),
            "window_valid": int(data["window"].num_valid),
            "fresh_valid": int(data["proposal"].valid.sum()),
            "reused_valid": int(data["proposal"].num_reused),
        },
        "config": cfg_spec,
        "peaks": core.load_json(core.BENCH_DIR / "peaks.json"),
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }


def breakdown(record: dict) -> dict:
    tr = record["trace"]
    ops = sorted(tr["device_s_by_name"].items(), key=lambda kv: -kv[1])
    gaps = sorted(tr["idle_s_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n[:120], s] for n, s in gaps[:10]]}
