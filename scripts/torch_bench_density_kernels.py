#!/usr/bin/env python3
"""Kernels B1 (``density_pack``) and B2 (``densities``) on the card: how
each version of their source compiles, whether it holds against the plain
versions, and how fast it runs, in turns with the others.

Builds ``gmmvi_tpu_torch/csrc/density.cu`` ("current") and the
``density.cu`` of each ``--other-csrc [NAME=]DIR``, every ``nvcc``
started together with ``-Xptxas -v``, and prints per build its seconds
and, per kernel instance, the registers, spill bytes and stack frame
ptxas reports.  Every version takes the C interface ``gmmvi_density``
(that of the kernels' first version and of every one since).

Inputs: ``chip_smoke.density_inputs`` (48 slots, 45 live, the main path's
magnitudes) at D = 20 with N = 9,600 (``chip_smoke.py``'s synthetic
inputs) and N = 28,800 (the reuse window), and at D = 100 with N = 28,800
(the run-time instance), the samples in slot order as a path holds them
and, at N = 28,800, scattered; with ``--path-inputs`` also the inputs of
B1's and B2's last launch at each call size on ``chip_smoke.py``'s
SAMTRON and ZAMTRUX paths (130 steps each) and on the gmm20 runner (1,500
iterations).  On each, every build is held to the plain version run in
float64 as ``chip_smoke.density_check`` holds them (atol 5e-4 + rtol
1e-5, NaN and +-inf in the same places, equal bits on two calls), and
the float32 plain version beside them ("plain"): at D = 100 and the main
path's magnitudes every float32 version, the plain one too, misses that
bar on the gradient, so a run with those inputs exits 1.  Each build is
timed as ``chip_smoke.py`` times the kernels (device ms per call),
builds in order and then in reverse, ``--rounds`` times, so that versions
compare on one card.  Beside the times: the bound of
``chip_smoke.density_bound`` (B1's second product counted over the pairs
with a nonzero responsibility only, ``responsible_pairs``) and, for B1,
the mean number of slots with a nonzero responsibility in a block of 64
samples (``listed_slots_per_64``).
Prints one JSON line per build and per input; exits 1 if a build or a
check fails.

Run from the repository root on a machine with the card, e.g. against an
older commit's sources unpacked with ``git archive <commit>
gmmvi_tpu_torch/csrc | tar -x -C build/other``, or a copy of the current
one with one choice undone by ``sed``:
``python3 scripts/torch_bench_density_kernels.py [--path-inputs]
[--other-csrc pr7=build/other/gmmvi_tpu_torch/csrc ...] [--rounds 2]``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAMES = ("density_pack", "densities")
ENTRY = re.compile(r"(density_pack_kernel|densities_kernel)ILi(\d+)E"
                   r"|density_wide_kernelILb(\d)E")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_rows(log: str) -> list:
    """[instance, registers, spill store bytes, spill load bytes, stack
    frame bytes] per entry function in ``-Xptxas -v``'s output."""
    rows = []
    for part in log.split("Compiling entry function '")[1:]:
        m = ENTRY.search(part.split("'")[0])
        if m is None:
            continue
        tag = (f"{'B1' if m.group(1) == 'density_pack_kernel' else 'B2'} "
               f"DK={m.group(2)}" if m.group(1) else
               f"{'B1' if m.group(3) == '1' else 'B2'} run-time D")
        rows.append([tag, *(int(re.search(pat, part).group(1)) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes spill stores",
            r"(\d+) bytes spill loads", r"(\d+) bytes stack frame"))])
    return sorted(rows)


def build(sources: dict, dev) -> dict:
    """Every ``density.cu`` of ``sources`` (name -> directory), all
    ``nvcc`` started together: name -> ({kernel name: launcher}, ptxas
    rows, seconds)."""
    import torch

    from gmmvi_tpu_torch.ops import cuda

    out_dir = os.path.join(cuda.BUILD_DIR, "bench_density")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, csrc in sources.items():
        lib_path = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc,
               "-o", lib_path, os.path.join(csrc, "density.cu")]
        procs[name] = (lib_path, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    stream = cuda.stream_ptr(dev)
    built = {}
    for name, (lib_path, t0, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(lib_path)
        lib.gmmvi_density.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])

        def launcher(grads, lib=lib, name=name):
            def call(means, inv_chols, logw, logdets, x):
                (k, d), n = means.shape, x.shape[0]
                comp = torch.empty((k, n), device=dev)
                model = torch.empty((n,), device=dev)
                g = torch.empty((n, d), device=dev) if grads else None
                cuda.check(lib.gmmvi_density(
                    *[t.data_ptr() for t in (means, inv_chols, logw,
                                             logdets, x, comp, model)],
                    g.data_ptr() if grads else None, k, n, d, stream),
                    f"density.cu of {name}")
                return (comp, model, g) if grads else (comp, model)
            return call

        built[name] = ({"density_pack": launcher(True),
                        "densities": launcher(False)},
                       ptxas_rows(log), seconds)
    return built


def path_inputs(dev) -> list:
    """B1's and B2's last inputs at each call size on chip_smoke.py's
    SAMTRON and ZAMTRUX paths and on the gmm20 runner: ("path K=.. N=..",
    name, args) each."""
    import chip_smoke as cs

    densities: dict = {}
    flagship = ("density_pack", "densities", "tr_search")
    cs.main_path_phase(dev, "SAMTRON", flagship, {}, densities)
    cs.main_path_phase(dev, "ZAMTRUX",
                       flagship + ("background_logpdf", "more_grams"), {},
                       densities, {})
    cs.runner_phase(dev, {}, {}, densities)
    return [(f"{path} K={k} N={n}", name, args)
            for (name, path, k, n), args in sorted(densities.items())]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_density_kernels: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density as dops

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", action="append", default=[],
                    metavar="[NAME=]DIR")
    ap.add_argument("--path-inputs", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda")
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    sources = {"current": str(cuda.CSRC_DIR)}
    for i, spec in enumerate(args.other_csrc):
        name, _, csrc = spec.rpartition("=")
        sources[name or f"other{i}"] = csrc
    built = build(sources, dev)
    for name, (_, rows, seconds) in built.items():
        emit({"build": name, "csrc": sources[name], "seconds": seconds,
              "spilling": [r for r in rows if r[2] or r[3]],
              "with_stack_frame": [r for r in rows if r[4]],
              "instances": rows})

    cases: dict = {}
    for d, n, scattered in ((20, 9600, False), (20, 28800, False),
                            (20, 28800, True), (100, 28800, False),
                            (100, 28800, True)):
        a = cs.density_inputs(dev, d, n, scattered=scattered)
        label = (f"synthetic D={d} K=48 N={n}"
                 + (" scattered" if scattered else ""))
        cases[label] = [(name, a) for name in NAMES]
    if args.path_inputs:
        for label, name, a in path_inputs(dev):
            cases.setdefault(label, []).append((name, a))

    fails = 0
    order = list(built)
    for label, runs in cases.items():
        for name, a in runs:
            plain = getattr(dops, name + "_plain")
            want = plain(*a)
            want64 = plain(*[t.double() for t in a])
            fns = {b: kernels[name] for b, (kernels, _, _) in built.items()}
            checks = {"plain": cs.density_check(want, plain(*a), want64)}
            for b, fn in fns.items():
                got, again = fn(*a), fn(*a)
                torch.cuda.synchronize()
                checks[b] = cs.density_check(got, again, want64)
            fails += not all(checks[b]["ok"] for b in fns)
            times: dict = {b: [] for b in fns}
            for _ in range(args.rounds):
                for b in order + order[::-1]:
                    times[b].append(cs.device_ms(lambda: fns[b](*a)))
            extra = {}
            if name == "density_pack":
                resp = (torch.exp(want[0] + a[2][:, None] - want[1]) > 0) \
                    & (a[2] > -math.inf)[:, None]
                n = resp.shape[1]
                blocks = torch.nn.functional.pad(resp, (0, -n % 64))
                extra["listed_slots_per_64"] = float(
                    blocks.view(resp.shape[0], -1, 64).any(-1).sum(0)
                    .float().mean())
            emit({"inputs": label, "name": name, "checks": checks,
                  **cs.density_bound(name, a, want), **extra, "ms": times})
    print(cs.nvidia_smi(), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
