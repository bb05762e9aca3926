#!/usr/bin/env python3
"""Kernels B5, B6 and B7 on the card: checked at edge shapes, timed at the
stm300 shapes, B6 optionally beside another version of its source.

Checks the current B5 (``densities_large`` and its background mode
``mixture_logpdf_large``), B6 (``density_grads_large``) and B7
(``stein_smom``) against their plain versions at D on either side of their
tiles' edges (B5 at rtol 2e-4 / atol 2e-3, B6 at rtol / atol 2e-3 with
equal bits on two calls, B7 within 1e-5 of each component's largest
entry, exact zeros for a component without weight), then times them
(device ms, as ``chip_smoke.py`` does) on ``chip_smoke.py``'s synthetic
stm300 inputs: B5 at the path's call sizes (window, reuse window, the
background over 160 ring rows half masked at both, B9's two), B6 with
dense responsibilities (every pair live) and, with ``--path-inputs``, on
the inputs of its last launch in a run of SAMTRON on stm300
(``--path-iters`` steps through ``GMMVI.train_iter``), B7 with dense
weights and with the weights below 1e-3 zeroed (most 32-sample slabs then
dead, as on the path), and the einsum that computes B7's function in one
call.  With ``--other-csrc DIR`` it also builds ``DIR``'s
``density_large.cu`` (with the current C interface or the fp32 SIMT
B6's of the repository's history, which has no workspace argument; e.g.
a variant of the current source) and times its B6 on the same
inputs in the same call, in turns with the current one (other, current,
current, other), so that two versions compare on one card.  Prints one
JSON line per check and per round of times; exits 1 if a check fails.

Run from the repository root on a machine with the card, e.g. against an
older commit's sources unpacked with ``git archive <commit>
gmmvi_tpu_torch/csrc | tar -x -C build/other``:
``python3 scripts/torch_bench_large_kernels.py [--path-inputs]
[--other-csrc build/other/gmmvi_tpu_torch/csrc]``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EDGE_DIMS = (1, 20, 65, 72, 136, 300, 301, 512)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def other_grads(csrc: str, dev):
    """B6 as built from ``csrc``'s ``density_large.cu``, with either C
    interface: the fp32 SIMT kernel's (no workspace) or the current one's
    (a workspace, sized by ``gmmvi_density_grads_large_workspace``)."""
    import torch

    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops.density_large import precisions

    out = os.path.join(cuda.BUILD_DIR, "other_density_large.so")
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", out,
                    os.path.join(csrc, "density_large.cu")], check=True)
    lib = ctypes.CDLL(out)
    ptr, num = ctypes.c_void_p, ctypes.c_int
    with_ws = hasattr(lib, "gmmvi_density_grads_large_workspace")
    lib.gmmvi_density_grads_large.argtypes = (
        [ptr] * (7 + with_ws) + [num] * 3 + [ptr])
    if with_ws:
        lib.gmmvi_density_grads_large_workspace.argtypes = [num] * 3
        lib.gmmvi_density_grads_large_workspace.restype = ctypes.c_size_t
    stream = cuda.stream_ptr(dev)

    def grads(means, inv_chols, logw, comp, model, x):
        (k, d), n = means.shape, x.shape[0]
        lam = precisions(inv_chols)
        out = torch.empty((n, d), device=dev)
        ws = ([cuda.workspace(lib, "gmmvi_density_grads_large", dev, k, n,
                              d)] if with_ws else [])
        cuda.check(lib.gmmvi_density_grads_large(
            *[t.data_ptr() for t in (lam, means, logw, comp, model, x, out,
                                     *ws)],
            k, n, d, stream), "other density_grads_large")
        return out

    return grads


def path_grads_inputs(dev, iters: int):
    """B6's arguments at its last launch in ``iters`` steps of SAMTRON on
    stm300 (``get_default_config("SAMTRON", "stm300")``)."""
    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.ops import density_large
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_config("SAMTRON", "stm300")
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    captured = {}
    fn = density_large.density_grads_large

    def call(*a):
        captured["args"] = a
        return fn(*a)

    density_large.density_grads_large = call
    try:
        gmmvi.train_iters(iters)
    finally:
        density_large.density_grads_large = fn
    return list(captured["args"])


def check_grads(args) -> dict:
    import torch

    from gmmvi_tpu_torch.ops import density_large as dl

    got, again = dl.density_grads_large(*args), dl.density_grads_large(*args)
    want = dl.density_grads_large_plain(*args)
    torch.cuda.synchronize()
    worst = float(((got - want).abs() / (2e-3 + 2e-3 * want.abs())).max())
    same = bool(torch.equal(got, again))
    return dict(worst_over_bar=worst, same_bits=same,
                ok=worst <= 1.0 and same)


def check_stein(w, g, xc) -> dict:
    import torch

    from gmmvi_tpu_torch.ops import stein

    got, want = stein.stein_smom(w, g, xc), stein.stein_smom_plain(w, g, xc)
    torch.cuda.synchronize()
    k = w.shape[0]
    scale = want.abs().reshape(k, -1).amax(1)
    err = (got - want).abs().reshape(k, -1).amax(1)
    live = scale > 0
    rel = float((err[live] / scale[live]).max()) if bool(live.any()) else 0.
    zeros = bool((got[~live] == 0).all())
    return dict(rel_to_scale=rel, dead_exact_zero=zeros,
                ok=rel <= 1e-5 and zeros)


def check_density(args, skip: bool) -> dict:
    """Worst |error| / bar over the finite entries, -inf in the same
    places; the factors' upper triangles hold NaN for the kernel (never
    read), not for the plain version."""
    import torch

    from gmmvi_tpu_torch.ops import density_large as dl

    fn = dl.mixture_logpdf_large if skip else dl.densities_large
    plain = dl.mixture_logpdf_large_plain if skip else dl.densities_large_plain
    nan_args = list(args)
    nan_args[1] = (args[1] + torch.triu(torch.full_like(args[1], math.nan),
                                        1)).contiguous()
    got, want = fn(*nan_args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for gv, wv in zip(got, want):
        fin = torch.isfinite(wv)
        e = (gv[fin] - wv[fin]).abs() / (2e-3 + 2e-4 * wv[fin].abs())
        worst = max(worst, float(e.max()) if e.numel() else 0.0)
        ok = ok and torch.equal(torch.isneginf(gv), torch.isneginf(wv))
    return dict(worst_over_bar=worst, ok=ok and worst <= 1.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_large_kernels: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gmmvi_tpu_torch.ops import density_large as dl
    from gmmvi_tpu_torch.ops import stein

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default=None)
    ap.add_argument("--path-inputs", action="store_true")
    ap.add_argument("--path-iters", type=int, default=130)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda")
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = 0
    for d in EDGE_DIMS[2:]:
        k, n = 5, 1001
        w = torch.softmax(torch.randn(k, n, generator=gen, device=dev) * 3, 0)
        w[1] = 0.0
        g = torch.randn(n, d, generator=gen, device=dev) * 10
        xc = torch.randn(n, d, generator=gen, device=dev) * 3
        out = check_stein(w, g, xc)
        fails += not out["ok"]
        emit({"check": "B7", "k": k, "n": n, "d": d, **out})
    for d in EDGE_DIMS:
        k, n = 5, 1001
        means = torch.randn(k, d, generator=gen, device=dev) * 3
        a = torch.randn(k, d, d, generator=gen, device=dev) * 0.1
        chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d, device=dev))
        inv = torch.linalg.solve_triangular(
            chols, torch.eye(d, device=dev).expand(k, d, d), upper=False)
        logw = torch.log_softmax(torch.randn(k, generator=gen, device=dev), 0)
        logw[2] = -math.inf
        logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
        x = torch.randn(n, d, generator=gen, device=dev) * 2 + means[0]
        dargs = [t.contiguous() for t in (means, inv, logw, logdets, x)]
        for skip in (False, True):
            out = check_density(dargs, skip)
            fails += not out["ok"]
            emit({"check": "B5", "k": k, "n": n, "d": d,
                  "background_mode": skip, **out})
        comp, model = dl.densities_large_plain(*dargs)
        out = check_grads([*dargs[:3], comp, model, x])
        fails += not out["ok"]
        emit({"check": "B6", "k": k, "n": n, "d": d, **out})

    largs = cs.large_inputs(dev)
    sargs = cs.stein_inputs(dev, largs)
    sparse = [sargs[0] * (sargs[0] > 1e-3), *sargs[1:]]
    means, inv, logw, logdets, x = largs
    u = 160
    rows = torch.randint(0, len(means), (u,), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    bg = [means[rows].contiguous(), inv[rows].contiguous(),
          torch.where(torch.arange(u, device=dev) % 2 == 0,
                      -math.log(u // 2), -math.inf).contiguous(),
          logdets[rows].contiguous()]
    lw24, lw10 = logw.clone(), logw.clone()
    lw24[24:] = -math.inf
    lw10[10:] = -math.inf
    cases = {
        "window": (largs, False),
        "reuse": ([means, inv, logw, logdets, x[:8000].contiguous()], False),
        "background_reuse": (bg + [x[:8000].contiguous()], True),
        "background_window": (bg + [x], True),
        "b9_candidates": ([means, inv, lw24, logdets,
                           torch.cat([x, x[:4384]]).contiguous()], True),
        "b9_evaluation": ([means, inv, lw10, logdets,
                           x[:2000].contiguous()], True)}
    for name, (a, skip) in cases.items():
        out = check_density(a, skip)
        fails += not out["ok"]
        emit({"check": "B5", "case": name, **out})
    for name, a in (("dense", sargs), ("sparse", sparse)):
        out = check_stein(*a)
        fails += not out["ok"]
        emit({"check": "B7", "case": name, **out})
    comp, model = dl.densities_large_plain(*largs)
    grad_cases = {"dense": [*largs[:3], comp, model, x]}
    if args.path_inputs:
        grad_cases["path"] = path_grads_inputs(dev, args.path_iters)
    for name, a in grad_cases.items():
        out = check_grads(a)
        fails += not out["ok"]
        resp = torch.exp(a[3] + a[2][:, None] - a[4][None, :])
        emit({"check": "B6", "case": name,
              "live_pairs": int((resp > 0).sum()), **out})

    other = other_grads(args.other_csrc, dev) if args.other_csrc else None
    for rnd in range(args.rounds):
        times = {}
        for name, (a, skip) in cases.items():
            fn = (lambda a=a, skip=skip: (dl.mixture_logpdf_large if skip
                                          else dl.densities_large)(*a))
            times[f"B5 {name}"] = [cs.device_ms(fn)]
        # in turns: other, current, current, other
        order = ("other", "current", "current", "other") if other else \
            ("current",)
        for which in order:
            for name, a in grad_cases.items():
                fn = ((lambda a=a: other(*a)) if which == "other" else
                      (lambda a=a: dl.density_grads_large(*a)))
                times.setdefault(f"B6 {name} {which}", []).append(
                    cs.device_ms(fn))
        for name, a in (("dense", sargs), ("sparse", sparse)):
            times[f"B7 {name}"] = [cs.device_ms(
                lambda a=a: stein.stein_smom(*a))]
        times["B7 dense einsum"] = [cs.device_ms(
            lambda: torch.einsum("kn,nd,ne->kde", *sargs), reps=11, batch=5)]
        emit({"round": rnd, "device_ms": times})
    emit({"nvidia_smi": cs.nvidia_smi(), "fails": fails})
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
