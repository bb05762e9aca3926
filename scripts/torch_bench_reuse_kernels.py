#!/usr/bin/env python3
"""Kernels B4, B8 and B9 on the card: checked at edge shapes, timed at the
reuse path's shapes, optionally beside another version of their sources.

Checks B8 (``more_grams``) at D = 1, 20 and 45 against its plain version
(within 2e-5 of each component's largest entry, exact zeros for a
component without weight, equal bits on two calls), and B4
(``background_logpdf``, U = 2,048 rows, half of them masked) and B9
(``mixture_logpdf``) at D = 1, 20, 60 and 128 (rtol 1e-4 with atol 2e-4
and 1e-4, -inf in the same places, equal bits).  Then times them (device
ms, as ``chip_smoke.py`` does) on ``chip_smoke.py``'s synthetic inputs: B8
on the window in runs of 200 per component and on the same window
shuffled (scattered zero weights, as on the path), B4 on the reuse path's
background, B9 at the runner's two call sizes.  With ``--path-inputs`` it
first runs ``chip_smoke.py``'s ZAMTRUX path (130 steps) and times B4 and
B8 on the inputs of their last launches there too.  With
``--path-spread`` it then runs that path and the gmm20 runner (1,500
iterations) with B4, B8 and B9 as the current kernels, as their plain
versions on the card and (with ``--other-csrc``) as the other sources'
kernels, and prints the fresh-sample counts (fevals) of each: how far
arithmetics that agree to float32 rounding part on the reuse paths, whose
ESS floors turn last bits into different trajectories.  With ``--ablate``
it also times B8 built from the current source without its tensor-core
products, without its whitening and without either (wrong results, read
for their times only: where the main kernel's time goes).  With
``--other-csrc
DIR`` it also builds ``DIR``'s ``more.cu`` and ``background.cu`` (the C
interface of the kernels of the repository's history before the
compacted B8: no workspace argument) and times them in turns with the
current ones (other, current, current, other), and builds a copy of that
``more.cu`` patched to walk a per-component list of the nonzero-weight
samples (built outside the timing with ``torch.argsort``), which measures
what compaction alone gives the SIMT tiles.  Prints one JSON line per
check and per round of times; exits 1 if a check fails.

Run from the repository root on a machine with the card, e.g. against an
older commit's sources unpacked with ``git archive <commit>
gmmvi_tpu_torch/csrc | tar -x -C build/other``:
``python3 scripts/torch_bench_reuse_kernels.py [--path-inputs]
[--path-spread] [--ablate] [--other-csrc
build/other/gmmvi_tpu_torch/csrc]``.
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

# the SIMT B8 of the repository's history, made to walk a list of the
# nonzero-weight samples per component: (old text, new text) pairs
COMPACT_PATCH = (
    ("float* __restrict__ gram, float* __restrict__ rhs, int N,",
     "float* __restrict__ gram, float* __restrict__ rhs,\n"
     "                 const int* __restrict__ cidx,\n"
     "                 const int* __restrict__ ccnt, int N,"),
    ("  for (int n0 = 0; n0 < N; n0 += NC) {\n"
     "    const int nc = min(NC, N - n0);\n"
     "    const float wt = tid < nc ? wk[n0 + tid] : 0.f;",
     "  const int* ik = cidx + (size_t)k * N;\n"
     "  const int cn = ccnt[k];\n"
     "  for (int n0 = 0; n0 < cn; n0 += NC) {\n"
     "    const int nc = min(NC, cn - n0);\n"
     "    const float wt = tid < nc ? wk[ik[n0 + tid]] : 0.f;"),
    ("idx < nc * D ? xs[(size_t)n0 * D + idx] : 0.f;",
     "idx < nc * D ? xs[(size_t)ik[n0 + idx / D] * D + idx % D] : 0.f;"),
    ("zs[D + 1] = tid < nc ? y[n0 + tid] : 0.f;",
     "zs[D + 1] = tid < nc ? y[ik[n0 + tid]] : 0.f;"),
)
COMPACT_ENTRY = """
extern "C" int gmmvi_more_grams_compacted(
    const float* inv_chols, const float* means, const float* w,
    const float* y, const float* x, float* gram, float* rhs, const int* cidx,
    const int* ccnt, int K, int N, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = D * (D + 1) / 2 + D + 1;
  const int ntiles = (F + 1 + TF - 1) / TF;
  const dim3 grid(ntiles * (ntiles + 1) / 2, K), block(NT);
  more_gram_kernel<<<grid, block, 0, st>>>(inv_chols, means, w, y, x, gram,
                                           rhs, cidx, ccnt, N, D, F, ntiles);
  return (int)cudaGetLastError();
}
"""


# parts of the current B8's main kernel removed, to see where its time goes
# (the results are wrong; only their times are read)
ABLATE_PRODUCTS = ("tf32x3::slab_product(acc, av, sm.b[wg][0], "
                   "sm.b[wg][1]);",
                   "for (int i = 0; i < 32; ++i) "
                   "acc[i] = av[i & 3][(i >> 2) & 3];")
ABLATE_WHITENING = ("for (int j = 0; j <= i; ++j) "
                    "zi = fmaf(row[j], sm.d[j][s], zi);",
                    "zi = sm.d[i][s] + row[0];")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(source_text: str, name: str, include: str) -> ctypes.CDLL:
    from gmmvi_tpu_torch.ops import cuda

    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda.BUILD_DIR, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source_text)
    out = os.path.join(cuda.BUILD_DIR, f"{name}.so")
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", include, "-o", out,
                    src], check=True)
    return ctypes.CDLL(out)


def other_kernels(csrc: str, dev):
    """(more, more_compacted, background, mixture) launching the kernels
    built from ``csrc`` (and the compacted copy of its ``more.cu``)."""
    import torch

    from gmmvi_tpu_torch.ops import cuda

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    more_text = read("more.cu")
    compact_text = more_text
    for old, new in COMPACT_PATCH:
        if old not in compact_text:
            raise RuntimeError(f"{csrc}/more.cu: patch anchor not found: "
                               f"{old!r}")
        compact_text = compact_text.replace(old, new)
    cut = compact_text.index("// gram [K, F, F] and rhs [K, F]")
    compact_text = compact_text[:cut] + COMPACT_ENTRY
    libs = {"more": build(more_text, "other_more", csrc),
            "compact": build(compact_text, "other_more_compacted", csrc),
            "background": build(read("background.cu"), "other_background",
                                csrc)}
    ptr, num = ctypes.c_void_p, ctypes.c_int
    libs["more"].gmmvi_more_grams.argtypes = [ptr] * 7 + [num] * 3 + [ptr]
    libs["compact"].gmmvi_more_grams_compacted.argtypes = \
        [ptr] * 9 + [num] * 3 + [ptr]
    for fn in ("gmmvi_background", "gmmvi_mixture_logpdf"):
        getattr(libs["background"], fn).argtypes = \
            [ptr] * 6 + [num] * 3 + [ptr]
    stream = cuda.stream_ptr(dev)

    def grams(inv, means, w, y, x, lists=None):
        (k, n), d = w.shape, means.shape[1]
        f = 1 + d + d * (d + 1) // 2
        gram = torch.empty((k, f, f), device=dev)
        rhs = torch.empty((k, f), device=dev)
        ptrs = [t.data_ptr() for t in (inv, means, w, y, x, gram, rhs)]
        if lists is None:
            rc = libs["more"].gmmvi_more_grams(*ptrs, k, n, d, stream)
        else:
            rc = libs["compact"].gmmvi_more_grams_compacted(
                *ptrs, lists[0].data_ptr(), lists[1].data_ptr(), k, n, d,
                stream)
        cuda.check(rc, "other more_grams")
        return gram, rhs

    def density(fn):
        def call(means, inv, logw, logdets, x):
            (u, d), n = means.shape, x.shape[0]
            out = torch.empty((n,), device=dev)
            cuda.check(getattr(libs["background"], fn)(
                *[t.data_ptr() for t in (means, inv, logw, logdets, x, out)],
                u, n, d, stream), "other " + fn)
            return out
        return call

    return (grams, density("gmmvi_background"),
            density("gmmvi_mixture_logpdf"))


def ablated_kernels(dev) -> dict:
    """B8 built from the current ``more.cu`` without its tensor-core
    products, without its whitening, and without either."""
    import torch

    from gmmvi_tpu_torch.ops import cuda

    with open(cuda.CSRC_DIR / "more.cu") as f:
        text = f.read()
    variants = {}
    for name, cuts in (("no products", (ABLATE_PRODUCTS,)),
                       ("no whitening", (ABLATE_WHITENING,)),
                       ("neither", (ABLATE_PRODUCTS, ABLATE_WHITENING))):
        t = text
        for old, new in cuts:
            if old not in t:
                raise RuntimeError(f"more.cu: ablation anchor not found: "
                                   f"{old!r}")
            t = t.replace(old, new)
        lib = build(t, "ablated_more_" + name.replace(" ", "_"),
                    str(cuda.CSRC_DIR))
        lib.gmmvi_more_grams_workspace.restype = ctypes.c_size_t
        lib.gmmvi_more_grams_workspace.argtypes = [ctypes.c_int] * 3
        lib.gmmvi_more_grams.argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

        def grams(inv, means, w, y, x, lib=lib):
            (k, n), d = w.shape, means.shape[1]
            f = 1 + d + d * (d + 1) // 2
            gram = torch.empty((k, f, f), device=dev)
            rhs = torch.empty((k, f), device=dev)
            ws = torch.empty((lib.gmmvi_more_grams_workspace(k, n, d),),
                             dtype=torch.uint8, device=dev)
            cuda.check(lib.gmmvi_more_grams(
                *[t.data_ptr() for t in (inv, means, w, y, x, gram, rhs, ws)],
                k, n, d, cuda.stream_ptr(dev)), "ablated more_grams")
            return gram, rhs
        variants[name] = grams
    return variants


def live_lists(w):
    """Per component, the indices of the nonzero weights first, in
    increasing order, and their count."""
    import torch

    order = torch.argsort((w == 0).to(torch.int8), dim=1, stable=True)
    return (order.to(torch.int32).contiguous(),
            (w != 0).sum(1).to(torch.int32).contiguous())


def rel_to_scale(got, want):
    k = want.shape[0]
    scale = want.abs().reshape(k, -1).amax(1)
    err = (got - want).abs().reshape(k, -1).amax(1)
    live = scale > 0
    return float((err[live] / scale[live]).max()) if bool(live.any()) else 0.


def check_more(args, other=None) -> dict:
    import torch

    from gmmvi_tpu_torch.ops import more

    got = more.more_grams(*args)
    again = more.more_grams(*args)
    want = more.more_grams_plain(*args)
    torch.cuda.synchronize()
    dead = (args[2] == 0).all(1)
    out = dict(gram_rel=rel_to_scale(got[0], want[0]),
               rhs_rel=rel_to_scale(got[1], want[1]),
               same_bits=bool(torch.equal(got[0], again[0])
                              and torch.equal(got[1], again[1])),
               dead_exact_zero=bool((got[0][dead] == 0).all()
                                    and (got[1][dead] == 0).all()))
    if other is not None:  # the compacted SIMT copy, for its own check
        comp = other(*args, lists=live_lists(args[2]))
        out["compacted_simt_gram_rel"] = rel_to_scale(comp[0], want[0])
    out["ok"] = (out["gram_rel"] <= 2e-5 and out["rhs_rel"] <= 2e-5
                 and out["same_bits"] and out["dead_exact_zero"])
    return out


def check_density(fn, plain, args, atol) -> dict:
    import torch

    got, again, want = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    bar = atol + 1e-4 * want[fin].abs()
    worst = float(((got[fin] - want[fin]).abs() / bar).max()) \
        if bool(fin.any()) else 0.0
    same = bool(torch.equal(got, again))
    places = bool(torch.equal(torch.isneginf(got), torch.isneginf(want)))
    return dict(worst_over_bar=worst, same_bits=same, neginf_places=places,
                ok=worst <= 1.0 and same and places)


def edge_more_inputs(k, d, n, gen, dev):
    import torch

    means = torch.randn(k, d, generator=gen, device=dev) * 3
    a = torch.randn(k, d, d, generator=gen, device=dev) * 0.3
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d, device=dev))
    inv = torch.linalg.solve_triangular(
        chols, torch.eye(d, device=dev).expand(k, d, d), upper=False)
    comp = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = means[comp] + torch.einsum(
        "nij,nj->ni", chols[comp], torch.randn(n, d, generator=gen,
                                               device=dev))
    logit = -0.5 * torch.einsum(
        "kij,knj->kni", inv, x[None] - means[:, None]).square().sum(-1)
    w = torch.softmax(logit * 4, dim=1)   # scattered underflows to zero
    w[1] = 0.0
    y = torch.randn(n, generator=gen, device=dev) * 10
    return [t.contiguous() for t in (inv, means, w, y, x)]


def edge_density_inputs(u, d, n, gen, dev):
    import torch

    means = torch.randn(u, d, generator=gen, device=dev) * 3
    a = torch.randn(u, d, d, generator=gen, device=dev) * 0.3
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d, device=dev))
    inv = torch.linalg.solve_triangular(
        chols, torch.eye(d, device=dev).expand(u, d, d), upper=False)
    logw = torch.log_softmax(torch.randn(u, generator=gen, device=dev), 0)
    logw[torch.arange(u, device=dev) % 2 == 1] = -math.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    x = torch.randn(n, d, generator=gen, device=dev) * 3
    return [t.contiguous() for t in (means, inv, logw, logdets, x)]


def path_inputs(dev) -> dict:
    """The arguments of B4's last launch over the total window and of B8's
    last launch on chip_smoke.py's ZAMTRUX path."""
    import chip_smoke as cs

    captured: dict = {}
    cs.main_path_phase(dev, "ZAMTRUX",
                       ("density_pack", "densities", "tr_search",
                        "background_logpdf", "more_grams"), {}, {}, captured)
    return {"more": captured["more_grams"],
            "background": captured[("background_logpdf", cs.N_WINDOW)]}


def path_fevals(dev, variant: str, other) -> dict:
    """Fresh samples (fevals) of 130 ZAMTRUX steps and of the gmm20 runner's
    1,500 iterations with B4, B8 and B9 as ``variant`` says: "current",
    "plain" (their plain versions on the card) or "other" (``other``'s
    kernels); everything else as in ``chip_smoke.py``."""
    import chip_smoke as cs
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import background, mixture_logpdf, more
    from gmmvi_tpu_torch.optimization import ng_estimators, sample_window
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    fns = {"current": (background.background_logpdf, more.more_grams,
                       mixture_logpdf.mixture_logpdf),
           "plain": (background.background_logpdf_plain,
                     more.more_grams_plain,
                     mixture_logpdf.mixture_logpdf_plain)}
    if other is not None:
        fns["other"] = (other[1], other[0], other[2])
    saved = (sample_window.background_logpdf, ng_estimators.more_grams,
             mixture_logpdf.mixture_logpdf)
    (sample_window.background_logpdf, ng_estimators.more_grams,
     mixture_logpdf.mixture_logpdf) = fns[variant]
    try:
        target = make_target(num_dimensions=cs.D, harder_setting=False,
                             seed=0, device=dev)
        cfg = cs.flagship_config(codename="ZAMTRUX")
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=dev)
        gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
        for _ in range(cs.MAIN_ITERS):
            gmmvi.train_iter()
        zamtrux = int(gmmvi.state.db.num_samples_written)
        runner = cs.build_runner(dev, cs.runner_config())
        for n in range(cs.RUNNER_ITERS):
            runner.iterate_and_log(n)
        state = runner.gmmvi.state
        return {"zamtrux_fevals": zamtrux,
                "runner_fevals": int(state.db.num_samples_written),
                "runner_components": int(state.model.num_active)}
    finally:
        (sample_window.background_logpdf, ng_estimators.more_grams,
         mixture_logpdf.mixture_logpdf) = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_reuse_kernels: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gmmvi_tpu_torch.ops import background, mixture_logpdf, more

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default=None)
    ap.add_argument("--path-inputs", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--path-spread", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    other = other_kernels(args.other_csrc, dev) if args.other_csrc else None
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = 0
    for d in (1, 20, 45):
        out = check_more(edge_more_inputs(5, d, 1001, gen, dev),
                         other[0] if other else None)
        fails += not out["ok"]
        emit({"check": "B8", "k": 5, "n": 1001, "d": d, **out})
    for d in (1, 20, 60, 128):
        dargs = edge_density_inputs(2048, d, 1001, gen, dev)
        for name, fn, plain, atol in (
                ("B4", background.background_logpdf,
                 background.background_logpdf_plain, 2e-4),
                ("B9", mixture_logpdf.mixture_logpdf,
                 mixture_logpdf.mixture_logpdf_plain, 1e-4)):
            out = check_density(fn, plain, dargs, atol)
            fails += not out["ok"]
            emit({"check": name, "u": 2048, "n": 1001, "d": d, **out})

    cases = {"B8 runs": ("more", cs.more_inputs(dev)),
             "B8 scattered": ("more", cs.more_inputs(dev, scattered=True)),
             "B4 synthetic": ("background", cs.background_inputs(dev)),
             "B9 N=2000": ("mixture", cs.mixture_inputs(dev, cs.N_EVAL)),
             "B9 N=16384": ("mixture",
                            cs.mixture_inputs(dev, cs.N_CANDIDATES))}
    if args.path_inputs:
        got = path_inputs(dev)
        cases["B8 path"] = ("more", got["more"])
        cases["B4 path"] = ("background", got["background"])
    for name, (kind, a) in cases.items():
        if kind == "more":
            out = check_more(a, other[0] if other else None)
            out["weighted_pairs"] = int((a[2] != 0).sum())
        else:
            out = check_density(
                background.background_logpdf if kind == "background"
                else mixture_logpdf.mixture_logpdf,
                background.background_logpdf_plain if kind == "background"
                else mixture_logpdf.mixture_logpdf_plain, a,
                2e-4 if kind == "background" else 1e-4)
        fails += not out["ok"]
        emit({"check": name, **out})

    current = {"more": more.more_grams,
               "background": background.background_logpdf,
               "mixture": mixture_logpdf.mixture_logpdf}
    if other:
        olds = {"more": other[0], "background": other[1],
                "mixture": other[2]}
    lists = {name: live_lists(a[2]) for name, (kind, a) in cases.items()
             if kind == "more"}
    ablated = ablated_kernels(dev) if args.ablate else {}
    for rnd in range(args.rounds):
        times = {}
        order = ("other", "current", "current", "other") if other else \
            ("current",)
        for which in order:
            for name, (kind, a) in cases.items():
                fn = (current if which == "current" else olds)[kind]
                times.setdefault(f"{name} {which}", []).append(
                    cs.device_ms(lambda fn=fn, a=a: fn(*a)))
                if kind == "more" and which == "other":
                    times.setdefault(f"{name} compacted_simt", []).append(
                        cs.device_ms(lambda a=a, li=lists[name]:
                                     olds["more"](*a, lists=li)))
                if kind == "more" and which == "current":
                    for cut, fn in ablated.items():
                        times.setdefault(f"{name} {cut}", []).append(
                            cs.device_ms(lambda fn=fn, a=a: fn(*a)))
        emit({"round": rnd, "device_ms": times})
    if args.path_spread:
        for variant in ("current", "plain") + (("other",) if other else ()):
            emit({"path_spread": variant, **path_fevals(dev, variant, other)})
    emit({"nvidia_smi": cs.nvidia_smi(), "fails": fails})
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
