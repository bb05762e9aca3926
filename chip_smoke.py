#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gmmvi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one JSON line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the main paths, compiled from
   ``gmmvi_tpu_torch/csrc`` with ``nvcc`` (in parallel), with the seconds;
3. kernels: each kernel at its main path's shapes against its plain
   PyTorch version on the card (max error against the stated tolerance),
   timed with CUDA events: ``ms`` and ``plain_ms`` are device time per call
   (median of 21 batches of 20 back-to-back calls queued behind a spin
   kernel, so the host's time is hidden), ``call_ms`` one call on an idle
   card with the host's part included (median of 50); with its least
   possible time on an H100 (``bound_ms``);
4. main paths, each through ``GMMVI.build_from_config`` and ``train_iter``
   for 130 iterations, with the launch counters set to 0 just before it and
   read just after, and checks on what comes out: SAMTRON on the 20-D
   Student-T mixture (45 components padded to 48, 200 samples per
   component, full covariances, no sample reuse; kernels B1-B3), then
   ZAMTRUX (VIPS: MORE, sample reuse at 2.0 x 200 per component, direct
   weight update; kernels B1-B4 and B8) at the same widths, then SAMTRON on
   the 300-D Student-T mixture, ``get_default_config("SAMTRON",
   "stm300")`` (20 components padded to 40, 100 fresh and 200 reused
   samples per component; kernels B5-B7 and the whitened trust-region
   update; 61 iterations instead of 130 if its step exceeds 150 ms; held to
   an improving ELBO, estimated as the JAX package's runner does);
5. every kernel once more, on the inputs of its last launch in the
   ZAMTRUX run (B2 at both of its window sizes; the data decides how much
   work B4 and B8 do) and in the stm300 run (B5 at each of its four call
   sizes), against its plain version at the bar of phase 3, timed as there.

Then one ``{"kernels": [...]}`` line (each kernel's ``launches`` from the
path that runs it: SAMTRON for B1-B3, ZAMTRUX for B4 and B8, stm300 for
B5-B7), the card's name and power limit as ``nvidia-smi`` gives them, and
last ``{"ok": true, "device": {...}}``.  Nothing is caught: any failure
exits non-zero before that line.  Without a CUDA card it exits 1.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_ITERS = 130
D, KMAX, K0, N_DES = 20, 48, 45, 200
REUSED = 2 * N_DES                       # ratio_reused_samples_to_desired 2.0
N_WINDOW = KMAX * (REUSED + N_DES)       # 28,800: the total window
U_BACKGROUND = min(4 * KMAX, 2048)       # 192: max_background_dists
# stm300 (SAMTRON's defaults): Kmax 40 = max(2 x 20, 20 + 16) rounded to 8,
# 100 fresh and 200 reused samples per component
D_LARGE, KMAX_LARGE, N_DES_LARGE = 300, 40, 100
N_REUSE_LARGE = KMAX_LARGE * 2 * N_DES_LARGE            # 8,000
N_LARGE = N_REUSE_LARGE + KMAX_LARGE * N_DES_LARGE      # 12,000
U_LARGE = min(4 * KMAX_LARGE, 2048)                     # 160
LARGE_STEP_MS_CAP, LARGE_ITERS_CUT = 150.0, 61


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median time of one call of ``fn`` on an idle card, by CUDA events:
    the host's work in the call (checks, allocation, launch) included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 21, batch: int = 20) -> float:
    """Median over ``reps`` batches of the device time per call of ``fn``.

    Each batch queues ``batch`` back-to-back calls behind a spin kernel that
    lasts twice as long as the host takes to queue them, so the two events
    around the batch bracket device work only, not the host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batch):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    cycles = int(10_000_000 / a.elapsed_time(b) * max(2.0 * host_ms, 1.0))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def max_err(got, want, atol: float, rtol: float):
    """(max |got - want|, whether every entry is within atol + rtol|want|)."""
    import torch

    diff = (got - want).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.abs()))
    return float(diff.max()), ok


def density_inputs(dev):
    """A main-path-shaped mixture (45 of 48 slots active, flagship prior)
    and N = 48 * 200 samples drawn from it."""
    import torch

    g = torch.Generator().manual_seed(1)
    k, n = KMAX, KMAX * N_DES
    means = torch.randn(k, D, generator=g) * 100.0
    a = torch.randn(k, D, D, generator=g)
    covs = 300.0 * (a @ a.mT / D + 0.2 * torch.eye(D))
    chols = torch.linalg.cholesky(covs)
    inv_chols = torch.linalg.solve_triangular(chols, torch.eye(D).expand(
        k, D, D), upper=False)
    logw = torch.full((k,), -math.log(K0))
    logw[K0:] = -math.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp_of = torch.arange(n) // N_DES
    eps = torch.randn(n, D, generator=g)
    x = means[comp_of] + torch.einsum("nij,nj->ni", chols[comp_of], eps)
    return [t.to(dev).contiguous() for t in (means, inv_chols, logw, logdets,
                                             x)]


def tr_inputs(dev):
    """Main-path-shaped trust-region inputs (K=48, D=20) with indefinite
    curvature, and a spread of etas including eta <= 0 and etas small
    enough to make the interpolated precision not positive definite."""
    import torch

    from gmmvi_tpu_torch.ops.trust_region import prepare_tr_kl_inputs

    g = torch.Generator().manual_seed(2)
    k = KMAX
    means = torch.randn(k, D, generator=g) * 10.0
    a = torch.randn(k, D, D, generator=g)
    covs = a @ a.mT / D + 0.5 * torch.eye(D)
    chols = torch.linalg.cholesky(covs)
    inv_chols = torch.linalg.solve_triangular(chols, torch.eye(D).expand(
        k, D, D), upper=False)
    h = torch.randn(k, D, D, generator=g) * 0.3
    rq = h @ h.mT - 0.5 * torch.eye(D)
    rl = torch.randn(k, D, generator=g)
    etas = 10.0 ** (torch.rand(k, generator=g) * 6.0 - 3.0)
    etas[0], etas[1] = 0.0, -1.0
    inp = prepare_tr_kl_inputs(*[t.to(dev) for t in (means, chols, inv_chols,
                                                     rl, rq)])
    return etas.to(dev), inp


def background_inputs(dev):
    """The reuse path's background pass: U = 192 ring snapshots (four
    iterations of 48 slots drifting apart), a third of them unselected
    (-inf log weight), count weights on the rest, and the N = 28,800 samples
    of a total window drawn from the selected ones."""
    import torch

    g = torch.Generator().manual_seed(3)
    u, n = U_BACKGROUND, N_WINDOW
    base = torch.randn(KMAX, D, generator=g) * 100.0
    means = base.repeat(u // KMAX, 1) + torch.randn(u, D, generator=g) * 5.0
    a = torch.randn(u, D, D, generator=g)
    covs = 300.0 * (a @ a.mT / D + 0.2 * torch.eye(D))
    chols = torch.linalg.cholesky(covs)
    inv_chols = torch.linalg.solve_triangular(chols, torch.eye(D).expand(
        u, D, D), upper=False)
    counts = torch.randint(1, 201, (u,), generator=g).float()
    counts[torch.randperm(u, generator=g)[:u // 3]] = 0.0
    logw = torch.where(counts > 0, torch.log(counts / counts.sum()),
                       -math.inf)
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    live = torch.nonzero(counts > 0)[:, 0]
    row_of = live[torch.randint(0, len(live), (n,), generator=g)]
    x = means[row_of] + torch.einsum("nij,nj->ni", chols[row_of],
                                     torch.randn(n, D, generator=g))
    return [t.to(dev).contiguous() for t in (means, inv_chols, logw, logdets,
                                             x)]


def more_inputs(dev):
    """The MORE fit of the reuse path: K = 48 slots of which 45 are active,
    N = 28,800 window samples drawn from them in the window's order (runs
    of 200 per component), self-normalized importance weights of each
    active slot against the mixture (zero for the inactive ones), and
    outputs on the scale of log ratios."""
    import torch

    from gmmvi_tpu_torch.ops.density import densities_plain

    g = torch.Generator().manual_seed(4)
    k, n = KMAX, N_WINDOW
    means = torch.randn(k, D, generator=g) * 100.0
    a = torch.randn(k, D, D, generator=g)
    chols = torch.linalg.cholesky(300.0 * (a @ a.mT / D
                                           + 0.2 * torch.eye(D)))
    inv_chols = torch.linalg.solve_triangular(chols, torch.eye(D).expand(
        k, D, D), upper=False)
    comp_of = (torch.arange(n) // N_DES) % K0
    x = means[comp_of] + torch.einsum("nij,nj->ni", chols[comp_of],
                                      torch.randn(n, D, generator=g))
    logw = torch.full((k,), -math.log(K0))
    logw[K0:] = -math.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp, bg = densities_plain(means, inv_chols, logw, logdets, x)
    w = torch.softmax(comp - bg[None, :], dim=1)
    w[K0:] = 0.0
    y = torch.randn(n, generator=g) * 20.0 - 0.5 * (x / 100.0).square().sum(1)
    return [t.to(dev).contiguous() for t in (inv_chols, means, w, y, x)]


def measure_background(args) -> dict:
    """B4 on ``args`` against its plain version: the error (-inf in the same
    places, atol 2e-4 + rtol 1e-4 elsewhere), device times and the bound
    these inputs need."""
    import torch

    from gmmvi_tpu_torch.ops import background as bops

    got = bops.background_logpdf(*args)
    want = bops.background_logpdf_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err, ok = max_err(got[fin], want[fin], atol=2e-4, rtol=1e-4)
    ok = ok and torch.equal(torch.isneginf(got), torch.isneginf(want))
    (u, d), n = args[0].shape, args[4].shape[0]
    live = int((args[2] > -math.inf).sum())
    tri = d * (d + 1) / 2
    # each live row whitens every sample; bytes: every log weight, the live
    # rows' means, lower triangles and log|L|, the samples, the output
    b_ms, b_by = bound_ms(2 * live * n * tri,
                          4 * (u + live * (d + tri + 1) + n * d + n))
    return dict(max_abs_err=err, ok=ok, rows=u, live_rows=live, samples=n,
                ms=device_ms(lambda: bops.background_logpdf(*args)),
                plain_ms=device_ms(lambda: bops.background_logpdf_plain(
                    *args)),
                bound_ms=b_ms, bound_by=b_by)


def measure_more(args) -> dict:
    """B8 on ``args`` against its plain version: the Gram and rhs against
    2e-5 of each component's largest entry (``ok``), the terms solved from
    each at MORE.yml's ridge 1e-12 against JAX's bar, rtol 2e-3 with atol
    2e-4 (quad) and 2e-3 (lin), over the fits both sides could solve
    (``solve_ok``); device times and the bound these inputs need."""
    import torch

    from gmmvi_tpu_torch.ops import more as mops
    from gmmvi_tpu_torch.ops import quadratic as qops

    gram, rhs = mops.more_grams(*args)
    gram_p, rhs_p = mops.more_grams_plain(*args)
    k, n = args[2].shape
    regs = torch.full((k,), 1e-12, device=gram.device)
    quad, lin, _ = qops.solve_quadratic_normal_eqs(gram, rhs, regs, args[1],
                                                   args[0])
    quad_p, lin_p, _ = qops.solve_quadratic_normal_eqs(gram_p, rhs_p, regs,
                                                       args[1], args[0])
    torch.cuda.synchronize()
    rel = []
    for got_t, want_t in ((gram, gram_p), (rhs, rhs_p)):
        scale = want_t.abs().reshape(k, -1).amax(1).clamp(min=1e-30)
        rel.append(float(((got_t - want_t).abs().reshape(k, -1).amax(1)
                          / scale).max()))
    solved = torch.isfinite(quad).all((1, 2)) & torch.isfinite(quad_p).all(
        (1, 2)) & torch.isfinite(lin).all(1) & torch.isfinite(lin_p).all(1)
    quad_err, quad_ok = max_err(quad[solved], quad_p[solved], atol=2e-4,
                                rtol=2e-3)
    lin_err, lin_ok = max_err(lin[solved], lin_p[solved], atol=2e-3,
                              rtol=2e-3)
    d = args[1].shape[1]
    f = mops.num_features(d)
    tri = d * (d + 1) / 2
    # per component, only the samples with a nonzero weight: the Gram's
    # upper triangle, the rhs and the whitening
    pairs = float((args[2] != 0).sum())
    b_ms, b_by = bound_ms(
        2 * pairs * (f * (f + 1) / 2 + f + tri),
        4 * (k * (tri + d) + k * n + n + n * d + k * f * f + k * f))
    return dict(max_abs_err=float((gram - gram_p).abs().max()),
                ok=max(rel) <= 2e-5, gram_rel_err=rel[0], rhs_rel_err=rel[1],
                solve_ok=quad_ok and lin_ok, solved=int(solved.sum()),
                quad_abs_err=quad_err, lin_abs_err=lin_err, components=k,
                samples=n, features=f, weighted_pairs=pairs,
                ms=device_ms(lambda: mops.more_grams(*args)),
                plain_ms=device_ms(lambda: mops.more_grams_plain(*args),
                                   reps=5, batch=4),
                bound_ms=b_ms, bound_by=b_by)


def reuse_kernel_rows(dev):
    """B4 and B8 at the reuse path's shapes against their plain versions."""
    from gmmvi_tpu_torch.ops import background as bops
    from gmmvi_tpu_torch.ops import more as mops

    args = background_inputs(dev)
    b4 = dict(
        name="background_logpdf", route="cuda",
        source="gmmvi_tpu_torch/csrc/background.cu",
        replaces="gmmvi_tpu/ops/pallas_density.py:263",
        tolerance="atol 2e-4 + rtol 1e-4; -inf in the same places",
        **measure_background(args),
        call_ms=call_ms(lambda: bops.background_logpdf(*args)),
        library_ms=None,
        library="none: no single PyTorch call computes a Gaussian mixture's "
                "log-density from its factors")
    emit({"phase": "kernel", **b4})
    if not b4["ok"]:
        raise AssertionError(f"background_logpdf disagrees with its plain "
                             f"version: {b4['max_abs_err']}")

    args = more_inputs(dev)
    b8 = dict(
        name="more_grams", route="cuda", source="gmmvi_tpu_torch/csrc/more.cu",
        replaces="gmmvi_tpu/ops/pallas_more.py:61",
        tolerance="Gram and rhs within 2e-5 of each component's largest "
                  "entry; solved quad atol 2e-4 + rtol 2e-3 and lin atol "
                  "2e-3 + rtol 2e-3 at ridge 1e-12",
        **measure_more(args),
        call_ms=call_ms(lambda: mops.more_grams(*args), reps=20),
        library_ms=None,
        library="none: no single PyTorch call whitens by each component and "
                "builds its quadratic-feature Gram")
    emit({"phase": "kernel", **b8})
    if not (b8["ok"] and b8["solve_ok"] and b8["solved"] == K0):
        raise AssertionError(
            f"more_grams disagrees with its plain version: Gram "
            f"{b8['gram_rel_err']}, rhs {b8['rhs_rel_err']}, quad "
            f"{b8['quad_abs_err']}, lin {b8['lin_abs_err']} over "
            f"{b8['solved']} solved fits")
    return [b4, b8]


def measure_density(name, args) -> dict:
    """B1 (``density_pack``) or B2 (``densities``) on ``args`` against its
    plain version (every output within atol 5e-4 + rtol 1e-5), device times
    and the bound these inputs need."""
    import torch

    from gmmvi_tpu_torch.ops import density as dops

    fn, plain = getattr(dops, name), getattr(dops, name + "_plain")
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    errs = [max_err(gv, wv, atol=5e-4, rtol=1e-5)
            for gv, wv in zip(got, want)]
    means, _, logw, _, x = args
    (k, d), n = means.shape, x.shape[0]
    grads = name == "density_pack"
    k_active = int((logw > -math.inf).sum())
    tri = d * (d + 1) / 2
    # each input read once (only the lower triangle of the factors is
    # used), each output written once
    nbytes = 4 * (k * d + k * tri + 2 * k + n * d
                  + k * n + n + (n * d if grads else 0))
    # FMAs: the whitening L^{-1}(x - mu) for every slot, and for the
    # gradient L^{-T} y once more for the active slots only
    fmas = n * tri * (k + (k_active if grads else 0))
    b_ms, b_by = bound_ms(2 * fmas, nbytes)
    return dict(max_abs_err=max(e[0] for e in errs),
                ok=all(e[1] for e in errs), samples=n,
                ms=device_ms(lambda: fn(*args)),
                plain_ms=device_ms(lambda: plain(*args)),
                bound_ms=b_ms, bound_by=b_by)


def measure_tr_kl(etas, inp) -> dict:
    """B3 on ``(etas, inp)`` against its plain version, over the components
    whose inputs are finite (an inactive slot of the MORE path carries NaN
    rewards, which the bisection never reads): F32_MAX in the same places,
    the KL within atol 1e-4 + rtol 1e-4 elsewhere; device times and the
    bound."""
    import torch

    from gmmvi_tpu_torch.ops import trust_region as tops

    got = tops.tr_kl(etas, inp)
    want = tops.tr_kl_plain(etas, inp)
    torch.cuda.synchronize()
    k, d = inp.means.shape
    fin = torch.isfinite(etas)
    for t in inp:
        fin &= torch.isfinite(t.reshape(k, -1)).all(1)
    inf_got, inf_want = got[fin] >= 3e38, want[fin] >= 3e38
    feas = ~inf_want
    err, ok = max_err(got[fin][feas], want[fin][feas], atol=1e-4, rtol=1e-4)
    n_feas = int(feas.sum())
    # per feasible component: Cholesky D^3/3, the D x D forward solve D^3/2,
    # the vector solves and the Mahalanobis term ~2 D^2, as FMAs
    flops = 2 * n_feas * (d ** 3 / 3 + d ** 3 / 2 + 2 * d * d)
    # each input read once: the lower triangles of the old precision,
    # R_quad and the old inverse factor, three [D] vectors, eta and the
    # constant; the [K] KLs written
    b_ms, b_by = bound_ms(flops, 4 * (k * (3 * d * (d + 1) / 2 + 3 * d + 2)
                                      + k))
    return dict(max_abs_err=err,
                ok=ok and torch.equal(inf_got, inf_want),
                compared=int(fin.sum()), infeasible=int(inf_want.sum()),
                ms=device_ms(lambda: tops.tr_kl(etas, inp)),
                plain_ms=device_ms(lambda: tops.tr_kl_plain(etas, inp)),
                bound_ms=b_ms, bound_by=b_by)


def kernel_phase(dev):
    import torch

    from gmmvi_tpu_torch.ops import density as dops
    from gmmvi_tpu_torch.ops import trust_region as tops

    rows = []
    args = density_inputs(dev)
    for name, replaces in (("density_pack",
                            "gmmvi_tpu/ops/pallas_density.py:128"),
                           ("densities",
                            "gmmvi_tpu/ops/pallas_density.py:164")):
        fn = getattr(dops, name)
        row = dict(
            name=name, route="cuda", source="gmmvi_tpu_torch/csrc/density.cu",
            replaces=replaces, tolerance="atol 5e-4 + rtol 1e-5",
            **measure_density(name, args),
            call_ms=call_ms(lambda: fn(*args)), library_ms=None,
            library="none: no single PyTorch call computes component "
                    "densities with their mixture logsumexp")
        emit({"phase": "kernel", **row})
        if not row["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{row['max_abs_err']}")
        rows.append(row)

    etas, inp = tr_inputs(dev)
    row = dict(
        name="tr_kl", route="cuda",
        source="gmmvi_tpu_torch/csrc/trust_region.cu",
        replaces="gmmvi_tpu/ops/pallas_trust_region.py:65",
        tolerance="atol 1e-4 + rtol 1e-4; F32_MAX flags equal",
        **measure_tr_kl(etas, inp),
        call_ms=call_ms(lambda: tops.tr_kl(etas, inp)), library_ms=None,
        library="none: no single PyTorch call computes the batched "
                "trust-region KL")

    # cost of the bisection's one host sync per trip: a trip's launch
    # followed by reading a device flag, against the launch alone
    def trips(sync: bool, reps: int = 200) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            kl = tops.tr_kl(etas, inp)
            if sync:
                bool((kl < 0).any())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    trips(True, 20)
    row["trip_ms_with_sync"] = trips(True)
    row["trip_ms_without_sync"] = trips(False)
    emit({"phase": "kernel", **row})
    if not (row["ok"] and row["compared"] == KMAX):
        raise AssertionError(f"tr_kl disagrees with its plain version: "
                             f"{row['max_abs_err']}")
    rows.append(row)
    return rows + reuse_kernel_rows(dev) + large_kernel_rows(dev)


def large_inputs(dev):
    """stm300-shaped inputs of B5 and B6: K = 40 components, all active,
    D = 300, N = 12,000 samples (300 drawn from each), the means close
    enough for every responsibility to be nonzero (B6's full K N D^2
    work).  Made on the card from a seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    k, d, n = KMAX_LARGE, D_LARGE, N_LARGE
    opts = dict(generator=g, device=dev)
    means = torch.randn(k, d, **opts) * 0.3
    a = torch.randn(k, d, d, **opts)
    chols = torch.linalg.cholesky(a @ a.mT / d + torch.eye(d, device=dev))
    inv_chols = torch.linalg.solve_triangular(
        chols, torch.eye(d, device=dev).expand(k, d, d), upper=False)
    logw = torch.full((k,), -math.log(k), device=dev)
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    eps = torch.randn(k, n // k, d, **opts)
    x = (means[:, None, :] + eps @ chols.mT).reshape(n, d)
    return [t.contiguous() for t in (means, inv_chols, logw, logdets, x)]


def stein_inputs(dev, args):
    """B7's inputs from the same mixture as the estimator makes them:
    self-normalized importance weights of every component against the
    mixture (by the plain B5), log-ratio gradients and centred samples."""
    import torch

    from gmmvi_tpu_torch.ops.density_large import densities_large_plain

    means, _, _, _, x = args
    comp, model = densities_large_plain(*args)
    w = torch.softmax(comp - model[None, :], dim=1)
    g = torch.Generator(device=dev).manual_seed(6)
    grads = torch.randn(x.shape, generator=g, device=dev) * 10.0
    return [t.contiguous() for t in (w, grads, x - means.mean(0))]


def measure_large_density(name, args) -> dict:
    """B5 on ``args``, as ``densities_large`` (comp and model) or
    ``mixture_logpdf_large`` (model alone, -inf rows skipped), against its
    plain version (rtol 2e-4, atol 2e-3; -inf in the same places), device
    times and the bound these inputs need: every computed row whitens every
    sample against its lower triangle."""
    import torch

    from gmmvi_tpu_torch.ops import density_large as dl

    fn, plain = getattr(dl, name), getattr(dl, name + "_plain")
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs, ok = [], True
    for gv, wv in zip(got, want):
        fin = torch.isfinite(wv)
        errs.append(max_err(gv[fin], wv[fin], atol=2e-3, rtol=2e-4))
        ok = ok and torch.equal(torch.isneginf(gv), torch.isneginf(wv))
    means, _, logw, _, x = args
    (k, d), n = means.shape, x.shape[0]
    comp_out = name == "densities_large"
    rows = k if comp_out else int((logw > -math.inf).sum())
    tri = d * (d + 1) / 2
    nbytes = 4 * (k + rows * (d + tri + 1) + n * d + n
                  + (k * n if comp_out else 0))
    b_ms, b_by = bound_ms(2 * rows * n * tri, nbytes)
    return dict(max_abs_err=max(e[0] for e in errs),
                ok=ok and all(e[1] for e in errs), rows=k, computed_rows=rows,
                samples=n, ms=device_ms(lambda: fn(*args)),
                plain_ms=device_ms(lambda: plain(*args), reps=11, batch=5),
                bound_ms=b_ms, bound_by=b_by)


def measure_large_grads(args) -> dict:
    """B6 on ``args`` (means, inv_chols, logw, comp, model, x) against its
    plain version (rtol and atol 2e-3); the bound counts D^2 FMAs for each
    (component, sample) pair whose responsibility is nonzero."""
    import torch

    from gmmvi_tpu_torch.ops import density_large as dl

    got = dl.density_grads_large(*args)
    want = dl.density_grads_large_plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(got, want, atol=2e-3, rtol=2e-3)
    means, _, logw, comp, model, x = args
    (k, d), n = means.shape, x.shape[0]
    resp = torch.exp(comp + logw[:, None] - model[None, :])
    pairs = float(((resp > 0) & (logw > -math.inf)[:, None]
                   & (model > -math.inf)[None, :]).sum())
    b_ms, b_by = bound_ms(2 * pairs * d * d,
                          4 * (k * (d + d * (d + 1) / 2 + 1) + k * n + n
                               + 2 * n * d))
    return dict(max_abs_err=err, ok=ok, components=k, samples=n,
                responsible_pairs=pairs,
                ms=device_ms(lambda: dl.density_grads_large(*args)),
                plain_ms=device_ms(lambda: dl.density_grads_large_plain(*args),
                                   reps=11, batch=5),
                bound_ms=b_ms, bound_by=b_by)


def measure_stein(args) -> dict:
    """B7 on ``args`` (w, g, xc) against its plain version: within 1e-5 of
    each component's largest |entry| of the plain result (the scale divided
    by; components without weight must give zeros); the bound counts D^2
    FMAs per nonzero weight.  ``library_ms``: one ``torch.einsum("kn,nd,ne->
    kde")`` on the same inputs (the plain version sums the same products
    over chunks of N instead, to bound its memory)."""
    import torch

    from gmmvi_tpu_torch.ops import stein

    got = stein.stein_smom(*args)
    want = stein.stein_smom_plain(*args)
    torch.cuda.synchronize()
    w, g, _ = args
    (k, n), d = w.shape, g.shape[1]
    scale = want.abs().reshape(k, -1).amax(1)
    err = (got - want).abs().reshape(k, -1).amax(1)
    live = scale > 0
    rel = float((err[live] / scale[live]).max()) if bool(live.any()) else 0.0
    ok = rel <= 1e-5 and bool((err[~live] == 0).all())
    pairs = float((w != 0).sum())
    b_ms, b_by = bound_ms(2 * pairs * d * d,
                          4 * (k * n + 2 * n * d + k * d * d))
    return dict(max_abs_err=float(err.max()), rel_to_scale=rel, ok=ok,
                components=k, samples=n, weighted_pairs=pairs,
                ms=device_ms(lambda: stein.stein_smom(*args)),
                plain_ms=device_ms(lambda: stein.stein_smom_plain(*args),
                                   reps=11, batch=5),
                library_ms=device_ms(
                    lambda: torch.einsum("kn,nd,ne->kde", *args),
                    reps=11, batch=5),
                bound_ms=b_ms, bound_by=b_by)


def large_kernel_rows(dev):
    """B5, B6 and B7 at the stm300 shapes on synthetic inputs."""
    from gmmvi_tpu_torch.ops import density_large as dl
    from gmmvi_tpu_torch.ops import stein

    args = large_inputs(dev)
    b5 = dict(
        name="densities_large", route="cuda",
        source="gmmvi_tpu_torch/csrc/density_large.cu",
        replaces="gmmvi_tpu/ops/pallas_density_large.py:101",
        tolerance="rtol 2e-4 + atol 2e-3 (comp and model)",
        **measure_large_density("densities_large", args),
        call_ms=call_ms(lambda: dl.densities_large(*args)), library_ms=None,
        library="none: no single PyTorch call computes component densities "
                "with their mixture logsumexp")
    emit({"phase": "kernel", **b5})
    comp, model = dl.densities_large_plain(*args)
    gargs = [*args[:3], comp, model, args[4]]
    b6 = dict(
        name="density_grads_large", route="cuda",
        source="gmmvi_tpu_torch/csrc/density_large.cu",
        replaces="gmmvi_tpu/ops/pallas_density_large.py:164",
        tolerance="rtol 2e-3 + atol 2e-3",
        **measure_large_grads(gargs),
        call_ms=call_ms(lambda: dl.density_grads_large(*gargs)),
        library_ms=None,
        library="none: no single PyTorch call computes a mixture's "
                "log-density gradient from its factors")
    emit({"phase": "kernel", **b6})
    sargs = stein_inputs(dev, args)
    b7 = dict(
        name="stein_smom", route="cuda",
        source="gmmvi_tpu_torch/csrc/stein.cu",
        replaces="gmmvi_tpu/ops/pallas_stein.py:75",
        tolerance="1e-5 of each component's largest |entry|",
        **measure_stein(sargs),
        call_ms=call_ms(lambda: stein.stein_smom(*sargs)),
        library='torch.einsum("kn,nd,ne->kde", w, g, xc)')
    emit({"phase": "kernel", **b7})
    for row in (b5, b6, b7):
        if not row["ok"]:
            raise AssertionError(f"{row['name']} disagrees with its plain "
                                 f"version: {row['max_abs_err']}")
    return [b5, b6, b7]


def flagship_config(seed: int = 0, codename: str = "SAMTRON") -> dict:
    """SAMTRON on the 20-D Student-T mixture: the flagship workload.  With
    ``codename="ZAMTRUX"`` the same widths under VIPS, with the M letter's
    sample reuse (2.0 x n_des per component)."""
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)

    cfg = get_default_algorithm_config(codename)
    return update_config(cfg, {
        "start_seed": seed, "seed": seed, "environment_name": "stm",
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": K0,
            "prior_mean": 0.0, "prior_scale": 100.0, "initial_cov": 300.0,
        },
        "use_sample_database": True, "max_database_size": 10_000_000,
        "temperature": 1.0,
        "sample_selector_config": {
            "desired_samples_per_component": N_DES,
            "ratio_reused_samples_to_desired":
                REUSED / N_DES if codename == "ZAMTRUX" else 0.0,
        },
        "num_component_adapter_config": {
            "del_iters": 100, "add_iters": 60, "max_components": KMAX,
            "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0, 200.0,
                                             100.0, 50.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 1024, "num_prior_samples": 0,
        },
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.1, "min_stepsize": 0.001,
            "max_stepsize": 1.0,
        },
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": KMAX},
    })


def newest_window_mean_lnpdf(db) -> float:
    newest = db.sample_iter.max()
    sel = db.sample_iter == newest
    return float(db.target_lnpdfs[sel].mean())


def mc_elbo(model, target, n: int = 2000, seed: int = 0):
    """(ELBO, mean target log-density) as the JAX package's runner
    estimates them (``GmmviRunner.get_expensive_metrics``, temperature 1):
    means of log p(x) - log q(x) and of log p(x) over ``n`` draws from the
    mixture, made on the card from ``seed``.  Their difference is the
    entropy estimate."""
    import torch

    from gmmvi_tpu_torch.models import gmm

    dev = model.means.device
    g = torch.Generator(device=dev).manual_seed(seed)
    comp = torch.multinomial(torch.where(model.mask, model.weights, 0.0), n,
                             replacement=True, generator=g)
    eps = torch.randn((n, model.num_dimensions), generator=g, device=dev)
    x = model.means[comp] + torch.einsum("nij,nj->ni", model.chols[comp], eps)
    lnp = target.log_density(x)
    return (float((lnp - gmm.log_density(model, x)).mean()),
            float(lnp.mean()))


def recording(captured: dict, module, attr, key=None):
    """Replace ``module.attr`` by a wrapper that keeps its latest arguments
    in ``captured`` (under ``key(args)``, else ``attr``) and calls it as
    before, so its launches count once; returns the undo.  The port's
    updates make new tensors, so the kept arguments stay as the kernel saw
    them."""
    fn = getattr(module, attr)

    def call(*args):
        captured[attr if key is None else key(args)] = args
        return fn(*args)

    setattr(module, attr, call)
    return lambda: setattr(module, attr, fn)


def capture_last_inputs(captured: dict):
    """Keep the arguments of the latest call the ZAMTRUX path makes to each
    kernel wrapper, B2's by its number of samples (its two call sites, the
    ESS pass over the reuse window and the weight update over the total
    window, differ in size)."""
    from gmmvi_tpu_torch.ops import density
    from gmmvi_tpu_torch.optimization import (component_updaters,
                                              ng_estimators, sample_db)

    return [recording(captured, density, "density_pack"),
            recording(captured, density, "densities",
                      key=lambda args: ("densities", args[4].shape[0])),
            recording(captured, component_updaters, "tr_kl"),
            recording(captured, sample_db, "background_logpdf"),
            recording(captured, ng_estimators, "more_grams")]


def capture_large_d_inputs(captured: dict):
    """The same for the stm300 path: B5 by entry and size (the pack and the
    weight update over the total window, the ESS pass over the reuse
    window, the background over U ring rows at both), B6 and B7."""
    from gmmvi_tpu_torch.ops import density_large, stein

    def size(args):
        return args[0].shape[0], args[4].shape[0]

    return [recording(captured, density_large, "densities_large",
                      key=lambda args: ("densities_large", *size(args))),
            recording(captured, density_large, "mixture_logpdf_large",
                      key=lambda args: ("mixture_logpdf_large", *size(args))),
            recording(captured, density_large, "density_grads_large"),
            recording(captured, stein, "stein_smom")]


def main_path_phase(dev, codename, kernel_names, captured=None):
    """130 iterations of ``codename`` through the entry points, the launch
    counters set to 0 just before and read just after; with ``captured``,
    the inputs of the last B4 and B8 launches go there."""
    import torch

    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                         device=dev)
    cfg = flagship_config(codename=codename)
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    # record each step's reused-sample count (device tensors, read at the
    # end, so the record adds no host sync)
    reused = []
    propose = gmmvi._propose_phase

    def recording_propose(state, draws):
        prop = propose(state, draws)
        reused.append(prop.num_reused)
        return prop

    gmmvi._propose_phase = recording_propose
    restore = capture_last_inputs(captured) if captured is not None else []

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmmvi.train_iter()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start_lnpdf = newest_window_mean_lnpdf(gmmvi.state.db)
    t0 = time.perf_counter()
    for _ in range(MAIN_ITERS - 1):
        gmmvi.train_iter()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()

    st = gmmvi.state
    num_active = int(st.model.num_active)
    end_lnpdf = newest_window_mean_lnpdf(st.db)
    means_finite = bool(torch.isfinite(st.model.means[:num_active]).all())
    reused = [int(r) for r in reused]
    step_ms = steady_s / (MAIN_ITERS - 1) * 1e3
    out = dict(
        phase="main_path", codename=codename, iterations=MAIN_ITERS,
        first_step_s=first_s, step_ms=step_ms,
        samples_per_s=KMAX * N_DES / (step_ms / 1e3),
        trips_per_step=launches["tr_kl"] / MAIN_ITERS,
        launches=launches, num_active=num_active,
        fevals=int(st.db.num_samples_written),
        num_reused_mean=sum(reused) / len(reused),
        num_reused_min_after_3=min(reused[4:]),
        window_mean_target_lnpdf_start=start_lnpdf,
        window_mean_target_lnpdf_end=end_lnpdf, means_finite=means_finite,
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if not means_finite:
        raise AssertionError("non-finite means after the main path")
    if not 1 <= num_active <= KMAX:
        raise AssertionError(f"num_active {num_active} outside [1, {KMAX}]")
    for name in kernel_names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{codename} path")
    wanted = {"density_pack": MAIN_ITERS, "densities": MAIN_ITERS}
    if codename == "ZAMTRUX":
        wanted.update(background_logpdf=2 * MAIN_ITERS,
                      more_grams=MAIN_ITERS)
        if not min(reused[4:]) > 0:
            raise AssertionError("no sample was reused after iteration 3")
    for name, least in wanted.items():
        if launches[name] < least:
            raise AssertionError(f"{name}: {launches[name]} launches < "
                                 f"{least} on the {codename} path")
    if not end_lnpdf > start_lnpdf:
        raise AssertionError(f"mean target log-density did not improve: "
                             f"{start_lnpdf} -> {end_lnpdf}")
    return launches


def main_path_input_rows(captured) -> None:
    """Every kernel once more on the inputs of its last launch in the
    ZAMTRUX run (B2 at each of its two window sizes), against its plain
    version at the kernel phase's bar; fails on a miss.  The solved MORE
    terms are reported, not held: on the main path's data the ridge-1e-12
    fit may be ill-conditioned."""
    measures = [("density_pack", captured["density_pack"],
                 lambda a: measure_density("density_pack", a))]
    for key in sorted(k for k in captured if k[0] == "densities"):
        measures.append((f"densities[N={key[1]}]", captured[key],
                         lambda a: measure_density("densities", a)))
    measures += [("tr_kl", captured["tr_kl"], lambda a: measure_tr_kl(*a)),
                 ("background_logpdf", captured["background_logpdf"],
                  measure_background),
                 ("more_grams", captured["more_grams"], measure_more)]
    if len(measures) != 6:
        raise AssertionError(f"expected B2 at two window sizes, got "
                             f"{[m[0] for m in measures]}")
    for name, args, measure in measures:
        out = measure(args)
        emit({"phase": "kernel_on_main_path_inputs", "name": name, **out})
        if not out["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the main path's inputs: {out}")


LARGE_KERNELS = ("densities_large", "density_grads_large", "stein_smom")


def large_d_phase(dev, captured):
    """SAMTRON on stm300 through the entry points, from
    ``get_default_config("SAMTRON", "stm300")`` as the JAX package's
    scripts build it: 130 iterations (61 if the step exceeds 150 ms over
    iterations 2-11), the launch counters set to 0 just before and read
    just after; the inputs of the last B5 (per call size), B6 and B7
    launches go to ``captured``."""
    import torch

    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization import component_updaters
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_config("SAMTRON", "stm300")
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    sel = gmmvi.selector_cfg
    shape = (model.num_dimensions, model.max_components,
             sel.desired_samples_per_component,
             sel.reused_samples_per_component, sel.max_background_dists)
    if shape != (D_LARGE, KMAX_LARGE, N_DES_LARGE, 2 * N_DES_LARGE, U_LARGE):
        raise AssertionError(f"stm300 built as {shape}")
    # each step's reused-sample count (device tensors, read at the end) and
    # bisection trips (a host count)
    reused, trips = [], []
    propose = gmmvi._propose_phase
    search = component_updaters._bracketing_search_batched

    def recording_propose(state, draws):
        prop = propose(state, draws)
        reused.append(prop.num_reused)
        return prop

    def counting_search(*args, **kw):
        out = search(*args, **kw)
        trips.append(out[2])
        return out

    gmmvi._propose_phase = recording_propose
    component_updaters._bracketing_search_batched = counting_search
    restore = capture_large_d_inputs(captured)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmmvi.train_iter()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start_lnpdf = newest_window_mean_lnpdf(gmmvi.state.db)
    start_elbo, start_density = mc_elbo(gmmvi.state.model, target)
    iters, done, probe_ms = MAIN_ITERS, 1, None
    t0 = time.perf_counter()
    while done < iters:
        gmmvi.train_iter()
        done += 1
        if done == 11:
            torch.cuda.synchronize()
            probe_ms = (time.perf_counter() - t0) / 10 * 1e3
            if probe_ms > LARGE_STEP_MS_CAP:
                iters = LARGE_ITERS_CUT
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()
    component_updaters._bracketing_search_batched = search

    st = gmmvi.state
    num_active = int(st.model.num_active)
    end_lnpdf = newest_window_mean_lnpdf(st.db)
    end_elbo, end_density = mc_elbo(st.model, target)
    means_finite = bool(torch.isfinite(st.model.means[:num_active]).all())
    reused = [int(r) for r in reused]
    fevals = int(st.db.num_samples_written)
    step_ms = steady_s / (iters - 1) * 1e3
    out = dict(
        phase="main_path", codename="SAMTRON", experiment="stm300",
        iterations=iters, cut_to_61=iters != MAIN_ITERS,
        probe_step_ms=probe_ms, first_step_s=first_s, step_ms=step_ms,
        samples_per_s=KMAX_LARGE * N_DES_LARGE / (step_ms / 1e3),
        fevals=fevals, fevals_per_step=fevals / iters,
        trips_per_step=sum(trips) / iters, launches=launches,
        launches_per_step={k: v / iters for k, v in launches.items()},
        num_active=num_active, num_reused_mean=sum(reused) / len(reused),
        num_reused=reused, elbo_start=start_elbo, elbo_end=end_elbo,
        draws_mean_target_lnpdf_start=start_density,
        draws_mean_target_lnpdf_end=end_density,
        window_mean_target_lnpdf_start=start_lnpdf,
        window_mean_target_lnpdf_end=end_lnpdf, means_finite=means_finite,
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if not means_finite:
        raise AssertionError("non-finite means after the stm300 path")
    if not 1 <= num_active <= KMAX_LARGE:
        raise AssertionError(f"num_active {num_active} outside [1, "
                             f"{KMAX_LARGE}]")
    # B5: pack, ESS pass, weight update and two background passes a step
    wanted = {"densities_large": 4 * iters, "density_grads_large": iters,
              "stein_smom": iters}
    for name, least in wanted.items():
        if launches[name] < least:
            raise AssertionError(f"{name}: {launches[name]} launches < "
                                 f"{least} on the stm300 path")
    for name in ("density_pack", "densities", "tr_kl", "background_logpdf",
                 "more_grams"):
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 "on the stm300 path")
    # held: the ELBO.  The window means are reported, not held: here the
    # mixture widens from its start (entropy up by some 800 nats in 130
    # steps) while its ELBO climbs, so the target density of its newest
    # samples falls
    if not end_elbo > start_elbo:
        raise AssertionError(f"the ELBO did not improve: {start_elbo} -> "
                             f"{end_elbo}")
    return launches


def large_d_input_rows(captured) -> None:
    """B5 at each of its call sizes, B6 and B7 once more on the inputs of
    their last launch in the stm300 run, against their plain versions at
    the kernel phase's bars; fails on a miss."""
    keys = sorted(k for k in captured if isinstance(k, tuple))
    if len(keys) != 4:
        raise AssertionError(f"expected B5 at four call sizes, got {keys}")
    measures = [(f"{key[0]}[K={key[1]},N={key[2]}]",
                 lambda key=key: measure_large_density(key[0], captured[key]))
                for key in keys]
    measures += [
        ("density_grads_large",
         lambda: measure_large_grads(captured["density_grads_large"])),
        ("stein_smom", lambda: measure_stein(captured["stein_smom"]))]
    for name, measure in measures:
        out = measure()
        emit({"phase": "kernel_on_main_path_inputs", "path": "stm300",
              "name": name, **out})
        if not out["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the stm300 path's inputs: {out}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.ops import cuda

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    t0 = time.perf_counter()
    built = cuda.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": built})

    rows = kernel_phase(dev)
    flagship = ("density_pack", "densities", "tr_kl")
    captured: dict = {}
    captured_large: dict = {}
    by_path = {"SAMTRON": main_path_phase(dev, "SAMTRON", flagship),
               "ZAMTRUX": main_path_phase(
                   dev, "ZAMTRUX",
                   flagship + ("background_logpdf", "more_grams"), captured),
               "stm300": large_d_phase(dev, captured_large)}
    main_path_input_rows(captured)
    large_d_input_rows(captured_large)
    for r in rows:
        # the flagship's count for B1-B3, the reuse path's for B4 and B8,
        # the stm300 path's for B5-B7
        path = ("SAMTRON" if r["name"] in flagship else
                "stm300" if r["name"] in LARGE_KERNELS else "ZAMTRUX")
        r["launches"] = by_path[path][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
