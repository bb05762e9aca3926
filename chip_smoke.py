#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gmmvi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one JSON line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the main path, compiled from
   ``gmmvi_tpu_torch/csrc`` with ``nvcc`` (in parallel), with the seconds;
3. kernels: each kernel at the main path's shapes against its plain
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
   weight update; kernels B1-B4 and B8) at the same widths;
5. every kernel once more, on the inputs of its last launch in the
   ZAMTRUX run (B2 at both of its window sizes; the data decides how much
   work B4 and B8 do), against its plain version at the bar of phase 3,
   timed as there.

Then one ``{"kernels": [...]}`` line (each kernel's ``launches`` from the
path that runs it: SAMTRON for B1-B3, ZAMTRUX for B4 and B8), the card's
name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero before that line.  Without a CUDA card it exits 1.
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
    return rows + reuse_kernel_rows(dev)


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


def capture_last_inputs(captured: dict):
    """Keep the arguments of the latest call the main path makes to each
    kernel wrapper, B2's by its number of samples (its two call sites, the
    ESS pass over the reuse window and the weight update over the total
    window, differ in size).  The wrappers are called as before, so their
    launches count once; the port's updates make new tensors, so the kept
    arguments stay as the kernel saw them."""
    from gmmvi_tpu_torch.ops import density
    from gmmvi_tpu_torch.optimization import (component_updaters,
                                              ng_estimators, sample_db)

    def recording(module, attr, key=None):
        fn = getattr(module, attr)

        def call(*args):
            captured[attr if key is None else key(args)] = args
            return fn(*args)

        setattr(module, attr, call)
        return lambda: setattr(module, attr, fn)

    return [recording(density, "density_pack"),
            recording(density, "densities",
                      key=lambda args: ("densities", args[4].shape[0])),
            recording(component_updaters, "tr_kl"),
            recording(sample_db, "background_logpdf"),
            recording(ng_estimators, "more_grams")]


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
    by_path = {"SAMTRON": main_path_phase(dev, "SAMTRON", flagship),
               "ZAMTRUX": main_path_phase(dev, "ZAMTRUX",
                                          [r["name"] for r in rows],
                                          captured)}
    main_path_input_rows(captured)
    for r in rows:
        # the flagship's count for B1-B3, the reuse path's for B4 and B8
        path = "SAMTRON" if r["name"] in flagship else "ZAMTRUX"
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
