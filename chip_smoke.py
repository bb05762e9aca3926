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
   possible time on an H100 (``bound_ms``), then one ``{"kernels": [...]}``
   line;
4. main path: SAMTRON on the 20-D Student-T mixture (45 components padded
   to 48, 200 samples per component, full covariances, no sample reuse)
   through ``GMMVI.build_from_config`` and ``train_iter`` for 130
   iterations, with the launch counters set to 0 just before and read just
   after, and checks on what comes out.

The last line is ``{"ok": true, "device": {...}}``.  Nothing is caught: any
failure exits non-zero before that line.  Without a CUDA card it exits 1.
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


def kernel_phase(dev):
    import torch

    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density as dops
    from gmmvi_tpu_torch.ops import trust_region as tops

    rows = []
    means, inv_chols, logw, logdets, x = density_inputs(dev)
    k, n = means.shape[0], x.shape[0]
    k_active = int((logw > -math.inf).sum())
    tri = D * (D + 1) / 2
    # each input read once: only the lower triangle of the factors is used
    in_bytes = 4 * (k * D + k * tri + 2 * k + n * D)
    for name, fn, plain, replaces, passes in (
        ("density_pack", dops.density_pack, dops.density_pack_plain,
         "gmmvi_tpu/ops/pallas_density.py:128", 2),
        ("densities", dops.densities, dops.densities_plain,
         "gmmvi_tpu/ops/pallas_density.py:164", 1),
    ):
        args = (means, inv_chols, logw, logdets, x)
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(gv, wv, atol=5e-4, rtol=1e-5)
                for gv, wv in zip(got, want)]
        out_bytes = 4 * (k * n + n + (n * D if passes == 2 else 0))
        # FMAs: the whitening L^{-1}(x - mu) for every slot, and for the
        # gradient L^{-T} y once more for the active slots only
        fmas = n * tri * (k + (k_active if passes == 2 else 0))
        b_ms, b_by = bound_ms(2 * fmas, in_bytes + out_bytes)
        row = dict(
            name=name, route="cuda", source="gmmvi_tpu_torch/csrc/density.cu",
            replaces=replaces, max_abs_err=max(e[0] for e in errs),
            tolerance="atol 5e-4 + rtol 1e-5",
            ms=device_ms(lambda: fn(*args)),
            plain_ms=device_ms(lambda: plain(*args)),
            call_ms=call_ms(lambda: fn(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library="none: no single PyTorch call computes component "
                    "densities with their mixture logsumexp")
        emit({"phase": "kernel", **row})
        if not all(e[1] for e in errs):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{errs}")
        rows.append(row)

    etas, inp = tr_inputs(dev)
    got = tops.tr_kl(etas, inp)
    want = tops.tr_kl_plain(etas, inp)
    torch.cuda.synchronize()
    inf_got, inf_want = got >= 3e38, want >= 3e38
    if not torch.equal(inf_got, inf_want):
        raise AssertionError(f"tr_kl feasibility differs: {inf_got.tolist()}"
                             f" vs {inf_want.tolist()}")
    feas = ~inf_want
    err, ok = max_err(got[feas], want[feas], atol=1e-4, rtol=1e-4)
    n_feas = int(feas.sum())
    # per feasible component: Cholesky D^3/3, the D x D forward solve D^3/2,
    # the vector solves and the Mahalanobis term ~2 D^2, as FMAs
    tr_flops = 2 * n_feas * (D ** 3 / 3 + D ** 3 / 2 + 2 * D * D)
    # each input read once: the lower triangles of the old precision,
    # R_quad and the old inverse factor, three [D] vectors, eta and the
    # constant; the [K] KLs written
    tr_bytes = 4 * (k * (3 * D * (D + 1) / 2 + 3 * D + 2) + k)
    b_ms, b_by = bound_ms(tr_flops, tr_bytes)
    row = dict(
        name="tr_kl", route="cuda",
        source="gmmvi_tpu_torch/csrc/trust_region.cu",
        replaces="gmmvi_tpu/ops/pallas_trust_region.py:65", max_abs_err=err,
        tolerance="atol 1e-4 + rtol 1e-4; F32_MAX flags equal",
        infeasible=int(inf_want.sum()),
        ms=device_ms(lambda: tops.tr_kl(etas, inp)),
        plain_ms=device_ms(lambda: tops.tr_kl_plain(etas, inp)),
        call_ms=call_ms(lambda: tops.tr_kl(etas, inp)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
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
    if not ok:
        raise AssertionError(f"tr_kl disagrees with its plain version: {err}")
    rows.append(row)
    return rows


def flagship_config(seed: int = 0) -> dict:
    """SAMTRON on the 20-D Student-T mixture: the flagship workload."""
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)

    cfg = get_default_algorithm_config("SAMTRON")
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
            "ratio_reused_samples_to_desired": 0.0,
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


def main_path_phase(dev, kernel_names):
    import torch

    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                         device=dev)
    cfg = flagship_config()
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)

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

    st = gmmvi.state
    num_active = int(st.model.num_active)
    end_lnpdf = newest_window_mean_lnpdf(st.db)
    means_finite = bool(torch.isfinite(st.model.means[:num_active]).all())
    step_ms = steady_s / (MAIN_ITERS - 1) * 1e3
    out = dict(
        phase="main_path", iterations=MAIN_ITERS, first_step_s=first_s,
        step_ms=step_ms,
        samples_per_s=KMAX * N_DES / (step_ms / 1e3),
        trips_per_step=launches["tr_kl"] / MAIN_ITERS,
        launches=launches, num_active=num_active,
        fevals=int(st.db.num_samples_written),
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
                                 "main path")
    for name in ("density_pack", "densities"):
        if launches[name] < MAIN_ITERS:
            raise AssertionError(f"{name}: {launches[name]} launches < "
                                 f"{MAIN_ITERS} iterations")
    if not end_lnpdf > start_lnpdf:
        raise AssertionError(f"mean target log-density did not improve: "
                             f"{start_lnpdf} -> {end_lnpdf}")
    return launches


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
    launches = main_path_phase(dev, [r["name"] for r in rows])
    for r in rows:
        r["launches"] = launches[r["name"]]
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
