#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gmmvi_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one JSON line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the main paths, compiled from
   ``gmmvi_tpu_torch/csrc`` with ``nvcc`` (in parallel), with the seconds;
   then sass: ``cuobjdump --dump-sass`` of the libraries, the count of
   ``HGMMA`` (wgmma) instructions in B5's, B6's, B7's and B8's
   tensor-core kernels, which fails the run where it is 0;
3. kernels: each kernel at its main path's shapes against its plain
   PyTorch version on the card (max error against the stated tolerance),
   timed with CUDA events: ``ms`` and ``plain_ms`` are device time per call
   (median of 21 batches of 20 back-to-back calls queued behind a spin
   kernel, so the host's time is hidden), ``call_ms`` one call on an idle
   card with the host's part included (median of 50); with its least
   possible time on an H100 (``bound_ms``: the fp32 FMAs at 67 TFLOP/s or
   the bytes at 3.35 TB/s; for B5-B8 also ``bound_tc_ms``: the same FMAs
   as three TF32 products each at the 495 TFLOP/s tensor-core peak, or the
   bytes); B3 twice: its per-trip KL (``tr_kl``, the reference) and the
   fused bracket search (``tr_search``, one launch per search, held equal
   to the bit to the host loop around ``tr_kl``);
4. main paths, each through its entry points, with the launch counters
   set to 0 just before it and read just after, and checks on what comes
   out.  Through ``GMMVI.build_from_config`` and ``train_iter`` for 130
   iterations: SAMTRON on the 20-D Student-T mixture (45 components padded
   to 48, 200 samples per component, full covariances, no sample reuse;
   kernels B1, B2, B3's fused search, and B9 in the add heuristic), then
   ZAMTRUX (VIPS: MORE,
   sample reuse at 2.0 x 200 per component, direct weight update; kernels
   B1-B4, B8 and B9) at the same widths, then SAMTRON on the 300-D
   Student-T mixture, ``get_default_config("SAMTRON", "stm300")`` (20
   components padded to 40, 100 fresh and 200 reused samples per
   component; kernels B5-B7 and the whitened trust-region update; 61
   iterations instead of 130 if its step exceeds 150 ms; held to an
   improving ELBO, the runner's estimate).  Then the runner path as the
   quick start runs it: ``GmmviRunner.build_from_config(get_default_config(
   "SAMTRON", "gmm20"))`` and ``iterate_and_log(n)`` for n = 0..1499 (600
   iterations if the median step passes 60 ms): 1 component padded to 24
   and grown by VIPS, 100 fresh and 200 reused samples per component, a
   16,384-sample reservoir; kernels B1-B4 and B9 (the add heuristic over
   the reservoir, two evaluation passes over 2,000 draws every 100
   iterations); held to finite metrics, a rising ELBO, a repad with its
   counts intact and a resume from a checkpoint equal to the bit.  Then
   the rest of the codename matrix: SEPYFUX on stm300,
   ``get_default_config("SEPYFUX", "stm300")`` with nothing cut (20
   components kept in 24 slots, 100 draws a step from the mixture, iBLR
   at the fixed stepsize 1e-5; kernels B5 and B6, not B7; held to fevals
   of exactly 100 a step, a finite state and step 21 on the card equal to
   the same step on the CPU through the plain versions, leaf by leaf at
   B5's bar); SEMIDUG at the flagship widths (45 components kept in 48
   slots, the direct updater, decaying stepsizes, the M letter's reuse;
   kernels B1, B2 and B4, no search; held to 45 components, a finite state
   and an improving fit); SAMTRON with standard importance weights for 30
   iterations (B1, B2, B3's search; held to a finite state and the
   self-normalized run's fevals at every step).  Then the paper's
   experiments through the runner, ``GmmviRunner.build_from_config(
   get_default_config("SAMTRON", e))`` with nothing cut: breast_cancer
   (D = 31, one component in 24 slots grown by VIPS, 1,000 iterations, an
   evaluation every 50; held to an ELBO rising to at least -79.0, the JAX
   package's CPU run of the same config ending at -78.36), german_credit
   (D = 25, 300 iterations; at least -585.6, JAX -585.11), breast_cancer_mb
   (the host-shuffled minibatch target with autograd, 30 iterations; held
   to finite metrics and fevals) and planar_robot_4 (D = 10, 300 initial
   components in Kmax = 600 slots, U = 2,048 background rows, 300
   iterations, 130 if the median step passes 150 ms; held to a mode at
   each of the four goals) and talos (the Talos humanoid's IK posterior,
   D = 34, one component in 24 slots, U = 96, n = 0..500 with evaluations
   at 0 and 500, cut to 0..250 with an evaluation every 250 if the median
   of steps 1-50 passes 150 ms; held to a finite state and an ELBO at the
   last evaluation at or above the floor from the JAX package's CPU runs,
   its B1 and B2 launches at D = 34, through their run-time instance),
   each with B1, B2, B3's search, B4 and B9 launched.  Then wine (the
   11-8-8-1 BNN posterior, D = 177, 4 components in 24 slots, n = 0..200,
   an evaluation every 25; the target keeps a host-side minibatch cursor,
   so every step takes the host-target path): held to finite metrics,
   each step's target call given exactly the next power of two of its
   valid rows, fevals equal to the valid rows, B5, B6 and B7 launched and
   none of B1-B4 or B8, an ELBO at iteration 200 above its first
   evaluation's and at or above its floor, and a ``bi_test_loss`` at or
   below its ceiling (both from the JAX package's CPU runs that end above
   their start).  Then the settings of ``tpu`` and of the adapter that
   take other paths, each through ``GMMVI.build_from_config`` and
   ``train_iter`` or the runner: SAMTRON on stm300 with
   ``trust_region_search: newton`` (61 iterations; B5-B7; its trips a
   step beside the bracket's on the stm300 path), the flagship with
   grid, bracket-eigen and newton (30 iterations each; B1 and B2, not
   B3's search), each held to a rising ELBO and every accepted component's
   exact KL at its eta within 1.1 eps (grid: eps), and the KL of its
   rebuilt float32 factors within the same bar on the flagship and no worse
   than the bracket's on stm300, stm300's settings at D = 1,024 (20
   iterations; no kernel launched, the peak memory printed), the flagship
   ZAMTRUX with ``db_eviction: decimate`` and a 65,536-sample store (130
   iterations; B1, B2, B4, B8; the store within its capacity every step and
   decimated; step 21 again through the plain versions on the card and on
   the CPU in float32 and float64: the database's and integer leaves and
   what the database hands the kernels equal to the CPU's at the one-step
   bar, and every model slot that float32 resolves within 1,000 bars of
   float64) and the gmm20 runner with 1,000 prior samples and without a
   database (300 iterations each; VIPS grows, B9 at the candidates'
   count).  Every path prints its median
   step ms, fevals and launch counts (the new ones also device-to-host
   copies per step, from ``torch.profiler``);
5. every kernel once more, on the inputs of its last launch: B1 and B2 at
   each of their call sizes on each D = 20 path (SAMTRON; ZAMTRUX, B2 over
   the reuse and the total window; the runner, B1 over the GMM target's
   modes and over the model, B2 at two sizes), each row with its path,
   sizes and equal bits on two calls; in the ZAMTRUX run B3's per-trip KL
   (at the etas its last search found), B4 and B8 (the data decides how
   much work they do); in the stm300 run B5 at each of its six call sizes
   (B9's two among them) and in the runner run B9 at its two call sizes;
   and B3's fused search on its last inputs on each D <= 64 path
   (SAMTRON, ZAMTRUX, the runner); on the new paths B1 and B2 (SEMIDUG,
   standard-IW SAMTRON), B4 at both sizes (SEMIDUG), B5 and B6 (SEPYFUX)
   and B3's fused search (standard-IW SAMTRON); B5-B7 on stm300 with
   newton, B1 and B2 on the new D = 20 paths, B4 and B8 on the
   decimating path, B9 on the gmm20 variants; on the paper's experiments
   and talos B1, B2 and B3's fused search at each call size, B4 at both
   and B9 at each; on wine B5 at each entry and call size, B6 and B7;
   each against its plain version at the bar of phase 3, timed as there.
   One rule on every path (``float64_form_ok``): where a B1, B2, B3, B5
   or B6 row misses that fixed bar, it is held entry by entry against the
   plain version in float64 within the bar plus the entry's first-order
   float32 error bound (B3: its per-trip KL at every eta the search
   visited), and passes only if the kernel meets the bar against float64
   itself or the float32 plain version misses it too (the row then shows
   both counts): on the paper's posteriors float32 rounding of log
   densities of 1e3-1e9 moves a gradient by up to 1e4 bars in any
   float32 arithmetic;
6. diagonal covariances: SAMTRON with ``get_default_config("SAMTRON",
   "stm300")``'s settings and ``use_diagonal_covs`` on the 300-D diagonal
   GMM target, through ``GMMVI.build_from_config`` and ``train_iter`` for
   130 iterations; held to no kernel launch (a diagonal model is plain
   torch, as in the JAX package), a finite state, a rising ELBO and step
   21 on the card equal to the same step on the CPU, leaf by leaf at the
   one-step bar (rtol 1e-4 / atol 1e-5); then the MNIST BNN (D = 101,770,
   diagonal SEMTRON built by the registry's ``MNIST``, on
   ``mnist.npz`` where one is found, else on the JAX package's synthetic
   stand-in, ``GMMVI_ALLOW_SYNTHETIC=1`` for this phase's loads; its
   ``mnist_data`` line says which): ``mnist_jax_test``, the JAX
   package's own MNIST test configuration (1 component, 4 samples, batch
   32) for 30 steps, held to no launch, a finite state, means that moved,
   step 21 against the CPU (leaf by leaf at the one-step bar; a leaf that
   misses it passes only where the card meets the bar against the float64
   step or float32 on the CPU misses it too) and the target's rows of that
   step against the CPU's float32 evaluation of the same rows and against
   float64 within their first-order float32 bound; ``mnist_wide``, the
   port's load configuration (8 components of 128 samples, as many
   reused, batch 128) for 30 steps, held to no launch, a finite state and
   means that moved; each prints its median step, the target's share,
   copies per step, the peak memory, the ELBO and the target's metrics;
   then every ``examples_torch/`` script as a user runs it, for 20
   iterations (the meshed one with two ranks over gloo), each held to exit
   0 and a finite last ELBO, with its seconds and kernel launches;
7. meshes (``mesh_phases``): seven runs of ranks in fresh processes
   (``parallel.mesh.spawn``), every rank on cuda:0, through
   ``GMMVI.build_from_config`` / ``GmmviRunner.build_from_config`` with
   the mesh from the config's ``tpu`` section, each printing one
   ``{"phase": "mesh"}`` line (ranks, backend, layout, median step ms,
   fevals, the ELBO after step 1 and at the end, collectives and bytes
   per step, the ``PhaseTimers`` split, launches per step per rank) with
   the replicated state's hash equal on every rank after every step: M1
   the flagship SAMTRON on the global ring, two ranks over gloo, 30 steps,
   step 1 held to the unmeshed step on the card from the same state and
   draws (leaf by leaf at rtol 1e-4 / atol 1e-5, equal fevals); M2 the
   same on the sharded ring (``db_layout: auto``), each rank's first
   window held to its block of the one-process ``[2, ...]`` form's
   (samples, masks, slots and iterations exactly, the rest at the bar);
   M3 the flagship ZAMTRUX on the sharded ring, 40 steps (B8's partials
   all-reduced); M4 the flagship SAMTRON on a 2 x 2 ``("data", "comp")``
   mesh, four ranks, 10 steps (B3 on 24-component slices), step 1 held as
   M1's; M5 stm300 on the sharded ring, 20 steps (B5-B7, B7's partial
   all-reduced; its ranks then run phase 8's M5); M6 the gmm20 runner with ``tpu: {data_shards: 2}`` and 4
   slots, 150 steps (grown to 16 slots), a checkpoint after step 125
   resumed by fresh ranks and held equal to the bit at the end; M7 the
   flagship SAMTRON with ``data_shards: 1`` over NCCL, step 1 held as
   M1's (its bits compared too).  M2, M3, M5 and M6 are held to a rising
   ELBO.  Then B1 and B2 at a data rank's 4,800 rows and B3's search on a
   comp rank's 24 components against their plain versions, with bounds;
8. compact (``compact_phase``): ``tpu.compact_target_eval`` on and off
   on four paths, the flagship ZAMTRUX (30 steps), the gmm20 runner config
   (30), planar_robot_4 (20) and M5 in two ranks over gloo (10), each
   pair of instances built from the same seed and stepped in lockstep:
   every step of the on instance is run again by the off instance from
   the same state with the same draws, and the off state's means and log
   weights are held to the on state's at the one-step bar (rtol 1e-4 /
   atol 1e-5), with equal fevals.  One ``{"phase": "compact"}`` line per
   path and setting: rows per target call (mean, last) beside the valid
   rows, device-to-host copies per step, the median step, the target's
   median device ms and share of a step, fevals, launches per step; one
   ``{"phase": "compact_check"}`` line per path, which also fails the run
   where, past the first step, a bucket holds more than twice the valid
   rows (the largest rank's) while that count is above the ladder's
   floor, where no step's bucket is smaller than the proposal, or where
   the off setting evaluates fewer rows than the proposal's;
9. interface (``interface_phase``): the target interface at the
   flagship widths, SAMTRON on the registry's 20-D Student-T mixture
   (``use_log_density_and_grad`` True: its analytic gradient) and on an
   ``LNPDF`` subclass with only ``log_density`` wrapping it (False: the
   optimizer's autograd), both built through the package's top-level
   ``configs`` and ``init_experiment``, 30 steps in lockstep (each
   autograd step from the analytic run's state with the same draws): log
   densities equal to the bit, gradients within 1e-4 of the largest
   analytic entry, means, factors and log weights at the one-step bar,
   equal fevals, B1, B2 and B3 launched on every step of both runs.

Then one ``{"kernels": [...]}`` line (each kernel's ``launches`` from the
path that runs it: SAMTRON for B1-B3, ZAMTRUX for B4 and B8, stm300 for
B5-B7, the runner for B9; the ``paths`` of B1-B7 and B9: their numbers
on each path's last inputs; ``mesh_launches_per_step_per_rank`` on M1-M7
and ``rank_shape``, B1's, B2's and B3's numbers at a rank's shapes; each
path's own counts are in its line), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero before that line.  Without a CUDA card it exits 1.  The script
runs itself with ``PYTHONHASHSEED=0`` (re-executing if it was not set so),
since the wine target orders its minibatches by ``hash(("bnn", seed))``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# the kernels on the tensor cores (3xTF32 wgmma): source, kernel function
TENSOR_CORE_KERNELS = {"densities_large": ("density_large.cu",
                                           "large_comp_kernel"),
                       "density_grads_large": ("density_large.cu",
                                               "large_grad_kernel"),
                       "stein_smom": ("stein.cu", "stein_mma_kernel"),
                       "more_grams": ("more.cu", "more_mma_kernel")}

MAIN_ITERS = 130
D, KMAX, K0, N_DES = 20, 48, 45, 200
REUSED = 2 * N_DES                       # ratio_reused_samples_to_desired 2.0
N_WINDOW = KMAX * (REUSED + N_DES)       # 28,800: the total window
U_BACKGROUND = min(4 * KMAX, 2048)       # 192: max_background_dists
# the D = 20 paths with the M letter's reuse
REUSE_PATHS = ("ZAMTRUX", "SEMIDUG")
# standard importance weights at the flagship widths: its iterations
STANDARD_IW_ITERS = 30
# the paths of B1 and B2 (D <= 128), and of the fused search (D <= 64)
DENSITY_PATHS = ("SAMTRON", "ZAMTRUX", "gmm20", "SEMIDUG",
                 "SAMTRON-standard-IW", "breast_cancer", "german_credit",
                 "breast_cancer_mb", "planar_robot_4", "talos")
SEARCH_PATHS = ("SAMTRON", "ZAMTRUX", "gmm20", "SAMTRON-standard-IW",
                "breast_cancer", "german_credit", "breast_cancer_mb",
                "planar_robot_4", "talos")
# stm300 (SAMTRON's defaults): Kmax 40 = max(2 x 20, 20 + 16) rounded to 8,
# 100 fresh and 200 reused samples per component
D_LARGE, KMAX_LARGE, N_DES_LARGE = 300, 40, 100
N_REUSE_LARGE = KMAX_LARGE * 2 * N_DES_LARGE            # 8,000
N_LARGE = N_REUSE_LARGE + KMAX_LARGE * N_DES_LARGE      # 12,000
U_LARGE = min(4 * KMAX_LARGE, 2048)                     # 160
LARGE_STEP_MS_CAP, LARGE_ITERS_CUT = 150.0, 61
# SEPYFUX on stm300: 20 components kept in 24 slots, 100 draws a step from
# the mixture; after step 20 the next step runs on the card and again on
# the CPU through the plain versions, leaves held at B5's bar
KMAX_SEPYFUX, SEPYFUX_COMPARED_STEP = 24, 20
STEP_RTOL, STEP_ATOL = 2e-4, 2e-3
BUILD_DIR = Path(__file__).resolve().parent / "build"
# the runner path: get_default_config("SAMTRON", "gmm20") as the quick start
# runs it, 1,500 iterations (600 if the median step passes 60 ms)
RUNNER_ITERS, RUNNER_STEP_MS_CAP, RUNNER_ITERS_CUT = 1500, 60.0, 600
RUNNER_RESUME_STEPS = 20
N_EVAL, N_CANDIDATES = 2000, 16384      # B9's two call sizes on that path
# the paper's experiments through the runner, get_default_config("SAMTRON",
# experiment) with nothing cut: iterations, and (D, Kmax, n_des, reused,
# max_background_dists, log_metrics_interval) as built
PAPER_PATHS = {
    "breast_cancer": (1000, (31, 24, 100, 200, 96, 50)),
    "german_credit": (300, (25, 24, 100, 200, 96, 20)),
    "breast_cancer_mb": (30, (31, 24, 100, 200, 96, 20)),
    "planar_robot_4": (300, (10, 600, 100, 200, 2048, 10)),
    "talos": (501, (34, 24, 100, 200, 96, 500)),
}
PLANAR_STEP_MS_CAP, PLANAR_ITERS_CUT = 150.0, 130
# talos: n = 0..250 with an evaluation every 250 if the median of steps
# 1-50 passes 150 ms
TALOS_STEP_MS_CAP, TALOS_ITERS_CUT, TALOS_INTERVAL_CUT = 150.0, 251, 250
# wine through the runner, get_default_config("SAMTRON", "wine") with
# nothing cut: n = 0..200, and (D, Kmax, n_des, reused,
# max_background_dists, log_metrics_interval) as built
WINE_ITERS, WINE_SHAPE = 201, (177, 24, 100, 200, 96, 25)


def floor_from_runs(values) -> float:
    """The lowest of the reference runs less their spread."""
    return min(values) - (max(values) - min(values))


# the JAX package's CPU runs of talos at start seeds 10000 to 10005
# (scripts/jax_experiment_reference.py --seed S): the ELBO at iteration
# 500.  Six seeds, not three: the JAX run at seed 10003 ends at 9.73,
# below the floor of seeds 10000-10002 (10.20)
TALOS_JAX_ELBO = (10.698097229003906, 11.198522567749023, 10.944807052612305,
                  9.731943130493164, 10.915525436401367, 11.677129745483398)
# the JAX package's CPU runs of wine at start seeds 10000 to 10011 with
# PYTHONHASHSEED=0 (the BNN's batch order follows it; PYTHONHASHSEED=0
# scripts/jax_experiment_reference.py --experiment wine --iters 201 --seed
# S): per seed the ELBO at the first evaluation (n = 0) and at n = 200,
# and bi_test_loss at 200
WINE_JAX_RUNS = {
    10000: (-89962.0555267334, -4678.126907348633,
            0.7181400656700134),
    10001: (-33378.00126647949, -10794.971145629883,
            0.7492539286613464),
    10002: (-44887.10607910156, -39231.145736694336,
            0.9883115291595459),
    10003: (-56394.299865722656, -6037.522552490234,
            0.7246685028076172),
    10004: (-52663.51387023926, -10347.961959838867,
            0.7557579278945923),
    10005: (-49234.77323913574, -24234.215118408203,
            2.154249668121338),
    10006: (-24604.391052246094, -8560.81575012207,
            0.7929320335388184),
    10007: (-37457.68522644043, -9421.151550292969,
            0.8596848845481873),
    10008: (-26068.436630249023, -5991.946441650391,
            0.7125679850578308),
    10009: (-37068.815338134766, -3412.9412841796875,
            0.7626389265060425),
    10010: (-53931.68991088867, -45288.90370178223,
            1.5897871255874634),
    10011: (-75501.66415405273, -13724.023162841797,
            1.0074678659439087),
}
# a wine run whose bi_test_loss at 200 is at or above this is an
# excursion: the method makes them in 15-30% of runs in every arithmetic
# (the JAX package's on the CPU, the port's plain versions on the CPU and
# on the card, its kernels on the card)
WINE_EXCURSION_LOSS = 1.0


def wine_sound_runs():
    """The JAX runs of wine that are not excursions: (ELBO at 200,
    bi_test_loss).  The bars are set from these; a heavy tail of
    excursions would otherwise put the ELBO floor below the runs' start."""
    return [(e, loss) for _, e, loss in WINE_JAX_RUNS.values()
            if loss < WINE_EXCURSION_LOSS]


# the last evaluation's ELBO must reach these: the JAX package's CPU runs
# of the same config (scripts/jax_experiment_reference.py) end at -78.36
# (breast_cancer, iteration 950) and -585.11 (german_credit, 280); talos's
# and wine's are the lowest of their (sound) runs less their spread, and
# wine's bi_test_loss must stay at or below the highest plus the spread
ELBO_FLOOR = {"breast_cancer": -79.0, "german_credit": -585.6,
              "talos": floor_from_runs(TALOS_JAX_ELBO),
              "wine": floor_from_runs([e for e, _ in wine_sound_runs()])}
WINE_TEST_LOSS_CEILING = -floor_from_runs(
    [-loss for _, loss in wine_sound_runs()])
# B1/B2's unrolled instances cover D <= this (gmmvi_tpu_torch/csrc/
# density.cu, MAX_UNROLLED_D); 33 <= D <= 128 runs the run-time instance
MAX_UNROLLED_D = 32
# diagonal SAMTRON: stm300's defaults with diagonal covariances on the
# 300-D diagonal GMM target; step 21 on the card against the CPU at the
# one-step bar
DIAG_COMPARED_STEP, DIAG_RTOL, DIAG_ATOL = 20, 1e-4, 1e-5


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


def bound_tc_ms(fmas: float) -> float:
    """The least time of ``fmas`` float32 multiply-adds taken as three TF32
    tensor-core products each (3xTF32), at the dense TF32 peak."""
    return 3 * 2 * fmas / PEAK_TF32_FLOPS * 1e3


def sass_phase() -> dict:
    """``cuobjdump --dump-sass`` of the built libraries: the count of
    ``HGMMA`` (the SASS form of wgmma) in each tensor-core kernel's
    function; fails where there is none."""
    from gmmvi_tpu_torch.ops import cuda

    tool = Path(cuda._nvcc()).parent / "cuobjdump"
    counts = {}
    for name, (source, function) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run(
            [str(tool), "--dump-sass", str(cuda._lib_path(source))],
            check=True, capture_output=True, text=True, timeout=300).stdout
        funcs = [f for f in sass.split("Function : ")[1:]
                 if function in f.splitlines()[0]]
        counts[name] = sum(line.count("HGMMA") for f in funcs
                           for line in f.splitlines())
    out = {"phase": "sass", "hgmma": counts}
    emit(out)
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"no HGMMA in the SASS of {missing}")
    return out


# the plain versions make [rows, N, D] intermediates; above this many
# elements they run over slices of the samples (each sample's outputs are
# its own) and are timed with fewer calls
PLAIN_SLICE_ELEMS = 1 << 30
# float32's unit roundoff; the float64 references of the kernel rows
# run over slices of the samples of at most this many [K, n, D] elements
U32 = 2.0 ** -24
BOUND_SLICE_ELEMS = 1 << 26


def plain_runner(plain, args, rows: int):
    """``(fn, reps, sliced)``: ``plain`` on ``args`` (samples last, ``rows``
    mixture rows), over slices of the samples where the whole
    intermediate would pass ``PLAIN_SLICE_ELEMS`` elements (outputs
    concatenated along the samples: a single ``[N]`` output, or B1's and
    B2's ``(comp [rows, N], model [N], grads [N, D])``), and the device_ms
    repetitions to time it with."""
    import torch

    x = args[-1]
    n, d = x.shape
    if rows * n * d <= PLAIN_SLICE_ELEMS:
        return (lambda: plain(*args)), dict(), False
    step = max(1, PLAIN_SLICE_ELEMS // (rows * d))

    def sliced():
        parts = [plain(*args[:-1], x[lo:lo + step])
                 for lo in range(0, n, step)]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts)
        return tuple(torch.cat(p, dim=1 if i == 0 else 0)
                     for i, p in enumerate(zip(*parts)))
    return sliced, dict(reps=3, batch=2), True


def max_err(got, want, atol: float, rtol: float):
    """(max |got - want|, whether every entry is within atol + rtol|want|);
    raises when there is nothing to compare."""
    import torch

    if got.numel() == 0:
        raise AssertionError("an empty comparison: nothing was checked")
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.abs()))
    return float(diff.max()), ok


def density_inputs(dev, d: int = D, n: int = KMAX * N_DES, seed: int = 1,
                   scattered: bool = False):
    """A main-path-shaped mixture at D = ``d`` (45 of 48 slots active,
    means ~ 100, covariances 300 (A A^T / d + 0.2 I)) and ``n`` samples
    drawn from its 48 slots in slot order, as a path's sample database
    holds them, or (``scattered``) in a random order."""
    import torch

    g = torch.Generator().manual_seed(seed)
    k = KMAX
    means = torch.randn(k, d, generator=g) * 100.0
    a = torch.randn(k, d, d, generator=g)
    covs = 300.0 * (a @ a.mT / d + 0.2 * torch.eye(d))
    chols = torch.linalg.cholesky(covs)
    inv_chols = torch.linalg.solve_triangular(chols, torch.eye(d).expand(
        k, d, d), upper=False)
    logw = torch.full((k,), -math.log(K0))
    logw[K0:] = -math.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp_of = torch.arange(n) * k // n
    eps = torch.randn(n, d, generator=g)
    x = means[comp_of] + torch.einsum("nij,nj->ni", chols[comp_of], eps)
    if scattered:
        x = x[torch.randperm(n, generator=g)]
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


def tr_search_inputs(dev):
    """The fused search's inputs on ``tr_inputs``'s components: KL bounds
    in [1e-3, 1], half the components cold-started (the bracket [-20, 80])
    and half warm (the updater's bracket around a last eta in [1e-2,
    1e3]), the last three slots inactive."""
    import torch

    _, inp = tr_inputs(dev)
    g = torch.Generator().manual_seed(8)
    k = KMAX
    bound = 10.0 ** (torch.rand(k, generator=g) * 3.0 - 3.0)
    log_last = torch.log(10.0 ** (torch.rand(k, generator=g) * 5.0 - 2.0))
    cold = torch.arange(k) % 2 == 0
    lower0 = torch.where(cold, -20.0, torch.clamp(log_last - 3.0, min=0.0))
    upper0 = torch.where(cold, 80.0, log_last + 3.0)
    active = torch.arange(k) < k - 3
    return (inp, *[t.to(dev).contiguous() for t in (bound, lower0, upper0,
                                                    active)])


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


def more_inputs(dev, scattered: bool = False):
    """The MORE fit of the reuse path: K = 48 slots of which 45 are active,
    N = 28,800 window samples drawn from them in the window's order (runs
    of 200 per component), self-normalized importance weights of each
    active slot against the mixture (zero for the inactive ones), and
    outputs on the scale of log ratios.  ``scattered``: the same window
    shuffled with a fixed generator, so that the zero weights lie
    scattered through it as on the path (runs of 200 let whole 32-sample
    slabs die, which the path's window does not)."""
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
    if scattered:
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
        x, y, w = x[perm], y[perm], w[:, perm]
    return [t.to(dev).contiguous() for t in (inv_chols, means, w, y, x)]


def measure_background(args) -> dict:
    """B4 on ``args`` against its plain version: the error (-inf in the same
    places, atol 2e-4 + rtol 1e-4 elsewhere, equal bits on two calls),
    device times and the bound these inputs need."""
    import torch

    from gmmvi_tpu_torch.ops import background as bops

    plain, reps, sliced = plain_runner(bops.background_logpdf_plain, args,
                                       args[0].shape[0])
    got = bops.background_logpdf(*args)
    want = plain()
    same_bits = bool(torch.equal(got, bops.background_logpdf(*args)))
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
    return dict(max_abs_err=err, ok=ok and same_bits, same_bits=same_bits,
                rows=u, live_rows=live, samples=n,
                ms=device_ms(lambda: bops.background_logpdf(*args)),
                plain_ms=device_ms(plain, **reps), plain_sliced=sliced,
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
    # reported, not held (``solve_ok``): none may be solved on both sides
    quad_err = lin_err = None
    quad_ok = lin_ok = False
    if bool(solved.any()):
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
    fmas = pairs * (f * (f + 1) / 2 + f + tri)
    nbytes = 4 * (k * (tri + d) + k * n + n + n * d + k * f * f + k * f)
    b_ms, b_by = bound_ms(2 * fmas, nbytes)
    again = mops.more_grams(*args)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(again[0], gram) and torch.equal(again[1],
                                                                  rhs))
    dead = (args[2] == 0).all(1)
    dead_zero = bool((gram[dead] == 0).all() and (rhs[dead] == 0).all())
    return dict(max_abs_err=float((gram - gram_p).abs().max()),
                ok=max(rel) <= 2e-5 and same_bits and dead_zero,
                same_bits=same_bits, dead_exact_zero=dead_zero,
                gram_rel_err=rel[0], rhs_rel_err=rel[1],
                solve_ok=quad_ok and lin_ok, solved=int(solved.sum()),
                quad_abs_err=quad_err, lin_abs_err=lin_err, components=k,
                samples=n, features=f, weighted_pairs=pairs,
                ms=device_ms(lambda: mops.more_grams(*args)),
                plain_ms=device_ms(lambda: mops.more_grams_plain(*args),
                                   reps=5, batch=4),
                bound_ms=b_ms, bound_by=b_by,
                bound_tc_ms=max(bound_tc_ms(fmas),
                                nbytes / PEAK_BYTES_PER_S * 1e3))


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

    rows = []
    # the window in runs of 200 per component (the row of the kernels
    # line), then shuffled: scattered zero weights, as on the path
    for scattered in (False, True):
        args = more_inputs(dev, scattered)
        b8 = dict(
            name="more_grams", route="cuda",
            source="gmmvi_tpu_torch/csrc/more.cu",
            replaces="gmmvi_tpu/ops/pallas_more.py:61",
            inputs="scattered" if scattered else "runs",
            tolerance="Gram and rhs within 2e-5 of each component's largest "
                      "entry, equal bits on two calls, exact zeros without "
                      "weight; solved quad atol 2e-4 + rtol 2e-3 and lin "
                      "atol 2e-3 + rtol 2e-3 at ridge 1e-12",
            **measure_more(args),
            call_ms=call_ms(lambda: mops.more_grams(*args), reps=20),
            library_ms=None,
            library="none: no single PyTorch call whitens by each component "
                    "and builds its quadratic-feature Gram")
        emit({"phase": "kernel", **b8})
        if not (b8["ok"] and b8["solve_ok"] and b8["solved"] == K0):
            raise AssertionError(
                f"more_grams disagrees with its plain version: Gram "
                f"{b8['gram_rel_err']}, rhs {b8['rhs_rel_err']}, quad "
                f"{b8['quad_abs_err']}, lin {b8['lin_abs_err']} over "
                f"{b8['solved']} solved fits, equal bits "
                f"{b8['same_bits']}, zeros {b8['dead_exact_zero']}")
        rows.append(b8)
    return [b4, rows[0]]


def density_check(got, again, want) -> dict:
    """B1's or B2's outputs ``got`` against the plain version's ``want``:
    every finite reference entry within atol 5e-4 + rtol 1e-5 (its max
    |error| and the worst error over that bar), NaN, +inf and -inf in the
    same places, and equal bits with a second call's ``again``."""
    import torch

    err, worst, within, places = 0.0, 0.0, True, True
    for gv, wv in zip(got, want):
        for where in (torch.isnan, torch.isposinf, torch.isneginf):
            places &= torch.equal(where(gv), where(wv))
        fin = torch.isfinite(wv)
        e, ok = max_err(gv[fin], wv[fin], atol=5e-4, rtol=1e-5)
        bar = 5e-4 + 1e-5 * wv[fin].abs()
        worst = max(worst, float(((gv[fin] - wv[fin]).abs() / bar).max()))
        err, within = max(err, e), within and ok
    equal_bits = all(torch.equal(gv, av) for gv, av in zip(got, again))
    return dict(max_abs_err=err, worst_over_bar=worst, places=places,
                equal_bits=equal_bits, ok=within and places and equal_bits)


def density_bound(name, args, want) -> dict:
    """The least time of B1 (``density_pack``) or B2 (``densities``) on
    ``args``, given the plain version's outputs ``want``: each input read
    once (only the lower triangle of the factors is used), each output
    written once; FMAs: the whitening y = L (x - mu) of every sample by
    every slot, and for B1's gradient L^T y once more for each (sample,
    slot) pair whose responsibility is nonzero (the others add nothing,
    and the kernel skips them)."""
    import torch

    means, _, logw, _, x = args
    (k, d), n = means.shape, x.shape[0]
    grads = name == "density_pack"
    tri = d * (d + 1) / 2
    nbytes = 4 * (k * d + k * tri + 2 * k + n * d
                  + k * n + n + (n * d if grads else 0))
    pairs = 0
    if grads:
        comp, model = want[0], want[1]
        resp = torch.exp(comp + logw[:, None] - model[None, :])
        pairs = int(((resp > 0) & (logw > -math.inf)[:, None]).sum())
    b_ms, b_by = bound_ms(2 * tri * (n * k + pairs), nbytes)
    return dict(bound_ms=b_ms, bound_by=b_by,
                **({"responsible_pairs": pairs} if grads else {}))


def float64_form_ok(check: dict, outputs=None) -> bool:
    """The one rule for a kernel that misses its fixed bar against its
    plain version: ``check``, its comparison with the plain version in
    float64 (entry by entry within the bar plus the entry's first-order
    float32 bound), passes only if the kernel meets the bar itself there
    or the float32 plain version misses the bar against float64 too
    (float32 cannot meet it on these inputs).  ``outputs``: the per-output
    dicts of ``check`` (B1, B2, B5), else ``check`` alone (B3's visited
    KLs, B6)."""
    parts = list(outputs.values()) if outputs else [check]
    kernel = sum(o["beyond_bar"] for o in parts)
    plain = sum(o["plain_beyond_bar"] for o in parts)
    return bool(check["ok"]) and (kernel == 0 or plain > 0)


def measure_density(name, args) -> dict:
    """B1 (``density_pack``) or B2 (``densities``) on ``args`` against its
    plain version at the fixed bar (``density_check``); where the kernel
    misses it, against the plain version in float64
    (``density_vs_float64``) under ``float64_form_ok``; device times and
    the bound these inputs need (``density_bound``)."""
    import torch

    from gmmvi_tpu_torch.ops import density as dops

    fn = getattr(dops, name)
    means, _, logw, _, x = args
    plain, reps, sliced = plain_runner(getattr(dops, name + "_plain"), args,
                                       means.shape[0])
    got = fn(*args)
    again = fn(*args)
    want = plain()
    torch.cuda.synchronize()
    check = density_check(got, again, want)
    if not check["ok"]:
        fixed = check
        check = density_vs_float64(args, got, again, want)
        check.update(fixed_bar=fixed, ok=float64_form_ok(
            check, check["against_float64"]))
    return dict(**check, components=means.shape[0], d=means.shape[1],
                live_components=int((logw > -math.inf).sum()),
                samples=x.shape[0], **density_bound(name, args, want),
                ms=device_ms(lambda: fn(*args)),
                plain_ms=device_ms(plain, **reps), plain_sliced=sliced)


def gamma(n: int) -> float:
    """The bound n u / (1 - n u) on the relative error of n float32
    roundings in a row (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., section 3.1)."""
    return n * U32 / (1 - n * U32)


def density_float64(args, grads: bool, product_u: int = 1):
    """The plain version of B1 (``grads``) or B2 in float64 on ``args``,
    and per output entry ``s``, the first-order bound of how far float32
    arithmetic on these inputs can move it through what the outputs
    amplify, whatever the order of its sums: each whitened coordinate
    y = L (x - mu) is off by at most gamma(D+1) (|L| |x - mu|), so a log
    density by s_comp = gamma(D+1) sum |y| |L||x - mu| + gamma(D) q/2 +
    gamma(3) (q/2 + |const|); a responsibility r_k moves by
    r_k (dw_k - sum_j r_j dw_j) with dw_k = s_comp + u (|comp| + |log w|),
    so the gradient by sum_k r_k dw_k |v_k + grad|, v_k = L^T y; each v by
    gamma(D+1) |L|^T |L||x - mu| + gamma(D) |L|^T |y|; and by the rounding
    of the sums, the exponentials, the model's own value (a float32 log
    density of 5e3 is off by up to 2.4e-4) and B1's online rescaling (at
    most K/4 rescales a group and the four groups' combine), gamma(3K + 32)
    + 2u (|w_k - model| + |model|) of sum_k r_k |v_k|.  Runs over slices of
    the samples.  ``product_u``: the roundings, in units of u, of one
    product term of the whitening (1 in fp32 FMA; B5's 3xTF32 products drop
    the product of the operands' low halves and round each low half to
    TF32, up to 12 u of |L||x - mu| more).  Returns ``(refs, bounds)``,
    each (comp, model[, grads])."""
    import torch

    from gmmvi_tpu_torch.ops.density import LOG_2PI
    from gmmvi_tpu_torch.ops.stable import masked_logsumexp

    means, chol, logw, logdet, x = [a.double() for a in args]
    k, d = means.shape
    step = max(1, BOUND_SLICE_ELEMS // (k * d))
    live = (logw > -math.inf)[:, None]
    absl = chol.abs()
    const = (-logdet - 0.5 * d * LOG_2PI)[:, None]
    rho_sums = gamma(3 * k + 32)
    parts = []
    for lo in range(0, x.shape[0], step):
        diff = x[lo:lo + step][None] - means[:, None]            # [K, n, D]
        y = torch.einsum("kij,knj->kni", chol, diff)
        a = torch.einsum("kij,knj->kni", absl, diff.abs())
        q = torch.sum(y * y, -1)
        comp = -0.5 * q + const
        s_comp = gamma(d + product_u) * torch.sum(y.abs() * a, -1) \
            + 0.5 * gamma(d) * q + gamma(3) * (0.5 * q + const.abs())
        w = comp + logw[:, None]
        model = masked_logsumexp(w, mask=live, dim=0)
        r = torch.where(live, torch.exp(w - model), 0.0)
        s_w = torch.where(live, s_comp + U32 * (comp.abs()
                                                + logw.abs()[:, None]), 0.0)
        part = [comp, s_comp, model,
                torch.sum(r * s_w, 0) + gamma(k + 4) + U32 * model.abs()]
        if grads:
            v = torch.einsum("kji,knj->kni", chol, y)
            g = -torch.sum(r[..., None] * v, 0)
            s_v = gamma(d + 1) * torch.einsum("kji,knj->kni", absl, a) \
                + gamma(d) * torch.einsum("kji,knj->kni", absl, y.abs())
            rho = rho_sums + 2 * U32 * torch.where(
                live, (w - model).abs() + model.abs(), 0.0)
            part += [g, torch.sum(r[..., None] * (
                s_w[..., None] * (v + g).abs() + s_v
                + rho[..., None] * v.abs()), 0)]
        parts.append(part)
    cols = [torch.cat(c, 1 if i < 2 else 0)
            for i, c in enumerate(zip(*parts))]
    return cols[0::2], cols[1::2]


def density_vs_float64(args, got, again, want, labels=None,
                       atol: float = 5e-4, rtol: float = 1e-5,
                       product_u: int = 1) -> dict:
    """B1's or B2's outputs ``got`` held entry by entry against the plain
    version in float64 on the same inputs: |got - ref| <= bar + s, the bar
    atol 5e-4 + rtol 1e-5 of ``ref`` and ``s`` the entry's float32 bound
    (``density_float64``); NaN, +inf and -inf in ``ref``'s places, and
    equal bits with a second call's ``again``.  On the paper's posteriors
    the log densities of samples far out in a component's tail reach
    1e3-1e5, and float32 rounding of two components' shares of such a
    sample moves the mixture gradient by up to 1e4 bars in any float32
    arithmetic; there ``s`` is large, elsewhere it is a fraction of the
    bar.  The float32 plain version ``want`` is held to the same bound,
    a check of the bound.  Per output: the kernel's max |error|, its and
    the plain version's worst error over the bound, the entries where the
    kernel misses the bar, those whose bound passes the bar and the
    bound's median over the bar.  ``labels`` name the outputs ``got``
    holds (B5's mixture-only entry: ("model",)), ``atol``/``rtol`` the bar
    (B5's: 2e-3 / 2e-4), ``product_u`` as in ``density_float64``."""
    import torch

    labels = labels or ("comp", "model", "grads")[:len(got)]
    refs, bounds = density_float64(args, "grads" in labels, product_u)
    named = dict(zip(("comp", "model", "grads"), zip(refs, bounds)))
    out, ok, places = {}, True, True
    for label, gv, pv in zip(labels, got, want):
        rv, sv = named[label]
        for where in (torch.isnan, torch.isposinf, torch.isneginf):
            places &= torch.equal(where(gv), where(rv))
        fin = torch.isfinite(rv)
        if not bool(fin.any()):
            raise AssertionError("an empty comparison: nothing was checked")
        rv, sv = rv[fin], sv[fin]
        bar = atol + rtol * rv.abs()
        tol = bar + sv
        ek = (gv[fin].double() - rv).abs()
        ep = (pv[fin].double() - rv).abs()
        out[label] = dict(
            max_abs_err=float(ek.max()),
            worst_over_bound=float((ek / tol).max()),
            plain_worst_over_bound=float((ep / tol).max()),
            beyond_bar=int((ek > bar).sum()),
            plain_beyond_bar=int((ep > bar).sum()),
            bound_beyond_bar=int((sv > bar).sum()),
            bound_over_bar_median=float((sv / bar).median()),
            entries=int(fin.sum()))
        ok &= bool((ek <= tol).all()) and bool((ep <= tol).all())
    equal_bits = all(torch.equal(g, a) for g, a in zip(got, again))
    return dict(max_abs_err=max(o["max_abs_err"] for o in out.values()),
                against_float64=out, places=places, equal_bits=equal_bits,
                ok=ok and places and equal_bits)


def kl_fmas(d: int) -> float:
    """FMAs of one trust-region KL evaluation at D = d: the Cholesky's
    trailing-triangle updates d^3/6, the forward solve of the d x d
    right-hand side O^T d^3/2, and ~3 d^2 for the rest (forming P's lower
    triangle, the two vector solves, the trace and Mahalanobis sums)."""
    return d ** 3 / 6 + d ** 3 / 2 + 3 * d * d


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
    flops = 2 * n_feas * kl_fmas(d)
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


def measure_tr_search(args) -> dict:
    """The fused search (B3, one launch) on ``args`` = (inputs, bounds,
    lower0, upper0, active): its etas (exp(lower), exp(upper)) and trips
    equal, bit for bit, to the host loop around B3's per-trip kernel and
    to a second call (``ok``), and against the plain version (the host loop
    around ``tr_kl_plain``) the number of components whose result differs
    (``differ_from_plain``: a KL within the plain version's 1e-4 agreement
    of a threshold can send a bracket the other way; held to at most one)
    and the largest |difference| of exp(lower) there.  Where more than one
    component differs, the per-trip KL is held instead at every eta the
    search visited (``visited_kl_vs_float64``) under ``float64_form_ok``.
    Device ms per search (``ms``);
    ``plain_ms`` and ``host_loop_ms``, the host loops' time per search
    (their syncs included).  The bound counts this run's trips: per trip a
    KL evaluation's FMAs (as ``measure_tr_kl``), the inputs read once."""
    import torch

    from gmmvi_tpu_torch.ops import trust_region as tops

    inp = args[0]

    def host_loop(per_component_trips: bool = False):
        return tops.bracket_search(lambda e: tops.tr_kl(e, inp), *args[1:],
                                   per_component_trips=per_component_trips)

    got = tops.tr_search(*args)
    again = tops.tr_search(*args)
    loop = host_loop(per_component_trips=True)
    plain = tops.tr_search_plain(*args)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    equal_loop = all(torch.equal(a, b) for a, b in zip(got, loop))
    differ = torch.zeros_like(got[2], dtype=torch.bool)
    for a, b in zip(got, plain):
        differ |= ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    n_differ = int(differ.sum())
    err = float((got[0] - plain[0]).abs().max())
    fixed_ok = n_differ <= 1
    visited = {} if fixed_ok else visited_kl_vs_float64(args)
    k, d = inp.means.shape
    trips = got[2].to(torch.float64)
    flops = 2 * float(trips.sum()) * kl_fmas(d)
    b_ms, b_by = bound_ms(flops, 4 * (k * (3 * d * (d + 1) / 2 + 3 * d + 4)
                                      + 3 * k) + k)
    close = fixed_ok or float64_form_ok(visited)
    return dict(max_abs_err=err, ok=same_bits and equal_loop and close,
                same_bits=same_bits, equal_to_host_loop=equal_loop,
                differ_from_plain=n_differ,
                **{f"visited_kl_{key}": v for key, v in visited.items()},
                components=k, active=int(args[4].sum()),
                trips_max=int(got[2].max()), trips_sum=int(got[2].sum()),
                ms=device_ms(lambda: tops.tr_search(*args)),
                plain_ms=device_ms(lambda: tops.tr_search_plain(*args),
                                   reps=5, batch=4),
                host_loop_ms=device_ms(host_loop, reps=5, batch=4),
                bound_ms=b_ms, bound_by=b_by)


def kl_float64(etas, inp):
    """The plain version of B3 in float64 at ``etas`` and per component
    ``s``, the first-order bound of how far float32 arithmetic on these
    inputs can move the KL, each error taken through the KL's exact
    derivative (computed here in float64) so that what cancels in the KL
    cancels in the bound.  Forming A = prec + R / eta and the Cholesky
    factor L of it give the exact factor of A + E, |E| <= M = u |A| +
    2u |R| / eta + gamma(D+1) |L| |L^T|, which moves log|A| + tr(A^-1
    P_old) by at most sum |A^-1 - A^-1 P_old A^-1| o M (nearly nothing
    where the new component is close to the old); the substitution
    (L + dL_j) x_j = o_j of the trace's X = L^-1 O^T, |dL_j| <= gamma(D)
    |L|, moves it by 2 gamma(D) sum |L^-T X| o |L| |X|; the new mean
    m = L^-T L^-1 y, y = lin + R_lin / eta, moves the Mahalanobis term by
    2 v . dm, v = P_old (m - mu): through w = A^-1 v by 2 |w| . (dy + M |m|
    + gamma(D) |L| |z|), z = L^-1 y, and through t = L^-1 v by 2 gamma(D)
    |t| . |L^T| |m|; o = O (mu - m) by 2 gamma(D+1) |o| . |O| |mu - m|; and
    the sums: gamma(D^2 + D + 4) of the trace and Mahalanobis terms (both
    versions' orders of summation), gamma(3) of the constant and log|A|,
    2 gamma(D+1) sum |log L_ii|.  Returns ``(kl, s, infeasible)``, the KL
    F32_MAX where eta <= 0 or A is not positive definite in float64."""
    import torch

    from gmmvi_tpu_torch.ops import trust_region as tops

    def mv(a, v):
        return torch.einsum("kij,kj->ki", a, v)

    prec, rq, lin, rl, old, mu, const = [t.double() for t in inp]
    e = etas.double()
    d = mu.shape[1]
    inv_eta = 1.0 / e
    a = prec + rq * inv_eta[:, None, None]
    y = lin + rl * inv_eta[:, None]
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (e <= 0) | (info != 0)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    chol = torch.where(bad[:, None, None], eye, chol)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                         upper=False)
    a_inv = linv.mT @ linv
    p_old = old.mT @ old
    absl = chol.abs()
    m = U32 * a.abs() + 2 * U32 * rq.abs() * inv_eta[:, None, None] \
        + gamma(d + 1) * absl @ absl.mT
    dy = U32 * y.abs() + 2 * U32 * rl.abs() * inv_eta[:, None]
    x = linv @ old.mT
    trace = torch.sum(x * x, (-2, -1))
    z = mv(linv, y)
    mean = mv(linv.mT, z)
    diff = mu - mean
    v = -mv(p_old, diff)
    od = mv(old, diff)
    maha = torch.sum(od * od, -1)
    logs = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
    logdet = 2 * torch.sum(logs, -1)
    s = 0.5 * (
        torch.sum((a_inv - a_inv @ p_old @ a_inv).abs() * m, (-2, -1))
        + 2 * gamma(d) * torch.sum((linv.mT @ x).abs() * (absl @ x.abs()),
                                   (-2, -1))
        + 2 * torch.sum(mv(a_inv, v).abs() * (
            dy + mv(m, mean.abs()) + gamma(d) * mv(absl, z.abs())), -1)
        + 2 * gamma(d) * torch.sum(mv(linv, v).abs()
                                   * mv(absl.mT, mean.abs()), -1)
        + 2 * gamma(d + 1) * torch.sum(od.abs() * mv(old.abs(),
                                                     diff.abs()), -1)
        + gamma(d * d + d + 4) * (trace + maha)
        + gamma(3) * (const.abs() + logdet.abs())
        + 2 * gamma(d + 1) * torch.sum(logs.abs(), -1))
    kl = 0.5 * (const + logdet + trace + maha)
    return torch.where(bad, tops.F32_MAX, kl), s, bad


def visited_kl_vs_float64(args) -> dict:
    """B3's per-trip KL at every eta the search on ``args`` visits (the
    host loop around the per-trip kernel, which is the fused search to the
    bit), held eta by eta against the plain KL in float64: F32_MAX in the
    float32 plain version's places, and where the KL is feasible in
    float32 and float64, |kl - ref| <= bar + s, the bar atol 1e-4 + rtol
    1e-4 of ``ref`` and ``s`` the float32 bound of ``kl_float64``; the
    float32 plain version is held to the same bound, a check of the bound.
    Returns ``ok``, the evaluations compared, the kernel's and the plain
    version's worst error over the bound, the kernel's evaluations beyond
    the bar, those whose bound passes the bar and the bound's median over
    the bar."""
    import torch

    from gmmvi_tpu_torch.ops import trust_region as tops

    inp, evals = args[0], []

    def recording_kl(etas):
        kl = tops.tr_kl(etas, inp)
        evals.append((etas, kl))
        return kl

    tops.bracket_search(recording_kl, *args[1:])
    etas = torch.stack([e for e, _ in evals])               # [trips, K]
    kls = torch.stack([kl for _, kl in evals])
    want = torch.stack([tops.tr_kl_plain(e, inp) for e, _ in evals])
    ref, s, bad = (torch.stack(t) for t in zip(
        *[kl_float64(e, inp) for e, _ in evals]))
    live = args[4][None, :].expand_as(etas) & torch.isfinite(etas)
    places = torch.equal(kls[live] >= 3e38, want[live] >= 3e38)
    feas = live & (want < 3e38) & ~bad
    if not bool(feas.any()):
        raise AssertionError("an empty comparison: nothing was checked")
    ref, s = ref[feas], s[feas]
    bar = 1e-4 + 1e-4 * ref.abs()
    ek = (kls[feas].double() - ref).abs()
    ep = (want[feas].double() - ref).abs()
    return dict(ok=places and bool((ek <= bar + s).all())
                and bool((ep <= bar + s).all()),
                evaluations=int(feas.sum()), max_abs_err=float(ek.max()),
                worst_over_bound=float((ek / (bar + s)).max()),
                plain_worst_over_bound=float((ep / (bar + s)).max()),
                beyond_bar=int((ek > bar).sum()),
                plain_beyond_bar=int((ep > bar).sum()),
                bound_beyond_bar=int((s > bar).sum()),
                bound_over_bar_median=float((s / bar).median()))


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
    # B3's per-trip entry: the reference of the fused search, off the paths
    emit({"phase": "kernel", **row})
    if not (row["ok"] and row["compared"] == KMAX):
        raise AssertionError(f"tr_kl disagrees with its plain version: "
                             f"{row['max_abs_err']}")

    sargs = tr_search_inputs(dev)
    row = dict(
        name="tr_search", route="cuda",
        source="gmmvi_tpu_torch/csrc/trust_region.cu",
        replaces="gmmvi_tpu/ops/pallas_trust_region.py:65",
        tolerance="exp(lower), exp(upper) and trips equal to the host loop "
                  "around the per-trip kernel and on two calls, bit for "
                  "bit; at most one component other than the plain "
                  "version's",
        **measure_tr_search(sargs),
        call_ms=call_ms(lambda: tops.tr_search(*sargs)), library_ms=None,
        library="none: no single PyTorch call runs a batched bisection")
    emit({"phase": "kernel", **row})
    if not row["ok"]:
        raise AssertionError(f"tr_search disagrees with the host loop or its "
                             f"plain version: {row}")
    rows.append(row)
    return (rows + reuse_kernel_rows(dev) + large_kernel_rows(dev)
            + mixture_logpdf_rows(dev))


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
    sample against its lower triangle.  Where the kernel misses that bar,
    it is held entry by entry against the plain version in float64 within
    the bar plus the entry's first-order float32 bound
    (``density_vs_float64``, with the error of B5's 3xTF32 products), with
    equal bits on a second call, under ``float64_form_ok``."""
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
    check = dict(max_abs_err=max(e[0] for e in errs),
                 ok=ok and all(e[1] for e in errs))
    if not check["ok"]:
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        fixed = check
        check = density_vs_float64(
            args, got, again, want,
            labels=("comp", "model") if len(got) == 2 else ("model",),
            atol=2e-3, rtol=2e-4, product_u=13)
        check.update(fixed_bar=fixed, ok=float64_form_ok(
            check, check["against_float64"]))
    means, _, logw, _, x = args
    (k, d), n = means.shape, x.shape[0]
    comp_out = name == "densities_large"
    rows = k if comp_out else int((logw > -math.inf).sum())
    tri = d * (d + 1) / 2
    nbytes = 4 * (k + rows * (d + tri + 1) + n * d + n
                  + (k * n if comp_out else 0))
    b_ms, b_by = bound_ms(2 * rows * n * tri, nbytes)
    return dict(**check, rows=k, computed_rows=rows,
                samples=n, ms=device_ms(lambda: fn(*args)),
                plain_ms=device_ms(lambda: plain(*args), reps=11, batch=5),
                bound_ms=b_ms, bound_by=b_by,
                bound_tc_ms=max(bound_tc_ms(rows * n * tri),
                                nbytes / PEAK_BYTES_PER_S * 1e3))


def grads_float64(args, product_u: int = 13):
    """B6's plain version in float64 on ``args`` (means, inv_chols, logw,
    comp, model, x; comp and model taken as given) and per entry ``s``, the
    first-order bound of how far float32 arithmetic on these inputs can
    move it, whatever the order of its sums: each v_k = L^T L (x - mu_k)
    by gamma(D + product_u) |L^T| |L| |x - mu| + gamma(D) |L^T| |y| (the
    plain version's two products; the kernel's one product with the
    precision rounded once to float32, in 3xTF32, within the first term);
    each r_k = exp(comp_k + log w_k - model) by r_k (gamma(2) (|comp_k| +
    |log w_k| + |model|) + 2u) (the exponent's rounding, which log
    densities of 1e3-1e9 far out in the tails make large); the sum over the
    slots by gamma(K + product_u) sum_k r_k |v_k|.  A first-order bound
    holds while the exponents' bound is small: a sample is ``determined``
    where it is at most 1/8 (|comp| + |model| up to ~1e6) for every live
    slot whose exponent can come above -87; beyond, float32 rounding of the inputs' log densities (1e7-1e9
    for samples far out in the tails, where one unit in the last place is
    1-100) leaves its responsibilities, and so its gradient, undetermined
    in any float32 arithmetic.  Runs over slices of the samples.  Returns
    ``(ref, s, determined [N])``."""
    import torch

    means, chol, logw, comp, model, x = [a.double() for a in args]
    k, d = means.shape
    step = max(1, BOUND_SLICE_ELEMS // (k * d))
    live = (logw > -math.inf)[:, None]
    absl = chol.abs()
    refs, bounds, determined = [], [], []
    for lo in range(0, x.shape[0], step):
        hi = lo + step
        diff = x[lo:hi][None] - means[:, None]                  # [K, n, D]
        y = torch.einsum("kij,knj->kni", chol, diff)
        v = torch.einsum("kji,knj->kni", chol, y)
        a = torch.einsum("kij,knj->kni", absl, diff.abs())
        s_v = gamma(d + product_u) * torch.einsum("kji,knj->kni", absl, a) \
            + gamma(d) * torch.einsum("kji,knj->kni", absl, y.abs())
        m = model[lo:hi][None, :]
        mask = live & (m > -math.inf)
        r = torch.where(mask, torch.exp(comp[:, lo:hi] + logw[:, None] - m),
                        0.0)
        expo = comp[:, lo:hi] + logw[:, None] - m
        s_exp = gamma(2) * (comp[:, lo:hi].abs() + logw.abs()[:, None]
                            + m.abs()) + 2 * U32
        s_r = torch.where(mask, r * s_exp, 0.0)
        # a slot whose exponent stays below -87 (r below float32's
        # smallest normal) whatever its rounding adds nothing
        loose = mask & (s_exp > 0.125) & (expo + s_exp > -87.0)
        determined.append(~loose.any(0))
        refs.append(-torch.einsum("kn,knd->nd", r, v))
        bounds.append(torch.einsum("kn,knd->nd", r, s_v)
                      + torch.einsum("kn,knd->nd", s_r, v.abs())
                      + gamma(k + product_u)
                      * torch.einsum("kn,knd->nd", r, v.abs()))
    return torch.cat(refs), torch.cat(bounds), torch.cat(determined)


def large_grads_vs_float64(args, got, want) -> dict:
    """B6's ``got`` and the plain version's ``want`` held entry by entry
    against ``grads_float64`` on the samples whose gradient float32
    determines: |got - ref| <= bar + s, the bar atol 2e-3 + rtol 2e-3 of
    ``ref``; on the others (``undetermined_samples``, counted) both finite;
    the kernel's and the plain version's worst error over the bound, the
    entries where each misses the bar, those whose bound passes it and the
    bound's median over the bar."""
    import torch

    ref, s, det = grads_float64(args)
    if not bool(det.any()):
        raise AssertionError("an empty comparison: nothing was checked")
    finite = bool(torch.isfinite(got[~det]).all()) \
        and bool(torch.isfinite(want[~det]).all())
    ref, s, got, want = ref[det], s[det], got[det], want[det]
    bar = 2e-3 + 2e-3 * ref.abs()
    tol = bar + s
    ek = (got.double() - ref).abs()
    ep = (want.double() - ref).abs()
    return dict(ok=bool((ek <= tol).all()) and bool((ep <= tol).all())
                and finite,
                undetermined_samples=int((~det).sum()),
                max_abs_err=float(ek.max()),
                worst_over_bound=float((ek / tol).max()),
                plain_worst_over_bound=float((ep / tol).max()),
                beyond_bar=int((ek > bar).sum()),
                plain_beyond_bar=int((ep > bar).sum()),
                bound_beyond_bar=int((s > bar).sum()),
                bound_over_bar_median=float((s / bar).median()),
                entries=ref.numel())


def measure_large_grads(args) -> dict:
    """B6 on ``args`` (means, inv_chols, logw, comp, model, x) against its
    plain version (rtol and atol 2e-3) and equal bits on two calls; where
    the kernel misses that bar, held entry by entry against float64 within
    the bar plus the entry's first-order float32 bound
    (``large_grads_vs_float64``) under ``float64_form_ok``.  The bound
    counts D^2 FMAs for each (component, sample) pair whose responsibility
    is nonzero (``bound_tc_ms``: as three TF32 products),
    ``live_tile_pairs`` the (component, 64-sample tile) pairs the kernel
    walks."""
    import torch

    from gmmvi_tpu_torch.ops import density_large as dl

    got = dl.density_grads_large(*args)
    again = dl.density_grads_large(*args)
    want = dl.density_grads_large_plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(got, want, atol=2e-3, rtol=2e-3)
    same_bits = bool(torch.equal(got, again))
    extra = {}
    if not ok:
        f64 = large_grads_vs_float64(args, got, want)
        extra = dict(fixed_bar=dict(max_abs_err=err, ok=ok),
                     against_float64=f64)
        err = f64["max_abs_err"]
        ok = float64_form_ok(f64)
    means, _, logw, comp, model, x = args
    (k, d), n = means.shape, x.shape[0]
    resp = torch.exp(comp + logw[:, None] - model[None, :])
    live = ((resp > 0) & (logw > -math.inf)[:, None]
            & (model > -math.inf)[None, :])
    pairs = float(live.sum())
    tiles = -(-n // 64)
    live_tiles = torch.nn.functional.pad(live, (0, tiles * 64 - n)).reshape(
        k, tiles, 64).any(-1)
    nbytes = 4 * (k * (d + d * (d + 1) / 2 + 1) + k * n + n + 2 * n * d)
    b_ms, b_by = bound_ms(2 * pairs * d * d, nbytes)
    return dict(max_abs_err=err, ok=ok and same_bits, same_bits=same_bits,
                **extra, components=k, samples=n, responsible_pairs=pairs,
                live_tile_pairs=int(live_tiles.sum()), sample_tiles=tiles,
                ms=device_ms(lambda: dl.density_grads_large(*args)),
                plain_ms=device_ms(lambda: dl.density_grads_large_plain(*args),
                                   reps=11, batch=5),
                bound_ms=b_ms, bound_by=b_by,
                bound_tc_ms=max(bound_tc_ms(pairs * d * d),
                                nbytes / PEAK_BYTES_PER_S * 1e3))


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
                bound_ms=b_ms, bound_by=b_by,
                bound_tc_ms=max(bound_tc_ms(pairs * d * d),
                                4 * (k * n + 2 * n * d + k * d * d)
                                / PEAK_BYTES_PER_S * 1e3))


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
        tolerance="rtol 2e-3 + atol 2e-3; equal bits on two calls",
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


def mixture_inputs(dev, n: int, d: int = D, k: int = KMAX, live: int = 30,
                   seed: int = 7):
    """B9's inputs as the runner path makes them: a model of ``k`` slots
    of which ``live`` are active (gmm20 grows from 1 to some dozens of
    components in 48 slots), means spread as the GMM target's modes
    (100 (U - 0.5)) with covariances of its scale, and ``n`` samples drawn
    around the active means (the evaluation's draws, the add heuristic's
    reservoir candidates).  Made on the card from a seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    opts = dict(generator=g, device=dev)
    means = 100.0 * (torch.rand(k, d, **opts) - 0.5)
    a = torch.randn(k, d, d, **opts) * 2.0   # gmm20's A ~ 0.1 N(0, 20)
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d, device=dev))
    inv_chols = torch.linalg.solve_triangular(
        chols, torch.eye(d, device=dev).expand(k, d, d), upper=False)
    logw = torch.full((k,), -math.log(live), device=dev)
    logw[live:] = -math.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp = torch.randint(0, live, (n,), **opts)
    x = means[comp] + torch.einsum(
        "nij,nj->ni", chols[comp], torch.randn(n, d, **opts)) * 1.5
    return [t.contiguous() for t in (means, inv_chols, logw, logdets, x)]


def measure_mixture_logpdf(args) -> dict:
    """B9 on ``args`` against its plain version (-inf in the same places,
    rtol and atol 1e-4 elsewhere: the Pallas kernel's bar), device times
    and the bound these inputs need: each live slot whitens every sample
    against its lower triangle.  Above D = 128 the wrapper runs B5."""
    import torch

    from gmmvi_tpu_torch.ops import mixture_logpdf as mops

    plain, reps, sliced = plain_runner(mops.mixture_logpdf_plain, args,
                                       args[0].shape[0])
    got = mops.mixture_logpdf(*args)
    want = plain()
    same_bits = bool(torch.equal(got, mops.mixture_logpdf(*args)))
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err, ok = max_err(got[fin], want[fin], atol=1e-4, rtol=1e-4)
    ok = ok and torch.equal(torch.isneginf(got), torch.isneginf(want))
    (k, d), n = args[0].shape, args[4].shape[0]
    live = int((args[2] > -math.inf).sum())
    tri = d * (d + 1) / 2
    b_ms, b_by = bound_ms(2 * live * n * tri,
                          4 * (k + live * (d + tri + 1) + n * d + n))
    return dict(max_abs_err=err, ok=ok and same_bits, same_bits=same_bits,
                slots=k, live_slots=live, samples=n,
                dims=d, ms=device_ms(lambda: mops.mixture_logpdf(*args)),
                plain_ms=device_ms(plain, **reps), plain_sliced=sliced,
                bound_ms=b_ms, bound_by=b_by)


def mixture_logpdf_rows(dev):
    """B9 at the runner path's two call sizes at D = 20 (the row of the
    kernels line: the add heuristic's 16,384 candidates) and at D = 300,
    where it takes B5 (``chip_smoke``'s stm300 ELBO calls it there)."""
    from gmmvi_tpu_torch.ops import mixture_logpdf as mops

    row = None
    for n, d, k, live in ((N_CANDIDATES, D, KMAX, 30), (N_EVAL, D, KMAX, 30),
                          (N_EVAL, D_LARGE, KMAX_LARGE, 24)):
        args = mixture_inputs(dev, n, d, k, live)
        out = dict(name="mixture_logpdf", route="cuda",
                   source="gmmvi_tpu_torch/csrc/background.cu",
                   replaces="gmmvi_tpu/ops/pallas_kernels.py:53",
                   tolerance="rtol 1e-4 + atol 1e-4; -inf in the same "
                             "places",
                   via="B9" if d <= 128 else "B5 (D > 128)",
                   **measure_mixture_logpdf(args),
                   call_ms=call_ms(lambda: mops.mixture_logpdf(*args)),
                   library_ms=None,
                   library="none: no single PyTorch call computes a "
                           "Gaussian mixture's log-density from its factors")
        emit({"phase": "kernel", **out})
        if not out["ok"]:
            raise AssertionError(f"mixture_logpdf disagrees with its plain "
                                 f"version at N={n}, D={d}: "
                                 f"{out['max_abs_err']}")
        row = row or out
    return [row]


def flagship_config(seed: int = 0, codename: str = "SAMTRON",
                    standard_iw: bool = False) -> dict:
    """SAMTRON on the 20-D Student-T mixture: the flagship workload.  With
    ``codename="ZAMTRUX"`` the same widths under VIPS, with the M letter's
    sample reuse (2.0 x n_des per component); ``"SEMIDUG"`` the same reuse
    with a fixed number of components (45 in 48 slots) and each letter's
    own stepsize defaults.  ``standard_iw``: standard importance weights in
    the estimator and the weight updater."""
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)

    cfg = update_config(get_default_algorithm_config(codename), {
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
                REUSED / N_DES if codename in REUSE_PATHS else 0.0,
        },
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": KMAX},
    })
    if cfg["num_component_adapter_type"] == "adaptive":
        cfg = update_config(cfg, {"num_component_adapter_config": {
            "del_iters": 100, "add_iters": 60, "max_components": KMAX,
            "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0, 200.0,
                                             100.0, 50.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 1024, "num_prior_samples": 0,
        }})
    if cfg["component_stepsize_adapter_type"] == "improvement-based":
        cfg = update_config(cfg, {"component_stepsize_adapter_config": {
            "initial_stepsize": 0.1, "min_stepsize": 0.001,
            "max_stepsize": 1.0,
        }})
    if standard_iw:
        cfg = update_config(cfg, {
            section: {"use_self_normalized_importance_weights": False}
            for section in ("ng_estimator_config", "weight_updater_config")})
    return cfg


def newest_window_mean_lnpdf(db) -> float:
    newest = db.sample_iter.max()
    sel = db.sample_iter == newest
    return float(db.target_lnpdfs[sel].mean())


def elbo(model, target, seed: int = 0):
    """(ELBO, mean target log-density) of ``model`` from the runner's
    estimate (``runner.sample_elbo``: 2,000 draws of the mixture, made on
    the card from ``seed``; temperature 1)."""
    import torch

    from gmmvi_tpu_torch.runner import sample_elbo

    g = torch.Generator(device=model.device).manual_seed(seed)
    metrics, _ = sample_elbo(model, target, 1.0, generator=g)
    return -metrics["-elbo"], metrics["target_density"]


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
    """Keep the arguments of the latest call a reuse path makes to B4's
    wrapper at each call size (under ("background_logpdf", N): the ESS
    pass over the reuse window, the finalize pass over the total window)
    and to B8's."""
    from gmmvi_tpu_torch.optimization import ng_estimators, sample_window

    return [recording(captured, sample_window, "background_logpdf",
                      key=lambda args: ("background_logpdf",
                                        args[4].shape[0])),
            recording(captured, ng_estimators, "more_grams")]


def capture_density_inputs(densities: dict, path: str):
    """Keep the arguments of the latest B1 and B2 launch at each call size
    on ``path`` in ``densities``, under (name, path, K, N): B2's two call
    sites on the reuse paths (the ESS pass over the reuse window, the
    weight update over the total window) and B1's two on the runner (the
    GMM target's modes, the model's slots) differ in size."""
    from gmmvi_tpu_torch.ops import density

    def key(name):
        return lambda args: (name, path, args[0].shape[0], args[4].shape[0])

    return [recording(densities, density, name, key=key(name))
            for name in ("density_pack", "densities")]


def watch_search(searches: dict, path: str, trips: list):
    """Replace the updater's fused search by a wrapper that keeps its
    latest arguments in ``searches[path]`` and each call's trips [K] (a
    device tensor, read at the end: no host sync) in ``trips``, and calls
    it as before; returns the undo."""
    from gmmvi_tpu_torch.optimization import component_updaters

    fn = component_updaters.tr_search

    def call(*args):
        searches[path] = args
        out = fn(*args)
        trips.append(out[2])
        return out

    component_updaters.tr_search = call
    return lambda: setattr(component_updaters, "tr_search", fn)


def lockstep_trips(trips: list) -> list:
    """Per search, the trips its slowest component took: the trips of the
    lockstep host loop the fused search replaces."""
    import torch

    return torch.stack([t.max() for t in trips]).tolist() if trips else []


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


def main_path_phase(dev, path, kernel_names, searches, densities,
                    captured=None, fevals_at=None):
    """``path``'s iterations through the entry points (130; 30 for
    standard importance weights), the launch counters set to 0 just before
    and read just after; the last fused search's inputs go to
    ``searches[path]``, the last B1 and B2 launches' at each size to
    ``densities``; with ``captured``, the inputs of the last B4 launch at
    each size and of the last B8 launch go there.  ``path``: SAMTRON or
    ZAMTRUX (the flagship widths under VIPS), SEMIDUG (45 components kept
    in 48 slots, the direct updater, decaying stepsizes, the M letter's
    reuse) or SAMTRON-standard-IW (standard importance weights, held to
    ``fevals_at``: the self-normalized run's fevals after each step).
    Returns the launch counts and the fevals after each step."""
    import torch

    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    standard_iw = path == "SAMTRON-standard-IW"
    codename = "SAMTRON" if standard_iw else path
    iters = STANDARD_IW_ITERS if standard_iw else MAIN_ITERS
    target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                         device=dev)
    cfg = flagship_config(codename=codename, standard_iw=standard_iw)
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    # record each step's reused-sample count and fevals (device tensors,
    # read at the end, so the record adds no host sync)
    reused, fevals = [], []
    propose = gmmvi._propose_phase

    def recording_propose(state, draws):
        prop = propose(state, draws)
        reused.append(prop.num_reused)
        return prop

    gmmvi._propose_phase = recording_propose
    trips: list = []
    restore = [watch_search(searches, path, trips),
               *capture_density_inputs(densities, path)]
    if captured is not None:
        restore += capture_last_inputs(captured)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    step_s = []
    for _ in range(iters):
        t0 = time.perf_counter()
        gmmvi.train_iter()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        fevals.append(gmmvi.state.db.num_samples_written)
        if len(step_s) == 1:
            start_lnpdf = newest_window_mean_lnpdf(gmmvi.state.db)
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()

    st = gmmvi.state
    num_active = int(st.model.num_active)
    end_lnpdf = newest_window_mean_lnpdf(st.db)
    means_finite = bool(torch.isfinite(st.model.means[:num_active]).all())
    state_finite = model_finite(st)
    reused = [int(r) for r in reused]
    fevals = [int(f) for f in fevals]
    search_trips = lockstep_trips(trips)
    step_ms = sum(step_s[1:]) / (iters - 1) * 1e3
    out = dict(
        phase="main_path", path=path, codename=codename, iterations=iters,
        first_step_s=step_s[0], step_ms=step_ms,
        median_step_ms=statistics.median(step_s[1:]) * 1e3,
        samples_per_s=KMAX * N_DES / (step_ms / 1e3),
        trips_per_step=sum(search_trips) / iters,
        search_launches_per_step=launches["tr_search"] / iters,
        launches=launches, num_active=num_active, fevals=fevals[-1],
        num_reused_mean=sum(reused) / len(reused),
        num_reused_min_after_3=min(reused[4:]),
        window_mean_target_lnpdf_start=start_lnpdf,
        window_mean_target_lnpdf_end=end_lnpdf, means_finite=means_finite,
        state_finite=state_finite,
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if not (means_finite and state_finite):
        raise AssertionError(f"a non-finite state after the {path} path")
    if not 1 <= num_active <= KMAX:
        raise AssertionError(f"num_active {num_active} outside [1, {KMAX}]")
    if codename == "SEMIDUG" and num_active != K0:
        raise AssertionError(f"fixed adaptation ended with {num_active} "
                             f"components, not {K0}")
    for name in kernel_names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} path")
    if launches["tr_kl"] != 0:
        raise AssertionError(f"the per-trip KL launched {launches['tr_kl']} "
                             f"times on the {path} path")
    # the direct updater (I) has no stepsize search; the ESS pass over the
    # reuse window launches B2 and B4 once more a step
    wanted = {"density_pack": iters, "densities": iters,
              "tr_search": iters}
    if codename in REUSE_PATHS:
        wanted.update(densities=2 * iters, background_logpdf=2 * iters)
        if not min(reused[4:]) > 0:
            raise AssertionError("no sample was reused after iteration 3")
    if codename == "ZAMTRUX":
        wanted.update(more_grams=iters)
    if codename == "SEMIDUG":
        del wanted["tr_search"]
        if launches["tr_search"] != 0:
            raise AssertionError("the stepsize search launched on the "
                                 "direct updater's path")
    for name, least in wanted.items():
        if launches[name] < least:
            raise AssertionError(f"{name}: {launches[name]} launches < "
                                 f"{least} on the {path} path")
    if standard_iw:
        # no reuse, no add before iteration 60 and no delete before 100:
        # every step draws n_des for each of the 45 components, as the
        # self-normalized run does
        if fevals != fevals_at[:iters]:
            raise AssertionError(f"standard-IW fevals {fevals} differ from "
                                 f"the self-normalized run's "
                                 f"{fevals_at[:iters]}")
    elif not end_lnpdf > start_lnpdf:
        raise AssertionError(f"mean target log-density did not improve: "
                             f"{start_lnpdf} -> {end_lnpdf}")
    return launches, fevals


def model_finite(state) -> bool:
    """The active components' parameters and the meta-state's float leaves
    finite (the histories start at the float32 minimum, a finite value)."""
    import torch

    k = int(state.model.num_active)
    m, meta = state.model, state.meta
    leaves = [m.log_weights[:k], m.means[:k], m.chols[:k], m.inv_chols[:k],
              meta.stepsizes, meta.reward_history, meta.weight_history,
              meta.l2_regularizers, state.wstep.stepsize]
    return all(bool(torch.isfinite(t).all()) for t in leaves)


def main_path_input_rows(captured, search_args) -> None:
    """B3's per-trip KL (at the etas the last search found) and B8 once
    more on the inputs of their last launch in the ZAMTRUX run, against
    their plain versions at the kernel phase's bar; fails on a miss.  The
    solved MORE terms are reported, not held: on the main path's data the
    ridge-1e-12 fit may be ill-conditioned."""
    from gmmvi_tpu_torch.ops import trust_region as tops

    found = tops.tr_search(*search_args)[0]
    measures = [("tr_kl", (found, search_args[0]),
                 lambda a: measure_tr_kl(*a)),
                ("more_grams", captured["more_grams"], measure_more)]
    for name, args, measure in measures:
        out = measure(args)
        emit({"phase": "kernel_on_main_path_inputs", "name": name, **out})
        if not out["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the main path's inputs: {out}")


PATH_FIELDS = ("samples", "components", "live_components", "d", "rows",
               "live_rows", "computed_rows", "responsible_pairs",
               "live_tile_pairs", "max_abs_err", "equal_bits", "same_bits",
               "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms")


def background_path_rows(captured, path: str) -> dict:
    """B4 once more on the inputs of its last launch at each call size on
    a reuse path (``captured`` from :func:`capture_last_inputs`), held as
    in the kernel phase; fails on a miss or where it never launched.
    Returns per "path U=.. N=.." its numbers."""
    out = {}
    for key in sorted(k for k in captured if isinstance(k, tuple)
                      and k[0] == "background_logpdf"):
        row = measure_background(captured[key])
        emit({"phase": "kernel_on_main_path_inputs", "path": path,
              "name": "background_logpdf", **row})
        if not row["ok"]:
            raise AssertionError(f"background_logpdf disagrees with its "
                                 f"plain version on the {path} path's "
                                 f"inputs: {row}")
        out[f"{path} U={row['rows']} N={row['samples']}"] = {
            f: row[f] for f in PATH_FIELDS if f in row}
    if len(out) != 2:
        raise AssertionError(f"expected B4 at two call sizes on the {path} "
                             f"path, got {sorted(out)}")
    return out


def density_path_rows(densities: dict) -> dict:
    """B1 and B2 once more on the inputs of their last launch at each call
    size on each path, held as in the kernel phase (``measure_density``);
    fails on a miss or where a path ran either kernel never.  Returns per kernel, per
    "path K=.. N=..", its numbers."""
    out: dict = {"density_pack": {}, "densities": {}}
    for key in sorted(densities):
        name, path, k, n = key
        row = measure_density(name, densities[key])
        emit({"phase": "kernel_on_main_path_inputs", "path": path,
              "name": name, **row})
        if not row["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {path} path's inputs: {row}")
        out[name][f"{path} K={k} N={n}"] = {
            f: row[f] for f in PATH_FIELDS if f in row}
        if path == "talos" and not MAX_UNROLLED_D < row["d"] <= 128:
            raise AssertionError(f"{name} on talos at D = {row['d']}, not "
                                 f"through the run-time instance")
    for name, rows in out.items():
        for path in DENSITY_PATHS:
            if not any(label.startswith(path + " ") for label in rows):
                raise AssertionError(f"no {name} launch recorded on the "
                                     f"{path} path")
    return out


LARGE_KERNELS = ("densities_large", "density_grads_large", "stein_smom")


def search_rows(searches: dict) -> dict:
    """The fused search once more on the inputs of its last launch on each
    D <= 64 path, held as in the kernel phase (``measure_tr_search``);
    fails on a miss.  Returns
    per path its device ms, trips and equality with the host loop."""
    out = {}
    for path in SEARCH_PATHS:
        row = measure_tr_search(searches[path])
        emit({"phase": "kernel_on_main_path_inputs", "path": path,
              "name": "tr_search", **row})
        if not row["ok"]:
            raise AssertionError(f"tr_search disagrees on the {path} path's "
                                 f"inputs: {row}")
        out[path] = {k: row[k] for k in ("ms", "trips_max", "trips_sum",
                                         "equal_to_host_loop",
                                         "differ_from_plain",
                                         "host_loop_ms")}
    return out


def large_d_phase(dev, captured):
    """SAMTRON on stm300 through the entry points, from
    ``get_default_config("SAMTRON", "stm300")`` as the JAX package's
    scripts build it: 130 iterations (61 if the step exceeds 150 ms over
    iterations 2-11), the launch counters set to 0 just before and read
    just after; the inputs of the last B5 (per call size), B6 and B7
    launches go to ``captured``.  Every accepted component's KL over its
    bound is watched between steps (``watch_updates``), and the slot whose
    rebuilt float32 factors carry the largest is replayed on the CPU
    (``rebuild_witness``)."""
    import torch

    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.ops import cuda
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
    # each step's reused-sample count (a device tensor, read at the end),
    # bisection trips (a host count) and accepted KLs over their bounds
    reused, trips, kl_ratios = [], [], []
    propose = gmmvi._propose_phase

    def recording_propose(state, draws):
        prop = propose(state, draws)
        reused.append(prop.num_reused)
        return prop

    gmmvi._propose_phase = recording_propose
    flush, undos = watch_updates(kl_ratios, trips, "stm300")
    restore = [*undos, *capture_large_d_inputs(captured)]

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmmvi.train_iter()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    flush()
    start_lnpdf = newest_window_mean_lnpdf(gmmvi.state.db)
    start_elbo, start_density = elbo(gmmvi.state.model, target)
    iters, step_s, probe_ms = MAIN_ITERS, [], None
    while len(step_s) < iters - 1:
        t0 = time.perf_counter()
        gmmvi.train_iter()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        flush()                     # the KLs, outside the step's time
        if len(step_s) == 10:
            probe_ms = sum(step_s) / 10 * 1e3
            if probe_ms > LARGE_STEP_MS_CAP:
                iters = LARGE_ITERS_CUT
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()

    st = gmmvi.state
    num_active = int(st.model.num_active)
    end_lnpdf = newest_window_mean_lnpdf(st.db)
    end_elbo, end_density = elbo(st.model, target)
    means_finite = bool(torch.isfinite(st.model.means[:num_active]).all())
    reused = [int(r) for r in reused]
    fevals = int(st.db.num_samples_written)
    step_ms = sum(step_s) / len(step_s) * 1e3
    out = dict(
        phase="main_path", codename="SAMTRON", experiment="stm300",
        iterations=iters, cut_to_61=iters != MAIN_ITERS,
        probe_step_ms=probe_ms, first_step_s=first_s, step_ms=step_ms,
        median_step_ms=statistics.median(step_s) * 1e3,
        samples_per_s=KMAX_LARGE * N_DES_LARGE / (step_ms / 1e3),
        fevals=fevals, fevals_per_step=fevals / iters,
        trips_per_step=sum(trips) / iters,
        launches=launches,
        launches_per_step={k: v / iters for k, v in launches.items()},
        num_active=num_active, num_reused_mean=sum(reused) / len(reused),
        num_reused=reused, elbo_start=start_elbo, elbo_end=end_elbo,
        draws_mean_target_lnpdf_start=start_density,
        draws_mean_target_lnpdf_end=end_density,
        window_mean_target_lnpdf_start=start_lnpdf,
        window_mean_target_lnpdf_end=end_lnpdf, means_finite=means_finite,
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
        **kl_summary(kl_ratios),
        worst_rebuild=rebuild_witness(WORST_REBUILD["stm300"]))
    emit(out)
    LINES_12["stm300"] = out
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
    for name in ("density_pack", "densities", "tr_kl", "tr_search",
                 "background_logpdf", "more_grams"):
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


def compare_states(got: dict, want: dict, rtol: float, atol: float
                   ) -> dict:
    """Leaf by leaf: integers equal, floats within ``atol + rtol |want|``
    with NaN and infinities in the same places.  Returns per leaf its
    largest error against the bar's scale (<= 1 holds) and the leaves that
    miss."""
    import numpy as np

    ratios, missed = {}, []
    for name, want_v in want.items():
        got_v = got[name]
        if np.issubdtype(want_v.dtype, np.integer):
            ok = np.array_equal(got_v, want_v)
            ratios[name] = 0.0 if ok else math.inf
        else:
            fin = np.isfinite(want_v)
            ok = np.array_equal(fin, np.isfinite(got_v)) and np.array_equal(
                got_v[~fin], want_v[~fin])
            diff = np.abs(got_v[fin].astype(np.float64) - want_v[fin])
            scale = atol + rtol * np.abs(want_v[fin].astype(np.float64))
            ratios[name] = float((diff / scale).max()) if diff.size else 0.0
            ok = ok and ratios[name] <= 1.0
        if not ok:
            missed.append(name)
    return {"worst": max(ratios.items(), key=lambda kv: kv[1]),
            "ratios": ratios, "missed": missed}


def sepyfux_phase(dev, captured):
    """SEPYFUX on stm300 through the entry points, from
    ``get_default_config("SEPYFUX", "stm300")`` with nothing cut: D = 300,
    20 components kept in 24 slots (E), 100 draws a step from the mixture
    without reuse (P), iBLR (Y) at the fixed stepsize 1e-5 (F), the direct
    weight update (U) at the fixed stepsize 1 (X); 130 iterations (61 if
    the step exceeds 150 ms over iterations 2-11), the launch counters set
    to 0 just before and read just after; the inputs of the last B5 and B6
    launches go to ``captured``.  Holds: fevals exactly 100 a step, a
    finite state, B5 and B6 launched and B7 not (N = 100 < 512, the JAX
    package's route rule), and step 21 on the card equal to the same step
    from the same state and draws on the CPU (the plain versions): integer
    leaves exact, float leaves within B5's bar, rtol 2e-4 / atol 2e-3 (the
    step's floats follow B5's densities and B6's gradients: the iBLR step
    moves a component by 1e-5 of its estimate, the weight update moves the
    log weights by the expected log ratios, B5's output)."""
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch import StepDraws
    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_config("SEPYFUX", "stm300")
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    sel = gmmvi.selector_cfg
    shape = (model.num_dimensions, model.max_components, int(
        model.num_active), sel.kind, sel.desired_samples_per_component,
        sel.reused_samples_per_component, gmmvi.vips_cfg,
        gmmvi.component_stepsize_cfg["initial_stepsize"])
    if shape != (D_LARGE, KMAX_SEPYFUX, 20, "mixture-based", N_DES_LARGE, 0,
                 None, 1e-5):
        raise AssertionError(f"SEPYFUX on stm300 built as {shape}")
    restore = capture_large_d_inputs(captured)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    iters, step_s, fevals = MAIN_ITERS, [], []
    before = after = draws = None
    while len(step_s) < iters:
        t0 = time.perf_counter()
        if len(step_s) == SEPYFUX_COMPARED_STEP:
            before = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
            draws = gmmvi.draw(gmmvi.num_updates)
            t0 = time.perf_counter()
            gmmvi.train_iter(draws)
        else:
            gmmvi.train_iter()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        fevals.append(gmmvi.state.db.num_samples_written)
        if before is not None and after is None:
            after = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
        if len(step_s) == 11 and statistics.median(step_s[1:]) * 1e3 \
                > LARGE_STEP_MS_CAP:
            iters = LARGE_ITERS_CUT
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()

    st = gmmvi.state
    fevals = [int(f) for f in fevals]
    state_finite = model_finite(st)
    # the same step on the CPU, through the plain versions
    cpu_target, cpu_model, cpu_meta = init_experiment(cfg, device="cpu")
    cpu = GMMVI.build_from_config(cfg, cpu_target, cpu_model, cpu_meta,
                                  device="cpu")
    cpu.state = gmmvi_tpu_torch.state_from_numpy(before, device="cpu",
                                                 like=cpu.state)
    cpu.train_iter(StepDraws(**{
        f: None if v is None else v.cpu()
        for f, v in vars(draws).items()}))
    cmp = compare_states(after, gmmvi_tpu_torch.state_to_numpy(cpu.state),
                         STEP_RTOL, STEP_ATOL)
    step_ms = sum(step_s[1:]) / (iters - 1) * 1e3
    out = dict(
        phase="main_path", path="SEPYFUX", codename="SEPYFUX",
        experiment="stm300", iterations=iters, cut_to_61=iters != MAIN_ITERS,
        first_step_s=step_s[0], step_ms=step_ms,
        median_step_ms=statistics.median(step_s[1:]) * 1e3,
        samples_per_s=N_DES_LARGE / (step_ms / 1e3), fevals=fevals[-1],
        fevals_per_step=sorted(set(b - a for a, b in
                                   zip([0] + fevals, fevals))),
        launches=launches,
        launches_per_step={k: v / iters for k, v in launches.items()},
        num_active=int(st.model.num_active), state_finite=state_finite,
        card_vs_cpu_step=SEPYFUX_COMPARED_STEP + 1,
        card_vs_cpu_bar=f"rtol {STEP_RTOL} / atol {STEP_ATOL}",
        card_vs_cpu_worst=cmp["worst"], card_vs_cpu_missed=cmp["missed"],
        card_vs_cpu_ratios={k: v for k, v in cmp["ratios"].items()
                            if v > 0},
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if fevals != [N_DES_LARGE * (i + 1) for i in range(iters)]:
        raise AssertionError(f"SEPYFUX fevals are not 100 a step: {fevals}")
    if not state_finite:
        raise AssertionError("a non-finite state after the SEPYFUX path")
    if out["num_active"] != 20:
        raise AssertionError(f"fixed adaptation ended with "
                             f"{out['num_active']} components")
    if not (launches["densities_large"] >= 2 * iters
            and launches["density_grads_large"] >= iters):
        raise AssertionError(f"B5/B6 launches {launches} on the SEPYFUX "
                             f"path")
    for name in ("stein_smom", "density_pack", "densities", "tr_kl",
                 "tr_search", "background_logpdf", "more_grams",
                 "mixture_logpdf"):
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 "on the SEPYFUX path")
    if cmp["missed"]:
        raise AssertionError(f"the card's step {SEPYFUX_COMPARED_STEP + 1} "
                             f"differs from the CPU's in {cmp['missed']}: "
                             f"{cmp['ratios']}")
    return launches


def large_d_input_rows(captured, path: str = "stm300") -> dict:
    """B5 at each of its call sizes, B6 and B7 once more on the inputs of
    their last launch in a D = 300 run (or wine's, D = 177), against their
    plain versions at the kernel phase's bars; fails on a miss.  On stm300
    B5's sizes are the step's four (the pack and the weight update over the
    total window, the ESS pass over the reuse window, the background over U
    ring rows at both) and B9's two through B5 (the add heuristic's
    reservoir candidates, the ELBO estimate's draws); on wine the same
    entries at its sizes (its window grows with its components); on
    SEPYFUX one (the pack and the weight update over the step's 100
    draws), without B7.  Returns per kernel, per "path [entry] K=.. N=..",
    its numbers."""
    keys = sorted(k for k in captured if isinstance(k, tuple))
    if path == "wine":
        if {k[0] for k in keys} != {"densities_large",
                                    "mixture_logpdf_large"} \
                or "density_grads_large" not in captured \
                or "stein_smom" not in captured:
            raise AssertionError(f"expected B5 (both entries), B6 and B7 "
                                 f"on wine, got {sorted(captured, key=str)}")
    elif path in ("stm300", "stm300_newton"):
        step_sizes = {(k[0], k[2]) for k in keys} & {
            ("densities_large", N_REUSE_LARGE), ("densities_large", N_LARGE),
            ("mixture_logpdf_large", N_REUSE_LARGE),
            ("mixture_logpdf_large", N_LARGE)}
        if len(step_sizes) != 4 or len(keys) != 6:
            raise AssertionError(f"expected B5 at four step sizes and B9's "
                                 f"two, got {keys}")
    elif keys != [("densities_large", KMAX_SEPYFUX, N_DES_LARGE)] \
            or "stein_smom" in captured:
        raise AssertionError(f"expected B5 at K = {KMAX_SEPYFUX}, N = "
                             f"{N_DES_LARGE} alone and no B7 on the {path} "
                             f"path, got {keys}, {sorted(captured, key=str)}")
    measures = [("densities_large",
                 f"{path} {key[0]} K={key[1]} N={key[2]}",
                 lambda key=key: measure_large_density(key[0], captured[key]))
                for key in keys]
    measures += [("density_grads_large", path, lambda: measure_large_grads(
        captured["density_grads_large"]))]
    if path in ("stm300", "stm300_newton", "wine"):
        measures += [("stein_smom", path,
                      lambda: measure_stein(captured["stein_smom"]))]
    out: dict = {}
    for name, label, measure in measures:
        row = measure()
        emit({"phase": "kernel_on_main_path_inputs", "path": path,
              "name": name, "label": label, **row})
        if not row["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {path} path's inputs: {row}")
        out.setdefault(name, {})[label] = {f: row[f] for f in PATH_FIELDS
                                           if f in row}
    return out


def wine_phase(dev, captured) -> dict:
    """wine through the runner, as a user drives it:
    ``GmmviRunner.build_from_config(get_default_config("SAMTRON",
    "wine"))`` with nothing cut (D = 177, 4 components in 24 slots, 100
    fresh and 200 reused samples each, U = 96 background rows) and
    ``iterate_and_log(n)`` for n = 0..200 (an evaluation every 25), the
    launch counters set to 0 just before and read just after; the inputs
    of the last B5 (per entry and size), B6 and B7 launches go to
    ``captured``.  The BNN target keeps a host-side minibatch cursor, so
    every step takes the host-target path: the valid rows in a
    power-of-two bucket.  Holds: every metric and the state finite; each
    step's target call given exactly min(next power of two of its valid
    rows, Kmax n_des) rows; the fevals the sum of the valid rows; B5, B6
    and B7 launched and none of B1-B4 or B8; the ELBO at iteration 200
    above the first evaluation's (a sound run, ``wine_sound_runs``) and at
    or above ``ELBO_FLOOR["wine"]``, and its ``bi_test_loss`` at or below
    ``WINE_TEST_LOSS_CEILING``."""
    import torch

    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.ops import cuda

    runner = build_runner(dev, get_default_config("SAMTRON", "wine"))
    g, sel = runner.gmmvi, runner.gmmvi.selector_cfg
    target = runner.target_distribution
    shape = (g.model.num_dimensions, g.model.max_components,
             sel.desired_samples_per_component,
             sel.reused_samples_per_component, sel.max_background_dists,
             runner.log_metrics_interval)
    if shape != WINE_SHAPE or target.safe_for_jit:
        raise AssertionError(f"wine built as {shape}, safe_for_jit "
                             f"{target.safe_for_jit}")
    # per step: the valid rows and the row counts of the target's calls
    target_rows, steps = [], []
    target_call = target.log_density_and_grad
    valid_rows = g._eval_valid_rows

    def recording_target(x):
        target_rows.append(x.shape[0])
        return target_call(x)

    def recording_valid_rows(samples, valid):
        first = len(target_rows)
        out = valid_rows(samples, valid)
        steps.append((int(valid.sum()), samples.shape[0],
                      target_rows[first:]))
        return out

    target.log_density_and_grad = recording_target
    g._eval_valid_rows = recording_valid_rows
    restore = capture_large_d_inputs(captured)
    evals, walls = [], []

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for n in range(WINE_ITERS):
        out = runner.iterate_and_log(n)
        walls.append(out["walltime"])
        if "-elbo" in out:
            evals.append(dict(
                iteration=n, elbo=-out["-elbo"],
                target_density=out["target_density"],
                num_components=out["num_components"],
                fevals=out["num_samples"],
                **{k: v for k, v in out.items() if k.startswith("bi_")},
                finite=all(math.isfinite(v) for v in out.values()
                           if isinstance(v, (int, float)))))
            emit({"phase": "paper_eval", "experiment": "wine", **evals[-1]})
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()
    del target.log_density_and_grad, g._eval_valid_rows
    st = g.state
    fevals = int(st.db.num_samples_written)
    bucket_ok = all(rows == [min(1 << max(v - 1, 0).bit_length(), b)]
                    for v, b, rows in steps)
    out = dict(
        phase="main_path", path="wine", codename="SAMTRON",
        experiment="wine", entry="GmmviRunner.iterate_and_log",
        iterations=WINE_ITERS, first_step_s=walls[0],
        median_step_ms=statistics.median(walls[1:]) * 1e3,
        mean_step_ms=sum(walls[1:]) / (WINE_ITERS - 1) * 1e3,
        wall_s=total_s, evaluations=len(evals),
        elbo_start=evals[0]["elbo"], elbo_end=evals[-1]["elbo"],
        fevals=fevals, valid_rows=sum(v for v, _, _ in steps),
        target_rows_in_steps=sum(sum(r) for _, _, r in steps),
        host_target_steps=len(steps), buckets_equal_next_pow2=bucket_ok,
        num_active=int(st.model.num_active), kmax=st.model.max_components,
        launches=launches,
        launches_per_step={k: v / WINE_ITERS for k, v in launches.items()},
        last_eval=evals[-1], elbo_floor=ELBO_FLOOR["wine"],
        test_loss_ceiling=WINE_TEST_LOSS_CEILING,
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if not all(e["finite"] for e in evals) or not model_finite(st):
        raise AssertionError("a non-finite metric or state on wine")
    if len(steps) != WINE_ITERS or not bucket_ok:
        raise AssertionError(f"wine's target calls were not the host-target "
                             f"path's buckets: {steps[:5]} ...")
    if fevals != out["valid_rows"]:
        raise AssertionError(f"wine: fevals {fevals} != the valid rows "
                             f"{out['valid_rows']}")
    for name in LARGE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on wine")
    for name in ("density_pack", "densities", "tr_kl", "tr_search",
                 "background_logpdf", "more_grams"):
        if launches[name] != 0:
            raise AssertionError(f"{name} launched on wine: {launches}")
    last = evals[-1]
    if not (last["iteration"] == WINE_ITERS - 1
            and last["elbo"] > evals[0]["elbo"]
            and last["elbo"] >= ELBO_FLOOR["wine"]
            and last["bi_test_loss"] <= WINE_TEST_LOSS_CEILING):
        raise AssertionError(f"wine's last evaluation {last} is not above "
                             f"the first ({evals[0]['elbo']}) or misses the "
                             f"floor {ELBO_FLOOR['wine']} or the test-loss "
                             f"ceiling {WINE_TEST_LOSS_CEILING}")
    return launches


def runner_config(max_components=None) -> dict:
    """``get_default_config("SAMTRON", "gmm20")`` as the quick start
    builds it; with ``max_components``, a smaller padded capacity."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config

    cfg = get_default_config("SAMTRON", "gmm20")
    if max_components is not None:
        cfg = update_config(cfg, {"tpu": {"max_components": max_components}})
    return cfg


def build_runner(dev, cfg):
    """``GmmviRunner.build_from_config`` on the card, with the target's
    figures off (the card's machine has no matplotlib)."""
    from gmmvi_tpu_torch.runner import GmmviRunner

    runner = GmmviRunner.build_from_config(cfg, device=dev)
    runner.target_distribution.make_plots = False
    return runner


def written_in_order(db):
    """The ring's newest ``min(written, capacity)`` samples (and their
    iterations and target log-densities) in the order they were written."""
    import torch

    written = int(db.write_pos)
    m = min(written, db.capacity)
    pos = torch.arange(written - m, written, device=db.samples.device) \
        % db.capacity
    return db.samples[pos], db.sample_iter[pos], db.target_lnpdfs[pos]


def watch_repads(gmmvi, repads: list) -> None:
    """Record each capacity growth of ``gmmvi`` in ``repads`` (and emit
    it): the capacities before and after, its time, and whether the counts
    (fevals, ring head, reservoir count, components) and the written
    samples in their order came through it unchanged."""
    import torch

    grow = gmmvi.grow_capacity

    def counts(st):
        return (int(st.db.num_samples_written), int(st.db.write_pos),
                int(st.db.res_count), int(st.model.num_active))

    def recording_grow(new_max_components):
        st = gmmvi.state
        before, kept = counts(st), written_in_order(st.db)
        kmax, cap = st.model.max_components, st.db.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grow(new_max_components)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = gmmvi.state
        intact = counts(st) == before and all(
            torch.equal(a, b[len(b) - len(a):])
            for a, b in zip(kept, written_in_order(st.db)))
        repads.append(dict(
            iteration=st.num_updates, kmax_from=kmax,
            kmax_to=st.model.max_components, capacity_from=cap,
            capacity_to=st.db.capacity, fevals=before[0],
            num_active=before[3], counts_intact=intact, ms=ms))
        emit({"phase": "repad", **repads[-1]})

    gmmvi.grow_capacity = recording_grow


def runner_phase(dev, captured, searches, densities):
    """The runner path, as docs/get_started.md runs it:
    ``GmmviRunner.build_from_config(get_default_config("SAMTRON",
    "gmm20"))`` and ``iterate_and_log(n)`` for n = 0..1499 (0..599 if the
    median of steps 1-10 passes 60 ms), the launch counters set to 0 just
    before and read just after; B9's last inputs at each call size go to
    ``captured``, the last fused search's to ``searches["gmm20"]``, the
    last B1 and B2 launches' at each size to ``densities``.  Holds:
    every metric finite, the last evaluation's ELBO
    above the first's, a repad with its counts intact (if the run never
    fills its 24 slots, the same config with 8 slots runs until it
    repads), and resume: a checkpoint saved halfway, loaded into a fresh
    runner, gives the unbroken run's state after 20 more steps, to the
    bit."""
    import numpy as np
    import torch

    from gmmvi_tpu_torch import state_to_numpy
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import mixture_logpdf as mops

    runner = build_runner(dev, runner_config())
    g, sel = runner.gmmvi, runner.gmmvi.selector_cfg
    shape = (g.model.num_dimensions, g.model.max_components,
             sel.desired_samples_per_component,
             sel.reused_samples_per_component,
             g.state.db.reservoir_capacity, runner.log_metrics_interval,
             g.vips_cfg.add_iters, g.vips_cfg.del_iters,
             g.vips_cfg.max_components, g.vips_cfg.num_database_samples)
    if shape != (D, 24, 100, 200, N_CANDIDATES, 100, 30, 100, 1000,
                 N_CANDIDATES):
        raise AssertionError(f"gmm20 built as {shape}")
    trips: list = []
    restore = [recording(captured, mops, "mixture_logpdf",
                         key=lambda args: ("mixture_logpdf",
                                           args[4].shape[0])),
               watch_search(searches, "gmm20", trips),
               *capture_density_inputs(densities, "gmm20")]
    repads, evals, walls = [], [], []
    watch_repads(g, repads)
    path = BUILD_DIR / "runner_resume.npz"
    path.parent.mkdir(parents=True, exist_ok=True)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    iters, probe_ms, snapshot = RUNNER_ITERS, None, None
    resume_at = iters // 2
    t_start = time.perf_counter()
    n = 0
    while n < iters:
        t0 = time.perf_counter()
        out = runner.iterate_and_log(n)
        call_s = time.perf_counter() - t0
        walls.append(out["walltime"])
        if "-elbo" in out:
            evals.append(dict(
                iteration=n, elbo=-out["-elbo"],
                target_density=out["target_density"],
                entropy=out["entropy"], num_components=out["num_components"],
                fevals=out["num_samples"], kmax=g.model.max_components,
                num_detected_modes=out["num_detected_modes"],
                eval_ms=(call_s - out["walltime"]) * 1e3,
                finite=all(math.isfinite(v) for v in out.values()
                           if isinstance(v, (int, float)))))
            emit({"phase": "runner_eval", **evals[-1]})
        if n == 10:
            probe_ms = statistics.median(walls[1:11]) * 1e3
            if probe_ms > RUNNER_STEP_MS_CAP:
                iters = RUNNER_ITERS_CUT
                resume_at = iters // 2
        if n == resume_at:
            runner.save_checkpoint(str(path))
        if n == resume_at + RUNNER_RESUME_STEPS:
            snapshot = state_to_numpy(g.state)
        n += 1
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()
    del g.grow_capacity
    st = g.state
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20

    # resume: the checkpoint into a fresh runner, 20 steps, the same state
    fresh = build_runner(dev, runner_config())
    fresh.load_checkpoint(str(path))
    for m in range(resume_at + 1, resume_at + 1 + RUNNER_RESUME_STEPS):
        fresh.iterate_and_log(m)
    resumed = state_to_numpy(fresh.gmmvi.state)
    differ = {k: (str(resumed[k].shape) if resumed[k].shape != v.shape else
                  float(np.nanmax(np.abs(resumed[k].astype(np.float64)
                                         - v.astype(np.float64)))))
              for k, v in snapshot.items()
              if not np.array_equal(resumed[k], v,
                                    equal_nan=v.dtype.kind == "f")}
    path.unlink()

    small_repads = []
    if not repads:   # never filled its 24 slots: grow from 8 instead
        small = build_runner(dev, runner_config(max_components=8))
        watch_repads(small.gmmvi, small_repads)
        for m in range(600):
            small.iterate_and_log(m)
            if small_repads:
                break

    steps = sorted(walls)
    out = dict(
        phase="main_path", codename="SAMTRON", experiment="gmm20",
        entry="GmmviRunner.iterate_and_log", iterations=iters,
        cut_to_600=iters != RUNNER_ITERS, probe_step_ms=probe_ms,
        first_step_s=walls[0], median_step_ms=statistics.median(steps) * 1e3,
        mean_step_ms=sum(walls[1:]) / (iters - 1) * 1e3,
        wall_s=total_s, evaluations=len(evals),
        eval_ms_median=statistics.median(e["eval_ms"] for e in evals),
        elbo_start=evals[0]["elbo"], elbo_end=evals[-1]["elbo"],
        fevals=int(st.db.num_samples_written),
        num_active=int(st.model.num_active),
        kmax=st.model.max_components, repads=repads,
        repads_from_8_slots=small_repads, launches=launches,
        launches_per_step={k: v / iters for k, v in launches.items()},
        trips_per_step=sum(lockstep_trips(trips)) / iters,
        resume_at=resume_at, resume_steps=RUNNER_RESUME_STEPS,
        resume_exact=not differ, resume_differs=differ,
        peak_mem_mb=peak_mb)
    emit(out)
    if not all(e["finite"] for e in evals):
        raise AssertionError("a runner metric is not finite")
    if not out["elbo_end"] > out["elbo_start"]:
        raise AssertionError(f"the ELBO did not improve: {out['elbo_start']}"
                             f" -> {out['elbo_end']}")
    if not any(r["counts_intact"] for r in repads + small_repads):
        raise AssertionError(f"no repad with its counts intact: "
                             f"{repads + small_repads}")
    if not all(r["counts_intact"] for r in repads + small_repads):
        raise AssertionError(f"a repad broke the counts: {repads}")
    if differ:
        raise AssertionError(f"the resumed run differs from the unbroken "
                             f"one: {differ}")
    for name in ("density_pack", "densities", "tr_search",
                 "background_logpdf", "mixture_logpdf"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "runner path")
    if launches["tr_kl"] != 0:
        raise AssertionError(f"the per-trip KL launched {launches['tr_kl']} "
                             "times on the runner path")
    if launches["mixture_logpdf"] < 2 * len(evals):
        raise AssertionError(f"mixture_logpdf: {launches['mixture_logpdf']}"
                             f" launches < 2 per evaluation")
    return launches


def runner_input_rows(captured) -> None:
    """B9 once more on the inputs of its last launch at each of its call
    sizes on the runner path, against its plain version at the kernel
    phase's bar; fails on a miss."""
    keys = sorted(k for k in captured if isinstance(k, tuple))
    if [k[1] for k in keys] != [N_EVAL, N_CANDIDATES]:
        raise AssertionError(f"expected B9 at N = {N_EVAL} and "
                             f"{N_CANDIDATES}, got {keys}")
    for key in keys:
        out = measure_mixture_logpdf(captured[key])
        emit({"phase": "kernel_on_main_path_inputs", "path": "gmm20 runner",
              "name": f"mixture_logpdf[N={key[1]}]", **out})
        if not out["ok"]:
            raise AssertionError(f"mixture_logpdf disagrees with its plain "
                                 f"version on the runner's inputs: {out}")


def paper_phase(dev, experiment, searches, densities, captured):
    """One of the paper's experiments through the runner, as a user drives
    it: ``GmmviRunner.build_from_config(get_default_config("SAMTRON",
    experiment))`` and ``iterate_and_log(n)`` for the iterations of
    ``PAPER_PATHS`` (planar_robot_4: 130 if the median of steps 1-10 passes
    150 ms; talos: n = 0..250 with an evaluation every 250 if the median
    of steps 1-50 passes 150 ms), the launch counters set to 0 just before
    and read just after.
    The last fused search's inputs go to ``searches[experiment]``, the last
    B1 and B2 launches' at each size to ``densities``, the last B4 and B9
    launches' at each size to ``captured``.  Holds: every metric finite;
    B1, B2, B3's search, B4 and B9 launched and the per-trip KL not; the
    logistic regressions' last ELBO above the first and above
    ``ELBO_FLOOR`` (talos too); the minibatch run's full-batch ELBO finite
    and its fevals rising; planar_robot_4 with a mode at each of its four
    goals at the last evaluation; talos's B1 and B2 through their
    run-time instance (33 <= D <= 128)."""
    import torch

    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import mixture_logpdf as mops
    from gmmvi_tpu_torch.optimization import sample_window

    iters, want_shape = PAPER_PATHS[experiment]
    runner = build_runner(dev, get_default_config("SAMTRON", experiment))
    g, sel = runner.gmmvi, runner.gmmvi.selector_cfg
    shape = (g.model.num_dimensions, g.model.max_components,
             sel.desired_samples_per_component,
             sel.reused_samples_per_component, sel.max_background_dists,
             runner.log_metrics_interval)
    if shape != want_shape:
        raise AssertionError(f"{experiment} built as {shape}")
    trips: list = []
    restore = [recording(captured, mops, "mixture_logpdf",
                         key=lambda args: ("mixture_logpdf",
                                           args[4].shape[0])),
               recording(captured, sample_window, "background_logpdf",
                         key=lambda args: ("background_logpdf",
                                           args[4].shape[0])),
               watch_search(searches, experiment, trips),
               *capture_density_inputs(densities, experiment)]
    repads, evals, walls = [], [], []
    watch_repads(g, repads)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    n = 0
    while n < iters:
        out = runner.iterate_and_log(n)
        walls.append(out["walltime"])
        if "-elbo" in out:
            evals.append(dict(
                iteration=n, elbo=-out["-elbo"],
                target_density=out["target_density"],
                num_components=out["num_components"],
                fevals=out["num_samples"], kmax=g.model.max_components,
                **{k: v for k, v in out.items()
                   if k.startswith(("num_detected_modes", "elbo_fb"))},
                finite=all(math.isfinite(v) for v in out.values()
                           if isinstance(v, (int, float)))))
            emit({"phase": "paper_eval", "experiment": experiment,
                  **evals[-1]})
        if experiment == "planar_robot_4" and n == 10 and statistics.median(
                walls[1:11]) * 1e3 > PLANAR_STEP_MS_CAP:
            iters = PLANAR_ITERS_CUT
        if experiment == "talos" and n == 50 and statistics.median(
                walls[1:51]) * 1e3 > TALOS_STEP_MS_CAP:
            iters = TALOS_ITERS_CUT
            runner.log_metrics_interval = TALOS_INTERVAL_CUT
            emit({"phase": "cut", "experiment": experiment,
                  "median_step_ms_1_50": statistics.median(walls[1:51]) * 1e3,
                  "iterations": iters,
                  "log_metrics_interval": TALOS_INTERVAL_CUT})
        n += 1
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = dict(cuda.LAUNCHES)
    for undo in restore:
        undo()
    del g.grow_capacity
    st = g.state
    # B4's two call sizes at the final capacity (the ESS pass over the reuse
    # window, the finalize pass over the total window)
    kmax, reused = st.model.max_components, sel.reused_samples_per_component
    for key in [k for k in captured if k[0] == "background_logpdf" and k[1]
                not in (kmax * reused,
                        kmax * (reused + sel.desired_samples_per_component))]:
        del captured[key]
    out = dict(
        phase="main_path", path=experiment, codename="SAMTRON",
        experiment=experiment, entry="GmmviRunner.iterate_and_log",
        iterations=iters, cut=iters != PAPER_PATHS[experiment][0],
        first_step_s=walls[0],
        median_step_ms=statistics.median(walls[1:]) * 1e3,
        mean_step_ms=sum(walls[1:]) / (iters - 1) * 1e3, wall_s=total_s,
        evaluations=len(evals), elbo_start=evals[0]["elbo"],
        elbo_end=evals[-1]["elbo"], fevals=int(st.db.num_samples_written),
        num_active=int(st.model.num_active),
        kmax=st.model.max_components, repads=repads, launches=launches,
        launches_per_step={k: v / iters for k, v in launches.items()},
        trips_per_step=sum(lockstep_trips(trips)) / iters,
        last_eval=evals[-1],
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if not all(e["finite"] for e in evals) or not model_finite(st):
        raise AssertionError(f"a non-finite metric or state on {experiment}")
    for name in ("density_pack", "densities", "tr_search",
                 "background_logpdf", "mixture_logpdf"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on "
                                 f"{experiment}")
    if launches["tr_kl"] != 0:
        raise AssertionError(f"the per-trip KL launched on {experiment}")
    if experiment == "talos":
        src = (Path(__file__).resolve().parent / "gmmvi_tpu_torch" / "csrc"
               / "density.cu").read_text()
        if f"MAX_UNROLLED_D = {MAX_UNROLLED_D};" not in src:
            raise AssertionError("density.cu's MAX_UNROLLED_D is not "
                                 f"{MAX_UNROLLED_D}")
        dims = {args[0].shape[1] for key, args in densities.items()
                if key[1] == experiment}
        if not dims or not all(MAX_UNROLLED_D < d <= 128 for d in dims):
            raise AssertionError(f"talos's B1/B2 launches at D = {dims}, "
                                 "not all through the run-time instance")
    if not all(r["counts_intact"] for r in repads):
        raise AssertionError(f"a repad broke the counts: {repads}")
    if experiment in ELBO_FLOOR:
        if not (out["elbo_end"] > out["elbo_start"]
                and out["elbo_end"] >= ELBO_FLOOR[experiment]):
            raise AssertionError(
                f"{experiment}: ELBO {out['elbo_start']} -> "
                f"{out['elbo_end']}, below {ELBO_FLOOR[experiment]}")
    elif experiment == "breast_cancer_mb":
        if not (math.isfinite(evals[-1]["elbo_fb"])
                and evals[-1]["fevals"] > evals[0]["fevals"] > 0):
            raise AssertionError(f"breast_cancer_mb: {evals}")
    else:
        modes = {k: v for k, v in evals[-1].items()
                 if k.startswith("num_detected_modes")}
        if len(modes) != 4 or min(modes.values()) < 1:
            raise AssertionError(f"planar_robot_4 modes at the last "
                                 f"evaluation: {modes}")
    return launches


def paper_input_rows(captured, experiment) -> dict:
    """B4 at its two call sizes and B9 at each of its call sizes once more
    on the inputs of their last launch on one of the paper's experiments,
    held as in the kernel phase; fails on a miss.  Returns per kernel, per
    label, its numbers."""
    out = {"background_logpdf": background_path_rows(captured, experiment),
           "mixture_logpdf": {}}
    for key in sorted(k for k in captured if k[0] == "mixture_logpdf"):
        row = measure_mixture_logpdf(captured[key])
        emit({"phase": "kernel_on_main_path_inputs", "path": experiment,
              "name": "mixture_logpdf", **row})
        if not row["ok"]:
            raise AssertionError(f"mixture_logpdf disagrees with its plain "
                                 f"version on {experiment}: {row}")
        label = f"{experiment} K={row['slots']} N={row['samples']}"
        out["mixture_logpdf"][label] = {
            f: row[f] for f in ("slots", "live_slots", "samples", "dims",
                                "max_abs_err", "same_bits", "ms", "plain_ms",
                                "bound_ms", "bound_by") if f in row}
    if not out["mixture_logpdf"]:
        raise AssertionError(f"no B9 launch recorded on {experiment}")
    return out


def diagonal_config() -> dict:
    """``get_default_config("SAMTRON", "stm300")`` with diagonal covariances
    on the 300-D diagonal GMM target."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config

    cfg = update_config(get_default_config("SAMTRON", "stm300"), {
        "environment_name": "DIAGGMM",
        "model_initialization": {"use_diagonal_covs": True}})
    cfg["environment_config"] = {"num_dimensions": D_LARGE}
    return cfg


def diagonal_phase(dev) -> dict:
    """Diagonal SAMTRON at D = 300 through ``GMMVI.build_from_config`` and
    ``train_iter``: ``diagonal_config()``, nothing else cut (20 components
    in 40 slots, 100 fresh and 200 reused samples each, U = 160 background
    rows, a [R, 40, 300] distribution ring), 130 iterations (61 if the
    step passes 150 ms over iterations 2-11), the launch counters set to 0
    just before and read just after.  Holds: no kernel launched (a
    diagonal model's densities, background and updates are plain torch, as
    in the JAX package), a finite state, the runner's ELBO estimate higher
    at the end than at the start, and step 21 on the card equal to the
    same step from the same state and draws on the CPU, leaf by leaf at
    the one-step bar (integers exact, floats within rtol 1e-4 / atol
    1e-5)."""
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch import StepDraws
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = diagonal_config()
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    sel = gmmvi.selector_cfg
    shape = (model.num_dimensions, model.max_components,
             int(model.num_active), model.diagonal, tuple(model.chols.shape),
             sel.desired_samples_per_component,
             sel.reused_samples_per_component, sel.max_background_dists)
    if shape != (D_LARGE, KMAX_LARGE, 20, True, (KMAX_LARGE, D_LARGE),
                 N_DES_LARGE, 2 * N_DES_LARGE, U_LARGE):
        raise AssertionError(f"diagonal SAMTRON built as {shape}")
    elbo_start, _ = elbo(gmmvi.model, target)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    iters, step_s, fevals = MAIN_ITERS, [], []
    before = after = draws = None
    while len(step_s) < iters:
        if len(step_s) == DIAG_COMPARED_STEP:
            before = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
            draws = gmmvi.draw(gmmvi.num_updates)
            t0 = time.perf_counter()
            gmmvi.train_iter(draws)
        else:
            t0 = time.perf_counter()
            gmmvi.train_iter()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        fevals.append(gmmvi.state.db.num_samples_written)
        if before is not None and after is None:
            after = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
        if len(step_s) == 11 and statistics.median(step_s[1:]) * 1e3 \
                > LARGE_STEP_MS_CAP:
            iters = LARGE_ITERS_CUT
    launches = dict(cuda.LAUNCHES)
    st = gmmvi.state
    elbo_end, _ = elbo(st.model, target)
    state_finite = model_finite(st)

    cpu_target, cpu_model, cpu_meta = init_experiment(cfg, device="cpu")
    cpu = GMMVI.build_from_config(cfg, cpu_target, cpu_model, cpu_meta,
                                  device="cpu")
    cpu.state = gmmvi_tpu_torch.state_from_numpy(before, device="cpu",
                                                 like=cpu.state)
    cpu.train_iter(StepDraws(**{
        f: None if v is None else v.cpu() for f, v in vars(draws).items()}))
    cmp = compare_states(after, gmmvi_tpu_torch.state_to_numpy(cpu.state),
                         DIAG_RTOL, DIAG_ATOL)
    step_ms = sum(step_s[1:]) / (iters - 1) * 1e3
    out = dict(
        phase="main_path", path="SAMTRON-diagonal", codename="SAMTRON",
        experiment="stm300 with diagonal covariances on DIAGGMM D=300",
        iterations=iters, cut_to_61=iters != MAIN_ITERS,
        first_step_s=step_s[0], step_ms=step_ms,
        median_step_ms=statistics.median(step_s[1:]) * 1e3,
        fevals=int(fevals[-1]), num_active=int(st.model.num_active),
        elbo_start=elbo_start, elbo_end=elbo_end, state_finite=state_finite,
        launches=launches, card_vs_cpu_step=DIAG_COMPARED_STEP + 1,
        card_vs_cpu_bar=f"rtol {DIAG_RTOL} / atol {DIAG_ATOL}",
        card_vs_cpu_worst=cmp["worst"], card_vs_cpu_missed=cmp["missed"],
        card_vs_cpu_ratios={k: v for k, v in cmp["ratios"].items()
                            if v > 0},
        peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    emit(out)
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the diagonal path: "
                             f"{launches}")
    if not state_finite:
        raise AssertionError("a non-finite state after the diagonal path")
    if not elbo_end > elbo_start:
        raise AssertionError(f"the diagonal ELBO did not improve: "
                             f"{elbo_start} -> {elbo_end}")
    if cmp["missed"]:
        raise AssertionError(f"the card's step {DIAG_COMPARED_STEP + 1} "
                             f"differs from the CPU's in {cmp['missed']}: "
                             f"{cmp['ratios']}")
    return launches


# ---------------------------------------------------------------------------
# The MNIST BNN on diagonal covariances, and the examples
# ---------------------------------------------------------------------------

# the 784-128-10 classifier's weights: D = 101,770
MNIST_D = 784 * 128 + 128 + 128 * 10 + 10
# the JAX package's own MNIST test (tests/test_bnn_e2e.py): 1 component, 4
# samples, batch 32; the port's load configuration: 8 components of 128
# samples with as many reused (a 2,048-row window), batch 128
MNIST_RUNS = {"mnist_jax_test": {"components": 1, "samples": 4,
                                 "ratio": 0.0, "batch": 32},
              "mnist_wide": {"components": 8, "samples": 128,
                             "ratio": 1.0, "batch": 128}}
MNIST_ITERS, MNIST_COMPARED_STEP = 30, 20
# the compared step's target rows, card against the CPU's float32
# evaluation of the same rows and batches: log densities within atol +
# rtol |ld|, gradients within a fraction of their largest entry (the bars
# of the CPU test against the JAX package)
MNIST_LD_RTOL, MNIST_LD_ATOL, MNIST_GRAD_FRAC = 1e-5, 1e-2, 1e-4
# the stand-in's shapes (train, test, vali rows; pixels; labels)
MNIST_STAND_IN = (6000, 500, 500, 784, 10)
# every example for this many iterations on the card
EXAMPLE_ITERS = 20
EXAMPLE_TIMEOUT_S = 300
_EXAMPLE_WRAPPER = (
    "import atexit, json, runpy, sys\n"
    "from gmmvi_tpu_torch.ops import cuda\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps(cuda.LAUNCHES),"
    " file=sys.stderr, flush=True))\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def mnist_config(run: str) -> dict:
    """SEMTRON on the MNIST BNN with diagonal covariances, built by the
    registry (``environment_name: MNIST``): ``MNIST_RUNS[run]``'s
    components (kept by the E letter, in as many slots), samples per
    component, sample reuse and batch size; the rest as the JAX package's
    MNIST test sets it (prior N(0, 1), stepsize 0.01 in [0.001, 0.1],
    database 1,000)."""
    from gmmvi_tpu_torch.configs import get_default_algorithm_config, \
        update_config

    r = MNIST_RUNS[run]
    return update_config(get_default_algorithm_config("SEMTRON"), {
        "start_seed": 0, "environment_name": "MNIST",
        "environment_config": {"likelihood_scaling": 1.0, "prior_std": 1.0,
                               "batch_size": r["batch"]},
        "model_initialization": {
            "use_diagonal_covs": True,
            "num_initial_components": r["components"], "prior_mean": 0.0,
            "prior_scale": 1.0, "initial_cov": 1.0},
        "use_sample_database": True, "max_database_size": 1000,
        "temperature": 1.0,
        "sample_selector_config": {
            "desired_samples_per_component": r["samples"],
            "ratio_reused_samples_to_desired": r["ratio"]},
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.01, "min_stepsize": 0.001,
            "max_stepsize": 0.1},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": r["components"]}})


def target_cursor(target) -> tuple:
    """A BNN target's batch order, cursor and generator state."""
    return target._order.copy(), target._cursor, target._rng.get_state()


def set_target_cursor(target, cursor: tuple) -> None:
    order, pos, rng = cursor
    target._order, target._cursor = order.copy(), pos
    target._rng.set_state(rng)


def bnn_ce_float64(target, x, rows):
    """The cross-entropy BNN's log densities and gradients of samples ``x``
    ``[N, D]`` on batches ``rows`` ``[N, B]`` of ``target``'s training
    data, in float64 on the CPU, with each entry's first-order bound on
    the error of a float32 evaluation (Higham's gamma_n of the sums):
    ``(ld, grads, ld_bound, grads_bound)``.

    The hidden pre-activations are 785-term sums, the logits 129-term
    sums of the activations (their error carried through ``|W2|``), the
    log-softmax adds the largest logit error and ~12 roundings, the loss
    a B-term mean, the prior a D-term sum.  The gradient is backpropagated
    the same way in absolute values: the softmax's relative error from the
    log-softmax's, the 10-term product with ``W2``, and where a hidden
    unit's pre-activation lies within its bound of 0 (its ReLU may flip)
    the whole of that unit's term; each weight gradient a B-term sum."""
    import torch

    g = gamma
    x = x.detach().cpu().double()
    rows = rows.cpu()
    feats = target._x_tr.cpu().double()[rows]                 # [N, B, 784]
    labels = target._y_tr.cpu()[rows]                         # [N, B]
    n, b = rows.shape
    (f, h), _, (_, o), _ = target.shapes
    w1 = x[:, :f * h].reshape(n, f, h)
    b1 = x[:, f * h:f * h + h]
    w2 = x[:, f * h + h:f * h + h + h * o].reshape(n, h, o)
    b2 = x[:, f * h + h + h * o:]
    pre = feats @ w1 + b1[:, None]
    e_pre = g(f + 1) * (feats.abs() @ w1.abs() + b1.abs()[:, None])
    act = torch.relu(pre)
    logits = act @ w2 + b2[:, None]
    e_logits = g(h + 1) * (act @ w2.abs() + b2.abs()[:, None]) \
        + e_pre @ w2.abs()
    lse = torch.logsumexp(logits, -1, keepdim=True)
    lsm = logits - lse
    e_lsm = e_logits + e_logits.amax(-1, keepdim=True) \
        + g(12) * (logits.abs() + lse.abs())
    onehot = torch.nn.functional.one_hot(labels, o).double()
    ce = -(lsm * onehot).sum(-1)
    loss = ce.mean(-1)
    e_loss = (e_lsm * onehot).sum(-1).mean(-1) + g(b + 2) * ce.abs().mean(-1)
    t, ls = float(target.train_size), target.likelihood_scaling
    var = target.prior_std ** 2
    sq = (x * x).sum(-1) / var
    ld = ls * (-t * loss - 0.5 * sq)
    ld_bound = ls * (t * e_loss + g(x.shape[1] + 2) * 0.5 * sq) \
        + g(4) * ls * (t * loss.abs() + 0.5 * sq)
    # d loss / d logits = (softmax - onehot) / B
    p = torch.exp(lsm)
    delta = p - onehot
    e_delta = p * (e_lsm + g(3)) + g(1) * delta.abs()
    z = delta @ w2.transpose(1, 2)
    e_z = e_delta @ w2.abs().transpose(1, 2) \
        + g(o + 1) * delta.abs() @ w2.abs().transpose(1, 2)
    on = (pre > 0).double()
    flip = pre.abs() <= e_pre
    dh = z * on
    e_dh = torch.where(flip, z.abs() + e_z, e_z * on)

    def flat(*parts):
        return torch.cat([q.reshape(n, -1) for q in parts], 1)

    tb = lambda m: m.transpose(1, 2)                          # noqa: E731
    grad_loss = flat(tb(feats) @ dh, dh.sum(1), tb(act) @ delta,
                     delta.sum(1)) / b
    e_grad_loss = flat(
        tb(feats.abs()) @ e_dh + g(b + 2) * tb(feats.abs()) @ dh.abs(),
        e_dh.sum(1) + g(b + 2) * dh.abs().sum(1),
        tb(e_pre) @ delta.abs() + tb(act) @ e_delta
        + g(b + 2) * tb(act) @ delta.abs(),
        e_delta.sum(1) + g(b + 2) * delta.abs().sum(1)) / b
    grads = ls * (-t * grad_loss - x / var)
    grads_bound = ls * (t * e_grad_loss
                        + g(4) * (t * grad_loss.abs() + x.abs() / var))
    return ld, grads, ld_bound, grads_bound


def bound_ratio(got, want, bound) -> float:
    """The largest ``|got - want| / bound`` over the entries."""
    import torch

    err = (got.detach().cpu().double() - want).abs()
    return float((err / torch.clamp(bound, min=1e-300)).max())


def mnist_step_on_cpu(cfg, compared: dict, float64: bool) -> dict:
    """The compared step again on the CPU from the card's state before it,
    its draws and its target's cursor (in float64 from the float32 values
    cast exactly where ``float64``): the state's leaves after it."""
    import numpy as np
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch import StepDraws
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    target, model, meta = init_experiment(cfg, device="cpu")
    cpu = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    set_target_cursor(target, compared["cursor"])
    state = compared["before"]
    if float64:
        state = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in state.items()}
    cpu.state = gmmvi_tpu_torch.state_from_numpy(state, device="cpu",
                                                 like=cpu.state)
    cpu.train_iter(StepDraws(**{
        f: None if v is None else v.to(
            "cpu", torch.float64 if float64 and v.is_floating_point()
            else v.dtype)
        for f, v in vars(compared["draws"]).items()}))
    return gmmvi_tpu_torch.state_to_numpy(cpu.state)


def mnist_run(dev, run: str) -> dict:
    """One MNIST run (``mnist_config(run)``) through
    ``init_experiment``, ``GMMVI.build_from_config`` and ``train_iter``
    for ``MNIST_ITERS`` steps, the launch counters set to 0 just before and
    read just after, each target call timed between synchronizes.  Holds
    no kernel launched, a finite state and means that moved; on
    ``mnist_jax_test`` also the compared step on the card against the CPU
    (leaf by leaf at the one-step bar; a leaf that misses it is held
    against the float64 step and passes only where the card meets the bar
    there or float32 on the CPU misses it too) and the target's rows of
    that step against the CPU's float32 evaluation of the same rows (log
    densities within ``MNIST_LD_ATOL`` + ``MNIST_LD_RTOL`` |ld|, gradients
    within ``MNIST_GRAD_FRAC`` of their largest entry) and against float64
    within their first-order float32 bounds (:func:`bnn_ce_float64`)."""
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.models import gmm as gmm_ops
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = mnist_config(run)
    r = MNIST_RUNS[run]
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    sel = gmmvi.selector_cfg
    k = r["components"]
    shape = (model.num_dimensions, model.diagonal, tuple(model.chols.shape),
             int(model.num_active), sel.desired_samples_per_component,
             sel.reused_samples_per_component, target.batch_size)
    want = (MNIST_D, True, (k, MNIST_D), k, r["samples"],
            int(r["ratio"] * r["samples"]), r["batch"])
    if shape != want:
        raise AssertionError(f"{run} built as {shape}, not {want}")
    means0 = model.means.clone()
    elbo_start, _ = elbo(model, target)

    target_s, bucket_rows = [], []
    record: dict = {"on": False}
    call, next_rows = target.log_density_and_grad, target._next_rows

    def rows_of_call(n):
        rows = next_rows(n)
        if record["on"]:
            record["rows"] = rows
        return rows

    def timed(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(x)
        torch.cuda.synchronize()
        target_s.append(time.perf_counter() - t0)
        bucket_rows.append(int(x.shape[0]))
        if record["on"]:
            record["x"], record["out"] = x.clone(), out
        return out

    target.log_density_and_grad, target._next_rows = timed, rows_of_call
    compared: dict = {}

    def step(i):
        if run == "mnist_jax_test" and i == MNIST_COMPARED_STEP:
            compared["before"] = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
            compared["cursor"] = target_cursor(target)
            compared["draws"] = gmmvi.draw(gmmvi.num_updates)
            record["on"] = True
            gmmvi.train_iter(compared["draws"])
            record["on"] = False
            compared["after"] = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
        else:
            gmmvi.train_iter()

    try:
        step_s, launches = run_path(dev, gmmvi, MNIST_ITERS, step=step)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        st = gmmvi.state
        state_finite = model_finite(st)
        moved = float(torch.linalg.norm(st.model.means - means0))
        norm = float(torch.linalg.norm(st.model.means))
        elbo_end, _ = elbo(st.model, target)
        g = torch.Generator(device=dev).manual_seed(1)
        samples, _ = gmm_ops.sample(st.model, 64, g)
        metrics = target.expensive_metrics(st.model, samples)
        copies = copies_per_step(gmmvi.train_iter)
    finally:
        del target.log_density_and_grad, target._next_rows
    median = statistics.median(step_s[1:]) * 1e3
    target_ms = statistics.median(target_s[1:MNIST_ITERS]) * 1e3
    out = dict(
        phase="main_path", path=run, codename="SEMTRON",
        experiment=f"MNIST BNN D={MNIST_D}, diagonal, {k} components x "
                   f"{r['samples']} samples, reuse {r['ratio']}, batch "
                   f"{r['batch']}",
        iterations=len(step_s), first_step_s=step_s[0],
        median_step_ms=median, median_target_ms=target_ms,
        target_share=target_ms / median,
        target_rows_per_call=sorted(set(bucket_rows)),
        fevals=int(st.db.num_samples_written), launches=launches,
        device_to_host_copies_per_step=copies, peak_mem_mb=peak,
        elbo_start=elbo_start, elbo_end=elbo_end, state_finite=state_finite,
        means_moved=moved, means_norm=norm, **metrics)
    if run == "mnist_jax_test":
        out.update(mnist_compared_step(cfg, target, compared, record))
    emit(out)
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on {run}: {launches}")
    if not state_finite:
        raise AssertionError(f"a non-finite state after {run}")
    if not (moved > 0 and norm > 0):
        raise AssertionError(f"the means did not move on {run}")
    if run == "mnist_jax_test":
        if out["card_vs_cpu_unexplained"]:
            raise AssertionError(
                f"{run}: step {MNIST_COMPARED_STEP + 1} on the card differs "
                f"from the CPU's in {out['card_vs_cpu_unexplained']}")
        if max(out["target_vs_cpu_float32"].values()) > 1.0:
            raise AssertionError(
                f"{run}: the target's rows on the card differ from the "
                f"CPU's: {out['target_vs_cpu_float32']}")
        if max(out["target_vs_float64_bound_ratio"].values()) > 1.0:
            raise AssertionError(
                f"{run}: the target's rows miss their float32 bound against "
                f"float64: {out['target_vs_float64_bound_ratio']}")
    return launches


def mnist_compared_step(cfg, target, compared: dict, record: dict) -> dict:
    """The checks of ``mnist_jax_test``'s compared step (see
    :func:`mnist_run`), as fields of its line."""
    import torch

    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    cpu32 = mnist_step_on_cpu(cfg, compared, float64=False)
    cmp = compare_states(compared["after"], cpu32, DIAG_RTOL, DIAG_ATOL)
    out = {"card_vs_cpu_step": MNIST_COMPARED_STEP + 1,
           "card_vs_cpu_bar": f"rtol {DIAG_RTOL} / atol {DIAG_ATOL}",
           "card_vs_cpu_worst": cmp["worst"],
           "card_vs_cpu_missed": cmp["missed"],
           "card_vs_cpu_unexplained": []}
    if cmp["missed"]:
        cpu64 = mnist_step_on_cpu(cfg, compared, float64=True)
        card64 = compare_states(compared["after"], cpu64, DIAG_RTOL,
                                DIAG_ATOL)["ratios"]
        cpu32_64 = compare_states(cpu32, cpu64, DIAG_RTOL,
                                  DIAG_ATOL)["ratios"]
        out["missed_vs_float64"] = {
            k: {"card": card64[k], "cpu_float32": cpu32_64[k]}
            for k in cmp["missed"]}
        out["card_vs_cpu_unexplained"] = [
            k for k in cmp["missed"] if card64[k] > 1.0
            and cpu32_64[k] <= 1.0]
    # the target's rows of the compared step against float64
    x, rows = record["x"], record["rows"]
    ld, grads = record["out"]
    ld64, g64, ld_b, g_b = bnn_ce_float64(target, x, rows)
    cpu_t = get_target_lnpdf(cfg["environment_name"],
                             cfg["environment_config"], 0, device="cpu")
    with torch.enable_grad():
        xc = x.detach().cpu().requires_grad_(True)
        ld32 = cpu_t._posterior(xc, rows.cpu())
        (g32,) = torch.autograd.grad(ld32.sum(), xc)
    out["target_rows"] = list(rows.shape)
    out["target_vs_cpu_float32"] = {
        "log_density": float(((ld.cpu() - ld32.detach()).abs()
                              / (MNIST_LD_ATOL + MNIST_LD_RTOL
                                 * ld32.detach().abs())).max()),
        "grads": float((grads.cpu() - g32).abs().max() / g32.abs().max()
                       / MNIST_GRAD_FRAC)}
    out["target_vs_float64_bound_ratio"] = {
        "log_density": bound_ratio(ld, ld64, ld_b),
        "grads": bound_ratio(grads, g64, g_b)}
    out["target_cpu_float32_vs_float64_bound_ratio"] = {
        "log_density": bound_ratio(ld32, ld64, ld_b),
        "grads": bound_ratio(g32, g64, g_b)}
    out["target_bound_rel"] = {
        "log_density": float((ld_b / ld64.abs()).max()),
        "grads": float((g_b.max() / g64.abs().max()))}
    return out


def mnist_phase(dev) -> dict:
    """The MNIST BNN: its data (``mnist.npz`` where one is found, else the
    JAX package's stand-in, ``GMMVI_ALLOW_SYNTHETIC=1`` set for this
    phase's loads), then ``mnist_jax_test`` and ``mnist_wide``
    (:func:`mnist_run`).  Returns each run's launches."""
    import torch

    from gmmvi_tpu_torch.experiments.targets import bnn
    from gmmvi_tpu_torch.experiments.targets import datasets as data_lib

    before = os.environ.get(data_lib.SYNTHETIC_ENV)
    os.environ[data_lib.SYNTHETIC_ENV] = "1"
    try:
        found = next((p for p in data_lib.mnist_paths() if p.exists()), None)
        t = bnn.make_MNIST_target(1.0, 1.0, 32, device=dev)
        shapes = (t._x_tr.shape[0], t._x_te.shape[0], t._x_va.shape[0],
                  t._x_tr.shape[1], int(t._y_tr.max()) + 1)
        emit({"phase": "mnist_data", "file": str(found) if found else None,
              "stand_in": found is None, "train_test_vali_pixels_labels":
                  list(shapes), "dims": t.get_num_dimensions()})
        if found is None and shapes != MNIST_STAND_IN:
            raise AssertionError(f"the MNIST stand-in has shapes {shapes}")
        del t
        out = {}
        for run in MNIST_RUNS:
            out[run] = mnist_run(dev, run)
            torch.cuda.empty_cache()
        return out
    finally:
        if before is None:
            os.environ.pop(data_lib.SYNTHETIC_ENV, None)
        else:
            os.environ[data_lib.SYNTHETIC_ENV] = before


def examples_phase(dev) -> dict:
    """Every ``examples_torch/*.py`` as a user runs it (its own process,
    ``PYTHONPATH`` the checkout) on the card with ``--iterations
    EXAMPLE_ITERS`` (the meshed example with two ranks over gloo, sharing
    the card), each in a wrapper that prints its kernel launches at exit
    (the meshed example's ranks are other processes: its own count is 0).
    Holds exit 0 and a finite last ELBO line; prints each one's seconds."""
    import re

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    elbo_line = re.compile(r"ELBO(?: after \d+ iterations)?: (\S+)")
    out = {}
    for script in sorted((root / "examples_torch").glob("*.py")):
        args = ["--iterations", str(EXAMPLE_ITERS)]
        if script.name.startswith("7_"):
            args += ["--ranks", "2", "--backend", "gloo"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _EXAMPLE_WRAPPER, str(script), *args],
            cwd=str(root), env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        elbos = elbo_line.findall(proc.stdout)
        launches = [json.loads(line[len("LAUNCHES "):])
                    for line in proc.stderr.splitlines()
                    if line.startswith("LAUNCHES ")]
        line = {"phase": "example", "script": script.name, "args": args,
                "exit": proc.returncode, "seconds": seconds,
                "last_elbo": float(elbos[-1]) if elbos else None,
                "launches": {k: v for k, v in (launches or [{}])[-1].items()
                             if v}}
        emit(line)
        if proc.returncode != 0:
            raise AssertionError(f"{script.name} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        if line["last_elbo"] is None or not math.isfinite(line["last_elbo"]):
            raise AssertionError(f"{script.name}: no finite ELBO line")
        out[script.name] = line
    return out


# ---------------------------------------------------------------------------
# The trust-region searches, D > 512, the decimating database, prior
# samples and candidates without a database
# ---------------------------------------------------------------------------

# stm300 with newton; the flagship with each search; SAMTRON at D = 1,024
NEWTON_ITERS, SEARCH_ITERS, STM1024_ITERS, D_XLA = 61, 30, 20, 1024
SEARCH_PATHS_12 = {"samtron_grid": "grid", "samtron_eigen": "bracket-eigen",
                   "samtron_newton": "newton"}
# an accepted component's KL(new || old) at its accepted eta, exact (in
# float64 from the update's inputs), at most (1 + KL_SLACK) eps (the grid
# search accepts feasible points only: at most eps), each bar raised by
# ROUNDING_SLACK eps for the search's float32 KL; the KL of the rebuilt
# float32 factors is reported beside it
KL_SLACK, ROUNDING_SLACK = 0.1, 1e-3
# the flagship ZAMTRUX with the decimating database; step 21 on the card
# against the CPU and float64 (``zamtrux_decimate_phase``): a model slot
# resolved by float32 ends within SLOT_BAR one-step bars of float64 in
# both plain arithmetics, and so through the kernels; at least
# MIN_RESOLVED_SHARE of the active slots resolved
DECIMATE_ITERS, DECIMATE_DB_SIZE, DECIMATE_COMPARED_STEP = 130, 65536, 20
SLOT_BAR, MIN_RESOLVED_SHARE = 1000.0, 0.5
# the quick-start runner with prior samples, and without a database
GMM20_ITERS_12, N_PRIOR = 300, 1000
# device-to-host copies: steps traced by torch.profiler after a path's run
COPIES_STEPS = 3
LINES_12: dict = {}
WORST_REBUILD: dict = {}


def copies_per_step(step, steps: int = COPIES_STEPS) -> float:
    """Device-to-host copies per call of ``step`` over ``steps`` calls
    traced by ``torch.profiler``: its ``DtoH`` memcpy records, counted as
    ``scripts/profile_torch_step.py`` counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if "DtoH" in ev.key and not ev.key.startswith(("aten::",
                                                              "cuda"))
               ) / steps


def gauss_kl64(new_means, new_chols, old):
    """``[Kmax]`` KL(new || old) in float64 of each slot's Gaussians, the new
    ones given by their means and lower factors, the old factor inverted
    anew in float64."""
    import torch

    lo = old.chols.double()
    eye = torch.eye(lo.shape[-1], dtype=torch.float64, device=lo.device)
    inv = torch.linalg.solve_triangular(lo, eye.expand_as(lo), upper=False)
    diff = (old.means.double() - new_means.double())[:, :, None]
    logdet = [2.0 * torch.log(torch.diagonal(c, dim1=-2, dim2=-1)).sum(-1)
              for c in (lo, new_chols.double())]
    return 0.5 * (torch.sum(torch.square(inv @ new_chols.double()),
                            dim=(-2, -1))
                  + torch.sum(torch.square(inv @ diff), dim=(-2, -1))
                  - lo.shape[-1] + logdet[0] - logdet[1])


def exact_update_kl64(model, hess, grads, etas):
    """``[Kmax]`` KL(new || old) of the exact trust-region interpolation at
    ``etas`` (``P' = P + R / eta``, ``l' = P mu + (R mu - g) / eta``, R the
    symmetric part of the Hessian estimate), all in float64: what the
    search's float32 KL approximates."""
    import torch

    lo = model.chols.double()
    eye = torch.eye(lo.shape[-1], dtype=torch.float64, device=lo.device)
    inv = torch.linalg.solve_triangular(lo, eye.expand_as(lo), upper=False)
    mu, h = model.means.double(), hess.double()
    prec = inv.mT @ inv
    e = torch.clamp(etas.double(), min=1e-30)
    new_prec = prec + 0.5 * (h + h.mT) / e[:, None, None]
    new_lin = (prec @ mu[:, :, None])[..., 0] + (
        (h @ mu[:, :, None])[..., 0] - grads.double()) / e[:, None]
    lp, info = torch.linalg.cholesky_ex(new_prec)
    lp = torch.where((info != 0)[:, None, None], eye, lp)
    new_mean = torch.cholesky_solve(new_lin[:, :, None], lp)[..., 0]
    new_chol = torch.linalg.solve_triangular(lp.mT, eye.expand_as(lp),
                                             upper=True)
    # new_chol new_chol^T = new_prec^{-1}: the KL needs only that product
    return torch.where(info == 0, gauss_kl64(new_mean, new_chol, model),
                       torch.nan)


def watch_updates(kl_ratios: list, trips: list, path=None):
    """Wrap the trust-region updater: each update's inputs and result are
    kept, and ``flush()`` (called between steps, outside their timing)
    turns them into every accepted component's KL over its bound eps (NaN
    elsewhere; device tensors, read at the end), exact at the accepted eta
    and of the rebuilt factors, in ``kl_ratios``; with ``path``, the slot
    whose rebuilt factors carried the largest KL over eps keeps its inputs
    in ``WORST_REBUILD[path]`` (``rebuild_witness`` replays it).  The
    Newton and bracket host loops' trips go to ``trips``.  Returns
    (flush, undos)."""
    import torch

    from gmmvi_tpu_torch.optimization import component_updaters as cu

    update = cu.UPDATERS["trust-region"]
    pending = []

    def recording_update(model, meta, hess, grads, stepsizes, **kw):
        res = update(model, meta, hess, grads, stepsizes, **kw)
        pending.append((model, meta, hess, grads, stepsizes, res))
        return res

    def flush():
        for model, meta, hess, grads, stepsizes, res in pending:
            etas = res.meta.last_etas
            accepted = (etas > 0) & model.mask
            eps = stepsizes.double()
            ratios = torch.stack([torch.where(accepted, kl / eps, torch.nan)
                                  for kl in (exact_update_kl64(model, hess,
                                                               grads, etas),
                                             gauss_kl64(res.model.means,
                                                        res.model.chols,
                                                        model))])
            kl_ratios.append(ratios)
            if path is None:
                continue
            rebuilt = torch.nan_to_num(ratios[1], nan=-1.0)
            k = int(torch.argmax(rebuilt))
            if float(rebuilt[k]) <= WORST_REBUILD.get(path, {}).get(
                    "kl_rebuilt_over_eps", -1.0):
                continue
            WORST_REBUILD[path] = {
                "kl_at_eta_over_eps": float(ratios[0, k]),
                "kl_rebuilt_over_eps": float(rebuilt[k]), "slot": k,
                **{name: t[k].detach().cpu().numpy() for name, t in (
                    ("eps", stepsizes), ("eta", etas),
                    ("last_eta", meta.last_etas), ("mean", model.means),
                    ("chol", model.chols), ("inv_chol", model.inv_chols),
                    ("hess", hess), ("grads", grads),
                    ("new_mean", res.model.means),
                    ("new_chol", res.model.chols))}}
        pending.clear()

    def counting(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            trips.append(out[2])
            return out
        return call

    searches = {name: getattr(cu, name)
                for name in ("newton_search", "bracket_search")}
    cu.UPDATERS["trust-region"] = recording_update
    for name, fn in searches.items():
        setattr(cu, name, counting(fn))

    def undo():
        cu.UPDATERS["trust-region"] = update
        for name, fn in searches.items():
            setattr(cu, name, fn)
    return flush, [undo]


def rebuild_witness(rec: dict) -> dict:
    """The worst rebuilt update of a path (``WORST_REBUILD``), on the CPU:
    the port's float32 rebuild at the card's accepted eta (the CPU's
    rounding in place of the card's) and the float64 one, each as KL over
    eps, and the condition numbers of the old covariance and of the new
    precision (float64).  ``scripts/jax_rebuild_kl.py`` replays the same
    inputs through the JAX package."""
    import torch

    from gmmvi_tpu_torch.ops.trust_region import prepare_tr_kl_inputs
    from gmmvi_tpu_torch.optimization.component_updaters import \
        _tr_final_full

    def one(name, dtype):
        return torch.as_tensor(rec[name])[None].to(dtype)

    out = {}
    for label, dtype in (("cpu_float32", torch.float32),
                         ("cpu_float64", torch.float64)):
        mean, chol, inv_chol, hess, grads = (
            one(n, dtype) for n in ("mean", "chol", "inv_chol", "hess",
                                    "grads"))
        reward_quad = 0.5 * (hess + hess.mT)
        reward_lin = torch.einsum("kij,kj->ki", hess, mean) - grads
        inp = prepare_tr_kl_inputs(mean, chol, inv_chol, reward_lin,
                                   reward_quad)
        _, new_mean, new_chol, _ = _tr_final_full(
            one("eta", dtype), inp.lin, inp.prec, inv_chol, reward_lin,
            reward_quad, inp.kl_const, mean)
        old = SimpleNamespace(means=mean, chols=chol)
        out[f"kl_rebuilt_{label}_over_eps"] = float(
            gauss_kl64(new_mean, new_chol, old)[0] / float(rec["eps"]))
    # (a covariance and its precision have the same condition number)
    for name, c in (("old", chol[0]), ("new", new_chol[0])):
        out[f"{name}_covariance_cond"] = float(torch.linalg.cond(c @ c.T))
    return out


def kl_summary(kl_ratios: list) -> dict:
    """The accepted components' KL / eps over a run, exact at the accepted
    eta and of the rebuilt float32 factors: count, largest, smallest and
    the share within 0.1 of 1."""
    import torch

    r = torch.stack(kl_ratios)                          # [steps, 2, Kmax]
    out = {}
    for i, name in enumerate(("kl_at_eta", "kl_rebuilt")):
        v = r[:, i][torch.isfinite(r[:, i])]
        out[name + "_over_eps_max"] = float(v.max()) if v.numel() else None
        out[name + "_over_eps_min"] = float(v.min()) if v.numel() else None
        out[name + "_within_tenth_share"] = float(
            (torch.abs(v - 1.0) < KL_SLACK).double().mean()) \
            if v.numel() else None
    out["accepted"] = int(torch.isfinite(r[:, 0]).sum())
    return out


def run_path(dev, gmmvi, iters: int, step=None, before_step=None):
    """``iters`` calls of ``step`` (``gmmvi.train_iter`` by default) with
    the launch counters set to 0 just before and read just after; each
    step's wall time (ending in a synchronize), and ``before_step(i)``
    called before step i.  Returns (step seconds, launches)."""
    import torch

    from gmmvi_tpu_torch.ops import cuda

    step = step or (lambda i: gmmvi.train_iter())
    torch.cuda.reset_peak_memory_stats(dev)
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    step_s = []
    for i in range(iters):
        if before_step is not None:
            before_step(i)
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s, dict(cuda.LAUNCHES)


def path_line(path, gmmvi, step_s, launches, dev, **extra) -> dict:
    """The common fields of a path's line, emitted with ``extra``: median
    step ms (steps after the first), fevals, launches, device-to-host
    copies per step (``COPIES_STEPS`` more steps under the profiler) and
    the peak memory of the run."""
    import torch

    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    fevals = int(gmmvi.state.db.num_samples_written)
    out = dict(phase="main_path", path=path, iterations=len(step_s),
               first_step_s=step_s[0],
               median_step_ms=statistics.median(step_s[1:]) * 1e3,
               fevals=fevals, launches=launches,
               launches_per_step={k: v / len(step_s)
                                  for k, v in launches.items()},
               peak_mem_mb=peak, **extra)
    out["device_to_host_copies_per_step"] = copies_per_step(gmmvi.train_iter)
    out["state_finite"] = model_finite(gmmvi.state)
    LINES_12[path] = out
    emit(out)
    if not out["state_finite"]:
        raise AssertionError(f"a non-finite state after the {path} path")
    return out


def stm300_newton_phase(dev, captured):
    """SAMTRON on stm300 with ``tpu.trust_region_search: newton``, nothing
    else cut, 61 iterations: the Newton search around the whitened KL and
    its slope (a host loop, one flag read a trip), B5-B7 on the card (their
    last inputs to ``captured``).  Holds: a finite state, a rising ELBO,
    B5-B7 launched, every accepted component's exact KL at its eta at most
    1.101 eps (``exact_update_kl64``), and the KL of its rebuilt float32
    factors no worse than the bracket's on the stm300 path (at most
    1.101 eps or the bracket's largest there); prints its trips per step
    beside the bracket's."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = update_config(get_default_config("SAMTRON", "stm300"),
                        {"tpu": {"trust_region_search": "newton"}})
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    if (model.num_dimensions, model.max_components) != (D_LARGE,
                                                        KMAX_LARGE):
        raise AssertionError("stm300 with newton built at another size")
    kl_ratios, trips = [], []
    flush, undos = watch_updates(kl_ratios, trips, "stm300_newton")
    restore = [*undos, *capture_large_d_inputs(captured)]
    elbo_start = [None]

    def step(i):
        gmmvi.train_iter()
        if i == 0:
            elbo_start[0] = elbo(gmmvi.model, target)[0]

    step_s, launches = run_path(dev, gmmvi, NEWTON_ITERS, step,
                                before_step=lambda i: flush())
    flush()
    elbo_end, _ = elbo(gmmvi.model, target)
    for undo in restore:
        undo()
    bracket = LINES_12.get("stm300", {})
    bar = 1.0 + KL_SLACK + ROUNDING_SLACK
    rebuilt_bar = max(bar, bracket.get("kl_rebuilt_over_eps_max") or bar)
    out = path_line(
        "stm300_newton", gmmvi, step_s, launches, dev,
        codename="SAMTRON", experiment="stm300", search="newton",
        trips_per_step=sum(trips) / NEWTON_ITERS,
        bracket_trips_per_step=bracket.get("trips_per_step"),
        bracket_median_step_ms=bracket.get("median_step_ms"),
        elbo_start=elbo_start[0], elbo_end=elbo_end,
        num_active=int(gmmvi.model.num_active), **kl_summary(kl_ratios),
        kl_rebuilt_bar=rebuilt_bar,
        worst_rebuild=rebuild_witness(WORST_REBUILD["stm300_newton"]))
    if not elbo_end > elbo_start[0]:
        raise AssertionError(f"stm300 with newton: the ELBO did not improve:"
                             f" {elbo_start[0]} -> {elbo_end}")
    for name in LARGE_KERNELS:
        if launches[name] < NEWTON_ITERS:
            raise AssertionError(f"{name}: {launches[name]} launches on "
                                 "stm300 with newton")
    if out["kl_at_eta_over_eps_max"] is None \
            or out["kl_at_eta_over_eps_max"] > bar:
        raise AssertionError(f"stm300 with newton: an accepted KL over "
                             f"{bar} eps: {out}")
    if out["kl_rebuilt_over_eps_max"] > rebuilt_bar:
        raise AssertionError(f"stm300 with newton: rebuilt factors at a KL "
                             f"over {rebuilt_bar} eps: {out}")
    return launches


def flagship_search_phase(dev, path, densities):
    """SAMTRON at the flagship widths (45 components in 48 slots, 200
    samples each) with ``tpu.trust_region_search`` grid, bracket-eigen or
    newton, 30 iterations; the last B1 and B2 inputs to ``densities``.
    Holds: a finite state, a rising ELBO, B1 and B2 launched and B3's
    search not, every accepted component's exact KL at its eta, and the KL
    of its rebuilt float32 factors, at most 1.101 eps (grid: 1.001 eps;
    the 0.001 for float32's rounding, ``ROUNDING_SLACK``)."""
    from gmmvi_tpu_torch.configs import update_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    search = SEARCH_PATHS_12[path]
    target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                         device=dev)
    cfg = update_config(flagship_config(),
                        {"tpu": {"trust_region_search": search}})
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    kl_ratios, trips = [], []
    flush, undos = watch_updates(kl_ratios, trips)
    restore = [*undos, *capture_density_inputs(densities, path)]
    elbo_start, _ = elbo(gmmvi.model, target)
    step_s, launches = run_path(dev, gmmvi, SEARCH_ITERS,
                                before_step=lambda i: flush())
    flush()
    elbo_end, _ = elbo(gmmvi.model, target)
    for undo in restore:
        undo()
    out = path_line(path, gmmvi, step_s, launches, dev, codename="SAMTRON",
                    experiment="flagship", search=search,
                    trips_per_step=sum(trips) / SEARCH_ITERS,
                    elbo_start=elbo_start, elbo_end=elbo_end,
                    num_active=int(gmmvi.model.num_active),
                    **kl_summary(kl_ratios))
    if not elbo_end > elbo_start:
        raise AssertionError(f"{path}: the ELBO did not improve: "
                             f"{elbo_start} -> {elbo_end}")
    if launches["density_pack"] < SEARCH_ITERS \
            or launches["densities"] < SEARCH_ITERS:
        raise AssertionError(f"{path}: B1/B2 launches {launches}")
    if launches["tr_search"] or launches["tr_kl"]:
        raise AssertionError(f"{path}: B3 launched: {launches}")
    bar = 1.0 + ROUNDING_SLACK + (0.0 if search == "grid" else KL_SLACK)
    for name in ("kl_at_eta_over_eps_max", "kl_rebuilt_over_eps_max"):
        if out[name] is None or out[name] > bar:
            raise AssertionError(f"{path}: {name} over {bar}: {out}")
    return launches


def stm1024_phase(dev):
    """SAMTRON with stm300's settings at D = 1,024 (the Student-T target
    generator takes any D), 20 iterations: above D = 512 no kernel takes
    the densities, in the port as in the JAX package (the XLA chain in
    plain torch, in slabs of components), nor the background, the Stein
    moments (B7 takes D <= 512) or the search (B3 D <= 64).  Holds: a
    finite state, a rising ELBO, no kernel launched; prints the peak
    memory."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = update_config(get_default_config("SAMTRON", "stm300"),
                        {"environment_config": {"num_dimensions": D_XLA}})
    target, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    if model.num_dimensions != D_XLA:
        raise AssertionError(f"stm1024 built at D = {model.num_dimensions}")
    elbo_start, _ = elbo(gmmvi.model, target)
    step_s, launches = run_path(dev, gmmvi, STM1024_ITERS)
    elbo_end, _ = elbo(gmmvi.model, target)
    sel = gmmvi.selector_cfg
    path_line("stm1024", gmmvi, step_s, launches, dev,
                    codename="SAMTRON", experiment="stm300 at D = 1024",
                    d=D_XLA, max_components=model.max_components,
                    n_des=sel.desired_samples_per_component,
                    reused=sel.reused_samples_per_component,
                    ring_rows=gmmvi.state.db.ring_iters,
                    elbo_start=elbo_start, elbo_end=elbo_end,
                    num_active=int(gmmvi.model.num_active))
    if not elbo_end > elbo_start:
        raise AssertionError(f"stm1024: the ELBO did not improve: "
                             f"{elbo_start} -> {elbo_end}")
    if any(launches.values()):
        raise AssertionError(f"a kernel launched at D = {D_XLA}: {launches}")
    return launches


def plain_versions():
    """Every kernel wrapper replaced by its plain PyTorch version where the
    port calls it (the launch counters then stay still); returns the
    undo."""
    from gmmvi_tpu_torch.ops import (background, density, density_large,
                                     mixture_logpdf, more, stein,
                                     trust_region)
    from gmmvi_tpu_torch.optimization import (component_updaters,
                                              ng_estimators, sample_window)

    swaps = {(density, "density_pack"): density.density_pack_plain,
             (density, "densities"): density.densities_plain,
             (mixture_logpdf, "mixture_logpdf"):
                 mixture_logpdf.mixture_logpdf_plain,
             (density_large, "densities_large"):
                 density_large.densities_large_plain,
             (density_large, "mixture_logpdf_large"):
                 density_large.mixture_logpdf_large_plain,
             (density_large, "density_grads_large"):
                 density_large.density_grads_large_plain,
             (stein, "stein_smom"): stein.stein_smom_plain,
             (sample_window, "background_logpdf"):
                 background.background_logpdf_plain,
             (ng_estimators, "more_grams"): more.more_grams_plain,
             (component_updaters, "tr_search"): trust_region.tr_search_plain}
    saved = {key: getattr(*key) for key in swaps}
    for (module, attr), fn in swaps.items():
        setattr(module, attr, fn)

    def undo():
        for (module, attr), fn in saved.items():
            setattr(module, attr, fn)
    return undo


def student_t_to_float64(target) -> None:
    """The port's Student-T mixture target evaluated in float64 from here
    on, in place: its float32 parameters cast exactly."""
    for name in ("_means", "_chols", "_inv_chols", "_log_dets", "_log_w"):
        setattr(target, name, getattr(target, name).double())


def watch_windows(into: dict):
    """Keep, while ``into["on"]`` is a dict, what the decimating database
    hands the kernels in a step: each window it gathers (samples, mapping,
    target log densities, iterations, validity, and the background that B4
    computes over it), by size, and the rows B4 weighs (means, inverse
    factors, log weights, log determinants).  Returns the undo."""
    import torch

    from gmmvi_tpu_torch.optimization import sample_db_decimate as dec
    from gmmvi_tpu_torch.optimization import sample_window

    # the decimating window's background goes through sample_window's
    window, bg = dec.get_newest_samples, sample_window.background

    def numpy(t):
        t = t.detach().cpu()
        return t.double().numpy() if t.is_floating_point() \
            else t.to(torch.int64).numpy()

    def recording_window(db, size, *args):
        win = window(db, size, *args)
        if into["on"] is not None:
            into["on"].update({f"window{size}.{name}": numpy(getattr(win,
                                                                     name))
                               for name in ("samples", "mapping",
                                            "target_lnpdfs", "sample_iters",
                                            "valid", "background_log_pdfs")})
        return win

    def recording_background(diagonal, means, inv_chols, log_weights,
                             log_dets, samples):
        if into["on"] is not None:
            n = samples.shape[0]
            into["on"].update({f"rows{n}.{name}": numpy(t) for name, t in (
                ("means", means), ("inv_chols", inv_chols),
                ("log_weights", log_weights), ("log_dets", log_dets))})
        return bg(diagonal, means, inv_chols, log_weights, log_dets, samples)

    dec.get_newest_samples = recording_window
    sample_window.background = recording_background

    def undo():
        dec.get_newest_samples, sample_window.background = window, bg
    return undo


def slot_ratios(got: dict, want: dict, kmax: int) -> dict:
    """For each float leaf of the model and the meta-state (each has a
    leading Kmax axis): ``[Kmax]`` each slot's largest error against the
    one-step bar's scale, ``atol + rtol |want|`` (inf where NaN or
    infinities sit elsewhere)."""
    import numpy as np

    out = {}
    for name, w in want.items():
        if not name.startswith(("model.", "meta.")) or w.ndim == 0 \
                or np.issubdtype(w.dtype, np.integer) or w.shape[0] != kmax:
            continue
        g = got[name].astype(np.float64).reshape(kmax, -1)
        w = w.astype(np.float64).reshape(kmax, -1)
        fin = np.isfinite(w)
        same = (np.isfinite(g) == fin) & np.where(
            fin, True, (g == w) | (np.isnan(g) & np.isnan(w)))
        diff = np.where(fin, np.abs(np.where(fin, g, 0.0) - np.where(
            fin, w, 0.0)), 0.0)
        ratio = diff / (DIAG_ATOL + DIAG_RTOL * np.abs(np.where(fin, w,
                                                                0.0)))
        out[name] = np.where(same.all(1), ratio.max(1), np.inf)
    return out


def zamtrux_decimate_phase(dev, captured, densities):
    """ZAMTRUX at the flagship widths (reuse 2.0, a 28,800-sample window)
    with ``tpu.db_eviction: decimate`` and ``max_database_size`` 65,536,
    130 iterations; the last B4 and B8 inputs to ``captured``, B1's and
    B2's to ``densities``.  Holds: the store's count within its capacity
    after every step, more samples written than it holds (it decimated), a
    rising ELBO, and B1, B2, B4 and B8 launched.

    Step 21 runs again from the same state and draws four ways: on the
    card through the kernels (the run's own step, K), on the card through
    the plain versions (P), and on the CPU in float32 (C) and in float64
    (F, the reference: state, draws and target cast exactly).  Held: K
    against C at the one-step bar (integers exact, floats within rtol 1e-4
    / atol 1e-5) in the database's leaves, every integer leaf, and what
    the decimating database hands the kernels (both windows with their
    background, and the table rows B4 weighs).  The model's and
    meta-state's floats part from F in any float32 arithmetic where
    MORE's ridge-1e-12 fit is ill-conditioned, so they are held slot by
    slot: a slot is resolved by float32 where both plain arithmetics, P
    and C, end within ``SLOT_BAR`` bars of F in every leaf, and there K
    must too; at least ``MIN_RESOLVED_SHARE`` of the active slots must be
    resolved.  Each run's slots that F accepted and it rejected, or the
    other way, are counted."""
    import numpy as np
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch import StepDraws
    from gmmvi_tpu_torch.configs import update_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI
    from gmmvi_tpu_torch.optimization.sample_db_decimate import \
        DecimatingDbState

    def build(device):
        target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                             device=device)
        cfg = update_config(flagship_config(codename="ZAMTRUX"), {
            "max_database_size": DECIMATE_DB_SIZE,
            "tpu": {"db_eviction": "decimate"}})
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=device)
        return GMMVI.build_from_config(cfg, target, model, meta,
                                       device=device), target

    gmmvi, target = build(dev)
    db = gmmvi.state.db
    if not isinstance(db, DecimatingDbState) \
            or db.capacity != DECIMATE_DB_SIZE:
        raise AssertionError(f"the decimating database built as "
                             f"{type(db).__name__} [{db.capacity}]")
    handed = {"on": None}
    capture = [*capture_last_inputs(captured),
               *capture_density_inputs(densities, "zamtrux_decimate")]
    watch = watch_windows(handed)
    counts, compared, windows = [], {}, {}

    def step(i):
        if i == DECIMATE_COMPARED_STEP:
            compared["before"] = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
            compared["draws"] = gmmvi.draw(gmmvi.num_updates)
            handed["on"] = windows.setdefault("K", {})
            gmmvi.train_iter(compared["draws"])
            handed["on"] = None
            compared["K"] = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
        else:
            gmmvi.train_iter()
        counts.append(gmmvi.state.db.count)

    elbo_start, _ = elbo(gmmvi.model, target)
    step_s, launches = run_path(dev, gmmvi, DECIMATE_ITERS, step)
    elbo_end, _ = elbo(gmmvi.model, target)
    counts = torch.stack(counts).tolist()
    # the kernels' last inputs are the card run's, not the witnesses'
    for undo in capture:
        undo()

    def again(run, device, float64=False, plain=False):
        g, t = build(device)
        state, draws = compared["before"], compared["draws"]
        if float64:
            student_t_to_float64(t)
            state = {k: v.astype(np.float64) if v.dtype == np.float32
                     else v for k, v in state.items()}
        g.state = gmmvi_tpu_torch.state_from_numpy(state, device=device,
                                                   like=g.state)
        draws = StepDraws(**{
            f: None if v is None else v.to(device, torch.float64
                                           if float64 and v.is_floating_point()
                                           else v.dtype)
            for f, v in vars(draws).items()})
        undo_plain = plain_versions() if plain else None
        before = dict(cuda.LAUNCHES)
        handed["on"] = windows.setdefault(run, {})
        try:
            g.train_iter(draws)
        finally:
            handed["on"] = None
            if undo_plain is not None:
                undo_plain()
        if plain and dict(cuda.LAUNCHES) != before:
            raise AssertionError("a kernel launched in the plain run")
        compared[run] = gmmvi_tpu_torch.state_to_numpy(g.state)

    again("P", dev, plain=True)
    again("C", "cpu")
    again("F", "cpu", float64=True)
    watch()

    k_run, c_run = compared["K"], compared["C"]
    held = [k for k, v in c_run.items()
            if k.startswith("db.") or np.issubdtype(v.dtype, np.integer)]
    db_cmp = compare_states({k: k_run[k] for k in held},
                            {k: c_run[k] for k in held}, DIAG_RTOL,
                            DIAG_ATOL)
    win_cmp = compare_states(windows["K"], windows["C"], DIAG_RTOL,
                             DIAG_ATOL)
    kmax, fl = KMAX, compared["F"]
    active = np.arange(kmax) < int(fl["model.num_active"])
    per_run = {run: slot_ratios(compared[run], fl, kmax)
               for run in ("K", "P", "C")}
    worst = {run: np.max(np.stack(list(r.values())), 0)
             for run, r in per_run.items()}                  # [Kmax]
    resolved = active & (worst["P"] <= SLOT_BAR) & (worst["C"] <= SLOT_BAR)
    missed = [int(k) for k in np.flatnonzero(resolved & (worst["K"]
                                                          > SLOT_BAR))]
    accepted_f = fl["meta.last_etas"] > 0
    flips = {run: int(np.sum(active & ((compared[run]["meta.last_etas"] > 0)
                                       != accepted_f)))
             for run in ("K", "P", "C")}
    pair_cmp = {f"{a}_vs_{b}": compare_states(compared[a], compared[b],
                                              DIAG_RTOL, DIAG_ATOL)["worst"]
                for a, b in (("K", "C"), ("P", "C"), ("K", "P"),
                             ("C", "F"))}
    st = gmmvi.state.db
    out = path_line(
        "zamtrux_decimate", gmmvi, step_s, launches, dev,
        codename="ZAMTRUX", experiment="flagship", db_eviction="decimate",
        capacity=st.capacity, dist_capacity=st.dist_capacity,
        count_max=max(counts), count_end=counts[-1],
        decimations=sum(b < a for a, b in zip(counts, counts[1:])),
        dist_count_end=int(st.dist_count), elbo_start=elbo_start,
        elbo_end=elbo_end, num_active=int(gmmvi.model.num_active),
        compared_step=DECIMATE_COMPARED_STEP + 1,
        one_step_bar=f"rtol {DIAG_RTOL} / atol {DIAG_ATOL}",
        db_and_integers_worst=db_cmp["worst"],
        db_and_integers_missed=db_cmp["missed"],
        handed_to_kernels_worst=win_cmp["worst"],
        handed_to_kernels_missed=win_cmp["missed"],
        handed_to_kernels_leaves=sorted(windows["K"]),
        pairs_worst=pair_cmp, slot_bar=SLOT_BAR,
        active_slots=int(active.sum()), resolved_slots=int(resolved.sum()),
        resolved_missed_by_kernels=missed, flips_against_float64=flips,
        slot_worst={run: [float(x) for x in w[active]]
                    for run, w in worst.items()})
    if max(counts) > st.capacity:
        raise AssertionError(f"the store held {max(counts)} > "
                             f"{st.capacity} samples")
    if not out["fevals"] > st.capacity or not out["decimations"]:
        raise AssertionError(f"no decimation: {out['fevals']} written")
    if not elbo_end > elbo_start:
        raise AssertionError(f"zamtrux_decimate: the ELBO did not improve: "
                             f"{elbo_start} -> {elbo_end}")
    for name in ("density_pack", "densities", "background_logpdf",
                 "more_grams"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the decimating "
                                 "path")
    for what, cmp in (("database and integer leaves", db_cmp),
                      ("inputs handed to the kernels", win_cmp)):
        if cmp["missed"]:
            raise AssertionError(f"step {DECIMATE_COMPARED_STEP + 1}: the "
                                 f"card's {what} differ from the CPU's in "
                                 f"{cmp['missed']}: {cmp['ratios']}")
    if missed:
        raise AssertionError(f"step {DECIMATE_COMPARED_STEP + 1}: slots "
                             f"{missed} resolved by float32 miss "
                             f"{SLOT_BAR} bars through the kernels")
    if resolved.sum() < MIN_RESOLVED_SHARE * active.sum():
        raise AssertionError(f"step {DECIMATE_COMPARED_STEP + 1}: only "
                             f"{int(resolved.sum())} of {int(active.sum())}"
                             " slots resolved by float32")
    return launches


def gmm20_variant_phase(dev, path, captured, densities):
    """The quick-start runner (``get_default_config("SAMTRON", "gmm20")``)
    with ``num_prior_samples`` 1,000 (``gmm20_prior``: every step draws
    1,000 prior samples, evaluates the target on them, and an add takes
    them as candidates beside the reservoir's 16,384) or with
    ``use_sample_database: False`` (``gmm20_nodb``: no reuse, add
    candidates from the newest batch), ``iterate_and_log(n)`` for n =
    0..299; B9's last inputs at each call size to ``captured``, B1's and
    B2's to ``densities``.  Holds: finite metrics, a rising ELBO,
    components grown by VIPS, B1-B3 and B9 launched (B4 with the
    database), B9 at the candidates' count."""
    from gmmvi_tpu_torch.configs import update_config
    from gmmvi_tpu_torch.ops import mixture_logpdf as mops

    over = ({"num_component_adapter_config": {"num_prior_samples": N_PRIOR}}
            if path == "gmm20_prior" else {"use_sample_database": False})
    runner = build_runner(dev, update_config(runner_config(), over))
    g = runner.gmmvi
    n_cand = (N_CANDIDATES + N_PRIOR if path == "gmm20_prior"
              else min(N_CANDIDATES, g.state.db.capacity))
    restore = [recording(captured, mops, "mixture_logpdf",
                         key=lambda args: ("mixture_logpdf",
                                           args[4].shape[0])),
               *capture_density_inputs(densities, path)]
    evals = []

    def step(n):
        out = runner.iterate_and_log(n)
        if "-elbo" in out:
            evals.append(dict(iteration=n, elbo=-out["-elbo"],
                              num_components=out["num_components"],
                              finite=all(math.isfinite(v)
                                         for v in out.values()
                                         if isinstance(v, (int, float)))))
            emit({"phase": "runner_eval", "path": path, **evals[-1]})

    step_s, launches = run_path(dev, g, GMM20_ITERS_12, step)
    for undo in restore:
        undo()
    sizes = sorted(k[1] for k in captured if isinstance(k, tuple))
    out = path_line(path, g, step_s, launches, dev, codename="SAMTRON",
                    experiment="gmm20", entry="GmmviRunner.iterate_and_log",
                    elbo_start=evals[0]["elbo"], elbo_end=evals[-1]["elbo"],
                    num_active=int(g.model.num_active),
                    kmax=g.model.max_components, b9_sizes=sizes,
                    candidates=n_cand)
    if not all(e["finite"] for e in evals):
        raise AssertionError(f"{path}: a runner metric is not finite")
    if not out["elbo_end"] > out["elbo_start"]:
        raise AssertionError(f"{path}: the ELBO did not improve: {out}")
    if not out["num_active"] > 1:
        raise AssertionError(f"{path}: VIPS added no component")
    kernels = ["density_pack", "densities", "tr_search", "mixture_logpdf"]
    if path == "gmm20_prior":
        kernels.append("background_logpdf")
    elif launches["background_logpdf"]:
        raise AssertionError(f"{path}: B4 launched without reuse")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on {path}")
    if n_cand not in sizes:
        raise AssertionError(f"{path}: B9 never at the {n_cand} candidates: "
                             f"{sizes}")
    return launches


def slice12_input_rows(captured_dec, captured_runner12) -> dict:
    """B4 and B8 on the decimating path's last inputs and B9 on the gmm20
    variants' (B1, B2 and B5-B7 go through ``density_path_rows`` and
    ``large_d_input_rows``), against their plain versions at the kernel
    phase's bars; fails on a miss.  Returns B4's rows by label."""
    out = background_path_rows(captured_dec, "zamtrux_decimate")
    row = measure_more(captured_dec["more_grams"])
    emit({"phase": "kernel_on_main_path_inputs", "path": "zamtrux_decimate",
          "name": "more_grams", **row})
    if not row["ok"]:
        raise AssertionError(f"more_grams disagrees on the decimating "
                             f"path's inputs: {row}")
    for path, caught in captured_runner12.items():
        for key in sorted(k for k in caught if isinstance(k, tuple)):
            row = measure_mixture_logpdf(caught[key])
            emit({"phase": "kernel_on_main_path_inputs", "path": path,
                  "name": f"mixture_logpdf[N={key[1]}]", **row})
            if not row["ok"]:
                raise AssertionError(f"mixture_logpdf disagrees on the "
                                     f"{path} path's inputs: {row}")
    return out


# ----------------------------------------------------------------------
# Meshes: ranks of one torch.distributed group, all on the one card
# ----------------------------------------------------------------------
# M1-M7: (steps, ranks, backend); every meshed path runs its ranks on
# cuda:0 (NCCL refuses two ranks on one device, so gloo, which has
# all_reduce and all_gather for CUDA tensors; NCCL at world size 1)
MESH_PATHS = {"M1": (30, 2, "gloo"), "M2": (30, 2, "gloo"),
              "M3": (40, 2, "gloo"), "M4": (10, 4, "gloo"),
              "M5": (20, 2, "gloo"), "M6": (150, 2, "gloo"),
              "M7": (10, 1, "nccl")}
# the gmm20 runner on a data mesh: 4 slots so that VIPS outgrows them (the
# check before iteration 120 grows them to 16), a checkpoint after
# iteration 124, resumed in fresh ranks and held equal to the bit at 149
MESH_RUNNER_SLOTS, MESH_CKPT_AT = 4, 125
# the sharded paths: step 1 held against the sharded database's [2, ...]
# form run in one process from the same draws
SHARDED_MESH_PATHS = ("M2", "M3", "M5")
# the kernels each rank holds against their plain versions on the inputs
# of its last launch (per call size), after the counted steps
RANK_INPUT_KERNELS = {
    "M3": ("density_pack", "densities", "background_logpdf", "more_grams"),
    "M5": ("densities_large", "density_grads_large", "stein_smom")}
MESH_TIMEOUT_S = 600
MESH_KERNELS = {
    "M1": ("density_pack", "densities", "tr_search"),
    "M2": ("density_pack", "densities", "tr_search"),
    "M3": ("density_pack", "densities", "background_logpdf", "more_grams"),
    "M4": ("density_pack", "densities", "tr_search"),
    "M5": ("densities_large", "density_grads_large", "stein_smom"),
    "M6": ("density_pack", "densities", "tr_search", "background_logpdf",
           "mixture_logpdf"),
    "M7": ("density_pack", "densities", "tr_search"),
}


MESH_TPU = {"M1": {"data_shards": 2, "db_layout": "global"},
            "M2": {"data_shards": 2}, "M3": {"data_shards": 2},
            "M4": {"data_shards": 2, "comp_shards": 2, "db_layout": "global"},
            "M5": {"data_shards": 2}, "M6": {"data_shards": 2},
            "M7": {"data_shards": 1, "db_layout": "global"}}


def mesh_config(path: str, meshed: bool = True) -> dict:
    """The config of mesh path ``path`` (without ``target_fn``): the
    flagship SAMTRON on the global ring (M1, M4), the flagship SAMTRON and
    ZAMTRUX with ``db_layout: auto`` (sharded on a data mesh: M2, M3),
    stm300 (M5), the gmm20 runner (M6), the flagship SAMTRON with
    ``data_shards: 1`` (M7); with ``meshed`` False the same run unmeshed
    on the global ring (the references of step 1)."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config

    if path == "M5":
        cfg = get_default_config("SAMTRON", "stm300")
    elif path == "M6":
        cfg = runner_config(MESH_RUNNER_SLOTS)
    else:
        cfg = flagship_config(codename="ZAMTRUX" if path == "M3"
                              else "SAMTRON")
    tpu = MESH_TPU[path] if meshed else {"db_layout": "global"}
    return update_config(cfg, {"tpu": tpu})


def mesh_gmmvi(path: str, dev, meshed: bool = True):
    """GMMVI of ``path`` through ``GMMVI.build_from_config`` (its mesh from
    the config's ``tpu`` section, inside a process group; unmeshed with
    ``meshed`` False)."""
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = mesh_config(path, meshed)
    if path != "M5":
        cfg["target_fn"] = make_target(num_dimensions=D,
                                       harder_setting=False, seed=0,
                                       device=dev)
    target, model, meta = init_experiment(cfg, device=dev)
    return GMMVI.build_from_config(cfg, target, model, meta, device=dev)


def _np_draws(draws) -> dict:
    import dataclasses

    return {f.name: None if getattr(draws, f.name) is None
            else getattr(draws, f.name).cpu().numpy()
            for f in dataclasses.fields(draws)}


def _torch_draws(named: dict, dev):
    import torch

    from gmmvi_tpu_torch.optimization.gmmvi import StepDraws

    return StepDraws(**{k: None if v is None else torch.as_tensor(
        v, device=dev) for k, v in named.items()})


def _window_arrays(win) -> dict:
    return {name: getattr(win, name).cpu().numpy() for name in (
        "samples", "mapping", "target_lnpdfs", "target_grads",
        "background_log_pdfs", "valid", "sample_iters")}


def capture_first_window(into: dict):
    """Keep the window of the first sharded-database step (its
    ``get_newest_samples_fused``) in ``into``; returns the undo."""
    from gmmvi_tpu_torch.optimization import sample_db_sharded as shd

    fn = shd.get_newest_samples_fused

    def call(*args, **kw):
        win, pack = fn(*args, **kw)
        into.setdefault("window", _window_arrays(win))
        return win, pack

    shd.get_newest_samples_fused = call
    return lambda: setattr(shd, "get_newest_samples_fused", fn)


def capture_first_more_fit(into: dict):
    """Keep the Gram and right-hand side of MORE's first fit (the
    all-reduced sums of every rank's B8 partials on a mesh) in ``into``
    as numpy; returns the undo."""
    from gmmvi_tpu_torch.optimization import ng_estimators

    fn = ng_estimators.solve_quadratic_normal_eqs

    def call(gram, rhs, *args, **kw):
        if "gram" not in into:
            into.update(gram=gram.cpu().numpy(), rhs=rhs.cpu().numpy())
        return fn(gram, rhs, *args, **kw)

    ng_estimators.solve_quadratic_normal_eqs = call
    return lambda: setattr(ng_estimators, "solve_quadratic_normal_eqs", fn)


def compare_more_fits(got: dict, want: dict) -> dict:
    """The reduced Gram and right-hand side of a meshed step against those
    of the same step in one process: each component's largest error over
    its largest entry, held to B8's bar 2e-5 (``measure_more``)."""
    import numpy as np

    rel = {}
    for name in ("gram", "rhs"):
        k = want[name].shape[0]
        w = want[name].reshape(k, -1).astype(np.float64)
        g = got[name].reshape(k, -1).astype(np.float64)
        scale = np.maximum(np.abs(w).max(1), 1e-30)
        rel[name] = float((np.abs(g - w).max(1) / scale).max())
    return {"more_fit_rel_err": rel,
            "more_fit_ok": max(rel.values()) <= 2e-5}


def mesh_steps(step, steps: int, state_of):
    """``steps`` calls of ``step(i)``, each ending in a synchronize, the
    launch counters and the collective counters set to 0 just before and
    read just after, every collective timed (``PhaseTimers``), and the
    replicated state (``state_of()``) held equal on every rank after every
    step.  Returns (step seconds, launches, collectives, bytes, each
    step's seconds in collectives)."""
    import torch

    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.parallel import reduce
    from gmmvi_tpu_torch.parallel.mesh import check_replicated
    from gmmvi_tpu_torch.utils.profiling import PhaseTimers

    timers = PhaseTimers()
    reduce.TIMERS = timers
    reduce.reset_stats()
    cuda.reset_launch_counts()
    torch.cuda.synchronize()
    step_s, coll_s = [], []
    try:
        for i in range(steps):
            before = timers.totals["collectives"]
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            coll_s.append(timers.totals["collectives"] - before)
            check_replicated(state_of())
    finally:
        reduce.TIMERS = None
    return (step_s, dict(cuda.LAUNCHES), reduce.STATS["collectives"],
            reduce.STATS["bytes"], coll_s)


def mesh_rank(rank: int, nprocs: int, path: str, work: str) -> None:
    """One rank of mesh path ``path`` on cuda:0; its record goes to
    ``work``/rank<r>.json (and rank 0's gathered state after step 1 to
    ``work``/state1.npz, each rank's first window to
    ``work``/window<r>.npz where asked)."""
    import numpy as np
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.parallel import reduce

    torch.cuda.set_device(0)
    dev = resolve_device("cuda")
    work = Path(work)
    steps = MESH_PATHS[path][0]
    rec: dict = {"rank": rank}
    if path == "M6":
        rec.update(mesh_runner_rank(rank, dev, work))
    else:
        gmmvi = mesh_gmmvi(path, dev)
        first = work / "draws0.npz"
        draws0 = None
        if first.exists():
            with np.load(first, allow_pickle=True) as z:
                draws0 = _torch_draws(z["draws"].item(), dev)
        window: dict = {}
        undo = capture_first_window(window) if path == "M2" else None
        captured: dict = {}
        fit1: dict = {}
        undos = (capture_last_inputs(captured)
                 + capture_density_inputs(captured, path)
                 + [capture_first_more_fit(fit1)] if path == "M3"
                 else capture_large_d_inputs(captured) if path == "M5"
                 else [])
        after1: dict = {}
        target = gmmvi.target_distribution

        def step(i):
            gmmvi.train_iter(draws0 if i == 0 else None)
            if i == 0:
                with reduce.scope(gmmvi.mesh):
                    after1.update(gmmvi_tpu_torch.gathered_state_to_numpy(
                        gmmvi.state))
                rec["elbo_after_1"] = elbo(gmmvi.state.model, target)[0]

        step_s, launches, coll, nbytes, coll_s = mesh_steps(
            step, steps, lambda: gmmvi.state)
        for undo_capture in undos:
            undo_capture()
        if undos:
            rec["kernel_rows"] = rank_input_rows(captured, path, rank,
                                                 nprocs)
        if undo is not None:
            undo()
            np.savez(work / f"window{rank}.npz", **window["window"])
        if rank == 0:
            np.savez(work / "state1.npz", **after1)
            if fit1:
                np.savez(work / "more1.npz", **fit1)
        rec.update(
            layout=type(gmmvi.state.db).__name__,
            elbo_end=elbo(gmmvi.state.model, target)[0],
            fevals=int(gmmvi.state.db.num_samples_written),
            num_active=int(gmmvi.state.model.num_active),
            state_finite=model_finite(gmmvi.state), step_s=step_s,
            launches=launches, collectives=coll, bytes=nbytes,
            collectives_s=coll_s)
    with open(work / f"rank{rank}.json", "w") as fh:
        json.dump(rec, fh)
    if path == "M5":
        # the compact phase's M5 in these ranks, saving a spawn
        import gc

        del gmmvi, target, captured
        gc.collect()
        torch.cuda.empty_cache()
        compact_rank(rank, nprocs, str(work))


def mesh_runner_rank(rank: int, dev, work: Path) -> dict:
    """M6 in one rank: the gmm20 runner from its config (``tpu:
    {data_shards: 2}``), ``iterate_and_log`` for n = 0..149 with a
    checkpoint after n = 124; fresh ranks' runner loads it and steps
    n = 125..149, held equal to the bit to the unbroken run."""
    import numpy as np

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch.parallel import reduce

    steps = MESH_PATHS["M6"][0]
    runner = build_runner(dev, mesh_config("M6"))
    outs = []

    def step(i):
        outs.append(runner.iterate_and_log(i))
        if i == MESH_CKPT_AT - 1:
            runner.save_checkpoint(str(work / "m6.npz"))

    step_s, launches, coll, nbytes, coll_s = mesh_steps(
        step, steps, lambda: runner.gmmvi.state)
    fresh = build_runner(dev, mesh_config("M6"))
    import torch.distributed as dist

    dist.barrier()
    fresh.load_checkpoint(str(work / "m6.npz"))
    for i in range(MESH_CKPT_AT, steps):
        fresh.iterate_and_log(i)
    with reduce.scope(runner.gmmvi.mesh):
        a = gmmvi_tpu_torch.gathered_state_to_numpy(runner.gmmvi.state)
        b = gmmvi_tpu_torch.gathered_state_to_numpy(fresh.gmmvi.state)
    resumed_equal = set(a) == set(b) and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in a)
    evals = [o for o in outs if "-elbo" in o]
    return dict(
        layout=type(runner.gmmvi.state.db).__name__,
        max_components=runner.gmmvi.state.model.max_components,
        elbo_after_1=-evals[0]["-elbo"], elbo_end=-evals[-1]["-elbo"],
        fevals=outs[-1]["num_samples"], num_active=outs[-1][
            "num_components"],
        state_finite=model_finite(runner.gmmvi.state)
        and all(np.isfinite(o["max_weight"]) for o in outs),
        resumed_equal=resumed_equal, step_s=step_s, launches=launches,
        collectives=coll, bytes=nbytes, collectives_s=coll_s)


def measure_rank_inputs(captured: dict, path: str, rank: int) -> dict:
    """Every kernel of ``RANK_INPUT_KERNELS[path]`` once more on the inputs
    of its last launch in this rank (per call size), against its plain
    version at the bars of the kernel phase (``measure_density``,
    ``measure_background``, ``measure_more``, ``measure_large_density``,
    ``measure_large_grads``, ``measure_stein``).  Returns per kernel, per
    "path rank r [entry] K=.. N=..", the row (with ``ok``)."""
    out: dict = {}
    at = f"{path} rank {rank}"
    for key, args in sorted(captured.items(), key=lambda kv: str(kv[0])):
        name = key[0] if isinstance(key, tuple) else key
        if name == "background_logpdf":
            row = measure_background(args)
            label = f"{at} U={row['rows']} N={row['samples']}"
        elif name in ("density_pack", "densities"):
            row = measure_density(name, args)
            label = f"{at} K={row['components']} N={row['samples']}"
        elif name == "more_grams":
            row = measure_more(args)
            label = f"{at} K={row['components']} N={row['samples']}"
        elif name in ("densities_large", "mixture_logpdf_large"):
            row = measure_large_density(name, args)
            label = f"{at} {name} K={row['rows']} N={row['samples']}"
            name = "densities_large"
        elif name == "density_grads_large":
            row = measure_large_grads(args)
            label = f"{at} K={row['components']} N={row['samples']}"
        else:
            row = measure_stein(args)
            label = f"{at} K={row['components']} N={row['samples']}"
        out.setdefault(name, {})[label] = {
            f: row[f] for f in PATH_FIELDS + ("ok",) if f in row}
    missing = set(RANK_INPUT_KERNELS[path]) - set(out)
    if missing:
        raise AssertionError(f"{path} rank {rank}: no launch of "
                             f"{sorted(missing)} recorded")
    return out


def rank_input_rows(captured: dict, path: str, rank: int, nprocs: int
                    ) -> dict:
    """:func:`measure_rank_inputs` in each rank in turn (the others wait
    at a barrier, so the card times one rank's kernels at a time)."""
    import torch.distributed as dist

    rows: dict = {}
    for r in range(nprocs):
        if r == rank:
            rows = measure_rank_inputs(captured, path, rank)
        dist.barrier()
    return rows


def mesh_reference(dev, work: Path) -> dict:
    """The unmeshed flagship SAMTRON on the card (global ring): the draws
    of its first step (saved for M1 and M4; M7's fresh generator draws the
    same) and its state after it."""
    import numpy as np

    import gmmvi_tpu_torch

    gmmvi = mesh_gmmvi("M1", dev, meshed=False)
    draws = gmmvi.draw(0)
    np.savez(work / "draws0.npz", draws=np.asarray(_np_draws(draws),
                                                   dtype=object))
    gmmvi.train_iter(draws)
    return gmmvi_tpu_torch.state_to_numpy(gmmvi.state)


def mesh_sharded_reference(dev, path: str, work: Path):
    """The first step of sharded path ``path`` (M2, M3, M5) with the
    sharded database's ``[2, ...]`` form in one process (no mesh, no
    collective: every sum over all the rows at once), from its generator's
    draws (saved for the ranks): the window it gathers, its state after
    the step and MORE's first Gram and right-hand side (M3; else empty)."""
    import gc

    import numpy as np
    import torch

    import gmmvi_tpu_torch
    from gmmvi_tpu_torch.optimization import sample_db_sharded as shd

    gmmvi = mesh_gmmvi(path, dev, meshed=False)
    db = gmmvi.state.db
    gmmvi.state.db = shd.create_sharded_db(
        dim=db.samples.shape[-1], max_components=db.max_components,
        capacity=db.capacity, dist_ring_iters=db.ring_iters,
        reservoir_capacity=db.reservoir_capacity, n_shards=2, device=dev)
    del db
    draws = gmmvi.draw(0)
    np.savez(work / "draws0.npz", draws=np.asarray(_np_draws(draws),
                                                   dtype=object))
    window: dict = {}
    fit1: dict = {}
    undos = [capture_first_window(window), capture_first_more_fit(fit1)]
    gmmvi.train_iter(draws)
    for undo in undos:
        undo()
    state = gmmvi_tpu_torch.state_to_numpy(gmmvi.state)
    del gmmvi, draws
    gc.collect()
    torch.cuda.empty_cache()
    return window["window"], state, fit1


def compare_windows(path_dir: Path, want: dict, ranks: int) -> dict:
    """Each rank's first window against its block of the one-process
    ``[P, ...]`` form's: samples, masks, slots and iterations exactly,
    target values and backgrounds at the one-step bar."""
    import numpy as np

    w_l = want["valid"].shape[0] // ranks
    worst, exact = 0.0, True
    for r in range(ranks):
        with np.load(path_dir / f"window{r}.npz") as z:
            got = dict(z)
        block = {k: v[r * w_l:(r + 1) * w_l] for k, v in want.items()}
        for name in ("samples", "mapping", "valid", "sample_iters"):
            exact &= bool(np.array_equal(got[name], block[name]))
        v = block["valid"]
        cmp_ = compare_states(
            {k: got[k][v] for k in ("target_lnpdfs", "target_grads",
                                    "background_log_pdfs")},
            {k: block[k][v] for k in ("target_lnpdfs", "target_grads",
                                      "background_log_pdfs")}, 1e-4, 1e-5)
        worst = max(worst, cmp_["worst"][1])
    return {"window_exact": exact, "window_worst_of_bar": worst,
            "window_rows_per_rank": w_l}


def mesh_phase(dev, path: str, work_root: Path, ref1=None) -> dict:
    """Mesh path ``path`` in ``ranks`` fresh processes on the card (spawn,
    a join timeout, one CPU thread each), then its line: ranks, backend,
    layout, steps and median step ms, fevals, the ELBO after step 1 and
    at the end, collectives and bytes per step, the ``PhaseTimers`` split
    (median ms of a step in collectives, and in the rest; steps after the
    first, each timed collective after a synchronize of the card),
    launches per step per rank, and the checks of the path."""
    import shutil

    import numpy as np

    from gmmvi_tpu_torch.parallel.mesh import spawn

    steps, ranks, backend = MESH_PATHS[path]
    work = work_root / path
    work.mkdir(parents=True, exist_ok=True)
    out: dict = {"phase": "mesh", "path": path, "ranks": ranks,
                 "backend": backend, "steps": steps, "device": "cuda:0"}
    want_window, want_fit = None, None
    if path in ("M1", "M4"):
        shutil.copy(work_root / "ref" / "draws0.npz", work / "draws0.npz")
    if path in SHARDED_MESH_PATHS:
        want_window, ref1, want_fit = mesh_sharded_reference(dev, path,
                                                             work)
    t0 = time.perf_counter()
    spawn(mesh_rank, ranks, backend, args=(path, str(work)),
          timeout_s=MESH_TIMEOUT_S)
    out["wall_s"] = time.perf_counter() - t0
    recs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(ranks)]
    r0 = recs[0]
    step_s, coll_s = r0["step_s"], r0["collectives_s"]
    compute_s = [a - b for a, b in zip(step_s, coll_s)]
    out.update(
        layout=r0["layout"], median_step_ms=statistics.median(
            step_s[1:]) * 1e3, first_step_s=step_s[0], fevals=r0["fevals"],
        num_active=r0["num_active"], elbo_after_1=r0["elbo_after_1"],
        elbo_end=r0["elbo_end"],
        collectives_per_step=r0["collectives"] / steps,
        bytes_per_step=r0["bytes"] / steps,
        timers_median_ms={
            "collectives": statistics.median(coll_s[1:]) * 1e3,
            "rest": statistics.median(compute_s[1:]) * 1e3},
        launches_per_step_per_rank=[
            {k: v / steps for k, v in rec["launches"].items() if v}
            for rec in recs],
        hash_checked_steps=steps,
        note="ranks share one card: no scaling is measured")
    failures = []
    if not all(rec["state_finite"] for rec in recs):
        failures.append("a non-finite state")
    for name in MESH_KERNELS[path]:
        if any(rec["launches"][name] <= 0 for rec in recs):
            failures.append(f"{name} not launched on every rank")
    rank_rows: dict = {}
    for rec in recs:
        for name, labelled in rec.get("kernel_rows", {}).items():
            for label, row in labelled.items():
                emit({"phase": "kernel_on_mesh_rank_inputs", "path": path,
                      "rank": rec["rank"], "name": name, "label": label,
                      **row})
                if not row["ok"]:
                    failures.append(f"{name} disagrees with its plain "
                                    f"version on {label}")
                rank_rows.setdefault(name, {})[label] = {
                    f: row[f] for f in PATH_FIELDS if f in row}
    out["rank_input_rows"] = rank_rows
    if path in ("M1", "M4", "M7") + SHARDED_MESH_PATHS:
        with np.load(work / "state1.npz") as z:
            got = dict(z)
        cmp_ = compare_states(got, ref1, 1e-4, 1e-5)
        out.update(step1_worst_of_bar=cmp_["worst"],
                   step1_missed=cmp_["missed"],
                   step1_bits_equal=all(np.array_equal(
                       got[k], ref1[k], equal_nan=True) for k in ref1),
                   step1_fevals=int(got["db.num_samples_written"]),
                   unmeshed_step1_fevals=int(ref1["db.num_samples_written"]))
        if cmp_["missed"] or out["step1_fevals"] != \
                out["unmeshed_step1_fevals"]:
            failures.append("step 1 differs from the unmeshed step")
        if path in SHARDED_MESH_PATHS:
            out["step1_reference"] = "the [2, ...] form in one process"
    if path == "M3":
        # step 1's fit fails at MORE's starting ridge (1e-12) on both
        # sides, so the state after it does not read MORE; its reduced Gram
        # and right-hand side are held instead (later states cannot be:
        # from the first accepted fit on, rounding decides the fitted model)
        with np.load(work / "more1.npz") as z:
            out.update(compare_more_fits(dict(z), want_fit))
        if not out["more_fit_ok"]:
            failures.append("MORE's reduced Gram differs from the one-process "
                            "form's")
    if path == "M2":
        out.update(compare_windows(work, want_window, ranks))
        if not (out["window_exact"] and out["window_worst_of_bar"] <= 1.0):
            failures.append("the per-rank windows differ from the [P, ...] "
                            "form's")
    if path in ("M2", "M3", "M5") and out["layout"] != \
            "ShardedSampleDbState":
        failures.append(f"layout {out['layout']}, not sharded")
    if path in ("M2", "M3", "M5", "M6") and not (
            out["elbo_end"] > out["elbo_after_1"]):
        failures.append("the ELBO did not rise")
    if path == "M6":
        out.update(resumed_bits_equal=r0["resumed_equal"],
                   grown_to=r0["max_components"])
        if not r0["resumed_equal"]:
            failures.append("the resumed run differs from the unbroken one")
        if r0["max_components"] <= MESH_RUNNER_SLOTS:
            failures.append("the capacity did not grow")
    out["ok"] = not failures
    out["failures"] = failures
    emit({k: v for k, v in out.items() if k != "rank_input_rows"})
    if failures:
        raise AssertionError(f"mesh path {path}: {failures}")
    return out


def mesh_phases(dev) -> dict:
    """M1-M7 in order (the unmeshed reference step first).  The ranks
    share the card with this process, so its cached blocks are given back
    first (earlier paths leave tens of GB cached: stm1024 peaks at 44.7
    GB)."""
    import gc
    import shutil

    import torch

    gc.collect()
    before = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    emit({"phase": "mesh_setup", "parent_reserved_mb_before": before / 2 ** 20,
          "parent_reserved_mb_after": torch.cuda.memory_reserved(dev)
          / 2 ** 20})
    work_root = BUILD_DIR / "mesh"
    shutil.rmtree(work_root, ignore_errors=True)
    (work_root / "ref").mkdir(parents=True)
    ref1 = mesh_reference(dev, work_root / "ref")
    gc.collect()
    torch.cuda.empty_cache()
    return {path: mesh_phase(dev, path, work_root, ref1)
            for path in MESH_PATHS}


def mesh_kernel_rows(dev) -> dict:
    """B1 and B2 at a data rank's rows of the flagship window (N = 4,800
    of 9,600 at P = 2) and B3's fused search on a comp rank's slice (24 of
    48 components), each against its plain version with its bound, as
    phase 3 measures them at the full shapes."""
    args = density_inputs(dev, n=KMAX * N_DES // 2)
    rows = {name: measure_density(name, args)
            for name in ("density_pack", "densities")}
    sargs = tr_search_inputs(dev)
    half = KMAX // 2
    sliced = (type(sargs[0])(*[t[:half] for t in sargs[0]]),
              *[t[:half].contiguous() for t in sargs[1:]])
    rows["tr_search"] = measure_tr_search(sliced)
    for name, row in rows.items():
        emit({"phase": "kernel_rank_shape", "name": name, **row})
        if not row["ok"]:
            raise AssertionError(f"{name} at a rank's shape disagrees with "
                                 "its plain version")
    return rows


# the bucketed target evaluation (tpu.compact_target_eval): each path's
# steps with the setting on and off in lockstep (the off step from the on
# run's state, with the same draws); M5 in two ranks over gloo
COMPACT_PATHS = {"ZAMTRUX": 30, "gmm20": 30, "planar_robot_4": 20, "M5": 10}
# the one-step bar of the paths' step comparisons, on the means and log
# weights after every step; steps before COMPACT_WARMUP are not held to the
# bucket's size
COMPACT_RTOL, COMPACT_ATOL, COMPACT_WARMUP = 1e-4, 1e-5, 1


def compact_gmmvi(path: str, mode: str, dev):
    """The GMMVI of compact path ``path`` with ``tpu.compact_target_eval``
    ``mode``, through the entry points: the flagship ZAMTRUX through
    ``GMMVI.build_from_config``, the gmm20 runner config and
    planar_robot_4 through ``GmmviRunner.build_from_config`` (its
    ``gmmvi``), M5 (stm300 on the sharded ring of a 2-rank data mesh,
    called in every rank) as the mesh phase builds it."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    setting = {"tpu": {"compact_target_eval": mode}}
    if path == "gmm20":
        return build_runner(dev, update_config(runner_config(),
                                               setting)).gmmvi
    if path == "planar_robot_4":
        return build_runner(dev, update_config(get_default_config(
            "SAMTRON", path), setting)).gmmvi
    if path == "M5":
        cfg = update_config(mesh_config("M5"), setting)
        target, model, meta = init_experiment(cfg, device=dev)
    else:
        cfg = update_config(flagship_config(codename=path), setting)
        cfg["target_fn"] = target = make_target(
            num_dimensions=D, harder_setting=False, seed=0, device=dev)
        _, model, meta = init_experiment(cfg, device=dev)
    return GMMVI.build_from_config(cfg, target, model, meta, device=dev)


def watch_target(gmmvi, calls: list):
    """Record each target evaluation of ``gmmvi``'s steps in ``calls``:
    its rows and a pair of CUDA events around it (read at the end, so the
    record adds no host sync); returns the undo."""
    import torch

    evaluate = gmmvi._eval_target

    def call(x):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = evaluate(x)
        end.record()
        calls.append((x.shape[0], start, end))
        return out

    gmmvi._eval_target = call
    return lambda: setattr(gmmvi, "_eval_target", evaluate)


def compact_lockstep(gmmvis: dict, steps: int) -> dict:
    """``steps`` steps of ``gmmvis["on"]``; each step also run by
    ``gmmvis["off"]`` from the same state with the same draws (the port's
    steps make new tensors, so both start from one state object).  Per
    mode and step: the rows of each target call, its device ms, the valid
    rows of the proposal (this rank's on a sharded ring), the ladder's
    size floor, the step's wall seconds and its launches; and per step the
    largest error of the off state's means and log weights against the on
    state's over the one-step bar, and both fevals.  Then
    device-to-host copies per step of each mode (``COPIES_STEPS`` more
    steps of each under the profiler, from one state with the same
    draws).  A target call's device ms is the span between events around
    it: after the bucketed path's read of the count the device waits on
    the host's launches, which the span then holds."""
    import numpy as np
    import torch

    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.parallel import reduce

    on, off = gmmvis["on"], gmmvis["off"]
    rec = {m: {"rows": [], "target_ms": [], "valid": [], "proposal": [],
               "floor": [], "step_s": [], "launches": {}} for m in gmmvis}
    calls = {m: [] for m in gmmvis}
    undo = [watch_target(g, calls[m]) for m, g in gmmvis.items()]
    valid = {m: [] for m in gmmvis}
    for m, g in gmmvis.items():
        propose = g._propose_phase

        def recording(state, draws, g=g, propose=propose, into=rec[m]):
            prop = propose(state, draws)
            mine = reduce.rows(prop.valid)
            valid[m].append(mine.sum())
            into["proposal"].append(mine.shape[0])
            into["floor"].append(g._eval_buckets[0] if g._eval_buckets
                                 else None)
            return prop

        g._propose_phase = recording
    # the on step's draws and the state they were drawn for (after any
    # capacity growth), which the off step starts from
    drawn = []
    draw = on.draw
    on.draw = lambda i: drawn.append((on.state, draw(i))) or drawn[-1][1]
    worst, fevals = [], []
    for _ in range(steps):
        drawn.clear()
        for m, g in (("on", on), ("off", off)):
            if m == "off":
                g.state = drawn[-1][0]
            counts = dict(cuda.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.train_iter(drawn[-1][1] if m == "off" else None)
            torch.cuda.synchronize()
            rec[m]["step_s"].append(time.perf_counter() - t0)
            for k, v in cuda.LAUNCHES.items():
                rec[m]["launches"][k] = rec[m]["launches"].get(k, 0) \
                    + v - counts.get(k, 0)
        got, want = ({k: getattr(g.state.model, k).cpu().numpy()
                      for k in ("means", "log_weights")} for g in (off, on))
        worst.append(compare_states(got, want, COMPACT_RTOL,
                                    COMPACT_ATOL)["worst"][1])
        fevals.append((int(on.state.db.num_samples_written),
                       int(off.state.db.num_samples_written)))
    torch.cuda.synchronize()
    for m, g in gmmvis.items():
        rec[m]["rows"] = [n for n, _, _ in calls[m]]
        rec[m]["target_ms"] = [a.elapsed_time(b) for _, a, b in calls[m]]
        rec[m]["valid"] = [int(v) for v in valid[m]]
        del g._propose_phase
    for u in undo:
        u()
    # copies of both settings from one state with the same draws (the
    # searches' trips, each a flag read, follow the state)
    drawn.clear()
    rec["on"]["copies_per_step"] = copies_per_step(on.train_iter)
    del on.draw
    off.state, replay = drawn[0][0], iter(drawn)
    rec["off"]["copies_per_step"] = copies_per_step(
        lambda: off.train_iter(next(replay)[1]))
    rec["worst_of_bar"] = worst
    rec["fevals"] = fevals
    rec["finite"] = bool(np.isfinite(
        on.state.model.means.cpu().numpy()).all())
    return rec


def compact_rank(rank: int, nprocs: int, work: str) -> None:
    """M5 of the compact phase in one rank on cuda:0; its record goes to
    ``work``/compact<rank>.json."""
    import torch

    from gmmvi_tpu_torch.device import resolve_device

    torch.cuda.set_device(0)
    dev = resolve_device("cuda")
    gmmvis = {m: compact_gmmvi("M5", m, dev) for m in ("on", "off")}
    rec = compact_lockstep(gmmvis, COMPACT_PATHS["M5"])
    rec["layout"] = type(gmmvis["on"].state.db).__name__
    rec["ladder"] = gmmvis["on"]._eval_buckets
    with open(Path(work) / f"compact{rank}.json", "w") as fh:
        json.dump(rec, fh)


def compact_lines(path: str, recs: list, ladder) -> dict:
    """One line per mode of compact path ``path`` from its records (one
    per rank) and the path's check: fevals equal, every step's means and
    log weights within the one-step bar, the bucket at most twice the
    valid rows (the largest rank's) past warm-up wherever that count is
    above the ladder's floor, the bucket smaller than the proposal's rows
    at some step, and all of them evaluated with the setting off."""
    import numpy as np

    lines = {}
    for mode in ("on", "off"):
        ranks = [r[mode] for r in recs]
        r0 = ranks[0]
        step_s = r0["step_s"]
        lines[mode] = dict(
            phase="compact", path=path, mode=mode, steps=len(step_s),
            ranks=len(recs), proposal_rows_last=r0["proposal"][-1],
            ladder=ladder if mode == "on" else None,
            rows_per_call_mean=float(np.mean([r["rows"] for r in ranks])),
            rows_per_call_last=[r["rows"][-1] for r in ranks],
            valid_rows_mean=float(np.mean([r["valid"] for r in ranks])),
            valid_rows_last=[r["valid"][-1] for r in ranks],
            copies_per_step=[r["copies_per_step"] for r in ranks],
            median_step_ms=statistics.median(step_s[1:]) * 1e3,
            target_median_ms=statistics.median(r0["target_ms"][1:]),
            target_share=sum(r0["target_ms"][1:])
            / (sum(step_s[1:]) * 1e3),
            fevals=recs[0]["fevals"][-1][0 if mode == "on" else 1],
            launches_per_step={k: v / len(step_s) for k, v in
                               r0["launches"].items() if v})
        emit(lines[mode])
    on_ranks, off_ranks = [r["on"] for r in recs], [r["off"] for r in recs]
    too_big = []
    for i in range(COMPACT_WARMUP, len(on_ranks[0]["rows"])):
        count = max(r["valid"][i] for r in on_ranks)
        if count > on_ranks[0]["floor"][i] and any(
                r["rows"][i] > 2 * count for r in on_ranks):
            too_big.append(i)
    check = dict(
        phase="compact_check", path=path,
        worst_of_bar=max(max(r["worst_of_bar"]) for r in recs),
        steps_over_bar=[i for i, w in enumerate(recs[0]["worst_of_bar"])
                        if w > 1.0],
        fevals_equal=all(a == b for r in recs for a, b in r["fevals"]),
        steps_bucket_over_twice_valid=too_big,
        steps_bucket_below_proposal=sum(
            any(r["rows"][i] < r["proposal"][i] for r in on_ranks)
            for i in range(len(on_ranks[0]["rows"]))),
        off_rows_whole=all(r["rows"] == r["proposal"] for r in off_ranks),
        finite=all(r["finite"] for r in recs))
    check["ok"] = (check["worst_of_bar"] <= 1.0 and check["fevals_equal"]
                   and not too_big and check["steps_bucket_below_proposal"]
                   > 0 and check["off_rows_whole"] and check["finite"])
    emit(check)
    if not check["ok"]:
        raise AssertionError(f"compact path {path}: {check}")
    return lines


def compact_phase(dev, m5_dir=None) -> dict:
    """The four compact paths: ZAMTRUX at the flagship widths, the gmm20
    runner config, planar_robot_4 (here) and M5 (two ranks over gloo on
    the card), each with ``tpu.compact_target_eval`` on and off in
    lockstep (:func:`compact_lockstep`), held by :func:`compact_lines`.
    M5's records are read from ``m5_dir`` where the mesh phase's M5 ranks
    left them (:func:`mesh_rank`), else its ranks are spawned here."""
    import gc
    import shutil

    import torch

    from gmmvi_tpu_torch.parallel.mesh import spawn

    out = {}
    for path, steps in COMPACT_PATHS.items():
        t0 = time.perf_counter()
        if path == "M5":
            work = m5_dir
            if work is None:
                work = BUILD_DIR / "compact"
                shutil.rmtree(work, ignore_errors=True)
                work.mkdir(parents=True)
                spawn(compact_rank, 2, "gloo", args=(str(work),),
                      timeout_s=MESH_TIMEOUT_S)
            recs = [json.loads((work / f"compact{r}.json").read_text())
                    for r in range(2)]
            if recs[0]["layout"] != "ShardedSampleDbState":
                raise AssertionError(f"M5 built {recs[0]['layout']}")
            ladder = recs[0]["ladder"]
        else:
            gmmvis = {m: compact_gmmvi(path, m, dev) for m in ("on", "off")}
            recs = [compact_lockstep(gmmvis, steps)]
            ladder = gmmvis["on"]._eval_buckets
            del gmmvis
            gc.collect()
            torch.cuda.empty_cache()
        out[path] = compact_lines(path, recs, ladder)
        emit({"phase": "timing", "name": f"compact {path}",
              "s": time.perf_counter() - t0})
    return out


INTERFACE_STEPS = 30
# the interface phase's bars, set from its rehearsal on the CPU (plain
# versions, the same widths and steps) before its first run on the card:
# each step's autograd gradients within INTERFACE_GRAD_FRAC of the step's
# largest analytic entry (the CPU tests' gradient bar), and the autograd
# step's state, from the same state with the same draws, within the
# one-step bar of the analytic step's, each component's mean and factor
# scaled by that component's largest entry (its float32 rounding is
# relative to its norm: entry by entry the rehearsal missed the bar 14x,
# at entries near 0 of means near 100) and the log weights entry by entry;
# the rehearsal's worst steps: gradients 5.7e-7, state 0.15 of the bar
INTERFACE_GRAD_FRAC = 1e-4
INTERFACE_RTOL, INTERFACE_ATOL = 1e-4, 1e-5
INTERFACE_KERNELS = ("density_pack", "densities", "tr_search")


def component_scaled_ratio(got, want, rtol: float, atol: float) -> float:
    """The largest ``|got - want|`` over ``atol + rtol * max |want[k]|``,
    each component ``k`` (the leading axis) over its own largest entry."""
    import numpy as np

    want = want.astype(np.float64)
    axes = tuple(range(1, want.ndim))
    scale = atol + rtol * np.abs(want).max(axis=axes, keepdims=True)
    return float((np.abs(got - want) / scale).max())


def interface_config() -> dict:
    """The flagship SAMTRON (45 components in 48 slots, 200 samples each)
    with the registry's 20-D Student-T mixture (``environment_name:
    STM``), the target ``__graft_entry__`` builds."""
    from gmmvi_tpu_torch import configs

    return configs.update_config(flagship_config(), {
        "environment_name": "STM",
        "environment_config": {"num_dimensions": D, "harder_setting": False,
                               "use_matlab_target": False}})


def interface_phase(dev) -> dict:
    """The target interface at the flagship widths: the registry's
    Student-T mixture (``use_log_density_and_grad`` True, its analytic
    gradient) and an ``LNPDF`` subclass that supplies only
    ``log_density``, wrapping the same target (flag False: the optimizer
    differentiates it by autograd), each built through the top-level
    ``configs``, ``init_experiment`` and ``GMMVI.build_from_config``, in
    lockstep for ``INTERFACE_STEPS`` steps: every step of the analytic
    run is run again by the autograd run from the same state with the same
    draws.  Per step: the target's log densities equal to the bit, the
    autograd gradients on the valid rows within ``INTERFACE_GRAD_FRAC`` of
    the analytic ones' largest entry, the autograd step's means, factors
    and log weights within the one-step bar of the analytic step's, equal
    fevals, and B1, B2 and B3's search launched in each run (counts set to
    0 just before each step and read just after).  One
    ``{"phase": "interface"}`` line with both runs' step and target times
    and the per-step launches, and one ``{"phase": "interface_check"}``
    line, which fails the run where a check misses."""
    import numpy as np
    import torch

    from gmmvi_tpu_torch import LNPDF, init_experiment
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    class LogDensityOnly(LNPDF):
        """A user's target with only ``log_density`` (the wrapped
        one's)."""

        def __init__(self, inner):
            super().__init__(use_log_density_and_grad=False,
                             safe_for_jit=True)
            self.inner = inner

        def log_density(self, x):
            return self.inner.log_density(x)

        def get_num_dimensions(self):
            return self.inner.get_num_dimensions()

    cfg = interface_config()
    target, model, meta = init_experiment(cfg, device=dev)
    wrapped = LogDensityOnly(target)
    flags = [(t.use_log_density_and_grad, t.safe_for_jit)
             for t in (target, wrapped)]
    if flags != [(True, True), (False, True)]:
        raise AssertionError(f"target flags {flags}")
    runs = {"analytic": GMMVI.build_from_config(cfg, target, model, meta,
                                                device=dev)}
    _, model2, meta2 = init_experiment({**cfg, "target_fn": wrapped},
                                       device=dev)
    runs["autograd"] = GMMVI.build_from_config(cfg, wrapped, model2, meta2,
                                               device=dev)
    if runs["analytic"].estimator_type != "Stein":
        raise AssertionError("the flagship is not on the Stein estimator")
    rec = {m: {"step_s": [], "target_ms": [], "launches": []} for m in runs}
    evals = {m: [] for m in runs}
    valid = []
    for m, g in runs.items():
        evaluate = g._eval_target

        def call(x, evaluate=evaluate, into=evals[m]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = evaluate(x)
            end.record()
            into.append((out, start, end))
            return out

        g._eval_target = call
    propose = runs["analytic"]._propose_phase

    def recording(state, draws):
        prop = propose(state, draws)
        valid.append(prop.valid)
        return prop

    runs["analytic"]._propose_phase = recording
    analytic, autograd = runs["analytic"], runs["autograd"]
    drawn = []
    draw = analytic.draw
    analytic.draw = lambda i: drawn.append((analytic.state, draw(i))) \
        or drawn[-1][1]
    t_phase = time.perf_counter()
    ld_equal, grad_gap, worst, fevals = [], [], [], []
    for step in range(INTERFACE_STEPS):
        drawn.clear()
        for m, g in runs.items():
            if m == "autograd":
                g.state = drawn[-1][0]
            cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.train_iter(drawn[-1][1] if m == "autograd" else None)
            torch.cuda.synchronize()
            rec[m]["step_s"].append(time.perf_counter() - t0)
            rec[m]["launches"].append(
                {k: v for k, v in cuda.LAUNCHES.items() if v})
        (a_ld, a_g), _, _ = evals["analytic"][-1]
        (b_ld, b_g), _, _ = evals["autograd"][-1]
        ld_equal.append(bool(torch.equal(a_ld, b_ld)))
        rows = valid[-1]
        scale = a_g[rows].abs().max()
        grad_gap.append(float((b_g[rows] - a_g[rows]).abs().max() / scale))
        got, want = ({k: getattr(g.state.model, k).cpu().numpy()
                      for k in ("means", "chols", "log_weights")}
                     for g in (autograd, analytic))
        worst.append({
            "log_weights": compare_states(
                got, want, INTERFACE_RTOL, INTERFACE_ATOL)["ratios"][
                    "log_weights"],
            **{k: component_scaled_ratio(got[k], want[k], INTERFACE_RTOL,
                                         INTERFACE_ATOL)
               for k in ("means", "chols")}})
        fevals.append((int(analytic.state.db.num_samples_written),
                       int(autograd.state.db.num_samples_written)))
    phase_s = time.perf_counter() - t_phase
    for m in runs:
        rec[m]["target_ms"] = [a.elapsed_time(b) for _, a, b in evals[m]]
    st = analytic.state
    missing = {m: [i for i, counts in enumerate(rec[m]["launches"])
                   if not all(counts.get(k, 0) > 0
                              for k in INTERFACE_KERNELS)]
               for m in runs}
    for m in runs:
        emit(dict(
            phase="interface", run=m, steps=INTERFACE_STEPS,
            flag=m == "analytic", first_step_s=rec[m]["step_s"][0],
            median_step_ms=statistics.median(rec[m]["step_s"][1:]) * 1e3,
            target_median_ms=statistics.median(rec[m]["target_ms"][1:]),
            target_rows=int(evals[m][-1][0][0].shape[0]),
            fevals=fevals[-1][0 if m == "analytic" else 1],
            launches_per_step={k: [c.get(k, 0) for c in rec[m]["launches"]]
                               for k in INTERFACE_KERNELS},
            num_active=int(st.model.num_active)))
    check = dict(
        phase="interface_check", seconds=phase_s,
        lnpdf_equal_steps=sum(ld_equal),
        grad_gap_max=max(grad_gap), grad_gap_median=statistics.median(
            grad_gap), grad_bar=INTERFACE_GRAD_FRAC,
        state_worst_of_bar={k: max(w[k] for w in worst) for k in worst[0]},
        state_worst_of_bar_median=statistics.median(
            max(w.values()) for w in worst),
        fevals_equal=all(a == b for a, b in fevals),
        steps_without_b1_b2_b3=missing,
        finite=bool(np.isfinite(st.model.means.cpu().numpy()).all()))
    check["ok"] = (check["lnpdf_equal_steps"] == INTERFACE_STEPS
                   and check["grad_gap_max"] <= INTERFACE_GRAD_FRAC
                   and max(check["state_worst_of_bar"].values()) <= 1.0
                   and check["fevals_equal"] and check["finite"]
                   and not any(missing.values()))
    emit(check)
    if not check["ok"]:
        raise AssertionError(f"interface phase: {check}")
    return check


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the wine BNN seeds its batch order from hash(("bnn", seed)), as
        # the JAX package does; with a fixed hash seed its run repeats
        # from call to call
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
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
    sass_phase()

    rows = kernel_phase(dev)
    flagship = ("density_pack", "densities", "tr_search")
    captured: dict = {}
    captured_semidug: dict = {}
    captured_large: dict = {}
    captured_sepyfux: dict = {}
    captured_runner: dict = {}
    captured_wine: dict = {}
    searches: dict = {}
    densities: dict = {}
    samtron, samtron_fevals = main_path_phase(dev, "SAMTRON", flagship,
                                              searches, densities)
    by_path = {"SAMTRON": samtron,
               "ZAMTRUX": main_path_phase(
                   dev, "ZAMTRUX",
                   flagship + ("background_logpdf", "more_grams"), searches,
                   densities, captured)[0],
               "stm300": large_d_phase(dev, captured_large),
               "gmm20": runner_phase(dev, captured_runner, searches,
                                     densities),
               "SEPYFUX": sepyfux_phase(dev, captured_sepyfux),
               "SEMIDUG": main_path_phase(
                   dev, "SEMIDUG",
                   ("density_pack", "densities", "background_logpdf"),
                   searches, densities, captured_semidug)[0],
               "SAMTRON-standard-IW": main_path_phase(
                   dev, "SAMTRON-standard-IW", flagship, searches, densities,
                   fevals_at=samtron_fevals)[0]}
    captured_paper = {e: {} for e in PAPER_PATHS}
    for experiment in PAPER_PATHS:
        by_path[experiment] = paper_phase(dev, experiment, searches,
                                          densities,
                                          captured_paper[experiment])
    by_path["wine"] = wine_phase(dev, captured_wine)
    captured_newton: dict = {}
    captured_dec: dict = {}
    captured_runner12 = {"gmm20_prior": {}, "gmm20_nodb": {}}
    by_path["stm300_newton"] = stm300_newton_phase(dev, captured_newton)
    for path in SEARCH_PATHS_12:
        by_path[path] = flagship_search_phase(dev, path, densities)
    by_path["stm1024"] = stm1024_phase(dev)
    by_path["zamtrux_decimate"] = zamtrux_decimate_phase(dev, captured_dec,
                                                         densities)
    for path, caught in captured_runner12.items():
        by_path[path] = gmm20_variant_phase(dev, path, caught, densities)
    on_paths = {**density_path_rows(densities),
                "tr_search": search_rows(searches),
                "background_logpdf": {
                    **background_path_rows(captured, "ZAMTRUX"),
                    **background_path_rows(captured_semidug, "SEMIDUG")},
                "mixture_logpdf": {}}
    for experiment, caught in captured_paper.items():
        for name, labels in paper_input_rows(caught, experiment).items():
            on_paths[name].update(labels)
    main_path_input_rows(captured, searches["ZAMTRUX"])
    on_paths["background_logpdf"].update(
        slice12_input_rows(captured_dec, captured_runner12))
    for path, large in (("stm300", captured_large),
                        ("SEPYFUX", captured_sepyfux),
                        ("wine", captured_wine),
                        ("stm300_newton", captured_newton)):
        for name, labels in large_d_input_rows(large, path).items():
            on_paths.setdefault(name, {}).update(labels)
    runner_input_rows(captured_runner)
    by_path["SAMTRON-diagonal"] = diagonal_phase(dev)
    by_path.update(mnist_phase(dev))
    examples_phase(dev)
    mesh_lines = mesh_phases(dev)
    rank_rows = mesh_kernel_rows(dev)
    compact_phase(dev, m5_dir=BUILD_DIR / "mesh" / "M5")
    interface_phase(dev)
    for line in mesh_lines.values():
        for name, labelled in line["rank_input_rows"].items():
            on_paths.setdefault(name, {}).update(labelled)
    for r in rows:
        r["mesh_launches_per_step_per_rank"] = {
            path: [per_rank.get(r["name"], 0.0)
                   for per_rank in line["launches_per_step_per_rank"]]
            for path, line in mesh_lines.items()}
        if r["name"] in rank_rows:
            got = rank_rows[r["name"]]
            r["rank_shape"] = {k: got[k] for k in (
                "samples", "components", "d", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by") if k in got}
        if r["name"] in on_paths:
            r["paths"] = on_paths[r["name"]]
        # the flagship's count for B1-B3, the reuse path's for B4 and B8,
        # the stm300 path's for B5-B7, the runner path's for B9
        path = ("SAMTRON" if r["name"] in flagship else
                "stm300" if r["name"] in LARGE_KERNELS else
                "gmm20" if r["name"] == "mixture_logpdf" else "ZAMTRUX")
        r["launches"] = by_path[path][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "responsible_pairs",
            "library_ms", "bound_tc_ms", "paths",
            "mesh_launches_per_step_per_rank", "rank_shape")
    emit({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
