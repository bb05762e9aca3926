#!/usr/bin/env python3
"""Wall time per training step of the PyTorch port on the card, without a
profiler.

Builds a main path as ``scripts/profile_torch_step.py`` does
(``--codename SAMTRON`` or ``ZAMTRUX`` on the flagship's widths, or
``--experiment stm300 | gmm20`` from ``get_default_config``), runs
``--warmup`` steps, then times ``--steps`` steps one by one (host clock
around ``train_iter`` and ``torch.cuda.synchronize()``) and prints one JSON
line: the median and quartiles of the step's wall ms, the fevals and the
card's name and power limit.  With ``--other-b6 DIR`` the stm300 path's
B6 is built from ``DIR``'s ``density_large.cu`` (the C interface without a
workspace, as ``scripts/torch_bench_large_kernels.py --other-csrc``
takes it), which separates what a kernel's last bits do to the trajectory
from what its call costs.

Compare two commits on one card by running this file from each tree's
root in turns (parent, change, change, parent, ...); copy it into the
older tree first if that tree lacks it.  Run on a machine with the card:
``python3 scripts/torch_step_time.py [--codename ZAMTRUX] [--experiment
stm300 | gmm20 --warmup 600]``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--codename", default="SAMTRON",
                    choices=("SAMTRON", "ZAMTRUX"))
    ap.add_argument("--experiment", default="flagship",
                    choices=("flagship", "stm300", "gmm20"))
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--other-b6", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_time: no CUDA device is available",
              file=sys.stderr)
        return 1

    from chip_smoke import D, flagship_config, nvidia_smi
    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import density_large
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    dev = resolve_device("cuda")
    if args.other_b6:
        from torch_bench_large_kernels import other_grads

        density_large.density_grads_large = other_grads(args.other_b6, dev)
    if args.experiment != "flagship":
        cfg = get_default_config(args.codename, args.experiment)
        target, model, meta = init_experiment(cfg, device=dev)
    else:
        target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                             device=dev)
        cfg = flagship_config(codename=args.codename)
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    gmmvi.train_iters(args.warmup)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        gmmvi.train_iter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, median, q3 = statistics.quantiles(walls, n=4)
    print(json.dumps({
        "codename": args.codename, "experiment": args.experiment,
        "other_b6": args.other_b6, "warmup": args.warmup,
        "steps": args.steps, "median_ms": median, "q1_ms": q1, "q3_ms": q3,
        "fevals": int(gmmvi.state.db.num_samples_written),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
