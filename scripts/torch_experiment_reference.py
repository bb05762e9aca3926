#!/usr/bin/env python3
"""The PyTorch port's runner on one bundled experiment: the port's side of
``scripts/jax_experiment_reference.py``, on the card or on the CPU.

``python3 scripts/torch_experiment_reference.py --experiment talos --iters
501 --seeds 10000,10001 [--device cpu]`` builds
``get_default_config("SAMTRON", experiment)`` with each ``start_seed`` in
turn (the initial mixture, the generator and, for wine, the data split),
drives ``GmmviRunner.iterate_and_log`` for ``--iters`` iterations and
prints one JSON line per evaluation (seed, iteration, ELBO, fevals,
components, the target's ``bi_*`` metrics) and one per run (its median
step ms and wall time).  The wine target's batch order also follows the
process's ``PYTHONHASHSEED``.  With ``--plain-kernels B5,B6,B7`` (any of
them) the named kernels are replaced by their plain PyTorch versions, so
that a run on the card can be compared with the same run through the
kernels.  On the card the last line is its name and power limit as
``nvidia-smi`` gives them.
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


def use_plain_versions(kernels) -> None:
    """Replace the large-D kernels named in ``kernels`` (B5, B6, B7) by
    their plain PyTorch versions in the modules that call them."""
    from gmmvi_tpu_torch.ops import density_large, stein

    unknown = set(kernels) - {"B5", "B6", "B7"}
    if unknown:
        raise ValueError(f"no plain-version switch for {sorted(unknown)}")
    if "B5" in kernels:
        density_large.densities_large = density_large.densities_large_plain
        density_large.mixture_logpdf_large = \
            density_large.mixture_logpdf_large_plain
    if "B6" in kernels:
        density_large.density_grads_large = \
            density_large.density_grads_large_plain
    if "B7" in kernels:
        stein.stein_smom = stein.stein_smom_plain


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default="talos")
    ap.add_argument("--codename", default="SAMTRON")
    ap.add_argument("--iters", type=int, default=501)
    ap.add_argument("--seeds", default="10000")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads")
    ap.add_argument("--plain-kernels", default="",
                    help="e.g. B5,B6,B7: run these as plain versions")
    args = ap.parse_args()

    import torch

    import gmmvi_tpu_torch.configs as configs
    from gmmvi_tpu_torch import GmmviRunner

    if args.threads:
        torch.set_num_threads(args.threads)
    plain = [k for k in args.plain_kernels.split(",") if k]
    use_plain_versions(plain)
    for seed in (int(s) for s in args.seeds.split(",")):
        cfg = configs.get_default_config(args.codename, args.experiment)
        cfg["start_seed"] = seed
        runner = GmmviRunner.build_from_config(cfg, device=args.device)
        if hasattr(runner.target_distribution, "make_plots"):
            runner.target_distribution.make_plots = False
        walls = []
        t0 = time.time()
        for n in range(args.iters):
            out = runner.iterate_and_log(n)
            walls.append(out["walltime"])
            if "-elbo" in out:
                print(json.dumps({
                    "seed": seed, "iteration": n, "elbo": -out["-elbo"],
                    "fevals": out["num_samples"],
                    "components": out["num_components"],
                    **{k: v for k, v in out.items() if k.startswith("bi_")}}),
                    flush=True)
        print(json.dumps({
            "experiment": args.experiment, "codename": args.codename,
            "seed": seed, "device": args.device, "iterations": args.iters,
            "plain_kernels": plain,
            "median_step_ms": statistics.median(walls[1:]) * 1e3
            if len(walls) > 1 else None,
            "wall_s": time.time() - t0}), flush=True)
    if args.device != "cpu":
        from chip_smoke import nvidia_smi

        print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
