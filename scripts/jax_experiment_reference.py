#!/usr/bin/env python3
"""The JAX package's runner on one bundled experiment, on the CPU: the
reference values the PyTorch port's runs of the same experiment are held
to (``chip_smoke.py`` takes its bars for breast_cancer, german_credit,
planar_robot_4, talos and wine from these runs).

``python3 scripts/jax_experiment_reference.py --experiment breast_cancer
--iters 1000`` builds ``get_default_config("SAMTRON", experiment)`` (with
``--num-initial-components`` a smaller initial mixture, for a run that
fits a small host, and with ``--seed`` another ``start_seed``: the initial
mixture, the run's random keys and, for wine, the data split) and drives ``GmmviRunner.iterate_and_log`` for
``--iters`` iterations, printing one JSON line per evaluation (iteration,
ELBO, fevals, components, the target's metrics) and a last line with the
run's wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default="breast_cancer")
    ap.add_argument("--codename", default="SAMTRON")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--num-initial-components", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args()

    import gmmvi_tpu.configs as configs
    from gmmvi_tpu import GmmviRunner

    cfg = configs.get_default_config(args.codename, args.experiment)
    if args.num_initial_components is not None:
        cfg = configs.update_config(cfg, {"model_initialization": {
            "num_initial_components": args.num_initial_components}})
    if args.seed is not None:
        cfg["start_seed"] = args.seed
    runner = GmmviRunner.build_from_config(cfg)
    if hasattr(runner.target_distribution, "make_plots"):
        runner.target_distribution.make_plots = False
    t0 = time.time()
    for n in range(args.iters):
        out = runner.iterate_and_log(n)
        if "-elbo" in out:
            print(json.dumps({
                "iteration": n, "elbo": -float(out["-elbo"]),
                "fevals": int(out["num_samples"]),
                "components": int(out["num_components"]),
                **{k: v for k, v in out.items()
                   if k.startswith(("num_detected_modes", "elbo_fb", "bi_"))}}),
                flush=True)
    print(json.dumps({"experiment": args.experiment,
                      "codename": args.codename, "iterations": args.iters,
                      "seed": int(cfg["start_seed"]),
                      "kmax": int(runner.gmmvi.state.model.max_components),
                      "wall_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
