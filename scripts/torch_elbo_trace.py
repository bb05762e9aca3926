#!/usr/bin/env python3
"""Trace the ELBO of SAMTRON on ``stm300`` on the card, every 10 steps.

Builds ``get_default_config("SAMTRON", "stm300")`` (the 300-D Student-T
mixture, 20 components padded to 40, 100 fresh and 200 reused samples per
component) through ``init_experiment`` and ``GMMVI.build_from_config``,
runs ``--iters`` ``train_iter()`` steps and prints one JSON line after
step 1 and every 10 steps: the ELBO and the mean target
log-density of 2,000 draws from the mixture, as the JAX package's runner
estimates them (``chip_smoke.mc_elbo``), their difference (the entropy
estimate), the newest window's mean target log-density and the component
count.  With ``--plain-iters N`` it then runs N steps again from the same
start with kernels B5-B7 replaced by their plain PyTorch versions, so the
two traces can be compared line by line.  Last, the card's name and power
limit as ``nvidia-smi`` gives them.

Run from the repository root on a machine with the card:
``python3 scripts/torch_elbo_trace.py [--iters 130] [--plain-iters 40]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def trace(tag: str, iters: int) -> None:
    from chip_smoke import mc_elbo, newest_window_mean_lnpdf
    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_config("SAMTRON", "stm300")
    target, model, meta = init_experiment(cfg, device="cuda")
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device="cuda")
    for step in range(1, iters + 1):
        gmmvi.train_iter()
        if step == 1 or step % 10 == 0:
            elbo, density = mc_elbo(gmmvi.state.model, target)
            print(json.dumps({
                "run": tag, "step": step, "elbo": elbo,
                "draws_mean_target_lnpdf": density,
                "entropy": elbo - density,
                "window_mean_target_lnpdf":
                    newest_window_mean_lnpdf(gmmvi.state.db),
                "num_active": int(gmmvi.state.model.num_active)}),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=130)
    ap.add_argument("--plain-iters", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_elbo_trace: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from gmmvi_tpu_torch.ops import density_large, stein

    trace("kernels", args.iters)
    if args.plain_iters:
        density_large.densities_large = density_large.densities_large_plain
        density_large.mixture_logpdf_large = \
            density_large.mixture_logpdf_large_plain
        density_large.density_pack_large = \
            density_large.density_pack_large_plain
        stein.stein_smom = stein.stein_smom_plain
        trace("plain", args.plain_iters)
    from chip_smoke import nvidia_smi

    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
