#!/usr/bin/env python3
"""Trace the ELBO of SAMTRON on ``stm300`` on the card, every 10 steps.

Builds ``get_default_config("SAMTRON", "stm300")`` (the 300-D Student-T
mixture, 20 components padded to 40, 100 fresh and 200 reused samples per
component) through ``init_experiment`` and ``GMMVI.build_from_config``,
runs ``--iters`` ``train_iter()`` steps and prints one JSON line after
step 1 and every 10 steps: the ELBO and the mean target log-density of
2,000 draws from the mixture, as the JAX package's runner estimates them
(``runner.sample_elbo``), their difference (the entropy estimate), the
newest window's mean target log-density, the component count and the
fevals so far (fresh samples written).  With ``--plain-iters N`` it then
runs N steps again from the same start with the kernels named in
``--plain-kernels`` (B5, B6 and B7 by default) replaced by their plain
PyTorch versions, so the two traces can be compared line by line: runs
of equally accurate float32 arithmetic that part only in the last bits.
Last, the card's name and power limit as ``nvidia-smi`` gives them.

Run from the repository root on a machine with the card:
``python3 scripts/torch_elbo_trace.py [--iters 130] [--plain-iters 40]
[--plain-kernels B5,B7]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def trace(tag: str, iters: int) -> None:
    from chip_smoke import elbo, newest_window_mean_lnpdf
    from gmmvi_tpu_torch.configs import get_default_config
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_config("SAMTRON", "stm300")
    target, model, meta = init_experiment(cfg, device="cuda")
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device="cuda")
    for step in range(1, iters + 1):
        gmmvi.train_iter()
        if step == 1 or step % 10 == 0:
            value, density = elbo(gmmvi.state.model, target)
            print(json.dumps({
                "run": tag, "step": step, "elbo": value,
                "draws_mean_target_lnpdf": density,
                "entropy": value - density,
                "window_mean_target_lnpdf":
                    newest_window_mean_lnpdf(gmmvi.state.db),
                "num_active": int(gmmvi.state.model.num_active),
                "fevals": int(gmmvi.state.db.num_samples_written)}),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=130)
    ap.add_argument("--plain-iters", type=int, default=0)
    ap.add_argument("--plain-kernels", default="B5,B6,B7")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_elbo_trace: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch_experiment_reference import use_plain_versions

    if args.iters:
        trace("kernels", args.iters)
    if args.plain_iters:
        plain = set(args.plain_kernels.split(","))
        use_plain_versions(plain)
        trace("plain " + "+".join(sorted(plain)), args.plain_iters)
    from chip_smoke import nvidia_smi

    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
