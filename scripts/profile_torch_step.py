#!/usr/bin/env python3
"""Where one step of the PyTorch port spends its time on the card.

Builds a main path as ``chip_smoke.py`` does (``--codename SAMTRON``, the
flagship: the 20-D Student-T mixture, 45 components padded to 48, 200
samples per component; or ``ZAMTRUX``, VIPS with sample reuse at the same
widths; with ``--experiment stm300`` or ``gmm20``, the codename on that
experiment from ``get_default_config(codename, experiment)``: the 300-D
Student-T mixture, the runner path's 20-D GMM, which starts from one
component, so give it a longer ``--warmup``, the 34-D Talos IK posterior
or the 177-D wine BNN, whose steps take the host-target path), with
``--search`` another trust-region search (``tpu.trust_region_search``) and
with ``--decimate`` the decimating database (``tpu.db_eviction: decimate``,
``max_database_size`` 65,536, as ``chip_smoke.py``'s zamtrux_decimate
path), runs warm-up steps, then
traces ``--steps`` steps with ``torch.profiler``.  Writes the profiler's
table (sorted by device time) to
``<out-dir>/profile_torch_step_<codename>[_<experiment>].txt`` and prints
one JSON line:
wall ms per step, device-busy ms per step (the sum of kernel and copy
times; one stream, so they do not overlap), the idle share, device
operations (kernels and copies) and device-to-host copies per step, and
device ms per step for the port's kernels and for the largest other groups.

Run from the repository root on a machine with the card:
``python3 scripts/profile_torch_step.py [--codename ZAMTRUX]
[--experiment stm300 | talos | wine | gmm20 --warmup 600]
[--search newton | grid | bracket-eigen] [--decimate]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--codename", default="SAMTRON",
                    choices=("SAMTRON", "ZAMTRUX"))
    ap.add_argument("--experiment", default="flagship",
                    choices=("flagship", "stm300", "gmm20", "talos",
                             "wine"))
    ap.add_argument("--search", default="bracket",
                    choices=("bracket", "newton", "grid", "bracket-eigen"))
    ap.add_argument("--decimate", action="store_true",
                    help="the decimating database, 65,536 samples")
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out-dir", default=os.path.join("build", "profile"),
                    help="directory for the profiler's table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available",
              file=sys.stderr)
        return 1

    from chip_smoke import DECIMATE_DB_SIZE, D, flagship_config
    from gmmvi_tpu_torch.configs import get_default_config, update_config
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    dev = resolve_device("cuda")
    over = {"tpu": {"trust_region_search": args.search}}
    if args.decimate:
        over = {"max_database_size": DECIMATE_DB_SIZE,
                "tpu": {**over["tpu"], "db_eviction": "decimate"}}
    if args.experiment != "flagship":
        cfg = update_config(get_default_config(args.codename,
                                               args.experiment), over)
        target, model, meta = init_experiment(cfg, device=dev)
    else:
        target = make_target(num_dimensions=D, harder_setting=False, seed=0,
                             device=dev)
        cfg = update_config(flagship_config(codename=args.codename), over)
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=dev)
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device=dev)
    gmmvi.train_iters(args.warmup)
    torch.cuda.synchronize()

    cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gmmvi.train_iters(args.steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)

    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=60)
    os.makedirs(args.out_dir, exist_ok=True)
    suffix = ("" if args.experiment == "flagship" else
              f"_{args.experiment}") + (
        "" if args.search == "bracket" else f"_{args.search}") + (
        "_decimate" if args.decimate else "")
    with open(os.path.join(args.out_dir,
                           f"profile_torch_step_{args.codename}{suffix}.txt"),
              "w") as fh:
        fh.write(table)

    def dev_us(ev) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, attr):
                return float(getattr(ev, attr))
        return 0.0

    groups = {"density_pack_kernel": "B1 density_pack_kernel",
              "densities_kernel": "B2 densities_kernel",
              "density_wide_kernel": "B1/B2 density_wide_kernel",
              "tr_kl_kernel": "B3 tr_kl_kernel",
              "tr_search_kernel": "B3 tr_search_kernel",
              "background_kernel": "B4/B9 background_kernel",
              "more_gram_kernel": "B8 more_gram_kernel",
              "large_comp_kernel": "B5 large_comp_kernel",
              "large_split_kernel": "B5 pre-passes",
              "large_xtiles_kernel": "B5/B6 sample slabs",
              "large_lse_kernel": "B5 large_lse_kernel",
              "large_grad_kernel": "B6 large_grad_kernel",
              "grad_resp_kernel": "B6 pre-passes",
              "grad_split_kernel": "B6 pre-passes",
              "stein_mma_kernel": "B7 stein_mma_kernel",
              "stein_tiles_kernel": "B7 pre-passes",
              "stein_weights_kernel": "B7 pre-passes"}
    per_group: dict = {}
    busy_us = 0.0
    device_ops = copies_to_host = 0
    for ev in events:
        us = dev_us(ev)
        if us <= 0 or ev.key.startswith("aten::") or ev.key.startswith(
                "cuda"):
            continue
        busy_us += us
        device_ops += ev.count
        if "DtoH" in ev.key:
            copies_to_host += ev.count
        name = next((label for key, label in groups.items()
                     if key in ev.key), ev.key[:60])
        per_group[name] = per_group.get(name, 0.0) + us
    steps = args.steps
    top = sorted(per_group.items(), key=lambda kv: -kv[1])[:16]
    out = {
        "device": torch.cuda.get_device_name(0),
        "codename": args.codename,
        "experiment": args.experiment,
        "search": args.search,
        "decimate": args.decimate,
        "warmup": args.warmup,
        "num_active": int(gmmvi.model.num_active),
        "max_components": gmmvi.model.max_components,
        "steps": steps,
        "wall_ms_per_step": wall_s / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "idle_share": 1.0 - (busy_us / 1e6) / wall_s,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "device_ops_per_step": device_ops / steps,
        "device_to_host_copies_per_step": copies_to_host / steps,
        "device_ms_per_step": {k: v / steps / 1e3 for k, v in top},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
