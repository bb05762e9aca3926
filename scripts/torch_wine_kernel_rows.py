#!/usr/bin/env python3
"""wine's path on the card and its kernels on their last inputs, every row
printed whether it passes or not.

``PYTHONHASHSEED=H python3 scripts/torch_wine_kernel_rows.py`` runs
``chip_smoke.wine_phase`` (``get_default_config("SAMTRON", "wine")``
through the runner, n = 0..200; the BNN orders its minibatches by
``hash(("bnn", seed))``, so each hash seed H gives another run) and then
B5 at each entry and call size, B6 and B7 on the inputs of their last
launch, as ``chip_smoke.py``'s phase 5 holds them (B5 and B6: the fixed
bar, and where the kernel misses it the float64 comparison with its
first-order float32 bound), printing one JSON line per row with the hash
seed.  Exits 1 if a row fails; without a card, exits 1 at once.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_wine_kernel_rows: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gmmvi_tpu_torch.ops import cuda

    dev = torch.device("cuda")
    cuda.build_all()
    captured: dict = {}
    cs.wine_phase(dev, captured)
    rows = [(f"{k[0]} K={k[1]} N={k[2]}", cs.measure_large_density(
        k[0], captured[k]))
        for k in sorted(k for k in captured if isinstance(k, tuple))]
    rows.append(("density_grads_large", cs.measure_large_grads(
        captured["density_grads_large"])))
    rows.append(("stein_smom", cs.measure_stein(captured["stein_smom"])))
    for label, row in rows:
        print(json.dumps({"hashseed": os.environ.get("PYTHONHASHSEED"),
                          "label": label, **row}), flush=True)
    return 0 if all(row["ok"] for _, row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
