#!/usr/bin/env python3
"""The benchmark of ``gmmvi_tpu_torch`` on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell named in ``BENCHMARK.json`` from its configuration and
traffic mix, warms up, replays the same block of ``GMMVI.train_iter`` from a
snapshot for ``--seconds``, and prints, as its last line on standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``, with the compared numbers beside
their limits under ``checks``, last.  The same numbers are the last lines
on standard error.  Without a card, or with fewer cards than the cell asks
for, it prints no result and exits 2; if the process has loaded ``jax``,
``jaxlib``, ``flax`` or ``gmmvi_tpu`` it exits 3.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import core, harness

    bench = core.load_benchmark()
    cell = core.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card is available: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    result = harness.measure(
        args.workload, core.config_spec(cell),
        core.traffic_spec(cell["traffic"]), args.seed, args.seconds,
        bool(args.trace), "cuda", core.limits_spec(args.workload),
        metric_names=core.metric_names(bench, args.workload, "end_to_end"),
        per_layer=core.metric_names(bench, args.workload, "per_layer"),
        started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = ("not compared" if c["limit"] is None
                 else f"limit {c['limit']}")
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
