#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's numbers and the
control's on many seeds, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control] [--fault <a name in portbench/faults.py>] \\
        [--out readings.jsonl]

For each seed: the cell built and warmed up (once: the warmed state does
not depend on the seed), one captured iteration of the replayed block (the
timed window's first) with that seed's draws, judged against the
reference; with ``--control``, also judge the control, the reference with
TF32 on in the program's place, from the same snapshot and draws; with
``--fault``, the program's iteration runs with that fault planted
(``portbench/faults.py``).  One JSON line per seed and side.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell_name: str, seeds, control: bool, device,
             fault: str = None):
    """One JSON-able dict per seed and side.  The warmed state does not
    depend on the seed (``core.prepare``), so the cell is built and warmed
    up once and each seed only reseeds the replay's generator, as a run
    with that seed would."""
    import contextlib

    from portbench import check, core, faults

    bench = core.load_benchmark()
    cell = core.find_cell(bench, cell_name)
    cfg_spec = core.config_spec(cell)
    mix_spec = core.traffic_spec(cell["traffic"])
    cfg, replay = core.prepare(cfg_spec, mix_spec, seeds[0], device)
    opt, dev = replay.opt, replay.device
    window_rows = core.built_sizes(opt)["window_rows"]
    for seed in seeds:
        opt.generator.manual_seed(int(seed) % core.SEED_MODULUS)
        replay.generator_state = opt.generator.get_state()
        rows = check.comp_rows(seed, window_rows)
        capture = check.Capture(opt, rows)
        planted = (faults.FAULTS[fault]() if fault
                   else contextlib.nullcontext())
        with planted:
            core.run_window(replay, 0.0, before=lambda i: capture.arm(),
                            after=lambda i: capture.disarm(),
                            max_iterations=1)
        t0 = time.perf_counter()
        numbers = check.judge(capture.data, cfg, replay.snapshot, dev)
        yield {"workload": cell_name, "seed": seed,
               "side": f"fault:{fault}" if fault else "program",
               "judge_s": time.perf_counter() - t0, **numbers}
        if control:
            t0 = time.perf_counter()
            cand = check.reference_step(cfg, replay.snapshot,
                                        capture.data["draws"], rows, dev,
                                        tf32=True)
            numbers = check.judge(cand, cfg, replay.snapshot, dev)
            yield {"workload": cell_name, "seed": seed, "side": "control",
                   "judge_s": time.perf_counter() - t0, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of portbench/faults.py in the "
                         "program's timed iteration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None
    try:
        for cell in args.workload:
            for line in readings(cell, args.seeds, args.control,
                                 args.device, args.fault):
                text = json.dumps(line)
                print(text, flush=True)
                if sink is not None:
                    sink.write(text + "\n")
                    sink.flush()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
