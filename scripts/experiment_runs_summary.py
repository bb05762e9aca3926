#!/usr/bin/env python3
"""Summarize runs of one experiment printed by
``scripts/torch_experiment_reference.py`` or
``scripts/jax_experiment_reference.py``.

``python3 scripts/experiment_runs_summary.py [--pool] FILE [FILE ...]``
reads each file's JSON lines, splits them into runs (a new run starts at
iteration 0) and prints one JSON line per file (with ``--pool``, one for
all files together): the number of runs, the ELBO at the first and last
evaluation of each run, the median, lowest and highest last ELBO, and,
where the target reports ``bi_test_loss`` (wine), the runs whose last
test loss is at or above ``chip_smoke.WINE_EXCURSION_LOSS`` (1.0:
excursions), the floor and ceiling
that ``chip_smoke.py`` sets from the others (their lowest last ELBO less
the spread of their last ELBOs, their highest test loss plus the spread
of their test losses) and the runs that would fail ``chip_smoke.py``'s
wine bars (an ELBO not above its start or below ``ELBO_FLOOR["wine"]``,
a test loss above ``WINE_TEST_LOSS_CEILING``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def runs_of(path: str) -> list:
    """Each run's evaluations, in order, from one file's JSON lines."""
    runs = []
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "iteration" not in rec or "elbo" not in rec:
                continue
            if rec["iteration"] == 0 or not runs:
                runs.append([])
            runs[-1].append(rec)
    return runs


def summary(paths) -> dict:
    from chip_smoke import (ELBO_FLOOR, WINE_EXCURSION_LOSS,
                            WINE_TEST_LOSS_CEILING)

    runs = [run for path in paths for run in runs_of(path)]
    last = [r[-1]["elbo"] for r in runs]
    out = dict(files=paths, runs=len(runs),
               first_and_last=[(r[0]["elbo"], r[-1]["elbo"]) for r in runs],
               median_last=statistics.median(last), lowest_last=min(last),
               highest_last=max(last))
    if all("bi_test_loss" in r[-1] for r in runs):
        losses = [r[-1]["bi_test_loss"] for r in runs]
        sound = [(e, loss) for e, loss in zip(last, losses)
                 if loss < WINE_EXCURSION_LOSS]
        out.update(test_losses=losses,
                   excursions=len(runs) - len(sound),
                   ended_below_start=sum(r[-1]["elbo"] <= r[0]["elbo"]
                                         for r in runs),
                   fail_wine_bars=sum(
                       not (r[-1]["elbo"] > r[0]["elbo"]
                            and r[-1]["elbo"] >= ELBO_FLOOR["wine"]
                            and r[-1]["bi_test_loss"]
                            <= WINE_TEST_LOSS_CEILING) for r in runs))
        if sound:
            e = [s[0] for s in sound]
            losses = [s[1] for s in sound]
            out.update(sound_floor=min(e) - (max(e) - min(e)),
                       sound_loss_ceiling=max(losses) + (max(losses)
                                                         - min(losses)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--pool", action="store_true",
                    help="one summary of all files' runs together")
    args = ap.parse_args()
    groups = [args.files] if args.pool else [[p] for p in args.files]
    for paths in groups:
        print(json.dumps(summary(paths)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
