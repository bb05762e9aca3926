"""Run some phases of ``chip_smoke.py`` on the card, without the rest of
the script: a quick first call for new paths, and the investigations of
their checks.

Phases (any of them, in this order; all when none is named):
``stm300`` (SAMTRON on stm300 with the bracket, its accepted KLs watched),
``newton`` (stm300 with newton), ``search`` (the flagship with grid,
bracket-eigen and newton), ``stm1024``, ``decimate`` (the flagship ZAMTRUX
with the decimating database and its step-21 witness) and ``gmm20`` (the
gmm20 runner with prior samples and without a database), ``mesh`` (the
meshed paths M1-M7, ranks on the one card, then B1, B2 and B3's search
at a rank's shapes), ``diagonal`` (diagonal SAMTRON at D = 300),
``mnist`` (the MNIST BNN at D = 101,770: ``mnist_jax_test`` and
``mnist_wide``), ``examples`` (every ``examples_torch/`` script),
``compact`` (``tpu.compact_target_eval`` on and off in lockstep on
ZAMTRUX, the gmm20 runner config, planar_robot_4 and M5) and
``interface`` (the flagship SAMTRON on the registry's Student-T mixture
and on a ``log_density``-only ``LNPDF`` wrapping it, in lockstep).  Each
prints the lines the full script prints; ``--rows`` then holds the kernels on these
paths' last inputs against their plain versions.  ``--save-rebuild DIR``
writes each watched path's worst rebuilt trust-region update
(``chip_smoke.WORST_REBUILD``) to ``DIR/rebuild_<path>.npz`` for
``scripts/jax_rebuild_kl.py``.

Run from the repository root on a machine with a card:
``python3 scripts/chip_smoke_phases.py [phase ...] [--rows]
[--save-rebuild chiprun_out/rebuild]``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PHASES = ("stm300", "newton", "search", "stm1024", "decimate", "gmm20",
          "mesh", "diagonal", "mnist", "examples", "compact", "interface")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="*")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--save-rebuild", default=None)
    args = ap.parse_args()
    want = set(args.phases or PHASES)
    if want - set(PHASES):
        ap.error(f"unknown phases {sorted(want - set(PHASES))}; {PHASES}")

    import numpy as np

    import chip_smoke as cs
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.ops import cuda

    dev = resolve_device("cuda")
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    cs.emit({"phase": "build", "per_source_s": cuda.build_all(),
             "s": time.perf_counter() - t0})
    densities, large, dec = {}, {}, {}
    gmm20 = {"gmm20_prior": {}, "gmm20_nodb": {}}
    runs = [("stm300", lambda: cs.large_d_phase(dev, {})),
            ("newton", lambda: cs.stm300_newton_phase(dev, large)),
            *[("search", lambda p=p: cs.flagship_search_phase(dev, p,
                                                                densities))
              for p in cs.SEARCH_PATHS_12],
            ("stm1024", lambda: cs.stm1024_phase(dev)),
            ("decimate", lambda: cs.zamtrux_decimate_phase(dev, dec,
                                                           densities)),
            *[("gmm20", lambda p=p, c=c: cs.gmm20_variant_phase(
                dev, p, c, densities)) for p, c in gmm20.items()],
            ("mesh", lambda: cs.mesh_phases(dev)),
            ("mesh", lambda: cs.mesh_kernel_rows(dev)),
            ("diagonal", lambda: cs.diagonal_phase(dev)),
            ("mnist", lambda: cs.mnist_phase(dev)),
            ("examples", lambda: cs.examples_phase(dev)),
            # after the mesh phase, M5's compact records come from its ranks
            ("compact", lambda: cs.compact_phase(
                dev, m5_dir=cs.BUILD_DIR / "mesh" / "M5" if "mesh" in want
                else None)),
            ("interface", lambda: cs.interface_phase(dev))]
    failed = 0
    for name, run in runs:
        if name not in want:
            continue
        t = time.perf_counter()
        try:
            run()
        except AssertionError as err:
            failed += 1
            cs.emit({"phase": "failed", "name": name, "error": str(err)})
        cs.emit({"phase": "timing", "name": name,
                 "s": time.perf_counter() - t})
    if args.save_rebuild:
        os.makedirs(args.save_rebuild, exist_ok=True)
        for path, rec in cs.WORST_REBUILD.items():
            np.savez(os.path.join(args.save_rebuild, f"rebuild_{path}.npz"),
                     **{k: np.asarray(v) for k, v in rec.items()})
    if args.rows:
        for key in sorted(densities):
            cs.emit({"phase": "kernel_on_main_path_inputs",
                     "key": [str(k) for k in key],
                     **cs.measure_density(key[0], densities[key])})
        if dec and all(gmm20.values()):
            cs.slice12_input_rows(dec, gmm20)
        if large:
            cs.large_d_input_rows(large, "stm300_newton")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
