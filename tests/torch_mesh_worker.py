"""Rank workers for the meshed-port tests (tests/test_torch_mesh.py).

Ranks are started with ``gmmvi_tpu_torch.parallel.mesh.spawn`` and run
here, in fresh processes that never import JAX: this module imports the
port only.  A test hands the ranks a list of cases in a pickle file (the
JAX package's states and draws as numpy arrays, prepared in the test
process) and reads rank 0's results from another.  Not a test module
itself.

A case is a dict: ``codename``, ``overrides`` (``update_config`` of the
codename's default algorithm config), ``dims`` (of the Student-T target),
``mesh`` (``("data", P)``, ``("hybrid", M)`` or None: the config's
``tpu`` section decides), ``state`` (leaves keyed by path to start from,
or None), ``draws`` (one dict of StepDraws fields per step, or None: the
generator's), ``steps``, ``float64``, ``checkpoint`` (a step count: save
there, go on, then resume a fresh GMMVI from the file and step it the same
way; the resumed states are recorded too), ``safe`` (False: the target
taken as not ``safe_for_jit``), ``count_rows`` (record the rows of every
target evaluation, per step).  After every step the replicated state is
checked equal on every rank.  Other kinds: ``errors`` (the ValueError or
database of each variant), ``helpers`` (the meshes ``parallel.mesh``
builds) and ``buckets`` (each variant's target-evaluation ladder).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg
from gmmvi_tpu_torch.experiments.setup import init_experiment
from gmmvi_tpu_torch.experiments.targets.student_t_mixture import make_target
from gmmvi_tpu_torch.optimization.gmmvi import GMMVI, StepDraws
from gmmvi_tpu_torch.parallel import mesh as mesh_ops
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.utils import checkpoint as ckpt


def _target_to_float64(target) -> None:
    """The Student-T target evaluated in float64 from here on (its float32
    parameters cast exactly)."""
    for name in ("_means", "_chols", "_inv_chols", "_log_dets", "_log_w"):
        setattr(target, name, getattr(target, name).double())


def _mesh(spec):
    if spec is None:
        return None
    kind, n = spec
    if kind == "data":
        return mesh_ops.data_mesh(n, device_type="cpu")
    return mesh_ops.hybrid_mesh(n, device_type="cpu")


def build(case):
    """A GMMVI of ``case`` in this rank, from its start state if given."""
    cfg = tcfg.update_config(
        tcfg.get_default_algorithm_config(case["codename"]),
        case["overrides"])
    target = make_target(case["dims"], False, seed=0, device="cpu")
    if case.get("safe") is False:
        target._safe_for_jit = False
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu",
                                mesh=_mesh(case.get("mesh")))
    named = case.get("state")
    if case.get("float64"):
        _target_to_float64(target)
        if named is None:
            named = gmmvi_tpu_torch.gathered_state_to_numpy(g.state)
        named = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in named.items()}
    if named is not None:
        with reduce.scope(g.mesh):
            g.state = gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                                       like=g.state)
    return g


def _draws(d):
    if d is None:
        return None
    return StepDraws(**{k: None if v is None else torch.as_tensor(v)
                        for k, v in d.items()})


def _gathered(g):
    with reduce.scope(g.mesh):
        return gmmvi_tpu_torch.gathered_state_to_numpy(g.state)


def _steps(g, case, lo, hi, out):
    draws = case.get("draws")
    rows: list = []
    if case.get("count_rows"):
        evaluate = g._eval_target
        g._eval_target = lambda x: (rows.append(x.shape[0]), evaluate(x))[1]
        out["rows"] = []
    for i in range(lo, hi):
        reduce.reset_stats()
        g.train_iter(_draws(None if draws is None else draws[i]))
        if case.get("count_rows"):
            out["rows"].append(list(rows))
            rows.clear()
        out["collectives"].append(dict(reduce.STATS))
        mesh_ops.check_replicated(g.state)
        out["states"].append(_gathered(g))


def _errors(case) -> dict:
    """For each of the case's ``variants`` (further overrides), the
    ValueError of building it on this mesh, or the database it built and
    the warnings on the way."""
    import warnings

    out = {}
    for name, extra in case["variants"].items():
        sub = {**case, "overrides": tcfg.update_config(case["overrides"],
                                                       extra)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                g = build(sub)
                out[name] = (type(g.state.db).__name__,
                             [str(w.message) for w in caught])
            except ValueError as err:
                out[name] = str(err)
    return out


def _buckets(case) -> dict:
    """For each of the case's ``variants`` (codename, overrides, safe), the
    target-evaluation ladder the port builds on this mesh and its count of
    ranks that compact their own rows."""
    out = {}
    for name, (codename, over, safe) in case["variants"].items():
        g = build({**case, "codename": codename, "overrides": over,
                   "safe": safe})
        out[name] = (g._eval_buckets, g._bucket_shards)
    return out


def _helpers(case) -> dict:
    """What ``parallel.mesh`` builds in this world: dimension names and
    shapes, or the error's message."""
    out = {}
    for name, tpu in case["tpu_sections"].items():
        try:
            m = mesh_ops.mesh_from_config(tpu, device_type="cpu")
            out[name] = None if m is None else (tuple(m.mesh_dim_names),
                                                tuple(m.shape))
        except ValueError as err:
            out[name] = f"ValueError: {err}"
    try:
        mesh_ops.hybrid_mesh(3, device_type="cpu")
    except ValueError as err:
        out["hybrid3"] = f"ValueError: {err}"
    return out


def run_case(rank: int, case: dict, ckpt_path: str) -> dict:
    kind = case.get("kind", "steps")
    if kind == "errors":
        return _errors(case)
    if kind == "helpers":
        return _helpers(case)
    if kind == "buckets":
        return _buckets(case)
    g = build(case)
    out = {"states": [], "collectives": [], "resumed": [],
           "layout": type(g.state.db).__name__}
    at = case.get("checkpoint")
    if at is None:
        _steps(g, case, 0, case["steps"], out)
        return out
    _steps(g, case, 0, at, out)
    with reduce.scope(g.mesh):
        ckpt.save_state(ckpt_path, g.state, g.generator)
    torch.distributed.barrier()
    _steps(g, case, at, case["steps"], out)
    fresh = build({**case, "state": None, "float64": False})
    with reduce.scope(fresh.mesh):
        state, gen = ckpt.load_state(ckpt_path, fresh.state, device="cpu")
    fresh.state = state
    fresh.generator.set_state(gen)
    resumed = {"states": [], "collectives": []}
    _steps(fresh, case, at, case["steps"], resumed)
    out["resumed"] = resumed["states"]
    return out


def run_cases(rank: int, nprocs: int, cases_path: str, out_path: str
              ) -> None:
    """Every case of the pickle at ``cases_path`` in this rank; rank 0
    pickles the results (one dict per case) to ``out_path``."""
    with open(cases_path, "rb") as fh:
        cases = pickle.load(fh)
    results = [run_case(rank, case, f"{out_path}.{i}.ckpt.npz")
               for i, case in enumerate(cases)]
    if rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(results, fh)


def card_first_step(rank: int, nprocs: int, work: str) -> None:
    """The first step of ``chip_smoke.py``'s mesh path M1 (the flagship
    SAMTRON on the global ring, a data mesh of ``nprocs`` ranks) in this
    rank on cuda:0, with the draws in ``work``/draws0.npz; rank 0 saves the
    gathered state to ``work``/state1.npz."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from gmmvi_tpu_torch.device import resolve_device

    torch.cuda.set_device(0)
    dev = resolve_device("cuda")
    g = chip_smoke.mesh_gmmvi("M1", dev)
    with np.load(Path(work) / "draws0.npz", allow_pickle=True) as z:
        draws = chip_smoke._torch_draws(z["draws"].item(), dev)
    g.train_iter(draws)
    mesh_ops.check_replicated(g.state)
    named = _gathered(g)
    if rank == 0:
        np.savez(Path(work) / "state1.npz", **named)
