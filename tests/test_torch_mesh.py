"""Meshed runs of the port (``parallel/mesh.py``, ``parallel/reduce.py``)
against the JAX package, with ranks on the CPU over gloo.

The ranks run in fresh processes (``tests/torch_mesh_worker.py``, which
imports no JAX); the JAX package's states, draws and steps are made here
and handed over as numpy arrays.  Two spawns in all, each a module fixture
running every case of its kind: two ranks on a ``data`` mesh, and four on
a 2 x 2 ``("data", "comp")`` mesh.  Steps are held leaf by leaf at the
one-step bar (integer leaves exactly, floats within rtol 1e-4 / atol
1e-5): the global layout against JAX's unmeshed step, the sharded layout
against JAX's step on a 2-device data mesh, the hybrid mesh against JAX's
unmeshed step.  After every step the ranks check that the replicated
state is equal on all of them.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64,
                          samtron_overrides, xdist_lock, zamtrux_overrides)

import gmmvi_tpu_torch
from gmmvi_tpu_torch.parallel import mesh as mesh_ops

SMALL = dict(kmax=8, n_des=24, k0=5, del_iters=6, add_iters=5)
DIMS = 5
STARTS = (0, 4)          # 4: the step adds a component (add_iters 5)
SHARDED_STARTS = (2, 4)
ZAMTRUX_SHARDED_START = 2
TRAJ_STEPS = 4
SPAWN_TIMEOUT_S = 420


def _draws_np(d) -> dict:
    return {f.name: None if getattr(d, f.name) is None
            else getattr(d, f.name).numpy() for f in dataclasses.fields(d)}


def _interpret(mp):
    mp.setenv("GMMVI_FUSED_DENSITY", "interpret")
    mp.setenv("GMMVI_FUSED_TR", "interpret")


def _jax_steps(jg, start, float64=False):
    """(leaves before, draws, leaves after) of JAX's step ``start`` (the
    run advanced to it first); in float64 on its XLA routes with
    ``float64``."""
    for _ in range(start):
        jg.train_iter()
    before = jax_state_leaves(jg.state)
    if not float64:
        draws = jax_step_draws(jg)
        jg.train_iter()
        return before, draws, jax_state_leaves(jg.state)
    before = as_float64(before)
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(
            jg.target_distribution)
        jg.state = jax_state_from_leaves(jg.state, before)
        draws = jax_step_draws(jg, dtype=jnp.float64)
        jg.train_iter()
        return before, draws, jax_state_leaves(jg.state)


def _jax_meshed(over, codename="SAMTRON"):
    """JAX's GMMVI of ``over`` on a 2-device data mesh."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.experiments.targets.student_t_mixture import \
        make_target as j_target
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu.parallel.mesh import data_mesh

    jc = jcfg.update_config(jcfg.get_default_algorithm_config(codename),
                            over)
    jc["target_fn"] = jt = j_target(DIMS, False, seed=0)
    _, jm, jmeta = j_init(jc)
    return JGMMVI.build_from_config(jc, jt, jm, jmeta, mesh=data_mesh(2))


def _case(codename, over, mesh, before=None, draws=None, steps=1, **kw):
    return dict(codename=codename, overrides=over, dims=DIMS, mesh=mesh,
                state=before, steps=steps,
                draws=None if draws is None else [_draws_np(draws)], **kw)


ERROR_VARIANTS = {
    "decimate": {"tpu": {"db_layout": "sharded", "db_eviction": "decimate"}},
    "indivisible": {"tpu": {"db_layout": "sharded", "max_components": 7},
                    "sample_selector_config": {
                        "desired_samples_per_component": 25}},
    "auto_indivisible": {"tpu": {"db_layout": "auto", "max_components": 7},
                         "sample_selector_config": {
                             "desired_samples_per_component": 25}},
    "auto": {"tpu": {"db_layout": "auto"}},
}


def _jax_errors(over) -> dict:
    import warnings

    import gmmvi_tpu.configs as jcfg

    out = {}
    for name, extra in ERROR_VARIANTS.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                jg = _jax_meshed(jcfg.update_config(over, extra))
                out[name] = (type(jg.state.db).__name__,
                             [str(w.message) for w in caught
                              if "db_layout" in str(w.message)])
            except ValueError as err:
                out[name] = str(err)
    return out


def _spawn(tmp_path_factory, cases, nprocs):
    from torch_mesh_worker import run_cases

    d = tmp_path_factory.mktemp(f"mesh{nprocs}")
    with open(d / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    with xdist_lock(tmp_path_factory, "tests"):
        mesh_ops.spawn(run_cases, nprocs, "gloo",
                       args=(str(d / "cases.pkl"), str(d / "out.pkl")),
                       timeout_s=SPAWN_TIMEOUT_S)
    with open(d / "out.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def data_runs(tmp_path_factory):
    """Every two-rank case, run in one spawn: {name: (case, result,
    reference)}."""
    cases, refs = {}, {}
    over = samtron_overrides(**SMALL)
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        for start in STARTS:
            jg, _ = build_pair(dims=DIMS, **SMALL)
            before, draws, after = _jax_steps(jg, start)
            cases[f"global{start}"] = _case(
                "SAMTRON", {**over, "tpu": {**over["tpu"],
                                            "db_layout": "global"}},
                ("data", 2), before, draws)
            refs[f"global{start}"] = after
        jg = _jax_meshed(over)
        for start in SHARDED_STARTS:
            before, draws, after = _jax_steps(jg, start - jg.num_updates)
            cases[f"sharded{start}"] = _case("SAMTRON", over, ("data", 2),
                                             before, draws)
            refs[f"sharded{start}"] = after
        errors = _jax_errors(over)
    z_over = zamtrux_overrides(**SMALL)
    jg, _ = build_pair(dims=DIMS, codename="ZAMTRUX", **SMALL)
    before, draws, after = _jax_steps(jg, 7, float64=True)
    cases["zamtrux64"] = _case(
        "ZAMTRUX", {**z_over, "tpu": {**z_over["tpu"],
                                      "db_layout": "global"}},
        ("data", 2), before, draws, float64=True)
    refs["zamtrux64"] = after
    # the sharded layout from a JAX state of a 2-device data mesh, at a
    # step whose count bounds keep every iteration (JAX's code and the
    # port then agree: they differ only where a bound falls inside one)
    jg = _jax_meshed(z_over, "ZAMTRUX")
    before, draws, after = _jax_steps(jg, ZAMTRUX_SHARDED_START,
                                      float64=True)
    cases["zamtrux64_sharded"] = _case("ZAMTRUX", z_over, ("data", 2),
                                       before, draws, float64=True)
    refs["zamtrux64_sharded"] = after
    cases["trajectory"] = _case(
        "SAMTRON", {**over, "tpu": {**over["tpu"], "db_layout": "global"}},
        ("data", 2), steps=TRAJ_STEPS)
    cases["checkpoint"] = _case("SAMTRON", over, ("data", 2), steps=5,
                                checkpoint=2)
    cases["errors"] = dict(kind="errors", codename="SAMTRON",
                           overrides=over, dims=DIMS, mesh=("data", 2),
                           variants=ERROR_VARIANTS)
    refs["errors"] = errors
    names = list(cases)
    results = _spawn(tmp_path_factory, [cases[n] for n in names], 2)
    return {n: (cases[n], r, refs.get(n)) for n, r in zip(names, results)}


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    """Every four-rank case, run in one spawn."""
    cases, refs = {}, {}
    over = samtron_overrides(**SMALL)
    over["tpu"]["db_layout"] = "global"
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        for start in STARTS:
            jg, _ = build_pair(dims=DIMS, **SMALL)
            before, draws, after = _jax_steps(jg, start)
            cases[f"hybrid{start}"] = _case("SAMTRON", over, ("hybrid", 2),
                                            before, draws)
            refs[f"hybrid{start}"] = after
    cases["helpers"] = dict(kind="helpers", tpu_sections={
        "none": {}, "data4": {"data_shards": 4},
        "data2comp2": {"data_shards": 2, "comp_shards": 2},
        "allcomp2": {"data_shards": "all", "comp_shards": 2},
        "data8": {"data_shards": 8}})
    names = list(cases)
    results = _spawn(tmp_path_factory, [cases[n] for n in names], 4)
    return {n: (cases[n], r, refs.get(n)) for n, r in zip(names, results)}


def _assert_step(run):
    case, result, want = run
    got = result["states"][0]
    assert set(got) == set(want) - {"key"}
    assert int(got["db.num_samples_written"]) == int(
        want["db.num_samples_written"])
    assert_states_match(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("start", STARTS)
def test_global_layout_step_matches_jax_unmeshed(data_runs, start):
    """P = 2 on the replicated ring (every rank writes the gathered batch;
    densities, backgrounds and sums over each rank's rows, reduced): one
    step from JAX's state with JAX's draws equals JAX's unmeshed step."""
    _, result, _ = data_runs[f"global{start}"]
    assert result["layout"] == "SampleDbState"
    # the ring's write gathers the target's outputs: batch-sized bytes
    assert result["collectives"][0]["bytes"] > 24 * 8 * 4
    _assert_step(data_runs[f"global{start}"])


@pytest.mark.parametrize("start", SHARDED_STARTS)
def test_sharded_layout_step_matches_jax_on_a_data_mesh(data_runs, start):
    """A JAX state of a 2-device data mesh (``db_layout: auto``, so
    sharded: ``[2, ...]`` rings and reservoirs) carried into two ranks, each
    holding its shard, and stepped once with JAX's draws: the gathered
    state equals JAX's meshed step (``start`` 4 adds a component from the
    sharded reservoir)."""
    _, result, _ = data_runs[f"sharded{start}"]
    assert result["layout"] == "ShardedSampleDbState"
    _assert_step(data_runs[f"sharded{start}"])


def test_zamtrux_float64_step_matches_jax_unmeshed(data_runs):
    """ZAMTRUX (reuse 2.0: the background over old distributions, MORE's
    Gram reduced over the ranks) at P = 2 in float64 against JAX's
    unmeshed step in float64 (MORE's float32 fit, ridge 1e-12, would let
    rounding decide)."""
    case, result, want = data_runs["zamtrux64"]
    assert result["states"][0]["model.means"].dtype == np.float64
    assert int(want["db.num_samples_written"]) > int(
        case["state"]["db.num_samples_written"])
    _assert_step(data_runs["zamtrux64"])


def test_sharded_zamtrux_float64_step_matches_jax_on_a_data_mesh(data_runs):
    """ZAMTRUX on the sharded layout: a JAX state of a 2-device data mesh
    carried into two ranks and stepped once in float64 with JAX's draws
    (each rank's window over its shard, the mixed background from the
    ``[R Kmax]`` all-reduced counts, B4 on the shard's rows, MORE's Gram
    reduced over the ranks) equals JAX's meshed step.  At this start every
    row written so far fits the reuse bound (reused samples per component
    times the active components), so no bound falls inside an iteration,
    where the port keeps the iteration and JAX's code drops it."""
    case, result, want = data_runs["zamtrux64_sharded"]
    before = case["state"]
    reused = int(2.0 * SMALL["n_des"])
    assert int(before["db.num_samples_written"]) <= reused * int(
        before["model.num_active"])
    assert before["db.sample_iter"].shape[0] == 2
    assert result["layout"] == "ShardedSampleDbState"
    assert result["states"][0]["model.means"].dtype == np.float64
    assert int(want["db.num_samples_written"]) > int(
        before["db.num_samples_written"])
    _assert_step(data_runs["zamtrux64_sharded"])


def test_four_steps_match_the_unmeshed_port(data_runs):
    """Four steps at P = 2 from the generator's draws (every rank draws
    what an unmeshed run draws) against the unmeshed port: within rtol /
    atol 5e-4 with equal num_active and fevals, the bar
    tests/test_sharding.py holds the JAX package to."""
    from torch_mesh_worker import build

    case, result, _ = data_runs["trajectory"]
    g = build({**case, "mesh": None})
    for got in result["states"]:
        g.train_iter()
        want = gmmvi_tpu_torch.state_to_numpy(g.state)
        assert int(got["model.num_active"]) == int(want["model.num_active"])
        assert int(got["db.num_samples_written"]) == int(
            want["db.num_samples_written"])
        assert_states_match(got, want, rtol=5e-4, atol=5e-4)


def test_checkpoint_resumes_bitwise(data_runs):
    """A P = 2 run on the sharded layout saves at step 2 (one file, the
    ``[2, ...]`` shards gathered, rank 0 writing); fresh ranks load it,
    each keeping its shard, and steps 3-5 equal the unbroken run's to the
    bit."""
    _, result, _ = data_runs["checkpoint"]
    assert result["layout"] == "ShardedSampleDbState"
    unbroken, resumed = result["states"][2:], result["resumed"]
    assert len(resumed) == 3
    for a, b in zip(resumed, unbroken):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(ERROR_VARIANTS))
def test_layout_errors_match_jax(data_runs, name):
    """``db_layout: sharded`` with ``decimate`` and with a batch the data
    axis does not divide raise the JAX package's ValueError; ``auto``
    falls back to the global ring with its warning there, and picks the
    sharded layout where the batch divides."""
    _, got, want = data_runs["errors"]
    if isinstance(want[name], str):
        assert got[name] == want[name]
        return
    layout, warned = got[name]
    assert layout == want[name][0]
    assert [w for w in warned if "db_layout" in w] == want[name][1]


@pytest.mark.parametrize("start", STARTS)
def test_hybrid_step_matches_jax_unmeshed(hybrid_runs, start):
    """A 2 x 2 ``("data", "comp")`` mesh: each comp rank takes 4 of the 8
    components through the stepsizes, the estimate and the trust-region
    search, the slices gathered back; one step equals JAX's unmeshed
    step."""
    _, result, _ = hybrid_runs[f"hybrid{start}"]
    _assert_step(hybrid_runs[f"hybrid{start}"])


def test_mesh_helpers(hybrid_runs):
    """``mesh_from_config`` and ``hybrid_mesh`` in a world of four ranks,
    as the JAX package's build them from its devices: the names, shapes
    and the errors."""
    _, got, _ = hybrid_runs["helpers"]
    assert got["none"] is None
    assert got["data4"] == (("data",), (4,))
    assert got["data2comp2"] == (("data", "comp"), (2, 2))
    assert got["allcomp2"] == (("data", "comp"), (2, 2))
    assert got["data8"].startswith("ValueError: tpu mesh config requests 8 "
                                   "devices")
    assert "not divisible by num_comp=3" in got["hybrid3"]
