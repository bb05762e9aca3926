"""The bucketed target evaluation (``tpu.compact_target_eval``) and the last
public helpers of the port, against the JAX package.

A safe target is evaluated on the proposal's valid rows, moved to the
front and cut to the smallest size of a ladder of halvings that holds them
(``GMMVI._eval_target_bucketed``), with the JAX package's enabled rule and
ladder; under the sharded layout each rank compacts its own rows.  Held
here: the ladder and the rule for every mode, selector, reuse, target kind
and rank count, against the JAX instance's ``_eval_buckets``; the JAX
package's own on/off test (tests/test_end_to_end.py
``test_bucketed_target_eval_matches_full``) through the port, with a
counting target; one step with the setting on, leaf by leaf against JAX;
the shard-local mode on two gloo ranks (tests/torch_mesh_worker.py) against
the setting off; and ``fit_linear``, ``gmm.log_density_and_grad`` and
``MetaState.history_length``.
"""
import itertools
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_leaves, jax_step_draws,
                          port_target_to_float64, samtron_overrides,
                          xdist_lock)

import gmmvi_tpu_torch

torch.set_num_threads(2)

DIMS = 5
SMALL = dict(kmax=8, n_des=24, k0=5, del_iters=6, add_iters=5)
MODES = ("on", "off", "auto")
# the component-based (M) and the mixture-based (P) selector
CODENAMES = ("SAMTRON", "SAPTRON")
REUSE = (0.0, 2.0)
SHARDED_STEPS = 4
SPAWN_TIMEOUT_S = 300


def _overrides(codename, reuse, mode):
    over = samtron_overrides(**SMALL)
    over["sample_selector_config"]["ratio_reused_samples_to_desired"] = reuse
    over["tpu"]["compact_target_eval"] = mode
    return over


def _jax_gmmvi(codename, over, safe, mesh=None):
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment
    from gmmvi_tpu.experiments.targets.student_t_mixture import make_target
    from gmmvi_tpu.optimization.gmmvi import GMMVI

    cfg = jcfg.update_config(jcfg.get_default_algorithm_config(codename),
                             over)
    cfg["target_fn"] = target = make_target(DIMS, False, seed=0)
    target._safe_for_jit = safe
    _, model, meta = init_experiment(cfg)
    return GMMVI.build_from_config(cfg, target, model, meta, mesh=mesh)


def _port_gmmvi(codename, over, safe):
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = tcfg.update_config(tcfg.get_default_algorithm_config(codename),
                             over)
    cfg["target_fn"] = target = make_target(DIMS, False, seed=0,
                                            device="cpu")
    target._safe_for_jit = safe
    _, model, meta = init_experiment(cfg, device="cpu")
    return GMMVI.build_from_config(cfg, target, model, meta, device="cpu")


LADDER_CASES = list(itertools.product(MODES, CODENAMES, REUSE,
                                      (True, False)))


def _case_name(mode, codename, reuse, safe):
    return f"{mode}-{codename}-{reuse}-{'safe' if safe else 'host'}"


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One spawn of two gloo ranks (tests/torch_mesh_worker.py): the
    ladder of every case of the ladder test on a 2-rank data mesh (the
    sharded layout), then the sharded SAMTRON of tests/test_sharded_db.py's
    shard-local test with the setting on and off."""
    from torch_mesh_worker import run_cases

    from gmmvi_tpu_torch.parallel import mesh as mesh_ops

    variants = {_case_name(*c): (c[1], _overrides(c[1], c[2], c[0]), c[3])
                for c in LADDER_CASES}
    cases = [dict(kind="buckets", dims=DIMS, mesh=("data", 2),
                  variants=variants)]
    for mode in ("on", "off"):
        over = _overrides("SAMTRON", 1.0, mode)
        over["tpu"]["db_layout"] = "sharded"
        cases.append(dict(codename="SAMTRON", overrides=over, dims=DIMS,
                          mesh=("data", 2), state=None, draws=None,
                          steps=SHARDED_STEPS, count_rows=True))
    d = tmp_path_factory.mktemp("compact_mesh")
    with open(d / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    out = d / "out.pkl"
    with xdist_lock(tmp_path_factory, "tests") as base:
        # one spawn per run: the first worker to get here leaves its
        # results for the others
        shared = None if base is None else Path(f"{base}.compact_mesh.pkl")
        if shared is not None and shared.exists():
            out = shared
        else:
            mesh_ops.spawn(run_cases, 2, "gloo",
                           args=(str(d / "cases.pkl"), str(out)),
                           timeout_s=SPAWN_TIMEOUT_S)
            if shared is not None:
                shutil.copyfile(out, shared)
    with open(out, "rb") as fh:
        buckets, on, off = pickle.load(fh)
    return {"buckets": buckets, "on": on, "off": off}


@pytest.mark.parametrize("ranks", (1, 2))
@pytest.mark.parametrize("mode,codename,reuse,safe", LADDER_CASES)
def test_ladder_and_rule_match_jax(request, mode, codename, reuse, safe,
                                   ranks):
    """The port's ladder (``_eval_buckets``) and its count of compacting
    ranks equal the JAX instance's for every mode, selector, reuse and
    target kind, unmeshed and on a 2-rank data mesh (sharded layout: the
    ladder of a rank's rows); unmeshed, ``grow_capacity`` rebuilds both
    alike."""
    over = _overrides(codename, reuse, mode)
    if ranks == 1:
        jg = _jax_gmmvi(codename, over, safe)
        tg = _port_gmmvi(codename, over, safe)
        got = (tg._eval_buckets, tg._bucket_shards)
    else:
        from gmmvi_tpu.parallel.mesh import data_mesh

        jg = _jax_gmmvi(codename, over, safe, mesh=data_mesh(2))
        got = request.getfixturevalue("mesh_runs")["buckets"][
            _case_name(mode, codename, reuse, safe)]
    want = (jg._eval_buckets, jg._bucket_shards)
    assert got == want
    enabled = (mode == "on" or (mode == "auto" and reuse > 0)) \
        and safe and codename == "SAMTRON"
    assert (got[0] is not None) == enabled
    if ranks == 1:
        jg.grow_capacity(16)
        tg.grow_capacity(16)
        assert tg._eval_buckets == jg._eval_buckets
        assert (tg._eval_buckets is not None) == enabled


def test_shard_local_ladder_needs_a_data_axis():
    """``shard_local_buckets`` without a mesh raises, as in JAX."""
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    g = _port_gmmvi("SAMTRON", _overrides("SAMTRON", 2.0, "on"), True)
    kw = {k: getattr(g, k) for k in (
        "target_distribution", "state", "temperature", "selector_cfg",
        "estimator_type", "estimator_cfg", "updater_type",
        "component_stepsize_type", "component_stepsize_cfg",
        "weight_updater_type", "weight_updater_cfg", "weight_stepsize_type",
        "weight_stepsize_cfg", "vips_cfg", "device")}
    kw["initial_state"] = kw.pop("state")
    with pytest.raises(ValueError, match="'data' axis"):
        GMMVI(**kw, seed=0, shard_local_buckets=True)


def _e2e_config(cfgmod, target, mode):
    """tests/test_end_to_end.py's ``_base_config("SAMTRON", target,
    n_des=24, ratio=2.0, kmax=8, k0=3, seed=3)`` with the setting."""
    cfg = cfgmod.get_default_algorithm_config("SAMTRON")
    return cfgmod.update_config(cfg, {
        "start_seed": 3, "seed": 3, "target_fn": target,
        "environment_name": "test",
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 3,
            "prior_mean": 0.0, "prior_scale": 3.0, "initial_cov": 4.0},
        "use_sample_database": True, "max_database_size": 100000,
        "temperature": 1.0,
        "sample_selector_config": {"desired_samples_per_component": 24,
                                   "ratio_reused_samples_to_desired": 2.0},
        "num_component_adapter_config": {
            "del_iters": 8, "add_iters": 5, "max_components": 8,
            "thresholds_for_add_heuristic": [500.0, 100.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 256, "num_prior_samples": 0},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": 8, "compact_target_eval": mode}})


def _draws_to_float64(draws):
    """The generator's float32 draws cast (exactly) to float64."""
    for name in ("eps", "accept_u", "add_a", "db_u", "prior_eps"):
        value = getattr(draws, name)
        if value is not None:
            setattr(draws, name, value.double())
    return draws


def _counted_run(mode, steps=12):
    """The port on :func:`_e2e_config` with ``mode`` for ``steps`` steps in
    float64: (GMMVI, rows of each target call, valid rows of each
    proposal)."""
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.gmm import make_simple_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    target = make_simple_target(device="cpu")
    cfg = _e2e_config(tcfg, target, mode)
    _, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    port_target_to_float64(target)
    g.state = gmmvi_tpu_torch.state_from_numpy(
        as_float64(gmmvi_tpu_torch.state_to_numpy(g.state)), device="cpu",
        like=g.state)
    draw = g.draw
    g.draw = lambda i: _draws_to_float64(draw(i))
    calls, valid = [], []
    evaluate = target.log_density_and_grad
    target.log_density_and_grad = lambda x: (calls.append(x.shape[0]),
                                             evaluate(x))[1]
    propose = g._propose_phase

    def recording(state, draws):
        prop = propose(state, draws)
        valid.append(int(prop.valid.sum()))
        return prop

    g._propose_phase = recording
    for _ in range(steps):
        g.train_iter()
    return g, calls, valid


def test_on_and_off_trajectories_agree_with_jax_buckets(tmp_path_factory):
    """The JAX package's own test configuration through the port, 12 steps
    with the setting on, off and auto: means and log weights within 1e-6,
    equal fevals; a counting target sees, each step, the bucket the JAX
    ladder picks for that step's valid count (on and auto), or the whole
    proposal (off).  In float64: in float32 the GMM target's plain density
    pack rounds a row differently at another row count, which 12 steps
    carry to 1.3e-5 in a mean."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment
    from gmmvi_tpu.experiments.targets.gmm import make_simple_target
    from gmmvi_tpu.optimization.gmmvi import GMMVI

    jt = make_simple_target()
    jc = _e2e_config(jcfg, jt, "on")
    _, jm, jmeta = init_experiment(jc)
    ladder = GMMVI.build_from_config(jc, jt, jm, jmeta)._eval_buckets
    assert ladder is not None and len(ladder) >= 2
    with xdist_lock(tmp_path_factory, "tests"):
        runs = {mode: _counted_run(mode) for mode in ("on", "off", "auto")}

    batch = 8 * 24
    g_on, calls, valid = runs["on"]
    want = [ladder[min(int(np.searchsorted(ladder, n, side="left")),
                       len(ladder) - 1)] for n in valid]
    assert calls == want
    assert min(calls) < batch          # the steady state's small buckets
    assert runs["auto"][1] == want
    assert runs["off"][1] == [batch] * 12
    for mode in ("off", "auto"):
        g = runs[mode][0]
        for leaf in ("means", "log_weights"):
            np.testing.assert_allclose(
                getattr(g_on.state.model, leaf).numpy(),
                getattr(g.state.model, leaf).numpy(), rtol=1e-6, atol=1e-6)
        assert int(g_on.state.db.num_samples_written) == int(
            g.state.db.num_samples_written)


@pytest.mark.parametrize("start", (3,))
def test_one_bucketed_step_matches_jax_leaf_by_leaf(monkeypatch,
                                                    tmp_path_factory, start):
    """SAMTRON with reuse 2.0 (both packages bucket under ``auto``): one
    step from JAX's state after ``start`` steps, with JAX's draws, leaf by
    leaf at the one-step bar (integer leaves exactly, floats within rtol
    1e-4 / atol 1e-5), its target call given a bucket smaller than the
    proposal."""
    monkeypatch.setenv("GMMVI_FUSED_DENSITY", "interpret")
    monkeypatch.setenv("GMMVI_FUSED_TR", "interpret")
    jg, tg = build_pair(dims=DIMS, ratio=2.0, **SMALL)
    assert tg._eval_buckets == jg._eval_buckets is not None
    calls = []
    with xdist_lock(tmp_path_factory, "tests"):
        for _ in range(start):
            jg.train_iter()
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            jax_state_leaves(jg.state), device="cpu", like=tg.state)
        draws = jax_step_draws(jg)
        evaluate = tg._eval_target
        tg._eval_target = lambda x: (calls.append(x.shape[0]),
                                     evaluate(x))[1]
        jg.train_iter()
        tg.train_iter(draws)
    assert len(calls) == 1 and calls[0] < SMALL["kmax"] * SMALL["n_des"]
    j_named = jax_state_leaves(jg.state)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert set(t_named) == set(j_named) - {"key"}
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def test_shard_local_on_matches_off_on_two_ranks(mesh_runs):
    """Two gloo ranks on the sharded layout, each compacting its own rows
    into the bucket of the larger rank's count: four steps with the setting
    on against off within rtol / atol 1e-5 (the JAX package's bar in
    tests/test_sharded_db.py), equal fevals, and the buckets of a rank's
    96 rows below 96 once the reuse window fills."""
    on, off = mesh_runs["on"], mesh_runs["off"]
    assert on["layout"] == off["layout"] == "ShardedSampleDbState"
    local = 8 * 24 // 2
    assert all(r == [local] for r in off["rows"])
    assert all(len(r) == 1 and r[0] <= local for r in on["rows"])
    assert min(r[0] for r in on["rows"]) < local
    for got, want in zip(on["states"], off["states"]):
        for leaf in ("model.means", "model.log_weights"):
            np.testing.assert_allclose(got[leaf], want[leaf], rtol=1e-5,
                                       atol=1e-5)
        assert int(got["db.num_samples_written"]) == int(
            want["db.num_samples_written"])


def test_fit_linear_matches_jax():
    """tests/test_api_parity.py's linear fit through the port, and the
    port's coefficients against JAX's with weights and a mask."""
    from gmmvi_tpu.ops.quadratic import fit_linear as j_fit

    from gmmvi_tpu_torch.ops.quadratic import fit_linear

    rng = np.random.RandomState(0)
    n, d = 100, 3
    x = rng.randn(n, d).astype(np.float32)
    w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
    y = x @ w_true + 0.7
    params = fit_linear(torch.tensor(1e-8), torch.as_tensor(x),
                        torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(params[:d], w_true, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(params[d], 0.7, rtol=1e-3)

    weights = rng.uniform(0.1, 2.0, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    y_noisy = (y + 0.1 * rng.randn(n)).astype(np.float32)
    want = np.asarray(j_fit(jnp.asarray(0.5), jnp.asarray(x),
                            jnp.asarray(y_noisy), jnp.asarray(weights),
                            jnp.asarray(mask)))
    got = fit_linear(0.5, torch.as_tensor(x), torch.as_tensor(y_noisy),
                     torch.as_tensor(weights), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got64 = fit_linear(0.5, torch.as_tensor(x, dtype=torch.float64),
                       torch.as_tensor(y_noisy, dtype=torch.float64),
                       torch.as_tensor(weights, dtype=torch.float64),
                       torch.as_tensor(mask))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-4, atol=1e-5)


def test_log_density_and_grad_and_history_length_match_jax():
    """``gmm.log_density_and_grad`` (model log densities, gradients and
    component log densities) against JAX's on the same mixture and
    samples, and ``MetaState.history_length``."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.models import meta as jmeta

    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.models import meta as tmeta

    rng = np.random.RandomState(2)
    k, d, n = 3, 4, 50
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    mu = rng.randn(k, d).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32)
    covs = (a @ a.transpose(0, 2, 1) + d * np.eye(d)).astype(np.float32)
    x = (2 * rng.randn(n, d)).astype(np.float32)
    js = jgmm.create_gmm_state(w, mu, covs, max_components=6)
    ts = tgmm.create_gmm_state(w, mu, covs, max_components=6, device="cpu")
    want = jgmm.log_density_and_grad(js, jnp.asarray(x))
    got = tgmm.log_density_and_grad(ts, torch.as_tensor(x))
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        assert g.shape == wv.shape
        live = np.isfinite(wv)
        np.testing.assert_array_equal(np.isfinite(g.numpy()), live)
        np.testing.assert_allclose(g.numpy()[live], wv[live], rtol=1e-4,
                                   atol=1e-4)
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 7)
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 7)
    assert tm.history_length == jm.history_length == 7
