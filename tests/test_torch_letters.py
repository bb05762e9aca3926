"""The rest of the codename matrix in the PyTorch port against the JAX
package: fixed adaptation (E), the mixture-based selector (P), the direct
and iBLR updaters (I, Y), the fixed and decaying component stepsizes (F,
D), the decaying weight stepsize (G) and standard importance weights.

Three levels, as the other port tests hold the port:

* functions, with the same numpy inputs (and JAX's draws injected);
* one step, leaf by leaf, from a JAX state carried across with JAX's draws
  injected: integers exact, floats within rtol 1e-4 / atol 1e-5;
* 80-iteration trajectories at the scale of test_full_optimizer_parity.py
  (dims 6, kmax 12, n_des 48): fevals equal, final ELBO within 1.0,
  component counts within 2; the float64 ones also leaf by leaf after
  every step.

The JAX side runs its density kernels in interpret mode.  Its trust-region
KL kernel (interpret mode) reads the upper triangle of the interpolated
precision, where its XLA route (``jnp.linalg.cholesky``) symmetrizes it;
the two agree on the symmetric Hessians of every estimator but the
standard-IW Stein estimate, whose Hessian is not symmetric.  The port
symmetrizes, so standard-IW SAMTRON is held against JAX's XLA route.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64, mc_elbo,
                          port_target_to_float64, standard_iw_overrides)

import gmmvi_tpu_torch
from gmmvi_tpu.models import gmm as jgmm
from gmmvi_tpu.models import meta as jmeta
from gmmvi_tpu_torch.models import gmm as tgmm
from gmmvi_tpu_torch.models import meta as tmeta

torch.set_num_threads(2)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, rtol=1e-5, atol=1e-5, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err)


def _states(k=5, kmax=8, d=4, seed=0, offset=0.0):
    rng = np.random.RandomState(seed)
    means = (rng.randn(k, d) * 3 + offset).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.4
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=kmax)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=kmax,
                               device="cpu")
    return rng, js, ts


def _metas(js, ts, stepsize=0.1, updates=None):
    jm = jmeta.create_meta_state(js, stepsize, 1e-12, 6)
    tm = tmeta.create_meta_state(ts, stepsize, 1e-12, 6)
    if updates is not None:
        jm = jm.replace(num_received_updates=jnp.asarray(updates))
        tm = tm.replace(num_received_updates=_t(updates))
    return jm, tm


def _assert_update_match(tr, jr, rtol=1e-4, atol=1e-5):
    for name in ("means", "chols", "inv_chols", "log_weights"):
        _close(getattr(tr.model, name), getattr(jr.model, name), rtol, atol,
               name)
    for name in ("l2_regularizers", "num_received_updates", "stepsizes"):
        _close(getattr(tr.meta, name), getattr(jr.meta, name), 1e-6, 0,
               name)


def _jax_routes(monkeypatch, case):
    """JAX's density kernels in interpret mode, its trust-region KL kernel
    too but for standard-IW SAMTRON (its XLA route, see the module
    docstring)."""
    monkeypatch.setenv("GMMVI_FUSED_DENSITY", "interpret")
    if case == "SAMTRON-standard-IW":
        monkeypatch.delenv("GMMVI_FUSED_TR", raising=False)
    else:
        monkeypatch.setenv("GMMVI_FUSED_TR", "interpret")


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fixed", "decaying"])
def test_component_stepsizes_match_jax(kind):
    """F and D: D's s0 / (1 + n^0.55) on each component's update count
    (0 among them), exact to float32 rounding."""
    from gmmvi_tpu.optimization import stepsize_adapters as jst
    from gmmvi_tpu_torch.optimization import stepsize_adapters as tst

    _, js, ts = _states()
    updates = np.array([0, 1, 2, 7, 30, 129, 0, 0], np.float32)
    jm, tm = _metas(js, ts, stepsize=1e-5, updates=updates)
    cfg = {"initial_stepsize": 1.0, "annealing_exponent": 0.55}
    got = tst.COMPONENT_STEPSIZE_ADAPTERS[kind](tm, cfg)
    want = jst.COMPONENT_STEPSIZE_ADAPTERS[kind](jm, cfg)
    _close(got, want, rtol=1e-6, atol=0)


def test_decaying_weight_stepsize_matches_jax():
    """G over twelve calls: the stepsize and the update count, with the
    reference's exponent 0.5."""
    from gmmvi_tpu.optimization import stepsize_adapters as jst
    from gmmvi_tpu_torch.optimization import stepsize_adapters as tst

    _, js, ts = _states()
    jm, tm = _metas(js, ts)
    cfg = {"initial_stepsize": 1.0, "annealing_exponent": 0.5}
    jw = jst.create_weight_stepsize_state(1.0)
    tw = tst.create_weight_stepsize_state(1.0, device="cpu")
    for _ in range(12):
        jw = jst.WEIGHT_STEPSIZE_ADAPTERS["decaying"](jw, js, jm, cfg)
        tw = tst.WEIGHT_STEPSIZE_ADAPTERS["decaying"](tw, ts, tm, cfg)
        _close(tw.stepsize, jw.stepsize, rtol=1e-6, atol=0)
        assert float(tw.num_updates) == float(jw.num_updates)


def _hessians(rng, kmax, d, symmetric=True):
    h = rng.randn(kmax, d, d).astype(np.float32) * 0.3
    hneg = np.einsum("kij,klj->kil", h, h) + 0.05 * np.eye(d,
                                                           dtype=np.float32)
    if not symmetric:
        hneg = hneg + 0.02 * rng.randn(kmax, d, d).astype(np.float32)
    return hneg, rng.randn(kmax, d).astype(np.float32)


@pytest.mark.parametrize("symmetric", [True, False])
def test_direct_update_matches_jax(symmetric):
    """I: the precision-space step, its factors from one flipped Cholesky
    (symmetrized, as jnp.linalg.cholesky does: the asymmetric case is the
    standard-IW Hessian's), the mean, and the success mask, with one
    component made infeasible (its new precision not positive definite)."""
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    rng, js, ts = _states(k=5, kmax=8, d=6, seed=3)
    jm, tm = _metas(js, ts)
    hneg, gneg = _hessians(rng, 8, 6, symmetric)
    hneg[2] -= 50.0 * np.eye(6, dtype=np.float32)
    steps = np.full(8, 0.2, np.float32)
    jr = jcu.UPDATERS["direct"](js, jm, jnp.asarray(hneg), jnp.asarray(gneg),
                                jnp.asarray(steps))
    tr = tcu.UPDATERS["direct"](ts, tm, _t(hneg), _t(gneg), _t(steps))
    _assert_update_match(tr, jr)
    assert float(tr.meta.l2_regularizers[2]) > 1e-12     # the failure
    assert torch.equal(tr.model.means[2], ts.means[2])


@pytest.mark.parametrize("updates", ["first", "later"])
def test_iblr_update_matches_jax(updates):
    """Y: the curvature-corrected precision step; on a component's first
    update (no updates received) the mean does not move."""
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    rng, js, ts = _states(k=5, kmax=8, d=6, seed=4)
    counts = (np.zeros(8, np.float32) if updates == "first" else
              np.array([3, 0, 1, 9, 2, 0, 0, 0], np.float32))
    jm, tm = _metas(js, ts, updates=counts)
    hneg, gneg = _hessians(rng, 8, 6)
    steps = np.full(8, 0.1, np.float32)
    jr = jcu.UPDATERS["iBLR"](js, jm, jnp.asarray(hneg), jnp.asarray(gneg),
                              jnp.asarray(steps))
    tr = tcu.UPDATERS["iBLR"](ts, tm, _t(hneg), _t(gneg), _t(steps))
    _assert_update_match(tr, jr)
    moved = (tr.model.means[:5] != ts.means[:5]).any(dim=1)
    assert moved.tolist() == [bool(c > 0) for c in counts[:5]]


def _mixture_selector_pair(ratio):
    """A JAX SEPIFUX run at the small scale after 4 steps (its database
    holds samples of four older mixtures) and the port's selector config."""
    jg, tg = build_pair(dims=4, codename="SEPIFUX", ratio=ratio, kmax=8,
                        n_des=24, k0=5)
    for _ in range(4):
        jg.train_iter()
    return jg, tg


@pytest.mark.parametrize("ratio", [0.0, 1.0])
def test_mixture_propose_matches_jax(ratio):
    """P's proposal with JAX's component indices and normals injected: the
    samples, their mapping and validity, and the reused count.  With a
    reuse window (ratio 1.0) the mixture's ESS decides how many fresh draws
    are valid."""
    from gmmvi_tpu.optimization import sample_selectors as jsel
    from gmmvi_tpu_torch.optimization import sample_selectors as tsel

    jg, tg = _mixture_selector_pair(ratio)
    st = jg.state
    tstate = gmmvi_tpu_torch.state_from_numpy(jax_state_leaves(st),
                                              device="cpu", like=tg.state)
    draws = jax_step_draws(jg)
    _, k_sel = jax.random.split(st.key)
    jp = jsel.propose(st.model, st.db, jg.selector_cfg, k_sel)
    tp = tsel.propose(tstate.model, tstate.db, tg.selector_cfg, draws.eps,
                      draws.mapping)
    _close(tp.samples, jp.samples, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tp.mapping.numpy(), np.asarray(jp.mapping))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert int(tp.num_reused) == int(jp.num_reused)
    if ratio > 0:
        assert 0 < int(tp.num_reused) and 1 <= int(tp.valid.sum()) < 24
    else:
        assert int(tp.valid.sum()) == 24


def _window(seed=1, k=5, kmax=8, n=300, d=4):
    rng, js, ts = _states(k=k, kmax=kmax, d=d, seed=seed, offset=7.0)
    x = (rng.randn(n, d) * 2 + 7.0).astype(np.float32)
    return rng, js, ts, dict(
        x=x, bg=(rng.randn(n) - 4.0).astype(np.float32),
        lnp=(rng.randn(n) * 3).astype(np.float32),
        grads=rng.randn(n, d).astype(np.float32),
        mask=rng.rand(n) > 0.1,
        mapping=rng.randint(0, k, n).astype(np.int32))


def test_standard_iw_stein_matches_jax(monkeypatch):
    """The standard-IW Stein estimate (signed log-sum-exp per element,
    divided by each component's sample count, the Hessian unsymmetrized)
    against JAX's, with JAX's pack in moment form (interpret kernel) and
    from XLA; and the port's chunked sum over the samples against its
    one-shot sum."""
    from gmmvi_tpu.optimization.ng_estimators import stein_estimate as js_est
    from gmmvi_tpu_torch.optimization import ng_estimators as tne

    _, js, ts, w = _window()
    args = [w[k] for k in ("x", "mask", "mapping", "bg", "lnp", "grads")]
    t_est = tne.stein_estimate(ts, *map(_t, args),
                               use_self_normalized_importance_weights=False)
    h = t_est.expected_hessians_neg[:5].numpy()
    assert np.abs(h - h.transpose(0, 2, 1)).max() > 1e-3
    for mode in ("interpret", "0"):
        monkeypatch.setenv("GMMVI_FUSED_DENSITY", mode)
        j_est = js_est(js, *map(jnp.asarray, args),
                       use_self_normalized_importance_weights=False)
        _close(t_est.expected_gradients_neg[:5],
               j_est.expected_gradients_neg[:5], rtol=1e-5, atol=1e-5)
        _close(t_est.expected_hessians_neg[:5],
               j_est.expected_hessians_neg[:5], rtol=1e-4, atol=1e-5)
    # 7 samples a chunk: 43 chunks, each with its own maximum
    monkeypatch.setattr(tne, "_STANDARD_IW_CHUNK", 7 * 4 * 4)
    chunked = tne.stein_estimate(ts, *map(_t, args),
                                 use_self_normalized_importance_weights=False)
    _close(chunked.expected_hessians_neg, t_est.expected_hessians_neg,
           rtol=1e-5, atol=1e-7)


def test_standard_iw_expected_log_ratios_match_jax():
    """(1/n) signed log-sum-exp of log_iw + log|log ratio| over the valid
    samples, and the rewards it stores."""
    from gmmvi_tpu.optimization import weight_updaters as jwu
    from gmmvi_tpu_torch.optimization import weight_updaters as twu

    _, js, ts, w = _window(seed=4)
    jm, tm = _metas(js, ts)
    j_elr, jm = jwu.expected_log_ratios(
        js, jm, jnp.asarray(w["x"]), jnp.asarray(w["mask"]),
        jnp.asarray(w["bg"]), jnp.asarray(w["lnp"]), 1.0, False)
    t_elr, tm = twu.expected_log_ratios(
        ts, tm, _t(w["x"]), _t(w["mask"]), _t(w["bg"]), _t(w["lnp"]), 1.0,
        False)
    _close(t_elr[:5], j_elr[:5], rtol=1e-5, atol=1e-4)
    _close(tm.reward_history, jm.reward_history, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# One step, leaf by leaf
# ---------------------------------------------------------------------------

_STEP_CASES = {
    "SEPYFUX": dict(codename="SEPYFUX"),
    "SEMIDUG": dict(codename="SEMIDUG", ratio=2.0),
    "SEPIFUX-reuse": dict(codename="SEPIFUX", ratio=1.0),
    "SAMTRON-standard-IW": dict(codename="SAMTRON",
                                extra=standard_iw_overrides()),
}


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_one_step_matches_jax_leaf_by_leaf(monkeypatch, case):
    """One step from a JAX state carried across (the E runs' ``adapt``
    leaves included, and back), with JAX's draws injected, from the
    initial state and from the state after five steps: integer leaves
    exact, float leaves within rtol 1e-4 / atol 1e-5.  The second makes
    SAMTRON's step an add (add_iters 5) and starts the reuse paths from a
    database of five older mixtures."""
    _jax_routes(monkeypatch, case)
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5, **_STEP_CASES[case])
    for start in range(6):
        if start not in (0, 5):
            jg.train_iter()
            continue
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            jax_state_leaves(jg.state), device="cpu", like=tg.state)
        draws = jax_step_draws(jg)
        jg.train_iter()
        tg.train_iter(draws)
        j_named = jax_state_leaves(jg.state)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        assert set(t_named) == set(j_named) - {"key"}
        assert int(t_named["db.num_samples_written"]) > 0
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

_TRAJECTORIES = {
    "SEPYFUX": dict(codename="SEPYFUX"),
    "SEPYFUX-stepsize-0.02": dict(codename="SEPYFUX", extra={
        "component_stepsize_adapter_config": {"initial_stepsize": 0.02}}),
    "SEMIDUG": dict(codename="SEMIDUG"),
    "ZAMTRON": dict(codename="ZAMTRON"),
    "SAMTRON-standard-IW": dict(codename="SAMTRON",
                                extra=standard_iw_overrides()),
}
# the cases run in float64, with their iterations: SEPYFUX at its fixed
# stepsize 0.1 only as far as float64 decides the run (below)
_FLOAT64_ITERS = {"SEPYFUX": 15, "SEPYFUX-stepsize-0.02": 80}


def _float64_trajectory(jg, tg, iters):
    """``iters`` steps of both packages in float64 (the initial states'
    float32 leaves cast exactly, the targets evaluated in float64, JAX
    under ``jax.enable_x64`` on its XLA routes with its draws in float64),
    the states held leaf by leaf after every step; the final states'
    leaves, in float64."""
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(
            jg.target_distribution)
        jg.state = jax_state_from_leaves(
            jg.state, as_float64(jax_state_leaves(jg.state)))
    port_target_to_float64(tg.target_distribution)
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        as_float64(gmmvi_tpu_torch.state_to_numpy(tg.state)), device="cpu",
        like=tg.state)
    for _ in range(iters):
        with jax.enable_x64(True):
            draws = jax_step_draws(jg, dtype=jnp.float64)
            jg.train_iter()
        tg.train_iter(draws)
        with jax.enable_x64(True):
            j_named = jax_state_leaves(jg.state)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)
    return j_named, t_named


@pytest.mark.parametrize("case", sorted(_TRAJECTORIES))
def test_trajectory_matches_jax(monkeypatch, case):
    """80 iterations (SEPYFUX at stepsize 0.1: 15) at the trajectory scale of
    test_full_optimizer_parity.py (dims 6, kmax 12, n_des 48, no reuse)
    with JAX's draws injected every step: identical feval counts, final
    ELBO within 1.0, component counts within 2, finite ELBOs.

    The SEPYFUX cases run in float64 on both sides, leaf by leaf after
    every step as well.  At the overrides' fixed stepsize 0.1 the iBLR
    steps drive the components that lose their weight to singular
    precisions (float32 cannot factor them; the float32 runs end at ELBO
    -41.0 (JAX) and -42.9 (the port)).  In float64 JAX's covariances reach
    condition number 7.5e9 at step 15 and 7e16 at step 16; from there on
    the two packages' factors differ by up to 95%, whether the port sums
    its Stein moments in chunks or in one product, and the run's end (ELBO
    -4.72 or -65) is decided by rounding, not by float64.  So SEPYFUX at
    0.1 runs the 15 steps that float64 decides (the port's leaves within
    2e-7 of JAX's).  At stepsize 0.02 no covariance passes condition number
    1.7e3 over the 80 steps while components still lose their weight (log
    weights down to -69); the leaves agree to 1e-8 at every step."""
    x64 = case in _FLOAT64_ITERS
    if x64:
        monkeypatch.delenv("GMMVI_FUSED_DENSITY", raising=False)
        monkeypatch.delenv("GMMVI_FUSED_TR", raising=False)
        jg, tg = build_pair(**_TRAJECTORIES[case])
        j_named, t_named = _float64_trajectory(jg, tg,
                                               _FLOAT64_ITERS[case])
    else:
        _jax_routes(monkeypatch, case)
        jg, tg = build_pair(**_TRAJECTORIES[case])
        for _ in range(80):
            draws = jax_step_draws(jg)
            jg.train_iter()
            tg.train_iter(draws)
        j_named = jax_state_leaves(jg.state)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert int(t_named["db.num_samples_written"]) == int(
        j_named["db.num_samples_written"])
    assert abs(int(t_named["model.num_active"])
               - int(j_named["model.num_active"])) <= 2

    dtype = np.float64 if x64 else np.float32
    assert t_named["model.means"].dtype == j_named["model.means"].dtype \
        == dtype

    def j_model(x):
        with jax.enable_x64(x64):
            return np.asarray(jgmm.log_density(jg.state.model,
                                               jnp.asarray(x, dtype)))

    def t_model(x):
        return tgmm.log_density(tg.state.model,
                                torch.as_tensor(x.astype(dtype))).numpy()

    def j_target(x):
        with jax.enable_x64(x64):
            return np.asarray(jg.target_distribution.log_density(
                jnp.asarray(x, dtype)))

    def t_target(x):
        return tg.target_distribution.log_density(
            torch.as_tensor(x.astype(dtype))).numpy()

    elbos = [mc_elbo(m, tgt, named["model.means"], named["model.chols"],
                     named["model.log_weights"],
                     int(named["model.num_active"]))
             for named, m, tgt in ((j_named, j_model, j_target),
                                   (t_named, t_model, t_target))]
    assert np.isfinite(elbos).all(), elbos
    assert abs(elbos[0] - elbos[1]) < 1.0, elbos


# ---------------------------------------------------------------------------
# Codename coverage and the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "codename",
    ["SAMTRON", "ZAMTRUX", "SEPIFUX", "SEMTRUX", "SAMYROX", "ZEPIFUG",
     "SEMIDOX", "ZAPTRON"],
)
def test_representative_codenames_build_and_step(codename):
    """The port's twin of test_configs.py's coverage of the module matrix:
    each codename's defaults on the simple 2-D GMM target, with sample
    reuse (ratio 1.0), build and take two steps on the CPU with finite
    means."""
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.gmm import make_simple_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = get_default_algorithm_config(codename)
    cfg = update_config(cfg, {
        "start_seed": 0,
        "environment_name": "simple",
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 2,
            "prior_mean": 0.0, "prior_scale": 2.0, "initial_cov": 2.0,
        },
        "use_sample_database": True, "max_database_size": 10000,
        "temperature": 1.0,
        "sample_selector_config": {"desired_samples_per_component": 8,
                                   "ratio_reused_samples_to_desired": 1.0},
        "gmmvi_runner_config": {"log_metrics_interval": 10},
        "tpu": {"max_components": 4},
    })
    if cfg["num_component_adapter_type"] == "adaptive":
        cfg = update_config(cfg, {"num_component_adapter_config": {
            "del_iters": 5, "add_iters": 3, "num_database_samples": 64,
        }})
    # direct/iBLR updaters need small stepsizes (reference example 3 notes)
    if cfg["ng_based_updater_type"] in ("direct", "iBLR"):
        cfg = update_config(cfg, {"component_stepsize_adapter_config": {
            "initial_stepsize": 1e-4,
        }})
    cfg["target_fn"] = make_simple_target(device="cpu")
    target, model, meta = init_experiment(cfg, device="cpu")
    gmmvi = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    for _ in range(2):
        gmmvi.train_iter()
    k = int(gmmvi.state.model.num_active)
    assert gmmvi.num_updates == 2
    assert torch.isfinite(gmmvi.state.model.means[:k]).all()


def test_runner_drives_a_fixed_k_mixture_selector_config():
    """The runner on SEPYFUX / stm20 (fixed K: 20 components in 24 slots,
    100 draws a step from the mixture): metrics every iteration, the
    expensive ones at n = 0 and 2, fevals 100 a step, nothing of VIPS
    read."""
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch import GmmviRunner

    cfg = tcfg.update_config(tcfg.get_default_config("SEPYFUX", "stm20"),
                             {"gmmvi_runner_config":
                              {"log_metrics_interval": 2}})
    runner = GmmviRunner.build_from_config(cfg, device="cpu")
    assert runner.gmmvi.vips_cfg is None
    assert runner.gmmvi.state.model.max_components == 24
    for n in range(3):
        out = runner.iterate_and_log(n)
        assert out["num_samples"] == 100 * (n + 1)
        assert out["num_components"] == 20
        assert ("-elbo" in out) == (n % 2 == 0)
    assert np.isfinite(out["-elbo"]) and np.isfinite(out["entropy"])
