"""Diagonal covariances in the PyTorch port against the JAX package: the
model's functions, the diagonal trust-region KL and its bracket search,
the diagonal Stein and MORE estimates and the direct and iBLR steps, one
training step leaf by leaf, an 80-iteration SAMTRON trajectory, and
checkpoints.

The JAX package's kernels take full covariances only, so both sides are
plain arithmetic here; the same numpy inputs (from seeded
``np.random.RandomState``s) go through both, and JAX's random draws are
injected into the port's steps.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (assert_states_match, build_pair, jax_state_leaves,
                          jax_step_draws, mc_elbo, xdist_lock)

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg
from gmmvi_tpu.models import gmm as jgmm
from gmmvi_tpu.models import meta as jmeta
from gmmvi_tpu_torch.models import gmm as tgmm
from gmmvi_tpu_torch.models import meta as tmeta

torch.set_num_threads(2)

DIAGONAL = {"model_initialization": {"use_diagonal_covs": True}}


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, rtol=1e-5, atol=1e-5, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err)


def _states(k=5, kmax=8, d=4, seed=0, offset=0.0, dtype=np.float32):
    """(rng, JAX state, port state): ``k`` diagonal components in ``kmax``
    slots, variances in [0.2, 2.2]."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(k, d) * 3 + offset).astype(dtype)
    var = (0.2 + 2.0 * rng.rand(k, d)).astype(dtype)
    w = rng.dirichlet(np.ones(k)).astype(dtype)
    js = jgmm.create_gmm_state(w, means, var, max_components=kmax,
                               diagonal=True, dtype=dtype)
    ts = tgmm.create_gmm_state(w, means, var, max_components=kmax,
                               diagonal=True, device="cpu",
                               dtype=getattr(torch, np.dtype(dtype).name))
    return rng, js, ts


def _model_match(ts, js, rtol=1e-6, atol=1e-7):
    for name in ("log_weights", "means", "chols", "inv_chols"):
        _close(getattr(ts, name), getattr(js, name), rtol, atol, name)
    assert int(ts.num_active) == int(js.num_active)
    assert ts.diagonal and js.diagonal


# ---------------------------------------------------------------------------
# models/gmm.py
# ---------------------------------------------------------------------------

def _case_create(rng, js, ts):
    _model_match(ts, js)
    assert ts.chols.shape == (8, 4)
    _close(ts.covs, js.covs, 1e-6, 0)
    _close(tgmm.invert_chol(ts.chols, True), jgmm.invert_chol(js.chols, True))
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    _close(tgmm.safe_chol_pad(ts.chols, _t(mask), True),
           jgmm.safe_chol_pad(js.chols, jnp.asarray(mask), True), 1e-6, 0)


def _case_densities(rng, js, ts):
    x = (rng.randn(200, 4) * 3).astype(np.float32)
    _close(tgmm.whitened_diffs(ts, _t(x)), jgmm.whitened_diffs(
        js, jnp.asarray(x)), 1e-5, 1e-5)
    _close(tgmm.component_log_densities(ts, _t(x))[:5],
           jgmm.component_log_densities(js, jnp.asarray(x))[:5], 1e-5, 5e-4)
    _close(tgmm.log_density(ts, _t(x)), jgmm.log_density(js, jnp.asarray(x)),
           1e-5, 5e-4)
    model, comp = tgmm.log_densities_also_individual(ts, _t(x))
    j_model, j_comp = jgmm.log_densities_also_individual(js, jnp.asarray(x))
    _close(model, j_model, 1e-5, 5e-4)
    _close(comp[:5], j_comp[:5], 1e-5, 5e-4)
    _close(tgmm.marginal_log_density(ts, _t(x), 1),
           jgmm.marginal_log_density(js, jnp.asarray(x), 1), 1e-5, 5e-4)


def _case_pack(rng, js, ts):
    x = (rng.randn(300, 4) * 3).astype(np.float32)
    pack = tgmm.density_pack(ts, _t(x))
    ld, grads, comp = jgmm.log_density_and_grad(js, jnp.asarray(x))
    _close(pack.model_log_densities, ld, 1e-5, 5e-4)
    _close(pack.component_log_densities[:5], comp[:5], 1e-5, 5e-4)
    scale = float(np.abs(np.asarray(grads)).max())
    _close(pack.model_grads, grads, 0, 1e-5 * scale)


def _case_pack_chunked(rng, js, ts):
    """The [k, N, D] slabs made one component at a time: the same pack."""
    x = _t((rng.randn(300, 4) * 3).astype(np.float32))
    whole = tgmm.density_pack(ts, x)
    old = tgmm._DIAG_CHUNK
    tgmm._DIAG_CHUNK = 300 * 4
    try:
        parts = tgmm.density_pack(ts, x)
    finally:
        tgmm._DIAG_CHUNK = old
    for a, b in zip(parts.__dict__.values(), whole.__dict__.values()):
        _close(a, b, 1e-6, 1e-6)


def _case_entropies(rng, js, ts):
    _close(tgmm.component_entropies(ts), jgmm.component_entropies(js),
           1e-6, 1e-5)
    _close(tgmm.average_entropy(ts), jgmm.average_entropy(js), 1e-6, 1e-5)


def _case_sample(rng, js, ts):
    key = jax.random.PRNGKey(3)
    j_smp, j_map = jgmm.sample(js, key, 64)
    k_key, n_key = jax.random.split(key)
    comp = jgmm.sample_categorical(js, k_key, 64)
    eps = jax.random.normal(n_key, (64, 4))
    t_smp, t_map = tgmm.sample(ts, 64, comp=_t(comp), eps=_t(eps))
    np.testing.assert_array_equal(t_map.numpy(), np.asarray(j_map))
    _close(t_smp, j_smp, 1e-6, 1e-5)
    eps3 = jax.random.normal(key, (8, 6, 4))
    _close(tgmm.sample_from_components(ts, _t(eps3)),
           jgmm.sample_from_components(js, key, 6), 1e-6, 1e-5)


def _case_add(rng, js, ts):
    mean = (rng.randn(4) * 2).astype(np.float32)
    var = (0.5 + rng.rand(4)).astype(np.float32)
    ja = jgmm.add_component(js, jnp.asarray(1e-3), jnp.asarray(mean),
                            jnp.asarray(var))
    ta = tgmm.add_component(ts, 1e-3, _t(mean), _t(var))
    _model_match(ta, ja)
    assert int(ta.num_active) == 6
    full = ts
    for _ in range(3):
        full = tgmm.add_component(full, 1e-3, _t(mean), _t(var))
    assert int(tgmm.add_component(full, 1e-3, _t(mean),
                                  _t(var)).num_active) == 8   # a no-op


def _case_remove(rng, js, ts):
    keep = np.array([1, 0, 1, 0, 1, 1, 1, 1], bool)
    _model_match(tgmm.remove_components(ts, _t(keep)),
                 jgmm.remove_components(js, jnp.asarray(keep)))


def _case_repad(rng, js, ts):
    tr, jr = tgmm.repad(ts, 16), jgmm.repad(js, 16)
    _model_match(tr, jr)
    assert tr.chols.shape == (16, 4)
    assert torch.equal(tr.chols[8:], torch.ones(8, 4))
    assert torch.equal(tr.chols[:8], ts.chols)


_GMM_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_create, _case_densities, _case_pack, _case_pack_chunked,
    _case_entropies, _case_sample, _case_add, _case_remove, _case_repad)}


@pytest.mark.parametrize("case", sorted(_GMM_CASES))
def test_gmm_function_matches_jax(case):
    """Each diagonal ``models/gmm.py`` function against the JAX package's:
    densities at the density kernels' bar (atol 5e-4 + rtol 1e-5),
    gradients within 1e-5 of their largest entry, structure exactly."""
    rng, js, ts = _states(seed=sorted(_GMM_CASES).index(case))
    _GMM_CASES[case](rng, js, ts)


# ---------------------------------------------------------------------------
# Trust region
# ---------------------------------------------------------------------------

def _rewards(rng, js, scale=0.5):
    """Diagonal negated Hessians and gradients [8, 4] around the model."""
    hneg = (scale * rng.rand(8, 4) + 0.05).astype(np.float32)
    gneg = rng.randn(8, 4).astype(np.float32)
    return hneg, gneg


def test_tr_kl_diag_matches_jax():
    """The elementwise KL at etas over seven decades, with one component
    whose interpolated precision turns negative (NaN on both sides), and
    its new means and inverse factors."""
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    rng, js, ts = _states(seed=7)
    hneg, gneg = _rewards(rng, js)
    hneg[3] = -50.0
    old_prec = np.square(np.asarray(js.inv_chols))
    old_lin = old_prec * np.asarray(js.means)
    reward_lin = hneg * np.asarray(js.means) - gneg
    etas = np.logspace(-3, 4, 8).astype(np.float32)
    want = jax.vmap(lambda e, ol, op, oi, rl, rq, m: jcu._tr_kl_diag(
        e, ol, op, oi, rl, rq, 0.0, m))(
        jnp.asarray(etas), jnp.asarray(old_lin), jnp.asarray(old_prec),
        js.inv_chols, jnp.asarray(reward_lin), jnp.asarray(hneg), js.means)
    got = tcu._tr_kl_diag(_t(etas), _t(old_lin), _t(old_prec), ts.inv_chols,
                          _t(reward_lin), _t(hneg), ts.means)
    for g, w, name in zip(got, want, ("kl", "new_mean", "inv_chol_p")):
        assert np.array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
        _close(g[:5], w[:5], 1e-5, 1e-6, name)
    assert np.isnan(got[0][3].item())


def _tr_pair(dtype):
    rng, js, ts = _states(k=6, seed=11, dtype=dtype)
    hneg, gneg = _rewards(rng, js)
    hneg, gneg = hneg.astype(dtype), gneg.astype(dtype)
    hneg[2] -= 5.0          # a negative precision for the larger etas
    steps = np.array([0.05, 0.2, 0.5, 1.0, 0.01, 0.1, 0.1, 0.1], dtype)
    last = np.array([-1, 3.0, -1, 40.0, 0.5, -1, -1, -1], dtype)
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 6).replace(
        last_etas=jnp.asarray(last))
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 6).replace(
        last_etas=_t(last))
    if dtype == np.float64:
        tm = tm.replace(**{k: v.double() for k, v in vars(tm).items()
                           if isinstance(v, torch.Tensor)
                           and v.dtype == torch.float32})
    return js, jm, ts, tm, hneg, gneg, steps


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_trust_region_update_matches_jax(dtype):
    """The diagonal trust-region step of every slot: the bracket search
    (cold and warm starts, one slot infeasible at its larger etas) and the
    parameters at the accepted eta.  In float64 the searched etas equal
    JAX's to 1e-14 (the same bisection decisions); in float32 the step is
    held at the one-step bar (rtol 1e-4 / atol 1e-5)."""
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    dt = np.dtype(dtype)
    with jax.enable_x64(dt == np.float64):
        js, jm, ts, tm, hneg, gneg, steps = _tr_pair(dt.type)
        jr = jcu.trust_region_update(js, jm, jnp.asarray(hneg),
                                     jnp.asarray(gneg), jnp.asarray(steps))
        j_etas = np.asarray(jr.meta.last_etas)
        j_model = {k: np.asarray(getattr(jr.model, k)) for k in
                   ("means", "chols", "inv_chols", "log_weights")}
        j_l2 = np.asarray(jr.meta.l2_regularizers)
    tr = tcu.trust_region_update(ts, tm, _t(hneg), _t(gneg), _t(steps))
    t_etas = tr.meta.last_etas.numpy()
    assert t_etas.dtype == dt
    rtol = 1e-14 if dt == np.float64 else 1e-4
    _close(t_etas, j_etas, rtol, 0, "etas")
    for name, want in j_model.items():
        _close(getattr(tr.model, name), want, 1e-10 if rtol < 1e-6 else 1e-4,
               1e-12 if rtol < 1e-6 else 1e-5, name)
    _close(tr.meta.l2_regularizers, j_l2, 1e-6, 0)
    assert (t_etas[:6] > 0).sum() >= 4 and t_etas[6:].tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# Estimators and the direct and iBLR steps
# ---------------------------------------------------------------------------

def _window(seed=1, n=300):
    rng, js, ts = _states(seed=seed, offset=2.0)
    x = (rng.randn(n, 4) * 2 + 2.0).astype(np.float32)
    return rng, js, ts, dict(
        x=x, bg=(rng.randn(n) - 4.0).astype(np.float32),
        lnp=(rng.randn(n) * 3 - 0.05 * np.sum(x * x, 1)).astype(np.float32),
        grads=rng.randn(n, 4).astype(np.float32),
        mask=rng.rand(n) > 0.1,
        mapping=rng.randint(0, 5, n).astype(np.int32))


@pytest.mark.parametrize("normalized", [True, False])
def test_stein_estimate_matches_jax(normalized):
    """The diagonal Stein estimate, elementwise and unsymmetrized, with
    self-normalized and with standard importance weights."""
    from gmmvi_tpu.optimization.ng_estimators import stein_estimate as jest
    from gmmvi_tpu_torch.optimization import ng_estimators as tne

    _, js, ts, w = _window()
    args = [w[k] for k in ("x", "mask", "mapping", "bg", "lnp", "grads")]
    got = tne.stein_estimate(
        ts, *map(_t, args), use_self_normalized_importance_weights=normalized)
    want = jest(js, *map(jnp.asarray, args),
                use_self_normalized_importance_weights=normalized)
    assert got.expected_hessians_neg.shape == (8, 4)
    _close(got.expected_gradients_neg[:5], want.expected_gradients_neg[:5],
           1e-5, 1e-5)
    _close(got.expected_hessians_neg[:5], want.expected_hessians_neg[:5],
           1e-4, 1e-5)


def test_more_estimate_matches_jax():
    """The diagonal MORE estimate: the full quadratic fitted on
    elementwise-whitened samples, one component at a time (the port's B8
    is not launched), its quadratic term's diagonal.  Both sides in
    float64 (JAX under ``jax.enable_x64``): on these inputs the weights
    sit on a few samples, and in float32 both packages miss the float64
    fit by ~2e-3 of its scale."""
    from gmmvi_tpu.optimization.ng_estimators import more_estimate as jest
    from gmmvi_tpu_torch.optimization import ng_estimators as tne

    _, js, ts, w = _window(seed=2, n=600)
    args = [w[k].astype(np.float64) if w[k].dtype == np.float32 else w[k]
            for k in ("x", "mask", "mapping", "bg", "lnp")]
    reg = np.full(8, 1e-3)
    ts = ts.replace(**{k: getattr(ts, k).double() for k in
                       ("log_weights", "means", "chols", "inv_chols")})
    got = tne.more_estimate(ts, *map(_t, args), _t(reg))
    with jax.enable_x64(True):
        js = js.replace(**{k: jnp.asarray(np.asarray(getattr(js, k)),
                                          jnp.float64)
                           for k in ("log_weights", "means", "chols",
                                     "inv_chols")})
        want = jest(js, *map(jnp.asarray, args), jnp.asarray(reg))
        want = [np.asarray(v) for v in want]
    assert got.expected_hessians_neg.shape == (8, 4)
    _close(got.expected_hessians_neg[:5], want[0][:5], 1e-4, 1e-5)
    _close(got.expected_gradients_neg[:5], want[1][:5], 1e-4, 1e-5)


@pytest.mark.parametrize("updater", ["direct", "iBLR-first", "iBLR-later"])
def test_direct_and_iblr_updates_match_jax(updater):
    """I and Y on a diagonal model: the elementwise precision step, iBLR's
    curvature correction (no mean step on a first update); under I a
    component whose new precision turns negative keeps its parameters,
    under Y the correction keeps it positive."""
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    rng, js, ts = _states(seed=5)
    hneg, gneg = _rewards(rng, js)
    hneg[1] -= 40.0
    counts = (np.zeros(8, np.float32) if updater == "iBLR-first" else
              np.array([3, 1, 0, 9, 2, 0, 0, 0], np.float32))
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 6).replace(
        num_received_updates=jnp.asarray(counts))
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 6).replace(
        num_received_updates=_t(counts))
    steps = np.full(8, 0.2, np.float32)
    kind = updater.split("-")[0]
    jr = jcu.UPDATERS[kind](js, jm, jnp.asarray(hneg), jnp.asarray(gneg),
                            jnp.asarray(steps))
    tr = tcu.UPDATERS[kind](ts, tm, _t(hneg), _t(gneg), _t(steps))
    _model_match(tr.model, jr.model, 1e-5, 1e-6)
    _close(tr.meta.l2_regularizers, jr.meta.l2_regularizers, 1e-6, 0)
    moved = (tr.model.means[:5] != ts.means[:5]).any(dim=1).tolist()
    if kind == "direct":
        assert float(tr.meta.l2_regularizers[1]) > 1e-12   # the failure
        assert moved == [True, False, True, True, True]
    else:   # the correction keeps the precision positive
        assert moved == [bool(c > 0) for c in counts[:5]]


# ---------------------------------------------------------------------------
# One step, a trajectory, checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture
def _one_test_at_a_time(tmp_path_factory):
    with xdist_lock(tmp_path_factory, "tests"):
        yield


_STEP_CASES = {
    "SAMTRON": dict(codename="SAMTRON"),
    "SEMIDUX": dict(codename="SEMIDUX", ratio=2.0),
}


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_one_step_matches_jax_leaf_by_leaf(_one_test_at_a_time, case):
    """One step of a diagonal model from a JAX state carried across, with
    JAX's draws injected, from the initial state and from the state after
    five steps (SAMTRON's an add; SEMIDUX's with a database of five older
    mixtures, its background density over their ``[R, Kmax, D]`` ring):
    integer leaves exact, float leaves within rtol 1e-4 / atol 1e-5."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5, extra=DIAGONAL, **_STEP_CASES[case])
    assert jg.state.model.diagonal and tg.state.model.diagonal
    assert tg.state.db.dist_chols.shape[2:] == (5,)
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
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def test_samtron_trajectory_matches_jax(_one_test_at_a_time):
    """Diagonal SAMTRON for 80 iterations at the trajectory scale of
    test_full_optimizer_parity.py's diagonal head-to-head (dims 6, kmax
    12, n_des 48, no reuse) with JAX's draws injected every step:
    identical feval counts, final ELBO within 1.0, component counts within
    2, finite ELBOs."""
    jg, tg = build_pair(extra=DIAGONAL)
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
    assert t_named["model.chols"].ndim == 2

    def j_model(x):
        return np.asarray(jgmm.log_density(jg.state.model, jnp.asarray(x)))

    def t_model(x):
        return tgmm.log_density(tg.state.model, _t(x)).numpy()

    def j_target(x):
        return np.asarray(jg.target_distribution.log_density(
            jnp.asarray(x)))

    def t_target(x):
        return tg.target_distribution.log_density(_t(x)).numpy()

    elbos = [mc_elbo(m, tgt, named["model.means"], named["model.chols"],
                     named["model.log_weights"],
                     int(named["model.num_active"]))
             for named, m, tgt in ((j_named, j_model, j_target),
                                   (t_named, t_model, t_target))]
    assert np.isfinite(elbos).all(), elbos
    assert abs(elbos[0] - elbos[1]) < 1.0, elbos


def _diag_runner_config(pkg_cfg):
    cfg = pkg_cfg.update_config(
        pkg_cfg.get_default_config("SAMTRON", "gmm20"),
        {"environment_name": "DIAGGMM",
         "model_initialization": {"use_diagonal_covs": True},
         "sample_selector_config": {"desired_samples_per_component": 24},
         "num_component_adapter_config": {"del_iters": 8, "add_iters": 5,
                                          "num_database_samples": 256},
         "gmmvi_runner_config": {"log_metrics_interval": 10},
         "tpu": {"max_components": 4}})
    cfg["environment_config"] = {"num_dimensions": 5}
    return cfg


def test_checkpoint_resumes_to_the_bit(tmp_path):
    """A diagonal run on the diagonal GMM target through the runner (4
    slots, grown to 16 by VIPS): saved after 12 iterations and loaded into
    a fresh runner, it takes the unbroken run's next 10 steps to the
    bit."""
    runners = [gmmvi_tpu_torch.GmmviRunner.build_from_config(
        _diag_runner_config(tcfg), device="cpu") for _ in range(2)]
    a, b = runners
    for n in range(12):
        a.iterate_and_log(n)
    path = str(tmp_path / "diag.npz")
    a.save_checkpoint(path)
    b.load_checkpoint(path)
    for n in range(12, 22):
        a.iterate_and_log(n)
        b.iterate_and_log(n)
    sa = gmmvi_tpu_torch.state_to_numpy(a.gmmvi.state)
    sb = gmmvi_tpu_torch.state_to_numpy(b.gmmvi.state)
    assert sa["model.chols"].shape == (16, 5)
    assert sa["db.dist_chols"].ndim == 3
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


def test_jax_diagonal_checkpoint_loads(tmp_path):
    """A checkpoint file of the JAX runner on the same diagonal config
    loads into a port runner: every leaf equal, the key ignored; the port
    then steps on from it."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu import GmmviRunner as JRunner
    from gmmvi_tpu.utils.checkpoint import save_state

    jr = JRunner.build_from_config(_diag_runner_config(jcfg))
    for n in range(6):
        jr.iterate_and_log(n)
    path = str(tmp_path / "jax_diag.npz")
    save_state(path, jr.gmmvi.state)
    want = jax_state_leaves(jr.gmmvi.state)
    tr = gmmvi_tpu_torch.GmmviRunner.build_from_config(
        _diag_runner_config(tcfg), device="cpu")
    tr.load_checkpoint(path)
    got = gmmvi_tpu_torch.state_to_numpy(tr.gmmvi.state)
    assert set(got) == set(want) - {"key"}
    for name, val in got.items():
        np.testing.assert_array_equal(val, want[name], err_msg=name)
    out = tr.iterate_and_log(6)
    assert np.isfinite(out["max_weight"])


def test_diagonal_codenames_build_and_step():
    """SAMTRON, SEMIDUX and ZEMTRON with diagonal covariances from their
    defaults on the diagonal GMM target (D = 5, reuse 1.0): two steps each
    with a finite state; nothing raises NotImplementedError."""
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    for codename in ("SAMTRON", "SEMIDUX", "ZEMTRON"):
        cfg = tcfg.update_config(tcfg.get_default_algorithm_config(codename), {
            "start_seed": 0, "environment_name": "DIAGGMM",
            "environment_config": {"num_dimensions": 5},
            "model_initialization": {
                "use_diagonal_covs": True, "num_initial_components": 3,
                "prior_mean": 0.0, "prior_scale": 30.0, "initial_cov": 100.0},
            "use_sample_database": True, "max_database_size": 10000,
            "temperature": 1.0,
            "sample_selector_config": {
                "desired_samples_per_component": 16,
                "ratio_reused_samples_to_desired": 1.0},
            "tpu": {"max_components": 6}})
        if cfg["ng_based_updater_type"] == "direct":
            cfg = tcfg.update_config(cfg, {
                "component_stepsize_adapter_config": {
                    "initial_stepsize": 1e-3}})
        target, model, meta = init_experiment(cfg, device="cpu")
        g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
        g.train_iters(2)
        k = int(g.model.num_active)
        assert g.model.diagonal and g.model.chols.shape == (6, 5)
        assert torch.isfinite(g.model.means[:k]).all()
        assert torch.isfinite(g.model.chols[:k]).all()
