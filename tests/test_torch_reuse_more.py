"""The PyTorch port's reuse path and MORE estimator against the JAX package:
the background density (kernel B4's plain version), the reuse half of the
sample database, the ESS pass, the quadratic fit and MORE Gram (kernel B8's
plain version), the direct weight update and fixed weight stepsize, and
ZAMTRUX (VIPS) steps and a trajectory with JAX's draws injected.

The ZAMTRUX runs use the ``torch_parity`` scale (D 6, Kmax 12, n_des 48,
``ratio_reused_samples_to_desired`` 2.0).  JAX runs its trust-region KL
kernel in interpret mode, so both sides take the batched bracket path; its
background pass and MORE fit take the XLA chain (their kernels engage only
on a TPU), which is what the port's plain versions reproduce.
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import (assert_states_match, build_pair, jax_state_leaves,
                          jax_step_draws, mc_elbo)

import gmmvi_tpu_torch
from gmmvi_tpu_torch.ops import background as tbg
from gmmvi_tpu_torch.ops import more as tmore
from gmmvi_tpu_torch.ops import quadratic as tquad
from gmmvi_tpu_torch.optimization import ng_estimators as tne

# the port's MORE estimate, kept apart: the float64 witness below stands in
# for the module's function and calls this one
PORT_MORE_ESTIMATE = tne.more_estimate

torch.set_num_threads(2)

TRAJ_ITERS = 30
# one-step start states (see test_one_step_matches_jax_leaf_by_leaf)
STEP_STARTS = (6, 12, 19)
# start states from which that f32 step misses its bar (by 3.1, 2.6 and 5.1
# times on one entry), for test_one_step_with_float64_fits_matches_jax
FIT64_STARTS = (2, 14, 24)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# B4: background density (rtol 1e-4, atol 2e-4, the Pallas kernel's bar)
# ---------------------------------------------------------------------------

def _background_case(u, d, n, seed=0):
    """The inputs of tests/test_pallas_kernels.py's background test, with
    its numpy oracle."""
    rng = np.random.RandomState(seed)
    means = rng.randn(u, d).astype(np.float32) * 3
    a = rng.randn(u, d, d).astype(np.float32) * 0.3
    covs = np.einsum("uij,ulj->uil", a, a) + np.eye(d, dtype=np.float32)
    chols = np.linalg.cholesky(covs).astype(np.float32)
    inv_chols = np.stack([np.linalg.inv(c) for c in chols]).astype(np.float32)
    log_dets = np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)),
                      axis=-1).astype(np.float32)
    log_w = np.log(rng.dirichlet(np.ones(u))).astype(np.float32)
    log_w[u // 3:: 3] = -np.inf
    x = (rng.randn(n, d) * 2).astype(np.float32)
    diffs = x[None] - means[:, None]
    y = np.einsum("uij,unj->uni", inv_chols, diffs)
    lp = (-0.5 * np.sum(y * y, -1) - log_dets[:, None]
          - 0.5 * d * np.log(2 * np.pi))
    sel = np.isfinite(log_w)
    stacked = lp[sel] + log_w[sel][:, None]
    m = stacked.max(0)
    want = np.log(np.exp(stacked - m).sum(0)) + m
    return (means, inv_chols, log_w, log_dets, x), want


@pytest.mark.parametrize("u,d,n", [(7, 5, 600), (70, 60, 520)])
def test_background_plain_matches_jax(u, d, n):
    from gmmvi_tpu.ops.pallas_density import fused_background_logpdf

    args, want = _background_case(u, d, n)
    got = tbg.background_logpdf(*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    kernel = np.asarray(fused_background_logpdf(
        *[jnp.asarray(a) for a in args], interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=2e-4)


def test_background_all_masked_is_neg_inf():
    """No selected row: -inf, as the JAX package's XLA chain and
    masked_logsumexp give (its TPU kernel gives a large negative float)."""
    from gmmvi_tpu.ops.stable import masked_logsumexp as jmlse

    args, _ = _background_case(5, 4, 50, seed=3)
    args[2][:] = -np.inf
    got = tbg.background_logpdf(*[_t(a) for a in args])
    assert torch.isneginf(got).all()
    lp = np.zeros((5, 50), np.float32)
    want = np.asarray(jmlse(jnp.asarray(lp + args[2][:, None]),
                            mask=jnp.zeros((5, 1), bool), axis=0))
    assert np.isneginf(want).all()


# ---------------------------------------------------------------------------
# B8: MORE normal equations and the quadratic fit (the Pallas test's bars)
# ---------------------------------------------------------------------------

def _more_case():
    """The inputs of tests/test_pallas_kernels.py's MORE Gram test."""
    rng = np.random.RandomState(5)
    k, d, n = 5, 7, 600
    means = rng.randn(k, d).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.3
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    inv_chols = np.stack([np.linalg.inv(np.linalg.cholesky(c))
                          for c in covs]).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n).astype(np.float32)
    w = rng.rand(k, n).astype(np.float32)
    w[:, -50:] = 0.0
    regs = (10.0 ** rng.uniform(-8, -2, k)).astype(np.float32)
    return inv_chols, means, w, y, x, regs


def test_quadratic_features_and_indices_match_jax():
    from gmmvi_tpu.ops import quadratic as jquad

    x = np.random.RandomState(0).randn(40, 6).astype(np.float32)
    for got, want in zip(tquad.triu_indices(6), jquad.triu_indices(6)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tquad.quadratic_features(_t(x)).numpy(),
        np.asarray(jquad.quadratic_features(jnp.asarray(x))))
    assert tquad.num_features(6) == 28


def test_more_grams_plain_matches_jax_kernel_and_fit():
    """Gram and rhs against the interpret-mode Pallas kernel (rtol 1e-5 of
    each component's largest entry), then the solved terms against JAX's
    fit_quadratic at that test's bars (quad rtol 2e-3 / atol 2e-4, lin
    rtol 2e-3 / atol 2e-3)."""
    from gmmvi_tpu.ops import quadratic as jquad
    from gmmvi_tpu.ops.pallas_more import fused_more_grams

    inv_chols, means, w, y, x, regs = _more_case()
    gram, rhs = tmore.more_grams(_t(inv_chols), _t(means), _t(w), _t(y),
                                 _t(x))
    jgram, jrhs = fused_more_grams(
        jnp.asarray(inv_chols), jnp.asarray(means), jnp.asarray(w),
        jnp.asarray(y), jnp.asarray(x), interpret=True)
    for got, want in ((gram, jgram), (rhs, jrhs)):
        want = np.asarray(want)
        scale = np.abs(want).reshape(want.shape[0], -1).max(1)
        err = np.abs(got.numpy() - want).reshape(want.shape[0], -1).max(1)
        assert (err <= 1e-5 * scale).all(), err / scale
    quad, lin, _ = tquad.solve_quadratic_normal_eqs(
        gram, rhs, _t(regs), _t(means), _t(inv_chols))
    for i in range(len(regs)):
        quad_j, lin_j, _ = jquad.fit_quadratic(
            jnp.asarray(regs[i]), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(w[i]), jnp.asarray(means[i]),
            jnp.asarray(inv_chols[i]))
        np.testing.assert_allclose(quad[i].numpy(), np.asarray(quad_j),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(lin[i].numpy(), np.asarray(lin_j),
                                   rtol=2e-3, atol=2e-3)
        quad_1, lin_1, const_1 = tquad.fit_quadratic(
            _t(regs[i]), _t(x), _t(y), _t(w[i]), _t(means[i]),
            _t(inv_chols[i]), mask=_t(w[i] > 0))
        np.testing.assert_allclose(quad_1.numpy(), np.asarray(quad_j),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(lin_1.numpy(), np.asarray(lin_j),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("normalized,own", [(True, False), (False, False),
                                            (True, True)])
def test_more_estimate_matches_jax(monkeypatch, normalized, own):
    """The inputs of tests/test_pallas_kernels.py's MORE estimate test
    (4 of 6 slots active), against JAX's lax.map path at its bars: H rtol
    2e-3 / atol 2e-4, g rtol 2e-3 / atol 2e-3; both weight branches and
    own samples."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.optimization import ng_estimators as jest
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.optimization import ng_estimators as test

    monkeypatch.setenv("GMMVI_FUSED_MORE", "0")
    rng = np.random.RandomState(6)
    k, d, n = 4, 5, 600
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    mu = rng.randn(k, d).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.3
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    js = jgmm.create_gmm_state(weights, mu, covs, max_components=k + 2)
    ts = tgmm.create_gmm_state(weights, mu, covs, max_components=k + 2,
                               device="cpu")
    samples = rng.randn(n, d).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-40:] = False
    mapping = rng.randint(0, k, n).astype(np.int32)
    newest = np.arange(n) >= n // 3
    bg = np.asarray(jgmm.log_density(js, jnp.asarray(samples)))
    lnpdfs = rng.randn(n).astype(np.float32)
    regs = (10.0 ** rng.uniform(-8, -4, k + 2)).astype(np.float32)
    kw = dict(use_self_normalized_importance_weights=normalized,
              only_use_own_samples=own)
    want = jest.more_estimate(
        js, jnp.asarray(samples), jnp.asarray(mask), jnp.asarray(mapping),
        jnp.asarray(bg), jnp.asarray(lnpdfs), jnp.asarray(regs),
        newest_mask=jnp.asarray(newest), **kw)
    got = test.more_estimate(ts, _t(samples), _t(mask), _t(mapping), _t(bg),
                             _t(lnpdfs), _t(regs), newest_mask=_t(newest),
                             **kw)
    np.testing.assert_allclose(got.expected_hessians_neg[:k].numpy(),
                               np.asarray(want.expected_hessians_neg)[:k],
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got.expected_gradients_neg[:k].numpy(),
                               np.asarray(want.expected_gradients_neg)[:k],
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Weight update and stepsize of the U and X letters
# ---------------------------------------------------------------------------

def test_direct_weight_update_and_fixed_stepsize_match_jax():
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.models import meta as jmeta
    from gmmvi_tpu.optimization import stepsize_adapters as jstep
    from gmmvi_tpu.optimization import weight_updaters as jw
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.models import meta as tmeta
    from gmmvi_tpu_torch.optimization import stepsize_adapters as tstep
    from gmmvi_tpu_torch.optimization import weight_updaters as tw

    rng = np.random.RandomState(2)
    k, kmax, d = 5, 8, 3
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    mu = rng.randn(k, d).astype(np.float32)
    covs = np.stack([np.eye(d, dtype=np.float32)] * k)
    js = jgmm.create_gmm_state(weights, mu, covs, max_components=kmax)
    ts = tgmm.create_gmm_state(weights, mu, covs, max_components=kmax,
                               device="cpu")
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 4)
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 4)
    elr = (rng.randn(kmax) * 30).astype(np.float32)
    elr[1] = 200.0    # pushes another weight under the 1e-30 floor
    for stepsize, temp in ((0.7, 1.0), (1.0, 2.0)):
        jm2, jmeta2 = jw.direct_weight_update(js, jm, jnp.asarray(elr),
                                              stepsize, temp)
        tm2, tmeta2 = tw.direct_weight_update(ts, tm, _t(elr), stepsize,
                                              temp)
        np.testing.assert_allclose(tm2.log_weights.numpy(),
                                   np.asarray(jm2.log_weights), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tmeta2.weight_history.numpy(),
                                   np.asarray(jmeta2.weight_history),
                                   rtol=1e-6, atol=1e-6)
    single = ts.replace(num_active=torch.tensor(1, dtype=torch.int32))
    same, _ = tw.direct_weight_update(single, tm, _t(elr), 1.0, 1.0)
    assert torch.equal(same.log_weights, single.log_weights)

    jws = jstep.create_weight_stepsize_state(0.3)
    tws = tstep.create_weight_stepsize_state(0.3, device="cpu")
    jws = jstep.fixed_weight_stepsize(jws, js, jm, {"initial_stepsize": 0.3})
    tws = tstep.WEIGHT_STEPSIZE_ADAPTERS["fixed"](tws, ts, tm,
                                                  {"initial_stepsize": 0.3})
    for name in ("stepsize", "num_updates", "prev_elbo"):
        assert float(getattr(tws, name)) == float(getattr(jws, name)), name


# ---------------------------------------------------------------------------
# ZAMTRUX: one JAX run shared by the tests below
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamtrux_run():
    """A JAX ZAMTRUX run of TRAJ_ITERS steps: its state leaves before every
    step and after the last, and the draws of every step; with the port's
    GMMVI built on the same target and initial mixture."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GMMVI_FUSED_TR", "interpret")
        jg, tg = build_pair(codename="ZAMTRUX")
        leaves, draws = [], []
        for _ in range(TRAJ_ITERS):
            leaves.append(jax_state_leaves(jg.state))
            draws.append(jax_step_draws(jg))
            jg.train_iter()
        leaves.append(jax_state_leaves(jg.state))
    return jg, tg, leaves, draws


def _port_state(tg, named):
    return gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                            like=tg.state)


def _jax_db(jg, named):
    """The JAX package's SampleDbState from leaves keyed by path."""
    db = jg.state.db
    return db.replace(**{f: jnp.asarray(named[f"db.{f}"])
                         for f in ("samples", "target_lnpdfs",
                                   "target_grads", "sample_iter",
                                   "sample_comp", "write_pos",
                                   "num_samples_written", "dist_means",
                                   "dist_chols", "dist_inv_chols",
                                   "dist_block_iter", "res_samples",
                                   "res_lnpdfs", "res_count")})


def _jax_model(jg, named):
    m = jg.state.model
    return m.replace(**{f: jnp.asarray(named[f"model.{f}"])
                        for f in ("log_weights", "means", "chols",
                                  "inv_chols", "num_active")})


def _assert_windows_match(twin, jwin):
    for name in ("mapping", "valid", "num_valid", "sample_iters"):
        np.testing.assert_array_equal(getattr(twin, name).numpy(),
                                      np.asarray(getattr(jwin, name)),
                                      err_msg=name)
    for name in ("samples", "target_lnpdfs", "background_log_pdfs"):
        np.testing.assert_allclose(getattr(twin, name).numpy(),
                                   np.asarray(getattr(jwin, name)),
                                   rtol=1e-5, err_msg=name)


def test_build_sizes_the_ring_as_jax(zamtrux_run):
    """With reuse the distribution ring has min(reused + 4, 64) rows (64 at
    96 reused per component), and tpu.max_dist_ring_iters bounds it."""
    from torch_parity import zamtrux_overrides
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    jg, tg, leaves, _ = zamtrux_run
    assert tg.state.db.ring_iters == jg.state.db.ring_iters == 64
    assert tg.selector_cfg == tuple(jg.selector_cfg)
    cfg = tcfg.update_config(tcfg.get_default_algorithm_config("ZAMTRUX"),
                             zamtrux_overrides(n_des=4, kmax=4, k0=2))
    cfg = tcfg.update_config(cfg, {"tpu": {"max_dist_ring_iters": 5}})
    target = make_target(3, False, seed=0, device="cpu")
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    assert g.state.db.ring_iters == 5


def test_state_round_trips_a_jax_zamtrux_state(zamtrux_run):
    """state_from_numpy / state_to_numpy carry a JAX ZAMTRUX state across
    leaf by leaf, bit for bit: the 64-row distribution ring, the l2
    regularizers the MORE fits use, every other leaf but JAX's key."""
    jg, tg, leaves, _ = zamtrux_run
    named = leaves[12]
    back = gmmvi_tpu_torch.state_to_numpy(_port_state(tg, named))
    assert set(back) == set(named) - {"key"}
    assert back["db.dist_means"].shape[0] == 64
    assert (named["meta.l2_regularizers"] > 0).all()
    for name, got in back.items():
        assert got.dtype == named[name].dtype, name
        np.testing.assert_array_equal(got, named[name], err_msg=name)


def test_get_newest_samples_matches_jax(zamtrux_run):
    """The reuse window of a JAX database after 12 reuse steps, where 62
    old distributions are live and max_background_dists is 48, so the
    top-k keeps some of the many 48-sample ties and drops others: integer
    and boolean leaves exactly, floats at rtol 1e-5."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization import sample_db as tdb

    jg, tg, leaves, _ = zamtrux_run
    named = leaves[12]
    jdbs, tdbs = _jax_db(jg, named), _port_state(tg, named).db
    u = tg.selector_cfg.max_background_dists
    window = tg.selector_cfg.reused_samples_per_component * 12
    n_req = tg.selector_cfg.reused_samples_per_component * int(
        named["model.num_active"])
    jwin = jdb.get_newest_samples(jdbs, window, jnp.asarray(n_req), u)
    twin = tdb.get_newest_samples(tdbs, window, torch.tensor(n_req), u)
    _assert_windows_match(twin, jwin)
    *_, valid, key, _ = jdb._gather_window(jdbs, window, jnp.asarray(n_req))
    live = np.unique(np.asarray(key)[np.asarray(valid)])
    assert len(live) > u
    assert int(twin.num_valid) < int(np.asarray(valid).sum())


@pytest.mark.parametrize("state", [6, 19])
def test_get_newest_samples_fused_with_old_dists_matches_jax(zamtrux_run,
                                                             state):
    """The total window with old generating distributions
    (any_old_dists=True) on JAX databases: exact integers and masks, floats
    at rtol 1e-5, the density pack too."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization import sample_db as tdb
    from gmmvi_tpu_torch.optimization.sample_selectors import \
        total_window_size

    jg, tg, leaves, _ = zamtrux_run
    named = leaves[state]
    ts = _port_state(tg, named)
    window = total_window_size(tg.selector_cfg, 12)
    u = tg.selector_cfg.max_background_dists
    iteration = state - 1       # the iteration that wrote the newest rows
    n_req = 700
    jwin, jpack = jdb.get_newest_samples_fused(
        _jax_db(jg, named), window, jnp.asarray(n_req), u,
        _jax_model(jg, named), jnp.asarray(iteration), any_old_dists=True)
    twin, tpack = tdb.get_newest_samples_fused(
        ts.db, window, torch.tensor(n_req), u, ts.model, iteration,
        any_old_dists=True)
    _assert_windows_match(twin, jwin)
    assert np.isfinite(twin.background_log_pdfs.numpy()[
        twin.valid.numpy()]).all()
    np.testing.assert_allclose(tpack.component_log_densities.numpy(),
                               np.asarray(jpack.component_log_densities),
                               rtol=1e-5)
    np.testing.assert_allclose(tpack.model_log_densities.numpy(),
                               np.asarray(jpack.model_log_densities),
                               rtol=1e-5)


def test_effective_samples_match_jax_exactly(zamtrux_run):
    """The ESS pass on a JAX state (the selector's own inputs) and on
    random log densities: equal integers."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu.optimization import sample_selectors as jsel
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.optimization import sample_selectors as tsel

    jg, tg, leaves, _ = zamtrux_run
    named = leaves[15]
    ts = _port_state(tg, named)
    cfg = tg.selector_cfg
    window = cfg.reused_samples_per_component * 12
    n_req = cfg.reused_samples_per_component * int(named["model.num_active"])
    jm = _jax_model(jg, named)
    jwin = jdb.get_newest_samples(_jax_db(jg, named), window,
                                  jnp.asarray(n_req),
                                  cfg.max_background_dists)
    want = jsel._effective_samples(
        jgmm.component_log_densities_fast(jm, jwin.samples),
        jwin.background_log_pdfs, jwin.valid)
    got = tsel.effective_samples(
        tgmm.component_log_densities_fast(ts.model, _t(jwin.samples)),
        _t(jwin.background_log_pdfs), _t(jwin.valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.max()) > 0

    rng = np.random.RandomState(7)
    ld = (rng.randn(9, 300) * 3).astype(np.float32)
    bg = (rng.randn(300) * 3).astype(np.float32)
    valid = rng.rand(300) > 0.3
    np.testing.assert_array_equal(
        tsel.effective_samples(_t(ld), _t(bg), _t(valid)).numpy(),
        np.asarray(jsel._effective_samples(jnp.asarray(ld), jnp.asarray(bg),
                                           jnp.asarray(valid))))


@pytest.mark.parametrize("start", STEP_STARTS)
def test_one_step_matches_jax_leaf_by_leaf(zamtrux_run, start):
    """One ZAMTRUX step from a JAX state in which reuse is active (48, 62
    and 93 live old distributions against max_background_dists 48): integer
    leaves (fresh-sample counts from the ESS floors, ring heads, fevals)
    exact, float leaves within rtol 1e-4 / atol 1e-5.

    MORE's f32 fit is ill-conditioned (ridge 1e-12): against a float64 fit
    both packages' quadratic terms err by ~1e-5 of their scale, in different
    directions, so some start states of this run land outside the float
    bar on a single entry and these do not (worst entry at 0.64, 0.81 and
    0.34 of its tolerance; scripts/torch_zamtrux_fit64_sweep.py reads every
    start state).  test_one_step_with_float64_fits_matches_jax holds the
    step from states that miss."""
    jg, tg, leaves, draws = zamtrux_run
    tg.state = _port_state(tg, leaves[start])
    assert int(tg.state.db.num_samples_written) > int(
        leaves[start]["model.num_active"]) * tg.selector_cfg.\
        desired_samples_per_component
    tg.train_iter(draws[start])
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    j_named = leaves[start + 1]
    assert set(t_named) == set(j_named) - {"key"}
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def _more_fit64(like, normalized, own, log_weights, means, chols,
                inv_chols, num_active, samples, sample_mask, mapping,
                background, target_lnpdfs, l2, comp, model_densities,
                newest):
    """MORE's estimate of the given inputs (numpy or torch) in float64 by
    the port's plain fit, rounded to float32 (hneg [K, D, D], gneg
    [K, D])."""
    from types import SimpleNamespace

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype)

    f64 = torch.float64
    model = like.replace(log_weights=t(log_weights, f64), means=t(means, f64),
                         chols=t(chols, f64), inv_chols=t(inv_chols, f64),
                         num_active=t(num_active))
    pack = SimpleNamespace(component_log_densities=t(comp, f64),
                           model_log_densities=t(model_densities, f64))
    with pytest.MonkeyPatch.context() as mp:
        # the kernel's wrapper takes float32 only; its plain version any
        mp.setattr(tne, "more_grams", tmore.more_grams_plain)
        est = PORT_MORE_ESTIMATE(
            model, t(samples, f64), t(sample_mask), t(mapping),
            t(background, f64), t(target_lnpdfs, f64), t(l2, f64),
            use_self_normalized_importance_weights=normalized,
            only_use_own_samples=own, pack=pack, newest_mask=t(newest))
    return tuple(e.to(torch.float32).numpy() for e in est)


def make_fit64_jax_step(jg, like):
    """JAX's step ``jg._full_step`` compiled anew with its MORE estimate
    replaced by the float64 fit of its own inputs (a host callback), and a
    function that rebuilds a JAX TrainState from leaves.  The step is traced
    at its first call, which must come with GMMVI_FUSED_TR=interpret."""
    import jax
    from gmmvi_tpu.optimization import ng_estimators as jest
    from gmmvi_tpu.utils.checkpoint import _path_str

    def more64(model, samples, sample_mask, mapping, background,
               target_lnpdfs, l2, use_self_normalized_importance_weights=True,
               only_use_own_samples=False, pack=None, newest_mask=None):
        k, d = model.means.shape
        shapes = (jax.ShapeDtypeStruct((k, d, d), jnp.float32),
                  jax.ShapeDtypeStruct((k, d), jnp.float32))
        hneg, gneg = jax.pure_callback(
            lambda *a: _more_fit64(like, use_self_normalized_importance_weights,
                                   only_use_own_samples, *a),
            shapes, model.log_weights, model.means, model.chols,
            model.inv_chols, model.num_active, samples, sample_mask,
            mapping, background, target_lnpdfs, l2,
            pack.component_log_densities, pack.model_log_densities,
            newest_mask)
        return jest.NgEstimate(hneg, gneg)

    paths, treedef = jax.tree_util.tree_flatten_with_path(jg.state)

    def state_of(named):
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(named[_path_str(p)]) for p, _ in paths])

    jitted = jax.jit(jg._spmd_scoped(jg._full_step))

    def step(state):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jest, "more_estimate", more64)
            return jitted(state)

    return step, state_of


def port_more64(model, samples, sample_mask, mapping, background,
                target_lnpdfs, l2, use_self_normalized_importance_weights=True,
                only_use_own_samples=False, pack=None, newest_mask=None):
    """A stand-in for the port's ``more_estimate``: the float64 fit of its
    inputs, rounded to float32."""
    hneg, gneg = _more_fit64(
        model, use_self_normalized_importance_weights, only_use_own_samples,
        model.log_weights, model.means, model.chols, model.inv_chols,
        model.num_active, samples, sample_mask, mapping, background,
        target_lnpdfs, l2, pack.component_log_densities,
        pack.model_log_densities, newest_mask)
    return tne.NgEstimate(torch.as_tensor(hneg), torch.as_tensor(gneg))


@pytest.fixture(scope="module")
def fit64_jax_step(zamtrux_run):
    jg, tg, _, _ = zamtrux_run
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GMMVI_FUSED_TR", "interpret")
        step, state_of = make_fit64_jax_step(jg, tg.state.model)
        step(state_of(zamtrux_run[2][FIT64_STARTS[0]]))   # traced here
    return step, state_of


def _worst_of_bar(t_named, j_named, rtol=1e-4, atol=1e-5):
    """The largest float error over the bar of assert_states_match."""
    worst = 0.0
    for name, want in j_named.items():
        if name in t_named and np.issubdtype(want.dtype, np.floating):
            fin = np.isfinite(want)
            err = np.abs(t_named[name][fin] - want[fin]) \
                / (atol + rtol * np.abs(want[fin]))
            worst = max(worst, float(err.max(initial=0.0)))
    return worst


@pytest.mark.parametrize("start", FIT64_STARTS)
def test_one_step_with_float64_fits_matches_jax(monkeypatch, zamtrux_run,
                                                fit64_jax_step, start):
    """The witness for the start states that test_one_step_matches_jax_leaf_
    by_leaf leaves out: from these, the f32 step misses rtol 1e-4 / atol
    1e-5 on one entry of the fitted means or factors.  With each package's
    MORE fit replaced by the float64 fit of its own inputs, one step matches
    leaf by leaf at that bar (integers exact), so the rest of the step, its
    window and weights included, agrees; and JAX's own f32 step lands as far
    from its float64-fit step (1.9, 1.9 and 4.4 times the bar) as the port's
    does, so the bar is finer than the reference's f32 solve can repeat."""
    jg, tg, leaves, draws = zamtrux_run
    step, state_of = fit64_jax_step
    want = jax_state_leaves(step(state_of(leaves[start])))
    assert _worst_of_bar(leaves[start + 1], want) > 1.0

    monkeypatch.setattr(tne, "more_estimate", port_more64)
    tg.state = _port_state(tg, leaves[start])
    tg.train_iter(draws[start])
    got = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert_states_match(got, want, rtol=1e-4, atol=1e-5)


def test_trajectory_matches_jax(zamtrux_run):
    """TRAJ_ITERS ZAMTRUX iterations with JAX's draws injected every step:
    final ELBO within 1.0, component counts within 2 and fevals within
    0.5%.  Fevals are not held equal here, unlike the SAMTRON trajectory:
    the fresh-sample count of every step is an ESS floor, and the float
    drift of a trajectory (sums in another order) moves a floor across an
    integer now and then."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    jg, tg, leaves, draws = zamtrux_run
    tg.state = _port_state(tg, leaves[0])
    for dr in draws:
        tg.train_iter(dr)
    j_named = leaves[-1]
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    fe_t = int(t_named["db.num_samples_written"])
    fe_j = int(j_named["db.num_samples_written"])
    assert abs(fe_t - fe_j) <= 0.005 * fe_j, (fe_t, fe_j)
    assert abs(int(t_named["model.num_active"])
               - int(j_named["model.num_active"])) <= 2
    jm, tm = _jax_model(jg, j_named), _port_state(tg, t_named).model

    def j_model(x):
        return np.asarray(jgmm.log_density(jm, jnp.asarray(x)))

    def t_model(x):
        return tgmm.log_density(tm, torch.as_tensor(x)).numpy()

    def j_target(x):
        return np.asarray(jg.target_distribution.log_density(x))

    elbos = [mc_elbo(m, j_target, named["model.means"], named["model.chols"],
                   named["model.log_weights"],
                   int(named["model.num_active"]))
             for named, m in ((j_named, j_model), (t_named, t_model))]
    assert abs(elbos[0] - elbos[1]) < 1.0, elbos
    assert np.isfinite(elbos).all()
    assert math.isfinite(float(tg.state.wstep.stepsize))
