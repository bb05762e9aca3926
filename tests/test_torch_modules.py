"""The PyTorch port's modules against the JAX package, one function at a
time, with the same numpy inputs and random draws made by JAX and injected
into the port."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

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


def _from_jax(js):
    """The port's GmmState holding exactly the JAX state's arrays."""
    return tgmm.GmmState(**{name: _t(getattr(js, name)) for name in (
        "log_weights", "means", "chols", "inv_chols", "num_active")})


def _assert_gmm_match(ts, js, rtol=1e-5, atol=1e-5):
    for name in ("log_weights", "means", "chols", "inv_chols"):
        _close(getattr(ts, name).numpy(), getattr(js, name), rtol, atol,
               name)
    assert int(ts.num_active) == int(js.num_active)


# ---------------------------------------------------------------------------
# models/gmm and models/meta
# ---------------------------------------------------------------------------

def test_create_state_entropies_and_log_density_match_jax():
    rng, js, ts = _states()
    _assert_gmm_match(ts, js)
    _close(tgmm.component_entropies(ts)[:5], jgmm.component_entropies(js)[:5])
    _close(tgmm.average_entropy(ts), jgmm.average_entropy(js))
    x = rng.randn(30, 4).astype(np.float32) * 2
    _close(tgmm.log_density(ts, _t(x)), jgmm.log_density(js, jnp.asarray(x)),
           atol=1e-4)
    _close(tgmm.chol_log_det(ts.chols), jgmm.chol_log_det(js.chols, False))


def test_sample_from_components_with_injected_eps():
    _, js, ts = _states()
    key = jax.random.PRNGKey(3)
    want = jgmm.sample_from_components(js, key, 6)
    eps = jax.random.normal(key, (8, 6, 4), jnp.float32)
    got = tgmm.sample_from_components(ts, _t(eps))
    _close(got, want, rtol=1e-6, atol=1e-5)


def test_add_remove_replace_components_match_jax():
    rng, js, ts = _states(k=5, kmax=7)
    mean = rng.randn(4).astype(np.float32)
    cov = (2.5 * np.eye(4)).astype(np.float32)
    ja = jgmm.add_component(js, jnp.float32(1e-29), jnp.asarray(mean),
                            jnp.asarray(cov))
    ta = tgmm.add_component(ts, 1e-29, _t(mean), _t(cov))
    _assert_gmm_match(ta, ja)
    # full state: adding is a silent no-op in both
    for _ in range(3):
        ja = jgmm.add_component(ja, jnp.float32(0.1), jnp.asarray(mean),
                                jnp.asarray(cov))
        ta = tgmm.add_component(ta, 0.1, _t(mean), _t(cov))
    assert int(ta.num_active) == 7
    _assert_gmm_match(ta, ja)

    keep = np.array([True, False, True, True, False, True, True])
    jr = jgmm.remove_components(ja, jnp.asarray(keep))
    tr = tgmm.remove_components(ta, _t(keep))
    _assert_gmm_match(tr, jr)
    assert int(tr.num_active) == 5

    new_means = rng.randn(7, 4).astype(np.float32)
    new_chols = np.asarray(ja.chols) * 1.5
    _assert_gmm_match(
        tgmm.replace_components(tr, _t(new_means), _t(new_chols)),
        jgmm.replace_components(jr, jnp.asarray(new_means),
                                jnp.asarray(new_chols)))
    lw = rng.randn(7).astype(np.float32)
    _assert_gmm_match(tgmm.replace_weights(tr, _t(lw)),
                      jgmm.replace_weights(jr, jnp.asarray(lw)))


def test_meta_add_and_remove_match_jax():
    _, js, ts = _states(k=5, kmax=7)
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 8)
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 8)
    rng = np.random.RandomState(9)
    rw = rng.randn(7).astype(np.float32)
    jm = jmeta.store_rewards(jm, jnp.asarray(rw))
    tm = tmeta.store_rewards(tm, _t(rw))
    jm = jmeta.add_component_meta(jm, jnp.int32(5), jnp.bool_(True),
                                  jnp.float32(1e-29), jnp.float32(500.0),
                                  jnp.float32(3.5))
    tm = tmeta.add_component_meta(tm, torch.tensor(5), torch.tensor(True),
                                  1e-29, torch.tensor(500.0),
                                  torch.tensor(3.5))
    order = np.array([0, 2, 3, 5, 1, 4, 6])
    jm = jmeta.remove_components_meta(jm, jnp.asarray(order))
    tm = tmeta.remove_components_meta(tm, _t(order))
    for name in ("l2_regularizers", "last_etas", "num_received_updates",
                 "stepsizes", "reward_history", "weight_history",
                 "unique_component_ids", "max_component_id",
                 "adding_thresholds", "initial_entropies"):
        got, want = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            _close(got, want, err=name)


# ---------------------------------------------------------------------------
# optimization/sample_db and sample_selectors
# ---------------------------------------------------------------------------

def test_add_samples_and_window_bookkeeping_exact():
    """Several batches through a small ring (wrapping) and reservoir
    (overflowing) with JAX's draws injected: ring heads, slots, iterations,
    counts and the feval counter exactly, and the stored rows too."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization import sample_db as tdb

    rng, js, _ = _states(k=3, kmax=4, d=2, seed=5)
    ts = _from_jax(js)
    kmax, d, b, c = 4, 2, 4 * 5, 16
    jd = jdb.create_sample_db(d, kmax, capacity=b, dist_ring_iters=2,
                              reservoir_capacity=c)
    td = tdb.create_sample_db(d, kmax, capacity=b, dist_ring_iters=2,
                              reservoir_capacity=c, device="cpu")
    for it in range(5):
        x = rng.randn(b, d).astype(np.float32)
        valid = rng.rand(b) > 0.3
        mapping = np.repeat(np.arange(kmax, dtype=np.int32), b // kmax)
        lnp = rng.randn(b).astype(np.float32)
        grads = rng.randn(b, d).astype(np.float32)
        key = jax.random.PRNGKey(it)
        jd = jdb.add_samples(jd, jnp.int32(it), js, jnp.asarray(x),
                             jnp.asarray(valid), jnp.asarray(mapping),
                             jnp.asarray(lnp), jnp.asarray(grads), key)
        slot_key, acc_key = jax.random.split(key)
        td = tdb.add_samples(
            td, it, ts, _t(x), _t(valid), _t(mapping), _t(lnp), _t(grads),
            _t(jax.random.randint(slot_key, (b,), 0, c), torch.int32),
            _t(jax.random.uniform(acc_key, (b,))))
        for name in ("samples", "target_lnpdfs", "target_grads",
                     "sample_iter", "sample_comp", "write_pos",
                     "num_samples_written", "dist_means", "dist_chols",
                     "dist_inv_chols", "dist_block_iter", "res_samples",
                     "res_lnpdfs", "res_count"):
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)),
                                          err_msg=f"{name} after {it}")
        n_req = int(valid.sum())
        jw, jp = jdb.get_newest_samples_fused(
            jd, b, jnp.int32(n_req), kmax, js, jnp.int32(it), False)
        tw, tp = tdb.get_newest_samples_fused(
            td, b, torch.tensor(n_req, dtype=torch.int32), kmax, ts, it,
            False)
        for name in ("valid", "mapping", "num_valid", "sample_iters"):
            np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                          np.asarray(getattr(jw, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(tw.newest_mask.numpy(),
                                      np.asarray(jw.newest_mask))
        v = np.asarray(jw.valid)
        _close(tw.background_log_pdfs.numpy()[v],
               np.asarray(jw.background_log_pdfs)[v], atol=5e-4)
    assert int(td.res_count) > c  # the reservoir overflowed

    key = jax.random.PRNGKey(11)
    js_, jl_, jv_ = jdb.get_random_samples(jd, key, 12)
    perm = jax.random.permutation(key, c)[:12]
    ts_, tl_, tv_ = tdb.get_random_samples(td, _t(perm))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tl_.numpy(), np.asarray(jl_))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv_))


def test_propose_with_injected_eps():
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu.optimization import sample_selectors as jsel
    from gmmvi_tpu_torch.optimization import sample_db as tdb
    from gmmvi_tpu_torch.optimization import sample_selectors as tsel

    _, js, ts = _states(k=5, kmax=8, d=4)
    cfg = dict(kind="component-based", desired_samples_per_component=6,
               reused_samples_per_component=0, max_background_dists=8)
    jd = jdb.create_sample_db(4, 8, 48, 2, 16)
    td = tdb.create_sample_db(4, 8, 48, 2, 16, device="cpu")
    key = jax.random.PRNGKey(2)
    jp = jsel.propose(js, jd, jsel.SelectorConfig(**cfg), key)
    eps = jax.random.normal(key, (8, 6, 4), jnp.float32)
    tp = tsel.propose(ts, td, tsel.SelectorConfig(**cfg), _t(eps))
    _close(tp.samples, jp.samples, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.mapping.numpy(), np.asarray(jp.mapping))
    # with reuse on an empty database: no effective samples, all draws valid
    reuse = {**cfg, "reused_samples_per_component": 2}
    jp = jsel.propose(js, jd, jsel.SelectorConfig(**reuse), key)
    tp = tsel.propose(ts, td, tsel.SelectorConfig(**reuse), _t(eps))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert int(tp.num_reused) == int(jp.num_reused) == 0


# ---------------------------------------------------------------------------
# optimization: estimator, updaters, adaptation
# ---------------------------------------------------------------------------

def _window(seed=1, k=5, kmax=8, n=300, d=4):
    rng, js, ts = _states(k=k, kmax=kmax, d=d, seed=seed, offset=7.0)
    x = (rng.randn(n, d) * 2 + 7.0).astype(np.float32)
    return rng, js, ts, dict(
        x=x, bg=(rng.randn(n) - 4.0).astype(np.float32),
        lnp=rng.randn(n).astype(np.float32),
        grads=rng.randn(n, d).astype(np.float32),
        mask=rng.rand(n) > 0.1,
        mapping=rng.randint(0, k, n).astype(np.int32))


@pytest.mark.parametrize("own", [False, True])
def test_stein_estimate_matches_jax_moment_form(monkeypatch, own):
    """The port's moment-form Stein estimate against JAX's, with JAX's pack
    from the interpret kernel (moment form) and from XLA (the direct form
    through prec_times_diff)."""
    from gmmvi_tpu.optimization.ng_estimators import stein_estimate as js_est
    from gmmvi_tpu_torch.optimization.ng_estimators import \
        stein_estimate as ts_est

    _, js, ts, w = _window()
    t_est = ts_est(ts, _t(w["x"]), _t(w["mask"]), _t(w["mapping"]),
                   _t(w["bg"]), _t(w["lnp"]), _t(w["grads"]),
                   only_use_own_samples=own)
    for mode in ("interpret", "0"):
        monkeypatch.setenv("GMMVI_FUSED_DENSITY", mode)
        j_est = js_est(js, jnp.asarray(w["x"]), jnp.asarray(w["mask"]),
                       jnp.asarray(w["mapping"]), jnp.asarray(w["bg"]),
                       jnp.asarray(w["lnp"]), jnp.asarray(w["grads"]),
                       only_use_own_samples=own)
        # active slots only: JAX leaves NaN in the inactive rows of the
        # own-samples estimate, the port zeros; neither row is ever read
        _close(t_est.expected_gradients_neg[:5],
               j_est.expected_gradients_neg[:5], rtol=1e-5, atol=1e-5)
        _close(t_est.expected_hessians_neg[:5],
               j_est.expected_hessians_neg[:5], rtol=1e-4, atol=1e-5)


def test_trust_region_update_matches_jax(monkeypatch):
    """Final eta and success mask (meta.last_etas, l2 regularizers) and the
    updated components against _trust_region_update_pallas (interpret)."""
    import gmmvi_tpu.optimization.component_updaters as jcu
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    monkeypatch.setenv("GMMVI_FUSED_TR", "interpret")
    rng, js, ts = _states(k=5, kmax=8, d=6, seed=3)
    jm = jmeta.create_meta_state(js, 0.01, 1e-12, 10)
    tm = tmeta.create_meta_state(ts, 0.01, 1e-12, 10)
    last = np.array([5.0, -1.0, 20.0, -1.0, 2.0, -1.0, -1.0, -1.0],
                    np.float32)
    jm = jm.replace(last_etas=jnp.asarray(last))
    tm = tm.replace(last_etas=_t(last))
    h = rng.randn(8, 6, 6).astype(np.float32) * 0.3
    hneg = np.einsum("kij,klj->kil", h, h) + 0.05 * np.eye(6, dtype=np.float32)
    hneg[1] -= 2.0 * np.eye(6, dtype=np.float32)  # infeasible at small eta
    gneg = rng.randn(8, 6).astype(np.float32)
    steps = np.full(8, 0.05, np.float32)
    jr = jcu.trust_region_update(js, jm, jnp.asarray(hneg),
                                 jnp.asarray(gneg), jnp.asarray(steps))
    tr = tcu.trust_region_update(ts, tm, _t(hneg), _t(gneg), _t(steps))
    np.testing.assert_array_equal(tr.meta.last_etas.numpy() > 0,
                                  np.asarray(jr.meta.last_etas) > 0)
    _close(tr.meta.last_etas, jr.meta.last_etas, rtol=1e-5, atol=1e-6)
    _close(tr.meta.l2_regularizers, jr.meta.l2_regularizers, rtol=1e-6,
           atol=0)
    _close(tr.meta.num_received_updates, jr.meta.num_received_updates)
    _assert_gmm_match(tr.model, jr.model, rtol=1e-4, atol=1e-5)


def test_weight_update_matches_jax():
    """expected_log_ratios (rewards into the history) and the trust-region
    weight update, against JAX."""
    from gmmvi_tpu.optimization import weight_updaters as jwu
    from gmmvi_tpu_torch.optimization import weight_updaters as twu

    _, js, ts, w = _window(seed=4)
    jm = jmeta.create_meta_state(js, 0.1, 1e-12, 6)
    tm = tmeta.create_meta_state(ts, 0.1, 1e-12, 6)
    j_elr, jm = jwu.expected_log_ratios(
        js, jm, jnp.asarray(w["x"]), jnp.asarray(w["mask"]),
        jnp.asarray(w["bg"]), jnp.asarray(w["lnp"]), 1.0, True)
    t_elr, tm = twu.expected_log_ratios(
        ts, tm, _t(w["x"]), _t(w["mask"]), _t(w["bg"]), _t(w["lnp"]), 1.0,
        True)
    _close(t_elr[:5], j_elr[:5], rtol=1e-5, atol=1e-4)
    _close(tm.reward_history, jm.reward_history, rtol=1e-5, atol=1e-4)
    for bound in (1e-3, 0.05, 5.0):
        jmod, jmt = jwu.trust_region_weight_update(js, jm, j_elr, bound, 1.0)
        tmod, tmt = twu.trust_region_weight_update(ts, tm, t_elr, bound, 1.0)
        _close(tmod.log_weights, jmod.log_weights, rtol=1e-5, atol=1e-5)
        _close(tmt.weight_history, jmt.weight_history, rtol=1e-5, atol=1e-7)


def test_add_new_component_with_injected_draws():
    """The add heuristic against JAX's with JAX's candidate permutation and
    entropy coefficient injected."""
    from gmmvi_tpu.optimization import component_adaptation as jca
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization import component_adaptation as tca
    from gmmvi_tpu_torch.optimization import sample_db as tdb

    rng, js, ts = _states(k=4, kmax=6, d=3, seed=6)
    c = 32
    jd = jdb.create_sample_db(3, 6, 24, 2, c)
    td = tdb.create_sample_db(3, 6, 24, 2, c, device="cpu")
    x = (rng.randn(24, 3) * 4).astype(np.float32)
    lnp = rng.randn(24).astype(np.float32)
    valid = np.ones(24, bool)
    mapping = np.zeros(24, np.int32)
    grads = np.zeros((24, 3), np.float32)
    key = jax.random.PRNGKey(0)
    jd = jdb.add_samples(jd, jnp.int32(0), js, jnp.asarray(x),
                         jnp.asarray(valid), jnp.asarray(mapping),
                         jnp.asarray(lnp), jnp.asarray(grads), key)
    sk, ak = jax.random.split(key)
    td = tdb.add_samples(td, 0, ts, _t(x), _t(valid), _t(mapping), _t(lnp),
                         _t(grads), _t(jax.random.randint(sk, (24,), 0, c),
                                       torch.int32),
                         _t(jax.random.uniform(ak, (24,))))
    cfg = dict(del_iters=6, add_iters=5, max_components=6,
               thresholds_for_add_heuristic=(5000.0, 50.0),
               min_weight_for_del_heuristic=1e-6, num_database_samples=c,
               num_prior_samples=0, prior_entropy=9.0)
    jmt = jmeta.create_meta_state(js, 0.1, 1e-12, 12)
    tmt = tmeta.create_meta_state(ts, 0.1, 1e-12, 12)
    ja = jca.create_adaptation_state()
    ta = tca.create_adaptation_state(device="cpu")
    for call in range(3):   # the last add finds the state full
        key = jax.random.PRNGKey(10 + call)
        db_key, a_key = jax.random.split(key)
        jmod, jmt, ja, _ = jca.adapt_number_of_components(
            js, jmt, ja, jd, jca.VipsConfig(**cfg), jnp.int32(5), key)
        tmod, tmt, ta, _ = tca.adapt_number_of_components(
            ts, tmt, ta, td, tca.VipsConfig(**cfg), 5,
            _t(jax.random.permutation(db_key, c)[:c], torch.int64),
            _t(jax.random.uniform(a_key, ())))
        _assert_gmm_match(tmod, jmod, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tmt.unique_component_ids.numpy(),
                                      np.asarray(jmt.unique_component_ids))
        _close(tmt.initial_entropies, jmt.initial_entropies)
        _close(tmt.adding_thresholds, jmt.adding_thresholds)
        assert int(ta.num_calls_to_add_heuristic) == int(
            ja.num_calls_to_add_heuristic)
        js, ts = jmod, tmod
    assert int(ts.num_active) == 6


def test_delete_bad_components_matches_jax():
    """A reward history in which two components stagnate at low weight:
    both packages delete the same ones and compact model and meta alike;
    with nothing bad, nothing changes."""
    from gmmvi_tpu.optimization import component_adaptation as jca
    from gmmvi_tpu_torch.optimization import component_adaptation as tca

    rng, js, ts = _states(k=6, kmax=8, d=3, seed=8)
    di = 6
    h = 2 * di
    rh = np.cumsum(rng.rand(8, h).astype(np.float32), axis=1)
    rh[[1, 4]] = -50.0 + 0.01 * rng.rand(2, h)    # flat, low reward
    wh = np.full((8, h), 0.2, np.float32)
    wh[[1, 4]] = 1e-9
    cfg = jca.VipsConfig(del_iters=di, add_iters=5, max_components=8,
                         thresholds_for_add_heuristic=(50.0,),
                         min_weight_for_del_heuristic=1e-6,
                         num_database_samples=8, num_prior_samples=0)
    tcfg = tca.VipsConfig(*cfg)
    for rh_case in (rh, np.cumsum(np.ones((8, h), np.float32), 1)):
        jm = jmeta.create_meta_state(js, 0.1, 1e-12, h).replace(
            reward_history=jnp.asarray(rh_case),
            weight_history=jnp.asarray(wh))
        tm = tmeta.create_meta_state(ts, 0.1, 1e-12, h).replace(
            reward_history=_t(rh_case), weight_history=_t(wh))
        jmod, jmt = jca.delete_bad_components(js, jm, cfg)
        tmod, tmt = tca.delete_bad_components(ts, tm, tcfg)
        _assert_gmm_match(tmod, jmod)
        np.testing.assert_array_equal(tmt.unique_component_ids.numpy(),
                                      np.asarray(jmt.unique_component_ids))
        _close(tmt.reward_history, jmt.reward_history)
    assert int(tca.delete_bad_components(ts, tmeta.create_meta_state(
        ts, 0.1, 1e-12, h).replace(reward_history=_t(rh),
                                   weight_history=_t(wh)),
        tcfg)[0].num_active) == 4
