"""The decimating sample database (``tpu.db_eviction: decimate``) of the
PyTorch port against the JAX package's ``sample_db_decimate``: each
operation on the same numpy inputs (an add that overflows and decimates by
a stride of 2 or more, the compaction of the distribution table, the
newest window with its count-weighted background, the random candidates
from JAX's uniforms, ``keep_samples=False``), a 40-step SAMTRON run that
decimates, step by step from JAX's state with JAX's draws, and a
checkpoint that resumes to the bit.  Adds and compactions move values
without arithmetic, so their leaves are held equal; the background within
rtol 1e-5; the steps leaf by leaf at the one-step bar (rtol 1e-4 / atol
1e-5).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (assert_states_match, build_pair, jax_state_leaves,
                          jax_step_draws, xdist_lock)

import gmmvi_tpu_torch

torch.set_num_threads(2)


def _models(k=3, kmax=4, d=2, seed=0, diagonal=False):
    """The same random mixture in both packages (the port's made from
    JAX's arrays, so the factors are equal to the bit)."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models.gmm import GmmState

    rng = np.random.RandomState(seed)
    w = np.full(k, 1.0 / k, np.float32)
    mu = rng.randn(k, d).astype(np.float32)
    if diagonal:
        covs = rng.uniform(0.5, 2.0, (k, d)).astype(np.float32)
    else:
        a = rng.randn(k, d, d).astype(np.float32)
        covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    jm = jgmm.create_gmm_state(w, mu, covs, max_components=kmax,
                               diagonal=diagonal)
    return jm, GmmState(**{f: torch.as_tensor(np.array(getattr(jm, f)))
                           for f in ("log_weights", "means", "chols",
                                     "inv_chols", "num_active")},
                        diagonal=diagonal)


def _leaves(db):
    return {k: np.asarray(v) for k, v in vars(db).items()
            if isinstance(v, (torch.Tensor, jax.Array))}


def _assert_dbs_equal(tdb, jdb):
    t, j = _leaves(tdb), _leaves(jdb)
    assert set(t) == set(j)
    for name in t:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def _batch(rng, n, d, kmax, frac_valid=0.8):
    """A proposal batch: samples, valid rows, mapping, lnpdfs, grads."""
    return (rng.randn(n, d).astype(np.float32),
            rng.uniform(size=n) < frac_valid,
            rng.randint(0, kmax, n).astype(np.int32),
            rng.randn(n).astype(np.float32),
            rng.randn(n, d).astype(np.float32))


def _add_both(jdb, tdb, jm, tm, batch, it):
    from gmmvi_tpu.optimization import sample_db_decimate as jdec

    s, v, m, l, g = batch
    jdb = jdec.add_samples(jdb, jnp.asarray(it), jm, jnp.asarray(s),
                           jnp.asarray(v), jnp.asarray(m), jnp.asarray(l),
                           jnp.asarray(g), jax.random.PRNGKey(it))
    tdb = tdb.add_samples(it, tm, torch.as_tensor(s), torch.as_tensor(v),
                          torch.as_tensor(m), torch.as_tensor(l),
                          torch.as_tensor(g), None, None)
    return jdb, tdb


def _create_both(d, kmax, capacity, dist_capacity, **kw):
    from gmmvi_tpu.optimization import sample_db_decimate as jdec
    from gmmvi_tpu_torch.optimization import sample_db_decimate as tdec

    return (jdec.create_decimating_db(d, kmax, capacity, dist_capacity, **kw),
            tdec.create_decimating_db(d, kmax, capacity, dist_capacity,
                                      device="cpu", **kw))


@pytest.mark.parametrize("capacity,batch", [(64, 24), (20, 16)])
@pytest.mark.parametrize("diagonal", [False, True])
def test_adds_that_overflow_match_jax(capacity, batch, diagonal):
    """Adds into a store of ``capacity`` rows from batches of ``batch``
    rows: every leaf equal to JAX's after every add, through decimations
    by a stride of 2 (64, 24) and of 4 and more (20, 16, where one halving
    cannot make room), with the table compacted each time."""
    rng = np.random.RandomState(1)
    d, kmax = 2, 4
    jm, tm = _models(d=d, kmax=kmax, diagonal=diagonal)
    jdb, tdb = _create_both(d, kmax, capacity, 64, diagonal=diagonal)
    counts = []
    for it in range(8):
        jdb, tdb = _add_both(jdb, tdb, jm, tm,
                             _batch(rng, batch, d, kmax), it)
        _assert_dbs_equal(tdb, jdb)
        counts.append(int(tdb.count))
        assert counts[-1] <= capacity
    assert any(b < a for a, b in zip(counts, counts[1:]))   # it decimated


def test_table_self_compaction_matches_jax():
    """A table too small for another block of components compacts itself
    to the rows still referenced, in ascending order, as JAX's does; the
    compaction on its own too (``_compact_dists``)."""
    from gmmvi_tpu.optimization import sample_db_decimate as jdec
    from gmmvi_tpu_torch.optimization import sample_db_decimate as tdec

    rng = np.random.RandomState(2)
    d, kmax = 3, 4
    jm, tm = _models(k=4, d=d, kmax=kmax)
    jdb, tdb = _create_both(d, kmax, 48, 10)
    for it in range(6):
        jdb, tdb = _add_both(jdb, tdb, jm, tm, _batch(rng, 12, d, kmax,
                                                      frac_valid=0.6), it)
        _assert_dbs_equal(tdb, jdb)
    _assert_dbs_equal(tdec._compact_dists(tdb), jdec._compact_dists(jdb))


@pytest.mark.parametrize("diagonal", [False, True])
def test_window_with_its_background_matches_jax(diagonal):
    """The newest window over a decimated store of several models' samples:
    samples, mapping, iterations and validity equal, the count-weighted
    background over the ``max_background_dists`` most used table rows
    within rtol 1e-5 (rows beyond them drop their samples)."""
    from gmmvi_tpu.optimization import sample_db_decimate as jdec

    rng = np.random.RandomState(3)
    d, kmax = 3, 4
    jdb, tdb = _create_both(d, kmax, 80, 128, diagonal=diagonal)
    for it in range(7):
        jm, tm = _models(k=3, d=d, kmax=kmax, seed=10 + it,
                         diagonal=diagonal)
        jdb, tdb = _add_both(jdb, tdb, jm, tm, _batch(rng, 20, d, kmax),
                             it)
    for window, n_req, max_bg in ((40, 35, 6), (60, 60, 64)):
        jw = jdec.get_newest_samples(jdb, window, jnp.asarray(n_req), max_bg)
        tw = tdb.get_newest_samples(window, torch.tensor(n_req), max_bg)
        for name in ("samples", "mapping", "target_lnpdfs", "valid",
                     "num_valid", "sample_iters"):
            np.testing.assert_array_equal(np.asarray(getattr(tw, name)),
                                          np.asarray(getattr(jw, name)),
                                          err_msg=name)
        np.testing.assert_allclose(tw.background_log_pdfs.numpy(),
                                   np.asarray(jw.background_log_pdfs),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("keep_samples", [True, False])
def test_random_candidates_match_jax(keep_samples):
    """The add heuristic's candidates from JAX's ``[S]`` uniforms: the
    stored rows in their stable order, empty rows after them invalid;
    with ``keep_samples`` False each add replaces the store (the newest
    batch only) while the feval counter keeps counting."""
    from gmmvi_tpu.optimization import sample_db_decimate as jdec

    rng = np.random.RandomState(4)
    d, kmax = 2, 4
    jm, tm = _models(d=d, kmax=kmax)
    jdb, tdb = _create_both(d, kmax, 64, 64, keep_samples=keep_samples)
    for it in range(3):
        jdb, tdb = _add_both(jdb, tdb, jm, tm, _batch(rng, 16, d, kmax), it)
        _assert_dbs_equal(tdb, jdb)
    key = jax.random.PRNGKey(9)
    want = jdec.get_random_samples(jdb, key, 40)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (64,))))
    got = tdb.get_random_samples(u, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not keep_samples:
        assert int(tdb.count) == int(got[2].sum()) < 16
        assert int(tdb.num_samples_written) > int(tdb.count)


def _decimating_pair():
    """SAMTRON at the size of tests/test_end_to_end.py's decimation run
    (16 samples per component, reuse 2.0, 4 slots, 2 initial components)
    on the 5-D Student-T mixture, ``max_database_size`` 256: a store of
    max(256, the 192-sample window) rows."""
    return build_pair(dims=5, ratio=2.0, n_des=16, kmax=4, k0=2,
                      del_iters=8, add_iters=5,
                      extra={"max_database_size": 256,
                             "tpu": {"db_eviction": "decimate"}})


def test_forty_steps_match_jax_step_by_step(tmp_path_factory):
    """40 SAMTRON steps with the decimating database, each from JAX's state
    carried across with JAX's draws injected: the leaves after every step
    match JAX's (integers exact, floats rtol 1e-4 / atol 1e-5), the store
    decimates (more samples written than it holds) and never holds more
    than its capacity."""
    from gmmvi_tpu_torch.optimization.sample_db_decimate import \
        DecimatingDbState

    with xdist_lock(tmp_path_factory, "tests"):
        jg, tg = _decimating_pair()
        assert isinstance(tg.state.db, DecimatingDbState)
        cap = tg.state.db.capacity
        for _ in range(40):
            tg.state = gmmvi_tpu_torch.state_from_numpy(
                jax_state_leaves(jg.state), device="cpu", like=tg.state)
            draws = jax_step_draws(jg)
            assert draws.rand_slots is None
            jg.train_iter()
            tg.train_iter(draws)
            t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
            assert_states_match(t_named, jax_state_leaves(jg.state),
                                rtol=1e-4, atol=1e-5)
            assert int(t_named["db.count"]) <= cap
        assert int(t_named["db.num_samples_written"]) > cap


def test_own_run_decimates_and_converges():
    """The port's own 40 steps (its generator's draws): the store stays
    within its capacity, decimates, and the ELBO estimate rises."""
    from gmmvi_tpu_torch.runner import sample_elbo

    _, tg = _decimating_pair()
    cap = tg.state.db.capacity

    def elbo():
        gen = torch.Generator().manual_seed(0)
        return -sample_elbo(tg.model, tg.target_distribution, 1.0,
                            generator=gen)[0]["-elbo"]

    start = elbo()
    for _ in range(40):
        tg.train_iter()
        assert int(tg.state.db.count) <= cap
    assert int(tg.state.db.num_samples_written) > cap
    assert int(tg.model.num_active) > 2
    assert elbo() > start + 1.0


def test_checkpoint_resumes_to_the_bit(tmp_path):
    """A decimating run saved after 12 steps, loaded into a fresh instance
    of the same config: the next 6 steps equal the unbroken run's leaf by
    leaf to the bit, across a decimation; the leaves keep JAX's paths."""
    from gmmvi_tpu_torch.utils import checkpoint as ckpt

    jg, tg = _decimating_pair()
    tg.train_iters(12)
    path = str(tmp_path / "dec.npz")
    ckpt.save_state(path, tg.state, tg.generator)
    written = int(tg.state.db.num_samples_written)
    tg.train_iters(6)
    assert int(tg.state.db.count) < written + 6 * 64   # it decimated
    _, fresh = _decimating_pair()
    state, gen = ckpt.load_state(path, fresh.state, device="cpu")
    fresh.state = state
    fresh.generator.set_state(gen)
    fresh.train_iters(6)
    a = gmmvi_tpu_torch.state_to_numpy(tg.state)
    b = gmmvi_tpu_torch.state_to_numpy(fresh.state)
    assert set(a) == set(jax_state_leaves(jg.state)) - {"key"}
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
