"""The port's sharded sample database (``tpu.db_layout: sharded``) against
the JAX package's ``sample_db_sharded``, op by op, in one process.

Both hold all ``P`` shards as ``[P, ...]`` leaves here (a rank of a meshed
port run holds its own as ``[1, ...]``, through the same functions); the
same batches go in with the same draws (JAX's, recomputed from its keys),
and the rings, reservoirs and windows come out equal: integers and masks
exactly, floats within the one-step bar.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gmmvi_tpu.models import gmm as jgmm
from gmmvi_tpu.optimization import sample_db_sharded as jshd

from gmmvi_tpu_torch.models import gmm as tgmm
from gmmvi_tpu_torch.optimization import sample_db as tdb
from gmmvi_tpu_torch.optimization import sample_db_sharded as tshd

P, KMAX, D = 4, 4, 3


def _models(rng, k=3):
    w = np.ones(k, np.float32) / k
    mu = rng.randn(k, D).astype(np.float32)
    covs = np.tile(np.eye(D, dtype=np.float32)[None], (k, 1, 1)) \
        * rng.uniform(0.5, 2.0, (k, 1, 1)).astype(np.float32)
    return (jgmm.create_gmm_state(w, mu, covs, max_components=KMAX),
            tgmm.create_gmm_state(w, mu, covs, max_components=KMAX,
                                  device="cpu"))


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _fill(n_iters, b, capacity=96, reservoir=32, keep_samples=True,
          seed=7):
    """The same ``n_iters`` batches of ``b`` rows (about 80% valid) into
    JAX's and the port's P-shard databases, and into the port's global
    ring; the port takes JAX's reservoir draws of every write."""
    rng = np.random.RandomState(seed)
    jm, tm = _models(rng)
    kw = dict(dim=D, max_components=KMAX, capacity=capacity,
              dist_ring_iters=4, reservoir_capacity=reservoir,
              keep_samples=keep_samples)
    jdb = jshd.create_sharded_db(n_shards=P, **kw)
    tdb_s = tshd.create_sharded_db(n_shards=P, device="cpu", **kw)
    ring = tdb.create_sample_db(device="cpu", **kw)
    key = jax.random.PRNGKey(1)
    for it in range(n_iters):
        samples = rng.randn(b, D).astype(np.float32)
        valid = rng.rand(b) < 0.8
        mapping = rng.randint(0, 3, b).astype(np.int32)
        lnp = rng.randn(b).astype(np.float32)
        grads = rng.randn(b, D).astype(np.float32)
        key, sub = jax.random.split(key)
        jdb = jshd.add_samples(jdb, jnp.asarray(it, jnp.int32), jm,
                               jnp.asarray(samples), jnp.asarray(valid),
                               jnp.asarray(mapping), jnp.asarray(lnp),
                               jnp.asarray(grads), sub)
        slot_key, acc_key = jax.random.split(sub)
        slots = _t(jax.random.randint(slot_key, (P, b // P), 0,
                                      jdb.reservoir_capacity_local),
                   torch.int32)
        acc = _t(jax.random.uniform(acc_key, (P, b // P)))
        args = (it, tm, _t(samples), _t(valid), _t(mapping), _t(lnp),
                _t(grads))
        tdb_s = tshd.add_samples(tdb_s, *args, slots, acc)
        ring = tdb.add_samples(ring, *args, slots.reshape(-1) % reservoir,
                               acc.reshape(-1))
    return jm, tm, jdb, tdb_s, ring


def _assert_db_equal(tdb_s, jdb):
    for name in ("samples", "target_lnpdfs", "target_grads", "sample_iter",
                 "sample_comp", "write_pos", "num_samples_written",
                 "dist_means", "dist_block_iter", "res_samples",
                 "res_lnpdfs", "res_count"):
        got = getattr(tdb_s, name).numpy()
        want = np.asarray(getattr(jdb, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_windows_equal(twin, jwin):
    for name in ("mapping", "valid", "num_valid", "sample_iters",
                 "samples", "target_lnpdfs", "target_grads"):
        np.testing.assert_array_equal(getattr(twin, name).numpy(),
                                      np.asarray(getattr(jwin, name)),
                                      err_msg=name)
    v = twin.valid.numpy()
    np.testing.assert_allclose(twin.background_log_pdfs.numpy()[v],
                               np.asarray(jwin.background_log_pdfs)[v],
                               rtol=1e-4, atol=1e-5)


def test_writes_match_jax():
    """Three writes of 64 rows into 4 shards: every ring, write position,
    reservoir and the global feval count equal to JAX's, to the bit."""
    _, _, jdb, tdb_s, _ = _fill(3, 64)
    _assert_db_equal(tdb_s, jdb)
    assert int(tdb_s.num_samples_written) == int(jdb.num_samples_written)


def _newest_counts(jdb, window):
    """Valid rows of each iteration in the window, newest first."""
    win = jshd.get_newest_samples(jdb, window, jnp.asarray(10 ** 6), 16)
    it = np.asarray(win.sample_iters)[np.asarray(win.valid)]
    return [int((it == t).sum()) for t in sorted(set(it), reverse=True)]


@pytest.mark.parametrize("window,iters", [(96, None), (192, None),
                                          (192, 2)])
def test_window_matches_jax(window, iters):
    """Each shard's newest ``window / P`` rows with the iteration-granular
    count bound where it falls between iterations (all of them, or the
    two newest exactly), as JAX gathers them: samples, masks and counts
    exactly, backgrounds at the bar."""
    _, _, jdb, tdb_s, _ = _fill(4, 64, capacity=256)
    n_req = 10 ** 6 if iters is None else sum(
        _newest_counts(jdb, window)[:iters])
    jwin = jshd.get_newest_samples(jdb, window, jnp.asarray(n_req), 8)
    twin = tshd.get_newest_samples(tdb_s, window, torch.tensor(n_req), 8)
    _assert_windows_equal(twin, jwin)


@pytest.mark.parametrize("extra", [1, 20])
def test_window_keeps_the_iteration_its_bound_falls_in(extra):
    """Where the count bound falls inside an iteration (``extra`` rows past
    the two newest), the port keeps that iteration whole, as the JAX
    package's ``_gather_window_sharded`` documents; JAX's code drops it
    (with sample reuse that drops the first add batch once the
    background's selection trims the count, and its sharded ZAMTRUX
    stalls).  Before the background's selection (every distribution
    kept): the port's valid rows are JAX's and all of the third newest
    iteration's, and reach the bound."""
    _, _, jdb, tdb_s, _ = _fill(4, 64, capacity=256)
    counts = _newest_counts(jdb, 192)
    n_req = counts[0] + counts[1] + extra
    jwin = jshd.get_newest_samples(jdb, 192, jnp.asarray(n_req), 16)
    twin = tshd.get_newest_samples(tdb_s, 192, torch.tensor(n_req), 16)
    jv, tv = np.asarray(jwin.valid), twin.valid.numpy()
    it = twin.sample_iters.numpy()
    assert not (jv & ~tv).any()
    added = np.unique(it[tv & ~jv])
    assert added.size == 1 and added[0] < it[jv].min()
    assert (tv & ~jv).sum() == counts[2]
    assert int(np.asarray(jwin.num_valid)) < n_req <= int(twin.num_valid)


def test_window_multiset_matches_plain_ring():
    """The same batches into the port's global ring and its 4-shard ring:
    where every shard's window holds all it was given, the windows' valid
    (sample, lnpdf, background) multisets are equal."""
    _, _, _, tdb_s, ring = _fill(3, 64, capacity=256)
    swin = tshd.get_newest_samples(tdb_s, 192, torch.tensor(160), 8)
    pwin = tdb.get_newest_samples(ring, 192, torch.tensor(160), 8)
    assert int(tdb_s.num_samples_written) == int(ring.num_samples_written)

    def multiset(win):
        v = win.valid.numpy()
        s = win.samples.numpy()[v]
        order = np.lexsort(s.T)
        return (s[order], win.target_lnpdfs.numpy()[v][order],
                win.background_log_pdfs.numpy()[v][order])

    (s_s, l_s, b_s), (s_p, l_p, b_p) = multiset(swin), multiset(pwin)
    assert s_s.shape == s_p.shape and s_s.shape[0] > 100
    np.testing.assert_array_equal(s_s, s_p)
    np.testing.assert_array_equal(l_s, l_p)
    np.testing.assert_allclose(b_s, b_p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("any_old", [False, True])
def test_fused_window_matches_jax(any_old):
    """The fused window (the current model's density pack and the
    background from the ``[R Kmax]`` counts: the current row's weights and,
    with reuse, the older distributions) as JAX's."""
    jm, tm, jdb, tdb_s, _ = _fill(3, 64)
    jwin, jpack = jshd.get_newest_samples_fused(
        jdb, 96, jnp.asarray(120), 8, jm, jnp.asarray(2, jnp.int32), any_old)
    twin, tpack = tshd.get_newest_samples_fused(
        tdb_s, 96, torch.tensor(120), 8, tm, 2, any_old)
    _assert_windows_equal(twin, jwin)
    np.testing.assert_allclose(tpack.model_log_densities.numpy(),
                               np.asarray(jpack.model_log_densities),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("keep_samples", [True, False])
def test_random_samples_masking_matches_jax(keep_samples):
    """Add candidates drawn per shard: from each reservoir by a permutation
    of its slots (slots past its fill invalid) or, without a database, from
    each shard's newest batch by uniforms; the same rows, lnpdfs and
    masks as JAX's from its key."""
    _, _, jdb, tdb_s, _ = _fill(2, 32, keep_samples=keep_samples)
    key = jax.random.PRNGKey(3)
    n = 14
    js, jl, jv = jshd.get_random_samples(jdb, key, n)
    n_l = -(-n // P)
    if keep_samples:
        keys = jax.random.split(key, P)
        draw = _t(jax.vmap(lambda k: jax.random.permutation(
            k, jdb.reservoir_capacity_local))(keys)[:, :n_l], torch.int64)
    else:
        draw = _t(jax.random.uniform(key, (P, jdb.capacity_local)))
    ts, tl, tv = tshd.get_random_samples(tdb_s, draw, n)
    assert ts.shape == (n, D)
    v = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), v)
    np.testing.assert_array_equal(ts.numpy()[v], np.asarray(js)[v])
    np.testing.assert_array_equal(tl.numpy()[v], np.asarray(jl)[v])
    assert np.all(np.isfinite(tl.numpy()[v]))


def test_repad_matches_jax():
    """Growing the component padding and every shard's ring keeps each
    shard's newest samples at their positions, as JAX's repad does."""
    _, _, jdb, tdb_s, _ = _fill(3, 64)
    jnew = jshd.repad_db(jdb, 8, 160)
    tnew = tshd.repad_db(tdb_s, 8, 160)
    _assert_db_equal(tnew, jnew)
    np.testing.assert_array_equal(tnew.dist_chols.numpy(),
                                  np.asarray(jnew.dist_chols))
    jwin = jshd.get_newest_samples(jnew, 96, jnp.asarray(120), 8)
    twin = tshd.get_newest_samples(tnew, 96, torch.tensor(120), 8)
    _assert_windows_equal(twin, jwin)


def test_sharded_layout_without_a_mesh_raises_as_jax():
    """``tpu.db_layout: sharded`` with no mesh raises the JAX package's
    ValueError."""
    from torch_parity import samtron_overrides
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.experiments.targets.student_t_mixture import \
        make_target as j_target
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI

    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target as t_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    over = samtron_overrides(n_des=4, kmax=4, k0=2)
    over["tpu"]["db_layout"] = "sharded"
    jc = jcfg.update_config(jcfg.get_default_algorithm_config("SAMTRON"),
                            over)
    jc["target_fn"] = jt = j_target(3, False, seed=0)
    _, jm, jmeta = j_init(jc)
    with pytest.raises(ValueError) as jerr:
        JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = tcfg.update_config(tcfg.get_default_algorithm_config("SAMTRON"),
                            over)
    tc["target_fn"] = tt = t_target(3, False, seed=0, device="cpu")
    _, tm, tmeta = t_init(tc, device="cpu")
    with pytest.raises(ValueError) as terr:
        TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_a_rank_state_knows_its_shards():
    """A rank's ``[1, ...]`` database carries the shard count and its own
    shard (as the JAX package's state carries ``P`` in its leaves), so no
    collective scope is needed to read them: the optimizer's draws are
    ``[P, ...]`` from it, and the rank's write takes its own rows of them
    and equals that shard of the one-process ``[P, ...]`` form's."""
    from torch_parity import samtron_overrides
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    kw = dict(dim=D, max_components=KMAX, capacity=96, dist_ring_iters=4,
              reservoir_capacity=32, device="cpu")
    whole = tshd.create_sharded_db(n_shards=P, **kw)
    ranks = [tshd.create_sharded_db(n_shards=P, n_local=1, first_shard=r,
                                    **kw) for r in range(P)]
    assert [(db.n_shards, db.first_shard) for db in ranks] == [
        (P, r) for r in range(P)]
    assert (whole.n_shards, whole.first_shard) == (P, 0)
    assert ranks[2].replace(res_count=ranks[2].res_count + 1).first_shard \
        == 2

    rng = np.random.RandomState(5)
    _, tm = _models(rng)
    b = 64
    rows = (_t(rng.randn(b, D).astype(np.float32)), _t(rng.rand(b) < 0.8),
            _t(rng.randint(0, 3, b).astype(np.int32)),
            _t(rng.randn(b).astype(np.float32)),
            _t(rng.randn(b, D).astype(np.float32)))
    slots = torch.randint(0, 8, (P, b // P), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    acc = torch.rand((P, b // P), generator=torch.Generator().manual_seed(3))
    whole = tshd.add_samples(whole, 0, tm, *rows, slots, acc)
    for r, db in enumerate(ranks):
        blk = slice(r * b // P, (r + 1) * b // P)
        db = tshd.add_samples(db, 0, tm, *[x[blk] for x in rows], slots,
                              acc)
        for name in tshd.SHARDED_FIELDS:
            np.testing.assert_array_equal(getattr(db, name)[0].numpy(),
                                          getattr(whole, name)[r].numpy(),
                                          err_msg=name)

    cfg = tcfg.update_config(tcfg.get_default_algorithm_config("SAMTRON"),
                             samtron_overrides(n_des=4, kmax=4, k0=2,
                                               add_iters=2))
    cfg["target_fn"] = target = make_target(D, False, seed=0, device="cpu")
    _, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    db = g.state.db
    g.state.db = tshd.create_sharded_db(
        dim=D, max_components=4, capacity=db.capacity,
        dist_ring_iters=db.ring_iters, reservoir_capacity=64, n_shards=2,
        n_local=1, first_shard=1, device="cpu")
    draws = g.draw(1)                   # the add at iteration 2 is due
    assert tuple(draws.rand_slots.shape) == (2, 8)
    assert tuple(draws.accept_u.shape) == (2, 8)
    # each shard's candidates: the first of a permutation of its 32 slots
    assert tuple(draws.db_perm.shape) == (2, 32)
