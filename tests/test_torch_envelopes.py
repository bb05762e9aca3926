"""Settings of the JAX package where the PyTorch port raised before:
full-covariance densities above D = 512, prior samples for the add
heuristic, add candidates without a sample database, ``tpu.debug_nans``,
and ``models/gmm.py``'s ``sample_from_components_shuffled`` and
``component_log_density_and_grad``; each against the JAX package on the
same numpy inputs from seeded ``np.random.RandomState``s, or a step from
JAX's state with JAX's draws injected, leaf by leaf at the one-step bar
(integers exact, floats within rtol 1e-4 / atol 1e-5).

Above D = 512 neither package has a kernel: both take the XLA chain (in
the port plain torch in slabs of components, ``models.gmm.xla_densities``)
and the kernel wrappers keep raising there.  No test builds a JAX GMMVI
with ``debug_nans`` on: JAX sets its flag for the whole process.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64,
                          port_target_to_float64)

import gmmvi_tpu_torch

torch.set_num_threads(2)

D_XLA = 520


def _mixture(d, k=3, kmax=4, seed=0, n=48):
    """(JAX model, port model, samples [n, d]) of the same random mixture
    (the port's factors JAX's to the bit), samples around its means."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models.gmm import GmmState

    rng = np.random.RandomState(seed)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    mu = rng.randn(k, d).astype(np.float32)
    a = (rng.randn(k, d, d) / np.sqrt(d)).astype(np.float32)
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    jm = jgmm.create_gmm_state(w, mu, covs, max_components=kmax)
    tm = GmmState(**{f: torch.as_tensor(np.array(getattr(jm, f)))
                     for f in ("log_weights", "means", "chols", "inv_chols",
                               "num_active")})
    x = (mu[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)
    return jm, tm, x


def test_densities_above_512_match_jax_xla_route():
    """At D = 520 (K = 3 in 4 slots, N = 48): the density pack (component
    and mixture log densities, the mixture gradient), the component
    densities, the mixture log density against JAX's XLA chain, rtol 1e-5
    (gradients: atol 1e-5 of their largest entry)."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    jm, tm, x = _mixture(D_XLA)
    jp = jgmm.density_pack(jm, jnp.asarray(x))
    tp = tgmm.density_pack(tm, torch.as_tensor(x))
    mask = np.asarray(jm.mask)
    np.testing.assert_allclose(tp.component_log_densities.numpy()[mask],
                               np.asarray(jp.component_log_densities)[mask],
                               rtol=1e-5)
    np.testing.assert_allclose(tp.model_log_densities.numpy(),
                               np.asarray(jp.model_log_densities), rtol=1e-5)
    g = np.asarray(jp.model_grads)
    np.testing.assert_allclose(tp.model_grads.numpy(), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())
    jmodel, jcomp = jgmm.log_densities_also_individual(jm, jnp.asarray(x))
    tmodel, tcomp = tgmm.log_densities_also_individual(tm,
                                                        torch.as_tensor(x))
    np.testing.assert_allclose(tcomp.numpy()[mask], np.asarray(jcomp)[mask],
                               rtol=1e-5)
    np.testing.assert_allclose(tmodel.numpy(), np.asarray(jmodel), rtol=1e-5)
    np.testing.assert_allclose(
        tgmm.component_log_densities_fast(tm, torch.as_tensor(x)).numpy()[
            mask], np.asarray(jcomp)[mask], rtol=1e-5)
    np.testing.assert_allclose(
        tgmm.log_density(tm, torch.as_tensor(x)).numpy(),
        np.asarray(jgmm.log_density(jm, jnp.asarray(x))), rtol=1e-5)


def test_slabs_equal_one_pass():
    """``xla_densities`` in slabs of a few components equals the one-pass
    chain (the slab size forced down to one component)."""
    from gmmvi_tpu_torch.models import gmm as tgmm

    _, tm, x = _mixture(D_XLA, k=4)
    args = (*tgmm._kernel_args(tm), torch.as_tensor(x))
    whole = tgmm.xla_densities(*args, want_grads=True)
    small = tgmm._DIAG_CHUNK
    tgmm._DIAG_CHUNK = 1
    try:
        sliced = tgmm.xla_densities(*args, want_grads=True)
    finally:
        tgmm._DIAG_CHUNK = small
    for a, b in zip(whole, sliced):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(a.abs().max()))


def test_background_above_512_matches_jax():
    """The count-weighted background over distribution rows with finite
    and -inf log weights at D = 520, against JAX's XLA chain
    (``_background_logsumexp`` off the TPU), rtol 1e-5."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization.sample_window import background

    jm, tm, x = _mixture(D_XLA, k=4, kmax=4)
    log_w = np.log(np.array([0.5, 0.3, 0.2, 1.0], np.float32))
    log_w[3] = -np.inf
    logdets = np.array(jnp.sum(jnp.log(jnp.diagonal(
        jm.chols, axis1=-2, axis2=-1)), -1))
    jring = jdb.create_sample_db(D_XLA, 4, 8, 2, 4)
    want = jdb._background_logsumexp(
        jring, jm.means, jm.inv_chols, jnp.asarray(logdets),
        jnp.asarray(log_w), jnp.asarray(np.isfinite(log_w)), jnp.asarray(x))
    got = background(False, tm.means, tm.inv_chols, torch.as_tensor(log_w),
                     torch.as_tensor(logdets), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_kernel_wrappers_still_raise_above_512():
    """The routes above D = 512 are chosen by D in the callers; B5, B6 and
    B9's wrappers keep raising outside their envelope."""
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.ops import density_large, mixture_logpdf

    _, tm, x = _mixture(D_XLA)
    args = (*tgmm._kernel_args(tm), torch.as_tensor(x))
    for fn in (density_large.densities_large,
               density_large.mixture_logpdf_large,
               density_large.density_pack_large,
               mixture_logpdf.mixture_logpdf):
        with pytest.raises(NotImplementedError, match="D <= 512"):
            fn(*args)


def test_samtron_step_at_d520_matches_jax():
    """One SAMTRON step at D = 520 (3 components in 4 slots, 16 samples
    each) from the initial state, with JAX's draws: the densities, the
    Stein estimate and the whitened bracket above every kernel's envelope,
    leaf by leaf at the one-step bar.  Both sides run in float64 (the
    state's float32 leaves cast exactly, the targets in float64, as
    ``tests/test_torch_large_d.py``'s step at D = 136): in float32 the
    Student-T target's gradients alone part by 2% of the bar's scale on
    small entries at this D."""
    jg, tg = build_pair(dims=D_XLA, kmax=4, n_des=16, k0=3)
    named = as_float64(jax_state_leaves(jg.state))
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(
            jg.target_distribution)
        jg.state = jax_state_from_leaves(jg.state, named)
        draws = jax_step_draws(jg, dtype=jnp.float64)
        jg.train_iter()
        j_named = jax_state_leaves(jg.state)
    port_target_to_float64(tg.target_distribution)
    tg.state = gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                                like=tg.state)
    tg.train_iter(draws)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert t_named["model.means"].dtype == np.float64
    assert int(t_named["db.num_samples_written"]) == 48
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("start", [3, 4])
def test_prior_samples_step_matches_jax(start):
    """``num_prior_samples`` 30 with a prior: every step draws them (JAX's
    key split once more before the update phase), the target is evaluated
    on them, and an add (``start`` 4: the step adds) takes them beside the
    reservoir's candidates and counts them as fevals; ``start`` 3 does not
    add, and counts nothing.  Leaf by leaf at the one-step bar."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5, extra={"num_component_adapter_config": {
                            "num_prior_samples": 30}})
    for _ in range(start):
        jg.train_iter()
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        jax_state_leaves(jg.state), device="cpu", like=tg.state)
    draws = jax_step_draws(jg)
    assert draws.prior_eps.shape == (30, 5)
    written = int(jg.state.db.num_samples_written)
    stored = int(jg.state.db.write_pos)
    jg.train_iter()
    tg.train_iter(draws)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert_states_match(t_named, jax_state_leaves(jg.state), rtol=1e-4,
                        atol=1e-5)
    added = int(t_named["model.num_active"]) > 5
    assert added == (start == 4)
    fresh = int(t_named["db.write_pos"]) - stored
    assert int(t_named["db.num_samples_written"]) - written \
        == fresh + (30 if added else 0)


def test_prior_samples_follow_the_prior():
    """The port's own prior samples: ``prior_mean + sqrt(initial_cov)
    eps`` from its generator, evaluated by the target every step."""
    _, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5,
                       extra={"num_component_adapter_config": {
                           "num_prior_samples": 4000}})
    draws = tg.draw(0)
    samples, lnpdfs = tg._prior_samples(draws)
    assert samples.shape == (4000, 5)
    np.testing.assert_allclose(samples.std(0).numpy(), 10.0, rtol=0.05)
    np.testing.assert_allclose(samples.mean(0).numpy(), 0.0, atol=0.5)
    np.testing.assert_array_equal(
        lnpdfs.numpy(), tg.target_distribution.log_density(samples).numpy())


def test_candidates_without_a_database_match_jax():
    """``use_sample_database: False``: the add candidates come from the
    newest add batch of the ring in the stable order of JAX's uniforms
    (the ring of several steps, after a wrap), equal to JAX's; a step that
    adds from them matches JAX's leaf by leaf."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu_torch.optimization import sample_db as tdb

    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5, extra={"use_sample_database": False})
    assert not tg.state.db.keep_samples
    for _ in range(4):
        jg.train_iter()
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        jax_state_leaves(jg.state), device="cpu", like=tg.state)
    key = jax.random.PRNGKey(5)
    want = jdb.get_random_samples(jg.state.db, key, 100)
    u = torch.as_tensor(np.asarray(jax.random.uniform(
        key, (tg.state.db.capacity,))))
    got = tdb.get_random_samples(tg.state.db, u, 100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    draws = jax_step_draws(jg)
    assert draws.db_perm is None and draws.db_u is not None
    jg.train_iter()
    tg.train_iter(draws)
    assert_states_match(gmmvi_tpu_torch.state_to_numpy(tg.state),
                        jax_state_leaves(jg.state), rtol=1e-4, atol=1e-5)


def _port_gmmvi(extra=None, target=None):
    import gmmvi_tpu_torch.configs as tcfg
    from torch_parity import samtron_overrides
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = tcfg.update_config(tcfg.get_default_algorithm_config("SAMTRON"),
                             samtron_overrides(n_des=8, kmax=4, k0=2))
    if extra:
        cfg = tcfg.update_config(cfg, extra)
    target = target or make_target(3, False, seed=0, device="cpu")
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device="cpu")
    return GMMVI.build_from_config(cfg, target, model, meta, device="cpu")


def test_debug_nans_raises_on_a_nan_and_changes_nothing_when_off():
    """With ``tpu.debug_nans`` a step whose target returns a NaN (which
    reaches the state) raises ``FloatingPointError`` naming the operation
    that made it (JAX's ``jax_debug_nans`` raises there) and keeps the
    state it started from; without it the step runs on; on a healthy step
    ``debug_nans`` True and False step to the same bits as the default."""
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target

    class NanTarget(type(make_target(3, False, seed=0, device="cpu"))):
        def log_density_and_grad(self, x):
            ld, g = super().log_density_and_grad(x)
            return ld * torch.nan, g

    def nan_target():
        t = make_target(3, False, seed=0, device="cpu")
        t.__class__ = NanTarget
        return t

    g = _port_gmmvi({"tpu": {"debug_nans": True}}, target=nan_target())
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        g.train_iter()
    assert g.num_updates == 0
    _port_gmmvi(target=nan_target()).train_iter()     # no check: runs on

    runs = [_port_gmmvi({"tpu": {"debug_nans": on}}) for on in (True, False)]
    runs.append(_port_gmmvi())
    for g in runs:
        g.train_iters(3)
    want = gmmvi_tpu_torch.state_to_numpy(runs[-1].state)
    for g in runs[:-1]:
        got = gmmvi_tpu_torch.state_to_numpy(g.state)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


def test_sample_from_components_shuffled_as_jax():
    """``tests/test_api_parity.py``'s check in the port, and the same rows
    as JAX's from JAX's normals and uniforms: the active slots' draws
    first, shuffled, then the inactive slots'."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    k, d, n = 2, 3, 500
    mu = np.stack([np.zeros(d), 50 * np.ones(d)]).astype(np.float32)
    covs = np.tile(np.eye(d, dtype=np.float32)[None], (k, 1, 1))
    jm = jgmm.create_gmm_state(np.ones(k, np.float32) / k, mu, covs,
                               max_components=4)
    tm = tgmm.create_gmm_state(np.ones(k, np.float32) / k, mu, covs,
                               max_components=4, device="cpu")
    smp = tgmm.sample_from_components_shuffled(
        tm, n, generator=torch.Generator().manual_seed(0)).numpy()
    valid = smp[:k * n]
    assert np.sum(np.linalg.norm(valid, axis=1) < 25) == n
    assert 0.3 * n < np.sum(np.linalg.norm(valid[:n], axis=1) < 25) < 0.7 * n

    key = jax.random.PRNGKey(0)
    want = np.asarray(jgmm.sample_from_components_shuffled(jm, key, n))
    draw_key, perm_key = jax.random.split(key)
    eps = np.asarray(jax.random.normal(draw_key, (4, n, d)))
    u = np.asarray(jax.random.uniform(perm_key, (4 * n,)))
    got = tgmm.sample_from_components_shuffled(
        tm, n, eps=torch.as_tensor(eps), uniform=torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("diagonal", [False, True])
def test_component_log_density_and_grad_as_jax(diagonal):
    """``tests/test_gmm_model.py``'s check in the port (the log density
    against scipy, the gradient against autograd) and both outputs against
    JAX's on the same inputs, rtol 1e-5."""
    from scipy import stats

    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    rng = np.random.RandomState(11)
    k, d = 3, 4
    w = np.full(k, 1.0 / k, np.float32)
    means = rng.randn(k, d).astype(np.float32)
    if diagonal:
        covs = rng.uniform(0.5, 2.0, (k, d)).astype(np.float32)
        full = np.stack([np.diag(c) for c in covs])
    else:
        a = rng.randn(k, d, d).astype(np.float32)
        covs = full = np.einsum("kij,klj->kil", a, a) + np.eye(
            d, dtype=np.float32)
    jm = jgmm.create_gmm_state(w, means, covs, max_components=k + 1,
                               diagonal=diagonal)
    tm = tgmm.create_gmm_state(w, means, covs, max_components=k + 1,
                               diagonal=diagonal, device="cpu")
    x = rng.randn(6, d).astype(np.float32)
    ld, grads = tgmm.component_log_density_and_grad(tm, 1,
                                                    torch.as_tensor(x))
    np.testing.assert_allclose(
        ld.numpy(), stats.multivariate_normal.logpdf(x, means[1], full[1]),
        rtol=2e-4, atol=2e-4)
    xs = torch.as_tensor(x).requires_grad_(True)
    tgmm.component_log_density_and_grad(tm, 1, xs)[0].sum().backward()
    np.testing.assert_allclose(grads.numpy(), xs.grad.numpy(), rtol=2e-3,
                               atol=2e-3)
    jld, jgrads = jgmm.component_log_density_and_grad(jm, 1, jnp.asarray(x))
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-5,
                               atol=1e-6)
