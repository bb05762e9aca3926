"""The trust-region searches of ``tpu.trust_region_search`` other than the
bracket (``newton``, ``grid``, ``bracket-eigen``) in the PyTorch port,
against the JAX package's ``trust_region_update(search=...)``.

Both packages get the same numpy inputs (random well-posed components,
rewards and bounds drawn from seeded ``np.random.RandomState``s) at D = 6
and at D = 70 (above the fused kernel's D = 64), for full covariances and,
for the grid, diagonal ones; the updated means, factors, inverse factors,
accepted etas and regularizers are compared.  A SAMTRON step with each
search is compared leaf by leaf from JAX's state with JAX's draws injected.
Where float32 rounding decides a trip of the search (it visits other etas
than the bracket, so no bar on its etas holds in float32) or a grid point
on the bound, both sides run in float64 (JAX under ``jax.enable_x64``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (assert_states_match, build_pair, jax_state_leaves,
                          jax_step_draws)

import gmmvi_tpu_torch

torch.set_num_threads(2)

SEARCHES = ("newton", "grid", "bracket-eigen")


def _inputs(d, k=5, kmax=6, seed=0, diagonal=False, stepsize=0.05):
    """(weights, means, covs, hessians_neg, grads_neg, stepsizes) as numpy:
    ``k`` active components in ``kmax`` slots, positive-definite rewards
    scaled with D, and per-slot bounds around ``stepsize``."""
    rng = np.random.RandomState(seed)
    w = np.full(k, 1.0 / k)
    mu = rng.randn(k, d)
    if diagonal:
        covs = rng.uniform(0.5, 2.0, (k, d))
        hneg = rng.uniform(0.0, 0.5, (kmax, d))
    else:
        a = rng.randn(k, d, d) / np.sqrt(d)
        covs = np.einsum("kij,klj->kil", a, a) + np.eye(d)
        b = rng.randn(kmax, d, d) / np.sqrt(d)
        hneg = 0.3 * np.einsum("kij,klj->kil", b, b) + 0.05 * np.eye(d)
    gneg = 0.5 * rng.randn(kmax, d)
    eps = stepsize * rng.uniform(0.5, 2.0, kmax)
    return w, mu, covs, hneg, gneg, eps


def _update_both(d, search, diagonal=False, dtype=np.float32, seed=0,
                 grid_size=32, warm=False):
    """Both packages' ``trust_region_update`` on the same inputs (with
    ``warm``, a second update from the first's etas); returns the two
    (model, meta) results as numpy dicts."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.models import meta as jmeta
    from gmmvi_tpu.optimization import component_updaters as jcu
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.models import meta as tmeta
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    w, mu, covs, hneg, gneg, eps = [np.asarray(x, dtype) for x in _inputs(
        d, seed=seed, diagonal=diagonal)]
    kmax = hneg.shape[0]
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jm = jgmm.create_gmm_state(w, mu, covs, max_components=kmax,
                               diagonal=diagonal, dtype=jdt)
    tm = tgmm.create_gmm_state(w, mu, covs, max_components=kmax,
                               diagonal=diagonal, device="cpu", dtype=tdt)
    jmt = jmeta.create_meta_state(jm, 0.05, 1e-12, 4)
    tmt = tmeta.create_meta_state(tm, 0.05, 1e-12, 4)
    if dtype == np.float64:
        jmt = jmt.replace(**{f: jnp.asarray(np.asarray(getattr(jmt, f)),
                                            jnp.float64)
                             for f in ("stepsizes", "last_etas",
                                       "l2_regularizers")})
        tmt = tmt.replace(**{f: getattr(tmt, f).double()
                             for f in ("stepsizes", "last_etas",
                                       "l2_regularizers")})
    out = []
    jax_update = jax.jit(lambda *a: jcu.trust_region_update(
        *a, search=search, grid_size=grid_size))
    for run, m, mt, h, g, e in (
            (jax_update, jm, jmt,
             jnp.asarray(hneg), jnp.asarray(gneg), jnp.asarray(eps)),
            (lambda *a: tcu.trust_region_update(
                *a, search=search, grid_size=grid_size), tm, tmt,
             torch.as_tensor(hneg), torch.as_tensor(gneg),
             torch.as_tensor(eps))):
        res = run(m, mt, h, g, e)
        if warm:
            res = run(res.model, res.meta, h, g, e)
        out.append({name: np.asarray(getattr(part, name))
                    for part, names in ((res.model, ("means", "chols",
                                                     "inv_chols")),
                                        (res.meta, ("last_etas",
                                                    "l2_regularizers")))
                    for name in names})
    return out


def _assert_updates_match(got, want, rtol, atol):
    np.testing.assert_array_equal(got["last_etas"] > 0,
                                  want["last_etas"] > 0)
    assert (want["last_etas"][:5] > 0).any()
    for name in ("means", "chols", "inv_chols", "last_etas",
                 "l2_regularizers"):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("d", [6, 70])
def test_full_covariance_update_matches_jax(search, d):
    """Full covariances, cold start: float64 on both sides, means, factors
    and etas within rtol 1e-9 / atol 1e-9 (the searches visit the same
    points, then the rebuild rounds in each package's own order)."""
    with jax.enable_x64(True):
        got, want = _update_both(d, search, dtype=np.float64)
    _assert_updates_match(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("search", SEARCHES)
def test_warm_started_update_matches_jax(search):
    """A second update from the first's accepted etas (the warm bracket;
    newton starts at log |last eta|), D = 6, float64, the same bars."""
    with jax.enable_x64(True):
        got, want = _update_both(6, search, dtype=np.float64, seed=3,
                                 warm=True)
    _assert_updates_match(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("search", SEARCHES)
def test_float32_update_matches_jax(search):
    """In float32 at D = 6 (the state's type on the main path) the updates
    agree within rtol 1e-4 / atol 1e-5 where the searches accept the same
    etas on these inputs."""
    got, want = _update_both(6, search, seed=1)
    _assert_updates_match(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [6, 70])
@pytest.mark.parametrize("grid_size", [32, 8])
def test_diagonal_grid_update_matches_jax(d, grid_size):
    """Diagonal covariances with the grid search (``grid_size`` points per
    pass), float64, rtol 1e-9 / atol 1e-9."""
    with jax.enable_x64(True):
        got, want = _update_both(d, "grid", diagonal=True,
                                 dtype=np.float64, grid_size=grid_size)
    _assert_updates_match(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("search", ["newton", "bracket-eigen"])
def test_diagonal_models_take_the_bracket(search):
    """A diagonal model's newton and bracket-eigen are the bracket, in the
    port as in the JAX package: equal bits to the port's bracket and JAX's
    same update within float32's bars."""
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.models import meta as tmeta
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    w, mu, covs, hneg, gneg, eps = [np.asarray(x, np.float32) for x in
                                    _inputs(6, diagonal=True)]
    tm = tgmm.create_gmm_state(w, mu, covs, max_components=6, diagonal=True,
                               device="cpu")
    tmt = tmeta.create_meta_state(tm, 0.05, 1e-12, 4)
    args = (tm, tmt, torch.as_tensor(hneg), torch.as_tensor(gneg),
            torch.as_tensor(eps))
    a = tcu.trust_region_update(*args, search=search)
    b = tcu.trust_region_update(*args, search="bracket")
    for x, y in ((a.model.means, b.model.means), (a.model.chols,
                                                  b.model.chols),
                 (a.meta.last_etas, b.meta.last_etas)):
        assert torch.equal(x, y)
    got, want = _update_both(6, search, diagonal=True)
    _assert_updates_match(got, want, rtol=1e-4, atol=1e-5)


def _kl64(m0, c0, m1, c1):
    """KL(N(m0, c0) || N(m1, c1)) in float64."""
    c1inv = np.linalg.inv(c1)
    diff = m1 - m0
    return 0.5 * (np.trace(c1inv @ c0) + diff @ c1inv @ diff - len(m0)
                  + np.linalg.slogdet(c1)[1] - np.linalg.slogdet(c0)[1])


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("d", [3, 80])
def test_accepted_updates_respect_the_bound(search, d):
    """The port's accepted components (eta > 0) keep KL(new || old) within
    the trust region: at most 1.1 eps (|KL - eps| < 0.1 eps, or a feasible
    fallback), the grid at most eps, up to 1e-3 eps of float32 rounding;
    and at least one moves."""
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.models import meta as tmeta
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    w, mu, covs, hneg, gneg, eps = [np.asarray(x, np.float32) for x in
                                    _inputs(d, seed=6)]
    tm = tgmm.create_gmm_state(w, mu, covs, max_components=6, device="cpu")
    tmt = tmeta.create_meta_state(tm, 0.05, 1e-12, 4)
    res = tcu.trust_region_update(tm, tmt, torch.as_tensor(hneg),
                                  torch.as_tensor(gneg),
                                  torch.as_tensor(eps), search=search)
    bar = (1.0 if search == "grid" else 1.1) + 1e-3
    moved = False
    for i in range(5):
        if float(res.meta.last_etas[i]) < 0:
            continue
        kl = _kl64(res.model.means[i].double().numpy(),
                   res.model.covs[i].double().numpy(),
                   tm.means[i].double().numpy(), tm.covs[i].double().numpy())
        assert kl <= bar * eps[i], (i, kl, eps[i])
        moved = moved or kl > 1e-6
    assert moved


@pytest.mark.parametrize("search", SEARCHES)
def test_one_samtron_step_matches_jax_leaf_by_leaf(search):
    """One SAMTRON step with ``tpu.trust_region_search`` from JAX's state
    after 4 steps carried across, JAX's draws injected (the step adds a
    component, add_iters 5): integers exact, floats within rtol 1e-4 /
    atol 1e-5."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5,
                        extra={"tpu": {"trust_region_search": search}})
    assert tg.trust_region_search == jg.trust_region_search == search
    jg.train_iters(4)
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        jax_state_leaves(jg.state), device="cpu", like=tg.state)
    draws = jax_step_draws(jg)
    jg.train_iter()
    tg.train_iter(draws)
    assert_states_match(gmmvi_tpu_torch.state_to_numpy(tg.state),
                        jax_state_leaves(jg.state), rtol=1e-4, atol=1e-5)


def test_grid_size_is_read_from_the_config():
    """``tpu.trust_region_grid_size`` reaches the update, as in the JAX
    package: a step with 8 grid points equals JAX's leaf by leaf."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, extra={"tpu": {
        "trust_region_search": "grid", "trust_region_grid_size": 8}})
    assert tg.trust_region_grid_size == jg.trust_region_grid_size == 8
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        jax_state_leaves(jg.state), device="cpu", like=tg.state)
    draws = jax_step_draws(jg)
    jg.train_iter()
    tg.train_iter(draws)
    assert_states_match(gmmvi_tpu_torch.state_to_numpy(tg.state),
                        jax_state_leaves(jg.state), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("search", SEARCHES)
def test_samtron_with_each_search_converges(search):
    """SAMTRON with each search, 40 iterations on the simple GMM target
    (the JAX package's end-to-end newton test): the ELBO rises by more
    than 1 and ends above -0.2, as the JAX test holds its newton run."""
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.gmm import make_simple_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI
    from gmmvi_tpu_torch.runner import sample_elbo

    target = make_simple_target(device="cpu")
    # tests/test_end_to_end.py's _base_config("SAMTRON", target)
    cfg = update_config(get_default_algorithm_config("SAMTRON"), {
        "start_seed": 0, "seed": 0, "environment_name": "test",
        "model_initialization": {"use_diagonal_covs": False,
                                 "num_initial_components": 3,
                                 "prior_mean": 0.0, "prior_scale": 3.0,
                                 "initial_cov": 4.0},
        "use_sample_database": True, "max_database_size": 100000,
        "temperature": 1.0,
        "sample_selector_config": {"desired_samples_per_component": 24,
                                   "ratio_reused_samples_to_desired": 1.0},
        "num_component_adapter_config": {
            "del_iters": 8, "add_iters": 5, "max_components": 8,
            "thresholds_for_add_heuristic": [500.0, 100.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 256, "num_prior_samples": 0},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": 8, "trust_region_search": search},
    })
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")

    def elbo():
        gen = torch.Generator().manual_seed(0)
        return -sample_elbo(g.model, target, 1.0, generator=gen)[0]["-elbo"]

    start = elbo()
    g.train_iters(40)
    end = elbo()
    assert end > start + 1.0 and end > -0.2, (start, end)
