"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: small flagship-shaped configs, JAX's random draws for one training
step, and leaf-by-leaf state comparison.  Not a test module itself."""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

# the trajectory scale of tests/test_full_optimizer_parity.py
DIMS, KMAX, N_DES, K0 = 6, 12, 48, 8


def samtron_overrides(n_des=N_DES, kmax=KMAX, k0=K0, del_iters=100,
                      add_iters=30, seed=0):
    """SAMTRON with the small-run overrides of scripts/compare_reference.py
    (no sample reuse, 100*I initial covariances)."""
    return {
        "seed": seed, "start_seed": seed, "temperature": 1.0,
        "environment_name": "stm",
        "sample_selector_config": {
            "desired_samples_per_component": n_des,
            "ratio_reused_samples_to_desired": 0.0},
        "use_sample_database": True, "max_database_size": 10_000_000,
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": k0,
            "prior_mean": 0.0, "prior_scale": 20.0, "initial_cov": 100.0},
        "component_stepsize_adapter_config": {"initial_stepsize": 0.1},
        "num_component_adapter_config": {
            "del_iters": del_iters, "add_iters": add_iters,
            "max_components": kmax,
            "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0, 200.0,
                                             100.0, 50.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 1024, "num_prior_samples": 0},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": kmax},
    }


def zamtrux_overrides(ratio=2.0, **kw):
    """ZAMTRUX (VIPS: MORE, direct weight update, fixed weight stepsize)
    with the small-run overrides of :func:`samtron_overrides`, but with the
    M letter's sample reuse (``ratio_reused_samples_to_desired`` 2.0)."""
    over = samtron_overrides(**kw)
    over["sample_selector_config"]["ratio_reused_samples_to_desired"] = ratio
    return over


def build_pair(dims=DIMS, codename="SAMTRON", ratio=None, **kw):
    """(jax_gmmvi, torch_gmmvi) on the same Student-T target and the same
    initial mixture, both on the CPU; ``codename`` SAMTRON or ZAMTRUX with
    its overrides above, ``ratio`` (when given) the sample reuse."""
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

    over = (zamtrux_overrides if codename == "ZAMTRUX"
            else samtron_overrides)(**kw)
    if ratio is not None:
        over["sample_selector_config"]["ratio_reused_samples_to_desired"] = \
            ratio
    jt = j_target(dims, False, seed=0)
    jc = jcfg.update_config(jcfg.get_default_algorithm_config(codename),
                            over)
    jc["target_fn"] = jt
    _, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)

    tt = t_target(dims, False, seed=0, device="cpu")
    tc = tcfg.update_config(tcfg.get_default_algorithm_config(codename),
                            over)
    tc["target_fn"] = tt
    _, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    return jg, tg


def jax_step_draws(jax_gmmvi):
    """The random numbers JAX's next ``_full_step`` consumes, recomputed
    from its key with the same splits (gmmvi.py ``_propose_phase`` and
    ``_update_phase``, sample_db.add_samples, add_new_component), as a
    StepDraws for the port."""
    from gmmvi_tpu_torch import StepDraws

    st = jax_gmmvi.state
    kmax, d = st.model.max_components, st.model.num_dimensions
    n_des = jax_gmmvi.selector_cfg.desired_samples_per_component
    b, c = kmax * n_des, st.db.reservoir_capacity
    n_db = jax_gmmvi.vips_cfg.num_database_samples
    key1, k_sel = jax.random.split(st.key)
    eps = jax.random.normal(k_sel, (kmax, n_des, d), jnp.float32)
    _, k_db, k_adapt = jax.random.split(key1, 3)
    slot_key, acc_key = jax.random.split(k_db)
    rand_slots = jax.random.randint(slot_key, (b,), 0, c)
    accept_u = jax.random.uniform(acc_key, (b,))
    db_key, a_key = jax.random.split(k_adapt)
    perm = jax.random.permutation(db_key, c)[:n_db]
    a = jax.random.uniform(a_key, ())

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype)

    return StepDraws(eps=t(eps), rand_slots=t(rand_slots, torch.int32),
                     accept_u=t(accept_u), db_perm=t(perm, torch.int64),
                     add_a=t(a))


def jax_state_leaves(state) -> dict:
    """The JAX TrainState's leaves as numpy arrays keyed by pytree path."""
    from gmmvi_tpu.utils.checkpoint import _named_leaves

    return {k: np.asarray(v) for k, v in _named_leaves(state).items()}


def assert_states_match(t_named: dict, j_named: dict, rtol=1e-4,
                        atol=1e-5):
    """Integer leaves exactly, float leaves within rtol/atol (nan and inf
    in the same places), every port leaf against its JAX leaf."""
    for name, got in t_named.items():
        want = j_named[name]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=name)


def mc_elbo(model_logpdf, target_logpdf, means, chols, log_weights,
            num_active, rng_state=99, n=2000, with_se=False):
    """ELBO estimate from n mixture draws made with numpy (component by
    inverse CDF of shared uniforms, then mu + L eps); with ``with_se``,
    (estimate, its Monte Carlo standard error)."""
    rng = np.random.RandomState(rng_state)
    k = num_active
    w = np.exp(log_weights[:k].astype(np.float64))
    comp = np.minimum(np.searchsorted(np.cumsum(w / w.sum()),
                                      rng.uniform(size=n)), k - 1)
    eps = rng.standard_normal((n, means.shape[1])).astype(np.float32)
    x = means[comp] + np.einsum("nij,nj->ni", chols[comp], eps)
    ratios = target_logpdf(x) - model_logpdf(x)
    if with_se:
        return float(np.mean(ratios)), float(np.std(ratios) / np.sqrt(n))
    return float(np.mean(ratios))
