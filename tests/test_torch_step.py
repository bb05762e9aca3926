"""The PyTorch port against the JAX package over whole training steps.

Both sides start from the same state and consume the same random numbers:
JAX's draws for its next step are recomputed from its key and injected into
the port.  The JAX side runs its fused density and trust-region kernels in
interpret mode, so both take the Stein estimator's moment form and the
batched KL path.
"""
import numpy as np
import pytest
import torch

from torch_parity import (assert_states_match, build_pair, jax_state_leaves,
                          jax_step_draws, mc_elbo)

import gmmvi_tpu_torch

torch.set_num_threads(2)


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("GMMVI_FUSED_DENSITY", "interpret")
    monkeypatch.setenv("GMMVI_FUSED_TR", "interpret")


@pytest.mark.parametrize("start", [0, 4, 8])
def test_one_step_matches_jax_leaf_by_leaf(interpret_kernels, start):
    """One step from a JAX state carried across: integer leaves (ring heads,
    slots, counters, the feval counter) exact, float leaves within rtol
    1e-4 / atol 1e-5.  ``start`` 4 makes the step an add (add_iters 5);
    ``start`` 8 runs the delete check (del_iters 6)."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5, del_iters=6,
                        add_iters=5)
    for _ in range(start):
        jg.train_iter()
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


def test_trajectory_matches_jax(interpret_kernels):
    """80 iterations at the trajectory scale of
    test_full_optimizer_parity.py (dims 6, kmax 12, n_des 48) with JAX's
    draws injected every step: identical feval counts, final ELBO within
    1.0, component counts within 2 (the bars that test holds against the
    reference)."""
    import jax.numpy as jnp
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    jg, tg = build_pair()
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

    def j_model(x):
        return np.asarray(jgmm.log_density(jg.state.model, jnp.asarray(x)))

    def t_model(x):
        return tgmm.log_density(tg.state.model, torch.as_tensor(x)).numpy()

    def j_target(x):
        return np.asarray(jg.target_distribution.log_density(x))

    def t_target(x):
        return tg.target_distribution.log_density(
            torch.as_tensor(x)).numpy()

    elbos = []
    for named, m, tgt in ((j_named, j_model, j_target),
                          (t_named, t_model, t_target)):
        elbos.append(mc_elbo(m, tgt, named["model.means"],
                           named["model.chols"], named["model.log_weights"],
                           int(named["model.num_active"])))
    assert abs(elbos[0] - elbos[1]) < 1.0, elbos
    assert np.isfinite(elbos).all()
