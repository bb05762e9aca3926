"""The wine BNN target of the PyTorch port, against the JAX package: the
wine loader, the MLP, the target call for call across a reshuffle of its
minibatch order, its runner metrics, SAMTRON steps on wine at D = 177 leaf
by leaf through the host-target path, and ZAMTRUX's MORE fit above B8's
envelope (D = 50).

Both packages get the same numpy inputs (drawn from seeded
``np.random.RandomState``s); the steps inject JAX's draws into the port.
The BNN's minibatch order is seeded from ``hash(("bnn", dataset_seed))``,
which changes with ``PYTHONHASHSEED``: both packages are built in this one
process, so they draw the same order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64,
                          port_target_to_float64, xdist_lock)

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg

torch.set_num_threads(2)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _grads_close(got, want, frac=1e-4, err=""):
    """Gradients within ``frac`` of the largest entry of the reference."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=err)


def _wine_pair(dataset_seed=10000):
    from gmmvi_tpu.experiments.targets import bnn as jbnn
    from gmmvi_tpu_torch.experiments.targets import bnn as tbnn

    return (jbnn.make_WINE_target(1.0, dataset_seed, 1.0, 128),
            tbnn.make_WINE_target(1.0, dataset_seed, 1.0, 128, device="cpu"))


def _weights(n, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    return (scale * rng.standard_normal((n, 177))).astype(np.float32)


# ---------------------------------------------------------------------------
# Data and the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset_seed", [10000, 3])
def test_wine_loader_gives_the_jax_arrays(dataset_seed):
    """``load_wine_split`` reads ``wine_seed_{seed % 10}.npz`` in place:
    the same six arrays as the JAX loader, 2,938 / 981 / 979 rows of 11
    features."""
    from gmmvi_tpu.experiments.targets import datasets as jds
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    got, want = tds.load_wine_split(dataset_seed), \
        jds.load_wine_split(dataset_seed)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["features_train"].shape == (2938, 11)
    assert got["features_vali"].shape == (981, 11)
    assert got["features_test"].shape == (979, 11)


def test_missing_wine_split_raises_naming_the_path(monkeypatch, tmp_path):
    """No synthetic stand-in: a missing split raises FileNotFoundError
    naming where it looked."""
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    monkeypatch.setattr(tds, "DATA_DIR", tmp_path)
    monkeypatch.delenv("GMMVI_DATASETS", raising=False)
    with pytest.raises(FileNotFoundError, match="wine_seed_4.npz"):
        tds.load_wine_split(4)


def test_mlp_forward_matches_jax():
    """The batched forward pass (a batch per sample, and one batch for
    all) against JAX's per-sample ``mlp_forward``, within rtol 1e-5 /
    atol 1e-6; D = 177 for the 11-8-8-1 network."""
    from gmmvi_tpu.experiments.targets import bnn as jbnn
    from gmmvi_tpu_torch.experiments.targets import bnn as tbnn

    shapes = tbnn._mlp_shapes(11, [8, 8], 1)
    assert shapes == jbnn._mlp_shapes(11, [8, 8], 1)
    assert sum(int(np.prod(s)) for s in shapes) == 177
    w = _weights(6)
    feats = np.random.RandomState(1).standard_normal((6, 20, 11)).astype(
        np.float32)
    jacts = [jax.nn.sigmoid, jax.nn.sigmoid, lambda x: x]
    tacts = [torch.sigmoid, torch.sigmoid, lambda x: x]
    want = np.stack([jbnn.mlp_forward(jnp.asarray(w[i]),
                                      jnp.asarray(feats[i]), shapes, jacts)
                     for i in range(6)])
    got = tbnn.mlp_forward(_t(w), _t(feats), shapes, tacts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    shared = tbnn.mlp_forward(_t(w), _t(feats[0]), shapes, tacts)
    np.testing.assert_allclose(shared[2].numpy(), np.asarray(
        jbnn.mlp_forward(jnp.asarray(w[2]), jnp.asarray(feats[0]), shapes,
                         jacts)), rtol=1e-5, atol=1e-6)


def test_wine_target_matches_jax_call_for_call():
    """Three calls of 10 samples each (22 batches of 128 fit in the 2,938
    training rows, so the third call crosses a reshuffle): each call's
    posteriors within rtol 1e-5 / atol 1e-3 (values of 1e4-1e5) and
    gradients within 1e-4 of their largest entry, and afterwards the
    same cursor and shuffled order; ``log_density`` takes the next
    batches too."""
    jt, tt = _wine_pair()
    assert tt.get_num_dimensions() == 177 and not tt.safe_for_jit
    np.testing.assert_array_equal(tt._order, jt._order)
    w = _weights(10)
    for call in range(3):
        jld, jg = jt.log_density_and_grad(jnp.asarray(w))
        tld, tg = tt.log_density_and_grad(_t(w))
        np.testing.assert_allclose(tld.numpy(), jld, rtol=1e-5, atol=1e-3,
                                   err_msg=f"call {call}")
        _grads_close(tg.numpy(), jg, err=f"call {call}")
    assert tt._cursor == jt._cursor == 8 * 128
    np.testing.assert_array_equal(tt._order, jt._order)
    np.testing.assert_allclose(tt.log_density(_t(w[:3])).numpy(),
                               jt.log_density(jnp.asarray(w[:3])),
                               rtol=1e-5, atol=1e-3)
    assert tt._cursor == jt._cursor


def test_wine_metrics_match_jax():
    """``expensive_metrics`` on the same 100 samples (the first 64 used):
    the keys ``bi_test_loss``, ``bi_test_accuracy``, ``bi_vali_loss`` and
    ``bi_vali_rmse``, each within rtol 1e-5."""
    jt, tt = _wine_pair()
    w = _weights(100, seed=3, scale=0.3)
    got = tt.expensive_metrics(None, _t(w))
    want = jt.expensive_metrics(None, jnp.asarray(w))
    assert set(got) == set(want) == {"bi_test_loss", "bi_test_accuracy",
                                     "bi_vali_loss", "bi_vali_rmse"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# SAMTRON on wine, through the host-target path
# ---------------------------------------------------------------------------

@pytest.fixture
def _one_test_at_a_time(tmp_path_factory):
    with xdist_lock(tmp_path_factory, "tests"):
        yield


def _small_wine(pkg_cfg):
    """wine's SAMTRON defaults at D = 177 with 8 slots and 16 fresh (32
    reused) samples a component."""
    return pkg_cfg.update_config(
        pkg_cfg.get_default_config("SAMTRON", "wine"),
        {"sample_selector_config": {"desired_samples_per_component": 16},
         "tpu": {"max_components": 8}})


def test_wine_steps_match_jax_leaf_by_leaf(_one_test_at_a_time,
                                           monkeypatch):
    """wine's SAMTRON defaults (4 components, reuse 2.0; 8 slots, 16
    samples a component) built by both packages: two steps from JAX's
    state carried across with JAX's draws injected (JAX's large-D kernels
    in interpret mode with float32 products): each step's target call gets
    the same number of rows (the power-of-two bucket of the valid rows, 64
    at the first step, whose 64 batches already cross a reshuffle), so
    both targets draw the same batches and end with the same cursor and
    order; integer leaves exact, float leaves within rtol 1e-4 /
    atol 1e-5, the stored target gradients (autograd of posteriors of
    1e4-1e5) within 1e-4 of their largest entry, the bar of the
    minibatch logistic regression's step."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.ops import pallas_density
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    monkeypatch.setattr(pallas_density, "MATMUL_MODE", "f32")
    jc = _small_wine(jcfg)
    jt, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = _small_wine(tcfg)
    tt, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    assert tm.num_dimensions == 177 and not tt.safe_for_jit
    np.testing.assert_array_equal(tt._order, jt._order)
    for _ in range(2):
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            jax_state_leaves(jg.state), device="cpu", like=tg.state)
        draws = jax_step_draws(jg)
        jg.train_iter()
        tg.train_iter(draws)
        assert tt._cursor == jt._cursor
        j_named = jax_state_leaves(jg.state)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        _grads_close(t_named.pop("db.target_grads"),
                     j_named.pop("db.target_grads"), err="target grads")
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tt._order, jt._order)


# ---------------------------------------------------------------------------
# MORE above B8's envelope
# ---------------------------------------------------------------------------

def test_zamtrux_step_above_the_more_kernel_envelope_matches_jax(
        _one_test_at_a_time):
    """ZAMTRUX at D = 50, above B8's D <= 45: the port fits MORE through
    its plain version there (one component at a time, as JAX's ``lax.map``
    does) rather than raising.  One step from the same state with JAX's
    draws (2 components in 4 slots, 1,500 fresh samples each, no reuse:
    more than the 1,326 quadratic features, so the ridge-1e-12 fit is
    determined), both in float64 (in float32 that fit is ill-conditioned
    still); integer leaves exact, float leaves within rtol 1e-4 /
    atol 1e-5."""
    jg, tg = build_pair(dims=50, codename="ZAMTRUX", ratio=0.0, n_des=1500,
                        kmax=4, k0=2)
    assert tg.estimator_type == "MORE"
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(
            jg.target_distribution)
        named = as_float64(jax_state_leaves(jg.state))
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
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def test_wine_runner_steps_on_the_cpu():
    """``GmmviRunner.build_from_config(get_default_config("SAMTRON",
    "wine"))`` at its full widths on the CPU (D = 177, 4 components in 24
    slots, 100 fresh samples each): an evaluation at iteration 0 with a
    finite ELBO and the target's four ``bi_*`` floats, fevals the valid
    rows (400 at the first step), the target's cursor moved by the
    power-of-two bucket (512 batches) plus the evaluation's 2,000."""
    import math

    tr = gmmvi_tpu_torch.GmmviRunner.build_from_config(
        tcfg.get_default_config("SAMTRON", "wine"), device="cpu")
    target = tr.target_distribution
    assert tr.gmmvi.model.max_components == 24
    out = tr.iterate_and_log(0)
    assert out["num_samples"] == 400 and math.isfinite(out["-elbo"])
    assert {"bi_test_loss", "bi_test_accuracy", "bi_vali_loss",
            "bi_vali_rmse"} <= set(out)
    assert all(isinstance(out[k], float) and math.isfinite(out[k])
               for k in out if k.startswith("bi_"))
    assert target._cursor == (512 + 2000) % 22 * 128
