"""The MNIST BNN target of the PyTorch port, against the JAX package: the
loaders' synthetic stand-ins (``GMMVI_ALLOW_SYNTHETIC=1``) and their
absence, both schemas of ``mnist.npz``, the 784-128-10 cross-entropy
target at its full width (D = 101,770) call for call, its metrics, the
diagonal model's slabs in blocks of rows, and one diagonal SEMTRON step of
the JAX package's own MNIST test leaf by leaf.

MNIST's images are not in the repository: the target runs on the JAX
package's deterministic stand-in (6,000 training and 1,000 test images of
uniform pixels, ``np.random.RandomState(42)``).  Every test here hides
keras (the JAX loader would otherwise try a download) and points ``HOME``
and the data directories at empty temporary ones.  The BNN's minibatch
order is seeded from ``hash(("bnn", -1))``; both packages are built in this
one process, so they draw the same order.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64, xdist_lock)

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg

torch.set_num_threads(2)

D_MNIST = 784 * 128 + 128 + 128 * 10 + 10


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    """No keras, no scikit-learn, an empty ``HOME`` and no
    ``GMMVI_DATASETS``: nothing is downloaded and no user file is read."""
    for name in ("keras", "keras.datasets", "sklearn", "sklearn.datasets"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("GMMVI_DATASETS", raising=False)
    monkeypatch.delenv("GMMVI_ALLOW_SYNTHETIC", raising=False)


@pytest.fixture
def empty_data(monkeypatch, tmp_path):
    """Both packages' data directories pointed at an empty one."""
    from gmmvi_tpu.experiments.targets import datasets as jds
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    empty = tmp_path / "data"
    empty.mkdir()
    monkeypatch.setattr(jds, "_PKG_DATA", empty)
    monkeypatch.setattr(tds, "DATA_DIR", empty)
    return empty


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setenv("GMMVI_ALLOW_SYNTHETIC", "1")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _grads_close(got, want, frac=1e-4, err=""):
    """Gradients within ``frac`` of the largest entry of the reference."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=err)


def _loader(name):
    """(port loader, JAX loader, the file it looks for) of ``name``."""
    from gmmvi_tpu.experiments.targets import datasets as jds
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    return {
        "breast_cancer": (tds.load_breast_cancer, jds.load_breast_cancer,
                          "breast_cancer.data"),
        "german_credit": (tds.load_german_credit, jds.load_german_credit,
                          "german.data-numeric"),
        "wine": (lambda: tds.load_wine_split(13),
                 lambda: jds.load_wine_split(13), "wine_seed_3.npz"),
        "mnist": (tds.load_mnist, jds.load_mnist, "mnist.npz"),
    }[name]


LOADERS = ("breast_cancer", "german_credit", "wine", "mnist")


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LOADERS)
def test_stand_ins_equal_the_jax_arrays(name, empty_data, synthetic):
    """With ``GMMVI_ALLOW_SYNTHETIC=1`` and no file each loader warns and
    returns the JAX package's stand-in: the same arrays, dtypes and shapes
    (breast cancer 569 x 30, german credit 1,000 x 24, wine 2,938 / 979 /
    981 rows of 11, MNIST 6,000 + 1,000 images of 784 pixels)."""
    port, jax_loader, _ = _loader(name)
    with pytest.warns(UserWarning, match="synthetic stand-in"):
        got = port()
    want = jax_loader()
    if isinstance(want, dict):
        assert set(got) == set(want)
        got, want = [got[k] for k in sorted(want)], \
            [want[k] for k in sorted(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if name == "mnist":
        assert [a.shape for a in got] == [(6000, 784), (6000,), (1000, 784),
                                          (1000,)]


@pytest.mark.parametrize("name", LOADERS)
def test_a_missing_file_raises_naming_the_paths(name, empty_data, tmp_path,
                                                monkeypatch):
    """Without the variable a missing file raises FileNotFoundError naming
    every path searched: ``GMMVI_DATASETS``, the data directory, and for
    MNIST the keras download cache."""
    port, _, filename = _loader(name)
    monkeypatch.setenv("GMMVI_DATASETS", str(tmp_path / "elsewhere"))
    with pytest.raises(FileNotFoundError) as err:
        port()
    msg = str(err.value)
    assert str(tmp_path / "elsewhere") in msg and str(empty_data) in msg
    assert filename in msg and "GMMVI_ALLOW_SYNTHETIC" in msg
    if name == "mnist":
        assert str(tmp_path / "home" / ".keras" / "datasets" / "mnist.npz") \
            in msg


@pytest.mark.parametrize("schema", ["flat", "keras"])
def test_mnist_npz_schemas_load_as_jax(schema, tmp_path, monkeypatch):
    """Both schemas of ``mnist.npz`` under ``GMMVI_DATASETS``: the flat
    ``train_x [N, 784]`` as stored, and the keras archive's ``x_train [N,
    28, 28]`` uint8 scaled by 1/255 and flattened; equal to the JAX
    loader's arrays.  The keras cache file is read where nothing else
    holds one."""
    from gmmvi_tpu.experiments.targets import datasets as jds
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    rng = np.random.RandomState(5)
    if schema == "flat":
        arrays = {"train_x": rng.rand(12, 784).astype(np.float32),
                  "train_y": rng.randint(0, 10, 12),
                  "test_x": rng.rand(6, 784).astype(np.float32),
                  "test_y": rng.randint(0, 10, 6)}
    else:
        arrays = {"x_train": rng.randint(0, 256, (12, 28, 28), np.uint8),
                  "y_train": rng.randint(0, 10, 12).astype(np.uint8),
                  "x_test": rng.randint(0, 256, (6, 28, 28), np.uint8),
                  "y_test": rng.randint(0, 10, 6).astype(np.uint8)}
    folder = tmp_path / "mnist"
    folder.mkdir()
    np.savez(folder / "mnist.npz", **arrays)
    monkeypatch.setenv("GMMVI_DATASETS", str(folder))
    got, want = tds.load_mnist(), jds.load_mnist()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (12, 784) and got[0].max() <= 1.0
    if schema == "keras":
        np.testing.assert_array_equal(
            got[2], arrays["x_test"].reshape(6, -1).astype(np.float32)
            / np.float32(255.0))
        cache = tmp_path / "home" / ".keras" / "datasets"
        cache.mkdir(parents=True)
        (folder / "mnist.npz").rename(cache / "mnist.npz")
        np.testing.assert_array_equal(tds.load_mnist()[0], got[0])


# ---------------------------------------------------------------------------
# The target at D = 101,770
# ---------------------------------------------------------------------------

def _mnist_pair(batch_size=32):
    from gmmvi_tpu.experiments.targets import bnn as jbnn
    from gmmvi_tpu_torch.experiments.targets import bnn as tbnn

    return (jbnn.make_MNIST_target(1.0, 1.0, batch_size),
            tbnn.make_MNIST_target(1.0, 1.0, batch_size, device="cpu"))


def _weights(n, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    return (scale * rng.standard_normal((n, D_MNIST))).astype(np.float32)


def test_registry_builds_mnist_on_the_stand_in(synthetic, empty_data,
                                               monkeypatch):
    """``get_target_lnpdf("MNIST", ...)`` builds the 784-128-10 classifier,
    D = 101,770, on the JAX package's stand-in: 6,000 training rows, the
    1,000 test images split 500 / 500 into test and validation, integer
    labels on the target's device, the same shuffled order as JAX's;
    without ``GMMVI_ALLOW_SYNTHETIC`` and a file it raises naming the
    paths searched."""
    from gmmvi_tpu.experiments.setup import get_target_lnpdf as j_get
    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    env = {"likelihood_scaling": 1.0, "prior_std": 1.0, "batch_size": 32}
    t = get_target_lnpdf("MNIST", env, 0, device="cpu")
    j = j_get("MNIST", env, 0)
    assert t.get_num_dimensions() == j.get_num_dimensions() == D_MNIST
    assert not t.safe_for_jit and t.loss_kind == "ce"
    for name in ("_x_tr", "_y_tr", "_x_te", "_y_te", "_x_va", "_y_va"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert t._y_tr.dtype == torch.int64
    assert (t._x_tr.shape, t._x_te.shape, t._x_va.shape) == (
        (6000, 784), (500, 784), (500, 784))
    np.testing.assert_array_equal(t._order, j._order)
    monkeypatch.delenv("GMMVI_ALLOW_SYNTHETIC")
    with pytest.raises(FileNotFoundError, match="mnist.npz") as err:
        get_target_lnpdf("MNIST", env, 0, device="cpu")
    assert str(empty_data / "mnist.npz") in str(err.value)


def test_mnist_target_matches_jax_call_for_call(synthetic, empty_data):
    """Two calls of 4 samples with batches of 32 (so the cursor moves
    between them), then ``log_density`` on the next 3: posteriors of
    1e4-1e5 within rtol 1e-5 / atol 1e-2 and gradients within 1e-4 of
    their largest entry, the same cursor and order afterwards."""
    jt, tt = _mnist_pair()
    w = _weights(4)
    for call in range(2):
        jld, jg = jt.log_density_and_grad(jnp.asarray(w))
        tld, tg = tt.log_density_and_grad(_t(w))
        np.testing.assert_allclose(tld.numpy(), jld, rtol=1e-5, atol=1e-2,
                                   err_msg=f"call {call}")
        _grads_close(tg.numpy(), jg, err=f"call {call}")
        assert tt._cursor == jt._cursor == (call + 1) * 4 * 32
    np.testing.assert_allclose(tt.log_density(_t(w[:3])).numpy(),
                               jt.log_density(jnp.asarray(w[:3])),
                               rtol=1e-5, atol=1e-2)
    assert tt._cursor == jt._cursor
    np.testing.assert_array_equal(tt._order, jt._order)


def test_mnist_metrics_match_jax(synthetic, empty_data):
    """``expensive_metrics`` on 80 samples (the first 64 used): the ensemble's
    cross-entropy and accuracy on the test and the validation half, each
    within rtol 1e-5."""
    jt, tt = _mnist_pair()
    w = _weights(80, seed=3, scale=0.1)
    got = tt.expensive_metrics(None, _t(w))
    want = jt.expensive_metrics(None, jnp.asarray(w))
    assert set(got) == set(want) == {"bi_test_loss", "bi_test_accuracy",
                                     "bi_vali_loss", "bi_vali_accuracy"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_target_float32_within_its_first_order_bound(synthetic, empty_data):
    """The bar ``chip_smoke.py`` holds the card's MNIST target rows to: the
    float32 log densities and gradients of 3 samples (weights from the
    N(0, 1) prior, batches of 32) within their first-order float32 bound
    of the float64 evaluation of the same rows; an entry moved by twice
    its bound is refused.  The bound is a worst case (~1% of a log density,
    and of the largest gradient entry for the median entry), so the card's
    rows are also held to the CPU's float32 evaluation of the same rows at
    the bars of the call-for-call test above."""
    cs = _chip_smoke()
    _, tt = _mnist_pair()
    x = _t(_weights(3, seed=4, scale=1.0))
    rows = tt._next_rows(3)
    with torch.enable_grad():
        xg = x.clone().requires_grad_(True)
        ld = tt._posterior(xg, rows)
        (grads,) = torch.autograd.grad(ld.sum(), xg)
    ld64, g64, ld_b, g_b = cs.bnn_ce_float64(tt, x, rows)
    assert cs.bound_ratio(ld, ld64, ld_b) <= 1.0
    assert cs.bound_ratio(grads, g64, g_b) <= 1.0
    assert cs.bound_ratio(ld64 + 2 * ld_b, ld64, ld_b) > 1.0
    moved = g64.clone()
    moved[1, 500] += 2 * g_b[1, 500]
    assert cs.bound_ratio(moved, g64, g_b) > 1.0
    # the worst case of 785-term sums is loose: ~1% of a log density and
    # of the largest gradient entry, where float32's error is ~1e-7
    assert float((ld_b / ld64.abs()).max()) < 0.05
    assert float(torch.quantile(g_b[0] / g64.abs().max(), 0.5)) < 0.02


def test_row_blocks_equal_one_pass():
    """The diagonal model's ``[k, N, D]`` intermediates in blocks of rows
    (``_DIAG_CHUNK`` forced below one component's ``[N, D]``, as at D =
    101,770 with more than 329 rows): component log densities, the pack's
    gradient, the background and the Stein estimate equal the one-pass
    values within 1e-6 of their scale."""
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.optimization import ng_estimators, sample_window

    rng = np.random.RandomState(2)
    k, n, d = 5, 37, 6
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    state = tgmm.create_gmm_state(
        w, (rng.randn(k, d) * 2).astype(np.float32),
        (0.3 + rng.rand(k, d)).astype(np.float32), max_components=7,
        diagonal=True, device="cpu")
    x = _t((rng.randn(n, d) * 2).astype(np.float32))
    g = _t(rng.randn(n, d).astype(np.float32))
    bg = _t(rng.randn(n).astype(np.float32))

    def run():
        pack = tgmm.density_pack(state, x)
        back = sample_window.background(
            True, state.means, state.inv_chols, state.log_weights,
            tgmm.chol_log_det(state.chols, True), x)
        est = ng_estimators.stein_estimate(
            state, x, torch.ones(n, dtype=torch.bool),
            torch.arange(n) % k, bg, bg, g, pack=pack)
        return (pack.component_log_densities[:k], pack.model_grads, back,
                est.expected_hessians_neg[:k], est.expected_gradients_neg[:k])

    whole = run()
    old = tgmm._DIAG_CHUNK
    tgmm._DIAG_CHUNK = 5 * d          # 5 rows, one component, a block
    try:
        assert len({rows for rows, _ in tgmm.diag_blocks(7, n, d)}) == 8
        blocked = run()
    finally:
        tgmm._DIAG_CHUNK = old
    for a, b in zip(blocked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# One diagonal SEMTRON step at D = 101,770
# ---------------------------------------------------------------------------

@pytest.fixture
def _one_test_at_a_time(tmp_path_factory):
    with xdist_lock(tmp_path_factory, "tests"):
        yield


def _jax_test_config(pkg_cfg, target):
    """The configuration of the JAX package's own MNIST test
    (tests/test_bnn_e2e.py): SEMTRON, one diagonal component, 4 samples a
    step, no reuse, database 1,000, stepsize 0.01 in [0.001, 0.1]."""
    return pkg_cfg.update_config(pkg_cfg.get_default_algorithm_config(
        "SEMTRON"), {
        "start_seed": 0, "target_fn": target, "environment_name": "mnist",
        "model_initialization": {
            "use_diagonal_covs": True, "num_initial_components": 1,
            "prior_mean": 0.0, "prior_scale": 1.0, "initial_cov": 1.0},
        "use_sample_database": True, "max_database_size": 1000,
        "temperature": 1.0,
        "sample_selector_config": {"desired_samples_per_component": 4,
                                   "ratio_reused_samples_to_desired": 0.0},
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.01, "min_stepsize": 0.001,
            "max_stepsize": 0.1},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": 1}})


def test_semtron_step_matches_jax_leaf_by_leaf(_one_test_at_a_time,
                                               synthetic, empty_data):
    """The JAX package's MNIST configuration built by both packages at D =
    101,770: after one step of JAX's, the second step from JAX's state
    with JAX's draws injected, both in float64 (the targets evaluate in
    the samples' type, the labels stay integers): the target sees the
    same 4 batches and both end with the same cursor; integer leaves
    exact, float leaves within rtol 1e-4 / atol 1e-5, the stored target
    gradients within 1e-4 of their largest entry.  In float32 the reward
    history parts by ~2e-4 of its 1e6: the self-normalized weights of 4
    samples whose log densities are ~1.4e5 turn float32's rounding of
    those densities into that much."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    jt, tt = _mnist_pair()
    jc = _jax_test_config(jcfg, jt)
    _, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = _jax_test_config(tcfg, tt)
    _, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    assert tm.num_dimensions == D_MNIST and tm.diagonal
    assert tuple(tm.chols.shape) == (1, D_MNIST)
    jg.train_iter()
    tt._order, tt._cursor = jt._order.copy(), jt._cursor
    tt._rng.set_state(jt._rng.get_state())
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(jt)
        named = as_float64(jax_state_leaves(jg.state))
        jg.state = jax_state_from_leaves(jg.state, named)
        draws = jax_step_draws(jg, dtype=jnp.float64)
        jg.train_iter()
        j_named = jax_state_leaves(jg.state)
    tg.state = gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                                like=tg.state)
    tg.train_iter(draws)
    assert tt._cursor == jg.target_distribution._cursor == 2 * 4 * 32
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert t_named["model.means"].dtype == np.float64
    _grads_close(t_named.pop("db.target_grads"),
                 j_named.pop("db.target_grads"), err="target grads")
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)
    assert np.linalg.norm(t_named["model.means"]) > 0
