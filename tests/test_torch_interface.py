"""The target interface of the port against the JAX package's, and the
public helpers that came with it, on the CPU at small sizes.

(a) every registry target's flags (``use_log_density_and_grad``,
``safe_for_jit``, ``safe_for_tf_graph``, ``can_sample``) equal its JAX
twin's; (b) a target whose ``log_density_and_grad`` is twice the gradient
of its ``log_density`` steps as JAX's does with each flag value, so both
packages take the same branch; (c) a target with only ``log_density``
steps as JAX's ``vmap(value_and_grad)`` does, in float64; (d) example 4's
``Rosenbrock(LNPDF)`` runs through ``GmmviRunner``; (e) ``load_yaml``,
``component_log_densities_from_whitened``, the two-pass ``finalize``, the
databases' shape properties and ``masked_logsumexp``'s sign against JAX.
"""
import copy
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64,
                          port_target_to_float64)

import gmmvi_tpu_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MB = {"batch_size": 64, "size_test_set": 0, "use_own_batch_per_sample": True}
REGISTRY = {
    "STM": {"num_dimensions": 5, "harder_setting": False},
    "GMM": {"num_dimensions": 5},
    "DIAGGMM": {"num_dimensions": 5},
    "breastCancer": {},
    "GermanCredit": {},
    "breastCancer_mb": _MB,
    "GermanCredit_mb": _MB,
    "PlanarRobot1": {},
    "PlanarRobot4": {},
    "MNIST": {"likelihood_scaling": 1.0, "prior_std": 1.0, "batch_size": 32},
    "WINE": {"likelihood_scaling": 1.0, "prior_std": 1.0, "batch_size": 128},
    "Talos": {"context": [0.1, 0.5, 1.0]},
}


def _flags(target) -> tuple:
    return (target.use_log_density_and_grad, target.safe_for_jit,
            target.safe_for_tf_graph, target.can_sample())


@pytest.fixture
def no_download(monkeypatch, tmp_path):
    """No keras, an empty ``HOME`` and the MNIST stand-in: the JAX loader
    would otherwise try a download."""
    for name in ("keras", "keras.datasets", "sklearn", "sklearn.datasets"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("GMMVI_DATASETS", raising=False)
    monkeypatch.setenv("GMMVI_ALLOW_SYNTHETIC", "1")


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_registry_target_flags_match_jax(name, no_download):
    """(a) The flags of ``get_target_lnpdf(name, ...)`` in both packages,
    and the base class's defaults."""
    from gmmvi_tpu.experiments.setup import get_target_lnpdf as j_get
    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    got = _flags(get_target_lnpdf(name, dict(REGISTRY[name]), 0,
                                  device="cpu"))
    assert got == _flags(j_get(name, dict(REGISTRY[name]), 0)), name


@pytest.mark.parametrize("with_grad", [True, False])
def test_host_target_and_base_flags_match_jax(with_grad):
    """(a) ``HostLNPDF``'s flag is True exactly when it is given a gradient
    callable; without one a first-order estimator's call still raises
    its ``NotImplementedError``; the base class's defaults and its
    ``sample`` equal JAX's."""
    from gmmvi_tpu.experiments.targets.lnpdf import LNPDF as JLNPDF
    from gmmvi_tpu.experiments.targets.talos_ik import HostLNPDF as JHost
    from gmmvi_tpu_torch.experiments.targets.talos_ik import HostLNPDF

    def fn(x):
        return -0.5 * np.sum(x ** 2, 1)

    def fn_and_grad(x):
        return fn(x), -x

    grad = fn_and_grad if with_grad else None
    t, j = HostLNPDF(3, fn, grad), JHost(3, fn, grad)
    assert _flags(t) == _flags(j) == (with_grad, False, False, False)
    if not with_grad:
        with pytest.raises(NotImplementedError, match="no gradients"):
            t.log_density_and_autograd(torch.zeros(2, 3))
    assert _flags(gmmvi_tpu_torch.LNPDF()) == _flags(JLNPDF()) \
        == (False, True, True, False)
    assert _flags(gmmvi_tpu_torch.LNPDF(True, False)) \
        == _flags(JLNPDF(True, False))
    with pytest.raises(NotImplementedError):
        gmmvi_tpu_torch.LNPDF().sample(4)


def _doubled(target, flag: bool):
    """A copy of Student-T ``target`` (either package's) whose
    ``log_density_and_grad`` gives twice the gradient of its
    ``log_density``, with ``use_log_density_and_grad`` ``flag``."""
    class Doubled(type(target)):
        def log_density_and_grad(self, x):
            ld, grads = super().log_density_and_grad(x)
            return ld, 2.0 * grads

    out = copy.copy(target)
    out.__class__ = Doubled
    out._use_log_density_and_grad = flag
    return out


def _newest(named: dict) -> np.ndarray:
    it = named["db.sample_iter"]
    return np.flatnonzero((it >= 0) & (it == it.max()))


@pytest.mark.parametrize("flag", [True, False])
def test_flag_routes_the_gradient_as_in_jax(flag, monkeypatch):
    """(b) One SAMTRON (Stein) step from the same state with JAX's draws on
    a target whose own gradient is twice its log density's: leaf by leaf
    at the one-step bar (integer leaves exact, float leaves rtol 1e-4 /
    atol 1e-5), and in both packages the gradients stored for the step's
    samples are twice the analytic ones where the flag is True and the
    analytic ones (autograd of ``log_density``) where it is False."""
    monkeypatch.setenv("GMMVI_FUSED_DENSITY", "interpret")
    monkeypatch.setenv("GMMVI_FUSED_TR", "interpret")
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5)
    assert tg.estimator_type == "Stein"
    jstm, tstm = jg.target_distribution, tg.target_distribution
    jg.target_distribution = _doubled(jstm, flag)
    tg.target_distribution = _doubled(tstm, flag)
    tg.state = gmmvi_tpu_torch.state_from_numpy(
        jax_state_leaves(jg.state), device="cpu", like=tg.state)
    draws = jax_step_draws(jg)
    jg.train_iter()
    tg.train_iter(draws)
    j_named = jax_state_leaves(jg.state)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)
    factor = 2.0 if flag else 1.0
    rows = _newest(t_named)
    np.testing.assert_array_equal(rows, _newest(j_named))
    assert len(rows) > 0
    x = t_named["db.samples"][rows]
    want_t = tstm.log_density_and_grad(torch.as_tensor(x))[1].numpy()
    want_j = np.asarray(jstm.log_density_and_grad(jnp.asarray(x))[1])
    scale = np.abs(want_t).max()
    np.testing.assert_allclose(t_named["db.target_grads"][rows],
                               factor * want_t, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(j_named["db.target_grads"][rows],
                               factor * want_j, rtol=0, atol=1e-5 * scale)


class _LogDensityOnly(gmmvi_tpu_torch.LNPDF):
    """A target that supplies only ``log_density`` (the wrapped one's)."""

    def __init__(self, inner):
        super().__init__(use_log_density_and_grad=False, safe_for_jit=True)
        self.inner = inner

    def log_density(self, x):
        return self.inner.log_density(x)

    def get_num_dimensions(self):
        return self.inner.get_num_dimensions()


def test_log_density_only_target_steps_as_jax_autodiff():
    """(c) A ``log_density``-only Student-T subclass (flag False) in the
    port against JAX's Student-T with its flag False, whose optimizer
    takes ``vmap(value_and_grad)`` of its log density: one SAMTRON step
    from the same state with JAX's draws, both in float64 (the state's
    float32 leaves cast exactly, the targets in float64); the stored
    gradients within 1e-10 of their largest entry, every leaf within rtol
    1e-4 / atol 1e-5 and the integer leaves exact."""
    jg, tg = build_pair(dims=5, kmax=8, n_des=24, k0=5)
    named = as_float64(jax_state_leaves(jg.state))
    with jax.enable_x64(True):
        jt = jax_target_in_float64(jg.target_distribution)
        jt._use_log_density_and_grad = False
        jg.target_distribution = jt
        jg.state = jax_state_from_leaves(jg.state, named)
        draws = jax_step_draws(jg, dtype=jnp.float64)
        jg.train_iter()
        j_named = jax_state_leaves(jg.state)
    port_target_to_float64(tg.target_distribution)
    tg.target_distribution = _LogDensityOnly(tg.target_distribution)
    tg.state = gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                                like=tg.state)
    tg.train_iter(draws)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert t_named["model.means"].dtype == np.float64
    got, want = t_named["db.target_grads"], j_named["db.target_grads"]
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def _example_4():
    path = os.path.join(REPO, "examples_torch",
                        "4_gmmvi_runner_with_custom_environments.py")
    spec = importlib.util.spec_from_file_location("example_4", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_custom_rosenbrock_runs_through_the_runner():
    """(d) Example 4's ``Rosenbrock(LNPDF)``, built with
    ``super().__init__(use_log_density_and_grad=True,
    safe_for_jit=False)`` as the JAX example builds its own, runs the
    example's SAMTRUX config through ``GmmviRunner`` for 5 iterations on
    the CPU: its gradient is the one the optimizer stores, and the ELBO
    is finite."""
    example = _example_4()
    cfg = example.merged_config()
    target = cfg["target_fn"]
    assert isinstance(target, gmmvi_tpu_torch.LNPDF)
    assert _flags(target) == (True, False, False, False)
    runner = gmmvi_tpu_torch.GmmviRunner.build_from_config(cfg,
                                                           device="cpu")
    for n in range(5):
        runner.iterate_and_log(n)
    db = runner.gmmvi.state.db
    rows = db.sample_iter >= 0
    np.testing.assert_allclose(
        db.target_grads[rows].numpy(),
        target.log_density_and_grad(db.samples[rows])[1].numpy(),
        rtol=1e-6, atol=1e-4)
    assert math.isfinite(runner.get_expensive_metrics()["-elbo"])


# ---------------------------------------------------------------------------
# (e) the helpers against JAX
# ---------------------------------------------------------------------------

def test_load_yaml_matches_jax():
    """The example config and a module default read by both packages."""
    import gmmvi_tpu.configs as jcfg

    for path in (os.path.join(REPO, "examples_torch", "example_config.yml"),
                 os.path.join(REPO, "gmmvi_tpu", "configs",
                              "experiment_configs", "stm20.yml")):
        got = gmmvi_tpu_torch.configs.load_yaml(path)
        assert got == jcfg.load_yaml(path) and got


@pytest.mark.parametrize("diagonal", [False, True])
def test_component_log_densities_from_whitened_matches_jax(diagonal):
    """From each package's whitened diffs (3 components in 4 slots, D = 6,
    40 samples): rtol 1e-5 / atol 1e-4 against JAX, and equal to the
    port's ``component_log_densities`` on the active slots."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    rng = np.random.RandomState(3)
    k, d = 3, 6
    w = np.array([0.5, 0.3, 0.2], np.float32)
    means = rng.randn(k, d).astype(np.float32)
    if diagonal:
        covs = (0.5 + rng.rand(k, d)).astype(np.float32)
    else:
        a = rng.randn(k, d, d).astype(np.float32)
        covs = (np.einsum("kij,klj->kil", a, a) / d
                + np.eye(d, dtype=np.float32)).astype(np.float32)
    x = rng.randn(40, d).astype(np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=4,
                               diagonal=diagonal)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=4,
                               diagonal=diagonal, device="cpu")
    xt = torch.as_tensor(x)
    got = tgmm.component_log_densities_from_whitened(
        ts, tgmm.whitened_diffs(ts, xt)).numpy()
    want = np.asarray(jgmm.component_log_densities_from_whitened(
        js, jgmm.whitened_diffs(js, jnp.asarray(x))))
    np.testing.assert_allclose(got[:k], want[:k], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got[:k], tgmm.component_log_densities(ts, xt).numpy()[:k],
        rtol=1e-6, atol=1e-5)


def test_finalize_matches_jax():
    """The two-pass ``finalize`` from the state of two SAMTRON steps with
    sample reuse (ZAMTRUX's selector), on a hand-made proposal (half its
    rows valid) and target values, the reservoir's slots and accept
    uniforms drawn from JAX's key as its ``add_samples`` draws them: the
    database's integer leaves and the window's valid count exact, the
    float leaves within rtol 1e-4 / atol 1e-5; and equal to the port's
    ``finalize_fused`` without its pack."""
    from gmmvi_tpu.optimization import sample_selectors as jsel
    from gmmvi_tpu.utils.checkpoint import _named_leaves
    from gmmvi_tpu_torch.optimization import sample_selectors as tsel

    jg, tg = build_pair(dims=4, codename="ZAMTRUX", kmax=6, n_des=16, k0=4)
    for _ in range(2):
        jg.train_iter()
    ts = gmmvi_tpu_torch.state_from_numpy(jax_state_leaves(jg.state),
                                          device="cpu", like=tg.state)
    js = jg.state
    kmax, n_des, d = 6, 16, 4
    b = kmax * n_des
    rng = np.random.RandomState(5)
    samples = rng.randn(b, d).astype(np.float32)
    valid = rng.rand(b) < 0.5
    mapping = (np.arange(b) // n_des).astype(np.int32)
    lnpdfs = rng.randn(b).astype(np.float32)
    grads = rng.randn(b, d).astype(np.float32)
    num_reused = np.int32(20)
    key = jax.random.PRNGKey(11)
    slot_key, acc_key = jax.random.split(key)
    c = js.db.reservoir_capacity
    rand_slots = torch.as_tensor(np.array(jax.random.randint(
        slot_key, (b,), 0, c)), dtype=torch.int32)
    accept_u = torch.as_tensor(np.array(jax.random.uniform(acc_key, (b,))))
    it = int(js.num_updates)

    jprop = jsel.Proposal(jnp.asarray(samples), jnp.asarray(valid),
                          jnp.asarray(mapping), jnp.asarray(num_reused))
    jdb, jwin = jsel.finalize(js.model, js.db, jg.selector_cfg,
                              jnp.asarray(it, jnp.int32), jprop,
                              jnp.asarray(lnpdfs), jnp.asarray(grads), key)

    def t(a):
        return torch.as_tensor(np.array(a))

    tprop = tsel.Proposal(t(samples), t(valid), t(mapping), t(num_reused))
    args = (ts.model, ts.db, tg.selector_cfg, it, tprop, t(lnpdfs), t(grads),
            rand_slots, accept_u)
    tdb, twin = tsel.finalize(*args)
    fdb, fwin, _ = tsel.finalize_fused(*args)

    t_db = {name: getattr(tdb, name).numpy()
            for name in gmmvi_tpu_torch._tensor_fields(type(tdb))}
    j_db = {k: np.asarray(v) for k, v in _named_leaves(jdb).items()}
    assert set(t_db) == set(j_db)
    assert_states_match(t_db, j_db)
    for name in ("samples", "mapping", "target_lnpdfs", "target_grads",
                 "background_log_pdfs", "valid", "num_valid",
                 "sample_iters"):
        got = getattr(twin, name).numpy()
        assert_states_match({name: got}, {name: np.asarray(getattr(jwin,
                                                                   name))})
        np.testing.assert_array_equal(got, getattr(fwin, name).numpy())
    assert int(twin.num_valid) > int(valid.sum())
    for name in ("samples", "write_pos", "res_samples"):
        np.testing.assert_array_equal(getattr(tdb, name).numpy(),
                                      getattr(fdb, name).numpy())


def test_database_shape_properties_match_jax():
    """``num_dimensions``, ``capacity``, ``ring_iters``,
    ``max_components``, the reservoir's capacity, ``dist_capacity`` and
    the sharded database's ``n_shards``, ``capacity_local`` and
    ``reservoir_capacity_local`` of each database built by both packages
    from the same arguments."""
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu.optimization import sample_db_decimate as jdec
    from gmmvi_tpu.optimization import sample_db_sharded as jshd
    from gmmvi_tpu_torch.optimization import sample_db as tdb
    from gmmvi_tpu_torch.optimization import sample_db_decimate as tdec
    from gmmvi_tpu_torch.optimization import sample_db_sharded as tshd

    pairs = [
        (jdb.create_sample_db(7, 8, 300, 5, 64),
         tdb.create_sample_db(7, 8, 300, 5, 64, device="cpu"),
         ("num_dimensions", "capacity", "ring_iters", "max_components",
          "reservoir_capacity")),
        (jdec.create_decimating_db(7, 8, 300, 40),
         tdec.create_decimating_db(7, 8, 300, 40, device="cpu"),
         ("num_dimensions", "capacity", "dist_capacity")),
        (jshd.create_sharded_db(7, 8, 300, 5, 64, 2),
         tshd.create_sharded_db(7, 8, 300, 5, 64, 2, device="cpu"),
         ("num_dimensions", "n_shards", "capacity_local", "ring_iters",
          "max_components", "reservoir_capacity_local")),
    ]
    for j, t, names in pairs:
        got = {n: getattr(t, n) for n in names}
        assert got == {n: getattr(j, n) for n in names}, type(t).__name__
        assert got["num_dimensions"] == 7
    sharded = pairs[2][1]
    assert (sharded.capacity_local, sharded.reservoir_capacity_local) == (
        sharded.capacity, sharded.reservoir_capacity)


@pytest.mark.parametrize("dim,keepdim", [(None, False), (None, True),
                                         (1, False), (0, True)])
def test_masked_logsumexp_sign_matches_jax(dim, keepdim):
    """``return_sign``: the values and the sign (1 where a slice holds an
    entry, 0 where it is entirely masked) in JAX's shapes."""
    from gmmvi_tpu.ops import stable as jst
    from gmmvi_tpu_torch.ops import stable as tst

    rng = np.random.RandomState(0)
    a = rng.randn(4, 5).astype(np.float32)
    mask = rng.rand(4, 5) < 0.6
    mask[2] = False
    mask[:, 3] = False
    got, sign = tst.masked_logsumexp(torch.as_tensor(a),
                                     mask=torch.as_tensor(mask), dim=dim,
                                     keepdim=keepdim, return_sign=True)
    want, jsign = jst.masked_logsumexp(jnp.asarray(a), mask=jnp.asarray(mask),
                                       axis=dim, keepdims=keepdim,
                                       return_sign=True)
    assert tuple(got.shape) == want.shape
    assert tuple(sign.shape) == jsign.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    assert np.asarray(jsign).min() == (0.0 if dim is not None else 1.0)
