"""The paper's logistic-regression and planar-robot targets and the
diagonal GMM target in the PyTorch port, against the JAX package: the
dataset loaders, the targets' densities and gradients, the minibatch
target's batches call for call, the planar robot's mode counts, the five
experiments' defaults, and breast_cancer through the runner.

Both packages get the same numpy inputs (drawn from seeded
``np.random.RandomState``s); the runner trajectory injects JAX's step and
evaluation draws into the port.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, jax_eval_draws, jax_state_from_leaves,
                          jax_state_leaves, jax_step_draws,
                          jax_target_in_float64, port_target_to_float64,
                          xdist_lock)

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = ("breast_cancer", "breast_cancer_mb", "german_credit",
               "german_credit_mb", "planar_robot_4", "talos", "wine")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, rtol, atol, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err)


def _grads_close(got, want, frac=1e-4, err=""):
    """Gradients within ``frac`` of the largest entry of the reference."""
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * scale, err_msg=err)


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["breast_cancer", "german_credit"])
def test_loaders_give_the_jax_arrays(name):
    """Features and labels equal to the JAX loaders', read from the files
    in place."""
    from gmmvi_tpu.experiments.targets import datasets as jds
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    got = getattr(tds, f"load_{name}")()
    want = getattr(jds, f"load_{name}")()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(got[1])) == {0.0, 1.0}


def test_loaders_read_without_the_jax_package():
    """The port finds the data files from its own location, with JAX and
    the JAX package unavailable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gmmvi_tpu'] = None; "
            "from gmmvi_tpu_torch.experiments.targets import datasets as d; "
            "import gmmvi_tpu_torch.experiments.targets.logistic_regression, "
            "gmmvi_tpu_torch.experiments.targets.planar_robot, "
            "gmmvi_tpu_torch.experiments.evaluation.visualize_planar_robot; "
            "x, y = d.load_breast_cancer(); u, v = d.load_german_credit(); "
            "print(x.shape, u.shape, 'gmmvi_tpu' in sys.modules and "
            "sys.modules['gmmvi_tpu'] is not None)")
    env = {k: v for k, v in os.environ.items() if k != "GMMVI_DATASETS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(569, 30) (1000, 24) False"


def test_missing_dataset_raises_naming_the_path(monkeypatch, tmp_path):
    """``GMMVI_DATASETS`` is searched first; a file found nowhere raises
    FileNotFoundError naming every path tried."""
    from gmmvi_tpu_torch.experiments.targets import datasets as tds

    rows = np.loadtxt(str(tds.DATA_DIR / "breast_cancer.data"))[:7]
    np.savetxt(str(tmp_path / "breast_cancer.data"), rows)
    monkeypatch.setenv("GMMVI_DATASETS", str(tmp_path))
    x, labels = tds.load_breast_cancer()
    assert x.shape == (7, 30) and labels.shape == (7,)
    monkeypatch.setattr(tds, "DATA_DIR", tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError) as err:
        tds.load_german_credit()
    assert str(tmp_path / "german.data-numeric") in str(err.value)
    assert str(tmp_path / "nowhere" / "german.data-numeric") in str(err.value)


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------

def _thetas(d, p=40, seed=0, scale=0.3):
    return (np.random.RandomState(seed).randn(p, d) * scale).astype(
        np.float32)


@pytest.mark.parametrize("dataset", ["breast_cancer", "german_credit"])
def test_logistic_regression_matches_jax(dataset):
    """The posterior within rtol 1e-5 and its analytic gradient within
    1e-4 of its largest entry, against the JAX target's (and the port's
    gradient against its own autograd)."""
    from gmmvi_tpu.experiments.targets import logistic_regression as jlr
    from gmmvi_tpu_torch.experiments.targets import logistic_regression as tlr
    from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF

    jt = jlr.LogisticRegression(dataset)
    tt = tlr.LogisticRegression(dataset, device="cpu")
    assert tt.get_num_dimensions() == jt.get_num_dimensions()
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    theta = _thetas(tt.get_num_dimensions())
    ld, grad = tt.log_density_and_grad(_t(theta))
    jld, jgrad = jt.log_density_and_grad(jnp.asarray(theta))
    _close(ld, jld, rtol=1e-5, atol=0, err="log density")
    _close(tt.log_density(_t(theta)), jt.log_density(jnp.asarray(theta)),
           rtol=1e-5, atol=0)
    _grads_close(grad, jgrad, err="gradient")
    _, auto = LNPDF.log_density_and_grad(tt, _t(theta))
    _grads_close(grad, auto, err="autograd")


@pytest.mark.parametrize("own_batches", [True, False])
def test_minibatch_target_matches_jax_call_for_call(own_batches):
    """Three consecutive calls give the JAX target's values (each call
    reshuffles with the same seeded RandomState: the same batches), three
    more the values and gradients the optimizers take (JAX's
    ``vmap(value_and_grad)`` of a one-sample call: one shuffle a call,
    every sample on the first batch), then the full-batch density over
    the shuffled training rows; with a test split of 100 rows."""
    from gmmvi_tpu.experiments.targets import logistic_regression as jlr
    from gmmvi_tpu_torch.experiments.targets import logistic_regression as tlr

    jt = jlr.LogisticRegression_minibatch("german_credit", 64, 100,
                                          own_batches)
    tt = tlr.LogisticRegression_minibatch("german_credit", 64, 100,
                                          own_batches, device="cpu")
    assert tt.num_data == jt.num_data == 900
    # 40 samples: the per-sample batches wrap around the 900 rows (14 a
    # cycle)
    theta = _thetas(tt.get_num_dimensions())
    for call in range(3):
        _close(tt.log_density(_t(theta)), jt.log_density(jnp.asarray(theta)),
               rtol=1e-5, atol=1e-3, err=f"call {call}")
    for call in range(3):
        ld, grad = tt.log_density_and_grad(_t(theta))
        jld, jgrad = jax.vmap(jax.value_and_grad(
            lambda s: jt.log_density(s[None])[0]))(jnp.asarray(theta))
        _close(ld, jld, rtol=1e-5, atol=1e-3, err=f"call {call}")
        _grads_close(grad, jgrad, err=f"call {call}")
    _close(tt.log_density_fb(_t(theta)), jt.log_density_fb(
        jnp.asarray(theta)), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tt.data_test.numpy(),
                                  np.asarray(jt.data_test))


def test_minibatch_elbo_metric_matches_jax():
    """The minibatch target's ``elbo_fb`` metric from the same mixture and
    draws."""
    from gmmvi_tpu.experiments.targets import logistic_regression as jlr
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.experiments.targets import logistic_regression as tlr
    from gmmvi_tpu_torch.models import gmm as tgmm

    jt = jlr.LogisticRegression_minibatch("breast_cancer", 64, 0, True)
    tt = tlr.LogisticRegression_minibatch("breast_cancer", 64, 0, True,
                                          device="cpu")
    d = tt.get_num_dimensions()
    rng = np.random.RandomState(2)
    means = (rng.randn(3, d) * 0.3).astype(np.float32)
    covs = np.tile(np.eye(d, dtype=np.float32)[None] * 0.01, (3, 1, 1))
    w = np.array([0.5, 0.3, 0.2], np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=4)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=4,
                               device="cpu")
    samples = _thetas(d, p=200, seed=3, scale=0.1)
    got = tt.expensive_metrics(ts, _t(samples))["elbo_fb"]
    want = jt.expensive_metrics(js, jnp.asarray(samples))["elbo_fb"]
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Planar robot
# ---------------------------------------------------------------------------

def _arms_at_goals(goals, per_goal=2, seed=0):
    """Joint angles whose end effector sits on each goal, two arm shapes a
    goal (first joint bent either way), by damped least squares from
    seeded starts: the prior's residuals theta / std beside the goal's
    (fk - goal) / 1e-2."""
    from scipy.optimize import least_squares

    stds = np.array([1.0] + [0.2] * 9)

    def fk(th):
        a = np.cumsum(th)
        return np.array([np.cos(a).sum(), np.sin(a).sum()])

    rng = np.random.RandomState(seed)
    arms = []
    for g in goals:
        for sign in (1.0, -1.0)[:per_goal]:
            th0 = np.zeros(10)
            th0[0] = math.atan2(g[1], g[0]) + sign * 0.6
            th0[1:] = -sign * 0.15 + 0.01 * rng.randn(9)
            sol = least_squares(
                lambda th: np.concatenate([(fk(th) - g) / 1e-2, th / stds]),
                th0)
            arms.append(sol.x)
    return np.array(arms, np.float32)


def test_planar_robot_matches_jax():
    """The four-goal robot's density and its autograd gradient (JAX: its
    GMMVI's per-sample ``value_and_grad``) at random and at goal-reaching
    angles, and the mode counts of a mixture whose means reach the goals
    (two arm shapes at each of the first three goals, none at the fourth,
    and four far-off means), equal to JAX's."""
    from gmmvi_tpu.experiments.targets import planar_robot as jpr
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.experiments.targets import planar_robot as tpr
    from gmmvi_tpu_torch.models import gmm as tgmm

    jt, tt = jpr.make_four_goal(), tpr.make_four_goal(device="cpu")
    goals = np.asarray(jt.goals)
    arms = _arms_at_goals(goals[:3])
    theta = np.concatenate([_thetas(10, p=30, seed=5, scale=0.5), arms])
    ld, grad = tt.log_density_and_grad(_t(theta))
    jld, jgrad = jax.vmap(jax.value_and_grad(
        lambda s: jt.log_density(s[None])[0]))(jnp.asarray(theta))
    _close(ld, jld, rtol=1e-5, atol=1e-3)
    _grads_close(grad, jgrad, err="gradient")
    _close(tt.forward_kinematics(_t(arms)), jt.forward_kinematics(
        jnp.asarray(arms)), rtol=0, atol=1e-5)

    means = np.concatenate([arms, _thetas(10, p=4, seed=6, scale=2.0)])
    k = means.shape[0]
    covs = np.tile(np.eye(10, dtype=np.float32)[None] * 1e-3, (k, 1, 1))
    w = np.full(k, 1.0 / k, np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=16)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=16,
                               device="cpu")
    got = {k: v for k, v in tt.expensive_metrics(ts, None).items()
           if k.startswith("num_detected_modes")}
    want = {k: v for k, v in jt.expensive_metrics(js, None).items()
            if k.startswith("num_detected_modes")}
    assert got == want
    assert list(got.values()) == [2, 2, 2, 0], got


# ---------------------------------------------------------------------------
# The diagonal GMM target
# ---------------------------------------------------------------------------

def test_diagonal_gmm_target_matches_jax():
    """``make_diag_target`` from one seed: the same parameters, and its
    density and analytic gradient at samples around its modes within the
    density kernels' bar (atol 5e-4 + rtol 1e-5; gradients within 1e-4 of
    their largest entry)."""
    from gmmvi_tpu.experiments.targets import gmm as jtg
    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    jt = jtg.make_diag_target(6, seed=3)
    tt = get_target_lnpdf("DIAGGMM", {"num_dimensions": 6}, 3,
                          device="cpu")
    np.testing.assert_array_equal(tt.target_covs, jt.target_covs)
    rng = np.random.RandomState(4)
    x = (jt.target_means[rng.randint(0, 10, 300)]
         + rng.randn(300, 6) * 2).astype(np.float32)
    ld, grad = tt.log_density_and_grad(_t(x))
    jld, jgrad = jt.log_density_and_grad(jnp.asarray(x))
    _close(ld, jld, rtol=1e-5, atol=5e-4)
    _close(tt.log_density(_t(x)), jt.log_density(jnp.asarray(x)), rtol=1e-5,
           atol=5e-4)
    _grads_close(grad, jgrad)
    _close(tt.marginal_log_density(_t(x), 2),
           jt.marginal_log_density(jnp.asarray(x), 2), rtol=1e-5, atol=5e-4)
    assert tt.expensive_metrics(None, None) == {}


# ---------------------------------------------------------------------------
# Experiment defaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_defaults_equal_the_yaml_files(experiment):
    """The paper's experiments: their defaults equal their YAML files, SAMTRON
    on them is configured as in the JAX package, and the config
    validates."""
    yaml = pytest.importorskip("yaml")
    import gmmvi_tpu.configs as jcfg

    with open(os.path.join(REPO, "gmmvi_tpu", "configs",
                           "experiment_configs", f"{experiment}.yml")) as fh:
        assert tcfg.get_default_experiment_config(experiment) == \
            yaml.safe_load(fh)
    assert tcfg.get_default_config("SAMTRON", experiment) == \
        jcfg.get_default_config("SAMTRON", experiment)
    tcfg.validate_config(tcfg.get_default_config("SAMTRON", experiment))


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiments_build_and_step_on_the_cpu(experiment):
    """Each experiment's SAMTRON defaults through ``init_experiment`` and
    ``GMMVI.build_from_config`` on the CPU: JAX's padded capacity and
    reuse sizes, two steps with a finite state.  planar_robot_4 keeps its
    300 initial components and 600 slots but draws 8 samples a component
    (its 100 would make a 180,000-sample window)."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import default_max_components
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = tcfg.get_default_config("SAMTRON", experiment)
    if experiment == "planar_robot_4":
        cfg = tcfg.update_config(cfg, {"sample_selector_config": {
            "desired_samples_per_component": 8}})
    target, model, meta = init_experiment(cfg, device="cpu")
    g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
    k0 = cfg["model_initialization"]["num_initial_components"]
    assert model.max_components == default_max_components(
        jcfg.get_default_config("SAMTRON", experiment), k0)
    assert g.selector_cfg.max_background_dists == min(
        4 * model.max_components, 2048)
    g.train_iters(2)
    k = int(g.model.num_active)
    assert k == k0 and torch.isfinite(g.model.means[:k]).all()
    assert int(g.state.db.num_samples_written) > 0


def test_minibatch_step_matches_jax_leaf_by_leaf():
    """breast_cancer_mb's SAMTRON defaults (per-sample batches, a test
    split of 100 rows) built by both packages: two steps from JAX's state
    carried across with JAX's draws injected, each target call taking the
    same shuffle, so both optimizers differentiate every sample on the
    call's first batch, and both shuffles stay in step; integer leaves
    exact, float leaves within rtol 1e-4 / atol 1e-5, the target's
    gradients (sums of terms of 1e3 over a batch) within 1e-4 of their
    largest entry, the gradient bar above."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI
    from torch_parity import assert_states_match

    jc = jcfg.get_default_config("SAMTRON", "breast_cancer_mb")
    assert jc["environment_config"]["use_own_batch_per_sample"]
    jt, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = tcfg.get_default_config("SAMTRON", "breast_cancer_mb")
    tt, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    for _ in range(2):
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            jax_state_leaves(jg.state), device="cpu", like=tg.state)
        draws = jax_step_draws(jg)
        jg.train_iter()
        tg.train_iter(draws)
        j_named = jax_state_leaves(jg.state)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        _grads_close(t_named.pop("db.target_grads"),
                     j_named.pop("db.target_grads"), err="target grads")
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)
    order = torch.as_tensor(tt._order)
    np.testing.assert_array_equal(tt._train_data[order].numpy(),
                                  jt._np_data)
    np.testing.assert_array_equal(tt._train_labels[order].numpy(),
                                  jt._np_labels)


# ---------------------------------------------------------------------------
# breast_cancer through the runner
# ---------------------------------------------------------------------------

RUN_ITERS = 31


@pytest.fixture
def _one_test_at_a_time(tmp_path_factory):
    with xdist_lock(tmp_path_factory, "tests"):
        yield


def _runner_config(pkg_cfg):
    return pkg_cfg.update_config(
        pkg_cfg.get_default_config("SAMTRON", "breast_cancer"),
        {"gmmvi_runner_config": {"log_metrics_interval": 10}})


def test_breast_cancer_runner_matches_jax(_one_test_at_a_time):
    """breast_cancer's SAMTRON defaults through both runners for 31
    iterations (an evaluation every 10 rather than 50; D = 31, one
    component in 24 slots, 100 fresh and 200 reused samples each, an add
    at iteration 30) with JAX's step and evaluation draws injected, both
    in float64 (the initial states cast exactly, the targets evaluated in
    float64): every step's fevals, component count and database sizes
    equal, each evaluation's ELBO within 1.0 and finite.  In float32 the
    reuse path's fresh-sample counts (floors of ESS values) part by one
    sample at iteration 14, as the gmm20 runner's do
    (test_torch_runner.py)."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu import GmmviRunner as JRunner

    with jax.enable_x64(True):
        jr = JRunner.build_from_config(_runner_config(jcfg))
        jr.target_distribution = jr.gmmvi.target_distribution = \
            jax_target_in_float64(jr.target_distribution)
        jr.gmmvi.state = jax_state_from_leaves(
            jr.gmmvi.state, as_float64(jax_state_leaves(jr.gmmvi.state)))
        draws, outputs = [], []
        for n in range(RUN_ITERS):
            # copies: the step donates the state's buffers
            key = jnp.asarray(np.asarray(jr.gmmvi.state.key))
            eval_key = jnp.asarray(np.asarray(jr._eval_key))
            outputs.append(jr.iterate_and_log(n))
            draws.append((jax_step_draws(jr.gmmvi, key=key,
                                         dtype=jnp.float64),
                          jax_eval_draws(eval_key, jr.gmmvi.state.model,
                                         jnp.float64)
                          if n % 10 == 0 else None))
        j_active = int(jr.gmmvi.state.model.num_active)
    tr = gmmvi_tpu_torch.GmmviRunner.build_from_config(
        _runner_config(tcfg), device="cpu")
    assert tr.gmmvi.model.max_components == 24
    tr.gmmvi.state = gmmvi_tpu_torch.state_from_numpy(
        as_float64(gmmvi_tpu_torch.state_to_numpy(tr.gmmvi.state)),
        device="cpu", like=tr.gmmvi.state)
    port_target_to_float64(tr.target_distribution)
    tr.gmmvi.draw = lambda iteration: draws[iteration][0]
    metrics = tr.get_expensive_metrics
    tr.get_expensive_metrics = lambda: metrics(
        draws=draws[tr.gmmvi.num_updates - 1][1])
    evals = 0
    for n in range(RUN_ITERS):
        got, want = tr.iterate_and_log(n), outputs[n]
        for key in ("num_samples", "num_components", "num_db_samples",
                    "num_db_components"):
            assert got[key] == want[key], (n, key, got[key], want[key])
        if "-elbo" in want:
            evals += 1
            assert math.isfinite(got["-elbo"])
            assert abs(got["-elbo"] - want["-elbo"]) < 1.0, (n, got, want)
    assert tr.gmmvi.state.model.means.dtype == torch.float64
    assert evals == 4 and j_active == 2
    assert int(tr.gmmvi.state.model.num_active) == j_active
