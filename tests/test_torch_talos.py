"""The Talos IK target and the host-target path of the PyTorch port, against
the JAX package: the URDF's parsed structure, forward kinematics, centre of
mass and tip poses, the posterior and its autograd gradient, the gripper
prior's transform, the stick-figure metrics, a ``HostLNPDF`` step (the
valid rows in a power-of-two bucket, identical arrays handed to the
callables, the states leaf by leaf) and SAMTRON steps on talos at D = 34
leaf by leaf.

Both packages get the same numpy inputs (drawn from seeded
``np.random.RandomState``s); the steps inject JAX's draws into the port.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64,
                          port_target_to_float64, samtron_overrides,
                          xdist_lock)

import gmmvi_tpu_torch
import gmmvi_tpu_torch.configs as tcfg

torch.set_num_threads(2)

CONTEXT = [0.1, 0.5, 1.0]


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _grads_close(got, want, frac=1e-4, err=""):
    """Gradients within ``frac`` of the largest entry of the reference."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=err)


@pytest.fixture(scope="module")
def targets():
    from gmmvi_tpu.experiments.targets import talos_ik as jtalos
    from gmmvi_tpu_torch.experiments.targets import talos_ik as ttalos

    return (jtalos.make_talos_target(CONTEXT),
            ttalos.make_talos_target(CONTEXT, device="cpu"))


def _configurations(target, n=16, seed=0, scale=0.3):
    """``n`` samples around the neutral pose (joints, base position and
    orientation perturbed by ``scale``)."""
    rng = np.random.RandomState(seed)
    return (target.mean_joints[None]
            + scale * rng.standard_normal((n, 34))).astype(np.float32)


# ---------------------------------------------------------------------------
# URDF and kinematics
# ---------------------------------------------------------------------------

def test_urdf_structure_matches_jax(targets):
    """The same tree from talos_reduced.urdf: 28 actuated joints in the
    same order with the same limits, the same segments (parents, fixed
    transforms, axes, masses, centres of mass), tips and total mass."""
    jt, tt = targets
    jtree, ttree = jt.tree, tt.tree
    assert ttree.nb_joint == jtree.nb_joint == 28
    assert tt.get_num_dimensions() == 34
    assert ttree.actuated_joint_names == jtree.actuated_joint_names
    np.testing.assert_array_equal(ttree.joint_limits, jtree.joint_limits)
    assert ttree.tip_nodes == jtree.tip_nodes
    assert len(ttree.segments) == len(jtree.segments)
    for ts, js in zip(ttree.segments, jtree.segments):
        assert (ts.joint_name, ts.child_link, ts.parent_idx, ts.q_index) \
            == (js.joint_name, js.child_link, js.parent_idx, js.q_index)
        for a, b in zip((ts.origin_rot, ts.origin_pos, ts.axis, ts.com),
                        (js.origin_rot, js.origin_pos, js.axis, js.com)):
            np.testing.assert_array_equal(a, b)
        assert ts.mass == js.mass
    assert ttree._total_mass == jtree._total_mass
    assert ttree.root_mass == jtree.root_mass
    np.testing.assert_array_equal(tt.mean_joints, jt.mean_joints)


def test_forward_kinematics_com_and_tips_match_jax(targets):
    """Link positions and rotations, the centre of mass and the four tip
    poses of 16 configurations within rtol 1e-5 / atol 1e-5 (metres and
    rotation entries of order 1)."""
    from gmmvi_tpu.experiments.targets import urdf as jurdf
    from gmmvi_tpu_torch.experiments.targets import urdf as turdf

    jt, tt = targets
    x = _configurations(jt)
    rot = turdf.rpy_matrix_batched(_t(x[:, -3:]))
    np.testing.assert_allclose(
        rot.numpy(), jurdf.rpy_matrix_batched(jnp.asarray(x[:, -3:])),
        rtol=1e-6, atol=1e-6)
    tpos, trot = tt.tree.fk(_t(x[:, :28]), _t(x[:, 28:31]), rot)
    jpos, jrot = jt.tree.fk(jnp.asarray(x[:, :28]), jnp.asarray(x[:, 28:31]),
                            jurdf.rpy_matrix_batched(jnp.asarray(x[:, -3:])))
    assert tpos.shape == (16, len(tt.tree.segments) + 1, 3)
    np.testing.assert_allclose(tpos.numpy(), jpos, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trot.numpy(), jrot, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.tree.com(tpos, trot).numpy(),
                               jt.tree.com(jpos, jrot), rtol=1e-5, atol=1e-5)
    for tip in ("r_gripper", "l_gripper", "r_foot", "l_foot"):
        np.testing.assert_allclose(
            tt.tree.tip_pose(tpos, trot, tip).numpy(),
            jt.tree.tip_pose(jpos, jrot, tip), rtol=1e-5, atol=1e-5,
            err_msg=tip)


def test_talos_density_and_gradient_match_jax(targets):
    """The posterior within rtol 1e-5 / atol 1e-3 (log densities of
    1e2-1e4) and its autograd gradient within 1e-4 of the largest entry of
    JAX's ``vmap(value_and_grad)``, near the neutral pose and far out of
    the joint limits; the port's float64 evaluation (its constants cast
    exactly) at the same bar."""
    jt, tt = targets
    x = np.concatenate([_configurations(jt),
                        _configurations(jt, n=8, seed=1, scale=2.0)])
    jld, jg = jax.vmap(jax.value_and_grad(
        lambda s: jt.log_density(s[None])[0]))(jnp.asarray(x))
    tld, tg = tt.log_density_and_grad(_t(x))
    np.testing.assert_allclose(tld.numpy(), jld, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tt.log_density(_t(x)).numpy(), jld,
                               rtol=1e-5, atol=1e-3)
    _grads_close(tg.numpy(), jg)
    tld64 = tt.log_density(_t(x, torch.float64))
    assert tld64.dtype == torch.float64
    np.testing.assert_allclose(tld64.numpy(), jld, rtol=1e-5, atol=1e-3)


def test_gripper_prior_transform_matches_jax():
    """``TalosLeftGripperTargetPdf``: from the uniforms JAX's ``sample``
    draws, the same [n, 3] targets within 1e-6 (the polar angle's upper
    end ``rad2deg(170)`` kept); the port's own draws are finite and in the
    radius range."""
    from gmmvi_tpu.experiments.targets import talos_ik as jtalos
    from gmmvi_tpu_torch.experiments.targets import talos_ik as ttalos

    jp, tp = jtalos.TalosLeftGripperTargetPdf(), \
        ttalos.TalosLeftGripperTargetPdf()
    assert tp.z_high == jp.z_high == float(np.rad2deg(170))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jp.sample(key, 50))
    u = [_t(jax.random.uniform(k, (50,))) for k in jax.random.split(key, 3)]
    np.testing.assert_allclose(tp.transform(*u).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    own = tp.sample(torch.Generator().manual_seed(0), 50)
    radius = torch.linalg.norm(own, dim=1)
    assert torch.isfinite(own).all()
    assert bool(((radius >= 0.2 - 1e-6) & (radius <= 1.0 + 1e-6)).all())


def test_talos_metrics_draw_the_same_figure(targets):
    """``expensive_metrics`` on the same 8 samples: the same keys and, in
    the figure, the same lines (stick figures, centres of mass, targets)
    within 1e-5; without matplotlib both give ``{}``."""
    jt, tt = targets
    x = _configurations(jt, n=8, seed=2)
    want = jt.expensive_metrics(None, jnp.asarray(x))
    got = tt.expensive_metrics(None, _t(x))
    assert set(got) == set(want)
    if not want:
        return
    import matplotlib.pyplot as plt

    for gax, wax in zip(got["plot"].axes, want["plot"].axes):
        glines, wlines = gax.get_lines(), wax.get_lines()
        assert len(glines) == len(wlines) == 8 * 36 + 4
        for gl, wl in zip(glines, wlines):
            np.testing.assert_allclose(np.asarray(gl.get_xydata(), float),
                                       np.asarray(wl.get_xydata(), float),
                                       rtol=1e-5, atol=1e-5)
    plt.close("all")


# ---------------------------------------------------------------------------
# The host-target path
# ---------------------------------------------------------------------------

class _Gaussian:
    """A numpy Gaussian log density N(mu, diag(var)) with its gradient,
    keeping a copy of every array it is handed."""

    def __init__(self, d, seed=0):
        rng = np.random.RandomState(seed)
        self.mu = 10.0 * rng.standard_normal(d)
        self.var = 1.0 + 50.0 * rng.uniform(size=d)
        self.calls = []

    def log_density(self, x):
        self.calls.append(np.array(x))
        return -0.5 * np.sum((x - self.mu) ** 2 / self.var, 1)

    def log_density_and_grad(self, x):
        self.calls.append(np.array(x))
        return (-0.5 * np.sum((x - self.mu) ** 2 / self.var, 1),
                -(x - self.mu) / self.var)


def _host_pair(codename="SAMTRON", d=6):
    """(JAX GMMVI, port GMMVI, JAX callables, port callables) on a
    HostLNPDF of the same numpy Gaussian, with the small-run SAMTRON
    overrides (8 initial components in 12 slots, 48 samples each) and the
    M letter's reuse."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.experiments.targets.talos_ik import HostLNPDF as JHost
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.experiments.targets.talos_ik import \
        HostLNPDF as THost
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    over = samtron_overrides()
    over["sample_selector_config"]["ratio_reused_samples_to_desired"] = 2.0
    jfn, tfn = _Gaussian(d), _Gaussian(d)
    jt = JHost(d, jfn.log_density, jfn.log_density_and_grad)
    tt = THost(d, tfn.log_density, tfn.log_density_and_grad)
    jc = jcfg.update_config(jcfg.get_default_algorithm_config(codename),
                            over)
    jc["target_fn"] = jt
    _, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = tcfg.update_config(tcfg.get_default_algorithm_config(codename),
                            over)
    tc["target_fn"] = tt
    _, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    return jg, tg, jfn, tfn


def _gamma(n: int) -> float:
    """``n u / (1 - n u)``, u the float32 unit roundoff."""
    u = 2.0 ** -24
    return n * u / (1.0 - n * u)


def _handed_rows_bound(jg, draws):
    """For JAX's next step on the host-target path: the proposal rows it
    hands the callable (the valid rows padded with row 0 to a power of
    two), the entry-wise bound ``2 gamma_{D+1} (|mu| + |L| |eps|)`` on the
    difference of two float32 evaluations of ``mu + L eps`` at those rows,
    and, in float64, all rows made with the next eps row and with the next
    component's factor."""
    _, prop = jg._jitted_propose(jg.state)
    idx = np.flatnonzero(np.asarray(prop.valid))
    bucket = min(1 << max(len(idx) - 1, 0).bit_length(), len(prop.valid))
    rows = np.zeros(bucket, np.int64)
    rows[:len(idx)] = idx
    mu = np.asarray(jg.state.model.means, np.float64)
    chol = np.asarray(jg.state.model.chols, np.float64)
    eps = draws.eps.numpy().astype(np.float64)
    d = mu.shape[1]
    mag = np.abs(mu)[:, None, :] + np.einsum("kij,knj->kni", np.abs(chol),
                                             np.abs(eps))
    bound = 2.0 * _gamma(d + 1) * mag.reshape(-1, d)[rows]
    others = [mu[:, None, :] + np.einsum("kij,knj->kni", c, e)
              for c, e in ((chol, np.roll(eps, 1, axis=1)),
                           (np.roll(chol, 1, axis=0), eps))]
    return rows, bound, [o.reshape(-1, d) for o in others]


def test_host_target_step_matches_jax_leaf_by_leaf():
    """Three SAMTRON steps on a HostLNPDF from JAX's state carried across
    with JAX's draws: the callables are handed the same float32 arrays,
    entry by entry within the first-order float32 error bound of mu + L eps
    that both packages round each their own way, ``2 gamma_{D+1} (|mu| +
    |L| |eps|)`` with ``gamma_n = n u / (1 - n u)`` and ``u = 2^-24``, or
    within rtol 1e-6 where that is larger (the bound rejects the rows of
    the next eps row and of the next component's factor), as many rows as
    the power-of-two bucket of the valid rows (the step's
    fevals: 384 of 576 rows at the first step, so 512, padded with row 0;
    fewer once samples are reused), and the states match leaf by leaf
    (integers exact, floats within rtol 1e-4 / atol 1e-5), the rows
    outside the bucket zero."""
    jg, tg, jfn, tfn = _host_pair()
    assert not tg.target_distribution.safe_for_jit
    buckets = []
    for step in range(3):
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            jax_state_leaves(jg.state), device="cpu", like=tg.state)
        draws = jax_step_draws(jg)
        fevals = int(jg.state.db.num_samples_written)
        rows, bound, others = _handed_rows_bound(jg, draws)
        jg.train_iter()
        tg.train_iter(draws)
        fevals = int(jg.state.db.num_samples_written) - fevals
        assert len(jfn.calls) == len(tfn.calls) == step + 1
        got, want = tfn.calls[-1], jfn.calls[-1]
        assert got.dtype == want.dtype == np.float32
        buckets.append(got.shape[0])
        assert got.shape == want.shape == (1 << (fevals - 1).bit_length(),
                                           6)
        bar = np.maximum(bound, 1e-6 * np.abs(want))
        assert np.all(np.abs(got.astype(np.float64) - want) <= bar), \
            np.max(np.abs(got.astype(np.float64) - want) / bar)
        for other in others:       # the bar tells apart rows off by a draw
            assert not np.all(np.abs(other[rows] - want) <= bar)
        assert_states_match(gmmvi_tpu_torch.state_to_numpy(tg.state),
                            jax_state_leaves(jg.state), rtol=1e-4,
                            atol=1e-5)
    assert buckets[0] == 512 and min(buckets) < 512


def test_host_target_bucket_keeps_the_last_copy_of_row_zero():
    """A host target whose values differ call by call and row by row: the
    port's scatter keeps, for row 0, the last of its padded copies, as
    JAX's scatter does on the CPU, and zeros outside the valid rows."""
    from gmmvi_tpu_torch.experiments.targets.talos_ik import HostLNPDF
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    def counting(x):
        return (np.arange(len(x), dtype=np.float32),
                np.tile(np.arange(len(x), dtype=np.float32)[:, None],
                        (1, x.shape[1])))

    g = GMMVI.__new__(GMMVI)
    g.target_distribution = HostLNPDF(2, lambda x: counting(x)[0], counting)
    g.estimator_type = "Stein"
    valid = torch.zeros(16, dtype=torch.bool)
    valid[[0, 3, 4, 9, 10]] = True
    samples = torch.randn(16, 2, generator=torch.Generator().manual_seed(0))
    lnp, grads = g._eval_valid_rows(samples, valid)
    want = np.zeros(16, np.float32)
    want[[3, 4, 9, 10]] = [1, 2, 3, 4]
    want[0] = 7                      # the last of the bucket's 8 rows
    np.testing.assert_array_equal(lnp.numpy(), want)
    np.testing.assert_array_equal(grads.numpy(), np.tile(want[:, None],
                                                         (1, 2)))


def test_host_target_without_gradients_raises_as_jax():
    """Without a gradient callable, ``log_density_and_grad`` raises
    NotImplementedError with JAX's message; ``log_density`` returns
    float32 on the samples' device."""
    from gmmvi_tpu.experiments.targets.talos_ik import HostLNPDF as JHost
    from gmmvi_tpu_torch.experiments.targets.talos_ik import \
        HostLNPDF as THost

    fn = _Gaussian(3)
    jt, tt = JHost(3, fn.log_density), THost(3, fn.log_density)
    assert not tt.safe_for_jit
    x = np.random.RandomState(0).standard_normal((5, 3))
    with pytest.raises(NotImplementedError) as jerr:
        jt.log_density_and_grad(jnp.asarray(x))
    with pytest.raises(NotImplementedError) as terr:
        tt.log_density_and_grad(_t(x))
    assert str(terr.value) == str(jerr.value)
    ld = tt.log_density(_t(x, torch.float64))
    assert ld.dtype == torch.float32 and ld.device.type == "cpu"
    np.testing.assert_array_equal(ld.numpy(), np.asarray(
        jt.log_density(jnp.asarray(x.astype(np.float32)))))


# ---------------------------------------------------------------------------
# SAMTRON on talos
# ---------------------------------------------------------------------------

@pytest.fixture
def _one_test_at_a_time(tmp_path_factory):
    with xdist_lock(tmp_path_factory, "tests"):
        yield


def _small_talos(pkg_cfg):
    """talos's SAMTRON defaults at D = 34 with 8 slots and 16 fresh (32
    reused) samples a component."""
    return pkg_cfg.update_config(
        pkg_cfg.get_default_config("SAMTRON", "talos"),
        {"sample_selector_config": {"desired_samples_per_component": 16},
         "tpu": {"max_components": 8}})


def test_talos_steps_match_jax_leaf_by_leaf(_one_test_at_a_time):
    """talos's SAMTRON defaults (one component, reuse 2.0; 8 slots, 16
    samples a component) built by both packages: two steps from JAX's
    state carried across with JAX's draws injected, both in float64 (the
    initial state cast exactly, JAX under ``jax.enable_x64``); integer
    leaves exact, float leaves within rtol 1e-4 / atol 1e-5.  In float32
    the first step's factors part by 1.6 times that bar (an entry of
    5.6e-4 off by 1.6e-5): the stored gradients are autograd of log
    densities of 1e3-1e4, and the trust-region update amplifies their
    rounding."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    jc = _small_talos(jcfg)
    jt, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)
    tc = _small_talos(tcfg)
    tt, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    assert tt.get_num_dimensions() == 34 and tt.safe_for_jit
    port_target_to_float64(tt)
    with jax.enable_x64(True):
        jg.target_distribution = jax_target_in_float64(jt)
        jg.state = jax_state_from_leaves(
            jg.state, as_float64(jax_state_leaves(jg.state)))
    for _ in range(2):
        with jax.enable_x64(True):
            tg.state = gmmvi_tpu_torch.state_from_numpy(
                jax_state_leaves(jg.state), device="cpu", like=tg.state)
            draws = jax_step_draws(jg, dtype=jnp.float64)
            jg.train_iter()
            j_named = jax_state_leaves(jg.state)
        tg.train_iter(draws)
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        assert t_named["model.means"].dtype == np.float64
        assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def test_talos_runner_steps_on_the_cpu():
    """``GmmviRunner.build_from_config(get_default_config("SAMTRON",
    "talos"))`` at its full widths on the CPU (D = 34, one component in 24
    slots, 100 fresh samples): two iterations with an evaluation at 0 whose
    ELBO is finite and, where matplotlib imports, whose stick figure
    passes through the runner's output."""
    import math

    tr = gmmvi_tpu_torch.GmmviRunner.build_from_config(
        tcfg.get_default_config("SAMTRON", "talos"), device="cpu")
    assert tr.gmmvi.model.max_components == 24
    out = tr.iterate_and_log(0)
    assert out["num_samples"] == 100 and math.isfinite(out["-elbo"])
    try:
        import matplotlib.pyplot as plt
    except Exception:
        assert "plot" not in out
    else:
        assert "plot" in out
        plt.close("all")
    out = tr.iterate_and_log(1)
    assert "-elbo" not in out and out["num_samples"] > 100
