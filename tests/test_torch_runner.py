"""The PyTorch port's runner path against the JAX package: the mixture
log-density (kernel B9's plain version), mixture sampling and marginals,
capacity growth (``repad``, ``repad_meta``, ``repad_db``), the GMM target,
the runner's metrics, MMD, a runner trajectory on ``gmm20`` at the verify
recipe's size that outgrows its padding, and checkpoints (resume, loading a
JAX checkpoint, structural mismatches).

Both packages get the same numpy inputs; where a function draws random
numbers, JAX's draws are injected into the port.
"""
import math
import os
import pickle

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
from gmmvi_tpu_torch.models import gmm as tgmm
from gmmvi_tpu_torch.models import meta as tmeta
from gmmvi_tpu_torch.ops import mixture_logpdf as tmix
from gmmvi_tpu_torch.optimization import sample_db as tdb

torch.set_num_threads(2)

# the verify recipe (.claude/skills/verify/SKILL.md) on gmm20, with a
# capacity of 4 slots so that VIPS outgrows it (4 -> 16 at iteration 15)
RECIPE = {
    "environment_config": {"num_dimensions": 5},
    "sample_selector_config": {"desired_samples_per_component": 24},
    "num_component_adapter_config": {"del_iters": 8, "add_iters": 5,
                                     "num_database_samples": 256},
    "gmmvi_runner_config": {"log_metrics_interval": 10},
}
RUN_ITERS = 31


@pytest.fixture(autouse=True)
def _one_test_at_a_time(tmp_path_factory):
    """Heavy port tests run one at a time across pytest-xdist workers."""
    with xdist_lock(tmp_path_factory, "tests"):
        yield


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _recipe_config(pkg_cfg, kmax):
    cfg = pkg_cfg.update_config(pkg_cfg.get_default_config("SAMTRON",
                                                           "gmm20"), RECIPE)
    return pkg_cfg.update_config(cfg, {"tpu": {"max_components": kmax}})


def _jax_runner(kmax):
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu import GmmviRunner

    r = GmmviRunner.build_from_config(_recipe_config(jcfg, kmax))
    r.target_distribution.make_plots = False
    return r


def _port_runner(kmax):
    r = gmmvi_tpu_torch.GmmviRunner.build_from_config(
        _recipe_config(tcfg, kmax), device="cpu")
    r.target_distribution.make_plots = False
    return r


# ---------------------------------------------------------------------------
# B9: the mixture log-density (the Pallas test's bar, rtol/atol 1e-4)
# ---------------------------------------------------------------------------

def _mixture(k, d, seed=0):
    """tests/test_pallas_kernels.py's mixture."""
    rng = np.random.RandomState(seed)
    means = rng.randn(k, d).astype(np.float32) * 2
    a = rng.randn(k, d, d).astype(np.float32) * 0.3
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    chols = np.linalg.cholesky(covs)
    inv_chols = np.linalg.inv(chols).astype(np.float32)
    log_dets = np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)),
                      axis=-1).astype(np.float32)
    lw = rng.dirichlet(np.ones(k)).astype(np.float32)
    return means, inv_chols, np.log(lw), log_dets


def _b9_case(case):
    if case == "masked":   # test_pallas_kernels.py's masked case
        means, inv_chols, log_w, log_dets = _mixture(6, 4, seed=2)
        log_w[4:] = -np.inf
        log_w[:4] -= np.log(np.exp(log_w[:4]).sum())
        samples = np.random.RandomState(3).randn(40, 4).astype(np.float32)
        return means, inv_chols, log_w, log_dets, samples
    k, d, n = case
    means, inv_chols, log_w, log_dets = _mixture(k, d)
    samples = (np.random.RandomState(1).randn(n, d) * 2).astype(np.float32)
    return means, inv_chols, log_w, log_dets, samples


@pytest.mark.parametrize("case", [(3, 5, 70), (17, 20, 600), "masked",
                                  (48, 20, 2000), (5, 136, 300)])
def test_mixture_logpdf_plain_matches_jax(case):
    """B9's wrapper (its plain version here; B5's above D = 128) against
    the JAX package's XLA path and its interpret-mode Pallas kernel."""
    from gmmvi_tpu.ops.pallas_kernels import (_plain_mixture_logpdf,
                                              fused_mixture_logpdf)

    args = _b9_case(case)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(_plain_mixture_logpdf(*jargs))
    fused = np.asarray(fused_mixture_logpdf(*jargs, interpret=True))
    got = tmix.mixture_logpdf(*[_t(a) for a in args]).numpy()
    plain = tmix.mixture_logpdf_plain(*[_t(a) for a in args]).numpy()
    assert got.shape == (args[4].shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, fused, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, plain)


def test_mixture_logpdf_all_masked_and_envelope():
    """-inf where every slot is masked (as the JAX XLA path gives); D > 512
    raises: the port's kernels stop there, the JAX kernel pads any D."""
    means, inv_chols, log_w, log_dets, x = _b9_case((3, 5, 70))
    log_w[:] = -np.inf
    got = tmix.mixture_logpdf(*[_t(a) for a in (means, inv_chols, log_w,
                                                log_dets, x)])
    assert torch.isneginf(got).all()
    d = 513
    with pytest.raises(NotImplementedError, match="D <= 512"):
        tmix.mixture_logpdf(torch.zeros(2, d),
                            torch.eye(d).expand(2, d, d).contiguous(),
                            torch.zeros(2), torch.zeros(2), torch.zeros(3, d))


def test_log_density_keeps_the_cpu_arithmetic():
    """On the CPU ``log_density`` gives the bits of the formula it had
    before B9 (component densities then ``masked_logsumexp``), so the CPU
    trajectories that hold component schedules equal are unchanged."""
    from gmmvi_tpu_torch.ops.stable import masked_logsumexp

    means, inv_chols, log_w, log_dets, x = _b9_case((17, 20, 600))
    covs = np.linalg.inv(np.einsum("kji,kjl->kil", inv_chols, inv_chols))
    st = tgmm.create_gmm_state(np.exp(log_w), means, covs, max_components=20,
                               device="cpu")
    xs = _t(x)
    before = masked_logsumexp(
        tgmm.component_log_densities(st, xs) + st.log_weights[:, None],
        mask=st.mask[:, None], dim=0)
    assert torch.equal(tgmm.log_density(st, xs), before)
    assert torch.equal(tgmm.density(st, xs), torch.exp(before))


# ---------------------------------------------------------------------------
# Sampling, marginals, repad
# ---------------------------------------------------------------------------

def _state_pair(k=5, d=4, kmax=8, seed=3):
    from gmmvi_tpu.models import gmm as jgmm

    rng = np.random.RandomState(seed)
    w = rng.rand(k).astype(np.float32) + 0.1
    mu = (rng.randn(k, d) * 3).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.5
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    js = jgmm.create_gmm_state(w / w.sum(), mu, covs, max_components=kmax)
    ts = tgmm.GmmState(
        log_weights=_t(js.log_weights), means=_t(js.means),
        chols=_t(js.chols), inv_chols=_t(js.inv_chols),
        num_active=_t(js.num_active, torch.int32))
    return js, ts


def test_sample_matches_jax_with_injected_draws():
    """``sample`` with JAX's component draws and normals: the sorted
    mapping equal, the samples within 1e-5."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.ops.stable import NEG_INF

    js, ts = _state_pair()
    key = jax.random.PRNGKey(4)
    smp, mapping = jgmm.sample(js, key, 700)
    k_key, n_key = jax.random.split(key)
    comp = jax.random.categorical(
        k_key, jnp.where(js.mask, js.log_weights, NEG_INF), shape=(700,))
    eps = jax.random.normal(n_key, (700, js.num_dimensions), jnp.float32)
    got, got_map = tgmm.sample(ts, 700, comp=_t(comp), eps=_t(eps))
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(mapping))
    np.testing.assert_allclose(got.numpy(), np.asarray(smp), rtol=1e-5,
                               atol=1e-5)
    # the port's own draws: sorted, active slots only, finite
    x, m = tgmm.sample(ts, 300, torch.Generator().manual_seed(0))
    assert x.shape == (300, 4) and torch.isfinite(x).all()
    assert torch.equal(m, torch.sort(m).values) and int(m.max()) < 5


def test_marginal_log_density_matches_jax():
    from gmmvi_tpu.models import gmm as jgmm

    js, ts = _state_pair()
    x = (np.random.RandomState(5).randn(400, 4) * 4).astype(np.float32)
    for dim in range(4):
        want = np.asarray(jgmm.marginal_log_density(js, jnp.asarray(x), dim))
        got = tgmm.marginal_log_density(ts, _t(x), dim).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The JAX runner's run at the recipe's size, shared by the tests below
# ---------------------------------------------------------------------------

def _jax_run():
    """RUN_ITERS iterations of the JAX runner from 4 slots: each step's
    draws (at the capacity the step grew to first) and, at an evaluation,
    the evaluation's draws; the state before every step and after the last;
    every step's output."""
    jr = _jax_runner(kmax=4)
    draws, leaves, outputs = [], [], []
    for n in range(RUN_ITERS):
        key, eval_key = jr.gmmvi.state.key, jr._eval_key
        leaves.append(jax_state_leaves(jr.gmmvi.state))
        outputs.append(jr.iterate_and_log(n))
        draws.append((jax_step_draws(
            jr.gmmvi, key=key, kmax=jr.gmmvi.state.model.max_components),
            jax_eval_draws(eval_key, jr.gmmvi.state.model)
            if n % jr.log_metrics_interval == 0 else None))
    leaves.append(jax_state_leaves(jr.gmmvi.state))
    for out in outputs:
        out.pop("walltime")
    return jr, draws, leaves, outputs


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """:func:`_jax_run`, made once per test run: under pytest-xdist the
    first worker leaves it (and the JAX runner's final state, as a JAX
    checkpoint) in the run's shared temporary directory, the others load
    it."""
    from gmmvi_tpu.utils.checkpoint import load_state, save_state

    with xdist_lock(tmp_path_factory, "tests") as base:
        if base is not None and os.path.exists(f"{base}.runner.pkl"):
            with open(f"{base}.runner.pkl", "rb") as fh:
                draws, leaves, outputs = pickle.load(fh)
            jr = _jax_runner(kmax=4)
            jr.gmmvi.grow_capacity(int(leaves[-1]["model.log_weights"]
                                       .shape[0]))
            jr.gmmvi.state = load_state(f"{base}.runner.npz", jr.gmmvi.state)
        else:
            jr, draws, leaves, outputs = _jax_run()
            if base is not None:
                save_state(f"{base}.runner.npz", jr.gmmvi.state)
                with open(f"{base}.runner.pkl.tmp", "wb") as fh:
                    pickle.dump((draws, leaves, outputs), fh)
                os.replace(f"{base}.runner.pkl.tmp", f"{base}.runner.pkl")
    return jr, draws, leaves, outputs


def _growth_step(leaves):
    kmax = [int(named["model.log_weights"].shape[0]) for named in leaves]
    return next(i for i in range(len(kmax) - 1) if kmax[i + 1] > kmax[i])


def test_repad_matches_jax_exactly(jax_run, tmp_path):
    """``repad``, ``repad_meta`` and ``repad_db`` on the JAX run's state
    just before it outgrew its 4 slots, leaf by leaf and exactly."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.models import meta as jmeta
    from gmmvi_tpu.optimization import sample_db as jdb
    from gmmvi_tpu.optimization import sample_selectors as jsel
    from gmmvi_tpu.utils.checkpoint import load_state

    jr, _, leaves, _ = jax_run
    named = leaves[_growth_step(leaves)]
    assert int(named["model.num_active"]) == 4
    assert int(named["db.write_pos"]) > 0
    kmax = 16
    new_cap = jsel.total_window_size(jr.gmmvi.selector_cfg, kmax)
    tr = _port_runner(kmax=4)
    ts = gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                          like=tr.gmmvi.state)
    path = str(tmp_path / "before.npz")
    np.savez(path, __format_version__=np.asarray(2),
             **{f"leaf::{k}": v for k, v in named.items()})
    js = load_state(path, _jax_runner(kmax=4).gmmvi.state)
    j_new = js.replace(model=jgmm.repad(js.model, kmax),
                       meta=jmeta.repad_meta(js.meta, kmax),
                       db=jdb.repad_db(js.db, kmax, new_cap))
    t_new = gmmvi_tpu_torch.TrainState(
        model=tgmm.repad(ts.model, kmax), meta=tmeta.repad_meta(ts.meta, kmax),
        db=tdb.repad_db(ts.db, kmax, new_cap), wstep=ts.wstep,
        adapt=ts.adapt, num_updates=ts.num_updates)
    j_named = jax_state_leaves(j_new)
    t_named = gmmvi_tpu_torch.state_to_numpy(t_new)
    assert t_named["db.samples"].shape[0] == new_cap
    for name, got in t_named.items():
        want = j_named[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# the sample ring's integers follow the fresh-sample counts
_RING_COUNTS = ("db.sample_iter", "db.sample_comp", "db.write_pos",
                "db.num_samples_written", "db.res_count")


def test_every_step_keeps_integers(jax_run):
    """One step from each of the JAX run's states with that step's draws:
    the component schedule, the capacity growth at iteration 15 and every
    other integer leaf equal to the JAX step's, and the fresh-sample count
    equal in all but a few steps, never off by more than one per component.
    The counts are floors of ESS values, and here many sit on an integer in
    exact arithmetic (24.999998 and 10.999999 at iteration 26, where the
    port takes one sample fewer than JAX): their floors follow the last bit
    of two sums taken in different orders."""
    _, draws, leaves, _ = jax_run
    tr = _port_runner(kmax=4)
    off = 0
    for n in range(RUN_ITERS):
        tr.gmmvi.grow_capacity(int(leaves[n]["model.log_weights"].shape[0]))
        tr.gmmvi.state = gmmvi_tpu_torch.state_from_numpy(
            leaves[n], device="cpu", like=tr.gmmvi.state)
        tr.gmmvi.train_iter(draws[n][0])
        got = gmmvi_tpu_torch.state_to_numpy(tr.gmmvi.state)
        want = leaves[n + 1]
        for name, val in want.items():
            if name != "key" and name not in _RING_COUNTS \
                    and np.issubdtype(val.dtype, np.integer):
                np.testing.assert_array_equal(got[name], val,
                                              err_msg=f"{n} {name}")
        fresh = [int(named["db.num_samples_written"])
                 - int(leaves[n]["db.num_samples_written"])
                 for named in (got, want)]
        assert abs(fresh[0] - fresh[1]) <= int(want["model.num_active"]), n
        off += fresh[0] != fresh[1]
    assert off <= 3, off


def _jax_run_float64():
    """RUN_ITERS iterations of the JAX runner from 4 slots in float64 (under
    ``jax.enable_x64``, its initial state cast exactly, its target
    evaluated in float64): each step's output, capacity after the step and
    draws (in float64) and, at an evaluation, the evaluation's draws."""
    with jax.enable_x64(True):
        jr = _jax_runner(kmax=4)
        target = jax_target_in_float64(jr.target_distribution)
        jr.target_distribution = jr.gmmvi.target_distribution = target
        jr.gmmvi.state = jax_state_from_leaves(
            jr.gmmvi.state, as_float64(jax_state_leaves(jr.gmmvi.state)))
        draws, outputs, kmax = [], [], []
        for n in range(RUN_ITERS):
            # copies: the step donates the state's buffers
            key = jnp.asarray(np.asarray(jr.gmmvi.state.key))
            eval_key = jnp.asarray(np.asarray(jr._eval_key))
            outputs.append(jr.iterate_and_log(n))
            model = jr.gmmvi.state.model
            kmax.append(model.max_components)
            draws.append((jax_step_draws(jr.gmmvi, key=key,
                                         kmax=model.max_components,
                                         dtype=jnp.float64),
                          jax_eval_draws(eval_key, model, jnp.float64)
                          if n % jr.log_metrics_interval == 0 else None))
    for out in outputs:
        out.pop("walltime")
    return draws, outputs, kmax


def test_runner_trajectory_matches_jax():
    """The port's runner against JAX's, both in float64, from the same
    config (gmm20 at the recipe's size, 4 slots) with JAX's step and
    evaluation draws injected: every step's component count, capacity (one
    growth, 4 -> 16 slots at iteration 15) and database sizes equal to the
    JAX runner's, each evaluation's ELBO within 1.0 and detected modes
    equal, and the fevals equal at every step up to the first step whose
    fresh-sample count differs.  That step may differ by one sample per
    active component, and later steps by no more than the fresh samples
    JAX drew since: the counts are floors of ESS values, which here often
    sit on an integer in exact arithmetic (25 and 11 at iteration 26), so
    their floors follow the last bit of sums taken in another order in
    any precision (test_every_step_keeps_integers holds every step's
    counts from JAX's own states), and once a floor differs the two runs
    hold different samples.

    In float32 the runs part from the first steps (~1e-5 of the means
    after 5 steps), and the first differing floor came as early as
    iteration 9: fevals then moved 4% apart by iteration 10 and 11% by
    iteration 15 on one x86 CPU, while another kept within 2% (1,346
    against 1,329 after 31 steps); in float64 they are equal up to the
    tie at iteration 26."""
    draws, outputs, kmax_j = _jax_run_float64()
    assert kmax_j.index(16) == 15 and sorted(set(kmax_j)) == [4, 16]
    tr = _port_runner(kmax=4)
    tr.gmmvi.state = gmmvi_tpu_torch.state_from_numpy(
        as_float64(gmmvi_tpu_torch.state_to_numpy(tr.gmmvi.state)),
        device="cpu", like=tr.gmmvi.state)
    port_target_to_float64(tr.target_distribution)
    tr.gmmvi.draw = lambda iteration: draws[iteration][0]
    metrics = tr.get_expensive_metrics
    tr.get_expensive_metrics = lambda: metrics(
        draws=draws[tr.gmmvi.num_updates - 1][1])
    evals, parted = 0, None
    for n in range(RUN_ITERS):
        got = tr.iterate_and_log(n)
        want = outputs[n]
        for key in ("num_components", "num_db_components"):
            assert got[key] == want[key], (n, key, got[key], want[key])
        assert tr.gmmvi.state.model.max_components == kmax_j[n], n
        assert tr.gmmvi.state.model.means.dtype == torch.float64
        off = abs(got["num_samples"] - want["num_samples"])
        if parted is None and off:
            parted = n
            assert off <= want["num_components"], (n, got, want)
        elif parted is not None:
            before = outputs[parted - 1]["num_samples"] if parted else 0
            assert off <= want["num_samples"] - before, (n, got, want,
                                                         parted)
        if "-elbo" in want:
            evals += 1
            assert math.isfinite(got["-elbo"])
            assert abs(got["-elbo"] - want["-elbo"]) < 1.0, (n, got, want)
            assert got["num_detected_modes"] == want["num_detected_modes"]
    assert evals == 4


def test_expensive_metrics_match_jax(jax_run):
    """``get_expensive_metrics`` from the JAX run's last state with the JAX
    runner's next 2,000 evaluation draws: ``-elbo``, ``entropy`` and
    ``target_density`` within 1e-4, ``num_detected_modes`` equal."""
    jr, _, leaves, _ = jax_run
    tr = _port_runner(kmax=4)
    tr.gmmvi.grow_capacity(int(leaves[-1]["model.log_weights"].shape[0]))
    tr.gmmvi.state = gmmvi_tpu_torch.state_from_numpy(
        leaves[-1], device="cpu", like=tr.gmmvi.state)
    draws = jax_eval_draws(jr._eval_key, jr.gmmvi.state.model)
    want = jr.get_expensive_metrics()
    got = tr.get_expensive_metrics(draws=draws)
    for key in ("-elbo", "entropy", "target_density"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert got["num_detected_modes"] == want["num_detected_modes"]
    assert set(got) == set(want)


def test_resume_is_exact_on_the_cpu(tmp_path):
    """Save after 18 iterations, load into a fresh runner (built with 4
    slots; the file's 16 are grown to first), then 13 more iterations in
    both: every leaf and every cheap metric equal to the bit."""
    a = _port_runner(kmax=4)
    for n in range(18):
        a.iterate_and_log(n)
    path = str(tmp_path / "ck.npz")
    a.save_checkpoint(path)
    b = _port_runner(kmax=4)
    b.load_checkpoint(path)
    assert b.gmmvi.state.model.max_components == \
        a.gmmvi.state.model.max_components
    for n in range(18, RUN_ITERS):
        oa, ob = a.iterate_and_log(n), b.iterate_and_log(n)
        for key in ("num_samples", "num_components", "max_weight"):
            assert oa[key] == ob[key], (n, key)
    assert a.gmmvi.state.model.max_components == 16
    sa = gmmvi_tpu_torch.state_to_numpy(a.gmmvi.state)
    sb = gmmvi_tpu_torch.state_to_numpy(b.gmmvi.state)
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


def test_jax_checkpoint_loads_leaf_equal(jax_run, tmp_path):
    """A checkpoint file of the JAX runner (grown to 16 slots) loads into a
    port runner built with 4: every leaf equal, the key ignored."""
    from gmmvi_tpu.utils.checkpoint import save_state

    jr, _, leaves, _ = jax_run
    path = str(tmp_path / "jax.npz")
    save_state(path, jr.gmmvi.state)
    tr = _port_runner(kmax=4)
    gen = tr.gmmvi.generator.get_state()
    tr.load_checkpoint(path)
    got = gmmvi_tpu_torch.state_to_numpy(tr.gmmvi.state)
    assert set(got) == set(leaves[-1]) - {"key"}
    for name, val in got.items():
        np.testing.assert_array_equal(val, leaves[-1][name], err_msg=name)
        assert val.dtype == leaves[-1][name].dtype, name
    assert torch.equal(tr.gmmvi.generator.get_state(), gen)
    tr.iterate_and_log(RUN_ITERS)


def test_checkpoint_rejects_structural_mismatch(tmp_path):
    """As the JAX package's checkpoints do: another capacity raises naming
    the shapes, other paths raise naming them, a file without a format
    version raises."""
    from gmmvi_tpu_torch.utils import checkpoint as ckpt

    a = _port_runner(kmax=8)
    a.iterate_and_log(0)
    path = str(tmp_path / "ck.npz")
    a.save_checkpoint(path)
    b = _port_runner(kmax=16)
    with pytest.raises(ValueError, match="shapes differ"):
        b.load_checkpoint(path)
    other = str(tmp_path / "other.npz")
    np.savez(other, __format_version__=np.asarray(2),
             **{"leaf::a": np.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch.*missing"):
        ckpt.load_state(other, a.gmmvi.state, device="cpu")
    plain = str(tmp_path / "plain.npz")
    np.savez(plain, a=np.zeros(3))
    with pytest.raises(ValueError, match="no format version"):
        a.load_checkpoint(plain)


# ---------------------------------------------------------------------------
# Targets and evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maker", ["make_target", "make_target_with_scale",
                                   "make_simple_target", "make_star_target"])
def test_gmm_target_matches_jax(maker):
    """The GMM targets from one seed: log-density within 1e-4; in float64
    on both sides (each target factored anew in float64 from the same
    float32 covariances, JAX under ``jax.enable_x64``) the log-density
    within 1e-4 and the gradients within B1's atol 5e-4 (rtol 1e-4);
    marginals within 1e-5, the detected modes of a model equal.

    The gradients are compared in float64 because in float32 both sides
    err by more than that bar on the star target against numpy's float64
    gradient of the same float32 parameters: JAX by up to 7.0e-3 (4.2
    times the bar), the port by up to 2.5e-3 (1.6 times), on gradients up
    to ~270.  Its precisions, diag(1, 100) rotated, give covariances of
    condition number 100, whose float32 factors carry rounding, and
    component log densities of ~-450 at these samples, so the
    responsibilities carry relative errors of ~3e-5 that multiply the
    components' opposing gradients; in float32 the two sides part by
    3.1e-3 on one of the 1,000 entries on one x86 CPU and stay within the
    bar on another.  In float64 both are within 1.3e-11 of numpy's."""
    from gmmvi_tpu.experiments.targets import gmm as jtg
    from gmmvi_tpu_torch.experiments.targets import gmm as ttg

    kw = {"make_target": dict(num_dimensions=20, seed=10000),
          "make_target_with_scale": dict(num_dimensions=6, num_components=4,
                                         scale=2.0, seed=3),
          "make_simple_target": {},
          "make_star_target": dict(num_components=5)}[maker]
    jt = getattr(jtg, maker)(**kw)
    tt = getattr(ttg, maker)(device="cpu", **kw)
    for name in ("target_weights", "target_means", "target_covs"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    d = tt.get_num_dimensions()
    rng = np.random.RandomState(7)
    x = (tt.target_means[rng.randint(0, len(tt.target_means), 500)]
         + rng.randn(500, d) * 3).astype(np.float32)
    np.testing.assert_allclose(tt.log_density(_t(x)).numpy(),
                               np.asarray(jt.log_density(x)), rtol=1e-4,
                               atol=1e-4)
    tt64 = getattr(ttg, maker)(device="cpu", **kw)
    port_target_to_float64(tt64)
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        jt64 = jax_target_in_float64(jt)
        jld, jgrads = [np.asarray(v) for v in
                       jt64.log_density_and_grad(jnp.asarray(x64))]
        jld2 = np.asarray(jt64.log_density(jnp.asarray(x64)))
    ld, grads = tt64.log_density_and_grad(_t(x64))
    assert grads.dtype == torch.float64 and jgrads.dtype == np.float64
    np.testing.assert_allclose(tt64.log_density(_t(x64)).numpy(), jld2,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), jld, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads.numpy(), jgrads, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(
        tt.marginal_log_density(_t(x), 1).numpy(),
        np.asarray(jt.marginal_log_density(x, 1)), rtol=1e-5, atol=1e-5)
    jt.make_plots = tt.make_plots = False
    js, ts = _state_pair(k=4, d=d, kmax=6, seed=1)
    ts = ts.replace(means=ts.means + _t(tt.target_means[:1]))
    js = js.replace(means=jnp.asarray(ts.means.numpy()))
    assert tt.expensive_metrics(ts, None) == jt.expensive_metrics(js, None)
    smp = tt.sample(64, torch.Generator().manual_seed(0))
    assert smp.shape == (64, d) and torch.isfinite(smp).all()


def test_target_registry_builds_ported_and_names_missing(monkeypatch):
    """The registry builds the GMM targets, the diagonal one too (held
    against JAX in test_torch_targets.py) and MNIST (on the synthetic
    stand-in, D = 101,770; held against JAX in test_torch_mnist.py), and
    names a target it does not know in a ValueError, as JAX does."""
    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    with pytest.raises(ValueError, match="unknown experiment name: MNIZT"):
        get_target_lnpdf("MNIZT", {}, 0, device="cpu")
    monkeypatch.setenv("GMMVI_ALLOW_SYNTHETIC", "1")
    t = get_target_lnpdf("MNIST", {"likelihood_scaling": 1.0,
                                   "prior_std": 1.0, "batch_size": 32}, 0,
                         device="cpu")
    assert t.get_num_dimensions() == 101770
    t = get_target_lnpdf("GMM", {"num_dimensions": 3}, 0, device="cpu")
    assert t.get_num_dimensions() == 3
    t = get_target_lnpdf("DIAGGMM", {"num_dimensions": 3}, 0, device="cpu")
    assert t.get_num_dimensions() == 3 and t._state.diagonal


def test_stm_marginals_sampling_and_metrics_match_jax():
    """The Student-T mixture's marginals within 1e-5 and its detected modes
    equal; its own draws are finite and spread like the target's."""
    from gmmvi_tpu.experiments.targets import student_t_mixture as jst
    from gmmvi_tpu_torch.experiments.targets import student_t_mixture as tst

    jt = jst.make_target(6, False, seed=2)
    tt = tst.make_target(6, False, seed=2, device="cpu")
    x = (np.random.RandomState(0).randn(300, 6) * 20).astype(np.float32)
    for dim in (0, 5):
        np.testing.assert_allclose(
            tt.marginal_log_density(_t(x), dim).numpy(),
            np.asarray(jt.marginal_log_density(x, dim)), rtol=1e-5,
            atol=1e-5)
    jt.make_plots = tt.make_plots = False
    js, ts = _state_pair(k=5, d=6, kmax=8, seed=4)
    means = ts.means.clone()
    means[:5] = _t(tt.target_means[:5]) + means[:5] * 0.1
    ts = ts.replace(means=means)
    js = js.replace(means=jnp.asarray(ts.means.numpy()))
    assert tt.expensive_metrics(ts, None) == jt.expensive_metrics(js, None)
    smp = tt.sample(4000, torch.Generator().manual_seed(1))
    assert smp.shape == (4000, 6) and torch.isfinite(smp).all()
    # heavy tails: the median distance to the nearest target mean is small
    near = torch.cdist(smp, _t(tt.target_means)).min(1).values
    assert float(near.median()) < 3.0


def test_mmd_matches_jax():
    from gmmvi_tpu.experiments.evaluation.mmd import MMD as JMMD
    from gmmvi_tpu_torch.experiments.evaluation.mmd import MMD as TMMD

    rng = np.random.RandomState(0)
    gt = rng.randn(600, 4).astype(np.float32)
    smp = (rng.randn(500, 4) * 1.2 + 0.3).astype(np.float32)
    jm, tm = JMMD(gt, 0.5), TMMD(gt, 0.5, device="cpu")
    np.testing.assert_allclose(tm.sigma.numpy(), np.asarray(jm.sigma),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.compute_MMD(_t(smp)), jm.compute_MMD(smp),
                               rtol=1e-5, atol=1e-5)


def test_runner_mmd_and_dumps(tmp_path):
    """MMD from ``mmd_evaluation_config`` and the npz dumps, as the JAX
    runner configures them."""
    gt = str(tmp_path / "gt.npy")
    np.save(gt, np.random.RandomState(0).randn(200, 5).astype(np.float32))
    cfg = tcfg.update_config(_recipe_config(tcfg, 8), {
        "mmd_evaluation_config": {"sample_dir": gt, "alpha": 1.0},
        "dump_gmm_path": str(tmp_path / "dumps")})
    r = gmmvi_tpu_torch.GmmviRunner.build_from_config(cfg, device="cpu")
    r.target_distribution.make_plots = False
    out = r.iterate_and_log(0)
    assert math.isfinite(out["MMD"]) and out["MMD"] >= 0.0
    r.log_to_disk(0)
    r.finalize()
    (run_dir,) = os.listdir(tmp_path / "dumps")
    names = sorted(os.listdir(tmp_path / "dumps" / run_dir))
    assert names == ["final_gmm_dump.npz", "gmm_dump_0.npz"]
    with np.load(tmp_path / "dumps" / run_dir / "gmm_dump_0.npz") as dump:
        assert dump["covs"].shape == (1, 5, 5)
        assert int(dump["fevals"]) == out["num_samples"]


def test_runner_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmmvi_tpu_torch.GmmviRunner.build_from_config(
            _recipe_config(tcfg, 8))
