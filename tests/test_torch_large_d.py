"""The PyTorch port's large-D path against the JAX package: the K-tiled
density passes (kernels B5 and B6, plain versions), the background above
D = 128 (B5's mixture output), the Stein second moments (B7, plain
version) and the estimator's dispatch to them, the whitened trust-region
update for D > 64, and SAMTRON with sample reuse at D = 136 one step at a
time (in float64 on both sides) and over a trajectory, with JAX's draws
injected.

The JAX side runs its Pallas kernels in interpret mode with float32
matrix products (``MATMUL_MODE = "f32"``, the mode its own tests hold at
1e-5), so both packages take the same routes: the K-tiled density stream,
the streamed Stein moments and, above D = 64, the XLA bracket with the
whitened per-trip KL.
"""
import math
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (as_float64, assert_states_match, build_pair,
                          jax_state_from_leaves, jax_state_leaves,
                          jax_step_draws, jax_target_in_float64, mc_elbo,
                          port_target_to_float64, xdist_lock)

import gmmvi_tpu_torch
from gmmvi_tpu_torch.models import gmm as tgmm
from gmmvi_tpu_torch.ops import background as tbg
from gmmvi_tpu_torch.ops import density_large as tdl
from gmmvi_tpu_torch.ops import stein as tstein

torch.set_num_threads(2)

# the reuse run: D 136 > 128 (B5/B6), Kmax 8 with 4 initial components, 40
# fresh and 80 reused samples per component (a window of 960 >= 512: B7)
DIMS, KMAX, K0, N_DES, RATIO, ADD_ITERS = 136, 8, 4, 40, 2.0, 10
TRAJ_ITERS = 25


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(autouse=True)
def _one_test_at_a_time(tmp_path_factory):
    """This file's tests run one at a time across pytest-xdist workers
    (``torch_parity.xdist_lock``)."""
    with xdist_lock(tmp_path_factory, "tests"):
        yield


@pytest.fixture
def f32_kernels(monkeypatch):
    from gmmvi_tpu.ops import pallas_density

    monkeypatch.setattr(pallas_density, "MATMUL_MODE", "f32")


# ---------------------------------------------------------------------------
# B5 and B6: K-tiled densities and gradients (the Pallas test's bars)
# ---------------------------------------------------------------------------

def _large_case(k, d, n):
    """The inputs of tests/test_pallas_kernels.py's large-D density test:
    k components padded by 3 masked slots, samples around the first mean."""
    from gmmvi_tpu.models import gmm as jgmm

    rng = np.random.RandomState(d)
    w = rng.rand(k).astype(np.float32) + 0.1
    mu = (rng.randn(k, d) * 3).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.1
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    js = jgmm.create_gmm_state(w / w.sum(), mu, covs, max_components=k + 3)
    x = (rng.randn(n, d) * 2 + mu[0]).astype(np.float32)
    logdets = np.sum(np.log(np.abs(np.diagonal(
        np.asarray(js.chols), axis1=-2, axis2=-1))), -1)
    logw = np.where(np.asarray(js.mask), np.asarray(js.log_weights), -np.inf)
    args = (np.asarray(js.means), np.asarray(js.inv_chols),
            logw.astype(np.float32), logdets.astype(np.float32), x)
    return js, args


@pytest.mark.parametrize("k,d,n", [(9, 130, 600), (150, 33, 600)])
def test_large_density_plain_matches_jax(f32_kernels, k, d, n):
    """B5 and B6's plain versions against the interpret-mode K-tiled
    kernels and the XLA density pack: comp and model rtol 2e-4 / atol
    2e-3, grads rtol / atol 2e-3; the mixture output alone equals
    B5's."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.ops.pallas_density_large import (
        fused_component_densities_large, fused_density_pack_large)

    js, args = _large_case(k, d, n)
    targs = [_t(a) for a in args]
    comp, model, grads = tdl.density_pack_large(*targs)
    jargs = [jnp.asarray(a) for a in args]
    kcomp, kmodel, kgrads = fused_density_pack_large(*jargs, interpret=True)
    xla = jgmm.density_pack(js, jnp.asarray(args[4]))
    for want_comp, want_model, want_grads in (
            (kcomp, kmodel, kgrads),
            (xla.component_log_densities, xla.model_log_densities,
             xla.model_grads)):
        np.testing.assert_allclose(comp.numpy()[:k], np.asarray(want_comp)[:k],
                                   rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(model.numpy(), np.asarray(want_model),
                                   rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(grads.numpy(), np.asarray(want_grads),
                                   rtol=2e-3, atol=2e-3)
    c2, m2 = tdl.densities_large(*targs)
    jc2, jm2 = fused_component_densities_large(*jargs, interpret=True)
    np.testing.assert_allclose(c2.numpy()[:k], np.asarray(jc2)[:k],
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), rtol=2e-4,
                               atol=2e-3)
    assert torch.equal(tdl.mixture_logpdf_large(*targs), m2)
    assert torch.equal(tdl.density_grads_large(*targs[:3], comp, model,
                                               targs[4]), grads)


def test_large_density_wrappers_check_inputs():
    d = 513
    big = [torch.zeros(1, d), torch.eye(d)[None].contiguous(), torch.zeros(1),
           torch.zeros(1), torch.zeros(2, d)]
    with pytest.raises(NotImplementedError, match="D <= 512"):
        tdl.densities_large(*big)
    with pytest.raises(NotImplementedError, match="B6"):
        tdl.density_grads_large(*big[:3], torch.zeros(1, 2), torch.zeros(2),
                                big[4])
    small = [torch.zeros(1, 4), torch.eye(4)[None].contiguous(),
             torch.zeros(1)]
    with pytest.raises(ValueError, match="comp"):
        tdl.density_grads_large(*small, torch.zeros(2, 2), torch.zeros(2),
                                torch.zeros(2, 4))


@pytest.mark.parametrize("d,large", [(128, False), (129, True), (300, True)])
def test_density_dispatch_by_dimension(monkeypatch, d, large):
    """density_pack, log_densities_also_individual and
    component_log_densities_fast route D <= 128 to B1/B2 and 128 < D <= 512
    to B5/B6, whatever K (the JAX package also sends small D with a large
    K to its K-tiled kernels; the port's B1/B2 take any K)."""
    from gmmvi_tpu_torch.ops import density as tdens

    calls = []
    for module, name in ((tdens, "density_pack"), (tdens, "densities"),
                         (tdl, "density_pack_large"),
                         (tdl, "densities_large")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n)
                            or _fn(*a))
    rng = np.random.RandomState(0)
    state = tgmm.create_gmm_state(np.ones(2) / 2, rng.randn(2, d),
                                  np.stack([np.eye(d)] * 2),
                                  max_components=3, device="cpu")
    x = _t(rng.randn(5, d).astype(np.float32))
    tgmm.density_pack(state, x)
    tgmm.log_densities_also_individual(state, x)
    tgmm.component_log_densities_fast(state, x)
    want = (["density_pack_large"] + ["densities_large"] * 3 if large
            else ["density_pack"] + ["densities"] * 2)
    assert calls == want


# ---------------------------------------------------------------------------
# The background above D = 128: B5's mixture output
# ---------------------------------------------------------------------------

def test_background_above_128_matches_jax():
    """At D = 136 with half the rows masked, against the interpret-mode
    background kernel (rtol 1e-4 / atol 2e-4, B4's bar); with every row
    masked the port gives -inf where JAX's kernel gives its large negative
    float."""
    from gmmvi_tpu.ops.pallas_density import _BIG_NEG, fused_background_logpdf

    u, d, n = 12, 136, 520
    rng = np.random.RandomState(11)
    means = (rng.randn(u, d) * 3).astype(np.float32)
    a = rng.randn(u, d, d).astype(np.float32) * 0.05
    covs = np.einsum("uij,ulj->uil", a, a) + np.eye(d, dtype=np.float32)
    chols = np.linalg.cholesky(covs)
    inv_chols = np.linalg.inv(chols).astype(np.float32)
    log_dets = np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)),
                      -1).astype(np.float32)
    log_w = np.log(rng.dirichlet(np.ones(u))).astype(np.float32)
    log_w[rng.permutation(u)[:u // 2]] = -np.inf
    x = (means[rng.randint(0, u, n)]
         + rng.randn(n, d).astype(np.float32)).astype(np.float32)
    args = [means, inv_chols, log_w, log_dets, x]
    got = tbg.background_logpdf(*[_t(v) for v in args]).numpy()
    want = np.asarray(fused_background_logpdf(
        *[jnp.asarray(v) for v in args], interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(got, tdl.mixture_logpdf_large_plain(
        *[_t(v) for v in args]).numpy(), rtol=0, atol=0)

    args[2] = np.full(u, -np.inf, np.float32)
    got = tbg.background_logpdf(*[_t(v) for v in args]).numpy()
    want = np.asarray(fused_background_logpdf(
        *[jnp.asarray(v) for v in args], interpret=True))
    assert np.isneginf(got).all()
    assert (want <= 0.5 * _BIG_NEG).all()


# ---------------------------------------------------------------------------
# B7: Stein second moments (rtol / atol 1e-5, the f32 kernel's bar)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,d,n", [(5, 70, 700), (9, 130, 600)])
def test_stein_smom_plain_matches_jax(k, d, n):
    from gmmvi_tpu.ops.pallas_stein import fused_stein_smom

    rng = np.random.RandomState(3)
    w = rng.rand(k, n).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    g = rng.randn(n, d).astype(np.float32)
    xc = rng.randn(n, d).astype(np.float32)
    got = tstein.stein_smom(_t(w), _t(g), _t(xc)).numpy()
    want = np.asarray(fused_stein_smom(jnp.asarray(w), jnp.asarray(g),
                                       jnp.asarray(xc), interpret=True,
                                       mm="f32"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.einsum("kn,nd,ne->kde", w, g, xc),
                               rtol=1e-5, atol=1e-5)


def _stein_case():
    """The inputs of tests/test_pallas_kernels.py's fused Stein estimate
    test (k 6, n 900, D 96)."""
    rng = np.random.RandomState(7)
    k, n, d = 6, 900, 96
    means = rng.randn(k, d).astype(np.float32) * 2 + 5.0
    a = rng.randn(k, d, d).astype(np.float32) * 0.05
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    x = (rng.randn(n, d) + 5.0).astype(np.float32)
    bg = rng.randn(n).astype(np.float32) - 4.0
    lnp = rng.randn(n).astype(np.float32)
    grads = rng.randn(n, d).astype(np.float32)
    mask = np.ones(n, bool)
    mapping = rng.randint(0, k, n).astype(np.int32)
    return (np.full(k, 1.0 / k, np.float32), means, covs), (
        x, mask, mapping, bg, lnp, grads)


def test_stein_estimate_matches_jax_fused_smom(monkeypatch, f32_kernels):
    """The port's estimate (B7's plain version) against JAX's with
    GMMVI_FUSED_STEIN=interpret, both from JAX's moment-form density pack:
    gradients rtol 1e-5 / atol 1e-6, Hessians rtol 1e-4 / atol 1e-5."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.optimization.ng_estimators import stein_estimate as jest
    from gmmvi_tpu_torch.optimization.ng_estimators import \
        stein_estimate as test

    (w, means, covs), window = _stein_case()
    js = jgmm.create_gmm_state(w, means, covs, max_components=6)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=6, device="cpu")
    monkeypatch.setenv("GMMVI_FUSED_STEIN", "interpret")
    pack = jgmm.density_pack(js, jnp.asarray(window[0])).replace(
        prec_times_diff=None)
    want = jest(js, *[jnp.asarray(v) for v in window], pack=pack)
    got = test(ts, *[_t(v) for v in window], pack=tgmm.DensityPack(
        _t(pack.component_log_densities), _t(pack.model_log_densities),
        _t(pack.model_grads)))
    np.testing.assert_allclose(got.expected_gradients_neg.numpy(),
                               np.asarray(want.expected_gradients_neg),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.expected_hessians_neg.numpy(),
                               np.asarray(want.expected_hessians_neg),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d,n,kernel", [(96, 900, True), (96, 511, False),
                                        (64, 900, False), (20, 900, False)])
def test_stein_estimate_dispatches_as_jax(monkeypatch, d, n, kernel):
    """B7 where pallas_stein.supports holds (64 < D <= 512, N >= 512), its
    plain version elsewhere, with the same moments either way."""
    from gmmvi_tpu.ops import pallas_stein
    from gmmvi_tpu_torch.optimization.ng_estimators import stein_estimate

    assert tstein.supports(d, n) == pallas_stein.supports(d, n) == kernel
    calls = []
    fn = tstein.stein_smom
    monkeypatch.setattr(tstein, "stein_smom",
                        lambda *a: calls.append(1) or fn(*a))
    rng = np.random.RandomState(d + n)
    ts = tgmm.create_gmm_state(np.ones(3) / 3, rng.randn(3, d),
                               np.stack([np.eye(d)] * 3), max_components=4,
                               device="cpu")
    window = [_t(rng.randn(n, d).astype(np.float32)), torch.ones(n, dtype=bool),
              torch.zeros(n, dtype=torch.int32),
              _t(rng.randn(n).astype(np.float32)), torch.zeros(n),
              _t(rng.randn(n, d).astype(np.float32))]
    est = stein_estimate(ts, *window)
    assert len(calls) == int(kernel)
    assert torch.isfinite(est.expected_hessians_neg[:3]).all()


# ---------------------------------------------------------------------------
# The trust-region update above D = 64: the whitened per-trip KL
# ---------------------------------------------------------------------------

def test_trust_region_update_whitened_matches_jax():
    """At D = 72 (past B3's envelope) against the JAX package's XLA bracket
    with the whitened KL: etas (meta.last_etas) and success masks equal,
    l2 regularizers and counters exact, updated components at rtol 1e-4 /
    atol 1e-5; one component infeasible at small eta, two without a warm
    start."""
    import gmmvi_tpu.optimization.component_updaters as jcu
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu.models import meta as jmeta
    from gmmvi_tpu_torch.models import meta as tmeta
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    k, kmax, d = 5, 8, 72
    rng = np.random.RandomState(3)
    means = (rng.randn(k, d) * 3).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.1
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=kmax)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=kmax,
                               device="cpu")
    jm = jmeta.create_meta_state(js, 0.01, 1e-12, 10)
    tm = tmeta.create_meta_state(ts, 0.01, 1e-12, 10)
    last = np.array([5.0, -1.0, 20.0, -1.0, 2.0, -1.0, -1.0, -1.0],
                    np.float32)
    jm = jm.replace(last_etas=jnp.asarray(last))
    tm = tm.replace(last_etas=_t(last))
    h = rng.randn(kmax, d, d).astype(np.float32) * 0.05
    hneg = np.einsum("kij,klj->kil", h, h) + 0.05 * np.eye(d, dtype=np.float32)
    hneg[1] -= 2.0 * np.eye(d, dtype=np.float32)  # infeasible at small eta
    gneg = rng.randn(kmax, d).astype(np.float32)
    steps = np.full(kmax, 0.05, np.float32)
    jr = jcu.trust_region_update(js, jm, jnp.asarray(hneg),
                                 jnp.asarray(gneg), jnp.asarray(steps))
    before = cuda.LAUNCHES["tr_kl"]
    tr = tcu.trust_region_update(ts, tm, _t(hneg), _t(gneg), _t(steps))
    assert cuda.LAUNCHES["tr_kl"] == before   # no B3 above D = 64
    etas, jetas = tr.meta.last_etas.numpy(), np.asarray(jr.meta.last_etas)
    np.testing.assert_array_equal(etas > 0, jetas > 0)
    assert (etas[:k] > 0).sum() >= 3
    np.testing.assert_allclose(etas, jetas, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tr.meta.l2_regularizers.numpy(),
                                  np.asarray(jr.meta.l2_regularizers))
    np.testing.assert_array_equal(tr.meta.num_received_updates.numpy(),
                                  np.asarray(jr.meta.num_received_updates))
    for name in ("log_weights", "means", "chols", "inv_chols"):
        np.testing.assert_allclose(getattr(tr.model, name).numpy(),
                                   np.asarray(getattr(jr.model, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_whitened_kl_equals_direct_kl():
    """The whitened per-trip KL equals B3's direct form (its plain version)
    up to float rounding, infeasible etas (F32_MAX) in the same places."""
    from gmmvi_tpu_torch.ops import trust_region as ttr
    from gmmvi_tpu_torch.optimization import component_updaters as tcu

    k, d = 6, 70
    g = torch.Generator().manual_seed(5)
    means = torch.randn(k, d, generator=g) * 3
    a = torch.randn(k, d, d, generator=g) * 0.1
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False)
    h = torch.randn(k, d, d, generator=g) * 0.05
    rq = h @ h.mT - 0.3 * torch.eye(d)
    rl = torch.randn(k, d, generator=g)
    etas = torch.tensor([1e-3, 0.1, 1.0, 10.0, 100.0, 1e4])
    direct = ttr.tr_kl_plain(etas, ttr.prepare_tr_kl_inputs(means, chols,
                                                            inv, rl, rq))
    whitened = tcu._tr_kl_whitened(etas, *tcu._tr_whitened_precompute(
        means, chols, inv, rl, rq))
    big = direct >= 3e38
    assert big.any() and not big.all()
    assert torch.equal(whitened >= 3e38, big)
    torch.testing.assert_close(whitened[~big], direct[~big], rtol=1e-3,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# SAMTRON with sample reuse at D = 136: one JAX run shared by the tests below
# ---------------------------------------------------------------------------

_RING = ("db.dist_chols", "db.dist_inv_chols")


def _share_ring_rows(named: dict, prev) -> dict:
    """``named`` with each distribution-ring array (64 x 8 x 136 x 136, 36
    MB) kept as a tuple of row copies, a row equal to the same row of
    ``prev`` kept as that object: consecutive states differ in one ring row,
    so the run's 26 states share ~90 rows instead of holding 26 rings."""
    out = dict(named)
    for key in _RING:
        before = prev[key] if prev is not None else [None] * len(named[key])
        out[key] = tuple(
            old if old is not None and np.array_equal(row, old) else row.copy()
            for row, old in zip(named[key], before))
    return out


def _leaves(named: dict) -> dict:
    """A state kept by :func:`_share_ring_rows` as its plain leaves."""
    return {k: np.stack(v) if k in _RING else v for k, v in named.items()}


def _jax_reuse_run(jg):
    """(states, draws) of TRAJ_ITERS steps of ``jg``, which ends at its last
    state: the states before every step and after the last, ring rows
    shared (:func:`_leaves` rebuilds one), and each step's draws."""
    leaves, draws = [], []
    for step in range(TRAJ_ITERS + 1):
        leaves.append(_share_ring_rows(jax_state_leaves(jg.state),
                                       leaves[-1] if leaves else None))
        if step < TRAJ_ITERS:
            draws.append(jax_step_draws(jg))
            jg.train_iter()
    return leaves, draws


@pytest.fixture(scope="module")
def reuse_run(tmp_path_factory):
    """A JAX SAMTRON run with sample reuse of TRAJ_ITERS steps at D = 136
    (:func:`_jax_reuse_run`), with the port's GMMVI built on the same target
    and initial mixture.  Under pytest-xdist each worker builds it holding
    the lock of :func:`_one_test_at_a_time`; the first makes the run and
    leaves it in the test run's shared temporary directory, the others load
    it (the run is this file's largest cost: interpret-mode kernels)."""
    from gmmvi_tpu.ops import pallas_density
    from gmmvi_tpu.utils.checkpoint import load_state, save_state

    with pytest.MonkeyPatch.context() as mp, \
            xdist_lock(tmp_path_factory, "tests") as base:
        mp.setenv("GMMVI_FUSED_DENSITY", "interpret")
        mp.setenv("GMMVI_FUSED_STEIN", "interpret")
        mp.setattr(pallas_density, "MATMUL_MODE", "f32")
        jg, tg = build_pair(dims=DIMS, ratio=RATIO, n_des=N_DES, kmax=KMAX,
                            k0=K0, add_iters=ADD_ITERS)
        if base is None:
            leaves, draws = _jax_reuse_run(jg)
        elif os.path.exists(f"{base}.large_d.pkl"):
            with open(f"{base}.large_d.pkl", "rb") as fh:
                leaves, draws = pickle.load(fh)
            jg.state = load_state(f"{base}.large_d.npz", jg.state)
        else:
            leaves, draws = _jax_reuse_run(jg)
            save_state(f"{base}.large_d.npz", jg.state)
            with open(f"{base}.large_d.pkl.tmp", "wb") as fh:
                pickle.dump((leaves, draws), fh)
            os.replace(f"{base}.large_d.pkl.tmp", f"{base}.large_d.pkl")
    return jg, tg, leaves, draws


def _port_state(tg, named):
    return gmmvi_tpu_torch.state_from_numpy(named, device="cpu",
                                            like=tg.state)


def test_reuse_run_takes_the_large_d_routes(reuse_run):
    """The run is the path this test file is about: D > 128, the window
    (960) inside B7's envelope, reuse on, VIPS adds at 10 and 20."""
    jg, tg, leaves, _ = reuse_run
    window = tg.selector_cfg.reused_samples_per_component * KMAX \
        + N_DES * KMAX
    assert DIMS > 128 and tstein.supports(DIMS, window)
    assert tg.selector_cfg.reused_samples_per_component == 80
    assert [int(n["model.num_active"]) for n in leaves[::10]] == [4, 5, 6]
    assert tg.state.db.ring_iters == jg.state.db.ring_iters == 64


@pytest.fixture(scope="module")
def float64_pair(tmp_path_factory):
    """A second (JAX, port) pair of the reuse run's config whose targets
    evaluate in float64 (:func:`torch_parity.jax_target_in_float64`,
    :func:`torch_parity.port_target_to_float64`); the JAX side takes its
    XLA routes (its Pallas kernels compute in float32)."""
    with xdist_lock(tmp_path_factory, "tests"):
        jg, tg = build_pair(dims=DIMS, ratio=RATIO, n_des=N_DES, kmax=KMAX,
                            k0=K0, add_iters=ADD_ITERS)
        with jax.enable_x64(True):
            jg.target_distribution = jax_target_in_float64(
                jg.target_distribution)
        port_target_to_float64(tg.target_distribution)
    return jg, tg


@pytest.mark.parametrize("start", range(TRAJ_ITERS))
def test_one_step_matches_jax_leaf_by_leaf(reuse_run, float64_pair, start):
    """One step from each of the JAX run's states, with both packages in
    float64 (the state's float32 leaves cast exactly, JAX under
    ``jax.enable_x64`` with its step's draws in float64): integer leaves
    exact, float leaves within rtol 1e-4 / atol 1e-5.

    In float32 the two packages' steps part by more than that bar from 14
    of these 25 states, and each misses it by about as much against this
    float64 step (log weights by up to 6.1 times on the port's side and
    6.4 on JAX's, the means up to 10.8 and 6.9): the Student-T's
    precisions at D = 136 magnify the fresh samples' rounding in the stored
    target gradients, the log weights of components near the 1e-30 floor
    follow sums of ~1e2 log ratios, and the trust-region update amplifies
    the Stein estimate's rounding (solving the new precision against a
    linear term of ~|Lambda mu|).  Which states miss follows the CPU's
    rounding; in float64 every state holds the bar by a wide margin."""
    _, _, leaves, _ = reuse_run
    jg, tg = float64_pair
    named = as_float64(_leaves(leaves[start]))
    with jax.enable_x64(True):
        jg.state = jax_state_from_leaves(jg.state, named)
        draws = jax_step_draws(jg, dtype=jnp.float64)
        jg.train_iter()
        j_named = jax_state_leaves(jg.state)
    tg.state = _port_state(tg, named)
    tg.train_iter(draws)
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    assert set(t_named) == set(j_named) - {"key"}
    assert t_named["model.means"].dtype == j_named["model.means"].dtype \
        == np.float64
    assert_states_match(t_named, j_named, rtol=1e-4, atol=1e-5)


def test_every_step_keeps_integers_and_etas(reuse_run):
    """One step from each of the run's start states: every integer leaf
    (fresh-sample counts from the ESS floors, ring heads, the component
    schedule) exact and the trust-region etas equal to float rounding, so
    each step's bisections took the same decisions as JAX's."""
    jg, tg, leaves, draws = reuse_run
    for start in range(TRAJ_ITERS):
        tg.state = _port_state(tg, _leaves(leaves[start]))
        tg.train_iter(draws[start])
        t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
        j_named = _leaves(leaves[start + 1])
        for name, want in j_named.items():
            if name != "key" and np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(t_named[name], want,
                                              err_msg=f"{start} {name}")
        np.testing.assert_allclose(t_named["meta.last_etas"],
                                   j_named["meta.last_etas"], rtol=1e-6,
                                   err_msg=str(start))


def test_trajectory_matches_jax(reuse_run):
    """TRAJ_ITERS iterations with JAX's draws injected every step: fevals
    within 0.5% (they are ESS floors, which float drift may move), the
    component counts within 2, the final ELBO within the Monte Carlo
    standard error of its estimate."""
    from gmmvi_tpu.models import gmm as jgmm

    jg, tg, leaves, draws = reuse_run
    tg.state = _port_state(tg, _leaves(leaves[0]))
    for dr in draws:
        tg.train_iter(dr)
    j_named = _leaves(leaves[-1])
    t_named = gmmvi_tpu_torch.state_to_numpy(tg.state)
    fe_t = int(t_named["db.num_samples_written"])
    fe_j = int(j_named["db.num_samples_written"])
    assert abs(fe_t - fe_j) <= 0.005 * fe_j, (fe_t, fe_j)
    assert abs(int(t_named["model.num_active"])
               - int(j_named["model.num_active"])) <= 2
    jm = jg.state.model
    tm = _port_state(tg, t_named).model

    def j_model(x):
        return np.asarray(jgmm.log_density(jm, jnp.asarray(x)))

    def t_model(x):
        return tgmm.log_density(tm, torch.as_tensor(x)).numpy()

    def j_target(x):
        return np.asarray(jg.target_distribution.log_density(x))

    (e_j, se), (e_t, _) = [
        mc_elbo(m, j_target, named["model.means"], named["model.chols"],
                named["model.log_weights"], int(named["model.num_active"]),
                with_se=True)
        for named, m in ((j_named, j_model), (t_named, t_model))]
    assert math.isfinite(e_t) and se > 0
    assert abs(e_j - e_t) < se, (e_j, e_t, se)
