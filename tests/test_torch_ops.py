"""The PyTorch port's ops against the JAX package: stable reductions, the
density kernels' plain versions (B1, B2) and the trust-region KL's (B3).

On a CPU tensor every kernel wrapper runs its plain version; these tests
hold that version against the JAX function, both its XLA path and its
Pallas kernel in interpret mode, at the bars the Pallas kernels meet in
tests/test_pallas_kernels.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gmmvi_tpu_torch.ops import density as tdens
from gmmvi_tpu_torch.ops import stable as tstable
from gmmvi_tpu_torch.ops import trust_region as ttr

torch.set_num_threads(2)

F32_MAX = 3.4028234663852886e38


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# ops/stable (rtol 1e-6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_masked_logsumexp_and_softmax_match_jax(axis):
    from gmmvi_tpu.ops import stable as jstable

    rng = np.random.RandomState(0)
    a = (rng.randn(7, 9) * 30).astype(np.float32)
    mask = rng.rand(7, 9) > 0.4
    mask[2, :] = False          # an all-masked row
    mask[:, 3] = False          # and column
    for keep in (False, True):
        got = tstable.masked_logsumexp(_t(a), mask=_t(mask), dim=axis,
                                       keepdim=keep).numpy()
        want = np.asarray(jstable.masked_logsumexp(
            jnp.asarray(a), mask=jnp.asarray(mask), axis=axis,
            keepdims=keep))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    got = tstable.masked_softmax(_t(a), mask=_t(mask), dim=axis).numpy()
    want = np.asarray(jstable.masked_softmax(jnp.asarray(a),
                                             mask=jnp.asarray(mask),
                                             axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    got = tstable.masked_logsumexp(_t(a)).numpy()
    want = np.asarray(jstable.masked_logsumexp(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_signed_weighted_logsumexp_matches_jax():
    from gmmvi_tpu.ops import stable as jstable

    rng = np.random.RandomState(1)
    log_w = (rng.randn(40, 3) * 20).astype(np.float32)
    values = rng.randn(40, 3).astype(np.float32)
    values[5] = 0.0
    mask = rng.rand(40, 3) > 0.2
    for m in (None, mask):
        got = tstable.signed_weighted_logsumexp(
            _t(log_w), _t(values), dim=0,
            mask=None if m is None else _t(m)).numpy()
        want = np.asarray(jstable.signed_weighted_logsumexp(
            jnp.asarray(log_w), jnp.asarray(values), axis=0,
            mask=None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# B1 / B2: density pack and densities (atol 5e-4)
# ---------------------------------------------------------------------------

def _padded_mixture(k, kmax, d, seed, offset=0.0):
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    rng = np.random.RandomState(seed)
    means = (rng.randn(k, d) * 3 + offset).astype(np.float32)
    a = rng.randn(k, d, d).astype(np.float32) * 0.3
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    js = jgmm.create_gmm_state(w, means, covs, max_components=kmax)
    ts = tgmm.create_gmm_state(w, means, covs, max_components=kmax,
                               device="cpu")
    x = (rng.randn(kmax * 37, d) * 2 + means[1]).astype(np.float32)
    return js, ts, x


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("k,kmax,d", [(11, 16, 5), (4, 6, 3)])
def test_density_pack_matches_jax(monkeypatch, mode, k, kmax, d):
    """Kernel B1's plain version against gmm.density_pack: the XLA path
    (mode 0) and the Pallas kernel in interpret mode."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    monkeypatch.setenv("GMMVI_FUSED_DENSITY", mode)
    js, ts, x = _padded_mixture(k, kmax, d, seed=k, offset=4.0)
    jp = jgmm.density_pack(js, jnp.asarray(x))
    tp = tgmm.density_pack(ts, _t(x))
    assert (jp.prec_times_diff is None) == (mode == "interpret")
    np.testing.assert_allclose(tp.component_log_densities.numpy()[:k],
                               np.asarray(jp.component_log_densities)[:k],
                               atol=5e-4)
    np.testing.assert_allclose(tp.model_log_densities.numpy(),
                               np.asarray(jp.model_log_densities), atol=5e-4)
    np.testing.assert_allclose(tp.model_grads.numpy(),
                               np.asarray(jp.model_grads), atol=5e-4)


@pytest.mark.parametrize("mode", ["0", "interpret"])
def test_log_densities_also_individual_matches_jax(monkeypatch, mode):
    """Kernel B2's plain version against gmm.log_densities_also_individual,
    and against the pack's own densities (the two passes agree)."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch.models import gmm as tgmm

    monkeypatch.setenv("GMMVI_FUSED_DENSITY", mode)
    k = 9
    js, ts, x = _padded_mixture(k, 12, 4, seed=3)
    jm, jc = jgmm.log_densities_also_individual(js, jnp.asarray(x))
    tm, tc = tgmm.log_densities_also_individual(ts, _t(x))
    np.testing.assert_allclose(tc.numpy()[:k], np.asarray(jc)[:k],
                               atol=5e-4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=5e-4)
    tp = tgmm.density_pack(ts, _t(x))
    np.testing.assert_allclose(tc.numpy(),
                               tp.component_log_densities.numpy(), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), tp.model_log_densities.numpy(),
                               atol=1e-6)


def test_density_all_masked_is_neg_inf():
    """Every slot masked: the mixture density is -inf, as
    masked_logsumexp gives, and the gradient is zero."""
    rng = np.random.RandomState(4)
    k, d, n = 3, 4, 10
    means = _t(rng.randn(k, d).astype(np.float32))
    inv = torch.eye(d).expand(k, d, d).contiguous()
    logw = torch.full((k,), -np.inf)
    ld = torch.zeros(k)
    x = _t(rng.randn(n, d).astype(np.float32))
    comp, model, grads = tdens.density_pack(means, inv, logw, ld, x)
    assert torch.isfinite(comp).all()
    assert torch.isneginf(model).all()
    assert torch.equal(grads, torch.zeros(n, d))


def test_density_wrappers_check_inputs():
    k, d, n = 3, 4, 10
    args = [torch.zeros(k, d), torch.eye(d).expand(k, d, d).contiguous(),
            torch.zeros(k), torch.zeros(k), torch.zeros(n, d)]
    bad_shape = list(args)
    bad_shape[1] = torch.zeros(k, d, d + 1)
    with pytest.raises(ValueError, match="inv_chols"):
        tdens.density_pack(*bad_shape)
    bad_dtype = list(args)
    bad_dtype[4] = torch.zeros(n, d, dtype=torch.float64)
    with pytest.raises(TypeError, match="samples"):
        tdens.densities(*bad_dtype)
    strided = list(args)
    strided[1] = torch.eye(d).expand(k, d, d)   # a broadcast view
    with pytest.raises(ValueError, match="inv_chols is not contiguous"):
        tdens.density_pack(*strided)
    big = [torch.zeros(1, 129), torch.zeros(1, 129, 129), torch.zeros(1),
           torch.zeros(1), torch.zeros(2, 129)]
    with pytest.raises(NotImplementedError, match="B5/B6"):
        tdens.density_pack(*big)


# ---------------------------------------------------------------------------
# B3: trust-region KL (rtol/atol 1e-5)
# ---------------------------------------------------------------------------

def _tr_problem(k, d, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(k, d).astype(np.float32) * 3
    a = rng.randn(k, d, d).astype(np.float32) * 0.4
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(d, dtype=np.float32)
    chols = np.linalg.cholesky(covs).astype(np.float32)
    inv_chols = np.stack([np.linalg.inv(c) for c in chols]).astype(
        np.float32)
    h = rng.randn(k, d, d).astype(np.float32) * 0.5
    # indefinite curvature, so small etas make the precision non-PD
    reward_quad = (np.einsum("kij,klj->kil", h, h)
                   - 0.3 * np.eye(d, dtype=np.float32)).astype(np.float32)
    reward_lin = rng.randn(k, d).astype(np.float32)
    return rng, (means, chols, inv_chols, reward_lin, reward_quad)


@pytest.mark.parametrize("k,d", [(7, 5), (13, 8)])
def test_tr_kl_matches_jax_kernel(k, d):
    """B3's plain version against batched_tr_kl (Pallas, interpret mode):
    the same KL, and F32_MAX for eta <= 0 and for non-PD precisions."""
    from gmmvi_tpu.ops import pallas_trust_region as jptr

    rng, prob = _tr_problem(k, d, seed=d)
    packed = jptr.prepare_tr_kl_inputs(*[jnp.asarray(p) for p in prob])
    inp = ttr.prepare_tr_kl_inputs(*[_t(p) for p in prob])
    n_inf = 0
    for scale in (0.5, 2.0, 50.0):
        etas = (rng.uniform(0.3, 1.0, k) * scale).astype(np.float32)
        etas[0] = 0.0 if scale == 2.0 else etas[0]
        etas[1] = -1.0 if scale == 50.0 else etas[1]
        want = np.asarray(jptr.batched_tr_kl(jnp.asarray(etas), packed, d=d,
                                             interpret=True))
        got = ttr.tr_kl(_t(etas), inp).numpy()
        inf = want > 1e37
        n_inf += int(inf.sum())
        np.testing.assert_array_equal(got >= F32_MAX, inf)
        np.testing.assert_allclose(got[~inf], want[~inf], rtol=1e-5,
                                   atol=1e-5)
    assert n_inf > 2  # eta <= 0 and non-PD precisions were exercised


def test_tr_kl_wrapper_checks_inputs():
    _, prob = _tr_problem(3, 4, seed=0)
    inp = ttr.prepare_tr_kl_inputs(*[_t(p) for p in prob])
    with pytest.raises(ValueError, match="etas"):
        ttr.tr_kl(torch.ones(4), inp)
    with pytest.raises(TypeError, match="etas"):
        ttr.tr_kl(torch.ones(3, dtype=torch.float64), inp)
    strided = inp._replace(prec=inp.prec.mT)
    with pytest.raises(ValueError, match="prec is not contiguous"):
        ttr.tr_kl(torch.ones(3), strided)


def test_tril_inverse_matches_jax():
    from gmmvi_tpu.ops.blocked_linalg import tril_inverse as j_inv
    from gmmvi_tpu_torch.ops.blocked_linalg import tril_inverse as t_inv

    _, (_, chols, *_rest) = _tr_problem(5, 7, seed=2)
    np.testing.assert_allclose(t_inv(_t(chols)).numpy(),
                               np.asarray(j_inv(jnp.asarray(chols))),
                               rtol=1e-5, atol=1e-6)
