"""The arithmetic of kernels B1/B2 (``gmmvi_tpu_torch/csrc/density.cu``)
carried out in torch float32 on the CPU, in the kernel's order, against the
plain version run in float64.

The kernel streams the slots once: slot group g of a block (4 groups in
the unrolled instances, 1, 2 or 4 in the run-time one) takes slots g,
g + groups, ... in order and keeps per sample the running max m, the
rescaled sum s and, for the gradient, the rescaled accumulator
a = sum_k exp(w_k - m) L_k^T y_k, both scaled by exp(m_old - m_new) where m
grows; the groups' (m, s, a) are then combined in group order.  Bar:
atol 5e-4 + rtol 1e-5 on every output, the kernels' bar on the card.
"""
import math

import numpy as np
import pytest
import torch

from gmmvi_tpu_torch.ops.density import density_pack_plain

torch.set_num_threads(2)
LOG_2PI = math.log(2.0 * math.pi)
ATOL, RTOL = 5e-4, 1e-5


def stream(means, inv_chols, log_weights, log_dets, x, groups):
    """(comp, model, grads) in float32, in the kernel's order."""
    k, d = means.shape
    n = x.shape[0]
    inf = torch.tensor(math.inf)
    cst = -log_dets - 0.5 * d * LOG_2PI
    comp = torch.empty(k, n)
    m = torch.full((groups, n), -math.inf)
    s = torch.zeros(groups, n)
    a = torch.zeros(groups, n, d)
    for kk in range(k):
        g = kk % groups
        y = (x - means[kk]) @ inv_chols[kk].T
        cv = -0.5 * (y * y).sum(1) + cst[kk]
        comp[kk] = cv
        w = cv + log_weights[kk]
        live = w > -inf
        grow = live & (w > m[g])
        sc = torch.where(grow, torch.exp(m[g] - w), 1.0)
        c = torch.where(grow, 1.0,
                        torch.where(live, torch.exp(w - m[g]), 0.0))
        m[g] = torch.where(grow, w, m[g])
        s[g] = s[g] * sc + c
        a[g] = a[g] * sc[:, None] + (c[:, None] * y) @ inv_chols[kk]
    mx = m.max(0).values
    share = torch.where(m > -inf, torch.exp(m - mx), 0.0)
    total = (s * share).sum(0)
    model = torch.where(total > 0, mx + torch.log(total), -inf)
    frac = torch.where(m > -inf, share / total, 0.0)
    grads = -(a * frac[..., None]).sum(0)
    return comp, model, grads


def mixture(rng, k, d, n, live, mean_scale, cov_scale):
    """``k`` slots of which the first ``live`` carry weight, main-path
    shaped (as chip_smoke.density_inputs: means ~ mean_scale, covariances
    cov_scale (A A^T / d + 0.2 I)), and ``n`` samples drawn from the live
    slots (from slot 0 where none is live)."""
    means = rng.standard_normal((k, d)) * mean_scale
    a = rng.standard_normal((k, d, d))
    covs = cov_scale * (a @ np.swapaxes(a, 1, 2) / d + 0.2 * np.eye(d))
    chols = np.linalg.cholesky(covs)
    inv_chols = np.tril(np.linalg.inv(chols))
    log_weights = np.full(k, -math.inf)
    log_weights[:live] = -math.log(max(live, 1))
    log_dets = np.log(np.diagonal(chols, axis1=1, axis2=2)).sum(1)
    of = rng.integers(0, max(live, 1), n)
    x = means[of] + np.einsum("nij,nj->ni", chols[of],
                              rng.standard_normal((n, d)))
    return [means, inv_chols, log_weights, log_dets, x]


CASES = {
    # the main path's magnitudes: 45 of 48 slots live
    "main_path": dict(k=48, d=20, n=300, live=45, mean_scale=100.0,
                      cov_scale=300.0),
    # components 1e4 apart with unit-scale covariances: every sample's
    # responsibilities but its own component's underflow to zero
    "far_apart": dict(k=12, d=7, n=200, live=12, mean_scale=1e4,
                      cov_scale=1.0),
    "one_live_slot": dict(k=48, d=20, n=150, live=1, mean_scale=100.0,
                          cov_scale=300.0),
    "all_masked": dict(k=9, d=5, n=60, live=0, mean_scale=3.0,
                       cov_scale=1.0),
}


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_density_pack_matches_plain_in_float64(case, groups):
    """The kernel's order in float32 against the plain version in float64:
    comp, model and grads within atol 5e-4 + rtol 1e-5; -inf models and
    zero gradients (no NaN) where every slot is masked."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    # the reference in float64 from the float32 inputs the kernel gets
    arrays = [torch.tensor(v, dtype=torch.float32)
              for v in mixture(rng, **CASES[case])]
    want = density_pack_plain(*[v.double() for v in arrays])
    got = stream(*arrays, groups=groups)
    for name, g, w in zip(("comp", "model", "grads"), got, want):
        assert g.shape == w.shape, name
        assert not torch.isnan(g).any(), name
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)), name
        fin = torch.isfinite(w)
        torch.testing.assert_close(g[fin].double(), w[fin], atol=ATOL,
                                   rtol=RTOL, msg=name)
    if case == "all_masked":
        assert torch.isneginf(got[1]).all()
        assert bool((got[2] == 0).all())
    if case == "far_apart":
        # the responsibilities underflow: a sample's own component alone
        # carries it
        resp = torch.exp(want[0] + arrays[2].double()[:, None]
                         - want[1][None, :])
        assert bool(((resp > 0).sum(0) == 1).all())
