"""The split-TF32 arithmetic of kernels B5-B8 (csrc/tf32x3.cuh),
emulated in plain PyTorch on the CPU and held against float64.

The kernels split a float32 a into hi = tf32(a) (round to nearest, ties
away from zero: ``cvt.rna.tf32.f32``) and lo = tf32(a - hi), take a
product as hi hi' + hi lo' + lo hi' (each exact in float32: two 11-bit
significands), sum a slab of 32 reduction steps in float32 and add each
slab's sum into a float32 total.  The emulation below does the same; the
tests show that at stm300's magnitudes the kernels stay inside their bars
against float64 with room to spare, and that one TF32 product (hi hi')
would miss B6's and B7's bars and take most of B5's: the reason for the
three.
"""
import numpy as np
import pytest
import torch

SLAB = 32           # reduction steps per slab (tf32x3::KS)
B5_RTOL, B5_ATOL = 2e-4, 2e-3
B6_RTOL, B6_ATOL = 2e-3, 2e-3
B7_BAR = 1e-5       # of each component's largest |entry|
B8_BAR = 2e-5       # of each component's largest |entry|, on the card


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit significand bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """``a @ b`` (float32, [..., M, S] @ [S, N]) as the kernels take it:
    per slab of SLAB reduction steps the TF32 products summed in float32,
    the slabs' sums added in float32; ``passes`` 3 (hi hi' + hi lo' +
    lo hi') or 1 (hi hi')."""
    ah, al = split(a)
    bh, bl = split(b)
    total = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float32)
    for s in range(0, a.shape[-1], SLAB):
        sl = slice(s, s + SLAB)
        part = ah[..., sl] @ bh[sl]
        if passes == 3:
            part = part + ah[..., sl] @ bl[sl] + al[..., sl] @ bh[sl]
        total = total + part
    return total


def test_tf32_rounding():
    """Ten significand bits kept, to nearest with ties away from zero; the
    split recovers a float32 to 2^-22 of its size."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-30,
                      0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)],
                        dtype=torch.float32)
    assert torch.equal(tf32(x)[:5], want)
    assert tf32(x)[6] == 0.0
    g = torch.Generator().manual_seed(0)
    a = torch.randn(10_000, generator=g) * 10.0 ** torch.randint(
        -5, 5, (10_000,), generator=g)
    hi, lo = split(a)
    assert torch.all((tf32(hi) == hi) & (tf32(lo) == lo))
    assert torch.all((hi - a).abs() <= 2.0 ** -11 * a.abs())
    assert torch.all(((hi + lo) - a).abs() <= 2.0 ** -22 * a.abs())


def _stein_inputs(k, n, d, seed):
    """B7 at stm300's magnitudes: dense softmax weights (overlapping
    components), |g| ~ 10, centred samples ~ 3."""
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n) * 3
    w = np.exp(w - w.max(0))
    w = (w / w.sum(0)).astype(np.float32)
    g = (rng.randn(n, d) * 10).astype(np.float32)
    xc = (rng.randn(n, d) * 3).astype(np.float32)
    return w, g, xc


@pytest.mark.parametrize("d", [72, 300])
def test_stein_moments_3xtf32_within_bar(d):
    """B7's moments (w_k o G)^T Xc emulated at D = 72 and 300, N = 2,048:
    within a tenth of the bar (1e-5 of each component's largest entry)
    against float64 (4.5e-7 at D = 300); one TF32 pass misses the bar
    (3.3e-4)."""
    w, g, xc = _stein_inputs(4, 2048, d, seed=d)
    truth = np.einsum("kn,nd,ne->kde", w.astype(np.float64),
                      g.astype(np.float64), xc.astype(np.float64))
    scale = np.abs(truth).reshape(4, -1).max(1)
    a = torch.as_tensor(w)[:, None, :] * torch.as_tensor(g).T[None]
    errs = {}
    for passes in (3, 1):
        got = product(a, torch.as_tensor(xc), passes).double().numpy()
        errs[passes] = (np.abs(got - truth).reshape(4, -1).max(1)
                        / scale).max()
    assert errs[3] <= 0.1 * B7_BAR, errs
    assert errs[1] > B7_BAR, errs


def test_density_3xtf32_within_bar():
    """B5's component log-densities emulated at D = 300, N = 512 with
    |x - mu| ~ 10 and factor entries ~ 1: within a tenth of the bar (rtol
    2e-4 / atol 2e-3) against float64 (1e-3 of it); one TF32 pass takes
    most of the bar (0.98 of it)."""
    d, n = 300, 512
    rng = np.random.RandomState(1)
    diff = (rng.randn(n, d) * 10).astype(np.float32)
    inv = np.tril(rng.randn(d, d)).astype(np.float32)
    inv[np.diag_indices(d)] = np.abs(inv[np.diag_indices(d)]) + 1.0
    logdet = float(np.sum(np.log(np.diag(inv.astype(np.float64)))))
    const = logdet - 0.5 * d * np.log(2 * np.pi)
    y64 = diff.astype(np.float64) @ inv.astype(np.float64).T
    truth = -0.5 * np.sum(y64 * y64, axis=1) + const
    worst = {}
    for passes in (3, 1):
        y = product(torch.as_tensor(diff),
                    torch.as_tensor(inv).T.contiguous(), passes)
        comp = (-0.5 * torch.sum(y * y, dim=1) + const).double().numpy()
        worst[passes] = np.max(np.abs(comp - truth)
                               / (B5_ATOL + B5_RTOL * np.abs(truth)))
    assert worst[3] <= 0.1, worst
    assert worst[1] > 0.5, worst


def test_density_grads_3xtf32_within_bar():
    """B6's mixture gradient -sum_k (r_k o (X - mu_k)) Lambda_k emulated at
    D = 40, N = 512 drawn from K = 4 far-apart narrow components (75% of
    the responsibilities underflow to zero, the rest span many decades, as
    on stm300), as the kernel takes it: mu subtracted and r folded into A
    before the split, Lambda_k (float64, rounded once, not symmetrized)
    split and read as B[e, d] = Lambda_k[d, e], a sum per 32-step slab added into one float32 total over the
    components in order.  Against float64 over the same float32 inputs:
    within a tenth of the bar (rtol and atol 2e-3; 8e-4 of it here); one
    TF32 pass misses the bar (3.6 times it)."""
    d, n, k = 40, 512, 4
    rng = np.random.RandomState(5)
    means = rng.randn(k, d) * 30.0
    a = rng.randn(k, d, d)
    chols = np.linalg.cholesky(0.01 * (a @ a.transpose(0, 2, 1) / d
                                       + np.eye(d)))
    inv = np.linalg.inv(chols)
    comp = rng.randint(0, k, n)
    x = means[comp] + np.einsum("nij,nj->ni", chols[comp], rng.randn(n, d))
    z = np.einsum("kij,knj->kni", inv, x[None] - means[:, None])
    log_comp = (-0.5 * (z ** 2).sum(-1)
                - np.log(np.diagonal(chols, axis1=1, axis2=2)).sum(1)[:, None])
    r = np.exp(log_comp - np.logaddexp.reduce(log_comp, axis=0)).astype(
        np.float32)
    assert 0.7 < (r == 0).mean() < 0.8
    # as precisions() forms it: L^T L in float64 from the float32 factor,
    # rounded once, not symmetrized
    inv32 = inv.astype(np.float32).astype(np.float64)
    lam = np.einsum("kji,kjl->kil", inv32, inv32).astype(np.float32)
    x32, mu32 = x.astype(np.float32), means.astype(np.float32)
    truth = -np.einsum("kn,kde,kne->nd", r.astype(np.float64),
                       lam.astype(np.float64),
                       x32[None].astype(np.float64)
                       - mu32[:, None].astype(np.float64))
    worst = {}
    for passes in (3, 1):
        total = torch.zeros(n, d, dtype=torch.float32)
        for kk in range(k):
            ah, al = split(torch.as_tensor(r[kk])[:, None]
                           * (torch.as_tensor(x32) - torch.as_tensor(
                               mu32[kk])))
            # B at (step e, column d) is Lambda[d, e], as the kernel reads
            bh, bl = split(torch.as_tensor(lam[kk]).T.contiguous())
            for s in range(0, d, SLAB):
                sl = slice(s, s + SLAB)
                part = ah[:, sl] @ bh[sl]
                if passes == 3:
                    part = part + ah[:, sl] @ bl[sl] + al[:, sl] @ bh[sl]
                total = total + part
        got = -total.double().numpy()
        worst[passes] = np.max(np.abs(got - truth)
                               / (B6_ATOL + B6_RTOL * np.abs(truth)))
    assert worst[3] <= 0.1, worst
    assert worst[1] > 1.0, worst


def _running_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as 3xTF32 wgmma without a separate per-slab sum: every
    8-step product (hi hi', hi lo', lo hi' in the kernel's issue order)
    added straight into one float32 accumulator."""
    ah, al = split(a)
    bh, bl = split(b)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s in range(0, a.shape[1], 8):
        sl = slice(s, s + 8)
        total = total + ah[:, sl] @ bh[sl]
        total = total + ah[:, sl] @ bl[sl]
        total = total + al[:, sl] @ bh[sl]
    return total


def test_more_gram_3xtf32_within_bar():
    """B8's Gram emulated at D = 20 (F = 231 features plus the y column)
    over a 3,000-sample window drawn from 4 far-apart components in random
    order, with self-normalized float32 importance weights, so that exp
    underflows 75% of the (component, sample) pairs to zeros scattered
    through the window (29% of the pairs carry weight on the reuse path),
    y on the reuse path's scale.  As the kernel takes it: each component's
    live samples in increasing order, three contiguous shares (the
    path's), slabs of 32, the weight folded into the row features before
    the split, the shares' sums added in order.  Against float64 over the
    same float32 whitened samples: within a tenth of the card's bar (2e-5
    of each component's largest entry) with the separate per-slab sum
    (2.0e-8 here) and without it (9.4e-8: this emulation rounds each
    addition to nearest, and the card's tensor-core accumulator across
    slabs errs far more, so the kernel keeps the per-slab sum); one TF32
    pass reaches 1.7e-5, 0.85 of the bar."""
    d, k, n, shares = 20, 4, 3000, 3
    rng = np.random.RandomState(6)
    means = rng.randn(k, d) * 45.0
    a = rng.randn(k, d, d)
    chols = np.linalg.cholesky(300.0 * (a @ a.transpose(0, 2, 1) / d
                                        + 0.2 * np.eye(d)))
    inv = np.linalg.inv(chols)
    comp = rng.randint(0, k, n)
    x = means[comp] + np.einsum("nij,nj->ni", chols[comp], rng.randn(n, d))
    y = rng.randn(n) * 20.0 - 0.5 * ((x / 100.0) ** 2).sum(1)
    z64 = np.einsum("kij,knj->kni", inv, x[None] - means[:, None])
    logdet = np.log(np.diagonal(chols, axis1=1, axis2=2)).sum(1)
    log_comp = -0.5 * (z64 ** 2).sum(-1) - logdet[:, None]
    log_iw = (log_comp - np.logaddexp.reduce(log_comp - np.log(k), axis=0)
              ).astype(np.float32)
    log_w = log_iw - np.logaddexp.reduce(log_iw.astype(np.float64), axis=1,
                                         keepdims=True).astype(np.float32)
    w = np.exp(log_w)
    w = w / w.sum(1, keepdims=True)
    assert 0.2 < (w == 0).mean() < 0.9

    x32, y32, inv32, mu32 = (torch.as_tensor(v.astype(np.float32))
                             for v in (x, y, inv, means))
    iu = torch.triu_indices(d, d)
    errs = {"3xtf32": 0.0, "running": 0.0, "1xtf32": 0.0}
    for kk in range(k):
        live = torch.as_tensor(np.nonzero(w[kk])[0])
        z = torch.einsum("ij,nj->ni", inv32[kk], x32[live] - mu32[kk])

        def features(z, yv):
            ones = torch.ones(len(z), 1, dtype=z.dtype)
            return torch.cat([(z[:, :, None] * z[:, None, :])[:, iu[0], iu[1]],
                              z, ones, yv[:, None]], 1)

        feats = features(z, y32[live])
        wk = torch.as_tensor(w[kk])[live]
        rows = wk[:, None] * feats
        f64 = features(z.double(), y32[live].double())
        truth = (wk.double()[:, None] * f64).T @ f64
        scale = float(truth.abs().max())
        nslab = -(-len(live) // SLAB)
        got = {name: torch.zeros(feats.shape[1], feats.shape[1])
               for name in errs}
        for s in range(shares):
            lo = nslab * s // shares * SLAB
            hi = nslab * (s + 1) // shares * SLAB
            at, b = rows[lo:hi].T.contiguous(), feats[lo:hi]
            got["3xtf32"] = got["3xtf32"] + product(at, b, 3)
            got["running"] = got["running"] + _running_product(at, b)
            got["1xtf32"] = got["1xtf32"] + product(at, b, 1)
        for name, g in got.items():
            errs[name] = max(errs[name],
                             float((g.double() - truth).abs().max()) / scale)
    assert errs["3xtf32"] <= 0.1 * B8_BAR, errs
    assert errs["running"] <= 0.1 * B8_BAR, errs
    assert errs["1xtf32"] > errs["3xtf32"] * 4, errs
