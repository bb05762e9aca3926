"""The split-TF32 arithmetic of kernels B5 and B7 (csrc/tf32x3.cuh),
emulated in plain PyTorch on the CPU and held against float64.

The kernels split a float32 a into hi = tf32(a) (round to nearest, ties
away from zero: ``cvt.rna.tf32.f32``) and lo = tf32(a - hi), take a
product as hi hi' + hi lo' + lo hi' (each exact in float32: two 11-bit
significands), sum a slab of 32 reduction steps in float32 and add each
slab's sum into a float32 total.  The emulation below does the same; the
tests show that at stm300's magnitudes both kernels stay inside their bars
against float64 with room to spare, and that one TF32 product (hi hi')
would miss B7's bar and take most of B5's: the reason for the three.
"""
import numpy as np
import pytest
import torch

SLAB = 32           # reduction steps per slab (tf32x3::KS)
B5_RTOL, B5_ATOL = 2e-4, 2e-3
B7_BAR = 1e-5       # of each component's largest |entry|


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
