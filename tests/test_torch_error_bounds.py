"""The float32 error bounds ``chip_smoke.py`` holds the paper paths' B1, B2
and B3 rows to, on the CPU: the plain float32 versions stay within the
bar plus the bound against float64 on narrow components and samples far
out in their tails, where the bar alone is missed, and a result moved by
more than its bound is refused."""
import math
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _narrow(k, d, seed):
    """Lower triangular factors of ``k`` covariances with eigenvalues over
    five decades (1e-5 to 1) in random bases, and their inverses."""
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(k, d, d, generator=g,
                                       dtype=torch.float64))
    ev = 10.0 ** (torch.rand(k, d, generator=g, dtype=torch.float64) * 5 - 5)
    covs = q @ torch.diag_embed(ev) @ q.mT
    chols = torch.linalg.cholesky(0.5 * (covs + covs.mT))
    inv = torch.linalg.solve_triangular(
        chols, torch.eye(d, dtype=torch.float64).expand(k, d, d), upper=False)
    return q, ev, chols.float(), inv.float()


def _tail_mixture(k=6, d=8, n=3000, seed=0):
    """B1's inputs: ``k`` narrow components, two slots masked, and samples
    near the means and far out (log densities down to ~-1e7)."""
    g = torch.Generator().manual_seed(seed)
    _, _, chols, inv = _narrow(k, d, seed)
    means = torch.randn(k, d, generator=g)
    logw = torch.log_softmax(torch.randn(k, generator=g), 0)
    logw[-2:] = -math.inf
    log_dets = torch.sum(torch.log(torch.diagonal(inv, dim1=-2, dim2=-1)), -1)
    scale = 10.0 ** (torch.rand(n, 1, generator=g) * 3 - 2)
    x = means[torch.arange(n) % (k - 2)] \
        + torch.randn(n, d, generator=g) * scale
    return [means, inv, logw, -log_dets, x]


@pytest.mark.parametrize("name", ["density_pack", "densities"])
def test_density_bound_holds_for_the_plain_version(name):
    """The plain float32 version of B1 or B2 within bar + s of float64 at
    every entry, though its gradient misses the bar alone; an entry moved
    by twice its bar + s is refused."""
    from gmmvi_tpu_torch.ops import density as dops

    cs = _chip_smoke()
    args = _tail_mixture()
    want = getattr(dops, name + "_plain")(*args)
    out = cs.density_vs_float64(args, want, want, want)
    assert out["ok"] and out["places"] and out["equal_bits"], out
    for label, o in out["against_float64"].items():
        assert o["worst_over_bound"] <= 1.0 and o["entries"] > 0, label
    if name == "density_pack":
        assert out["against_float64"]["grads"]["beyond_bar"] > 0
    refs, bounds = cs.density_float64(args, name == "density_pack")
    for i in range(len(want)):
        bad = [t.clone() for t in want]
        flat = bad[i].view(-1)
        j = int(torch.isfinite(refs[i]).view(-1).nonzero()[0])
        r, s = float(refs[i].view(-1)[j]), float(bounds[i].view(-1)[j])
        flat[j] = r + 2 * (5e-4 + 1e-5 * abs(r) + s)
        assert not cs.density_vs_float64(args, bad, bad, want)["ok"], i


def _narrow_search(k=48, d=10):
    """A bracket search's inputs on narrow components: precisions of
    condition number up to 1e5 and rewards that nearly cancel them."""
    from gmmvi_tpu_torch.ops import trust_region as tops

    g = torch.Generator().manual_seed(3)
    q, ev, chols, inv = _narrow(k, d, 3)
    means = torch.randn(k, d, generator=g)
    h = torch.randn(k, d, d, generator=g)
    rq = -(q @ torch.diag_embed(
        torch.rand(k, d, generator=g, dtype=torch.float64) / ev) @ q.mT)
    rq = (0.5 * (rq + rq.mT)).float() + 0.1 * (h @ h.mT)
    rl = torch.randn(k, d, generator=g) * 100
    inp = tops.prepare_tr_kl_inputs(means, chols, inv, rl, rq)
    return (inp, 10.0 ** (torch.rand(k, generator=g) * 2 - 3),
            torch.full((k,), -20.0), torch.full((k,), 80.0),
            torch.ones(k, dtype=torch.bool))


@pytest.mark.parametrize("inputs", ["narrow", "synthetic"])
def test_kl_bound_holds_along_a_search(inputs):
    """B3's plain KL, at every eta a bracket search visits, within bar + s
    of float64, on narrow components and on ``chip_smoke``'s synthetic
    search; on the synthetic one (condition numbers up to ~1e2) the bound
    stays within a few bars; a KL moved by twice its bar + s is
    refused."""
    from gmmvi_tpu_torch.ops import trust_region as tops

    cs = _chip_smoke()
    args = (_narrow_search() if inputs == "narrow"
            else cs.tr_search_inputs("cpu"))
    out = cs.visited_kl_vs_float64(args)
    assert out["ok"] and out["evaluations"] > 100, out
    assert out["plain_worst_over_bound"] <= 1.0
    if inputs == "synthetic":
        assert out["bound_over_bar_median"] < 10, out

    plain = tops.tr_kl

    def off(etas, inp):
        kl = plain(etas, inp)
        _, s, _ = cs.kl_float64(etas, inp)
        moved = kl + 2 * (1e-4 + 1e-4 * kl.abs() + s.float())
        return torch.where(kl < 3e38, moved, kl)

    tops.tr_kl = off
    try:
        assert not cs.visited_kl_vs_float64(args)["ok"]
    finally:
        tops.tr_kl = plain
