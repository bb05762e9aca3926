"""The float32 error bounds ``chip_smoke.py`` holds a B1, B2, B3, B5 or B6
row to where the kernel misses its fixed bar, on the CPU: the plain
float32 versions stay within the bar plus the bound against float64 on
narrow components and samples far out in their tails, where the bar alone
is missed, and a result moved by more than its bound is refused; and the
rule that allows that form only where float32 itself misses the bar."""
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


@pytest.mark.parametrize("name", ["densities_large", "mixture_logpdf_large"])
def test_large_density_bound_holds_for_the_plain_version(name):
    """B5's bound (wine's rows, where the kernel misses its fixed bar): at
    D = 140 on narrow components with samples far out in their tails, the
    plain float32 version within B5's bar (atol 2e-3 + rtol 2e-4) plus s
    of float64 at every entry, s with the 3xTF32 products' roundings
    (``product_u=13``); an entry moved by twice its bar + s is
    refused."""
    from gmmvi_tpu_torch.ops import density_large as dl

    cs = _chip_smoke()
    args = _tail_mixture(d=140, n=800, seed=1)
    want = getattr(dl, name + "_plain")(*args)
    want = want if isinstance(want, tuple) else (want,)
    labels = ("comp", "model") if len(want) == 2 else ("model",)
    kw = dict(labels=labels, atol=2e-3, rtol=2e-4, product_u=13)
    out = cs.density_vs_float64(args, want, want, want, **kw)
    assert out["ok"] and out["places"] and out["equal_bits"], out
    assert set(out["against_float64"]) == set(labels)
    refs, bounds = cs.density_float64(args, False, product_u=13)
    named = dict(zip(("comp", "model"), zip(refs, bounds)))
    for i, label in enumerate(labels):
        bad = [t.clone() for t in want]
        ref, bound = named[label]
        j = int(torch.isfinite(ref).view(-1).nonzero()[0])
        r, b = float(ref.view(-1)[j]), float(bound.view(-1)[j])
        bad[i].view(-1)[j] = r + 2 * (2e-3 + 2e-4 * abs(r) + b)
        assert not cs.density_vs_float64(args, bad, bad, want, **kw)["ok"]


def test_large_grads_bound_holds_for_the_plain_version():
    """B6's bound (wine's row, where the kernel misses its fixed bar): at
    D = 140 on narrow components with samples far out in their tails (log
    densities down to ~-1e7, whose float32 rounding moves the
    responsibilities), the plain float32 version within B6's bar (atol and
    rtol 2e-3) plus s of float64 at every entry; an entry moved by twice
    its bar + s is refused."""
    from gmmvi_tpu_torch.ops import density_large as dl

    cs = _chip_smoke()
    means, inv, logw, logdets, x = _tail_mixture(d=140, n=800, seed=1)
    comp, model = dl.densities_large_plain(means, inv, logw, logdets, x)
    args = [means, inv, logw, comp, model, x]
    want = dl.density_grads_large_plain(*args)
    out = cs.large_grads_vs_float64(args, want, want)
    assert out["ok"] and out["worst_over_bound"] <= 1.0, out
    ref, bound, determined = cs.grads_float64(args)
    assert int(determined.sum()) > 400
    i = int(determined.nonzero()[0])
    bad = want.clone()
    r, b = float(ref[i, 0]), float(bound[i, 0])
    bad[i, 0] = r + 2 * (2e-3 + 2e-3 * abs(r) + b)
    assert not cs.large_grads_vs_float64(args, bad, want)["ok"]


def test_large_grads_bound_leaves_out_undetermined_samples():
    """Samples whose log densities reach ~1e9 (one unit in the last place
    of float32 ~64) have responsibilities no float32 arithmetic fixes:
    ``grads_float64`` marks them undetermined and the comparison leaves
    them out (counting them), but still refuses a non-finite value
    there."""
    from gmmvi_tpu_torch.ops import density_large as dl

    cs = _chip_smoke()
    means, inv, logw, logdets, _ = _tail_mixture(d=140, n=400, seed=2)
    g = torch.Generator().manual_seed(2)
    x = means[torch.arange(400) % 4] \
        + 1e-3 * torch.randn(400, 140, generator=g)
    x[:5] = means[0] + 3e4                 # far out: log densities ~1e9
    comp, model = dl.densities_large_plain(means, inv, logw, logdets, x)
    assert float(model[:5].abs().min()) > 1e8
    args = [means, inv, logw, comp, model, x]
    want = dl.density_grads_large_plain(*args)
    _, _, determined = cs.grads_float64(args)
    assert not bool(determined[:5].any()) and bool(determined[5:].all())
    out = cs.large_grads_vs_float64(args, want, want)
    assert out["ok"] and out["undetermined_samples"] == 5, out
    bad = want.clone()
    bad[0, 0] = math.inf
    assert not cs.large_grads_vs_float64(args, bad, want)["ok"]


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


@pytest.mark.parametrize("kernel,plain,within,passes", [
    (0, 0, True, True),       # the kernel meets the bar against float64
    (3, 5, True, True),       # float32 itself misses it: the bound decides
    (1, 0, True, False),      # only the kernel misses, the plain one meets
    (0, 2, False, False),     # past the bound
    (4, 4, False, False),
])
def test_float64_form_only_where_float32_misses_the_bar(kernel, plain,
                                                        within, passes):
    """``float64_form_ok``: a row held against float64 within bar + s
    passes only if the kernel meets the bar there itself, or the float32
    plain version misses it too; per output (B1, B2, B5) the counts are
    summed over the outputs."""
    cs = _chip_smoke()
    check = {"ok": within, "beyond_bar": kernel, "plain_beyond_bar": plain}
    assert cs.float64_form_ok(check) is passes
    outputs = {"comp": {"beyond_bar": 0, "plain_beyond_bar": 0},
               "grads": {"beyond_bar": kernel, "plain_beyond_bar": plain}}
    assert cs.float64_form_ok({"ok": within}, outputs) is passes
