"""The port's CUDA kernels against their plain PyTorch versions, and the
main path on the card against the same path on the CPU.

These tests need an NVIDIA card (Hopper, since the kernels build for
sm_90a) and ``nvcc``; without them each skips.  On a machine with the card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gmmvi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _mixture(k, d, n, n_masked, seed):
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(k, d, generator=g) * 3
    a = torch.randn(k, d, d, generator=g) * 0.3
    covs = a @ a.mT + torch.eye(d)
    chols = torch.linalg.cholesky(covs)
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False).contiguous()
    logw = torch.log_softmax(torch.randn(k, generator=g), 0)
    logw[k - n_masked:] = -torch.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    x = torch.randn(n, d, generator=g) * 3
    return [means, inv, logw, logdets, x]


@pytest.mark.parametrize("k,d,n,n_masked", [
    (5, 3, 50, 2), (1, 1, 7, 0), (48, 20, 9600, 3), (100, 20, 333, 10),
    (7, 33, 129, 0), (3, 64, 64, 1), (2, 128, 40, 0), (4, 5, 31, 4)])
def test_density_kernels_match_plain(dev, k, d, n, n_masked):
    """B1 and B2 against their plain versions: atol 5e-4 plus rtol 1e-5
    (fp32 sums in another order); -inf where every slot is masked."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density as dops

    args = [t.to(dev) for t in _mixture(k, d, n, n_masked, seed=k + d)]
    before = dict(cuda.LAUNCHES)
    for fn, plain, name in ((dops.density_pack, dops.density_pack_plain,
                             "density_pack"),
                            (dops.densities, dops.densities_plain,
                             "densities")):
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        for gv, wv in zip(got, want):
            assert gv.shape == wv.shape
            torch.testing.assert_close(gv, wv, atol=5e-4, rtol=1e-5)
        assert cuda.LAUNCHES[name] == before[name] + 1


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _check_density(args):
    """B1 and B2 on ``args`` against their plain versions as
    ``chip_smoke.density_check`` holds them: atol 5e-4 + rtol 1e-5, NaN and
    +-inf in the same places, equal bits on a second call."""
    from gmmvi_tpu_torch.ops import density as dops

    for fn, plain in ((dops.density_pack, dops.density_pack_plain),
                      (dops.densities, dops.densities_plain)):
        got = fn(*args)
        again = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert [g.shape for g in got] == [w.shape for w in want]
        out = _chip_smoke().density_check(got, again, want)
        assert out["ok"], out


@pytest.mark.parametrize("d", range(1, 33))
def test_density_unrolled_instances(dev, d):
    """Every unrolled instance (D = 1..32) of B1 and B2 at a small ragged N,
    two of seven slots masked: within atol 5e-4 + rtol 1e-5 of the plain
    versions, equal bits on two calls."""
    _check_density([t.to(dev) for t in _mixture(7, d, 257, 2, seed=d)])


@pytest.mark.parametrize("d", [33, 100, 128])
def test_density_wide_instance_at_window_size(dev, d):
    """The run-time instance (33 <= D <= 128) at the reuse window's K = 48
    and N = 28,800, three slots masked."""
    _check_density([t.to(dev) for t in _mixture(48, d, 28800, 3, seed=d)])


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("n", [28800, 19200, 9600, 2400, 1])
def test_density_main_path_magnitudes_equal_bits(dev, n, scattered):
    """B1 and B2 at the main path's magnitudes (45 of 48 slots live,
    ``chip_smoke.density_inputs``) and its window sizes, down to N = 1,
    with the samples in slot order and scattered: within the bar, equal
    bits on two calls."""
    _check_density(_chip_smoke().density_inputs(dev, 20, n, seed=n,
                                                scattered=scattered))


@pytest.mark.parametrize("k,d,n,n_live", [
    (24, 31, 7200, 4), (24, 25, 7200, 4), (600, 10, 60000, 300)])
def test_density_at_the_paper_experiments_shapes(dev, k, d, n, n_live):
    """B1 and B2 at the shapes of the logistic-regression runs (D = 31 and
    25: the unrolled DK = 32 and 28 instances with zero-padded lanes, 24
    slots) and of planar_robot_4 (D = 10, 600 slots of which 300 are
    live): within the bar, -inf slots -inf, equal bits on two calls."""
    _check_density([t.to(dev) for t in _mixture(k, d, n, k - n_live,
                                                 seed=k + d)])


@pytest.mark.parametrize("n_live", [1, 12, 24])
def test_density_at_talos_shapes(dev, n_live):
    """B1 and B2 at talos's shapes: D = 34 (the run-time instance, 33 <= D
    <= 128), 24 slots of which ``n_live`` are live, the total window's
    N = 7,200: within the bar, -inf slots -inf, equal bits on two
    calls."""
    _check_density([t.to(dev) for t in _mixture(24, 34, 7200, 24 - n_live,
                                                seed=34 + n_live)])


@pytest.mark.parametrize("k,d", [(48, 20), (5, 1), (9, 6), (3, 64)])
def test_tr_kl_kernel_matches_plain(dev, k, d):
    """B3 against its plain version: F32_MAX in the same places (eta <= 0,
    non-PD precision), the KL within rtol/atol 1e-4 elsewhere."""
    from gmmvi_tpu_torch.ops import trust_region as tops

    g = torch.Generator().manual_seed(d)
    means = torch.randn(k, d, generator=g) * 3
    a = torch.randn(k, d, d, generator=g)
    chols = torch.linalg.cholesky(a @ a.mT / d + 0.5 * torch.eye(d))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False)
    h = torch.randn(k, d, d, generator=g) * 0.3
    rq = h @ h.mT - 0.5 * torch.eye(d)
    rl = torch.randn(k, d, generator=g)
    inp = tops.prepare_tr_kl_inputs(*[t.to(dev) for t in (means, chols, inv,
                                                          rl, rq)])
    etas = (10.0 ** (torch.rand(k, generator=g) * 6 - 3)).to(dev)
    etas[0] = 0.0
    if k > 1:
        etas[1] = -2.0
    got = tops.tr_kl(etas, inp)
    want = tops.tr_kl_plain(etas, inp)
    torch.cuda.synchronize()
    big = want >= 3e38
    assert torch.equal(got >= 3e38, big)
    torch.testing.assert_close(got[~big], want[~big], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [2, 20, 64])
def test_tr_search_kernel_equals_host_loop(dev, d):
    """B3's fused search (one launch) against the host loop around B3's
    per-trip kernel on the same inputs: exp(lower), exp(upper) and each
    component's trips equal to the bit, and on a second call; cold and
    warm starts, KL bounds over three decades, infeasible small etas, a
    bracket narrower than the width stop, inactive slots with NaN
    rewards (as MORE leaves them), K = 48."""
    _search_equals_host_loop(dev, 48, d)


def test_tr_search_at_planar_robot_width(dev):
    """The same at planar_robot_4's width: 600 blocks at D = 10, their
    trips differing widely between components."""
    _search_equals_host_loop(dev, 600, 10)


def _search_equals_host_loop(dev, k, d):
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import trust_region as tops

    g = torch.Generator().manual_seed(100 + d)
    means = torch.randn(k, d, generator=g) * 3
    a = torch.randn(k, d, d, generator=g)
    chols = torch.linalg.cholesky(a @ a.mT / d + 0.5 * torch.eye(d))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False)
    h = torch.randn(k, d, d, generator=g) * 0.3
    rq = h @ h.mT - 0.5 * torch.eye(d)
    rl = torch.randn(k, d, generator=g)
    rq[-2:], rl[-2:] = torch.nan, torch.nan
    inp = tops.prepare_tr_kl_inputs(*[t.to(dev) for t in (means, chols, inv,
                                                          rl, rq)])
    bound = 10.0 ** (torch.rand(k, generator=g) * 3 - 3)
    log_last = torch.log(10.0 ** (torch.rand(k, generator=g) * 5 - 2))
    cold = torch.arange(k) % 3 == 0
    lower0 = torch.where(cold, -20.0, torch.clamp(log_last - 3.0, min=0.0))
    upper0 = torch.where(cold, 80.0, log_last + 3.0)
    lower0[1], upper0[1] = math.log(5.0), math.log(5.0) + 1e-3
    active = torch.arange(k) < k - 2
    args = (inp, *[t.to(dev).contiguous() for t in (bound, lower0, upper0,
                                                     active)])
    before = dict(cuda.LAUNCHES)
    got = tops.tr_search(*args)
    again = tops.tr_search(*args)
    assert cuda.LAUNCHES["tr_search"] == before["tr_search"] + 2
    loop = tops.bracket_search(lambda e: tops.tr_kl(e, inp), *args[1:],
                               per_component_trips=True)
    lockstep_trips = tops.bracket_search(lambda e: tops.tr_kl(e, inp),
                                         *args[1:])[2]
    torch.cuda.synchronize()
    for a_, b_, c_ in zip(got, again, loop):
        assert torch.equal(a_, b_)
        assert torch.equal(a_, c_)
    trips = got[2].cpu()
    assert int(trips.max()) == lockstep_trips
    assert trips[-2:].tolist() == [0, 0] and int(trips[1]) == 1
    assert int(trips.max()) > 3
    assert bool((got[0] == got[1]).any()) and not bool(
        (got[0] == got[1]).all())


def test_background_kernel_at_planar_robot_width(dev):
    """B4 at planar_robot_4's finalize pass: U = 2,048 rows, all live, over
    N = 180,000 samples at D = 10, against the plain version taken over
    slices of 30,000 samples (each sample's value is its own; the whole
    [U, N, D] intermediates would take ~45 GB): within rtol 1e-4 /
    atol 2e-4, equal bits on two calls."""
    from gmmvi_tpu_torch.ops import background as bops

    args = [t.to(dev) for t in _mixture(2048, 10, 180000, 0, seed=7)]
    got = bops.background_logpdf(*args)
    again = bops.background_logpdf(*args)
    want = torch.cat([bops.background_logpdf_plain(*args[:4], x)
                      for x in args[4].split(30000)])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("u,d,n,n_masked", [
    (192, 20, 28800, 64), (7, 5, 600, 2), (70, 60, 520, 23),
    (5, 128, 77, 0), (1, 1, 33, 0), (4, 3, 10, 4), (300, 6, 1000, 150),
    (2048, 20, 3000, 700), (192, 20, 19200, 0)])
def test_background_kernel_matches_plain(dev, u, d, n, n_masked):
    """B4 against its plain version: rtol 1e-4 / atol 2e-4 (the Pallas
    kernel's bar); -inf in the same places (every row masked); two calls
    give the same bits (no atomics).  U = 2048 is the cap on
    max_background_dists.  U = 192 at N = 19,200 with every row live is
    the ESS pass of SEMIDUG (and ZAMTRUX), whose window's old samples come
    from more than 192 generating distributions; the first case is the
    shape of their finalize pass."""
    from gmmvi_tpu_torch.ops import background as bops
    from gmmvi_tpu_torch.ops import cuda

    args = [t.to(dev) for t in _mixture(u, d, n, 0, seed=u + d)]
    g = torch.Generator().manual_seed(d)
    masked = torch.randperm(u, generator=g)[:n_masked].to(dev)
    args[2][masked] = -torch.inf
    before = cuda.LAUNCHES["background_logpdf"]
    got = bops.background_logpdf(*args)
    want = bops.background_logpdf_plain(*args)
    again = bops.background_logpdf(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["background_logpdf"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isneginf(want).all() == (n_masked == u)
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("k,d,n,n_masked", [
    (24, 20, 2000, 0), (48, 20, 2000, 24), (96, 20, 16384, 40),
    (5, 3, 50, 5), (7, 33, 129, 0), (3, 128, 64, 1), (1, 1, 31, 0),
    (4, 136, 300, 1), (24, 31, 16384, 20), (48, 25, 2000, 30),
    (600, 10, 16384, 300)])
def test_mixture_logpdf_kernel_matches_plain(dev, k, d, n, n_masked):
    """B9 against its plain version at rtol / atol 1e-4 (the Pallas
    kernel's bar), at the runner path's shapes (2,000 evaluation draws,
    16,384 add candidates), at the paper experiments' D = 31, 25 and 10
    (600 slots) and others; -inf in the same places (every slot
    masked); two calls give the same bits.  Above D = 128 it takes B5 and
    counts there."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import mixture_logpdf as mops

    args = [t.to(dev) for t in _mixture(k, d, n, n_masked, seed=k + d)]
    before = dict(cuda.LAUNCHES)
    got = mops.mixture_logpdf(*args)
    want = mops.mixture_logpdf_plain(*args)
    again = mops.mixture_logpdf(*args)
    torch.cuda.synchronize()
    name = "mixture_logpdf" if d <= 128 else "densities_large"
    assert cuda.LAUNCHES[name] == before[name] + 2
    assert torch.equal(got, again)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isneginf(want).all() == (n_masked == k)
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=1e-4, rtol=1e-4)


def test_runner_on_card_resumes_exactly(dev, tmp_path):
    """The runner on gmm20 at a small size on the card, outgrowing 4 slots:
    saved after 18 iterations and loaded into a fresh runner, 8 more
    iterations in both give the same state to the bit; B9 ran on the path
    (the evaluations and the adds)."""
    from gmmvi_tpu_torch import GmmviRunner, state_to_numpy
    from gmmvi_tpu_torch.configs import get_default_config, update_config
    from gmmvi_tpu_torch.ops import cuda

    cfg = update_config(get_default_config("SAMTRON", "gmm20"), {
        "environment_config": {"num_dimensions": 5},
        "sample_selector_config": {"desired_samples_per_component": 24},
        "num_component_adapter_config": {"del_iters": 8, "add_iters": 5,
                                         "num_database_samples": 256},
        "gmmvi_runner_config": {"log_metrics_interval": 10},
        "tpu": {"max_components": 4}})

    def runner():
        r = GmmviRunner.build_from_config(update_config(cfg, {}), device=dev)
        r.target_distribution.make_plots = False
        return r

    a = runner()
    cuda.reset_launch_counts()
    for n in range(18):
        a.iterate_and_log(n)
    # two evaluations (model and target, 2,000 draws each), three adds
    assert cuda.LAUNCHES["mixture_logpdf"] == 2 * 2 + 3
    assert a.gmmvi.state.model.max_components == 16
    path = str(tmp_path / "ck.npz")
    a.save_checkpoint(path)
    b = runner()
    b.load_checkpoint(path)
    for n in range(18, 26):
        a.iterate_and_log(n)
        b.iterate_and_log(n)
    sa, sb = state_to_numpy(a.gmmvi.state), state_to_numpy(b.gmmvi.state)
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


@pytest.mark.parametrize("k,d,n,order", [
    (3, 2, 1000, "runs"), (5, 7, 613, "runs"), (48, 20, 28801, "runs"),
    (2, 45, 517, "runs"), (48, 20, 28801, "scattered"),
    (6, 45, 3001, "scattered")])
def test_more_grams_kernel_matches_plain(dev, k, d, n, order):
    """B8 against its plain version on samples drawn from the components in
    runs of 50 with self-normalized importance weights, as the estimator
    gives them (whole 32-sample slabs carry no weight for a component);
    or ("scattered") the same window shuffled with a fixed generator, so
    that the zero weights lie scattered as on the reuse path, and one
    component keeps 45 live samples (not a multiple of the 32-sample
    slab).  N not a multiple of the slab, a zero-weight tail and one
    component with no weight at all.  Gram and rhs within 2e-5 of each
    component's largest entry (3xTF32 sums over the live samples in
    another order); an exactly-zero Gram without weight; two calls give
    the same bits.  The solved terms are held at rtol 2e-3 in
    chip_smoke.py; on the random inputs here they also measure the
    conditioning of the fit, not the kernel."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density as dops
    from gmmvi_tpu_torch.ops import more as mops

    means, inv, logw, logdets, _ = _mixture(k, d, n, 0, seed=k * d)
    chols = torch.linalg.inv(inv)
    g = torch.Generator().manual_seed(n)
    comp = (torch.arange(n) // 50) % k
    x = means[comp] + torch.einsum("nij,nj->ni", chols[comp],
                                   torch.randn(n, d, generator=g))
    y = torch.randn(n, generator=g) * 10.0
    dens, model = dops.densities_plain(means, inv, logw, logdets, x)
    w = torch.softmax(dens - model[None, :], dim=1)
    w[:, n - 70:] = 0.0
    weighted = k - 1 if k > 2 else k
    w[weighted:] = 0.0
    if order == "scattered":
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(k))
        x, y, w = x[perm], y[perm], w[:, perm]
        live = torch.nonzero(w[0])[:, 0]
        w[0, live[45:]] = 0.0
        assert int((w[0] != 0).sum()) == 45
    args = [t.to(dev).contiguous() for t in (inv, means, w, y, x)]
    before = cuda.LAUNCHES["more_grams"]
    gram, rhs = mops.more_grams(*args)
    gram_p, rhs_p = mops.more_grams_plain(*args)
    gram_2, rhs_2 = mops.more_grams(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["more_grams"] == before + 2
    assert torch.equal(gram, gram_2) and torch.equal(rhs, rhs_2)
    for got, want in ((gram, gram_p), (rhs, rhs_p)):
        scale = want.abs().reshape(k, -1).amax(1).clamp(min=1e-30)
        err = (got - want).abs().reshape(k, -1).amax(1)
        assert (err <= 2e-5 * scale).all(), (err / scale).tolist()
    assert torch.equal(gram[weighted:], torch.zeros_like(gram[weighted:]))


def _main_path_overrides(codename):
    return {
        "seed": 0, "temperature": 1.0,
        "sample_selector_config": {
            "desired_samples_per_component": 40,
            "ratio_reused_samples_to_desired":
                2.0 if codename == "ZAMTRUX" else 0.0},
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 6,
            "prior_mean": 0.0, "prior_scale": 20.0, "initial_cov": 100.0},
        "component_stepsize_adapter_config": {"initial_stepsize": 0.1},
        "num_component_adapter_config": {
            "del_iters": 3, "add_iters": 4, "max_components": 8,
            "num_database_samples": 1024, "num_prior_samples": 0},
        "tpu": {"max_components": 8},
    }


def _draws(dims, steps):
    """Injected draws for ``steps`` steps of the overrides above (8 slots,
    40 samples each, a 1024-row reservoir)."""
    rng = np.random.RandomState(0)
    b, c = 8 * 40, 1024
    return [dict(eps=rng.standard_normal((8, 40, dims)).astype(np.float32),
                 rand_slots=rng.randint(0, c, b).astype(np.int32),
                 accept_u=rng.uniform(size=b).astype(np.float32),
                 db_perm=rng.permutation(c), add_a=np.float32(0.3))
            for _ in range(steps)]


def _build(codename, dims, device):
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    target = make_target(dims, False, seed=0, device=device)
    cfg = update_config(get_default_algorithm_config(codename),
                        _main_path_overrides(codename))
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device=device)
    return GMMVI.build_from_config(cfg, target, model, meta, device=device)


def _step(g, dr, device):
    from gmmvi_tpu_torch import StepDraws

    g.train_iter(StepDraws(**{k: torch.as_tensor(v).to(device)
                              for k, v in dr.items()}))


@pytest.mark.parametrize("codename,dims", [("SAMTRON", 10), ("ZAMTRUX", 3)])
def test_main_path_on_card_matches_cpu(dev, codename, dims):
    """Five steps on the card and on the CPU from the same initial state
    with the same injected draws (one step is an add), SAMTRON and ZAMTRUX
    (sample reuse, MORE): counts exact, means and weights within rtol 1e-3
    / atol 1e-3 (the card sums in another order), and every kernel of the
    path launched.  ZAMTRUX runs at D = 3: MORE fits F = 1 + D + D(D+1)/2
    features per component from about 40 draws, which is well posed at D = 3
    (F = 10) but not at D = 10 (F = 66), where the ridge-1e-12 fit turns the
    card's rounding into differences far past any fixed bar (one step at
    D = 10 is taken apart in the next test)."""
    from gmmvi_tpu_torch import state_to_numpy
    from gmmvi_tpu_torch.ops import cuda

    runs = []
    draws = _draws(dims, 5)
    for device in ("cpu", dev):
        g = _build(codename, dims, device)
        cuda.reset_launch_counts()
        for dr in draws:
            _step(g, dr, device)
        runs.append(state_to_numpy(g.state))
        launches = dict(cuda.LAUNCHES)
    cpu, card = runs
    assert launches["density_pack"] == 5
    assert launches["tr_search"] == 5             # one search a step
    assert launches["tr_kl"] == 0
    assert launches["mixture_logpdf"] == 1        # the add's candidates
    if codename == "ZAMTRUX":
        assert launches["densities"] == 10          # ESS pass + weights
        assert launches["background_logpdf"] == 10  # propose + finalize
        assert launches["more_grams"] == 5
        assert int(card["db.num_samples_written"]) < 5 * 6 * 40
    else:
        assert launches["densities"] == 5
    for name in ("model.num_active", "db.num_samples_written", "db.write_pos",
                 "db.sample_comp", "db.sample_iter", "db.res_count"):
        np.testing.assert_array_equal(card[name], cpu[name], err_msg=name)
    assert int(card["model.num_active"]) == 7
    for name in ("model.means", "model.log_weights"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def _rel_to_scale(got, want):
    """Per component: max |got - want| over the component's largest |want|;
    the largest of these over the components with a nonzero want."""
    k = want.shape[0]
    scale = want.abs().reshape(k, -1).amax(1)
    err = (got - want).abs().reshape(k, -1).amax(1)
    live = scale > 0
    return float((err[live] / scale[live]).max())


def test_zamtrux_step_on_card_matches_cpu_up_to_the_solve(dev, monkeypatch):
    """Where the card and the CPU part at D = 10: one ZAMTRUX step from one
    state (four CPU steps in, so old distributions are reused) with the same
    draws, each stage held card against CPU.  The proposal's fresh-sample
    counts (ESS floors, B2 and B4) and the window's integer leaves exactly;
    its background densities at B4's bar (atol 2e-4 + rtol 1e-4); the card's
    Gram against the plain version on the card's own inputs at B8's bar (2e-5
    of each component's largest entry) and against the CPU's Gram within
    1e-3 (its weights come from log densities held at atol 5e-4).  Past the
    Gram the two part in the ridge-1e-12 solve: the regularized Grams are
    singular to f32 precision (condition numbers up to ~1e10 on the CPU), so
    even their float64 solutions differ by O(1); each component's difference
    is held to the first-order perturbation bound kappa (eA + eb) /
    (1 - kappa eA) of the two Grams' difference (no bound where
    kappa eA >= 1).  The readings are printed as one JSON line."""
    import json

    from gmmvi_tpu_torch import state_from_numpy, state_to_numpy
    from gmmvi_tpu_torch.ops import more as mops
    from gmmvi_tpu_torch.ops import quadratic as qops
    from gmmvi_tpu_torch.optimization import ng_estimators, sample_selectors

    dims = 10
    draws = _draws(dims, 5)
    g_cpu = _build("ZAMTRUX", dims, "cpu")
    for dr in draws[:4]:
        _step(g_cpu, dr, "cpu")
    named = state_to_numpy(g_cpu.state)
    g_card = _build("ZAMTRUX", dims, dev)
    g_card.state = state_from_numpy(named, device=dev, like=g_card.state)

    seen = {}

    def recording(module, attr):
        fn = getattr(module, attr)

        def call(*args, **kw):
            out = fn(*args, **kw)
            seen[attr] = (args, out)
            return out

        monkeypatch.setattr(module, attr, call)

    recording(sample_selectors, "propose")
    recording(sample_selectors, "finalize_fused")
    recording(ng_estimators, "more_grams")
    stages = []
    for g, device in ((g_cpu, "cpu"), (g_card, dev)):
        seen.clear()
        _step(g, draws[4], device)
        stages.append({k: (v[0], v[1]) for k, v in seen.items()})
        stages[-1]["state"] = state_to_numpy(g.state)
    cpu, card = stages

    def host(t):
        return t.cpu() if torch.is_tensor(t) else t

    p_cpu, p_card = cpu["propose"][1], card["propose"][1]
    w_cpu, w_card = cpu["finalize_fused"][1][1], card["finalize_fused"][1][1]
    valid = w_cpu.valid
    args_card, (gram_card, rhs_card) = card["more_grams"]
    _, (gram_cpu, rhs_cpu) = cpu["more_grams"]
    gram_plain, rhs_plain = mops.more_grams_plain(*args_card)
    # the solve: each side's Gram in f32 and in float64, at the components
    # and regularizers of the start state (the estimate precedes the update)
    f64 = torch.float64
    regs = torch.as_tensor(named["meta.l2_regularizers"])
    means = torch.as_tensor(named["model.means"])
    inv_chols = torch.as_tensor(named["model.inv_chols"])
    active = torch.as_tensor(named["model.log_weights"]) > -np.inf
    quad = {}
    for side, gram, rhs in (("cpu", gram_cpu, rhs_cpu),
                            ("card", host(gram_card), host(rhs_card))):
        for bits, dtype in ((32, torch.float32), (64, f64)):
            quad[side, bits] = qops.solve_quadratic_normal_eqs(
                gram.to(dtype), rhs.to(dtype), regs.to(dtype),
                means.to(dtype), inv_chols.to(dtype))[0][active].to(f64)
    # the exact solutions of both sides' regularized normal equations
    f = gram_cpu.shape[-1]
    ridge = torch.eye(f, dtype=f64)
    ridge[f - 1, f - 1] = 0.0
    a_cpu, a_card = (g.to(f64)[active] + regs.to(f64)[active, None, None]
                     * ridge for g in (gram_cpu, host(gram_card)))
    b_cpu, b_card = rhs_cpu.to(f64)[active], host(rhs_card).to(f64)[active]
    th_cpu = torch.linalg.solve(a_cpu, b_cpu)
    th_card = torch.linalg.solve(a_card, b_card)
    kappa = torch.linalg.cond(a_cpu)
    e_a = torch.linalg.matrix_norm(a_card - a_cpu, ord=2) \
        / torch.linalg.matrix_norm(a_cpu, ord=2)
    e_b = (b_card - b_cpu).norm(dim=1) / b_cpu.norm(dim=1)
    theta_rel = (th_card - th_cpu).norm(dim=1) / th_cpu.norm(dim=1)
    theta_bound = torch.where(kappa * e_a < 1.0,
                              kappa * (e_a + e_b) / (1.0 - kappa * e_a),
                              torch.inf)
    reading = dict(
        num_reused=[int(p_cpu.num_reused), int(p_card.num_reused)],
        background_max_abs=float(
            (host(w_card.background_log_pdfs)[valid]
             - w_cpu.background_log_pdfs[valid]).abs().max()),
        gram_card_vs_plain=_rel_to_scale(gram_card, gram_plain),
        rhs_card_vs_plain=_rel_to_scale(rhs_card, rhs_plain),
        gram_card_vs_cpu=_rel_to_scale(host(gram_card), gram_cpu),
        rhs_card_vs_cpu=_rel_to_scale(host(rhs_card), rhs_cpu),
        quad64_card_vs_cpu=_rel_to_scale(quad["card", 64], quad["cpu", 64]),
        quad32_card_vs_cpu=_rel_to_scale(quad["card", 32], quad["cpu", 32]),
        quad32_vs_quad64_cpu=_rel_to_scale(quad["cpu", 32], quad["cpu", 64]),
        quad32_vs_quad64_card=_rel_to_scale(quad["card", 32],
                                            quad["card", 64]),
        kappa=kappa.tolist(), gram_rel_diff=e_a.tolist(),
        theta64_rel_diff=theta_rel.tolist(),
        theta64_bound=theta_bound.tolist(),
        means_after_step_max_abs=float(np.abs(
            card["state"]["model.means"]
            - cpu["state"]["model.means"]).max()))
    print(json.dumps({"zamtrux_d10_one_step": reading}))

    # the proposal: fresh-sample counts from the ESS floors
    assert int(p_cpu.num_reused) > 0
    assert int(p_card.num_reused) == int(p_cpu.num_reused)
    assert torch.equal(host(p_card.valid), p_cpu.valid)
    assert torch.equal(host(p_card.mapping), p_cpu.mapping)
    # the window of the update
    for name in ("valid", "mapping", "sample_iters", "num_valid"):
        assert torch.equal(host(getattr(w_card, name)),
                           getattr(w_cpu, name)), name
    torch.testing.assert_close(host(w_card.samples), w_cpu.samples,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(host(w_card.background_log_pdfs)[valid],
                               w_cpu.background_log_pdfs[valid],
                               rtol=1e-4, atol=2e-4)
    # the Gram before the solve, and the solve within its perturbation bound
    for name, bar in (("gram_card_vs_plain", 2e-5), ("rhs_card_vs_plain", 2e-5),
                      ("gram_card_vs_cpu", 1e-3), ("rhs_card_vs_cpu", 1e-3)):
        assert reading[name] <= bar, (name, reading)
    assert bool((theta_rel <= theta_bound * (1.0 + 1e-6)).all()), reading
    for name in ("model.num_active", "db.num_samples_written", "db.write_pos",
                 "db.sample_comp", "db.sample_iter"):
        np.testing.assert_array_equal(card["state"][name],
                                      cpu["state"][name], err_msg=name)


def _large_mixture(k, d, n, n_masked, seed):
    """The large-D kernels' inputs as tests/test_pallas_kernels.py makes
    them: means spread by 3, covariances a a^T + I with a ~ 0.1 N(0, 1),
    samples around the first mean; the last ``n_masked`` slots masked."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(k, d, generator=g) * 3
    a = torch.randn(k, d, d, generator=g) * 0.1
    chols = torch.linalg.cholesky(a @ a.mT + torch.eye(d))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False).contiguous()
    logw = torch.log_softmax(torch.randn(k, generator=g), 0)
    logw[k - n_masked:] = -torch.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    x = torch.randn(n, d, generator=g) * 2 + means[0]
    return [means, inv, logw, logdets, x]


@pytest.mark.parametrize("k,d,n", [(40, 300, 12000), (150, 33, 600),
                                   (9, 512, 300), (3, 129, 70)])
def test_large_density_kernels_match_plain(dev, k, d, n):
    """B5 against its plain version at the Pallas test's bar (rtol 2e-4 /
    atol 2e-3), B6 on the plain comp and model at rtol / atol 2e-3, and
    B5's background mode with half the rows masked (the same mixture
    output) and with all of them masked (-inf)."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density_large as dl

    args = [t.to(dev) for t in _large_mixture(k, d, n, 3 if k > 3 else 0,
                                              seed=k + d)]
    before = dict(cuda.LAUNCHES)
    comp, model = dl.densities_large(*args)
    comp_p, model_p = dl.densities_large_plain(*args)
    grads = dl.density_grads_large(*args[:3], comp_p, model_p, args[4])
    grads_p = dl.density_grads_large_plain(*args[:3], comp_p, model_p,
                                           args[4])
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["densities_large"] == before["densities_large"] + 1
    assert cuda.LAUNCHES["density_grads_large"] == \
        before["density_grads_large"] + 1
    torch.testing.assert_close(comp, comp_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(model, model_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(grads, grads_p, rtol=2e-3, atol=2e-3)

    half = list(args)
    half[2] = args[2].clone()
    half[2][torch.arange(k, device=dev) % 2 == 1] = -torch.inf
    got = dl.mixture_logpdf_large(*half)
    want = dl.mixture_logpdf_large_plain(*half)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-3)
    half[2] = torch.full_like(args[2], -torch.inf)
    assert torch.isneginf(dl.mixture_logpdf_large(*half)).all()


@pytest.mark.parametrize("k,d,n", [(40, 300, 12000), (150, 33, 600),
                                   (9, 512, 300), (5, 70, 700)])
def test_stein_smom_kernel_matches_plain(dev, k, d, n):
    """B7 against its plain version within 1e-5 of each component's largest
    entry (fp32 sums over N in another order); a component without weight
    gives zeros, and runs of zero weight are skipped."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import stein

    g = torch.Generator().manual_seed(k * d)
    w = torch.rand(k, n, generator=g)
    w[:, (torch.arange(n) // 40) % 3 == 0] = 0.0
    w[-1] = 0.0
    w = w / w.sum(1, keepdim=True).clamp(min=1e-30)
    gr = torch.randn(n, d, generator=g)
    xc = torch.randn(n, d, generator=g) * 3
    args = [t.to(dev).contiguous() for t in (w, gr, xc)]
    before = cuda.LAUNCHES["stein_smom"]
    got = stein.stein_smom(*args)
    want = stein.stein_smom_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["stein_smom"] == before + 1
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    scale = want[:-1].abs().reshape(k - 1, -1).amax(1)
    err = (got[:-1] - want[:-1]).abs().reshape(k - 1, -1).amax(1)
    assert (err <= 1e-5 * scale).all(), (err / scale).tolist()


def test_stein_smom_plain_at_planar_robot_shape(dev):
    """The plain moments at planar_robot_4's window (K 600, D 10, N 180,000:
    one slab of [N, D^2] outer products and one fp32 product, TF32 off)
    against float64 within 1e-5 of each component's largest entry; the
    weightless slots give exact zeros."""
    from gmmvi_tpu_torch.ops import stein

    k, n, d = 600, 180_000, 10
    g = torch.Generator(device=dev).manual_seed(21)
    w = torch.rand(k, n, generator=g, device=dev) ** 8
    w[:, torch.rand(n, generator=g, device=dev) < 0.2] = 0.0
    live = torch.arange(k, device=dev) % 2 == 0
    w[~live] = 0.0
    w = w / w.sum(1, keepdim=True).clamp(min=1e-30)
    gr = torch.randn(n, d, generator=g, device=dev) * 10
    xc = torch.randn(n, d, generator=g, device=dev) * 3
    assert not torch.backends.cuda.matmul.allow_tf32
    got = stein.stein_smom_plain(w, gr, xc)
    want = torch.einsum("kn,nd,ne->kde", w.double(), gr.double(),
                        xc.double())
    assert got.dtype == torch.float32
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    scale = want[live].abs().reshape(-1, d * d).amax(1)
    err = (got[live].double() - want[live]).abs().reshape(-1, d * d).amax(1)
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


EDGE_DIMS = [65, 72, 136, 300, 301, 512]


@pytest.mark.parametrize("d", EDGE_DIMS)
def test_stein_smom_tf32x3_edge_shapes(dev, d):
    """B7's 3xTF32 tiles (64 x 128 of the D x D output, slabs of 32
    samples) at D on either side of a tile's edge and N = 1,001 (a
    multiple of no tile or slab): within 1e-5 of each component's largest
    entry of the plain version; a component without weight gives exact
    zeros; runs of 40 zero-weight samples (whole dead slabs) skipped."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import stein

    k, n = 5, 1001
    g = torch.Generator().manual_seed(d)
    w = torch.softmax(torch.randn(k, n, generator=g) * 3, dim=0)
    w[:, (torch.arange(n) // 40) % 3 == 1] = 0.0
    w[2] = 0.0
    gr = torch.randn(n, d, generator=g) * 10
    xc = torch.randn(n, d, generator=g) * 3
    args = [t.to(dev).contiguous() for t in (w, gr, xc)]
    before = cuda.LAUNCHES["stein_smom"]
    got = stein.stein_smom(*args)
    want = stein.stein_smom_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["stein_smom"] == before + 1
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    live = torch.arange(k, device=dev) != 2
    scale = want[live].abs().reshape(k - 1, -1).amax(1)
    err = (got[live] - want[live]).abs().reshape(k - 1, -1).amax(1)
    assert (err <= 1e-5 * scale).all(), (err / scale).tolist()


@pytest.mark.parametrize("d", EDGE_DIMS)
def test_large_density_tf32x3_edge_shapes(dev, d):
    """B5's 3xTF32 tiles (64 samples x 64 factor rows, 32-column slabs)
    at D on either side of a tile's edge and N = 1,001, the factors' upper
    triangles holding NaN (never read): comp and model at rtol 2e-4 / atol
    2e-3 against the plain version, and the background mode with -inf log
    weights (skipped rows) giving the plain mixture output, -inf where
    every row is masked."""
    from gmmvi_tpu_torch.ops import density_large as dl

    k, n = 6, 1001
    args = [t.to(dev) for t in _large_mixture(k, d, n, 2, seed=d)]
    clean = list(args)
    args[1] = (args[1] + torch.triu(torch.full_like(args[1], torch.nan),
                                    1)).contiguous()
    comp, model = dl.densities_large(*args)
    comp_p, model_p = dl.densities_large_plain(*clean)
    torch.cuda.synchronize()
    torch.testing.assert_close(comp, comp_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(model, model_p, rtol=2e-4, atol=2e-3)
    half = list(args)
    half[2] = args[2].clone()
    half[2][torch.arange(k, device=dev) % 2 == 1] = -torch.inf
    want = dl.mixture_logpdf_large_plain(*clean[:2], half[2], *clean[3:])
    torch.testing.assert_close(dl.mixture_logpdf_large(*half), want,
                               rtol=2e-4, atol=2e-3)
    half[2] = torch.full_like(args[2], -torch.inf)
    assert torch.isneginf(dl.mixture_logpdf_large(*half)).all()


def _grads_mixture(k, d, n, sparse, seed):
    """B6's inputs: a mixture of k components at D = d (the last masked,
    the one before it without samples) and n samples drawn from the
    others in random order, with B5's plain comp and model.  ``sparse``:
    narrow components 30 apart, so that most responsibilities underflow to
    zero and the live (component, 64-sample tile) pairs lie scattered, as
    on stm300; else overlapping ones (every pair live)."""
    from gmmvi_tpu_torch.ops import density_large as dl

    g = torch.Generator().manual_seed(seed)
    means = torch.randn(k, d, generator=g) * (30.0 if sparse else 0.3)
    a = torch.randn(k, d, d, generator=g)
    scale = 0.05 if sparse else 1.0
    chols = torch.linalg.cholesky(scale * (a @ a.mT / d + torch.eye(d)))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False).contiguous()
    logw = torch.log_softmax(torch.randn(k, generator=g), 0)
    logw[-1] = -torch.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp_of = torch.randint(0, k - 2, (n,), generator=g)
    x = means[comp_of] + torch.einsum("nij,nj->ni", chols[comp_of],
                                      torch.randn(n, d, generator=g))
    comp, model = dl.densities_large_plain(means, inv, logw, logdets, x)
    return [means, inv, logw, comp, model, x]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("d", [65, 136, 300, 301, 512])
def test_density_grads_tf32x3_dense_and_sparse(dev, d, sparse):
    """B6 on the tensor cores (64-sample x 64-column tiles, 32-step slabs
    over e, the live (component, tile) pairs only) at D on either side of
    a tile's edge and N = 1,001: rtol / atol 2e-3 against the plain
    version, equal bits on two calls; with dense responsibilities and with
    sparse ones (most pairs dead, and a component without a live pair)."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density_large as dl

    k, n = 7, 1001
    args = [t.to(dev) for t in _grads_mixture(k, d, n, sparse, seed=d)]
    before = cuda.LAUNCHES["density_grads_large"]
    got = dl.density_grads_large(*args)
    again = dl.density_grads_large(*args)
    want = dl.density_grads_large_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["density_grads_large"] == before + 2
    assert torch.equal(got, again)
    resp = torch.exp(args[3] + args[2][:, None] - args[4][None, :])
    live = float((resp > 0).double().mean())
    assert (live < 0.5) if sparse else (live > 0.5)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_live,n", [(4, 1200), (10, 7200), (24, 7200)])
def test_large_kernels_at_wine_shapes(dev, n_live, n):
    """B5, B6 and B7 at wine's shapes: D = 177 (its last 32-column slab
    part filled), 24 slots of which ``n_live`` are live, N the window
    (1,200 at the first step, 7,200 once the reuse window fills): B5 at
    rtol 2e-4 / atol 2e-3 (comp and model, and its background mode over
    the live rows), B6 at rtol / atol 2e-3 with equal bits on two calls,
    B7 within 1e-5 of each component's largest entry."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density_large as dl
    from gmmvi_tpu_torch.ops import stein

    k, d = 24, 177
    args = [t.to(dev) for t in _large_mixture(k, d, n, k - n_live,
                                              seed=d + n_live)]
    before = dict(cuda.LAUNCHES)
    comp, model = dl.densities_large(*args)
    comp_p, model_p = dl.densities_large_plain(*args)
    gargs = [*args[:3], comp_p, model_p, args[4]]
    grads = dl.density_grads_large(*gargs)
    again = dl.density_grads_large(*gargs)
    grads_p = dl.density_grads_large_plain(*gargs)
    mix = dl.mixture_logpdf_large(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["densities_large"] == before["densities_large"] + 2
    assert cuda.LAUNCHES["density_grads_large"] == \
        before["density_grads_large"] + 2
    torch.testing.assert_close(comp, comp_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(model, model_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(mix, model_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(grads, grads_p, rtol=2e-3, atol=2e-3)
    assert torch.equal(grads, again)
    w = torch.where(torch.isfinite(args[2])[:, None],
                    torch.softmax(comp_p - model_p[None, :], dim=1), 0.0)
    g = torch.Generator(device=dev).manual_seed(n_live)
    sargs = [t.contiguous() for t in (
        w, torch.randn(n, d, generator=g, device=dev) * 10.0,
        args[4] - args[0].mean(0))]
    got = stein.stein_smom(*sargs)
    want = stein.stein_smom_plain(*sargs)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["stein_smom"] == before["stein_smom"] + 1
    scale = want.abs().reshape(k, -1).amax(1)
    err = (got - want).abs().reshape(k, -1).amax(1)
    live = scale > 0
    assert (err[live] <= 1e-5 * scale[live]).all()
    assert (err[~live] == 0).all()


def test_large_kernels_at_sepyfux_shapes(dev):
    """B5 and B6 at SEPYFUX's shapes on stm300: K = 24 slots of which 20
    are active, N = 100 draws from the mixture, D = 300.  B5 at rtol 2e-4 /
    atol 2e-3 and B6 at rtol / atol 2e-3 against their plain versions, each
    with equal bits on two calls."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import density_large as dl

    k, d, n = 24, 300, 100
    g = torch.Generator().manual_seed(24)
    means = torch.randn(k, d, generator=g) * 30.0
    a = torch.randn(k, d, d, generator=g)
    chols = torch.linalg.cholesky(300.0 * (a @ a.mT / d + torch.eye(d)))
    inv = torch.linalg.solve_triangular(chols, torch.eye(d).expand(k, d, d),
                                        upper=False).contiguous()
    logw = torch.log_softmax(torch.randn(k, generator=g), 0)
    logw[20:] = -torch.inf
    logdets = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp_of = torch.multinomial(torch.exp(logw), n, replacement=True,
                                generator=g)
    x = means[comp_of] + torch.einsum("nij,nj->ni", chols[comp_of],
                                      torch.randn(n, d, generator=g))
    args = [t.to(dev) for t in (means, inv, logw, logdets, x)]
    before = dict(cuda.LAUNCHES)
    comp, model = dl.densities_large(*args)
    comp2, model2 = dl.densities_large(*args)
    comp_p, model_p = dl.densities_large_plain(*args)
    gargs = [*args[:3], comp_p, model_p, args[4]]
    grads = dl.density_grads_large(*gargs)
    grads2 = dl.density_grads_large(*gargs)
    grads_p = dl.density_grads_large_plain(*gargs)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["densities_large"] == before["densities_large"] + 2
    assert cuda.LAUNCHES["density_grads_large"] == \
        before["density_grads_large"] + 2
    assert torch.equal(comp, comp2) and torch.equal(model, model2)
    assert torch.equal(grads, grads2)
    torch.testing.assert_close(comp, comp_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(model, model_p, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(grads, grads_p, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n,live", [(16384, 24), (2000, 10)])
def test_mixture_logpdf_at_d300_takes_b5(dev, n, live):
    """B9's two call sizes on the stm300 path (40 slots at D = 300: the add
    heuristic's 16,384 reservoir candidates, the ELBO estimate's 2,000
    draws) go through B5's background mode and match B9's plain version at
    B5's bar."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.ops import mixture_logpdf as mix

    args = [t.to(dev) for t in _large_mixture(40, 300, n, 40 - live,
                                              seed=n)]
    cuda.reset_launch_counts()
    got = mix.mixture_logpdf(*args)
    want = mix.mixture_logpdf_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["densities_large"] == 1
    assert cuda.LAUNCHES["mixture_logpdf"] == 0
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-3)


def test_large_d_density_pack_dispatch_on_card(dev):
    """A D = 300 density pack on the card launches B5 and B6, not B1/B2."""
    from gmmvi_tpu_torch.models import gmm as tgmm
    from gmmvi_tpu_torch.ops import cuda

    means, inv, logw, _, x = _large_mixture(4, 300, 500, 0, seed=1)
    covs = torch.linalg.inv(inv.mT @ inv)
    state = tgmm.create_gmm_state(torch.exp(logw), means, covs,
                                  max_components=6, device=dev)
    cuda.reset_launch_counts()
    pack = tgmm.density_pack(state, x.to(dev))
    tgmm.log_densities_also_individual(state, x.to(dev))
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["densities_large"] == 2
    assert cuda.LAUNCHES["density_grads_large"] == 1
    assert cuda.LAUNCHES["density_pack"] == cuda.LAUNCHES["densities"] == 0
    assert torch.isfinite(pack.model_grads).all()


def test_large_d_path_on_card_matches_cpu(dev):
    """Five SAMTRON steps with sample reuse at D = 136 on the card and on
    the CPU from the same initial state with the same injected draws (one
    step is an add): B5, B6 and B7 and the whitened trust-region update on
    the card, B1-B4 not at all; counts exact, means and weights within
    rtol 1e-3 / atol 1e-3."""
    from gmmvi_tpu_torch import state_to_numpy
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    dims = 136
    draws = _draws(dims, 5)
    runs = []
    for device in ("cpu", dev):
        target = make_target(dims, False, seed=0, device=device)
        cfg = update_config(get_default_algorithm_config("SAMTRON"),
                            _main_path_overrides("SAMTRON"))
        cfg = update_config(cfg, {"sample_selector_config": {
            "ratio_reused_samples_to_desired": 2.0}})
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=device)
        g = GMMVI.build_from_config(cfg, target, model, meta, device=device)
        cuda.reset_launch_counts()
        for dr in draws:
            _step(g, dr, device)
        runs.append(state_to_numpy(g.state))
        launches = dict(cuda.LAUNCHES)
    cpu, card = runs
    # pack, ESS, weights and 2 backgrounds a step; the add's candidates
    # (B9's mixture log-density, which takes B5 above D = 128)
    assert launches["densities_large"] == 5 * 5 + 1
    assert launches["mixture_logpdf"] == 0
    assert launches["density_grads_large"] == 5
    assert launches["stein_smom"] == 5
    for name in ("density_pack", "densities", "tr_kl", "tr_search",
                 "background_logpdf", "more_grams"):
        assert launches[name] == 0, name
    for name in ("model.num_active", "db.num_samples_written", "db.write_pos",
                 "db.sample_comp", "db.sample_iter", "db.res_count"):
        np.testing.assert_array_equal(card[name], cpu[name], err_msg=name)
    assert int(card["model.num_active"]) == 7
    assert int(card["db.num_samples_written"]) < 5 * 6 * 40
    for name in ("model.means", "model.log_weights"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_meshed_first_step_on_card_matches_unmeshed(dev, tmp_path):
    """``chip_smoke.py``'s mesh path M1 for one step: the flagship SAMTRON
    (45 components in 48 slots, 200 samples each, D = 20, the global ring)
    on a data mesh of two ranks that share cuda:0 over gloo, each rank's
    kernels on its block of the rows, against the unmeshed step on the
    card from the same state and draws: integer leaves (fevals included)
    exactly, floats within rtol 1e-4 / atol 1e-5, the replicated state
    equal on both ranks."""
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.parallel.mesh import spawn

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_mesh_worker import card_first_step

    cs = _chip_smoke()
    cuda.build_all()
    want = cs.mesh_reference(dev, tmp_path)
    spawn(card_first_step, 2, "gloo", args=(str(tmp_path),), timeout_s=300)
    with np.load(tmp_path / "state1.npz") as z:
        got = dict(z)
    cmp_ = cs.compare_states(got, want, 1e-4, 1e-5)
    assert not cmp_["missed"], cmp_["worst"]
    assert int(got["db.num_samples_written"]) == int(
        want["db.num_samples_written"]) > 0
