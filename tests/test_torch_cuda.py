"""The port's CUDA kernels against their plain PyTorch versions, and the
main path on the card against the same path on the CPU.

These tests need an NVIDIA card (Hopper, since the kernels build for
sm_90a) and ``nvcc``; without them each skips.  On a machine with the card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
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


@pytest.mark.parametrize("u,d,n,n_masked", [
    (192, 20, 28800, 64), (7, 5, 600, 2), (70, 60, 520, 23),
    (5, 128, 77, 0), (1, 1, 33, 0), (4, 3, 10, 4), (300, 6, 1000, 150),
    (2048, 20, 3000, 700)])
def test_background_kernel_matches_plain(dev, u, d, n, n_masked):
    """B4 against its plain version: rtol 1e-4 / atol 2e-4 (the Pallas
    kernel's bar); -inf in the same places (every row masked).  U = 2048,
    the cap on max_background_dists, takes over 48 KB of shared memory."""
    from gmmvi_tpu_torch.ops import background as bops
    from gmmvi_tpu_torch.ops import cuda

    args = [t.to(dev) for t in _mixture(u, d, n, 0, seed=u + d)]
    g = torch.Generator().manual_seed(d)
    masked = torch.randperm(u, generator=g)[:n_masked].to(dev)
    args[2][masked] = -torch.inf
    before = cuda.LAUNCHES["background_logpdf"]
    got = bops.background_logpdf(*args)
    want = bops.background_logpdf_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["background_logpdf"] == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isneginf(want).all() == (n_masked == u)
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("k,d,n", [(3, 2, 1000), (5, 7, 613),
                                   (48, 20, 28801), (2, 45, 517)])
def test_more_grams_kernel_matches_plain(dev, k, d, n):
    """B8 against its plain version on samples drawn from the components in
    runs of 50 with self-normalized importance weights, as the estimator
    gives them (so whole 32-sample chunks carry no weight for a component
    and are skipped); N not a multiple of the chunk, a zero-weight tail and
    one component with no weight at all.  Gram and rhs within 2e-5 of each
    component's largest entry (fp32 sums over N in another order).  The
    solved terms are held at rtol 2e-3 in chip_smoke.py; on the random
    inputs here they also measure the conditioning of the fit, not the
    kernel."""
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
    args = [t.to(dev).contiguous() for t in (inv, means, w, y, x)]
    before = cuda.LAUNCHES["more_grams"]
    gram, rhs = mops.more_grams(*args)
    gram_p, rhs_p = mops.more_grams_plain(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["more_grams"] == before + 1
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
    assert launches["tr_kl"] >= 5
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
    assert launches["densities_large"] == 5 * 5   # pack, ESS, weights, 2 bg
    assert launches["density_grads_large"] == 5
    assert launches["stein_smom"] == 5
    for name in ("density_pack", "densities", "tr_kl", "background_logpdf",
                 "more_grams"):
        assert launches[name] == 0, name
    for name in ("model.num_active", "db.num_samples_written", "db.write_pos",
                 "db.sample_comp", "db.sample_iter", "db.res_count"):
        np.testing.assert_array_equal(card[name], cpu[name], err_msg=name)
    assert int(card["model.num_active"]) == 7
    assert int(card["db.num_samples_written"]) < 5 * 6 * 40
    for name in ("model.means", "model.log_weights"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)
