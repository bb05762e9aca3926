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


def test_main_path_on_card_matches_cpu(dev):
    """Five SAMTRON steps on the card and on the CPU from the same initial
    state with the same injected draws (one step is an add): counts exact,
    means and weights within rtol 1e-3 / atol 1e-3 (the card sums in
    another order), and every kernel launched."""
    from gmmvi_tpu_torch import StepDraws, state_to_numpy
    from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                         update_config)
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.ops import cuda
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    over = {
        "seed": 0, "temperature": 1.0,
        "sample_selector_config": {"desired_samples_per_component": 40,
                                   "ratio_reused_samples_to_desired": 0.0},
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 6,
            "prior_mean": 0.0, "prior_scale": 20.0, "initial_cov": 100.0},
        "component_stepsize_adapter_config": {"initial_stepsize": 0.1},
        "num_component_adapter_config": {
            "del_iters": 3, "add_iters": 4, "max_components": 8,
            "num_database_samples": 1024, "num_prior_samples": 0},
        "tpu": {"max_components": 8},
    }
    runs = []
    rng = np.random.RandomState(0)
    b, c = 8 * 40, 1024
    draws = [dict(eps=rng.standard_normal((8, 40, 10)).astype(np.float32),
                  rand_slots=rng.randint(0, c, b).astype(np.int32),
                  accept_u=rng.uniform(size=b).astype(np.float32),
                  db_perm=rng.permutation(c), add_a=np.float32(0.3))
             for _ in range(5)]
    for device in ("cpu", dev):
        target = make_target(10, False, seed=0, device=device)
        cfg = update_config(get_default_algorithm_config("SAMTRON"), over)
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device=device)
        g = GMMVI.build_from_config(cfg, target, model, meta, device=device)
        cuda.reset_launch_counts()
        for dr in draws:
            g.train_iter(StepDraws(**{k: torch.as_tensor(v).to(device)
                                      for k, v in dr.items()}))
        runs.append(state_to_numpy(g.state))
        launches = dict(cuda.LAUNCHES)
    cpu, card = runs
    assert launches["density_pack"] == 5 and launches["densities"] == 5
    assert launches["tr_kl"] >= 5
    for name in ("model.num_active", "db.num_samples_written", "db.write_pos",
                 "db.sample_comp", "db.sample_iter", "db.res_count"):
        np.testing.assert_array_equal(card[name], cpu[name], err_msg=name)
    assert int(card["model.num_active"]) == 7
    for name in ("model.means", "model.log_weights"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)
