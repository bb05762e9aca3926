"""The fused trust-region search (kernel B3 as one launch per search, its
plain version on the CPU) against the lockstep host loop it replaces, a
loop per component, and the JAX package's ``_bracketing_search_batched``
around the interpret-mode Pallas B3.

The kernel runs every component's bisection to its end in its own block,
so on the card the search is K independent loops where the host loop ran
them in lockstep; these tests hold that the two are the same search
(equal etas, success masks and per-component trips) on inputs with
inactive slots, cold and warm starts, infeasible small etas and a
component that stops on the bracket's width.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gmmvi_tpu_torch.ops import trust_region as ttr

torch.set_num_threads(2)

K, D = 8, 5


def _problem(dtype=torch.float32):
    """K components at D with indefinite curvature (small etas make the
    interpolated precision not positive definite): ``(arrays, inp, bound,
    lower0, upper0, active)``.  Slots 0, 2, 4 cold-start over [-20, 80];
    1, 3, 5 warm-start around a last eta as the updater brackets it; slot
    6 starts on a bracket narrower than the width stop; slot 7 is
    inactive."""
    rng = np.random.RandomState(11)
    means = rng.randn(K, D) * 3
    a = rng.randn(K, D, D) * 0.4
    covs = np.einsum("kij,klj->kil", a, a) + np.eye(D)
    chols = np.linalg.cholesky(covs)
    inv = np.stack([np.linalg.inv(c) for c in chols])
    h = rng.randn(K, D, D) * 0.5
    rq = np.einsum("kij,klj->kil", h, h) - 0.3 * np.eye(D)
    rl = rng.randn(K, D)
    arrays = [v.astype(np.float32) for v in (means, chols, inv, rl, rq)]
    inp = ttr.prepare_tr_kl_inputs(*[torch.as_tensor(v).to(dtype)
                                     for v in arrays])
    bound = np.array([0.05, 0.01, 0.5, 0.05, 0.002, 1.0, 0.05, 0.05],
                     np.float32)
    last = np.array([-1, 3.0, -1, 40.0, -1, 0.2, 5.0, -1], np.float32)
    log_last = np.log(np.abs(last) + 1e-30)
    lower0 = np.where(last < 0, -20.0, np.maximum(log_last - 3.0, 0.0))
    upper0 = np.where(last < 0, 80.0, log_last + 3.0)
    lower0[6], upper0[6] = log_last[6], log_last[6] + 1e-3
    active = np.arange(K) < K - 1
    return (arrays, inp, *[torch.as_tensor(v.astype(np.float32)).to(dtype)
                           for v in (bound, lower0, upper0)],
            torch.as_tensor(active))


def _lockstep_loop_before_fusion(kl_eval, kl_bound, lower0, upper0, active):
    """The host loop the updater ran before the fused search, as it was:
    one "all done" flag read per trip, one trip count for the loop."""
    lower, upper = lower0, upper0
    upper_ok = torch.zeros(lower0.shape, dtype=torch.bool)
    done = torch.logical_not(active)
    trips = 0
    while trips < 1000 and not bool(done.all()):
        act = torch.logical_not(done)
        eta = 0.5 * (lower + upper)
        kl = kl_eval(torch.exp(eta))
        diff = torch.minimum(torch.exp(upper) - torch.exp(eta),
                             torch.exp(eta) - torch.exp(lower))
        stop_width = diff < 1e-1
        good = torch.abs(kl_bound - kl) < 1e-1 * kl_bound
        go_low = kl_bound > kl
        new_lower = torch.where(
            stop_width, lower,
            torch.where(good, eta, torch.where(go_low, lower, eta)))
        new_upper = torch.where(
            stop_width, upper,
            torch.where(good, eta, torch.where(go_low, eta, upper)))
        new_upper_ok = torch.where(
            ~stop_width & ~good, upper_ok | go_low, upper_ok)
        lower = torch.where(act, new_lower, lower)
        upper = torch.where(act, new_upper, upper)
        upper_ok = torch.where(act, new_upper_ok, upper_ok)
        done = torch.where(act, stop_width | good, done)
        trips += 1
    lower = torch.where(upper_ok, upper, lower)
    return torch.exp(lower), torch.exp(upper), trips


def _one_component(inp, k, bound, lower0, upper0):
    """Component k's search alone, as one block of the kernel runs it: its
    own loop over its own KL, to its own end."""
    one = ttr.TrKlInputs(*[t[k:k + 1] for t in inp])
    return ttr.bracket_search(lambda e: ttr.tr_kl_plain(e, one),
                              bound[k:k + 1], lower0[k:k + 1],
                              upper0[k:k + 1])


@pytest.fixture(scope="module")
def problem():
    return _problem()


def test_tr_search_equals_the_host_loop_it_replaces(problem):
    """On the CPU the fused search's plain version gives exactly the etas
    of the lockstep loop the updater ran before it (copied above as it
    was), and its slowest component's trips are that loop's trips; every
    case occurs: an inactive slot (no trip, exp(lower0)), the width stop on
    the first trip, successes (exp(lower) == exp(upper)) from cold starts
    (one on the width stop with an upper end inside the bound, one on
    |KL - bound| < 0.1 bound) and a warm start, and stops short of the
    bound."""
    _, inp, bound, lower0, upper0, active = problem
    got = ttr.tr_search(inp, bound, lower0, upper0, active)
    want = _lockstep_loop_before_fusion(
        lambda e: ttr.tr_kl_plain(e, inp), bound, lower0, upper0, active)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    trips = got[2]
    assert trips.dtype == torch.int32
    assert int(trips.max()) == want[2]
    assert int(trips[7]) == 0 and float(got[0][7]) == float(
        torch.exp(lower0[7]))
    assert int(trips[6]) == 1 and float(got[0][6]) != float(got[1][6])
    success = got[0] == got[1]
    assert bool(success[[0, 3, 4]].all())
    assert not bool(success[[1, 5, 6, 7]].any())
    assert len(set(trips[:7].tolist())) > 2


def test_tr_search_equals_a_loop_per_component(problem):
    """The lockstep search and K independent searches, one per component
    (what a block of the kernel runs), give the same etas and trips, to
    the bit: a component's bracket depends on its own KL alone."""
    _, inp, bound, lower0, upper0, active = problem
    got = ttr.tr_search(inp, bound, lower0, upper0, active)
    for k in range(K - 1):
        lo, up, n = _one_component(inp, k, bound, lower0, upper0)
        assert float(lo) == float(got[0][k]), k
        assert float(up) == float(got[1][k]), k
        assert int(n) == int(got[2][k]), k


def test_tr_search_checks_inputs(problem):
    _, inp, bound, lower0, upper0, active = problem
    with pytest.raises(ValueError, match="lower0"):
        ttr.tr_search(inp, bound, lower0[:3], upper0, active)
    with pytest.raises(TypeError, match="kl_bound"):
        ttr.tr_search(inp, bound.double(), lower0, upper0, active)
    with pytest.raises(ValueError, match="active"):
        ttr.tr_search(inp, bound, lower0, upper0, active.float())
    with pytest.raises(NotImplementedError, match="D <= 64"):
        big = ttr.TrKlInputs(*[
            torch.zeros(t.shape[:1] + (65,) * (t.dim() - 1)) for t in inp])
        ttr.tr_search(big, bound, lower0, upper0, active)


@pytest.fixture(scope="module")
def jax_search(problem):
    """JAX's ``_bracketing_search_batched`` around the Pallas B3 in
    interpret mode (its KL float32, as the kernel writes it), the bracket
    in float64; run once for the module."""
    from gmmvi_tpu.ops import pallas_trust_region as jptr
    from gmmvi_tpu.optimization import component_updaters as jcu

    arrays, _, bound, lower0, upper0, active = problem
    with jax.enable_x64(True):
        packed = jptr.prepare_tr_kl_inputs(*[jnp.asarray(v) for v in arrays])

        def kl_eval(etas):
            return jptr.batched_tr_kl(etas.astype(jnp.float32), packed, d=D,
                                      interpret=True).astype(jnp.float64)

        lo, up = jcu._bracketing_search_batched(
            kl_eval, jnp.asarray(bound.numpy(), jnp.float64),
            jnp.asarray(lower0.numpy(), jnp.float64),
            jnp.asarray(upper0.numpy(), jnp.float64),
            active=jnp.asarray(active.numpy()))
        return np.asarray(lo), np.asarray(up)


def test_tr_search_matches_jax_bracketing_search(problem, jax_search):
    """In float64 on both sides (the port's plain KL in float64, JAX's
    bracket around its float32 interpret-mode kernel): the same success
    masks and the same etas (rtol 1e-9: the brackets take the same
    decisions, the two exps differ in their last bits at most)."""
    arrays, _, bound, lower0, upper0, active = problem
    inp64 = ttr.prepare_tr_kl_inputs(*[torch.as_tensor(v).double()
                                       for v in arrays])
    lo, up, _ = ttr.tr_search(inp64, bound.double(), lower0.double(),
                              upper0.double(), active)
    jlo, jup = jax_search
    np.testing.assert_array_equal(lo.numpy() == up.numpy(), jlo == jup)
    np.testing.assert_allclose(lo.numpy(), jlo, rtol=1e-9, atol=0)
    np.testing.assert_allclose(up.numpy(), jup, rtol=1e-9, atol=0)
