"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: small flagship-shaped configs, JAX's random draws for one training
step, leaf-by-leaf state comparison, and both packages' states and targets
in float64 (for comparisons that f32 rounding, amplified by the problem's
conditioning, would decide).  Not a test module itself."""
from __future__ import annotations

import contextlib
import fcntl
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

# the trajectory scale of tests/test_full_optimizer_parity.py
DIMS, KMAX, N_DES, K0 = 6, 12, 48, 8


def samtron_overrides(n_des=N_DES, kmax=KMAX, k0=K0, del_iters=100,
                      add_iters=30, seed=0):
    """SAMTRON with the small-run overrides of scripts/compare_reference.py
    (no sample reuse, 100*I initial covariances)."""
    return {
        "seed": seed, "start_seed": seed, "temperature": 1.0,
        "environment_name": "stm",
        "sample_selector_config": {
            "desired_samples_per_component": n_des,
            "ratio_reused_samples_to_desired": 0.0},
        "use_sample_database": True, "max_database_size": 10_000_000,
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": k0,
            "prior_mean": 0.0, "prior_scale": 20.0, "initial_cov": 100.0},
        "component_stepsize_adapter_config": {"initial_stepsize": 0.1},
        "num_component_adapter_config": {
            "del_iters": del_iters, "add_iters": add_iters,
            "max_components": kmax,
            "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0, 200.0,
                                             100.0, 50.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 1024, "num_prior_samples": 0},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": kmax},
    }


def zamtrux_overrides(ratio=2.0, **kw):
    """ZAMTRUX (VIPS: MORE, direct weight update, fixed weight stepsize)
    with the small-run overrides of :func:`samtron_overrides`, but with the
    M letter's sample reuse (``ratio_reused_samples_to_desired`` 2.0)."""
    over = samtron_overrides(**kw)
    over["sample_selector_config"]["ratio_reused_samples_to_desired"] = ratio
    return over


def codename_overrides(codename, **kw):
    """The small-run overrides of :func:`samtron_overrides` (ZAMTRUX: of
    :func:`zamtrux_overrides`) for any codename; with fixed adaptation (the
    E letter) without the VIPS settings, as scripts/compare_reference.py
    builds it."""
    over = (zamtrux_overrides if codename == "ZAMTRUX"
            else samtron_overrides)(**kw)
    if codename[1].upper() == "E":
        del over["num_component_adapter_config"]
    return over


def standard_iw_overrides():
    """Standard (not self-normalized) importance weights in the estimator
    and the weight updater."""
    return {section: {"use_self_normalized_importance_weights": False}
            for section in ("ng_estimator_config", "weight_updater_config")}


def build_pair(dims=DIMS, codename="SAMTRON", ratio=None, extra=None, **kw):
    """(jax_gmmvi, torch_gmmvi) on the same Student-T target and the same
    initial mixture, both on the CPU; ``codename`` with its overrides
    above, ``ratio`` (when given) the sample reuse, ``extra`` further
    overrides."""
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment as j_init
    from gmmvi_tpu.experiments.targets.student_t_mixture import \
        make_target as j_target
    from gmmvi_tpu.optimization.gmmvi import GMMVI as JGMMVI

    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment as t_init
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target as t_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI as TGMMVI

    over = codename_overrides(codename, **kw)
    if ratio is not None:
        over["sample_selector_config"]["ratio_reused_samples_to_desired"] = \
            ratio
    if extra:
        over = tcfg.update_config(over, extra)
    jt = j_target(dims, False, seed=0)
    jc = jcfg.update_config(jcfg.get_default_algorithm_config(codename),
                            over)
    jc["target_fn"] = jt
    _, jm, jmeta = j_init(jc)
    jg = JGMMVI.build_from_config(jc, jt, jm, jmeta)

    tt = t_target(dims, False, seed=0, device="cpu")
    tc = tcfg.update_config(tcfg.get_default_algorithm_config(codename),
                            over)
    tc["target_fn"] = tt
    _, tm, tmeta = t_init(tc, device="cpu")
    tg = TGMMVI.build_from_config(tc, tt, tm, tmeta, device="cpu")
    return jg, tg


def jax_step_draws(jax_gmmvi, key=None, kmax=None, dtype=jnp.float32):
    """The random numbers JAX's next ``_full_step`` consumes, recomputed
    from its key with the same splits (gmmvi.py ``_propose_phase`` and
    ``_update_phase``, sample_selectors.propose, sample_db.add_samples,
    add_new_component), as a StepDraws for the port.  ``key`` and ``kmax``
    (the state's key and padded capacity by default) let a caller recompute
    a step's draws after the step, at the capacity it grew to first.
    ``dtype`` is the state's float type (JAX draws its normals in it; under
    ``jax.enable_x64`` its uniforms are float64 too).  The mixture-based
    selector draws ``n_des`` component indices by the state's weights and
    ``[n_des, D]`` normals; without VIPS nothing is drawn for an add.  With
    prior samples the key is split once more before the update phase's
    split (``_full_step``); a decimating database draws no reservoir slots,
    and its add candidates, like those of a ring without a database, come
    from ``[S]`` uniforms (``db_u``) instead of a reservoir permutation.  A
    sharded database (``db_layout: sharded`` on a mesh, ``[P, ...]``
    leaves) draws its reservoir slots and accept uniforms ``[P, B / P]``
    and its candidates per shard: ``[P, ceil(n / P)]`` from a permutation
    of each shard's slots, or ``[P, S]`` uniforms without a database."""
    from gmmvi_tpu.models import gmm as jgmm
    from gmmvi_tpu_torch import StepDraws

    st = jax_gmmvi.state
    key = st.key if key is None else key
    kmax = st.model.max_components if kmax is None else kmax
    d = st.model.num_dimensions
    n_des = jax_gmmvi.selector_cfg.desired_samples_per_component
    sharded = hasattr(st.db, "n_shards")
    ring = sharded or hasattr(st.db, "reservoir_capacity")
    c = (st.db.reservoir_capacity_local if sharded
         else st.db.reservoir_capacity if ring else 0)
    key1, k_sel = jax.random.split(key)
    mapping = None
    if jax_gmmvi.selector_cfg.is_vips:
        b = kmax * n_des
        eps = jax.random.normal(k_sel, (kmax, n_des, d), dtype)
    else:
        b = n_des
        cat_key, eps_key = jax.random.split(k_sel)
        mapping = jgmm.sample_categorical(st.model, cat_key, n_des)
        eps = jax.random.normal(eps_key, (n_des, d), dtype)
    vips = jax_gmmvi.vips_cfg
    prior_eps = None
    if vips is not None and vips.num_prior_samples > 0 \
            and jax_gmmvi.prior_mean is not None:
        key1, k_prior = jax.random.split(key1)
        prior_eps = jax.random.normal(
            k_prior, (vips.num_prior_samples, d))
    _, k_db, k_adapt = jax.random.split(key1, 3)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype)

    draws = StepDraws(eps=t(eps), rand_slots=None, accept_u=None)
    if ring:
        slot_key, acc_key = jax.random.split(k_db)
        shape = (st.db.n_shards, b // st.db.n_shards) if sharded else (b,)
        draws.rand_slots = t(jax.random.randint(slot_key, shape, 0, c),
                             torch.int32)
        draws.accept_u = t(jax.random.uniform(acc_key, shape))
    if mapping is not None:
        draws.mapping = t(mapping, torch.int64)
    if prior_eps is not None:
        draws.prior_eps = t(prior_eps)
    if vips is not None:
        db_key, a_key = jax.random.split(k_adapt)
        if sharded and st.db.keep_samples:
            n_l = -(-vips.num_database_samples // st.db.n_shards)
            draws.db_perm = t(jax.vmap(lambda k: jax.random.permutation(
                k, c))(jax.random.split(db_key, st.db.n_shards))[:, :n_l],
                torch.int64)
        elif sharded:
            draws.db_u = t(jax.random.uniform(
                db_key, (st.db.n_shards, st.db.capacity_local)))
        elif ring and st.db.keep_samples:
            draws.db_perm = t(jax.random.permutation(db_key, c)[
                :vips.num_database_samples], torch.int64)
        else:
            draws.db_u = t(jax.random.uniform(db_key, (st.db.capacity,)))
        draws.add_a = t(jax.random.uniform(a_key, ()))
    return draws


def jax_eval_draws(eval_key, model, dtype=jnp.float32):
    """The component indices and normals (of the model's float type
    ``dtype``) of the JAX runner's next evaluation
    (``get_expensive_metrics`` from ``eval_key``) of ``model``, as tensors
    for the port."""
    from gmmvi_tpu.ops.stable import NEG_INF

    _, key = jax.random.split(eval_key)
    k_key, n_key = jax.random.split(key)
    comp = jax.random.categorical(
        k_key, jnp.where(model.mask, model.log_weights, NEG_INF),
        shape=(2000,))
    eps = jax.random.normal(n_key, (2000, model.num_dimensions), dtype)
    return (torch.as_tensor(np.array(comp)),
            torch.as_tensor(np.array(eps)))


@contextlib.contextmanager
def xdist_lock(tmp_path_factory, name: str):
    """Hold an exclusive lock shared by this test run's pytest-xdist
    workers, yielding the run's shared path prefix; without xdist, no lock
    and ``None``.  The port's heavy test files run their tests one at a
    time under the lock ``"tests"``: each keeps several cores busy with
    torch's and XLA's threads, and a few at once starved the JAX tests that
    rendezvous over an 8-device CPU mesh (tests/test_sharded_db.py aborted
    under that load)."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run_id is None:
        yield None
        return
    base = tmp_path_factory.getbasetemp().parent / f"torch_{run_id}"
    with open(f"{base}.{name}.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield base


def jax_state_leaves(state) -> dict:
    """The JAX TrainState's leaves as numpy arrays keyed by pytree path."""
    from gmmvi_tpu.utils.checkpoint import _named_leaves

    return {k: np.asarray(v) for k, v in _named_leaves(state).items()}


def assert_states_match(t_named: dict, j_named: dict, rtol=1e-4,
                        atol=1e-5):
    """Integer leaves exactly, float leaves within rtol/atol (nan and inf
    in the same places), every port leaf against its JAX leaf."""
    for name, got in t_named.items():
        want = j_named[name]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=name)


def mc_elbo(model_logpdf, target_logpdf, means, chols, log_weights,
            num_active, rng_state=99, n=2000, with_se=False):
    """ELBO estimate from n mixture draws made with numpy (component by
    inverse CDF of shared uniforms, then mu + L eps, or mu + sigma * eps for
    a diagonal model's ``chols`` ``[K, D]``); with ``with_se``,
    (estimate, its Monte Carlo standard error)."""
    rng = np.random.RandomState(rng_state)
    k = num_active
    w = np.exp(log_weights[:k].astype(np.float64))
    comp = np.minimum(np.searchsorted(np.cumsum(w / w.sum()),
                                      rng.uniform(size=n)), k - 1)
    eps = rng.standard_normal((n, means.shape[1])).astype(np.float32)
    if chols.ndim == 2:                        # diagonal: standard deviations
        x = means[comp] + chols[comp] * eps
    else:
        x = means[comp] + np.einsum("nij,nj->ni", chols[comp], eps)
    ratios = target_logpdf(x) - model_logpdf(x)
    if with_se:
        return float(np.mean(ratios)), float(np.std(ratios) / np.sqrt(n))
    return float(np.mean(ratios))


# ---------------------------------------------------------------------------
# float64 on both sides
# ---------------------------------------------------------------------------

def as_float64(named: dict) -> dict:
    """State leaves with every float32 array cast (exactly) to float64."""
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in named.items()}


def jax_state_from_leaves(like, named: dict):
    """A JAX pytree shaped like ``like`` holding the arrays of ``named``
    (keyed by path, as :func:`jax_state_leaves` gives them) in their own
    dtypes; call under ``jax.enable_x64(True)`` for float64 leaves."""
    from gmmvi_tpu.utils.checkpoint import _path_str

    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(named[_path_str(p)]) for p, _ in flat])


def port_target_to_float64(target) -> None:
    """The port's Student-T, GMM, full-batch logistic-regression, Talos or
    BNN target ``target`` evaluated in float64 from here on, in place (the
    Talos and BNN targets already evaluate in the samples' float type,
    their float32 constants and data cast exactly): the Student-T's
    and the regression's float32 parameters (the Student-T's factored in
    float64 on the host) and data cast exactly, the GMM's factors made anew in
    float64 from its float32 covariances (in float32 the factors of the
    star target's covariances, condition number 100, carry rounding that
    its gradients magnify; JAX's float64 copy does the same)."""
    from gmmvi_tpu_torch.models.gmm import create_gmm_state

    if hasattr(target, "tree") or hasattr(target, "_x_tr"):
        return                  # Talos, BNN: in the samples' float type
    if hasattr(target, "labels"):                        # logistic regr.
        for name in ("data", "labels"):
            setattr(target, name, getattr(target, name).double())
    elif hasattr(target, "_inv_chols"):                  # Student-T mixture
        for name in ("_means", "_chols", "_inv_chols", "_log_dets",
                     "_log_w"):
            setattr(target, name, getattr(target, name).double())
    else:                                                # GMM
        target._state = create_gmm_state(
            target.target_weights, target.target_means, target.target_covs,
            device=target._state.device, dtype=torch.float64)


def jax_target_in_float64(target):
    """A copy of JAX's Student-T, GMM, full-batch logistic-regression,
    Talos or BNN target ``target`` that evaluates in float64 under
    ``jax.enable_x64(True)`` (call it there).  Its
    parameters are the original's float32 values cast exactly (the GMM's
    factors made anew in float64 from its covariances, as
    :func:`port_target_to_float64` does); its
    ``log_density`` and ``log_density_and_grad`` are the original's
    formulas without their cast of the samples to float32 (the JAX
    targets evaluate in float32 whatever the samples' type)."""
    import copy

    from gmmvi_tpu.experiments.targets import gmm as jtg
    from gmmvi_tpu.experiments.targets import logistic_regression as jlr
    from gmmvi_tpu.experiments.targets import student_t_mixture as jstm
    from gmmvi_tpu.models import gmm as jgmm

    def f64(v):
        return jnp.asarray(np.asarray(v), jnp.float64)

    class StudentT64(type(target)):
        def log_density(self, x):
            return jax.scipy.special.logsumexp(
                self._component_log_probs(x) + self._log_w[:, None], axis=0)

        def log_density_and_grad(self, x):
            # jstm.StudentTMixture_LNPDF.log_density_and_grad's formula
            nu, d = self.alpha, self.get_num_dimensions()
            y, maha = self._whiten(x)
            weighted = self._log_probs_from_maha(maha) + self._log_w[:, None]
            ld = jax.scipy.special.logsumexp(weighted, axis=0)
            scale = jnp.exp(weighted - ld[None, :]) * (nu + d) / (nu + maha)
            return ld, -jnp.einsum("kij,kni,kn->nj", self._inv_chols, y,
                                   scale,
                                   precision=jax.lax.Precision.HIGHEST)

    class Gmm64(type(target)):
        def log_density(self, x):
            return jgmm.log_density(self._state, x)

        def log_density_and_grad(self, x):
            return jgmm.log_density_and_grad(self._state, x)[:2]

    class LogReg64(type(target)):
        def _z(self, theta):
            return -jnp.einsum("nf,pf->np", self.data, theta,
                               precision=jax.lax.Precision.HIGHEST)

        def log_density(self, theta):
            z = self._z(theta)
            return jnp.sum(jlr._stable_loglik_terms(z, self.labels), axis=0) \
                + self.log_prior(theta)

        def log_density_and_grad(self, theta):
            # jlr.LogisticRegression.log_density_and_grad's formula
            z = self._z(theta)
            coeff = jax.nn.sigmoid(z) - self.labels[:, None]
            grad = jnp.einsum("np,nf->pf", coeff, self.data,
                              precision=jax.lax.Precision.HIGHEST) \
                - (theta - self.prior_mean) / self.prior_std ** 2
            return self.log_density(theta), grad

    class Bnn64(type(target)):
        def log_density_and_grad(self, x):
            # jbnn.BNN_LNPDF.log_density_and_grad without its float32 cast
            feats, labels = self._next_batches(x.shape[0])
            if getattr(self, "_grad_fn64", None) is None:
                self._grad_fn64 = jax.jit(
                    jax.vmap(jax.value_and_grad(self._posterior_one)))
            return self._grad_fn64(x, f64(feats), f64(labels))

    from gmmvi_tpu.experiments.targets import bnn as jbnn
    from gmmvi_tpu.experiments.targets import talos_ik as jtalos

    out = copy.copy(target)
    if isinstance(target, jtalos.Talos):
        return out           # its formulas keep the samples' float type
    if isinstance(target, jbnn.BNN_LNPDF):
        out.__class__ = Bnn64
        return out
    if isinstance(target, jlr.LogisticRegression) and \
            not isinstance(target, jlr.LogisticRegression_minibatch):
        out.__class__ = LogReg64
        out.data, out.labels = f64(target.data), f64(target.labels)
    elif isinstance(target, jstm.StudentTMixture_LNPDF):
        out.__class__ = StudentT64
        for name in ("_chols", "_inv_chols", "_log_dets", "_log_w"):
            setattr(out, name, f64(getattr(target, name)))
        out.target_means = target.target_means.astype(np.float64)
    elif isinstance(target, jtg.GMM_LNPDF):
        out.__class__ = Gmm64
        out._state = jgmm.create_gmm_state(
            target.target_weights, target.target_means, target.target_covs,
            dtype=jnp.float64)
    else:
        raise TypeError(f"no float64 copy of {type(target).__name__}")
    return out
