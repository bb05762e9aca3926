"""Replay a trust-region update whose rebuilt factors carried a large KL
on the card, through the JAX package and the port on the CPU.

``scripts/chip_smoke_phases.py --save-rebuild DIR`` writes, per watched
path, the slot whose rebuilt float32 factors had the largest KL(new || old)
over its bound eps: its old mean and factors, Hessian and gradient
estimates, bound, last and accepted eta, and the card's new mean and
factor.  This script rebuilds that update at the card's accepted eta with
the JAX package's ``_tr_final_full`` in float32 and in float64, runs JAX's
whole per-slot update (``_tr_update_one``, its own search: ``newton`` for a
file whose name says so, else ``bracket``) in float32, rebuilds it with the
port's ``_tr_final_full`` in float32 on the CPU, and prints each one's
KL(new || old) over eps (all KLs in float64 from the factors), one JSON
line per file: whether the card's KL is float32's rounding, shared by both
packages, or the port's own.

``JAX_PLATFORMS=cpu python3 scripts/jax_rebuild_kl.py
DIR/rebuild_stm300.npz [...]``
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def kl64(new_mean, new_chol, mean, chol) -> float:
    """KL(N(new_mean, new_chol new_chol^T) || N(mean, chol chol^T)) in
    float64."""
    import numpy as np

    lo = np.asarray(chol, np.float64)
    lo_new = np.asarray(new_chol, np.float64)
    inv = np.linalg.solve(lo, np.eye(lo.shape[0]))
    diff = inv @ (np.asarray(mean, np.float64)
                  - np.asarray(new_mean, np.float64))
    logdets = [2.0 * np.sum(np.log(np.diag(c))) for c in (lo, lo_new)]
    return float(0.5 * (np.sum(np.square(inv @ lo_new)) + diff @ diff
                        - lo.shape[0] + logdets[0] - logdets[1]))


def jax_rebuild(rec, dtype):
    """JAX's ``_tr_final_full`` at the card's eta, its inputs made as
    ``_tr_update_one`` makes them."""
    import jax.numpy as jnp

    from gmmvi_tpu.optimization import component_updaters as jcu

    mean, chol, inv_chol, hess, grads = (
        jnp.asarray(rec[n], dtype) for n in ("mean", "chol", "inv_chol",
                                              "hess", "grads"))
    d = mean.shape[0]
    reward_lin = hess @ mean - grads
    old_prec = inv_chol.T @ inv_chol
    kl_const = 2.0 * jnp.sum(jnp.log(jnp.diag(chol))) - d
    _, new_mean, new_chol, _ = jcu._tr_final_full(
        jnp.asarray(rec["eta"], dtype), old_prec @ mean, old_prec, inv_chol,
        reward_lin, hess, kl_const, mean)
    return new_mean, new_chol


def port_rebuild(rec):
    """The port's float32 ``_tr_final_full`` at the card's eta on the
    CPU."""
    import torch

    from gmmvi_tpu_torch.ops.trust_region import prepare_tr_kl_inputs
    from gmmvi_tpu_torch.optimization.component_updaters import \
        _tr_final_full

    mean, chol, inv_chol, hess, grads = (
        torch.as_tensor(rec[n])[None] for n in ("mean", "chol", "inv_chol",
                                                 "hess", "grads"))
    reward_quad = 0.5 * (hess + hess.mT)
    reward_lin = torch.einsum("kij,kj->ki", hess, mean) - grads
    inp = prepare_tr_kl_inputs(mean, chol, inv_chol, reward_lin,
                               reward_quad)
    _, new_mean, new_chol, _ = _tr_final_full(
        torch.as_tensor(rec["eta"])[None], inp.lin, inp.prec, inv_chol,
        reward_lin, reward_quad, inp.kl_const, mean)
    return new_mean[0].numpy(), new_chol[0].numpy()


def replay(path: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gmmvi_tpu.optimization import component_updaters as jcu

    rec = dict(np.load(path))
    eps = float(rec["eps"])
    old = (rec["mean"], rec["chol"])
    out = {"file": os.path.basename(path), "eps": eps,
           "card_eta": float(rec["eta"]),
           "card_kl_at_eta_over_eps": float(rec["kl_at_eta_over_eps"]),
           "card_kl_rebuilt_over_eps": kl64(rec["new_mean"], rec["new_chol"],
                                            *old) / eps}
    out["port_cpu_float32_over_eps"] = kl64(*port_rebuild(rec), *old) / eps
    out["jax_cpu_float32_over_eps"] = kl64(
        *[np.asarray(x) for x in jax_rebuild(rec, jnp.float32)], *old) / eps
    with jax.enable_x64(True):
        out["jax_cpu_float64_over_eps"] = kl64(
            *[np.asarray(x) for x in jax_rebuild(rec, jnp.float64)],
            *old) / eps
    search = "newton" if "newton" in os.path.basename(path) else "bracket"
    new_mean, new_chol, _, success, eta = jcu._tr_update_one(
        *(jnp.asarray(rec[n], jnp.float32)
          for n in ("mean", "chol", "inv_chol", "last_eta", "eps", "hess",
                    "grads")), jnp.asarray(True), 1.0, False, search)
    out.update(jax_search=search, jax_eta=float(eta),
               jax_accepted=bool(success),
               jax_update_float32_over_eps=kl64(np.asarray(new_mean),
                                                np.asarray(new_chol),
                                                *old) / eps)
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    for path in sys.argv[1:]:
        print(json.dumps(replay(path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
