#!/usr/bin/env python3
"""One ZAMTRUX step of the PyTorch port against the JAX package, from every
start state of a JAX run, with and without MORE's f32 fit.

Runs the JAX package's ZAMTRUX for 30 steps at the small scale of
``tests/torch_parity.py`` (D 6, Kmax 12, n_des 48, reuse ratio 2.0) and,
from each of its states, takes one step three ways, printing one JSON line
per state with the worst float entry as a multiple of the one-step bar
(rtol 1e-4 / atol 1e-5) and whether the integer leaves matched:

* ``f32``: the port's step against JAX's, both as they are;
* ``fit64``: both steps with their MORE fit replaced by the float64 fit of
  their own inputs (``tests/test_torch_reuse_more.py``'s stand-ins);
* ``jax_self``: JAX's own f32 step against its float64-fit step.

CPU only, about a minute: ``python3 scripts/torch_zamtrux_fit64_sweep.py``
from the repository root.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["GMMVI_FUSED_TR"] = "interpret"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gmmvi_tpu_torch  # noqa: E402
from gmmvi_tpu_torch.optimization import ng_estimators  # noqa: E402
from test_torch_reuse_more import (TRAJ_ITERS, _worst_of_bar,  # noqa: E402
                                   make_fit64_jax_step, port_more64)
from torch_parity import (build_pair, jax_state_leaves,  # noqa: E402
                          jax_step_draws)


def ints_equal(t_named: dict, j_named: dict) -> bool:
    return all(np.array_equal(got, j_named[name])
               for name, got in t_named.items()
               if not np.issubdtype(j_named[name].dtype, np.floating))


def main() -> int:
    torch.set_num_threads(4)
    jg, tg = build_pair(codename="ZAMTRUX")
    leaves, draws = [], []
    for _ in range(TRAJ_ITERS):
        leaves.append(jax_state_leaves(jg.state))
        draws.append(jax_step_draws(jg))
        jg.train_iter()
    leaves.append(jax_state_leaves(jg.state))
    step64, state_of = make_fit64_jax_step(jg, tg.state.model)

    def port_step(start: int) -> dict:
        tg.state = gmmvi_tpu_torch.state_from_numpy(
            leaves[start], device="cpu", like=tg.state)
        tg.train_iter(draws[start])
        return gmmvi_tpu_torch.state_to_numpy(tg.state)

    for start in range(1, TRAJ_ITERS):
        f32 = port_step(start)
        jax64 = jax_state_leaves(step64(state_of(leaves[start])))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ng_estimators, "more_estimate", port_more64)
            fit64 = port_step(start)
        want = leaves[start + 1]
        print(json.dumps({
            "start": start,
            "f32": _worst_of_bar(f32, want),
            "f32_ints_equal": ints_equal(f32, want),
            "fit64": _worst_of_bar(fit64, jax64),
            "fit64_ints_equal": ints_equal(fit64, jax64),
            "jax_self": _worst_of_bar(want, jax64)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
