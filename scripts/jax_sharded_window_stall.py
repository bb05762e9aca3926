"""The JAX package's flagship ZAMTRUX on a 2-device data mesh, with the
sharded and with the global sample database, on the CPU: the ELBO (2,000
draws, key 99) and the fevals every 10 steps.

It shows the reference's sharded window dropping the iteration its count
bound falls in (``_gather_window_sharded``): once the background's
selection trims the requested count, the first add batch leaves the
window and the run stalls, where the global ring's does not.  The port
keeps that iteration (``gmmvi_tpu_torch/optimization/sample_db_sharded.py``).

Run from the repository root: ``python3 scripts/jax_sharded_window_stall.py
[--steps 60] [--layouts sharded global]`` (~5 minutes for both).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--layouts", nargs="+", default=["sharded", "global"])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    import jax.numpy as jnp

    import chip_smoke
    import gmmvi_tpu.configs as jcfg
    from gmmvi_tpu.experiments.setup import init_experiment
    from gmmvi_tpu.experiments.targets.student_t_mixture import make_target
    from gmmvi_tpu.models import gmm as G
    from gmmvi_tpu.optimization.gmmvi import GMMVI
    from gmmvi_tpu.parallel.mesh import data_mesh

    def elbo(g):
        s, _ = G.sample(g.state.model, jax.random.PRNGKey(99), 2000)
        return float(jnp.mean(g.target_distribution.log_density(s))
                     - jnp.mean(G.log_density(g.state.model, s)))

    for layout in args.layouts:
        cfg = jcfg.update_config(chip_smoke.flagship_config(
            codename="ZAMTRUX"), {"tpu": {"db_layout": layout}})
        cfg["target_fn"] = target = make_target(20, False, seed=0)
        _, model, meta = init_experiment(cfg)
        g = GMMVI.build_from_config(cfg, target, model, meta,
                                    mesh=data_mesh(2))
        t0 = time.time()
        for i in range(args.steps):
            g.train_iter()
            if i == 0 or i % 10 == 9:
                print(f"{layout} ({type(g.state.db).__name__}) step {i + 1}: "
                      f"ELBO {elbo(g):.4f}, fevals "
                      f"{int(g.state.db.num_samples_written)}, "
                      f"{time.time() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
