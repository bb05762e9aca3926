"""GmmviRunner: the training loop with metrics, logging, dumps and resume.

(JAX counterpart: gmmvi_tpu/runner.py)

The same metric names and cadence as the JAX package: cheap metrics every
iteration (``num_samples``, the cumulative target evaluations;
``num_components``; ``max_weight``; the database sizes), fetched from the
card in one copy; expensive metrics every ``log_metrics_interval``
iterations (``-elbo``, ``entropy`` and ``target_density`` from 2,000 draws
of the mixture, the target's own metrics, MMD when configured, the
cumulative ``algo_time``), a console line, npz model dumps, and
checkpoints that resume exactly (``utils/checkpoint.py``).  On the card the
evaluation's two mixture log-densities (the model's, and a GMM target's)
run through kernel B9.

A meshed run (``tpu.data_shards`` / ``tpu.comp_shards``, or ``mesh=``)
builds the runner in every rank; all ranks step, only rank 0 prints and
writes dumps and checkpoints.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.setup import init_experiment
from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.optimization.gmmvi import GMMVI
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.utils import checkpoint as ckpt

NUM_EVAL_SAMPLES = 2000


def get_process_memory() -> int:
    """The process's resident memory in bytes (needs psutil)."""
    import psutil

    return psutil.Process(os.getpid()).memory_info().rss


def sample_elbo(model: GmmState, target, temperature: float,
                num_samples: int = NUM_EVAL_SAMPLES,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(``{"-elbo", "entropy", "target_density"}``, samples) from
    ``num_samples`` draws of the mixture: the entropy is minus the mean
    model log-density, the target density the mean target log-density,
    the ELBO ``target_density + temperature * entropy``.  ``draws``
    (component indices, standard normals) replace the generator's, so a
    test can inject the JAX package's."""
    comp, eps = draws if draws is not None else (None, None)
    samples, _ = gmm_ops.sample(model, num_samples, generator, comp=comp,
                                eps=eps)
    entropy, mean_reward = torch.stack([
        -torch.mean(gmm_ops.log_density(model, samples)),
        torch.mean(target.log_density(samples))]).tolist()
    elbo = mean_reward + temperature * entropy
    return ({"-elbo": -elbo, "entropy": entropy,
             "target_density": mean_reward}, samples)


class GmmviRunner:
    """Builds the experiment from a config and drives ``GMMVI.train_iter``
    with the JAX package's metrics.  ``device`` defaults to the card;
    without one it raises unless given ``"cpu"``."""

    def __init__(self, config: dict, log_metrics_interval: int,
                 device="cuda", mesh=None):
        from gmmvi_tpu_torch.configs import validate_config

        validate_config(config, require_target="target_fn" not in config)
        if "seed" not in config:
            if "start_seed" not in config:
                raise ValueError("config needs 'seed' or 'start_seed' (the "
                                 "reference experiment configs set "
                                 "start_seed)")
            config["seed"] = config["start_seed"]
        self.config = config
        self.device = resolve_device(device)
        self.log_metrics_interval = int(log_metrics_interval)
        self.wall_times = []

        target, model, meta = init_experiment(config, device=self.device)
        self.gmmvi = GMMVI.build_from_config(config, target, model, meta,
                                             device=self.device, mesh=mesh)
        self.is_writer = (self.gmmvi.mesh is None
                          or torch.distributed.get_rank() == 0)
        self.target_distribution = target
        self.eval_generator = torch.Generator(device=self.device).manual_seed(
            int(config["seed"]) + 7777)

        if "mmd_evaluation_config" in config:
            from gmmvi_tpu_torch.experiments.evaluation.mmd import MMD

            mc = config["mmd_evaluation_config"]
            self.mmd = MMD(np.load(mc["sample_dir"]), mc["alpha"],
                           device=self.device)
        else:
            self.mmd = None

        if "dump_gmm_path" in config:
            self.dump_gmms = True
            self.dump_gmm_path = os.path.join(config["dump_gmm_path"],
                                              str(time.time()))
            os.makedirs(self.dump_gmm_path, exist_ok=True)
        else:
            self.dump_gmms = False

    @staticmethod
    def build_from_config(config: dict, device="cuda", mesh=None
                          ) -> "GmmviRunner":
        """The runner of ``config``; ``mesh`` (a ``DeviceMesh``) by
        default the one ``tpu.data_shards`` / ``tpu.comp_shards`` ask for
        (``parallel.mesh.mesh_from_config``), or None."""
        if mesh is None:
            from gmmvi_tpu_torch.parallel.mesh import mesh_from_config

            mesh = mesh_from_config(config.get("tpu", {}) or {},
                                    device_type=resolve_device(device).type)
        return GmmviRunner(config=config, device=device, mesh=mesh,
                           **config["gmmvi_runner_config"])

    # ------------------------------------------------------------------
    def get_cheap_metrics(self) -> dict:
        """One copy from the card of all cheap metrics."""
        st = self.gmmvi.state
        with reduce.scope(self.gmmvi.mesh):
            db_size, num_dists = st.db.size_metrics()
        vals = torch.stack([
            st.db.num_samples_written.double(), st.model.num_active.double(),
            torch.max(st.model.weights).double(), db_size, num_dists,
        ]).tolist()
        return {"num_samples": int(vals[0]), "num_components": int(vals[1]),
                "max_weight": float(vals[2]),
                "num_db_samples": int(vals[3]),
                "num_db_components": int(vals[4])}

    def get_expensive_metrics(
            self, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> dict:
        """ELBO, entropy and target density from 2,000 draws of the
        mixture (``draws`` replaces the evaluation generator's), the
        cumulative ``algo_time``, the target's metrics and MMD."""
        model = self.gmmvi.state.model
        metrics, samples = sample_elbo(model, self.target_distribution,
                                       self.gmmvi.temperature,
                                       generator=self.eval_generator,
                                       draws=draws)
        metrics["algo_time"] = float(np.sum(self.wall_times))
        metrics.update(self.target_distribution.expensive_metrics(model,
                                                                  samples))
        if self.mmd is not None:
            metrics["MMD"] = self.mmd.compute_MMD(samples)
        return metrics

    def iterate_and_log(self, n: int) -> dict:
        """One training iteration (wall time read after the card is done),
        its cheap metrics and, every ``log_metrics_interval`` iterations,
        the expensive ones with a console line."""
        output = {}
        t0 = time.time()
        self.gmmvi.train_iter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_time = time.time() - t0
        self.wall_times.append(wall_time)
        output["walltime"] = wall_time
        output.update(self.get_cheap_metrics())

        if n % self.log_metrics_interval == 0:
            eval_dict = self.get_expensive_metrics()
            output.update(eval_dict)
            if not self.is_writer:
                return output
            print("Checkpoint {:3d} | FEVALS: {:10d} | avg. sample logpdf: "
                  "{:05.05f} | ELBO: {:05.05f}".format(
                      n, output["num_samples"], eval_dict["target_density"],
                      -eval_dict["-elbo"]))
            print(f"{output['num_components']} components\n")
        return output

    # ------------------------------------------------------------------
    def log_to_disk(self, n: int) -> None:
        """npz model dumps: every iteration below 100, then every 50th."""
        if not (self.dump_gmms and self.is_writer):
            return
        if n < 100 or n % 50 == 0:
            self._dump(os.path.join(self.dump_gmm_path, f"gmm_dump_{n}.npz"))

    def finalize(self) -> None:
        if self.dump_gmms and self.is_writer:
            self._dump(os.path.join(self.dump_gmm_path, "final_gmm_dump.npz"))

    def _dump(self, path: str) -> None:
        model = self.gmmvi.state.model
        k = int(model.num_active)
        np.savez(path, weights=model.weights[:k].cpu().numpy(),
                 means=model.means[:k].cpu().numpy(),
                 covs=model.covs[:k].cpu().numpy(),
                 timestamps=time.time(),
                 fevals=int(self.gmmvi.state.db.num_samples_written))

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """The full training state and the generator's state: a run
        resumed from it takes the steps an unbroken run takes.  On a mesh
        every rank calls it and rank 0 writes."""
        with reduce.scope(self.gmmvi.mesh):
            ckpt.save_state(path, self.gmmvi.state, self.gmmvi.generator)

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint of this config (the port's, or the JAX
        package's, whose random key is ignored), first growing the padded
        capacity to the file's where VIPS had grown it."""
        self.gmmvi.grow_capacity(ckpt.stored_max_components(path))
        with reduce.scope(self.gmmvi.mesh):
            state, gen = ckpt.load_state(path, self.gmmvi.state,
                                         device=self.device)
        self.gmmvi.state = state
        if gen is not None:
            self.gmmvi.generator.set_state(gen)
