"""Data-parallel training over ranks of ``torch.distributed``.  The
PyTorch twin of examples/7_data_parallel_mesh.py.

Each rank is one process: the per-iteration sample batch is split over the
ranks of a 1-D ``data`` mesh, the model and the optimizer state stay
replicated, and every per-component sum over the samples is all-reduced.
Ranks are started by ``parallel.mesh.spawn`` (``--ranks`` processes on
this host), or by ``torchrun``, which sets ``WORLD_SIZE``.  The backend is
yours: ``nccl`` with one rank per card, ``gloo`` on the CPU or for ranks
that share a card (NCCL refuses two ranks on one device).

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/7_data_parallel_mesh.py                    # one rank per card, NCCL
    PYTHONPATH=. python3 examples_torch/7_data_parallel_mesh.py --ranks 2 --backend gloo
    PYTHONPATH=. python3 examples_torch/7_data_parallel_mesh.py --device cpu --ranks 2
    PYTHONPATH=. torchrun --nproc-per-node 2 examples_torch/7_data_parallel_mesh.py --backend gloo
"""
import argparse
import os

import torch
import torch.distributed as dist

from gmmvi_tpu_torch.configs import get_default_algorithm_config, \
    update_config
from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
    make_target
from gmmvi_tpu_torch.parallel import mesh as mesh_lib
from gmmvi_tpu_torch.runner import GmmviRunner


def train(rank: int, nprocs: int, device_type: str, iterations: int) -> None:
    """One rank: SAMTRON on the 20-D Student-T mixture over a ``data``
    mesh of all ranks, 16 samples per component and rank."""
    if device_type == "cuda":
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    else:
        device = torch.device("cpu")
    mesh = mesh_lib.data_mesh(device_type=device_type)
    if rank == 0:
        print(f"mesh: {tuple(mesh.shape)} over {nprocs} ranks "
              f"({dist.get_backend()}, {device_type})", flush=True)
    config = update_config(get_default_algorithm_config("SAMTRON"), {
        "start_seed": 0,
        "target_fn": make_target(num_dimensions=20, harder_setting=False,
                                 seed=0, device=device),
        "environment_name": "stm20",
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 16,
            "prior_mean": 0.0, "prior_scale": 100.0, "initial_cov": 300.0,
        },
        "use_sample_database": True, "max_database_size": 10_000_000,
        "temperature": 1.0,
        # keep the sharded axis divisible by the mesh
        "sample_selector_config": {
            "desired_samples_per_component": 16 * nprocs,
            "ratio_reused_samples_to_desired": 0.0,
        },
        "num_component_adapter_config": {
            "del_iters": 100, "add_iters": 60, "max_components": 32,
            "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0],
            "min_weight_for_del_heuristic": 1e-6,
            "num_database_samples": 1024, "num_prior_samples": 0,
        },
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.1, "min_stepsize": 0.001,
            "max_stepsize": 1.0,
        },
        "gmmvi_runner_config": {"log_metrics_interval": 25},
        "tpu": {"max_components": 32},
    })
    runner = GmmviRunner.build_from_config(config, device=device, mesh=mesh)
    runner.target_distribution.make_plots = False
    for n in range(iterations):
        runner.iterate_and_log(n)
    elbo = -runner.get_expensive_metrics()["-elbo"]
    if rank == 0:
        print(f"ELBO after {iterations} iterations: {elbo:.5f}", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--iterations", type=int, default=101)
    parser.add_argument("--ranks", type=int, default=None,
                        help="processes to start (default: one per card, "
                             "2 on the CPU)")
    parser.add_argument("--backend", default=None,
                        help="nccl or gloo (default: nccl on cards, gloo "
                             "on the CPU)")
    args = parser.parse_args()
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu")
    if "WORLD_SIZE" in os.environ:          # started by torchrun
        mesh_lib.initialize_distributed(backend)
        try:
            train(dist.get_rank(), dist.get_world_size(), args.device,
                  args.iterations)
        finally:
            dist.destroy_process_group()
    else:
        ranks = args.ranks or (torch.cuda.device_count()
                               if args.device == "cuda" else 2)
        mesh_lib.spawn(train, ranks, backend,
                       args=(args.device, args.iterations))
