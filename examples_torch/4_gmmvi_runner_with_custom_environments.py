"""A custom target outside torch: a numpy Rosenbrock with hand-coded
gradients, run through the host-target path.  The PyTorch twin of
examples/4_gmmvi_runner_with_custom_environments.py.

``HostLNPDF`` wraps numpy callables: it is not ``safe_for_jit``, so every
step hands it the proposal's valid rows as a float32 numpy array and takes
its results back onto the samples' device.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/4_gmmvi_runner_with_custom_environments.py [--device cpu]
"""
import argparse

import numpy as np

from gmmvi_tpu_torch.configs import get_default_algorithm_config, \
    update_config
from gmmvi_tpu_torch.experiments.targets.talos_ik import HostLNPDF
from gmmvi_tpu_torch.runner import GmmviRunner

A, B = 1.0, 100.0


def rosenbrock(samples: np.ndarray) -> np.ndarray:
    """Negative Rosenbrock as an unnormalized log density."""
    x, y = samples[:, 0], samples[:, 1]
    return -((A - x) ** 2 + B * (y - x ** 2) ** 2)


def rosenbrock_and_grad(samples: np.ndarray):
    x, y = samples[:, 0], samples[:, 1]
    gx = -(-2 * (A - x) - 4 * B * (y - x ** 2) * x)
    gy = -(2 * B * (y - x ** 2))
    return rosenbrock(samples), np.stack([gx, gy], 1)


parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--iterations", type=int, default=500)
args = parser.parse_args()

environment_config = {
    "target_fn": HostLNPDF(2, rosenbrock, rosenbrock_and_grad),
    "start_seed": 0,
    "environment_name": "Rosenbrock",
    "model_initialization": {
        "use_diagonal_covs": False,
        "num_initial_components": 1,
        "prior_mean": 0.0,
        "prior_scale": 1.0,
        "initial_cov": 1.0,
    },
    "gmmvi_runner_config": {"log_metrics_interval": 100},
    "use_sample_database": True,
    "max_database_size": int(1e6),
    "temperature": 1.0,
    "tpu": {"max_components": 32},
}

algorithm_config = get_default_algorithm_config("SAMTRUX")
merged_config = update_config(algorithm_config, environment_config)
runner = GmmviRunner.build_from_config(merged_config, device=args.device)

for n in range(args.iterations):
    runner.iterate_and_log(n)
print(f"ELBO after {args.iterations} iterations: "
      f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
