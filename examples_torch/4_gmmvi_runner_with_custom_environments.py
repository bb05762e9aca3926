"""A custom target written as a subclass of ``LNPDF``: a numpy Rosenbrock
with hand-coded gradients.  The PyTorch twin of
examples/4_gmmvi_runner_with_custom_environments.py.

The two flags of ``LNPDF.__init__`` say how the optimizer calls a target:
``use_log_density_and_grad=True`` makes a first-order estimator (Stein)
take the gradient from ``log_density_and_grad`` (False: autograd through
``log_density``, which numpy cannot give), and ``safe_for_jit=False``
hands the target only the proposal's valid rows, here read to the host as
numpy.  The results go back as tensors on the samples' device.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/4_gmmvi_runner_with_custom_environments.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from gmmvi_tpu_torch import LNPDF, GmmviRunner
from gmmvi_tpu_torch.configs import get_default_algorithm_config, \
    update_config


class Rosenbrock(LNPDF):
    """Negative Rosenbrock as an unnormalized target, implemented in numpy.
    Autograd cannot go through it, so use_log_density_and_grad=True
    supplies the gradients and safe_for_jit=False gives it the valid rows
    alone."""

    def __init__(self):
        super().__init__(use_log_density_and_grad=True, safe_for_jit=False)
        self.a, self.b = 1.0, 100.0

    def get_num_dimensions(self) -> int:
        return 2

    def log_density(self, samples):
        x = samples.detach().cpu().numpy()[:, 0]
        y = samples.detach().cpu().numpy()[:, 1]
        return torch.as_tensor(
            -((self.a - x) ** 2 + self.b * (y - x ** 2) ** 2),
            dtype=torch.float32, device=samples.device)

    def log_density_and_grad(self, samples):
        x = samples.detach().cpu().numpy()[:, 0]
        y = samples.detach().cpu().numpy()[:, 1]
        ld = -((self.a - x) ** 2 + self.b * (y - x ** 2) ** 2)
        gx = -(-2 * (self.a - x) - 4 * self.b * (y - x ** 2) * x)
        gy = -(2 * self.b * (y - x ** 2))
        return (torch.as_tensor(ld, dtype=torch.float32,
                                device=samples.device),
                torch.as_tensor(np.stack([gx, gy], 1), dtype=torch.float32,
                                device=samples.device))


def merged_config() -> dict:
    """SAMTRUX on a fresh Rosenbrock target, as the JAX example runs it."""
    environment_config = {
        "target_fn": Rosenbrock(),
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
    return update_config(algorithm_config, environment_config)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=500)
    args = parser.parse_args()

    runner = GmmviRunner.build_from_config(merged_config(),
                                           device=args.device)
    for n in range(args.iterations):
        runner.iterate_and_log(n)
    print(f"ELBO after {args.iterations} iterations: "
          f"{-runner.get_expensive_metrics()['-elbo']:.5f}")


if __name__ == "__main__":
    main()
