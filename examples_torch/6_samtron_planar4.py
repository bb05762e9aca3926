"""SAMTRON on the 4-goal planar-robot IK experiment with the paper's
hyperparameters (100 initial components; by default iterations until 30
minutes have passed, as the paper's runs).  The PyTorch twin of
examples/6_samtron_planar4.py.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/6_samtron_planar4.py [--device cpu] [--iterations N]
"""
import argparse
from time import time

from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                     get_default_experiment_config,
                                     update_config)
from gmmvi_tpu_torch.runner import GmmviRunner


def run(seed: int = 0, max_seconds: float = 30 * 60, iters=None,
        device="cuda") -> GmmviRunner:
    """Iterate until ``max_seconds`` have passed, or ``iters`` times."""
    environment_config = get_default_experiment_config("planar_robot_4")
    environment_config = update_config(environment_config,
                                       {"start_seed": seed})
    algorithm_config = get_default_algorithm_config("SAMTRON")
    used_hyperparameters = {
        "num_component_adapter_config": {"del_iters": 10, "add_iters": 1},
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.1, "min_stepsize": 0.001,
            "max_stepsize": 1.0,
        },
        "sample_selector_config": {
            "desired_samples_per_component": 100,
            "ratio_reused_samples_to_desired": 0.0,
        },
        "weight_stepsize_adapter_config": {"initial_stepsize": 5},
        "model_initialization": {"num_initial_components": 100},
        "gmmvi_runner_config": {"log_metrics_interval": 10},
        "tpu": {"max_components": 192},
    }
    algorithm_config = update_config(algorithm_config, used_hyperparameters)
    config = update_config(environment_config, algorithm_config)

    runner = GmmviRunner.build_from_config(config=config, device=device)
    start = time()
    n = 0
    while (n < iters) if iters is not None else \
            (time() - start < max_seconds):
        runner.iterate_and_log(n)
        n += 1
    return runner


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=None)
    args = parser.parse_args()
    runner = run(0, iters=args.iterations, device=args.device)
    print(f"ELBO after {len(runner.wall_times)} iterations: "
          f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
