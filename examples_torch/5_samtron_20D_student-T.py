"""SAMTRON on the 20-D mixture-of-Student-T experiment with the paper's
hyperparameters, the flagship configuration.  The PyTorch twin of
examples/5_samtron_20D_student-T.py.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/5_samtron_20D_student-T.py [--device cpu]
"""
import argparse

from gmmvi_tpu_torch.configs import (get_default_algorithm_config,
                                     get_default_experiment_config,
                                     update_config)
from gmmvi_tpu_torch.runner import GmmviRunner


def run(seed: int = 0, iters: int = 1501, device="cuda") -> GmmviRunner:
    algorithm_config = get_default_algorithm_config("SAMTRON")
    environment_config = get_default_experiment_config("stm20")
    environment_config = update_config(environment_config,
                                       {"start_seed": seed})
    used_hyperparameters = {
        "num_component_adapter_config": {"del_iters": 100, "add_iters": 60},
        "component_stepsize_adapter_config": {
            "initial_stepsize": 0.1, "min_stepsize": 0.001,
            "max_stepsize": 1.0,
        },
        "sample_selector_config": {
            "desired_samples_per_component": 200,
            "ratio_reused_samples_to_desired": 0.0,
        },
        "weight_stepsize_adapter_config": {"initial_stepsize": 1},
        "model_initialization": {"num_initial_components": 45},
        "gmmvi_runner_config": {"log_metrics_interval": 100},
        "tpu": {"max_components": 80},
    }
    algorithm_config = update_config(algorithm_config, used_hyperparameters)
    config = update_config(environment_config, algorithm_config)

    runner = GmmviRunner.build_from_config(config=config, device=device)
    # the marginals figure (needs matplotlib) is not shown by a script
    runner.target_distribution.make_plots = False
    for n in range(iters):
        runner.iterate_and_log(n)
    return runner


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=1501)
    args = parser.parse_args()
    runner = run(0, args.iterations, args.device)
    print(f"ELBO after {args.iterations} iterations: "
          f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
