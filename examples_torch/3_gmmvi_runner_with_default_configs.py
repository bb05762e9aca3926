"""Assemble a run from codename + experiment defaults: SAMYROX on gmm20.
The PyTorch twin of examples/3_gmmvi_runner_with_default_configs.py.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/3_gmmvi_runner_with_default_configs.py [--device cpu]
"""
import argparse

import gmmvi_tpu_torch.configs as configs
from gmmvi_tpu_torch.runner import GmmviRunner

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--iterations", type=int, default=1500)
args = parser.parse_args()

algorithm_config = configs.get_default_algorithm_config("SAMYROX")

# The per-slot defaults are chosen independently; the improvement-based
# initial stepsize suits trust-region updates ("T"), not direct/iBLR steps
# ("I"/"Y") — override for SAMYROX:
algorithm_config = configs.update_config(algorithm_config, {
    "component_stepsize_adapter_config": {
        "initial_stepsize": 0.0001,
        "min_stepsize": 0.0001,
        "max_stepsize": 0.001,
    }
})

environment_config = configs.get_default_experiment_config("gmm20")
config = configs.update_config(algorithm_config, environment_config)

runner = GmmviRunner.build_from_config(config, device=args.device)
# the marginals figure (needs matplotlib) is not shown by a script
runner.target_distribution.make_plots = False
for n in range(args.iterations):
    runner.iterate_and_log(n)
print(f"ELBO after {args.iterations} iterations: "
      f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
