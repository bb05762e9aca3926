"""Train through the GmmviRunner (metrics and logging).  The PyTorch twin
of examples/2_using_the_gmmvi_runner.py.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/2_using_the_gmmvi_runner.py [--device cpu]
"""
import argparse
import os

from gmmvi_tpu_torch.configs import load_yaml
from gmmvi_tpu_torch.runner import GmmviRunner

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--iterations", type=int, default=10001)
args = parser.parse_args()

my_path = os.path.dirname(os.path.realpath(__file__))
config = load_yaml(os.path.join(my_path, "example_config.yml"))
runner = GmmviRunner.build_from_config(config, device=args.device)

for n in range(args.iterations):
    runner.iterate_and_log(n)
print(f"ELBO after {args.iterations} iterations: "
      f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
