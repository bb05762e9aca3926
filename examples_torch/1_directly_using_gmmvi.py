"""Drive the GMMVI optimizer directly (no runner): build a target, an
initial model and a GMMVI instance from a config, then call train_iter()
yourself.  The PyTorch twin of examples/1_directly_using_gmmvi.py.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/1_directly_using_gmmvi.py [--device cpu]
"""
import argparse
import os

import torch

from gmmvi_tpu_torch.configs import load_yaml
from gmmvi_tpu_torch.experiments.setup import construct_initial_mixture
from gmmvi_tpu_torch.experiments.targets.logistic_regression import \
    make_breast_cancer
from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models import meta as meta_ops
from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--iterations", type=int, default=1001)
args = parser.parse_args()

my_path = os.path.dirname(os.path.realpath(__file__))
config = load_yaml(os.path.join(my_path, "example_config.yml"))

# 1. a target distribution
target_distribution = make_breast_cancer(device=args.device)

# 2. an initial (padded) model + meta-state
dims = target_distribution.get_num_dimensions()
model = construct_initial_mixture(
    num_dimensions=dims, num_initial_components=1, prior_mean=0.0,
    prior_scale=10.0, use_diagonal_covs=False, initial_cov=100.0,
    max_components=config["tpu"]["max_components"], device=args.device,
)
meta = meta_ops.create_meta_state(
    model,
    initial_stepsize=config["component_stepsize_adapter_config"][
        "initial_stepsize"],
    initial_regularizer=1e-12,
    max_reward_history_length=meta_ops.history_length_from_config(config),
)

# 3. the optimizer
gmmvi = GMMVI.build_from_config(config, target_distribution, model, meta,
                                device=args.device)
generator = torch.Generator(device=model.device).manual_seed(0)


def elbo() -> float:
    state = gmmvi.state.model
    samples, _ = gmm_ops.sample(state, 1000, generator)
    return float(torch.mean(target_distribution.log_density(samples)
                            - gmm_ops.log_density(state, samples)))


for n in range(args.iterations):
    gmmvi.train_iter()
    if n % 100 == 0:
        print(f"{n}/{args.iterations}: {int(gmmvi.state.model.num_active)} "
              f"components, elbo {elbo():.3f}")
print(f"ELBO after {args.iterations} iterations: {elbo():.5f}")
