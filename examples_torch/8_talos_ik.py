"""Humanoid inverse kinematics: the 34-DoF Talos posterior.  The PyTorch
twin of examples/8_talos_ik.py: the forward kinematics of the bundled URDF
in torch, differentiated by autograd, on the samples' device.

The mixture discovers several IK solutions that place the left gripper at
``context`` while keeping both feet planted and the centre of mass over the
support.

Run from the repository root:
    PYTHONPATH=. python3 examples_torch/8_talos_ik.py [--device cpu]
"""
import argparse

from gmmvi_tpu_torch.configs import get_default_config, update_config
from gmmvi_tpu_torch.runner import GmmviRunner

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--iterations", type=int, default=500)
args = parser.parse_args()

config = get_default_config("SAMTRON", "talos")
config = update_config(config, {
    # the experiment's defaults, with an evaluation every 50 iterations and
    # 32 component slots for an interactive demo
    "gmmvi_runner_config": {"log_metrics_interval": 50},
    "tpu": {"max_components": 32},
})

runner = GmmviRunner.build_from_config(config, device=args.device)
for n in range(args.iterations):
    runner.iterate_and_log(n)
print(f"ELBO after {args.iterations} iterations: "
      f"{-runner.get_expensive_metrics()['-elbo']:.5f}")
