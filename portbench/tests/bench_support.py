"""Shared helpers of the benchmark's tests: tiny CPU versions of the cells
and the card fixture.

Run the tests from the root of the checkout:
``python -m pytest -p no:cacheprovider portbench/tests`` (the tests marked
``cuda``, a marker the repository's pytest settings register, skip
without a card; on the card they run the control).
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_specs(config_name: str, mix_name: str):
    """A cell's configuration and mix cut to a size a CPU test holds: a few
    initial components, 20 samples per component, 35 warm-up iterations
    (past the first add) and blocks of 10."""
    from portbench import core

    cfg = copy.deepcopy(core.load_json(
        core.BENCH_DIR / "configs" / f"{config_name}.json"))
    mix = copy.deepcopy(core.traffic_spec(mix_name))
    cfg["config"]["model_initialization"]["num_initial_components"] = 6
    cfg["sizes"] = {}
    mix["sizes"] = {}
    mix["warmup_iterations"], mix["block_iterations"] = 35, 10
    mix["module_configs"]["sample_selector_config"][
        "desired_samples_per_component"] = 20
    return cfg, mix


CELLS = [("planar_robot_4", "samtron")]


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")
