"""The PyTorch port's examples (``examples_torch/``) run on the CPU: each
script as a user runs it, in a fresh process from the repository root with
``PYTHONPATH=.``, with ``--device cpu --iterations 2`` (the meshed example
with two ranks over gloo), exits 0 and ends with a finite ELBO."""
import math
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")
SCRIPTS = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
_ELBO = re.compile(r"ELBO(?: after \d+ iterations)?: (\S+)")


def test_every_jax_example_has_a_twin():
    """``examples_torch/`` holds a script of the same name for each of
    ``examples/``'s, and the YAML config they read."""
    def names(folder):
        return sorted(f for f in os.listdir(os.path.join(REPO, folder))
                      if f.endswith((".py", ".yml")))

    assert names("examples_torch") == names("examples")
    assert len(SCRIPTS) == 8


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu(script):
    args = [sys.executable, os.path.join(EXAMPLES, script), "--device", "cpu",
            "--iterations", "2"]
    if script.startswith("7_"):
        args += ["--ranks", "2", "--backend", "gloo"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
           "MKL_NUM_THREADS": "2"}
    out = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    elbos = _ELBO.findall(out.stdout)
    assert elbos, out.stdout[-2000:]
    assert math.isfinite(float(elbos[-1]))
    assert out.stdout.rstrip().splitlines()[-1].startswith(
        "ELBO after 2 iterations:")
