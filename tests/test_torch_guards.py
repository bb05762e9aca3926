"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
keeps its own copy of the YAML defaults, validates configs as the JAX
package does, runs on the card by default and names what it lacks."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import gmmvi_tpu_torch.configs as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gmmvi_tpu_torch")
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|gmmvi_tpu)\b", re.M)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    offenders = [f for f in files if _IMPORT.search(open(f).read())]
    assert offenders == []


def test_port_imports_with_jax_unavailable():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gmmvi_tpu'] = None; "
            "import gmmvi_tpu_torch, gmmvi_tpu_torch.experiments.setup, "
            "gmmvi_tpu_torch.optimization.gmmvi, gmmvi_tpu_torch.ops.cuda, "
            "gmmvi_tpu_torch.runner, gmmvi_tpu_torch.experiments.targets.gmm, "
            "gmmvi_tpu_torch.experiments.targets.talos_ik, "
            "gmmvi_tpu_torch.experiments.targets.bnn, "
            "gmmvi_tpu_torch.experiments.evaluation.mmd, "
            "gmmvi_tpu_torch.experiments.evaluation.plotting; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cuda_device_without_a_card_raises():
    from gmmvi_tpu_torch.device import resolve_device
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_target(4, False, seed=0)   # entry points default to the card
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("letter", sorted(tcfg.LETTER_DEFAULTS))
def test_letter_defaults_equal_the_yaml_files(letter):
    yaml = pytest.importorskip("yaml")
    from gmmvi_tpu.configs import LETTER_TO_PATH

    with open(LETTER_TO_PATH[letter]) as fh:
        assert tcfg.LETTER_DEFAULTS[letter] == yaml.safe_load(fh)
    assert set(tcfg.LETTER_DEFAULTS) == set(LETTER_TO_PATH)


def test_stm20_defaults_equal_the_yaml_file():
    yaml = pytest.importorskip("yaml")
    import gmmvi_tpu.configs as jcfg

    with open(os.path.join(REPO, "gmmvi_tpu", "configs",
                           "experiment_configs", "stm20.yml")) as fh:
        assert tcfg.get_default_experiment_config("stm20") == \
            yaml.safe_load(fh)
    assert tcfg.get_default_config("SAMTRON", "stm20") == \
        jcfg.get_default_config("SAMTRON", "stm20")
    assert tcfg.ALL_CODENAME_LETTERS == jcfg.ALL_CODENAME_LETTERS
    for experiment in ("wine", "talos"):
        with open(os.path.join(REPO, "gmmvi_tpu", "configs",
                               "experiment_configs",
                               f"{experiment}.yml")) as fh:
            assert tcfg.get_default_experiment_config(experiment) == \
                yaml.safe_load(fh)


def test_stm300_defaults_equal_the_yaml_file():
    """The large-D experiment: its defaults equal stm300.yml, and SAMTRON
    on it is configured as in the JAX package."""
    yaml = pytest.importorskip("yaml")
    import gmmvi_tpu.configs as jcfg

    with open(os.path.join(REPO, "gmmvi_tpu", "configs",
                           "experiment_configs", "stm300.yml")) as fh:
        assert tcfg.get_default_experiment_config("stm300") == \
            yaml.safe_load(fh)
    assert tcfg.get_default_config("SAMTRON", "stm300") == \
        jcfg.get_default_config("SAMTRON", "stm300")
    tcfg.validate_config(tcfg.get_default_config("SAMTRON", "stm300"))


@pytest.mark.parametrize("experiment", ["gmm20", "gmm100"])
def test_gmm_defaults_equal_the_yaml_file(experiment):
    """The GMM experiments the runner path takes: their defaults equal
    their YAML files, and SAMTRON on them is configured as in the JAX
    package."""
    yaml = pytest.importorskip("yaml")
    import gmmvi_tpu.configs as jcfg

    with open(os.path.join(REPO, "gmmvi_tpu", "configs",
                           "experiment_configs", f"{experiment}.yml")) as fh:
        assert tcfg.get_default_experiment_config(experiment) == \
            yaml.safe_load(fh)
    assert tcfg.get_default_config("SAMTRON", experiment) == \
        jcfg.get_default_config("SAMTRON", experiment)
    tcfg.validate_config(tcfg.get_default_config("SAMTRON", experiment))


def _bad_configs():
    good = tcfg.get_default_config("SAMTRON", "stm20")
    return [
        tcfg.update_config(good, {"ng_estimator_type": "Steen"}),
        tcfg.update_config(good, {"tpu": {"max_component": 8}}),
        {k: v for k, v in good.items() if k != "temperature"},
        tcfg.update_config(good, {"tpu": {"db_layout": "ring"}}),
        {k: v for k, v in good.items() if k != "sample_selector_config"},
    ]


@pytest.mark.parametrize("case", range(5))
def test_validate_config_reports_as_jax_does(case):
    import gmmvi_tpu.configs as jcfg

    cfg = _bad_configs()[case]
    with pytest.raises(jcfg.ConfigError) as jerr:
        jcfg.validate_config(cfg)
    with pytest.raises(tcfg.ConfigError) as terr:
        tcfg.validate_config(cfg)
    assert str(terr.value) == str(jerr.value)
    tcfg.validate_config(tcfg.get_default_config("SAMTRON", "stm20"))


def _small_samtron():
    """(config, target, model, meta) of a small SAMTRON run on the CPU."""
    from torch_parity import samtron_overrides
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target

    cfg = tcfg.update_config(tcfg.get_default_algorithm_config("SAMTRON"),
                             samtron_overrides(n_des=4, kmax=4, k0=2))
    target = make_target(3, False, seed=0, device="cpu")
    cfg["target_fn"] = target
    _, model, meta = init_experiment(cfg, device="cpu")
    return cfg, target, model, meta


@pytest.mark.parametrize("override,missing", [
    ({"environment_name": "MNIST", "environment_config": {}}, "MNIST"),
])
def test_paths_not_ported_raise(override, missing):
    """Every module of the codename matrix is ported, for full and diagonal
    covariances; what is not raises NotImplementedError naming itself: a
    target not ported yet where the registry looks it up."""
    from gmmvi_tpu_torch.experiments.setup import get_target_lnpdf

    cfg = tcfg.update_config(_small_samtron()[0], override)
    with pytest.raises(NotImplementedError, match=missing):
        get_target_lnpdf(cfg["environment_name"], cfg["environment_config"],
                         0, device="cpu")


@pytest.mark.parametrize("override", [
    {"tpu": {"db_eviction": "decimate"}},
    {"tpu": {"debug_nans": True}},
    {"tpu": {"trust_region_search": "newton"}},
    {"num_component_adapter_config": {"num_prior_samples": 5}},
])
def test_settings_that_raised_build_and_step(override):
    """The settings that raised NotImplementedError until the port had
    them build from the same config (the model made without the override)
    and take a step to a finite state."""
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg, target, model, meta = _small_samtron()
    g = GMMVI.build_from_config(tcfg.update_config(cfg, override), target,
                                model, meta, device="cpu")
    g.train_iter()
    assert g.num_updates == 1
    assert torch.isfinite(g.model.means).all()
    assert int(g.state.db.num_samples_written) > 0


def test_meshes_raise():
    """A data or component axis of more than one rank needs a process
    group (one process per rank, ``parallel.mesh.initialize_distributed``):
    without one, building the optimizer raises and names it.  Meshed runs
    themselves are held in tests/test_torch_mesh.py."""
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg, target, model, meta = _small_samtron()
    for key in ("data_shards", "comp_shards"):
        with pytest.raises(RuntimeError, match="initialize_distributed"):
            GMMVI.build_from_config(
                tcfg.update_config(cfg, {"tpu": {key: 2}}), target, model,
                meta, device="cpu")


@pytest.mark.parametrize("shards", [1, "all"])
def test_one_rank_without_a_group_is_unmeshed(shards):
    """``tpu.data_shards`` of one rank (1, or ``"all"`` of a world of one)
    without a process group builds an unmeshed run on the global ring, as
    the port did before it had meshes: two steps equal to the bit to the
    run without the key."""
    import gmmvi_tpu_torch
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    states = []
    for over in ({}, {"tpu": {"data_shards": shards}}):
        cfg, target, model, meta = _small_samtron()
        g = GMMVI.build_from_config(tcfg.update_config(cfg, over), target,
                                    model, meta, device="cpu")
        assert g.mesh is None
        assert type(g.state.db).__name__ == "SampleDbState"
        g.train_iters(2)
        states.append(gmmvi_tpu_torch.state_to_numpy(g.state))
    assert set(states[0]) == set(states[1])
    for k in states[0]:
        np.testing.assert_array_equal(states[1][k], states[0][k], err_msg=k)


@pytest.mark.parametrize("kernel", ["background", "more"])
def test_kernel_wrappers_raise_outside_their_envelope(kernel):
    """The background takes D <= 512 (B4 up to 128, B5's mixture output
    above it), B8 D <= 45 (the JAX kernels' envelopes)."""
    from gmmvi_tpu_torch.ops import background, more

    if kernel == "background":
        d = 513
        args = [torch.zeros(2, d), torch.eye(d).expand(2, d, d).contiguous(),
                torch.zeros(2), torch.zeros(2), torch.zeros(3, d)]
        with pytest.raises(NotImplementedError, match="B5"):
            background.background_logpdf(*args)
        for d in (128, 129):
            args[0], args[1], args[4] = (torch.zeros(2, d),
                                         torch.eye(d).expand(2, d, d)
                                         .contiguous(), torch.zeros(3, d))
            assert background.background_logpdf(*args).shape == (3,)
    else:
        d = 46
        args = [torch.eye(d).expand(2, d, d).contiguous(), torch.zeros(2, d),
                torch.zeros(2, 3), torch.zeros(3), torch.zeros(3, d)]
        with pytest.raises(NotImplementedError, match="D <= 45"):
            more.more_grams(*args)
        args[0], args[1], args[4] = (torch.eye(45).expand(2, 45, 45)
                                     .contiguous(), torch.zeros(2, 45),
                                     torch.zeros(3, 45))
        assert more.more_grams(*args)[0].shape == (2, 1081, 1081)


def test_generator_draws_are_reproducible():
    """Without injected draws a run is a function of its seed."""
    from torch_parity import samtron_overrides
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    means = []
    for _ in range(2):
        cfg = tcfg.update_config(
            tcfg.get_default_algorithm_config("SAMTRON"),
            samtron_overrides(n_des=8, kmax=6, k0=3, add_iters=3))
        target = make_target(3, False, seed=0, device="cpu")
        cfg["target_fn"] = target
        _, model, meta = init_experiment(cfg, device="cpu")
        g = GMMVI.build_from_config(cfg, target, model, meta, device="cpu")
        g.train_iters(7)
        assert int(g.model.num_active) == 5   # adds at 3 and 6
        assert torch.isfinite(g.model.means).all()
        means.append(g.model.means)
    assert torch.equal(means[0], means[1])
