"""The comparison that decides ``correct``: the reference holds the port's
CPU path equal at a tiny size, and a run whose timed path is broken
underneath reads ``correct`` false, once for each fault a cell can have
(one card: no exchange between chips to leave out).  The control, the
reference with TF32 on in the program's place, runs on the card."""
import pytest
import torch

from portbench import check, core, faults, harness
from portbench.tests.bench_support import CELLS, card, tiny_specs  # noqa: F401


def run(config, mix, seed=21, iterations=2):
    cfg, spec = tiny_specs(config, mix)
    name = f"{config}.{mix}"
    return harness.measure(name, cfg, spec, seed, 0.0, False, "cpu",
                           core.limits_spec(name),
                           max_iterations=iterations)


def sound(values: dict, limits: dict) -> bool:
    """The exact numbers 0, every number within the cell's limit."""
    return all((v == 0.0 if k.endswith("mismatch") else True)
               and (k not in limits or v <= limits[k])
               for k, v in values.items())


@pytest.mark.parametrize("config,mix", CELLS)
@pytest.mark.parametrize("seed", [21, 2 ** 31 + 7])
def test_the_reference_holds_the_cpu_path_equal(config, mix, seed):
    """The port's CPU path (its plain versions in float32) against the
    float64 reference: within every limit of the cell."""
    out = run(config, mix, seed=seed)
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert set(values) == set(check.NUMBERS)
    assert sound(values, core.limits_spec(f"{config}.{mix}")), values
    assert out["correct"]


@pytest.mark.parametrize("config,mix", CELLS)
def test_the_reference_in_float32_is_sound(config, mix):
    """The reference's own float32 step, with TF32 off, in the program's
    place: sound too."""
    cfg_spec, spec = tiny_specs(config, mix)
    cfg, replay = core.prepare(cfg_spec, spec, 5, "cpu")
    opt, dev = replay.opt, replay.device
    rows = check.comp_rows(5, core.built_sizes(opt)["window_rows"])
    draws = opt.draw(replay.snapshot.num_updates)
    cand = check.reference_step(cfg, replay.snapshot, draws, rows, dev,
                                tf32=False)
    numbers = check.judge(cand, cfg, replay.snapshot, dev)
    assert sound(numbers, core.limits_spec(f"{config}.{mix}")), numbers


@pytest.mark.parametrize("config,mix", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_reads_incorrect(config, mix, fault):
    """Each fault of ``portbench/faults.py`` underneath the run's timed
    path: ``correct`` false."""
    with faults.FAULTS[fault]():
        out = run(config, mix)
    assert not out["correct"], {k: c["value"]
                                for k, c in out["checks"].items()}


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card):  # noqa: F811
    """Every cell at its own size on the card, three seeds: the program's
    step within every limit, the control's (the reference with TF32 on,
    in the program's place) outside one on each seed."""
    from portbench import calibrate

    bench = core.load_benchmark()
    for entry in bench["workloads"]:
        limits = core.limits_spec(entry["name"])
        lines = list(calibrate.readings(entry["name"], [7, 8, 2 ** 31 + 9],
                                        True, card))
        for line in lines:
            numbers = {k: line[k] for k in check.NUMBERS}
            ok, _ = check.verdict(numbers, limits)
            assert ok == (line["side"] == "program"), line


@pytest.mark.parametrize("config,mix", CELLS)
def test_the_reference_step_equals_the_cpu_path(config, mix):
    """The reference's whole step (``portbench/reference/step.py``, which
    makes the warmed state) against the port's CPU path, from the same
    initial state with the same draws: one step, every leaf of the state
    within 1e-5 of its scale (the program's bucketed target evaluation
    batches the rows otherwise), the integer leaves equal."""
    from portbench.reference.step import ReferenceGMMVI

    cfg_spec, spec = tiny_specs(config, mix)
    cfg, opt = core.build_cell(cfg_spec, spec, "cpu")
    ref = ReferenceGMMVI(cfg, "cpu")
    opt.train_iter()
    ref.train_iter()
    assert opt.state.num_updates == ref.state.num_updates == 1
    for part in ("model", "meta", "db", "wstep", "adapt"):
        a, b = getattr(opt.state, part), getattr(ref.state, part)
        for name in a.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            if not isinstance(x, torch.Tensor):
                assert x == y, f"{part}.{name}"
            elif x.is_floating_point():
                both = torch.isfinite(x) & torch.isfinite(y)
                assert torch.equal(torch.isfinite(x), torch.isfinite(y))
                scale = float(torch.where(both, y.abs(), 0).max()) \
                    if y.numel() else 0.0
                gap = float(torch.where(both, (x - y).abs(), 0).max()) \
                    if y.numel() else 0.0
                assert gap <= 1e-5 * max(scale, 1.0), f"{part}.{name}"
            else:
                assert torch.equal(x, y), f"{part}.{name}"
