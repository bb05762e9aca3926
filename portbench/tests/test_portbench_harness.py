"""The harness on the CPU: the registry by name, the replay, the result's
keys, the refusal without a card and the import guard."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import core, harness
from portbench.tests.bench_support import CELLS, ROOT, tiny_specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_file_keeps_the_contract():
    bench = core.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (core.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (core.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert core.plugin("metrics", m["name"]) is not None, m["name"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_file_is_found_by_name():
    bench = core.load_benchmark()
    for entry in bench["workloads"]:
        cell = core.find_cell(bench, entry["name"])
        assert core.config_spec(cell)["name"] == cell["config"]
        assert core.traffic_spec(cell["traffic"])["name"] == cell["traffic"]
        assert set(core.limits_spec(cell["name"])) >= {"target_lnpdf"}
        for name in core.metric_names(bench, cell["name"], "per_layer"):
            assert hasattr(core.plugin("metrics", name), "read")
    for config, mix in CELLS:
        assert core.load_json(core.BENCH_DIR / "configs" / f"{config}.json")
        assert core.traffic_spec(mix)["name"] == mix
        assert core.limits_spec(f"{config}.{mix}")


def test_a_dropped_in_file_is_picked_up(tmp_path):
    """A new mix, configuration, metric and cell in a copy of the
    benchmark are found and run without an edit to any file there."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.load_benchmark()
    bdir = tmp_path / "portbench"
    mix = core.traffic_spec("samtron")
    mix["name"] = "samtron_copy"
    (bdir / "traffic" / "samtron_copy.json").write_text(json.dumps(mix))
    cfg = core.load_json(core.BENCH_DIR / "configs" / "planar_robot_4.json")
    cfg["name"] = "planar_copy"
    (bdir / "configs" / "planar_copy.json").write_text(json.dumps(cfg))
    planar = dict(name="planar_copy", source=bench["configs"][0]["source"],
                  file="portbench/configs/planar_copy.json", reduced=[],
                  why="a copy of planar_robot_4 under a new name")
    (bdir / "metrics" / "constant_one.py").write_text(
        'UNIT = "count"\n\n\ndef read(record):\n    return 1.0\n')
    (bdir / "limits" / "planar_copy.samtron_copy.json").write_text(
        (core.BENCH_DIR / "limits" / "planar_robot_4.samtron.json")
        .read_text())
    bench["configs"].append(planar)
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="planar_copy.samtron_copy",
                                   config="planar_copy",
                                   traffic="samtron_copy"))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="constant_one", unit="count",
                                   workloads=["planar_copy.samtron_copy"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import core, harness\n"
        "from portbench.tests.bench_support import tiny_specs\n"
        "assert core.BENCH_DIR == __import__('pathlib').Path("
        f"{str(bdir)!r}).resolve()\n"
        "bench = core.load_benchmark()\n"
        "cell = core.find_cell(bench, 'planar_copy.samtron_copy')\n"
        "assert core.config_spec(cell)['name'] == 'planar_copy'\n"
        "assert core.traffic_spec(cell['traffic'])['name'] == 'samtron_copy'\n"
        "cfg, mix = tiny_specs('planar_copy', 'samtron_copy')\n"
        "out = harness.measure(cell['name'], cfg, mix, 7, 0.0, True, 'cpu',\n"
        "    core.limits_spec(cell['name']),\n"
        "    per_layer=core.metric_names(bench, cell['name'], 'per_layer'),\n"
        "    max_iterations=3)\n"
        "print(json.dumps(out['metrics']))\n")
    run = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    metrics = json.loads(run.stdout.strip().splitlines()[-1])
    assert metrics["constant_one"] == {"value": 1.0, "unit": "count"}


@pytest.mark.parametrize("config,mix", CELLS)
def test_two_replayed_blocks_are_equal(config, mix):
    cfg, spec = tiny_specs(config, mix)
    _, replay = core.prepare(cfg, spec, 11, "cpu")
    opt = replay.opt
    ends = []

    def keep(i):
        if (i + 1) % replay.block == 0:
            ends.append(core.clone_state(opt.state))

    core.run_window(replay, 1e9, after=keep,
                    max_iterations=2 * replay.block)
    assert len(ends) == 2
    first, second = ends
    for part in ("model", "meta", "db", "wstep", "adapt"):
        a, b = getattr(first, part), getattr(second, part)
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f"{part}.{f}"
    assert first.num_updates == second.num_updates == \
        replay.snapshot.num_updates + replay.block


def test_the_result_line_has_the_contract_keys():
    cfg, mix = tiny_specs("planar_robot_4", "samtron")
    out = harness.measure(
        "planar_robot_4.samtron", cfg, mix, 2 ** 31 + 12345, 0.0, False,
        "cpu", core.limits_spec("planar_robot_4.samtron"),
        metric_names=["step_device_ms", "peak_mem_mb", "setup_s"],
        max_iterations=2)
    keys = list(out)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # the card's busy time has no reading on the CPU, so it is left out
    assert set(out["metrics"]) == {"peak_mem_mb", "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "planar_robot_4.samtron",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode not in (0, None)
    assert not any(line.startswith("{") for line in run.stdout.splitlines())


FORBIDDEN_RUN = {"jax", "jaxlib", "flax", "gmmvi_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    for path in core.BENCH_DIR.rglob("*.py"):
        found = set(_imports(path)) & FORBIDDEN_RUN
        assert not found, f"{path}: {found}"
    for path in (core.BENCH_DIR / "reference").rglob("*.py"):
        found = set(_imports(path)) & (FORBIDDEN_RUN | {"gmmvi_tpu_torch"})
        assert not found, f"{path}: {found}"


def test_a_run_loads_no_jax_and_the_reference_not_the_program():
    script = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.check as check\n"
        "check.ref_modules()\n"
        "import portbench.reference.experiments.setup\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'gmmvi_tpu', 'gmmvi_tpu_torch'))\n"
        "assert not bad, bad\n"
        "from portbench import core, harness\n"
        "from portbench.tests.bench_support import tiny_specs\n"
        "cfg, mix = tiny_specs('planar_robot_4', 'samtron')\n"
        "harness.measure('planar_robot_4.samtron', cfg, mix, 5, 0.0, True, 'cpu',\n"
        "    core.limits_spec('planar_robot_4.samtron'), max_iterations=2)\n"
        "assert not harness.forbidden_modules(), harness.forbidden_modules()\n"
        "assert 'gmmvi_tpu_torch' in sys.modules\n")
    run = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["gmmvi_tpu_torch", "gmmvi_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "gmmvi_tpu.ops"]) == [
        "gmmvi_tpu.ops", "jax.numpy"]


def test_the_window_opens_one_session_a_block():
    """``session`` is entered before each block's restore and left after
    its last iteration, or the window's, and never left open."""
    cfg, spec = tiny_specs("planar_robot_4", "samtron")
    _, replay = core.prepare(cfg, spec, 13, "cpu")
    log = []

    class Session:
        def __enter__(self):
            log.append(("enter", replay.opt.state.num_updates))

        def __exit__(self, *exc):
            log.append(("exit", replay.opt.state.num_updates))

    window = core.run_window(replay, 1e9, session=Session,
                             max_iterations=2 * replay.block + 3)
    start = replay.snapshot.num_updates
    assert window.blocks == 3
    assert [k for k, _ in log] == ["enter", "exit"] * 3
    assert [n for k, n in log if k == "exit"] == [
        start + replay.block, start + replay.block, start + 3]


class _Event:
    def __init__(self, start, end, name="k", device="DeviceType.CUDA",
                 mark=False):
        self._s, self._e, self._n = start, end, name
        self._d, self._m = device, mark

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._m


def test_device_busy_is_the_union_of_the_cards_work():
    """Overlaps count once; host events and marks on the card's timeline
    are no work."""
    from types import SimpleNamespace

    from portbench import trace

    events = [_Event(0, 10), _Event(5, 20), _Event(30, 40),
              _Event(0, 100, device="DeviceType.CPU"),
              _Event(0, 100, name="portbench.train_iter"),
              _Event(50, 90, name="range", mark=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert trace.device_busy_s(prof) == pytest.approx(30e-9)
