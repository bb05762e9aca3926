"""The benchmark's registry, cell construction, replay and measured window.

Everything is found by name: ``BENCHMARK.json`` at the root of the checkout
names each cell's configuration and traffic mix; a configuration's file is
the ``file`` of its entry there, a mix is ``portbench/traffic/<mix>.json``,
a per-layer metric is ``portbench/metrics/<metric>.py``, a kernel's counts
are ``portbench/counts/<kernel>.py`` and a cell's limits are
``portbench/limits/<cell>.json``.  Adding a cell, a mix, a metric or a
kernel's counts adds files and entries; nothing here changes.

A cell is built as ``gmmvi_tpu_torch``'s users build it:
``get_default_config(codename, experiment)``, the mix's module settings and
the configuration's experiment settings merged over it, ``init_experiment``
and ``GMMVI.build_from_config`` with the experiment's published seed
(``start_seed``: the target and the initial mixture are the published
run's in every run).  Set-up makes the warmed state with the frozen
reference's step (``warmup_iterations`` of them, from that seed; the
first run in a checkout leaves it under ``build/portbench_warm/`` and
later runs read it there), hands it to the program, seeds the program's generator from the run's
``--seed``, snapshots the state and the generator and replays one block
to warm every shape; the window replays the same block of
``block_iterations`` from a clone of that snapshot, again and again.  So
every run of every version of the program replays the same warmed state,
and the seed chooses only the block's draws.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SEED_MODULUS = 2 ** 63          # torch.Generator.manual_seed takes less
# the warmed states, one file per configuration, mix and card
WARM_DIR = ROOT / "build" / "portbench_warm"


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    """The workload ``name`` of ``bench``, with its configuration's entry
    under ``config_entry``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_entry"] = configs[cell["config"]]
    return cell


def config_spec(cell: dict, root: Path = ROOT) -> dict:
    return load_json(root / cell["config_entry"]["file"])


def traffic_spec(mix: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{mix}.json")


def limits_spec(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "limits" / f"{cell_name}.json")


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MODULES: Dict[Path, ModuleType] = {}


def plugin(kind: str, name: str, bench_dir: Path = BENCH_DIR
           ) -> Optional[ModuleType]:
    """``portbench/<kind>/<name>.py`` loaded as a module, or None where
    there is no such file."""
    path = bench_dir / kind / f"{name}.py"
    if not path.exists():
        return None
    if path not in _MODULES:
        _MODULES[path] = _load_module(
            path, f"portbench_{kind}_{name}".replace(".", "_"))
    return _MODULES[path]


def metric_names(bench: dict, cell_name: str, section: str) -> List[str]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell_name`` reports."""
    return [m["name"] for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


# ----------------------------------------------------------------------
# Building a cell
# ----------------------------------------------------------------------
def build_config(cfg_spec: dict, mix_spec: dict) -> dict:
    """The program's config dict: the codename's and the experiment's
    defaults, the mix's module settings and the configuration's experiment
    settings, its published ``start_seed`` the run's ``seed``."""
    from gmmvi_tpu_torch.configs import get_default_config, update_config

    cfg = get_default_config(mix_spec["codename"], cfg_spec["experiment"])
    cfg = update_config(cfg, mix_spec.get("module_configs", {}))
    cfg = update_config(cfg, cfg_spec["config"])
    cfg["seed"] = int(cfg["start_seed"])
    return cfg


def built_sizes(opt) -> dict:
    """The sizes a built ``GMMVI`` runs at, under the names the
    configuration's file gives them."""
    sel, model = opt.selector_cfg, opt.state.model
    from gmmvi_tpu_torch.optimization.sample_selectors import \
        total_window_size

    return {"num_dimensions": model.num_dimensions,
            "max_components": model.max_components,
            "num_initial_components": int(model.num_active),
            "desired_samples_per_component":
                sel.desired_samples_per_component,
            "reused_samples_per_component": sel.reused_samples_per_component,
            "max_background_dists": sel.max_background_dists,
            "window_rows": total_window_size(sel, model.max_components),
            "database_capacity": opt.state.db.capacity}


def build_cell(cfg_spec: dict, mix_spec: dict, device,
               sizes_key: str = "sizes"):
    """``(config, GMMVI)`` for one run; raises where the program builds
    other sizes than the configuration's file states."""
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    cfg = build_config(cfg_spec, mix_spec)
    target, model, meta = init_experiment(cfg, device=device)
    opt = GMMVI.build_from_config(cfg, target, model, meta, device=device)
    want = dict(cfg_spec.get(sizes_key, {}))
    want.update(mix_spec.get(sizes_key, {}))
    got = built_sizes(opt)
    wrong = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if wrong:
        raise RuntimeError(f"the program built other sizes than the "
                           f"configuration states (built, stated): {wrong}")
    return cfg, opt


def clone_state(obj):
    """A deep copy of a state: every tensor cloned, every dataclass
    rebuilt, everything else shared."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: clone_state(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Replay:
    """The warmed optimizer, its snapshot and the block it replays."""

    opt: object
    snapshot: object
    generator_state: torch.Tensor
    block: int
    device: torch.device

    def restore(self) -> None:
        self.opt.state = clone_state(self.snapshot)
        self.opt.generator.set_state(self.generator_state)


def to_program_state(ref_state, like):
    """The reference's ``TrainState`` as the program's: every part rebuilt
    as the program's class of it (``like``'s), from the same fields."""
    parts = {}
    for f in dataclasses.fields(like):
        if f.name == "num_updates":
            continue
        prog_part, ref_part = getattr(like, f.name), getattr(ref_state, f.name)
        values = {g.name: getattr(ref_part, g.name)
                  for g in dataclasses.fields(ref_part) if g.init}
        parts[f.name] = type(prog_part)(**{
            g.name: values[g.name] for g in dataclasses.fields(prog_part)
            if g.init})
    return dataclasses.replace(like, num_updates=ref_state.num_updates,
                               **parts)


def _warm_path(cfg: dict, iterations: int, device: torch.device) -> Path:
    """Where the warmed state of ``cfg`` after ``iterations`` reference
    steps on ``device`` is kept: named by a hash of the config, the
    reference's sources, the card and the torch version."""
    h = hashlib.sha256()
    h.update(json.dumps(cfg, sort_keys=True, default=str).encode())
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    h.update(f"{iterations} {kind} {torch.__version__}".encode())
    for path in sorted((BENCH_DIR / "reference").rglob("*.py")):
        h.update(path.read_bytes())
    return WARM_DIR / f"{h.hexdigest()[:24]}.pt"


def warmed_reference_state(cfg: dict, iterations: int, device):
    """The frozen reference's state after ``iterations`` steps from the
    published seed (``portbench/reference/step.py``).  Made once in a
    checkout and kept in :data:`WARM_DIR`; later runs read it."""
    from portbench.check import precision, to_device
    from portbench.reference.step import ReferenceGMMVI

    device = torch.device(device)
    path = _warm_path(cfg, iterations, device)
    if path.exists():
        return to_device(torch.load(path, map_location="cpu",
                                    weights_only=False), device)
    with precision(False), torch.no_grad():
        ref = ReferenceGMMVI(cfg, device)
        for _ in range(iterations):
            ref.train_iter()
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(f"{path.stem}.{os.getpid()}.part")
    torch.save(to_device(ref.state, "cpu"), part)
    os.replace(part, path)
    return ref.state


def warm_up(cfg: dict, opt, iterations: int, block: int, seed: int,
            device) -> Replay:
    """The warmed state (:func:`warmed_reference_state`) handed to the
    program; the program's generator seeded from ``seed``; the snapshot
    taken; then one block of the program replayed from it, so that every
    kernel is built and every shape warmed before the window."""
    opt.state = to_program_state(
        warmed_reference_state(cfg, iterations, device), opt.state)
    opt.generator.manual_seed(int(seed) % SEED_MODULUS)
    replay = Replay(opt=opt, snapshot=clone_state(opt.state),
                    generator_state=opt.generator.get_state(), block=block,
                    device=device)
    run_window(replay, math.inf, max_iterations=block)
    synchronize(device)
    return replay


def prepare(cfg_spec: dict, mix_spec: dict, seed: int, device):
    """``(config, Replay)``: the cell built and warmed up, its replay's
    draws seeded from ``seed``."""
    cfg, opt = build_cell(cfg_spec, mix_spec, device)
    dev = opt.device if torch.device(device).type == "cuda" \
        else torch.device(device)
    return cfg, warm_up(cfg, opt, int(mix_spec["warmup_iterations"]),
                        int(mix_spec["block_iterations"]), seed, dev)


@dataclasses.dataclass
class Window:
    seconds: float
    iteration_s: List[float]
    blocks: int

    @property
    def iterations(self) -> int:
        return len(self.iteration_s)


def run_window(replay: Replay, seconds: float,
               before: Optional[Callable[[int], None]] = None,
               after: Optional[Callable[[int], None]] = None,
               span: Optional[Callable[[str], object]] = None,
               max_iterations: Optional[int] = None,
               session: Optional[Callable[[], object]] = None) -> Window:
    """Replay blocks from the snapshot until ``seconds`` have passed (or
    ``max_iterations`` are done); every iteration ends in a synchronize.
    The block's restore counts in the time of its first iteration.
    ``before``/``after`` are called with the iteration's index in the
    window; ``span`` (a ``record_function`` factory) names the restore and
    the step on a profiler's timeline; ``session`` (a context-manager
    factory) is entered before each block's restore and left after its
    last iteration, or the window's."""
    times: List[float] = []
    blocks = 0
    dev = replay.device
    open_session = None
    synchronize(dev)
    t0 = last = time.perf_counter()
    try:
        while True:
            i = len(times)
            if i % replay.block == 0:
                blocks += 1
                if session is not None:
                    open_session = session()
                    open_session.__enter__()
                if span is None:
                    replay.restore()
                else:
                    with span("portbench.block_restore"):
                        replay.restore()
            if before is not None:
                before(i)
            if span is None:
                replay.opt.train_iter()
            else:
                with span("portbench.train_iter"):
                    replay.opt.train_iter()
            synchronize(dev)
            if after is not None:
                after(i)
            done = (time.perf_counter() - t0 >= seconds
                    or (max_iterations is not None
                        and len(times) + 1 >= max_iterations))
            if open_session is not None and (
                    done or (i + 1) % replay.block == 0):
                session_, open_session = open_session, None
                session_.__exit__(None, None, None)
            now = time.perf_counter()
            times.append(now - last)
            last = now
            if done:
                break
    finally:
        if open_session is not None:
            open_session.__exit__(None, None, None)
    return Window(seconds=last - t0, iteration_s=times, blocks=blocks)


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics, as ``numpy.percentile`` gives it."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
