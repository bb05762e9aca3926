"""The training step's spans and counters (``gmmvi_tpu_torch.utils.profiling``)
and the benchmark's readers of them, on the CPU at a small SAMTRON size with
sample reuse and the bucketed target evaluation.

One traced block of three steps (under ``torch.profiler``) from a warmed
state is held against the same three steps untraced: the spans nest in
``train_iter`` in the step's order, the state is equal to the bit, the
target's rows are the bucket's, and the search trips are those the
searches took.  The readers of ``portbench/metrics`` are fed a summary and
a record.
"""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from torch_parity import samtron_overrides

from gmmvi_tpu_torch.optimization import component_updaters as upd_ops
from gmmvi_tpu_torch.optimization import weight_updaters as w_ops
from gmmvi_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

DIMS = 5
WARM_STEPS = 4
STEPS = 3
# steps 5-7: an add (iteration 6) and a deletion check (iteration 7) fall
# inside the block
SMALL = dict(kmax=8, n_des=24, k0=5, del_iters=6, add_iters=3)
PHASES = ("grow", "draw", "propose", "target", "finalize", "estimate",
          "update", "weights", "adapt")
READERS = ("host_reads_per_step", "host_read_wait_ms", "target_rows_per_step",
           "tr_search_trips_per_step", "weight_search_trips_per_step",
           "update_host_ms")


def _build():
    import gmmvi_tpu_torch.configs as tcfg
    from gmmvi_tpu_torch.experiments.setup import init_experiment
    from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
        make_target
    from gmmvi_tpu_torch.optimization.gmmvi import GMMVI

    over = samtron_overrides(**SMALL)
    over["sample_selector_config"]["ratio_reused_samples_to_desired"] = 2.0
    over["tpu"]["compact_target_eval"] = "on"
    cfg = tcfg.update_config(tcfg.get_default_algorithm_config("SAMTRON"),
                             over)
    cfg["target_fn"] = target = make_target(DIMS, False, seed=0,
                                            device="cpu")
    _, model, meta = init_experiment(cfg, device="cpu")
    return GMMVI.build_from_config(cfg, target, model, meta, device="cpu")


def _leaves(state) -> dict:
    out = {"num_updates": state.num_updates}
    for part in dataclasses.fields(state):
        value = getattr(state, part.name)
        if dataclasses.is_dataclass(value):
            for f in dataclasses.fields(value):
                leaf = getattr(value, f.name)
                if isinstance(leaf, torch.Tensor):
                    out[f"{part.name}.{f.name}"] = leaf
    return out


@pytest.fixture(scope="module")
def block():
    """The same three steps untraced and traced from one warmed state and
    generator state, with what the step's own functions saw in the traced
    ones (valid counts, bucket sizes, search trips, weight KL calls)."""
    from portbench.core import clone_state

    opt = _build()
    opt.train_iters(WARM_STEPS)
    snapshot, gen = clone_state(opt.state), opt.generator.get_state()
    profiling.reset()
    opt.train_iters(STEPS)
    untraced = opt.state
    summary_off = profiling.summary()

    opt.state, seen = clone_state(snapshot), {
        "valid": [], "bucket": [], "tr_trips": [], "weight_kl": 0}
    opt.generator.set_state(gen)
    propose, bucket_size = opt._propose_phase, opt._bucket_size

    def seen_propose(*a):
        prop = propose(*a)
        seen["valid"].append(int(prop.valid.sum()))
        return prop

    def seen_bucket(n):
        seen["bucket"].append(bucket_size(n))
        return seen["bucket"][-1]

    def seen_tr_search(*a):
        out = tr_search(*a)
        seen["tr_trips"].append(int(out[2].max()))
        return out

    def seen_weight_kl(*a):
        seen["weight_kl"] += 1
        return weight_kl(*a)

    tr_search, weight_kl = upd_ops.tr_search, w_ops._tr_weight_kl
    opt._propose_phase, opt._bucket_size = seen_propose, seen_bucket
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(upd_ops, "tr_search", seen_tr_search)
        mp.setattr(w_ops, "_tr_weight_kl", seen_weight_kl)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            opt.train_iters(STEPS)
    summary = profiling.summary()
    profiling.reset()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gmmvi.")]
    return dict(untraced=untraced, traced=opt.state, summary=summary,
                summary_off=summary_off, events=events, seen=seen)


def test_tracing_off_leaves_the_summary_empty(block):
    assert block["summary_off"] == {"spans": {}, "counters": {}}


def test_phase_spans_nest_in_train_iter_in_step_order(block):
    events = block["events"]
    steps = [e for e in events if e[0] == "gmmvi.train_iter"]
    assert len(steps) == STEPS
    for _, start, end in steps:
        inside = sorted((s, name[len("gmmvi."):]) for name, s, e in events
                        if start <= s and e <= end
                        and name[len("gmmvi."):] in PHASES)
        assert tuple(name for _, name in inside) == PHASES
    calls = [e for e in events if e[0] == "gmmvi.target.call"]
    targets = [e for e in events if e[0] == "gmmvi.target"]
    assert len(calls) == len(targets) == STEPS
    for (_, s, e), (_, ts, te) in zip(calls, targets):
        assert ts <= s and e <= te
    spans = block["summary"]["spans"]
    assert spans["train_iter"]["parent"] is None
    assert all(spans[p]["parent"] == "train_iter"
               and spans[p]["count"] == STEPS for p in PHASES)
    assert spans["target.call"]["parent"] == "target"
    # the phases hold the step's time: train_iter's own is what is left
    assert spans["train_iter"]["self_s"] < spans["train_iter"]["total_s"]


def test_traced_steps_equal_untraced_to_the_bit(block):
    a, b = _leaves(block["untraced"]), _leaves(block["traced"])
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], torch.Tensor):
            assert torch.equal(a[name], b[name]), name
        else:
            assert a[name] == b[name], name


def test_target_rows_are_the_bucket_and_the_valid_rows(block):
    seen, counters = block["seen"], block["summary"]["counters"]
    assert len(seen["bucket"]) == len(seen["valid"]) == STEPS
    assert counters["target.rows"] == sum(seen["bucket"])
    assert counters["target.valid_rows"] == sum(seen["valid"])
    assert counters["host_reads.bucket"] == STEPS


def test_search_trips_are_the_searches(block):
    seen, counters = block["seen"], block["summary"]["counters"]
    assert len(seen["tr_trips"]) == STEPS
    assert counters["tr_search.trips"] == sum(seen["tr_trips"])
    # one KL per trip and one at the accepted bracket end per search
    assert counters["weight_search.trips"] == seen["weight_kl"] - STEPS
    assert counters["host_reads.weight_search"] \
        == counters["weight_search.trips"]


def test_stein_moments_take_one_slab_a_step(block):
    # the plain moments at D = 5 contract the whole window in one slab
    assert block["summary"]["counters"]["stein.moment_slabs"] == STEPS


def test_gather_max_sums_step_maxima_across_folds(monkeypatch):
    timers = profiling.PhaseTimers()
    monkeypatch.setattr(profiling, "GATHER_SLOTS", 3)
    for i in range(8):
        timers.gather_max("t", torch.tensor([1, i, 2], dtype=torch.int32))
    assert timers.summary()["counters"]["t"] \
        == sum(max(i, 2) for i in range(8))
    timers.reset()
    timers.gather_max("t", torch.tensor([5], dtype=torch.int32))
    assert timers.summary()["counters"]["t"] == 5


def test_phase_timers_nest_self_time_parents_and_counts():
    timers = profiling.PhaseTimers()
    with timers.phase("outer"):
        with timers.phase("inner"):
            timers.count("c", 2)
        with timers.phase("inner"):
            pass
    s = timers.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert (outer["count"], inner["count"]) == (1, 2)
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert s["counters"] == {"c": 2}
    # the collectives' timer of parallel/reduce.py reads the totals
    assert timers.totals["outer"] == outer["total_s"]
    timers.reset()
    assert timers.summary() == {"spans": {}, "counters": {}}


def test_trace_writes_the_summary_beside_the_chrome_trace(tmp_path):
    x = torch.ones(3)
    with profiling.trace(str(tmp_path)):
        with profiling.span("train_iter"):
            assert profiling.read(x.sum(), "probe") == 3.0
    (summary,) = tmp_path.glob("summary_*.json")
    (chrome,) = tmp_path.glob("trace_*.json")
    assert summary.name[len("summary_"):] == chrome.name[len("trace_"):]
    data = json.loads(summary.read_text())
    assert data["spans"]["read.probe"]["parent"] == "train_iter"
    assert data["counters"] == {"host_reads.probe": 1}
    profiling.reset()


def _summary(steps: int) -> dict:
    spans = {"train_iter": {"count": steps, "total_s": 2.0},
             "read.bucket": {"count": steps, "total_s": 0.01},
             "read.weight_search": {"count": 3 * steps, "total_s": 0.03},
             "estimate": {"count": steps, "total_s": 0.1},
             "update": {"count": steps, "total_s": 0.2},
             "weights": {"count": steps, "total_s": 0.3},
             "adapt": {"count": steps, "total_s": 0.05}}
    counters = {"host_reads.bucket": steps,
                "host_reads.weight_search": 3 * steps,
                "target.rows": 96 * steps, "target.valid_rows": 80 * steps,
                "tr_search.trips": 6 * steps,
                "weight_search.trips": 3 * steps}
    return {"spans": copy.deepcopy(spans), "counters": counters}


@pytest.mark.parametrize("name, want", list(zip(READERS, (
    4.0, 0.4, 96.0, 6.0, 3.0, 6.5))))
def test_reader_reads_the_summary(name, want):
    from portbench import core

    reader = core.plugin("metrics", name)
    assert reader.read({"profiled_iterations": 100}, _summary(100)) \
        == pytest.approx(want)
    # the summary's train_iter count is not the profiled block's
    assert reader.read({"profiled_iterations": 100}, _summary(99)) is None
    assert reader.read({"profiled_iterations": 100},
                       {"spans": {}, "counters": {}}) is None
