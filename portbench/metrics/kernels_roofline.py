"""The hand-written kernels' share of their roofline over the profiled
block: the sum over their launches of each launch's bound
(``portbench/rooflines.py`` from ``portbench/counts/<kernel>.py``), over
their device time by the profiler (every ``__global__`` function of the
program's ``csrc/``).  Nothing where no hand-written kernel ran.  Moves
``step_device_ms``."""
from portbench import core
from portbench.rooflines import bound_seconds, peaks_for

UNIT = "%"


def read(record: dict):
    device_s = sum(record["trace"]["hand_written_s"].values())
    if device_s <= 0:
        return None
    peaks = peaks_for(record["device_kind"], record["peaks"])
    bound = 0.0
    for rec in record["launches"]:
        for kernel, launches in rec["kernels"].items():
            counts = core.plugin("counts", kernel)
            if counts is None:
                raise KeyError(f"no counts for the kernel {kernel!r}")
            bound += launches * bound_seconds(
                counts.count(rec, record["state"]), peaks)
    return bound / device_s * 100.0
