"""The whole step's share of the card's float32 peak: the step's counted
operations (``portbench/counts/step.py``) times the iterations of the
traced run's unprofiled window, over that window's time and the peak
(the port computes in float32).  Moves ``step_device_ms``."""
from portbench import core
from portbench.rooflines import peaks_for

UNIT = "%"


def read(record: dict):
    un = record["unprofiled"]
    if record["device_kind"] == "cpu" or un["seconds"] <= 0:
        return None
    step = core.plugin("counts", "step")
    peak = peaks_for(record["device_kind"], record["peaks"])["fp32_flops"]
    return (step.flops(record) * un["iterations"] / un["seconds"] / peak
            * 100.0)
