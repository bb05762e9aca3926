"""Host reads per iteration: the program's ``host_reads.<site>`` counters
(``gmmvi_tpu_torch.utils.profiling``: every point where the step makes the
host wait for the card, a read of a device value or a copy of a host value
that synchronizes), summed over the sites, over the profiled block's
``train_iter`` spans.  Moves ``step_device_ms``."""
from gmmvi_tpu_torch.utils import profiling

UNIT = "reads/step"


def read(record: dict, summary=None):
    """``summary`` is the program's (``profiling.summary()`` by default);
    None where the program keeps no such record or its ``train_iter`` spans
    are not the profiled block's iterations."""
    if summary is None:
        take = getattr(profiling, "summary", None)
        if take is None:
            return None
        summary = take()
    steps = summary["spans"].get("train_iter", {}).get("count")
    if not steps or steps != record["profiled_iterations"]:
        return None
    counters = summary["counters"]
    return sum(n for name, n in counters.items()
               if name.startswith("host_reads.")) / steps
