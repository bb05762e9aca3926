"""The host's time inside the program's ``read.<site>`` spans per
iteration (``gmmvi_tpu_torch.utils.profiling``), over the profiled block:
the time the host waited for the card at its reads.  Moves
``step_device_ms``."""
from gmmvi_tpu_torch.utils import profiling

UNIT = "ms/step"


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
    return sum(s["total_s"] for name, s in summary["spans"].items()
               if name.startswith("read.")) / steps * 1e3
