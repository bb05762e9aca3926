"""Trips of the weight trust-region search per iteration, each a host
read: the program's ``weight_search.trips`` counter
(``gmmvi_tpu_torch.utils.profiling``) over the profiled block.  Moves
``step_device_ms``."""
from gmmvi_tpu_torch.utils import profiling

UNIT = "trips/step"


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
    trips = summary["counters"].get("weight_search.trips")
    return None if trips is None else trips / steps
