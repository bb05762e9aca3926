"""Rows the target evaluated per iteration, a bucket's padding included:
the program's ``target.rows`` counter (``gmmvi_tpu_torch.utils.profiling``)
over the profiled block; over ``fevals_per_step`` it gives the bucket's
fill.  Moves ``step_device_ms``."""
from gmmvi_tpu_torch.utils import profiling

UNIT = "rows/step"


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
    rows = summary["counters"].get("target.rows")
    return None if rows is None else rows / steps
