"""The 95th percentile of the traced run's unprofiled window's iteration
times on the host's clock (all of them, each ending in a synchronize).
Host-paced, as ``step_ms.host`` is.  Moves ``step_device_ms``."""
from portbench import core

UNIT = "ms"


def read(record: dict):
    times = record["unprofiled"].get("iteration_s") or []
    if not times:
        return None
    return core.percentile(times, 95) * 1e3
