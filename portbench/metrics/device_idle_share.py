"""The share of the profiled block in which no operation ran on the card:
``1 - busy / window``, busy the union of the kernel, copy and set
intervals.  Host dispatch sets it.  Moves ``step_device_ms``."""
UNIT = "fraction"


def read(record: dict):
    tr = record["trace"]
    if tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
