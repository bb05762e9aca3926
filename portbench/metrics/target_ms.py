"""The target's device time per iteration: CUDA events around each of its
calls in the profiled block (the benchmark's wrapper keeps the target's
flags, so the step takes the same route).  Moves ``step_device_ms``."""
UNIT = "ms/step"


def read(record: dict):
    if record["target_ms"] is None:
        return None
    return record["target_ms"] / record["profiled_iterations"]
