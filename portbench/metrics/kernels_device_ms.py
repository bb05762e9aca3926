"""The hand-written kernels' device time per iteration (every
``__global__`` function of the program's ``csrc/``, by the profiler) over
the profiled block.  Moves ``step_device_ms``."""
UNIT = "ms/step"


def read(record: dict):
    hand = record["trace"]["hand_written_s"]
    if not hand:
        return None
    return sum(hand.values()) / record["profiled_iterations"] * 1e3
