"""Target evaluations per iteration: the delta of the database's
``num_samples_written`` (the runner's fevals counter) over the profiled
block.  Sample selection and reuse set it.  Moves ``step_device_ms``."""
UNIT = "rows/step"


def read(record: dict):
    return record["fevals_per_step"]
