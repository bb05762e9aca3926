"""Device-to-host copies per iteration (the profiler's ``Memcpy DtoH``
events over the profiled block): each is a point where the host waits
for the card.  Moves ``step_device_ms``."""
UNIT = "copies/step"


def read(record: dict):
    if record["device_kind"] == "cpu":
        return None
    return record["trace"]["d2h_copies"] / record["profiled_iterations"]
