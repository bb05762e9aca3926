"""The step's wall time on the host's clock: the traced run's unprofiled
window, its seconds over the iterations completed in it (the block
restores inside).  Host-paced on a shared host, so its runs spread too
widely for an end-to-end bound; the card's share of the same steps is
``step_device_ms``.  Moves ``step_device_ms``."""
UNIT = "ms"


def read(record: dict):
    un = record["unprofiled"]
    if un["iterations"] <= 0 or un["seconds"] <= 0:
        return None
    return un["seconds"] / un["iterations"] * 1e3
