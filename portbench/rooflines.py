"""The least time a kernel launch could take on the card, from what its
inputs need.

A launch's counts (``portbench/counts/<kernel>.py``) give its
matrix-shaped operations, its other operations and its bytes.  Its bound
is the larger of the compute time, matrix operations at a third of the TF32
rate (3xTF32, the fastest arithmetic the port's float32 allows for them)
plus the others at the float32 rate, and the memory time, each input byte
read once and each output byte written once at the card's bandwidth.
Counts take the live components and the valid rows, not the padded slots,
so no later change that skips padding or moves a product onto the tensor
cores can read over 100%.
"""
from __future__ import annotations

import math
from typing import Optional


def peaks_for(kind: str, table: dict) -> dict:
    return table.get(kind, table["default"])


def bound_seconds(counts: dict, peaks: dict) -> float:
    compute = (counts["matrix_flops"] / (peaks["tf32_flops"] / 3.0)
               + counts["other_flops"] / peaks["fp32_flops"])
    memory = counts["bytes"] / peaks["bytes_per_s"]
    return max(compute, memory)


def live(rec: dict, state: dict, k: int) -> int:
    """The live components of a launch over ``k`` slots: its own count of
    live entries where it has a per-component vector, else the model's
    active components (at most ``k``)."""
    if rec.get("live") is not None:
        return int(rec["live"])
    return min(k, int(state["active"]))


def rows(n: int, state: dict) -> int:
    """The valid rows among ``n`` padded ones, at the window's valid share
    between blocks."""
    share = state["window_valid"] / max(1, state["window_rows"])
    return int(math.ceil(n * min(1.0, share)))


def tri_flops(d: int) -> int:
    """Operations of one lower-triangular matrix-vector product."""
    return d * (d + 1)


def tri_floats(d: int) -> int:
    return d * (d + 1) // 2


def dims(rec: dict, index: int) -> Optional[tuple]:
    shapes = rec["shapes"]
    return tuple(shapes[index]) if index < len(shapes) else None
