"""B3 per trip (``csrc/trust_region.cu`` ``tr_kl_kernel``,
``ops.trust_region.tr_kl``): each component's KL at a trial eta; counted
as one factorisation per live component (``D^3 / 3``) and its inputs read
once."""
from portbench.rooflines import live


def count(rec: dict, state: dict) -> dict:
    shapes = rec["shapes"]
    k = shapes[0][0]
    d = state["num_dimensions"]
    kl = live(rec, state, k)
    floats = sum(_numel(s) for s in shapes[1:])
    return {"matrix_flops": kl * d ** 3 // 3,
            "other_flops": 0,
            "bytes": 4 * (floats * kl // max(1, k) + 2 * kl)}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
