"""B3 fused (``csrc/trust_region.cu`` ``tr_search_kernel``,
``ops.trust_region.tr_search``): every live component's bisection for its
trust-region stepsize.  The trips depend on the data; the least the
search needs is one factorisation of a ``D x D`` matrix per live
component (``D^3 / 3``, matrix-shaped), never its trips.  Bytes: the
search's inputs (precisions, quadratic and linear terms, old factors,
means, constants) for the live components read once, etas written."""
from portbench.rooflines import live


def count(rec: dict, state: dict) -> dict:
    shapes = rec["shapes"]
    k = shapes[0][0]
    d = state["num_dimensions"]
    kl = live(rec, state, k)
    floats = sum(_numel(s) for s in shapes[4:])
    return {"matrix_flops": kl * d ** 3 // 3,
            "other_flops": 0,
            "bytes": 4 * (floats * kl // max(1, k) + 4 * kl)}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
