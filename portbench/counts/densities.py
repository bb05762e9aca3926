"""B2 (``csrc/density.cu``, ``ops.density.densities``): per-component and
mixture log densities over ``x [N, D]``, ``K`` components.  Per live
component and valid row: one triangular product (matrix-shaped), the
difference and the squared norm (others).  Bytes: means, triangular
factors, log weights, log determinants and rows read; ``comp [K, N]`` and
``model [N]`` written."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 0)
    n = rows(dims(rec, 4)[0], state)
    k = live(rec, state, k)
    return {"matrix_flops": k * n * tri_flops(d),
            "other_flops": 3 * k * n * d,
            "bytes": 4 * (k * (tri_floats(d) + d + 2) + n * d + k * n + n)}
