"""B8 (``csrc/more.cu``, ``ops.more.more_grams``): MORE's weighted Gram
matrix and right-hand side of the quadratic features ``phi`` (``F = D (D
+ 1) / 2 + D + 1``) per component, over the rows with weight.  The least
the inputs need: each valid row's whitening (one triangular product) and
one Gram update ``2 F^2`` (matrix-shaped).  Bytes: factors, means,
weights, outputs and rows read; ``[K, F, F]`` and ``[K, F]`` written."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 1)
    n = rows(dims(rec, 2)[1], state)
    k = live(rec, state, k)
    f = tri_floats(d) + d + 1
    return {"matrix_flops": n * (2 * f * f + tri_flops(d)),
            "other_flops": n * f,
            "bytes": 4 * (k * (tri_floats(d) + d) + k * n + n + n * d
                          + k * (f * f + f))}
