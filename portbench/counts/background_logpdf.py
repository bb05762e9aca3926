"""B4 (``csrc/background.cu``, ``ops.background.background_logpdf``): the
count-weighted mixture log density over ``U`` old distributions at ``x
[N, D]``.  Per live distribution and valid row: one triangular product
(matrix-shaped), the difference and the squared norm (others).  Bytes:
the distributions' means, factors, log weights and log determinants and
the rows read; ``[N]`` written."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    u, d = dims(rec, 0)
    n = rows(dims(rec, 4)[0], state)
    u = live(rec, state, u)
    return {"matrix_flops": u * n * tri_flops(d),
            "other_flops": 3 * u * n * d,
            "bytes": 4 * (u * (tri_floats(d) + d + 2) + n * d + n)}
