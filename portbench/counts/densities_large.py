"""B5 (``csrc/density_large.cu``, ``ops.density_large.densities_large`` and
``mixture_logpdf_large``): B2's densities for 128 < D <= 512, K-tiled.
Per live component and valid row: one triangular product (matrix-shaped),
the difference and the squared norm (others).  ``mixture_logpdf_large``
writes only the mixture ``[N]``; ``densities_large`` also ``comp [K,
N]``."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 0)
    n = rows(dims(rec, 4)[0], state)
    k = live(rec, state, k)
    written = n + (k * n if rec["function"] == "densities_large" else 0)
    return {"matrix_flops": k * n * tri_flops(d),
            "other_flops": 3 * k * n * d,
            "bytes": 4 * (k * (tri_floats(d) + d + 2) + n * d + written)}
