"""B1 (``csrc/density.cu``, ``ops.density.density_pack``): per-component
and mixture log densities and the mixture's gradient over ``x [N, D]``,
``K`` components.  Per live component and valid row: one triangular
product for the whitened difference and one for the gradient's back
substitution (matrix-shaped), the difference, the squared norm and the
responsibility-weighted sum (others).  Bytes: means, the triangular
factors, log weights and log determinants, the rows; written: ``comp [K,
N]``, ``model [N]``, ``grads [N, D]``."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 0)
    n = rows(dims(rec, 4)[0], state)
    k = live(rec, state, k)
    return {"matrix_flops": 2 * k * n * tri_flops(d),
            "other_flops": 5 * k * n * d,
            "bytes": 4 * (k * (tri_floats(d) + d + 2) + 2 * n * d + k * n
                          + n)}
