"""B6 (``csrc/density_large.cu``, ``ops.density_large.density_grads_large``):
the mixture gradient ``-sum_k r_k Lambda_k (x - mu_k)`` over ``x [N, D]``
from B5's outputs.  The pairs with a nonzero responsibility depend on the
data; every valid row has at least one, so one symmetric product per
valid row (``2 D^2``, matrix-shaped) is the least the inputs need.  Bytes:
the symmetric precisions, means, log weights, ``comp [K, N]``, ``model
[N]`` and the rows read; ``grads [N, D]`` written."""
from portbench.rooflines import dims, live, rows, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 0)
    n = rows(dims(rec, 5)[0], state)
    k = live(rec, state, k)
    return {"matrix_flops": 2 * n * d * d,
            "other_flops": 2 * n * d,
            "bytes": 4 * (k * (tri_floats(d) + d + 1) + k * n + n
                          + 2 * n * d)}
