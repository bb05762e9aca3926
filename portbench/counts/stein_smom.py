"""B7 (``csrc/stein.cu``, ``ops.stein.stein_smom``): per component the
weighted second moments ``sum_n w_kn g_n xc_n^T`` over ``N`` rows of
``D``: ``2 N D^2`` matrix-shaped operations per live component over the
valid rows.  Bytes: ``w [K, N]``, ``g [N, D]`` and ``xc [N, D]`` read,
``[K, D, D]`` written."""
from portbench.rooflines import dims, live, rows


def count(rec: dict, state: dict) -> dict:
    k, n = dims(rec, 0)
    d = dims(rec, 1)[1]
    n = rows(n, state)
    k = live(rec, state, k)
    return {"matrix_flops": 2 * k * n * d * d,
            "other_flops": k * n * d,
            "bytes": 4 * (k * n + 2 * n * d + k * d * d)}
