"""B9 (``csrc/background.cu`` entry ``gmmvi_mixture_logpdf``,
``ops.mixture_logpdf.mixture_logpdf``): the mixture log density ``[N]``
over ``K`` components at ``x [N, D]``; counted as B4."""
from portbench.rooflines import dims, live, rows, tri_flops, tri_floats


def count(rec: dict, state: dict) -> dict:
    k, d = dims(rec, 0)
    n = rows(dims(rec, 4)[0], state)
    k = live(rec, state, k)
    return {"matrix_flops": k * n * tri_flops(d),
            "other_flops": 3 * k * n * d,
            "bytes": 4 * (k * (tri_floats(d) + d + 2) + n * d + n)}
