"""One GMMVI iteration's operations, the least its work needs, from the
state between blocks: ``D`` dimensions, ``K`` active components, ``W``
valid window rows, ``R`` reused and ``F`` fresh valid rows, ``U`` live
old distributions of the background (the live count of the density
launches over ``max_background_dists`` distributions) and the target's
matrix-shaped operations per row (the configuration's
``target_matrix_flops_per_row``).  A triangular product is ``D (D + 1)``
operations (``tri``), a symmetric one ``2 D^2``:

- fresh samples ``mu + L eps``: ``F tri``; the target: ``F`` times its
  operations per row;
- the reuse window's component densities (the selector's ESS pass):
  ``K R tri``;
- the density pack over the window: ``K W tri`` and one symmetric
  product per row for the gradient; the background: ``U W tri``;
- the Stein moments: ``2 K W D^2``;
- the trust-region search: one factorisation per component, ``K D^3 /
  3``, never its trips;
- the weight update's densities of the updated model: ``K W tri``.
"""


def flops(record: dict) -> float:
    s = record["state"]
    d, k = s["num_dimensions"], s["active"]
    w, r, f = s["window_valid"], s["reused_valid"], s["fresh_valid"]
    tri = d * (d + 1)
    bg = [rec["live"] for rec in record["launches"]
          if rec.get("live") is not None and rec["shapes"]
          and rec["shapes"][0][0] == s["max_background_dists"]
          and s["max_background_dists"] > s["max_components"]]
    u = sorted(bg)[len(bg) // 2] if bg else 0
    per_row = record["config"].get("target_matrix_flops_per_row", 0)
    return float(f * tri + f * per_row + k * r * tri + k * w * tri
                 + 2 * w * d * d + u * w * tri + 2 * k * w * d * d
                 + k * d ** 3 / 3 + k * w * tri)
