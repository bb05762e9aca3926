"""The kernels' and the step's operation and byte counts against hand counts
at small shapes, and the roofline bound they give."""
import math

import pytest

from portbench import core, rooflines
from portbench.tests import bench_support  # noqa: F401  (puts the root on the path)

# 4 rows of D = 4 in a window of 10 rows of which 5 are valid: rows() halves
STATE = {"active": 2, "window_valid": 5, "window_rows": 10,
         "num_dimensions": 4, "max_components": 3,
         "max_background_dists": 12}


def rec(function, shapes, live=None, kernel=None):
    return {"function": function, "shapes": shapes, "live": live,
            "kernels": {kernel or function: 1}}


def test_density_pack_by_hand():
    # K 3 slots, 2 live; N 10 rows -> 5 valid; D 4: a triangular product
    # is 4 * 5 = 20 operations, a factor 10 floats
    c = core.plugin("counts", "density_pack").count(
        rec("density_pack", [(3, 4), (3, 4, 4), (3,), (3,), (10, 4)], 2),
        STATE)
    assert c["matrix_flops"] == 2 * 2 * 5 * 20          # two products
    assert c["other_flops"] == 5 * 2 * 5 * 4
    # means 4 + factor 10 + 2 scalars per component; rows and grads 2 x
    # 5 x 4; comp 2 x 5; model 5 -- 4 bytes each
    assert c["bytes"] == 4 * (2 * 16 + 40 + 10 + 5)


def test_densities_by_hand():
    c = core.plugin("counts", "densities").count(
        rec("densities", [(3, 4), (3, 4, 4), (3,), (3,), (10, 4)], 3),
        STATE)
    assert c["matrix_flops"] == 3 * 5 * 20
    assert c["other_flops"] == 3 * 3 * 5 * 4
    assert c["bytes"] == 4 * (3 * 16 + 20 + 15 + 5)


@pytest.mark.parametrize("function,written", [("densities_large", 2 * 5 + 5),
                                              ("mixture_logpdf_large", 5)])
def test_densities_large_by_hand(function, written):
    c = core.plugin("counts", "densities_large").count(
        rec(function, [(3, 4), (3, 4, 4), (3,), (3,), (10, 4)], 2,
            kernel="densities_large"), STATE)
    assert c["matrix_flops"] == 2 * 5 * 20
    assert c["bytes"] == 4 * (2 * 16 + 20 + written)


def test_density_grads_large_by_hand():
    # one symmetric product (2 D^2 = 32) per valid row
    c = core.plugin("counts", "density_grads_large").count(
        rec("density_grads_large",
            [(3, 4), (3, 4, 4), (3,), (3, 10), (10,), (10, 4)], 2), STATE)
    assert c["matrix_flops"] == 5 * 32
    assert c["bytes"] == 4 * (2 * 15 + 2 * 5 + 5 + 2 * 20)


def test_stein_smom_by_hand():
    # no per-component vector: the model's 2 active components
    c = core.plugin("counts", "stein_smom").count(
        rec("stein_smom", [(3, 10), (10, 4), (10, 4)]), STATE)
    assert c["matrix_flops"] == 2 * 2 * 5 * 16
    assert c["bytes"] == 4 * (2 * 5 + 2 * 20 + 2 * 16)


@pytest.mark.parametrize("name", ["background_logpdf", "mixture_logpdf"])
def test_mixture_kernels_by_hand(name):
    c = core.plugin("counts", name).count(
        rec(name, [(12, 4), (12, 4, 4), (12,), (12,), (10, 4)], 7), STATE)
    assert c["matrix_flops"] == 7 * 5 * 20
    assert c["other_flops"] == 3 * 7 * 5 * 4
    assert c["bytes"] == 4 * (7 * 16 + 20 + 5)


@pytest.mark.parametrize("name,first", [("tr_search", 4), ("tr_kl", 1)])
def test_search_kernels_by_hand(name, first):
    # 3 slots, 2 live: one factorisation (4^3 / 3 -> 21) per live one; the
    # inputs' floats read for the live share
    inp = [(3, 4, 4), (3, 4)]
    shapes = [(3,)] * first + inp
    c = core.plugin("counts", name).count(rec(name, shapes, 2), STATE)
    assert c["matrix_flops"] == 2 * 21
    floats = (48 + 12) * 2 // 3
    assert c["bytes"] == 4 * (floats + (4 if name == "tr_search" else 2) * 2)


def test_more_grams_by_hand():
    # F = 10 + 4 + 1 = 15 features; one Gram update and one whitening a row
    c = core.plugin("counts", "more_grams").count(
        rec("more_grams", [(3, 4, 4), (3, 4), (3, 10), (10,), (10, 4)], 2),
        STATE)
    assert c["matrix_flops"] == 5 * (2 * 225 + 20)
    assert c["bytes"] == 4 * (2 * 14 + 2 * 5 + 5 + 20 + 2 * (225 + 15))


def test_step_by_hand():
    record = {
        "state": {"num_dimensions": 4, "active": 2, "window_valid": 30,
                  "reused_valid": 10, "fresh_valid": 20,
                  "max_background_dists": 12, "max_components": 3},
        "launches": [rec("background_logpdf", [(12, 4)], 5),
                     rec("background_logpdf", [(12, 4)], 7),
                     rec("background_logpdf", [(12, 4)], 9),
                     rec("densities", [(3, 4)], 2)],
        "config": {"target_matrix_flops_per_row": 100},
    }
    tri = 20
    want = (20 * tri + 20 * 100 + 2 * 10 * tri + 2 * 30 * tri
            + 2 * 30 * 16 + 7 * 30 * tri + 2 * 2 * 30 * 16
            + 2 * 64 / 3 + 2 * 30 * tri)
    assert core.plugin("counts", "step").flops(record) == pytest.approx(want)


def test_bound_is_the_larger_time():
    peaks = {"fp32_flops": 67e12, "tf32_flops": 495e12, "bytes_per_s": 3.35e12}
    compute = {"matrix_flops": 165e12, "other_flops": 67e12, "bytes": 1.0}
    assert rooflines.bound_seconds(compute, peaks) == pytest.approx(2.0)
    memory = {"matrix_flops": 0, "other_flops": 0, "bytes": 6.7e12}
    assert rooflines.bound_seconds(memory, peaks) == pytest.approx(2.0)


def test_rows_and_live():
    assert rooflines.rows(10, STATE) == 5
    assert rooflines.rows(3, STATE) == math.ceil(1.5)
    assert rooflines.live({"live": 7}, STATE, 12) == 7
    assert rooflines.live({"live": None}, STATE, 12) == 2
    assert rooflines.live({"live": None}, STATE, 1) == 1


def test_every_program_kernel_has_counts():
    from gmmvi_tpu_torch.ops import cuda

    missing = [k for k in cuda.LAUNCHES
               if core.plugin("counts", k) is None]
    assert not missing, f"kernels without counts: {missing}"
