"""The plain Stein moments (``ops/stein.py`` ``stein_smom_plain``), the
estimator's route wherever kernel B7 does not run, against float64
``np.einsum("kn,nd,ne->kde")`` at B7's bar (1e-5 of each component's
largest entry), with exact zeros for weightless components.  Small
``N_CHUNK`` values force several slabs and a ragged last one; every
operand of the slabs' products is held to ``K * N_CHUNK * D`` elements, and
the counter ``stein.moment_slabs`` to the slab count while tracing is on.
"""
import numpy as np
import pytest
import torch

from gmmvi_tpu_torch.ops import stein
from gmmvi_tpu_torch.utils import profiling

torch.set_num_threads(2)

# k, n, d, N_CHUNK (None: the module's); rows a slab: K * N_CHUNK // D at
# D <= MIN_D (at least 1), N_CHUNK above
CASES = {
    "d1": (7, 300, 1, None),
    "d10": (12, 500, 10, None),
    "d64": (6, 400, 64, None),
    "ragged": (5, 1001, 10, 16),       # 8 rows: 125 slabs and one of 1 row
    "slabs": (4, 960, 10, 30),         # 12 rows: 80 slabs
    "d64_slabs": (3, 700, 64, 100),    # 4 rows: 175 slabs
    "one_row": (3, 50, 10, 2),         # K * N_CHUNK < D: 1 row a slab
    "wide": (4, 300, 72, 128),         # past MIN_D: [K, 128, D] slabs
}


class _Operands(torch.overrides.TorchFunctionMode):
    """The sizes of both operands of every matrix product."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in ("matmul", "__matmul__"):
            self.sizes.append((args[0].numel(), args[1].numel()))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", list(CASES))
def test_stein_smom_plain_matches_float64(monkeypatch, case):
    k, n, d, n_chunk = CASES[case]
    if n_chunk is not None:
        monkeypatch.setattr(stein, "N_CHUNK", n_chunk)
    n_chunk = stein.N_CHUNK
    rows = (max(1, k * n_chunk // d) if d <= stein.MIN_D
            else n_chunk)
    rng = np.random.RandomState(n + d)
    w = rng.rand(k, n).astype(np.float32)
    w[:, rng.rand(n) < 0.3] = 0.0
    w[1] = 0.0
    w[-1] = 0.0
    w /= np.maximum(w.sum(1, keepdims=True), 1e-30)
    g = (rng.randn(n, d) * 10).astype(np.float32)
    xc = (rng.randn(n, d) * 3 + 1).astype(np.float32)

    profiling.reset()
    operands = _Operands()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), operands:
        got = stein.stein_smom_plain(*map(torch.from_numpy, (w, g, xc)))
    counters = profiling.summary()["counters"]
    profiling.reset()

    slabs = -(-n // rows)
    assert counters == {"stein.moment_slabs": slabs}
    assert len(operands.sizes) == slabs
    # [K, N_CHUNK, D], or one row's D^2 outer products where K * N_CHUNK < D
    assert max(max(s) for s in operands.sizes) <= max(k * n_chunk, d) * d

    assert got.dtype == torch.float32 and got.shape == (k, d, d)
    want = np.einsum("kn,nd,ne->kde", w.astype(np.float64),
                     g.astype(np.float64), xc.astype(np.float64))
    dead = np.array([1, k - 1])
    assert torch.equal(got[dead], torch.zeros(2, d, d))
    live = np.setdiff1d(np.arange(k), dead)
    scale = np.abs(want[live]).reshape(len(live), -1).max(1)
    err = np.abs(got.numpy()[live].astype(np.float64)
                 - want[live]).reshape(len(live), -1).max(1)
    assert (err <= 1e-5 * scale).all(), (err / scale).tolist()
