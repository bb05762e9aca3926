"""Input checks of the plain versions.

The frozen reference launches no kernel: every wrapper of ``ops/`` runs its
plain PyTorch version on any device.  Only the checks of the program's
``ops/cuda.py`` are kept.
"""
from __future__ import annotations

from typing import Dict

import torch


def check_tensors(tensors: Dict[str, tuple], device: torch.device) -> None:
    """Each ``name: (tensor, shape)`` is float32 (or all of them float64),
    of that shape, on ``device`` and row-major."""
    all64 = all(t.dtype == torch.float64 for t, _ in tensors.values())
    want = torch.float64 if all64 else torch.float32
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
