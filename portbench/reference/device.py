"""Device selection and float32 policy for the PyTorch port.

Every entry point of the port takes an explicit ``device`` and defaults to
the CUDA card; code that wants the CPU (the tests) asks for it with
``device="cpu"``.  On the card, float32 matrix products and convolutions run
in full float32: TF32 keeps about three decimal digits, too few for the
Mahalanobis and Cholesky chains of this package, so :func:`resolve_device`
turns it off for both matmuls and cuDNN.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).

    Raises RuntimeError for a CUDA device when no card is present.  The
    reference leaves the TF32 switches as its caller set them
    (``portbench/check.py`` sets them for each of its runs)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:  # compare equal to the device tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
