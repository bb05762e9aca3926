"""Target distribution interface.

(JAX counterpart: gmmvi_tpu/experiments/targets/lnpdf.py)

The port runs eagerly, so a target is simply called between the propose and
update phases of a step; there is no compiled/host split to choose between.
Targets with analytic gradients override :meth:`LNPDF.log_density_and_grad`;
the default differentiates :meth:`LNPDF.log_density` with autograd.
"""
from __future__ import annotations

from typing import Tuple

import torch


class LNPDF:
    """Unnormalized target log-density interface."""

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_num_dimensions(self) -> int:
        raise NotImplementedError

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Default: autograd through :meth:`log_density` (each sample's
        density depends on that sample alone, so the gradient of the sum is
        the per-sample gradient)."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            ld = self.log_density(x)
            (grads,) = torch.autograd.grad(ld.sum(), x)
        return ld.detach(), grads
