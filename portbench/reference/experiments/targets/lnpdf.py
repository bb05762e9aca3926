"""Target distribution interface.

(JAX counterpart: gmmvi_tpu/experiments/targets/lnpdf.py)

A target is called between the propose and update phases of a step.  Two
flags, set through ``LNPDF.__init__`` as in the JAX package, decide how:

* ``safe_for_jit`` (the JAX package's name, the reference's
  ``safe_for_tf_graph``) decides which rows it sees: a target that is safe
  (True, the default) is evaluated on every padded row of the proposal, as
  in the JAX package's compiled step; one that is not (a target with host
  state, such as a minibatch cursor, or a Python callable outside torch)
  is given only the valid rows, compacted into a power-of-two bucket
  padded with row 0 (``GMMVI.train_iter``), so it sees the rows, in the
  order, that the JAX package gives it.
* ``use_log_density_and_grad`` decides where a first-order estimator
  (Stein) takes the gradient from: True calls
  :meth:`LNPDF.log_density_and_grad`, the target's own (analytic)
  gradient; False (the default) calls :meth:`LNPDF.log_density_and_autograd`,
  the per-sample autograd of :meth:`LNPDF.log_density` (the JAX package's
  ``vmap(value_and_grad)``).  A zero-order estimator (MORE) calls
  :meth:`LNPDF.log_density` alone, whatever the flag.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class LNPDF:
    """Unnormalized target log-density interface."""

    _use_log_density_and_grad = False
    _safe_for_jit = True

    def __init__(self, use_log_density_and_grad: bool = False,
                 safe_for_jit: bool = True):
        self._use_log_density_and_grad = use_log_density_and_grad
        self._safe_for_jit = safe_for_jit

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_num_dimensions(self) -> int:
        raise NotImplementedError

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The target's own gradient, read where
        ``use_log_density_and_grad`` is True; by default
        :meth:`log_density_and_autograd`."""
        return self.log_density_and_autograd(x)

    def log_density_and_autograd(self, x: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Values and per-sample gradients by autograd through
        :meth:`log_density` (each sample's density depends on that sample
        alone, so the gradient of the sum is the per-sample gradient): what
        a first-order estimator reads where ``use_log_density_and_grad`` is
        False."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            ld = self.log_density(x)
            (grads,) = torch.autograd.grad(ld.sum(), x)
        return ld.detach(), grads

    def expensive_metrics(self, model_state, samples) -> dict:
        """Task-specific metrics for the runner's evaluations; none by
        default."""
        return {}

    def can_sample(self) -> bool:
        return False

    def sample(self, n: int, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """``n`` draws of the target, where :meth:`can_sample`."""
        raise NotImplementedError

    @property
    def use_log_density_and_grad(self) -> bool:
        return self._use_log_density_and_grad

    @property
    def safe_for_jit(self) -> bool:
        return self._safe_for_jit

    @property
    def safe_for_tf_graph(self) -> bool:
        """The reference's name of :attr:`safe_for_jit`."""
        return self._safe_for_jit

