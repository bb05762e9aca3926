"""Sample selection, VIPS (component-based) without sample reuse.

(JAX counterpart: gmmvi_tpu/optimization/sample_selectors.py)

:func:`propose` draws a full ``[Kmax, n_des]`` batch of fresh samples with a
validity mask; the target is evaluated between :func:`propose` and
:func:`finalize_fused`, which stores the valid samples and returns the
window with the current model's density pack.  The standard-normal draws
come in as ``eps``, so a caller can inject them.  Sample reuse (the ESS
pass over old samples) and the mixture-based (Lin) selector are not ported
yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.optimization import sample_db as db_ops
from gmmvi_tpu_torch.optimization.sample_db import SampleDbState


class SelectorConfig(NamedTuple):
    kind: str                          # "component-based" | "mixture-based"
    desired_samples_per_component: int
    reused_samples_per_component: int  # floor(ratio * n_des)
    max_background_dists: int

    @property
    def is_vips(self) -> bool:
        return self.kind == "component-based"


class Proposal(NamedTuple):
    """Fresh samples awaiting target evaluation."""

    samples: torch.Tensor     # [B, D]
    valid: torch.Tensor       # [B] bool
    mapping: torch.Tensor     # [B] int32 generating slot
    num_reused: torch.Tensor  # 0-d int32


def reuse_window_size(cfg: SelectorConfig, max_components: int) -> int:
    return cfg.reused_samples_per_component * max_components


def total_window_size(cfg: SelectorConfig, max_components: int) -> int:
    fresh = (max_components * cfg.desired_samples_per_component
             if cfg.is_vips else cfg.desired_samples_per_component)
    return reuse_window_size(cfg, max_components) + fresh


def check_supported(cfg: SelectorConfig) -> None:
    if not cfg.is_vips:
        raise NotImplementedError(
            "the mixture-based (Lin) sample selector is not ported yet")
    if cfg.reused_samples_per_component > 0:
        raise NotImplementedError(
            "sample reuse (ratio_reused_samples_to_desired > 0) is not "
            "ported yet")


def propose(model: GmmState, db: SampleDbState, cfg: SelectorConfig,
            eps: torch.Tensor) -> Proposal:
    """VIPS proposal: ``n_des`` draws ``mu_k + L_k eps`` per slot from the
    standard-normal ``eps`` ``[Kmax, n_des, D]``; every active slot's draws
    are valid (no reuse means no effective samples to subtract)."""
    check_supported(cfg)
    kmax, n_des = model.max_components, cfg.desired_samples_per_component
    fresh = gmm_ops.sample_from_components(model, eps)      # [Kmax, n, D]
    valid = model.mask[:, None].expand(kmax, n_des)
    mapping = torch.arange(kmax, dtype=torch.int32, device=model.device)
    return Proposal(
        samples=fresh.reshape(-1, model.num_dimensions),
        valid=valid.reshape(-1),
        mapping=mapping[:, None].expand(kmax, n_des).reshape(-1),
        num_reused=torch.zeros((), dtype=torch.int32, device=model.device),
    )


def finalize_fused(model: GmmState, db: SampleDbState, cfg: SelectorConfig,
                   iteration: int, proposal: Proposal,
                   target_lnpdfs: torch.Tensor, target_grads: torch.Tensor,
                   rand_slots: torch.Tensor, accept_u: torch.Tensor):
    """Store the evaluated samples and return ``(db, window, pack)``: the
    window of the newest samples and the current model's density pack over
    it (kernel B1 on the card), shared by the background mixture and the
    natural-gradient estimator."""
    check_supported(cfg)
    db = db_ops.add_samples(
        db, iteration, model, proposal.samples, proposal.valid,
        proposal.mapping, target_lnpdfs, target_grads, rand_slots, accept_u)
    n_new = proposal.valid.sum(dtype=torch.int32)
    win, pack = db_ops.get_newest_samples_fused(
        db, total_window_size(cfg, model.max_components),
        proposal.num_reused + n_new, cfg.max_background_dists, model,
        iteration, any_old_dists=cfg.reused_samples_per_component > 0)
    return db, win, pack
