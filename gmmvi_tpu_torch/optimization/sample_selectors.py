"""Sample selection, VIPS (component-based), with or without sample reuse.

(JAX counterpart: gmmvi_tpu/optimization/sample_selectors.py)

:func:`propose` takes the newest ``reused * Kmax`` samples of the database
(with their background densities, kernel B4 on the card), estimates each
component's effective sample size from self-normalized importance weights
(kernel B2 for the component densities) and draws a full ``[Kmax, n_des]``
batch of fresh samples of which the first ``max(1, n_des - n_eff)`` per
active component are valid.  The target is evaluated between
:func:`propose` and :func:`finalize_fused`, which stores the valid samples
and returns the window with the current model's density pack.  The
standard-normal draws come in as ``eps``, so a caller can inject them.  The
mixture-based (Lin) selector is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.optimization import sample_db as db_ops
from gmmvi_tpu_torch.optimization.sample_db import SampleDbState
from gmmvi_tpu_torch.ops.stable import masked_logsumexp


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


def effective_samples(log_densities: torch.Tensor, background: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """``[K]`` int32 ESS ``floor(1 / sum w^2)`` from self-normalized
    importance weights of ``log_densities [K, W]`` against the background,
    in the JAX package's order (masked logsumexp, exp, sum of squares)."""
    log_w = log_densities - background[None, :]
    mask = valid[None, :].expand(log_w.shape)
    log_w = log_w - masked_logsumexp(log_w, mask=mask, dim=1, keepdim=True)
    w = torch.where(mask, torch.exp(log_w), 0.0)
    denom = torch.sum(torch.square(w), dim=1)
    n_eff = torch.where(denom > 0, 1.0 / torch.clamp(denom, min=1e-38), 0.0)
    return torch.floor(n_eff).to(torch.int32)


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


def propose(model: GmmState, db: SampleDbState, cfg: SelectorConfig,
            eps: torch.Tensor) -> Proposal:
    """VIPS proposal: the ESS pass over the reuse window, then ``n_des``
    draws ``mu_k + L_k eps`` per slot from the standard-normal ``eps``
    ``[Kmax, n_des, D]``, of which the first ``max(1, n_des - n_eff_k)`` of
    every active slot are valid."""
    check_supported(cfg)
    kmax, n_des = model.max_components, cfg.desired_samples_per_component
    dev = model.device
    w_reuse = reuse_window_size(cfg, kmax)
    if w_reuse > 0:
        win = db_ops.get_newest_samples(
            db, w_reuse, cfg.reused_samples_per_component * model.num_active,
            cfg.max_background_dists)
        num_reused = win.num_valid
        n_eff = effective_samples(
            gmm_ops.component_log_densities_fast(model, win.samples),
            win.background_log_pdfs, win.valid)
        n_eff = torch.where(win.num_valid > 0, n_eff, 0)
    else:
        num_reused = torch.zeros((), dtype=torch.int32, device=dev)
        n_eff = torch.zeros((kmax,), dtype=torch.int32, device=dev)
    counts = torch.where(model.mask, torch.clamp(n_des - n_eff, min=1), 0)
    fresh = gmm_ops.sample_from_components(model, eps)      # [Kmax, n, D]
    col = torch.arange(n_des, device=dev)
    valid = (col[None, :] < counts[:, None]) & model.mask[:, None]
    mapping = torch.arange(kmax, dtype=torch.int32, device=dev)
    return Proposal(
        samples=fresh.reshape(-1, model.num_dimensions),
        valid=valid.reshape(-1),
        mapping=mapping[:, None].expand(kmax, n_des).reshape(-1),
        num_reused=num_reused,
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
