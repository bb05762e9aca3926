"""What both sample databases hand the optimizer: the window of newest
samples, and the count-weighted background mixture over their generating
distributions.

(JAX counterpart: the window half of gmmvi_tpu/optimization/sample_db.py,
which ``sample_db_decimate.py`` there imports)

``sample_db`` (the ring) and ``sample_db_decimate`` (the decimating
store) each gather their window and count its distinct generating
distributions; this module keeps the ``max_background_dists`` most used (in
``lax.top_k``'s order) and evaluates their mixture at every sample: kernel
B4 (``ops/background.py``, whose plain version is the JAX package's
``_dist_log_pdfs`` chain) for full covariances up to D = 128, B5's mixture
output up to D = 512, and above that, or for a diagonal model, the JAX
package's XLA chain in plain torch.  Counts and the selection table are
scatters into spill-binned tensors, so no step reads the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from gmmvi_tpu_torch.models.gmm import LOG_2PI, diag_half_maha, xla_densities
from gmmvi_tpu_torch.ops.background import background_logpdf
from gmmvi_tpu_torch.ops.density_large import MAX_D as KERNEL_MAX_D
from gmmvi_tpu_torch.ops.stable import NEG_INF, masked_logsumexp
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.utils.profiling import read


@dataclass
class SampleWindow:
    """A statically-shaped view of the newest samples with their background
    densities; ``[W]``-shaped with a validity mask."""

    samples: torch.Tensor              # [W, D]
    mapping: torch.Tensor              # [W] generating slot
    target_lnpdfs: torch.Tensor        # [W]
    target_grads: torch.Tensor         # [W, D]
    background_log_pdfs: torch.Tensor  # [W]
    valid: torch.Tensor                # [W] bool
    num_valid: torch.Tensor            # 0-d int32
    sample_iters: torch.Tensor         # [W] int32

    @property
    def newest_mask(self) -> torch.Tensor:
        """True for the valid samples of the newest add batch."""
        newest = reduce.data_max(torch.max(torch.where(
            self.valid, self.sample_iters, -1)))
        return self.valid & (self.sample_iters == newest)


def background(diagonal: bool, means, inv_chols, log_weights, log_dets,
               samples) -> torch.Tensor:
    """The count-weighted background log-density ``[N]`` over the rows
    with a finite log weight: kernel B4 (``background_logpdf``; B5's mixture
    output above D = 128), or for a diagonal model, and above D = 512, the
    JAX package's XLA chain in plain torch (``_dist_log_pdfs`` then
    ``masked_logsumexp``)."""
    if not diagonal:
        if means.shape[1] > KERNEL_MAX_D:
            return xla_densities(means, inv_chols, log_weights, log_dets,
                                 samples)[1]
        return background_logpdf(means, inv_chols, log_weights, log_dets,
                                 samples)
    log_pdfs = diag_half_maha(means, inv_chols, samples) \
        - log_dets[:, None] - 0.5 * means.shape[1] * LOG_2PI
    return masked_logsumexp(log_pdfs + log_weights[:, None],
                            mask=(log_weights > NEG_INF)[:, None], dim=0)


def count_bins(bins: torch.Tensor, size: int) -> torch.Tensor:
    """``[size]`` float counts of ``bins``; entries equal to ``size`` go to
    a spill bin (a scatter-add of ones: exact, and unlike bincount no host
    sync)."""
    bins = bins.long()
    return torch.zeros(size + 1, dtype=torch.float32,
                       device=bins.device).index_add_(
        0, bins, torch.ones_like(bins, dtype=torch.float32))[:size]


def select_dists(counts: torch.Tensor, u: int, dist_key: torch.Tensor):
    """The ``u`` most used distributions in ``lax.top_k``'s order (by count,
    ties to the lower key): ``(top_counts, top_keys, sel_mask, selected)``
    where ``selected`` says for each sample whether its distribution is among
    them.  Marking them with a host ``True`` copies it to the card, which
    waits for the card (the read ``select_dists``)."""
    nkeys = counts.shape[0]
    top_keys = torch.sort(counts, descending=True, stable=True).indices[:u]
    top_counts = counts[top_keys]
    sel_mask = top_counts > 0
    table = torch.zeros(nkeys + 1, dtype=torch.bool, device=counts.device)
    marked = torch.where(sel_mask, top_keys, nkeys)

    def mark():
        table[marked] = True

    read(mark, "select_dists")
    selected = table[torch.clamp(dist_key.long(), max=nkeys)]
    return top_counts, top_keys, sel_mask, selected





def rank_window(diagonal: bool, means_u, inv_u, log_weights, log_dets_u,
                samples, comp, lnpdfs, grads, valid, sample_iters
                ) -> SampleWindow:
    """The window of a replicated database as this rank holds it: its
    block of rows (all of them unmeshed) with their background densities
    over the selected distributions, and the count of valid samples over
    the whole window."""
    num_valid = valid.sum(dtype=torch.int32)
    samples, comp, lnpdfs, grads, valid, sample_iters = (
        reduce.rows(x) for x in (samples, comp, lnpdfs, grads, valid,
                                 sample_iters))
    # (the counts are float32, as in the JAX package; a float64 state
    # takes their logarithms exactly)
    bg = background(diagonal, means_u, inv_u,
                    log_weights.to(means_u.dtype), log_dets_u, samples)
    return SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=num_valid, sample_iters=sample_iters)
