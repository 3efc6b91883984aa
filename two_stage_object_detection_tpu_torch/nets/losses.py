"""Detection losses (masked, static-shape).

The counterparts of the JAX package's ``nets/losses.py``.  The JAX functions
reduce one image and are ``vmap``-ed over the batch; here the batch axis is
written out: each function reduces the trailing sample axis (and the
coordinate axis) and keeps every leading axis, so an unbatched call gives the
JAX scalar and a ``[B, ...]`` call gives the ``[B]`` losses of the ``vmap``.
Zero positives (or no valid label) give 0, not NaN.
"""

from __future__ import annotations

import torch


def fast_rcnn_loc_loss(pred_loc: torch.Tensor, gt_loc: torch.Tensor,
                       gt_label: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smooth-L1 over positive samples, averaged over positive *elements*.

    Args:
      pred_loc / gt_loc: ``[..., N, 4]``.
      gt_label: ``[..., N]``; positives are ``> 0``.
      sigma: smooth-L1 transition parameter.

    Returns ``[...]`` float32.
    """
    pos = (gt_label > 0).to(torch.float32)[..., None]          # [..., N, 1]
    sigma2 = sigma ** 2
    diff = (gt_loc - pred_loc).to(torch.float32).abs()
    loss = torch.where(diff < 1.0 / sigma2, 0.5 * sigma2 * diff ** 2,
                       diff - 0.5 / sigma2)
    total = (loss * pos).sum(dim=(-2, -1))
    n_elem = pos.sum(dim=(-2, -1)) * pred_loc.shape[-1]
    return total / n_elem.clamp(min=1.0)


def softmax_cross_entropy_with_ignore(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      ignore_index: int = -1) -> torch.Tensor:
    """Mean softmax cross-entropy over the entries of the sample axis whose
    label is not ``ignore_index``.

    ``logits [..., N, C]``, ``labels [..., N]`` integer -> ``[...]``.
    """
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).to(torch.int64)
    log_probs = logits - logits.amax(dim=-1, keepdim=True)
    log_probs = log_probs - torch.log(
        torch.exp(log_probs).sum(dim=-1, keepdim=True))
    nll = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    nll = nll * valid.to(nll.dtype)
    return nll.sum(dim=-1) / valid.sum(dim=-1).clamp(min=1)


def mask_loss(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Mask R-CNN's mask loss: per-pixel binary cross-entropy of
    ``logits [B, S, M, M]`` (each roi's own class) against ``targets`` in
    {0, 1}, averaged over the valid rois of the whole batch times ``M * M``
    pixels; 0 with no valid roi."""
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        logits.to(torch.float32), targets, reduction="none").sum((-2, -1))
    n = valid.sum().clamp(min=1) * (logits.shape[-2] * logits.shape[-1])
    return (bce * valid.to(bce.dtype)).sum() / n
