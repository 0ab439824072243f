"""Weak-supervision losses (counterpart of ``cl4wsis_tpu/wss/losses.py``),
NCHW: the nGWP focal pooling, the image-level BCE, pseudo-GT masks, the
class-balanced mask losses and the random-drop negative loss.

All of them compute in float32 and read nothing back to the host. The
random-drop loss takes its negative labels as an argument, so the caller
decides where they are drawn. Over several ranks each loss is this rank's
share of the global batch's (``train/losses``): batch means and counts are
the global batch's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train.losses import _bce_logits, batch_mean


def ngwp_focal(outputs: torch.Tensor, focal: bool = True,
               lam: float = 1e-2) -> torch.Tensor:
    """nGWP image logits plus the focal penalty, (B, C, H, W) -> (B, C)."""
    B, C = outputs.shape[:2]
    x = outputs.float().reshape(B, C, -1)
    masks = torch.softmax(x, dim=1)
    y = (x * masks).sum(-1) / (1.0 + masks.sum(-1))
    if focal:
        m = masks.mean(-1)
        y = y + (1.0 - m) ** 3 * torch.log(lam + m)
    return y


def bce_loss(outputs: torch.Tensor, labels: torch.Tensor, mode: str = "ngwp",
             reduction: str = "sum") -> torch.Tensor:
    """Image-level BCE of the pooled CAM logits' last labels.shape[-1]
    channels against `labels` (B, n)."""
    if mode == "ngwp":
        y = ngwp_focal(outputs)
    else:
        y = outputs.float().flatten(2).mean(-1)
    per = _bce_logits(y[:, -labels.shape[-1]:], labels)
    if reduction == "sum":
        return batch_mean(per.sum(1))
    return batch_mean(per)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """1 where a channel reaches the pixel's max over channels (ties all
    set), else 0."""
    return (x >= x.amax(1, keepdim=True)).to(x.dtype)


def pseudo_gtmask(mask: torch.Tensor, ambiguous: bool = True,
                  cutoff_top: float = 0.6, cutoff_bkg: float = 0.7,
                  cutoff_low: float = 0.2) -> torch.Tensor:
    """(B, C, H, W) probabilities -> binary pseudo GT: a pixel of a class is
    set above max(the class's max x cutoff, cutoff_low), cutoff_bkg for the
    background channel; with `ambiguous`, pixels set in more than one
    class are cleared."""
    C = mask.shape[1]
    mx = mask.amax((2, 3), keepdim=True)
    scale = torch.full((1, C, 1, 1), cutoff_top, dtype=mask.dtype,
                       device=mask.device)
    scale[:, 0] = cutoff_bkg
    thresh = torch.clamp(mx * scale, min=cutoff_low)
    pseudo = (mask > thresh).to(mask.dtype)
    if ambiguous:
        amb = (pseudo.sum(1, keepdim=True) > 1).to(mask.dtype)
        pseudo = (1.0 - amb) * pseudo
    return pseudo


def _balanced_weights(pseudo_gt: torch.Tensor, gt_labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixel weights (B, H, W), the batch gate (B,) and pixels per class
    (B, C) of the balanced mask losses. An image passes the gate iff its
    pseudo mask holds exactly its image-level classes plus background."""
    npc = pseudo_gt.sum((2, 3))                                  # B, C
    ntot = npc.sum(-1, keepdim=True)
    class_weight = (ntot - npc) / (1.0 + ntot)
    pix_weight = (pseudo_gt * class_weight[:, :, None, None]).sum(1)
    gt_num = gt_labels.sum(-1) + 1.0
    npc_gated = torch.cat([npc[:, :1], npc[:, 1:] * gt_labels], dim=1)
    ps_num = (npc_gated > 0).float().sum(-1)
    return pix_weight, (gt_num == ps_num).float(), npc


def _masked_loss(nll: torch.Tensor, pseudo_gt: torch.Tensor,
                 gt_labels: torch.Tensor) -> torch.Tensor:
    pix_weight, batch_weight, _ = _balanced_weights(pseudo_gt, gt_labels)
    per_img = (pix_weight * nll).flatten(1).mean(-1)
    return batch_mean(batch_weight * per_img)


def balanced_mask_loss_ce(mask_logits: torch.Tensor, pseudo_gt: torch.Tensor,
                          gt_labels: torch.Tensor,
                          ignore_index: int = 255) -> torch.Tensor:
    """Class-balanced CE of the mask logits against the pseudo GT's argmax,
    at pixels where the pseudo GT is set, with the image-level gate."""
    H, W = pseudo_gt.shape[2:]
    x = resize_bilinear(mask_logits, (H, W), align_corners=True).float()
    mask_gt = torch.argmax(pseudo_gt, dim=1)
    valid = pseudo_gt.sum(1) >= 1.0
    logp = F.log_softmax(x, dim=1)
    nll = -torch.gather(logp, 1, mask_gt[:, None])[:, 0] * valid
    return _masked_loss(nll, pseudo_gt, gt_labels)


def balanced_mask_loss_unce(mask_logits: torch.Tensor,
                            pseudo_gt: torch.Tensor, gt_labels: torch.Tensor,
                            old_cl: int,
                            ignore_index: int = 255) -> torch.Tensor:
    """The unbiased variant: the old classes fold into the background;
    pixels whose pseudo class is an old foreground class give 0."""
    C, H, W = pseudo_gt.shape[1:]
    x = resize_bilinear(mask_logits, (H, W), align_corners=True).float()
    mask_gt = torch.argmax(pseudo_gt, dim=1)
    valid = pseudo_gt.sum(1) >= 1.0
    den = torch.logsumexp(x, dim=1)
    log_bkg = torch.logsumexp(x[:, :old_cl], dim=1) - den
    log_new = x[:, old_cl:] - den[:, None]
    picked = torch.gather(
        log_new, 1, torch.clamp(mask_gt - old_cl, 0, C - old_cl - 1)
        [:, None])[:, 0]
    logp = torch.where(mask_gt < old_cl,
                       torch.where(mask_gt == 0, log_bkg, 0.0), picked)
    return _masked_loss(-(logp * valid), pseudo_gt, gt_labels)


def randrop_loss(inputs: torch.Tensor, entropy_ref: torch.Tensor,
                 labels_neg: torch.Tensor, old_classes: int,
                 label: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random-drop negative loss: where a new class is confident
    (entropy_ref > 0.5), BCE of the CAM logit of a random old class
    `labels_neg` (B, h, w), in [0, old_classes), toward 1.

    inputs (B, C, h, w) CAM logits; entropy_ref (B, C, h, w) sigmoid CAM
    masked by the image labels; with `label` (B, C - 1), a negative class
    absent from the image is dropped (class 0 always counts as present).
    """
    C = inputs.shape[1]
    weight = (entropy_ref[:, old_classes:].amax(1) > 0.5).float()
    ignore = weight == 0
    if label is not None:
        present = torch.gather(F.pad(label, (1, 0), value=1.0), 1,
                               labels_neg.flatten(1).long())
        ignore = ignore | (present.view_as(labels_neg) == 0)
    onehot = F.one_hot(labels_neg.long(), C).permute(0, 3, 1, 2).float()
    onehot = onehot * (~ignore)[:, None]
    per = _bce_logits(inputs, onehot) * (onehot == 1.0)
    pix = per.sum(1)
    valid = onehot.sum(1) != 0
    n_valid, n_weighted = dist.all_sum(torch.stack(
        [valid.sum().float(), weight.sum()]))
    loss = torch.where(n_valid > 0,
                       (pix * valid).sum() / torch.clamp(n_valid, min=1), 0.0)
    return torch.where(n_weighted > 0, loss, 0.0)
