# Frozen plain copy of cl4wsis_tpu_torch/train/losses.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Training losses (counterpart of ``cl4wsis_tpu/train/losses.py``), NCHW.

Logits and soft targets are (B, C, H, W); integer label maps are (B, H, W)
with 255 = ignore. Every loss computes in float32, whatever the logits'
dtype, and returns a 0-dim tensor (the per-pixel BCE returns (B, H, W)).
Nothing here reads a value back to the host.

In a run over several ranks each loss of a batch is this rank's share of
the loss of the global batch: its own numerator over the global count
(``core/dist``), so the shares sum to the global loss; at world 1 it is
the loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import dist

CENTER_LOSS_WEIGHT = 200.0   # train.py:100 of the upstream code
OFFSET_LOSS_WEIGHT = 0.01    # train.py:101 of the upstream code


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of `x` over the global batch, whose
    ranks hold equal shards: its own mean over the world size."""
    return x.mean() / dist.world()


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in torch's stable
    form: max(x, 0) - x t + log1p(exp(-|x|)), in float32."""
    x = logits.float()
    t = targets.float()
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _onehot(labels: torch.Tensor, valid: torch.Tensor, C: int) -> torch.Tensor:
    """(B, H, W) labels -> (B, C, H, W) float32 one-hot, zero where not
    `valid` (an invalid label reads as class 0 before it is zeroed)."""
    idx = torch.where(valid, labels, 0).long()
    out = torch.zeros((labels.shape[0], C) + tuple(labels.shape[1:]),
                      dtype=torch.float32, device=labels.device)
    return out.scatter_(1, idx[:, None], valid[:, None].float())


def bce_with_logits_ignore(logits: torch.Tensor, targets: torch.Tensor,
                           ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel sum over classes of BCE against the one-hot target, 0 at
    ignored pixels: (B, H, W). The caller takes the mean over all pixels,
    so ignored ones stay in the denominator."""
    valid = targets != ignore_index
    onehot = _onehot(targets, valid, logits.shape[1])
    return _bce_logits(logits, onehot).sum(1) * valid


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean BCE-with-logits over soft targets (share of the global
    batch's)."""
    return batch_mean(_bce_logits(logits, targets))


def deeplab_ce(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = 255,
               top_k_percent: float = 0.2) -> torch.Tensor:
    """Hard-pixel-mining cross entropy: the mean of the largest
    k = max(int(top_k_percent * numel), 1) pixel losses of the whole global
    batch, ignored pixels counting as 0.

    Each rank takes its own top min(k, numel) values; the ranks' candidates
    meet in one all-reduce of a zero-padded (world, min(k, numel)) buffer,
    which gives the global k-th value t. A rank's share is the sum of its
    own values among the global top k, over k. Values equal to t are taken
    by the lower ranks first: the loss is the one process's, and only which
    of several equal pixel losses gets the gradient may differ from it."""
    valid = labels != ignore_index
    logp = F.log_softmax(logits.float(), dim=1)
    idx = torch.where(valid, labels, 0).long()[:, None]
    nll = -torch.gather(logp, 1, idx)[:, 0] * valid
    flat = nll.reshape(-1)
    if top_k_percent >= 1.0:
        return batch_mean(flat)
    k = max(int(top_k_percent * flat.numel() * dist.world()), 1)
    m = min(k, flat.numel())
    top = torch.topk(flat, m).values                    # descending
    with torch.no_grad():
        r = dist.rank()
        cand = top.new_zeros((dist.world(), m))
        cand[r] = top
        cand = dist.all_sum(cand)
        t = torch.topk(cand.reshape(-1), k).values[-1]
        ties = (cand == t).sum(1)
        need = k - (cand > t).sum()                     # ties to take
        mine = torch.minimum(torch.clamp(
            need - (torch.cumsum(ties, 0)[r] - ties[r]), min=0), ties[r])
        keep = (top > t) | ((top == t) & (torch.cumsum(top == t, 0) <= mine))
    return (top * keep).sum() / k


def _weighted(err: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum(err * weight) / count(weight > 0), 0 when nothing is weighted;
    the count is the global batch's. `weight` broadcasts over the channels
    of `err`; the count is of the weight's own entries, as upstream
    normalises."""
    n = dist.all_sum((weight > 0).sum().float())
    return torch.where(n > 0, (err * weight).sum() / torch.clamp(n, min=1.0),
                       0.0)


def weighted_mse(out: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Center loss: sum(w * (out - target)^2) / count(w > 0), in float32."""
    return _weighted(torch.square(out.float() - target.float()), weight)


def weighted_l1(out: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Offset loss: sum(w * |out - target|) / count(w > 0), in float32."""
    return _weighted(torch.abs(out.float() - target.float()), weight)


def unbiased_ce(logits: torch.Tensor, labels: torch.Tensor, old_cl: int,
                ignore_index: int = 255) -> torch.Tensor:
    """Unbiased cross entropy: the old classes fold into the background
    probability; the mean over valid pixels."""
    x = logits.float()
    den = torch.logsumexp(x, dim=1)
    log_bkg = torch.logsumexp(x[:, :old_cl], dim=1) - den
    log_new = x[:, old_cl:] - den[:, None]
    valid = labels != ignore_index
    lab = torch.where(valid & (labels >= old_cl), labels, 0).long()
    picked = torch.gather(
        log_new, 1, torch.clamp(lab - old_cl, 0, x.shape[1] - old_cl - 1)
        [:, None])[:, 0]
    logp = torch.where(lab == 0, log_bkg, picked)
    return -(logp * valid).sum() / torch.clamp(valid.sum(), min=1)


def kd_loss(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 1.0,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft cross-entropy distillation toward the old model's C_old logits:
    -mean over pixels of the mean over old classes of
    softmax(alpha t) * log_softmax(x[:, :C_old])."""
    c_old = targets.shape[1]
    outputs = F.log_softmax(inputs[:, :c_old].float(), dim=1)
    labels = torch.softmax(targets.float() * alpha, dim=1)
    loss = (outputs * labels).mean(1)
    if mask is not None:
        loss = loss * mask
    return -loss.mean()


def unbiased_kd_loss(inputs: torch.Tensor, targets: torch.Tensor,
                     alpha: float = 1.0,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased KD: the new classes' logits fold into the background of
    the old distribution."""
    c_old = targets.shape[1]
    x = inputs.float()
    den = torch.logsumexp(x, dim=1)
    out_no_bkg = x[:, 1:c_old] - den[:, None]
    out_bkg = torch.logsumexp(torch.cat([x[:, :1], x[:, c_old:]], 1),
                              dim=1) - den
    labels = torch.softmax(targets.float() * alpha, dim=1)
    loss = (labels[:, 0] * out_bkg +
            (labels[:, 1:] * out_no_bkg).sum(1)) / c_old
    if mask is not None:
        loss = loss * mask
    return -loss.mean()


def icarl_loss(inputs: torch.Tensor, targets: torch.Tensor,
               output_old: torch.Tensor, bkg: float = 1.0,
               ignore_index: int = 255) -> torch.Tensor:
    """iCaRL distillation BCE: the one-hot target with its old-class
    channels replaced by the old model's (sigmoid) outputs, channel 0
    blended by `bkg` (the minimum when -1)."""
    c_old = output_old.shape[1]
    valid = targets != ignore_index
    onehot = _onehot(targets, valid, inputs.shape[1])
    old = output_old.float()
    onehot[:, 1:c_old] = old[:, 1:]
    if bkg != -1:
        onehot[:, 0] = bkg * onehot[:, 0] + (1 - bkg) * old[:, 0]
    else:
        onehot[:, 0] = torch.minimum(onehot[:, 0], old[:, 0])
    return _bce_logits(inputs, onehot).sum(1).mean()


def feature_distillation(features: torch.Tensor,
                         features_old: torch.Tensor) -> torch.Tensor:
    """loss_de: the MSE between the new and the old backbone features."""
    return batch_mean(torch.square(features.float() - features_old.float()))
