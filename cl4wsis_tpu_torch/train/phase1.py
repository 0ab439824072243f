"""The phase-1 (CL-WSSS) train step (counterpart of
``cl4wsis_tpu/train/phase1.py``).

With image-level labels only for the new classes, the step trains the
backbone, the seg head, the PseudoLabeler's CAM head and the
PeakGenerator on live backbone features, supervised by

* l_cam_new: image-level nGWP-focal BCE of the new-class CAM channels;
* l_loc: BCE of the old-class CAM channels toward the old model's seg;
* flac: flip and rot90 consistency MSE of the mean new-class CAM;
* l_peak: image-level BCE of the PeakGenerator's logits;
* lde: MSE between the new and the old backbone features;
* with `use_pseudo` (after the warm-up epochs): the PAMR-refined CAM ->
  pseudo seg GT -> gated BCE of the model's seg (l_seg), class-balanced CE
  of the raw CAM (l_cls) and the random-drop negative loss.

Its random draws are the rot90 count `angle_k` in {1, 2, 3}, drawn on the
host (from the step's generator's seed and the step count) so that
``torch.rot90`` gets a Python int, and the random-drop negative labels,
drawn on the device from the step's generator at the global batch's shape
(each rank keeps its rows, ``core/dist``). Over several ranks the losses
are this rank's shares of the global batch's and the gradients are summed
over ranks. Nothing in the step waits on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.ops.pamr import pamr
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train import losses
from cl4wsis_tpu_torch.train.state import TrainState, prepare
from cl4wsis_tpu_torch.wss import losses as wss_losses

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def denorm(images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalised images -> RGB in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype,
                       device=images.device)[:, None, None]
    return images * std + mean


def rot90_batch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate the last two (square) dims by k quarter turns, from the first
    toward the second, as ``jnp.rot90(a, k, axes=(1, 2))`` turns NHWC."""
    return torch.rot90(x, k, (-2, -1))


def rot90_back(x: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of :func:`rot90_batch`."""
    return torch.rot90(x, 4 - k, (-2, -1))


def draw_angle_k(generator: Optional[torch.Generator], step: int) -> int:
    """The rot90 count in {1, 2, 3} of step `step`, drawn on the host from
    `generator`'s seed (torch's global seed without one) plus `step`, so
    that the step never waits on the card and a resumed run draws on."""
    seed = (generator.initial_seed() if generator is not None
            else torch.initial_seed()) + step
    host = torch.Generator().manual_seed(seed % 2 ** 63)
    return int(torch.randint(1, 4, (), generator=host))


def phase1_group_fn(name: str) -> str:
    """The learning-rate group of a parameter of
    ``nn.ModuleDict(model=..., pseudolabeler=..., peakgenerator=...)``."""
    if name.startswith("model.body."):
        return "body"
    if name.startswith(("pseudolabeler.", "peakgenerator.")):
        return "pseudo"
    return "seg"


def _with_labels(maps: torch.Tensor, l1h: torch.Tensor) -> torch.Tensor:
    """Channels 1.. of (B, C, h, w) times the image labels l1h (B, C - 1)."""
    return torch.cat([maps[:, :1], maps[:, 1:] * l1h[:, :, None, None]], 1)


def make_phase1_train_step(model: torch.nn.Module,
                           model_old: torch.nn.Module,
                           pseudolabeler: torch.nn.Module,
                           peakgenerator: torch.nn.Module,
                           old_classes: int, *,
                           loss_de: float = 1.0,
                           l_seg_weight: float = 1.0,
                           alpha: float = 0.5,
                           icarl_bkg: float = -1.0,
                           use_affinity: bool = True,
                           use_flac: bool = True,
                           use_randrop: bool = True,
                           use_pseudo: bool = False,
                           no_mask: bool = False,
                           device: str = "cuda",
                           dtype: str = "float32") -> Callable:
    """Build the phase-1 step: ``train_step(state, batch, generator,
    draws=None)``; `use_pseudo` selects the post-warm-up program.

    The modules move to `device` (the card unless the caller passes
    "cpu"). `state.model` is ``nn.ModuleDict(model=model,
    pseudolabeler=pseudolabeler, peakgenerator=peakgenerator)`` with its
    optimizer grouped by :func:`phase1_group_fn`. `dtype` "bfloat16" runs
    the networks under autocast; the losses, PAMR and the pseudo GT
    compute in float32. batch: "image" (B, H, W, 3) normalised, "l1h"
    (B, C - 1) image-level labels. `angle_k` comes from a host generator
    seeded with `generator`'s seed (torch's global one without it) plus
    the state's step count, the body's dropout masks (WideResNet's mod6
    and mod7) and then the random-drop labels from `generator` (on the
    device); ``draws={"angle_k": int, "labels_neg": (B, h, w)
    tensor}`` overrides either (this rank's rows). The step updates
    `state` in place and returns the metrics loss, l_seg, l_cam_int,
    l_cam_new, l_loc, l_cls, lde and flac as tensors on the device (this
    rank's shares).
    """
    device, fmt, autocast = prepare(
        (model, model_old, pseudolabeler, peakgenerator), device, dtype)
    tot_classes = model.tot_classes

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        state.model.train()
        model_old.eval()
        x = batch["image"].to(device).permute(0, 3, 1, 2).contiguous(
            memory_format=fmt)
        l1h = batch["l1h"].to(device).float()
        bs = x.shape[0]
        zero = torch.zeros((), device=device)

        # the old model, frozen; the new model in train mode
        with torch.no_grad(), autocast():
            out_old, feats_old = model_old.forward_seg(x, interpolate=False)
        with autocast():
            pred, feats = model.forward_seg(x, interpolate=False,
                                            generator=generator)
            if model.has_instance:   # its BN statistics move, as in JAX
                model.forward_instance(feats["features"], generator)
        feat_body = feats["body"]

        # the PseudoLabeler: an eval pass (running statistics) for the
        # pseudo GT, then the train pass whose statistics move
        pseudolabeler.eval()
        with torch.no_grad(), autocast():
            int_masks = pseudolabeler(feat_body)
        pseudolabeler.train()
        if use_flac:
            angle_k = draws.get("angle_k")
            if angle_k is None:
                angle_k = draw_angle_k(generator, state.step)
            feat_in = torch.cat([feat_body, torch.flip(feat_body, [3]),
                                 rot90_batch(feat_body, angle_k)])
        else:
            feat_in = feat_body
        with autocast():
            int_masks_raw = pseudolabeler(feat_in)

        flac_loss = zero
        if use_flac:
            A = int_masks_raw[:, old_classes:].float().mean(1)   # 3B, h, w
            a_ori = torch.sigmoid(A[:bs])
            a_flip = torch.sigmoid(torch.flip(A[bs:2 * bs], [2]))
            a_rot = torch.sigmoid(A[2 * bs:])
            with torch.no_grad():
                a_target = torch.maximum(torch.maximum(a_ori, a_flip),
                                         rot90_back(a_rot, angle_k))
                a_rot_target = rot90_batch(a_target, angle_k)
            flac_loss = (losses.batch_mean(torch.square(a_ori - a_target)) +
                         losses.batch_mean(torch.square(a_flip - a_target)) +
                         losses.batch_mean(torch.square(a_rot - a_rot_target))
                         ) / 3.0
            int_masks_raw = int_masks_raw[:bs]

        with autocast():
            peak_logits, _ = peakgenerator(int_masks_raw)

        # the CAM losses; l1h is (B, tot - 1), its new classes from old - 1
        cam_labels = l1h if no_mask else l1h[:, old_classes - 1:]
        l_cam_new = wss_losses.bce_loss(int_masks_raw, cam_labels,
                                        mode="ngwp", reduction="mean")
        l_peak = losses.bce_with_logits(peak_logits[:, old_classes - 1:],
                                        l1h[:, old_classes - 1:])
        cam_size = tuple(int_masks.shape[2:])
        out_old_seg = resize_bilinear(out_old["seg"], cam_size)
        out_seg = resize_bilinear(pred["seg"], cam_size)
        target_old = torch.sigmoid(out_old_seg.float())
        if no_mask:   # mask the old-class targets by the image labels
            target_old = _with_labels(target_old, l1h[:, :old_classes - 1])
        l_loc = losses.bce_with_logits(int_masks_raw[:, :old_classes],
                                       target_old)
        l_cam_int = l_cam_new + l_loc + l_peak + flac_loss
        lde = loss_de * losses.feature_distillation(feat_body,
                                                    feats_old["body"])

        l_seg = l_cls = zero
        if use_pseudo:
            with torch.no_grad():
                soft = torch.softmax(int_masks.float(), dim=1)
                masks_soft = soft
                if use_affinity:
                    im = resize_bilinear(denorm(x.float()), cam_size,
                                         align_corners=True)
                    masks_soft = pamr(im, soft)
                masks_orig = _with_labels(soft, l1h)
                masks_soft = _with_labels(masks_soft, l1h)
                pseudo_gt_seg = wss_losses.pseudo_gtmask(
                    masks_soft, ambiguous=True, cutoff_top=0.6,
                    cutoff_bkg=0.7, cutoff_low=0.2)
                lx = wss_losses.binarize(masks_orig)
                gt_lx = alpha * lx + (1 - alpha) * masks_orig
                px_cls = gt_lx.sum((2, 3))
                bw = (px_cls[:, old_classes:] > 0) == \
                    (l1h[:, old_classes - 1:] > 0)
                batch_weight = (bw.sum(1) ==
                                tot_classes - old_classes).float()
                if icarl_bkg == -1:
                    bg = torch.minimum(target_old[:, 0], gt_lx[:, 0])
                else:
                    bg = ((1 - icarl_bkg) * target_old[:, 0] +
                          icarl_bkg * gt_lx[:, 0])
                pseudo_seg_map = torch.cat(
                    [bg[:, None], target_old[:, 1:], gt_lx[:, old_classes:]],
                    dim=1)

            per_pix = losses._bce_logits(out_seg, pseudo_seg_map).sum(1)
            per_img = per_pix.flatten(1).mean(-1)
            l_seg = l_seg_weight * (batch_weight * per_img).sum() / (
                dist.all_sum(batch_weight.sum()) + 1e-5)
            l_cls = wss_losses.balanced_mask_loss_ce(int_masks_raw,
                                                     pseudo_gt_seg, l1h)
            if use_randrop:
                ref = _with_labels(torch.sigmoid(int_masks.float()), l1h)
                labels_neg = draws.get("labels_neg")
                if labels_neg is None:
                    labels_neg = dist.rows_of(torch.randint(
                        0, old_classes, dist.global_shape((bs,) + cam_size),
                        generator=generator, device=device))
                l_cam_int = l_cam_int + wss_losses.randrop_loss(
                    int_masks_raw, ref, labels_neg.to(device), old_classes,
                    label=l1h if no_mask else None)

        loss = l_seg + lde + (l_cls + l_cam_int)
        loss.backward()
        state.apply_gradients()
        metrics = {"loss": loss, "l_seg": l_seg, "l_cam_int": l_cam_int,
                   "l_cam_new": l_cam_new, "l_loc": l_loc, "l_cls": l_cls,
                   "lde": lde, "flac": flac_loss}
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
