"""The phase-2 (CL4WSIS instance) train step (counterpart of
``cl4wsis_tpu/train/phase2.py::make_phase2_train_step``).

Backbone and semantic branch stay frozen; only the instance decoder and
head train. One step:

1. the old model's eval forward (its center and offset supervise the old
   classes);
2. two eval ``forward_seg`` passes, on the image and on its flip, averaged;
3. the instance branch in train mode on the detached backbone features;
4. CAM from the PseudoLabeler -> PeakGenerator (eval) -> smoothing -> peaks;
5. the argmax of the seg as ground truth, old classes zeroed;
6. the label factory: class components, 1-peak-1-component pseudo labels,
   self-refinement, and the gaussian stamps;
7. the blend of pseudo and refined targets, the weighted losses and one
   optimizer step;
8. the instance branch's BN statistics move (it alone runs in train mode,
   so body and seg statistics stay as they were).

The label factory runs over the whole batch at once, so each of its kernels
is launched once per step: connected components twice (8-connected classes,
4-connected weak clusters), top-k twice (CAM peaks, NMS centers), run
totals once and the stamp twice. Nothing in the step waits on the card.

Under a running profiler the step's launches fall in five stage spans
(``utils/logging.span``): ``phase2.frozen`` (the input's copy and layout,
the frozen forwards and the CAM), ``phase2.instance_forward`` (the
instance branch and the resize of its outputs), ``phase2.targets`` (CAM
peaks, the seg's argmax and the old classes' targets; entered twice),
``phase2.label_factory`` (the factory and the blend of its targets) and
``phase2.instance_update`` (losses, backward and the optimizer step).

Over several ranks each rank runs the label factory on its own rows, as
the JAX step's ``shard_map`` does; the weighted losses count over the
global batch, and the gradients are summed over ranks (``core/dist``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from cl4wsis_tpu_torch.ops import labelgen, pseudo_labels, refine
from cl4wsis_tpu_torch.ops.peaks import peak_extract_nchw, smoothing
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train import losses
from cl4wsis_tpu_torch.train.losses import (CENTER_LOSS_WEIGHT,
                                             OFFSET_LOSS_WEIGHT)
from cl4wsis_tpu_torch.train.state import TrainState, prepare
from cl4wsis_tpu_torch.utils.logging import span


def label_factory(seg_gt: torch.Tensor, cls_label: torch.Tensor,
                  peak_ys: torch.Tensor, peak_xs: torch.Tensor,
                  peak_valid: torch.Tensor, soft: torch.Tensor,
                  center: torch.Tensor, offset: torch.Tensor, *,
                  num_classes: int, first_class: int, sigma: int = 6,
                  refine_thresh: float = 0.3, nms_kernel: int = 41,
                  beta: float = 3.0, max_ctr: int = 16, max_cluster: int = 8,
                  max_comp: int = 64,
                  run_refine: bool = True) -> Dict[str, torch.Tensor]:
    """The batch's pseudo and refined targets: one class-component pass
    shared by the pseudo labels and the refinement, then both stamps
    (without `run_refine`, the pseudo targets alone).

    seg_gt (B, H, W); cls_label (B, C); peaks (B, C, K); soft (B, C+1, H,
    W); center (B, C, H, W); offset (B, 2, H, W). Returns pc (B, C, H, W),
    po (B, 2, H, W), pw (B, 1, H, W), p_trunc (B,), n_match (B,), p_slots
    (the pseudo stamp's slot arrays) and "refined": center, offset,
    weight, truncated and the refined stamp's slot arrays stamp_valid,
    stamp_y, stamp_x, stamp_cls.
    """
    size = tuple(seg_gt.shape[1:])
    comps = pseudo_labels.class_components(
        seg_gt, cls_label, num_classes, first_class, peak_ys, peak_xs,
        peak_valid)
    p_slots, po, pw, n_match, p_trunc = pseudo_labels.pseudo_label_slots(
        seg_gt, peak_ys, peak_xs, peak_valid, cls_label, num_classes,
        max_comp, first_class, comps)
    out = {"pc": labelgen.stamp_centers_batched(*p_slots, num_classes, sigma,
                                                 size),
           "po": po, "pw": pw, "p_trunc": p_trunc, "n_match": n_match,
           "p_slots": p_slots}
    if not run_refine:
        return out
    refined = refine.refine_label_slots(
        soft, center, offset, cls_label, seg_gt, num_classes=num_classes,
        refine_thresh=refine_thresh, nms_kernel=nms_kernel, beta=beta,
        max_ctr=max_ctr, max_cluster=max_cluster, first_class=first_class,
        components=comps)
    refined["center"] = labelgen.stamp_centers_batched(
        refined["stamp_valid"], refined["stamp_y"], refined["stamp_x"],
        refined["stamp_cls"], num_classes, sigma, size)
    out["refined"] = refined
    return out


def make_phase2_train_step(model: torch.nn.Module,
                           model_old: torch.nn.Module,
                           pseudolabeler: torch.nn.Module,
                           peakgenerator: torch.nn.Module,
                           old_classes: int, *,
                           sigma: int = 6,
                           pseudo_thresh: float = 0.7,
                           refine_thresh: float = 0.3,
                           nms_kernel: int = 41,
                           peak_kernel: int = 15,
                           beta: float = 3.0,
                           max_peaks: int = 25,
                           max_ctr: int = 16,
                           max_cluster: int = 8,
                           max_comp: int = 64,
                           run_refine: bool = True,
                           device: str = "cuda",
                           dtype: str = "float32") -> Callable:
    """Build the phase-2 step: ``train_step(state, batch, generator)``.

    The four modules move to `device` (the card unless the caller passes
    "cpu"; without a card this raises). `dtype` "bfloat16" runs the
    networks under autocast over float32 parameters; the label factory and
    the losses compute in float32. batch: "image" (B, H, W, 3) normalised,
    "l1h" (B, C) image-level labels of the thing classes. `generator` feeds
    the decoder's dropout. The step updates `state` in place and returns
    the metrics: loss, l_center, l_offset, pseudo_weight_px and
    label_truncated, as tensors on the device: this rank's shares, which
    sum over ranks to the global batch's values.
    """
    device, fmt, autocast = prepare(
        (model, model_old, pseudolabeler, peakgenerator), device, dtype)
    n_things = model.tot_classes - 1
    old_things = old_classes - 1
    factory_kw = dict(num_classes=n_things, first_class=old_things,
                      sigma=sigma, refine_thresh=refine_thresh,
                      nms_kernel=nms_kernel, beta=beta, max_ctr=max_ctr,
                      max_cluster=max_cluster, max_comp=max_comp,
                      run_refine=run_refine)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        net = state.model
        net.eval()
        net.decoder.train()
        net.instance_head.train()
        for m in (model_old, pseudolabeler, peakgenerator):
            m.eval()
        with span("phase2.frozen"):
            x = batch["image"].to(device).permute(0, 3, 1, 2).contiguous(
                memory_format=fmt)
            l1h = batch["l1h"].to(device).float()
            size = tuple(x.shape[2:])

            # frozen networks: old model, the seg on the image and its
            # flip, the CAM from the body features
            with torch.no_grad(), autocast():
                out_old = model_old(x, interpolate=False)
                seg_a, feats = net.forward_seg(x, interpolate=False)
                seg_b, _ = net.forward_seg(torch.flip(x, dims=[3]),
                                           interpolate=False)
                _, cam = peakgenerator(pseudolabeler(feats["body"]),
                                       label=l1h)

        # the instance branch on the detached features: the only gradients
        with span("phase2.instance_forward"):
            with autocast():
                instance = net.forward_instance(feats["features"], generator)
            center_out = resize_bilinear(instance["center"].float(), size)
            offset_out = resize_bilinear(instance["offset"].float(), size)

        with torch.no_grad():
            with span("phase2.targets"):
                # CAM -> peaks of the new classes, padded back over the old
                cam_t = resize_bilinear(
                    smoothing(cam.float())[:, old_things:], size)
                peak_conf, peak_ys, peak_xs = peak_extract_nchw(
                    cam_t, kernel=peak_kernel, k=max_peaks)
                pad = (0, 0, old_things, 0)
                peak_conf, peak_ys, peak_xs = (
                    F.pad(t, pad) for t in (peak_conf, peak_ys, peak_xs))

                # the frozen seg's argmax as ground truth
                seg_max = (seg_a["seg"].float() +
                           torch.flip(seg_b["seg"].float(), dims=[3])) / 2.0
                soft = torch.softmax(resize_bilinear(seg_max, size), dim=1)
                soft[:, old_classes:] *= l1h[:, old_classes - 1:, None, None]
                seg_gt = torch.argmax(soft, dim=1).to(torch.int32)
                old_fg = ((seg_gt < old_classes) &
                          (seg_gt != 0))[:, None].float()
                seg_gt = torch.where(seg_gt < old_classes, 0, seg_gt)
                cls_label = l1h.clone()
                cls_label[:, :old_things] = 0.0        # new classes only
                peak_valid = (peak_conf >= pseudo_thresh) & \
                    (cls_label[:, :, None] > 0)

            with span("phase2.label_factory"):
                fac = label_factory(seg_gt, cls_label, peak_ys, peak_xs,
                                    peak_valid, soft, center_out.detach(),
                                    offset_out.detach(), **factory_kw)
                pc, po, pw = fac["pc"], fac["po"], fac["pw"]
                label_truncated = fac["p_trunc"].sum()
                if run_refine:
                    refined = fac["refined"]
                    label_truncated = (label_truncated +
                                       refined["truncated"].sum())
                    pw_sum = torch.maximum(old_fg, pw)
                    pc[:, old_things:] = (
                        pw * pc[:, old_things:] +
                        (1 - pw) * refined["center"][:, old_things:])
                    po = pw_sum * po + (1 - pw_sum) * refined["offset"]
                    pw = torch.maximum(pw, refined["weight"])

            with span("phase2.targets"):
                out_old_center = resize_bilinear(out_old["center"].float(),
                                                 size)
                out_old_offset = resize_bilinear(out_old["offset"].float(),
                                                 size)

        with span("phase2.instance_update"):
            center_loss_1 = 0.5 * losses.weighted_mse(
                center_out[:, :old_things], out_old_center, old_fg) * \
                CENTER_LOSS_WEIGHT
            offset_loss_1 = 0.5 * losses.weighted_l1(
                offset_out, out_old_offset, old_fg) * OFFSET_LOSS_WEIGHT
            center_loss_2 = 0.5 * losses.weighted_mse(
                center_out[:, old_things:], pc[:, old_things:], pw) * \
                CENTER_LOSS_WEIGHT
            offset_loss_2 = 0.5 * losses.weighted_l1(offset_out, po, pw) * \
                OFFSET_LOSS_WEIGHT
            l_center = center_loss_1 + center_loss_2
            l_offset = offset_loss_1 + offset_loss_2
            loss = l_center + l_offset
            loss.backward()
            state.apply_gradients()
            return {"loss": loss.detach(), "l_center": l_center.detach(),
                    "l_offset": l_offset.detach(),
                    "pseudo_weight_px": pw.sum(),
                    "label_truncated": label_truncated.to(torch.int32)}

    return train_step
