# Frozen plain copy of cl4wsis_tpu_torch/train/step0.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""The step-0 (fully supervised base step) train step (counterpart of
``cl4wsis_tpu/train/step0.py``).

One step runs the whole model in train mode, resizes its raw outputs to
the crop with align_corners=False (unlike the eval upsampling), makes the
center, offset and weight targets from the (seg, instance-id) maps on the
device (``ops/labelgen.batched_label_generation``, which launches the stamp
kernel once), and takes seg BCE-with-ignore (mean) or the hard-pixel CE,
+ 200 x weighted MSE of the centers + 0.01 x weighted L1 of the offsets.
The BN statistics of body, head and decoder move. Nothing in the step
waits on the card. Over several ranks the step trains on the global batch
(``core/dist``): the losses are this rank's shares and the gradients are
summed over ranks before the update.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from . import labelgen, losses, schedule
from .losses import CENTER_LOSS_WEIGHT, OFFSET_LOSS_WEIGHT
from .phase2 import TrainState
from .resize import resize_bilinear

def make_step0_train_step(model: torch.nn.Module, seg_loss: str = "bce",
                          sigma: int = 6, max_inst: int = 50,
                          device: str = "cuda",
                          dtype: str = "float32") -> Callable:
    """Build the step-0 step: ``train_step(state, batch, generator)``.

    The model moves to `device`; everything computes in its own precision
    (float32), with no autocast (`dtype` is accepted and ignored). batch:
    "image" (B, H, W, 3) normalised, "seg" (B, H, W) int (255 ignore),
    "inst" (B, H, W) int dense instance ids. `generator` feeds the
    dropout of the body (WideResNet's mod6 and mod7) and the decoder. The
    step updates `state` in place and returns the metrics loss, l_seg,
    l_center and l_offset as tensors on the device (this rank's shares).
    """
    if seg_loss not in ("bce", "dce"):
        raise ValueError(seg_loss)
    device = torch.device(device)
    model.to(device)
    fmt = torch.contiguous_format

    def autocast():
        return contextlib.nullcontext()
    n_things = model.tot_classes - 1

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        net = state.model
        net.train()
        x = batch["image"].to(device).permute(0, 3, 1, 2).contiguous(
            memory_format=fmt)
        seg = batch["seg"].to(device)
        size = tuple(x.shape[2:])
        with autocast():
            pred = net(x, interpolate=False, generator=generator)
        pred = {k: resize_bilinear(v, size, align_corners=False)
                for k, v in pred.items()}

        if seg_loss == "bce":
            l_seg = losses.batch_mean(
                losses.bce_with_logits_ignore(pred["seg"], seg))
        else:
            l_seg = losses.deeplab_ce(pred["seg"], seg)
        if net.has_instance:
            with torch.no_grad():
                center, offset, weight = labelgen.batched_label_generation(
                    seg, batch["inst"].to(device), num_classes=n_things,
                    sigma=sigma, max_inst=max_inst)
            l_center = losses.weighted_mse(pred["center"], center, weight) \
                * CENTER_LOSS_WEIGHT
            l_offset = losses.weighted_l1(pred["offset"], offset, weight) \
                * OFFSET_LOSS_WEIGHT
        else:   # semantic-only model: no instance terms
            l_center = l_offset = torch.zeros((), device=device)
        loss = l_seg + l_center + l_offset
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "l_seg": l_seg.detach(),
                "l_center": l_center.detach(), "l_offset": l_offset.detach()}

    return train_step


def init_state(model: torch.nn.Module, optim: str,
               lr_schedule: schedule.Schedule, *, weight_decay: float = 0.0,
               group_scale: Optional[Dict[str, float]] = None,
               momentum: float = 0.9) -> TrainState:
    """The state of a fresh run over `model`'s own (seeded) weights: the
    grouped optimizer (every group at scale 1 unless `group_scale`) and
    step 0."""
    opt = schedule.make_optimizer(model, optim, weight_decay=weight_decay,
                                  group_scale=group_scale, momentum=momentum)
    return TrainState(model, opt, lr_schedule)
