"""Trainer: per-phase set-up, the epoch loop and checkpoints (counterpart of
``cl4wsis_tpu/train/trainer.py``).

It builds the models and the weak-supervision modules of the phase, the
grouped optimizer (upstream ``train.py:144-185``), the phase's train step,
and drives epochs with epoch and interval means. Checkpoints are
``torch.save`` files of state dicts in the upstream key layout
(``cl/ckpt.py``):

    {"model": ..., "pseudolabeler": ..., "peakgenerator": ...,
     "optimizer": optimizer.state_dict(), "step": int, "epoch": int}

with the two weak-supervision modules where the phase has them. Every load
copies into the tensors the model already has, so the optimizer, built
first, keeps updating the model's own parameters. The old model is a model
of its own, loaded from the previous step's checkpoint into its own
tensors.

Fresh layers start where the JAX CLI's start at the same ``--torch_init``:
in flax's init families by default (``models/flax_init``), in torch's
under ``--torch_init true``, each with upstream's explicit inits where
upstream sets them.

Over several ranks (``CL4WSIS_MULTIHOST=1`` under ``torchrun``,
``core/dist``) each rank trains on its card, ``cuda:$LOCAL_RANK``, with
its shard of every global batch; the steps sum the gradients over ranks.
The epoch and interval means are summed over ranks before they are
returned or logged, so every rank holds the global ones. Rank 0 writes
the checkpoints and every rank waits for it; every rank reads them.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import torch

from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.cl.ckpt import (ckpt_path, expand_for_new_step,
                                       load_checkpoint, load_torch_pretrained,
                                       save_checkpoint, tree_merge)
from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.models.flax_init import flax_family_init
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train.phase1 import (make_phase1_train_step,
                                            phase1_group_fn)
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState, prepare
from cl4wsis_tpu_torch.train.step0 import make_step0_train_step
from cl4wsis_tpu_torch.utils.logging import StepTimer, span
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler


def pretrained_name(backbone: str) -> str:
    """The ImageNet checkpoint's file name under --pretrained_path, as the
    JAX trainer looks for it."""
    if "wide" in backbone:
        return "wide_resnet38_ipabn_lr_256.pth.tar"
    return f"{backbone}_iabn_sync.pth.tar"


def model_kwargs(cfg) -> Dict[str, Any]:
    """`make_model`'s arguments for the finalized config `cfg`. --tiny cuts
    a ResNet to one block a stage; WideResNet-38 stays whole, as the JAX
    model ignores the structure for it."""
    tiny = cfg.tiny and "wide" not in cfg.backbone
    return dict(backbone=cfg.backbone, output_stride=cfg.output_stride,
                crop_size=cfg.crop_size, branch=cfg.branch,
                norm_act=cfg.norm_act, remat=cfg.remat,
                backbone_structure=(1, 1, 1, 1) if tiny else None)


class Trainer:
    def __init__(self, cfg, iters_per_epoch: int):
        self.cfg = cfg = cfg.finalize(iters_per_epoch)

        self.classes = tasks.get_per_task_classes(cfg.dataset, cfg.task,
                                                  cfg.step)
        self.tot_classes = sum(self.classes)
        self.old_classes = self.tot_classes - self.classes[-1]
        self.weakly = cfg.weakly and cfg.step > 0
        # --pseudo: the dataset supplies instance labels; training is the
        # supervised (step-0) step, without the pseudo-label machinery
        self.supervised_pseudo = self.weakly and cfg.pseudo is not None

        mk = model_kwargs(cfg)
        # fresh weights from the seed in torch's families, leaving torch's
        # global stream alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = make_model(self.classes,
                                    detach_instance=cfg.detach_instance, **mk)
            self.model_old = None
            if cfg.step > 0:
                old_cls = tasks.get_per_task_classes(cfg.dataset, cfg.task,
                                                     cfg.step - 1)
                self.model_old = make_model(old_cls, **mk)
            self.pseudolabeler = None
            self.peakgenerator = None
            if self.weakly and cfg.pseudo is None:
                if cfg.peak_from != "peakgenerator":
                    # upstream train.py:88: any other value leaves the
                    # peak generator unset and the weakly phases crash
                    raise NotImplementedError(
                        f"peak_from={cfg.peak_from!r}: only 'peakgenerator' "
                        "is implemented (matching the reference)")
                self.pseudolabeler = PseudoLabeler(
                    self.tot_classes, in_channels=self.model.body.out_channels)
                self.peakgenerator = PeakGenerator(
                    self.tot_classes - 1, self.old_classes - 1,
                    alpha=cfg.pam_alpha)

        fresh = [m for m in (self.model, self.model_old, self.pseudolabeler,
                             self.peakgenerator) if m is not None]
        self.device, _, _ = prepare(fresh, dist.local_device(cfg.device),
                                    cfg.dtype)
        if not cfg.torch_init:
            # the JAX CLI's default start: every fresh layer in flax's
            # families, drawn on the device from a generator of its own
            gen = torch.Generator(self.device).manual_seed(cfg.seed)
            for m in fresh:
                flax_family_init(m, gen)

        # the pretrained body, then (cli.main) the previous step's weights,
        # overwrite the draws as in the JAX trainer
        if cfg.pretrained and not cfg.synthetic:
            pre = load_torch_pretrained(os.path.join(
                cfg.pretrained_path, pretrained_name(cfg.backbone)))
            if pre is not None:
                self.model.load_state_dict(
                    tree_merge(self.model.state_dict(), pre))
        self._build_optimizer()
        self._train_steps: Dict[Any, Any] = {}
        self.step_timer: Optional[StepTimer] = None

    # ------------------------------------------------------------- setup

    def _build_optimizer(self):
        """The grouped optimizer over the train state's module, its param
        groups in the module's parameter order (so a resumed optimizer
        state lines up)."""
        cfg = self.cfg
        sched = schedule.make_schedule(cfg.lr_policy, cfg.lr,
                                       cfg.max_iters or 1,
                                       start_decay=cfg.start_decay,
                                       power=cfg.lr_power,
                                       decay_step=cfg.lr_decay_step,
                                       decay_factor=cfg.lr_decay_factor)
        if cfg.phase == 1:
            net = torch.nn.ModuleDict(dict(model=self.model,
                                           pseudolabeler=self.pseudolabeler,
                                           peakgenerator=self.peakgenerator))
            scale = {"body": 1.0, "seg": cfg.lr_head,
                     # absolute lr_pseudo expressed as a multiplier of lr
                     "pseudo": cfg.lr_pseudo / max(cfg.lr, 1e-12),
                     "instance": cfg.lr_head}
            group_fn = phase1_group_fn
        else:
            net = self.model
            scale = {"body": 0.0 if cfg.freeze else 1.0,
                     "seg": 0.0 if cfg.freeze_seg else cfg.lr_head,
                     "instance": cfg.lr_head, "pseudo": 0.0}
            group_fn = schedule.default_group_fn
        opt = schedule.make_optimizer(net, cfg.optim,
                                      weight_decay=cfg.weight_decay,
                                      group_scale=scale, group_fn=group_fn,
                                      momentum=cfg.momentum)
        self.state = TrainState(net, opt, sched)

    # ------------------------------------------------------------ steps

    def _get_step(self, epoch: int):
        cfg = self.cfg
        kw = dict(device=self.device, dtype=cfg.dtype)
        if self.supervised_pseudo:
            if "p0" not in self._train_steps:
                self._train_steps["p0"] = make_step0_train_step(
                    self.model, seg_loss="bce", sigma=cfg.sigma, **kw)
            return self._train_steps["p0"]
        if cfg.phase == 1:
            key = ("p1", epoch >= cfg.pseudo_ep)
            if key not in self._train_steps:
                self._train_steps[key] = make_phase1_train_step(
                    self.model, self.model_old, self.pseudolabeler,
                    self.peakgenerator, self.old_classes,
                    loss_de=cfg.loss_de, l_seg_weight=cfg.l_seg,
                    alpha=cfg.alpha, icarl_bkg=cfg.icarl_bkg,
                    use_affinity=cfg.affinity, use_flac=cfg.flac,
                    use_randrop=cfg.randrop,
                    use_pseudo=epoch >= cfg.pseudo_ep, no_mask=cfg.no_mask,
                    **kw)
            return self._train_steps[key]
        if cfg.phase == 2:
            if "p2" not in self._train_steps:
                self._train_steps["p2"] = make_phase2_train_step(
                    self.model, self.model_old, self.pseudolabeler,
                    self.peakgenerator, self.old_classes, sigma=cfg.sigma,
                    pseudo_thresh=cfg.pseudo_thresh,
                    refine_thresh=cfg.refine_thresh, nms_kernel=cfg.kernel,
                    beta=cfg.beta, max_ctr=cfg.max_ctr,
                    max_cluster=cfg.max_cluster, max_comp=cfg.max_comp,
                    run_refine=cfg.run_refine, **kw)
            return self._train_steps["p2"]
        if "p0" not in self._train_steps:
            # the reference default (no --bce/--dce) is BCEWithLogitsLoss on
            # a long map, which errors at runtime; published scripts always
            # use --bce, so that is the fallback (train.py:102-110)
            seg_loss = "dce" if (cfg.dce and not (cfg.bce or cfg.icarl)) \
                else "bce"
            self._train_steps["p0"] = make_step0_train_step(
                self.model, seg_loss=seg_loss, sigma=cfg.sigma, **kw)
        return self._train_steps["p0"]

    # ------------------------------------------------------------ loops

    # reference wandb tag names for interval logging (train.py:560-564)
    _REF_TAGS = {"loss": "Loss/tot", "l_cam_int": "Loss/CAM_int",
                 "l_cam_new": "Loss/CAM_out", "l_cls": "Loss/SEG_int",
                 "l_seg": "Loss/SEG_out"}

    def train_epoch(self, epoch: int, batches, logger=None
                    ) -> Dict[str, float]:
        """One epoch. The returned metrics are EPOCH MEANS over all batches
        (upstream train.py:543,568-580); with a logger, the interval means
        of every ``print_interval`` steps are logged too (train.py:552-566).

        The sums stay on the device, so the host waits on the card only at
        the first batch (to fail fast), at each interval's end and, under
        ``--debug``, after every step. The steps draw from one generator
        seeded with seed + epoch, in the same state on every rank. Over
        several ranks the sums of the steps' metrics (each rank's shares)
        are summed over ranks at each interval's end and at the epoch's,
        so the means are the global batch's on every rank; only rank 0
        profiles. ``loader_wait_s`` is the host's wait for its next batch
        over the epoch (this rank's; the ``trainer.next_batch`` span)."""
        cfg = self.cfg
        step_fn = self._get_step(epoch)
        gen = torch.Generator(self.device).manual_seed(cfg.seed + epoch)
        agg = None          # on-device running sums over the epoch
        interval = None     # on-device running sums since the last print
        n = n_int = 0
        t0 = time.time()
        timer = None
        if cfg.profile_dir and epoch == 0 and dist.is_main():
            timer = self.step_timer = StepTimer(
                cfg.profile_dir, device=self.device)
        loader_wait = 0.0  # the host's wait for the next batch, seconds
        it = self._prefetch_device(batches)
        for i in itertools.count():
            t_wait = time.perf_counter()
            with span("trainer.next_batch"):
                batch = next(it, None)
            loader_wait += time.perf_counter() - t_wait
            if batch is None:
                break
            if timer is not None:
                timer.start_step(i)
            metrics = step_fn(self.state, batch, gen)
            if timer is not None:
                timer.end_step(i)
            agg = metrics if agg is None else {
                k: agg[k] + v for k, v in metrics.items()}
            interval = metrics if interval is None else {
                k: interval[k] + v for k, v in metrics.items()}
            n += 1
            n_int += 1
            if i == 0 or cfg.debug:
                float(metrics["loss"])
            if logger is not None and (i + 1) % cfg.print_interval == 0:
                means = {k: v / n_int for k, v in _sum_ranks(interval).items()}
                logger.debug(f"Epoch {epoch}, Batch {i + 1}, "
                             f"Loss={means.get('loss', float('nan')):.6f}")
                ipe = (cfg.max_iters // cfg.epochs) if cfg.epochs else 0
                x = epoch * max(ipe, i + 1) + i + 1
                for k, v in means.items():
                    logger.add_scalar(self._REF_TAGS.get(k, f"Loss/{k}"), v,
                                      x, intermediate=True)
                logger.commit(intermediate=True)
                interval = None
                n_int = 0
        if timer is not None:
            timer.close()
        if n == 0:
            raise ValueError(
                "epoch produced no batches — dataset smaller than "
                "batch_size after task filtering?")
        metrics = {k: v / n for k, v in _sum_ranks(agg).items()}
        metrics["epoch_time_s"] = time.time() - t0
        metrics["loader_wait_s"] = loader_wait
        metrics["n_batches"] = n
        if timer is not None:
            metrics.update({f"step_{k}": v
                            for k, v in timer.summary().items()})
        return metrics

    def _prefetch_device(self, batches, size: int = 2):
        """Start host-to-device copies `size` batches ahead of the step
        that takes them (from pinned memory, without waiting)."""
        q: deque = deque()
        for batch_np in batches:
            q.append(self._device_batch(batch_np))
            if len(q) > size:
                yield q.popleft()
        while q:
            yield q.popleft()

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The step's inputs of a host batch (numpy arrays, or CPU tensors
        from the loader) on the step's device. A tensor of the right dtype
        is taken as it is: one the loader pinned goes to the card without
        another host copy; anything else is pinned here first."""
        if self.cfg.phase in (1, 2) and not self.supervised_pseudo:
            want = {"image": torch.float32, "l1h": torch.float32}
        else:
            want = {"image": torch.float32, "seg": torch.int32,
                    "inst": torch.int32}
        host = {k: torch.as_tensor(batch[k]).to(dtype)
                for k, dtype in want.items()}
        if self.device.type != "cuda":
            return host
        return {k: (v if v.is_pinned() else v.pin_memory()).to(
                    self.device, non_blocking=True) for k, v in host.items()}

    # ------------------------------------------------------- checkpoints

    def model_variables(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def pseudolabeler_variables(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.pseudolabeler is None:
            return None
        return self.pseudolabeler.state_dict()

    def check_replicas(self) -> None:
        """Raise unless every rank holds the same weights: every rank seeds
        and builds the same, and loads the same checkpoints."""
        for name in ("model", "model_old", "pseudolabeler", "peakgenerator"):
            m = getattr(self, name)
            if m is not None:
                dist.check_same(m.state_dict(), f"the {name}'s weights")

    def save(self, path: str, epoch: int):
        tree = {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "step": self.state.step, "epoch": epoch}
        if self.pseudolabeler is not None:
            tree["pseudolabeler"] = self.pseudolabeler.state_dict()
            tree["peakgenerator"] = self.peakgenerator.state_dict()
        save_checkpoint(path, tree)

    def load_resume(self, path: str) -> int:
        """Model, weak-supervision modules, optimizer state and step count
        of a checkpoint of this run; returns the epoch to start at."""
        blob = load_checkpoint(path)
        self.model.load_state_dict(blob["model"])
        if self.pseudolabeler is not None and "pseudolabeler" in blob:
            self.pseudolabeler.load_state_dict(blob["pseudolabeler"])
            self.peakgenerator.load_state_dict(blob["peakgenerator"])
        self.state.optimizer.load_state_dict(blob["optimizer"])
        self.state.step = int(blob["step"])
        return int(blob["epoch"]) + 1

    def load_step_ckpt(self, path: str):
        """The previous step's checkpoint into the new model (classifiers
        expanded) and into the frozen old model (upstream
        ``train.py:747-771``)."""
        old = load_checkpoint(path)["model"]
        self.model.load_state_dict(expand_for_new_step(
            self.model.state_dict(), old, self.classes,
            init_balanced=self.cfg.init_balanced))
        if self.model_old is not None:
            self.model_old.load_state_dict(
                tree_merge(self.model_old.state_dict(), old))

    def load_seg_ckpt(self, path: str):
        """The phase-1 result into the phase-2 model, PseudoLabeler and
        PeakGenerator (upstream ``train.py:797-812``)."""
        blob = load_checkpoint(path)
        self.model.load_state_dict(tree_merge(self.model.state_dict(),
                                              blob["model"]))
        if self.pseudolabeler is not None and "pseudolabeler" in blob:
            self.pseudolabeler.load_state_dict(blob["pseudolabeler"])
            self.peakgenerator.load_state_dict(blob["peakgenerator"])

    def default_ckpt_path(self, step: Optional[int] = None) -> str:
        cfg = self.cfg
        return ckpt_path(cfg.checkpoint, cfg.dataset, cfg.task, cfg.overlap,
                         cfg.name, cfg.step if step is None else step)


def _sum_ranks(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per-rank metric sums (tensors on the device), summed over ranks in
    one all-reduce, as host floats."""
    total = dist.all_sum(torch.stack([v.double() for v in sums.values()]))
    return dict(zip(sums, total.tolist()))
