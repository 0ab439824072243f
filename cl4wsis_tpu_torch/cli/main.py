"""CLI entry point: the reference's ``run.py`` (counterpart of
``cl4wsis_tpu/cli/main.py``).

    python -m cl4wsis_tpu_torch.cli.main --dataset voc --task 15-5 --step 0 ...

It runs on the card unless the caller passes ``--device cpu``. The data
is VOC (``--dataset voc``), COCO (``coco``) or COCO-to-VOC (``coco-voc``:
COCO at step 0, VOC images in the COCO label space after), read from
``--data_root`` by ``data/loader.Loader`` with ``--num_workers`` worker
processes, or ``--synthetic`` batches. With ``--synthetic`` there is no
validation set, so the CLI validates nothing; with real data
``run_validation`` runs the mode of the stage on the validation set.

Over several cards, one process each (``--batch_size`` per process):

    CL4WSIS_MULTIHOST=1 python -m torch.distributed.run --nproc_per_node N \
        -m cl4wsis_tpu_torch.cli.main ...

Each rank trains on its card with its shard of the data (``--synthetic``
gives every rank the same batches, as the JAX CLI does), validates its
strided shard of the validation set and merges the metrics; rank 0 writes
the checkpoints and the log (``core/dist``).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.cli.config import Config, parse_config
from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.data.coco import make_coco_datasets
from cl4wsis_tpu_torch.data.loader import Loader, eval_samples
from cl4wsis_tpu_torch.data.voc import make_voc_datasets
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train.eval import (make_eval_forward, validate_instances,
                                          validate_semseg)
from cl4wsis_tpu_torch.train.state import DTYPES
from cl4wsis_tpu_torch.train.trainer import Trainer
from cl4wsis_tpu_torch.utils.logging import Logger
from cl4wsis_tpu_torch.utils.visualize import sample_image


class SyntheticLoader:
    """`n_batches` synthetic batches an epoch, drawn from seed + epoch; the
    image labels without the background column."""

    def __init__(self, cfg: Config, n_batches: int = 4):
        self.cfg = cfg
        self.n = n_batches
        self.n_things = sum(tasks.get_per_task_classes(
            cfg.dataset, cfg.task, cfg.step)) - 1

    def __len__(self):
        return self.n

    def epoch(self, epoch: int):
        from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
        for b in synthetic_batches(self.cfg.batch_size, self.cfg.crop_size,
                                   n_classes=self.n_things,
                                   seed=self.cfg.seed + epoch,
                                   n_batches=self.n):
            b["l1h"] = b.pop("l1h")[:, 1:]
            yield b


def build_data(cfg: Config):
    """(train loader, validation set or None). ``--grain`` selects the same
    loader: it already runs ``--num_workers`` worker processes, as the JAX
    package's grain pipeline does."""
    if cfg.synthetic:
        return SyntheticLoader(cfg), None
    step_dict = tasks.get_task_dict(cfg.dataset, cfg.task, cfg.step)
    if cfg.dataset == "voc":
        train, val = make_voc_datasets(cfg.data_root, step_dict, cfg.step,
                                       cfg.crop_size, cfg.crop_size_val,
                                       overlap=cfg.overlap,
                                       masking=not cfg.no_mask,
                                       pseudo=cfg.pseudo,
                                       val_on_trainset=cfg.val_on_trainset,
                                       seed=cfg.seed)
    elif cfg.dataset == "coco-voc" and cfg.step > 0:
        # step 1 of coco-voc: VOC images, labels in the COCO id space
        # (reference VOCasCOCOSegmentationIncremental)
        train, val = make_voc_datasets(cfg.data_root, step_dict, cfg.step,
                                       cfg.crop_size, cfg.crop_size_val,
                                       overlap=cfg.overlap,
                                       masking=not cfg.no_mask, as_coco=True,
                                       seed=cfg.seed)
    elif cfg.dataset in ("coco", "coco-voc"):
        # reference split-index files (dataset/__init__.py:57-70): the coco
        # path trains on data/{ds}/{task}[-ov]/train-{step}.npy indices.
        # The JAX package's rule, kept as it is: "-ov" only for voc, which
        # never reaches this branch.
        ov = "-ov" if (cfg.overlap and cfg.dataset == "voc") else ""
        idx_path = os.path.join(cfg.data_root, cfg.dataset,
                                f"{cfg.task}{ov}", f"train-{cfg.step}.npy")
        indices = np.load(idx_path) if os.path.exists(idx_path) else None
        train, val = make_coco_datasets(cfg.data_root, step_dict, cfg.step,
                                        cfg.crop_size, cfg.crop_size_val,
                                        train_indices=indices, seed=cfg.seed)
    else:
        raise NotImplementedError(cfg.dataset)
    loader = Loader(train, cfg.batch_size, seed=cfg.seed,
                    process_index=dist.rank(), process_count=dist.world(),
                    num_workers=cfg.num_workers,
                    pin_memory=torch.device(cfg.device).type == "cuda")
    return loader, val


def make_classify_seg(trainer: Trainer):
    """DeeplabV3 mode: image (1, H, W, 3) -> the model's seg softmax at the
    image's size, (1, H, W, C), in eval mode."""
    model, dev = trainer.model, trainer.device
    bf16 = DTYPES[trainer.cfg.dtype] == torch.bfloat16

    @torch.no_grad()
    def classify(image: torch.Tensor) -> torch.Tensor:
        model.eval()
        x = image.to(dev).permute(0, 3, 1, 2)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            pred, _ = model.forward_seg(x, interpolate=False)
        seg = resize_bilinear(pred["seg"].float(), tuple(x.shape[2:]))
        return torch.softmax(seg, dim=1).permute(0, 2, 3, 1)
    return classify


def make_classify_cam(trainer: Trainer):
    """Phase-1 mode: image (1, H, W, 3) -> the PseudoLabeler's CAM softmax
    on the model's body features at the image's size, (1, H, W, C), in eval
    mode."""
    model, pl, dev = trainer.model, trainer.pseudolabeler, trainer.device
    bf16 = DTYPES[trainer.cfg.dtype] == torch.bfloat16

    @torch.no_grad()
    def classify(image: torch.Tensor) -> torch.Tensor:
        model.eval()
        pl.eval()
        x = image.to(dev).permute(0, 3, 1, 2)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            cam = pl(model.forward_features(x)["res5"])
        cam = resize_bilinear(cam.float(), tuple(x.shape[2:]))
        return torch.softmax(cam, dim=1).permute(0, 2, 3, 1)
    return classify


def make_instance_forward(trainer: Trainer):
    """Instance mode: the bucketed eval forward with the CLI's options."""
    cfg = trainer.cfg
    return make_eval_forward(
        trainer.model, trainer.tot_classes - 1, device=trainer.device,
        dtype=DTYPES[cfg.dtype], val_flip=cfg.val_flip,
        val_thresh=cfg.val_thresh, val_kernel=cfg.val_kernel, beta=cfg.beta,
        max_ctr=cfg.val_max_ctr, max_cluster=cfg.max_cluster)


def run_validation(trainer: Trainer, val, logger: Logger, tag: str):
    """The three validation modes of upstream ``run.py:132-153``: DeeplabV3
    mIoU, phase-1 CAM mIoU through the PseudoLabeler, instance mAP. Each
    rank validates its strided shard; the metrics merge over ranks. In the
    instance mode the first ``--sample_num`` validation images are logged
    beside their instances (``Logger.add_image``, rank 0)."""
    cfg = trainer.cfg
    if val is None:
        return
    samples = eval_samples(val, dist.rank(), dist.world())
    if cfg.model == "DeeplabV3" and cfg.phase != 1:
        res = validate_semseg(make_classify_seg(trainer), samples,
                              trainer.tot_classes)
        logger.add_results(res)
        logger.info(f"[{tag}] MeanIoU={res['Mean IoU']:.4f} "
                    f"MeanAcc={res['Mean Acc']:.4f}")
        return
    if cfg.phase == 1:
        res = validate_semseg(make_classify_cam(trainer), samples,
                              trainer.tot_classes,
                              old_classes=trainer.old_classes)
        logger.add_results(res)
        logger.info(f"[{tag}] Val_CAM MeanIoU={res['Mean IoU']:.4f} "
                    f"MeanAcc={res['Mean Acc']:.4f} "
                    f"MeanPrec={res['Mean Precision']:.4f}")
        return
    fwd = make_instance_forward(trainer)
    for i in range(min(cfg.sample_num, len(val))):
        # upstream's --sample_num images: the image beside its instances,
        # found at the image's own size (the JAX CLI asks for them at the
        # ground truth's, which the validation resize changes, and then
        # cannot put the two side by side)
        image = np.asarray(val[i]["image"], np.float32)
        out = fwd(torch.as_tensor(image), image.shape[1:3])
        logger.add_image(f"{tag}/sample", sample_image(
            image[0], out["ins_map"].cpu().numpy()), i)
    res = validate_instances(fwd, samples)
    logger.add_results({"map": res["map"], "map50": res["map50"],
                        "ap": res["ap"].tolist(),
                        "truncated_centers": res["truncated_centers"]})
    logger.info(f"[{tag}] mAP@[.5:.95]={res['map']:.4f} "
                f"mAP@.5={res['map50']:.4f}")
    if res["truncated_centers"]:
        logger.info(f"[{tag}] WARNING: {res['truncated_centers']} center "
                    "candidates hit the slot cap (--val_max_ctr); consider "
                    "raising it")


def main(argv: Optional[list] = None,
         on_trainer: Optional[Callable[[Trainer], None]] = None) -> int:
    """Run one stage of the chain. `on_trainer`, where given, is called with
    the Trainer as soon as it is built, before any checkpoint is loaded:
    the hook through which a caller watches the run. Under
    ``CL4WSIS_MULTIHOST=1`` it joins the process group torchrun describes
    and destroys it at the end, or keeps the group its caller made: a
    caller that runs main several times in one process over more than one
    rank makes the group once, since a second group made under torchrun's
    store can meet the first one's keys there."""
    cfg = parse_config(argv)
    made_group = dist.init_from_env(cfg.device)
    try:
        return _run(cfg, on_trainer)
    finally:
        if made_group:
            dist.destroy()


def _run(cfg: Config, on_trainer: Optional[Callable[[Trainer], None]]
         ) -> int:
    # the data takes the recipe's crops (coco-voc: 448, validation 512);
    # the JAX CLI builds its data before finalize, at the flags' crops
    loader, val = build_data(cfg.finalize())
    iters = max(len(loader), 1)

    trainer = Trainer(cfg, iters_per_epoch=iters)
    cfg = trainer.cfg  # finalized
    if on_trainer is not None:
        on_trainer(trainer)

    # checkpoint plumbing (run.py:90-106)
    start_epoch = 0
    if cfg.step > 0:
        prev = cfg.step_ckpt or trainer.default_ckpt_path(cfg.step - 1)
        if os.path.exists(prev):
            trainer.load_step_ckpt(prev)
            print(f"[ckpt] loaded step checkpoint {prev}")
    if cfg.seg_ckpt and os.path.exists(cfg.seg_ckpt):
        trainer.load_seg_ckpt(cfg.seg_ckpt)
        print(f"[ckpt] loaded seg checkpoint {cfg.seg_ckpt}")
    resume = cfg.ckpt or (trainer.default_ckpt_path()
                          if cfg.continue_ckpt else None)
    if resume and os.path.exists(resume):
        start_epoch = trainer.load_resume(resume)
        print(f"[ckpt] resumed from {resume} at epoch {start_epoch}")
    trainer.check_replicas()

    ckpt_out = trainer.default_ckpt_path()
    os.makedirs(os.path.dirname(ckpt_out), exist_ok=True)

    # reference run.py:48-49: logdir_full = {logdir}/{task_name}/{name}/,
    # summary gated on --visualize
    ov = "-ov" if cfg.overlap else ""
    logdir_full = os.path.join(cfg.logdir, f"{cfg.dataset}-{cfg.task}{ov}",
                               cfg.name)
    logger = Logger(logdir_full, rank=dist.rank(), name=cfg.name,
                    summary=cfg.visualize)
    try:
        logger.add_config(cfg)
        # determinism canary (run.py:118-119): a fixed-seed draw printed so
        # that drift between runs is eyeballable
        canary = torch.randint(0, 1000, (4,), generator=torch.Generator()
                               .manual_seed(cfg.seed))
        logger.info(f"[canary] {canary.tolist()}")

        # --test: skip training, evaluate the loaded checkpoint (run.py:114)
        for epoch in range(start_epoch, 0 if cfg.test else cfg.epochs):
            metrics = trainer.train_epoch(epoch, loader.epoch(epoch),
                                          logger=logger)
            loss = metrics.get("loss", float("nan"))
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged: {metrics}")
            logger.info(f"[epoch {epoch}] loss={loss:.4f} "
                        f"({metrics['n_batches']} it, "
                        f"{metrics['epoch_time_s']:.1f}s, loader wait "
                        f"{metrics['loader_wait_s']:.1f}s)")
            if cfg.phase == 2:
                logger.info(f"[epoch {epoch}] pseudo_weight_px="
                            f"{metrics['pseudo_weight_px']:.1f} "
                            f"label_truncated="
                            f"{metrics['label_truncated']:.2f}")
            for k, v in metrics.items():
                logger.add_scalar(f"Loss/{k}" if k.startswith("l") and
                                  k != "loader_wait_s" else k, v, epoch)
            logger.commit()
            if (epoch + 1) % cfg.ckpt_interval == 0 or \
                    epoch == cfg.epochs - 1:
                trainer.save(ckpt_out, epoch)
            # in-training validation every val_interval epochs
            if (epoch + 1) % cfg.val_interval == 0 and \
                    epoch != cfg.epochs - 1:
                run_validation(trainer, val, logger, f"val e{epoch}")

        run_validation(trainer, val, logger, "test")  # run.py:168-182
    finally:
        logger.close()
        if isinstance(loader, Loader):
            loader.close()
    print("[done]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
