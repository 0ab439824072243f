"""Configuration: dataclass + CLI with reference flag parity (a copy of
``cl4wsis_tpu/cli/config.py``).

One difference, which follows the reference: ``--device`` is a real field,
the device every entry point runs on ("cuda" unless the caller asks for
"cpu"); the JAX package accepts and ignores it. ``--torch_init`` picks
the fresh layers' init families as in the JAX package: flax's (truncated
lecun-normal kernels, zero biases; ``models/flax_init``) by default,
torch's under ``--torch_init true``; upstream's explicit inits (the ASPP
head, the PeakGenerator's ``extra_conv4``) stay in both. ``--grain`` selects
the loader the port always uses, ``data/loader.Loader``, whose
``--num_workers`` worker processes stand in for grain's.

Re-design of reference ``argparser.py``: the same user-facing flags, with
``modify_command_options``'s imperative derivations (``argparser.py:4-34``)
made explicit in `finalize()` — coco-voc -> WideResNet38/OS8/crop448,
phase 1 -> branch none + flac + randrop, phase 2 -> freeze + freeze_seg,
pooling = crop // output_stride, lr_head = 1 at step 0.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Config:
    # data
    data_root: str = "data"
    dataset: str = "voc"            # voc | coco | coco-voc
    task: str = "15-5"
    step: int = 0
    overlap: bool = True
    batch_size: int = 16
    crop_size: int = 512
    crop_size_val: int = 512
    synthetic: bool = False         # tiny synthetic data instead of real
    tiny: bool = False              # 1-block-per-stage backbone (debug/CI)
    grain: bool = False             # the same loader (it has worker processes)
    num_workers: int = 4            # loader worker processes (0: in-process)

    # model
    model: str = "PanopticDeepLab"  # PanopticDeepLab | DeeplabV3 (semantic-only)
    backbone: str = "resnet101"
    output_stride: int = 16
    norm_act: str = "iabn_sync"
    remat: bool = False              # recompute backbone blocks in backward
    pretrained: bool = True
    pretrained_path: str = "pretrained"

    # train
    epochs: int = 30
    lr: float = 0.007
    lr_head: float = 10.0
    lr_pseudo: float = 0.01
    lr_policy: str = "poly"
    lr_power: float = 0.9
    lr_decay_step: int = 5000
    lr_decay_factor: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    optim: str = "sgd"              # sgd | adam
    bce: bool = False
    dce: bool = False
    seed: int = 42
    dtype: str = "bfloat16"
    device: str = "cuda"            # cuda | cpu
    # fresh layers in torch's init families instead of flax's
    torch_init: bool = False

    # CL / weakly
    weakly: bool = False
    phase: Optional[int] = None     # None | 1 | 2
    pseudo: Optional[str] = None
    alpha: float = 0.5
    loss_de: float = 0.0
    loss_kd: float = 0.0
    unkd: bool = False
    kd_alpha: float = 1.0
    icarl: bool = False
    icarl_bkg: float = -1.0
    # Accepted-and-inert, matching actual reference behavior: the reference
    # parses these (argparser.py:157,159,169,189) but `l_icarl` is initialized
    # to 0 and never reassigned (train.py:223), balanced_mask_loss_unce is
    # imported but never selected (train.py:19 vs :411), and pl_ckpt has no
    # usage site at all.
    icarl_importance: float = 1.0
    icarl_disjoint: bool = False
    unce: bool = False
    pl_ckpt: Optional[str] = None
    # Live: only 'peakgenerator' is implemented (reference train.py:88 —
    # any other value leaves self.peakgenerator unset and the weakly
    # phases crash); validated in Trainer.
    peak_from: str = "peakgenerator"
    pseudo_ep: int = 5
    pos_w: float = 1.0
    affinity: bool = False
    affinity_method: str = "pamr"
    cam: str = "ngwp"
    l_seg: float = 1.0
    ss_dist: bool = False
    no_mask: bool = False
    flac: bool = False
    randrop: bool = False
    init_balanced: bool = False

    # label generation
    pseudo_thresh: float = 0.7
    refine_thresh: float = 0.3
    sigma: int = 6
    kernel: int = 41
    beta: float = 3.0
    run_refine: bool = True
    pam_alpha: float = 0.7
    # slot caps (rebuild-specific, PARITY.md "slot caps"): the reference's
    # label factory is unbounded (top_k=10000, train.py:497); these bound the
    # static-shape device programs. Saturation is counted and logged
    # ("label_truncated" train metric / "truncated_centers" val result).
    max_ctr: int = 16        # NMS center slots per class (train refine)
    max_cluster: int = 8     # offset-cluster slots per class
    max_comp: int = 64       # pseudo-label gaussian-stamp slots per IMAGE
    val_max_ctr: int = 32    # NMS center slots per class at validation

    # validation
    val_interval: int = 1
    # crop_val: parsed by the reference (argparser.py:95) but never read —
    # the val transform is unconditional Resize (dataset/__init__.py:21-26).
    # Accepted-and-inert here to match actual reference behavior.
    crop_val: bool = True
    val_thresh: float = 0.1
    val_kernel: int = 41
    val_flip: bool = False
    val_clean: bool = False
    val_ignore: bool = False
    val_on_trainset: bool = False

    # ckpt / logging
    name: str = "experiment"
    checkpoint: str = "checkpoints"
    ckpt: Optional[str] = None
    step_ckpt: Optional[str] = None
    continue_ckpt: bool = False
    ckpt_interval: int = 1
    test: bool = False
    seg_ckpt: Optional[str] = None
    debug: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    sample_num: int = 0                # save N sample visualizations per val
    logdir: str = "./logs"             # log root (reference argparser.py:99)
    visualize: bool = True             # logger summary on/off (run.py:49)
    print_interval: int = 10           # interval-mean loss logging cadence
                                       # (reference train.py:552-566; its flag
                                       # argparser.py:109 is parsed but train()
                                       # keeps the default 10 — here it's wired)

    # derived in finalize()
    branch: str = "ins"
    freeze: bool = False
    freeze_seg: bool = False
    pooling: int = 32
    num_classes: int = 21
    no_overlap: bool = False
    detach_instance: bool = False
    max_iters: int = 0
    start_decay: int = 0

    def finalize(self, iters_per_epoch: int = 0) -> "Config":
        """modify_command_options derivations (argparser.py:4-34)."""
        cfg = dataclasses.replace(self)
        if cfg.dataset == "voc":
            cfg.num_classes = 21
        elif cfg.dataset == "coco":
            cfg.num_classes = 80
        if cfg.dataset == "coco-voc":
            cfg.backbone = "wider_resnet38_a2"
            cfg.output_stride = 8
            if not cfg.tiny:  # --tiny (debug/CI only) keeps the user's crop
                cfg.crop_size = 448
                cfg.crop_size_val = 512
        cfg.branch = "none" if cfg.model == "DeeplabV3" else "ins"
        if cfg.phase == 1:
            cfg.branch = "none"
            cfg.flac = True
            cfg.randrop = True
        if cfg.phase == 2:
            cfg.freeze = True
            cfg.freeze_seg = True
        cfg.no_overlap = not cfg.overlap
        cfg.pooling = cfg.crop_size // cfg.output_stride
        if cfg.step == 0:
            cfg.lr_head = 1.0
        cfg.detach_instance = (cfg.step > 0 and cfg.weakly and
                               cfg.pseudo is None) or cfg.detach_instance
        if iters_per_epoch:
            cfg.max_iters = cfg.epochs * iters_per_epoch
            cfg.start_decay = cfg.pseudo_ep * iters_per_epoch
        return cfg


def _strbool(v: str) -> bool:
    return v.lower() in ("1", "true", "t", "yes", "y")


# Reference flags that map onto a differently-named Config field, plus
# reference flags accepted and ignored so that reference command lines parse
# unchanged (reference argparser.py:43-48 for local_rank, DDP process
# plumbing: torchrun puts LOCAL_RANK in the environment, which core/dist
# reads, and :107/:123 for the store_false/store_true inversions).
_REF_ALIASES = {"random_seed": "seed"}
_REF_IGNORED = ("local_rank", "use_DeeplabV3_as_seg_branch")
_REF_INVERTED = {"no_pretrained": "pretrained"}  # --no_pretrained == --pretrained false


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("cl4wsis_tpu_torch")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            # accepts both reference style (bare `--weakly`) and explicit
            # `--weakly true/false`
            parser.add_argument(name, type=_strbool, nargs="?", const=True,
                                default=f.default)
        elif f.default is None:
            parser.add_argument(name, default=None)
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)
    for ref, mine in _REF_ALIASES.items():
        parser.add_argument("--" + ref, dest=mine, type=int,
                            default=argparse.SUPPRESS)
    for ref in _REF_IGNORED:
        parser.add_argument("--" + ref, nargs="?", const=True,
                            default=argparse.SUPPRESS, dest="_ignored_" + ref)
    for ref in _REF_INVERTED:
        parser.add_argument("--" + ref, nargs="?", const=True, type=_strbool,
                            default=argparse.SUPPRESS, dest="_inv_" + ref)
    return parser


def parse_config(argv: Optional[List[str]] = None) -> Config:
    args = get_argparser().parse_args(argv)
    kw = vars(args)
    for k in list(kw):
        if k.startswith("_ignored_"):
            kw.pop(k)
        elif k.startswith("_inv_"):
            v = kw.pop(k)
            kw[_REF_INVERTED[k[len("_inv_"):]]] = not v
    if kw.get("phase") is not None:
        kw["phase"] = int(kw["phase"])
    if kw.get("step") is not None:
        kw["step"] = int(kw["step"])
    return Config(**kw)
