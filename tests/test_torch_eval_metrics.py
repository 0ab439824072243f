"""The port's validation (cl4wsis_tpu_torch: metrics/stream, metrics/voc_ap,
train/eval.validate_instances and validate_semseg with the CLI's three
classify/forward builders) against the JAX package on the CPU, in float32,
with a tiny model's weights carried over by convert_jax_variables.

Tolerances: confusion matrices and integer results exactly, metric floats
1e-12 (the same numpy arithmetic on the same integers), mAP / mAP50 / AP
1e-6 (the instance maps are equal, the scores agree to 1e-5)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.metrics.stream import StreamSegMetrics as JaxSSM
from cl4wsis_tpu.metrics.voc_ap import InstanceAPAccumulator as JaxAcc
from cl4wsis_tpu.metrics.voc_ap import ins_map_iou as jax_ins_map_iou
from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu.ops.resize import resize_bilinear as jax_resize
from cl4wsis_tpu.train.eval import make_eval_forward as jax_eval_forward
from cl4wsis_tpu.train.eval import validate_instances as jax_val_instances
from cl4wsis_tpu.train.eval import validate_semseg as jax_val_semseg
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.cli.main import (make_classify_cam, make_classify_seg,
                                        make_instance_forward)
from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
from cl4wsis_tpu_torch.metrics import (InstanceAPAccumulator, StreamSegMetrics,
                                       ins_map_iou, mask_iou)
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train.eval import (make_eval_forward,
                                          validate_instances, validate_semseg)
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = (1, 1, 1, 1)
CLASSES = (3, 2)
SIZE = 64
EVAL_KW = dict(val_thresh=0.1, val_kernel=15, beta=3.0, max_ctr=8,
               max_cluster=4)


# ------------------------------------------------------------- metrics

def _seg_pairs(rs, n_classes, n=5):
    for i in range(n):
        shape = (2, 17, 23) if i % 2 else (29, 31)
        lt = rs.randint(0, n_classes, shape)
        lt[rs.rand(*shape) < 0.1] = 255
        lp = rs.randint(0, n_classes - 2, shape)   # two classes never predicted
        if lt.ndim == 2:
            lt, lp = lt[None], lp[None]
        yield lt, lp


def test_stream_seg_metrics_match_jax():
    """Confusion matrix exactly (int64), every result float within 1e-12,
    "X" for classes without ground truth; reset empties it."""
    got, want = StreamSegMetrics(21), JaxSSM(21)
    for lt, lp in _seg_pairs(np.random.RandomState(0), 21):
        got.update(lt, lp)
        want.update(lt, lp)
    got.synch()
    assert got.confusion_matrix.dtype == np.int64
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    g, w = got.get_results(), want.get_results()
    assert g.keys() == w.keys()
    for k in g:
        if isinstance(g[k], dict):
            assert g[k].keys() == w[k].keys()
            for c in g[k]:
                if w[k][c] == "X":
                    assert g[k][c] == "X", (k, c)
                else:
                    assert abs(g[k][c] - w[k][c]) <= 1e-12, (k, c)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    assert got.to_str(g) == want.to_str(w)
    got.reset()
    assert got.total_samples == 0 and not got.confusion_matrix.any()


def _ap_images(rs, n_img=12, n_classes=6):
    """Random per-image gt, predictions and IoU matrices (some images
    without predictions, some classes only predicted, score ties)."""
    for i in range(n_img):
        n_gt, n_pred = rs.randint(1, 6), rs.randint(0, 8)
        gt_label = rs.randint(0, n_classes - 1, n_gt)
        gt_mask = rs.rand(n_gt, 8, 8) > 0.5
        pred_label = rs.randint(0, n_classes, n_pred)
        pred_score = rs.choice([0.2, 0.5, 0.5, 0.9], n_pred) + \
            rs.rand(n_pred) * (i % 2)
        iou = rs.rand(n_pred, n_gt)
        yield gt_label, gt_mask, pred_label, pred_score, iou


def test_instance_ap_accumulator_matches_jax_and_merges():
    """results() equal to JAX's (AP within 1e-12, NaN where JAX has NaN);
    the merge of two halves equals one pass."""
    images = list(_ap_images(np.random.RandomState(1)))
    got, want = InstanceAPAccumulator(), JaxAcc()
    halves = [InstanceAPAccumulator(), InstanceAPAccumulator()]
    for i, im in enumerate(images):
        got.add_image(*im)
        want.add_image(*im)
        halves[i % 2].add_image(*im)
    halves[0].merge(halves[1])
    g, w, m = got.results(), want.results(), halves[0].results()
    for k in ("ap", "ap50", "map", "map50"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12,
                                   equal_nan=True, err_msg=k)
        np.testing.assert_allclose(m[k], g[k], rtol=0, atol=1e-12,
                                   equal_nan=True, err_msg=k)
    assert np.isnan(g["ap"]).any() and 0 < g["map"] < 1
    g07, w07 = got.results(use_07_metric=True), want.results(use_07_metric=True)
    np.testing.assert_allclose(g07["ap"], w07["ap"], rtol=0, atol=1e-12,
                               equal_nan=True)


def test_ins_map_iou_matches_jax_and_mask_iou():
    rs = np.random.RandomState(2)
    ins = rs.randint(-1, 7, (20, 30)).astype(np.int32)
    gt = rs.rand(4, 20, 30) > 0.6
    slots = np.array([0, 3, 6])
    got = ins_map_iou(ins, slots, gt)
    np.testing.assert_array_equal(got, jax_ins_map_iou(ins, slots, gt))
    np.testing.assert_allclose(got, mask_iou(np.stack([ins == s for s in slots]),
                                             gt), rtol=0, atol=1e-15)


# ------------------------------------------------------ tiny models

@pytest.fixture(scope="module")
def tiny():
    """A tiny JAX model (centre heads biased so NMS finds centres) and a
    PseudoLabeler, jitted init; the port's twins from the same weights."""
    jm = jax_make_model(CLASSES, "resnet101", 16, SIZE,
                        backbone_structure=TINY)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    head = v["params"]["instance_head"]
    for name in ("center_cls_0", "center_cls_1"):
        head[name]["bias"] = head[name]["bias"] + np.float32(0.3)
    jpl = JaxPL(num_classes=sum(CLASSES))
    plv = jax.tree_util.tree_map(np.asarray, jpl.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 4, 2048)), train=False))
    port = make_model(CLASSES, "resnet101", 16, SIZE, backbone_structure=TINY)
    port.load_state_dict(convert_jax_variables(v))
    pl = PseudoLabeler(sum(CLASSES))
    pl.load_state_dict(convert_jax_variables(plv))
    port.train()        # validation must put it in eval mode itself
    pl.train()
    trainer = types.SimpleNamespace(
        model=port, pseudolabeler=pl, device=torch.device("cpu"),
        tot_classes=sum(CLASSES), old_classes=CLASSES[0],
        cfg=types.SimpleNamespace(dtype="float32", val_thresh=0.1,
                                  val_kernel=15, beta=3.0, val_max_ctr=8,
                                  max_cluster=4, val_flip=False))
    return jm, v, jpl, plv, trainer


def _images(sizes, seed):
    """Normalised images at the given (H, W), painted with boxes."""
    rs = np.random.RandomState(seed)
    out = []
    for h, w in sizes:
        img = rs.rand(h, w, 3).astype(np.float32) * 0.3
        for _ in range(3):
            y, x = rs.randint(0, h - 12), rs.randint(0, w - 12)
            img[y:y + rs.randint(8, 20), x:x + rs.randint(8, 20)] = rs.rand(3)
        out.append(((img - 0.45) / 0.225)[None].astype(np.float32))
    return out


@pytest.fixture(scope="module")
def instance_samples(tiny):
    """Painted images of two sizes (one bucket) whose ground truth is
    made from the JAX model's own predictions without flip: every second
    predicted instance with its class, every fourth with the next class, a
    painted box of class 0; so AP is neither 0 nor 1."""
    jm, v = tiny[:2]
    fwd = jax_eval_forward(jm, v, sum(CLASSES) - 1, **EVAL_KW)
    samples = []
    for img in _images([(60, 44), (64, 52), (60, 44), (64, 52)], 3):
        h, w = img.shape[1:3]
        out = fwd(jnp.asarray(img), (h, w))
        ins, lab = np.asarray(out["ins_map"]), np.asarray(out["label"])
        ids = [s for s in np.unique(ins) if s >= 0]
        masks = [ins == s for s in ids[::2]]
        labels = [int(lab[s]) for s in ids[::2]]
        labels[::2] = [(c + 1) % (sum(CLASSES) - 1) for c in labels[::2]]
        box = np.zeros((h, w), bool)
        box[5:20, 8:30] = True
        samples.append({"image": img, "gt_masks": np.stack(masks + [box]),
                        "gt_labels": np.array(labels + [0])})
    assert sum(len(s["gt_labels"]) for s in samples) > 8
    return samples


@pytest.mark.parametrize("val_flip", [False, True])
def test_validate_instances_matches_jax(tiny, instance_samples, val_flip):
    """validate_instances over the CLI's instance forward (bucketed, the
    model left in train mode before it) against JAX's: mAP, mAP50 and
    per-class AP within 1e-6, truncated_centers equal."""
    jm, v, _, _, trainer = tiny
    trainer.model.train()
    trainer.cfg.val_flip = val_flip
    want = jax_val_instances(
        jax_eval_forward(jm, v, sum(CLASSES) - 1, val_flip=val_flip,
                         **EVAL_KW), instance_samples)
    got = validate_instances(make_instance_forward(trainer), instance_samples)
    assert not trainer.model.training
    for k in ("map", "map50", "ap", "ap50"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    assert got["truncated_centers"] == want["truncated_centers"]
    assert 0 < got["map50"] < 1


def _semseg_samples():
    rs = np.random.RandomState(4)
    out = []
    for img in _images([(48, 40), (64, 64), (56, 48)], 5):
        seg = rs.randint(0, sum(CLASSES), img.shape[1:3])
        seg[rs.rand(*seg.shape) < 0.1] = 255
        out.append({"image": img, "seg": seg})
    return out


def test_validate_semseg_deeplab_mode_matches_jax(tiny):
    """The model's own seg (DeeplabV3 mode): results equal to JAX's
    exactly, so the confusion matrices are equal."""
    jm, v, _, _, trainer = tiny
    trainer.model.train()

    @jax.jit
    def classify(image):
        pred, _ = jm.apply(v, image, train=False, interpolate=False,
                           method=jm.forward_seg)
        seg = jax_resize(pred["seg"], image.shape[1:3], align_corners=False)
        return jax.nn.softmax(seg, axis=-1)

    samples = _semseg_samples()
    want = jax_val_semseg(classify, samples, sum(CLASSES))
    got = validate_semseg(make_classify_seg(trainer), samples, sum(CLASSES))
    assert got == want
    assert got["Total samples"] == 3 and got["Mean IoU"] > 0


def test_validate_semseg_cam_mode_matches_jax(tiny):
    """The PseudoLabeler's CAM on the body features (phase-1 mode), the
    old classes' ground truth zeroed: results equal to JAX's exactly."""
    jm, v, jpl, plv, trainer = tiny
    trainer.model.train()
    trainer.pseudolabeler.train()

    @jax.jit
    def classify(image):
        feats = jm.apply(v, image, train=False, method=jm.forward_features)
        cam = jpl.apply(plv, feats["res5"], train=False)
        cam = jax_resize(cam, image.shape[1:3], align_corners=False)
        return jax.nn.softmax(cam, axis=-1)

    samples = _semseg_samples()
    want = jax_val_semseg(classify, samples, sum(CLASSES),
                          old_classes=CLASSES[0])
    got = validate_semseg(make_classify_cam(trainer), samples, sum(CLASSES),
                          old_classes=CLASSES[0])
    assert got == want
    assert not trainer.pseudolabeler.training


def test_eval_forward_after_a_phase2_step_equals_a_fresh_eval_model():
    """A phase-2 step leaves the body in eval mode and the decoder in train
    mode. The eval forward called right after it gives what the same
    weights give in a model freshly put in eval mode; without its own
    .eval() it would differ (the decoder's batch statistics and dropout)."""
    torch.manual_seed(0)
    model = make_model(CLASSES, "resnet101", 16, SIZE, backbone_structure=TINY)
    model_old = make_model(CLASSES[:1], "resnet101", 16, SIZE,
                           backbone_structure=TINY)
    pl, pg = PseudoLabeler(5), PeakGenerator(4, 2)
    opt = schedule.make_optimizer(model, "adam", group_scale={
        "body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0})
    state = TrainState(model, opt, schedule.make_schedule("poly", 1e-4, 10))
    step = make_phase2_train_step(model, model_old, pl, pg, CLASSES[0],
                                  nms_kernel=15, device="cpu")
    b = next(synthetic_batches(2, SIZE, 4, seed=1))
    step(state, {"image": torch.from_numpy(b["image"]),
                 "l1h": torch.from_numpy(b["l1h"][:, 1:].copy())},
         torch.Generator().manual_seed(0))
    assert not model.body.training and model.decoder.training

    image = torch.from_numpy(_images([(60, 44)], 6)[0])
    kw = dict(device="cpu", dtype=torch.float32, **EVAL_KW)
    fresh = make_model(CLASSES, "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    fresh.load_state_dict(model.state_dict())
    fresh.eval()
    with torch.no_grad():
        x = image.permute(0, 3, 1, 2)
        train_mode = model(x, interpolate=False)["center"]
    got = make_eval_forward(model, 4, **kw)(image, (60, 44))
    want = make_eval_forward(fresh, 4, **kw)(image, (60, 44))
    for k in ("ins_map", "label", "valid", "score", "truncated"):
        assert torch.equal(got[k], want[k]), k
    with torch.no_grad():
        eval_mode = fresh(x, interpolate=False)["center"]
    assert not torch.allclose(train_mode, eval_mode, atol=1e-3)
