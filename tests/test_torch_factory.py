"""The port's phase-2 label factory (cl4wsis_tpu_torch.ops: stamp, binary
connected components, class components, pseudo labels, lane assignment,
center slots, slot statistics, refinement) against the JAX package on the
CPU, on the same seeded inputs. The port is batched and NCHW; the JAX
functions label one image, so they run image by image. Slot arrays, roots
and counts must be equal exactly; float tolerances are stated per test."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.ops import cc as jcc
from cl4wsis_tpu.ops import grouping as jgrouping
from cl4wsis_tpu.ops import labelgen as jlabelgen
from cl4wsis_tpu.ops import pseudo_labels as jpl
from cl4wsis_tpu.ops import refine as jrefine
from cl4wsis_tpu_torch.ops import cc, grouping, labelgen, pseudo_labels, refine
from torch_one_thread import one_torch_thread  # noqa: F401

# ------------------------------------------------------------------ stamp


def _slots(rs, B, K, H, W, C):
    cy = rs.uniform(0, H - 1, (B, K)).astype(np.float32)
    cx = rs.uniform(0, W - 1, (B, K)).astype(np.float32)
    cy[:, :4] = [0.0, H - 1, 0.0, H - 1]              # corners
    cx[:, :4] = [0.0, 0.0, W - 0.5, W - 1]
    cy[:, 4:8] = [-1.0, H + 0.5, 10.0, -0.001]        # off the plane
    cx[:, 4:8] = [10.0, 10.0, W + 3.0, 10.0]
    cls = rs.randint(0, C, (B, K)).astype(np.int32)
    cls[:, 8] = C + 3                                 # clipped to C - 1
    cls[:, 9] = -2                                    # clipped to 0
    valid = rs.rand(B, K) > 0.3
    valid[:, :10] = True
    return valid, cy, cx, cls


@pytest.mark.parametrize("sigma", [6, 8])
def test_stamp_plain_matches_jax(sigma):
    """The plain stamp against jax.vmap(stamp_centers) and the full-plane
    scan oracle: max error 1e-6 (JAX's exp against torch's)."""
    H, W, C, B, K = 64, 72, 5, 3, 20
    valid, cy, cx, cls = _slots(np.random.RandomState(sigma), B, K, H, W, C)
    got = labelgen.stamp_centers_batched(
        *(torch.from_numpy(a) for a in (valid, cy, cx, cls)), C, sigma, (H, W))
    assert got.shape == (B, C, H, W) and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    args = [jnp.asarray(a) for a in (valid, cy, cx, cls)]
    for fn in (jlabelgen.stamp_centers, jlabelgen.stamp_centers_scan):
        want = jax.jit(jax.vmap(partial(fn, num_classes=C, sigma=sigma,
                                        shape=(H, W))))(*args)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    assert got.max() == pytest.approx(1.0, abs=1e-6)


def test_stamp_slots_that_stamp_nothing():
    H = W = 32
    valid, cy, cx, cls = _slots(np.random.RandomState(0), 2, 12, H, W, 3)
    t = [torch.from_numpy(a) for a in (valid, cy, cx, cls)]
    off = torch.zeros_like(t[0])
    off[:, 4:8] = True                       # only the off-plane slots
    assert not labelgen.stamp_centers_batched(off, *t[1:], 3, 6, (H, W)).any()
    none = torch.zeros_like(t[0])
    assert not labelgen.stamp_centers_batched(none, *t[1:], 3, 6, (H, W)).any()


# ---------------------------------------------------------- binary CC


def _masks():
    rs = np.random.RandomState(0)
    yield rs.rand(48, 40) < 0.45                      # percolating speckle
    lo = rs.rand(9, 9) < 0.5
    yield np.kron(lo, np.ones((6, 6), bool))[:50, :52]  # blobs
    m = np.zeros((30, 30), bool)
    m[5, 5:25] = m[5:25, 24] = m[24, 5:25] = True      # a hook and a dot
    m[15, 15] = True
    yield m
    yield np.zeros((8, 9), bool)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_binary_cc_matches_jax(connectivity):
    """Roots exact against the JAX fixpoint (masks that converge within its
    cap of 128 iterations), for bool and uint8 masks, and batched."""
    masks = list(_masks())
    for m in masks:
        want = np.asarray(jcc.connected_components(
            jnp.asarray(m), connectivity=connectivity, num_iters=128))
        for arr in (m, m.astype(np.uint8) * 7):
            got = cc.connected_components(torch.from_numpy(arr), connectivity)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    batch = np.stack([masks[0][:30, :30], masks[2]])
    got = cc.connected_components(torch.from_numpy(batch), connectivity)
    for g, m in zip(got.numpy(), batch):
        np.testing.assert_array_equal(g, np.asarray(jcc.connected_components(
            jnp.asarray(m), connectivity=connectivity)))


# --------------------------------------------------------- factory case

C = 4          # thing classes
H = W = 64
K_PEAKS = 5


def factory_case(seed, B=3, first_class=1):
    """A batch of painted scenes: rectangles of random new classes, a wide
    one holding seven centers (more than MAXIMUM_NUM_INST), gaussian
    centers (one rectangle's and some others too weak for NMS, so that
    offset clusters fill cluster slots), offsets toward the nearest center of
    the rectangle (small near each center, so weak clusters form), soft
    seg probabilities, and CAM peaks: one in some components, two in
    others, one in a component under the minimum size."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = {k: [] for k in ("gt", "center", "offset", "soft", "label",
                           "pys", "pxs", "pvalid")}
    for b in range(B):
        gt = np.zeros((H, W), np.int32)
        center = np.zeros((H, W, C), np.float32)
        offset = rs.uniform(-20, 20, (H, W, 2)).astype(np.float32)
        pys = np.zeros((C, K_PEAKS), np.int32)
        pxs = np.zeros((C, K_PEAKS), np.int32)
        pvalid = np.zeros((C, K_PEAKS), bool)
        rects = [(2, 16, 2, 62, first_class, 7)] if b == 0 else []
        for j in range(4):
            y0, x0 = rs.randint(18, 50), rs.randint(0, 46)
            rects.append((y0, y0 + rs.randint(6, 14), x0,
                          x0 + rs.randint(6, 18), rs.randint(first_class, C),
                          1 if j == 0 else rs.randint(1, 3)))
        rects.append((60, 63, 60, 64, C - 1, 1))       # 12 px: too small
        npk = np.zeros(C, int)
        for r_id, (y0, y1, x0, x1, c, n) in enumerate(rects):
            box = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
            gt[box] = c + 1
            cs = [(rs.randint(y0, y1), x0 + (2 * i + 1) * (x1 - x0) // (2 * n))
                  for i in range(n)]
            d = np.full((H, W), np.inf, np.float32)
            for i, (cy, cx) in enumerate(cs):
                # the first random rectangle's one center is too weak for
                # NMS: only its offset cluster can find it
                weak = r_id == len(rects) - 5 or rs.rand() < 0.2
                amp = 0.12 if weak else rs.uniform(0.4, 1.0)
                g = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
                center[..., c] = np.maximum(center[..., c], g)
                di = (yy - cy) ** 2 + (xx - cx) ** 2
                near = box & (di < d)
                offset[..., 0][near] = (cy - yy)[near]
                offset[..., 1][near] = (cx - xx)[near]
                d = np.minimum(d, np.where(box, di, np.inf))
                if npk[c] < K_PEAKS and (n <= 2 or i < 2):
                    pys[c, npk[c]], pxs[c, npk[c]] = cy, cx
                    pvalid[c, npk[c]] = rs.rand() < 0.9
                    npk[c] += 1
        logits = rs.uniform(0, 1, (H, W, C + 1)).astype(np.float32)
        logits[..., 0] += 2.0
        for c in range(C):
            logits[..., c + 1][gt == c + 1] += 5.0
        label = np.zeros(C, np.float32)
        label[np.unique(gt[gt > 0]) - 1] = 1.0
        label[:first_class] = 0.0
        soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        soft[..., 1:] *= label
        for k, v in zip(out, (gt, center, offset, soft, label, pys, pxs,
                              pvalid)):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_per_image(fn, *arrays):
    """fn over each image of numpy batches; outputs stacked to numpy."""
    outs = [fn(*(jnp.asarray(a[b]) for a in arrays))
            for b in range(arrays[0].shape[0])]
    return jax.tree_util.tree_map(lambda *xs: np.stack(
        [np.asarray(x) for x in xs]), *outs)


FC = 1


@pytest.fixture(scope="module")
def case():
    return factory_case(0)


@pytest.fixture(scope="module")
def port_components(case):
    return pseudo_labels.class_components(
        _t(case["gt"]), _t(case["label"]), C, FC, _t(case["pys"]),
        _t(case["pxs"]), _t(case["pvalid"]))


def _jax_components(case):
    fn = jax.jit(lambda s, cl, py, px, pv: jpl.class_components(
        s, cl, C, FC, 64, py, px, pv))
    return _jax_per_image(fn, case["gt"], case["label"], case["pys"],
                          case["pxs"], case["pvalid"])


def test_class_components_matches_jax(case, port_components):
    want = _jax_components(case)
    got = port_components
    for k in ("eff", "roots", "proot", "accept_p"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k), err_msg=k)
    for k in ("cy_p", "cx_p"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(want, k), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.pcls.numpy(), want.pcls[0])
    accepted = got.accept_p.sum(1)
    assert accepted.sum() >= 2 and (~got.accept_p & (got.proot < H * W)).any()


@pytest.mark.parametrize("max_comp", [64, 1])
def test_pseudo_label_slots_matches_jax(case, port_components, max_comp):
    """Slots, n_match and truncated exact (max_comp 1 truncates; 64 pads
    the 15-peak axis); maps within 1e-5."""
    slots, off, wt, n_match, trunc = pseudo_labels.pseudo_label_slots(
        _t(case["gt"]), _t(case["pys"]), _t(case["pxs"]), _t(case["pvalid"]),
        _t(case["label"]), C, max_comp, FC, port_components)
    fn = jax.jit(lambda s, py, px, pv, cl: jpl.pseudo_label_slots(
        s, py, px, pv, cl, C, 6, max_comp, 64, FC))
    w_slots, w_off, w_wt, w_n, w_trunc = _jax_per_image(
        fn, case["gt"], case["pys"], case["pxs"], case["pvalid"],
        case["label"])
    for g, w, name in zip(slots, w_slots, ("valid", "cy", "cx", "cls")):
        assert g.shape == (3, max_comp), name
        if name in ("cy", "cx"):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(n_match.numpy(), w_n)
    np.testing.assert_array_equal(trunc.numpy(), w_trunc)
    assert (trunc.numpy() > 0).any() == (max_comp == 1)
    np.testing.assert_allclose(off.permute(0, 2, 3, 1).numpy(), w_off,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.permute(0, 2, 3, 1).numpy(), w_wt,
                               rtol=0, atol=1e-5)


def test_assign_pixels_lanes_matches_jax():
    """Ties to the lowest slot, S where no slot qualifies: exact."""
    rs = np.random.RandomState(1)
    B, S = 2, 12
    roots = np.stack([np.kron(rs.randint(0, 3, (4, 4)),
                              np.ones((8, 8), np.int32)) for _ in range(B)])
    roots[:, :4] = 32 * 32                          # background rows
    ys = rs.randint(0, 32, (B, S)).astype(np.int32)
    xs = rs.randint(0, 32, (B, S)).astype(np.int32)
    ys[:, 1], xs[:, 1] = ys[:, 0], xs[:, 0]         # a duplicate: a tie
    valid = rs.rand(B, S) > 0.2
    croot = rs.randint(0, 4, (B, S)).astype(np.int32)
    offsets = np.round(rs.uniform(-3, 3, (B, 32, 32, 2))).astype(np.float32)
    got = grouping.assign_pixels_lanes(_t(ys), _t(xs), _t(valid), _t(croot),
                                       _nchw(offsets), _t(roots.astype(np.int32)))
    want = _jax_per_image(jgrouping.assign_pixels_lanes, ys, xs, valid,
                          croot, offsets, roots.astype(np.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == S).any() and (want < S).any()


@pytest.mark.parametrize("first_class,cap", [(0, False), (1, True)])
def test_global_center_slots_matches_jax(case, first_class, cap):
    """Slot arrays, truncation exact; the spiked heatmap exact. The cap
    drops the seven-center component of image 0."""
    comp = pseudo_labels.class_components(_t(case["gt"]), _t(case["label"]),
                                          C, first_class)
    kw = dict(threshold=0.3, nms_kernel=15, beta=3.0, max_ctr=8,
              max_cluster=4)
    slots, spiked, trunc = refine._global_center_slots(
        comp.eff, comp.roots, _nchw(case["center"]), _nchw(case["offset"]),
        num_classes=C, first_class=first_class, max_inst_cap=cap, **kw)
    fn = jax.jit(lambda e, r, c, o: jrefine._global_center_slots(
        e, r, c, o, cc_iters=64, num_classes=C, first_class=first_class,
        max_inst_cap=cap, **kw))
    w_slots, w_spiked, w_trunc = _jax_per_image(
        fn, comp.eff.numpy(), comp.roots.numpy(), case["center"],
        case["offset"])
    for k in ("ys", "xs", "valid", "root", "cls", "cyf", "cxf"):
        np.testing.assert_array_equal(slots[k].numpy(), w_slots[k],
                                      err_msg=k)
    np.testing.assert_array_equal(trunc.numpy(), w_trunc)
    np.testing.assert_array_equal(spiked.permute(0, 2, 3, 1).numpy(),
                                  w_spiked)
    n_ctr = (C - first_class) * 8
    assert slots["valid"][:, :n_ctr].any() and slots["valid"][:, n_ctr:].any()


def test_slot_stats_matches_jax(case, port_components):
    """npix, vmax and the argmax pixel exact; seg_score within 1e-5 (the
    port sums probabilities in float64, JAX in float32 lanes)."""
    comp = port_components
    kw = dict(threshold=0.3, nms_kernel=15, beta=3.0, max_ctr=8,
              max_cluster=4, num_classes=C, first_class=FC)
    slots, spiked, _ = refine._global_center_slots(
        comp.eff, comp.roots, _nchw(case["center"]), _nchw(case["offset"]),
        max_inst_cap=True, **kw)
    assign = grouping.assign_pixels_lanes(
        slots["ys"], slots["xs"], slots["valid"], slots["root"],
        _nchw(case["offset"]), comp.roots)
    n_slots = (C - FC) * 12
    soft_things = _nchw(case["soft"])[:, 1 + FC:]
    got = refine._slot_stats(assign, comp.eff, spiked, soft_things, n_slots,
                             FC)
    fn = jax.jit(lambda a, e, s, p: jrefine._slot_stats(
        None, a, e, s, p, n_slots, FC))
    want = _jax_per_image(fn, assign.numpy(), comp.eff.numpy(),
                          spiked.permute(0, 2, 3, 1).numpy(),
                          case["soft"][..., 1 + FC:])
    for i, name in enumerate(("npix", "seg_score", "vmax", "py", "px")):
        if name == "seg_score":
            np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got[i].numpy(), want[i],
                                          err_msg=name)
    assert (got[0][:, :n_slots] > 0).sum() >= 3


def test_refine_label_slots_matches_jax(case, port_components):
    """Stamp slots and truncation exact; offset and weight maps within 1e-5;
    the stamped refined centers within 1e-6."""
    kw = dict(num_classes=C, refine_thresh=0.3, nms_kernel=15, beta=3.0,
              max_ctr=8, max_cluster=4, first_class=FC)
    got = refine.refine_label_slots(
        _nchw(case["soft"]), _nchw(case["center"]), _nchw(case["offset"]),
        _t(case["label"]), _t(case["gt"]), components=port_components, **kw)
    fn = jax.jit(lambda sp, c, o, cl, s: jrefine.refine_label_slots(
        sp, c, o, cl, s, sigma=6, cc_iters=64, **kw))
    want = _jax_per_image(fn, case["soft"], case["center"], case["offset"],
                          case["label"], case["gt"])
    for k in ("stamp_valid", "stamp_y", "stamp_x", "stamp_cls", "truncated"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("offset", "weight"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   want[k], rtol=0, atol=1e-5, err_msg=k)
    assert got["stamp_valid"].sum() >= 3 and (got["weight"] > 0).any()
    center = labelgen.stamp_centers_batched(
        got["stamp_valid"], got["stamp_y"], got["stamp_x"], got["stamp_cls"],
        C, 6, (H, W))
    w_center = jax.vmap(partial(jlabelgen.stamp_centers, num_classes=C,
                                sigma=6, shape=(H, W)))(
        *(jnp.asarray(want[k]) for k in ("stamp_valid", "stamp_y", "stamp_x",
                                         "stamp_cls")))
    np.testing.assert_allclose(center.permute(0, 2, 3, 1).numpy(),
                               np.asarray(w_center), rtol=0, atol=1e-6)
