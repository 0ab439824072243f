"""The port's data path (cl4wsis_tpu_torch.data) against the JAX package's
on the CPU: mask RLE and the native library, CocoJson, every transform,
the VOC, COCO and COCO-to-VOC datasets, the offline VOC->COCO remap and the
shipped split assets.

Tolerance: none anywhere. Integers, masks and float images must be equal
exactly: both packages run the same Pillow and numpy on the same bytes."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st
from PIL import Image

from cl4wsis_tpu.cl import tasks as jax_tasks
from cl4wsis_tpu.data import coco as jax_coco
from cl4wsis_tpu.data import cocojson as jax_cocojson
from cl4wsis_tpu.data import cocovoc as jax_cocovoc
from cl4wsis_tpu.data import maskrle as jax_maskrle
from cl4wsis_tpu.data import native as jax_native
from cl4wsis_tpu.data import transforms as JT
from cl4wsis_tpu.data import voc as jax_voc
from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.data import coco, cocojson, cocovoc, maskrle, native
from cl4wsis_tpu_torch.data import transforms as PT
from cl4wsis_tpu_torch.data import voc
from tests.test_coco_data import _write_fake_coco
from tests.test_data import _rle_to_string, _write_fake_voc
from tests.test_native import _frpoly_transcription
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_sample(got, want):
    """Two samples (dicts or tuples): the same keys, dtypes and values."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        pairs = [(got[k], want[k], k) for k in want]
    else:
        assert len(got) == len(want)
        pairs = [(g, w, i) for i, (g, w) in enumerate(zip(got, want))]
    for g, w, k in pairs:
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=str(k))
        elif isinstance(w, Image.Image):
            assert g.size == w.size and g.mode == w.mode, k
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            assert g == w, k


# ------------------------------------------------------------ mask RLE

COUNTS = [[3, 5, 0, 2, 10, 7, 1], [0, 1], [100000, 3, 99999, 40, 2],
          [7], [1, 1, 1, 1, 1, 1, 1, 1, 1]]


@pytest.mark.parametrize("counts", COUNTS)
def test_rle_from_string_matches_jax(counts):
    s = _rle_to_string(counts)
    want = jax_maskrle.rle_from_string(s)
    assert maskrle.rle_from_string(s) == want == counts
    assert maskrle.rle_from_string(s.encode()) == want
    assert native.rle_from_string(s) == jax_native.rle_from_string(s) == want


@pytest.mark.parametrize("shape,p", [((37, 23), 0.5), ((1, 1), 1.0),
                                     ((16, 9), 0.0), ((64, 48), 0.9)])
def test_rle_encode_decode_match_jax(shape, p):
    m = (np.random.RandomState(shape[0]).rand(*shape) < p).astype(np.uint8)
    enc = maskrle.rle_encode(m)
    assert enc == jax_maskrle.rle_encode(m)
    assert native.rle_encode(m) == jax_native.rle_encode(m) == enc["counts"]
    for dec in (maskrle.rle_decode(enc["counts"], *shape),
                native.rle_decode(enc["counts"], *shape)):
        assert dec.dtype == np.uint8
        np.testing.assert_array_equal(dec, m)
        np.testing.assert_array_equal(
            dec, jax_maskrle.rle_decode(enc["counts"], *shape))


def test_rle_decode_short_counts_pad_with_zeros():
    got = maskrle.rle_decode([2, 3], 4, 3)
    np.testing.assert_array_equal(got, jax_maskrle.rle_decode([2, 3], 4, 3))
    np.testing.assert_array_equal(native.rle_decode([2, 3], 4, 3), got)
    assert got.sum() == 3


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), seed=st.integers(0, 2 ** 16),
       p=st.floats(0.0, 1.0))
def test_rle_roundtrips_native_against_numpy(h, w, seed, p):
    m = (np.random.RandomState(seed).rand(h, w) < p).astype(np.uint8)
    counts = native.rle_encode(m)
    assert counts == maskrle.rle_encode(m)["counts"]
    np.testing.assert_array_equal(native.rle_decode(counts, h, w), m)
    np.testing.assert_array_equal(maskrle.rle_decode(counts, h, w), m)
    s = _rle_to_string(counts)
    assert native.rle_from_string(s) == maskrle.rle_from_string(s) == counts


@pytest.fixture(scope="module")
def jax_poly_lib(tmp_path_factory):
    """The JAX package's mask library (``csrc/maskops.cpp``) built with its
    Makefile's flags and ``-ffp-contract=off``. ``-march=native`` alone lets
    g++ fuse multiply-adds on a host with FMA, which moves one pixel of
    about one random polygon in 500 away from pycocotools' rleFrPoly (seed
    60187, 3 points below); without contraction the build rounds as
    rleFrPoly does on every host."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/maskops.cpp with")
    csrc = os.path.join(REPO, "csrc")
    with open(os.path.join(csrc, "Makefile")) as f:
        flags = re.search(r"^CXXFLAGS \?= (.*)$", f.read(), re.M)[1].split()
    so = tmp_path_factory.mktemp("jax_maskops") / "libmaskops.so"
    subprocess.run(["g++", *flags, "-ffp-contract=off", "-shared", "-o",
                    str(so), os.path.join(csrc, "maskops.cpp")], check=True)
    return ctypes.CDLL(str(so))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n_pts=st.integers(3, 9))
@example(seed=60187, n_pts=3)
def test_polygon_roundtrip_against_frpoly(jax_poly_lib, seed, n_pts):
    rs = np.random.RandomState(seed)
    h, w = 29, 35
    xy = (rs.rand(2 * n_pts) * np.array([w + 4, h + 4] * n_pts) - 2).tolist()
    got = maskrle.polygons_to_mask([xy], h, w)
    np.testing.assert_array_equal(got, _frpoly_transcription(xy, h, w))
    with mock.patch.object(jax_native, "_LIB", jax_poly_lib):
        want = jax_native.poly_to_mask([xy], h, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_polygons_match_jax(seed):
    """One polygon, several OR-ed together (overlapping), and one of fewer
    than 3 points (skipped), through the port and the JAX package."""
    rs = np.random.RandomState(seed)
    h, w = 40, 52
    polys = [(rs.rand(2 * n) * np.array([w, h] * n)).tolist()
             for n in (4, 6, 3)] + [[1.0, 2.0, 3.0, 4.0]]
    for ps in (polys[:1], polys):
        got = maskrle.polygons_to_mask(ps, h, w)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_maskrle.polygons_to_mask(
            ps, h, w))
        np.testing.assert_array_equal(got, native.poly_to_mask(ps, h, w))
    union = np.zeros((h, w), np.uint8)
    for p in polys[:3]:
        union |= _frpoly_transcription(p, h, w)
    np.testing.assert_array_equal(maskrle.polygons_to_mask(polys, h, w), union)


def test_ann_to_mask_matches_jax():
    m = np.zeros((13, 11), np.uint8)
    m[2:9, 3:7] = 1
    m[10:, :2] = 1
    counts = maskrle.rle_encode(m)["counts"]
    anns = [
        {"segmentation": [[1, 1, 9, 1, 9, 8, 1, 8]]},
        {"segmentation": {"size": [13, 11], "counts": counts}},
        {"segmentation": {"size": [13, 11], "counts": _rle_to_string(counts)}},
        {"segmentation": {"size": [13, 11],
                          "counts": _rle_to_string(counts).encode()}},
    ]
    for ann in anns:
        got = maskrle.ann_to_mask(ann, 13, 11)
        np.testing.assert_array_equal(got, jax_maskrle.ann_to_mask(ann, 13, 11))
    for ann in anns[1:]:
        np.testing.assert_array_equal(maskrle.ann_to_mask(ann, 13, 11), m)


def test_native_library_is_the_port_own_build():
    """The port builds its own copy of the source, byte for byte the JAX
    package's, under its _build directory, and no flag ties it to the
    building host."""
    with open(os.path.join(REPO, "csrc", "maskops.cpp"), "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert "-march=native" not in native.CXX_FLAGS
    assert native.lib() is native.lib()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    a missing compiler raises too. Nothing falls back."""
    bad = tmp_path / "maskops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="maskops.cpp failed:\n.*error"):
        native.build()
    with pytest.raises(RuntimeError, match="failed"):
        maskrle.polygons_to_mask([[0, 0, 4, 0, 4, 4]], 8, 8)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_port_imports_no_cv2():
    """No module of the port imports cv2 (the failed-build test above shows
    that nothing else rasterises in the native library's place)."""
    import ast
    pkg = os.path.join(REPO, "cl4wsis_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                assert not any(m.split(".")[0] == "cv2" for m in mods), name


# ------------------------------------------------------------ CocoJson

def test_cocojson_matches_jax(tmp_path):
    _write_fake_coco(str(tmp_path), n_images=3)
    path = str(tmp_path / "coco" / "annotations" / "instances_train2017.json")
    ann = next(iter(jax_cocojson.CocoJson(path).anns.values()))
    ann = dict(ann, iscrowd=1)
    a, b = cocojson.CocoJson(path), jax_cocojson.CocoJson(path)
    a.anns[ann["id"]].update(iscrowd=1)
    b.anns[ann["id"]].update(iscrowd=1)
    assert a.getImgIds() == b.getImgIds() == a.get_img_ids()
    assert a.cats == b.cats and a.imgs == b.imgs
    for i in a.getImgIds():
        for crowd in (None, True, False):
            assert a.getAnnIds(i, iscrowd=crowd) == b.getAnnIds(i,
                                                               iscrowd=crowd)
        assert a.loadAnns(a.getAnnIds(i)) == b.loadAnns(b.getAnnIds(i))
        for x in a.loadAnns(a.getAnnIds(i)):
            np.testing.assert_array_equal(a.annToMask(x), b.annToMask(x))
    assert a.getAnnIds([1, 2]) == b.getAnnIds([1, 2])
    assert a.loadImgs(1) == b.loadImgs(1)


# ---------------------------------------------------------- transforms

def _pair(rs, h=40, w=60, k=2):
    img = Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8))
    lbl = Image.fromarray(rs.randint(0, 5, (h, w, k) if k > 1 else (h, w),
                                     dtype=np.uint8))
    return img, lbl


def _flip(im):
    return im.transpose(Image.FLIP_LEFT_RIGHT)


TRANSFORMS = {
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(48),
    "RandomResizedCrop-fallback": lambda T: T.RandomResizedCrop(
        32, scale=(3.0, 4.0)),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "Resize": lambda T: T.Resize(32),
    "ResizeExact": lambda T: T.ResizeExact((30, 50)),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(),
    "RandomScale": lambda T: T.RandomScale((0.5, 2.0)),
    "CenterCrop": lambda T: T.CenterCrop(32),
    "PadCenterCrop": lambda T: T.PadCenterCrop(64),
    "RandomCrop": lambda T: T.RandomCrop(32),
    "RandomCrop-pad": lambda T: T.RandomCrop(56),
    "RandomRotation": lambda T: T.RandomRotation(10),
    "ColorJitter": lambda T: T.ColorJitter(),
    "Pad": lambda T: T.Pad(3, fill=7),
    "Pad-edge": lambda T: T.Pad((1, 2, 3, 4), mode="edge"),
    "Lambda": lambda T: T.Lambda(_flip),
    "CustomRandomResizeLong": lambda T: T.CustomRandomResizeLong(70, 90),
    "CustomRandomCrop": lambda T: T.CustomRandomCrop(48),
    "train_transform": lambda T: T.train_transform(48),
    "val_transform": lambda T: T.val_transform(32),
    "val_transform-none": lambda T: T.val_transform(None),
}


@pytest.mark.parametrize("name,k", [(n, k) for n in sorted(TRANSFORMS)
                                    for k in (1, 2)
                                    if (n, k) != ("RandomRotation", 2)])
def test_transform_matches_jax(name, k):
    """The same draws in the same order (the generators end in the same
    state over 8 calls) and the same pixels, on a label of one channel and
    on the (seg, inst) stack the datasets give (RandomRotation fills a
    label of one channel only)."""
    img, lbl = _pair(np.random.RandomState(3), k=k)
    port, ref = TRANSFORMS[name](PT), TRANSFORMS[name](JT)
    ra, rb = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(8):
        assert_same_sample(port(img, lbl, ra), ref(img, lbl, rb))
    assert ra.randint(1 << 30) == rb.randint(1 << 30)


def test_normalize_image_matches_jax():
    img, _ = _pair(np.random.RandomState(5))
    got = PT.normalize_image(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JT.normalize_image(img))
    np.testing.assert_array_equal(PT.IMAGENET_MEAN, JT.IMAGENET_MEAN)
    np.testing.assert_array_equal(PT.IMAGENET_STD, JT.IMAGENET_STD)


# ------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def rich_voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    _write_fake_voc(root, n_images=16, size=96, rich=True, paint=True)
    pdir = os.path.join(root, "voc", "mylab", "ins_seg_mylab")
    os.makedirs(pdir)
    rs = np.random.RandomState(4)
    for i in range(16):
        masks = np.zeros((2, 96, 96), bool)
        for m in masks:
            y, x = rs.randint(0, 60, 2)
            m[y:y + 30, x:x + 24] = True
        np.save(os.path.join(pdir, f"img_{i:03d}.npy"),
                {"mask": masks, "class": rs.randint(0, 20, 2)})
    return root


def assert_same_dataset(port, ref, epochs=(0, 1)):
    assert len(port) == len(ref)
    assert port.dataset.indices == ref.dataset.indices
    for epoch in epochs if port.train else (0,):
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            assert_same_sample(port[(epoch, i)], ref[i])
    if port.train and len(ref):
        ref.set_epoch(0)
        assert_same_sample(port[0], ref[0])


VOC_CASES = {
    "15-5 step 1": dict(task="15-5", step=1),
    "15-5 step 1 disjoint": dict(task="15-5", step=1, overlap=False),
    "15-5 step 1 no masking": dict(task="15-5", step=1, masking=False),
    "15-5 step 0": dict(task="15-5", step=0),
    "10-5 step 1": dict(task="10-5", step=1),
    "10-5 step 1 disjoint": dict(task="10-5", step=1, overlap=False),
    "15-1 step 2 no masking": dict(task="15-1", step=2, masking=False),
    "15-5 step 1 pseudo": dict(task="15-5", step=1, masking=False,
                               pseudo="mylab"),
    "15-5 step 1 val on train": dict(task="15-5", step=1,
                                     val_on_trainset=True),
    "coco-voc step 1 as_coco": dict(dataset="coco-voc", task="voc", step=1,
                                    as_coco=True),
}


@pytest.mark.parametrize("case", sorted(VOC_CASES))
def test_voc_datasets_match_jax(rich_voc, case):
    """make_voc_datasets: every index of the train set at epochs 0 and 1,
    and of the validation set, equal in both packages."""
    kw = dict(VOC_CASES[case])
    ds, task, step = kw.pop("dataset", "voc"), kw.pop("task"), kw.pop("step")
    args = (rich_voc, tasks.get_task_dict(ds, task, step), step)
    assert args[1] == jax_tasks.get_task_dict(ds, task, step)
    kw.update(crop_size=64, crop_size_val=48, seed=5)
    p_train, p_val = voc.make_voc_datasets(*args, **kw)
    j_train, j_val = jax_voc.make_voc_datasets(*args, **kw)
    assert_same_dataset(p_train, j_train)
    assert_same_dataset(p_val, j_val)
    if len(p_train):
        assert not np.array_equal(p_train[(0, 0)]["image"],
                                  p_train[(1, 0)]["image"])


def test_voc_raw_dataset_and_filter_match_jax(rich_voc):
    ann = os.path.join(rich_voc, "voc", "pascal_sbd_train.json")
    for train in (True, False):
        for overlap in (True, False):
            args = (rich_voc, ann, list(range(1, 11)), [11, 12, 13, 14, 15])
            kw = dict(is_train=train, overlap=overlap)
            p = voc.VOCInstanceSegmentation(*args, **kw)
            j = jax_voc.VOCInstanceSegmentation(*args, **kw)
            assert p.indices == j.indices
            for i in range(len(p)):
                assert_same_sample(p[i], j[i])
    anno = [{"category_id": c} for c in (3, 17)]
    for overlap in (True, False):
        for train in (True, False):
            assert voc.check_if_insert(anno, overlap, [3, 4], [4], train) == \
                jax_voc.check_if_insert(anno, overlap, [3, 4], [4], train)
    inst = np.random.RandomState(0).choice([0, 3, 7, 255], (9, 9))
    np.testing.assert_array_equal(voc._dense_ids(inst),
                                  jax_voc._dense_ids(inst))


@pytest.mark.parametrize("indices", [None, [2, 0]])
def test_coco_datasets_match_jax(tmp_path, indices):
    root = str(tmp_path)
    _write_fake_coco(root, n_images=4)
    idx = None if indices is None else np.array(indices)
    for train in (True, False):
        p = coco.COCODataset(root, train=train, indices=idx)
        j = jax_coco.COCODataset(root, train=train, indices=idx)
        assert p.indices == j.indices
        for i in range(len(p)):
            assert_same_sample(p[i], j[i])
    sd = tasks.get_task_dict("coco-voc", "voc", 0)
    kw = dict(crop_size=32, crop_size_val=40, train_indices=idx, seed=2)
    p_train, p_val = coco.make_coco_datasets(root, sd, 0, **kw)
    j_train, j_val = jax_coco.make_coco_datasets(root, sd, 0, **kw)
    assert_same_dataset(p_train, j_train)
    assert_same_dataset(p_val, j_val)
    assert coco.IGNORE_LABELS == jax_coco.IGNORE_LABELS


# --------------------------------------------------------- coco-voc remap

def test_remap_voc_dir_matches_jax(tmp_path):
    assert cocovoc.COCO_MAP == jax_cocovoc.COCO_MAP
    np.testing.assert_array_equal(cocovoc.VOC_TO_COCO_LUT,
                                  jax_cocovoc.VOC_TO_COCO_LUT)
    d_in = tmp_path / "in"
    d_in.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        lbl = rs.choice(list(range(21)) + [255], (12, 10)).astype(np.uint8)
        Image.fromarray(lbl).save(str(d_in / f"{i}.png"))
    (d_in / "notes.txt").write_text("skipped")
    assert cocovoc.remap_voc_dir(str(d_in), str(tmp_path / "p")) == 3
    assert jax_cocovoc.remap_voc_dir(str(d_in), str(tmp_path / "j")) == 3
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "p"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "p" / name)),
            np.asarray(Image.open(tmp_path / "j" / name)))
    out = subprocess.run(
        [sys.executable, "-m", "cl4wsis_tpu_torch.data.cocovoc", str(d_in),
         str(tmp_path / "m")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0 and "3 files remapped" in out.stdout


# ------------------------------------------------------ shipped assets

@pytest.mark.parametrize("ds", ["coco", "coco-voc"])
def test_shipped_split_assets_load_identically(monkeypatch, ds):
    """The CLI's build_data of both packages resolves the same shipped
    train-{step}.npy under data/ and hands the same indices to the COCO
    factory."""
    from cl4wsis_tpu.cli import main as jax_cli
    from cl4wsis_tpu.cli.config import parse_config as jax_parse
    from cl4wsis_tpu_torch.cli import main as cli
    from cl4wsis_tpu_torch.cli.config import parse_config

    seen = {}

    def capture(tag):
        def factory(root, step_dict, step, crop, crop_val, train_indices,
                    seed):
            seen[tag] = (step_dict, step, crop, crop_val, train_indices, seed)
            raise StopIteration
        return factory

    monkeypatch.setattr(cli, "make_coco_datasets", capture("port"))
    monkeypatch.setattr(jax_coco, "make_coco_datasets", capture("jax"))
    argv = ["--data_root", os.path.join(REPO, "data"), "--dataset", ds,
            "--task", "voc", "--step", "0"]
    for build, cfg in ((cli.build_data, parse_config(argv)),
                       (jax_cli.build_data, jax_parse(argv))):
        with pytest.raises(StopIteration):
            build(cfg)
    p, j = seen["port"], seen["jax"]
    assert p[:4] == j[:4] and p[5] == j[5]
    assert p[4].shape == (23274,)
    np.testing.assert_array_equal(p[4], j[4])
    np.testing.assert_array_equal(p[4], np.load(os.path.join(
        REPO, "data", ds, "voc", "train-0.npy")))
