"""The port's plain ops (cl4wsis_tpu_torch.ops, CPU path) against the JAX
package on the same seeded inputs. Integer outputs must be equal exactly;
float tolerances are stated where they apply."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.ops import pallas_seg as jseg
from cl4wsis_tpu.ops import segsort as jss
from cl4wsis_tpu.ops.cc import connected_components_multilabel as jcc
from cl4wsis_tpu.ops.peaks import max_pool_same as jpool
from cl4wsis_tpu.ops.pseudo_labels import component_stats as jstats
from cl4wsis_tpu.ops.resize import resize_bilinear_nchw as jresize
from cl4wsis_tpu.ops.topk import topk_hier as jtopk
from cl4wsis_tpu_torch.ops import cc, segsort
from cl4wsis_tpu_torch.ops.peaks import max_pool_same
from cl4wsis_tpu_torch.ops.pseudo_labels import component_stats
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.ops.topk import topk_hier, topk_plain
from torch_one_thread import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")


# ----------------------------------------------------------- class maps

def blobby(H, W, C, seed):
    """Low-resolution random classes blown up to (H, W), about half
    background: large blobs of many classes with shared borders."""
    rs = np.random.RandomState(seed)
    lo = rs.randint(1, C + 1, (H // 8 + 1, W // 8 + 1))
    lo[rs.rand(*lo.shape) < 0.5] = 0
    return np.kron(lo, np.ones((8, 8), np.int64))[:H, :W].astype(np.int32)


def speckle(H, W, C, seed):
    rs = np.random.RandomState(seed)
    m = rs.randint(1, C + 1, (H, W))
    m[rs.rand(H, W) < 0.5] = 0
    return m.astype(np.int32)


def spiral(n):
    """One-pixel corridor wound inward with one-pixel gaps: the longest
    geodesic a square plane holds."""
    m = np.zeros((n, n), np.int32)
    y = x = d = turns = 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = 1
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead = 0 <= ay < n and 0 <= ax < n and m[ay, ax]
        if 0 <= ny < n and 0 <= nx < n and not m[ny, nx] and not ahead:
            y, x, turns = ny, nx, 0
            m[y, x] = 1
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def tile_edges(H, W, seed):
    """Classes that change exactly on 32-pixel edges, squares centred on
    the tile corners and a diagonal line (one component at connectivity 8
    only): components that cross the edges in both axes."""
    rs = np.random.RandomState(seed)
    m = np.kron(rs.randint(0, 4, (H // 32 + 1, W // 32 + 1)),
                np.ones((32, 32), np.int64))[:H, :W]
    for cy in range(32, H, 32):
        for cx in range(32, W, 32):
            m[cy - 5:cy + 5, cx - 5:cx + 5] = rs.randint(1, 4)
    d = np.arange(min(H, W))
    m[d, d] = 4
    return m.astype(np.int32)


CLASS_MAPS = {
    "blobby": lambda: blobby(64, 64, 20, 0),
    "speckle": lambda: speckle(64, 64, 3, 1),
    "spiral": lambda: spiral(64),
    "nonsquare": lambda: blobby(40, 72, 5, 2),
    "spiral_classes": lambda: spiral(48) * 3 + (spiral(48) == 0) * 2,
    "tile_edges": lambda: tile_edges(80, 100, 3),
}


def _canon(labels):
    """Map each label to the flat index of its first occurrence."""
    flat = np.asarray(labels).reshape(-1)
    _, first, inv = np.unique(flat, return_index=True, return_inverse=True)
    return first[inv].reshape(np.shape(labels))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(CLASS_MAPS))
def test_cc_multilabel_matches_jax_and_cv2(name, connectivity):
    m = CLASS_MAPS[name]()
    H, W = m.shape
    got = cc.connected_components_multilabel(torch.from_numpy(m),
                                             connectivity).numpy()
    assert got.dtype == np.int32
    want = np.asarray(jcc(jnp.asarray(m), connectivity=connectivity,
                          num_iters=64))
    np.testing.assert_array_equal(got, want)
    # against cv2, class by class: same partition, root = min flat index
    assert (got[m <= 0] == H * W).all()
    for c in np.unique(m[m > 0]):
        mask = (m == c).astype(np.uint8)
        _, ref = cv2.connectedComponents(mask, connectivity=connectivity)
        fg = mask.astype(bool)
        np.testing.assert_array_equal(_canon(got[fg]), _canon(ref[fg]))
        flat = np.arange(H * W).reshape(H, W)
        for r in np.unique(got[fg]):
            assert r == flat[got == r].min()


def test_cc_multilabel_batched_equals_planes():
    planes = np.stack([blobby(32, 48, 4, s) for s in range(3)] +
                      [speckle(32, 48, 2, 9)])
    got = cc.connected_components_multilabel(torch.from_numpy(planes),
                                             8).numpy()
    for p, g in zip(planes, got):
        np.testing.assert_array_equal(
            g, cc.connected_components_multilabel(torch.from_numpy(p),
                                                  8).numpy())


# ------------------------------------------------------------------ top-k

def _topk_rows(N, seed):
    rs = np.random.RandomState(seed)
    rows = [rs.rand(N)]
    r = np.full(N, -1.0)                           # NMS-like: -1 fill
    r[rs.choice(N, 40, replace=False)] = rs.choice([0.5, 0.9, 0.9, 0.7], 40)
    rows.append(r)
    r = np.full(N, -1.0)                           # fewer than k survivors
    r[[5, 999, N - 1]] = [0.3, 0.8, 0.3]
    rows.append(r)
    r = np.full(N, -np.inf)                        # -inf, few finite
    r[[7, 77, N - 2]] = [0.1, -2.0, 0.1]
    rows.append(r)
    r = rs.rand(N)                                 # 100-way tie at the top
    r[200:300] = 2.0
    rows.append(r)
    r = np.zeros(N)                                # signed zeros
    r[rs.rand(N) < 0.5] = -0.0
    r[[3, 4]] = -1.0
    rows.append(r)
    rows.append(np.full(N, -np.inf))
    return np.stack(rows).astype(np.float32)


def _topk_case(case):
    """(rows, k): the mixed rows of `_topk_rows` at N 8192 and 3000; rows
    of one value each; equal maxima straddling index 8192 (the kernel's
    segment edge); k = N."""
    if case in ("8192", "3000"):
        return _topk_rows(int(case), 0), 32
    if case == "all_equal":
        x = np.full((3, 9000), 0.25, np.float32)
        x[1], x[2] = -1.0, -0.0
        return x, 32
    if case == "straddle_8192":
        x = np.random.RandomState(1).rand(2, 16384).astype(np.float32)
        x[:, 8180:8200] = 2.0
        x[1, 8192:8200] = 3.0
        return x, 32
    return _topk_rows(1000, 2), 1000                 # k_equals_n


@pytest.mark.parametrize("case", ["8192", "3000", "all_equal",
                                  "straddle_8192", "k_equals_n"])
def test_topk_matches_jax(case):
    x, k = _topk_case(case)
    gv, gi = topk_hier(torch.from_numpy(x), k)
    assert gi.dtype == torch.int32
    wv, wi = jtopk(jnp.asarray(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # signed zeros keep their order: +0.0 above -0.0, as lax.top_k
    lv, li = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(li))
    np.testing.assert_array_equal(np.signbit(gv.numpy()),
                                  np.signbit(np.asarray(lv)))
    for row in gi.numpy():
        assert len(set(row.tolist())) == len(row)


def test_topk_leading_dims():
    x = np.random.RandomState(3).rand(2, 3, 500).astype(np.float32)
    gv, gi = topk_hier(torch.from_numpy(x), 5)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert topk_plain(torch.from_numpy(x), 5)[0].shape == (2, 3, 5)


# ------------------------------------------------------------- run totals

def _sorted_rows(B, N, seed, n_keys):
    rs = np.random.RandomState(seed)
    keys = np.sort(rs.randint(0, n_keys, (B, N)), axis=1).astype(np.int32)
    vals = [rs.randint(-1000, 1000, (B, N)).astype(np.int32)
            for _ in range(3)]
    return keys, vals


@pytest.mark.parametrize("B,N,n_keys", [(3, 1024, 50), (2, 1000, 7),
                                        (1, 513, 1), (4, 256, 100000)])
def test_run_totals_matches_jax(B, N, n_keys):
    keys, vals = _sorted_rows(B, N, B * N, n_keys)
    got = segsort.run_totals(torch.from_numpy(keys),
                             *(torch.from_numpy(v) for v in vals))
    want = jax.jit(jseg.run_totals)(jnp.asarray(keys),
                                    *(jnp.asarray(v) for v in vals))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_segsort_helpers_match_jax():
    keys, (v, _, _) = _sorted_rows(1, 700, 5, 30)
    k, v = keys[0], v[0]
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for port, ref in ((segsort.run_starts(tk), jss.run_starts(jnp.asarray(k))),
                      (segsort.run_ends(tk), jss.run_ends(jnp.asarray(k)))):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    starts, ends = jss.run_starts(jnp.asarray(k)), jss.run_ends(jnp.asarray(k))
    np.testing.assert_array_equal(
        segsort.seg_total(tv, segsort.run_starts(tk)).numpy(),
        np.asarray(jax.jit(jss.seg_total)(jnp.asarray(v), starts, ends)))
    np.testing.assert_array_equal(
        segsort.seg_length(segsort.run_starts(tk)).numpy(),
        np.asarray(jax.jit(jss.seg_length)(starts, ends)))


@pytest.mark.parametrize("p,k", [(0.01, 16), (0.3, 16), (0.0, 4)])
def test_select_flagged_matches_jax(p, k):
    flags = np.random.RandomState(int(p * 100)).rand(500) < p
    got = segsort.select_flagged(torch.from_numpy(flags), k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jss.select_flagged(jnp.asarray(flags), k)))
    rows = np.stack([flags, flags[::-1]])
    got2 = segsort.select_flagged(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(got2[1].numpy(), np.asarray(
        jss.select_flagged(jnp.asarray(rows[1]), k)))


# ------------------------------------------- pooling, resize, statistics

def test_max_pool_same_k41_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.rand(1, 50, 70, 3).astype(np.float32)
    x[x < 0.9] = -1.0
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 41)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jpool(jnp.asarray(x), 41)))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("size", [(32, 20), (5, 7), (9, 13)])
def test_resize_bilinear_matches_jax(align, size):
    """float32 interpolation in two different orders: atol 1e-5."""
    x = np.random.RandomState(5).randn(2, 3, 9, 13).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), size, align).numpy()
    want = np.asarray(jresize(jnp.asarray(x), size, align))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_component_stats_matches_jax():
    m = blobby(48, 40, 6, 7)
    roots = cc.connected_components_multilabel(torch.from_numpy(m), 8)
    rs = np.random.RandomState(8)
    q = np.concatenate([roots.numpy().reshape(-1)[rs.choice(48 * 40, 30)],
                        [48 * 40, 0, 5]]).astype(np.int32)
    got = component_stats(roots, torch.from_numpy(q))
    want = jstats(jnp.asarray(roots.numpy()), jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
