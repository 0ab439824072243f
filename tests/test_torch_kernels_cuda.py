"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, so every worker collects the same tests). On a machine with a card
and no JAX (tests/conftest.py imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.ops import cc, kernels, labelgen, segsort, topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _maps(rs):
    lo = rs.randint(0, 6, (17, 23))
    yield np.kron(lo, np.ones((8, 8), np.int64))[:130, :181]
    m = rs.randint(1, 4, (96, 64))
    m[rs.rand(96, 64) < 0.5] = 0
    yield m
    yield np.ones((1, 300), np.int64)
    yield -np.ones((7, 5), np.int64)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_cc_kernel_equals_plain(dev, connectivity):
    rs = np.random.RandomState(connectivity)
    for m in _maps(rs):
        t = torch.from_numpy(m.astype(np.int32)).to(dev)
        n = kernels.LAUNCHES["cc_multilabel"]
        got = cc.connected_components_multilabel(t, connectivity)
        assert kernels.LAUNCHES["cc_multilabel"] == n + 1
        assert torch.equal(got, cc.cc_multilabel_plain(t, connectivity))
    batch = torch.from_numpy(rs.randint(0, 3, (3, 40, 50)).astype(np.int32))
    got = cc.connected_components_multilabel(batch.to(dev), connectivity)
    assert torch.equal(got.cpu(), cc.cc_multilabel_plain(batch, connectivity))


@pytest.mark.parametrize("B,N,k", [(20, 262144, 32), (3, 4096, 7),
                                   (2, 4097, 64), (5, 100, 100), (1, 9000, 1)])
def test_topk_kernel_equals_plain(dev, B, N, k):
    rs = np.random.RandomState(N)
    x = rs.rand(B, N).astype(np.float32)
    x[0] = -1.0
    x[0, rs.choice(N, min(N, 40), replace=False)] = 0.5
    if B > 1:
        x[1, rs.rand(N) < 0.3] = -np.inf
        x[1, :3] = -0.0
    t = torch.from_numpy(x).to(dev)
    gv, gi = topk.topk_hier(t, k)
    pv, pi = topk.topk_plain(t, k)
    assert torch.equal(gi, pi) and torch.equal(gv, pv)


def _topk_rows(name, B, N, rs):
    x = rs.rand(B, N).astype(np.float32)
    if name == "all_equal":
        x[:] = 0.25
    elif name == "all_neginf":
        x[:] = -np.inf
    elif name == "signed_zeros":
        x[:] = 0.0
        x[rs.rand(B, N) < 0.5] = -0.0
    elif name == "ties_straddle_segments":
        # equal maxima across the 8192-key segment edges: lower columns win
        x[:, 8190:8195] = 2.0
        x[:, 16380:16390] = 2.0
        x[1] = 1.0
    elif name == "peak_rows":
        x[:] = 0.0
        for b in range(B):
            x[b, rs.choice(N, rs.randint(0, 40), replace=False)] = rs.rand()
    return x


@pytest.mark.parametrize("name,B,N,k", [
    ("all_equal", 3, 20000, 25), ("all_neginf", 2, 20000, 16),
    ("signed_zeros", 2, 20000, 32), ("ties_straddle_segments", 2, 24581, 4),
    ("ties_straddle_segments", 2, 24581, 25), ("n_below_segment", 3, 5000, 25),
    ("k_equals_n", 2, 1024, 1024), ("k_at_limit", 2, 262144, 1024),
    ("k_at_limit", 3, 9000, 1024), ("peak_rows", 80, 262144, 25)])
def test_topk_kernel_trouble_spots(dev, name, B, N, k):
    """Bit-equal to the plain version on the rows the select finds hard."""
    t = torch.from_numpy(_topk_rows(name, B, N, np.random.RandomState(k))
                         ).to(dev)
    n = kernels.LAUNCHES["topk"]
    gv, gi = topk.topk_hier(t, k)
    assert kernels.LAUNCHES["topk"] == n + 1
    pv, pi = topk.topk_plain(t, k)
    assert torch.equal(gi, pi)
    assert torch.equal(gv.view(torch.int32), pv.view(torch.int32))


def test_topk_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros(2, 10000, device=dev)
    with pytest.raises(ValueError):
        topk.topk_cuda(x, 4096)
    with pytest.raises(ValueError):
        topk.topk_cuda(x, 1025)             # one past the limit of 1024
    with pytest.raises(ValueError):
        topk.topk_cuda(x[:, :10].contiguous(), 11)
    with pytest.raises(TypeError):
        topk.topk_cuda(x.double(), 4)


@pytest.mark.parametrize("B,N,n_keys", [(1, 262144, 3000), (16, 262144, 40000),
                                        (3, 1000, 7), (2, 1, 1), (1, 5000, 1)])
def test_run_totals_kernel_equals_plain(dev, B, N, n_keys):
    rs = np.random.RandomState(B * N)
    keys = np.sort(rs.randint(0, n_keys, (B, N)), axis=1).astype(np.int32)
    vals = [rs.randint(-2 ** 20, 2 ** 20, (B, N)).astype(np.int32)
            for _ in range(3)]
    args = [torch.from_numpy(a).to(dev) for a in [keys] + vals]
    for g, w in zip(segsort.run_totals(*args), segsort.run_totals_plain(*args)):
        assert torch.equal(g, w)


def border_slots(rs, B, K, H, W, C):
    """Random slots plus one on every border and corner, off-plane centers,
    invalid slots and class ids out of range."""
    cy = rs.uniform(0, H, (B, K)).astype(np.float32)
    cx = rs.uniform(0, W, (B, K)).astype(np.float32)
    edge_y = [0.0, H - 0.5, 0.0, H - 1, 0.2, H - 1, H / 2, H / 2]
    edge_x = [0.0, 0.0, W - 0.5, W - 1, W / 2, W / 2, 0.7, W - 0.1]
    cy[:, :8], cx[:, :8] = edge_y, edge_x
    cy[:, 8:12] = [-1.0, H + 0.5, 10.0, -0.001]
    cx[:, 8:12] = [10.0, 10.0, W + 3.0, 10.0]
    cls = rs.randint(0, C, (B, K)).astype(np.int32)
    cls[:, 12], cls[:, 13] = C + 5, -3
    valid = rs.rand(B, K) > 0.25
    valid[:, :14] = True
    return valid, cy, cx, cls


@pytest.mark.parametrize("sigma,K,shape", [(6, 64, (512, 512)),
                                           (6, 120, (512, 512)),
                                           (30, 16, (200, 333)),
                                           (1, 16, (7, 9))])
def test_stamp_kernel_equals_plain(dev, sigma, K, shape):
    """Bit-equal, launched once; sigma 30 is past the Pallas kernel's
    limit of 21."""
    rs = np.random.RandomState(sigma + K)
    H, W = shape
    B, C = 3, 20
    args = [torch.from_numpy(a).to(dev)
            for a in border_slots(rs, B, K, H, W, C)]
    n = kernels.LAUNCHES["stamp"]
    got = labelgen.stamp_centers_batched(*args, C, sigma, shape)
    assert kernels.LAUNCHES["stamp"] == n + 1
    want = labelgen.stamp_centers(*args, C, sigma, shape)
    assert got.shape == (B, C, H, W)
    assert torch.equal(got, want)
    assert got.max() == 1.0


def test_stamp_kernel_rejects_what_it_cannot_take(dev):
    z = torch.zeros((1, 2000), device=dev)
    with pytest.raises(ValueError):
        labelgen.stamp_centers_cuda(z > 0, z, z, z.int(), 3, 6, (32, 32))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_cc_binary_kernel_equals_plain(dev, connectivity):
    rs = np.random.RandomState(10 + connectivity)
    masks = [rs.rand(130, 181) < 0.45, np.kron(rs.rand(20, 20) < 0.5,
                                               np.ones((9, 9), bool)),
             np.ones((1, 300), bool), np.zeros((7, 5), bool)]
    for m in masks:
        for t in (torch.from_numpy(m), torch.from_numpy(m.astype(np.uint8) * 3)):
            t = t.to(dev)
            n = kernels.LAUNCHES["cc_binary"]
            got = cc.connected_components(t, connectivity)
            assert kernels.LAUNCHES["cc_binary"] == n + 1
            assert torch.equal(got, cc.cc_binary_plain(t, connectivity))
    batch = torch.from_numpy(rs.rand(3, 40, 50) < 0.5).to(dev)
    assert torch.equal(cc.connected_components(batch, connectivity),
                       cc.cc_binary_plain(batch, connectivity))


def _spiral(n):
    """One-pixel corridor wound inward: union chains that cross every
    tile."""
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


def _cc_trouble_map(name, rs):
    if name == "non_multiple":       # neither side a multiple of 32
        return np.kron(rs.randint(0, 5, (15, 11)), np.ones((7, 7), int)
                       )[:100, :77]
    if name == "row":
        return (rs.rand(1, 300) < 0.8) * rs.randint(1, 3, (1, 300))
    if name == "column":
        return (rs.rand(300, 1) < 0.8) * rs.randint(1, 3, (300, 1))
    if name == "spiral":
        return _spiral(200)
    if name == "tile_edges":         # classes change exactly on tile edges
        m = np.kron(rs.randint(0, 3, (5, 6)), np.ones((32, 32), int))
        m[::7, :] = 1                 # and lines across many tile edges
        m[:, 31::33] = 2
        return m
    # planes of a batch, each one component touching the plane's edges:
    # they must not unite across the plane boundary
    m = np.ones((4, 64, 70), int)
    m[1, 30:34, :] = 0
    m[2] = rs.randint(0, 2, (64, 70))
    return m


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", ["non_multiple", "row", "column", "spiral",
                                  "tile_edges", "batch"])
def test_cc_kernels_trouble_spots(dev, name, connectivity):
    """Both CC kernels bit-equal to their plain versions where the tiled
    passes meet their edges."""
    m = torch.from_numpy(_cc_trouble_map(name, np.random.RandomState(7))
                         .astype(np.int32)).to(dev)
    assert torch.equal(cc.connected_components_multilabel(m, connectivity),
                       cc.cc_multilabel_plain(m, connectivity))
    assert torch.equal(cc.connected_components(m > 0, connectivity),
                       cc.cc_binary_plain(m > 0, connectivity))
