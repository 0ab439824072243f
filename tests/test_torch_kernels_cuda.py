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


def _runs(lengths):
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


def _run_totals_keys(name, tile, rs):
    if name == "single_run":
        return np.full((3, 5 * tile + 40), 11, np.int32)
    if name == "single_run_262144":
        return np.zeros((16, 262144), np.int32)
    if name == "all_distinct":
        return np.arange(3 * tile + 8, dtype=np.int32)[None].repeat(2, 0)
    if name == "runs_of_one_tile":
        return _runs([tile] * 5)[None]
    if name == "runs_of_tile_plus_one":
        return _runs([tile + 1] * 5)[None]
    if name == "runs_of_tile_minus_one":
        return _runs([tile - 1] * 5)[None]
    if name == "run_ends_on_tile_edges":
        return _runs([tile // 2, tile // 2, 40 * tile, 1, tile - 1, 2 * tile,
                      5])[None]
    if name == "n_tile_minus_1":
        return np.sort(rs.randint(0, 9, (2, tile - 1))).astype(np.int32)
    if name == "n_tile_plus_1":
        return np.sort(rs.randint(0, 9, (2, tile + 1))).astype(np.int32)
    if name == "n_odd":
        return np.sort(rs.randint(0, 700, (5, 70001))).astype(np.int32)
    if name == "many_rows":          # more rows than a grid's y extent
        return np.sort(rs.randint(0, 3, (70000, 12))).astype(np.int32)
    if name == "step_like":          # short runs, then one run at the top key
        rows = []
        for _ in range(16):
            short = rs.randint(10, 41, 1200)
            keys = np.repeat(3 * np.arange(1200), short)[:rs.randint(
                2000, 26000)]
            rows.append(np.concatenate(
                [keys, np.full(262144 - len(keys), 262144)]))
        return np.stack(rows).astype(np.int32)
    raise KeyError(name)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("name", [
    "single_run", "single_run_262144", "all_distinct", "runs_of_one_tile",
    "runs_of_tile_plus_one", "runs_of_tile_minus_one",
    "run_ends_on_tile_edges", "n_tile_minus_1", "n_tile_plus_1", "n_odd",
    "many_rows", "step_like"])
def test_run_totals_kernel_trouble_spots(dev, name, wrap):
    """Bit-equal where runs meet the tiles' edges, cross many tiles or fill
    a row; with `wrap`, payloads near +-2^30 whose run sums wrap int32."""
    rs = np.random.RandomState(len(name) + wrap)
    tile = kernels.lib().cl4_run_totals_tile()
    keys = _run_totals_keys(name, tile, rs)
    if wrap:
        vals = [(rs.choice([-1, 1], keys.shape) *
                 (2 ** 30 - rs.randint(0, 9, keys.shape))).astype(np.int32)
                for _ in range(2)] + [np.full(keys.shape, 2 ** 30, np.int32)]
    else:
        vals = [rs.randint(0, 512, keys.shape).astype(np.int32)
                for _ in range(3)]
    args = [torch.from_numpy(a).to(dev) for a in [keys] + vals]
    n = kernels.LAUNCHES["run_totals"]
    got = segsort.run_totals(*args)
    assert kernels.LAUNCHES["run_totals"] == n + 1
    for g, w in zip(got, segsort.run_totals_plain(*args)):
        assert torch.equal(g, w)


def test_built_kernels_have_the_emulated_shapes(dev):
    """The library that was built carries the block shapes that the numpy
    emulations of tests/test_torch_kernel_designs.py run at."""
    lib = kernels.lib()
    assert lib.cl4_run_totals_tile() == 256 * 4
    assert lib.cl4_run_totals_desc() == 8
    assert lib.cl4_stamp_max_slots() == 1024


def test_run_totals_kernel_rejects_what_it_cannot_take(dev):
    k = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        segsort.run_totals_cuda(k.long(), k, k, k)
    with pytest.raises(ValueError):
        segsort.run_totals_cuda(k, k[:, :32].contiguous(), k, k)
    with pytest.raises(ValueError):
        segsort.run_totals_cuda(k.cpu(), k, k, k)


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


def _stamp_slots(name, rs, B, K, H, W, C):
    cy = rs.uniform(0, H, (B, K)).astype(np.float32)
    cx = rs.uniform(0, W, (B, K)).astype(np.float32)
    cls = rs.randint(0, C, (B, K)).astype(np.int32)
    valid = np.ones((B, K), bool)
    if name == "few_valid":          # the step's pseudo stamp
        valid[:] = False
        for b in range(B):
            valid[b, rs.choice(K, rs.randint(1, 4), replace=False)] = True
    elif name == "all_invalid":      # the step's refined stamp
        valid[:] = False
    elif name == "one_tile":         # every slot on one tile, one channel
        cy[:] = rs.uniform(16, 32, (B, K))
        cx[:] = rs.uniform(64, 128, (B, K))
        cls[:] = 2
    return valid, cy, cx, cls


@pytest.mark.parametrize("name,sigma,B,K,shape,C", [
    ("few_valid", 6, 16, 64, (512, 512), 20),
    ("all_invalid", 6, 16, 120, (512, 512), 20),
    ("one_tile", 6, 2, 120, (512, 512), 20),
    ("one_tile", 2, 2, 1024, (128, 256), 4),
    ("random", 6, 2, 1024, (256, 256), 20),
    ("random", 6, 2, 0, (64, 64), 3),
    ("random", 30, 16, 120, (512, 512), 20),
    ("random", 6, 3, 40, (100, 130), 5),      # W % 4 == 2
    ("random", 2, 1, 30, (8, 8), 70000),      # more planes than 65535
])
def test_stamp_kernel_trouble_spots(dev, name, sigma, B, K, shape, C):
    """Bit-equal on the train step's two slot sets, with every slot on one
    tile, with the slot list full and empty, past the staged template, off
    16-byte rows and past the old limit on planes."""
    rs = np.random.RandomState(sigma + K)
    H, W = shape
    args = [torch.from_numpy(a).to(dev)
            for a in _stamp_slots(name, rs, B, K, H, W, C)]
    n = kernels.LAUNCHES["stamp"]
    got = labelgen.stamp_centers_batched(*args, C, sigma, shape)
    assert kernels.LAUNCHES["stamp"] == n + 1
    assert torch.equal(got, labelgen.stamp_centers(*args, C, sigma, shape))


def test_stamp_kernel_takes_an_unaligned_output(dev):
    """The scalar path when W is a multiple of 4 but rows are not: the
    kernel is handed a view one float into a larger buffer."""
    rs = np.random.RandomState(5)
    B, K, C, H, W = 2, 30, 3, 40, 64
    args = [torch.from_numpy(a).to(dev)
            for a in _stamp_slots("random", rs, B, K, H, W, C)]
    iy, ix, sel = (t.contiguous() for t in
                   labelgen._fold_slots(*args, C, (H, W)))
    tmpl = labelgen._template(6, dev)
    buf = torch.full((B * C * H * W + 1,), -1.0, device=dev)
    out = buf[1:]
    err = kernels.lib().cl4_stamp(
        kernels.ptr(iy), kernels.ptr(ix), kernels.ptr(sel), kernels.ptr(tmpl),
        kernels.ptr(out), B, K, C, H, W, 19, kernels.stream_of(out))
    assert err == 0
    want = labelgen.stamp_centers(*args, C, 6, (H, W))
    assert torch.equal(out.view(B, C, H, W), want) and buf[0] == -1.0


def test_stamp_kernel_rejects_what_it_cannot_take(dev):
    z = torch.zeros((1, 2000), device=dev)
    with pytest.raises(ValueError):
        labelgen.stamp_centers_cuda(z > 0, z, z, z.int(), 3, 6, (32, 32))
    z = torch.zeros((1, 4), device=dev)
    with pytest.raises(ValueError):
        labelgen.stamp_centers_cuda(z > 0, z, z, z.int(), 3, -1, (32, 32))
    with pytest.raises(ValueError):
        labelgen.stamp_centers_cuda(z > 0, z, z[:, :2], z.int(), 3, 6, (32, 32))


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


@pytest.mark.parametrize("max_inst", [50, 6])
def test_step0_targets_on_the_card_equal_the_cpu(dev, max_inst):
    """batched_label_generation on the card (one stamp launch) against the
    same call on the CPU (the plain stamp): the slot statistics, offsets
    and weights exactly, the centers bit for bit against the plain stamp
    on the card's own slots and within an ulp of the CPU's exp."""
    from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
    b = next(synthetic_batches(4, 128, 15, seed=max_inst))
    seg, inst = torch.from_numpy(b["seg"]), torch.from_numpy(b["inst"])
    inst[:, :3, :5] = 255
    inst[0, 60:70, 60:70] = 9                       # above max_inst = 6
    n = kernels.LAUNCHES["stamp"]
    got = labelgen.batched_label_generation(seg.to(dev), inst.to(dev), 15, 6,
                                            max_inst)
    assert kernels.LAUNCHES["stamp"] == n + 1
    want = labelgen.batched_label_generation(seg, inst, 15, 6, max_inst)
    stats = labelgen.batched_instance_stats(inst.to(dev), seg.to(dev),
                                            max_inst)
    for g, w in zip(stats, labelgen.batched_instance_stats(inst, seg,
                                                           max_inst)):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0], labelgen.stamp_centers(
        stats[0] > 0, *stats[1:], 15, 6, (128, 128)))
    assert (got[0].cpu() - want[0]).abs().max() <= 1e-6
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])


def test_tiny_chain_on_the_card_launches_the_kernels(dev, tmp_path):
    """The CLI's three stages at a tiny size on the card, 4 synthetic
    batches an epoch: step 0 launches the stamp once a step, phase 1 no
    kernel, phase 2 CC / top-k / run totals / stamp 2 / 2 / 1 / 2 times a
    step."""
    from cl4wsis_tpu_torch.cli.main import main
    root = str(tmp_path / "ck")
    common = ["--synthetic", "--tiny", "--dataset", "voc", "--task", "15-5",
              "--batch_size", "2", "--crop_size", "64", "--dtype",
              "bfloat16", "--kernel", "15", "--epochs", "1", "--device",
              "cuda", "--checkpoint", root, "--visualize", "false"]
    step0 = f"{root}/step/voc-15-5-ov/exp_0"
    runs = {
        "step0": ["--step", "0", "--name", "exp", "--bce", "--optim", "adam",
                  "--lr", "5e-5"],
        "phase1": ["--step", "1", "--name", "p1", "--weakly", "--phase", "1",
                   "--optim", "sgd", "--lr", "1e-3", "--lr_policy", "warmup",
                   "--loss_de", "1", "--affinity", "--pseudo_ep", "0",
                   "--step_ckpt", step0],
        "phase2": ["--step", "1", "--name", "p2", "--weakly", "--phase", "2",
                   "--optim", "adam", "--lr", "5e-5", "--step_ckpt", step0,
                   "--seg_ckpt", f"{root}/step/voc-15-5-ov/p1_1"]}
    none = dict.fromkeys(kernels.LAUNCHES, 0)
    want = {"step0": dict(none, stamp=4), "phase1": none,
            "phase2": dict(none, cc_multilabel=8, topk=8, run_totals=4,
                           stamp=8)}
    for name, argv in runs.items():
        kernels.reset_launches()
        assert main(common + argv) == 0
        assert dict(kernels.LAUNCHES) == want[name], name


def test_pinned_loader_batches_reach_the_card_without_pinning_again(
        dev, monkeypatch):
    """The loader pins its batches on a card machine; Trainer._device_batch
    copies them to the card without pinning them a second time."""
    import types

    from cl4wsis_tpu_torch.data.loader import Loader
    from cl4wsis_tpu_torch.train.trainer import Trainer

    class Samples(torch.utils.data.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, key):
            epoch, i = key
            rs = np.random.RandomState(100 * epoch + i)
            return {"image": rs.rand(16, 16, 3).astype(np.float32),
                    "seg": rs.randint(0, 3, (16, 16)).astype(np.int32),
                    "inst": rs.randint(0, 3, (16, 16)).astype(np.int32),
                    "l1h": rs.rand(20).astype(np.float32), "fname": "x"}

    batch = next(iter(Loader(Samples(), 4, num_workers=0,
                             pin_memory=True).epoch(0)))
    assert all(v.is_pinned() for v in batch.values())
    calls = []
    real = torch.Tensor.pin_memory

    def counting(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "pin_memory", counting)
    like = types.SimpleNamespace(cfg=types.SimpleNamespace(phase=None),
                                 supervised_pseudo=False, device=dev)
    got = Trainer._device_batch(like, batch)
    assert not calls and got.keys() == {"image", "seg", "inst"}
    for k, v in got.items():
        assert v.is_cuda and torch.equal(v.cpu(), batch[k])


def _blobby(rs, H, W, C, cell):
    lo = rs.randint(1, C + 1, (H // cell + 1, W // cell + 1))
    lo[rs.rand(*lo.shape) < 0.4] = 0
    return np.kron(lo, np.ones((cell, cell), np.int64))[:H, :W]


@pytest.mark.parametrize("kernel", ["cc", "topk", "run_totals", "stamp"])
def test_kernels_at_the_coco_voc_shapes(dev, kernel):
    """The COCO-to-VOC chain's shapes (WideResNet-38 at 448^2, 80 thing
    classes of which 20 new, a 512 x 683 validation image in its 704^2
    bucket): each wrapper launches its kernel once a call and equals the
    plain version bit for bit."""
    rs = np.random.RandomState(448)
    N, NV = 448 * 448, 704 * 704
    name = "cc_multilabel" if kernel == "cc" else kernel
    if kernel == "cc":
        maps = np.stack([_blobby(rs, 448, 448, 80, c) for c in (8, 16, 32,
                                                                64)] * 4)
        calls = [(torch.from_numpy(maps.astype(np.int32)), conn)
                 for conn in (4, 8)]
        v = _blobby(rs, 704, 704, 80, 16)
        v[512:], v[:, 683:] = 0, 0
        calls.append((torch.from_numpy(v.astype(np.int32)), 8))
        fn, plain = cc.connected_components_multilabel, cc.cc_multilabel_plain
    elif kernel == "topk":
        cam = rs.rand(320, N).astype(np.float32) ** 8
        nms = np.full((80, NV), -1.0, np.float32)
        nms[:, rs.choice(NV, 300, replace=False)] = 0.9
        calls = [(torch.from_numpy(cam), 25), (torch.from_numpy(cam), 16),
                 (torch.from_numpy(nms), 32)]
        fn, plain = topk.topk_hier, topk.topk_plain
    elif kernel == "run_totals":
        calls = [tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                       for a in [np.sort(rs.randint(0, n_keys, (nb, n)), 1)]
                       + [rs.randint(0, 512, (nb, n)) for _ in range(3)])
                 for nb, n, n_keys in ((16, N, 40000), (1, NV, 3000))]
        fn, plain = segsort.run_totals, segsort.run_totals_plain
    else:
        calls = [tuple(torch.from_numpy(a) for a in
                       border_slots(rs, 16, K, 448, 448, C)) + (C, 6,
                                                                  (448, 448))
                 for K, C in ((480, 80), (64, 80), (50, 60))]
        fn, plain = labelgen.stamp_centers_batched, labelgen.stamp_centers
    for args in calls:
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        n = kernels.LAUNCHES[name]
        got = fn(*args)
        assert kernels.LAUNCHES[name] == n + 1
        want = plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
