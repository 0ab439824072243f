"""The block algorithms of ``csrc/run_totals.cu`` and ``csrc/stamp.cu``,
emulated in numpy tile by tile as the kernels run them, against the plain
versions (``segsort.run_totals_plain``, ``labelgen.stamp_centers``).

A CUDA kernel cannot run without a card, but its logic can: the emulations
keep the kernels' structure (threads with their registers, warps with their
shuffles, the shared exchange, the descriptors, the second launch; the slot
binning, the channel mask, the empty and the covered path, 16-byte and
scalar stores), so an edge rule that is wrong here is wrong there. Every
output element must be written exactly once, inside its array, and 16-byte
stores must be aligned. Integers are compared exactly, the stamp bit for
bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.ops import labelgen, segsort
from torch_one_thread import one_torch_thread  # noqa: F401

CSRC = Path(labelgen.__file__).resolve().parents[1] / "csrc"


def _constants(source):
    """The `constexpr int kName = <integer>;` lines of a CUDA source."""
    text = (CSRC / source).read_text()
    return {m[1]: int(m[2]) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


# ---------------------------------------------------------------- run totals


FLAG = np.uint32(0x80000000)    # bit 31 of the count word: a boundary in the span


class RunTotalsEmulation:
    """csrc/run_totals.cu with `threads` threads of `items` elements. An
    aggregate is four uint32 (count, three sums) with the boundary flag in
    bit 31 of the count, as in the kernel."""

    def __init__(self, threads=64, items=4):
        assert threads % 32 == 0 and threads >= 64 and items % 4 == 0
        self.threads, self.items = threads, items
        self.tile = threads * items
        self.warps = threads // 32

    # -- warp primitives: arrays are (warps, 32, 4) -------------------------

    @staticmethod
    def bounded(v):
        return (v[..., 0] & FLAG) != 0

    @classmethod
    def chain(cls, far, near):
        """`far` enters from outside, `near` is the nearer span."""
        return np.where(cls.bounded(near)[..., None], near, near + far)

    @staticmethod
    def _shift(a, d, fwd):
        """Lane l reads lane l - d (fwd) or l + d; 0 where there is none
        (the kernel never uses what such a lane reads)."""
        out = np.zeros_like(a)
        if fwd:
            out[:, d:] = a[:, :-d]
        else:
            out[:, :-d] = a[:, d:]
        return out

    def warp_seg_scan(self, v, fwd, width=32):
        v = v.copy()
        lane = np.arange(32)
        d = 1
        while d < width:
            o = self._shift(v, d, fwd)
            has = (lane >= d) if fwd else (lane + d < width)
            v = np.where(has[None, :, None], self.chain(o, v), v)
            d *= 2
        return v

    def shift_one(self, v, fwd):
        return self._shift(v, 1, fwd)

    def warp_carry(self, agg, fwd):
        """What enters each warp from the warps on one side: every warp
        scans the (zero-padded) aggregates for itself, over the least power
        of two of lanes that holds them."""
        width = 1
        while width < self.warps:
            width *= 2
        v = np.zeros((1, 32, 4), np.uint32)
        v[0, :self.warps] = agg
        v = self.warp_seg_scan(v, fwd, width)
        out = np.zeros((self.warps, 4), np.uint32)
        for w in range(self.warps):
            none = w == 0 if fwd else w == self.warps - 1
            if not none:
                out[w] = v[0, w - 1 if fwd else w + 1]
        return out

    # -- the two launches ---------------------------------------------------

    def tile_pass(self, key, pay, row, tile, outs, written, desc, vec):
        T, I, N = self.threads, self.items, key.shape[1]
        j0 = tile * self.tile + np.arange(T) * I               # (T,)
        j = j0[:, None] + np.arange(I)[None, :]                # (T, I)
        valid = j < N
        jc = np.minimum(j, N - 1)
        k = np.where(valid, key[row, jc], 0)
        v = np.zeros((T, I, 4), np.uint32)
        v[..., 0] = valid
        for q in range(3):
            v[..., q + 1] = np.where(valid, pay[q][row, jc], 0).astype(np.uint32)
        halo_l = key[row, tile * self.tile - 1] if tile > 0 else 0
        last_j0 = j0[-1]
        halo_r = key[row, last_j0 + I] if last_j0 + I < N else 0
        s_first, s_last = k[:, 0], k[:, -1]
        prev = np.concatenate([[halo_l], s_last[:-1]])
        nxt = np.concatenate([s_first[1:], [halo_r]])

        left = np.concatenate([prev[:, None], k[:, :-1]], 1)
        right = np.concatenate([k[:, 1:], nxt[:, None]], 1)
        heads = (j >= N) | (j == 0) | (k != left)
        tails = (j >= N - 1) | (k != right)

        tot = np.zeros((T, I, 4), np.uint32)
        fa = np.zeros((T, 4), np.uint32)
        for i in range(I):
            fa = np.where(heads[:, i, None], 0, fa).astype(np.uint32) + v[:, i]
            tot[:, i] = fa
        ba = np.zeros((T, 4), np.uint32)
        for i in range(I - 1, -1, -1):
            ba = np.where(tails[:, i, None], 0, ba).astype(np.uint32)
            tot[:, i] += ba
            ba = ba + v[:, i]
        ff, bf = heads.any(1), tails.any(1)
        fa[:, 0] |= np.where(ff, FLAG, 0).astype(np.uint32)
        ba[:, 0] |= np.where(bf, FLAG, 0).astype(np.uint32)

        W = self.warps
        fin = self.warp_seg_scan(fa.reshape(W, 32, 4), True)
        bin_ = self.warp_seg_scan(ba.reshape(W, 32, 4), False)
        agg_f, agg_b = fin[:, 31].copy(), bin_[:, 0].copy()
        fin, bin_ = self.shift_one(fin, True), self.shift_one(bin_, False)
        wf, wb = self.warp_carry(agg_f, True), self.warp_carry(agg_b, False)
        fin = self.chain(wf[:, None], fin).reshape(T, 4)
        bin_ = self.chain(wb[:, None], bin_).reshape(T, 4)

        idx = np.arange(I)[None, :]
        first_head = np.where(ff, heads.argmax(1), I)
        last_tail = np.where(bf, I - 1 - tails[:, ::-1].argmax(1), -1)
        before = idx < first_head[:, None]
        after = idx > last_tail[:, None]
        unflag = np.array([~FLAG, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF],
                          np.uint32)
        tot = tot + np.where(before[..., None], (fin & unflag)[:, None],
                             0).astype(np.uint32)
        tot = tot + np.where(after[..., None], (bin_ & unflag)[:, None],
                             0).astype(np.uint32)
        opened = ((before & ~self.bounded(fin)[:, None]) |
                  (after & ~self.bounded(bin_)[:, None]))

        # descriptors, by thread 0 and the last thread
        desc[row, tile, :4] = (0 if heads[0, 0]
                               else self.chain(bin_[0], ba[0]) & unflag)
        desc[row, tile, 4:] = (0 if tails[-1, -1]
                               else self.chain(fin[-1], fa[-1]) & unflag)

        # closed elements, 16 bytes at a time where a group is whole
        for t in range(T):
            for g in range(I // 4):
                m = opened[t, 4 * g:4 * g + 4]
                at = j0[t] + 4 * g
                if vec and not m.any() and at + 4 <= N:
                    assert (row * N + at) % 4 == 0
                    lanes = range(4)
                elif not m.all():
                    lanes = [i for i in range(4) if not m[i] and at + i < N]
                else:
                    lanes = []
                for i in lanes:
                    assert at + i < N
                    for q in range(4):
                        outs[q][row, at + i] = tot[t, 4 * g + i, q]
                    written[row, at + i] += 1

    def chain_tiles(self, row_desc, tile, left):
        n_tiles = row_desc.shape[0]
        total = np.zeros(4, np.uint32)
        step = 0
        lane = np.arange(32)
        while True:
            s = tile - 1 - step - lane if left else tile + 1 + step + lane
            inside = (s >= 0) if left else (s < n_tiles)
            d = np.zeros((32, 8), np.uint32)
            d[inside] = row_desc[s[inside]]
            whole = inside & (d[:, 0] == self.tile) & (d[:, 4] > 0)
            stops = np.flatnonzero(~whole)
            last = stops[0] if stops.size else 31
            part = d[:, 4:] if left else d[:, :4]
            total = total + part[:last + 1].sum(0, dtype=np.uint32)
            if stops.size:
                return total
            step += 32
            assert step <= n_tiles + 32, "a chain ran off its row"

    def fix_up(self, row, tile, N, outs, written, desc, vec):
        d = desc[row, tile]
        l, r = d[:4], d[4:]
        if l[0] == 0 and r[0] == 0:
            return
        whole = l[0] == self.tile and r[0] > 0
        a = l + (self.chain_tiles(desc[row], tile, True) if l[0] else 0)
        b = r + (self.chain_tiles(desc[row], tile, False) if r[0] else 0)
        a, b = a.astype(np.uint32), b.astype(np.uint32)
        if whole:
            a = b = a + b - l
        n_left, from_right = int(l[0]), self.tile - int(r[0])
        at0 = tile * self.tile
        for e in range(0, self.tile, 4):
            all_a, all_b = e + 3 < n_left, e >= from_right
            if vec and (all_a or all_b):
                assert (row * N + at0 + e) % 4 == 0
                picks = [(i, a if all_a else b) for i in range(4)]
            else:
                picks = [(i, a if e + i < n_left else b) for i in range(4)
                         if e + i < n_left or e + i >= from_right]
            for i, val in picks:
                assert at0 + e + i < N
                for q in range(4):
                    outs[q][row, at0 + e + i] = val[q]
                written[row, at0 + e + i] += 1

    def __call__(self, key, v1, v2, v3):
        B, N = key.shape
        n_tiles = -(-N // self.tile)
        vec = N % 4 == 0
        outs = [np.full((B, N), 0xDEADBEEF, np.uint32) for _ in range(4)]
        written = np.zeros((B, N), np.int64)
        desc = np.full((B, n_tiles, 8), 0xDEADBEEF, np.uint32)
        with np.errstate(over="ignore"):
            for row in range(B):
                for tile in range(n_tiles):
                    self.tile_pass(key, (v1, v2, v3), row, tile, outs, written,
                                   desc, vec)
            for row in range(B):
                for tile in range(n_tiles):
                    self.fix_up(row, tile, N, outs, written, desc, vec)
        assert (written == 1).all(), "an element was left out or written twice"
        return [o.view(np.int32) for o in outs]


def _runs(lengths, first_key=0, step=1):
    """Sorted keys with the given run lengths."""
    keys = first_key + step * np.arange(len(lengths))
    return np.repeat(keys, lengths).astype(np.int32)


def _step_like(n, rs, share=0.92):
    """A row as the refinement passes it: short runs, then one run at the
    top key over most of the row."""
    short = []
    while sum(short) < int(n * (1 - share)):
        short.append(rs.randint(10, 41))
    keys = _runs(short, step=3)[:n]
    return np.concatenate([keys, np.full(n - len(keys), n, np.int32)])


RT_THREADS, RT_ITEMS, RT_DESC = 256, 4, 8   # the block shape of the .cu file
T = 256   # the small tile most cases run at: 64 threads of 4 elements


def test_run_totals_emulation_has_the_kernels_constants():
    c = _constants("run_totals.cu")
    assert (c["kThreads"], c["kItems"], c["kDesc"]) == (RT_THREADS, RT_ITEMS,
                                                        RT_DESC)


def _rt_case(name, rs, T=T):
    if name == "single_run":
        return np.full((2, 5 * T + 40), 7, np.int32)
    if name == "single_run_many_tiles":   # chains of several steps
        return np.full((1, 300 * T + 8), 7, np.int32)
    if name == "all_distinct":
        return np.arange(3 * T + 8, dtype=np.int32)[None].repeat(2, 0)
    if name == "runs_of_one_tile":
        return _runs([T] * 4)[None]
    if name == "runs_of_tile_plus_one":
        return _runs([T + 1] * 4)[None]
    if name == "runs_of_tile_minus_one":
        return _runs([T - 1] * 4)[None]
    if name == "run_ends_on_tile_edges":
        return _runs([T // 2, T // 2, 3 * T, 1, T - 1, 2 * T, 5])[None]
    if name == "n_1":
        return np.zeros((3, 1), np.int32)
    if name == "n_tile_minus_1":
        return np.sort(rs.randint(0, 9, (2, T - 1))).astype(np.int32)
    if name == "n_tile":
        return np.sort(rs.randint(0, 9, (2, T))).astype(np.int32)
    if name == "n_tile_plus_1":
        return np.sort(rs.randint(0, 9, (2, T + 1))).astype(np.int32)
    if name == "n_odd_scalar_path":
        return np.sort(rs.randint(0, 40, (3, 3 * T + 3))).astype(np.int32)
    if name == "uniform_short_runs":
        return np.sort(rs.randint(0, 600, (2, 4096))).astype(np.int32)
    if name == "step_like":
        return np.stack([_step_like(8192, rs) for _ in range(2)])
    if name == "one_run_but_the_ends":
        return _runs([1, 6 * T - 2, 1])[None]
    if name == "negative_keys":
        return np.sort(rs.randint(-5, 5, (2, 2 * T + 4))).astype(np.int32)
    raise KeyError(name)


RT_CASES = ["single_run", "single_run_many_tiles", "all_distinct", "runs_of_one_tile",
            "runs_of_tile_plus_one", "runs_of_tile_minus_one",
            "run_ends_on_tile_edges", "n_1", "n_tile_minus_1", "n_tile",
            "n_tile_plus_1", "n_odd_scalar_path", "uniform_short_runs",
            "step_like", "one_run_but_the_ends", "negative_keys"]


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("name", RT_CASES)
def test_run_totals_design_equals_plain(name, wrap):
    """Tile pass, descriptors, chains and fix-up give the plain version's
    totals; with `wrap`, payloads near +-2^30 make the run sums wrap int32,
    which both must do alike."""
    rs = np.random.RandomState(len(name) + 100 * wrap)
    key = _rt_case(name, rs)
    if wrap:
        pay = [rs.choice([-1, 1], key.shape) * (2 ** 30 - rs.randint(0, 9, key.shape))
               for _ in range(3)]
        pay[2][:] = 2 ** 30        # one sign only: wraps in every long run
    else:
        pay = [rs.randint(0, 512, key.shape) for _ in range(3)]
    pay = [p.astype(np.int32) for p in pay]
    got = RunTotalsEmulation(64, 4)(key, *pay)
    want = segsort.run_totals_plain(*(torch.from_numpy(a)
                                      for a in [key] + pay))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("name", [n for n in RT_CASES
                                  if n != "single_run_many_tiles"])
def test_run_totals_design_at_the_kernels_block_shape(name):
    """The same rows, scaled to the tile the kernel is built with (8 warps:
    the carry scan is as wide as the warps are many), with payloads that
    wrap int32."""
    rs = np.random.RandomState(len(name) + 7)
    key = _rt_case(name, rs, RT_THREADS * RT_ITEMS)
    pay = [(rs.choice([-1, 1], key.shape) *
            (2 ** 30 - rs.randint(0, 9, key.shape))).astype(np.int32)
           for _ in range(3)]
    got = RunTotalsEmulation(RT_THREADS, RT_ITEMS)(key, *pay)
    want = segsort.run_totals_plain(*(torch.from_numpy(a)
                                      for a in [key] + pay))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("threads,items", [(64, 8), (128, 4), (256, 4),
                                           (1024, 4)])
def test_run_totals_design_other_block_shapes(threads, items):
    """The same passes at other block shapes (8 warps: the kernel's own;
    32 warps: the exchange has no spare lane), on runs that cross several tiles and rows that do not
    fill their last tile."""
    rs = np.random.RandomState(threads + items)
    tile = threads * items
    key = np.stack([
        _runs([3, tile - 3, 2 * tile + 5, 7, tile, 11])[:3 * tile + 24],
        np.sort(rs.randint(0, 50, 3 * tile + 24)).astype(np.int32)])
    pay = [rs.randint(-2 ** 20, 2 ** 20, key.shape).astype(np.int32)
           for _ in range(3)]
    got = RunTotalsEmulation(threads, items)(key, *pay)
    want = segsort.run_totals_plain(*(torch.from_numpy(a)
                                      for a in [key] + pay))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# --------------------------------------------------------------------- stamp

TILE_X, TILE_Y, THREADS = 64, 16, 256
MASK_BITS, STAGE_BYTES, MAX_SLOTS = 2048, 32768, 1024


def test_stamp_emulation_has_the_kernels_constants():
    c = _constants("stamp.cu")
    assert (c["kTileX"], c["kTileY"], c["kThreads"]) == (TILE_X, TILE_Y, THREADS)
    assert (c["kMaskBits"], c["kStageBytes"], c["kMaxSlots"]) == (
        MASK_BITS, STAGE_BYTES, MAX_SLOTS)


def stamp_emulation(iy, ix, sel, tmpl, C, H, W, r):
    """csrc/stamp.cu: (B, K) folded slots -> (B, C, H, W)."""
    B, K = sel.shape
    win = 2 * r + 1
    flat = tmpl.reshape(-1)
    vec = W % 4 == 0
    px_n = 4 if vec else 1
    cols = TILE_X // px_n
    per = TILE_X * TILE_Y // px_n // THREADS
    out = np.full((B, C, H, W), np.nan, np.float32)
    written = np.zeros((B, C, H, W), np.int64)
    tiles_x, tiles_y = -(-W // TILE_X), -(-H // TILE_Y)
    for block in range(B * tiles_x * tiles_y):
        tx, ty = block % tiles_x, (block // tiles_x) % tiles_y
        b = block // tiles_x // tiles_y
        x0, y0 = tx * TILE_X, ty * TILE_Y
        # bin
        s_y, s_x, s_c = [], [], []
        mask = np.zeros(MASK_BITS // 32, np.uint32)
        for k in range(K):
            c = int(sel[b, k])
            if c < 0:
                continue
            sy, sx = int(iy[b, k]), int(ix[b, k])
            if (y0 - sy > r or sy - (y0 + TILE_Y - 1) > r or x0 - sx > r
                    or sx - (x0 + TILE_X - 1) > r):
                continue
            s_y.append(sy), s_x.append(sx), s_c.append(c)
            if c < MASK_BITS:
                mask[c >> 5] |= np.uint32(1 << (c & 31))
        n = len(s_y)
        assert n <= MAX_SLOTS
        # where the threads store
        it = np.arange(per * THREADS)
        py, px = y0 + it // cols, x0 + (it % cols) * px_n
        inside = (py < H) & (px < W)
        py, px = py[inside], px[inside]
        assert (px + px_n - 1 < W).all(), "a 16-byte store crosses the row end"
        if vec:
            assert ((py * W + px) % 4 == 0).all()
        for c in range(C):
            covered = n > 0 and (c >= MASK_BITS or (mask[c >> 5] >> (c & 31)) & 1)
            v = np.zeros((len(py), px_n), np.float32)
            if covered:
                for j in range(n):
                    if s_c[j] != c:
                        continue
                    dy = py - s_y[j]
                    ok_y = (dy >= -r) & (dy <= r)
                    for i in range(px_n):
                        dx = px - s_x[j] + i
                        ok = ok_y & (dx >= -r) & (dx <= r)
                        at = (dy + r) * win + r + dx
                        v[ok, i] = np.maximum(v[ok, i], flat[at[ok]])
            for i in range(px_n):
                out[b, c, py, px + i] = v[:, i]
                written[b, c, py, px + i] += 1
    assert (written == 1).all(), "a pixel was left out or written twice"
    return out


def _slots(name, rs, B, K, H, W, C):
    cy = rs.uniform(0, H, (B, K)).astype(np.float32)
    cx = rs.uniform(0, W, (B, K)).astype(np.float32)
    cls = rs.randint(0, C, (B, K)).astype(np.int32)
    valid = rs.rand(B, K) > 0.25
    if name == "borders":      # every border and corner, off the plane,
        n = min(K, 14)         # invalid, class ids out of range
        cy[:, :8] = [0.0, H - 0.5, 0.0, H - 1, 0.2, H - 1, H / 2, H / 2]
        cx[:, :8] = [0.0, 0.0, W - 0.5, W - 1, W / 2, W / 2, 0.7, W - 0.1]
        cy[:, 8:12] = [-1.0, H + 0.5, 10.0, -0.001]
        cx[:, 8:12] = [10.0, 10.0, W + 3.0, 10.0]
        cls[:, 12], cls[:, 13] = C + 5, -3
        valid[:, :n] = True
    elif name == "one_tile":   # all slots pile on one tile, one channel
        cy[:] = rs.uniform(16, 32, (B, K))
        cx[:] = rs.uniform(64, 128, (B, K))
        cls[:] = 2
        valid[:] = True
    elif name == "all_invalid":
        valid[:] = False
    elif name == "few_valid":  # 1-3 live slots an image
        valid[:] = False
        for b in range(B):
            valid[b, rs.choice(K, rs.randint(1, 4), replace=False)] = True
    return valid, cy, cx, cls


@pytest.mark.parametrize("name,sigma,K,shape,C", [
    ("borders", 6, 24, (96, 128), 5),
    ("borders", 1, 16, (7, 9), 20),           # W % 4 != 0, below one tile
    ("borders", 30, 16, (200, 333), 3),       # template not staged, W % 4 != 0
    ("borders", 30, 14, (64, 192), 2),        # not staged, 16-byte stores
    ("borders", 6, 20, (50, 70), 4),          # W % 4 != 0, ragged tiles
    ("random", 6, 40, (64, 256), 6),
    ("random", 1, 64, (33, 132), 3),          # W % 4 == 0, not of the tile
    ("one_tile", 6, 200, (48, 192), 4),
    ("one_tile", 1, 1024, (48, 192), 4),      # the list at its limit
    ("all_invalid", 6, 30, (32, 128), 3),
    ("few_valid", 6, 64, (64, 128), 20),
    ("random", 6, 0, (16, 64), 2),            # no slot at all
    ("random", 2, 12, (16, 64), 2100),        # channels past the mask's bits
])
def test_stamp_design_equals_plain(name, sigma, K, shape, C):
    """Binning, the channel mask, the empty and the covered path give the
    plain version's planes bit for bit."""
    rs = np.random.RandomState(sigma + K + C)
    H, W = shape
    B = 2
    args = [torch.from_numpy(a) for a in _slots(name, rs, B, K, H, W, C)]
    want = labelgen.stamp_centers(*args, C, sigma, shape).numpy()
    iy, ix, sel = (t.numpy() for t in labelgen._fold_slots(*args, C, shape))
    tmpl = labelgen._template(sigma, torch.device("cpu")).numpy()
    got = stamp_emulation(iy, ix, sel, tmpl, C, H, W, 3 * sigma + 1)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    staged = tmpl.nbytes <= STAGE_BYTES
    assert staged == (sigma <= 14)
