"""The host side of the walk of the range-walking and block-skipping level
kernels (one kernel, `csrc/msda_dense_v4_fwd.cu`) on the CPU.

  * `walk_plan` at the main paths' shapes: shared memory within the card's
    227 KB, a grid of at least 132 blocks at the decoder calls that
    `MSDA_DEC_SKIP` sends to kernel v4, a tile of lane groups x 1, 2, 4 or
    8 queries (the tiles `test_v4_ranges_equal_jax` holds against the JAX
    ranges), windows that lie in one column chunk;
  * the word a lane reads, and the plans the kernel refuses;
  * a plain mirror of a block's walk (corner table, windows marked and
    ranked, each query's corners sorted by rank, stages of `wps` windows
    clipped to the head's corners, each query owned by one lane group with
    a cursor) equals the plain level and the JAX package's range-walking
    function (its Pallas kernel in interpret mode), sums every corner in
    the level exactly once, stages no cell outside the tile's `v4_ranges`,
    and gives the tile bounds (`v4_ranges`, `v2_row_band`) over all heads.

Tolerance: float32 on every side, sums in different orders: 1e-5 absolute
and relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops import msda_dense as jdense
from trackformer_tpu_torch.ops import msda, msda_dense

torch.set_num_threads(1)

TOL = 1e-5
LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
S_ENC = sum(h * w for h, w in LEVELS)
M, P, D = 8, 4, 36
CARD_SMEM = 227 * 1024
SMS = 132
# the tiles `tests/test_torch_msda_routes.py::test_v4_ranges_equal_jax`
# holds against the JAX package's ranges
WALK_TQS = {16, 24, 48, 96, 192}
# the decoder calls that `MSDA_DEC_SKIP` sends to kernel v4: (items,
# queries) serving at B = 1, training and the previous frame's forward
DEC_CALLS = ((1, 650), (2, 611), (2, 500))


def path_plans():
    """(what, plan, cw, w) for every call of the routes at the flagship's
    shapes, bfloat16 and float32 values at an aligned pointer."""
    out = []
    for es in (2, 4):
        for n in (1, 2):
            for h, w in LEVELS:
                for cw in (64, 0):        # route v4 sorted, and full width
                    out.append((f"enc n={n} {h}x{w} cw={cw} es={es}",
                                msda_dense.walk_plan(n, S_ENC, M, P, D, h, w,
                                                     es, 256, cw), cw, w))
        for n, lq in DEC_CALLS:
            out.append((f"dec n={n} lq={lq} es={es}",
                        msda_dense.walk_plan(n, lq, M, P, D, *LEVELS[0], es,
                                             256, 64), 64, LEVELS[0][1]))
    return out


def test_plans_at_the_paths_shapes_fit_the_card():
    for what, plan, cw, w in path_plans():
        assert plan.smem_bytes <= CARD_SMEM, what
        assert plan.stage_bytes <= max(msda_dense.WALK_STAGE_BYTES,
                                       msda_dense.WALK_ROWS_BYTES), what
        assert plan.tq in WALK_TQS, what
        assert plan.tq <= plan.groups * plan.kmax, what
        assert plan.kmax in msda_dense.WALK_KMAX, what
        # 72-byte bf16 rows in 9 lanes of 8 bytes, 144-byte f32 rows in 9
        # of 16: 3 groups a warp
        assert plan.word == (8 if "es=2" in what else 16), what
        assert plan.lanes == 9 and plan.groups == 24, what
        # a window lies in one chunk of the walk (full width: whole rows)
        assert (min(cw, w) % plan.wc == 0) if cw else plan.wc == w, what
        assert plan.nwin + plan.wps < 32768, what


def test_windows_lie_in_one_chunk():
    for h, w in LEVELS:
        for lq in (650, S_ENC):
            plan = msda_dense.walk_plan(1, lq, M, P, D, h, w, 2, 256, 64)
            chunk = min(64, w)
            assert chunk % plan.wc == 0, (h, w, lq)
            # window c covers [c * wc, (c + 1) * wc): inside chunk c * wc // 64
            for c in range(-(-w // plan.wc)):
                lo, hi = c * plan.wc, min((c + 1) * plan.wc, w) - 1
                assert lo // 64 == hi // 64
            full = msda_dense.walk_plan(1, lq, M, P, D, h, w, 2, 256, 0)
            assert full.wc == w


@pytest.mark.parametrize("n,lq", DEC_CALLS)
def test_the_decoder_calls_fill_the_card(n, lq):
    plan = msda_dense.walk_plan(n, lq, M, P, D, *LEVELS[0], 2, 256, 64)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= SMS
    assert plan.grid == (M, -(-lq // plan.tq), n)
    # the sparse windows, many a stage
    assert (plan.wr, plan.wc) == (msda_dense.WALK_SPARSE_ROWS,
                                  msda_dense.WALK_SPARSE_COLS)
    assert plan.wps > 8
    # the parent design launched 8 x 3 x 1 = 24 blocks at 650 queries
    assert blocks >= 9 * 24


def test_the_encoder_calls_take_the_largest_tile():
    for n in (1, 2):
        for h, w in LEVELS:
            plan = msda_dense.walk_plan(n, S_ENC, M, P, D, h, w, 2, 256, 64)
            assert plan.tq == 192 and plan.kmax == 8
            assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 2 * SMS


@pytest.mark.parametrize("d,es,ptr,word", [
    (36, 2, 256, 8),      # flagship bf16: 72-byte rows, 9 lanes
    (36, 4, 256, 16),     # flagship f32: 144-byte rows, 9 lanes
    (36, 4, 264, 8),      # f32 rows at an 8-byte pointer: 18 lanes
    (8, 2, 256, 16),
    (5, 2, 256, 2),
    (6, 2, 256, 4),
    (5, 4, 256, 4),
    (6, 4, 256, 8),
])
def test_walk_plan_word(d, es, ptr, word):
    plan = msda_dense.walk_plan(1, 100, 3, 3, d, 11, 17, es, ptr, 8)
    assert plan.word == word
    assert plan.lanes == d * es // word <= 32
    assert plan.groups == 8 * (32 // plan.lanes)


def test_walk_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no word"):
        msda_dense.walk_plan(1, 100, 8, 4, 40, 11, 17, 4, 4, 8)   # 40 lanes
    with pytest.raises(ValueError, match="no word"):   # one element off
        msda_dense.walk_plan(1, 100, 8, 4, 36, 11, 17, 2, 258, 8)
    with pytest.raises(ValueError, match="tq"):
        msda_dense.walk_plan(1, 100, 8, 4, 36, 11, 17, 2, 256, 8, tq=193)
    plan = msda_dense.walk_plan(1, 100, 8, 4, 36, 11, 17, 2, 256, 8, tq=25)
    assert plan.kmax == 2 and plan.tq == 25


# --------------------------------------------------------------------------
# a plain mirror of the walk
# --------------------------------------------------------------------------

def cell_coord(loc, size):
    """`msda::cell_coord`: the product and the difference rounded one
    after the other, clamped to [-2, size + 1]."""
    c = (np.float32(loc) * np.float32(size)).astype(np.float32)
    c = (c - np.float32(0.5)).astype(np.float32)
    return np.clip(c, -2, size + 1).astype(np.float32)


def mirror_walk(value, loc, attn, h, w, plan, perm=None, cw=0):
    """What the blocks of the walk compute, block by block, in numpy ->
    (out (N, Lq, M, D) float32, ranges (N, tiles, 4), band (N, tiles, 2),
    staged cells outside the tile's ranges, corners summed, corners in the
    level)."""
    n, _, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[3]
    tq, wr, wc = plan.tq, plan.wr, plan.wc
    n_cb = -(-w // wc)
    tiles = plan.grid[1]
    out = np.full((n, lq, m, d), np.nan, np.float32)
    ranges = np.zeros((n, tiles, 4), np.int64)
    band = np.zeros((n, tiles, 2), np.int64)
    outside = summed = in_level = 0
    for b in range(n):
        order = np.arange(lq) if perm is None else perm[b]
        for t in range(tiles):
            qs = order[t * tq:(t + 1) * tq]
            parts, tile_staged = [], []
            for head in range(m):
                x = cell_coord(loc[b, qs, head, :, 0], w)        # (nq, P)
                y = cell_coord(loc[b, qs, head, :, 1], h)
                a = attn[b, qs, head]
                parts.append((x.min(), x.max(), y.min(), y.max()))
                x0, y0 = np.floor(x), np.floor(y)
                dx, dy = x - x0, y - y0
                # the corner table: (window, cell in window, weight)
                corners = [[] for _ in qs]
                flags = set()
                for j in range(len(qs)):
                    for pt in range(p):
                        for c in range(4):
                            cx = int(x0[j, pt]) + (c & 1)
                            cy = int(y0[j, pt]) + (c >> 1)
                            if not (0 <= cx < w and 0 <= cy < h):
                                continue
                            wx = dx[j, pt] if c & 1 else 1 - dx[j, pt]
                            wy = dy[j, pt] if c >> 1 else 1 - dy[j, pt]
                            win = (cy // wr) * n_cb + cx // wc
                            flags.add(win)
                            corners[j].append((win, (cy % wr) * wc + cx % wc,
                                               np.float32(a[j, pt] * wx * wy),
                                               cy, cx))
                in_level += sum(map(len, corners))
                occ = sorted(flags)
                rank = {win: r for r, win in enumerate(occ)}
                for lst in corners:
                    lst.sort(key=lambda e: (rank[e[0]], e[1]))
                br0 = max(int(np.floor(y.min())), 0)
                br1 = min(int(np.floor(y.max())) + 1, h - 1)
                bc0 = max(int(np.floor(x.min())), 0)
                bc1 = min(int(np.floor(x.max())) + 1, w - 1)
                # each query's owner: group j % groups, its k = j // groups
                assert -(-len(qs) // plan.groups) <= plan.kmax
                acc = np.zeros((len(qs), d), np.float32)
                cur = [0] * len(qs)
                for s in range(-(-len(occ) // plan.wps)):
                    staged = {}
                    for win in occ[s * plan.wps:(s + 1) * plan.wps]:
                        r0, c0 = (win // n_cb) * wr, (win % n_cb) * wc
                        for r in range(r0, min(r0 + wr, h)):
                            for c in range(c0, min(c0 + wc, w)):
                                if br0 <= r <= br1 and bc0 <= c <= bc1:
                                    staged[(r, c)] = value[b, r * w + c,
                                                           head]
                    limit = (s + 1) * plan.wps
                    for j, lst in enumerate(corners):
                        while cur[j] < len(lst) and rank[lst[cur[j]][0]] \
                                < limit:
                            _, _, wt, cy, cx = lst[cur[j]]
                            acc[j] += wt * staged[(cy, cx)]
                            cur[j] += 1
                            summed += 1
                    tile_staged.extend(staged)
                out[b, qs, head] = acc
            xmin = min(q[0] for q in parts)
            xmax = max(q[1] for q in parts)
            ymin = min(q[2] for q in parts)
            ymax = max(q[3] for q in parts)
            ranges[b, t] = (min(max(int(np.floor(ymin)) - 1, 0), h - 1),
                            min(int(np.floor(ymax)) + 1, h - 1),
                            0 if cw == 0 else
                            min(max(int(np.floor(xmin)), 0), w - 1),
                            w - 1 if cw == 0 else
                            min(max(int(np.floor(xmax)) + 1, 0), w - 1))
            band[b, t] = (max(0, int(np.floor(ymin)) - 1),
                          min(h - 1, int(np.floor(ymax)) + 1))
            r_lo, r_hi = ranges[b, t, :2]
            c_lo = min(max(int(np.floor(xmin)), 0), w - 1)
            c_hi = min(max(int(np.floor(xmax)) + 1, 0), w - 1)
            outside += sum(1 for r, c in tile_staged
                           if not (r_lo <= r <= r_hi and c_lo <= c <= c_hi))
    return out, ranges, band, outside, summed, in_level


def walk_inputs(seed, h, w, lq, oob, clustered):
    """One level's inputs, N = 2, M = 2 heads, P = 3 points, D = 4: queries
    that sample near a raster position each (`clustered`, as encoder
    queries do) or anywhere (as decoder queries do); with `oob` samples
    reach outside [0, 1] and the first eight queries sample wholly
    outside."""
    rng = np.random.default_rng(seed)
    n, m, p, d = 2, 2, 3, 4
    value = rng.standard_normal((n, h * w, m, d)).astype(np.float32)
    if clustered:
        base = (np.arange(lq) * 7) % (h * w)
        centre = np.stack([(base % w + 0.5) / w, (base // w + 0.5) / h], -1)
        loc = centre[None, :, None, None, :] + rng.normal(
            0, 0.06, (n, lq, m, p, 2))
    else:
        loc = rng.uniform(0, 1, (n, lq, m, p, 2))
    if oob:
        loc = loc * 1.4 - 0.2
        loc[:, :8] = rng.uniform(1.2, 1.5, loc[:, :8].shape)
    attn = rng.uniform(0.1, 1.0, (n, lq, m, p)).astype(np.float32)
    return value, loc.astype(np.float32), attn


# (h, w, lq, clustered): a level that the plan walks in sparse windows (2 x
# 8 cells, fewer corners a head than cells) and one in dense windows
WALK_CASES = {"sparse": (30, 41, 64, False), "dense": (9, 13, 64, True)}


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "oob"])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("kind", ["v4", "v4p_sorted", "v4p_random", "v2"])
def test_mirror_of_the_walk_matches_plain_and_jax(kind, case, oob):
    h, w, lq, clustered = WALK_CASES[case]
    value, loc, attn = walk_inputs(31, h, w, lq, oob, clustered)
    n, _, m, d = value.shape
    cw = 8 if kind.startswith("v4p") else 0
    perm = None
    if kind == "v4p_sorted":
        perm = np.asarray(jdense.spatial_sort_perm(jnp.asarray(loc), h, w))
    elif kind == "v4p_random":
        rng = np.random.default_rng(3)
        perm = np.stack([rng.permutation(lq) for _ in range(n)])
    # small stages, so that a tile's walk takes several
    plan = msda_dense.walk_plan(n, lq, m, loc.shape[3], d, h, w, 4, 256, cw,
                                tq=16, stage_budget=512, window_budget=128)
    assert plan.grid[1] == 4
    if case == "sparse" and cw:
        assert (plan.wr, plan.wc) == (msda_dense.WALK_SPARSE_ROWS,
                                      msda_dense.WALK_SPARSE_COLS)
    got, ranges, band, outside, summed, in_level = mirror_walk(
        value, loc, attn, h, w, plan, perm, cw)
    tl = torch.from_numpy(loc)
    want = msda.level_plain(torch.from_numpy(value), tl,
                            torch.from_numpy(attn), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    args = (jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), h, w)
    if kind == "v2":
        jout = jdense.dense_level_pallas_v2(*args, True)
    elif kind == "v4":
        jout = jdense.dense_level_pallas_v4(*args, True)
    else:
        jout = jdense.dense_level_pallas_v4p(*args[:3], jnp.asarray(perm), h,
                                             w, cw, True)
    np.testing.assert_allclose(got, np.asarray(jout).reshape(got.shape),
                               atol=TOL, rtol=TOL)
    assert summed == in_level > 0            # every corner once
    assert outside == 0                      # nothing outside the ranges
    tperm = None if perm is None else torch.from_numpy(perm)
    assert np.array_equal(ranges, msda_dense.v4_ranges(
        tl, h, w, plan.tq, cw or None, tperm).numpy())
    want_band = msda_dense.v2_row_band(tl, h, plan.tq).numpy()
    if perm is None:
        assert np.array_equal(band[..., 0], np.maximum(want_band[..., 0], 0))
        assert np.array_equal(band[..., 1],
                              np.minimum(want_band[..., 1], h - 1))
    if oob:
        assert not got[:, :8].any()          # no corner of theirs in the level
