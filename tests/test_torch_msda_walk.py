"""The host side of the walk of the range-walking, block-skipping, sorted
x-windowed and all-levels flat-walk kernels (one kernel,
`csrc/msda_dense_v4_fwd.cu`) on the CPU.

  * `walk_plan` and `levels_plan` at the main paths' shapes: shared memory
    within the card's 227 KB, a grid of at least 132 blocks at the decoder
    calls that `MSDA_DEC_SKIP` sends to kernel v4, a tile of lane groups x
    1, 2, 4 or 8 queries (the tiles `test_v4_ranges_equal_jax` holds
    against the JAX ranges), windows that lie in one column chunk, each
    level's corner keys within 16 bits;
  * the word a lane reads, the rows wider than a warp (several passes) and
    the plans the kernel refuses;
  * a plain mirror of a block's walk (per pass over a head row and per
    level: corner table, windows marked and ranked, each query's corners
    sorted by rank, stages of `wps` windows clipped to the head's corners,
    each query owned by one lane group with a cursor, its sums kept across
    the levels) equals the plain version and the JAX package's functions
    (their Pallas kernels in interpret mode): the range-walking,
    block-skipping and sorted x-windowed levels and, over all levels in
    snake order, the flat walk; it sums every corner exactly once, stages
    no cell outside the tile's `v4_ranges` (one level) or `v6_walk` chunks
    (all levels), and gives the tile bounds (`v4_ranges`, `v2_row_band`,
    `v3_windows`) over all heads.

Tolerance: float32 on every side, sums in different orders: 1e-5 absolute
and relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops import msda_dense as jdense
from trackformer_tpu.ops import msda_patch as jpatch
from trackformer_tpu_torch.ops import msda, msda_dense, msda_patch

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
        assert plan.passes == 1, what
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
    assert plan.passes == 1


@pytest.mark.parametrize("d,es,ptr,word", [
    (40, 4, 4, 4),        # float32 rows at a 4-byte pointer: 40 words
    (36, 2, 258, 2),      # D = 36 bfloat16 one element off: 36 words
    (160, 4, 256, 16),    # float32 rows of 160 channels: 40 words
])
def test_walk_plan_takes_rows_wider_than_a_warp(d, es, ptr, word):
    plan = msda_dense.walk_plan(1, 100, 8, 4, d, 11, 17, es, ptr, 8)
    assert (plan.word, plan.lanes, plan.passes) == (word, 32, 2)
    assert plan.groups == 8 and plan.tq <= plan.groups * plan.kmax
    # each stage holds a pass's slice of the rows: 32 words a cell
    assert plan.stage_bytes == -(-plan.wps * plan.wr * plan.wc * 32 * word
                                 // 16) * 16
    # at the flagship's encoder level the plan still fills the card, with
    # the largest tile that 8 lane groups can own
    big = msda_dense.walk_plan(1, S_ENC, M, P, d, *LEVELS[0], es, ptr, 64)
    assert big.passes == 2 and big.tq == 48 and big.kmax == 8
    assert big.smem_bytes <= CARD_SMEM
    assert big.grid[0] * big.grid[1] * big.grid[2] >= 2 * SMS


def test_walk_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="tq"):
        msda_dense.walk_plan(1, 100, 8, 4, 36, 11, 17, 2, 256, 8, tq=193)
    with pytest.raises(ValueError, match="tq"):     # 8 groups of 32 lanes
        msda_dense.walk_plan(1, 100, 8, 4, 40, 11, 17, 4, 4, 8, tq=65)
    with pytest.raises(ValueError, match="words"):  # more than 32 passes
        msda_dense.walk_plan(1, 100, 8, 4, 1025, 11, 17, 4, 4, 8)
    with pytest.raises(ValueError, match="shared memory"):
        msda_dense.walk_plan(1, 100, 8, 400, 36, 11, 17, 2, 256, 8)
    with pytest.raises(ValueError, match="levels"):
        msda_dense.levels_plan(1, 100, 8, 4, 36, ((11, 17),) * 9, 2, 256)
    plan = msda_dense.walk_plan(1, 100, 8, 4, 36, 11, 17, 2, 256, 8, tq=25)
    assert plan.kmax == 2 and plan.tq == 25
    plan = msda_dense.walk_plan(1, 100, 8, 4, 32 * 32, 11, 17, 4, 4, 8)
    assert plan.passes == 32


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("n", [1, 2])
def test_levels_plan_at_the_encoder_call(n, es):
    plan = msda_dense.levels_plan(n, S_ENC, M, P, D, LEVELS, es, 256,
                                  msda_patch.V6_CW)
    assert plan.tq == 192 and plan.kmax == 8 and plan.passes == 1
    assert plan.grid == (M, -(-S_ENC // 192), n)
    assert plan.starts == (0, 16800, 21000, 22050)
    assert plan.smem_bytes <= CARD_SMEM
    for (h, w), lv in zip(LEVELS, plan.levels):
        # each level on its own window grid, its own walk_plan at the tile
        assert lv == msda_dense.walk_plan(n, S_ENC, M, P, D, h, w, es, 256,
                                          msda_patch.V6_CW, 192)
        assert lv.nwin + lv.wps < 32768
        assert min(msda_patch.V6_CW, w) % lv.wc == 0
    # shared memory: the largest level's stage and window table
    assert plan.smem_bytes == 2 * max(lv.stage_bytes for lv in plan.levels) \
        + 4 * (2 * 192 * (4 * P + 1) + 2 * max(lv.nwin for lv in plan.levels)
               + 192 + 192)


# --------------------------------------------------------------------------
# a plain mirror of the walk
# --------------------------------------------------------------------------

def cell_coord(loc, size):
    """`msda::cell_coord`: the product and the difference rounded one
    after the other, clamped to [-2, size + 1]."""
    c = (np.float32(loc) * np.float32(size)).astype(np.float32)
    c = (c - np.float32(0.5)).astype(np.float32)
    return np.clip(c, -2, size + 1).astype(np.float32)


def mirror_walk(value, loc, attn, plan, perm=None, cw=0, es=4):
    """What the blocks of the walk compute, block by block, in numpy:
    value (N, cells, M, D), the plan's levels back to back; loc (N, Lq, M,
    L, P, 2); attn (N, Lq, M, L, P); `plan` a `levels_plan` (its head rows
    of `es`-byte elements: a pass covers 32 words of them); the tiles'
    order `perm` (N, Lq), or (Lq,) for every item, or None. -> dict: `out`
    (N, Lq, M, D) float32; the bounds over all heads of level 0 per tile,
    `ranges` (`cw` 0: the full width), `band` and `windows` (a window of
    `cw` columns); `staged`, the cells staged per (item, tile, level);
    `outside`, staged cells outside the tile's rows and columns of level 0;
    `summed` corners and corners `in_level`."""
    n, _, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
    tq, tiles = plan.tq, plan.grid[1]
    per_pass = 32 * plan.word // es                  # channels a pass
    out = np.full((n, lq, m, d), np.nan, np.float32)
    ranges = np.zeros((n, tiles, 4), np.int64)
    band = np.zeros((n, tiles, 2), np.int64)
    windows = np.zeros((n, tiles, 4), np.int64)
    staged_cells = {}
    outside = summed = in_level = 0
    for b in range(n):
        order = (np.arange(lq) if perm is None
                 else perm if perm.ndim == 1 else perm[b])
        for t in range(tiles):
            qs = order[t * tq:(t + 1) * tq]
            # each query's owner: group j % groups, its k = j // groups
            assert -(-len(qs) // plan.groups) <= plan.kmax
            parts = []
            for head in range(m):
                for ps in range(plan.passes):
                    ch = slice(ps * per_pass, min((ps + 1) * per_pass, d))
                    acc = np.zeros((len(qs), ch.stop - ch.start), np.float32)
                    for lvl, ((h, w), start, lv) in enumerate(zip(
                            plan.shapes, plan.starts, plan.levels)):
                        wr, wc, wps = lv.wr, lv.wc, lv.wps
                        n_cb = -(-w // wc)
                        x = cell_coord(loc[b, qs, head, lvl, :, 0], w)
                        y = cell_coord(loc[b, qs, head, lvl, :, 1], h)
                        a = attn[b, qs, head, lvl]
                        if ps == 0 and lvl == 0:
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
                                    corners[j].append(
                                        (win, (cy % wr) * wc + cx % wc,
                                         np.float32(a[j, pt] * wx * wy),
                                         cy, cx))
                        if ps == 0:
                            in_level += sum(map(len, corners))
                        occ = sorted(flags)
                        rank = {win: r for r, win in enumerate(occ)}
                        for lst in corners:
                            lst.sort(key=lambda e: (rank[e[0]], e[1]))
                        br0 = max(int(np.floor(y.min())), 0)
                        br1 = min(int(np.floor(y.max())) + 1, h - 1)
                        bc0 = max(int(np.floor(x.min())), 0)
                        bc1 = min(int(np.floor(x.max())) + 1, w - 1)
                        cur = [0] * len(qs)
                        for s in range(-(-len(occ) // wps)):
                            staged = {}
                            for win in occ[s * wps:(s + 1) * wps]:
                                r0, c0 = (win // n_cb) * wr, (win % n_cb) * wc
                                for r in range(r0, min(r0 + wr, h)):
                                    for c in range(c0, min(c0 + wc, w)):
                                        if br0 <= r <= br1 and bc0 <= c <= bc1:
                                            staged[(r, c)] = value[
                                                b, start + r * w + c, head, ch]
                            limit = (s + 1) * wps
                            for j, lst in enumerate(corners):
                                while cur[j] < len(lst) and \
                                        rank[lst[cur[j]][0]] < limit:
                                    _, _, wt, cy, cx = lst[cur[j]]
                                    acc[j] += wt * staged[(cy, cx)]
                                    cur[j] += 1
                                    summed += ps == 0
                            staged_cells.setdefault((b, t, lvl), set()).update(
                                staged)
                    out[b, qs, head, ch] = acc
            xmin = min(q[0] for q in parts)
            xmax = max(q[1] for q in parts)
            ymin = min(q[2] for q in parts)
            ymax = max(q[3] for q in parts)
            h, w = plan.shapes[0]
            fx, gx = int(np.floor(xmin)), int(np.floor(xmax))
            fy, gy = int(np.floor(ymin)), int(np.floor(ymax))
            ranges[b, t] = (min(max(fy - 1, 0), h - 1), min(gy + 1, h - 1),
                            0 if cw == 0 else min(max(fx, 0), w - 1),
                            w - 1 if cw == 0 else min(max(gx + 1, 0), w - 1))
            band[b, t] = (max(0, fy - 1), min(h - 1, gy + 1))
            cwc = min(cw, w)
            left, right = min(max(fx, 0), w + 1), min(max(gx + 1, -1), w - 1)
            fits = right - left + 1 <= cwc
            windows[b, t] = (min(max(fy - 1, 0), h), min(max(gy + 1, -1), h - 1),
                             min(left, w - cwc) if fits else 0, int(fits))
            r_lo, r_hi = ranges[b, t, :2]
            c_lo, c_hi = min(max(fx, 0), w - 1), min(max(gx + 1, 0), w - 1)
            outside += sum(1 for r, c in staged_cells.get((b, t, 0), ())
                           if not (r_lo <= r <= r_hi and c_lo <= c <= c_hi))
    return dict(out=out, ranges=ranges, band=band, windows=windows,
                staged=staged_cells, outside=outside, summed=summed,
                in_level=in_level)


def walk_inputs(seed, h, w, lq, oob, clustered, d=4):
    """One level's inputs, N = 2, M = 2 heads, P = 3 points, D = `d`:
    queries that sample near a raster position each (`clustered`, as
    encoder queries do) or anywhere (as decoder queries do); with `oob`
    samples reach outside [0, 1] and the first eight queries sample wholly
    outside."""
    rng = np.random.default_rng(seed)
    n, m, p = 2, 2, 3
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


def small_plan(n, lq, m, p, d, shapes, cw, es=4, ptr=256, tq=16):
    """A plan with small stages, so that a tile's walk takes several."""
    return msda_dense.levels_plan(n, lq, m, p, d, shapes, es, ptr, cw, tq,
                                  stage_budget=512, window_budget=128)


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "oob"])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("kind", ["v4", "v4p_sorted", "v4p_random", "v2",
                                  "v3"])
def test_mirror_of_the_walk_matches_plain_and_jax(kind, case, oob):
    h, w, lq, clustered = WALK_CASES[case]
    value, loc, attn = walk_inputs(31, h, w, lq, oob, clustered)
    n, _, m, d = value.shape
    cw = 8 if kind.startswith(("v4p", "v3")) else 0
    perm = None
    if kind in ("v4p_sorted", "v3"):
        perm = np.asarray(jdense.spatial_sort_perm(jnp.asarray(loc), h, w))
    elif kind == "v4p_random":
        rng = np.random.default_rng(3)
        perm = np.stack([rng.permutation(lq) for _ in range(n)])
    plan = small_plan(n, lq, m, loc.shape[3], d, ((h, w),), cw)
    assert plan.grid[1] == 4
    if case == "sparse" and cw:
        assert (plan.levels[0].wr, plan.levels[0].wc) == (
            msda_dense.WALK_SPARSE_ROWS, msda_dense.WALK_SPARSE_COLS)
    res = mirror_walk(value, loc[:, :, :, None], attn[:, :, :, None], plan,
                      perm, cw)
    got = res["out"]
    tl = torch.from_numpy(loc)
    want = msda.level_plain(torch.from_numpy(value), tl,
                            torch.from_numpy(attn), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    args = (jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), h, w)
    if kind == "v2":
        jout = jdense.dense_level_pallas_v2(*args, True)
    elif kind == "v4":
        jout = jdense.dense_level_pallas_v4(*args, True)
    elif kind == "v3":
        jout = jdense._dense_level_pallas_v3_fwd(*args, cw=cw, tq=8,
                                                 rows_per_tile=2,
                                                 interpret=True)
    else:
        jout = jdense.dense_level_pallas_v4p(*args[:3], jnp.asarray(perm), h,
                                             w, cw, True)
    np.testing.assert_allclose(got, np.asarray(jout).reshape(got.shape),
                               atol=TOL, rtol=TOL)
    assert res["summed"] == res["in_level"] > 0     # every corner once
    assert res["outside"] == 0                      # nothing outside ranges
    tperm = None if perm is None else torch.from_numpy(perm.copy())
    assert np.array_equal(res["ranges"], msda_dense.v4_ranges(
        tl, h, w, plan.tq, cw or None, tperm).numpy())
    want_band = msda_dense.v2_row_band(tl, h, plan.tq).numpy()
    if perm is None:
        band = res["band"]
        assert np.array_equal(band[..., 0], np.maximum(want_band[..., 0], 0))
        assert np.array_equal(band[..., 1],
                              np.minimum(want_band[..., 1], h - 1))
    else:
        # the v3 bounds at the walk's tiles, exactly
        windows = msda_dense.v3_windows(tl, h, w, tperm, plan.tq, cw).numpy()
        assert np.array_equal(res["windows"], windows)
    if oob:
        assert not got[:, :8].any()          # no corner of theirs in the level


def test_mirror_windows_at_the_fit_boundary():
    # `test_torch_msda_routes.py::test_v3_windows_at_the_fit_boundary`'s
    # tiles through the walk: the first fits (its window starts at 10), the
    # second takes the full width, the third fits with its window pulled
    # back inside the level
    h, w, cw, tq = 6, 40, 8, 4
    x = np.array([10.2, 12.0, 15.0, 16.5, 10.2, 12.0, 15.0, 17.5, 35.5, 36.0,
                  38.0, 39.4], np.float32).reshape(1, 12, 1, 1, 1)
    y = np.full_like(x, 2.3)
    loc = np.stack([(x + 0.5) / w, (y + 0.5) / h], -1).astype(np.float32)
    attn = np.ones((1, 12, 1, 1, 1), np.float32)
    value = np.random.default_rng(5).standard_normal(
        (1, h * w, 1, 4)).astype(np.float32)
    plan = small_plan(1, 12, 1, 1, 4, ((h, w),), cw, tq=tq)
    res = mirror_walk(value, loc, attn, plan, np.arange(12)[None], cw)
    assert res["windows"][0].tolist() == [[1, 3, 10, 1], [1, 3, 0, 0],
                                          [1, 3, 32, 1]]
    assert np.array_equal(res["windows"], msda_dense.v3_windows(
        torch.from_numpy(loc[:, :, :, 0]), h, w, torch.arange(12)[None], tq,
        cw).numpy())
    np.testing.assert_allclose(res["out"], msda.level_plain(
        *map(torch.from_numpy, (value, loc[:, :, :, 0], attn[:, :, :, 0])),
        h, w).numpy(), atol=TOL, rtol=TOL)


# the levels of the all-levels walk: 192 + 48 + 15 = 255 tokens, a ragged
# last tile of 15 at tiles of 16
PATCH_SHAPES = ((12, 16), (6, 8), (3, 5))
PATCH_S = sum(h * w for h, w in PATCH_SHAPES)


def patch_inputs(seed, case, d=4, shapes=PATCH_SHAPES):
    """All-levels inputs of the encoder's self-pattern, N = 2, M = 2, P =
    3: every token samples near its own centre on every level, except
    "uniform" (anywhere); with "across_border" every fifth token's samples
    are pushed across the border and the first tile's lie wholly below
    the levels."""
    rng = np.random.default_rng(seed)
    n, m, p, l = 2, 2, 3, len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    if case == "uniform":
        loc = rng.uniform(0, 1, (n, s, m, l, p, 2))
    else:
        centres = np.concatenate([np.stack(
            [(np.arange(h * w) % w + 0.5) / w,
             (np.arange(h * w) // w + 0.5) / h], -1) for h, w in shapes])
        loc = centres[None, :, None, None, None] + rng.normal(
            0, 0.08, (n, s, m, l, p, 2))
    if case == "across_border":
        loc[:, ::5] = loc[:, ::5] * 1.4 - 0.2
        first = msda_patch.snake_bucket_perm(shapes)[0][:16]
        below = loc[:, first]
        below[..., 1] = rng.uniform(1.5, 1.8, (n, 16, m, l, p))
        loc[:, first] = below
    attn = rng.uniform(0.1, 1.0, (n, s, m, l, p))
    attn /= attn.sum((-2, -1), keepdims=True)
    return value, loc.astype(np.float32), attn.astype(np.float32)


def staged_outside_the_v6_walk(res, loc, plan, ph=4, pw=8):
    """Cells the mirror staged outside the chunks that `v6_walk` lists for
    the tile (at the plan's tile)."""
    codes, totals = msda_patch.v6_walk(plan.shapes, torch.from_numpy(loc),
                                       plan.tq, ph, pw)
    listed = {}
    for b in range(codes.shape[0]):
        for t in range(codes.shape[1]):
            for code in codes[b, t, :int(totals[b, t])].tolist():
                listed.setdefault((b, t, code >> 20), set()).add(
                    ((code >> 10) & 1023, code & 1023))
    return sum(1 for key, cells in res["staged"].items() for r, c in cells
               if (r // ph, c // pw) not in listed.get(key, ()))


@pytest.mark.parametrize("case", ["clustered", "uniform", "across_border"])
def test_mirror_of_the_walk_over_all_levels_matches_plain_and_jax(case):
    value, loc, attn = patch_inputs(37, case)
    n, s, m, d = value.shape
    plan = small_plan(n, s, m, loc.shape[4], d, PATCH_SHAPES,
                      msda_patch.V6_CW)
    assert plan.grid[1] == 16 and s % plan.tq               # a ragged tile
    perm = msda_patch.snake_bucket_perm(PATCH_SHAPES)[0]
    res = mirror_walk(value, loc, attn, plan, perm)
    got = res["out"]
    want = msda.ms_deform_attn_plain(
        *map(torch.from_numpy, (value,)), PATCH_SHAPES,
        torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jout = jpatch._msda_patch_v6_fwd(
        jnp.asarray(value), PATCH_SHAPES, jnp.asarray(loc),
        jnp.asarray(attn), tq=48, ph=4, pw=8, nslots=3, interpret=True)
    np.testing.assert_allclose(got, np.asarray(jout).reshape(got.shape),
                               atol=TOL, rtol=TOL)
    assert res["summed"] == res["in_level"] > 0     # every corner once
    assert staged_outside_the_v6_walk(res, loc, plan) == 0
    # each level on its own window grid, several windows a tile
    assert {lvl for _, _, lvl in res["staged"]} == {0, 1, 2}
    if case == "across_border":
        first = msda_patch.snake_bucket_perm(PATCH_SHAPES)[0][:16]
        assert not got[:, first].any()      # no corner of theirs in a level


@pytest.mark.parametrize("levels", ["one", "all"])
@pytest.mark.parametrize("d,es,ptr", [(40, 4, 4), (36, 2, 258)],
                         ids=["f32_40_channels", "bf16_36_one_element_off"])
def test_mirror_of_a_two_pass_walk_matches_plain(d, es, ptr, levels):
    """Rows wider than a warp: float32 rows of 40 words at a 4-byte
    pointer, bfloat16 rows of 36 channels one element off (the mirror sums
    in float32 either way; the plan's passes are what is held)."""
    if levels == "one":
        h, w, lq, _ = WALK_CASES["dense"]
        value, loc, attn = walk_inputs(43, h, w, lq, True, True, d)
        loc, attn, shapes, perm = (loc[:, :, :, None], attn[:, :, :, None],
                                   ((h, w),), None)
    else:
        value, loc, attn = patch_inputs(47, "across_border", d)
        shapes = PATCH_SHAPES
        perm = msda_patch.snake_bucket_perm(shapes)[0]
    n, lq, m = loc.shape[:3]
    plan = small_plan(n, lq, m, loc.shape[4], d, shapes, 8, es, ptr)
    assert plan.passes == 2 and plan.lanes == 32 and plan.groups == 8
    res = mirror_walk(value, loc, attn, plan, perm, 8, es)
    want = msda.ms_deform_attn_plain(
        torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(res["out"], want, atol=TOL, rtol=TOL)
    assert res["summed"] == res["in_level"] > 0
