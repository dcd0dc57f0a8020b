"""The host side of the MSDA forward kernel (`csrc/msda_fwd.cu`) on the
CPU: the plan `msda.fwd_plan`, and a plain PyTorch mirror of the kernel's
lanes.

  * the plan picks the widest word of 16 or 8 bytes that divides a head's
    row and the value pointer's alignment (bfloat16 D = 36: 8 bytes;
    float32: 16), one channel a lane otherwise (bfloat16 D = 6, a pointer
    one element off), and the grid that the wrapper launches the kernel on
    (the entry point refuses one that misses a query), whose warps cover
    every (item, query, head) exactly once at the flagship's call shapes;
  * the mirror builds the table that each lane builds in registers for its
    sample (four corner rows and folded weights, a corner off its level at
    weight 0 on the row of the level's nearest cell, which the kernel reads
    like any other) and sums it as the warp does: each group
    of lanes over its own samples in order, then a tree over the groups. It
    equals `ms_deform_attn_plain` and the JAX package's `ms_deform_attn` on
    the same numpy inputs, with samples outside the levels. Float32 on all
    sides, sums in different orders: 1e-5 absolute and relative.

The kernel itself runs only on the card (`chip_smoke.py --phases msda`),
held there against the same plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops.msda import ms_deform_attn as jax_msda
from trackformer_tpu_torch.ops import msda

torch.set_num_threads(1)

FLAGSHIP = ((100, 168), (50, 84), (25, 42), (13, 21))
S_ENC = sum(h * w for h, w in FLAGSHIP)


@pytest.mark.parametrize("d, es, ptr, word", [
    (36, 2, 256, 8),       # bfloat16, the flagship's head: 72-byte rows
    (36, 4, 256, 16),      # float32: 144-byte rows
    (32, 2, 256, 16),      # bfloat16, 64-byte rows
    (6, 2, 256, 0),        # bfloat16 D = 6: 12-byte rows, one channel a lane
    (6, 4, 256, 8),        # float32 D = 6: 24-byte rows
    (36, 2, 258, 0),       # one element off an aligned pointer
    (36, 4, 260, 0),
    (36, 4, 264, 8),       # 8- but not 16-byte aligned
])
def test_fwd_plan_word(d, es, ptr, word):
    assert msda.fwd_plan(1, 650, 8, d, es, ptr).word == word


@pytest.mark.parametrize("n, lq", [
    (1, S_ENC),            # encoder call, serving
    (2, S_ENC),            # encoder call, training
    (1, 650),              # decoder call, B = 1
    (8, 650),              # decoder call, the lockstep step's B = 8
    (2, 611),              # decoder call, training
    (2, 500),              # previous frame's decoder call, training
    (1, 7),                # a ragged last block
])
def test_fwd_plan_grid_covers_each_query_and_head_once(n, lq):
    m = 8
    plan = msda.fwd_plan(n, lq, m, 36, 2, 256)
    gx, gy, gz = plan.grid
    assert (gy, gz) == (m, n) and plan.warps == msda.FWD_WARPS
    # warp w of block (x, head, item) serves query x * warps + w
    x, head, item, w = np.meshgrid(np.arange(gx), np.arange(gy),
                                   np.arange(gz), np.arange(plan.warps),
                                   indexing="ij")
    q = x * plan.warps + w
    live = q < lq
    keys = (item[live] * lq + q[live]) * m + head[live]
    assert keys.size == n * lq * m
    np.testing.assert_array_equal(np.sort(keys), np.arange(n * lq * m))
    # the decoder call at B = 1 gives every one of the H100's 132 SMs
    # several blocks
    if (n, lq) == (1, 650):
        assert gx * gy * gz >= 4 * 132


def corner_table(shapes, loc, attn):
    """What each lane computes once for its sample: (N, Lq, M, L * P, 4)
    corner rows, counted from the item's first cell (a corner off the level
    on the level's nearest cell), and folded weights (attention x bilinear
    x in range), corners (x, y) = 00, 10, 01, 11."""
    rows, wts = [], []
    start = 0
    for lv, (h, w) in enumerate(shapes):
        x = torch.clamp(loc[:, :, :, lv, :, 0] * w - 0.5, -2.0, w + 1.0)
        y = torch.clamp(loc[:, :, :, lv, :, 1] * h - 0.5, -2.0, h + 1.0)
        x0f, y0f = torch.floor(x), torch.floor(y)
        dx, dy = x - x0f, y - y0f
        x0, y0 = x0f.long(), y0f.long()
        r, wt = [], []
        for c in range(4):
            cx, cy = x0 + (c & 1), y0 + (c >> 1)
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            b = (dx if c & 1 else 1 - dx) * (dy if c >> 1 else 1 - dy)
            wt.append(torch.where(ok, attn[:, :, :, lv] * b, 0.0))
            r.append(start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1))
        rows.append(torch.stack(r, -1))
        wts.append(torch.stack(wt, -1))
        start += h * w
    return torch.cat(rows, 3), torch.cat(wts, 3)


def mirror(value, shapes, loc, attn, word, es):
    """The kernel's sum for a plan word of `word` bytes on elements of `es`
    bytes: groups of min(D / VW, 32) lanes, 32 // that many groups; group g
    takes the samples j with (j mod 32) mod groups == g in order, each
    sample's four corners in order; a tree adds the groups. -> (N, Lq, M,
    D) float32."""
    n, s, m, d = value.shape
    lq = loc.shape[1]
    vw = word // es if word else 1
    groups = 32 // min(d // vw, 32)
    rows, wts = corner_table(shapes, loc, attn)
    table = value.float().permute(0, 2, 1, 3)           # (N, M, S, D)
    items = torch.arange(n)[:, None, None]
    heads = torch.arange(m)[None, None, :]
    acc = [torch.zeros(n, lq, m, d) for _ in range(groups)]
    for j in range(rows.shape[3]):
        g = (j % 32) % groups
        for c in range(4):
            v = table[items, heads, rows[..., j, c]]    # (N, Lq, M, D)
            acc[g] = acc[g] + wts[..., j, c, None] * v
    off = 1
    while off < groups:
        for g in range(0, groups - off, 2 * off):
            acc[g] = acc[g] + acc[g + off]
        off *= 2
    return acc[0]


@pytest.mark.parametrize("shapes, n, lq, m, d, p, word, es, lo, hi", [
    # float32 D = 36 in 16-byte words: 3 groups of 9 lanes; 8 levels
    (((6, 4), (3, 2)) * 4, 2, 13, 2, 36, 4, 16, 4, -0.3, 1.3),
    # bfloat16 D = 36 in 8-byte words (the flagship's layout), encoder-like
    (((9, 13), (5, 7), (3, 4), (2, 2)), 1, 40, 3, 36, 4, 8, 2, -0.2, 1.2),
    # D = 6 one channel a lane: 5 groups of 6 lanes; levels one cell wide
    (((7, 1), (1, 5), (4, 6)), 2, 17, 2, 6, 4, 0, 2, -0.4, 1.4),
    # 36 samples a head: two passes of 32 samples; 16-byte words of 8 bf16
    (((9, 13), (5, 7), (3, 4), (1, 1)), 2, 11, 2, 32, 9, 16, 2, -0.5, 1.5),
])
def test_mirror_of_the_lanes_matches_plain_and_jax(shapes, n, lq, m, d, p,
                                                   word, es, lo, hi):
    rng = np.random.default_rng(d * 100 + p)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, (n, lq, m, len(shapes), p, 2)).astype(
        np.float32)
    attn = rng.uniform(0.1, 1.0, (n, lq, m, len(shapes), p)).astype(
        np.float32)
    assert ((loc < 0) | (loc > 1)).any(-1).any((0, 1, 2, 4)).all()
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, attn))

    rows, wts = corner_table(shapes, tl, ta)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    level = torch.arange(len(shapes)).repeat_interleave(p)[:, None]
    assert bool((rows >= torch.from_numpy(starts[:-1])[level]).all())
    assert bool((rows < torch.from_numpy(starts[1:])[level]).all())
    # a sample's weights add up to its attention weight when all four of
    # its corners lie on the level, to less when some do not
    total = wts.sum(-1)
    flat_attn = ta.reshape(total.shape)
    assert bool((total <= flat_attn * (1 + 1e-6)).all())
    assert bool((total < flat_attn * (1 - 1e-6)).any())

    got = mirror(tv, shapes, tl, ta, word, es)
    want = msda.ms_deform_attn_plain(tv, shapes, tl, ta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    jax_out = jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                       jnp.asarray(attn))
    np.testing.assert_allclose(got.reshape(n, lq, m * d).numpy(),
                               np.asarray(jax_out), atol=1e-5, rtol=1e-5)
