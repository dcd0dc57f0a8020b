"""The host side of the MSDA backward kernel (`csrc/msda_bwd.cu`) on the
CPU: the plan `msda.bwd_plan` that splits a call into blocks, and a plain
PyTorch mirror of that split.

  * the plan keeps each block's shared memory within what a Hopper block
    may use, picks the two coarse levels at the flagship's encoder call and
    no level for a single call on the finest one, sizes the blocks, and
    handles channel counts that are not a multiple of 4 (no 16-byte
    path);
  * the mirror walks the kernel's blocks, (item, head, run of queries): it
    sums the corner terms of the planned levels into a block-local buffer,
    flushes that once, and sends every other corner term straight to the
    value gradient. Its value gradient equals autograd through
    `ms_deform_attn_plain`, with samples outside the level: every corner
    term lands exactly once. Float32 on both sides, sums in different
    orders: 1e-5 absolute and relative.

The kernel itself runs only on the card (`chip_smoke.py --phases
msda_bwd`), held there against the same plain version.
"""
import numpy as np
import pytest
import torch

from trackformer_tpu_torch.ops import msda

torch.set_num_threads(1)

FLAGSHIP = ((100, 168), (50, 84), (25, 42), (13, 21))
S_ENC = sum(h * w for h, w in FLAGSHIP)


@pytest.mark.parametrize("n, lq, m, p, d, shapes", [
    (2, S_ENC, 8, 4, 36, FLAGSHIP),              # encoder call, training
    (1, S_ENC, 8, 4, 36, FLAGSHIP),              # encoder call, serving
    (2, 611, 8, 4, 36, FLAGSHIP * 2),            # decoder call, training
    (8, 650, 8, 4, 36, FLAGSHIP * 2),            # decoder call, B = 8
    (2, S_ENC, 8, 4, 128, FLAGSHIP),             # the widest head
    (2, S_ENC, 8, 4, 127, FLAGSHIP),             # widest, not 16-byte rows
    (1, 5000, 1, 4, 37, ((40, 40), (20, 20), (10, 10), (5, 5))),
    (2, 30000, 2, 8, 6, ((60, 60), (30, 30), (15, 15))),
])
def test_bwd_plan_stays_within_a_blocks_shared_memory(n, lq, m, p, d,
                                                      shapes):
    plan = msda.bwd_plan(n, lq, m, p, d, shapes)
    assert 0 <= plan.smem_bytes <= msda.BWD_SMEM_BYTES == 232_448
    assert plan.smem_bytes == sum(shapes[i][0] * shapes[i][1] * d * 4
                                  for i in plan.levels)
    assert plan.vector == (d % 4 == 0)
    assert 1 <= plan.queries <= lq
    # the coarsest levels first: a planned level is never larger than one
    # left out
    cells = [h * w for h, w in shapes]
    left = [cells[i] for i in range(len(shapes)) if i not in plan.levels]
    assert all(cells[i] <= c for i in plan.levels for c in left)


def test_bwd_plan_at_the_flagship_shapes():
    enc = msda.bwd_plan(2, S_ENC, 8, 4, 36, FLAGSHIP)
    # levels 2 and 3: 186 KiB of float32 head slices; about BWD_WAVES
    # blocks per SM over the call
    assert enc.levels == (2, 3) and enc.smem_bytes == 190_512
    blocks = 2 * 8 * -(-S_ENC // enc.queries)
    assert enc.vector and enc.queries == 677
    assert abs(blocks - msda.BWD_WAVES * msda.BWD_SMS) <= 2 * 8
    # the decoder call's blocks are too small for a level to take
    # BWD_MIN_HITS terms per cell
    dec = msda.bwd_plan(2, 611, 8, 4, 36, FLAGSHIP * 2)
    assert dec.levels == () and dec.queries == 19
    # single-level calls of routes v2 and v4: the two fine levels do not
    # fit, the two coarse ones do, and then every level of the call is in
    # shared memory: one wave of larger blocks
    plans = [msda.bwd_plan(2, S_ENC, 8, 4, 36, (hw,)) for hw in FLAGSHIP]
    assert [pl.levels for pl in plans] == [(), (), (0,), (0,)]
    assert [pl.queries for pl in plans] == [677, 677, 2791, 2791]
    assert plans[0].smem_bytes == 0


def test_bwd_plan_with_channels_not_a_multiple_of_4():
    shapes = ((30, 40), (5, 7))
    plan = msda.bwd_plan(2, 3000, 2, 4, 6, shapes)
    assert not plan.vector and plan.queries == 23
    assert plan.levels == (1,) and plan.smem_bytes == 5 * 7 * 6 * 4
    # level 0 takes too few hits per cell from one block
    assert 23 * 4 * 4 < msda.BWD_MIN_HITS * 30 * 40


def mirror_grad_value(grad_out, value, shapes, loc, attn, plan):
    """The value gradient as the kernel's blocks build it: per (item, head,
    run of `plan.queries` queries), the corner terms w_corner * (attn *
    grad_out) of a planned level into a block-local buffer that is added
    to the gradient once at the end, those of any other level straight into
    the gradient; a corner outside the level takes nothing."""
    n, s, m, d = value.shape
    lq = loc.shape[1]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    gv = torch.zeros(n, s, m, d)
    for b in range(n):
        for head in range(m):
            for q0 in range(0, lq, plan.queries):
                qs = slice(q0, min(lq, q0 + plan.queries))
                local = {lv: torch.zeros(shapes[lv][0] * shapes[lv][1], d)
                         for lv in plan.levels}
                g = grad_out[b, qs, head]                     # (q, D)
                for lv, (h, w) in enumerate(shapes):
                    x = loc[b, qs, head, lv, :, 0] * w - 0.5  # (q, P)
                    y = loc[b, qs, head, lv, :, 1] * h - 0.5
                    x0, y0 = torch.floor(x), torch.floor(y)
                    dx, dy = x - x0, y - y0
                    a = attn[b, qs, head, lv]
                    dest = local.get(lv, gv[b, starts[lv]:starts[lv + 1],
                                            head])
                    for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                        ix, iy = x0.long() + cx, y0.long() + cy
                        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                        wc = ((dx if cx else 1 - dx)
                              * (dy if cy else 1 - dy))
                        term = wc[..., None] * (a[..., None] * g[:, None])
                        dest.index_add_(0, (iy * w + ix)[ok], term[ok])
                for lv, buf in local.items():                 # the flush
                    gv[b, starts[lv]:starts[lv + 1], head] += buf
    return gv


@pytest.mark.parametrize("n, lq, m, d, shapes, planned", [
    (2, 3000, 2, 6, ((30, 40), (5, 7)), (1,)),   # one level planned
    (1, 1000, 2, 8, ((4, 5), (3, 4)), (0, 1)),   # every level planned
    (2, 600, 2, 4, ((30, 40), (20, 25)), ()),    # none: all direct
])
def test_block_mirror_lands_every_corner_term_once(n, lq, m, d, shapes,
                                                   planned):
    rng = np.random.default_rng(23)
    s = sum(h * w for h, w in shapes)
    p = 4
    value = torch.from_numpy(
        rng.standard_normal((n, s, m, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.3, 1.3, (n, lq, m, len(shapes), p,
                                                   2)).astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0.1, 1.0, (n, lq, m, len(shapes),
                                                   p)).astype(np.float32))
    grad_out = torch.from_numpy(
        rng.standard_normal((n, lq, m, d)).astype(np.float32))
    plan = msda.bwd_plan(n, lq, m, p, d, shapes)
    assert plan.levels == planned
    assert (lq + plan.queries - 1) // plan.queries > 1  # several runs
    got = mirror_grad_value(grad_out, value, shapes, loc, attn, plan)
    v = value.clone().requires_grad_(True)
    out = msda.ms_deform_attn_plain(v, shapes, loc, attn)
    want, = torch.autograd.grad(out, v, grad_out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    # samples fell outside the levels, and the gradient is not all zero
    assert bool(((loc < 0) | (loc > 1)).any()) and want.abs().max() > 0.1
