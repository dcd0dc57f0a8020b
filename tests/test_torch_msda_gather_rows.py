"""The precomputed-rows gather (`ms_deform_attn_pallas`,
trackformer_tpu_torch/ops/msda_pallas.py) on the CPU, against the JAX
package's op, whose Pallas kernel `_msda_kernel` runs in interpret mode.

  * the corner operands follow the JAX wrapper's dtype: with bfloat16 or
    float32 locations and weights, on levels of 6x9, 3x5, 100x168 and
    2x337 (a width that bfloat16 rounds), with samples on cell borders and
    outside the map, the indices and the folded weights equal JAX's
    `_corner_indices_weights` bit for bit, in JAX's wrapper layout too,
    and the op equals the JAX op;
  * the plain versions of the kernels' contract (the corner build in the
    gather's layout, the gather reading the (N, S, M, D) value in place in
    its own dtype) equal the JAX op in float32 and bfloat16, D in {5, 8,
    36}, K in {24, 64}, with samples out of range;
  * the default routes with bfloat16 locations: the port's
    `ms_deform_attn` computes them as float32, as the JAX op's dense
    route does, while the JAX gather routes build bfloat16 corners;
  * the host's plan `gather_plan` (word, lane groups, queries a step,
    corner chunks, passes, warps, steps, grid) at the flagship's calls and
    at odd rows, and the plans it refuses;
  * a plain mirror of the kernel's partition (blocks, warps and steps over
    the queries; lane (group, word); a query's groups on its chunks of
    corners in order, passes of 32 words, its groups added in order at the
    end), with a query for each group and with one query a step, sums
    every (corner, channel) exactly once, writes every channel of every
    query once and equals the plain gather.

The kernels themselves run only on the card (`chip_smoke.py` holds them
against these plain versions there). Tolerances: float32 sums in different
orders, 1e-5 absolute and relative; a bfloat16 output rounds a float32 sum
once on each side, so the two may differ by one bfloat16 ulp (2^-8
relative) where the sums round to different sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops import msda as jmsda
from trackformer_tpu.ops import msda_pallas as jpallas
from trackformer_tpu_torch.ops import msda, msda_pallas

torch.set_num_threads(1)

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -8)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# 100x168 is where bfloat16 locations move corners; bfloat16 rounds 337 to
# 336, which JAX multiplies by
FAULT_SHAPES = ((6, 9), (3, 5), (100, 168), (2, 337))
SHAPES = ((11, 17), (6, 9), (4, 5), (2, 3))


def close(got, want, dtype=torch.float32, name=""):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=rtol, err_msg=name)


def as_torch(x, dtype):
    """A float32 numpy array as a torch tensor of `dtype`."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def fault_inputs(seed, n=1, lq=12, m=2, p=2, d=8):
    """Locations in [-0.2, 1.2] with every fourth sample on a cell border
    (x * W - 0.5 whole) and every fifth on a cell centre, weights of both
    signs; float32 numpy."""
    rng = np.random.default_rng(seed)
    l = len(FAULT_SHAPES)
    loc = rng.uniform(-0.2, 1.2, (n, lq, m, l, p, 2))
    for lvl, (h, w) in enumerate(FAULT_SHAPES):
        size = np.array([w, h])
        cell = rng.integers(-1, size + 1, (n, lq, m, p, 2))
        loc[:, ::4, :, lvl] = ((cell + 0.5) / size)[:, ::4]
        loc[:, 1::5, :, lvl] = ((cell + 1.0) / size)[:, 1::5]
    attn = rng.uniform(-0.5, 1.0, (n, lq, m, l, p))
    s = sum(h * w for h, w in FAULT_SHAPES)
    value = rng.standard_normal((n, s, m, d))
    return (value.astype(np.float32), loc.astype(np.float32),
            attn.astype(np.float32))


@pytest.mark.parametrize("loc_dt,attn_dt", [("bf16", "bf16"), ("f32", "bf16"),
                                            ("bf16", "f32"), ("f32", "f32")])
def test_corners_follow_the_jax_dtype(loc_dt, attn_dt):
    value, loc, attn = fault_inputs(0)
    (tl_dt, jl_dt), (ta_dt, ja_dt) = DTYPES[loc_dt], DTYPES[attn_dt]
    jl, ja = jnp.asarray(loc).astype(jl_dt), jnp.asarray(attn).astype(ja_dt)
    # the same values on both sides: the numpy float32 of JAX's rounding
    tl = as_torch(jl.astype(jnp.float32), tl_dt)
    ta = as_torch(ja.astype(jnp.float32), ta_dt)
    n, lq, m, l, p, _ = loc.shape
    s = value.shape[1]
    jidx, jw = jmsda._corner_indices_weights(FAULT_SHAPES, jl, ja)
    idx, w = msda_pallas.corner_indices_weights(FAULT_SHAPES, tl, ta)
    nm_off = (np.arange(n)[:, None] * m + np.arange(m)[None, :]) * s
    jidx = np.asarray(jidx) - nm_off[:, None, :, None, None, None]
    jw = np.asarray(jw.astype(jnp.float32))
    assert w.dtype == torch.float32
    assert np.array_equal(idx.numpy(), jidx)
    assert np.array_equal(w.numpy().view(np.uint32), jw.view(np.uint32))
    # the gather's layout is the JAX wrapper's
    k = l * p * 4
    gidx, gw = msda_pallas.corner_operands_plain(FAULT_SHAPES, tl, ta)
    assert gidx.dtype == torch.int32 and gidx.shape == (n * m, lq, k)
    assert np.array_equal(gidx.numpy(), jidx.transpose(0, 2, 1, 3, 4, 5)
                          .reshape(n * m, lq, k))
    assert np.array_equal(gw.numpy().view(np.uint32),
                          jw.transpose(0, 2, 1, 3, 4, 5)
                          .reshape(n * m, lq, k).view(np.uint32))
    # and the op is the JAX op
    want = jpallas.ms_deform_attn_pallas(jnp.asarray(value), FAULT_SHAPES,
                                         jl, ja, True)
    got = msda_pallas.ms_deform_attn_pallas(torch.from_numpy(value),
                                            FAULT_SHAPES, tl, ta)
    close(got, want, name=f"{loc_dt} locations, {attn_dt} weights")


def test_default_routes_with_bf16_locations(monkeypatch):
    # both models cast locations and weights to float32 before MSDA; a
    # direct caller with bfloat16 ones gets JAX's dense route from the port
    value, loc, attn = fault_inputs(1, lq=16)
    jl = jnp.asarray(loc).astype(jnp.bfloat16)
    ja = jnp.asarray(attn).astype(jnp.bfloat16)
    tl = as_torch(jl.astype(jnp.float32), torch.bfloat16)
    ta = as_torch(ja.astype(jnp.float32), torch.bfloat16)
    jv = jnp.asarray(value)
    got = msda.ms_deform_attn(torch.from_numpy(value), FAULT_SHAPES, tl, ta)
    as_f32 = jmsda.ms_deform_attn(jv, FAULT_SHAPES, jl.astype(jnp.float32),
                                  ja.astype(jnp.float32))
    close(got, jmsda.ms_deform_attn(jv, FAULT_SHAPES, jl, ja), name="dense")
    close(got, as_f32, name="float32")
    # the JAX gather routes (`ops/msda.py:341` compact, `:365` flat) build
    # the corners in bfloat16: far from the float32 result
    for compact in (True, False):
        monkeypatch.setattr(jmsda, "MSDA_GATHER_COMPACT", compact)
        gathered = jmsda.ms_deform_attn(jv, FAULT_SHAPES, jl, ja,
                                        dense_cell_budget=0)
        assert np.abs(np.asarray(gathered) - np.asarray(as_f32)).max() > 0.1


def op_inputs(seed, d, p, n=2, lq=9, m=2, shapes=SHAPES):
    """value, locations in [-0.3, 1.3] (corners out of range) and positive
    weights normalized per query and head; float32 numpy."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (n, lq, m, len(shapes), p, 2))
    attn = rng.uniform(0.1, 1.0, (n, lq, m, len(shapes), p))
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return value, loc.astype(np.float32), attn.astype(np.float32)


@pytest.mark.parametrize("k", [24, 64])
@pytest.mark.parametrize("d", [5, 8, 36])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_kernels_match_jax_kernel(dt, d, k):
    # K = 24: two levels of three points; K = 64: four levels of four
    shapes, p = (SHAPES[:2], 3) if k == 24 else (SHAPES, 4)
    value, loc, attn = op_inputs(11 + d + k, d, p, shapes=shapes)
    t_dt, j_dt = DTYPES[dt]
    jv = jnp.asarray(value).astype(j_dt)
    tv = as_torch(jv.astype(jnp.float32), t_dt)
    tl, ta = torch.from_numpy(loc), torch.from_numpy(attn)
    want = np.asarray(jpallas.ms_deform_attn_pallas(
        jv, shapes, jnp.asarray(loc), jnp.asarray(attn), True)
        .astype(jnp.float32))
    idx, w = msda_pallas.corner_operands_plain(shapes, tl, ta)
    assert idx.shape == (2 * 2, 9, k)
    plain = msda_pallas.gather_rows_plain(idx, w, tv)
    n, lq, m = loc.shape[:3]
    assert plain.dtype == torch.float32 and plain.shape == (n, lq, m, d)
    close(plain.to(t_dt).reshape(n, lq, m * d), want, t_dt, "gather plain")
    got = msda_pallas.ms_deform_attn_pallas(tv, shapes, tl, ta)
    assert got.dtype == t_dt and got.shape == (n, lq, m * d)
    close(got, want, t_dt, "op")


@pytest.mark.parametrize("d,es,off,word,words,groups,passes,chunk", [
    (36, 2, 0, 8, 9, 3, 1, 44),   # the flagship's bf16 row: 9 x 8 bytes
    (36, 4, 0, 16, 9, 3, 1, 44),  # its float32 row: 9 x 16 bytes
    (36, 2, 2, 2, 36, 1, 2, 128),  # one element off: 2-byte words, 2 passes
    (36, 4, 4, 4, 36, 1, 2, 128),
    (5, 2, 0, 2, 5, 6, 1, 24),
    (5, 4, 0, 4, 5, 6, 1, 24),
    (6, 2, 4, 4, 3, 10, 1, 16),
    (8, 2, 0, 16, 1, 32, 1, 4),   # a row in one word: 32 corners a load
    (160, 4, 0, 16, 40, 1, 2, 128),
])
def test_gather_plan_words_and_lanes(d, es, off, word, words, groups, passes,
                                     chunk):
    k = 128
    plan = msda_pallas.gather_plan(1, 650, 8, k, d, es, 4096 + off)
    assert (plan.word, plan.words, plan.groups, plan.passes, plan.chunk) == (
        word, words, groups, passes, chunk)
    assert plan.words * plan.word == d * es
    assert min(plan.words, 32) * plan.groups <= 32
    assert plan.passes * min(plan.words, 32) >= plan.words
    # the chunks cover the corners, each the fewest 16-byte loads that do
    assert plan.chunk % 4 == 0
    assert plan.chunk - 4 < -(-k // plan.groups) <= plan.chunk


def test_gather_plan_at_the_flagship_calls():
    # the captured encoder call: 22,323 queries, 8 heads, K = 64: a query
    # for each of the three lane groups
    enc = msda_pallas.gather_plan(1, 22323, 8, 64, 36, 2, 0)
    assert (enc.groups, enc.qstep, enc.chunk) == (3, 3, 64)
    assert (enc.warps, enc.smem_bytes) == (4, 4 * 3 * (8 * 64 + 16))
    assert enc.grid == (-(-22323 // (4 * 3)), 8)
    assert enc.grid[0] * enc.grid[1] >= 8 * msda_pallas.GATHER_SMS
    # the decoder call: 650 queries, K = 128: too few to fill the card with
    # a query a group, so one query a warp, its corners in three chunks
    dec = msda_pallas.gather_plan(1, 650, 8, 128, 36, 2, 0)
    assert (dec.groups, dec.qstep, dec.chunk) == (3, 1, 44)
    assert (dec.warps, dec.smem_bytes) == (4, 4 * (8 * 128 + 16))
    assert dec.grid == (163, 8)
    # every query is in a tile
    for plan, lq in ((enc, 22323), (dec, 650)):
        assert plan.grid[0] * plan.warps * plan.qstep >= lq
        assert plan.smem_bytes <= msda_pallas.GATHER_SMEM
    # the corner buffers set the warps and the queries a warp
    for k, qstep, warps in ((1024, 3, 1), (768, 1, 4), (4096, 1, 1)):
        plan = msda_pallas.gather_plan(1, 650, 8, k, 36, 2, 0)
        assert (plan.qstep, plan.warps) == (qstep, warps), k
    wide = msda_pallas.gather_plan(8, 22323, 8, 128, 8, 2, 0)
    assert (wide.groups, wide.qstep, wide.chunk) == (32, 32, 128)
    assert wide.smem_bytes <= msda_pallas.GATHER_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        msda_pallas.gather_plan(1, 650, 8, 8192, 36, 2, 0)
    with pytest.raises(ValueError, match="aligned"):
        msda_pallas.gather_plan(1, 650, 8, 64, 36, 2, 1)


def mirror_gather(idx, w, value, plan):
    """The kernel's partition, lane by lane: warp w of block (tile, b)
    takes queries (tile * warps + w) * qstep + [0, qstep); in each pass
    lane (g, jl) loads word j = jl + pass * lanes
    of the rows of corners [c * chunk, (c + 1) * chunk) of query g // r,
    c = g % r, r = groups / qstep, in order, into float32 sums of its
    word's elements; the query's first group adds the others' sums in
    order and writes word j. -> (N, Lq, M, D) float32; per (b, q, k,
    channel) the times it was summed; per (q, channel) the times it was
    written."""
    n, s, m, d = value.shape
    b, lq, k = idx.shape
    e = plan.word // value.element_size()
    lanes = min(plan.words, 32)
    r = plan.groups // plan.qstep
    table = value.float().permute(0, 2, 1, 3).reshape(b, s, d).numpy()
    idx, w = idx.numpy(), w.numpy()
    out = np.zeros((b, lq, d), np.float32)
    summed = np.zeros((b, lq, k, d), np.int64)
    written = np.zeros((lq, d), np.int64)
    bi = np.arange(b)
    starts = [(tile * plan.warps + warp) * plan.qstep
              for tile in range(plan.grid[0]) for warp in range(plan.warps)]
    for q0, pas in ((q0, pas) for q0 in starts for pas in range(plan.passes)):
        sums = {}
        for lane in range(lanes * plan.groups):
            g, jl = lane // lanes, lane % lanes
            q, c, j = q0 + g // r, g % r, jl + pas * lanes
            acc = np.zeros((b, e), np.float32)
            if q < lq and j < plan.words:
                ch = slice(j * e, (j + 1) * e)
                for kk in range(c * plan.chunk, min(k, (c + 1) * plan.chunk)):
                    acc = acc + w[:, q, kk, None] * table[bi, idx[:, q, kk], ch]
                    summed[:, q, kk, ch] += 1
            sums[g, jl] = acc
        for g, jl in ((g, jl) for g in range(0, plan.groups, r)
                      for jl in range(lanes)):
            q, j = q0 + g // r, jl + pas * lanes
            if q < lq and j < plan.words:
                total = sums[g, jl]
                for rr in range(1, r):
                    total = total + sums[g + rr, jl]
                out[:, q, j * e:(j + 1) * e] = total
                written[q, j * e:(j + 1) * e] += 1
    out = out.reshape(n, m, lq, d).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(out)), summed, written


@pytest.mark.parametrize("d,dt,off", [(36, "bf16", 0), (36, "f32", 0),
                                      (36, "bf16", 2), (5, "bf16", 0),
                                      (5, "f32", 0), (8, "bf16", 0),
                                      (160, "f32", 0)])
@pytest.mark.parametrize("k", [24, 64])
@pytest.mark.parametrize("sms", [0, 132], ids=["query_a_group",
                                              "query_a_step"])
def test_partition_mirror_sums_every_corner_once(sms, k, d, dt, off):
    shapes, p = (SHAPES[:2], 3) if k == 24 else (SHAPES, 4)
    value, loc, attn = op_inputs(5, d, p, lq=5, shapes=shapes)
    t_dt = DTYPES[dt][0]
    tv = torch.from_numpy(value).to(t_dt)
    idx, w = msda_pallas.corner_operands_plain(
        shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    plan = msda_pallas.gather_plan(2, 5, 2, k, d, tv.element_size(),
                                   4096 + off * tv.element_size(), sms)
    assert plan.qstep == (plan.groups if sms == 0 else 1)
    got, summed, written = mirror_gather(idx, w, tv, plan)
    assert (summed == 1).all() and (written == 1).all()
    close(got, msda_pallas.gather_rows_plain(idx, w, tv), name="mirror")
