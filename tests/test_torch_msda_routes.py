"""The port's last four MSDA variants and the routes that reach them
(trackformer_tpu_torch.ops) held against the JAX package on the CPU.

  * `dense_level_pallas_v4`, `dense_level_pallas_v4p` (with a spatial sort
    and with a random permutation), `dense_level_pallas_v3`,
    `ms_deform_attn_pallas` and `msda_patch_v6` against their JAX
    counterparts, whose Pallas kernels run in interpret mode: forward, with
    samples outside [0, 1] and a tile whose samples all lie outside; for
    the three differentiable kinds the three gradients against `jax.grad`;
  * `spatial_sort_perm`, `snake_bucket_perm`, `v4_ranges` and `v6_walk`
    equal the JAX values element for element (the JAX wrappers compute
    their ranges inline and hand them to `pallas_call`: the tests read them
    there);
  * the plain bounds are exact: zeroing every value cell outside a tile's
    `v4_ranges` / `v3_windows` / `v6_walk` leaves the tile's result as it
    was;
  * routes "v4" (sorted and unsorted) and `MSDA_DEC_SKIP` of
    `ms_deform_attn` send the levels to the per-level function, with the
    permutation and chunk width, that the JAX routing sends them to, and
    equal the default route.

The CUDA kernels cannot run in this CPU suite (`chip_smoke.py` holds them
against the plain versions on the card): on CPU tensors every wrapper is its
plain version. Tolerances: float32 on both sides, sums in different orders:
forward 1e-5 absolute and relative, gradients 1e-4.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops import msda as jmsda
from trackformer_tpu.ops import msda_dense as jdense
from trackformer_tpu.ops import msda_pallas as jpallas
from trackformer_tpu.ops import msda_patch as jpatch
from trackformer_tpu_torch.ops import (cuda_build, msda, msda_dense,
                                       msda_pallas, msda_patch, window_attn)

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
H, W = 9, 13
N, M, P = 2, 2, 4
LQ = 37


def level_inputs(seed, d, oob, lq=LQ, h=H, w=W, n=N):
    """One level's inputs; with `oob` samples reach outside [0, 1] and the
    first eight queries (one tile of 8) sample wholly outside the level."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((n, h * w, M, d)).astype(np.float32)
    lo, hi = (-0.4, 1.4) if oob else (0.0, 1.0)
    loc = rng.uniform(lo, hi, (n, lq, M, P, 2)).astype(np.float32)
    if oob:
        loc[:, :8] = rng.uniform(1.2, 1.5, loc[:, :8].shape)
    attn = rng.uniform(0.1, 1.0, (n, lq, M, P)).astype(np.float32)
    grad_out = rng.standard_normal((n, lq, M, d)).astype(np.float32)
    return value, loc, attn, grad_out


def close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=name)


def level_perm(perm_kind, loc):
    """(N, Lq) permutation for the v4p cases: the JAX spatial sort of `loc`
    or a random one."""
    if perm_kind == "sorted":
        return np.asarray(jdense.spatial_sort_perm(jnp.asarray(loc), H, W))
    rng = np.random.default_rng(5)
    return np.stack([rng.permutation(loc.shape[1])
                     for _ in range(loc.shape[0])])


def level_pair(kind, perm_kind, loc, public):
    """(JAX function, port function) of (value_l, loc_l, attn_l) for one
    per-level kind at level (H, W). The JAX side is the differentiable
    public function when `public`, else its forward with tiles of 8 queries
    and 2 rows, so that the walks have several steps."""
    h, w = H, W
    small = dict(tq=8, rows_per_tile=2, interpret=True)
    if kind == "v4":
        jfn = (lambda v, lo, a: jdense.dense_level_pallas_v4(
                   v, lo, a, h, w, True)) if public else \
            (lambda v, lo, a: jdense._dense_level_pallas_v4_fwd(
                v, lo, a, h, w, **small))
        return jfn, lambda v, lo, a: msda_dense.dense_level_pallas_v4(
            v, lo, a, h, w)
    if kind == "v4p":
        perm = level_perm(perm_kind, loc)
        jfn = (lambda v, lo, a: jdense.dense_level_pallas_v4p(
                   v, lo, a, jnp.asarray(perm), h, w, 8, True)) if public \
            else (lambda v, lo, a: jdense._dense_level_pallas_v4_fwd(
                v, lo, a, h, w, cw=8, perm=jnp.asarray(perm), **small))
        return jfn, lambda v, lo, a: msda_dense.dense_level_pallas_v4p(
            v, lo, a, torch.from_numpy(perm.copy()).long(), h, w, 8)
    assert kind == "v3"
    jfn = (lambda v, lo, a: jdense.dense_level_pallas_v3(
               v, lo, a, h, w, True)) if public else \
        (lambda v, lo, a: jdense._dense_level_pallas_v3_fwd(
            v, lo, a, h, w, cw=8, **small))
    return jfn, lambda v, lo, a: msda_dense.dense_level_pallas_v3(
        v, lo, a, h, w, cw=8)


LEVEL_KINDS = [("v4", None), ("v4p", "sorted"), ("v4p", "random"),
               ("v3", None)]
KIND_IDS = ["v4", "v4p_sorted", "v4p_random_perm", "v3"]


@pytest.mark.parametrize("d", [8, 36])
@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
@pytest.mark.parametrize("kind, perm_kind", LEVEL_KINDS, ids=KIND_IDS)
def test_level_forward_matches_jax_kernel(kind, perm_kind, oob, d):
    value, loc, attn, _ = level_inputs(41, d, oob)
    jfn, tfn = level_pair(kind, perm_kind, loc, public=False)
    want = jfn(*map(jnp.asarray, (value, loc, attn)))
    got = tfn(*map(torch.from_numpy, (value, loc, attn)))
    assert got.shape == (N, LQ, M, d) and got.dtype == torch.float32
    close(got, want)
    if oob:     # the tile whose samples all lie outside adds nothing
        assert bool((got[:, :8] == 0).all())


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
@pytest.mark.parametrize("kind, perm_kind", LEVEL_KINDS, ids=KIND_IDS)
def test_level_gradients_match_jax(kind, perm_kind, oob):
    value, loc, attn, g = level_inputs(43, 8, oob)
    jfn, tfn = level_pair(kind, perm_kind, loc, public=True)
    want = jax.grad(lambda v, lo, a: jnp.sum(jfn(v, lo, a) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (value, loc, attn)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (value, loc, attn)]
    got = torch.autograd.grad(tfn(*leaves), leaves, torch.from_numpy(g))
    for a, b, name in zip(got, want, ("value", "loc", "attn")):
        close(a, b, GRAD_TOL, name)


# --------------------------------------------------------------------------
# all-levels ops: the precomputed-rows gather and the flat chunk walk
# --------------------------------------------------------------------------

SHAPES = ((12, 16), (6, 8))
S = sum(h * w for h, w in SHAPES)        # 240 = 15 tiles of 16


def op_inputs(seed, d, oob, lq, shapes=SHAPES, clustered=False):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((N, s, M, d)).astype(np.float32)
    if clustered:
        pos = []
        for h, w in shapes:
            yy, xx = np.mgrid[0:h, 0:w]
            pos.append(np.stack([(xx.ravel() + 0.5) / w,
                                 (yy.ravel() + 0.5) / h], -1))
        loc = np.concatenate(pos)[None, :, None, None, None, :] + rng.normal(
            0, 0.05, (N, lq, M, len(shapes), P, 2))
    else:
        lo, hi = (-0.4, 1.4) if oob else (0.0, 1.0)
        loc = rng.uniform(lo, hi, (N, lq, M, len(shapes), P, 2))
    attn = rng.uniform(0.1, 1.0, (N, lq, M, len(shapes), P))
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    grad_out = rng.standard_normal((N, lq, M, d)).astype(np.float32)
    return value, loc.astype(np.float32), attn.astype(np.float32), grad_out


@pytest.mark.parametrize("d", [8, 36])
@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
def test_ms_deform_attn_pallas_matches_jax_kernel(oob, d):
    value, loc, attn, _ = op_inputs(3, d, oob, lq=11)
    want = jpallas.ms_deform_attn_pallas(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn),
        True)
    tv, tl, ta = map(torch.from_numpy, (value, loc, attn))
    got = msda_pallas.ms_deform_attn_pallas(tv, SHAPES, tl, ta)
    assert got.shape == (N, 11, M * d)
    close(got, want)
    close(got, msda.ms_deform_attn(tv, SHAPES, tl, ta))
    # the operands are the JAX wrapper's: indices and folded weights
    jidx, jw = jmsda._corner_indices_weights(SHAPES, jnp.asarray(loc),
                                             jnp.asarray(attn))
    idx, w = msda_pallas.corner_indices_weights(SHAPES, tl, ta)
    nm_off = (np.arange(N)[:, None] * M + np.arange(M)[None, :]) * S
    assert np.array_equal(
        idx.numpy(), np.asarray(jidx) - nm_off[:, None, :, None, None, None])
    close(w, jw, 1e-6)


def test_ms_deform_attn_pallas_is_forward_only():
    value, loc, attn, _ = op_inputs(3, 8, False, lq=5)
    tv, tl, ta = map(torch.from_numpy, (value, loc, attn))
    tl.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        msda_pallas.ms_deform_attn_pallas(tv, SHAPES, tl, ta)
    with torch.no_grad():
        assert not msda_pallas.ms_deform_attn_pallas(
            tv, SHAPES, tl, ta).requires_grad


@pytest.mark.parametrize("d", [8, 36])
@pytest.mark.parametrize("case", ["uniform", "out_of_range", "clustered"])
def test_msda_patch_v6_matches_jax_kernel(case, d):
    value, loc, attn, _ = op_inputs(7, d, case == "out_of_range", lq=S,
                                    clustered=case == "clustered")
    want = jpatch._msda_patch_v6_fwd(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn),
        tq=48, ph=4, pw=8, nslots=3, interpret=True)
    got = msda_patch.msda_patch_v6(
        *map(torch.from_numpy, (value,)), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(attn))
    assert got.shape == (N, S, M, d) and got.dtype == torch.float32
    close(got, want)
    with pytest.raises(ValueError, match="Lq == S"):
        msda_patch.msda_patch_v6(
            torch.from_numpy(value), SHAPES, torch.from_numpy(loc[:, :5]),
            torch.from_numpy(attn[:, :5]))


@pytest.mark.parametrize("case", ["out_of_range", "clustered"])
def test_msda_patch_v6_gradients_match_jax(case):
    value, loc, attn, g = op_inputs(9, 8, case == "out_of_range", lq=S,
                                    clustered=case == "clustered")
    want = jax.grad(
        lambda v, lo, a: jnp.sum(jpatch.msda_patch_v6(v, SHAPES, lo, a, True)
                                 * jnp.asarray(g)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (value, loc, attn)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (value, loc, attn)]
    out = msda_patch.msda_patch_v6(leaves[0], SHAPES, leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b, name in zip(got, want, ("value", "loc", "attn")):
        close(a, b, GRAD_TOL, name)


# --------------------------------------------------------------------------
# permutations, ranges and walks equal the JAX values
# --------------------------------------------------------------------------

def clustered_level(seed, h, w, lq, sigma, step=37):
    """Queries that sample near a raster position each: scrambled ones, or
    with `step` 1 consecutive ones as encoder queries do."""
    rng = np.random.default_rng(seed)
    base = (np.arange(lq) * step) % (h * w)
    centre = np.stack([(base % w + 0.5) / w, (base // w + 0.5) / h], -1)
    loc = (centre[None, :, None, None, :]
           + rng.normal(0, sigma, (N, lq, M, P, 2))).astype(np.float32)
    return loc


@pytest.mark.parametrize("sigma", [0.02, 0.5], ids=["narrow", "wide_oob"])
def test_spatial_sort_perm_equals_jax(sigma):
    h, w = 30, 41
    loc = clustered_level(53, h, w, 200, sigma)
    want = np.asarray(jdense.spatial_sort_perm(jnp.asarray(loc), h, w))
    got = msda_dense.spatial_sort_perm(torch.from_numpy(loc), h, w)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # many queries share a bucket: the order among them is the stable one
    assert len(np.unique(want[0])) == 200


@pytest.mark.parametrize("shapes", [SHAPES, ((9, 13), (5, 7), (3, 4)),
                                    ((25, 42), (13, 21))])
def test_snake_bucket_perm_equals_jax(shapes):
    want_perm, want_inv = jpatch.snake_bucket_perm(shapes)
    perm, inv = msda_patch.snake_bucket_perm(shapes)
    assert perm.dtype == np.int32
    assert np.array_equal(perm, want_perm) and np.array_equal(inv, want_inv)


def capture_pallas_operands(monkeypatch, fn):
    """Runs `fn` eagerly with `pallas_call` replaced by a recorder: -> the
    operands the JAX wrapper hands its kernel (the scalars first)."""
    seen = []

    def fake_pallas_call(kernel, *, out_shape, **kw):
        def run(*operands):
            seen.extend(np.asarray(x) for x in operands)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(jdense.pl, "pallas_call", fake_pallas_call)
    with jax.disable_jit():
        fn()
    return seen


# every tile `walk_plan` picks for the flagship's D = 36 (lane groups of 9
# lanes, 24 a block, 1, 2, 4 or 8 queries a group), and the small tests'
# 16 (`tests/test_torch_msda_walk.py` holds the plan to these)
WALK_TQS = [16, 24, 48, 96, 192]


@pytest.mark.parametrize("tq", WALK_TQS)
@pytest.mark.parametrize("sigma", [0.03, 0.5], ids=["narrow", "wide_oob"])
@pytest.mark.parametrize("cw", [None, 8, 64])
@pytest.mark.parametrize("sort", [False, True], ids=["raster", "sorted"])
def test_v4_ranges_equal_jax(monkeypatch, sort, cw, sigma, tq):
    h, w, lq = 30, 41, 4 * tq               # Lq a multiple of the tile
    loc = clustered_level(59, h, w, lq, sigma)
    if sigma > 0.1:
        loc[:, :tq] -= 3.0                   # a tile wholly above and left
    value = np.zeros((N, h * w, M, 4), np.float32)
    attn = np.ones((N, lq, M, P), np.float32)
    perm = (np.asarray(jdense.spatial_sort_perm(jnp.asarray(loc), h, w))
            if sort else None)
    operands = capture_pallas_operands(
        monkeypatch, lambda: jdense._dense_level_pallas_v4_fwd(
            *map(jnp.asarray, (value, loc, attn)), h, w, tq=tq,
            rows_per_tile=1, cw=cw,
            perm=None if perm is None else jnp.asarray(perm),
            interpret=True))
    n_q = lq // tq
    jlo, jhi, jxlo, jxhi = operands[0].reshape(4, N, n_q)
    got = msda_dense.v4_ranges(
        torch.from_numpy(loc), h, w, tq, cw,
        None if perm is None else torch.from_numpy(perm)).numpy()
    assert got.shape == (N, n_q, 4)
    # rows_per_tile = 1: the JAX row-tile range is the row range
    assert np.array_equal(got[..., 0], jlo)
    assert np.array_equal(got[..., 1], jhi)
    # JAX chunks are of the width padded to 128 columns; past the level's
    # last column they hold zeros
    chunk = w if cw is None else cw
    jchunk = 128 if cw is None else cw
    assert np.array_equal(got[..., 2] // chunk, jxlo)
    assert np.array_equal(got[..., 3] // chunk,
                          np.minimum(jxhi, (w - 1) // jchunk))
    if sigma > 0.1:
        assert (got[:, 0, 0] > got[:, 0, 1]).all() or sort   # empty walk
    elif cw == 8 and sort and tq == 16:
        assert (got[..., 3] - got[..., 2] < w - 1).any()     # it skips
    elif cw == 8 and sort:
        # a larger sorted tile spans a whole row of 8 x 8 buckets of this
        # level: it skips rows
        assert (got[..., 1] - got[..., 0] < h - 1).all()


@pytest.mark.parametrize("case", ["uniform", "out_of_range", "clustered"])
def test_v6_walk_equals_jax(monkeypatch, case):
    tq, ph, pw = 16, 4, 8
    value, loc, attn, _ = op_inputs(11, 4, case == "out_of_range", lq=S,
                                    clustered=case == "clustered")
    operands = capture_pallas_operands(
        monkeypatch, lambda: jpatch._msda_patch_v6_fwd(
            jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn),
            tq=tq, ph=ph, pw=pw, interpret=True))
    n_q = S // tq
    maxc = msda_patch.v6_max_chunks(SHAPES, ph, pw)
    assert maxc == 3 * 2 + 2 * 1
    jcodes = operands[0][:N * n_q * maxc].reshape(N, n_q, maxc)
    jtotals = operands[0][N * n_q * maxc:].reshape(N, n_q)
    codes, totals = msda_patch.v6_walk(SHAPES, torch.from_numpy(loc), tq, ph,
                                       pw)
    assert codes.dtype == totals.dtype == torch.int32
    assert np.array_equal(totals.numpy(), jtotals)
    used = np.arange(maxc)[None, None] < jtotals[..., None]
    assert np.array_equal(codes.numpy()[used], jcodes[used])
    if case == "clustered":
        assert (jtotals < maxc).any()        # some tile skips chunks


# --------------------------------------------------------------------------
# the plain bounds are exact
# --------------------------------------------------------------------------

def cells_kept(h, w, r_lo, r_hi, c_lo, c_hi):
    rows, cols = torch.arange(h), torch.arange(w)
    return (((rows >= r_lo) & (rows <= r_hi))[:, None]
            & ((cols >= c_lo) & (cols <= c_hi))[None, :])


@pytest.mark.parametrize("sigma", [0.03, 0.5], ids=["narrow", "wide_oob"])
@pytest.mark.parametrize("kind", ["v4_rows", "v4p_chunks", "v3_windows"])
def test_cells_outside_a_tiles_bounds_carry_no_weight(kind, sigma):
    h, w, lq, tq, d = 20, 33, 64, 8, 4
    cw = 16 if kind == "v3_windows" else 8
    loc = torch.from_numpy(clustered_level(
        61, h, w, lq, sigma, step=37 if kind == "v4p_chunks" else 1))
    rng = np.random.default_rng(1)
    value = torch.from_numpy(rng.standard_normal((N, h * w, M, d))
                             .astype(np.float32))
    attn = torch.from_numpy(rng.uniform(0.1, 1, (N, lq, M, P))
                            .astype(np.float32))
    perm = (None if kind == "v4_rows"
            else msda_dense.spatial_sort_perm(loc, h, w))
    if kind == "v3_windows":
        bounds = msda_dense.v3_windows(loc, h, w, perm, tq, cw)
    else:
        bounds = msda_dense.v4_ranges(loc, h, w, tq,
                                      None if kind == "v4_rows" else cw, perm)
    want = msda.level_plain(value, loc, attn, h, w)
    skipped, fitting = 0, 0
    for n in range(N):
        order = torch.arange(lq) if perm is None else perm[n]
        for tile in range(lq // tq):
            b = bounds[n, tile].tolist()
            if kind == "v3_windows":
                r_lo, r_hi, xstart, fits = b
                fitting += fits
                c_lo, c_hi = (xstart, xstart + cw - 1) if fits else (0, w - 1)
                # a tile fits exactly when its occupied columns span <= cw
                x = loc[n, order[tile * tq:(tile + 1) * tq], ..., 0] * w - 0.5
                left = max(0, int(torch.floor(x.min())))
                right = min(w - 1, int(torch.floor(x.max())) + 1)
                assert bool(fits) == (right - left + 1 <= cw), (n, tile)
                assert not fits or (0 <= xstart <= max(left, 0)
                                    and xstart + cw <= w)
            else:
                r_lo, r_hi, c_lo, c_hi = b
            keep = cells_kept(h, w, r_lo, r_hi, c_lo, c_hi)
            skipped += int((~keep).sum())
            q = order[tile * tq:(tile + 1) * tq]
            banded = (value[n:n + 1].reshape(1, h, w, M, d)
                      * keep[None, :, :, None, None]).reshape(1, h * w, M, d)
            got = msda.level_plain(banded, loc[n:n + 1, q], attn[n:n + 1, q],
                                   h, w)
            assert torch.equal(got, want[n:n + 1, q]), (n, tile)
    if sigma < 0.1:
        assert skipped > N * (lq // tq) * h * w // 3   # many cells skipped
        if kind == "v3_windows":
            assert fitting > 0
    elif kind == "v3_windows":
        assert fitting < N * (lq // tq)                # some take full width


def test_v3_windows_at_the_fit_boundary():
    # two tiles of 4 queries on a 6x40 level, cw = 8: the first occupies the
    # columns 10..17 (8: fits, the window starts at 10), the second 10..18
    # (9: full width); a tile at the right border fits with its window
    # pulled back inside the level
    h, w, cw, tq = 6, 40, 8, 4
    x = torch.tensor([[10.2, 12.0, 15.0, 16.5], [10.2, 12.0, 15.0, 17.5],
                      [35.5, 36.0, 38.0, 39.4]]).reshape(1, 12, 1, 1)
    y = torch.full_like(x, 2.3)
    loc = torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1)
    perm = torch.arange(12)[None]
    got = msda_dense.v3_windows(loc, h, w, perm, tq, cw)
    assert got[0].tolist() == [[1, 3, 10, 1], [1, 3, 0, 0], [1, 3, 32, 1]]


def test_chunks_outside_a_tiles_walk_carry_no_weight():
    tq, ph, pw = 16, 4, 8
    value, loc, attn, _ = op_inputs(13, 4, False, lq=S, clustered=True)
    value, loc, attn = map(torch.from_numpy, (value, loc, attn))
    codes, totals = msda_patch.v6_walk(SHAPES, loc, tq, ph, pw)
    perm = torch.from_numpy(msda_patch.snake_bucket_perm(SHAPES)[0]).long()
    want = msda.ms_deform_attn_plain(value, SHAPES, loc, attn)
    starts = [0, SHAPES[0][0] * SHAPES[0][1]]
    skipped = 0
    for tile in range(S // tq):
        keep = torch.zeros(S, dtype=torch.bool)
        for code in codes[0, tile, :int(totals[0, tile])].tolist():
            lvl, cy, cx = code >> 20, (code >> 10) & 1023, code & 1023
            h, w = SHAPES[lvl]
            cells = cells_kept(h, w, cy * ph, cy * ph + ph - 1, cx * pw,
                               cx * pw + pw - 1)
            keep[starts[lvl]:starts[lvl] + h * w] |= cells.reshape(-1)
        skipped += int((~keep).sum())
        q = perm[tile * tq:(tile + 1) * tq]
        got = msda.ms_deform_attn_plain(
            value[:1] * keep[None, :, None, None], SHAPES, loc[:1, q],
            attn[:1, q])
        assert torch.equal(got, want[:1, q]), tile
    assert skipped > 0


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------

def route_inputs(shapes, lq, m=1, d=2, p=1, seed=3):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((1, s, m, d)).astype(np.float32)
    loc = rng.uniform(0, 1, (1, lq, m, len(shapes), p, 2)).astype(np.float32)
    attn = rng.uniform(0.1, 1, (1, lq, m, len(shapes), p)).astype(np.float32)
    return value, loc, attn


def record_level_calls(monkeypatch):
    """Recorders on both sides for the per-level functions of kernel v4:
    -> (jax calls, port calls), each entry (function, h, w, cw, perm)."""
    jax_calls, port_calls = [], []

    def jax_v4p(value_l, loc_l, attn_l, perm, h, w, cw, interpret=False):
        jax_calls.append(("v4p", h, w, cw, np.asarray(perm)))
        return jdense._level_out_gather(value_l, loc_l, attn_l, h, w)

    def jax_v4(value_l, loc_l, attn_l, h, w, interpret=False):
        jax_calls.append(("v4", h, w, None, None))
        return jdense._level_out_gather(value_l, loc_l, attn_l, h, w)

    real_v4p, real_v4 = (msda_dense.dense_level_pallas_v4p,
                         msda_dense.dense_level_pallas_v4)

    def port_v4p(value_l, loc_l, attn_l, perm, h, w, cw):
        port_calls.append(("v4p", h, w, cw, perm.numpy()))
        return real_v4p(value_l, loc_l, attn_l, perm, h, w, cw)

    def port_v4(value_l, loc_l, attn_l, h, w):
        port_calls.append(("v4", h, w, None, None))
        return real_v4(value_l, loc_l, attn_l, h, w)

    monkeypatch.setattr(jdense, "dense_level_pallas_v4p", jax_v4p)
    monkeypatch.setattr(jdense, "dense_level_pallas_v4", jax_v4)
    monkeypatch.setattr(msda_dense, "dense_level_pallas_v4p", port_v4p)
    monkeypatch.setattr(msda_dense, "dense_level_pallas_v4", port_v4)
    return jax_calls, port_calls


def same_calls(port_calls, jax_calls):
    assert len(port_calls) == len(jax_calls)
    for got, want in zip(port_calls, jax_calls):
        assert got[:4] == want[:4]
        assert (got[4] is None) == (want[4] is None)
        if got[4] is not None:
            assert np.array_equal(got[4], want[4])


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("shapes, picked", [
    (((50, 41), (200, 170), (4, 4)), [0]),
    (((4, 4), (50, 41), (200, 170)), [1]),
])
def test_route_v4_takes_the_levels_the_jax_routing_takes(monkeypatch, shapes,
                                                         picked, sort):
    # 50x41: over the dense budget, within the v2 cell limit -> kernel v4;
    # 200x170: too many cells -> the gather path; 4x4: within the budget
    lq = 4096
    for name in ("DENSE_CELL_BUDGET", "PALLAS_V2_MAX_CELLS",
                 "PALLAS_V2_MIN_QUERIES", "PALLAS_DENSE_MAX_CELLS",
                 "PALLAS_V4_CW", "PALLAS_V4_SORT"):
        assert getattr(msda, name) == getattr(jmsda, name), name
    value, loc, attn = route_inputs(shapes, lq)
    jax_calls, port_calls = record_level_calls(monkeypatch)
    monkeypatch.setattr(jmsda, "PALLAS_SKIP_IMPL", "v4")
    monkeypatch.setattr(jmsda, "PALLAS_V4_SORT", sort)
    with jax.disable_jit():     # eager: the recorders see the permutation
        want = jmsda.ms_deform_attn(jnp.asarray(value), shapes,
                                    jnp.asarray(loc), jnp.asarray(attn),
                                    pallas_dense=True)
    tv, tl, ta = map(torch.from_numpy, (value, loc, attn))
    base = msda.ms_deform_attn(tv, shapes, tl, ta)
    assert port_calls == []                       # default route: "v5"
    monkeypatch.setattr(msda, "PALLAS_SKIP_IMPL", "v4")
    monkeypatch.setattr(msda, "PALLAS_V4_SORT", sort)
    got = msda.ms_deform_attn(tv, shapes, tl, ta)
    assert [c[:4] for c in jax_calls] == [
        ("v4p" if sort else "v4", 50, 41, 64 if sort else None)]
    same_calls(port_calls, jax_calls)
    assert msda.v2_levels(1, lq, 1, shapes) == picked
    close(got, want)
    close(got, base)
    # fewer queries than PALLAS_V2_MIN_QUERIES: the default route
    port_calls.clear()
    msda.ms_deform_attn(tv, shapes, tl[:, :100], ta[:, :100])
    assert port_calls == []


@pytest.mark.parametrize("shapes, picked", [
    (((50, 41), (20, 20), (4, 4), (60, 30)), [0, 3]),
    (((4, 4), (50, 41), (20, 20)), [1]),
])
def test_dec_skip_takes_the_levels_the_jax_routing_takes(monkeypatch, shapes,
                                                         picked):
    # budget 100,000 and a v1 limit of 1,000 cells: 50x41 and 60x30 are over
    # both -> kernel v4 with the call's one sort; 20x20 is over the budget,
    # within the v1 limit -> (JAX: v1 kernel; the port: the gather kernel);
    # 4x4 is within the budget
    lq, m = 300, 2
    value, loc, attn = route_inputs(shapes, lq, m=m, p=2, seed=5)
    jax_calls, port_calls = record_level_calls(monkeypatch)
    for mod in (jmsda, msda):
        monkeypatch.setattr(mod, "MSDA_DEC_SKIP", True)
        monkeypatch.setattr(mod, "PALLAS_DENSE_MAX_CELLS", 1000)
    monkeypatch.setattr(msda, "DENSE_CELL_BUDGET", 100_000)
    with jax.disable_jit():     # eager: the recorders see the permutation
        want = jmsda.ms_deform_attn(jnp.asarray(value), shapes,
                                    jnp.asarray(loc), jnp.asarray(attn),
                                    dense_cell_budget=100_000,
                                    pallas_dense=True)
    tv, tl, ta = map(torch.from_numpy, (value, loc, attn))
    assert msda.dec_skip_levels(1, lq, m, shapes) == picked
    got = msda.ms_deform_attn(tv, shapes, tl, ta)
    assert [c[:4] for c in jax_calls] == [
        ("v4p", *shapes[i], 64) for i in picked]
    same_calls(port_calls, jax_calls)
    # one sort per call, from the first such level
    first = shapes[picked[0]]
    assert np.array_equal(port_calls[-1][4], msda_dense.spatial_sort_perm(
        tl[:, :, :, picked[0]], *first).numpy())
    close(got, want)
    monkeypatch.setattr(msda, "MSDA_DEC_SKIP", False)
    assert msda.dec_skip_levels(1, lq, m, shapes) == []
    port_calls.clear()
    close(got, msda.ms_deform_attn(tv, shapes, tl, ta))
    assert port_calls == []
    # with enough queries for a v2 level no level is a dec-skip level
    monkeypatch.setattr(msda, "MSDA_DEC_SKIP", True)
    assert msda.dec_skip_levels(1, msda.PALLAS_V2_MIN_QUERIES, m,
                                shapes) == []


def test_flagship_calls_take_the_routes_the_documents_count():
    levels = ((100, 168), (50, 84), (25, 42), (13, 21))
    s = sum(h * w for h, w in levels)
    assert msda.v2_levels(1, s, 8, levels) == [0, 1, 2, 3]
    assert msda.v2_levels(2, s, 8, levels) == [0, 1, 2, 3]
    saved = msda.MSDA_DEC_SKIP
    try:
        msda.MSDA_DEC_SKIP = True
        for n, lq in ((1, 650), (2, 611), (2, 500)):
            assert msda.dec_skip_levels(n, lq, 8, levels * 2) == [0, 4]
        assert msda.dec_skip_levels(1, s, 8, levels) == []
    finally:
        msda.MSDA_DEC_SKIP = saved


# --------------------------------------------------------------------------
# the build key
# --------------------------------------------------------------------------

def test_build_key_covers_the_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// helpers\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    with_header = cuda_build.CudaLib("k.cu", {}, headers=["common.cuh"])
    without = cuda_build.CudaLib("k.cu", {})
    first = with_header.so_path()
    assert first.parent == cuda_build.BUILD_DIR and first.suffix == ".so"
    assert first == with_header.so_path()
    alone = without.so_path()
    (csrc / "common.cuh").write_text("// helpers, edited\n")
    assert with_header.so_path() != first       # a stale library is not met
    assert without.so_path() == alone
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert without.so_path() != alone
    # every kernel that includes the shared header names it (V4_LIB is the
    # walk of the range-walking, block-skipping, sorted x-windowed and
    # all-levels flat-walk kernels)
    for lib in (msda_dense.V4_LIB, msda_pallas.LIB, msda.BWD_LIB, msda.LIB):
        assert [h.name for h in lib.headers] == [cuda_build.MSDA_COMMON]
        assert f'#include "{cuda_build.MSDA_COMMON}"' in lib.source.read_text()
        assert all(h.is_file() for h in lib.headers)
    # and no source includes a header of `csrc/` that its key leaves out;
    # these five are every source of `csrc/`
    libs = (msda_dense.V4_LIB, msda_pallas.LIB, msda.BWD_LIB, msda.LIB,
            window_attn.LIB)
    assert {lib.source.name for lib in libs} == {
        f.name for f in msda.LIB.source.parent.glob("*.cu")}
    for lib in libs:
        included = set(re.findall(r'#include "([^"]+)"',
                                  lib.source.read_text()))
        assert included == {h.name for h in lib.headers}, lib.source.name
