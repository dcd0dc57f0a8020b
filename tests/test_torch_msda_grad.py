"""Gradients and the block-skipping level of the port's MSDA
(trackformer_tpu_torch.ops) held against the JAX package on the CPU.

  * gradients of `ms_deform_attn`, `dense_level_pallas` and
    `dense_level_pallas_v2` (on CPU tensors: autograd through the plain
    version) against `jax.grad` of the JAX ops, whose Pallas forwards run
    in interpret mode and whose backward is the gather formulation's, with
    samples inside and outside [0, 1];
  * `dense_level_pallas_v2` forward against the v2 Pallas kernel in
    interpret mode at the shapes of the JAX package's own v2 tests;
  * `v2_row_band`: zeroing every value row outside a tile's band leaves the
    tile's result unchanged (the skip is exact);
  * route "v2" of `ms_deform_attn` sends the levels to the block-skipping
    function that the JAX routing sends there (route "v4" and
    `MSDA_DEC_SKIP`: tests/test_torch_msda_routes.py).

The CUDA kernels cannot run in this CPU suite; `chip_smoke.py` holds them
against the plain versions on the card. Tolerance: float32 on both sides,
sums in different orders: 1e-5 absolute and relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops import msda as jmsda
from trackformer_tpu.ops import msda_dense as jdense
from trackformer_tpu_torch.ops import (msda, msda_dense, msda_pallas,
                                       msda_patch)

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = ((9, 13), (5, 7))
N, M, D, LQ, P = 2, 2, 4, 37, 4


def make_inputs(seed=0, oob=False, shapes=SHAPES, lq=LQ):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((N, s, M, D)).astype(np.float32)
    lo, hi = (-0.4, 1.4) if oob else (0.0, 1.0)
    loc = rng.uniform(lo, hi, (N, lq, M, len(shapes), P, 2)) \
        .astype(np.float32)
    attn = rng.uniform(0.1, 1.0, (N, lq, M, len(shapes), P)) \
        .astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    grad_out = rng.standard_normal((N, lq, M, D)).astype(np.float32)
    return value, loc, attn, grad_out


def leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
def test_ms_deform_attn_gradients_match_jax(oob):
    value, loc, attn, g = make_inputs(seed=5, oob=oob)

    def f(v, lo, a):
        # every level through the v1 Pallas kernel (interpret mode), whose
        # custom_vjp differentiates the gather formulation
        out = jmsda.ms_deform_attn(v, SHAPES, lo, a, dense_cell_budget=1,
                                   pallas_dense=True)
        return jnp.sum(out * jnp.asarray(g).reshape(N, LQ, M * D))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray,
                                               (value, loc, attn)))
    tv, tl, ta = leaves(value, loc, attn)
    out = msda.ms_deform_attn(tv, SHAPES, tl, ta)
    got = torch.autograd.grad(out, (tv, tl, ta),
                              torch.from_numpy(g).reshape(N, LQ, M * D))
    for a, b, name in zip(got, want, ("value", "loc", "attn")):
        close(a, b, name)
    if oob:
        # a sample with every corner out of range passes no gradient
        x = loc[..., 0] * np.array([w for _, w in SHAPES])[:, None] - 0.5
        far = torch.from_numpy(x < -1.0)
        assert far.any() and bool((got[1][far] == 0).all())
        assert bool((got[2][far] == 0).all())


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
@pytest.mark.parametrize("fn", ["dense_level_pallas",
                                "dense_level_pallas_v2"])
def test_level_gradients_match_jax(fn, oob):
    value, loc, attn, g = make_inputs(seed=7, oob=oob)
    h, w = SHAPES[0]
    value_l, loc_l, attn_l = value[:, :h * w], loc[:, :, :, 0], \
        attn[:, :, :, 0]
    jfn = getattr(jdense, fn)

    def f(v, lo, a):
        return jnp.sum(jfn(v, lo, a, h, w, True) * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray,
                                               (value_l, loc_l, attn_l)))
    tv, tl, ta = leaves(value_l, loc_l, attn_l)
    out = getattr(msda_dense, fn)(tv, tl, ta, h, w)
    close(out, jfn(*map(jnp.asarray, (value_l, loc_l, attn_l)), h, w, True),
          "forward")
    got = torch.autograd.grad(out, (tv, tl, ta), torch.from_numpy(g))
    for a, b, name in zip(got, want, ("value", "loc", "attn")):
        close(a, b, name)


@pytest.mark.parametrize("oob", [False, True], ids=["inside", "out_of_range"])
@pytest.mark.parametrize("lvl", [0, 1])
def test_dense_level_v2_matches_v2_kernel(lvl, oob):
    value, loc, attn, _ = make_inputs(seed=13, oob=oob)
    h, w = SHAPES[lvl]
    start = sum(a * b for a, b in SHAPES[:lvl])
    value_l = value[:, start:start + h * w]
    loc_l, attn_l = loc[:, :, :, lvl], attn[:, :, :, lvl]
    want = jdense._dense_level_pallas_v2_fwd(
        *map(jnp.asarray, (value_l, loc_l, attn_l)), h, w, interpret=True)
    got = msda_dense.dense_level_pallas_v2(
        *map(torch.from_numpy, (value_l, loc_l, attn_l)), h, w)
    assert got.shape == (N, LQ, M, D) and got.dtype == torch.float32
    close(got, want)


def clustered_level(seed, h, w, lq, m, d, p, sigma=0.03):
    """Each query samples near its own raster position, as encoder
    queries do."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((1, h * w, m, d)).astype(np.float32)
    base = np.arange(lq) % (h * w)
    centre = np.stack([(base % w + 0.5) / w, (base // w + 0.5) / h], -1)
    loc = (centre[None, :, None, None, :]
           + rng.normal(0, sigma, (1, lq, m, p, 2))).astype(np.float32)
    attn = rng.uniform(0.1, 1.0, (1, lq, m, p)).astype(np.float32)
    return value, loc, attn


def test_dense_level_v2_matches_v2_kernel_while_it_skips():
    h, w = 12, 9
    value, loc, attn = clustered_level(17, h, w, 50, 2, 4, 4)
    want = jdense._dense_level_pallas_v2_fwd(
        *map(jnp.asarray, (value, loc, attn)), h, w, tq=8, rows_per_tile=2,
        interpret=True)
    got = msda_dense.dense_level_pallas_v2(
        *map(torch.from_numpy, (value, loc, attn)), h, w)
    close(got, want)


@pytest.mark.parametrize("sigma", [0.03, 0.5], ids=["narrow", "wide_oob"])
def test_rows_outside_the_band_carry_no_weight(sigma):
    h, w, lq, tq = 12, 9, 50, 8
    value, loc, attn = map(torch.from_numpy,
                           clustered_level(19, h, w, lq, 2, 4, 4, sigma))
    band = msda_dense.v2_row_band(loc, h, tq)
    assert band.shape == (1, -(-lq // tq), 2)
    # the bound of the JAX forward: floor(min y) - 1 .. floor(max y) + 1
    y = loc[..., 1] * h - 0.5
    first = y[0, :tq]
    assert band[0, 0].tolist() == [int(torch.floor(first.min())) - 1,
                                   int(torch.floor(first.max())) + 1]
    want = msda.level_plain(value, loc, attn, h, w)
    rows = torch.arange(h)
    skipped = 0
    for tile in range(band.shape[1]):
        lo, hi = band[0, tile].tolist()
        keep = (rows >= lo) & (rows <= hi)
        skipped += int((~keep).sum())
        banded = value.reshape(1, h, w, 2, 4) * keep[None, :, None, None,
                                                     None]
        q = slice(tile * tq, (tile + 1) * tq)
        got = msda.level_plain(banded.reshape(value.shape), loc[:, q],
                               attn[:, q], h, w)
        assert torch.equal(got, want[:, q])
    if sigma < 0.1:
        assert skipped > band.shape[1] * h // 2   # most rows are skipped


@pytest.mark.parametrize("shapes, picked", [
    (((50, 41), (200, 170), (4, 4)), [0]),    # the rest: a run of levels
    (((4, 4), (50, 41), (200, 170)), [1]),    # the rest: levels 0 and 2
])
def test_route_v2_takes_the_levels_the_jax_routing_takes(monkeypatch, shapes,
                                                         picked):
    # 50x41: over the dense budget, within the v2 cell limit -> v2;
    # 200x170: too many cells -> the gather path; 4x4: within the
    # budget -> (JAX: dense XLA product; the port: the gather kernel)
    n, lq, m, d, p = 1, 4096, 1, 2, 1
    assert (msda.DENSE_CELL_BUDGET, msda.PALLAS_V2_MAX_CELLS,
            msda.PALLAS_V2_MIN_QUERIES) == (
        jmsda.DENSE_CELL_BUDGET, jmsda.PALLAS_V2_MAX_CELLS,
        jmsda.PALLAS_V2_MIN_QUERIES)
    rng = np.random.default_rng(3)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    loc = rng.uniform(0, 1, (n, lq, m, 3, p, 2)).astype(np.float32)
    attn = rng.uniform(0.1, 1, (n, lq, m, 3, p)).astype(np.float32)

    jax_calls, port_calls = [], []

    def jax_recorder(value_l, loc_l, attn_l, h, w, interpret=False):
        jax_calls.append((h, w))
        return jdense._level_out_gather(value_l, loc_l, attn_l, h, w)

    real_v2 = msda_dense.dense_level_pallas_v2

    def port_recorder(value_l, loc_l, attn_l, h, w):
        port_calls.append((h, w))
        return real_v2(value_l, loc_l, attn_l, h, w)

    monkeypatch.setattr(jdense, "dense_level_pallas_v2", jax_recorder)
    monkeypatch.setattr(jmsda, "PALLAS_SKIP_IMPL", "v2")
    monkeypatch.setattr(msda_dense, "dense_level_pallas_v2", port_recorder)
    jmsda.ms_deform_attn.clear_cache()
    try:
        want = jmsda.ms_deform_attn(*map(jnp.asarray, (value,)), shapes,
                                    jnp.asarray(loc), jnp.asarray(attn),
                                    pallas_dense=True)
    finally:
        jmsda.ms_deform_attn.clear_cache()
    tv, tl, ta = map(torch.from_numpy, (value, loc, attn))
    base = msda.ms_deform_attn(tv, shapes, tl, ta)
    assert port_calls == []                       # default route: "v5"
    monkeypatch.setattr(msda, "PALLAS_SKIP_IMPL", "v2")
    got = msda.ms_deform_attn(tv, shapes, tl, ta)
    assert jax_calls == [(50, 41)]
    assert port_calls == jax_calls
    assert msda.v2_levels(n, lq, m, shapes) == picked
    # fewer queries than PALLAS_V2_MIN_QUERIES: no level is a v2 level
    assert msda.v2_levels(n, lq - 1, m, shapes) == []
    close(got, want)
    close(got, base)


def test_unknown_route_raises(monkeypatch):
    # routes "v2" and "v4" are held in test_route_v2_... above and in
    # tests/test_torch_msda_routes.py
    value, loc, attn, _ = make_inputs()
    monkeypatch.setattr(msda, "PALLAS_SKIP_IMPL", "v7")
    with pytest.raises(ValueError, match="PALLAS_SKIP_IMPL"):
        msda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                            torch.from_numpy(loc), torch.from_numpy(attn))


def test_new_cuda_launchers_refuse_cpu_tensors():
    # a CUDA call either launches its kernel or raises: no plain fallback
    value, loc, attn, g = make_inputs()
    tv, tl, ta, tg = map(torch.from_numpy, (value, loc, attn, g))
    before = msda.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        msda.msda_bwd_cuda(tg, tv, SHAPES, tl, ta)
    h, w = SHAPES[0]
    with pytest.raises(ValueError, match="CUDA"):
        msda_dense.dense_level_v2_fwd_cuda(
            tv[:, :h * w].contiguous(), tl[:, :, :, 0].contiguous(),
            ta[:, :, :, 0].contiguous(), h, w)
    level = (tv[:, :h * w].contiguous(), tl[:, :, :, 0].contiguous(),
             ta[:, :, :, 0].contiguous(), h, w)
    perm = msda_dense.spatial_sort_perm(level[1], h, w)
    for call in (
            lambda: msda_dense.dense_level_v4_fwd_cuda(*level),
            lambda: msda_dense.dense_level_v4_fwd_cuda(*level, perm=perm,
                                                       cw=8),
            lambda: msda_dense.dense_level_v3_fwd_cuda(*level),
            lambda: msda_patch.msda_patch_v6_fwd_cuda(tv, SHAPES, tl, ta),
            lambda: msda_pallas.corner_operands_cuda(SHAPES, tl, ta),
            lambda: msda_pallas.gather_rows_cuda(
                torch.zeros(2, 3, 4, dtype=torch.int32), torch.zeros(2, 3, 4),
                torch.zeros(1, 5, 2, 6), ((1, 5),))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert msda.launch_counts() == before
    assert {"dense_level_pallas_v4", "dense_level_pallas_v3",
            "ms_deform_attn_pallas", "ms_deform_attn_pallas_corners",
            "msda_patch_v6"} <= set(before)


def test_launches_are_counted_by_name_and_by_shape():
    msda.reset_launch_counts()
    try:
        msda.count_launch("msda_bwd", 2, 5, [(1, 2), [3, 4]])
        msda.count_launch("msda_bwd", 2, 5, ((1, 2), (3, 4)))
        msda.count_launch("msda_patch", 1, 7, ((1, 7),))
        assert msda.launch_counts()["msda_bwd"] == 2
        assert msda.launch_shapes() == {
            ("msda_bwd", 2, 5, ((1, 2), (3, 4))): 2,
            ("msda_patch", 1, 7, ((1, 7),)): 1}
    finally:
        msda.reset_launch_counts()
    assert msda.launch_shapes() == {}
    assert set(msda.launch_counts().values()) == {0}
