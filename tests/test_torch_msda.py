"""The port's MSDA (trackformer_tpu_torch.ops) held against the JAX package
on the CPU: the plain version against `ms_deform_attn` and its per-point
reference, the `msda_patch` counterpart against the v5 Pallas kernel and
the `dense_level_pallas` counterpart against the v1 Pallas kernel (both in
interpret mode, as the JAX package's own tests run them), with
out-of-range and negative locations and a ragged query tile.

The CUDA kernel cannot run in this CPU suite (no card, no nvcc);
`chip_smoke.py` holds it against the plain version on the card.
Tolerance: float32 on both sides; the sums run in different orders, so
1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.ops.msda import ms_deform_attn as jax_msda
from trackformer_tpu.ops.msda import ms_deform_attn_reference
from trackformer_tpu.ops.msda_dense import \
    dense_level_pallas as jax_dense_level
from trackformer_tpu.ops.msda_patch import _msda_patch_fwd
from trackformer_tpu_torch.ops import msda
from trackformer_tpu_torch.ops.msda_dense import dense_level_pallas
from trackformer_tpu_torch.ops.msda_patch import msda_patch

torch.set_num_threads(1)

ATOL = 1e-5
ENC_SHAPES = ((9, 13), (5, 7), (3, 4))     # encoder self-pattern, Lq == S
DEC_SHAPES = ((6, 4), (3, 2)) * 2          # two frames of two levels


def make_inputs(shapes, n, lq, m, d, p, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, (n, lq, m, len(shapes), p, 2)) \
        .astype(np.float32)
    attn = rng.uniform(0.1, 1.0, (n, lq, m, len(shapes), p)) \
        .astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return value, loc, attn


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.4, 1.4), (-3.0, -0.5)],
                         ids=["inside", "out_of_range", "negative"])
def test_plain_matches_jax_ms_deform_attn(lo, hi):
    value, loc, attn = make_inputs(DEC_SHAPES, 2, 11, 3, 5, 3, lo=lo, hi=hi)
    (jv, jl, ja), (tv, tl, ta) = both(value, loc, attn)
    want = jax_msda(jv, DEC_SHAPES, jl, ja)
    got = msda.ms_deform_attn(tv, DEC_SHAPES, tl, ta)
    assert got.shape == (2, 11, 15) and got.dtype == torch.float32
    close(got, want)
    close(got, ms_deform_attn_reference(jv, DEC_SHAPES, jl, ja))


def test_plain_matches_reference_at_encoder_pattern():
    n, m, d, p = 1, 2, 4, 4
    s = sum(h * w for h, w in ENC_SHAPES)
    value, loc, attn = make_inputs(ENC_SHAPES, n, s, m, d, p, seed=2,
                                   lo=-0.2, hi=1.2)
    (jv, jl, ja), (tv, tl, ta) = both(value, loc, attn)
    close(msda.ms_deform_attn(tv, ENC_SHAPES, tl, ta),
          ms_deform_attn_reference(jv, ENC_SHAPES, jl, ja))


@pytest.mark.parametrize("tq,lo,hi", [(64, 0.0, 1.0), (48, -0.4, 1.4)],
                         ids=["tile64", "ragged_tile48_oob"])
def test_msda_patch_matches_v5_kernel(tq, lo, hi):
    # S = 164: a 48-query tile leaves a ragged last tile
    n, m, d, p = 2, 2, 4, 4
    s = sum(h * w for h, w in ENC_SHAPES)
    value, loc, attn = make_inputs(ENC_SHAPES, n, s, m, d, p, seed=5,
                                   lo=lo, hi=hi)
    (jv, jl, ja), (tv, tl, ta) = both(value, loc, attn)
    want = _msda_patch_fwd(jv, ENC_SHAPES, jl, ja, tq=tq, interpret=True)
    got = msda_patch(tv, ENC_SHAPES, tl, ta)
    assert got.shape == (n, s, m, d)
    close(got, want)


def test_msda_patch_requires_encoder_pattern():
    value, loc, attn = make_inputs(ENC_SHAPES, 1, 7, 2, 4, 4)
    with pytest.raises(ValueError, match="Lq == S"):
        msda_patch(torch.from_numpy(value), ENC_SHAPES,
                   torch.from_numpy(loc), torch.from_numpy(attn))


@pytest.mark.parametrize("lq,lo,hi", [(37, 0.0, 1.0), (37, -0.4, 1.4),
                                      (300, -1.0, 2.0)])
def test_dense_level_matches_v1_kernel(lq, lo, hi):
    h, w = 9, 13
    value, loc, attn = make_inputs(((h, w),), 2, lq, 2, 4, 4, seed=3,
                                   lo=lo, hi=hi)
    value_l, loc_l, attn_l = value, loc[:, :, :, 0], attn[:, :, :, 0]
    (jv, jl, ja), (tv, tl, ta) = both(value_l, loc_l, attn_l)
    want = jax_dense_level(jv, jl, ja, h, w, True)
    got = dense_level_pallas(tv, tl, ta, h, w)
    assert got.shape == (2, lq, 2, 4)
    close(got, want)


def test_cuda_launcher_refuses_cpu_tensors():
    # a CUDA call either launches the kernel or raises: no plain fallback
    value, loc, attn = make_inputs(DEC_SHAPES, 1, 5, 2, 4, 2)
    before = msda.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        msda.msda_fwd_cuda(torch.from_numpy(value), DEC_SHAPES,
                           torch.from_numpy(loc), torch.from_numpy(attn),
                           "ms_deform_attn")
    assert msda.launch_counts() == before


def test_cpu_calls_launch_nothing():
    msda.reset_launch_counts()
    s = sum(h * w for h, w in ENC_SHAPES)
    value, loc, attn = make_inputs(ENC_SHAPES, 1, s, 2, 4, 2)
    t = [torch.from_numpy(a) for a in (value, loc, attn)]
    msda.ms_deform_attn(t[0], ENC_SHAPES, t[1], t[2])
    msda_patch(t[0], ENC_SHAPES, t[1], t[2])
    counts = msda.launch_counts()
    assert set(counts) == {"ms_deform_attn", "msda_patch",
                           "dense_level_pallas", "dense_level_pallas_v2",
                           "msda_bwd"}
    assert all(v == 0 for v in counts.values())
