"""Window side 16 (256-token windows) held against the JAX package on the
CPU: the window layout of both shift parities (a half-window shift of 8,
with fully-padded windows), the windowed layer's plain version against the
JAX Pallas kernel `_fused_window_layer` in interpret mode, the plain chain
of the five stages (what the CUDA kernels round like) against the plain
layer, a 2-layer windowed encoder, and the fast flagship
(`tpu_fast` with `tpu.encoder_window: 16`, the cached memory) forward on
two frames; then the agreement tools' `w16` arm (the same overrides as the
JAX tool's) and `agree_probe`'s arguments and a two-step `fast_w16` probe
at the `small` scale.

Inputs come from numpy seeds and weights from a JAX `init`
(`test_torch_window_attn.py`'s helpers). Tolerances as there: float32 on
both sides, summed in different orders, 1e-5 (layout: exact; the whole
model 1e-4, `test_torch_variants.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_variants import MULTI, TINY, make_batch, make_track_queries
from test_torch_variants_rest import assert_outputs_match, run_both
from test_torch_window_attn import (B, FF, HEADS, close, make_levels,
                                    perturbed, port_state, to_j, to_t)
from trackformer_tpu.models import windowed_encoder as jwe
from trackformer_tpu.ops.window_attn import fused_window_layer as jax_fused
from trackformer_tpu_torch.models import windowed_encoder as twe
from trackformer_tpu_torch.ops import window_attn
from trackformer_tpu_torch.tools import agree_probe
from trackformer_tpu_torch.tools import fast_exact_agreement as port_det

torch.set_num_threads(1)

C = 32
WIN = 16
# level 0 of item 1 is padded from row 26 on: with the pad to 48 rows its
# last window row is wholly excluded
SHAPES = ((40, 36), (20, 18), (10, 9), (5, 5))


@pytest.mark.parametrize("shift", [False, True], ids=["shift0", "shift1"])
def test_window16_layout_matches_jax(shift):
    srcs, masks, poses = make_levels(0, SHAPES, C)
    jpw, jkp = jax.jit(jwe.window_context, static_argnums=(2, 3, 4))(
        to_j(poses), to_j(masks), WIN, shift, jnp.float32)
    tpw, tkp = twe.window_context(to_t(poses), to_t(masks), WIN, shift,
                                  torch.float32)
    close(tpw, jpw, atol=0, rtol=0)
    assert np.array_equal(tkp.numpy(), np.asarray(jkp))
    assert tkp.shape[1] == WIN * WIN
    if not shift:
        m0 = np.pad(masks[0], ((0, 0), (0, 8), (0, 12)),
                    constant_values=True)
        blocks = m0.reshape(B, 3, WIN, 3, WIN).transpose(0, 1, 3, 2, 4)
        assert blocks.reshape(B * 9, -1).all(1).any()
    for x in srcs:
        xp, hp, wp = jwe._pad_hw(jnp.asarray(x), WIN)
        txp, thp, twp = twe.pad_hw(torch.from_numpy(x), WIN)
        jw = jwe.window_partition(xp, WIN)
        tw = twe.window_partition(txp, WIN)
        close(tw, jw, atol=0, rtol=0)
        close(twe.window_merge(tw, B, thp, twp, WIN),
              jwe.window_merge(jw, B, hp, wp, WIN), atol=0, rtol=0)


@pytest.fixture(scope="module")
def layer_setup():
    srcs, masks, poses = make_levels(1, SHAPES, C)
    jlayer = jwe.WindowedEncoderLayer(C, HEADS, FF, window=WIN, shift=True)
    ctx = jax.jit(jwe.window_context, static_argnums=(2, 3, 4))(
        to_j(poses), to_j(masks), WIN, True, jnp.float32)
    params = jax.jit(lambda k, s, p, m, c: jlayer.init(k, s, p, m, True, c))(
        jax.random.PRNGKey(2), to_j(srcs), to_j(poses), to_j(masks), ctx)
    params = perturbed(params, 3)
    tlayer = twe.WindowedEncoderLayer(C, HEADS, FF, WIN, shift=True)
    tlayer.load_state_dict(port_state(params["params"], "layer_0"))
    return params, tlayer


def window_inputs(seed, nw=3):
    rng = np.random.RandomState(seed)
    xw = rng.randn(nw, WIN * WIN, C).astype(np.float32)
    pw = rng.randn(nw, WIN * WIN, C).astype(np.float32)
    kp = rng.rand(nw, WIN * WIN) < 0.3
    kp[1] = False
    return xw, pw, kp


def test_plain_layer_matches_jax_kernel_interpret(layer_setup):
    """3 windows of 256 tokens (not a multiple of the TPU kernel's tile)
    through the JAX kernel in interpret mode and the port's plain
    version."""
    params, tlayer = layer_setup
    p = params["params"]
    weights = {f"{n}_{kind}": p["self_attn"][f"{n}_proj"][kind]
               for n in ("q", "k", "v", "out") for kind in ("kernel", "bias")}
    for mod in ("norm1", "norm2"):
        weights[f"{mod}_scale"] = p[mod]["scale"]
        weights[f"{mod}_bias"] = p[mod]["bias"]
    for mod in ("linear1", "linear2"):
        weights[f"{mod}_kernel"] = p[mod]["kernel"]
        weights[f"{mod}_bias"] = p[mod]["bias"]
    xw, pw, kp = window_inputs(4)
    want = jax_fused(jnp.asarray(xw), jnp.asarray(pw), jnp.asarray(kp),
                     {k: jnp.asarray(v) for k, v in weights.items()}, HEADS,
                     interpret=True)
    with torch.no_grad():
        got = window_attn.window_layer(torch.from_numpy(xw),
                                       torch.from_numpy(pw),
                                       torch.from_numpy(kp), tlayer)
    close(got, want)


def test_staged_plain_chain_matches_the_layer():
    """At 256 tokens a window the five stages' plain chain (the rounding
    and layout the CUDA kernels follow: attention over the (NW, 256) key
    mask) computes the layer: in float32, to 1e-5. The stage kernels'
    checks take any window the kernels are instantiated at."""
    kp = torch.from_numpy(window_inputs(5)[2])
    layer8 = twe.WindowedEncoderLayer(256, 8, 128, WIN, shift=False)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in layer8.parameters():
            prm.normal_(0.0, 0.05, generator=gen)
        x8 = torch.randn(3, WIN * WIN, 256, generator=gen)
        p8 = torch.randn(3, WIN * WIN, 256, generator=gen)
        want = window_attn.window_layer_plain(x8, p8, kp, layer8)
        got = window_attn.window_layer_staged_plain(
            x8, p8, kp, window_attn.pack_weights(layer8, torch.float32))
    close(got, want, atol=1e-5, rtol=1e-5)
    for c in window_attn.WIDTHS:
        window_attn.check_width(c, 8, WIN * WIN)
    with pytest.raises(ValueError, match="CUDA tensors"):
        window_attn.attn_cuda(torch.zeros(WIN * WIN, 3 * 256,
                                          dtype=torch.bfloat16),
                              torch.zeros(1, WIN * WIN, dtype=torch.bool))


def test_windowed_encoder_w16_matches_jax(monkeypatch):
    monkeypatch.setattr(jwe, "ATTN_IMPL", "module")
    srcs, masks, poses = make_levels(8, SHAPES, C)
    jenc = jwe.WindowedEncoder(C, num_layers=2, nheads=HEADS,
                               dim_feedforward=FF, window=WIN,
                               dtype=jnp.float32)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(9), to_j(srcs),
                                to_j(masks), to_j(poses))
    want = jax.jit(jenc.apply)(params, to_j(srcs), to_j(masks), to_j(poses))
    tenc = twe.WindowedEncoder(C, len(SHAPES), 2, HEADS, FF, WIN)
    tenc.load_state_dict(port_state(params["params"], None))
    with torch.no_grad():
        got = tenc([torch.from_numpy(s).permute(0, 3, 1, 2) for s in srcs],
                   to_t(masks), to_t(poses))
    close(got, want, atol=1e-4, rtol=1e-4)


def test_fast_w16_model_forward_matches_jax():
    """The fast flagship at window side 16 (windowed encoder over the
    current frame, the cached memory): the second frame's outputs and
    memory against JAX."""
    named = MULTI + ["tpu_fast"]
    over = {"tpu.encoder_window": 16}
    japply, params, tmodel = run_both(named, over)
    assert tmodel.transformer.encoder.window == 16
    jb0, tb0 = make_batch(4)
    jb, tb = make_batch(3)
    jt, tt = make_track_queries(TINY["hidden_dim"])
    jprev = japply(params, jb0, None, None)[2]
    jout, _, _, jmem, _ = japply(params, jb, jt, jprev)
    with torch.no_grad():
        tprev = tmodel(tb0)[2]
        tout, _, _, tmem, _ = tmodel(tb, tt, tprev)
    assert_outputs_match(tout, jout, tmem, jmem)


def test_w16_arm_and_agree_probe(tmp_path, capsys):
    """`fast_w16` maps to the JAX tool's overrides; `agree_probe` takes
    the budget, scale and arms (refusing a window no kernel takes) and, on
    the CPU, trains a `fast_w16` arm 2 steps at the `small` scale and
    prints its AP and summary, writing no AGREEMENT file."""
    from test_torch_agreement import load_jax_tool
    jtool = load_jax_tool("fast_exact_agreement", "2", "small")
    for mode in ("fast_w16", "fast_w16_f32", "exact_w16"):
        assert port_det.mode_over(mode) == jtool._mode_over(mode)
    args = agree_probe.parse_args(["600", "flagship", "fast_w16",
                                   "fast_f32"])
    assert (args.steps, args.scale, args.modes) == (
        600, "flagship", ["fast_w16", "fast_f32"])
    with pytest.raises(NotImplementedError, match="window sides"):
        agree_probe.parse_args(["10", "small", "fast_w12"])
    with pytest.raises(SystemExit):
        agree_probe.parse_args(["10", "huge", "fast"])
    summary = agree_probe.main(["2", "small", "fast_w16", "--device", "cpu",
                                "--ckpt-dir", str(tmp_path)])
    assert set(summary) == {"fast_w16"}
    assert summary["fast_w16"]["steps"] == 2
    assert np.isfinite(summary["fast_w16"]["ap"])
    printed = capsys.readouterr().out
    assert "PROBE fast_w16: AP=" in printed and "PROBE SUMMARY" in printed
    assert list((tmp_path / "probe").glob("*_train.pt"))
    assert not list(tmp_path.glob("AGREEMENT*"))
