"""The port's model (trackformer_tpu_torch) held against the JAX package on
the CPU at a tiny width: the flagship config dataclass against the YAML
loader, weight-conversion coverage, backbone + input projections +
position encodings, and the whole DeformableDETR forward in three cases
(plain, with track queries, with prev_features).

The same JAX-initialized weights go through `convert.py` into the port;
inputs are made with numpy from a seed and handed to both. Tolerance:
float32 on both sides, but the two frameworks sum in different orders
through a ResNet-50 and several transformer layers, so outputs agree to
about 1e-4, not to the last bit (1e-3 absolute for the raw backbone
features, whose magnitudes reach the tens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import empty_targets as jempty_targets
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models.position_encoding import (
    sine_position_encoding, sine_position_encoding_3d)
from trackformer_tpu_torch.structures import FrameBatch, empty_targets
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8}
ATOL = 1e-4
H, W = 64, 96
VALID_HW = np.array([[60, 90]], np.int32)
K = 4  # track-query slots


def tiny_cfg() -> FlagshipConfig:
    return FlagshipConfig().replace(compute_dtype="float32", **TINY)


@pytest.fixture(scope="module")
def models():
    args = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "float32"}))
    jmodel = jax_build_model(args)[0]
    rng = np.random.RandomState(0)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    jbatch = JFrameBatch.from_images(jnp.asarray(img0),
                                     jnp.asarray(VALID_HW))
    # jitted: the same bits as the eager init, in a fifth of its time
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    params = jax.tree.map(np.asarray, params)
    # perturb the zero-initialized heads/offsets so every path carries signal
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    tmodel, _ = build_model(tiny_cfg(), "cpu")
    tmodel.load_state_dict(jax_params_to_state_dict(params))
    japply = jax.jit(lambda p, b, t, pf: jmodel.apply(
        p, b, t, pf, deterministic=True))
    return jmodel, params, japply, tmodel


def make_batch(seed):
    img = np.random.RandomState(seed).randn(1, H, W, 3).astype(np.float32)
    jb = JFrameBatch.from_images(jnp.asarray(img), jnp.asarray(VALID_HW))
    tb = FrameBatch.from_images(torch.from_numpy(img),
                                torch.from_numpy(VALID_HW))
    return jb, tb


def make_track_queries(c):
    rng = np.random.RandomState(7)
    hs = rng.randn(1, K, c).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (1, K, 2)),
                            rng.uniform(0.05, 0.3, (1, K, 2))],
                           -1).astype(np.float32)
    valid = np.array([[True, False, True, True]])
    jt = jempty_targets(1, 1).with_track_queries(
        jnp.asarray(hs), jnp.asarray(boxes), jnp.asarray(valid))
    tt = empty_targets(1, 1, "cpu").with_track_queries(
        torch.from_numpy(hs), torch.from_numpy(boxes),
        torch.from_numpy(valid))
    return jt, tt


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-4)


def assert_config_matches(cfg: FlagshipConfig, train: dict) -> None:
    """Every field of `cfg` against the YAML loader's train config and
    cfgs/track.yaml. A `tpu.*` key the YAML leaves unset takes the JAX
    model's default, as the JAX factory does."""
    from trackformer_tpu.models.deformable_detr import DeformableDETR
    track = load_config("track.yaml")
    tpu_keys = {"encoder_attention", "decoder_attention", "scan_layers",
                "cached_prev_memory", "encoder_window", "max_objects",
                "lr_warmup_steps"}
    for f in dataclasses.fields(cfg):
        name = f.name
        got = getattr(cfg, name)
        if name in tpu_keys:
            want = (train["tpu"][name] if name in train["tpu"]
                    else getattr(DeformableDETR, name))
            assert got == want, name
        elif name in ("val_width", "max_size"):
            assert got == train["img_transform"][name], name
        elif name == "image_bucket":
            assert list(got) in train["tpu"]["image_buckets"]
            # the eval transform's longest side fits the bucket's width
            assert got[0] == cfg.val_width and got[1] >= cfg.max_size
        elif name == "tracker_cfg":
            assert got == track["tracker_cfg"]
        elif name in ("max_tracks", "compute_dtype"):
            assert got == track["tpu"][name], name
        elif name == "remat":
            # train.yaml turns it on, and `from_config` (the train CLI)
            # takes it from there; the dataclass leaves it off
            assert got is False and train["tpu"]["remat"] is True
        else:
            assert got == train[name], name


def test_config_matches_yaml():
    assert_config_matches(FlagshipConfig(), load_config("train.yaml", NAMED))


def test_build_model_defaults_to_the_card():
    """Without a device, build_model builds on CUDA: on a machine without
    one it raises rather than quietly building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_cfg())


def test_weight_conversion_covers_every_port_param(models):
    _, params, _, tmodel = models
    sd = jax_params_to_state_dict(params)
    port = tmodel.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    # every JAX leaf lands somewhere: q/k/v pack three leaves into one key
    n_leaves = len(jax.tree_util.tree_leaves(params))
    n_packed = sum(1 for k in sd if k.endswith(("in_proj_weight",
                                                "in_proj_bias")))
    assert n_leaves == len(sd) + 2 * n_packed


def test_position_encodings_match():
    from trackformer_tpu.models.position_encoding import (
        sine_position_encoding as jsine, sine_position_encoding_3d as jsine3)
    mask = np.zeros((2, 5, 7), bool)
    mask[0, 4:] = True
    mask[1, :, 5:] = True
    close(sine_position_encoding(torch.from_numpy(mask), 16),
          jsine(jnp.asarray(mask), 16), atol=1e-5)
    close(sine_position_encoding_3d(torch.from_numpy(mask), 16),
          jsine3(jnp.asarray(mask), 16), atol=1e-5)


def test_backbone_and_input_proj_match(models):
    from trackformer_tpu.models.deformable_detr import InputProj as JProj
    jmodel, params, _, tmodel = models
    jb, tb = make_batch(3)
    jfeats, jmasks = jmodel.apply(params, jb,
                                  method=lambda m, b: m.backbone(b))
    with torch.no_grad():
        tfeats, tmasks = tmodel.backbone[0](tb)
        for jf, tf, jm, tm in zip(jfeats, tfeats, jmasks, tmasks):
            close(tf.permute(0, 2, 3, 1), jf, atol=ATOL * 10)
            assert np.array_equal(tm.numpy(), np.asarray(jm))
        # input projection of the finest used level (conv + GroupNorm)
        jp = JProj(96).apply({"params": params["params"]["input_proj_0"]},
                             jfeats[1])
        tp = tmodel.input_proj[0](tfeats[1])
        close(tp.permute(0, 2, 3, 1), jp)


@pytest.mark.parametrize("case", ["plain", "track_queries", "prev_features"])
def test_forward_matches_jax(models, case):
    _, params, japply, tmodel = models
    jb, tb = make_batch(3)
    jt = tt = None
    jprev = tprev = None
    if case == "track_queries":
        jt, tt = make_track_queries(96)
    if case == "prev_features":
        jb0, tb0 = make_batch(4)
        jprev = japply(params, jb0, None, None)[2]
        with torch.no_grad():
            tprev = tmodel(tb0)[2]
    jout = japply(params, jb, jt, jprev)[0]
    with torch.no_grad():
        tout = tmodel(tb, tt, tprev)[0]
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        close(tout[key], jout[key])
    assert np.array_equal(tout["query_valid"].numpy(),
                          np.asarray(jout["query_valid"]))


def test_bf16_forward_matches_jax_bf16(models):
    """The port's bfloat16 forward against the JAX package's bfloat16
    forward on the same weights. The two round at different points (the
    port stores every parameter in bfloat16, flax keeps them in float32 and
    applies the norms' affines in float32), so they cannot agree to
    float32's 1e-4. The bound of each output is derived from each side's
    own distance to its float32 forward (max abs): rounding noise of the
    two sides, independent, adds in quadrature, so the two bfloat16
    outputs may differ by the root of the sum of the squares of those
    distances; a bias of the port beyond its rounding noise would add
    linearly and pass it. The norms' scales and biases are moved off
    bfloat16-exact values first, so that the rounding of their affines
    shows."""
    _, params, japply, _ = models
    noise = np.random.RandomState(2)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * noise.randn(*x.shape).astype(x.dtype)
        if any("norm" in str(getattr(k, "key", "")) for k in p) else x,
        params)
    args16 = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "bfloat16"}))
    jmodel16 = jax_build_model(args16)[0]
    jb, tb = make_batch(3)
    outs = {"jax_f32": japply(params, jb, None, None)[0],
            "jax_bf16": jmodel16.apply(params, jb, None, None,
                                       deterministic=True)[0]}
    state = jax_params_to_state_dict(params)
    for name, dtype in (("port_f32", "float32"), ("port_bf16", "bfloat16")):
        tmodel, _ = build_model(tiny_cfg().replace(compute_dtype=dtype),
                                "cpu")
        tmodel.load_state_dict(state)
        with torch.no_grad():
            outs[name] = {k: v.float().numpy()
                          for k, v in tmodel(tb)[0].items()
                          if k in ("pred_logits", "pred_boxes", "hs_embed")}
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        o = {k: np.asarray(v[key], np.float32) for k, v in outs.items()}
        np.testing.assert_allclose(o["port_f32"], o["jax_f32"], atol=ATOL,
                                   rtol=1e-4, err_msg=key)
        e_jax = np.abs(o["jax_bf16"] - o["jax_f32"]).max()
        e_port = np.abs(o["port_bf16"] - o["port_f32"]).max()
        apart = np.abs(o["port_bf16"] - o["jax_bf16"]).max()
        assert e_jax > 0 and e_port > 0, key       # both really rounded
        assert apart <= np.hypot(e_jax, e_port), (key, apart, e_jax, e_port)
