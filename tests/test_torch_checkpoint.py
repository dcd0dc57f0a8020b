"""Checkpoints of the port (trackformer_tpu_torch.utils.checkpoint and the
torch -> JAX map of convert.py) held against the JAX package on the CPU:

  * JAX params -> port state dict -> JAX params is bit-exact, in the exact
    and the TPU-fast config, for seeded values on the real param trees;
  * an `.npz` written by the JAX package's `save_params_npz` loads into the
    port and gives the JAX forward, and one written by the port loads
    through the JAX package's `load_params_npz` and gives the port's
    forward (a tiny exact model, float32: 1e-4 + 1e-4 |ref|, the
    tolerance of test_torch_model.py); a `scan_layers` file loads into the
    port's unrolled layers;
  * `bridge_scan_layout` and `adapt_params` (with `resume_shift_neuron` on
    and off) give the JAX functions' arrays, bit for bit;
  * `CheckpointManager`: save after one train step, restore into a fresh
    model and state, and the next step is bit-equal to the uninterrupted
    one; the files it writes over a run of epochs are the JAX manager's,
    names and arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import FORCED, make_pack, torch_pack
from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.utils import checkpoint as jckpt
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import (jax_params_to_state_dict,
                                           state_dict_to_jax_params)
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.utils import checkpoint as ckpt
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dataset": "mot_crowdhuman"}
H, W = 64, 96
ATOL = 1e-4


def configs(fast: bool):
    args = nested_namespace(load_config(
        "train.yaml", NAMED + (["tpu_fast"] if fast else []),
        {**TINY, "tpu.compute_dtype": "float32"}))
    base = FlagshipConfig.tpu_fast() if fast else FlagshipConfig()
    return args, base.replace(compute_dtype="float32", dropout=0.0, **TINY)


def jax_batch():
    img = np.random.RandomState(5).randn(1, H, W, 3).astype(np.float32)
    return img, JFrameBatch.from_images(jnp.asarray(img),
                                        jnp.asarray([[60, 90]]))


def flat(tree):
    return jckpt.flatten_params(tree)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_jax_port_jax_round_trip_is_bit_exact(fast):
    """Seeded values on the JAX model's own param tree go to the port's
    keys and back unchanged; the port model takes every key, and its
    state dict maps back to the same tree."""
    args, cfg = configs(fast)
    jmodel = jax_build_model(args)[0]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax_batch()[1])
    rng = np.random.RandomState(7)
    params = jax.tree.map(
        lambda sd: rng.standard_normal(sd.shape).astype(np.float32), shapes)
    state_dict = jax_params_to_state_dict(params)
    model = build_model(cfg, "cpu")[0]
    model.load_state_dict(state_dict)
    for sd in (state_dict, model.state_dict()):
        back = flat(state_dict_to_jax_params(sd, cfg))
        want = flat(params)
        assert set(back) == set(want)
        for key, arr in want.items():
            assert back[key].dtype == np.float32
            assert np.array_equal(back[key], arr), key
    # a key with no JAX path, and keys of another config, are refused
    with pytest.raises(KeyError, match="no JAX param"):
        state_dict_to_jax_params({**state_dict, "extra.weight":
                                  torch.zeros(2)})
    other = cfg.replace(enc_layers=1)
    with pytest.raises(ValueError, match="does not fit"):
        state_dict_to_jax_params(state_dict, other)


@pytest.fixture(scope="module")
def exact_models():
    """The JAX tiny exact model from its init (offsets and heads perturbed,
    as in the other port tests), its jitted forward, and the port's."""
    args, cfg = configs(False)
    jmodel = jax_build_model(args)[0]
    img, jb = jax_batch()
    params = jax.tree.map(np.asarray,
                          jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    apply = jax.jit(lambda p, b: jmodel.apply(p, b, deterministic=True)[0])
    tb = FrameBatch.from_images(torch.from_numpy(img),
                                torch.tensor([[60, 90]]))
    return cfg, params, apply, jb, tb


def port_forward(model, tb):
    with torch.inference_mode():
        out = model(tb)[0]
    return {k: out[k].numpy() for k in ("pred_logits", "pred_boxes")}


def assert_forward_close(got, want):
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=ATOL,
                                   rtol=1e-4, err_msg=key)


def test_jax_npz_loads_into_the_port(exact_models, tmp_path):
    cfg, params, apply, jb, tb = exact_models
    path = tmp_path / "jax.npz"
    jckpt.save_params_npz(params, path)
    model = build_model(cfg, "cpu")[0]
    ckpt.load_model_npz(model, path)
    assert_forward_close(port_forward(model, tb), apply(params, jb))


def test_port_npz_loads_into_jax(exact_models, tmp_path):
    cfg, params, apply, jb, tb = exact_models
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))[0]
    path = tmp_path / "port.npz"
    ckpt.save_model_npz(model, path, cfg)
    loaded = jckpt.load_params_npz(path)
    assert set(flat(loaded)) == set(flat(params))
    assert_forward_close(apply(loaded, jb), port_forward(model, tb))
    # and the port's own reader gives the same tensors back
    again = build_model(cfg, "cpu")[0]
    ckpt.load_model_npz(again, path)
    for key, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], t), key


def stacked_layout(flat_unrolled):
    """The `scan_layers` key of each per-layer key, with its layer count:
    encoder/layer_i/R -> encoder/layers/layer/R, decoder_layers_i/R ->
    dec_scan/layers/layer/R, {class,bbox}_embed_i/R ->
    dec_scan/layers/{class,bbox}_embed/R."""
    import re
    stacked = {}
    for key, arr in flat_unrolled.items():
        for pat, tmpl in ((r"(.*encoder/)layer_(\d+)/(.+)",
                           r"\1layers/layer/\3"),
                          (r"(.*?)decoder_layers_(\d+)/(.+)",
                           r"\1dec_scan/layers/layer/\3"),
                          (r"(.*?)(class_embed|bbox_embed)_(\d+)/(.+)",
                           r"\1dec_scan/layers/\2/\4")):
            m = re.fullmatch(pat, key)
            if m:
                skey = re.sub(pat, tmpl, key)
                n = stacked.get(skey, (0,))[0]
                stacked[skey] = (n + 1,) + arr.shape
                break
    return {k: np.zeros(v, np.float32) for k, v in stacked.items()}


def test_scan_layers_npz_loads_into_the_port(tmp_path):
    """A checkpoint in the stacked layout (built here with the JAX
    package's own bridge) loads into the port's unrolled layers."""
    cfg = configs(False)[1]
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(4))[0]
    unrolled = flat(state_dict_to_jax_params(model.state_dict()))
    stacked = jckpt.bridge_scan_layout(unrolled, stacked_layout(unrolled),
                                       verbose=False)
    assert any("dec_scan/layers/layer/" in k for k in stacked)
    assert not any("decoder_layers_" in k for k in stacked)
    path = tmp_path / "scan.npz"
    jckpt.save_params_npz(jckpt.unflatten_params(stacked), path)
    again = build_model(cfg, "cpu")[0]
    ckpt.load_model_npz(again, path)
    for key, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], t), key


def bridge_cases():
    """(loaded, target) flat dicts in both directions, with the two-stage
    extra head."""
    rng = np.random.RandomState(2)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    unrolled = {"params/encoder/layer_0/linear1/kernel": arr(4, 6),
                "params/encoder/layer_1/linear1/kernel": arr(4, 6),
                "params/decoder_layers_0/norm1/scale": arr(4),
                "params/decoder_layers_1/norm1/scale": arr(4),
                "params/class_embed_0/bias": arr(3),
                "params/class_embed_1/bias": arr(3),
                "params/class_embed_2/bias": arr(3),
                "params/query_embed": arr(5, 8)}
    stacked = {"params/encoder/layers/layer/linear1/kernel": arr(2, 4, 6),
               "params/dec_scan/layers/layer/norm1/scale": arr(2, 4),
               "params/dec_scan/layers/class_embed/bias": arr(2, 3),
               "params/enc_class_embed/bias": arr(3),
               "params/query_embed": arr(5, 8)}
    return [(unrolled, {k: np.zeros_like(v) for k, v in stacked.items()}),
            (stacked, {k: np.zeros_like(v) for k, v in unrolled.items()})]


def assert_same_arrays(got, want):
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("case", [0, 1], ids=["to_stacked", "to_unrolled"])
def test_bridge_scan_layout_matches_jax(case):
    loaded, target = bridge_cases()[case]
    assert_same_arrays(
        ckpt.bridge_scan_layout(dict(loaded), target, verbose=False),
        jckpt.bridge_scan_layout(dict(loaded), target, verbose=False))


def surgery_cases():
    """The dicts of test_checkpoint_surgery.py in one loaded / target
    pair: norm and attention repeats, fresh linear1 and query_embed,
    linear2 and input_proj repeats, the reference-points prefix, the class
    head slice, equal-shape class heads, and the generic slice and pad."""
    rng = np.random.default_rng(0)
    c, c2 = 8, 16

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    loaded = {"decoder_layers_0/norm1/scale": arr(c),
              "decoder_layers_0/self_attn/q_proj/kernel": arr(c, c),
              "encoder/layer_0/linear1/kernel": arr(c, 32),
              "query_embed": arr(10, c),
              "encoder/layer_0/linear2/kernel": arr(32, c),
              "input_proj_0/conv/kernel": arr(1, 1, 4, c),
              "reference_points/kernel": arr(c, 2),
              "class_embed_0/kernel": arr(c, 92),
              "class_embed_1/kernel": arr(c, 5),
              "class_embed_1/bias": arr(5),
              "level_embed": arr(4, c2 + 2),
              "frame_embed": arr(2, c)}
    target = {"decoder_layers_0/norm1/scale": arr(c2),
              "decoder_layers_0/self_attn/q_proj/kernel": arr(c2, c2),
              "encoder/layer_0/linear1/kernel": arr(c2, 32),
              "query_embed": arr(10, c2),
              "encoder/layer_0/linear2/kernel": arr(32, c2),
              "input_proj_0/conv/kernel": arr(1, 1, 4, c2),
              "reference_points/kernel": arr(c, 4),
              "class_embed_0/kernel": arr(c, 21),
              "class_embed_1/kernel": arr(c, 5),
              "class_embed_1/bias": arr(5),
              "level_embed": arr(4, c2),
              "frame_embed": arr(2, c2),
              "encoder/layer_0/norm2/bias": arr(c)}
    return loaded, target


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shift"])
def test_adapt_params_matches_jax(shift):
    loaded, target = surgery_cases()
    got = ckpt.adapt_params(dict(loaded), dict(target),
                            resume_shift_neuron=shift, verbose=False)
    want = jckpt.adapt_params(dict(loaded), dict(target),
                              resume_shift_neuron=shift, verbose=False)
    assert_same_arrays(got, want)
    moved = not np.array_equal(got["class_embed_1/bias"],
                               loaded["class_embed_1/bias"])
    assert moved == shift


def tiny_train(cfg, seed):
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed),
                        train=True)
    optimizer = make_optimizer(cfg, model[0], lr_drop_steps=[1])
    state = TrainState.create(model[0], optimizer)
    step = make_train_step(model[0], model[1], optimizer, model[3],
                           tracking=True, return_grads=True)
    return model[0], state, step


def test_checkpoint_manager_resume_is_bit_equal(tmp_path):
    """Save after step 1; a fresh model and state restored from it take
    step 2 bit for bit as the uninterrupted run does: weights, AdamW
    moments, gradients and metrics."""
    cfg = configs(False)[1].replace(enc_layers=1, dec_layers=1)
    pack = torch_pack(make_pack())
    model, state, step = tiny_train(cfg, 0)
    state, _ = step(state, pack, None, forced=FORCED)
    manager = ckpt.CheckpointManager(tmp_path / "run", save_interval=1)
    manager.save(state, 1, {"AP": 0.25}, cfg)
    state, uninterrupted = step(state, pack, None, forced=FORCED)

    fresh, fresh_state, fresh_step = tiny_train(cfg, 99)
    restored, epoch = ckpt.CheckpointManager(tmp_path / "run").restore(
        fresh_state, fresh)
    assert epoch == 1 and restored is fresh_state and restored.step == 1
    restored, resumed = fresh_step(restored, pack, None, forced=FORCED)
    assert restored.step == state.step == 2
    for name in ("params", "mu", "nu"):
        for key, t in getattr(state, name).items():
            assert torch.equal(getattr(restored, name)[key], t), (name, key)
    for key, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], t), key
    for key, t in uninterrupted["_grads"].items():
        assert torch.equal(resumed["_grads"][key], t), key
    for key in uninterrupted:
        if key != "_grads":
            assert torch.equal(resumed[key], uninterrupted[key]), key
    # nothing saved: the state comes back as it was, epoch 0
    empty = ckpt.CheckpointManager(tmp_path / "none")
    assert empty.restore(fresh_state) == (fresh_state, 0)


def test_checkpoint_manager_writes_the_jax_managers_files(tmp_path):
    """Over epochs with rising and falling metrics both managers write the
    same files (epoch copies every `save_interval`, a best copy per metric
    whenever it does not fall), the same `meta.json`, and the same weights
    in every `.npz`."""
    cfg = configs(False)[1].replace(enc_layers=1, dec_layers=1)
    model, state, _ = tiny_train(cfg, 1)
    params = state_dict_to_jax_params(state.params, cfg)
    jstate = jtrain.TrainState(params=params, opt_state={},
                               step=jnp.int32(0))
    port = ckpt.CheckpointManager(tmp_path / "port", save_interval=2)
    jman = jckpt.CheckpointManager(tmp_path / "jax", save_interval=2)
    for epoch, stats in enumerate([{"AP": 0.1, "MOTA": 0.5},
                                   {"AP": 0.3, "MOTA": 0.2},
                                   {"AP": 0.2, "MOTA": 0.5}], 1):
        port.save(state, epoch, stats, cfg)
        jman.save(jstate, epoch, stats)
    names = {p.name for p in (tmp_path / "port").iterdir()} - {
        "checkpoint.pt"}
    jnames = {p.name for p in (tmp_path / "jax").iterdir()} - {"checkpoint"}
    assert names == jnames == {
        "meta.json", "checkpoint_params.npz", "checkpoint_epoch_2.npz",
        "checkpoint_best_AP.npz", "checkpoint_best_MOTA.npz"}
    assert (tmp_path / "port/meta.json").read_text() == \
        (tmp_path / "jax/meta.json").read_text()
    for name in names - {"meta.json"}:
        got = jckpt.load_params_npz(tmp_path / "port" / name)
        want = jckpt.load_params_npz(tmp_path / "jax" / name)
        assert_same_arrays(flat(got), flat(want))
