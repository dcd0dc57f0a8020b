"""Vanilla DETR of the port (`models/transformer.py`, `models/detr.py`)
held against the JAX package on the CPU at a tiny width (2 + 2 layers,
hidden 128, 8 heads, FFN 64, 6 queries): the transformer alone with its
post-norm, pre-norm and track-attention layers; the whole model from the
same JAX weights (through `convert.py`) on the same seeded frame, with and
without track queries; `postprocess_softmax`; and the weight maps of
`DETR` both ways, through the `.npz` files of both packages.

Tolerance: float32 on both sides, summed in different orders through a
ResNet-50 and a few transformer layers: 1e-4 absolute and relative
(`test_torch_model.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_variants import (jax_params, make_batch,
                                 make_track_queries)
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import postprocess as jpost
from trackformer_tpu.models.transformer import Transformer as JTransformer
from trackformer_tpu.utils import checkpoint as jckpt
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import (flatten_tree,
                                           jax_params_to_state_dict,
                                           state_dict_to_jax_params)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models.postprocess import postprocess_softmax
from trackformer_tpu_torch.models.transformer import Transformer
from trackformer_tpu_torch.utils.checkpoint import (load_model_npz,
                                                    save_model_npz)
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

TINY = {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 128, "nheads": 8,
        "dim_feedforward": 64, "num_queries": 6,
        "tpu.compute_dtype": "float32"}
TOL = dict(atol=1e-4, rtol=1e-4)
# (named configs, overrides) of the vanilla models held here
MODELS = {
    "post_norm": (["mots20"], {"masks": False}),
    "pre_norm_track_attention": (["mots20"], {"masks": False,
                                              "pre_norm": True,
                                              "track_attention": True}),
}


def jax_config(named, over):
    return load_config("train.yaml", named, {**TINY, **over})


def port_model(named, over, params):
    cfg = FlagshipConfig.from_config(jax_config(named, over))
    model, post = build_model(cfg, "cpu")
    model.load_state_dict(jax_params_to_state_dict(params))
    return cfg, model, post


def close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg,
                               **TOL)


@pytest.mark.parametrize("pre_norm,track_attention",
                         [(False, False), (True, False), (True, True)])
def test_transformer_matches_jax(pre_norm, track_attention):
    """The transformer on its own: 3 track slots (one invalid) before 4
    object queries, a padded memory; hs, hs_raw and the memory."""
    c, nq, k = 32, 4, 3
    jt = JTransformer(d_model=c, nheads=4, num_encoder_layers=2,
                      num_decoder_layers=2, dim_feedforward=48,
                      pre_norm=pre_norm, track_attention=track_attention,
                      num_queries=nq)
    rng = np.random.RandomState(0)
    src = rng.randn(2, 5, 6, c).astype(np.float32)
    pos = rng.randn(2, 5, 6, c).astype(np.float32)
    mask = np.zeros((2, 5, 6), bool)
    mask[1, 3:] = True
    mask[1, :, 4:] = True
    query = rng.randn(2, k + nq, c).astype(np.float32)
    tgt = rng.randn(2, k + nq, c).astype(np.float32)
    key_pad = np.zeros((2, k + nq), bool)
    key_pad[0, 1] = True
    args = [jnp.asarray(x) for x in (src, mask, query, pos, tgt, key_pad)]
    params = jt.init(jax.random.PRNGKey(0), *args)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(
            np.float32), params)
    want = jt.apply(params, *args)

    tt = Transformer(c, 4, 2, 2, 48, 0.0, pre_norm, track_attention, nq)
    sd = jax_params_to_state_dict({"params": {"transformer":
                                              params["params"]}})
    tt.load_state_dict({key[len("transformer."):]: v
                        for key, v in sd.items()})
    with torch.no_grad():
        got = tt(*[torch.from_numpy(x) for x in (src, mask, query, pos, tgt,
                                                 key_pad)])
    for g, w, name in zip(got, want, ("hs", "hs_raw", "memory")):
        close(g.numpy(), w, name)


@pytest.mark.parametrize("model", list(MODELS))
def test_detr_matches_jax(model):
    """The whole model on a padded frame, without track queries and with 4
    track slots (one invalid): logits, boxes, the last raw hidden state,
    the validity of the slots, the memory and the auxiliary outputs; then
    `postprocess_softmax` of both outputs."""
    named, over = MODELS[model]
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel)
    cfg, tmodel, post = port_model(named, over, params)
    assert post is postprocess_softmax
    jb, tb = make_batch(3)
    for with_tq in (False, True):
        jt, tt = (make_track_queries(TINY["hidden_dim"]) if with_tq
                  else (None, None))
        jout, _, _, jmem, jhs = jmodel.apply(params, jb, jt)
        with torch.no_grad():
            tout, _, feats, tmem, ths = tmodel(tb, tt)
        q = TINY["num_queries"] + (4 if with_tq else 0)
        assert tout["pred_logits"].shape == (1, q, 21)
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            close(tout[key].numpy(), jout[key], f"{key} tq={with_tq}")
        np.testing.assert_array_equal(tout["query_valid"].numpy(),
                                      np.asarray(jout["query_valid"]))
        close(tmem.numpy(), jmem, "memory")
        close(ths.numpy(), jhs, "hs")
        assert len(feats) == 4
        for i, aux in enumerate(jout["aux_outputs"]):
            for key in ("pred_logits", "pred_boxes"):
                close(tout["aux_outputs"][i][key].numpy(), aux[key], key)
        sizes = np.array([[480, 640]], np.int32)
        jres = jpost.postprocess_softmax(jout, jnp.asarray(sizes))
        tres = postprocess_softmax(tout, torch.from_numpy(sizes))
        assert set(tres) == set(jres)
        np.testing.assert_array_equal(tres["labels"].numpy(),
                                      np.asarray(jres["labels"]))
        for key in ("scores", "scores_no_object"):
            close(tres[key].numpy(), jres[key], key)
        np.testing.assert_allclose(tres["boxes"].numpy(),
                                   np.asarray(jres["boxes"]), atol=1e-2,
                                   rtol=1e-4)


def test_postprocess_softmax_ties_and_no_object():
    """Hand-made logits: the no-object column never wins the label, even
    where it is the largest; scores and labels as the JAX package's."""
    logits = np.array([[[5.0, 1.0, 9.0], [0.0, 0.0, 0.0],
                        [-1.0, 3.0, 2.0]]], np.float32)
    boxes = np.full((1, 3, 4), 0.5, np.float32)
    sizes = np.array([[100, 200]], np.int32)
    jres = jpost.postprocess_softmax({"pred_logits": jnp.asarray(logits),
                                      "pred_boxes": jnp.asarray(boxes)},
                                     jnp.asarray(sizes))
    tres = postprocess_softmax({"pred_logits": torch.from_numpy(logits),
                                "pred_boxes": torch.from_numpy(boxes)},
                               torch.from_numpy(sizes))
    np.testing.assert_array_equal(tres["labels"].numpy(), [[0, 0, 1]])
    np.testing.assert_array_equal(tres["labels"].numpy(),
                                  np.asarray(jres["labels"]))
    for key in ("scores", "scores_no_object", "boxes"):
        close(tres[key].numpy(), jres[key], key)


def test_detr_weights_map_both_ways(tmp_path):
    """Every JAX param of the pre-norm track-attention DETR has a port key
    and back, exactly; a JAX `.npz` loads into the port, and the port's
    `.npz` reads back into the JAX tree bit for bit."""
    named, over = MODELS["pre_norm_track_attention"]
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel, seed=3)
    jflat = flatten_tree(params)
    assert any("track_attention_layer_1" in k for k in jflat)
    assert any("encoder_norm" in k for k in jflat)
    cfg, tmodel, _ = port_model(named, over, params)
    back = flatten_tree(state_dict_to_jax_params(tmodel.state_dict(), cfg))
    assert set(back) == set(jflat)
    for key, value in jflat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)

    jckpt.save_params_npz(params, tmp_path / "jax.npz")
    fresh, _ = build_model(cfg, "cpu")
    load_model_npz(fresh, tmp_path / "jax.npz")
    for key, value in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    save_model_npz(fresh, tmp_path / "port.npz", cfg)
    loaded = flatten_tree(jckpt.load_params_npz(tmp_path / "port.npz"))
    assert set(loaded) == set(jflat)
    for key, value in jflat.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)
    # the layout check knows the family
    deformable = FlagshipConfig(compute_dtype="float32")
    with pytest.raises(ValueError, match="vanilla"):
        state_dict_to_jax_params(tmodel.state_dict(), deformable)
