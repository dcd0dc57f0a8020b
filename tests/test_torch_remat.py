"""`tpu.remat` in the port: each exact-MSDA encoder layer and, on a
`tpu.scan_layers` model, each decoder layer with its heads run under
`torch.utils.checkpoint` in a training step (the layers the JAX package
wraps in `nn.remat`), their dropout masks replayed in the recompute.

  * On the CPU in float32 with dropout 0.1 and a seeded generator, a
    two-frame train step of the tiny flagship (2 + 2 layers, hidden 96)
    with remat is bit-equal to the same step without it: the loss, every
    loss key, `grad_norm` and every gradient, and the generator ends in
    the same state. The layers really recompute (each checkpointed layer
    runs twice), and a checkpoint without the replay draws other masks:
    its gradients differ, which is what the replay is for.
  * The port's remat step held against the JAX package's remat step
    (`tpu.remat` and `tpu.scan_layers` on, dropout 0, the draws pinned,
    the tiny model of `test_torch_train_step.py`): losses and `grad_norm`
    within 1e-4, the gradients against the port's float64 step by
    `gradient_misses`.
"""
import numpy as np
import pytest
import torch

from test_torch_train_step import (FORCED, NAMED, TINY, gradient_misses,
                                   jax_args, jax_pack, make_pack,
                                   recording_optimizer, tiny_cfg, torch_pack)
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import attention, build_model
from trackformer_tpu_torch.models.deformable_transformer import \
    DeformableEncoderLayer

torch.set_num_threads(1)

# 2 + 2 layers so that a layer's recompute sits between others
DEEP = {**TINY, "enc_layers": 2, "dec_layers": 2, "dropout": 0.1}


def port_run(remat: bool, scan_layers: bool = True, seed: int = 0):
    """One two-frame step with dropout from a seeded generator -> (metrics
    as floats, gradients, the generator's state after the step)."""
    cfg = tiny_cfg(tiny=DEEP).replace(remat=remat, scan_layers=scan_layers)
    gen = torch.Generator().manual_seed(seed)
    model, crit, _, track = build_model(cfg, "cpu", generator=gen,
                                        train=True)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=True,
                           return_grads=True)
    draws = torch.Generator().manual_seed(seed + 1)
    _, metrics = step(state, torch_pack(make_pack()), draws, forced=FORCED)
    grads = metrics.pop("_grads")
    return metrics, grads, draws.get_state()


def test_remat_step_is_bit_equal(monkeypatch):
    calls = []
    real = DeformableEncoderLayer.forward

    def counted(self, *a, **kw):
        calls.append(id(self))
        return real(self, *a, **kw)

    monkeypatch.setattr(DeformableEncoderLayer, "forward", counted)
    with_remat = port_run(True)
    n_remat = len(calls)
    calls.clear()
    without = port_run(False)
    # 2 layers x 4 frame encodings (the previous frame's forward, without
    # gradient, and the current frame's, each over both frames with the
    # separate encoder); the current frame's forward's 4 recomputed
    assert (n_remat, len(calls)) == (12, 8)
    assert with_remat[0].keys() == without[0].keys()
    for key in without[0]:
        assert torch.equal(with_remat[0][key], without[0][key]), key
    assert with_remat[1].keys() == without[1].keys()
    for key in without[1]:
        assert torch.equal(with_remat[1][key], without[1][key]), key
    assert torch.equal(with_remat[2], without[2])
    # without the replay the recompute draws new masks: other gradients
    monkeypatch.setattr(attention, "remat", lambda fn, module, *a:
                        torch.utils.checkpoint.checkpoint(
                            fn, *a, use_reentrant=False))
    from trackformer_tpu_torch.models import (deformable_detr,
                                              deformable_transformer)
    monkeypatch.setattr(deformable_transformer, "remat", attention.remat)
    monkeypatch.setattr(deformable_detr, "remat", attention.remat)
    naive = port_run(True)
    assert torch.equal(naive[0]["loss"], without[0]["loss"])
    differ = [k for k in without[1]
              if not torch.equal(naive[1][k], without[1][k])]
    assert len(differ) > 10


@pytest.fixture(scope="module")
def jax_remat_step():
    """The JAX package's two-frame step with `tpu.remat` and
    `tpu.scan_layers` from a jitted init, the draws pinned -> (params,
    metrics, gradients in the port's names)."""
    import jax

    from trackformer_tpu.engine import train_step as jtrain
    from trackformer_tpu.models import build_model as jax_build_model
    from trackformer_tpu.models import tracking as jtracking
    from trackformer_tpu_torch.convert import (flatten_tree,
                                               jax_params_to_state_dict,
                                               state_dict_to_jax_params)
    from trackformer_tpu_torch.utils.checkpoint import (bridge_scan_layout,
                                                        unflatten_params)

    args = jax_args(NAMED,
                    {**TINY, "tpu.remat": True, "tpu.scan_layers": True})
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    jpack = jax_pack(make_pack())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jpack["batch"])
    params = jax.tree.map(np.asarray, params)
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    real = jtracking.add_track_queries_to_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "add_track_queries_to_targets",
                   lambda *a, **kw: real(*a, **{**kw, "forced": FORCED}))
        opt = recording_optimizer(jtrain.make_optimizer(args, params))
        state = jtrain.TrainState.create(params, opt)
        step = jax.jit(jtrain.make_train_step(jmodel, jcrit, opt, jtrack,
                                              tracking=True))
        state, metrics = step(state, jpack, jax.random.PRNGKey(0))
    cfg = tiny_cfg().replace(remat=True, scan_layers=True)
    own = flatten_tree(state_dict_to_jax_params(
        build_model(cfg, "cpu")[0].state_dict()))

    def port_names(tree):
        flat = bridge_scan_layout(flatten_tree(jax.tree.map(np.asarray,
                                                            tree)),
                                  own, verbose=False)
        return jax_params_to_state_dict(unflatten_params(flat))

    return (port_names(params), {k: float(v) for k, v in metrics.items()},
            port_names(state.opt_state[0]))


def test_remat_step_matches_jax_remat(jax_remat_step):
    weights, jmetrics, jgrads = jax_remat_step
    cfg = tiny_cfg().replace(remat=True, scan_layers=True)
    results = {}
    for dtype in (torch.float32, torch.float64):
        model, crit, _, track = build_model(cfg, "cpu", train=True)
        model.load_state_dict(weights)
        model.to(dtype)
        optimizer = make_optimizer(cfg, model)
        state = TrainState.create(model, optimizer)
        step = make_train_step(model, crit, optimizer, track, tracking=True,
                               return_grads=True)
        _, metrics = step(state, torch_pack(make_pack()), None,
                          forced=FORCED)
        results[dtype] = metrics
    metrics = results[torch.float32]
    grads, ref = metrics.pop("_grads"), results[torch.float64]["_grads"]
    assert set(metrics) == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert set(grads) == set(jgrads) == set(ref)
    misses = gradient_misses(grads, jgrads, ref)
    assert misses == [], misses[:5]
