"""Training the TPU-fast mode (windowed encoder, cached previous-frame
memory) in the port, held against the JAX package on the CPU: two full
optimizer steps of two-frame track-query training of a tiny model (2
windowed encoder layers, so that both shift parities run; 1 decoder layer;
hidden 96, 4 heads, 8 queries, 64x96 frames, float32), with a
learning-rate warmup (`tpu_fast`'s, shortened to 2 steps: `WARMUP`) and
the drop before the second step.

The fixture, the pinned draws and every tolerance are those of
`test_torch_train_step.py`: the metrics to 1e-4 relative, each gradient
tensor against the port's own float64 steps (`gradient_misses`), each
update as a whole. Dropout is 0 for the comparison; a step at the config's
dropout 0.1 runs and is finite. No training call of the windowed encoder
reaches `window_layer` (kernel #8 on the card, its plain version here) or
any `*_plain` function: the layer's training path is its own module
composition (`WindowedEncoderLayer._train_forward`), and an eval-mode call
still goes through `window_layer`.
"""
import numpy as np
import pytest
import torch

from test_torch_train_step import (TINY, jax_steps, make_setup, port_steps,
                                   port_two_steps_match)
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model, windowed_encoder
from trackformer_tpu_torch.ops import window_attn
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)


# the warmup of the compared steps: `tpu_fast`'s 1000 steps scale the first
# updates by 1e-3, below a float32 ulp of most weights, so that the update
# checks would see nothing; 2 steps keep the ramp in the comparison
WARMUP = 2


@pytest.fixture(scope="module")
def setup():
    # two encoder layers, so that both shift parities run
    s = make_setup(fast=True, tiny={**TINY, "enc_layers": 2})
    assert s.cfg.enc_layers == 2
    assert s.cfg.cached_prev_memory and s.cfg.lr_warmup_steps == 1000
    assert s.args.tpu.lr_warmup_steps == s.cfg.lr_warmup_steps
    s.args.tpu.lr_warmup_steps = WARMUP
    s.cfg = s.cfg.replace(lr_warmup_steps=WARMUP)
    return s


@pytest.fixture(scope="module")
def jax_two_steps(setup):
    return jax_steps(setup)


@pytest.fixture(scope="module")
def float64_steps(setup):
    return port_steps(setup, torch.float64)


@pytest.fixture
def window_calls(monkeypatch):
    """Counts of the calls that reach `window_layer` from the windowed
    encoder and of every `*_plain` function of `ops/window_attn.py`."""
    calls = {"window_layer": 0, "plain": 0}

    def counted(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(windowed_encoder, "window_layer",
                        counted(windowed_encoder.window_layer,
                                "window_layer"))
    for name in [n for n in dir(window_attn) if n.endswith("_plain")]:
        monkeypatch.setattr(window_attn, name,
                            counted(getattr(window_attn, name), "plain"))
    return calls


def test_two_fast_train_steps_match_jax(setup, jax_two_steps, float64_steps,
                                        window_calls):
    port_two_steps_match(setup, jax_two_steps, float64_steps)
    assert window_calls == {"window_layer": 0, "plain": 0}


def test_eval_calls_still_take_the_window_layer(setup, window_calls):
    """An eval-mode forward of the same model goes through `window_layer`
    once per encoder layer, and its plain version on the CPU."""
    model = setup.tmodel
    try:
        model.eval()
        with torch.inference_mode():
            model(setup.tpack["batch"])
    finally:
        model.train()
    assert window_calls == {"window_layer": setup.cfg.enc_layers,
                            "plain": setup.cfg.enc_layers}


def test_fast_step_with_dropout_runs(setup, window_calls):
    """A tracking step at the config's dropout 0.1 with a seeded generator:
    finite loss and gradient norm, the weights move, and the dropout of
    the windowed layers draws (two training forwards differ)."""
    cfg = setup.cfg.replace(dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    model, crit, _, track = build_model(cfg, "cpu", generator=gen,
                                        train=True)
    layer = model.transformer.encoder.layers[0]
    assert layer.drop.p == 0.1 and layer.self_attn.attn_drop.p == 0.1
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=True)
    name = "transformer.encoder.layers.1.linear1.weight"
    before = state.params[name].clone()
    state, metrics = step(state, setup.tpack, gen)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    assert not torch.equal(state.params[name], before)
    with torch.no_grad():
        outs = [model(setup.tpack["batch"])[0]["pred_logits"]
                for _ in range(2)]
    assert not torch.equal(*outs)
    assert window_calls == {"window_layer": 0, "plain": 0}


def test_fast_mode_builds_for_training_on_the_card_by_default():
    """`build_model(tpu_fast, train=True)` returns the JAX factory's tuple
    with the config's warmup; without a card it raises rather than
    building on the CPU."""
    cfg = FlagshipConfig.tpu_fast()
    assert cfg.lr_warmup_steps == 1000
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_model(cfg, train=True)
