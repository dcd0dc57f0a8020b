"""The port's windowed encoder (trackformer_tpu_torch.models.windowed_encoder
and ops/window_attn.py) held against the JAX package on the CPU, module by
module, without a backbone: the window layout (partition, merge, the
positions and key padding of both shift parities, with odd level sizes and
a fully-padded window), the windowed layer's plain version against both
JAX paths (the module path, and the Pallas kernel in interpret mode), the
cross-level fusion (including a 25 -> 13 level, where JAX's nearest resize
is not torch's), and a 2-layer encoder in float32 and bfloat16.

Weights come from one JAX `init` through the port's `convert.py`; inputs
are drawn with numpy from a seed. Tolerances: float32 on both sides, summed
in different orders, 1e-5 (layout: exact); bfloat16 through two layers,
where the frameworks round the same values at the same points but may sum
in other orders, 5e-2 absolute and relative, as the JAX package's own
bf16 check of its kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.models import windowed_encoder as jwe
from trackformer_tpu.ops.window_attn import fused_window_layer as jax_fused
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import windowed_encoder as twe
from trackformer_tpu_torch.ops import msda, window_attn

torch.set_num_threads(1)

C, HEADS, FF, WIN = 32, 4, 64, 8
B = 2
# odd sizes, a 25 -> 13 step; level 0 of item 1 is padded from row 8 on,
# so with the 12 -> 16 pad its second window row is wholly excluded
SHAPES = ((12, 20), (25, 10), (13, 5), (7, 3))


def make_levels(seed, shapes=SHAPES, c=C):
    rng = np.random.RandomState(seed)
    srcs = [rng.randn(B, h, w, c).astype(np.float32) for h, w in shapes]
    poses = [rng.randn(B, h, w, c).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((B, h, w), bool)
        m[1, max(1, (2 * h) // 3):] = True
        m[1, :, max(1, (3 * w) // 4):] = True
        masks.append(m)
    return srcs, masks, poses


def to_t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_j(arrays):
    return [jnp.asarray(a) for a in arrays]


def perturbed(params, seed):
    """Random biases and norm affines, so that every term carries signal
    (flax initializes them to zeros and ones)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        x = np.asarray(x)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name == "bias":
            return (0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def port_state(subtree, prefix):
    """JAX params of an encoder part (a layer, a fusion or the whole
    encoder) -> the port's state_dict of that part, through `convert.py`
    and its `transformer.encoder.*` keys."""
    tree = {"params": {"encoder": subtree if prefix is None
                       else {prefix: subtree}}}
    head = "transformer.encoder." + ("" if prefix is None else
                                     {"layer_0": "layers.0.",
                                      "fuse_0": "fuse.0."}[prefix])
    sd = jax_params_to_state_dict(tree)
    assert all(k.startswith(head) for k in sd)
    return {k[len(head):]: v for k, v in sd.items()}


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shift", [False, True], ids=["shift0", "shift1"])
def test_window_layout_matches_jax(shift):
    srcs, masks, poses = make_levels(0)
    jpw, jkp = jax.jit(jwe.window_context, static_argnums=(2, 3, 4))(
        to_j(poses), to_j(masks), WIN, shift, jnp.float32)
    tpw, tkp = twe.window_context(to_t(poses), to_t(masks), WIN, shift,
                                  torch.float32)
    close(tpw, jpw, atol=0, rtol=0)
    assert np.array_equal(tkp.numpy(), np.asarray(jkp))
    if not shift:
        # level 0 (12 x 20, padded to 2 x 3 windows) has a window excluded
        # wholly before the un-masking
        m0 = np.pad(masks[0], ((0, 0), (0, 4), (0, 4)), constant_values=True)
        blocks = m0.reshape(B, 2, WIN, 3, WIN).transpose(0, 1, 3, 2, 4)
        assert blocks.reshape(B * 6, -1).all(1).any()
    for x, (h, w) in zip(srcs, SHAPES):
        xp, hp, wp = jwe._pad_hw(jnp.asarray(x), WIN)
        txp, thp, twp = twe.pad_hw(torch.from_numpy(x), WIN)
        assert (thp, twp) == (hp, wp)
        jw = jwe.window_partition(xp, WIN)
        tw = twe.window_partition(txp, WIN)
        close(tw, jw, atol=0, rtol=0)
        close(twe.window_merge(tw, B, thp, twp, WIN),
              jwe.window_merge(jw, B, hp, wp, WIN), atol=0, rtol=0)


@pytest.fixture(scope="module")
def layer_setup():
    srcs, masks, poses = make_levels(1)
    jlayer = jwe.WindowedEncoderLayer(C, HEADS, FF, window=WIN, shift=True)
    ctx = jax.jit(jwe.window_context, static_argnums=(2, 3, 4))(
        to_j(poses), to_j(masks), WIN, True, jnp.float32)
    params = jax.jit(lambda k, s, p, m, c: jlayer.init(k, s, p, m, True, c))(
        jax.random.PRNGKey(2), to_j(srcs), to_j(poses), to_j(masks), ctx)
    params = perturbed(params, 3)
    tlayer = twe.WindowedEncoderLayer(C, HEADS, FF, WIN, shift=True)
    tlayer.load_state_dict(port_state(params["params"], "layer_0"))
    return jlayer, params, tlayer, (srcs, masks, poses), ctx


def test_window_layer_plain_matches_jax_module_path(layer_setup,
                                                    monkeypatch):
    monkeypatch.setattr(jwe, "ATTN_IMPL", "module")
    jlayer, params, tlayer, (srcs, masks, poses), ctx = layer_setup
    want = jlayer.apply(params, to_j(srcs), to_j(poses), to_j(masks), True,
                        ctx)
    tctx = twe.window_context(to_t(poses), to_t(masks), WIN, True,
                              torch.float32)
    msda.reset_launch_counts()
    window_attn.reset_launch_counts()
    with torch.no_grad():
        got = tlayer([torch.from_numpy(s) for s in srcs], tctx)
    for g, w in zip(got, want):
        close(g, w)
    # a CPU call runs the plain version and launches nothing
    assert set(window_attn.launch_counts()) >= {"fused_window_layer",
                                                *window_attn.STAGES}
    assert not any(window_attn.launch_counts().values())


def test_window_layer_plain_matches_jax_kernel_interpret(layer_setup):
    _, params, tlayer, _, _ = layer_setup
    p = params["params"]
    weights = {f"{n}_{kind}": p["self_attn"][f"{n}_proj"][kind]
               for n in ("q", "k", "v", "out") for kind in ("kernel", "bias")}
    for mod in ("norm1", "norm2"):
        weights[f"{mod}_scale"] = p[mod]["scale"]
        weights[f"{mod}_bias"] = p[mod]["bias"]
    for mod in ("linear1", "linear2"):
        weights[f"{mod}_kernel"] = p[mod]["kernel"]
        weights[f"{mod}_bias"] = p[mod]["bias"]
    rng = np.random.RandomState(4)
    nw = 6  # not a multiple of the TPU kernel's 4 windows per tile
    xw = rng.randn(nw, WIN * WIN, C).astype(np.float32)
    pw = rng.randn(nw, WIN * WIN, C).astype(np.float32)
    kp = rng.rand(nw, WIN * WIN) < 0.3
    kp[2] = False
    want = jax_fused(jnp.asarray(xw), jnp.asarray(pw), jnp.asarray(kp),
                     {k: jnp.asarray(v) for k, v in weights.items()}, HEADS,
                     interpret=True)
    with torch.no_grad():
        got = window_attn.window_layer(torch.from_numpy(xw),
                                       torch.from_numpy(pw),
                                       torch.from_numpy(kp), tlayer)
    close(got, want)


def test_cuda_launcher_refuses_cpu_tensors(layer_setup):
    tlayer = layer_setup[2]
    x = torch.zeros(1, WIN * WIN, C)
    with pytest.raises(ValueError, match="CUDA tensors"):
        window_attn.fused_window_layer(x, x, torch.zeros(1, WIN * WIN,
                                                         dtype=torch.bool),
                                       tlayer)


def test_packed_weights_follow_the_parameters():
    """The kernel's packed weights are made once per layer and dtype, and
    made anew after an in-place write or a dtype change."""
    gen = torch.Generator().manual_seed(0)
    layer = twe.WindowedEncoderLayer(C, HEADS, FF, WIN, shift=False)
    with torch.no_grad():  # the module leaves some parameters uninitialized
        for p in layer.parameters():
            p.normal_(generator=gen)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    first = window_attn.packed_weights(layer, torch.float32)
    assert window_attn.packed_weights(layer, torch.float32) is first
    assert same(first, window_attn.pack_weights(layer, torch.float32))
    with torch.no_grad():
        layer.linear2.bias.add_(1.0)
    second = window_attn.packed_weights(layer, torch.float32)
    assert second is not first
    assert same(second, window_attn.pack_weights(layer, torch.float32))
    layer.load_state_dict({k: v + 0.5 for k, v in
                           layer.state_dict().items()})
    assert same(window_attn.packed_weights(layer, torch.float32),
                window_attn.pack_weights(layer, torch.float32))
    layer.to(torch.bfloat16)
    packed = window_attn.packed_weights(layer, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in packed)
    assert same(packed, window_attn.pack_weights(layer, torch.bfloat16))


def test_cross_level_fusion_matches_jax():
    shapes = ((50, 42), (25, 21), (13, 11), (7, 6))
    srcs, _, _ = make_levels(5, shapes)
    jfuse = jwe.CrossLevelFusion(C)
    params = perturbed(jax.jit(jfuse.init)(jax.random.PRNGKey(6),
                                           to_j(srcs)), 7)
    want = jax.jit(jfuse.apply)(params, to_j(srcs))
    tfuse = twe.CrossLevelFusion(C, len(shapes))
    tfuse.load_state_dict(port_state(params["params"], "fuse_0"))
    with torch.no_grad():
        got = tfuse(to_t(srcs))
    for g, w in zip(got, want):
        close(g, w)
    for n_in, n_out in ((25, 13), (13, 25), (50, 25), (21, 11), (11, 21)):
        x = jnp.arange(n_in, dtype=jnp.float32)
        ref = jax.image.resize(x, (n_out,), "nearest")
        assert np.array_equal(twe.nearest_idx(n_out, n_in),
                              np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_encoder_matches_jax(dtype, monkeypatch):
    monkeypatch.setattr(jwe, "ATTN_IMPL", "module")
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = getattr(torch, dtype)
    srcs, masks, poses = make_levels(8)
    jenc = jwe.WindowedEncoder(C, num_layers=2, nheads=HEADS,
                               dim_feedforward=FF, window=WIN, dtype=jdtype)
    # positions enter in the compute dtype, as the model adds the level
    # embeds in it
    jposes = [p.astype(jdtype) for p in to_j(poses)]
    params = jax.jit(jenc.init)(jax.random.PRNGKey(9), to_j(srcs),
                                to_j(masks), jposes)
    want = jax.jit(jenc.apply)(params,
                               [s.astype(jdtype) for s in to_j(srcs)],
                               to_j(masks), jposes)
    tenc = twe.WindowedEncoder(C, len(SHAPES), 2, HEADS, FF, WIN)
    tenc.load_state_dict(port_state(params["params"], None))
    tenc = tenc.to(tdtype)
    msda.reset_launch_counts()
    window_attn.reset_launch_counts()
    with torch.no_grad():
        got = tenc([torch.from_numpy(s).permute(0, 3, 1, 2).to(tdtype)
                    for s in srcs], to_t(masks),
                   [torch.from_numpy(p).to(tdtype) for p in poses])
    assert got.dtype == tdtype
    assert got.shape == (B, sum(h * w for h, w in SHAPES), C)
    tol = 1e-5 if dtype == "float32" else 5e-2
    close(got, np.asarray(want, np.float32), atol=tol, rtol=tol)
    assert window_attn.launch_counts()["fused_window_layer"] == 0
    assert sum(msda.launch_counts().values()) == 0
