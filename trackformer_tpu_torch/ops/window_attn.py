"""One windowed-encoder layer over every window of a call: its plain
PyTorch versions (the module path, and the five stages of the kernels), the
binding of its CUDA kernels, and the dispatch.

Counterpart of `trackformer_tpu/ops/window_attn.py` (`fused_window_layer`,
a Pallas TPU kernel) and of the module path of the JAX package's
`WindowedEncoderLayer`. The contract:

  xw, pw: (NW, WS, C) tokens and position embeds in the windowed layout
  kp:     (NW, WS) bool, True = exclude the key
  layer:  the `WindowedEncoderLayer` holding the weights (`self_attn`,
          `norm1`, `linear1`, `linear2`, `norm2`)
  -> (NW, WS, C) in xw's dtype: q, k from xw + pw and v from xw, windowed
     multi-head attention with key padding, out projection, residual +
     LayerNorm, FFN (ReLU), residual + LayerNorm.

`window_layer` sends a CUDA tensor to `fused_window_layer` and a CPU tensor
to `window_layer_plain`. Nothing falls back from a kernel to a plain
version. In bfloat16 `fused_window_layer` runs the five stage kernels of
`csrc/window_layer_fwd.cu` over the R = NW * WS tokens, through
intermediates in device memory:

  window_layer_qkv      x, pos         -> q|k|v (R, 3C)
  window_layer_attn     q|k|v, kp      -> a (R, C), per (window, head, 64
                                          query rows)
  window_layer_proj_ln  a, x           -> x1 = LayerNorm1(x + a Wo + bo)
  window_layer_ffn1     x1             -> h = relu(x1 W1 + b1) (R, ff)
  window_layer_ffn2_ln  h, x1          -> LayerNorm2(x1 + h W2 + b2)

each beside its plain version here (`qkv_plain`, ...; chained by
`window_layer_staged_plain`), with the same operands, layout and rounding.
In float32 it launches one kernel per call, a block per (window, 64 query
rows). The kernels are built at first use (`cuda_build.py`); they are
forward only, and take windows of 64 or 256 tokens (window side 8 or 16,
`WINDOW_SIDES`), 8 heads, an FFN width that is a multiple of 128, and C = 288
(the flagship, heads of 36) or C = 256 (the single-frame Deformable DETR
family, heads of 32): each kernel is a template on C (and the attention's
and the float32 layer's on the window), instantiated at those sizes. Any
other width, head count or window raises `NotImplementedError` naming
the sizes the kernels take.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence, Tuple

import torch
from torch.nn import functional as F

from .linear import dense
from .cuda_build import CudaLib

WS, N_HEADS, FF_CHUNK = 64, 8, 128
# the widths and the windows (window sides, and their tokens) the kernels
# are instantiated at
WIDTHS = (288, 256)
WINDOW_SIDES = (8, 16)
WINDOWS = tuple(side * side for side in WINDOW_SIDES)
LN_EPS = 1e-6


def d_head_pad(c: int) -> int:
    """The float32 kernel's head width: d_head rounded up to 16 (48 at C =
    288, 32 at C = 256)."""
    return -(-(c // N_HEADS) // 16) * 16


def check_width(c: int, heads: int = N_HEADS, ws: int = WS) -> None:
    """Raise unless a kernel is instantiated for this layer shape."""
    if c not in WIDTHS or heads != N_HEADS or ws not in WINDOWS:
        raise NotImplementedError(
            f"window layer kernel at C = {c}, {heads} heads, windows of "
            f"{ws} tokens: no kernel is instantiated there; the kernels "
            f"take C in {WIDTHS}, {N_HEADS} heads, windows of {WINDOWS} "
            f"tokens")

# the bfloat16 path's kernels, in launch order
STAGES = ("window_layer_qkv", "window_layer_attn", "window_layer_proj_ln",
          "window_layer_ffn1", "window_layer_ffn2_ln")
# launches: `fused_window_layer` adds one per call; each kernel's wrapper
# one where it launches (the float32 kernel: `window_layer_f32`)
LAUNCHES: Dict[str, int] = {"fused_window_layer": 0,
                            **{name: 0 for name in STAGES},
                            "window_layer_f32": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLib("window_layer_fwd.cu", {
    "window_layer_qkv": (_I, [_P] * 5 + [_I, _I, _P]),
    "window_layer_attn": (_I, [_P] * 3 + [_I, _I, _I, _P]),
    "window_layer_proj_ln": (_I, [_P] * 7 + [_I, _I, _P]),
    "window_layer_ffn1": (_I, [_P] * 4 + [_I, _I, _I, _P]),
    "window_layer_ffn2_ln": (_I, [_P] * 7 + [_I, _I, _I, _P]),
    "window_layer_occupancy": (_I, [_I, _I, _I, ctypes.POINTER(_I),
                                    ctypes.POINTER(_I)]),
    "window_layer_f32_fwd": (_I, [_P] * 16 + [_I] * 5 + [_P])})


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def window_layer_plain(xw: torch.Tensor, pw: torch.Tensor, kp: torch.Tensor,
                       layer) -> torch.Tensor:
    """The layer as plain PyTorch ops (the JAX module path)."""
    q = xw + pw
    x = layer.norm1(xw + layer.self_attn(q, q, xw, kp))
    hidden = torch.relu(dense(x, layer.linear1.weight, layer.linear1.bias))
    return layer.norm2(x + dense(hidden, layer.linear2.weight,
                                 layer.linear2.bias))


def pack_weights(layer, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The kernels' weight operands, in `dtype`, every matrix as (in, out):
    `in_proj` as (C, 3C), the q columns of all heads, then k, then v (head
    h at columns d h .. d h + d - 1 of each, d = C / 8), with its bias
    alike; then the
    out projection, the norms and the FFN."""
    mha = layer.self_attn

    def mat(weight):
        return weight.to(dtype).t()

    def vec(p):
        return p.to(dtype)

    ws = (mat(mha.in_proj_weight), vec(mha.in_proj_bias),
          mat(mha.out_proj.weight), vec(mha.out_proj.bias),
          vec(layer.norm1.weight), vec(layer.norm1.bias),
          mat(layer.linear1.weight), vec(layer.linear1.bias),
          mat(layer.linear2.weight), vec(layer.linear2.bias),
          vec(layer.norm2.weight), vec(layer.norm2.bias))
    return tuple(t.contiguous() for t in ws)


def padded_qkv(wqkv: torch.Tensor,
               bqkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_weights`' (C, 3C) q|k|v in the layout of the float32 kernel
    (a block per window): (C, heads * 2 * 48 + heads * 48), the q and k
    columns of each head side by side, then the v columns of all heads,
    each head zero-padded from d_head to `d_head_pad`; its bias alike."""
    c = wqkv.shape[0]
    pad = d_head_pad(c) - c // N_HEADS
    w = F.pad(wqkv.view(c, 3, N_HEADS, -1), (0, pad))  # (C, 3, nh, pad)
    b = F.pad(bqkv.view(3, N_HEADS, -1), (0, pad))
    return (torch.cat([w[:, :2].permute(0, 2, 1, 3).reshape(c, -1),
                       w[:, 2].reshape(c, -1)], 1).contiguous(),
            torch.cat([b[:2].permute(1, 0, 2).reshape(-1),
                       b[2].reshape(-1)]).contiguous())


def packed_weights(layer, dtype: torch.dtype,
                   padded: bool = False) -> Tuple[torch.Tensor, ...]:
    """`pack_weights` (with `padded`, its q|k|v through `padded_qkv`),
    made once per layer, dtype and layout and kept on the layer. It is made
    anew when a parameter is replaced (`.to()`, a new device) or written in
    place (`load_state_dict`, an optimizer step), which the parameters'
    storage and version counters show. Parameters made under
    `torch.inference_mode` have no version counter; they are keyed by
    storage alone."""
    key = (dtype, padded) + tuple(
        (p.data_ptr(), None if p.is_inference() else p._version)
        for p in layer.parameters())
    cache = layer.__dict__.setdefault("_window_layer_packs", {})
    hit = cache.get((dtype, padded))
    if hit is None or hit[0] != key:
        pack = pack_weights(layer, dtype)
        if padded:
            pack = padded_qkv(*pack[:2]) + pack[2:]
        hit = cache[(dtype, padded)] = (key, pack)
    return hit[1]


# --------------------------------------------------------------------------
# the stages' plain versions: R = NW * WS token rows, every matrix (in, out)
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a w summed in float32, rounded to a's dtype."""
    return (a.float() @ w.float()).to(a.dtype)


def _layer_norm(y: torch.Tensor, g: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """LayerNorm as the kernels take it: float32 statistics, the variance
    as E[y^2] - E[y]^2, eps 1e-6, the affine in float32, rounded once."""
    y32 = y.float()
    mean = y32.mean(-1, keepdim=True)
    var = (y32 * y32).mean(-1, keepdim=True) - mean * mean
    z = (y32 - mean) * torch.rsqrt(var + LN_EPS)
    return (z * g.float() + b.float()).to(y.dtype)


def qkv_plain(x: torch.Tensor, pos: torch.Tensor, wqkv: torch.Tensor,
              bqkv: torch.Tensor) -> torch.Tensor:
    """(R, C) tokens and positions -> (R, 3C) q|k|v: q and k from x + pos
    (rounded), v from x; each product rounded, then its bias added."""
    c = x.shape[1]
    qk = _mm(x + pos, wqkv[:, :2 * c]) + bqkv[:2 * c]
    return torch.cat([qk, _mm(x, wqkv[:, 2 * c:]) + bqkv[2 * c:]], 1)


def attn_plain(qkv: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """(R, 3C) q|k|v and the (NW, WS) key mask (WS tokens a window) -> (R,
    C) the heads' outputs side by side: float32 logits scaled after the product, excluded
    keys at float32's minimum, softmax as e / sum(e), the probabilities
    rounded before they multiply v, the sum rounded."""
    r, c = qkv.shape[0], qkv.shape[1] // 3
    nw = kp.shape[0]
    q, k, v = qkv.view(nw, r // nw, 3, N_HEADS, -1).float().unbind(2)
    scale = 1.0 / math.sqrt(c // N_HEADS)
    logits = torch.einsum("wqhd,wkhd->whqk", q, k) * scale
    logits = logits.masked_fill(kp[:, None, None, :],
                                torch.finfo(torch.float32).min)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    out = torch.einsum("whqk,wkhd->wqhd", p.float(), v)
    return out.to(qkv.dtype).reshape(r, c)


def proj_ln_plain(a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  x: torch.Tensor, g1: torch.Tensor,
                  be1: torch.Tensor) -> torch.Tensor:
    """x1 = LayerNorm1(x + (a Wo + bo)), each sum rounded."""
    return _layer_norm(x + (_mm(a, wo) + bo), g1, be1)


def ffn1_plain(x1: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor) -> torch.Tensor:
    """h = relu(x1 W1 + b1), (R, ff)."""
    return torch.relu(_mm(x1, w1) + b1)


def ffn2_ln_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  x1: torch.Tensor, g2: torch.Tensor,
                  be2: torch.Tensor) -> torch.Tensor:
    """LayerNorm2(x1 + (h W2 + b2)), each sum rounded."""
    return _layer_norm(x1 + (_mm(h, w2) + b2), g2, be2)


def window_layer_staged_plain(xw: torch.Tensor, pw: torch.Tensor,
                              kp: torch.Tensor,
                              weights: Sequence[torch.Tensor]
                              ) -> torch.Tensor:
    """The layer as the five stages' plain versions, on `pack_weights`."""
    nw, ws, c = xw.shape
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = weights
    x = xw.reshape(-1, c)
    qkv = qkv_plain(x, pw.reshape(-1, c), wqkv, bqkv)
    x1 = proj_ln_plain(attn_plain(qkv, kp), wo, bo, x, g1, be1)
    return ffn2_ln_plain(ffn1_plain(x1, w1, b1), w2, b2, x1, g2,
                         be2).view(nw, ws, c)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _launch(fn: str, count: str, device: torch.device, *args) -> None:
    """One launch of the C entry point `fn` on `device`'s current stream;
    raises on a refused launch, else counts it under `count`."""
    lib = LIB.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    LAUNCHES[count] += 1


def _check_stage(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be CUDA tensors")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: bfloat16 operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_rows(name: str, shapes: Dict[str, Tuple[torch.Tensor, tuple]]
                ) -> None:
    for what, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} of shape {tuple(t.shape)}, "
                             f"want {want}")


def qkv_cuda(x: torch.Tensor, pos: torch.Tensor, wqkv: torch.Tensor,
             bqkv: torch.Tensor) -> torch.Tensor:
    """`qkv_plain` as one launch of `window_layer_qkv`."""
    _check_stage("window_layer_qkv", x, pos, wqkv, bqkv)
    r, c = x.shape
    check_width(c)
    _check_rows("window_layer_qkv", {
        "x": (x, (r, c)), "pos": (pos, (r, c)), "wqkv": (wqkv, (c, 3 * c)),
        "bqkv": (bqkv, (3 * c,))})
    out = torch.empty(r, 3 * c, dtype=x.dtype, device=x.device)
    _launch("window_layer_qkv", "window_layer_qkv", x.device, x.data_ptr(),
            pos.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), out.data_ptr(),
            r, c)
    return out


def attn_cuda(qkv: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """`attn_plain` as one launch of `window_layer_attn`; the window's
    token count is the key mask's width."""
    _check_stage("window_layer_attn", qkv)
    (nw, ws), c = kp.shape, qkv.shape[1] // 3
    check_width(c, N_HEADS, ws)
    if not (kp.is_cuda and kp.device == qkv.device
            and kp.dtype == torch.bool and kp.is_contiguous()):
        raise ValueError("window_layer_attn: the key mask must be a "
                         "contiguous bool CUDA tensor on the device of q|k|v")
    _check_rows("window_layer_attn", {"qkv": (qkv, (nw * ws, 3 * c))})
    out = torch.empty(nw * ws, c, dtype=qkv.dtype, device=qkv.device)
    _launch("window_layer_attn", "window_layer_attn", qkv.device,
            qkv.data_ptr(), kp.data_ptr(), out.data_ptr(), nw, ws, c)
    return out


def proj_ln_cuda(a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                 x: torch.Tensor, g1: torch.Tensor,
                 be1: torch.Tensor) -> torch.Tensor:
    """`proj_ln_plain` as one launch of `window_layer_proj_ln`."""
    _check_stage("window_layer_proj_ln", a, wo, bo, x, g1, be1)
    r, c = a.shape
    check_width(c)
    _check_rows("window_layer_proj_ln", {
        "a": (a, (r, c)), "wo": (wo, (c, c)), "x": (x, (r, c)),
        **{n: (t, (c,)) for n, t in (("bo", bo), ("g1", g1), ("be1", be1))}})
    out = torch.empty_like(x)
    _launch("window_layer_proj_ln", "window_layer_proj_ln", a.device,
            a.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
            g1.data_ptr(), be1.data_ptr(), out.data_ptr(), r, c)
    return out


def ffn1_cuda(x1: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor) -> torch.Tensor:
    """`ffn1_plain` as one launch of `window_layer_ffn1`."""
    _check_stage("window_layer_ffn1", x1, w1, b1)
    (r, c), ff = x1.shape, w1.shape[1]
    check_width(c)
    _check_rows("window_layer_ffn1", {"x1": (x1, (r, c)), "w1": (w1, (c, ff)),
                                      "b1": (b1, (ff,))})
    if ff % FF_CHUNK:
        raise ValueError(f"window_layer_ffn1: FFN width {ff} is not a "
                         f"multiple of {FF_CHUNK}")
    out = torch.empty(r, ff, dtype=x1.dtype, device=x1.device)
    _launch("window_layer_ffn1", "window_layer_ffn1", x1.device,
            x1.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), r,
            ff, c)
    return out


def ffn2_ln_cuda(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 x1: torch.Tensor, g2: torch.Tensor,
                 be2: torch.Tensor) -> torch.Tensor:
    """`ffn2_ln_plain` as one launch of `window_layer_ffn2_ln`."""
    _check_stage("window_layer_ffn2_ln", h, w2, b2, x1, g2, be2)
    (r, ff), c = h.shape, x1.shape[1]
    check_width(c)
    _check_rows("window_layer_ffn2_ln", {
        "w2": (w2, (ff, c)), "x1": (x1, (r, c)),
        **{n: (t, (c,)) for n, t in (("b2", b2), ("g2", g2), ("be2", be2))}})
    if ff % FF_CHUNK:
        raise ValueError(f"window_layer_ffn2_ln: FFN width {ff} is not a "
                         f"multiple of {FF_CHUNK}")
    out = torch.empty_like(x1)
    _launch("window_layer_ffn2_ln", "window_layer_ffn2_ln", h.device,
            h.data_ptr(), w2.data_ptr(), b2.data_ptr(), x1.data_ptr(),
            g2.data_ptr(), be2.data_ptr(), out.data_ptr(), r, ff, c)
    return out


def stage_occupancy(c: int = 288, ws: int = WS
                    ) -> Dict[str, Tuple[int, int]]:
    """Each stage kernel's (blocks per SM that the card grants, dynamic
    shared bytes a block) at width `c` and windows of `ws` tokens, from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor` on the current
    device."""
    check_width(c, N_HEADS, ws)
    lib = LIB.load()
    out = {}
    for i, name in enumerate(STAGES):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.window_layer_occupancy(i, c, ws, ctypes.byref(blocks),
                                        ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"window_layer_occupancy({name}): "
                               f"cudaError {rc}")
        out[name] = (blocks.value, smem.value)
    return out


def _check_inputs(xw, pw, kp, layer) -> None:
    if not (xw.is_cuda and pw.is_cuda and kp.is_cuda):
        raise ValueError("window_layer_fwd: all inputs must be CUDA tensors")
    if not (xw.device == pw.device == kp.device):
        raise ValueError("window_layer_fwd: inputs on different devices")
    if xw.dtype not in (torch.float32, torch.bfloat16) or pw.dtype != xw.dtype:
        raise TypeError(f"window_layer_fwd: dtypes {xw.dtype}, {pw.dtype}")
    if kp.dtype != torch.bool:
        raise TypeError("window_layer_fwd: the key mask must be bool")
    params = list(layer.parameters())
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [xw, pw, *params]):
        raise RuntimeError("window_layer_fwd is forward-only: call it under "
                           "torch.no_grad(); to train the windowed encoder "
                           "run its module path (window_layer_plain), as "
                           "the JAX package does")
    ff = layer.linear1.weight.shape[0]
    if xw.dim() != 3:
        raise ValueError(f"window_layer_fwd takes (NW, WS, C) windows; got "
                         f"{tuple(xw.shape)}")
    nw, ws, _ = xw.shape
    check_width(xw.shape[2], layer.self_attn.num_heads, ws)
    if (pw.shape != xw.shape or tuple(kp.shape) != (nw, ws)
            or ff % FF_CHUNK):
        raise ValueError(
            f"window_layer_fwd takes (NW, WS, C) windows, positions of "
            f"their shape, an (NW, WS) key mask and an FFN width "
            f"divisible by {FF_CHUNK}; got {tuple(xw.shape)}, "
            f"{tuple(pw.shape)}, {tuple(kp.shape)}, FFN {ff}")
    if any(p.device != xw.device for p in params):
        raise ValueError("window_layer_fwd: weights on another device")
    if not (xw.is_contiguous() and pw.is_contiguous()
            and kp.is_contiguous()):
        raise ValueError("window_layer_fwd: inputs must be contiguous")
    if (xw.data_ptr() | pw.data_ptr()) % 16:
        raise ValueError("window_layer_fwd: inputs must be 16-byte aligned")


def fused_window_layer(xw: torch.Tensor, pw: torch.Tensor, kp: torch.Tensor,
                       layer) -> torch.Tensor:
    """The layer over all NW windows on the card -> (NW, WS, C) in xw's
    dtype: the five stage kernels in bfloat16, the float32 kernel in
    float32. Counts the call."""
    _check_inputs(xw, pw, kp, layer)
    nw, ws, c = xw.shape
    if xw.dtype == torch.bfloat16:
        (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2,
         be2) = packed_weights(layer, xw.dtype)
        x = xw.view(-1, c)
        qkv = qkv_cuda(x, pw.view(-1, c), wqkv, bqkv)
        x1 = proj_ln_cuda(attn_cuda(qkv, kp), wo, bo, x, g1, be1)
        out = ffn2_ln_cuda(ffn1_cuda(x1, w1, b1), w2, b2, x1, g2,
                           be2).view(nw, ws, c)
    else:
        weights = packed_weights(layer, xw.dtype, padded=True)
        out = torch.empty_like(xw)
        _launch("window_layer_f32_fwd", "window_layer_f32", xw.device,
                xw.data_ptr(), pw.data_ptr(), kp.data_ptr(),
                *[w.data_ptr() for w in weights], out.data_ptr(), nw, ws, c,
                N_HEADS, layer.linear1.weight.shape[0])
    LAUNCHES["fused_window_layer"] += 1
    return out


def window_layer(xw: torch.Tensor, pw: torch.Tensor, kp: torch.Tensor,
                 layer) -> torch.Tensor:
    """The layer over every window (module docstring): the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if xw.device.type == "cpu":
        return window_layer_plain(xw, pw, kp, layer)
    return fused_window_layer(xw, pw, kp, layer)
