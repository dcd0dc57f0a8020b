"""One windowed-encoder layer over every window of a call: its plain
PyTorch version, the binding of its CUDA kernel, and the dispatch.

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

`window_layer` sends a CUDA tensor to ONE launch of the kernel in
`csrc/window_layer_fwd.cu` (`fused_window_layer`) and a CPU tensor to
`window_layer_plain`. Nothing falls back from the kernel to the plain
version. The kernel is built at first use (`cuda_build.py`); it is forward
only, and takes the flagship's layer shape: windows of 64 tokens, C = 288,
8 heads, an FFN width that is a multiple of 128.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from .linear import dense
from .cuda_build import CudaLib

WS, C, N_HEADS, D_HEAD_PAD, FF_CHUNK = 64, 288, 8, 48, 128

# launches of the kernel; `fused_window_layer` adds one where it launches
LAUNCHES: Dict[str, int] = {"fused_window_layer": 0}

LIB = CudaLib("window_layer_fwd.cu", {"window_layer_fwd": (
    ctypes.c_int, [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
    + [ctypes.c_void_p])})


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
    """The kernel's weight operands, in `dtype`, every matrix as (in, out):
    `in_proj` as (C, heads * 2 * 48 + heads * 48), the q and k columns of
    each head side by side and then the v columns of all heads, each head
    zero-padded from d_head to 48, with its bias alike; then the out
    projection, the norms and the FFN."""
    mha = layer.self_attn
    nh, c = mha.num_heads, mha.d_model
    pad = D_HEAD_PAD - c // nh
    w = F.pad(mha.in_proj_weight.to(dtype).view(3, nh, -1, c),
              (0, 0, 0, pad))                          # (3, nh, 48, C)
    wqkv = torch.cat([w[:2].permute(3, 1, 0, 2).reshape(c, -1),
                      w[2].permute(2, 0, 1).reshape(c, -1)], 1)
    b = F.pad(mha.in_proj_bias.to(dtype).view(3, nh, -1), (0, pad))
    bqkv = torch.cat([b[:2].permute(1, 0, 2).reshape(-1), b[2].reshape(-1)])

    def mat(lin):
        return lin.weight.to(dtype).t()

    def vec(p):
        return p.to(dtype)

    ws = (wqkv, bqkv, mat(mha.out_proj), vec(mha.out_proj.bias),
          vec(layer.norm1.weight), vec(layer.norm1.bias),
          mat(layer.linear1), vec(layer.linear1.bias),
          mat(layer.linear2), vec(layer.linear2.bias),
          vec(layer.norm2.weight), vec(layer.norm2.bias))
    return tuple(t.contiguous() for t in ws)


def packed_weights(layer, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """`pack_weights`, made once per layer and dtype and kept on the layer.
    It is made anew when a parameter is replaced (`.to()`, a new device) or
    written in place (`load_state_dict`, an optimizer step), which the
    parameters' storage and version counters show. Parameters made under
    `torch.inference_mode` have no version counter; they are keyed by
    storage alone."""
    key = (dtype,) + tuple(
        (p.data_ptr(), None if p.is_inference() else p._version)
        for p in layer.parameters())
    cache = layer.__dict__.setdefault("_window_layer_packs", {})
    hit = cache.get(dtype)
    if hit is None or hit[0] != key:
        hit = cache[dtype] = (key, pack_weights(layer, dtype))
    return hit[1]


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
    nw = xw.shape[0]
    ff = layer.linear1.weight.shape[0]
    if (xw.dim() != 3 or tuple(xw.shape[1:]) != (WS, C)
            or pw.shape != xw.shape or tuple(kp.shape) != (nw, WS)
            or layer.self_attn.num_heads != N_HEADS or ff % FF_CHUNK):
        raise ValueError(
            f"window_layer_fwd takes (NW, {WS}, {C}) windows, {N_HEADS} "
            f"heads and an FFN width divisible by {FF_CHUNK}; got "
            f"{tuple(xw.shape)}, {tuple(kp.shape)}, "
            f"{layer.self_attn.num_heads} heads, FFN {ff}")
    if any(p.device != xw.device for p in params):
        raise ValueError("window_layer_fwd: weights on another device")
    if not (xw.is_contiguous() and pw.is_contiguous()
            and kp.is_contiguous()):
        raise ValueError("window_layer_fwd: inputs must be contiguous")
    if (xw.data_ptr() | pw.data_ptr()) % 16:
        raise ValueError("window_layer_fwd: inputs must be 16-byte aligned")


def fused_window_layer(xw: torch.Tensor, pw: torch.Tensor, kp: torch.Tensor,
                       layer) -> torch.Tensor:
    """One launch of the CUDA kernel over all NW windows -> (NW, WS, C) in
    xw's dtype. Counts the launch."""
    _check_inputs(xw, pw, kp, layer)
    lib = LIB.load()
    weights = packed_weights(layer, xw.dtype)
    out = torch.empty_like(xw)
    nw = xw.shape[0]
    ff = layer.linear1.weight.shape[0]
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.window_layer_fwd(
            xw.data_ptr(), pw.data_ptr(), kp.data_ptr(),
            *[w.data_ptr() for w in weights], out.data_ptr(),
            nw, WS, C, N_HEADS, ff, int(xw.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"window_layer_fwd launch failed: cudaError {rc}")
    LAUNCHES["fused_window_layer"] += 1
    return out


def window_layer(xw: torch.Tensor, pw: torch.Tensor, kp: torch.Tensor,
                 layer) -> torch.Tensor:
    """The layer over every window (module docstring): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xw.device.type == "cpu":
        return window_layer_plain(xw, pw, kp, layer)
    return fused_window_layer(xw, pw, kp, layer)
