"""ResNet-50/101 backbone with frozen batch-norm.

Counterpart of `trackformer_tpu/models/backbone.py`, written by hand in the
torchvision layout (the port does not depend on torchvision), so that
state-dict keys match the original checkpoints: `body.conv1`,
`body.layer1.0.conv2`, `body.layer2.0.downsample.0`, ... Convolutions run
on NCHW tensors; the NHWC images of a `FrameBatch` are permuted into a
channels-last NCHW view, which cuDNN takes as is.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..structures import FrameBatch

RESNET_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
BACKBONE_CHANNELS = [256, 512, 1024, 2048]


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine parameters, stored as the
    four torchvision buffers and folded into one multiply-add in float32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        b = self.bias.float() - self.running_mean.float() * k
        return (x * k.to(x.dtype)[None, :, None, None]
                + b.to(x.dtype)[None, :, None, None])


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1, expansion 4."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk returning the outputs of layer1..layer4."""

    def __init__(self, layers: Sequence[int], dilation: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for stage, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            dil = 1
            if stage == 3 and dilation:
                stride, dil = 1, 2
            blocks = []
            for i in range(n_blocks):
                blocks.append(Bottleneck(inplanes, width,
                                         stride if i == 0 else 1, dil,
                                         downsample=(i == 0)))
                inplanes = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            feats.append(x)
        return feats


def downsample_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-downsample a (B, H, W) bool pad mask to (th, tw)."""
    _, h, w = mask.shape
    th, tw = hw
    ys = torch.floor(torch.arange(th, device=mask.device) * (h / th)).long()
    xs = torch.floor(torch.arange(tw, device=mask.device) * (w / tw)).long()
    return mask[:, ys][:, :, xs]


class Backbone(nn.Module):
    """Trunk features (NCHW) at strides 4, 8, 16, 32 plus their pad masks."""

    def __init__(self, name: str = "resnet50", dilation: bool = False):
        super().__init__()
        self.body = ResNet(RESNET_LAYERS[name], dilation)

    def forward(self, batch: FrameBatch):
        dtype = self.body.conv1.weight.dtype
        x = batch.images.to(dtype).permute(0, 3, 1, 2)
        features = self.body(x)
        masks = [downsample_mask(batch.mask, f.shape[-2:]) for f in features]
        return features, masks
