"""ENet encoder for the multiview 2D features (counterpart of
``bridgeqa_tpu/models/enet.py``).

The reference feeds 328x256 frames through the pretrained ScanNet ENet
encoder and keeps its 128-channel maps at 1/8 resolution (41x32) as each
frame's features. Stages: the initial block (a 3x3/2 convolution beside a
2x2 max-pool, 16 channels), stage 1 (down to 64 channels and 4
bottlenecks), stages 2 and 3 (down to 128 and the dilated and asymmetric
bottleneck series). Input and output are channel-last, as the JAX module's:
(B, H, W, 3) -> (B, H/8, W/8, 128), the layout of the saved ``.npy`` files.

The submodules carry the flax names (``initial.conv``, ``b1_0.reduce``,
``b2_3.conv_a``, ``prelu_out.alpha``), so ``convert.load_jax_variables``
takes the JAX variables unchanged. The convolutions are ``F.conv2d`` (cuDNN
on the card), as the JAX package runs them in XLA, outside any Pallas
kernel. Inference-only, as the reference uses it: in eval mode BatchNorm
(eps 1e-3) normalises with the running statistics.

The JAX module's lines each trap sits on: the initial block pads (1, 1)
explicitly (``enet.py:41-43``); a ``down`` bottleneck's reduce is a 2x2
stride-2 VALID convolution with no bias and its main branch a max-pool with
the channels zero-padded (``:71-74``); ``asymmetric`` is (1, k) with no bias
then (k, 1) with a bias, both SAME (``:88-89``); ``dilated`` pads by the
dilation; the torch7 damping ``h * (1 - drop)`` applies in eval mode too
(``:101-102``). flax's SAME max-pool pads only an odd side, and H and W must
be multiples of 8 here, so no pool pads.
"""

import torch
import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.models.layers import BatchNorm, Conv, dropout

BN_EPS = 1e-3


class PReLU(nn.Module):
    """One slope per channel (``alpha``, 0.25 at init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.alpha.fill_(0.25)


def _max_pool(x):
    """2x2 stride-2 max-pool of (B, H, W, C), H and W even."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class InitialBlock(nn.Module):
    """3x3/2 convolution (13 filters) concatenated with a 2x2 max-pool of
    the input."""

    def __init__(self, in_chans: int = 3):
        super().__init__()
        # explicit (1, 1) padding: flax SAME at stride 2 would pad (0, 1)
        self.conv = Conv(in_chans, 16 - in_chans, (3, 3), stride=2, padding=(1, 1))
        self.bn = BatchNorm(16, eps=BN_EPS)
        self.prelu = PReLU(16)

    def forward(self, x):
        out = torch.cat([self.conv(x), _max_pool(x)], dim=-1)  # 16 channels
        return self.prelu(self.bn(out))


class Bottleneck(nn.Module):
    """ENet bottleneck: reduce -> core convolution -> 1x1 expand, added to
    the main branch. ``kind``: 'regular', 'down', 'dilated' or
    'asymmetric'."""

    def __init__(self, in_ch: int, out_ch: int, kind: str = "regular", dilation: int = 1,
                 asym_k: int = 5, proj_ratio: int = 4, drop: float = 0.1):
        super().__init__()
        if kind not in ("regular", "down", "dilated", "asymmetric"):
            raise ValueError(f"unknown bottleneck kind {kind!r}")
        self.in_ch, self.out_ch, self.kind, self.drop = in_ch, out_ch, kind, drop
        mid = out_ch // proj_ratio
        if kind == "down":
            self.reduce = Conv(in_ch, mid, (2, 2), stride=2, bias=False)
        else:
            self.reduce = Conv(in_ch, mid, (1, 1), bias=False)
        self.bn1 = BatchNorm(mid, eps=BN_EPS)
        self.prelu1 = PReLU(mid)
        if kind == "asymmetric":
            # (1, k) without a bias, then (k, 1) with one, both SAME
            self.conv_a = Conv(mid, mid, (1, asym_k), padding=(0, asym_k // 2), bias=False)
            self.conv_b = Conv(mid, mid, (asym_k, 1), padding=(asym_k // 2, 0))
        else:
            self.conv = Conv(mid, mid, (3, 3), padding=(dilation, dilation), dilation=dilation)
        self.bn2 = BatchNorm(mid, eps=BN_EPS)
        self.prelu2 = PReLU(mid)
        self.expand = Conv(mid, out_ch, (1, 1), bias=False)
        self.bn3 = BatchNorm(out_ch, eps=BN_EPS)
        self.prelu_out = PReLU(out_ch)

    def forward(self, x):
        if self.kind == "down":
            main = _max_pool(x)
            if self.in_ch < self.out_ch:  # zero-pad the channels
                main = F.pad(main, (0, self.out_ch - self.in_ch))
        else:
            main = x
        h = self.prelu1(self.bn1(self.reduce(x)))
        h = self.conv_b(self.conv_a(h)) if self.kind == "asymmetric" else self.conv(h)
        h = self.prelu2(self.bn2(h))
        h = self.bn3(self.expand(h))
        # the torch7 dropout: the branch is damped by (1 - p) in eval mode
        # too, which the pretrained weights expect
        h = dropout(h * (1.0 - self.drop), self.drop, self.training)
        return self.prelu_out(main + h)


# (kind, dilation) of the stage-2 and stage-3 series
_SERIES = [("regular", 1), ("dilated", 2), ("asymmetric", 1), ("dilated", 4),
           ("regular", 1), ("dilated", 8), ("asymmetric", 1), ("dilated", 16)]


class ENetEncoder(nn.Module):
    """The initial block and stages 1-3 -> (B, H/8, W/8, 128) feature maps."""

    def __init__(self, device: torch.device | str = "cuda"):
        """Built on ``device`` (the card unless the caller asks for the
        CPU), in eval mode."""
        super().__init__()
        with torch.device(device):
            self.initial = InitialBlock()
            self.add_module("b1_0", Bottleneck(16, 64, kind="down", drop=0.01))
            for i in range(1, 5):
                self.add_module(f"b1_{i}", Bottleneck(64, 64, drop=0.01))
            self.add_module("b2_0", Bottleneck(64, 128, kind="down"))
            for stage in (2, 3):
                start = 1 if stage == 2 else 0
                for i, (kind, dil) in enumerate(_SERIES, start=start):
                    self.add_module(f"b{stage}_{i}",
                                    Bottleneck(128, 128, kind=kind, dilation=dil))
        self.eval()

    def forward(self, x):
        """x (B, H, W, 3) with H and W multiples of 8."""
        if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(f"ENetEncoder takes (B, H, W, 3) with H and W multiples of 8, got "
                             f"{tuple(x.shape)}")
        for block in self.children():
            x = block(x)
        return x


class ENetClassifier(nn.Module):
    """1x1 classifier head over the encoder's features
    (``create_enet_for_3d``'s ``model_classifier``)."""

    def __init__(self, num_classes: int, in_chans: int = 128,
                 device: torch.device | str = "cuda"):
        super().__init__()
        with torch.device(device):
            self.classifier = Conv(in_chans, num_classes, (1, 1), bias=False)
        self.eval()

    def forward(self, feats):
        return self.classifier(feats)


def create_enet_for_3d(num_classes: int = 41, device: torch.device | str = "cuda"):
    """(encoder, classifier): the fixed feature stack and the 1x1 head, the
    reference's (model_fixed + model_trainable, model_classifier) split."""
    return ENetEncoder(device), ENetClassifier(num_classes, device=device)
