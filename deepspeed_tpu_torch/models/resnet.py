"""Small ResNet for CIFAR-class vision workloads.

Counterpart of ``deepspeed_tpu/models/resnet.py`` (the reference's
DeepSpeedExamples/cifar workload): a conv stem, residual stages, a global
average pool and a linear head, with GroupNorm (no batch statistics, so
each rank's micro-batch computes as the whole batch does). Images come as
the JAX model takes them, NHWC ``[B, 32, 32, 3]``; the convolutions run as
``F.conv2d`` on NCHW tensors (cuDNN on the card; the JAX package has no
Pallas kernel here). Padding is XLA's ``SAME`` rule, which for a
stride-2 3x3 convolution of an even size pads one row and column on the
high side only.

Parameters mirror the JAX tree (``params_tree``): ``stem.{w, gn.scale,
gn.bias}``, ``stages.{s}.{b}.{conv1, conv2}.{w, gn.*}`` (and ``proj.w`` where
the width changes), ``head.{w [C, classes], b}``. Convolution weights are
torch's OIHW where JAX's are HWIO: ``params_from_jax`` transposes them.
``forward(images, labels)`` returns the mean cross-entropy (what the
training engine calls), ``logits(images)`` the float32 logits.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .gpt2 import load_parameters


@dataclass
class ResNetConfig:
    num_classes: int = 10
    width: int = 32                             # stem channels
    stage_sizes: Tuple[int, ...] = (2, 2, 2)    # residual blocks per stage
    groups: int = 8                             # GroupNorm groups
    compute_dtype: Any = torch.float32


def _same_pad(size: int, k: int, stride: int):
    """(low, high) padding of XLA's ``SAME`` for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``SAME`` convolution of NCHW ``x`` by OIHW ``w`` (in ``x``'s dtype)."""
    k = w.shape[-1]
    ph, pw = _same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


class _GN(nn.Module):
    def __init__(self, ch, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, device, norm=True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        if norm:
            self.gn = _GN(cout, device)


class _Block(nn.Module):
    def __init__(self, cin, cout, device):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 3, device)
        self.conv2 = _Conv(cout, cout, 3, device)
        if cin != cout:
            self.proj = _Conv(cin, cout, 1, device, norm=False)


class _Head(nn.Module):
    def __init__(self, cin, classes, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, classes, device=device))
        self.b = nn.Parameter(torch.zeros(classes, device=device))


class ResNet(nn.Module):
    """``init(generator)`` fills the float32 parameters on ``device`` (the
    card unless the caller asks for ``"cpu"``)."""

    def __init__(self, config: ResNetConfig = None, device=None):
        super().__init__()
        c = self.config = config or ResNetConfig()
        dev = resolve_device(device)
        self.stem = _Conv(3, c.width, 3, dev)
        self.stages = nn.ModuleList()
        cin = c.width
        for si, blocks in enumerate(c.stage_sizes):
            cout = c.width * (2 ** si)
            stage = nn.ModuleList()
            for _ in range(blocks):
                stage.append(_Block(cin, cout, dev))
                cin = cout
            self.stages.append(stage)
        self.head = _Head(cin, c.num_classes, dev)

    @property
    def device(self):
        return self.head.w.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """He (fan-in) normal convolutions, unit GroupNorm, a 0.01-normal head.
        The numbers differ from ``jax.random``'s; tests that need equal
        weights carry the JAX ones over with ``params_from_jax``."""
        for name, p in self.named_parameters():
            if name.endswith(".w") and p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        self.head.w.normal_(0.0, 0.01, generator=generator)
        return dict(self.named_parameters())

    def load_parameters(self, params: Dict[str, torch.Tensor]) -> None:
        load_parameters(self, params)

    def params_tree(self):
        """The JAX parameter tree's structure over these parameters (the
        engine's checkpoint keys and leaf order)."""
        def conv(m):
            d = {"w": m.w}
            if hasattr(m, "gn"):
                d["gn"] = {"scale": m.gn.scale, "bias": m.gn.bias}
            return d

        stages = []
        for stage in self.stages:
            blocks = []
            for b in stage:
                d = {"conv1": conv(b.conv1), "conv2": conv(b.conv2)}
                if hasattr(b, "proj"):
                    d["proj"] = {"w": b.proj.w}
                blocks.append(d)
            stages.append(blocks)
        return {"stem": conv(self.stem), "stages": stages,
                "head": {"w": self.head.w, "b": self.head.b}}

    def param_count(self, params=None) -> int:
        from ..runtime.utils import param_count
        return param_count(params if params is not None else dict(self.named_parameters()))

    def _group_norm(self, x, gn):
        C = x.shape[1]
        g = min(self.config.groups, C)
        y = F.group_norm(x.float(), g, gn.scale.float(), gn.bias.float(), eps=1e-5)
        return y.to(x.dtype)

    def _block(self, x, b, stride):
        y = _conv(x, b.conv1.w, stride)
        y = F.relu(self._group_norm(y, b.conv1.gn))
        y = _conv(y, b.conv2.w)
        y = self._group_norm(y, b.conv2.gn)
        # stride 2 only at a stage boundary, where the width changes too
        shortcut = _conv(x, b.proj.w, stride) if hasattr(b, "proj") else x
        return F.relu(y + shortcut)

    def logits(self, images):
        """[B, H, W, 3] NHWC images -> [B, classes] float32 logits."""
        x = torch.as_tensor(images, device=self.device).to(self.config.compute_dtype)
        # NCHW, contiguous (torch 2.13's CPU backward of this net corrupts its
        # heap with channels-last inputs)
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self._group_norm(_conv(x, self.stem.w), self.stem.gn))
        for si, stage in enumerate(self.stages):
            for bi, b in enumerate(stage):
                x = self._block(x, b, 2 if (si > 0 and bi == 0) else 1)
        x = torch.mean(x, dim=(2, 3))                      # global average pool
        return torch.matmul(x, self.head.w.to(x.dtype)).float() + self.head.b.float()

    def forward(self, images, labels=None):
        logits = self.logits(images)
        if labels is None:
            return logits
        logp = F.log_softmax(logits, dim=-1)
        labels = torch.as_tensor(labels, device=logits.device).long()
        return -logp.gather(-1, labels[:, None])[:, 0].mean()


def params_from_jax(tree, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet parameter tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> a name -> float32 tensor dict in
    ``ResNet``'s naming, HWIO convolutions as OIHW, on ``device`` (the card
    unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = {}

    def put(name, leaf, conv=False):
        a = np.array(leaf, np.float32)
        if conv:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[name] = torch.from_numpy(a).to(dev)

    def conv(prefix, p):
        put(f"{prefix}.w", p["w"], conv=True)
        if "gn" in p:
            put(f"{prefix}.gn.scale", p["gn"]["scale"])
            put(f"{prefix}.gn.bias", p["gn"]["bias"])

    conv("stem", tree["stem"])
    for si, stage in enumerate(tree["stages"]):
        for bi, block in enumerate(stage):
            for k in ("conv1", "conv2", "proj"):
                if k in block:
                    conv(f"stages.{si}.{bi}.{k}", block[k])
    put("head.w", tree["head"]["w"])
    put("head.b", tree["head"]["b"])
    return out
