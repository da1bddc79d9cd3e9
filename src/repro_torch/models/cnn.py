"""VGG-16 and ResNet-18/50-style classifiers, the paper's own workloads
(mirrors ``repro/models/cnn.py``).

Layouts are the reference's: activations NHWC (B, H, W, C), conv weights
OIHW (A, C, kh, kw), the classifier head (num_classes, features) applied
transposed. A conv weight may be a ``PackedTensor``: a stride-1 pattern-
packed 3x3 conv then runs the ``pattern_conv`` kernel with its bias and
activation fused; any other conv runs ``F.conv2d`` (handed a channels-last
NCHW view of the NHWC tensor) with the same epilogue in fp32.

Both models implement the reference's ``SequentialAdapter`` protocol
(``embed``, ``layer_params``, ``with_layer_params``, ``apply_layer``,
``synthetic_batch``): each conv is one layer f_n. Weights are drawn from a
``torch.Generator`` in ``param_dtype`` on ``device``, which is the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.synthetic import synthetic_images
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import _dense_epilogue, dtype_of
from repro_torch.sparse.packed import PackedTensor
from repro_torch.sparse.registry import SCHEMES, dispatch_conv


def conv_init(gen: torch.Generator, out_ch: int, in_ch: int, kh: int = 3,
              kw: int = 3, *, dtype=torch.float32, device=None
              ) -> torch.Tensor:
    """He-scaled truncated-normal (+-2 sigma) init, (out, in, kh, kw)."""
    w = torch.empty((out_ch, in_ch, kh, kw), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * math.sqrt(2.0 / (in_ch * kh * kw))).to(dtype)


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high): the odd pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of x (B, H, W, C) with w (A, C, kh, kw) -> (B, H', W', A),
    in the common dtype of x and w."""
    ph = _same_pad(x.shape[1], w.shape[2], stride)
    pw = _same_pad(x.shape[2], w.shape[3], stride)
    xn = x.permute(0, 3, 1, 2)                  # NCHW view, channels last
    if xn.device.type == "cpu":
        # the CPU backend's weight gradient of a strided 1x1 conv on a
        # channels-last input of few channels aborts the process (torch
        # 2.13); a contiguous input takes another kernel
        xn = xn.contiguous()
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xn, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xn, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_apply(x: torch.Tensor, w, stride: int = 1,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Packed-aware conv, the CNN analogue of ``layers.dense_apply``.

    A pattern-packed weight at stride 1 runs the ``pattern_conv`` kernel
    with the (bias, activation) epilogue fused; any other packed leaf is
    rebuilt dense; raw weights take ``F.conv2d`` and the same epilogue in
    fp32 on the rounded product.
    """
    if isinstance(w, PackedTensor):
        handler = SCHEMES[w.scheme]     # unknown scheme: fail, never misread
        if handler.conv is not None and stride == 1:
            return dispatch_conv(x, w, bias=bias, activation=activation)
        w = handler.to_dense(w)
    return _dense_epilogue(conv2d(x, w, stride), bias, activation)


def _as_dense(w):
    """Dense view of a possibly-packed weight (for the transposed head)."""
    if isinstance(w, PackedTensor):
        return SCHEMES[w.scheme].to_dense(w)
    return w


def _max_pool2(y: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of NHWC y."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(
        0, 2, 3, 1).contiguous()


class _CNN:
    """What VGG and ResNet share: device, dtype, the adapter protocol."""

    image_hwc: Tuple[int, int, int]
    param_dtype: str

    # provenance tag: the pruner's synthetic batches are Uniform[0,255] pixels
    synthetic_kind = "uniform_pixels"

    def _setup(self, device: DeviceLike) -> None:
        self.device = resolve_device(device)
        self.dtype = dtype_of(self.param_dtype)

    def synthetic_batch(self, gen: torch.Generator,
                        batch_size: int) -> torch.Tensor:
        return synthetic_images(gen, batch_size, self.image_hwc,
                                device=self.device)

    def layer_params(self, params, n: int):
        return params["layers"][n]

    def with_layer_params(self, params, n: int, lp):
        layers = list(params["layers"])
        layers[n] = lp
        return {**params, "layers": layers}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        f = self.features(params, x)
        return f @ _as_dense(params["head"]["w"]).T + params["head"]["bias"]

    def _head(self, gen: torch.Generator, feat: int) -> Dict[str, Any]:
        w = torch.randn((self.num_classes, feat), generator=gen,
                        dtype=torch.float32, device=self.device)
        return {"w": (w * math.sqrt(1.0 / feat)).to(self.dtype),
                "bias": torch.zeros((self.num_classes,), dtype=self.dtype,
                                    device=self.device)}


@dataclasses.dataclass
class VGG(_CNN):
    """VGG-style plain CNN. ``plan``: list of (out_channels | 'M' maxpool)."""

    plan: Sequence
    num_classes: int = 10
    image_hwc: Tuple[int, int, int] = (32, 32, 3)
    param_dtype: str = "float32"
    device: DeviceLike = None

    # VGG-16 conv plan (13 conv layers)
    VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                  512, 512, 512, "M", 512, 512, 512, "M")

    def __post_init__(self):
        self._setup(self.device)
        self.conv_channels = [c for c in self.plan if c != "M"]
        self.num_layers = len(self.conv_channels)

    def _feature_dim(self) -> int:
        # pools stop once a spatial dim is 1 (small-image variants)
        h, w = self.image_hwc[0], self.image_hwc[1]
        for c in self.plan:
            if c == "M":
                h = h // 2 if h >= 2 else h
                w = w // 2 if w >= 2 else w
        return h * w * self.conv_channels[-1]

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """'/'-path -> shape of every parameter ``init`` creates."""
        shapes = {}
        in_ch = self.image_hwc[2]
        for i, ch in enumerate(self.conv_channels):
            shapes[f"layers/{i}/w"] = (ch, in_ch, 3, 3)
            shapes[f"layers/{i}/bias"] = (ch,)
            in_ch = ch
        shapes["head/w"] = (self.num_classes, self._feature_dim())
        shapes["head/bias"] = (self.num_classes,)
        return shapes

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn from ``gen`` (a generator on this device)."""
        layers = []
        in_ch = self.image_hwc[2]
        for ch in self.conv_channels:
            layers.append({
                "w": conv_init(gen, ch, in_ch, dtype=self.dtype,
                               device=self.device),
                "bias": torch.zeros((ch,), dtype=self.dtype,
                                    device=self.device)})
            in_ch = ch
        return {"layers": layers, "head": self._head(gen, self._feature_dim())}

    def embed(self, params, batch: torch.Tensor) -> torch.Tensor:
        return batch.to(self.dtype)

    def apply_layer(self, n: int, lp, x: torch.Tensor) -> torch.Tensor:
        """conv -> bias -> relu fused epilogue (-> the plan's max pools)."""
        y = conv_apply(x, lp["w"], bias=lp["bias"], activation="relu")
        conv_seen = -1
        for c in self.plan:
            if c != "M":
                conv_seen += 1
            elif conv_seen == n and y.shape[1] >= 2 and y.shape[2] >= 2:
                y = _max_pool2(y)
        return y

    def features(self, params, x: torch.Tensor) -> torch.Tensor:
        x = self.embed(params, x)
        for n in range(self.num_layers):
            x = self.apply_layer(n, params["layers"][n], x)
        return x.reshape(x.shape[0], -1)          # (H, W, C) order


def vgg16(num_classes: int = 10, width_mult: float = 1.0,
          image_hwc=(32, 32, 3), *, param_dtype: str = "float32",
          device: DeviceLike = None) -> VGG:
    plan = tuple(c if c == "M" else max(8, int(c * width_mult))
                 for c in VGG.VGG16_PLAN)
    return VGG(plan=plan, num_classes=num_classes, image_hwc=image_hwc,
               param_dtype=param_dtype, device=device)


@dataclasses.dataclass
class ResNet(_CNN):
    """ResNet-18/50-style CNN with basic blocks (CIFAR stem).

    Each basic block gives the pruner its two convs as separate layers;
    the residual add (and its 1x1 projection) happens in ``apply_layer``
    of the second conv, followed by the ReLU.
    """

    stage_channels: Sequence[int] = (64, 128, 256, 512)
    blocks_per_stage: Sequence[int] = (2, 2, 2, 2)     # resnet-18
    num_classes: int = 10
    image_hwc: Tuple[int, int, int] = (32, 32, 3)
    param_dtype: str = "float32"
    device: DeviceLike = None

    def __post_init__(self):
        self._setup(self.device)
        self.layer_plan: List[dict] = [
            {"kind": "stem", "out": self.stage_channels[0], "stride": 1}]
        in_ch = self.stage_channels[0]
        for s, (ch, nb) in enumerate(zip(self.stage_channels,
                                         self.blocks_per_stage)):
            for b in range(nb):
                stride = 2 if (b == 0 and s > 0) else 1
                self.layer_plan.append(
                    {"kind": "conv1", "out": ch, "in": in_ch,
                     "stride": stride})
                self.layer_plan.append(
                    {"kind": "conv2", "out": ch, "in": ch, "stride": 1,
                     "proj": in_ch != ch or stride != 1, "block_in": in_ch})
                in_ch = ch
        self.num_layers = len(self.layer_plan)
        self.final_ch = in_ch

    def _conv_shapes(self, n: int, spec: dict) -> Dict[str, Tuple[int, ...]]:
        cin = self.image_hwc[2] if spec["kind"] == "stem" else spec["in"]
        shapes = {"w": (spec["out"], cin, 3, 3), "bias": (spec["out"],)}
        if spec.get("proj"):
            shapes["w_proj"] = (spec["out"], spec["block_in"], 1, 1)
        return shapes

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """'/'-path -> shape of every parameter ``init`` creates."""
        shapes = {}
        for n, spec in enumerate(self.layer_plan):
            for k, v in self._conv_shapes(n, spec).items():
                shapes[f"layers/{n}/{k}"] = v
        shapes["head/w"] = (self.num_classes, self.final_ch)
        shapes["head/bias"] = (self.num_classes,)
        return shapes

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn from ``gen`` (a generator on this device)."""
        layers = []
        for n, spec in enumerate(self.layer_plan):
            lp = {}
            for k, shape in self._conv_shapes(n, spec).items():
                if k == "bias":
                    lp[k] = torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)
                else:
                    lp[k] = conv_init(gen, *shape, dtype=self.dtype,
                                      device=self.device)
            layers.append(lp)
        return {"layers": layers, "head": self._head(gen, self.final_ch)}

    def embed(self, params, batch: torch.Tensor) -> Dict[str, Any]:
        # carry (activation, residual input) through the layer sequence
        return {"x": batch.to(self.dtype), "res": None}

    def apply_layer(self, n: int, lp, state):
        spec = self.layer_plan[n]
        x = state["x"]
        if spec["kind"] == "stem":
            y = conv_apply(x, lp["w"], 1, bias=lp["bias"], activation="relu")
            return {"x": y, "res": None}
        if spec["kind"] == "conv1":
            y = conv_apply(x, lp["w"], spec["stride"], bias=lp["bias"],
                           activation="relu")
            return {"x": y, "res": x}
        # conv2: the bias fuses into the conv; relu waits for the residual
        y = conv_apply(x, lp["w"], 1, bias=lp["bias"])
        res = state["res"]
        if spec.get("proj"):
            res = conv_apply(res, lp["w_proj"], self.layer_plan[n - 1]["stride"])
        return {"x": torch.relu(y + res), "res": None}

    def unpackable_leaf_paths(self) -> List[str]:
        """Leaves whose packed form cannot run packed here: the strided 3x3
        convs have no packed kernel, so ``PrunedArtifact.bind`` unpacks
        them once instead of inside every forward."""
        return [f"layers/{n}/w" for n, spec in enumerate(self.layer_plan)
                if spec.get("stride", 1) != 1]

    def features(self, params, x: torch.Tensor) -> torch.Tensor:
        state = self.embed(params, x)
        for n in range(self.num_layers):
            state = self.apply_layer(n, params["layers"][n], state)
        return state["x"].mean(dim=(1, 2))          # global average pool


def resnet18(num_classes: int = 10, width_mult: float = 1.0,
             image_hwc=(32, 32, 3), *, param_dtype: str = "float32",
             device: DeviceLike = None) -> ResNet:
    chans = tuple(max(8, int(c * width_mult)) for c in (64, 128, 256, 512))
    return ResNet(stage_channels=chans, blocks_per_stage=(2, 2, 2, 2),
                  num_classes=num_classes, image_hwc=image_hwc,
                  param_dtype=param_dtype, device=device)


def resnet50_basic(num_classes: int = 10, width_mult: float = 0.25,
                   image_hwc=(32, 32, 3), *, param_dtype: str = "float32",
                   device: DeviceLike = None) -> ResNet:
    """ResNet-50-depth variant with basic blocks (3, 4, 6, 3)."""
    chans = tuple(max(8, int(c * width_mult)) for c in (64, 128, 256, 512))
    return ResNet(stage_channels=chans, blocks_per_stage=(3, 4, 6, 3),
                  num_classes=num_classes, image_hwc=image_hwc,
                  param_dtype=param_dtype, device=device)
