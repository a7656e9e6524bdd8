"""The paper's analysis programs: VGG-16 [1] and ZF [2] in torch.

The paper runs Faster R-CNN with VGG-16 / ZF backbones to detect objects in
640x480 MJPEG frames.  Both nets here are the backbone's conv stack at the
published channel widths plus the detection head (fc6/fc7 and the class
and box outputs); the region-proposal machinery beyond the shared conv
trunk is folded into the head, since the resource manager observes
utilization, never detections.

These are the programs the manager "test runs" (paper §3.1.1): on the CPU
the profiler measures their real wall-clock; for accelerators calibration
derives occupancy from their analytic FLOP and byte counts.

The function is the reference's (`repro/models/analysis_programs.py`),
computed in NCHW with OIHW conv weights:

- convs pad as XLA's ``"SAME"`` does, the extra row and column at the end
  (ZF's stride-2 convs pad asymmetrically, which ``F.conv2d``'s
  ``padding=`` cannot express);
- the resizes are antialiased bilinear, as ``jax.image.resize(...,
  "linear")`` is when it downsamples;
- the trunk's output is flattened in (h, w, c) order before fc6, so fc
  weights are (d_in, d_out) matrices in the reference's row order.

Parameters are dicts of tensors (``init_*`` / ``*_forward`` pairs, as in
the reference), drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.streams import FrameSize
from ..device import resolve_device

__all__ = [
    "init_vgg16",
    "vgg16_forward",
    "init_zf",
    "zf_forward",
    "make_frame",
    "program_flops",
    "program_params",
    "PROGRAMS",
]

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]
# ZF-net: 5 conv layers (96, 256, 384, 384, 256) + pools.
_ZF_CFG = [(96, 7, 2), "M", (256, 5, 2), "M", (384, 3, 1), (384, 3, 1), (256, 3, 1), "M"]
#: The detection head's input size: the trunk's output is (7, 7, channels).
_HEAD_HW = 7


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``relu(conv(x, w) + b)`` with SAME padding; x (N, C, H, W), w OIHW."""
    k_h, k_w = w.shape[2:]
    top, bottom = same_pads(x.shape[2], k_h, stride)
    left, right = same_pads(x.shape[3], k_w, stride)
    x = F.pad(x, (left, right, top, bottom))
    return torch.relu(F.conv2d(x, w, b, stride=stride))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride 2, VALID (the reference's ``reduce_window``)."""
    return F.max_pool2d(x, 2, 2)


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, h, w), ``jax.image.resize(..., "linear")``."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def _preprocess(frame, size: int, device: torch.device) -> torch.Tensor:
    """(H, W, 3) frame -> (1, 3, size, size) normalized float32."""
    x = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.asarray(frame))
    x = x.to(device=device, dtype=torch.float32) / 255.0
    return _resize(x.permute(2, 0, 1)[None], size, size)


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Flatten (h, w, c) as the reference's NHWC does, then the fc stack."""
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    fcs = params["fc"]
    for i, p in enumerate(fcs):
        x = x @ p["w"] + p["b"]
        if i < len(fcs) - 1:
            x = torch.relu(x)
    return x


def _init_head(generator: torch.Generator, fc_in: int, num_classes: int) -> list[dict]:
    # Detection head (fc6/fc7 + cls/box): fc_in -> 4096 -> 4096 -> out.
    shapes = ((fc_in, 4096, 0.005), (4096, 4096, 0.01), (4096, num_classes * 5, 0.01))
    return [
        {"w": torch.randn(d_in, d_out, generator=generator) * scale,
         "b": torch.zeros(d_out)}
        for d_in, d_out, scale in shapes
    ]


def _to(params: dict, device: torch.device) -> dict:
    return {
        part: [{k: v.to(device) for k, v in p.items()} for p in layers]
        for part, layers in params.items()
    }


def init_vgg16(generator: torch.Generator, *, num_classes: int = 21,
               device: "str | torch.device | None" = None) -> dict:
    """21 classes = PASCAL VOC (the paper detects persons, cars, buses...).

    Drawn from ``generator`` (on its device), then moved to ``device``
    (default: the card)."""
    dev = resolve_device(device)
    params, cin = {"convs": []}, 3
    for spec in _VGG_CFG:
        if spec == "M":
            continue
        w = torch.randn(spec, cin, 3, 3, generator=generator) * np.sqrt(2.0 / (9 * cin))
        params["convs"].append({"w": w, "b": torch.zeros(spec)})
        cin = spec
    params["fc"] = _init_head(generator, 512 * _HEAD_HW * _HEAD_HW, num_classes)
    return _to(params, dev)


def vgg16_forward(params: dict, frame) -> torch.Tensor:
    """frame: (H, W, 3) uint8/float -> (1, num_classes * 5) detection logits,
    on the device of ``params``."""
    x = _preprocess(frame, 224, params["fc"][0]["w"].device)
    ci = 0
    for spec in _VGG_CFG:
        if spec == "M":
            x = _maxpool(x)
        else:
            p = params["convs"][ci]
            x = _conv(x, p["w"], p["b"])
            ci += 1
    return _head(params, x)


def init_zf(generator: torch.Generator, *, num_classes: int = 21,
            device: "str | torch.device | None" = None) -> dict:
    """ZF's parameters, drawn and placed as `init_vgg16`'s."""
    dev = resolve_device(device)
    params, cin = {"convs": []}, 3
    for spec in _ZF_CFG:
        if spec == "M":
            continue
        ch, k, _s = spec
        w = torch.randn(ch, cin, k, k, generator=generator) * np.sqrt(2.0 / (k * k * cin))
        params["convs"].append({"w": w, "b": torch.zeros(ch)})
        cin = ch
    params["fc"] = _init_head(generator, 256 * _HEAD_HW * _HEAD_HW, num_classes)
    return _to(params, dev)


def zf_forward(params: dict, frame) -> torch.Tensor:
    x = _preprocess(frame, 224, params["fc"][0]["w"].device)
    ci = 0
    for spec in _ZF_CFG:
        if spec == "M":
            x = _maxpool(x)
        else:
            _ch, _k, s = spec
            p = params["convs"][ci]
            x = _conv(x, p["w"], p["b"], stride=s)
            ci += 1
    # Global-pad/crop to 7x7 for the head (the identity at 224 input).
    x = _resize(x, _HEAD_HW, _HEAD_HW)
    return _head(params, x)


def make_frame(frame_size: FrameSize) -> np.ndarray:
    """Synthetic camera frame (the data pipeline's test pattern)."""
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, (frame_size.height, frame_size.width, 3), np.uint8)


def program_flops(program_id: str, frame_size: FrameSize) -> float:
    """Analytic FLOPs per frame (for accelerator-side derived profiles)."""
    # Convs resized to 224x224 regardless of camera frame size; the resize
    # itself is O(pixels) and negligible.
    if program_id == "vgg16":
        return 2 * 15.3e9 + 2 * (512 * 49 * 4096 + 4096 * 4096 + 4096 * 105)
    if program_id == "zf":
        return 2 * 1.1e9 + 2 * (256 * 49 * 4096 + 4096 * 4096 + 4096 * 105)
    raise KeyError(program_id)


def program_params(program_id: str, num_classes: int = 21) -> float:
    """Analytic parameter count, from the same layer configs as the nets.

    Used by the calibration layer for memory footprints and weight-traffic
    byte estimates without instantiating the parameters.
    """
    if program_id == "vgg16":
        convs, cin, n = _VGG_CFG, 3, 0.0
        for spec in convs:
            if spec == "M":
                continue
            n += 3 * 3 * cin * spec + spec
            cin = spec
        fc_in = 512 * 7 * 7
    elif program_id == "zf":
        cin, n = 3, 0.0
        for spec in _ZF_CFG:
            if spec == "M":
                continue
            ch, k, _s = spec
            n += k * k * cin * ch + ch
            cin = ch
        fc_in = 256 * 7 * 7
    else:
        raise KeyError(program_id)
    for d_in, d_out in ((fc_in, 4096), (4096, 4096), (4096, num_classes * 5)):
        n += d_in * d_out + d_out
    return n


_NETS = {"vgg16": (init_vgg16, vgg16_forward), "zf": (init_zf, zf_forward)}


@functools.cache
def _initialised(program_id: str, device: torch.device) -> dict:
    """The program's parameters on ``device``, drawn from seed 0 (one set a
    (program, device) for the life of the process)."""
    init, _forward = _NETS[program_id]
    return init(torch.Generator().manual_seed(0), device=device)


def _runner(program_id: str):
    def run(frame, device: "str | torch.device | None" = None) -> torch.Tensor:
        """One frame through the program, on the card unless ``device``
        names another."""
        dev = resolve_device(device)
        return _NETS[program_id][1](_initialised(program_id, dev), frame)

    return run


PROGRAMS = {pid: _runner(pid) for pid in _NETS}
