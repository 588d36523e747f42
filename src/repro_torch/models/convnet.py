"""Small classifiers for the paper-faithful Parle experiments.  Port of
``repro/models/convnet.py``.

``allcnn``: All-CNN-C-style (Springenberg et al., 2014) — conv stacks,
stride-2 downsampling convs, global average pooling, no FC layers.
``mlp``: a cheap 3-layer MLP (the quickstart's model).

The params keep the reference's layout — conv weights HWIO, dense
weights ``(d_in, d_out)`` — and the activations are NHWC at the
interface, so a reference param tree loads with no transposes; the
permutes to PyTorch's NCHW / OIHW happen inside the forward.  Convs pad
as XLA's ``padding="SAME"`` does: ``pad = max((ceil(n / s) - 1) s + k -
n, 0)`` split with the smaller half BEFORE, so a stride-2 3x3 conv on an
even size pads (0, 1), not the (1, 1) of ``conv2d(padding=1)``.  Init
draws from an explicit ``torch.Generator`` (not the reference's PRNG).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cross_entropy, dense_init


def _conv_init(generator: torch.Generator, shape, dtype=torch.float32):
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.normal_(generator=generator).div_(math.sqrt(fan_in)).to(dtype)


def _same_pad(size: int, k: int, stride: int):
    """(before, after) of XLA's SAME padding along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride=1):
    """x: (B, H, W, C) NHWC; w: (kh, kw, C_in, C_out) HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[1], kh, stride)
    left, right = _same_pad(x.shape[2], kw, stride)
    h = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    h = F.conv2d(h, w.permute(3, 2, 0, 1), stride=stride)
    return h.permute(0, 2, 3, 1) + b


def init_allcnn(generator: torch.Generator, num_classes=10, channels=(32, 64),
                in_ch=3, dtype=torch.float32):
    """Reduced All-CNN: [conv3-c1, conv3-c1-s2, conv3-c2, conv3-c2-s2,
    conv1-cls], on ``generator``'s device."""
    c1, c2 = channels
    dev = generator.device
    layer = lambda shape: {"w": _conv_init(generator, shape, dtype),
                           "b": torch.zeros(shape[-1], dtype=dtype,
                                            device=dev)}
    return {"c1": layer((3, 3, in_ch, c1)), "c2": layer((3, 3, c1, c1)),
            "c3": layer((3, 3, c1, c2)), "c4": layer((3, 3, c2, c2)),
            "cls": layer((1, 1, c2, num_classes))}


def allcnn_forward(params, x):
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    h = F.relu(_conv(x, params["c1"]["w"], params["c1"]["b"]))
    h = F.relu(_conv(h, params["c2"]["w"], params["c2"]["b"], stride=2))
    h = F.relu(_conv(h, params["c3"]["w"], params["c3"]["b"]))
    h = F.relu(_conv(h, params["c4"]["w"], params["c4"]["b"], stride=2))
    h = _conv(h, params["cls"]["w"], params["cls"]["b"])
    return h.mean(dim=(1, 2))


def init_mlp(generator: torch.Generator, in_dim=64, hidden=128,
             num_classes=10, dtype=torch.float32):
    dev = generator.device
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    return {"w1": dense_init(generator, (in_dim, hidden), dtype=dtype),
            "b1": zeros(hidden),
            "w2": dense_init(generator, (hidden, hidden), dtype=dtype),
            "b2": zeros(hidden),
            "w3": dense_init(generator, (hidden, num_classes), dtype=dtype),
            "b3": zeros(num_classes)}


def mlp_forward(params, x):
    h = F.relu(x @ params["w1"] + params["b1"])
    h = F.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def classification_loss(forward_fn):
    def loss(params, batch):
        logits = forward_fn(params, batch["x"])
        return cross_entropy(logits, batch["y"]), logits
    return loss


def error_rate(forward_fn, params, batch) -> torch.Tensor:
    logits = forward_fn(params, batch["x"])
    return (logits.argmax(-1) != batch["y"]).float().mean()
