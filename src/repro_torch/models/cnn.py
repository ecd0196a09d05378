"""ResNet18 / VGG16 — the paper's §5.2 non-convex experiments (CIFAR-10).

The port of the JAX package's ``models/cnn.py``: functional conv nets on
dict/list parameter trees, BatchNorm-free (per-channel scales on the
residual branches), with a ``width`` knob for reduced-width variants of
the same topology.

The parameter layout is the JAX package's — HWIO conv weights, the same
tree and so the same sorted leaf order — so the per-leaf reducer rng, the
comm ledger's leaf paths and ``utils/convert.py::params_from_jax`` carry
over unchanged. Images arrive NHWC, as ``data.make_multiclass_images``
makes them; ``apply_*`` permute them to NCHW and the weights to OIHW for
``F.conv2d``.

Padding is XLA's ``"SAME"``: out = ceil(n / stride), and the total pad
(out − 1)·stride + k − n is split with the smaller half first. A stride-2
3×3 conv on an even input therefore pads (0, 1), not (1, 1); an
asymmetric pad goes through ``F.pad`` before the conv.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.simulate import resolve_device

_RESNET18_STAGES = ((2, 1), (2, 2), (2, 2), (2, 2))  # (blocks, first-stride)
_VGG16_PLAN = ((2, 1), (2, 2), (3, 4), (3, 8), (3, 8))  # (convs, width-mult)


def _normal(g, shape, std: float, device):
    return (torch.randn(shape, generator=g, dtype=torch.float32)
            * std).to(device)


def _conv_init(g, kh, kw, cin, cout, device):
    """He-normal HWIO conv weight."""
    return _normal(g, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)),
                   device)


def _same_pad(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """NCHW x, HWIO w -> NCHW, "SAME" padding as XLA computes it."""
    kh, kw = w.shape[0], w.shape[1]
    (ph0, ph1), (pw0, pw1) = (_same_pad(x.shape[-2], kh, stride),
                              _same_pad(x.shape[-1], kw, stride))
    wt = w.permute(3, 2, 0, 1)
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, wt, stride=stride, padding=(ph0, pw0))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), wt, stride=stride)


def _nchw(x):
    """NHWC images -> contiguous NCHW. Contiguous, not the permuted
    (channels-last) view: torch 2.13's oneDNN CPU convolution backward
    faults on that view under ``torch.func.grad`` (a stride-2 conv at an
    even size with several threads)."""
    return x.permute(0, 3, 1, 2).contiguous()


def _chan(s):
    """A per-channel (C,) scale broadcast over NCHW."""
    return s[:, None, None]


# ---------------------------------------------------------------------------
# ResNet18
# ---------------------------------------------------------------------------

def init_resnet18(seed: int = 0, n_classes: int = 10, width: int = 64, *,
                  device=None):
    """(params, strides): He-initialized ResNet18 params from a seeded
    ``torch.Generator`` (the JAX package draws its own with
    ``jax.random``; carry those across with ``utils.convert.params_from_jax``
    to start both from one point), and the per-block strides, a static
    list kept out of the tree. ``device`` — None means CUDA, and the call
    raises when CUDA is absent."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    p = {"stem": _conv_init(g, 3, 3, 3, width, dev)}
    cin = width
    stages, strides = [], []
    for si, (blocks, stride) in enumerate(_RESNET18_STAGES):
        cout = width * (2 ** si)
        blist, slist = [], []
        for b in range(blocks):
            s = stride if b == 0 else 1
            blk = {"conv1": _conv_init(g, 3, 3, cin, cout, dev),
                   "conv2": _conv_init(g, 3, 3, cout, cout, dev),
                   "scale1": torch.ones((cout,), device=dev),
                   "scale2": torch.zeros((cout,), device=dev)}
            if s != 1 or cin != cout:
                blk["proj"] = _conv_init(g, 1, 1, cin, cout, dev)
            blist.append(blk)
            slist.append(s)
            cin = cout
        stages.append(blist)
        strides.append(slist)
    p["stages"] = stages
    p["head_w"] = _normal(g, (cin, n_classes), 0.01, dev)
    p["head_b"] = torch.zeros((n_classes,), device=dev)
    return p, strides


def apply_resnet18(params, strides, x):
    """x: (B, H, W, 3) NHWC -> logits (B, n_classes)."""
    h = _conv(_nchw(x), params["stem"])
    for st, st_strides in zip(params["stages"], strides):
        for blk, s in zip(st, st_strides):
            inp = h
            h = torch.relu(_conv(inp, blk["conv1"], s) * _chan(blk["scale1"]))
            h = _conv(h, blk["conv2"]) * _chan(1.0 + blk["scale2"])
            sc = _conv(inp, blk["proj"], s) if "proj" in blk else inp
            h = torch.relu(h + sc)
    h = torch.mean(h, dim=(2, 3))
    return h @ params["head_w"] + params["head_b"]


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------

def init_vgg16(seed: int = 0, n_classes: int = 10, width: int = 64, *,
               device=None):
    """He-initialized VGG16 params from a seeded ``torch.Generator`` (see
    ``init_resnet18``). ``device`` — None means CUDA."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    p = {"stages": []}
    cin = 3
    for convs, mult in _VGG16_PLAN:
        cout = width * mult
        st = []
        for _ in range(convs):
            st.append({"conv": _conv_init(g, 3, 3, cin, cout, dev),
                       "scale": torch.ones((cout,), device=dev)})
            cin = cout
        p["stages"].append(st)
    p["fc1"] = _normal(g, (cin, 4 * width), 0.02, dev)
    p["fc2"] = _normal(g, (4 * width, n_classes), 0.02, dev)
    p["b1"] = torch.zeros((4 * width,), device=dev)
    p["b2"] = torch.zeros((n_classes,), device=dev)
    return p


def apply_vgg16(params, x):
    """x: (B, H, W, 3) NHWC -> logits (B, n_classes). Each stage ends in
    a 2×2 max pool of stride 2 without padding (XLA's "VALID")."""
    h = _nchw(x)
    for st in params["stages"]:
        for blk in st:
            h = torch.relu(_conv(h, blk["conv"]) * _chan(blk["scale"]))
        h = F.max_pool2d(h, 2, 2)
    h = torch.mean(h, dim=(2, 3))
    h = torch.relu(h @ params["fc1"] + params["b1"])
    return h @ params["fc2"] + params["b2"]


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy of integer ``labels`` (B,)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))
