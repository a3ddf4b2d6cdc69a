"""Plain reference of the LoFTR coarse confidence, in f32, from the weights file.

Frozen copy of the forward in `mono_slam_framework_torch/models/loftr_native.py:
64-266` (backbone, positional encoding, the 4 encoder layers with
sequential cross order, dual-softmax head), of the weight names of
`convert.py:299-324` and of the input scaling of
`matchers/loftr_matcher.py:59-68` at the model's own 480x640 size. It reads
the weights from the `.npz` file the program is given, and works on the
images the benchmark fed; every product goes through `precision.matmul` or
`precision.round_operand`, so the control is this code one precision lower.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.precision import matmul, round_operand

C = 32
ATTN_EPS = 1e-6
LN_EPS = 1e-7
TEMPERATURE = 0.1
MODEL_H, MODEL_W = 480, 640
LAYER_NAMES = ("self", "cross", "self", "cross")
STAGES = ((1, 8, 8, 1), (2, 8, 16, 2), (3, 16, 32, 2), (4, 32, 32, 2))  # layer, cin, cout, stride


def load_weights(path, device) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32)).to(device)
                for k in z.files if not k.startswith("posenc")}


def _conv(x, w, b, stride, pad, mode):
    out = F.conv2d(round_operand(x, mode), round_operand(w, mode), stride=stride, padding=pad)
    return out if b is None else out + b[None, :, None, None]


def _block(p, pre, x, stride, mode):
    y = F.relu(_conv(x, p[f"{pre}/conv1/w"], p[f"{pre}/conv1/b"], stride, 1, mode))
    y = _conv(y, p[f"{pre}/conv2/w"], p[f"{pre}/conv2/b"], 1, 1, mode)
    if stride == 2:
        x = _conv(x, p[f"{pre}/down/w"], p[f"{pre}/down/b"], stride, 0, mode)
    return F.relu(x + y)


def backbone(p, img, mode):
    x = F.relu(_conv(img, p["backbone/conv1/w"], p["backbone/conv1/b"], 2, 3, mode))
    for layer, _, _, stride in STAGES:
        x = _block(p, f"backbone/layer{layer}/block0", x, stride, mode)
        x = _block(p, f"backbone/layer{layer}/block1", x, 1, mode)
    return _conv(x, p["backbone/outconv/w"], None, 1, 0, mode)


def positional_encoding(h, w, device):
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    f = torch.exp(-2.0 * torch.arange(C // 4, dtype=torch.float32, device=device))[:, None, None]
    pe = torch.zeros((C, h, w), device=device)
    pe[0::4] = torch.sin(x[None] * f)
    pe[1::4] = torch.cos(x[None] * f)
    pe[2::4] = torch.sin(y[None] * f)
    pe[3::4] = torch.cos(y[None] * f)
    return pe


def encode(p, img, mode):
    """[B, 1, 480, 640] in [0, 1] -> [B, L, C]."""
    fmap = backbone(p, img, mode)
    b, c, h, w = fmap.shape
    fmap = fmap + positional_encoding(h, w, img.device)[None]
    return fmap.reshape(b, c, h * w).transpose(1, 2)


def _layernorm(x, w, b):
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc / torch.sqrt(var + LN_EPS)) * w + b


def _layer(p, i, x, source, mode):
    g = lambda n: p[f"coarse/{i}/{n}"]  # noqa: E731
    v_len = source.shape[1]
    q = F.elu(matmul(x, g("wq"), mode)) + 1.0
    k = F.elu(matmul(source, g("wk"), mode)) + 1.0
    v = matmul(source, g("wv"), mode) / v_len
    kv = matmul(k.transpose(1, 2), v, mode)
    z = 1.0 / (matmul(q, torch.sum(k, dim=1)[..., None], mode)[..., 0] + ATTN_EPS)
    msg = matmul(q, kv, mode) * z[..., None] * float(v_len)
    msg = _layernorm(matmul(msg, g("merge"), mode), g("norm1_w"), g("norm1_b"))
    m = matmul(F.relu(matmul(torch.cat([x, msg], dim=-1), g("mlp0"), mode)), g("mlp1"), mode)
    return x + _layernorm(m, g("norm2_w"), g("norm2_b"))


def confidence(p, img0, img1, mode: str = "f32"):
    """Coarse confidence [L, L] of two [480, 640] images with pixel values
    0-255: row i is image 0's cell i, column j image 1's cell j."""
    x = torch.stack([img0, img1])[:, None] / 255.0
    f = encode(p, x, mode)
    f0, f1 = f[0:1], f[1:2]
    for i, name in enumerate(LAYER_NAMES):
        if name == "self":
            f0, f1 = _layer(p, i, f0, f0, mode), _layer(p, i, f1, f1, mode)
        else:
            f0 = _layer(p, i, f0, f1, mode)
            f1 = _layer(p, i, f1, f0, mode)
    scale = 1.0 / np.sqrt(float(C))
    sim = matmul(f0 * scale, (f1 * scale).transpose(1, 2), mode) / TEMPERATURE
    return (torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2))[0]
