"""The LoFTR coarse matcher in PyTorch: the framework's DNN model.

PyTorch counterpart of `mono_slam_framework_tpu/models/loftr_native.py`,
on the same weights (`models/weights/loftr_teacher.npz`, a byte-identical
copy of the JAX package's; `convert.loftr_params` turns its arrays into
`LoftrCoarse`'s state).

Architecture (as the JAX forward decodes it from the exported graph):

* backbone: conv7x7/2 then 4 residual stages (1->8->8 /2, ->16 /4, ->32 /8,
  ->32 /16) and a bias-free 1x1 outconv -> [B, C=32] coarse features on a
  /16 grid (30x40 for the native 480x640 input -> L=1200 tokens); the /4
  layer2 activation is the `fine` map of `fine_refine`.
* positional encoding: interleaved sine table, frequency exp(-2k) for
  channel group k, positions 1-indexed.
* coarse transformer: 4 encoder layers applied ['self','cross','self',
  'cross'] with *sequential* cross semantics: feat0 updates first, feat1
  attends to the updated feat0. Single-head linear attention with elu+1
  feature maps, V pre-scaled by 1/L and the message rescaled by L, eps 1e-6;
  merge -> LayerNorm(eps 1e-7) -> MLP(2C->2C->C, bias-free) on
  concat(x, message) -> LayerNorm -> residual.
* head: features /sqrt(C), similarity /0.1 temperature, dual softmax.

`encode` is per image and cacheable; `confidence_from_features` is the
pairwise transformer + head, batched over a leading axis, so one call
matches a query against a stack of stored keyframe features.

Precision, per device. The JAX package computes the convolutions, the
attention and MLP products, the similarity and the fine correlation under
`jax.default_matmul_precision("bfloat16")`: one bf16 pass with an f32
result on a TPU, while XLA on the CPU ignores the scope and stays f32. The
port makes the same choice per device: on a card those products take bf16
operands (cuDNN / cuBLAS then round their result to bf16 once, which a
TPU's f32-output pass does not), on the CPU they stay f32. Everything else
(biases, elu, softmax, LayerNorm) is f32 on both. TF32 stays off.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mono_slam_framework_torch import device as device_mod

C = 32  # coarse feature dim
ATTN_EPS = 1e-6
LN_EPS = 1e-7
TEMPERATURE = 0.1
FINE_C = 16  # channels of the /4 fine map

WEIGHTS_PATH = pathlib.Path(__file__).parent / "weights" / "loftr_teacher.npz"


def _lowp(t: torch.Tensor) -> torch.Tensor:
    """An operand of a learned-weight product: bf16 on a card, as it is."""
    return t.to(torch.bfloat16) if t.is_cuda else t


def _mm(a, b):
    """a @ b (batched as torch.matmul) with the per-device operand precision;
    the result is f32."""
    return torch.matmul(_lowp(a), _lowp(b)).to(torch.float32)


def _conv(x, w, b=None, stride=1, pad=None):
    if pad is None:
        pad = w.shape[2] // 2
    out = F.conv2d(_lowp(x), _lowp(w), stride=stride, padding=pad).to(torch.float32)
    if b is not None:
        out = out + b[None, :, None, None]
    return out


def _param(*shape):
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, bias=True, pad=None):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None
        self.stride = stride
        self.pad = pad

    def forward(self, x):
        return _conv(x, self.weight, self.bias, self.stride, self.pad)


class Block(nn.Module):
    """Residual basic block; the 1x1 `down` projection exists iff stride 2."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride)
        self.conv2 = Conv(cout, cout, 3)
        self.down = Conv(cin, cout, 1, stride, pad=0) if stride == 2 else None

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = self.conv2(y)
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + y)


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(1, 8, 7, 2)
        self.layer1 = nn.ModuleList([Block(8, 8), Block(8, 8)])
        self.layer2 = nn.ModuleList([Block(8, 16, 2), Block(16, 16)])
        self.layer3 = nn.ModuleList([Block(16, 32, 2), Block(32, 32)])
        self.layer4 = nn.ModuleList([Block(32, 32, 2), Block(32, 32)])
        self.outconv = Conv(32, C, 1, bias=False, pad=0)

    def forward(self, img):
        """[B,1,H,W] -> (coarse [B,C,H/16,W/16], fine [B,16,H/4,W/4])."""
        x = F.relu(self.conv1(img))
        for blk in (*self.layer1, *self.layer2):
            x = blk(x)
        fine = x
        for blk in (*self.layer3, *self.layer4):
            x = blk(x)
        return self.outconv(x), fine


class EncoderLayer(nn.Module):
    """Weights in the JAX layout: `x @ w` with w [in, out]."""

    def __init__(self):
        super().__init__()
        for name in ("wq", "wk", "wv", "merge"):
            setattr(self, name, _param(C, C))
        self.mlp0 = _param(2 * C, 2 * C)
        self.mlp1 = _param(2 * C, C)
        for name in ("norm1_w", "norm1_b", "norm2_w", "norm2_b"):
            setattr(self, name, _param(C))


LAYER_NAMES = ("self", "cross", "self", "cross")


class LoftrCoarse(nn.Module):
    """The coarse LoFTR model's parameters; the forward is the functions
    below (`encode`, `confidence_from_features`, ...)."""

    def __init__(self):
        super().__init__()
        self.backbone = Backbone()
        self.layers = nn.ModuleList([EncoderLayer() for _ in LAYER_NAMES])


def load_model(path=None, device=device_mod.DEFAULT) -> LoftrCoarse:
    """The model with the repo's weights (or those at `path`) on `device`."""
    from mono_slam_framework_torch import convert

    device = device_mod.resolve(device)
    with np.load(path or WEIGHTS_PATH) as z:
        state = convert.loftr_params({k: z[k] for k in z.files}, device)
    model = LoftrCoarse().to(device)
    model.load_state_dict(state)
    return model.eval()


def _posenc_np(h: int, w: int, c: int) -> np.ndarray:
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    f = np.exp(-2.0 * np.arange(c // 4, dtype=np.float32))[:, None, None]
    pe = np.zeros((c, h, w), np.float32)
    pe[0::4] = np.sin(x[None] * f)
    pe[1::4] = np.cos(x[None] * f)
    pe[2::4] = np.sin(y[None] * f)
    pe[3::4] = np.cos(y[None] * f)
    return pe


@functools.lru_cache(maxsize=None)
def _posenc_cached(h: int, w: int, c: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_posenc_np(h, w, c)).to(device)


def positional_encoding(h: int, w: int, c: int = C, device="cpu") -> torch.Tensor:
    """Interleaved sine table [c, h, w]; group-k frequency exp(-2k),
    1-indexed (the exported 480x640 table to f32 rounding)."""
    return _posenc_cached(h, w, c, torch.device(device))


def _flatten_with_posenc(fmap):
    b, c, h, w = fmap.shape
    fmap = fmap + positional_encoding(h, w, c, fmap.device)[None]
    return fmap.reshape(b, c, h * w).transpose(1, 2)


@torch.no_grad()
def encode(model: LoftrCoarse, img) -> torch.Tensor:
    """Backbone + positional encoding, flattened: [B,1,H,W] (in [0, 1]) ->
    [B, L, C], row-major over (y, x) (the matcher's cell decode,
    dnnfeaturematcher.cpp:75-100: x = cell % grid_w, y = cell // grid_w)."""
    return _flatten_with_posenc(model.backbone(img)[0])


@torch.no_grad()
def encode_with_fine(model: LoftrCoarse, img):
    """encode() + the /4 fine map: [B,1,H,W] -> ([B,L,C], [B,16,H/4,W/4])."""
    fmap, fine = model.backbone(img)
    return _flatten_with_posenc(fmap), fine


def _layernorm(x, w, b):
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc / torch.sqrt(var + LN_EPS)) * w + b


@torch.no_grad()
def encoder_layer(lp: EncoderLayer, x, source):
    """One LoFTR encoder layer (single-head linear attention), [B,L,C] each."""
    v_len = source.shape[1]
    q = F.elu(_mm(x, lp.wq)) + 1.0
    k = F.elu(_mm(source, lp.wk)) + 1.0
    v = _mm(source, lp.wv) / v_len
    kv = _mm(k.transpose(1, 2), v)  # [B,C,C]
    z = 1.0 / (_mm(q, torch.sum(k, dim=1)[..., None])[..., 0] + ATTN_EPS)  # [B,L]
    msg = _mm(q, kv) * z[..., None] * float(v_len)
    msg = _layernorm(_mm(msg, lp.merge), lp.norm1_w, lp.norm1_b)
    m = _mm(F.relu(_mm(torch.cat([x, msg], dim=-1), lp.mlp0)), lp.mlp1)
    return x + _layernorm(m, lp.norm2_w, lp.norm2_b)


@torch.no_grad()
def coarse_transformer(model: LoftrCoarse, f0, f1):
    """4x [self, cross] with sequential cross updates (the original LoFTR
    order: feat0 updates first, feat1 attends to the *updated* feat0)."""
    for lp, name in zip(model.layers, LAYER_NAMES):
        if name == "self":
            f0 = encoder_layer(lp, f0, f0)
            f1 = encoder_layer(lp, f1, f1)
        else:
            f0 = encoder_layer(lp, f0, f1)
            f1 = encoder_layer(lp, f1, f0)
    return f0, f1


@torch.no_grad()
def confidence_from_features(model: LoftrCoarse, f0, f1) -> torch.Tensor:
    """Pairwise transformer + dual-softmax head: [B,L,C] x2 -> [B,L,L]."""
    f0, f1 = coarse_transformer(model, f0, f1)
    scale = 1.0 / np.sqrt(float(C))
    sim = _mm(f0 * scale, (f1 * scale).transpose(1, 2)) / TEMPERATURE
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


@torch.no_grad()
def loftr_confidence(model: LoftrCoarse, img0, img1) -> torch.Tensor:
    """Full forward, [1,1,H,W] x2 -> [1,L,L] confidence; both images run the
    backbone as one batch of 2."""
    feats = encode(model, torch.cat([img0, img1], dim=0))
    return confidence_from_features(model, feats[0:1], feats[1:2])


@torch.no_grad()
def match_features_topk(model: LoftrCoarse, f0, f1, max_matches: int):
    """Pairwise match + flat top-k (exact) decode: (vals, flat_idx) [B,K]
    with flat_idx = cell0 * L + cell1 over the [L, L] confidence."""
    conf = confidence_from_features(model, f0, f1)
    b, l0, l1 = conf.shape
    vals, idx = torch.topk(conf.reshape(b, l0 * l1), max_matches, dim=1)
    return vals, idx


@torch.no_grad()
def match_one_against_many(model: LoftrCoarse, f_query, f_stack, max_matches: int):
    """One query's features [1,L,C] against a stack [N,L,C], one batched
    call: (vals [N,K], idx [N,K]). The reference scans its keyframe
    database serially (KeyFrameDatabase.cc:31, 63-70)."""
    n = f_stack.shape[0]
    return match_features_topk(model, f_query.expand(n, -1, -1), f_stack, max_matches)


@torch.no_grad()
def fine_refine(fine0, fine1, cell0, cell1, grid_w: int = 40, window: int = 5):
    """Training-free subpixel refinement of coarse cell matches.

    fine0 / fine1 [F,H4,W4] are the /4 features of images 0 and 1, cell0 /
    cell1 [K] flat cell ids (row-major /16 grid). Correlates the /4
    descriptor at each image-0 cell corner against a window x window /4
    neighbourhood around the image-1 cell corner and takes the correlation
    soft-argmax. Returns the image-1 offsets [K,2] in model pixels (add to
    the 16*cell corner decode); window 5 keeps them within +-8 px.
    """
    _, H4, W4 = fine0.shape
    r = window // 2
    cell0 = cell0.long()
    cell1 = cell1.long()
    y0 = (cell0 // grid_w) * 4
    x0 = (cell0 % grid_w) * 4
    y1 = (cell1 // grid_w) * 4
    x1 = (cell1 % grid_w) * 4

    d0 = fine0[:, y0.clamp(0, H4 - 1), x0.clamp(0, W4 - 1)].T  # [K,F]
    d0 = d0 / (torch.linalg.norm(d0, dim=-1, keepdim=True) + 1e-6)

    off = torch.arange(-r, r + 1, device=fine0.device)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    dy = dy.reshape(-1)
    dx = dx.reshape(-1)
    ys = (y1[:, None] + dy[None, :]).clamp(0, H4 - 1)  # [K,w*w]
    xs = (x1[:, None] + dx[None, :]).clamp(0, W4 - 1)
    patches = fine1[:, ys, xs].permute(1, 2, 0)  # [K,w*w,F]
    patches = patches / (torch.linalg.norm(patches, dim=-1, keepdim=True) + 1e-6)
    scores = _mm(patches, d0[..., None])[..., 0]  # [K,w*w]
    w_soft = torch.softmax(scores / 0.1, dim=-1)
    ox = torch.sum(w_soft * dx[None, :].to(torch.float32), dim=-1)
    oy = torch.sum(w_soft * dy[None, :].to(torch.float32), dim=-1)
    return torch.stack([ox, oy], dim=-1) * 4.0
