"""LoFTR DNN matcher plugin.

PyTorch counterpart of `mono_slam_framework_tpu/matchers/loftr_matcher.py`
(the reference DNNFeatureMatcher, src/dnnfeaturematcher.{h,cpp}): run the
LoFTR coarse model on two grayscale frames, threshold the [1200,1200]
confidence matrix, and decode cell pairs to pixel coordinates at 16 px
resolution: row index = image-1 cell, col = image-2 cell, x = (cell % 40)*16,
y = (cell // 40)*16 (dnnfeaturematcher.cpp:75-100). Default threshold 0.1
(src/main.cpp:63). Selection keeps the top `max_matches` by confidence
(exact `torch.topk`) above the threshold.

The backbone runs once per frame and its [L, C] features are cached by
frame key, so a further match against the same frame pays only the
pairwise transformer; `match_against_many` runs that transformer over the
stacked keyframe features in one batched call, at the stack's own size.
Frames that are not 480x640 are resized as the JAX package's
`jax.image.resize(..., "bilinear")` does (triangle kernel, antialiased when
it shrinks): two products with separable weight matrices built on the host.
The model runs on the matcher's `device` (the card unless the caller asks
for the CPU); results come back as numpy.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.matchers.base import FeatureMatcher, MatchFramesResult
from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops.filters import resize_weights

MODEL_H, MODEL_W = 480, 640
CELL = 16  # model_resolution (src/main.cpp:64)
GRID_W = MODEL_W // CELL  # 40
GRID_H = MODEL_H // CELL  # 30
L = GRID_W * GRID_H  # 1200
FINE_CACHE = 8  # fine maps are ~1.2 MB each: a small LRU of its own


def _decode_cells(flat_idx: np.ndarray):
    """flat (cell1 * L + cell2) -> integer pixel (x, y) per image."""
    cell1 = flat_idx // L
    cell2 = flat_idx - cell1 * L
    xy1 = np.stack([(cell1 % GRID_W) * CELL, (cell1 // GRID_W) * CELL], -1)
    xy2 = np.stack([(cell2 % GRID_W) * CELL, (cell2 // GRID_W) * CELL], -1)
    return xy1.astype(np.int32), xy2.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _resize_mats(h: int, w: int, device: torch.device):
    return (torch.from_numpy(resize_weights(h, MODEL_H).T.copy()).to(device),
            torch.from_numpy(resize_weights(w, MODEL_W)).to(device))


def to_model(img: torch.Tensor) -> torch.Tensor:
    """[H,W] f32 image on any device -> [1,1,480,640] in [0, 1]: bilinear
    resize when the size differs (f32 products), then /255. N streams'
    images [N,H,W] -> [N,1,480,640]."""
    h, w = img.shape[-2:]
    if (h, w) != (MODEL_H, MODEL_W):
        wy, wx = _resize_mats(h, w, img.device)
        img = wy @ img @ wx
    return (img / 255.0).reshape(-1, 1, MODEL_H, MODEL_W)


class LoftrFeatureMatcher(FeatureMatcher):
    def __init__(
        self,
        model_path: str | None = None,
        threshold: float = 0.1,
        max_matches: int = 1024,
        cache_size: int = 512,
        fine: bool = False,
        device: torch.device | str = device_mod.DEFAULT,
    ):
        self.device = device_mod.resolve(device)
        self.model = loftr_native.load_model(model_path, self.device)
        self.threshold = float(threshold)
        self.max_matches = int(max_matches)
        self.cache_size = int(cache_size)
        # Optional training-free fine stage (loftr_native.fine_refine): the
        # reference model is coarse-only, 16 px cells; this sharpens
        # match_frames' float coordinates (keypoints*_f) by /4-feature
        # correlation. A quality extension beyond the reference, off by
        # default.
        self.fine = bool(fine)
        # frame key -> ([1, L, C] device features, (sx, sy) image/model scale)
        self._feat_cache: collections.OrderedDict = collections.OrderedDict()
        # frame key -> [16, H/4, W/4] fine map (match_frames only)
        self._fine_cache: collections.OrderedDict = collections.OrderedDict()

    def _frame_key(self, frame):
        # explicit None test: matcher_key 0 (first frame after reset) is falsy
        key = getattr(frame, "matcher_key", None)
        return id(frame) if key is None else key

    def _model_input(self, frame):
        img = torch.from_numpy(np.array(frame.image, np.float32))
        h, w = img.shape
        scale = (w / MODEL_W, h / MODEL_H)
        if self.device.type == "cuda":
            # pinned and non-blocking: the upload does not wait for queued work
            img = img.pin_memory().to(self.device, non_blocking=True)
        return to_model(img), scale

    def _features(self, frame):
        key = self._frame_key(frame)
        hit = self._feat_cache.get(key)
        if hit is not None:
            self._feat_cache.move_to_end(key)
            return hit
        x, scale = self._model_input(frame)
        feats = loftr_native.encode(self.model, x)
        self.seed_cache(frame, feats, scale)
        return feats, scale

    def seed_cache(self, frame, feats, scale) -> None:
        """Insert a frame's features encoded elsewhere (the fused LoFTR step),
        under the same LRU bound."""
        key = self._frame_key(frame)
        self._feat_cache[key] = (feats, scale)
        self._feat_cache.move_to_end(key)
        if len(self._feat_cache) > self.cache_size:
            self._feat_cache.popitem(last=False)  # evict LRU; recomputable

    def drop_frame_cache(self, frame_id=None) -> None:
        if frame_id is None:
            self._feat_cache.clear()
            self._fine_cache.clear()
        else:
            self._feat_cache.pop(frame_id, None)
            self._fine_cache.pop(frame_id, None)

    def _fine_map(self, frame):
        """[16, H/4, W/4] device fine features of a frame (small LRU)."""
        key = self._frame_key(frame)
        hit = self._fine_cache.get(key)
        if hit is not None:
            self._fine_cache.move_to_end(key)
            return hit
        x, _ = self._model_input(frame)
        fine = loftr_native.encode_with_fine(self.model, x)[1][0]
        self._fine_cache[key] = fine
        if len(self._fine_cache) > FINE_CACHE:
            self._fine_cache.popitem(last=False)
        return fine

    def _sigma_octave(self, scale) -> float:
        """Effective 'octave' encoding the matcher's measurement sigma.

        The optimizers weight every edge by InvSigma2 = 1.2^(-2*octave) and
        gate inliers at chi2 = err^2 * InvSigma2 < 5.991. A 16 px coarse cell
        has ~CELL/2 px quantization sigma (~CELL/8 with fine refinement);
        report the octave whose 1.2^octave equals that sigma, so that LoFTR
        matches are judged at their real precision instead of ORB's ~1 px.
        """
        s = (CELL / 8.0 if self.fine else CELL / 2.0) * float((scale[0] + scale[1]) * 0.5)
        return float(np.log(max(s, 1.0)) / np.log(1.2))

    def _decode_result(self, frame1, frame2, vals, idx, scale1, scale2):
        ok = vals > self.threshold
        xy1, xy2 = _decode_cells(idx[ok])
        kp1 = (xy1 * np.asarray(scale1, np.float32)).astype(np.int32)
        kp2 = (xy2 * np.asarray(scale2, np.float32)).astype(np.int32)
        n = kp1.shape[0]
        return MatchFramesResult(
            frame1=frame1,
            frame2=frame2,
            keypoints1=kp1,
            keypoints2=kp2,
            octaves1=np.full(n, self._sigma_octave(scale1), np.float32),
            octaves2=np.full(n, self._sigma_octave(scale2), np.float32),
        )

    def match_frames(self, frame1, frame2) -> MatchFramesResult:
        f0, scale1 = self._features(frame1)
        f1, scale2 = self._features(frame2)
        vals_d, idx_d = loftr_native.match_features_topk(self.model, f0, f1, self.max_matches)
        vals = vals_d[0].cpu().numpy()
        idx = idx_d[0].cpu().numpy()
        res = self._decode_result(frame1, frame2, vals, idx, scale1, scale2)
        if self.fine and res.num_matches:
            ok = vals > self.threshold
            cell1 = torch.as_tensor(idx[ok] // L, device=self.device)
            cell2 = torch.as_tensor(idx[ok] % L, device=self.device)
            fm1 = self._fine_map(frame1)
            fm2 = self._fine_map(frame2)
            # refine BOTH images' coordinates, each against the other's /4
            # neighbourhood. The refined values ride ONLY in the float
            # measurements (keypoints*_f): the integer keypoints stay at the
            # coarse cell corners, so the exact-pixel association keys
            # (KeyPointMap, quirk B1) are the same for every match pair.
            for which, fma, fmb, ca, cb, scale, frame in (
                (2, fm1, fm2, cell1, cell2, scale2, frame2),
                (1, fm2, fm1, cell2, cell1, scale1, frame1),
            ):
                offs = loftr_native.fine_refine(fma, fmb, ca, cb, GRID_W).cpu().numpy()
                h, w = np.asarray(frame.image).shape
                kpf = (res.keypoints2 if which == 2 else res.keypoints1).astype(np.float32)
                kpf[:, 0] = np.clip(kpf[:, 0] + offs[:, 0] * float(scale[0]), 0, w - 1)
                kpf[:, 1] = np.clip(kpf[:, 1] + offs[:, 1] * float(scale[1]), 0, h - 1)
                if which == 2:
                    res.keypoints2_f = kpf
                else:
                    res.keypoints1_f = kpf
        return res

    def match_against_many(self, frame, others):
        """One batched call for a database scan (see the module docstring)."""
        if not others:
            return []
        fq, scale_q = self._features(frame)
        feats = [self._features(o) for o in others]
        f_stack = torch.cat([f for f, _ in feats], dim=0)
        vals, idx = loftr_native.match_one_against_many(
            self.model, fq, f_stack, self.max_matches
        )
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return [
            self._decode_result(frame, o, vals[i], idx[i], scale_q, feats[i][1])
            for i, o in enumerate(others)
        ]

    def set_threshold(self, value: float) -> None:
        self.threshold = float(value)
