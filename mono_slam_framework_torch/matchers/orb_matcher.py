"""ORB + brute-force-Hamming matcher plugin.

PyTorch counterpart of `mono_slam_framework_tpu/matchers/orb_matcher.py`
(the reference's ORB plugin, src/featurematcher.{h,cpp}): ORB extraction,
Hamming knnMatch(k=2) + Lowe ratio test with strict '<'
(featurematcher.cpp:32) and integer-truncated keypoint coordinates
(featurematcher.cpp:33-38). Per-frame features are cached by frame key;
the reference recomputes both sides every call and gets the same matches.
Extraction runs on the matcher's `device`; results come back as numpy.
"""

from __future__ import annotations

import collections

import torch

from mono_slam_framework_torch.matchers.base import FeatureMatcher, MatchFramesResult
from mono_slam_framework_torch.ops import hamming, orb


def _match(f1: orb.Features, f2: orb.Features, ratio: float):
    """Match f1 against one feature set f2 ([K2, ...]) or a stack of them
    ([N, K2, ...]); returns per-query arrays with f2's leading dims."""
    d = hamming.distance_matrix(f1.desc, f2.desc, f1.valid, f2.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    xy2 = torch.gather(f2.xy, -2, idx2[..., None].expand(*idx2.shape, 2))
    oc2 = torch.gather(f2.octave, -1, idx2)
    xy1 = f1.xy.expand_as(xy2)
    return (
        xy1.to(torch.int32),  # truncation toward zero, featurematcher.cpp:33-38
        xy2.to(torch.int32),
        xy1,
        xy2,
        f1.octave.expand_as(oc2),
        oc2,
        ok & f1.valid,
    )


class OrbFeatureMatcher(FeatureMatcher):
    def __init__(
        self,
        threshold: float = 0.6,
        max_features: int = 500,
        fast_threshold: float = 20.0,
        cache_size: int = 512,
        subpixel: bool = True,
        device: torch.device | str = "cpu",
    ):
        """`subpixel=True` carries the refined float coordinates as
        measurements alongside the integer contract."""
        self.threshold = float(threshold)
        self.subpixel = bool(subpixel)
        self.max_features = int(max_features)
        self.fast_threshold = float(fast_threshold)
        self.cache_size = int(cache_size)
        self.device = torch.device(device)
        self._cache: collections.OrderedDict[object, orb.Features] = (
            collections.OrderedDict()
        )

    # -- feature extraction with per-image LRU caching ---------------------
    def features_for(self, frame) -> orb.Features:
        # frames expose `matcher_key` (unique per distinct image); bare
        # stand-ins fall back to object identity
        fid = getattr(frame, "matcher_key", None)
        if fid is None:
            fid = id(frame)
        feats = self._cache.get(fid)
        if feats is None:
            img = torch.as_tensor(frame.image, dtype=torch.float32, device=self.device)
            feats = orb.extract(img, self.max_features, self.fast_threshold)
            self._cache[fid] = feats
            if len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)  # evict LRU; recomputable
        else:
            self._cache.move_to_end(fid)
        return feats

    def drop_frame_cache(self, frame_id=None) -> None:
        if frame_id is None:
            self._cache.clear()
        else:
            self._cache.pop(frame_id, None)

    def _result(self, frame1, frame2, arrays):
        xy1, xy2, xy1f, xy2f, oc1, oc2, ok = arrays
        return MatchFramesResult(
            frame1=frame1,
            frame2=frame2,
            keypoints1=xy1[ok],
            keypoints2=xy2[ok],
            keypoints1_f=xy1f[ok] if self.subpixel else None,
            keypoints2_f=xy2f[ok] if self.subpixel else None,
            octaves1=oc1[ok],
            octaves2=oc2[ok],
        )

    # -- FeatureMatcher interface ------------------------------------------
    def match_frames(self, frame1, frame2) -> MatchFramesResult:
        out = _match(self.features_for(frame1), self.features_for(frame2), self.threshold)
        return self._result(frame1, frame2, [t.cpu().numpy() for t in out])

    def match_against_many(self, frame, others):
        """Match one frame against several in one batched call."""
        if not others:
            return []
        f1 = self.features_for(frame)
        stacked = orb.Features(
            *(torch.stack(xs) for xs in zip(*(self.features_for(o) for o in others)))
        )
        out = [t.cpu().numpy() for t in _match(f1, stacked, self.threshold)]
        return [
            self._result(frame, o, [a[i] for a in out])
            for i, o in enumerate(others)
        ]

    def set_threshold(self, value: float) -> None:
        self.threshold = float(value)
