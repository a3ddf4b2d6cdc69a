from mono_slam_framework_torch.matchers.base import FeatureMatcher, MatchFramesResult
from mono_slam_framework_torch.matchers.loftr_matcher import LoftrFeatureMatcher
from mono_slam_framework_torch.matchers.orb_matcher import OrbFeatureMatcher

__all__ = ["FeatureMatcher", "LoftrFeatureMatcher", "MatchFramesResult", "OrbFeatureMatcher"]
