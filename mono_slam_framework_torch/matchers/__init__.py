from mono_slam_framework_torch.matchers.base import FeatureMatcher, MatchFramesResult
from mono_slam_framework_torch.matchers.orb_matcher import OrbFeatureMatcher

__all__ = ["FeatureMatcher", "LoftrFeatureMatcher", "MatchFramesResult", "OrbFeatureMatcher"]


def __getattr__(name):
    # lazy: the DNN matcher pulls in the LoFTR model module, which ORB-only
    # users should not pay for when they import the package
    if name == "LoftrFeatureMatcher":
        from mono_slam_framework_torch.matchers.loftr_matcher import LoftrFeatureMatcher

        return LoftrFeatureMatcher
    raise AttributeError(name)
