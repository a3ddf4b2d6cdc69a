"""`loftr_graph_share` reads the fused LoFTR steps' model-call counters and
is silent where the program has none (a program without CUDA graphs)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from slam_bench import manifest

read = manifest.metric_reader("loftr_graph_share")


def test_silent_without_the_counters():
    assert read(SimpleNamespace(counters={"pipe.done_steady": 40})) is None


@pytest.mark.parametrize("replay,capture,eager,share", [(97, 1, 2, 97.0), (0, 0, 3, 0.0)])
def test_share_of_replays(replay, capture, eager, share):
    counters = {"pipe.loftr_graph_replay": replay, "pipe.loftr_graph_capture": capture,
                "pipe.loftr_eager": eager}
    assert read(SimpleNamespace(counters=counters)) == pytest.approx(share)
