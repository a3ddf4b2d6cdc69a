"""The LoFTR model calls' CUDA graphs (models/loftr_native.GraphCache).

On the CPU: the cache's policy as plain Python (a key eager on its first
call, captured on its second, replayed from its third; at most `cap` keys,
the least recently used evicted; a copied or moved model starts empty), and
both model functions eager there, counted as such, with no graph built and
the eager bodies' answers. On a card (marked `cuda`, skipped here): the
checks of chip_smoke's phase loftr_graphs, which also runs them on the H100
(`python3 chip_smoke.py`). This file imports no JAX; the JAX parity of the
CPU path stays in test_torch_loftr_model.py.
"""

import copy

import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch.models import loftr_native as pln
from torch_parity import require_cuda


def _actions(cache, keys):
    return [cache.lookup(k)[0] for k in keys]


@pytest.mark.parametrize("cap", [1, 2, 16])
def test_second_sight_captures_third_replays(cap):
    cache = pln.GraphCache(cap)
    assert _actions(cache, ["a", "a"]) == ["eager", "capture"]
    g = pln.Graph("graph-a", (), None)
    cache.store("a", g)
    assert cache.lookup("a") == ("replay", g)
    assert cache.lookup("a") == ("replay", g)
    assert cache.counts == {"replay": 2, "capture": 1, "eager": 1}
    assert len(cache) == 1 and cache.n_graphs() == 1


def test_eviction_holds_the_cap_and_keeps_the_recently_used():
    cache = pln.GraphCache(2)
    for k in "ab":
        cache.lookup(k)
        cache.lookup(k)
        cache.store(k, pln.Graph(k, (), None))
    assert cache.lookup("a")[0] == "replay"  # a is now the most recent
    assert cache.lookup("c")[0] == "eager"  # evicts b, the least recently used
    assert len(cache) == 2 and cache.n_graphs() == 1
    assert _actions(cache, ["a", "b", "c"]) == ["replay", "eager", "eager"]
    # growing one-off keys (a keyframe database) never capture and stay capped
    assert _actions(cache, [("db", n) for n in range(40)]) == ["eager"] * 40
    assert len(cache) == 2 and cache.n_graphs() == 0


def test_a_copied_or_moved_model_starts_without_graphs():
    model = pln.LoftrCoarse()
    model.graphs.lookup("k")
    model.graphs.lookup("k")
    model.graphs.store("k", pln.Graph("g", (), None))
    twin = copy.deepcopy(model)
    assert len(twin.graphs) == 0 and twin.graphs.cap == model.graphs.cap
    assert len(model.graphs) == 1
    model.to("cpu")  # any move: the graphs read the old parameters
    assert len(model.graphs) == 0


@pytest.fixture(scope="module")
def model_and_feats():
    model = pln.load_model(device="cpu")
    gen = torch.Generator().manual_seed(3)
    img = torch.rand((2, 1, 240, 320), generator=gen)
    with torch.no_grad():
        feats = pln._encode_eager(model, img)
    return model, img, feats


@pytest.mark.parametrize("fn", ["encode", "confidence_n1", "confidence_n3"])
def test_cpu_calls_stay_eager(model_and_feats, fn):
    model, img, feats = model_and_feats
    f0, f1 = feats[:1], feats[1:]
    public, body, args = {
        "encode": (pln.encode, pln._encode_eager, (img[:1],)),
        "confidence_n1": (pln.confidence_from_features, pln._confidence_eager, (f0, f1)),
        "confidence_n3": (pln.confidence_from_features, pln._confidence_eager,
                          (f0.expand(3, -1, -1), torch.cat([f1, f0, f1]))),
    }[fn]
    before = dict(model.graphs.counts)
    with torch.no_grad():
        want = body(model, *args)
    got = [public(model, *args) for _ in range(3)]
    assert {k: v - before[k] for k, v in model.graphs.counts.items()} == {
        "replay": 0, "capture": 0, "eager": 3}
    assert len(model.graphs) == 0 and model.graphs.pool is None and not model.graphs.streams
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["parity", "outputs_survive", "policy", "hooks"])
def test_card_graphs(part):
    require_cuda()
    import chip_smoke

    getattr(chip_smoke, f"loftr_graph_{part}")(torch.device("cuda"))
