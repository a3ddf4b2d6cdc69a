"""Port parity for the LoFTR coarse model (models/loftr_native.py).

The same numpy inputs (tests/test_loftr.py's rendered 640x480 pair, scaled
to [0, 1]) go through the JAX functions and the port's on the same weights,
on the CPU, where the JAX package's bf16 matmul scope is ignored by XLA and
the port's products are f32 (the per-device precision rule). Tolerances:

  * positional_encoding: < 1e-6;
  * encode at 240x320 and 480x640: max |d| < 5e-5 on features of magnitude
    ~7 (f32 convolutions summed in another order);
  * one encoder_layer and the coarse transformer: < 5e-5;
  * confidence_from_features at 480x640: max |d| < 1e-5 and argmax
    agreement > 0.999 (test_loftr.py's golden-parity bounds); the top-k set
    above the threshold equal;
  * match_one_against_many: each row's above-threshold set equal to a
    serial match_features_topk;
  * encode_with_fine's fine map < 5e-5 and fine_refine offsets < 1e-4 px.

The port's weights file is byte-identical to the JAX package's and
convert.loftr_params loads it into LoftrCoarse's state.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.models import loftr_native as jln
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.models import loftr_native as pln

from synthetic_world import PlaneWorld, lateral_trajectory

THRESHOLD = 0.1
K_TOP = 256


@pytest.fixture(scope="module")
def models():
    return jln.load_params(), pln.load_model(device="cpu")


@pytest.fixture(scope="module")
def pair():
    world = PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))
    poses = lateral_trajectory(4, step=0.2)
    imgs = [world.render(poses[0]), world.render(poses[2])]
    return np.stack([(im / 255.0)[None] for im in imgs]).astype(np.float32)  # [2,1,H,W]


@pytest.fixture(scope="module")
def feats(models, pair):
    """The pair's features from the JAX encode: the pairwise functions below
    take the same numpy features in both packages."""
    jp, _ = models
    return np.asarray(jln.encode(jp, jnp.asarray(pair)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_weights_and_state():
    assert filecmp.cmp(pln.WEIGHTS_PATH, jln._WEIGHTS_PATH, shallow=False)
    with np.load(pln.WEIGHTS_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    state = convert.loftr_params(arrays, "cpu")
    model = pln.load_model(device="cpu")
    assert set(state) == set(model.state_dict())
    assert len(state) == len(arrays) - 1  # all but the stored posenc table
    np.testing.assert_array_equal(model.backbone.layer2[0].down.weight.numpy(),
                                  arrays["backbone/layer2/block0/down/w"])
    np.testing.assert_array_equal(model.layers[3].mlp1.numpy(), arrays["coarse/3/mlp1"])
    assert model.backbone.outconv.bias is None
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("hw", [(30, 40), (15, 20)])
def test_positional_encoding(models, hw):
    jp, _ = models
    got = pln.positional_encoding(*hw, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jln.positional_encoding(*hw)), rtol=0, atol=1e-6)
    if hw == (30, 40):  # the exported table
        assert np.abs(got - np.asarray(jp["posenc"])).max() < 1e-6


@pytest.mark.parametrize("size", [(240, 320), (480, 640)])
def test_encode(models, pair, size):
    jp, model = models
    img = pair[:1]
    if size != (480, 640):
        img = np.ascontiguousarray(img[:, :, ::2, ::2])
    ref = np.asarray(jln.encode(jp, jnp.asarray(img)))
    got = pln.encode(model, _t(img)).numpy()
    assert got.shape == ref.shape == (1, (size[0] // 16) * (size[1] // 16), 32)
    assert np.abs(got - ref).max() < 5e-5


def test_encoder_layer_and_transformer(models, feats):
    jp, model = models
    f0, f1 = feats[:1], feats[1:]
    lp = {k.rsplit("/", 1)[1]: v for k, v in jp.items() if k.startswith("coarse/1/")}
    ref = np.asarray(jln.encoder_layer(lp, jnp.asarray(f0), jnp.asarray(f1)))
    got = pln.encoder_layer(model.layers[1], _t(f0), _t(f1)).numpy()
    assert np.abs(got - ref).max() < 5e-5
    r0, r1 = jln.coarse_transformer(jp, jnp.asarray(f0), jnp.asarray(f1))
    g0, g1 = pln.coarse_transformer(model, _t(f0), _t(f1))
    assert np.abs(g0.numpy() - np.asarray(r0)).max() < 5e-5
    assert np.abs(g1.numpy() - np.asarray(r1)).max() < 5e-5


def test_confidence_and_topk(models, feats):
    jp, model = models
    f0, f1 = feats[:1], feats[1:]
    ref = np.asarray(jln.confidence_from_features(jp, jnp.asarray(f0), jnp.asarray(f1)))
    got = pln.confidence_from_features(model, _t(f0), _t(f1)).numpy()
    assert got.shape == (1, 1200, 1200)
    assert np.abs(got - ref).max() < 1e-5
    assert (got[0].argmax(-1) == ref[0].argmax(-1)).mean() > 0.999
    # the top-k set above the threshold (exact top-k in both on the CPU)
    jv, ji = jln.match_features_topk(jp, jnp.asarray(f0), jnp.asarray(f1), K_TOP)
    pv, pi = pln.match_features_topk(model, _t(f0), _t(f1), K_TOP)
    jset = set(np.asarray(ji)[0][np.asarray(jv)[0] > THRESHOLD].tolist())
    pset = set(pi.numpy()[0][pv.numpy()[0] > THRESHOLD].tolist())
    assert len(jset) > 20 and pset == jset
    np.testing.assert_allclose(np.sort(pv.numpy()[0]), np.sort(np.asarray(jv)[0]), atol=1e-5)


def test_match_one_against_many_equals_serial(models, feats):
    _, model = models
    f_q = _t(feats[1:])
    stack = _t(np.concatenate([feats, feats[:1]]))  # N = 3
    vals, idx = pln.match_one_against_many(model, f_q, stack, K_TOP)
    assert vals.shape == idx.shape == (3, K_TOP)
    for i in range(3):
        sv, si = pln.match_features_topk(model, f_q, stack[i: i + 1], K_TOP)
        got = set(idx[i][vals[i] > THRESHOLD].tolist())
        assert got == set(si[0][sv[0] > THRESHOLD].tolist())
    # the self pair (row 1) matches far more cells than the moved pair
    assert (vals[1] > THRESHOLD).sum() > (vals[0] > THRESHOLD).sum()


def test_fine_refine(models, pair):
    jp, model = models
    jf, jfine = jln.encode_with_fine(jp, jnp.asarray(pair))
    pf, pfine = pln.encode_with_fine(model, _t(pair))
    assert pfine.shape == (2, 16, 120, 160)
    assert np.abs(pf.numpy() - np.asarray(jf)).max() < 5e-5
    assert np.abs(pfine.numpy() - np.asarray(jfine)).max() < 5e-5
    fine = np.asarray(jfine)
    rng = np.random.default_rng(3)
    cell0 = rng.integers(0, 1200, 64).astype(np.int32)
    cell1 = np.clip(cell0 + rng.integers(-3, 4, 64), 0, 1199).astype(np.int32)
    cell0[:2] = [0, 1199]  # border cells: the window is clipped
    ref = np.asarray(jln.fine_refine(*(jnp.asarray(a) for a in (fine[0], fine[1], cell0, cell1))))
    got = pln.fine_refine(_t(fine[0]), _t(fine[1]), _t(cell0), _t(cell1)).numpy()
    assert got.shape == (64, 2) and np.abs(got).max() <= 8.0
    assert np.abs(got - ref).max() < 1e-4


def test_repeated_calls_stay_eager_on_the_cpu(pair, feats):
    """On the CPU every call runs the eager body, never a CUDA graph: the
    third call of a shape keeps test_encode's and test_confidence_and_topk's
    bounds against the JAX functions, and every call counts as eager."""
    jp = jln.load_params()
    model = pln.load_model(device="cpu")
    f0, f1 = feats[:1], feats[1:]
    ref_e = np.asarray(jln.encode(jp, jnp.asarray(pair[:1])))
    ref_c = np.asarray(jln.confidence_from_features(jp, jnp.asarray(f0), jnp.asarray(f1)))
    for _ in range(3):
        assert np.abs(pln.encode(model, _t(pair[:1])).numpy() - ref_e).max() < 5e-5
        got = pln.confidence_from_features(model, _t(f0), _t(f1)).numpy()
        assert np.abs(got - ref_c).max() < 1e-5
        assert (got[0].argmax(-1) == ref_c[0].argmax(-1)).mean() > 0.999
    assert model.graphs.counts == {"replay": 0, "capture": 0, "eager": 6}
    assert len(model.graphs) == 0
