"""Port parity for the LoFTR ONNX oracle (models/onnx_reader.py,
models/loftr.py, tools/torch_extract_loftr_weights.py).

The reference export is not in the repo, so the files come from
tests/torch_onnx_graphs.py: a graph covering every attribute type and tensor
encoding, one-node graphs per op, and the coarse LoFTR graph on the
committed weights. The same files and the same numpy inputs go through the
JAX package's reader and interpreter and the port's, on the CPU. Tolerances:

  * reader: nodes, attributes, graph inputs / outputs and the census equal,
    initializers bit-equal;
  * per op: host-ness, shapes and dtypes equal; host and integer outputs
    equal; floats within 1e-6, Conv and MatMul within 1e-5; the same ops
    raise in both;
  * the LoFTR graph at 128x160 (80 tokens): the JAX LoftrModel (its one jit)
    against the port's on the CPU within 1e-5; the port's interpreter
    against the port's native forward (loftr_native, f32) within 1e-5 with
    argmax agreement > 0.999 (tests/test_loftr.py:106-107);
  * the extraction tools at 480x640: both return the committed npz
    bit-equal.

The real export's golden check (tests/test_loftr.py:86-114 for the port)
skips while the export is missing; the card's check skips without a card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_onnx_graphs as tg
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.models import loftr as ploftr
from mono_slam_framework_torch.models import loftr_native as pln
from mono_slam_framework_torch.models import onnx_reader as preader
from mono_slam_framework_tpu.models import loftr as jloftr
from mono_slam_framework_tpu.models import onnx_reader as jreader

from test_loftr import REFERENCE_ONNX
from torch_parity import require_cuda

CPU = torch.device("cpu")
TOL_FLOAT = 1e-6
TOL_PRODUCT = 1e-5  # Conv, MatMul and the whole graph
MIN_ARGMAX = 0.999


sys.path.append(str(tg.ROOT / "tools"))
import extract_loftr_weights as JTOOL  # noqa: E402
import torch_extract_loftr_weights as PTOOL  # noqa: E402

REAL_EXPORT = next((str(p) for p in (PTOOL.DEFAULT_ONNX, REFERENCE_ONNX) if os.path.exists(p)),
                   None)


def _npz() -> dict:
    with np.load(pln.WEIGHTS_PATH) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    return {
        "reader": tg.reader_graph().save(d / "reader.onnx"),
        "loftr_128x160": tg.loftr_coarse_graph(128, 160, pln.WEIGHTS_PATH, PTOOL).save(
            d / "l128.onnx"),
        "loftr_480x640": tg.loftr_coarse_graph(480, 640, pln.WEIGHTS_PATH, PTOOL).save(
            d / "l480.onnx"),
    }


def _rendered_pair(h, w):
    """tests/test_loftr.py's pair rendered at h x w, in [0, 1], [2,1,h,w]."""
    world = sim.PlaneWorld(width=w, height=h, f=500.0 * w / 640, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(4, step=0.2)
    return np.stack([(world.render(poses[i]) / 255.0)[None] for i in (0, 2)]).astype(np.float32)


# ---- 1. the reader ----

def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(a, list):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes() and len(a) == len(b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("which", ["reader", "loftr_128x160"])
def test_reader_matches_jax(graphs, which):
    jg, pg = jreader.load_graph(graphs[which]), preader.load_graph(graphs[which])
    assert len(jg.nodes) == len(pg.nodes)
    for jn, pn in zip(jg.nodes, pg.nodes):
        assert (jn.op_type, jn.name, jn.inputs, jn.outputs) == \
            (pn.op_type, pn.name, pn.inputs, pn.outputs)
        assert list(jn.attrs) == list(pn.attrs)
        for k in jn.attrs:
            _same_value(jn.attrs[k], pn.attrs[k])
    assert list(jg.initializers) == list(pg.initializers)
    for k, v in jg.initializers.items():
        _same_value(v, pg.initializers[k])
    assert (jg.inputs, jg.outputs) == (pg.inputs, pg.outputs)
    assert jreader.op_census(jg) == preader.op_census(pg)
    if which == "reader":  # every encoding decoded, not just decoded alike
        want = {"raw_i64": [[-3, 0], [7, 2**40]], "int64_packed": [-1, 0, 5, -(2**40)],
                "int32_packed": [0, 1, 300, 2**31 - 1], "float_one": [1.5]}
        for k, v in want.items():
            assert pg.initializers[k].tolist() == v
        assert pg.nodes[2].attrs["kernel_shape"] == [-7]
        assert pg.nodes[3].attrs["weights"] == [0.25, 4.0]
    else:
        assert {k: preader.op_census(pg)[k] for k in tg.LOFTR_CENSUS} == tg.LOFTR_CENSUS


# ---- 2. op by op ----

_RNG = np.random.default_rng(7)


def _f(*shape, lo=-1.0, hi=1.0):
    return _RNG.uniform(lo, hi, shape).astype(np.float32)


class H(np.ndarray):
    """Marks a test input fed as a host (numpy) value; others are fed as
    device arrays (jnp / a CPU tensor)."""


def _h(a):
    return np.asarray(a).view(H)


_ARITH = ("Add", "Sub", "Mul", "Div", "Pow")
_CASES = [
    ("Constant-tensor", "Constant", {}, 1, dict(value=np.array([[1.5, -2.0]], np.float32))),
    ("Constant-int64", "Constant", {}, 1,
     dict(value=tg.Tensor(np.array([3, -1], np.int64), "int64_packed"))),
    ("Constant-value_float", "Constant", {}, 1, dict(value_float=0.75)),
    ("Shape-device", "Shape", {"x": _f(2, 3, 4)}, 1, {}),
    ("Shape-host", "Shape", {"x": _h(np.zeros((5, 2), np.int64))}, 1, {}),
    *[(f"{op}-host", op, {"a": _h(_f(3, lo=0.5, hi=2.0)), "b": _h(_f(3))}, 1, {})
      for op in _ARITH],
    *[(f"{op}-host-int", op, {"a": _h(np.array([6, 3, 9], np.int64)),
                              "b": _h(np.array([2, 1, 3], np.int64))}, 1, {}) for op in _ARITH],
    *[(f"{op}-device", op, {"a": _f(2, 3, lo=0.5, hi=2.0), "b": _f(3)}, 1, {})
      for op in _ARITH],
    *[(f"{op}-device-host-f64", op,
       {"a": _f(2, 3, lo=0.5, hi=2.0), "b": _h(np.array([0.5, -1.25, 2.0]))}, 1, {})
      for op in _ARITH],
    ("Add-host-device-int", "Add", {"a": _h(np.array([1, 2, 3], np.int64)), "b": _f(3)}, 1, {}),
    ("Sqrt-host", "Sqrt", {"x": _h(_f(4, lo=0.0, hi=3.0))}, 1, {}),
    ("Sqrt-device", "Sqrt", {"x": _f(2, 4, lo=0.0, hi=3.0)}, 1, {}),
    ("Relu-device", "Relu", {"x": _f(3, 5)}, 1, {}),
    ("Relu-host", "Relu", {"x": _h(_f(4))}, 1, {}),
    ("Relu-int", "Relu", {"x": np.array([-2, 0, 3], np.int32)}, 1, {}),
    ("Elu-alpha", "Elu", {"x": _f(3, 4, lo=-3, hi=3)}, 1, dict(alpha=0.5)),
    ("Elu-default", "Elu", {"x": _f(3, 4, lo=-3, hi=3)}, 1, {}),
    ("Elu-alpha-zero", "Elu", {"x": _h(_f(6, lo=-3, hi=3))}, 1, dict(alpha=0.0)),
    *[(f"Cast-{to}-{where}", "Cast", {"x": (_h if where == "host" else np.asarray)(
        np.array([-1.5, 0.0, 2.7, 3.0], np.float32))}, 1, {} if to is None else dict(to=to))
      for to in (1, 6, 7, 11, 9, 10, None) for where in ("host", "device")],
    ("Concat-host", "Concat", {"a": _h(np.array([1, 2], np.int64)),
                               "b": _h(np.array([3], np.int64))}, 1, dict(axis=0)),
    ("Concat-mixed", "Concat", {"a": _f(2, 3), "b": _h(_f(2, 1))}, 1, dict(axis=-1)),
    ("Concat-default-axis", "Concat", {"a": _f(1, 3), "b": _f(2, 3)}, 1, {}),
    ("Split-even", "Split", {"x": _f(2, 6)}, 2, dict(axis=1)),
    ("Split-three-host", "Split", {"x": _h(_f(6, 2))}, 3, {}),
    ("Reshape-device", "Reshape", {"x": _f(2, 3, 4), "s": _h(np.array([-1, 4], np.int64))}, 1, {}),
    ("Reshape-zero-as-given", "Reshape", {"x": _f(2, 0), "s": _h(np.array([0, 5], np.int64))},
     1, {}),
    ("Reshape-host", "Reshape", {"x": _h(np.arange(6, dtype=np.int64)),
                                 "s": _h(np.array([3, 2], np.int64))}, 1, {}),
    ("Transpose-perm", "Transpose", {"x": _f(2, 3, 4)}, 1, dict(perm=[1, 2, 0])),
    ("Transpose-reverse", "Transpose", {"x": _h(_f(2, 3, 4))}, 1, {}),
    ("Squeeze-attr", "Squeeze", {"x": _f(1, 3, 1, 2)}, 1, dict(axes=[0, 2])),
    ("Squeeze-input", "Squeeze", {"x": _f(2, 3, 1), "a": _h(np.array([-1], np.int64))}, 1, {}),
    ("Squeeze-empty", "Squeeze", {"x": _f(1, 3, 1, 1)}, 1, {}),
    ("Squeeze-host", "Squeeze", {"x": _h(_f(1, 4))}, 1, dict(axes=[0])),
    ("Unsqueeze-attr", "Unsqueeze", {"x": _f(3, 2)}, 1, dict(axes=[0, 3])),
    ("Unsqueeze-input", "Unsqueeze", {"x": _f(3, 2), "a": _h(np.array([-1, 0], np.int64))}, 1, {}),
    ("Unsqueeze-host", "Unsqueeze", {"x": _h(np.array([4, 5], np.int64))}, 1, dict(axes=[1])),
    ("Slice-basic", "Slice", {"x": _f(5, 6), "s": _h(np.array([1], np.int64)),
                              "e": _h(np.array([4], np.int64))}, 1, {}),
    ("Slice-axes-steps", "Slice", {"x": _f(5, 7), "s": _h(np.array([0, 1], np.int64)),
                                   "e": _h(np.array([5, 2**63 - 1], np.int64)),
                                   "a": _h(np.array([0, -1], np.int64)),
                                   "t": _h(np.array([2, 3], np.int64))}, 1, {}),
    ("Slice-negative-step", "Slice", {"x": _f(4, 6), "s": _h(np.array([-1, 4], np.int64)),
                                      "e": _h(np.array([-(2**63), 0], np.int64)),
                                      "a": _h(np.array([1, 0], np.int64)),
                                      "t": _h(np.array([-2, -1], np.int64))}, 1, {}),
    ("Slice-host", "Slice", {"x": _h(np.array([3, 32, 8, 10], np.int64)),
                             "s": _h(np.array([-2], np.int64)),
                             "e": _h(np.array([2**63 - 1], np.int64))}, 1, {}),
    ("ReduceSum-attr", "ReduceSum", {"x": _f(2, 3, 4)}, 1, dict(axes=[1], keepdims=0)),
    ("ReduceSum-input", "ReduceSum", {"x": _f(2, 3, 4), "a": _h(np.array([0, -1], np.int64))},
     1, {}),
    ("ReduceSum-all", "ReduceSum", {"x": _h(_f(3, 4))}, 1, {}),
    ("ReduceSum-int", "ReduceSum", {"x": np.array([[1, 2], [3, 4]], np.int32)}, 1,
     dict(axes=[0])),
    ("ReduceSum-bool", "ReduceSum", {"x": np.array([True, False, True])}, 1, {}),
    ("ReduceMean-int", "ReduceMean", {"x": np.array([1, 2, 4], np.int32)}, 1, dict(keepdims=0)),
    ("ReduceMean-attr", "ReduceMean", {"x": _f(2, 3, 4)}, 1, dict(axes=[-1])),
    ("ReduceMean-all", "ReduceMean", {"x": _f(3, 4)}, 1, dict(keepdims=0)),
    ("MatMul-2d", "MatMul", {"a": _f(4, 5), "b": _f(5, 3)}, 1, {}),
    ("MatMul-batched", "MatMul", {"a": _f(2, 4, 5), "b": _h(_f(5, 3))}, 1, {}),
    ("Softmax-default", "Softmax", {"x": _f(2, 3, 5, lo=-5, hi=5)}, 1, {}),
    ("Softmax-axis", "Softmax", {"x": _f(2, 3, 5, lo=-5, hi=5)}, 1, dict(axis=1)),
    ("Conv-bias", "Conv", {"x": _f(2, 3, 9, 8), "w": _f(4, 3, 3, 3), "b": _f(4)}, 1,
     dict(strides=[2, 2], pads=[1, 1, 1, 1], dilations=[1, 1], kernel_shape=[3, 3])),
    ("Conv-asym-grouped", "Conv", {"x": _f(1, 4, 7, 9), "w": _f(6, 2, 3, 2)}, 1,
     dict(pads=[1, 0, 2, 1], group=2, dilations=[2, 1], strides=[1, 2])),
    ("Conv-group-zero", "Conv", {"x": _f(1, 2, 5, 5), "w": _h(_f(3, 2, 1, 1)), "b": _h(_f(3))},
     1, dict(group=0)),
    ("Conv-defaults", "Conv", {"x": _f(1, 1, 6, 6), "w": _f(2, 1, 3, 3)}, 1, {}),
]
_RAISES = [
    ("Split-uneven", "Split", {"x": _f(2, 5)}, 3, dict(axis=1), ValueError),
    ("Reshape-zero-not-copied", "Reshape", {"x": _f(2, 3, 4), "s": _h(np.array([0, 12], np.int64))},
     1, {}, (TypeError, ValueError, RuntimeError)),
    ("Squeeze-not-one", "Squeeze", {"x": _f(1, 3)}, 1, dict(axes=[1]), ValueError),
    ("Gather-unsupported", "Gather", {"x": _f(3), "i": _h(np.array([0], np.int64))}, 1, {},
     NotImplementedError),
]


def _node_of(tmp_path, op, inputs, n_out, attrs):
    path = tg.op_graph(op, inputs, n_out, **attrs).save(tmp_path / "op.onnx")
    return jreader.load_graph(path).nodes[0], preader.load_graph(path).nodes[0]


def _envs(inputs):
    jenv, penv = {}, {}
    for k, v in inputs.items():
        if isinstance(v, H):
            jenv[k] = penv[k] = np.asarray(v)
        else:
            jenv[k], penv[k] = jnp.asarray(v), ploftr._to_device(v, CPU)
    return jenv, penv


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_run_node_matches_jax(tmp_path, case):
    _, op, inputs, n_out, attrs = case
    jnode, pnode = _node_of(tmp_path, op, inputs, n_out, attrs)
    jenv, penv = _envs(inputs)
    jout = jloftr._run_node(jnode, jenv, {})
    pout = ploftr._run_node(pnode, penv, {}, CPU)
    assert len(jout) == len(pout) == n_out
    tol = TOL_PRODUCT if op in ("Conv", "MatMul") else TOL_FLOAT
    for j, p in zip(jout, pout):
        assert jloftr._is_host(j) == ploftr._is_host(p), (type(j), type(p))
        jn, pn = np.asarray(j), _np(p)
        assert (jn.shape, jn.dtype) == (pn.shape, pn.dtype)
        if jn.dtype.kind == "f" and not jloftr._is_host(j):
            np.testing.assert_allclose(pn, jn, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(pn, jn)


@pytest.mark.parametrize("case", _RAISES, ids=[c[0] for c in _RAISES])
def test_run_node_raises_like_jax(tmp_path, case):
    _, op, inputs, n_out, attrs, exc = case
    jnode, pnode = _node_of(tmp_path, op, inputs, n_out, attrs)
    jenv, penv = _envs(inputs)
    with pytest.raises(exc):
        jloftr._run_node(jnode, jenv, {})
    with pytest.raises(exc):
        ploftr._run_node(pnode, penv, {}, CPU)


# ---- 3. the LoFTR graph ----

@pytest.fixture(scope="module")
def pair_128():
    return _rendered_pair(128, 160)


def test_loftr_graph_matches_jax_and_native(graphs, pair_128):
    path = graphs["loftr_128x160"]
    x = torch.from_numpy(pair_128)
    mine = ploftr.LoftrModel(path, device="cpu").confidence(x[:1], x[1:]).numpy()
    assert mine.shape == (1, 80, 80) and mine.dtype == np.float32
    ref = np.asarray(jloftr.LoftrModel(path).confidence(jnp.asarray(pair_128[:1]),
                                                        jnp.asarray(pair_128[1:])))
    assert np.abs(mine - ref).max() < TOL_PRODUCT
    native = pln.loftr_confidence(pln.load_model(device="cpu"), x[:1], x[1:]).numpy()
    assert np.abs(mine - native).max() < TOL_PRODUCT
    assert (mine.argmax(-1) == native.argmax(-1)).mean() > MIN_ARGMAX


def test_execute_graph_feeds_host_images(graphs, pair_128):
    """execute_graph on the graph's numpy initializers and numpy feeds, as the
    JAX API is called, gives the model's confidence on the device asked for."""
    model = ploftr.LoftrModel(graphs["loftr_128x160"], device="cpu")
    g = model.graph
    out = ploftr.execute_graph(g, g.initializers, {"img0": pair_128[:1], "img1": pair_128[1:]},
                               device="cpu")
    ref = model.confidence(torch.from_numpy(pair_128[:1]), torch.from_numpy(pair_128[1:]))
    assert out[0].device == CPU
    assert torch.equal(out[0], ref)


def test_execute_graph_defaults_to_the_card(graphs, pair_128):
    g = preader.load_graph(graphs["loftr_128x160"])
    feeds = {"img0": pair_128[:1], "img1": pair_128[1:]}
    if torch.cuda.is_available():
        assert ploftr.execute_graph(g, g.initializers, feeds)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ploftr.execute_graph(g, g.initializers, feeds)


def test_model_defaults_to_the_card(graphs):
    path = graphs["loftr_128x160"]
    if torch.cuda.is_available():
        assert ploftr.LoftrModel(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ploftr.LoftrModel(path)
    ploftr.default_model.cache_clear()
    m = ploftr.default_model(path, "cpu")
    assert m is ploftr.default_model(path, "cpu") and m.device == CPU
    ploftr.default_model.cache_clear()


# ---- 4. the extraction tools ----

def test_extraction_round_trip(graphs):
    want = _npz()
    for tool in (JTOOL, PTOOL):
        got = tool.extract(graphs["loftr_480x640"])
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_extraction_missing_file_writes_nothing(tmp_path):
    missing, out = tmp_path / "missing.onnx", tmp_path / "out.npz"
    with pytest.raises(FileNotFoundError, match="missing.onnx"):
        PTOOL.main([str(missing), str(out)])
    assert not out.exists()


def test_extraction_main_writes_the_npz(graphs, tmp_path):
    out = tmp_path / "w.npz"
    PTOOL.main([graphs["loftr_480x640"], str(out)])
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    want = _npz()
    assert list(got) == list(want)
    assert all(got[k].tobytes() == v.tobytes() for k, v in want.items())


# ---- 5. the real export ----

@pytest.mark.skipif(REAL_EXPORT is None, reason="reference ONNX export not present")
class TestGoldenParity:
    """The port's native forward against the port's interpreter on the
    reference export (tests/test_loftr.py::TestGoldenParity for the port)."""

    def test_confidence_parity(self):
        x = torch.from_numpy(_rendered_pair(480, 640))
        ref = ploftr.LoftrModel(REAL_EXPORT, device="cpu").confidence(x[:1], x[1:]).numpy()
        mine = pln.loftr_confidence(pln.load_model(device="cpu"), x[:1], x[1:]).numpy()
        assert np.abs(ref - mine).max() < TOL_PRODUCT
        assert (ref.argmax(-1) == mine.argmax(-1)).mean() > MIN_ARGMAX

    def test_weights_match_onnx_initializers(self):
        g = preader.load_graph(REAL_EXPORT)
        want = _npz()
        assert np.array_equal(want["coarse/0/wq"], g.initializers["1087"])
        assert np.array_equal(want["backbone/conv1/w"], g.initializers["1028"])
        got = PTOOL.extract(REAL_EXPORT)
        assert all(np.array_equal(got[k], v) for k, v in want.items())


# ---- 6. the card ----

@pytest.mark.cuda
def test_interpreter_on_the_card(graphs, pair_128):
    require_cuda()
    path = graphs["loftr_128x160"]
    x = torch.from_numpy(pair_128)
    cpu = ploftr.LoftrModel(path, device="cpu").confidence(x[:1], x[1:]).numpy()
    xd = x.cuda()
    card = ploftr.LoftrModel(path, device="cuda").confidence(xd[:1], xd[1:]).cpu().numpy()
    assert np.abs(card - cpu).max() < TOL_PRODUCT
    assert (card.argmax(-1) == cpu.argmax(-1)).mean() > MIN_ARGMAX
