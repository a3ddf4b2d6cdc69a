"""One-time extraction of LoFTR_teacher weights into the port's checkpoint.

The port's counterpart of tools/extract_loftr_weights.py: it reads the
reference's ONNX asset (model/LoFTR_teacher.onnx, consumed by
src/dnnfeaturematcher.cpp:50-74) through the port's protobuf reader
(`mono_slam_framework_torch/models/onnx_reader.py`) and maps its
initializers and constants onto the arrays `models/loftr_native.py` loads
(`convert.loftr_params`). The npz ships with the repo (0.8 MB of float32);
run this only to regenerate it from an export.

Weight-name map (ONNX initializer -> role), as the JAX tool decodes the node
trace: the backbone is conv1(7x7/2) + 4 residual stages (1->8->16->32->32
channels, /16 resolution) + a bias-free 1x1 outconv; the coarse transformer
is 4 LoFTREncoderLayers applied [self, cross, self, cross] to both feature
sets. The exporter duplicated each layer's weights per application (feat0 /
feat1 copies, asserted bit-equal), so only the first copy is kept.

Usage: python tools/torch_extract_loftr_weights.py [onnx_path] [out_npz]
(defaults: model/LoFTR_teacher.onnx and
mono_slam_framework_torch/models/weights/loftr_teacher.npz, both under the
repo root).
"""

from __future__ import annotations

import errno
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from mono_slam_framework_torch.models.onnx_reader import load_graph  # noqa: E402

DEFAULT_ONNX = ROOT / "model" / "LoFTR_teacher.onnx"
DEFAULT_OUT = ROOT / "mono_slam_framework_torch" / "models" / "weights" / "loftr_teacher.npz"

# backbone: (key, weight_init, bias_init or None)
_BACKBONE = [
    ("conv1", "1028", "1029"),
    ("layer1/block0/conv1", "1031", "1032"),
    ("layer1/block0/conv2", "1034", "1035"),
    ("layer1/block1/conv1", "1037", "1038"),
    ("layer1/block1/conv2", "1040", "1041"),
    ("layer2/block0/conv1", "1043", "1044"),
    ("layer2/block0/conv2", "1046", "1047"),
    ("layer2/block0/down", "1049", "1050"),
    ("layer2/block1/conv1", "1052", "1053"),
    ("layer2/block1/conv2", "1055", "1056"),
    ("layer3/block0/conv1", "1058", "1059"),
    ("layer3/block0/conv2", "1061", "1062"),
    ("layer3/block0/down", "1064", "1065"),
    ("layer3/block1/conv1", "1067", "1068"),
    ("layer3/block1/conv2", "1070", "1071"),
    ("layer4/block0/conv1", "1073", "1074"),
    ("layer4/block0/conv2", "1076", "1077"),
    ("layer4/block0/down", "1079", "1080"),
    ("layer4/block1/conv1", "1082", "1083"),
    ("layer4/block1/conv2", "1085", "1086"),
    ("outconv", "backbone.layer4_outconv.weight", None),
]

# coarse transformer layers: (wq, wk, wv, merge, mlp0, mlp1); the duplicated
# second-application copies (e.g. 1100-1112 for layer 0) are verified equal.
_COARSE = [
    ("1087", "1088", "1089", "1097", "1098", "1099"),
    ("1113", "1114", "1115", "1123", "1124", "1125"),
    ("1139", "1140", "1141", "1149", "1150", "1151"),
    ("1165", "1166", "1167", "1175", "1176", "1177"),
]
_COARSE_DUP = [
    ("1100", "1101", "1102", "1110", "1111", "1112"),
    ("1126", "1127", "1128", "1136", "1137", "1138"),
    ("1152", "1153", "1154", "1162", "1163", "1164"),
    ("1178", "1179", "1180", "1188", "1189", "1190"),
]
_ROLES = ("wq", "wk", "wv", "merge", "mlp0", "mlp1")
_POSENC_CONSTANT = "248"  # the graph Constant feeding the post-split Add


def extract(onnx_path) -> dict[str, np.ndarray]:
    """The checkpoint's arrays from an export; FileNotFoundError (naming the
    path) when there is no file."""
    onnx_path = os.fspath(onnx_path)
    if not os.path.isfile(onnx_path):
        raise FileNotFoundError(errno.ENOENT, "LoFTR ONNX export not found", onnx_path)
    g = load_graph(onnx_path)
    init = g.initializers
    out: dict[str, np.ndarray] = {}
    for key, w, b in _BACKBONE:
        out[f"backbone/{key}/w"] = init[w].astype(np.float32)
        if b is not None:
            out[f"backbone/{key}/b"] = init[b].astype(np.float32)
    for i, (names, dup) in enumerate(zip(_COARSE, _COARSE_DUP)):
        for role, w, w2 in zip(_ROLES, names, dup):
            assert np.array_equal(init[w], init[w2]), f"layer {i} {role} copies differ"
            out[f"coarse/{i}/{role}"] = init[w].astype(np.float32)
        for n in ("norm1", "norm2"):
            out[f"coarse/{i}/{n}_w"] = init[f"loftr_coarse.layers.{i}.{n}.weight"]
            out[f"coarse/{i}/{n}_b"] = init[f"loftr_coarse.layers.{i}.{n}.bias"]
    # positional-encoding table; equals the exp(-2k)-frequency sine table
    # loftr_native regenerates, kept for bit-exactness at 480x640
    for n in g.nodes:
        if n.op_type == "Constant" and n.outputs[0] == _POSENC_CONSTANT:
            out["posenc"] = np.asarray(n.attrs["value"])[0].astype(np.float32)
            break
    assert "posenc" in out, "positional encoding constant not found"
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    onnx_path = argv[0] if len(argv) > 0 else DEFAULT_ONNX
    out_path = argv[1] if len(argv) > 1 else DEFAULT_OUT
    params = extract(onnx_path)  # raises before anything is written
    np.savez_compressed(out_path, **params)
    total = sum(v.size * v.itemsize for v in params.values())
    print(f"wrote {out_path}: {len(params)} arrays, {total / 1e6:.2f} MB raw")


if __name__ == "__main__":
    main()
