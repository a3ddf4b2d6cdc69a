"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

PyTorch port's counterpart of `mono_slam_framework_tpu/io/datasets.py`
(numpy; the native decoder is the port's copy of frameio.cc).

The reference's only frame source is a live Webots camera (src/main.cpp:
122-128); the rebuild's BASELINE.json configs name TUM fr1/xyz, fr1/desk,
KITTI 00 and EuRoC MH_01, so these loaders provide the standard monocular
frame streams (grayscale f32 [H,W] + timestamp) for offline runs. Decoding
is served by the native C++ decoder + decode-ahead worker thread
(native/frameio.cc) when available, with a per-frame PIL fallback for
encodings it doesn't handle (no OpenCV in this environment).
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Sequence

import numpy as np


class FrameData(NamedTuple):
    timestamp: float
    image: np.ndarray  # f32 [H, W] grayscale 0..255


def _pil_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def _load_gray(path: str) -> np.ndarray:
    """Grayscale f32 [H,W]: native decoder first, PIL fallback.

    The two paths are pinned bit-identical by tests/test_native_io.py, so
    which one serves a frame is an availability detail, not a behavior one.
    """
    from mono_slam_framework_torch.native import frameio

    img = frameio.decode(path)
    return img if img is not None else _pil_gray(path)


def stream_paths(
    times: Sequence[float], paths: Sequence[str], prefetch: int = 4
) -> Iterator[FrameData]:
    """Yield FrameData for parallel (timestamp, image-path) sequences.

    With `prefetch` > 0 and the native library available, a C++ worker
    thread decodes `prefetch` frames ahead of the consumer (the twin of the
    reference app's camera acquisition running ahead of the SLAM step,
    src/main.cpp:122-128); frames the native decoder rejects fall back to
    PIL individually. `prefetch=0` forces the synchronous path.
    """
    from mono_slam_framework_torch.native import frameio

    pf = None
    if prefetch > 0 and frameio.load_library() is not None:
        try:
            pf = frameio.FramePrefetcher(paths, ring=prefetch)
        except RuntimeError:
            pf = None
    if pf is None:
        for ts, path in zip(times, paths):
            yield FrameData(float(ts), _load_gray(path))
        return
    try:
        for i, img in pf:
            if img is None:
                img = _pil_gray(paths[i])
            yield FrameData(float(times[i]), img)
    finally:
        pf.close()


def load_tum(seq_dir: str, prefetch: int = 4) -> Iterator[FrameData]:
    """TUM RGB-D monocular stream: rgb.txt lines `timestamp filename`."""
    index = os.path.join(seq_dir, "rgb.txt")
    times, paths = [], []
    with open(index) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            times.append(float(ts))
            paths.append(os.path.join(seq_dir, rel))
    return stream_paths(times, paths, prefetch=prefetch)


def load_tum_groundtruth(seq_dir: str):
    """groundtruth.txt -> (times [N], pos [N,3], quat [N,4])."""
    from mono_slam_framework_torch.io import trajectory

    return trajectory.read_tum(os.path.join(seq_dir, "groundtruth.txt"))


def load_kitti_groundtruth(seq_dir: str):
    """KITTI odometry ground truth -> (times [N], pos [N,3], quat [N,4]).

    poses.txt rows are 3x4 row-major camera-to-world matrices Twc for the
    left gray camera; timestamps come from times.txt. Looks for poses.txt in
    the sequence directory (where evaluation scripts conventionally drop it).
    Quaternions use the TUM [qx qy qz qw] order.
    """
    poses = np.loadtxt(os.path.join(seq_dir, "poses.txt"), np.float64)
    poses = poses.reshape(-1, 3, 4)
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = np.array([float(x) for x in f.read().split()], np.float64)
    n = min(len(poses), len(times))
    pos = poses[:n, :, 3]
    quat = _rot_to_quat_np(poses[:n, :, :3])
    return times[:n], pos, quat


def load_euroc_groundtruth(seq_dir: str):
    """EuRoC ground truth -> (times [N], pos [N,3], quat [N,4]).

    mav0/state_groundtruth_estimate0/data.csv rows:
    ts_ns, px, py, pz, qw, qx, qy, qz, ... — reordered to TUM [qx qy qz qw].
    """
    path = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    times, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split(",")[:8]]
            times.append(vals[0] * 1e-9)
            pos.append(vals[1:4])
            qw, qx, qy, qz = vals[4:8]
            quat.append([qx, qy, qz, qw])
    return (
        np.asarray(times, np.float64),
        np.asarray(pos, np.float64),
        np.asarray(quat, np.float64),
    )


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Batched rotation [N,3,3] -> quaternion [N,4] ([qx qy qz qw]), in
    f64 on the CPU."""
    import torch

    from mono_slam_framework_torch.geometry import se3

    R = torch.from_numpy(np.ascontiguousarray(R, np.float64))
    return se3.rotation_to_quaternion(R).numpy()


def load_kitti_calib(seq_dir: str):
    """(fx, fy, cx, cy) of the left gray camera from calib.txt's P0 row."""
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P0:"):
                v = [float(x) for x in line.split()[1:]]
                return v[0], v[5], v[2], v[6]
    raise ValueError(f"no P0 row in {seq_dir}/calib.txt")


def load_euroc_calib(seq_dir: str, cam: str = "cam0"):
    """(fx, fy, cx, cy) from mav0/cam0/sensor.yaml's `intrinsics:` line
    (parsed textually — no YAML dependency)."""
    path = os.path.join(seq_dir, "mav0", cam, "sensor.yaml")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("intrinsics:"):
                inner = line.split("[", 1)[1].rsplit("]", 1)[0]
                v = [float(x) for x in inner.split(",")]
                return v[0], v[1], v[2], v[3]
    raise ValueError(f"no intrinsics line in {path}")


def load_kitti(
    seq_dir: str, camera: str = "image_0", prefetch: int = 4
) -> Iterator[FrameData]:
    """KITTI odometry grayscale: times.txt + image_0/######.png."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    img_dir = os.path.join(seq_dir, camera)
    names = sorted(os.listdir(img_dir))
    paths = [os.path.join(img_dir, n) for n in names[: len(times)]]
    return stream_paths(times[: len(paths)], paths, prefetch=prefetch)


def load_euroc(
    seq_dir: str, cam: str = "cam0", prefetch: int = 4
) -> Iterator[FrameData]:
    """EuRoC MAV: mav0/cam0/data.csv (ns timestamps) + data/*.png."""
    cam_dir = os.path.join(seq_dir, "mav0", cam)
    times, paths = [], []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, name = line.split(",")[:2]
            times.append(float(ts_ns) * 1e-9)
            paths.append(os.path.join(cam_dir, "data", name.strip()))
    return stream_paths(times, paths, prefetch=prefetch)


LOADERS = {"tum": load_tum, "kitti": load_kitti, "euroc": load_euroc}
GROUNDTRUTH_LOADERS = {
    "tum": load_tum_groundtruth,
    "kitti": load_kitti_groundtruth,
    "euroc": load_euroc_groundtruth,
}
CALIB_LOADERS = {"kitti": load_kitti_calib, "euroc": load_euroc_calib}
