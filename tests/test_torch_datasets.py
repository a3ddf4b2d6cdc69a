"""The port's dataset loaders (io/datasets.py) against the JAX package's.

Tiny TUM, KITTI and EuRoC sequences (64x48, 5 frames) go through both
packages' loaders: frames bit-equal and timestamps equal, with the native
prefetcher and without it; ground truth and calibration equal. The KITTI
quaternions are computed from rotation matrices: the port's in f64, the
JAX package's in f32 (JAX runs without 64-bit mode), so they agree to
f32 rounding.
"""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.io import datasets as jd
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.io import datasets as pd

H, W, F, N = 48, 64, 40.0, 5
QW = f"{np.sqrt(1 - 0.14):.15f}"  # with qx, qy, qz = 0.1, 0.2, 0.3: a unit quaternion


def _write_png(path, img):
    from PIL import Image

    Image.fromarray(img.astype(np.uint8), "L").save(path)


@pytest.fixture(scope="module")
def views():
    world = sim.PlaneWorld(width=W, height=H, f=F, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(N, step=0.09, yaw_step=0.01)
    return world, poses, [world.render(T) for T in poses]


@pytest.fixture(scope="module")
def tum(tmp_path_factory, views):
    world, poses, images = views
    root = tmp_path_factory.mktemp("tum")
    os.makedirs(root / "rgb")
    lines, gt = [], []
    for i, (T, img) in enumerate(zip(poses, images)):
        ts = 1305031102.175304 + i * 0.033
        _write_png(root / f"rgb/{ts:.6f}.png", img)
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        Ow = -(T[:3, :3].T @ T[:3, 3])
        gt.append(f"{ts:.4f} {Ow[0]:.4f} {Ow[1]:.4f} {Ow[2]:.4f} 0.1 0.2 0.3 {QW}")
    (root / "rgb.txt").write_text("# color images\n# timestamp filename\n"
                                  + "\n".join(lines) + "\n")
    (root / "groundtruth.txt").write_text("# ground truth\n" + "\n".join(gt) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory, views):
    world, poses, images = views
    root = tmp_path_factory.mktemp("kitti")
    os.makedirs(root / "image_0")
    times, rows = [], []
    for i, (T, img) in enumerate(zip(poses, images)):
        _write_png(root / "image_0" / f"{i:06d}.png", img)
        times.append(f"{i * 0.1036:.6e}")
        rows.append(" ".join(f"{v:.9e}" for v in np.linalg.inv(T)[:3].reshape(-1)))
    (root / "times.txt").write_text("\n".join(times) + "\n")
    (root / "poses.txt").write_text("\n".join(rows) + "\n")
    (root / "calib.txt").write_text(
        f"P0: {F:.12e} 0 {world.cx:.12e} 0 0 {F:.12e} {world.cy:.12e} 0 0 0 1 0\n"
        "P1: 7.0e+02 0 6.0e+02 -3.8e+02 0 7.0e+02 1.8e+02 0 0 0 1 0\n")
    return str(root)


@pytest.fixture(scope="module")
def euroc(tmp_path_factory, views):
    world, poses, images = views
    root = tmp_path_factory.mktemp("euroc")
    cam = root / "mav0" / "cam0"
    gt = root / "mav0" / "state_groundtruth_estimate0"
    os.makedirs(cam / "data")
    os.makedirs(gt)
    csv, gt_lines = ["#timestamp [ns],filename"], ["#timestamp, p_RS_R_x [m], ..."]
    for i, (T, img) in enumerate(zip(poses, images)):
        ns = 1403636579763555584 + i * 50_000_000
        _write_png(cam / "data" / f"{ns}.png", img)
        csv.append(f"{ns},{ns}.png")
        Ow = -(T[:3, :3].T @ T[:3, 3])
        gt_lines.append(f"{ns},{Ow[0]},{Ow[1]},{Ow[2]},{QW},0.1,0.2,0.3,0,0,0")
    (cam / "data.csv").write_text("\n".join(csv) + "\n")
    (cam / "sensor.yaml").write_text(
        "sensor_type: camera\ncamera_model: pinhole\n"
        f"intrinsics: [{F}, {F * 1.01}, {world.cx}, {world.cy}]\n"
        "distortion_model: radial-tangential\n")
    (gt / "data.csv").write_text("\n".join(gt_lines) + "\n")
    return str(root)


@pytest.mark.parametrize("dataset", ["tum", "kitti", "euroc"])
@pytest.mark.parametrize("prefetch", [4, 0])
def test_frames_equal_jax(request, views, dataset, prefetch):
    root = request.getfixturevalue(dataset)
    got = list(pd.LOADERS[dataset](root, prefetch=prefetch))
    want = list(jd.LOADERS[dataset](root, prefetch=prefetch))
    assert len(got) == len(want) == N
    assert [f.timestamp for f in got] == [f.timestamp for f in want]
    for f, w, img in zip(got, want, views[2]):
        assert f.image.dtype == np.float32 and f.image.shape == (H, W)
        np.testing.assert_array_equal(f.image, w.image)
        np.testing.assert_array_equal(f.image, img.astype(np.uint8))


@pytest.mark.parametrize("dataset", ["tum", "kitti", "euroc"])
def test_groundtruth_equals_jax(request, views, dataset):
    root = request.getfixturevalue(dataset)
    t, p, q = pd.GROUNDTRUTH_LOADERS[dataset](root)
    jt, jp, jq = jd.GROUNDTRUTH_LOADERS[dataset](root)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    assert len(t) == N and np.allclose(np.linalg.norm(q, axis=1), 1.0)
    if dataset == "kitti":
        assert q.dtype == np.float64
        np.testing.assert_allclose(q, jq, atol=1e-6)
        _, poses, _ = views
        Ow = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
        np.testing.assert_allclose(p, Ow, atol=1e-5)
    else:
        np.testing.assert_array_equal(q, jq)


@pytest.mark.parametrize("dataset", ["kitti", "euroc"])
def test_calibration_equals_jax(request, views, dataset):
    root = request.getfixturevalue(dataset)
    world = views[0]
    got = pd.CALIB_LOADERS[dataset](root)
    assert got == jd.CALIB_LOADERS[dataset](root)
    fy = F * 1.01 if dataset == "euroc" else F
    assert got == (F, fy, world.cx, world.cy)


def test_loader_tables_match_jax():
    for name in ("LOADERS", "GROUNDTRUTH_LOADERS", "CALIB_LOADERS"):
        assert sorted(getattr(pd, name)) == sorted(getattr(jd, name))
