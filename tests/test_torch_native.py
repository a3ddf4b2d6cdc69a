"""The port's native runtime (native/) against the JAX package's.

  * the observation graph's raw API (tests/test_native_graph.py's calls);
  * `KeyFrame.update_connections` on twin worlds built by the same calls in
    both packages, each over its own native graph: equal weights, ordered
    covisibles and parents, also where no pair reaches the threshold of 15
    and the single connection goes to the first maximum in the library's
    answer order;
  * a map point fused into two pixels of one keyframe: the port's default
    map counts it once, as the JAX default (native) map does, and the port's
    Python scan counts it twice, as the JAX Python scan does;
  * the graph through `set_bad_flag`, `replace` and `Map.clear`, against the
    JAX graph after the same calls;
  * a checkpoint written from a native-graph map and loaded into one gives
    the source's covisibility (the loader keys the keyframe registry by the
    restored ids), as does a map rebuilt by `convert.map_from_snapshot`;
  * `frameio.decode` of gray and RGB PNG and of PGM P5 and P2, bit-equal to
    the JAX `frameio.decode` and to PIL; the prefetcher's order, and the
    per-frame PIL fallback on a palette PNG;
  * chip_smoke's stdlib PNG writer: the native decoder and PIL read its
    files back bit-exact;
  * two processes that build the libraries at once into one fresh directory
    both load them.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.io import datasets as jdatasets
from mono_slam_framework_tpu.native import frameio as jfio
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_torch import convert, native
from mono_slam_framework_torch.io import checkpoint as pckpt
from mono_slam_framework_torch.io import datasets as pdatasets
from mono_slam_framework_torch.native import frameio as pfio
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import map_model as pmm

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
PORT = (pmm, pframe)
JAX = (jmm, jframe)


def _reset(pkg):
    mm, fr = pkg
    fr.reset_frame_ids()
    mm.reset_map_ids()


def make_kf(pkg, map_, t):
    mm, fr = pkg
    f = fr.Frame(np.zeros((240, 320), np.float32), 0.0, K)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    f.set_pose(T)
    kf = mm.KeyFrame(f, map_, None)
    map_.add_keyframe(kf)
    return kf


def observe(mp, kf, kp):
    mp.add_observation(kf, kp)
    kf.add_map_point(mp, kp)


def build_world(pkg, map_, seed=7, n_kf=6, n_mp=300):
    """test_native_graph.py's world: every point seen by 2-4 keyframes."""
    mm, _ = pkg
    rng = np.random.default_rng(seed)
    kfs = [make_kf(pkg, map_, (i, 0, 0)) for i in range(n_kf)]
    mps = []
    for j in range(n_mp):
        mp = mm.MapPoint(rng.normal(size=3) + [0, 0, 5], kfs[0], map_)
        map_.add_map_point(mp)
        for o in rng.choice(n_kf, size=rng.integers(2, 5), replace=False):
            observe(mp, kfs[o], (int(j % 300), int(o)))
        mps.append(mp)
    return kfs, mps


def covis(kfs):
    """Per keyframe: ({other id: weight}, ordered covisible ids, parent id)."""
    return [({k.id: w for k, w in kf.connections.items()},
             [k.id for k in kf.ordered_covisibles],
             None if kf.parent is None else kf.parent.id) for kf in kfs]


def twins(build, native_port=True, native_jax=True):
    """The same build on a port map and a JAX map, ids reset before each."""
    out = []
    for pkg, mm, use in ((PORT, pmm, native_port), (JAX, jmm, native_jax)):
        _reset(pkg)
        map_ = mm.Map(use_native_graph=use)
        assert (map_.obs_graph is not None) == use
        out.append((map_, *build(pkg, map_)))
    return out


# ---------------------------------------------------------------------------
# the observation graph


def test_raw_api():
    assert native.available(), native.build_errors
    g = native.ObservationGraph()
    assert g.add(1, 10)
    assert not g.add(1, 10)  # duplicate
    g.add(1, 11)
    g.add(2, 10)
    assert g.covis_counts(10) == {11: 1}
    assert g.n_obs_kf(10) == 2
    g.erase(1, 10)
    assert g.covis_counts(10) == {}
    g.add(1, 10)
    g.erase_map_point(1)
    assert g.n_obs_mp(1) == 0
    g.add(3, 12)
    g.erase_keyframe(12)
    assert g.n_obs_mp(3) == 0 and g.n_obs_kf(12) == 0
    # more partners than the first buffer holds: the query grows and retries
    for kf in range(300):
        g.add(7, 1000 + kf)
    counts = g.covis_counts(1000)
    assert len(counts) == 299 and set(counts.values()) == {1}
    g.clear()
    assert g.n_obs_kf(10) == 0


def test_port_map_uses_the_native_graph_by_default():
    assert pmm.Map().obs_graph is not None
    assert pmm.Map(use_native_graph=False).obs_graph is None


def test_update_connections_matches_jax_native():
    (pm, pk, _), (jm, jk, _) = twins(build_world)
    for p, j in zip(pk, jk):
        p.update_connections()
        j.update_connections()
    assert covis(pk) == covis(jk)
    assert all(c[0] for c in covis(pk))  # every keyframe has connections


def _sparse_world(pkg, map_):
    """Keyframe 3 shares 4 points with keyframe 1 and 4 with keyframe 2 and
    fewer with 0: no pair reaches 15, so keyframe 3's single connection and
    its parent go to the first maximum in the counter's order."""
    mm, _ = pkg
    kfs = [make_kf(pkg, map_, (i, 0, 0)) for i in range(4)]
    j = 0
    for other, n in ((2, 4), (0, 2), (1, 4)):
        for _ in range(n):
            mp = mm.MapPoint(np.array([0, 0, 5.0]), kfs[3], map_)
            map_.add_map_point(mp)
            observe(mp, kfs[3], (j, 3))
            observe(mp, kfs[other], (j, other))
            j += 1
    return kfs, None


def test_tie_goes_to_the_same_keyframe_as_jax():
    (pm, pk, _), (jm, jk, _) = twins(_sparse_world)
    pk[3].update_connections()
    jk[3].update_connections()
    assert covis(pk) == covis(jk)
    assert pk[3].parent.id in (1, 2) and pk[3].get_weight(pk[pk[3].parent.id]) == 4
    # the single connection back from the chosen keyframe
    back = [kf.id for kf in pk[:3] if kf.get_weight(pk[3])]
    assert back == [pk[3].parent.id]


def _fused_world(pkg, map_):
    """Keyframe 1 shares 14 points with keyframe 0, and one more point that
    fused into two of keyframe 1's pixels: 15 distinct points, 16 pixels."""
    mm, _ = pkg
    kfs = [make_kf(pkg, map_, (i, 0, 0)) for i in range(3)]
    for j in range(15):
        mp = mm.MapPoint(np.array([0, 0, 5.0]), kfs[0], map_)
        map_.add_map_point(mp)
        observe(mp, kfs[0], (j, 0))
        observe(mp, kfs[1], (j, 1))
        if j < 3:
            observe(mp, kfs[2], (j, 2))
    observe(mp, kfs[1], (40, 1))  # the same point at a second pixel
    assert len(mp.observations) == 2 and mp.n_obs == 2
    return kfs, None


def test_fused_point_counts_once_as_in_the_jax_default():
    """The covisibility fault of the Python scan: the port's default map
    (native) weighs keyframes 0-1 by distinct points as the JAX default map
    does; the Python scan of either package counts the fused point twice."""
    weights = {}
    for native_port, native_jax in ((True, True), (False, False)):
        (pm, pk, _), (jm, jk, _) = twins(_fused_world, native_port, native_jax)
        pk[1].update_connections()
        jk[1].update_connections()
        assert covis(pk) == covis(jk)
        weights[native_port] = pk[1].get_weight(pk[0])
    assert weights == {True: 15, False: 16}


def test_cascades_match_jax():
    (pm, pk, pp), (jm, jk, jp) = twins(build_world)
    for p, j in zip(pk, jk):
        p.update_connections()
        j.update_connections()

    def graph_counts(m, kfs, mps):
        g = m.obs_graph
        return ([g.n_obs_kf(kf.id) for kf in kfs], [g.n_obs_mp(mp.id) for mp in mps],
                [g.covis_counts(kf.id) for kf in kfs])

    pp[0].set_bad_flag()
    jp[0].set_bad_flag()
    assert pm.obs_graph.n_obs_mp(pp[0].id) == 0
    pp[1].replace(pp[2])
    jp[1].replace(jp[2])
    assert pm.obs_graph.n_obs_mp(pp[1].id) == 0
    assert pm.obs_graph.n_obs_mp(pp[2].id) == pp[2].n_obs
    assert graph_counts(pm, pk, pp) == graph_counts(jm, jk, jp)
    pk[2].set_bad_flag()
    jk[2].set_bad_flag()
    assert graph_counts(pm, pk, pp) == graph_counts(jm, jk, jp)
    for p, j in zip(pk, jk):
        if not p.is_bad:
            p.update_connections()
            j.update_connections()
    assert covis(pk) == covis(jk)
    pm.clear()
    assert pm.obs_graph.n_obs_kf(pk[0].id) == 0 and not pm.kf_registry


def test_checkpoint_and_snapshot_round_trips_keep_covisibility(tmp_path):
    _reset(PORT)
    src = pmm.Map()
    kfs, _ = build_world(PORT, src)
    for kf in kfs:
        kf.update_connections()
    want = {kf.id: w for kf, (w, _, _) in zip(kfs, covis(kfs))}
    path = str(tmp_path / "map.npz")
    pckpt.save_map(path, src)

    # a process that has made keyframes since: fresh ids differ from the file's
    got = pmm.Map()
    pckpt.load_map(path, got, None, None)
    assert got.obs_graph is not None
    assert {kf.id: w for kf, (w, _, _) in
            zip(got.all_keyframes(), covis(got.all_keyframes()))} == want

    # the rebuilt map's graph answers as the source's (the snapshot carries
    # the connections themselves)
    rebuilt, rkfs, _ = convert.map_from_snapshot(convert.snapshot_map(src))
    assert rebuilt.obs_graph is not None
    assert {k: rebuilt.obs_graph.covis_counts(k) for k in rkfs} == want
    for kf in rkfs.values():
        kf.connections = {}
        kf.update_connections()
    assert {k: w for k, (w, _, _) in zip(rkfs, covis(list(rkfs.values())))} == want


# ---------------------------------------------------------------------------
# frame IO


def _write_png(path, arr, mode):
    from PIL import Image

    Image.fromarray(arr, mode).save(path)


def _pil_gray(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("frames")
    paths = {}
    paths["gray_png"] = str(d / "gray.png")
    _write_png(paths["gray_png"], rng.integers(0, 256, (48, 64), np.uint8), "L")
    paths["rgb_png"] = str(d / "rgb.png")
    _write_png(paths["rgb_png"], rng.integers(0, 256, (32, 40, 3), np.uint8), "RGB")
    pgm = rng.integers(0, 256, (20, 30), np.uint8)
    paths["pgm_p5"] = str(d / "p5.pgm")
    with open(paths["pgm_p5"], "wb") as f:
        f.write(b"P5\n# comment\n30 20\n255\n" + pgm.tobytes())
    paths["pgm_p2"] = str(d / "p2.pgm")
    with open(paths["pgm_p2"], "w") as f:
        f.write("P2\n30 20\n255\n" + "\n".join(" ".join(map(str, r)) for r in pgm) + "\n")
    paths["palette_png"] = str(d / "palette.png")
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (24, 32, 3), np.uint8), "RGB").convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=16).save(paths["palette_png"])
    return paths


@pytest.fixture(scope="module")
def jax_frameio():
    """The JAX package's frameio, loaded. Its loader builds the library in
    place, so processes that import it at once (pytest's workers) can catch
    a half-written file and give up for the process; load again then, since
    the file is whole by now."""
    if jfio.load_library() is None:
        jfio._tried = False
    assert jfio.load_library() is not None
    return jfio


@pytest.mark.parametrize("name", ["gray_png", "rgb_png", "pgm_p5", "pgm_p2"])
def test_decode_equals_jax_and_pil(images, jax_frameio, name):
    got = pfio.decode(images[name])
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_frameio.decode(images[name]))
    np.testing.assert_array_equal(got, _pil_gray(images[name]))
    g = 0.77  # the gamma LUT of the native decoder, as in the JAX package
    np.testing.assert_array_equal(pfio.decode(images[name], gamma=g),
                                  jax_frameio.decode(images[name], gamma=g))


def test_decode_refuses_what_it_does_not_handle(images, tmp_path):
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image at all")
    assert pfio.decode(str(junk)) is None
    assert pfio.decode(str(tmp_path / "missing.png")) is None
    assert pfio.decode(images["palette_png"]) is None


def test_prefetcher_order_and_per_frame_fallback(images, jax_frameio):
    paths = [images[k] for k in ("gray_png", "palette_png", "rgb_png", "pgm_p5")] * 2
    got = list(pfio.FramePrefetcher(paths, ring=2))
    assert [i for i, _ in got] == list(range(len(paths)))
    assert [img is None for _, img in got] == [p == images["palette_png"] for p in paths]
    times = [0.1 * i for i in range(len(paths))]
    for prefetch in (2, 0):
        frames = list(pdatasets.stream_paths(times, paths, prefetch=prefetch))
        want = list(jdatasets.stream_paths(times, paths, prefetch=prefetch))
        assert [f.timestamp for f in frames] == [f.timestamp for f in want] == times
        for f, w, p in zip(frames, want, paths):
            np.testing.assert_array_equal(f.image, w.image)
            np.testing.assert_array_equal(f.image, _pil_gray(p))


def test_stdlib_png_writer_round_trips(tmp_path):
    import chip_smoke

    img = np.random.default_rng(5).integers(0, 256, (37, 53), np.uint8)
    path = tmp_path / "w.png"
    path.write_bytes(chip_smoke.png_gray(img))
    np.testing.assert_array_equal(pfio.decode(str(path)), img.astype(np.float32))
    np.testing.assert_array_equal(_pil_gray(str(path)), img.astype(np.float32))


BUILD = """
import pathlib, sys
from mono_slam_framework_torch import native
from mono_slam_framework_torch.native import frameio
native.BUILD_ROOT = pathlib.Path(sys.argv[1])
assert native.available(), native.build_errors
assert frameio.load_library() is not None, native.build_errors
assert native.ObservationGraph().add(1, 2)
"""


def test_two_processes_build_at_once(tmp_path):
    root = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = sorted(p.name for p in root.rglob("*") if p.is_file())
    assert built == ["libframeio.so", "libslamgraph.so"]  # no temporary left behind
