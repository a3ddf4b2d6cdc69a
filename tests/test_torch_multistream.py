"""Port parity for multi-stream serving's device step
(mono_slam_framework_torch/parallel/multistream.py), at test_multistream.py's
sizes: 120x160 images, 200 features, 2-3 streams, tables of 64 / 128, two
local keyframes.

  * `extract_batch`: each stream's Features equal `orb.extract` on that
    image bit for bit, and agree with the JAX `orb._extract_multi(interpret=
    True)` (the multi-band Pallas path that `multistream.extract_batch`
    batches) by feature set, tests/test_torch_orb.py's bars;
  * `fused_tracking.steady_core_batch`: each stream against the JAX
    `_steady_core(use_pallas_lm=False)` on the same numpy inputs (ROADMAP
    C.2: the anchor is the per-stream core, not the JAX batch step), T1 and
    T2 within atol 1e-4 (tests/test_torch_slice.py's bound for the pose
    LMs' f32 sums), every integer output equal;
  * `steady_step_batch` against the port's own `steady_step` per stream:
    every field equal (on the CPU the batched LM is the per-problem plain
    LM, and the association is integer work);
  * a group whose streams have different table sizes, padded as the server
    pads it: every field of every stream unchanged, extension rows under
    the padded ctx row space included;
  * `fused_loftr.loftr_core_batch` per stream against the JAX `_loftr_core`
    on the same features (160x320 images, L = 200 cells, so that the JAX
    pose LM compiles once for both cores), and against the port's own
    `_loftr_core`;
  * kernel B1's batched launch: its plain version against `detect_maps_plain`
    per stream here; the kernels themselves in the `cuda` tests (chip_smoke).

The state is built with numpy: each stream's current frame is its own
previous frame (the self-match of test_multistream.py), with map points
back-projected from the features at seeded depths so that both LMs work
on real associations, a few outliers, and extension rows past the ctx rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_parity import compare_feature_sets, require_cuda
from mono_slam_framework_tpu.models import loftr_native as jln
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.slam import fused_loftr as jfl
from mono_slam_framework_tpu.slam import fused_tracking as jft
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.models import loftr_native as pln
from mono_slam_framework_torch.ops import detect, orb
from mono_slam_framework_torch.parallel import multistream, server
from mono_slam_framework_torch.slam import fused_loftr, fused_tracking

H, W = 120, 160
MAXF = 200
F = 120.0
K_MAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
STATICS = dict(ratio=0.7, cols=W, width=float(W), height=float(H), use_octave_info=True)
TABLES = dict(mcap=64, rcap=128, n_ext=8, nk=2, mcap2=64)


def _images(n, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return np.stack([
        np.kron(rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32),
                np.ones((8, 8), np.float32))
        for _ in range(n)
    ])


def _stream_state(f: dict, seed: int, mcap, rcap, n_ext, nk, mcap2) -> dict:
    """One stream's steady-step state (numpy) around its features f: motion
    rows for the first valid slots (n_ext of them extension rows from rcap
    on), keyframe rows for the next ones (first proposed by keyframe slot
    0), positions back-projected at seeded depths, three outliers."""
    rng = np.random.default_rng(seed)
    slots = np.nonzero(f["valid"])[0]
    n_mo = min(mcap, 24)
    n_e = min(n_ext, n_mo)
    lo0 = n_mo - n_e  # motion ctx rows 0 .. lo0 - 1, keyframe rows from lo0
    n_lo = min(mcap2, 40, rcap - lo0)
    mo, lo = slots[:n_mo], slots[n_mo: n_mo + n_lo]
    px = lambda s: (f["xy"][s, 1].astype(np.int32) * W + f["xy"][s, 0].astype(np.int32))  # noqa: E731
    P = rcap + n_ext
    mp_pos = np.zeros((P, 3), np.float32)
    mo_rows = np.concatenate([rcap + np.arange(n_e), np.arange(lo0)])
    lo_rows = lo0 + np.arange(len(lo))
    for s, r in zip(np.concatenate([mo, lo]), np.concatenate([mo_rows, lo_rows])):
        z = rng.uniform(4.0, 8.0)
        x, y = f["xy"][s]
        mp_pos[r] = [(x - K_MAT[0, 2]) * z / F, (y - K_MAT[1, 2]) * z / F, z]
    mp_pos[mo_rows[-3:]] += rng.uniform(0.5, 1.0, (3, 3)).astype(np.float32)  # outliers
    prev_px = np.full(mcap, -1, np.int32)
    prev_row = np.full(mcap, -1, np.int32)
    prev_px[:n_mo], prev_row[:n_mo] = px(mo), mo_rows
    kf_px = np.full((nk, mcap2), -1, np.int32)
    kf_row = np.full((nk, mcap2), -1, np.int32)
    kf_px[0, : len(lo)], kf_row[0, : len(lo)] = px(lo), lo_rows
    if nk > 1:
        kf_px[-1, :10], kf_row[-1, :10] = px(lo[::4][:10]), lo_rows[::4][:10]
    first_slot = np.full(rcap, -1, np.int32)
    first_slot[lo_rows] = 0
    normal = np.zeros((rcap, 3), np.float32)
    d = mp_pos[:rcap] / np.maximum(np.linalg.norm(mp_pos[:rcap], axis=1, keepdims=True), 1e-9)
    normal[first_slot >= 0] = d[first_slot >= 0]
    maxdist = np.where(first_slot >= 0, 1.5 * np.linalg.norm(mp_pos[:rcap], axis=1), 0.0)
    T_init = np.eye(4, dtype=np.float32)
    T_init[:3, 3] = rng.normal(0, 0.01, 3)
    kf = {k: np.stack([v] * nk) for k, v in f.items()}
    return {"prev": f, "prev_px": prev_px, "prev_row": prev_row, "mp_pos": mp_pos,
            "T_init": T_init, "kf": kf, "kf_px": kf_px, "kf_row": kf_row,
            "first_slot": first_slot, "normal": normal, "maxdist": maxdist.astype(np.float32),
            "K": K_MAT}


ORDER = ("prev", "prev_px", "prev_row", "mp_pos", "T_init", "kf", "kf_px", "kf_row",
         "first_slot", "normal", "maxdist", "K")


def _port_args(st: dict):
    return tuple(convert.features_from_numpy(st[k], device="cpu") if isinstance(st[k], dict)
                 else torch.from_numpy(np.array(st[k])) for k in ORDER)


def _batch_args(states: list):
    """Equal-shaped streams' states stacked [N, ...] (port tensors)."""
    per = [_port_args(st) for st in states]
    return tuple(orb.Features(*(torch.stack(xs) for xs in zip(*col)))
                 if isinstance(col[0], orb.Features) else torch.stack(col)
                 for col in zip(*per))


def _features(fb: orb.Features, i: int) -> orb.Features:
    return orb.Features(*(x[i] for x in fb))


@pytest.fixture(scope="module")
def batch3():
    imgs = _images(3)
    return imgs, multistream.extract_batch(torch.from_numpy(imgs), MAXF)


@pytest.fixture(scope="module")
def states(batch3):
    _, feats = batch3
    return [_stream_state(convert.features_to_numpy(_features(feats, i)), 10 + i, **TABLES)
            for i in range(3)]


def _fields(out: fused_tracking.SteadyOut) -> dict:
    return {**fused_tracking.steady_fields(out), "n_good1": out.motion.n_good,
            "n_good2": out.local.n_good, "chain_px": out.chain_px, "union_row": out.union_row}


def test_extract_batch_equals_single_stream(batch3):
    imgs, feats = batch3
    assert feats.xy.shape == (3, MAXF, 2)
    for i in range(3):
        one = orb.extract(torch.from_numpy(imgs[i]), MAXF)
        for name, a, b in zip(orb.Features._fields, _features(feats, i), one):
            assert torch.equal(a, b), (i, name)
    assert not torch.equal(feats.xy[0], feats.xy[2])


def test_extract_batch_matches_jax_multi(batch3):
    imgs, feats = batch3
    extract = jax.jit(jorb._extract_multi,
                      static_argnames=("max_features", "fast_threshold", "interpret"))
    for i in (0, 2):
        ref = extract(jnp.asarray(imgs[i]), max_features=MAXF, fast_threshold=20.0,
                      interpret=True)
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
        got = convert.features_to_numpy(_features(feats, i))
        compare_feature_sets(got, ref)
        assert got["valid"].sum() > 100


def _jax_unpack(packed, k, r):
    """The JAX steady core's packed layout (fused_tracking._steady_core)."""
    p = np.asarray(packed)
    blk = p[18: 18 + 8 * k].reshape(8, k)
    off = 18 + 8 * k
    return {"T1": p[:16].reshape(4, 4), "n_good1": p[16], "n_matches": p[17],
            "row": blk[0].astype(np.int64), "keep": blk[1] > 0.5, "inlier": blk[2] > 0.5,
            "idx2": blk[3].astype(np.int64), "ok": blk[4] > 0.5,
            "T2": p[off: off + 16].reshape(4, 4), "n_good2": p[off + 16],
            "new_row": p[off + 17: off + 17 + k].astype(np.int64),
            "inlier2": p[off + 17 + k: off + 17 + 2 * k] > 0.5,
            "vis": p[off + 17 + 2 * k: off + 17 + 2 * k + r] > 0.5}


def test_steady_core_batch_matches_jax_per_stream(batch3, states):
    _, feats = batch3
    n = 2
    out = fused_tracking.steady_core_batch(
        orb.Features(*(x[:n] for x in feats)), *_batch_args(states[:n]), **STATICS)
    for i in range(n):
        st = states[i]
        jx = [jorb.Features(**{k: jnp.asarray(v) for k, v in st[k].items()})
              if isinstance(st[k], dict) else jnp.asarray(st[k]) for k in ORDER]
        # eager: its pose LM compiles once per edge count, shared with the
        # LoFTR test below (L = 200 cells = MAXF slots)
        _, packed, chain_px, union_row, _ = jft._steady_core(
            jx[0], *jx, **STATICS, use_pallas_lm=False)
        ref = _jax_unpack(packed, MAXF, TABLES["rcap"])
        np.testing.assert_allclose(out.motion.T1[i].numpy(), ref["T1"], atol=1e-4)
        np.testing.assert_allclose(out.local.T2[i].numpy(), ref["T2"], atol=1e-4)
        for name, got in (("row", out.motion.row), ("keep", out.motion.keep),
                          ("inlier", out.motion.inlier), ("idx2", out.motion.idx2),
                          ("ok", out.motion.ok), ("new_row", out.local.new_row),
                          ("inlier2", out.local.inlier), ("vis", out.local.vis)):
            np.testing.assert_array_equal(got[i].numpy(), ref[name], err_msg=f"{i} {name}")
        for name, got in (("n_good1", out.motion.n_good), ("n_good2", out.local.n_good),
                          ("n_matches", out.motion.n_matches)):
            assert int(got[i]) == int(ref[name]), (i, name)
        np.testing.assert_array_equal(out.chain_px[i].numpy(), np.asarray(chain_px))
        np.testing.assert_array_equal(out.union_row[i].numpy(), np.asarray(union_row))
        # both phases did real work: motion rows (extension rows among them),
        # motion outliers, new keyframe rows, visible candidates
        row = out.motion.row[i]
        assert int((row >= TABLES["rcap"]).sum()) >= 4 and int((row >= 0).sum()) >= 20
        assert int((out.motion.keep[i] & ~out.motion.inlier[i]).sum()) >= 1
        assert int((out.local.new_row[i] >= 0).sum()) >= 20 and int(out.local.vis[i].sum()) >= 20


def test_steady_step_batch_equals_single_steps(states):
    imgs = _images(2, seed=5)
    args = _batch_args(states[:2])
    out = multistream.steady_step_batch(torch.from_numpy(imgs), *args, **STATICS,
                                        max_features=MAXF, fast_threshold=20.0)
    for i in range(2):
        one = fused_tracking.steady_step(
            torch.from_numpy(imgs[i]), *_port_args(states[i]), **STATICS,
            max_features=MAXF, fast_threshold=20.0)
        for name, a in _fields(out).items():
            b = _fields(one)[name]
            assert torch.equal(a[i], b.to(a.dtype)), (i, name)
        for name, a, b in zip(orb.Features._fields, _features(out.cur, i), one.cur):
            assert torch.equal(a, b), (i, name)


def test_padded_group_keeps_every_stream(batch3):
    """Three streams with different table sizes, padded to one group with the
    server's fills and floors: each stream's fields equal its own unpadded
    core's. Stream 0's extension rows (from its rcap of 40 on) lie under the
    group's padded ctx row space of 128 and stay invisible (first_slot -1)."""
    _, feats = batch3
    sizes = [dict(mcap=40, rcap=40, n_ext=12, nk=1, mcap2=48),
             dict(mcap=64, rcap=128, n_ext=0, nk=2, mcap2=64),
             dict(mcap=30, rcap=100, n_ext=5, nk=3, mcap2=40)]
    sts = [_stream_state(convert.features_to_numpy(_features(feats, i)), 20 + i, **sz)
           for i, sz in enumerate(sizes)]
    singles = [fused_tracking._steady_core(_features(feats, i), *_port_args(st), **STATICS)
               for i, st in enumerate(sts)]
    per = [_port_args(st) for st in sts]
    caps = dict(m=80, p=140, r=128, nk=4, m2=64)  # the larger of floor and group
    fs = [p[0] for p in per]
    out = fused_tracking.steady_core_batch(
        feats,
        orb.Features(*(torch.stack(xs) for xs in zip(*fs))),
        server._pad_stack([p[1] for p in per], (caps["m"],), -1),
        server._pad_stack([p[2] for p in per], (caps["m"],), -1),
        server._pad_stack([p[3] for p in per], (caps["p"], 3), 0.0),
        torch.stack([p[4] for p in per]),
        orb.Features(*(torch.stack([server._pad_slots(x, caps["nk"]) for x in xs])
                       for xs in zip(*(p[5] for p in per)))),
        server._pad_stack([p[6] for p in per], (caps["nk"], caps["m2"]), -1),
        server._pad_stack([p[7] for p in per], (caps["nk"], caps["m2"]), -1),
        server._pad_stack([p[8] for p in per], (caps["r"],), -1),
        server._pad_stack([p[9] for p in per], (caps["r"], 3), 0.0),
        server._pad_stack([p[10] for p in per], (caps["r"],), 0.0),
        torch.stack([p[11] for p in per]),
        **STATICS,
    )
    for i, (one, st) in enumerate(zip(singles, sts)):
        r = len(st["first_slot"])
        for name, a in _fields(out).items():
            b = _fields(one)[name]
            a = a[i][:r] if name == "vis" else a[i]
            assert torch.equal(a, b.to(a.dtype)), (i, name)
        assert not out.local.vis[i][r:].any()
        assert int((out.local.new_row[i] >= 0).sum()) >= 10, i
    # the case the pads must cover: stream 0's extension rows were associated
    # in the motion phase and lie under the padded ctx rows (40 <= row < 128)
    row0 = out.motion.row[0]
    assert int(((row0 >= 40) & (row0 < caps["r"]) & out.motion.keep[0]).sum()) >= 10


# ---------------------------------------------------------------------------
# LoFTR at 160x320 (L = 200 cells), on the port's encode of the same images

H2, W2 = 160, 320
L2 = (H2 // 16) * (W2 // 16)


@pytest.fixture(scope="module")
def loftr_inputs():
    return _loftr_inputs()


def _loftr_inputs():
    """Two streams' LoFTR core inputs (numpy) around the port's encode of
    their 160x320 images: motion rows for the even cells, keyframe rows for
    the odd ones (keyframe slot 0 holds the stream's own features)."""
    model = pln.load_model(device="cpu")
    imgs = _images(2, seed=11, h=H2, w=W2)
    f = pln.encode(model, torch.from_numpy(imgs)[:, None] / 255.0)  # [2, L, C]
    n, nk, rcap = 2, 2, 224
    rng = np.random.default_rng(13)
    gw = W2 // 16
    cells = np.arange(L2)
    cell_uv = np.stack([(cells % gw) * 16, (cells // gw) * 16], -1).astype(np.float32)
    prev_cellrow = np.full((n, L2), -1, np.int32)
    kf_cellrow = np.full((n, nk, L2), -1, np.int32)
    mp_pos = np.zeros((n, rcap + 4, 3), np.float32)
    first_slot = np.full((n, rcap), -1, np.int32)
    for i in range(n):
        z = rng.uniform(4.0, 8.0, L2)
        mp_pos[i, :L2] = np.stack([(cell_uv[:, 0] - W2 / 2) * z / 100.0,
                                   (cell_uv[:, 1] - H2 / 2) * z / 100.0, z], -1)
        prev_cellrow[i, ::2] = np.arange(0, L2, 2)
        kf_cellrow[i, 0, 1::2] = np.arange(1, L2, 2)
        first_slot[i, 1:L2:2] = 0
    normal = mp_pos[:, :rcap] / np.maximum(
        np.linalg.norm(mp_pos[:, :rcap], axis=-1, keepdims=True), 1e-9)
    maxdist = 1.5 * np.linalg.norm(mp_pos[:, :rcap], axis=-1)
    K = np.broadcast_to(np.array([[100.0, 0, W2 / 2], [0, 100.0, H2 / 2], [0, 0, 1]],
                                 np.float32), (n, 3, 3)).copy()
    fn = f.numpy()
    args = dict(f_cur=fn, f_prev=fn, prev_cellrow=prev_cellrow, mp_pos=mp_pos,
                T_init=np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy(),
                kf_feats=np.stack([fn, fn[::-1]], 1), kf_cellrow=kf_cellrow,
                first_slot=first_slot, ctx_normal=normal.astype(np.float32),
                ctx_maxdist=maxdist.astype(np.float32), cell_uv=cell_uv, K=K)
    return model, args


LOFTR_ORDER = ("f_prev", "prev_cellrow", "mp_pos", "T_init", "kf_feats", "kf_cellrow",
               "first_slot", "ctx_normal", "ctx_maxdist")


def test_loftr_core_batch_matches_jax_and_single(loftr_inputs):
    model, a = loftr_inputs
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    out, union_row, T2 = fused_loftr.loftr_core_batch(
        t["f_cur"], model, *(t[k] for k in LOFTR_ORDER), t["cell_uv"], t["K"],
        1.0 / 64.0, 0.1, float(W2), float(H2))
    jp = jln.load_params()
    for i in range(2):
        one, u1, _ = fused_loftr._loftr_core(
            t["f_cur"][i: i + 1], model, t["f_prev"][i: i + 1],
            *(t[k][i] for k in LOFTR_ORDER[1:]), t["cell_uv"], t["K"][i],
            1.0 / 64.0, 0.1, float(W2), float(H2))
        for name in fused_loftr.FIELDS:
            b = getattr(one, name)
            got = getattr(out, name)[i]
            if name in ("T1", "T2"):
                np.testing.assert_allclose(got.numpy(), b.numpy(), atol=1e-5, err_msg=name)
            else:
                assert torch.equal(got, b.to(got.dtype)), (i, name)
        assert torch.equal(union_row[i], u1.to(union_row.dtype))
        # eager, as tests/test_torch_fused_loftr.py runs it
        _, packed, _, _ = jfl._loftr_core(
            jnp.asarray(a["f_cur"][i: i + 1]), jp, jnp.asarray(a["f_prev"][i: i + 1]),
            *(jnp.asarray(a[k][i]) for k in LOFTR_ORDER[1:]), jnp.asarray(a["cell_uv"]),
            jnp.asarray(a["K"][i]), jnp.float32(1.0 / 64.0), 0.1, float(W2), float(H2),
            use_pallas_lm=False)
        p = np.asarray(packed)
        blk = p[18: 18 + 4 * L2].reshape(4, L2)
        off = 18 + 4 * L2
        np.testing.assert_allclose(out.T1[i].numpy(), p[:16].reshape(4, 4), atol=1e-4)
        np.testing.assert_allclose(out.T2[i].numpy(), p[off: off + 16].reshape(4, 4), atol=1e-4)
        ref = {"row": blk[0], "okm": blk[1] > 0.5, "inlier1": blk[2] > 0.5, "j1": blk[3],
               "new_row": p[off + 17: off + 17 + L2],
               "inlier2": p[off + 17 + L2: off + 17 + 2 * L2] > 0.5,
               "vis": p[off + 17 + 2 * L2:] > 0.5}
        for name, r in ref.items():
            np.testing.assert_array_equal(getattr(out, name)[i].numpy(), r.astype(
                bool if r.dtype == bool else np.int64), err_msg=f"{i} {name}")
        assert int(out.n_matches[i]) == int(p[17]) >= 20
        assert int((out.row[i] >= 0).sum()) >= 10 and int((out.new_row[i] >= 0).sum()) >= 10


def test_loftr_batch_checks_the_resize():
    with pytest.raises(ValueError, match="resize_hw"):
        multistream.steady_step_loftr_batch(
            torch.zeros(2, H2, W2), None, *([None] * 11), 1.0, 0.1, float(W2), float(H2),
            resize_hw=None)


# ---------------------------------------------------------------------------
# kernel B1 over N streams in one launch


def test_b1_batch_plain_is_per_stream_plain(batch3):
    imgs, _ = batch3
    dims = orb._level_dims(H, W)
    stacks = torch.stack([orb.pyramid(torch.from_numpy(img)) for img in imgs])
    assert stacks.shape == (3, detect.level_layout(dims)[1], W)
    got = detect.detect_maps_batch(stacks, dims, 20.0, orb.BORDER)
    for i in range(3):
        ref = detect.detect_maps_plain(stacks[i], dims, 20.0, orb.BORDER)
        for name, a, b in zip(detect.DetectMaps._fields, got, ref):
            assert torch.equal(a[i], b), (i, name)
    with pytest.raises(ValueError, match="CUDA"):
        detect.detect_maps_batch_cuda(stacks, dims)
    with pytest.raises(ValueError, match="layout"):
        detect.detect_maps_batch_plain(stacks[:, :-1], dims)


@pytest.mark.cuda
def test_kernel_b1_batch_matches_plain():
    require_cuda()
    import chip_smoke

    imgs = _images(4, seed=2, h=480, w=640)
    rec = chip_smoke.check_b1_batch(imgs, torch.device("cuda"))
    assert rec["streams"] == 4


@pytest.mark.cuda
def test_kernel_b2_batch_matches_plain():
    require_cuda()
    import chip_smoke

    rec = chip_smoke.check_b2_batch(torch.device("cuda"), 8)
    assert rec["problems"] == 8
