"""SlamServer: N camera streams, each a full System, served per tick with
their steady frames batched into ONE device call and ONE readback.

PyTorch counterpart of `mono_slam_framework_tpu/parallel/server.py`. The
reference serves one camera per process (src/main.cpp:100-188);
`parallel/multistream.py` runs N streams' steady tracking as one batched
call, and this module is the host orchestration around it:

  * every stream is a complete, independent `System` (own map, tracker,
    local mapper, loop closer, matcher feature cache); initialization,
    keyframe events, relocalization and loop closure run per stream through
    the normal host paths;
  * at each tick, the streams whose trackers are in the fused steady state
    (a device-resident chain from the previous frame under an unchanged
    local-map ctx: `fused_host.prepare_spec_inputs`, or the LoFTR twin) are
    grouped by `key` (the kind of step, its statics and the image shape).
    A group's tables are padded to common sizes, at least the capacity
    floors, with fills that change no stream's result, and the group is
    dispatched as ONE `multistream.steady_step_batch` (or
    `steady_step_loftr_batch`) call: one B1 launch and two B2 launches for
    the whole group. Its results come back through ONE shared
    `fused_tracking.HostCopy` (one CUDA event, one wait), and each stream's
    spec reads its row of it lazily in `run_steady`'s speculative branch,
    exactly as the pipelined mode's dispatch is consumed;
  * a group of one takes the single-stream `dispatch_prepared`; streams
    that do not qualify this tick (initializing, just after a keyframe
    event, lost) simply run their own `track_monocular`. The server never
    changes per-stream semantics: it batches the device work and shares the
    readback.

A group is dispatched at its own size: the JAX package pads the batch to a
power of two to bound its executable count, and the port compiles nothing
per shape. Trajectory semantics per stream are those of the pipelined
dispatch (the device-side velocity model `chain_T_init`), held by
tests/test_torch_server.py against independently run Systems.

The JAX package's multi-device pieces (the mesh-sharded batch steps, the
sharded sweeps and bundle adjustment) are not part of this module.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Sequence

import numpy as np
import torch

from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.matchers.loftr_matcher import LoftrFeatureMatcher
from mono_slam_framework_torch.ops import orb
from mono_slam_framework_torch.parallel import multistream
from mono_slam_framework_torch.slam import fused_host, fused_loftr, fused_tracking
from mono_slam_framework_torch.slam.kfdb import KeyFrameMatchDatabase
from mono_slam_framework_torch.slam.system import System

MAX_SAMPLES = 4096  # a long-running server keeps at most this many samples per list


def _sample(stats: dict, name: str, ms: float) -> None:
    """Add ms to stats[name] and to its bounded samples list."""
    stats[name] = stats.get(name, 0.0) + ms
    samples = stats.setdefault(f"{name.replace('_ms', '')}_samples_ms", [])
    samples.append(ms)
    if len(samples) > MAX_SAMPLES:
        del samples[: MAX_SAMPLES // 2]


class _GroupReadback:
    """ONE device->host copy of a group's batched fields, shared by its
    streams (the counterpart of the JAX package's `_LazyBatchFetch`). The
    copy starts at dispatch; the first stream that replays waits on its one
    event, and every stream reads its row from the same host arrays."""

    def __init__(self, fields: dict, stats: dict):
        self._copy = fused_tracking.HostCopy(fields)
        self._host = None
        self._stats = stats

    def _wait(self) -> dict:
        if self._host is None:
            t0 = time.perf_counter()
            self._host = self._copy.wait()
            self._copy = None
            _sample(self._stats, "readback_ms", (time.perf_counter() - t0) * 1e3)
        return self._host

    def row(self, j: int) -> "_Row":
        return _Row(self, j)


class _Row:
    """Stream j's readback: `wait()` gives its fields as numpy, as a
    HostCopy's `wait()` does for one stream."""

    def __init__(self, group: _GroupReadback, j: int):
        self._group, self._j = group, j

    def wait(self) -> dict:
        return {k: v[self._j] for k, v in self._group._wait().items()}


def _pad_stack(tensors, shape, fill):
    """[N, *shape]: tensor j in the leading corner of row j, `fill` around
    it (device work only, no synchronization)."""
    t0 = tensors[0]
    if all(tuple(t.shape) == tuple(shape) for t in tensors):
        return torch.stack(tensors)
    out = torch.full((len(tensors), *shape), fill, dtype=t0.dtype, device=t0.device)
    for j, t in enumerate(tensors):
        out[(j, *(slice(0, s) for s in t.shape))] = t
    return out


def _pad_slots(x, n: int):
    """A keyframe stack [n_kf, ...] padded to n slots with copies of slot 0
    (a real keyframe's features: a padded slot is never active)."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[:1].expand(n - x.shape[0], *x.shape[1:])])


def _stack_features(feats) -> orb.Features:
    return orb.Features(*(torch.stack(xs) for xs in zip(*feats)))


class SlamServer:
    """Serve N independent monocular streams on one card.

    Parameters
    ----------
    parameters: a `SlamParameters` template, deep-copied per stream.
    matcher_factory: zero-argument callable returning a fresh FeatureMatcher
        per stream (each stream needs its own feature cache), on `device`.
    n_streams: number of streams to serve.
    keyframe_database_factory: optional callable(matcher) -> KeyFrameDatabase;
        defaults to `KeyFrameMatchDatabase(matcher)`.
    cap_floors: the least sizes a group's tables are padded to at dispatch
        (keys mcap / mcap2 / rcap / nkcap: the association tables, the
        keyframe tables, the ctx row space and the keyframe slots). A group
        is padded to the larger of the floor and its largest stream. The
        default derives from the matcher's max_features as the JAX package's
        does; pass {} for no floor.
    verbose, rng_seed: per stream, as `System` (stream s gets rng_seed + s).
    device: where every stream runs; the card unless the caller asks for the
        CPU (raises without a card).
    """

    def __init__(
        self,
        parameters,
        matcher_factory: Callable[[], object],
        n_streams: int,
        *,
        keyframe_database_factory: Callable | None = None,
        cap_floors: dict | None = None,
        verbose: bool = False,
        rng_seed: int = 0,
        device: torch.device | str = device_mod.DEFAULT,
    ):
        self.device = device_mod.resolve(device)
        self.systems = []
        for s in range(n_streams):
            matcher = matcher_factory()
            kf_db = (
                keyframe_database_factory(matcher)
                if keyframe_database_factory is not None
                else KeyFrameMatchDatabase(matcher)
            )
            self.systems.append(System(
                copy.deepcopy(parameters), matcher, kf_db, verbose=verbose,
                rng_seed=rng_seed + s, device=self.device,
            ))
        if cap_floors is None:
            m = self.systems[0].matcher if self.systems else None
            f = 1 << (int(getattr(m, "max_features", 2000)) - 1).bit_length()
            cap_floors = {"mcap": f, "mcap2": f, "rcap": f, "nkcap": 8}
        self.cap_floors = dict(cap_floors)
        self.stats = {
            "ticks": 0,
            "frames": 0,
            "batched_frames": 0,
            "batch_groups": 0,
            "single_frames": 0,
        }
        self._pending: tuple | None = None

    # ------------------------------------------------------------------
    def _normalize(self, images, timestamps):
        n = len(self.systems)
        if len(images) != n:
            raise ValueError(f"expected {n} images, got {len(images)}")
        if timestamps is None:
            timestamps = float(self.stats["ticks"]) * 0.1
        if not isinstance(timestamps, (list, tuple, np.ndarray)):
            timestamps = [float(timestamps)] * n
        return images, timestamps

    def _prepare_and_dispatch(self, images) -> None:
        """Build the steady-qualifying streams' device inputs, group them by
        key, and dispatch each group as ONE batched call (a lone stream gets
        the single-stream speculative dispatch: still overlapped, not
        batched)."""
        t0 = time.perf_counter()
        preps: dict[int, dict] = {}
        for i, img in enumerate(images):
            if img is None:
                continue
            tr = self.systems[i].tracker
            if getattr(tr, "_pipe_spec", None) is not None:
                continue  # a dispatch is already in flight for this stream
            mod = fused_loftr if isinstance(tr.matcher, LoftrFeatureMatcher) else fused_host
            prep = mod.prepare_spec_inputs(tr, img)
            if prep is not None:
                preps[i] = prep
        t1 = time.perf_counter()

        groups: dict[tuple, list[int]] = {}
        for i, prep in preps.items():
            groups.setdefault(prep["key"], []).append(i)
        for idxs in groups.values():
            if len(idxs) < 2:
                i = idxs[0]
                tr = self.systems[i].tracker
                mod = fused_loftr if preps[i]["kind"] == "loftr" else fused_host
                tr._pipe_spec = mod.dispatch_prepared(tr, preps[i])
                self.stats["single_frames"] += 1
                continue
            self._dispatch_group(idxs, preps)
        _sample(self.stats, "prepare_ms", (t1 - t0) * 1e3)
        _sample(self.stats, "dispatch_ms", (time.perf_counter() - t1) * 1e3)

    def _track_all(self, images, timestamps) -> list:
        """Drive every stream's per-frame superloop; dispatched streams
        consume their spec inside run_steady."""
        t0 = time.perf_counter()
        results: list = []
        for i, img in enumerate(images):
            if img is None:
                results.append(None)
                continue
            system = self.systems[i]
            system.track_monocular(img, float(timestamps[i]))
            results.append(system.get_current_position())
            self.stats["frames"] += 1
        _sample(self.stats, "track_ms", (time.perf_counter() - t0) * 1e3)
        return results

    def step(
        self,
        images: Sequence,
        timestamps: Sequence[float] | float | None = None,
    ) -> list:
        """Process one tick: one frame per stream (None skips a stream).
        Returns the per-stream current positions (None for skipped / lost)."""
        images, timestamps = self._normalize(images, timestamps)
        self._prepare_and_dispatch(images)
        results = self._track_all(images, timestamps)
        self.stats["ticks"] += 1
        return results

    def step_pipelined(
        self,
        images: Sequence,
        timestamps: Sequence[float] | float | None = None,
    ) -> list:
        """One-tick-latency serving (the server twin of
        System.track_monocular_pipelined): replay the PREVIOUS tick's frames,
        whose batched device work and host copy have been in flight since
        the last call, then prepare and dispatch THIS tick's groups before
        returning. Returns the previous tick's per-stream positions (all
        None on the first call); call `flush()` after the final tick."""
        images, timestamps = self._normalize(images, timestamps)
        prev = self._pending
        results = [None] * len(self.systems)
        if prev is not None:
            results = self._track_all(*prev)
        self._pending = (list(images), list(timestamps))
        self._prepare_and_dispatch(images)
        self.stats["ticks"] += 1
        return results

    def flush(self) -> list:
        """Complete the pending pipelined tick (if any)."""
        prev = self._pending
        self._pending = None
        results = [None] * len(self.systems)
        if prev is not None:
            results = self._track_all(*prev)
        for system in self.systems:
            system.tracker._pipe_spec = None
        return results

    # ------------------------------------------------------------------
    def _caps(self, ps: list, kind: str) -> dict:
        """A group's padded table sizes: the larger of the floor and the
        group's largest, with mp_pos at least as long as the ctx rows."""
        fl, ctxs = self.cap_floors, [p["ctx"] for p in ps]
        rcap = max(fl.get("rcap", 0), *(c["first_slot_d"].shape[0] for c in ctxs))
        caps = {
            "rcap": rcap,
            "pcap": max(rcap, *(p["mp_pos_d"].shape[0] for p in ps)),
            "nkcap": max(fl.get("nkcap", 0), *(c["n_kf"] for c in ctxs)),
        }
        if kind == "orb":
            caps["mcap"] = max(fl.get("mcap", 0), *(p["chain_px_d"].shape[0] for p in ps))
            caps["mcap2"] = max(fl.get("mcap2", 0), *(c["kf_px"].shape[1] for c in ctxs))
        return caps

    def _ctx_tables(self, ctxs: list, caps: dict) -> tuple:
        """The ctx geometry of a group, padded: first_slot -1, normal and
        maxdist 0 (a padded row is never visible)."""
        r = caps["rcap"]
        return (
            _pad_stack([c["first_slot_d"] for c in ctxs], (r,), -1),
            _pad_stack([c["normal_d"] for c in ctxs], (r, 3), 0.0),
            _pad_stack([c["maxdist_d"] for c in ctxs], (r,), 0.0),
        )

    def _chain_T_init(self, ps: list, trackers: list):
        """The group's velocity-model poses: one batched chain_T_init over the
        stacked chain poses and the previous poses (one upload)."""
        T_prev = fused_host._upload(trackers[0], np.stack([p["T_prev_host"] for p in ps]))
        return fused_tracking.chain_T_init(torch.stack([p["T2_d"] for p in ps]), T_prev)

    def _finish_group(self, idxs, preps, trackers, fields, finish) -> None:
        """Start the group's one shared readback and hand each stream its
        spec (`finish(j, tracker, prep, row)` packages stream j's)."""
        readback = _GroupReadback(fields, self.stats)
        for j, i in enumerate(idxs):
            tr = trackers[j]
            fused_host.count(tr, "dispatch")
            tr._pipe_spec = finish(j, tr, preps[i], readback.row(j))
        self.stats["batched_frames"] += len(idxs)
        self.stats["batch_groups"] += 1

    def _dispatch_group(self, idxs: list[int], preps: dict[int, dict]) -> None:
        if preps[idxs[0]]["kind"] == "loftr":
            return self._dispatch_group_loftr(idxs, preps)
        ps = [preps[i] for i in idxs]
        ctxs = [p["ctx"] for p in ps]
        trackers = [self.systems[i].tracker for i in idxs]
        caps = self._caps(ps, "orb")
        nk, m, m2 = caps["nkcap"], caps["mcap"], caps["mcap2"]
        out = multistream.steady_step_batch(
            torch.stack([p["img_d"] for p in ps]),
            _stack_features([p["prev_feats"] for p in ps]),
            _pad_stack([p["chain_px_d"] for p in ps], (m,), -1),
            _pad_stack([p["chain_row_d"] for p in ps], (m,), -1),
            _pad_stack([p["mp_pos_d"] for p in ps], (caps["pcap"], 3), 0.0),
            self._chain_T_init(ps, trackers),
            orb.Features(*(
                torch.stack([_pad_slots(x, nk) for x in xs])
                for xs in zip(*(c["kf_feats"] for c in ctxs))
            )),
            _pad_stack([c["kf_px"] for c in ctxs], (nk, m2), -1),
            _pad_stack([c["kf_row"] for c in ctxs], (nk, m2), -1),
            *self._ctx_tables(ctxs, caps),
            torch.stack([fused_host._k_dev(t) for t in trackers]),
            **ps[0]["statics"],
        )

        def finish(j, tr, prep, row):
            return fused_host.finish_spec(
                tr, prep, orb.Features(*(x[j] for x in out.cur)), row,
                (out.chain_px[j], out.union_row[j], out.local.T2[j]),
            )

        self._finish_group(idxs, preps, trackers, fused_tracking.steady_fields(out), finish)

    def _dispatch_group_loftr(self, idxs: list[int], preps: dict[int, dict]) -> None:
        """A LoFTR group: one `multistream.steady_step_loftr_batch` call (the
        backbone over N images at once) with one shared readback."""
        ps = [preps[i] for i in idxs]
        ctxs = [p["ctx"] for p in ps]
        trackers = [self.systems[i].tracker for i in idxs]
        caps = self._caps(ps, "loftr")
        nk = caps["nkcap"]
        s = ps[0]["statics"]
        # every stream's matcher holds the same weights (one checkpoint)
        f_cur, out, union_row, T2 = multistream.steady_step_loftr_batch(
            torch.stack([p["img_d"] for p in ps]),
            trackers[0].matcher.model,
            torch.stack([p["f_prev"] for p in ps]),
            torch.stack([p["cellrow_d"] for p in ps]),
            _pad_stack([p["mp_pos_d"] for p in ps], (caps["pcap"], 3), 0.0),
            self._chain_T_init(ps, trackers),
            torch.stack([_pad_slots(c["kf_feats"], nk) for c in ctxs]),
            _pad_stack([c["kf_cellrow"] for c in ctxs], (nk, ctxs[0]["kf_cellrow"].shape[1]), -1),
            *self._ctx_tables(ctxs, caps),
            ps[0]["tables"]["uv"],
            torch.stack([fused_host._k_dev(t) for t in trackers]),
            ps[0]["info_val"], s["threshold"], s["width"], s["height"], s["resize_hw"],
        )

        def finish(j, tr, prep, row):
            return fused_loftr.finish_spec(
                tr, prep, f_cur[j : j + 1], row, (union_row[j], T2[j]),
            )

        self._finish_group(idxs, preps, trackers, fused_loftr.loftr_fields(out), finish)
