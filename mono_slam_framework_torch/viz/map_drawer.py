"""Map viewer: trajectory-and-cloud recorder with a live viewer thread.

PyTorch-port copy of `mono_slam_framework_tpu/viz/map_drawer.py` (plain
Python and numpy: it reads the map through `all_map_points` /
`all_keyframes`, which the port's `slam/map_model.Map` has). Capability twin
of the reference MapDrawer (include/MapDrawer.h, src/MapDrawer.cc): the
reference runs a PCL GUI thread consuming a double-buffered point cloud and
camera pose cone (MapDrawer.cc:67-136). The same hook points (update /
set_pos_dir / start / stop, called from Tracking at Tracking.cc:113,
184-192) and the same double-buffer-under-mutex structure; the consumer
thread renders to a rolling PNG and (optionally) serves it over a local
HTTP endpoint, the headless equivalent of the live PCL window. Snapshots can
also be dumped to .npz or rendered offline (matplotlib, imported only when
rendering).
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np


class MapDrawer:
    def __init__(self, map_):
        self.map = map_
        self.running = False
        self.points = np.zeros((0, 3), np.float32)
        self.kf_centers = np.zeros((0, 3), np.float32)
        self.kf_dirs = np.zeros((0, 3), np.float32)
        self.cam_pos = np.zeros(3, np.float32)
        self.cam_dir = np.array([0, 0, 1.0], np.float32)
        self.history: list[np.ndarray] = []
        # live-viewer state (reference: PCL thread + buffer mutex,
        # MapDrawer.cc:67-136)
        self._lock = threading.Lock()
        self._dirty = False
        self._viewer_thread: threading.Thread | None = None
        self._http_server = None
        self._latest_png: bytes | None = None

    def start(self) -> None:
        self.running = True

    def stop(self) -> None:
        self.running = False
        self.stop_viewer()

    def update(self) -> None:
        """Snapshot the map (reference: double-buffer swap, MapDrawer.cc:30-55)."""
        pts = [mp.world_pos for mp in self.map.all_map_points() if not mp.is_bad]
        points = (
            np.stack(pts).astype(np.float32) if pts else np.zeros((0, 3), np.float32)
        )
        kfs = [
            kf
            for kf in self.map.all_keyframes()
            if not kf.is_bad and kf.Ow is not None
        ]
        kf_centers = (
            np.stack([kf.get_camera_center() for kf in kfs]).astype(np.float32)
            if kfs
            else np.zeros((0, 3), np.float32)
        )
        # per-KF world view direction (Rcw^T e_z = Tcw's third rotation row):
        # the reference draws a 35-degree cone glyph along it per keyframe
        # (MapDrawer.cc:116-130)
        dirs = []
        for kf in kfs:
            T = getattr(kf, "Tcw", None)
            dirs.append(
                np.asarray(T[2, :3], np.float32)
                if T is not None
                else np.array([0, 0, 1], np.float32)
            )
        kf_dirs = (
            np.stack(dirs).astype(np.float32)
            if dirs
            else np.zeros((0, 3), np.float32)
        )
        with self._lock:
            self.points = points
            self.kf_centers = kf_centers
            self.kf_dirs = kf_dirs
            self._dirty = True

    def set_pos_dir(self, x, y, z, dx, dy, dz) -> None:
        with self._lock:
            self.cam_pos = np.array([x, y, z], np.float32)
            self.cam_dir = np.array([dx, dy, dz], np.float32)
            self.history.append(self.cam_pos.copy())
            self._dirty = True

    # ------------------------------------------------------------------
    # live viewer thread (MapDrawer.cc:67-136 twin for headless setups)
    def start_viewer(
        self,
        out_path: str | None = None,
        interval: float = 1.0,
        http_port: int | None = None,
    ) -> None:
        """Start the consumer thread: re-render `out_path` whenever the
        buffers changed, at most every `interval` seconds. With `http_port`,
        also serve the latest render at http://127.0.0.1:<port>/map.png.
        `out_path` defaults to mono_slam_live.png in the temporary directory."""
        if self._viewer_thread is not None:
            return
        if out_path is None:
            out_path = os.path.join(tempfile.gettempdir(), "mono_slam_live.png")
        self._viewer_stop = threading.Event()

        def loop():
            while not self._viewer_stop.wait(interval):
                with self._lock:
                    dirty = self._dirty
                    self._dirty = False
                if dirty:
                    try:
                        self.render(out_path)
                        with open(out_path, "rb") as fh:
                            self._latest_png = fh.read()
                    except Exception:  # rendering must never kill tracking
                        pass

        self._viewer_thread = threading.Thread(
            target=loop, name="map-viewer", daemon=True
        )
        self._viewer_thread.start()

        if http_port is not None:
            import http.server

            drawer = self

            class Handler(http.server.BaseHTTPRequestHandler):
                def do_GET(self):  # noqa: N802 (stdlib API)
                    png = drawer._latest_png
                    if self.path not in ("/", "/map.png") or png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)

                def log_message(self, *a):  # quiet
                    pass

            self._http_server = http.server.ThreadingHTTPServer(
                ("127.0.0.1", http_port), Handler
            )
            threading.Thread(
                target=self._http_server.serve_forever,
                name="map-viewer-http",
                daemon=True,
            ).start()

    def stop_viewer(self) -> None:
        if self._viewer_thread is not None:
            self._viewer_stop.set()
            self._viewer_thread.join(timeout=5.0)
            self._viewer_thread = None
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server = None

    def save(self, path: str) -> None:
        np.savez(
            path,
            points=self.points,
            kf_centers=self.kf_centers,
            kf_dirs=self.kf_dirs,
            trajectory=np.stack(self.history) if self.history else np.zeros((0, 3)),
        )

    @staticmethod
    def _draw_cone(ax, apex, direction, length, color, half_angle_deg=35.0):
        """View-cone glyph: apex + rim wireframe along `direction`, the PNG
        equivalent of the reference's 35-degree PCL cones per camera/KF
        (MapDrawer.cc:104-130)."""
        d = np.asarray(direction, np.float64)
        n = np.linalg.norm(d)
        if n < 1e-9:
            return
        d = d / n
        # an orthonormal basis of the plane normal to the view direction
        up = np.array([0.0, 1.0, 0.0])
        if abs(d @ up) > 0.9:
            up = np.array([1.0, 0.0, 0.0])
        u = np.cross(d, up)
        u /= np.linalg.norm(u)
        v = np.cross(d, u)
        r = length * np.tan(np.radians(half_angle_deg))
        ang = np.linspace(0, 2 * np.pi, 9)
        rim = (
            np.asarray(apex, np.float64)
            + length * d
            + r * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
        )
        ax.plot(*rim.T, c=color, lw=0.8)
        for k in range(0, 8, 2):
            seg = np.stack([np.asarray(apex, np.float64), rim[k]])
            ax.plot(*seg.T, c=color, lw=0.8)

    def render(self, path: str) -> None:
        """Offline 3D scatter render (replaces the live PCL window)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        with self._lock:
            points = self.points
            kf_centers = self.kf_centers
            kf_dirs = self.kf_dirs
            cam_pos, cam_dir = self.cam_pos, self.cam_dir
            traj = np.stack(self.history) if self.history else None
        if len(points):
            ax.scatter(*points.T, s=1, c="gray", alpha=0.5)
        # glyph length scaled to the scene so frusta stay visible at any map
        # extent (the reference uses 0.02 world units, MapDrawer.cc:108-111)
        ext = 1.0
        if len(points) or len(kf_centers):
            allp = np.concatenate([points, kf_centers], axis=0)
            ext = max(float(np.ptp(allp, axis=0).max()), 1e-3)
        glyph = 0.04 * ext
        if len(kf_centers):
            ax.scatter(*kf_centers.T, s=20, c="tab:blue", marker="^")
            ndirs = min(len(kf_dirs), len(kf_centers))
            for i in range(ndirs):
                self._draw_cone(ax, kf_centers[i], kf_dirs[i], glyph, "tab:blue")
        if traj is not None:
            ax.plot(*traj.T, c="tab:red")
        # current camera cone, distinct color (pos_cone, MapDrawer.cc:104-115)
        self._draw_cone(ax, cam_pos, cam_dir, 1.5 * glyph, "tab:green")
        ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
        fig.savefig(path, dpi=120)
        plt.close(fig)
