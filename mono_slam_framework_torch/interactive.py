"""Interactive teleop driver: the reference's keyboard display loop.

PyTorch port's counterpart of `mono_slam_framework_tpu/interactive.py`; the
System and its matcher run on `--device` (default `cuda`).

The reference application is a Webots robot controller: a 32 ms camera loop
grabs a frame, gamma-corrects it, hands it to an async SLAM step that drops
frames while busy, displays the side-by-side match image, and maps arrow
keys to motor speeds plus 'I' to ToggleInitializationAllowed
(src/main.cpp:100-188, display 142-147, teleop 151-175).

This module is the rebuild's twin: the camera is the procedural plane
simulator (`mono_slam_framework_torch.sim.PlaneWorld`), the async step is
`utils.app.AsyncSlamDriver`, the display is a rolling PNG of the match image
plus an optional ANSI half-block preview rendered straight into the
terminal, and the keyboard drives a planar camera rig:

  arrows / wasd   translate the rig over the plane (x/y)
  z / c           yaw left/right (about the camera y axis)
  f / b           dolly toward/away from the plane (z)
  space           stop (zero all rig velocities)
  i               toggle the manual initialization gate (main.cpp:173-175)
  v               start/stop the live map viewer (StartGUI/StopGUI twin)
  t               save the TUM keyframe trajectory
  r               reset the system
  q / ESC         quit

Run: python -m mono_slam_framework_torch.interactive [--term] [--matcher orb]
     [--device cuda|cpu]
Scripted key streams (``keys=iter([...])`` / ``--keys``) make the loop
deterministic for tests and demos.
"""

from __future__ import annotations

import os
import select
import sys
import tempfile

import numpy as np

from mono_slam_framework_torch.utils.app import AsyncSlamDriver, GammaCorrector

DEFAULT_PNG = os.path.join(tempfile.gettempdir(), "mono_slam_match.png")


class Rig:
    """Planar camera rig with velocity-decay teleop (differential-drive feel).

    The camera looks +z at the textured plane; translation spans the
    strongly observable x/y axes, yaw pans about the camera y axis, and z
    dollies toward/away from the plane. Key impulses add velocity which
    decays by `damping` per tick — the keyboard-to-motor-speed semantics of
    the reference teleop (main.cpp:151-171) without the robot kinematics.
    """

    def __init__(self, impulse=0.02, yaw_impulse=0.01, damping=0.85):
        self.pos = np.zeros(3)  # camera center in world coords
        self.yaw = 0.0
        self.vel = np.zeros(3)
        self.yaw_vel = 0.0
        self.impulse = impulse
        self.yaw_impulse = yaw_impulse
        self.damping = damping

    def key(self, tok: str) -> bool:
        """Apply a movement token; returns True if it was one."""
        d = self.impulse
        moves = {
            "left": (-d, 0, 0), "a": (-d, 0, 0),
            "right": (d, 0, 0), "d": (d, 0, 0),
            "up": (0, d, 0), "w": (0, d, 0),
            "down": (0, -d, 0), "s": (0, -d, 0),
            "f": (0, 0, d), "b": (0, 0, -d),
        }
        if tok in moves:
            self.vel += moves[tok]
            return True
        if tok == "z":
            self.yaw_vel -= self.yaw_impulse
            return True
        if tok == "c":
            self.yaw_vel += self.yaw_impulse
            return True
        if tok == "space":
            self.vel[:] = 0.0
            self.yaw_vel = 0.0
            return True
        return False

    def tick(self) -> None:
        self.pos += self.vel
        self.yaw += self.yaw_vel
        self.vel *= self.damping
        self.yaw_vel *= self.damping

    def tcw(self) -> np.ndarray:
        """World->camera pose (same convention as sim.lateral_trajectory)."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ self.pos
        return T.astype(np.float32)


class _TtyKeys:
    """Non-blocking cbreak keyboard: poll() returns a token or None.

    Arrow keys arrive as ESC [ A/B/C/D sequences; a bare ESC is reported as
    'esc'. Used only when stdin is a real terminal.
    """

    def __enter__(self):
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        return False

    def poll(self, timeout: float) -> str | None:
        r, _, _ = select.select([sys.stdin], [], [], timeout)
        if not r:
            return None
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            r, _, _ = select.select([sys.stdin], [], [], 0.01)
            if not r:
                return "esc"
            seq = sys.stdin.read(1)
            if seq == "[":
                arrow = sys.stdin.read(1)
                return {"A": "up", "B": "down", "C": "right", "D": "left"}.get(
                    arrow, None
                )
            return None
        if ch == " ":
            return "space"
        return ch.lower() or None


def _ansi_preview(img: np.ndarray, cols: int = 96) -> str:
    """Render a grayscale/RGB image as ANSI 256-color half-block rows."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img.mean(axis=2)
    h, w = img.shape
    step = max(1, w // cols)
    small = img[:: 2 * step, ::step]  # 2x vertical: one ▀ carries two rows
    top = small[0::2]
    bot = small[1::2][: top.shape[0]]
    top = top[: bot.shape[0]]
    # ANSI 232..255 is the 24-step grayscale ramp
    t = (np.clip(top, 0, 255) / 255.0 * 23).astype(int) + 232
    b = (np.clip(bot, 0, 255) / 255.0 * 23).astype(int) + 232
    lines = []
    for ti, bi in zip(t, b):
        lines.append(
            "".join(
                f"\x1b[38;5;{a}m\x1b[48;5;{c}m▀" for a, c in zip(ti, bi)
            )
            + "\x1b[0m"
        )
    return "\n".join(lines)


def _save_png(path: str, img: np.ndarray) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    img = np.asarray(img)
    if img.ndim == 2:
        mpimg.imsave(path, img, cmap="gray", vmin=0, vmax=255)
    else:
        mpimg.imsave(path, np.clip(img, 0, 255).astype(np.uint8))


def run_interactive(
    system,
    world,
    *,
    keys=None,
    period: float = 0.032,
    gamma: float = 1.0,
    png: str | None = DEFAULT_PNG,
    png_every: int = 8,
    term: bool = False,
    max_steps: int | None = None,
    out: str = "trajectory_tum.txt",
    verbose: bool = True,
) -> dict:
    """Drive `system` interactively over `world` (any object with
    ``render(Tcw) -> [H,W] f32`` — e.g. sim.PlaneWorld).

    keys: None reads the real keyboard (requires a TTY; the loop then paces
    itself at `period`, the reference's 32 ms camera interval,
    main.cpp:58-59); an iterable of tokens replays a scripted session with
    no pacing (one token per camera tick; exhausting it quits).
    """
    scripted = keys is not None
    if scripted:
        key_iter = iter(keys)
    elif not sys.stdin.isatty():
        raise SystemExit(
            "interactive mode needs a TTY (or pass --keys for a scripted run)"
        )
    corrector = GammaCorrector(gamma) if gamma != 1.0 else None
    driver = AsyncSlamDriver(system)
    rig = Rig()
    step = 0
    saved = 0
    ctx = _TtyKeys() if not scripted else None
    try:
        if ctx is not None:
            ctx.__enter__()
        while True:
            tok = (
                next(key_iter, "q") if scripted else ctx.poll(period)
            )
            if tok in ("q", "esc"):
                break
            if tok == "i":
                system.toggle_initialization_allowed()
            elif tok == "r":
                system.reset()
            elif tok == "t":
                system.save_keyframe_trajectory_tum(out)
                saved += 1
            elif tok == "v":
                if getattr(system, "map_drawer", None) is not None and getattr(
                    system.map_drawer, "_viewer_thread", None
                ):
                    system.stop_gui()
                else:
                    system.start_gui()
            elif tok is not None:
                rig.key(tok)
            rig.tick()
            img = world.render(rig.tcw())
            if corrector is not None:
                img = corrector(img)
            driver.feed(img, timestamp=step * period)
            if scripted:
                # scripted sessions are deterministic: no frame dropping
                driver.wait()
            if png and step % png_every == 0:
                try:
                    _save_png(png, system.get_current_match_image())
                except Exception:
                    pass  # display is best-effort, tracking is not
            if term and step % png_every == 0:
                sys.stdout.write("\x1b[H\x1b[2J")
                sys.stdout.write(_ansi_preview(img) + "\n")
            if verbose and step % 8 == 0:
                m = system.last_metrics
                sys.stdout.write(
                    f"\r[{step}] state={m.get('state')} "
                    f"inliers={m.get('inliers', 0)} "
                    f"kf={system.map.n_keyframes()} "
                    f"mp={system.map.n_map_points()} "
                    f"dropped={driver.frames_dropped}   "
                )
                sys.stdout.flush()
            step += 1
            if max_steps is not None and step >= max_steps:
                break
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
        driver.close()
        if verbose:
            sys.stdout.write("\n")
    return {
        "frames": step,
        "dropped": driver.frames_dropped,
        "state": system.last_metrics.get("state"),
        "keyframes": system.map.n_keyframes(),
        "map_points": system.map.n_map_points(),
        "trajectory_saves": saved,
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matcher", choices=["orb", "loftr"], default="orb")
    p.add_argument("--features", type=int, default=2000)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--focal", type=float, default=500.0)
    p.add_argument("--texture", choices=["kron", "smooth"], default="kron")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--png", default=DEFAULT_PNG)
    p.add_argument("--term", action="store_true", help="ANSI camera preview")
    p.add_argument("--keys", default=None,
                   help="scripted key tokens, comma-separated (for demos)")
    p.add_argument("--max-steps", type=int, default=0)
    p.add_argument("--out", default="trajectory_tum.txt")
    p.add_argument("--device", default="cuda",
                   help="device of the matcher and the System (cuda or cpu)")
    args = p.parse_args(argv)

    from mono_slam_framework_torch.params import SlamParameters
    from mono_slam_framework_torch.sim import PlaneWorld
    from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System

    world = PlaneWorld(
        width=args.width, height=args.height, f=args.focal,
        second_plane=(3.0, 0.3), texture=args.texture,
    )
    if args.matcher == "loftr":
        from mono_slam_framework_torch.matchers.loftr_matcher import (
            LoftrFeatureMatcher,
        )

        matcher = LoftrFeatureMatcher(threshold=0.1, device=args.device)
    else:
        from mono_slam_framework_torch.matchers import OrbFeatureMatcher

        matcher = OrbFeatureMatcher(
            threshold=0.7, max_features=args.features, device=args.device
        )
    params = SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
        max_features=args.features, minIniMatchCount=100,
        initializerModelFallback=True,
    )
    system = System(
        params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
        device=args.device,
    )
    keys = args.keys.split(",") if args.keys else None
    summary = run_interactive(
        system, world,
        keys=keys,
        gamma=args.gamma,
        png=args.png or None,
        term=args.term,
        max_steps=args.max_steps or None,
        out=args.out,
    )
    import json

    print(json.dumps(summary))


if __name__ == "__main__":
    main()
