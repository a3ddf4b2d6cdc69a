"""The `system` driver: one `System` of the program fed one frame per
operation through `System.track_monocular`, as a camera or `run.py`'s
sequence replay feeds it. With `"on_path_end": "reset"` in the mix the
System is reset where the path starts over (a user running sequence after
sequence); otherwise the path wraps.

A driver is `drivers/<name>.py`, named by a traffic mix's `"driver"`, with
a class `Driver(root, config, traffic, device)` that has `systems` (the
program's Systems, whose trackers the harness reads after each operation),
`resets` and `op(i)`, which feeds operation `i` and returns each System's
tracker state from before it.
"""

from __future__ import annotations

from slam_bench import port


class Driver:
    def __init__(self, root, config: dict, traffic, device):
        self.traffic = traffic
        self.system = port.build_system(root, config, device)
        self.systems = [self.system]
        self.resets = 0

    def op(self, i: int) -> list:
        t = self.traffic
        if t.spec.get("on_path_end") == "reset" and i > 0 and i % t.n == 0:
            port.reset(self.system)
            self.resets += 1
        before = [port.state(self.system)]
        self.system.track_monocular(t.image(0, i), i / t.fps)
        return before
