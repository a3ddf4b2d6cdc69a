"""Share of the window's frames that the fused steady step completed
(`fused_host.pipe_stats` `done_steady`, summed over streams), in %."""


def read(run):
    if not run.frames:
        return None
    return 100.0 * run.counters.get("pipe.done_steady", 0) / run.frames
