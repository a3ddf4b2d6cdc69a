"""Share of the fused LoFTR steps' model calls in the window that replayed
a captured CUDA graph (`pipe_stats` `loftr_graph_replay` over replays,
captures and eager calls, summed over streams), in %. None where the
program counts no such calls."""

KEYS = ("pipe.loftr_graph_replay", "pipe.loftr_graph_capture", "pipe.loftr_eager")


def read(run):
    calls = sum(run.counters.get(k, 0) for k in KEYS)
    if not calls:
        return None
    return 100.0 * run.counters.get("pipe.loftr_graph_replay", 0) / calls
