"""Tier-1's schedule under `pytest tests/ -n 6 --dist loadfile`.

The suite's own set-up is tests/conftest.py. This file orders the files so that
the longest start first, and builds the JAX package's native libraries once
before the workers start. It acts only on runs that collect files under tests/.
"""

import os
import pathlib

TESTS = pathlib.Path(__file__).parent / "tests"

# The files that take longest, queued first so that `-n 6 --dist loadfile`
# starts them at once (junit seconds per file on a 6-worker run of 668 cases:
# test_hard_world.py 818 s, test_server.py 573 s; the next, test_orb.py, 417 s).
LONG_FILES = ("test_hard_world.py", "test_server.py")

# xdist hands each of tier-1's 6 workers one file, then a second one to each
# worker with 2 or fewer tests pending: at once to the hard-world worker, whose
# second file, the 7th in the queue, waits for the drive to end. A fast file
# takes that slot.
WORKERS = 6
BEHIND_DRIVE = "test_suite_order.py"


def runs_the_suite(config):
    """Whether this run collects files under tests/."""
    for arg in config.args:
        path = (config.invocation_params.dir / arg.split("::")[0]).resolve()
        if path == TESTS or TESTS in path.parents or path in TESTS.parents:
            return True
    return False


def queue_order(items):
    """Items by file: LONG_FILES first, BEHIND_DRIVE in slot WORKERS, the
    other files in their order; items inside a file keep theirs."""
    files = list(dict.fromkeys(item.path for item in items))
    head = [TESTS / name for name in LONG_FILES]
    behind = TESTS / BEHIND_DRIVE
    order = [f for f in head if f in files]
    order += [f for f in files if f not in head and f != behind]
    if behind in files:
        order.insert(WORKERS, behind)
    rank = {f: i for i, f in enumerate(order)}
    return sorted(items, key=lambda item: rank[item.path])


def pytest_configure(config):
    if not runs_the_suite(config):
        return
    # xdist's loadfile queues files by test count unless this is off, and
    # would start the 2-test hard-world file among the last.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    # Build the native libraries before the workers start, so that no two
    # workers run g++ onto the same path at collection.
    if "PYTEST_XDIST_WORKER" not in os.environ:
        from mono_slam_framework_tpu import native
        from mono_slam_framework_tpu.native import frameio

        frameio.load_library()
        native.load_library()


def pytest_collection_modifyitems(config, items):
    if runs_the_suite(config):
        items[:] = queue_order(items)


def give_way():
    """Set every thread of this process to nice 10, or leave it if higher.

    A Linux nice value belongs to a thread, and JAX's pool threads exist by now.
    """
    for tid in map(int, os.listdir("/proc/self/task")):
        try:
            nice = os.getpriority(os.PRIO_PROCESS, tid)
            os.setpriority(os.PRIO_PROCESS, tid, max(nice, 10))
        except ProcessLookupError:  # the thread ended meanwhile
            pass


def pytest_runtest_setup(item):
    # The hard-world drive sets the end of the run. Beside five busy workers it
    # took 1134-1268 s, against 875-1046 s once they ran at nice 10 (tier-1 runs
    # on one 8-CPU host), so every other xdist worker gives it way.
    if (
        "PYTEST_XDIST_WORKER" in os.environ
        and TESTS in item.path.parents
        and item.path != TESTS / LONG_FILES[0]
    ):
        give_way()
