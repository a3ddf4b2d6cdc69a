"""Tier-1's schedule (the repository's root conftest.py): the longest files are
queued first, a fast file waits behind the first one's drive, and the other
workers give that drive way.

Under `-n 6 --dist loadfile` a file starts when it reaches the head of xdist's
queue, so the order decides when the longest file can start, and with it the
end of the run. This file compiles nothing: it is the one queued behind the
drive.
"""

import importlib.util
import os
import pathlib
import types

import pytest

_ROOT_CONFTEST = pathlib.Path(__file__).parents[1] / "conftest.py"
_spec = importlib.util.spec_from_file_location("tier1_schedule", _ROOT_CONFTEST)
schedule = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(schedule)


def _items(names):
    return [
        types.SimpleNamespace(path=schedule.TESTS / name, nodeid=f"tests/{name}::t{i}")
        for name in names
        for i in range(3)
    ]


def _suite_files():
    return sorted(p.name for p in schedule.TESTS.glob("test_*.py"))


def _file_order(items):
    return [path.name for path in dict.fromkeys(item.path for item in items)]


@pytest.mark.parametrize("name", schedule.LONG_FILES + (schedule.BEHIND_DRIVE,))
def test_long_file_exists(name):
    assert (schedule.TESTS / name).is_file()


def test_sort_keeps_every_item_once_in_its_file_order():
    items = _items(_suite_files())
    ordered = schedule.queue_order(items)
    assert sorted(map(id, ordered)) == sorted(map(id, items))
    for name in _suite_files():
        mine = [it.nodeid for it in items if it.path.name == name]
        assert [it.nodeid for it in ordered if it.path.name == name] == mine
    placed = schedule.LONG_FILES + (schedule.BEHIND_DRIVE,)
    rest = [it for it in items if it.path.name not in placed]
    assert [it for it in ordered if it.path.name not in placed] == rest


def test_long_files_come_first_in_their_order():
    ordered = schedule.queue_order(_items(_suite_files()))
    head = [it.path.name for it in ordered[: 3 * len(schedule.LONG_FILES)]]
    assert head == [name for name in schedule.LONG_FILES for _ in range(3)]


def test_a_fast_file_waits_behind_the_drive():
    files = _file_order(schedule.queue_order(_items(_suite_files())))
    assert files[schedule.WORKERS] == schedule.BEHIND_DRIVE


def test_this_session_is_ordered(request):
    assert request.config.pluginmanager.get_plugin(str(_ROOT_CONFTEST)) is not None
    assert getattr(request.config.option, "loadscopereorder", False) is False
    files = _file_order(request.session.items)
    if schedule.LONG_FILES[0] in files:
        assert files[0] == schedule.LONG_FILES[0]
    if set(schedule.LONG_FILES) <= set(files) and len(files) > schedule.WORKERS:
        assert files[schedule.WORKERS] == schedule.BEHIND_DRIVE


def test_give_way_lowers_every_thread():
    schedule.give_way()
    for tid in os.listdir("/proc/self/task"):
        try:
            assert os.getpriority(os.PRIO_PROCESS, int(tid)) >= 10
        except ProcessLookupError:
            pass
