"""The metrics read from the program's own spans: only the spans wholly
inside the traced window count, the block time per step takes replays
alone, a loop's host time is its own less its child blocks', and without
a trace (or a program without spans) nothing is read."""

import os

import pytest

from portbench import spans as S

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MS = 1_000_000  # nanoseconds


def _obs(start=10.0, stop=12.0):
    return {"trace": {"start": start, "stop": stop}}


def _at(s):
    """Nanoseconds at s seconds."""
    return int(s * 1e9)


def test_only_spans_wholly_inside_the_window_count():
    recs = [(1, 0, "slot.admit", _at(9.99), _at(10.01), {"waited_ns": 100 * MS}),  # starts before the window
            (2, 0, "slot.admit", _at(10.5), _at(10.5) + 4 * MS, {"waited_ns": 2 * MS}),
            (3, 0, "slot.admit", _at(11.0), _at(11.0) + 6 * MS, {"waited_ns": 4 * MS}),
            (4, 0, "slot.admit", _at(11.99), _at(12.01), {"waited_ns": 100 * MS}),  # ends after it
            (5, 0, "slot.tick", _at(10.4), _at(10.6), {})]
    assert [s[0] for s in S.in_window(_obs(), recs)] == [2, 3, 5]
    assert S.admit_wait_ms(_obs(), recs) == pytest.approx(3.0)
    assert S.admit_ms_per_row(_obs(), recs) == pytest.approx(5.0)


def test_block_time_per_step_takes_replays_only():
    recs = [(1, 0, "dec.loop", _at(10.1), _at(10.2), {}),
            (2, 1, "dec.block", _at(10.1), _at(10.1) + 48 * MS, {"event": "replay", "ran": 16}),
            (3, 1, "dec.block", _at(10.15), _at(10.15) + 9 * MS, {"event": "replay", "ran": 2}),
            (4, 1, "dec.block", _at(10.16), _at(10.16) + 9 * MS, {"event": "warm", "ran": 16}),
            (5, 0, "slot.block", _at(11.0), _at(11.0) + 30 * MS, {"event": "replay", "ran": 8}),
            (6, 0, "slot.block", _at(11.1), _at(11.1) + 80 * MS, {"event": "run", "ran": 8})]
    assert S.block_ms_per_step(_obs(), recs) == pytest.approx((48 + 9 + 30) / (16 + 2 + 8))
    assert S.block_ms_per_step(_obs(), [r for r in recs if r[5].get("event") != "replay"]) is None


def test_loop_host_time_is_the_loops_less_their_child_blocks():
    recs = [(1, 0, "dec.loop", _at(10.0), _at(10.0) + 100 * MS, {}),
            (2, 1, "dec.draws", _at(10.0), _at(10.0) + 1 * MS, {"steps": 16}),  # the loop's host time
            (3, 1, "dec.block", _at(10.01), _at(10.01) + 50 * MS, {"event": "replay", "ran": 16}),
            (4, 1, "dec.block", _at(10.07), _at(10.07) + 20 * MS, {"event": "replay", "ran": 5}),
            (5, 0, "slot.loop", _at(11.0), _at(11.0) + 40 * MS, {}),
            (6, 5, "slot.block", _at(11.0), _at(11.0) + 34 * MS, {"event": "replay", "ran": 16}),
            (7, 0, "dec.block", _at(11.5), _at(11.5) + 5 * MS, {"event": "replay", "ran": 1})]  # no loop around it
    # (100 - 50 - 20) + (40 - 34) ms over the three blocks of the two loops
    assert S.loop_host_ms_per_block(_obs(), recs) == pytest.approx((30 + 6) / 3)
    assert S.loop_host_ms_per_block(_obs(), [r for r in recs if "loop" not in r[2]]) is None


def test_nothing_is_read_without_a_trace():
    recs = [(1, 0, "slot.admit", _at(10.5), _at(10.6), {"waited_ns": MS}),
            (2, 0, "dec.loop", _at(10.5), _at(10.6), {}),
            (3, 2, "dec.block", _at(10.5), _at(10.55), {"event": "replay", "ran": 4})]
    for obs in ({"trace": None}, {}):
        for read in (S.admit_wait_ms, S.admit_ms_per_row, S.block_ms_per_step, S.loop_host_ms_per_block):
            assert read(obs, recs) is None
    # a window holding none of the spans reads nothing either
    assert S.admit_wait_ms(_obs(20.0, 21.0), recs) is None


def test_readers_read_the_programs_ring():
    # each metric's file (or its base's) reads the ring, empty here: nothing to read
    from indextts_tpu_torch import tracing
    from portbench.cell import Cell

    tracing.clear()
    cell = Cell(ROOT, "batch-offline")
    for name in ("serving.admit_wait_ms", "serving.admit_ms_per_row", "graphs.block_ms_per_step",
                 "graphs.block_ms_per_step.slots", "graphs.loop_host_ms_per_block",
                 "graphs.loop_host_ms_per_block.slots"):
        assert cell.reader(name).read(_obs()) is None, name
