"""The metric arithmetic: a rate over the whole window, a tail over all
requests with the missing ones ranked last, shares from their parts."""

import pytest

from counts import flops as F
from portbench import readers


def test_tail_is_nearest_rank_over_all_requests():
    waits = [float(i) for i in range(1, 11)]
    assert readers.tail(waits, [], 0.9) == 9.0
    # a missing request ranks beyond every finished one: the p90 moves up a place
    assert readers.tail(waits[:9], [50.0], 0.9) == 9.0
    assert readers.tail(waits[:8], [50.0, 60.0], 0.9) == 60.0
    assert readers.tail([], [], 0.9) is None


def test_request_tail_counts_misses_and_kinds():
    reqs = [{"stream": True, "due": 0.0, "first_at": 0.5, "out": {}, "cut_at": 9.0} for _ in range(9)]
    reqs.append({"stream": True, "due": 1.0, "first_at": None, "out": None, "cut_at": 9.0})
    reqs.append({"stream": False, "due": 0.0, "done_at": 0.1, "out": {}, "cut_at": 9.0})
    obs = {"requests": reqs}
    assert readers.request_tail(obs, True, "first_at", 0.9) == 0.5
    assert readers.request_tail(obs, True, "first_at", 0.95) == 8.0  # the miss, at the wait it had reached
    assert readers.request_tail(obs, False, "done_at", 0.9) == pytest.approx(0.1)


def test_audio_rate_is_all_work_over_all_time():
    calls = [{"stats": {"audio_s": 10.0}}, {"stats": {"audio_s": 30.0}}]
    # not the mean of per-call rates: the window's total over its length
    assert readers.audio_rate({"calls": calls, "window_s": 4.0}) == 10.0


class Rec:
    def __init__(self, events=(), spans=(), work=()):
        self.events, self.spans, self.work = list(events), list(spans), list(work)


def test_chunk_ms_per_step_and_captures():
    rec = Rec(events=[(0.0, "slot", "replay", 16), (0.1, "slot", "replay", 9), (0.2, "voc", "replay", None),
                      (0.3, "voc", "capture", None)])
    obs = {"rec": rec, "ticks": [(0.1, 0.05), (0.2, None)]}
    assert readers.chunk_ms_per_step(obs) == pytest.approx(1e3 * 0.05 / 25)
    assert readers.window_captures(obs) == 1


def test_k1_roofline_and_mfu_from_the_traced_window():
    h = {"upsample_initial_channel": 1536, "upsample_rates": [4, 4, 2, 2, 2, 2], "upsample_kernel_sizes": [8] * 6,
         "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3, "gpt_dim": 1280}
    tr = {"start": 10.0, "stop": 12.0, "window_s": 2.0, "busy_s": 1.5, "k1": {"own_s": 0.00086}}
    spans = [("vocode", 10.5, 10.6, (1, 100, 400)), ("vocode", 13.0, 13.1, (1, 100, 400))]
    obs = {"trace": tr, "cfg": {"bigvgan": h}, "rec": Rec(spans=spans, work=[(9.0, 11.0, 4e12), (11.0, 11.5, 1e12)])}
    assert readers.k1_roofline(obs) == pytest.approx(100 * F.k1_bound_s(F.k1_elements(h, 1, 100)) / 0.00086)
    assert readers.idle_share(obs) == pytest.approx(25.0)
    # half of the first piece of work lies inside the window
    assert readers.step_mfu(obs) == pytest.approx(100 * (2e12 + 1e12) / (2.0 * F.PEAK_BF16))
    assert readers.k1_roofline({"trace": None}) is None


def _tracer(events):
    from portbench.trace import Tracer

    class Rec:
        pass

    rec = Rec()
    rec.events = events
    tr = Tracer(rec, after_s=0.0, seconds=1.0, device="cpu")
    tr.start, tr.stop = 10.0, 20.0
    return tr


def test_block_check_holds_each_replay_to_its_predicates_and_steps():
    from indextts_tpu_torch.graphs import BLOCK

    lane_a, lane_b = (("k", 1), 0), (("k", 2), 0)
    events = [(1.0, "dec", "capture", None, lane_a), (2.0, "slot", "capture", None, lane_b),
              (11.0, "dec", "replay", 16, lane_a), (12.0, "slot", "replay", 16, lane_b),
              (13.0, "dec", "replay", 16, lane_a), (14.0, "dec", "replay", 5, lane_a),
              (25.0, "dec", "replay", 16, lane_a)]  # after the traced window
    per_step = 40

    def launches(ops):  # one launch per replay in the window, in time order: [start, operations, predicates]
        return {c: [100 * c, BLOCK + 2 + ran * per_step + extra, BLOCK]
                for c, (ran, extra) in enumerate(ops)}

    sound = launches([(16, 0), (16, 7), (16, 0), (5, 0)])
    out = _tracer(events)._blocks(sound)
    assert out["lost"] is None and out["per_launch"] and out["replays"] == 4 and out["expected"] == 4 * BLOCK
    # a replay of one lane that recorded fewer operations than its twin
    dropped = launches([(16, 0), (16, 7), (16, -3), (5, 0)])
    assert "two replays of one lane" in _tracer(events)._blocks(dropped)["lost"]
    # the IF bodies' operations missing altogether
    bodiless = {c: [100 * c, BLOCK + 2, BLOCK] for c in range(4)}
    assert "besides its predicates" in _tracer(events)._blocks(bodiless)["lost"]
    # a predicate lost
    short = launches([(16, 0), (16, 7), (16, 0), (5, 0)])
    short[3][2] -= 1
    assert "block predicate launches" in _tracer(events)._blocks(short)["lost"]


def test_counters_stop_at_the_profilers_close():
    rec = Rec(events=[(1.0, "slot", "replay", 16), (2.0, "slot", "capture", None), (5.0, "slot", "replay", 9),
                      (6.0, "voc", "capture", None)])
    obs = {"rec": rec, "t0": 0.5, "ticks": [(0.6, 0.08), (4.6, 0.05)], "until": 3.0}
    assert readers.window_captures(obs) == 1
    assert readers.chunk_ms_per_step(obs) == pytest.approx(1e3 * 0.08 / 16)
