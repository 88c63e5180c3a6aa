"""The metric arithmetic: a rate over the whole window, a tail over all
requests with the missing ones ranked last, shares from their parts."""

import os

import pytest

from counts import flops as F
from portbench import readers

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_request_tail_stops_where_the_profiler_opened():
    # traced: only requests due before the opening count, and a mark after it is a miss at the wait reached then
    reqs = [{"stream": False, "due": float(i), "done_at": i + 0.5, "out": {}, "cut_at": 60.0} for i in range(10)]
    reqs[8]["done_at"] = 30.0  # due at 8, finished after the opening at 10
    obs = {"requests": reqs, "t0": 100.0, "opened": 110.0}
    assert readers.request_tail(obs, False, "done_at", 0.5) == 0.5
    assert readers.request_tail(obs, False, "done_at", 1.0) == pytest.approx(2.0)  # 10 - 8, not 30 - 8
    assert readers.request_tail({"requests": reqs, "t0": 100.0}, False, "done_at", 1.0) == pytest.approx(22.0)


def test_audio_rate_is_all_work_over_all_time():
    calls = [{"stats": {"audio_s": 10.0}}, {"stats": {"audio_s": 30.0}}]
    # not the mean of per-call rates: the window's total over its length
    assert readers.audio_rate({"calls": calls, "window_s": 4.0}) == 10.0


class Rec:
    def __init__(self, events=(), spans=(), work=(), bounds=()):
        self.events, self.spans, self.work, self.bounds = list(events), list(spans), list(work), list(bounds)


def test_chunk_ms_per_step_and_captures():
    rec = Rec(events=[(0.0, "slot", "replay", 16), (0.1, "slot", "replay", 9), (0.2, "voc", "replay", None),
                      (0.3, "voc", "capture", None)])
    obs = {"rec": rec, "ticks": [(0.1, 0.05), (0.2, None)]}
    assert readers.chunk_ms_per_step(obs) == pytest.approx(1e3 * 0.05 / 25)
    assert readers.window_captures(obs) == 1


def test_k1_roofline_and_mfu_from_the_traced_window():
    h = {"upsample_initial_channel": 1536, "upsample_rates": [4, 4, 2, 2, 2, 2], "upsample_kernel_sizes": [8] * 6,
         "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3, "gpt_dim": 1280}
    tr = {"start": 10.0, "stop": 12.0, "window_s": 2.0, "busy_s": 1.5,
          "kernels": {"void anti_alias_snake_kernel<__nv_bfloat16, true>(...)": {"own_s": 0.00086, "launches": 109}}}
    k1 = F.k1_bound_s(F.k1_elements(h, 1, 100))
    bounds = [(10.5, 10.6, {F.K1_KERNEL: k1}), (13.0, 13.1, {F.K1_KERNEL: k1})]
    obs = {"trace": tr, "rec": Rec(bounds=bounds, work=[(9.0, 11.0, 4e12), (11.0, 11.5, 1e12)])}
    assert readers.kernel_roofline(obs, F.K1_KERNEL) == pytest.approx(100 * k1 / 0.00086)
    assert readers.idle_share(obs) == pytest.approx(25.0)
    # half of the first piece of work lies inside the window
    assert readers.step_mfu(obs) == pytest.approx(100 * (2e12 + 1e12) / (2.0 * F.PEAK_BF16))
    assert readers.kernel_roofline({"trace": None}, F.K1_KERNEL) is None


def test_a_kernel_roofline_reads_the_kernels_summary():
    # a synthetic summary: K6 under two instantiations, another kernel whose
    # name holds none of it; the bounds of work inside and outside the window
    from portbench.cell import load_module

    k6 = load_module(os.path.join(BENCH, "metrics", "kernels.k6_roofline.py"))
    tr = {"start": 10.0, "stop": 12.0, "window_s": 2.0, "busy_s": 1.0,
          "kernels": {"void (anonymous namespace)::decode_attn_kernel<__nv_bfloat16, 2, 64>(...)": {"own_s": 0.003,
                                                                                                 "launches": 48},
                      "void (anonymous namespace)::decode_attn_kernel<signed char, 4, 64>(...)": {"own_s": 0.001,
                                                                                                "launches": 24},
                      "nvjet_tst_64x8_64x16_4x1_v_bz_bias_TNT": {"own_s": 0.5, "launches": 96}}}
    bounds = [(10.2, 10.4, {"decode_attn_kernel": 0.0006}), (10.5, 10.6, {F.K1_KERNEL: 1.0}),
              (11.5, 12.5, {"decode_attn_kernel": 0.0008}), (13.0, 13.5, {"decode_attn_kernel": 5.0})]
    obs = {"trace": tr, "rec": Rec(bounds=bounds)}
    # the first whole, half of the second, none of the fourth: 0.001 s of bound over 0.004 s of own time
    assert k6.read(obs) == pytest.approx(25.0)
    assert readers.kernel_roofline(obs, "decode_attn_kernel") == pytest.approx(25.0)
    # a kernel that did not run in the window, or that no work named, reads nothing (never 0)
    assert readers.kernel_roofline(obs, F.K1_KERNEL) is None
    assert readers.kernel_roofline(dict(obs, rec=Rec(bounds=bounds[1:2])), "decode_attn_kernel") is None
    tr["kernels"] = {}
    assert k6.read(obs) is None


def test_k1_on_the_kernel_path_reads_as_from_the_vocoder_spans():
    # the recorder keeps K1's bound for each vocoder call as padded: on the same
    # trace it reads what the `vocode` spans' (rows, frames) gave before
    import types

    import torch

    from portbench import observe

    h = {"upsample_initial_channel": 64, "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
         "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 3]], "gpt_dim": 128}
    rec = observe.Recorder({"gpt": {"condition_num_latent": 8}, "bigvgan": h, "engine": {}}, None)
    eng = types.SimpleNamespace(_conditioning=None, _gpt_generate=None, _gpt_latent=None, _vocode=None,
                                _vocode_many=None, _vocoder_call=lambda latent, mel_ref, lens: None,
                                _graphs=types.SimpleNamespace(stages=lambda: []))
    observe.instrument_engine(eng, rec)
    rec.on = True
    for rows, frames in ((1, 16), (4, 32), (2, 64)):
        eng._vocoder_call(torch.zeros(rows, frames, 128), torch.zeros(1, 300, 100), None)
    t0, t1 = rec.spans[0][1] - 1.0, rec.spans[-1][2] + 1.0
    tr = {"start": t0, "stop": t1, "kernels": {"anti_alias_snake_kernel<float>": {"own_s": 0.002, "launches": 111}}}
    obs = {"trace": tr, "rec": rec}
    spans = sum(F.k1_elements(h, info[0], info[1]) for name, _a, _b, info in rec.spans if name == "vocode")
    assert readers.kernel_roofline(obs, F.K1_KERNEL) == pytest.approx(100 * F.k1_bound_s(spans) / 0.002, rel=1e-12)
    assert [w[2] for w in rec.work] == [0.0, 0.0, 0.0]  # the model FLOPs are the valid codes', counted apart


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
