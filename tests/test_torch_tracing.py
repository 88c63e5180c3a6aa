"""The port's spans (indextts_tpu_torch/tracing.py) on a tiny CPU engine of
the port alone: with no profiler a span enters no range, reads no clock and
keeps nothing; under a profiler the entry points, the slot tick, the decode
loops, their blocks and draws and the graph stages' calls record with their
nesting and attributes, one to one with the profiler's own ranges; a
queued slot row's admission span carries the time it waited; the ring keeps
at most its bound; start_profiling's exported trace carries the spans."""

import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from indextts_tpu_torch import tracing
from indextts_tpu_torch.config import (BigVGANConfig, ConditionModuleConfig, GPTConfig, IndexTTSConfig,
                                       save_config)
from indextts_tpu_torch.engine import IndexTTS
from indextts_tpu_torch.graphs import BLOCK

MAX_CODES = 24  # two blocks a row: BLOCK steps, then the rest
SAMPLED = dict(max_mel_tokens=MAX_CODES)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    cfg = IndexTTSConfig(
        gpt=GPTConfig(layers=1, model_dim=32, heads=2, max_text_tokens=60, max_mel_tokens=48, number_text_tokens=50,
                      number_mel_codes=66, start_mel_token=64, stop_mel_token=65, condition_num_latent=4,
                      condition_type="conformer_perceiver",
                      condition_module=ConditionModuleConfig(output_size=16, linear_units=32, attention_heads=2,
                                                             num_blocks=1, input_layer="conv2d2", perceiver_mult=2)),
        bigvgan=BigVGANConfig(gpt_dim=32, upsample_initial_channel=16, upsample_rates=(2, 2),
                              upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
                              speaker_embedding_dim=16))
    save_config(cfg, str(d / "config.yaml"))
    eng = IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d), is_fp16=False, device="cpu",
                   allow_random_init=True)
    with torch.no_grad():  # every row runs to its budget
        eng.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -40.0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield eng
    torch.set_num_threads(threads)


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _calls(eng, seed):
    """A beam infer, an infer_batch and a slot session (a whole-file and a
    streamed request) on new voices; returns the slot requests' ids."""
    eng.infer(_prompt(seed), "HELLO WORLD.", None, num_beams=2, **SAMPLED)
    eng.infer_batch([(_prompt(seed + 1), "HI THERE."), (_prompt(seed + 2), "GOOD DAY. TO YOU AGAIN.")],
                    max_text_tokens_per_sentence=12, num_beams=1, **SAMPLED)
    eng.fast_latents = True
    try:
        sess = eng.slot_session(n_slots=2, chunk_steps=10, max_text_tokens_per_sentence=6, **SAMPLED)
        rids = [sess.submit(_prompt(seed + 3), "HI."),
                sess.submit(_prompt(seed + 4), "YO. YES.", on_chunk=lambda r, c: None)]
        sess.drain()
    finally:
        eng.fast_latents = False
    return rids


def test_no_profiler_no_span(engine, monkeypatch):
    def refuse(*_a):
        raise AssertionError("a span reached for the profiler or the clock with no profiler running")

    tracing.clear()
    monkeypatch.setattr(tracing, "_range", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    _calls(engine, 100)
    assert tracing.spans() == []
    a, b = tracing.span("slot.tick"), tracing.span("dec.block", ran=3)
    assert a is b and not a and tracing.current() is a
    with a as s:
        s.set(ran=1)
    assert tracing.spans() == []


@pytest.fixture(scope="module")
def traced(engine):
    """The calls of _calls under a CPU profiler: (ring records, the
    profiler's user annotations on the host, the slot requests' ids)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rids = _calls(engine, 200)
    notes = [(e.start_ns(), e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    return tracing.spans(), sorted(notes), rids


def _by_id(recs):
    return {r.id: r for r in recs}


def _parents(recs, name):
    """The names of the parents of every `name` span."""
    ids = _by_id(recs)
    return {ids[r.parent].name if r.parent else None for r in recs if r.name == name}


def test_spans_and_their_nesting(traced):
    recs, _notes, _rids = traced
    names = {r.name for r in recs}
    assert names >= {"engine.infer", "engine.infer_batch", "slot.submit", "slot.tick", "slot.admit", "slot.snapshot",
                     "slot.emit", "slot.harvest", "slot.loop", "dec.loop", "slot.draws", "dec.draws", "slot.block",
                     "dec.block", "voc.call", "lat.call", "cond.call", "dec.prefill", "dec.generate", "lat.pass",
                     "voc.batch"}
    for root in ("engine.infer", "engine.infer_batch", "slot.submit", "slot.tick"):
        assert _parents(recs, root) == {None}, root
    assert _parents(recs, "slot.admit") == {"slot.tick"}
    assert _parents(recs, "slot.loop") == _parents(recs, "slot.snapshot") == {"slot.tick"}
    assert _parents(recs, "slot.emit") <= {"slot.tick", "slot.harvest"}
    assert _parents(recs, "slot.block") == _parents(recs, "slot.draws") == {"slot.loop"}
    assert _parents(recs, "dec.block") == _parents(recs, "dec.draws") - {"dec.prefill"} == {"dec.loop"}
    assert _parents(recs, "dec.loop") == {"dec.generate"}
    # each prefill once, never inside another: the slot admission's, the beam loop's, the batch's
    assert _parents(recs, "dec.prefill") == {"slot.admit", "dec.generate"}
    assert _parents(recs, "voc.call") == {"voc.batch"}
    assert _parents(recs, "lat.call") == {"lat.pass"}
    assert _parents(recs, "cond.call") == {"engine.infer", "engine.infer_batch", "slot.submit"}
    # the tiny engine captures nothing: every block and call runs as it is
    assert {r.attrs["event"] for r in recs if r.name.endswith((".block", ".call"))} == {"run"}
    blocks = [r for r in recs if r.name == "dec.block"]
    assert {r.attrs["ran"] for r in blocks} == {BLOCK, MAX_CODES - 1 - BLOCK}
    beam = [r for r in recs if r.name == "dec.generate" and r.attrs["beams"] == 2]
    assert len(beam) == 1 and beam[0].attrs["rows"] == 1
    infer, batch = [r for r in recs if r.name.startswith("engine.")]
    assert infer.attrs["rows"] == 1 and infer.attrs["rid"] < batch.attrs["rid"] and batch.attrs["requests"] == 2
    assert batch.attrs["rows"] == sum(r.attrs["rows"] for r in recs
                                      if r.name == "dec.generate" and r.parent == batch.id)
    assert all(r.t0 <= r.t1 for r in recs)


def test_slot_spans_carry_their_request(traced):
    recs, _notes, rids = traced
    submits = [r for r in recs if r.name == "slot.submit"]
    assert [r.attrs["rid"] for r in submits] == rids and [r.attrs["rows"] for r in submits] == [1, 2]
    admits = [r for r in recs if r.name == "slot.admit"]
    # the streamed request's second sentence queues at the harvest of its first
    assert sorted((r.attrs["rid"], r.attrs["row"]) for r in admits) == [(rids[0], 0), (rids[1], 0), (rids[1], 1)]
    assert all(r.attrs["waited_ns"] >= 0 for r in admits)


def test_a_queued_row_waits_in_its_admission_span(engine):
    """One slot, two requests: the second waits for the first to finish,
    and its wait covers the ticks that ran while it was queued."""
    sess = engine.slot_session(n_slots=1, chunk_steps=10, **SAMPLED)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first, second = sess.submit(_prompt(300), "HI."), sess.submit(_prompt(301), "YO.")
        sess.drain()
    recs = tracing.spans()
    admits = {r.attrs["rid"]: r for r in recs if r.name == "slot.admit"}
    queued = [r for r in recs if r.name == "slot.submit" and r.attrs["rid"] == second][0]
    before = [r for r in recs if r.name == "slot.tick" and queued.t1 <= r.t0 and r.t1 <= admits[second].t0]
    assert len(before) >= 2  # the first request's row decodes MAX_CODES codes in chunks of 10
    assert admits[second].attrs["waited_ns"] >= sum(r.t1 - r.t0 for r in before)
    assert admits[second].attrs["waited_ns"] <= admits[second].t0 - queued.t0
    assert 0 <= admits[first].attrs["waited_ns"] < admits[second].attrs["waited_ns"]


def test_records_join_the_profilers_ranges(traced):
    """By name, order and nesting, one to one; durations within 2 ms (the
    two clocks differ, the lengths may not). A record brackets its range by
    the range's own entry and exit, some microseconds; a thread that loses
    its core inside them adds a scheduler slice (~4 ms) to one span, which
    a loaded machine does to one or two spans of a hundred: at most 5 % of
    the spans may differ by that, and none by more than 10 ms."""
    recs, notes, _rids = traced
    assert [n for _s, _d, n in notes] == [r.name for r in sorted(recs, key=lambda r: r.t0)]
    ordered = sorted(recs, key=lambda r: r.t0)
    index = {r.id: i for i, r in enumerate(ordered)}
    stack, parents = [], []
    for s, d, _n in notes:
        while stack and notes[stack[-1]][0] + notes[stack[-1]][1] <= s:
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(len(parents) - 1)
    assert parents == [index[r.parent] if r.parent else None for r in ordered]
    gaps = [abs(d - (r.t1 - r.t0)) for (_s, d, _n), r in zip(notes, ordered)]
    assert sum(g >= 2_000_000 for g in gaps) <= len(gaps) // 20 and max(gaps) < 10_000_000


def test_the_ring_keeps_its_bound():
    assert tracing._ring.maxlen == tracing.RING == 65536
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(tracing.RING + 3):
            with tracing.span("x"):
                pass
    recs = tracing.spans()
    assert len(recs) == tracing.RING and recs[-1].id - recs[0].id == tracing.RING - 1
    tracing.clear()


def test_start_profiling_exports_the_spans(engine, tmp_path):
    logdir = str(tmp_path / "trace")
    engine.start_profiling(logdir)
    engine.infer(_prompt(400), "HELLO.", None, num_beams=1, **SAMPLED)
    assert engine.stop_profiling() == logdir
    (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert names >= {"engine.infer", "dec.generate", "dec.prefill", "dec.loop", "dec.block", "voc.batch", "voc.call",
                     "cond.call", "lat.pass"}
