"""The captured programs on a mesh (indextts_tpu_torch/graphs.py): which
stage captures, by the device and the mesh's backend, and the decisions the
ranks of a model group must take alike.

The capture rule needs no card: Graphs is built with a stated device and
backend. The decisions are held in spawned gloo groups of CPU processes
(tests/torch_mesh_graph_workers.py, one torch thread each) whose engines run
through recording stages: every stage decides as a capturing stage on an
NCCL mesh does, the card's work stood in for on the CPU, with the measured
pool bytes and a state's lifetime made to differ across the ranks. The
ranks of each model group must log the same decisions (bind, warm,
capture, replay, drop) with the same steps per block; their codes stay
token-exact against one process and the JAX engine under its conftest
mesh (tests/test_torch_mesh_engine.py's `world`)."""

import collections

import numpy as np
import pytest
import torch

from indextts_tpu_torch.graphs import COLLECTIVE_STAGES, Graphs, stage_captures, stage_or_uncaptured
from tests import torch_mesh_graph_workers as gw
from tests import torch_mesh_workers as w
from tests.test_torch_mesh_engine import _jax_codes, _same_codes, _spawn, world  # noqa: F401 (a fixture)

STAGES = ("dec", "slot", "voc", "lat", "cond")
# which stages capture: the CPU, one card, ranks that share a card (gloo), a card a rank (NCCL)
RULE = {
    ("cpu", None): set(),
    ("cuda", None): set(STAGES),
    ("cuda", "gloo"): {"voc", "cond"},
    ("cuda", "nccl"): set(STAGES),
    ("cpu", "gloo"): set(),
}


@pytest.fixture(scope="module")
def tp_rec(world):  # noqa: F811
    return _spawn("tp", 2, world["spec"], str(world["tmp"].mktemp("tp_rec")), gw.run)


@pytest.fixture(scope="module")
def dp_rec(world):  # noqa: F811
    return _spawn("dp", 4, world["spec"], str(world["tmp"].mktemp("dp_rec")), gw.run)


@pytest.fixture(scope="module")
def server_rec(world):  # noqa: F811
    return _spawn("server", 2, world["spec"], str(world["tmp"].mktemp("server_rec")), gw.run)


def _events(log):
    return collections.Counter((stage, event) for stage, event, *_ in log)


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device,backend", list(RULE))
def test_capture_rule(device, backend):
    """Graphs built for a device and a backend: the stages that capture are
    the rule's (a stage with collectives only off gloo), none under
    Graphs.eager(), and none with capture=False; no card needed."""
    g = Graphs(torch.device(device), backend=backend, keep_bytes=1 << 30)
    got = {s.name for s in g.stages() if s.capturing}
    assert got == RULE[(device, backend)]
    assert got == {n for n in STAGES if stage_captures(n, device, backend)}
    with g.eager():
        assert not any(s.capturing for s in g.stages())
    assert all(s.capturing for s in g.stages() if s.name in got)  # eager() put back
    off = Graphs(torch.device(device), backend=backend, capture=False, keep_bytes=0)
    assert not any(s.capturing for s in off.stages())


def test_collective_stages_are_the_gpt_stages():
    """The stages whose calls hold the tensor-parallel GPT's collectives:
    the decode loops' blocks and the latent pass; the vocoder and the
    conditioning encoders are replicated."""
    assert set(COLLECTIVE_STAGES) == {"dec", "slot", "lat"}
    assert not stage_or_uncaptured(None, torch.device("cuda")).capturing


def test_engine_on_a_gloo_mesh_takes_the_rule(tp_rec):
    """A mesh engine's Graphs states the mesh's backend and agrees over the
    model group's host group; on CPU ranks nothing captures."""
    for res in tp_rec:
        assert res["backend"] == "gloo" and res["agree_is_model_host"]
        assert res["rule"] == {n: False for n in STAGES}


# ---------------------------------------------------------------------------
# the ranks' decisions
# ---------------------------------------------------------------------------


def _model_groups(results, tp=2):
    return [results[d * tp:(d + 1) * tp] for d in range(len(results) // tp)]


@pytest.mark.parametrize("group", ["tp", "dp", "server"])
def test_model_group_logs_equal_decisions(group, tp_rec, dp_rec, server_rec):
    """Every rank of a model group logs the same decisions, in the same
    order, with the same steps per block (warm, replay and uncaptured
    runs), although its pool bytes and its states' lifetimes differ from
    its partner's; the requests bind new and free lanes, warm, capture,
    replay and drop."""
    results = {"tp": tp_rec, "dp": dp_rec, "server": server_rec}[group]
    for ranks in _model_groups(results):
        logs = [res["log"] for res in ranks]
        assert len(logs[0]) > 0
        for other in logs[1:]:
            assert other == logs[0]
        events = _events(logs[0])
        for event in ("warm", "capture", "replay"):
            assert sum(n for (_s, e), n in events.items() if e == event) > 0, event
    if group == "tp":
        events = _events(tp_rec[0]["log"])
        assert events[("dec", "drop")] > 0 and events[("voc", "drop")] > 0
        binds = {detail for stage, event, _k, _n, detail in tp_rec[0]["log"] if event == "bind"}
        assert binds == {"new", "free", "own"}


def test_blocks_ran_mid_block(tp_rec):
    """The decode blocks replay with the steps the loop's condition allowed:
    the 10-code requests run 9 steps, a block of 16 that stops early."""
    ran = [detail for stage, event, _k, _n, detail in tp_rec[0]["log"]
           if stage == "dec" and event in ("warm", "replay")]
    assert ran and all(0 <= r <= 16 for r in ran) and any(0 < r < 16 for r in ran)


def test_pool_bytes_agreed(tp_rec, dp_rec):
    """Each rank reported its own pool growth per capture; every lane keeps
    the largest of its model group's."""
    for results in (tp_rec, dp_rec):
        for ranks in _model_groups(results):
            reported = [res["measured"] for res in ranks]
            assert reported[0] != reported[1]
            assert all(ranks[0]["pool_bytes"] == res["pool_bytes"] for res in ranks)
            top = max(max(v, default=0) for res in ranks for v in res["measured"].values())
            assert all(b == top for lanes in ranks[0]["pool_bytes"].values() for b in lanes)


def test_held_state_takes_a_new_lane(tp_rec):
    """Rank 1 still holds the first greedy request's state when the second
    binds the same key: on both ranks the second request takes a new lane
    (not the free lane rank 0 alone sees) and warms it; after a request of
    another key, the third takes the second one's lane, free on both."""
    binds = [(k, n, d) for stage, event, k, n, d in tp_rec[0]["log"] if stage == "dec" and event == "bind"]
    (k0, n0, d0), (k1, n1, d1), _sampled, (k3, n3, d3) = binds[:4]
    assert (d0, d1) == ("new", "new") and k0 == k1 and n0 != n1
    assert (k3, n3, d3) == (k1, n1, "free")  # the third request replays the second one's lane


def test_recorded_codes_match_one_process_and_jax_mesh(world, tp_rec, dp_rec):  # noqa: F811
    """Through the recording stages the greedy codes stay token-exact
    against one process and the JAX engine under its mesh; sampled codes
    and the generator state after them are one process's."""
    spec, single = world["spec"], world["single"]
    want = w.decode(single, spec, "4", w.GREEDY)
    _same_codes(want, _jax_codes(world["jm"], spec, "4"))
    want5 = w.decode(single, spec, "5", w.GREEDY)
    sampled = w.decode(single, spec, "4", w.SAMPLED, w.SAMPLED_KNOBS, seed=7)
    state = single._generator.get_state().numpy()
    for res in tp_rec + dp_rec:
        _same_codes(res["greedy4"], want)
        _same_codes(res["sampled4"], sampled)
    for res in tp_rec:
        _same_codes(res["greedy4_again"], want)
        _same_codes(res["greedy4_third"], want)
        _same_codes(res["greedy4_last"], want)
    for res in dp_rec:
        _same_codes(res["greedy5"], want5)
        np.testing.assert_array_equal(res["generator_state"], state)


def test_recorded_requests_match_one_process(world, tp_rec, dp_rec):  # noqa: F811
    """infer (twice), infer_batch, slots, a stream and the beams through
    the recording stages give one process's wavs and codes."""
    spec, single = world["spec"], world["single"]
    solo = single.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)
    beams = w.decode(single, spec, "4", w.BEAMS)
    items = [(spec["mel"], "HELLO WORLD."), (spec["mel"], "GOOD DAY."), (spec["mel"], "HI.")]
    batch = single.infer_batch(items, **w.SOLO)
    for res in tp_rec + dp_rec:
        assert res["solo"][1].shape == solo[1].shape
        assert np.abs(res["solo"][1].astype(np.int32) - solo[1].astype(np.int32)).max() <= 2
    for res in dp_rec:  # the second infer replays its latent and vocoder keys
        np.testing.assert_array_equal(res["solo_again"][1], res["solo"][1])
    for res in tp_rec:
        _same_codes(res["beams4"], beams)
        assert len(res["stream"]) > 1 and all(n > 0 for n in res["stream"])
        for (_, got), (_, want) in zip(res["batch"], batch):
            assert got.shape == want.shape and np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
        for (_, got), (_, want) in zip(res["slots"], res["batch"]):
            assert got.shape == want.shape and np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_server_follower_captures_as_rank_0(server_rec):
    """The follower replays rank 0's warmup and requests: the same keys
    warmed, captured and replayed in the same order, and the request after
    the warmup replays its keys."""
    lead, follower = server_rec
    assert follower["followed"] and lead["log"] == follower["log"]
    assert lead["warmup_s"] > 0 and lead["solo"][1].shape[0] > 0 and lead["again"][1].shape == lead["solo"][1].shape
    events = _events(lead["log"])
    assert events[("dec", "capture")] > 0 and events[("voc", "replay")] > 0
