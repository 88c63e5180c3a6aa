"""The ranks of tests/test_torch_mesh_graphs.py: spawned gloo groups of CPU
processes (as tests/torch_mesh_workers.py, whose helpers they use), each
rank's engine running its requests through graph stages in a recording
mode. Torch only: a spawned child imports this module, and no jax.

A recording stage decides as a capturing stage on a card does (bind, warm,
capture, replay, drop; graphs.py), with the card's work stood in for on the
CPU: a capture runs nothing (on the card it launches nothing) and reports
pool bytes of the rank's own, different on every rank; a replay runs the
eager block or call of the current functions. Two inputs of the decisions
are made to differ across the ranks on purpose: the measured pool bytes, and
the lifetime of a decode state (odd ranks hold their last state until the
next one is bound, as a garbage collector that has not run yet would).
Each rank returns its stages' decision log, its codes and its lanes' pool
bytes.
"""

from __future__ import annotations

from collections import deque

import torch
import torch.distributed as dist

from indextts_tpu_torch.graphs import GraphStage, Graphs
from tests import torch_mesh_workers as w

# what a recording capture says the pool grew by: this many bytes times the rank + 1
POOL_UNIT = 1 << 20
# the stages' lane limits: small, so that the requests evict lanes
LIMITS = {"dec": 3, "slot": 1, "voc": 2, "lat": 2, "cond": 2}
# free lanes are kept within this many bytes: at tp = 2 two captured lanes of
# the agreed pool growth (2 units each) fit and three do not; rank 0's own
# growth (1 unit) would keep five
KEEP_BYTES = 5 * POOL_UNIT


class RecordingStage(GraphStage):
    """A stage that takes every decision of a capturing stage on the CPU
    (the module docstring). Odd ranks keep a strong reference to the last
    state bound, so its lane stays held longer than on even ranks."""

    def __init__(self, *args):
        super().__init__(*args)
        self.captures = True
        self.measured = []  # the pool growth this rank reported for each capture
        self.held = deque(maxlen=1) if dist.get_rank() % 2 else None

    def bind(self, key, owner, holders):
        lane = super().bind(key, owner, holders)
        if self.held is not None:
            self.held.append(owner)  # the state bound before it goes now
        return lane

    def _warm(self, fn):
        return fn()

    def _capture(self, lane, fns, keep_graph=False):
        out = None if keep_graph else fns[-1]()  # a call's static output
        grown = POOL_UNIT * (dist.get_rank() + 1)
        self.measured.append(grown)
        self._pool_grew(lane, grown)
        return [None] * len(fns), out

    def _assemble(self, lane, graphs):
        return "block"

    def run(self, lane, step, live, budget):
        self.now = (step, live)  # what a replay of this block runs
        return super().run(lane, step, live, budget)

    def call(self, key, fn, inputs):
        self.now = fn  # what a replay of this call runs
        return super().call(key, fn, inputs)

    def _replay(self, lane):
        lane.replays += 1
        if lane.ctl is not None:  # a loop's block
            self._block(lane, *self._head_body(lane.ctl, *self.now))
        else:
            lane.outputs.copy_(self.now(*lane.tensors))


class RecordingGraphs(Graphs):
    """An engine's Graphs with recording stages, as on an NCCL mesh (every
    stage captures), agreeing over the engine's model group."""

    def __init__(self, engine):
        super().__init__(engine.device, backend="nccl", agree=engine.mesh.model_host, keep_bytes=KEEP_BYTES)
        self.decode, self.slot, self.vocoder, self.latent, self.cond = (
            RecordingStage(name, self, LIMITS[name]) for name in ("dec", "slot", "voc", "lat", "cond"))


def recorded(e, out: dict) -> dict:
    """The rank's decision log and pool bytes (reported, and the lanes'
    agreed ones), into `out`."""
    g = e._graphs
    out["log"] = list(g.log)
    out["measured"] = {s.name: list(s.measured) for s in g.stages()}
    out["pool_bytes"] = {s.name: [lane.pool_bytes for lane in s.lanes.values()] for s in g.stages()}
    return out


def run(rank: int, world: int, port: int, kind: str, spec, out_dir: str) -> None:
    """One rank of a spawned group (torch_mesh_workers.run, with this
    module's groups)."""
    w.run(rank, world, port, kind, spec, out_dir, groups={"tp": tp_group, "dp": dp_group, "server": server_group})


def tp_group(rank, spec, out_dir):
    """tp = 2 on 2 ranks: the engine's own stages (the gloo mesh's rule),
    then recording stages through greedy rows twice (the second request
    finds the first one's lane held on rank 1 only), sampled rows, greedy
    rows a third time (the second one's lane now free on both ranks), beams,
    infer, a stream, infer_batch and slots, and greedy rows again."""
    e = w.engine(spec, True, tp=2)
    own = e._graphs
    out = {"rule": {s.name: s.captures for s in own.stages()}, "backend": own.backend,
           "agree_is_model_host": own.agree is e.mesh.model_host}
    e._graphs = RecordingGraphs(e)
    out["greedy4"] = w.decode(e, spec, "4", w.GREEDY)
    out["greedy4_again"] = w.decode(e, spec, "4", w.GREEDY)
    out["sampled4"] = w.decode(e, spec, "4", w.SAMPLED, w.SAMPLED_KNOBS, seed=7)
    out["greedy4_third"] = w.decode(e, spec, "4", w.GREEDY)
    out["beams4"] = w.decode(e, spec, "4", w.BEAMS)
    out["solo"] = e.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)
    out["stream"] = [c.size for c in e.infer_stream(spec["mel"], "HELLO WORLD. GOOD DAY.", first_chunk_codes=4,
                                                    chunk_codes=4, **w.SOLO)]
    items = [(spec["mel"], "HELLO WORLD."), (spec["mel"], "GOOD DAY."), (spec["mel"], "HI.")]
    out["batch"] = e.infer_batch(items, **w.SOLO)
    out["slots"] = e.infer_slots(items, n_slots=2, **w.SOLO)
    out["greedy4_last"] = w.decode(e, spec, "4", w.GREEDY)
    return recorded(e, out)


def dp_group(rank, spec, out_dir):
    """dp = 2 x tp = 2 on 4 ranks, recording stages: greedy rows of 4 and
    of 5, sampled rows with the generator state after them, infer twice,
    _vocode_many and the int8-KV beams."""
    e = w.engine(spec, True, tp=2)
    e._graphs = RecordingGraphs(e)
    out = {"greedy4": w.decode(e, spec, "4", w.GREEDY), "greedy5": w.decode(e, spec, "5", w.GREEDY)}
    out["sampled4"] = w.decode(e, spec, "4", w.SAMPLED, w.SAMPLED_KNOBS, seed=7)
    out["generator_state"] = e._generator.get_state().numpy()
    out["solo"] = e.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)
    out["solo_again"] = e.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)  # its latent and vocoder keys replay
    with torch.no_grad():
        out["vocode_many"] = e._vocode_many(w.vocoder_chunks(spec))
    e.quant_kv = True
    out["beams_int8_kv"] = w.decode(e, spec, "4", w.BEAMS)
    return recorded(e, out)


def server_group(rank, spec, out_dir):
    """The web server on tp = 2 with recording stages: rank 0 warms up and
    serves a request and a stream through the proxy; rank 1 follows, and
    so warms, captures and replays the same keys in the same order."""
    from indextts_tpu_torch.server.mesh_proxy import EngineProxy, follow

    e = w.engine(spec, True, tp=2)
    e._graphs = RecordingGraphs(e)
    if rank != 0:
        follow(e)
        return recorded(e, {"followed": True})
    proxy = EngineProxy(e)
    try:
        out = {"warmup_s": proxy.warmup(texts=("WARM UP.",), verbose=False, **w.SOLO)}
        out["solo"] = proxy.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)
        out["stream"] = [c.size for c in proxy.infer_stream(spec["mel"], "HELLO WORLD.", first_chunk_codes=4,
                                                            chunk_codes=4, **w.SOLO)]
        out["again"] = proxy.infer(spec["mel"], "HELLO WORLD.", None, **w.SOLO)
    finally:
        proxy.stop()
    return recorded(e, out)
