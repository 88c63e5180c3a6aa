"""Captured step programs: the port's counterpart of the JAX engine's
compiled programs over static shape buckets (indextts_tpu/engine.py:9,
`_decode_fn`, `_vocoder_fn`).

JAX keeps one jitted program per key (`("dec", b, l, gen, capture,
quant_kv)`, `("voc", b, m, frames, int16_out)`); a decode loop is one
`lax.while_loop` inside it. Here a decode loop's STEP, and a whole vocoder
call, is captured once per key as a `torch.cuda.CUDAGraph` and replayed after
that; the host keeps its one check per step (every row stopped, the beams'
early stop), so a loop runs exactly the steps JAX's while_loop runs.

What a captured step needs, and how the loops give it:

* Fixed addresses. A key owns one set of static buffers (the decode state:
  codes, KV cache, masks, the step counter, the per-row sampling knobs and
  the uniforms of the next draw). The first state bound to a key becomes its
  buffers; a later one is copied into them (`GraphStage.bind`), so the
  prefill's output lands in the key's buffers. A lane of a key belongs to
  one live state at a time (held by a weak reference): two streams decoding
  at one key at once take two lanes. No two lanes share a buffer: a state
  that moves to a new key (a grown cache) takes copies of the tensors its
  old lane keeps, so a later state bound to the old key cannot write into
  the moved one.
* No host reads and no shapes that depend on data inside the step: the step
  index is a device counter, cache slots and codes are written by
  `index_copy_`, and the random draw of a step is made outside the graph,
  into the static uniforms buffer, right before the replay, from the same
  generator in the same order as the eager loop draws it.
* Warm before capture: the first step of a key runs eagerly on a side
  stream (it is that step: the state advances once), which builds every
  kernel library, K2's packed weights, the snake parameters and
  cudaFuncSetAttribute's shared-memory sizes, and lets cuDNN and cuBLAS pick
  their algorithms; then the same step is captured, which launches nothing.
  A vocoder key's first call is its warm run, and is captured after it;
  every later call replays. So each step and each call runs once, and the
  first one of a key runs eagerly.
* The kernel wrappers count their launches on the host, which a replay does
  not run: the counts a capture adds are taken back and added on every
  replay, so K1-K5's `launches` count what ran on the card.

The graphs of a stage share one memory pool; only temporaries live there
(the steps write their results into the static buffers), and the graphs of
one engine replay one after another on one stream. A lane keeps its buffers
and its graph after its state is gone, for the key's next request: a stage
keeps at most `limit` lanes, and its free lanes only while all its lanes
hold at most `keep_bytes` (buffers and the memory each capture added to
the pool); beyond either it drops the least recently used free lanes.

Nothing falls back: a capture or a replay that fails raises. `Graphs.eager()`
is the private switch that runs the same steps, on the same static buffers,
without capture (chip_smoke.py compares the two, and it is the way to debug
on the card). The loops always run their steps through a stage: on the CPU,
and on a multi-device engine (parallel/mesh.py, `capture=False`: gloo's
collectives are host round trips that a graph cannot hold), the stage runs
the same bound steps without capture.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _counters() -> Dict[Any, int]:
    """The kernel wrappers' launch counters (K1-K5), by module."""
    from indextts_tpu_torch.ops.cuda import aa_conv_branch, antialias, antialias_folded, antialias_tmajor, qmatmul

    return {m: m.launches for m in (antialias, aa_conv_branch, antialias_tmajor, antialias_folded, qmatmul)}


def _flatten(holders: Sequence[Tuple[Any, Sequence[str]]]) -> List[torch.Tensor]:
    """The tensors of each (object, attribute names) pair, a tuple attribute
    (a KV cache) element by element; None attributes are skipped."""
    out = []
    for obj, names in holders:
        for name in names:
            v = getattr(obj, name)
            if isinstance(v, tuple):
                out.extend(v)
            elif v is not None:
                out.append(v)
    return out


def _unflatten(holders: Sequence[Tuple[Any, Sequence[str]]], tensors: List[torch.Tensor]) -> None:
    """Point every attribute _flatten read at the matching tensor of `tensors`."""
    it = iter(tensors)
    for obj, names in holders:
        for name in names:
            v = getattr(obj, name)
            if isinstance(v, tuple):
                setattr(obj, name, tuple(next(it) for _ in v))
            elif v is not None:
                setattr(obj, name, next(it))


def weights_key(module: torch.nn.Module) -> int:
    """A captured program reads a model's weights at fixed addresses: this
    fingerprint of the module's tensors (their addresses) goes into every
    key, so that a module that swapped or moved its weights (int8
    quantization, `.to`) is captured anew; weights updated in place keep
    their graphs."""
    import itertools

    return hash((id(module),) + tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers())))


def _storages(tensors) -> Dict[int, int]:
    """The device storages of `tensors`, as {address: bytes}."""
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}


class Lane:
    """One set of static buffers of a key, and the graph captured on them."""

    def __init__(self, key, tensors: List[torch.Tensor]):
        self.key = key
        self.tensors = tensors
        self.owner: Optional[weakref.ref] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.deltas: Dict[Any, int] = {}
        self.outputs: Any = None  # a called function's static outputs (vocoder keys)
        self.capture_s = 0.0
        self.pool_bytes = 0  # device memory the capture reserved (the pool's growth)
        self.replays = 0

    def free_for(self, owner) -> bool:
        held = None if self.owner is None else self.owner()
        return held is None or held is owner

    def buffer_bytes(self) -> int:
        """The bytes of the static buffers the lane keeps (inputs, state,
        outputs), each storage once."""
        outs = [] if self.outputs is None else [self.outputs]
        return sum(_storages(self.tensors + outs).values())

    def nbytes(self) -> int:
        return self.buffer_bytes() + self.pool_bytes


class GraphStage:
    """The captured programs of one stage ("dec", "slot" or "voc"): lanes of
    static buffers by key, one CUDA graph each, one memory pool."""

    def __init__(self, name: str, graphs: "Graphs", limit: int):
        self.name, self.graphs, self.limit = name, graphs, limit
        self.keep_bytes = graphs.keep_bytes
        self.lanes: "OrderedDict[Tuple[Any, int], Lane]" = OrderedDict()
        self._pool = None

    @property
    def capturing(self) -> bool:
        """Whether run / call capture and replay (a capturing CUDA engine
        outside Graphs.eager()); otherwise they run the function as it is."""
        return self.graphs.capture and self.graphs.device.type == "cuda" and self.graphs.enabled

    # -- static buffers ---------------------------------------------------

    def bind(self, key, owner, holders: Sequence[Tuple[Any, Sequence[str]]]) -> Lane:
        """Give `owner` (a decode state, held weakly) a lane of `key` and
        point the holders' tensor attributes at its buffers: a new lane takes
        the holders' tensors as they are, or copies of those another lane
        keeps; a lane that held another state gets them copied in; the
        owner's own lane only copies what changed objects (per-call inputs
        such as a session's knob columns). The owner's lanes of other keys
        are freed (a grown cache moves to a new key)."""
        live = _flatten(holders)
        lane = None
        for (k, _n), cand in self.lanes.items():
            if cand.owner is not None and cand.owner() is owner and k != key:
                cand.owner = None
            elif k == key and lane is None and cand.free_for(owner):
                lane = cand
        if lane is None:
            kept = _storages(t for cand in self.lanes.values() for t in cand.tensors)
            tensors = [t.clone() if t.untyped_storage().data_ptr() in kept else t for t in live]
            _unflatten(holders, tensors)
            lane = Lane(key, tensors)
            n = next(n for n in range(len(self.lanes) + 1) if (key, n) not in self.lanes)
            self.lanes[(key, n)] = lane
        else:
            if len(lane.tensors) != len(live):
                raise RuntimeError(f"{self.name} graph key {key}: {len(live)} tensors bound to a lane of "
                                   f"{len(lane.tensors)}")
            for s, t in zip(lane.tensors, live):
                if s is t:
                    continue
                if s.shape != t.shape or s.dtype != t.dtype or s.device != t.device:
                    raise RuntimeError(f"{self.name} graph key {key}: a {t.dtype} {tuple(t.shape)} on {t.device} "
                                       f"bound to a {s.dtype} {tuple(s.shape)} buffer on {s.device}")
                s.copy_(t)
            _unflatten(holders, lane.tensors)
        lane.owner = weakref.ref(owner)
        self.lanes.move_to_end(next(k for k, v in self.lanes.items() if v is lane))
        self._evict()
        return lane

    def _evict(self) -> None:
        """Drop the least recently used free lanes while the stage keeps more
        than `limit` lanes or its lanes hold more than `keep_bytes`."""
        sizes = {k: lane.nbytes() for k, lane in self.lanes.items()}
        total = sum(sizes.values())
        for k in [k for k, lane in self.lanes.items() if lane.free_for(None)]:
            if len(self.lanes) <= self.limit and total <= self.keep_bytes:
                break
            total -= sizes[k]
            del self.lanes[k]

    def resident_bytes(self) -> int:
        """What the stage's lanes keep on their device: buffers and pool growth."""
        return sum(lane.nbytes() for lane in self.lanes.values())

    # -- capture and replay -------------------------------------------------

    def _pool_handle(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture(self, lane: Lane, fn: Callable[[], Any]):
        """Capture fn() into lane.graph (it launches nothing) and keep what
        it returns; the launch counts it added move to lane.deltas."""
        dev = self.graphs.device
        before = _counters()
        # torch.cuda.graph empties the allocator's cache as it starts: empty it
        # first, so that the growth of the reserved memory is the capture's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool_handle(), capture_error_mode="thread_local"):
            out = fn()
        lane.capture_s = time.perf_counter() - t0
        lane.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = _counters()
        for m, n in before.items():
            m.launches = n
        lane.deltas = {m: after[m] - n for m, n in before.items() if after[m] != n}
        lane.graph = graph
        return out

    def _warm(self, fn: Callable[[], Any]):
        """fn() eagerly on a side stream, ordered against the current one."""
        cur = torch.cuda.current_stream(self.graphs.device)
        if self.graphs.side_stream is None:
            self.graphs.side_stream = torch.cuda.Stream(self.graphs.device)
        side = self.graphs.side_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def _replay(self, lane: Lane) -> None:
        lane.graph.replay()
        lane.replays += 1
        for m, n in lane.deltas.items():
            m.launches += n

    def run(self, lane: Lane, fn: Callable[[], None]) -> None:
        """One step of a bound loop: fn() updates the lane's buffers in
        place. The first step of a lane runs eagerly (warm) and is then
        captured; every later step replays."""
        if not self.capturing:
            fn()
        elif lane.graph is None:
            self._warm(fn)
            self._capture(lane, fn)
            self._evict()
        else:
            self._replay(lane)

    def call(self, key, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """fn(*inputs) as a captured program of `key`: the inputs are copied
        into the key's static inputs and the graph replayed; returns a copy
        of its output. The first call of a key runs fn eagerly (warm) on the
        static inputs, returns that, and captures fn."""
        if not self.capturing:
            return fn(*inputs)
        lane = self.lanes.get((key, 0))
        if lane is None:
            lane = Lane(key, [t.clone() for t in inputs])
            self.lanes[(key, 0)] = lane
            out = self._warm(lambda: fn(*lane.tensors))
            lane.outputs = self._capture(lane, lambda: fn(*lane.tensors))
            self._evict()
            return out
        self.lanes.move_to_end((key, 0))
        for s, t in zip(lane.tensors, inputs):
            s.copy_(t)
        self._replay(lane)
        return lane.outputs.clone()

    def stats(self) -> List[Dict[str, Any]]:
        """One row per lane: its key, whether a state holds it, capture
        seconds, the bytes of its static buffers, the memory its capture
        added to the pool, and its replays."""
        return [{"key": repr(lane.key), "lane": n, "live": not lane.free_for(None), "captured": lane.graph is not None,
                 "capture_s": lane.capture_s, "buffer_bytes": lane.buffer_bytes(), "pool_bytes": lane.pool_bytes,
                 "replays": lane.replays}
                for (_k, n), lane in self.lanes.items()]


class Graphs:
    """An engine's captured programs, by stage: `decode` (the greedy /
    sampled and the beam loops' steps), `slot` (slot_steps) and `vocoder`
    (a whole bigvgan_apply call). `capture=False` (a multi-device engine)
    runs every stage's steps without capture, as the CPU does.

    What a stage keeps: at most `limit` lanes (16 decode keys, 4 slot
    sessions, 32 vocoder keys), and its free lanes only while all its lanes
    hold at most `keep_bytes`, an eighth of the card's memory (1 GiB on the
    CPU): a decode lane holds its key's whole KV cache, k and v of [layers,
    rows x beams, heads, slots, head dim] each, so a few lanes of large
    batches reach the budget before the count does."""

    def __init__(self, device, capture: bool = True, keep_bytes: Optional[int] = None):
        self.device = torch.device(device)
        self.capture = capture
        self.enabled = True
        self.side_stream = None  # where a key's first run warms, made at the first capture
        if keep_bytes is None:
            keep_bytes = (torch.cuda.get_device_properties(self.device).total_memory // 8
                          if self.device.type == "cuda" else 1 << 30)
        self.keep_bytes = keep_bytes
        self.decode = GraphStage("dec", self, 16)
        self.slot = GraphStage("slot", self, 4)
        self.vocoder = GraphStage("voc", self, 32)

    @contextlib.contextmanager
    def eager(self):
        """Run the steps eagerly, on the same static buffers, inside the
        block: the comparison and debugging path; nothing else turns capture
        off."""
        was, self.enabled = self.enabled, False
        try:
            yield
        finally:
            self.enabled = was

    def stats(self) -> Dict[str, List[Dict[str, Any]]]:
        return {s.name: s.stats() for s in (self.decode, self.slot, self.vocoder)}


def stage_or_uncaptured(stage: Optional[GraphStage], device) -> GraphStage:
    """`stage`, or for a loop run without an engine's stage, a stage of its
    own that runs the same bound steps without capture."""
    return stage if stage is not None else Graphs(device, capture=False, keep_bytes=0).decode
