"""Captured device programs: the port's counterpart of the JAX engine's
compiled programs over static shape buckets (indextts_tpu/engine.py:9,
`_decode_fn`, `_vocoder_fn`, `_latent_fn`, the conditioning programs).

JAX keeps one jitted program per key (`("dec", b, l, gen, capture,
quant_kv)`, `("voc", b, m, frames, int16_out)`, `("lat", b, l_text,
l_code)`, `("cond", bucket)`); a decode loop is one `lax.while_loop` inside
its program, the condition evaluated on the device. Here a decode loop runs
in BLOCKS of `BLOCK` steps: one CUDA graph per key holds BLOCK copies of the
captured step, step j inside a conditional IF node whose predicate the card
computes just before it (the steps before it ran, the host's budget for the
block, and the loop's own condition: a row still live, the beams' early
stop, a slot still active), so the steps after a stop are skipped on the
card as the while_loop skips them. The host replays a block and then reads
one small tensor (the steps the block ran, the condition after them): one
read per BLOCK steps. A vocoder call, a teacher-forced latent pass and a
conditioning pass are each captured once per key and replayed whole.

What a captured block needs, and how the loops give it:

* Fixed addresses. A key owns one set of static buffers (the decode state:
  codes, KV cache, masks, the step counter, the per-row sampling knobs and
  the uniforms of the block's steps) and the block's control buffers
  (`BlockControl`). The first state bound to a key becomes its buffers; a
  later one is copied into them (`GraphStage.bind`), so the prefill's output
  lands in the key's buffers. A lane of a key belongs to one live state at a
  time (held by a weak reference): two streams decoding at one key at once
  take two lanes. No two lanes share a buffer: a state that moves to a new
  key (a grown cache) takes copies of the tensors its old lane keeps, so a
  later state bound to the old key cannot write into the moved one.
* No host reads and no shapes that depend on data inside the step: the step
  index is a device counter, cache slots and codes are written by
  `index_copy_`, and the random draws of a block are made outside the graph,
  before the replay, one per step the budget allows, from the same generator
  in the same order as the steps consume them, into rows of a [BLOCK, ...]
  buffer; step j reads row `ctl.ran` (j) of it.
* Warm before capture: a key's first block runs eagerly on a side stream (it
  is that block: the state advances), which builds every kernel library, K2's
  packed weights, the snake parameters and cudaFuncSetAttribute's
  shared-memory sizes, and lets cuDNN and cuBLAS pick their algorithms; once
  a warm block has run a step, the block's head and one step are captured
  (which launches nothing) and assembled into the block graph
  (ops/cuda/graph_block.py). Every later block replays it. A vocoder,
  latent or conditioning key's first call is its warm run, captured after it.
* The kernel wrappers count their launches on the host, which a replay does
  not run: the counts a capture adds are taken back, per step for a block
  (the step is captured once) and per call otherwise, and a replay adds them
  times the steps it ran (read back with the block's status), so K1-K5's
  `launches` count what ran on the card.

The graphs of a stage share one memory pool; only temporaries live there
(the steps write their results into the static buffers), the BLOCK copies of
a step share one step's temporaries, and the graphs of one engine replay one
after another on one stream. A lane keeps its buffers and its graph after
its state is gone, for the key's next request: a stage keeps at most `limit`
lanes, and its free lanes only while all its lanes hold at most
`keep_bytes` (buffers and the memory each capture added to the pool);
beyond either it drops the least recently used free lanes.

Nothing falls back: a capture, a block's assembly or a replay that fails
raises. `Graphs.eager()` is the private switch that runs the same blocks, on
the same static buffers, without capture, the IF decided on the host
(chip_smoke.py compares the two, and it is the way to debug on the card).
The loops always run their blocks through a stage: on the CPU, and on a
multi-device engine (parallel/mesh.py, `capture=False`: gloo's collectives
are host round trips that a graph cannot hold), the stage runs the same
head and steps without capture.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# the steps of a decode loop's block: one captured graph holds BLOCK
# conditional steps, and the host reads the device once per block
BLOCK = 16


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


def block_row(buf: Optional[torch.Tensor], ran: torch.Tensor) -> Optional[torch.Tensor]:
    """Row `ran` ([1] long, a step's place in its block: BlockControl.ran)
    of a block's [BLOCK, ...] draws buffer; None for None (a greedy loop)."""
    return None if buf is None else buf.index_select(0, ran)[0]


class BlockControl:
    """A loop lane's block control, on the lane's device: `status` int64 [2]
    (the steps this block has run, and the loop's condition as the last
    step left it) and `budget` int64 [1] (the steps the host allows the
    block, written before each block). `ran` is status[:1], the index of
    the block's next step: the row of the block's uniforms it reads."""

    def __init__(self, device):
        self.status = torch.zeros(2, dtype=torch.long, device=device)
        self.budget = torch.zeros(1, dtype=torch.long, device=device)
        self.ran = self.status[:1]
        self.live = self.status[1:]

    def holds(self) -> torch.Tensor:
        """The next step's predicate: inside the budget and the condition
        holds (what the block graph's predicate kernel computes)."""
        return (self.ran < self.budget) & (self.live != 0)


class Lane:
    """One set of static buffers of a key, and the graph captured on them."""

    def __init__(self, key, tensors: List[torch.Tensor]):
        self.key = key
        self.tensors = tensors
        self.owner: Optional[weakref.ref] = None
        self.graph: Any = None  # a torch.cuda.CUDAGraph (a call) or a BlockGraph (a loop)
        self.ctl: Optional[BlockControl] = None  # a loop lane's block control
        self.deltas: Dict[Any, int] = {}  # launches a replay adds: per step (a loop), per call otherwise
        self.outputs: Any = None  # a called function's static outputs (vocoder, latent, conditioning keys)
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
    """The captured programs of one stage ("dec", "slot", "voc", "lat" or
    "cond"): lanes of static buffers by key, one CUDA graph each, one memory
    pool."""

    def __init__(self, name: str, graphs: "Graphs", limit: int):
        self.name, self.graphs, self.limit = name, graphs, limit
        self.keep_bytes = graphs.keep_bytes
        self.lanes: "OrderedDict[Tuple[Any, int], Lane]" = OrderedDict()
        self._pool = None
        self.reads = 0  # the blocks' host reads, one per block

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
        keeps; a lane that held another state gets them copied in (a free
        lane with a graph before one without: the state then replays at
        once); the owner's own lane only copies what changed objects
        (per-call inputs such as a session's knob columns). The owner's lanes
        of other keys are freed (a grown cache moves to a new key)."""
        live = _flatten(holders)
        own = free = None
        for (k, _n), cand in self.lanes.items():
            held = None if cand.owner is None else cand.owner()
            if held is owner and k != key:
                cand.owner = None
            elif k == key and held is owner:
                own = cand
            elif k == key and held is None and (free is None or (free.graph is None and cand.graph is not None)):
                free = cand
        lane = own or free
        if lane is None:
            kept = _storages(t for cand in self.lanes.values() for t in cand.tensors)
            tensors = [t.clone() if t.untyped_storage().data_ptr() in kept else t for t in live]
            _unflatten(holders, tensors)
            lane = Lane(key, tensors)
            lane.ctl = BlockControl(tensors[0].device)
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

    @staticmethod
    @contextlib.contextmanager
    def _counts_to(lane: Lane):
        """The launch counts the kernel wrappers add inside the `with` (a
        capture, which launches nothing) are taken back and kept in
        lane.deltas, what a replay adds per step or call."""
        before = _counters()
        try:
            yield
        finally:
            after = _counters()
            for m, n in before.items():
                m.launches = n
            lane.deltas = {m: after[m] - n for m, n in before.items() if after[m] != n}

    def _capture(self, lane: Lane, fns: Sequence[Callable[[], Any]], keep_graph: bool = False):
        """Capture each of fns into a CUDA graph of its own (they launch
        nothing); returns the graphs and what the last fn returned. The
        launch counts they added move to lane.deltas; the capture seconds
        and the pool's growth go to the lane."""
        dev = self.graphs.device
        with self._counts_to(lane):
            # torch.cuda.graph empties the allocator's cache as it starts: empty it
            # first, so that the growth of the reserved memory is the capture's
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            graphs, out = [], None
            for fn in fns:
                graph = torch.cuda.CUDAGraph(keep_graph=True) if keep_graph else torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool_handle(), capture_error_mode="thread_local"):
                    out = fn()
                graphs.append(graph)
            lane.capture_s = time.perf_counter() - t0
            lane.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        return graphs, out

    def _assemble(self, lane: Lane, graphs) -> Any:
        """The block graph of a lane from its captured head and step."""
        from indextts_tpu_torch.ops.cuda.graph_block import BlockGraph

        head, step = graphs
        return BlockGraph(head, step, BLOCK, lane.ctl.status, lane.ctl.budget)

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

    def _count(self, lane: Lane, times: int) -> None:
        """Add a replay's launches: the capture's counts, `times` over."""
        for m, n in lane.deltas.items():
            m.launches += n * times

    # -- a loop's block -------------------------------------------------------

    def _holds(self, ctl: BlockControl) -> bool:
        """The IF of a block run without capture: the next step's predicate,
        read on the host."""
        return bool(ctl.holds())

    def _block(self, lane: Lane, head: Callable[[], None], body: Callable[[], None]) -> None:
        """A block without capture: head(), then body() while the predicate
        holds (once it fails it stays failed: the state no longer moves)."""
        head()
        for _ in range(BLOCK):
            if not self._holds(lane.ctl):
                break
            body()

    def _read(self, ctl: BlockControl) -> Tuple[int, bool]:
        """The block's one host read: (steps run, the loop's condition)."""
        self.reads += 1
        ran, live = ctl.status.to("cpu", copy=True).tolist()
        return ran, bool(live)

    def run(self, lane: Lane, step: Callable[[], None], live: Callable[[], torch.Tensor],
            budget: int) -> Tuple[int, bool]:
        """One block of a bound loop: up to min(budget, BLOCK) steps, each
        run while the steps before it ran and live() holds. step() updates
        the lane's buffers in place and finds its place in the block at
        lane.ctl.ran; live() is the loop's condition, a one-element bool
        tensor computed from the buffers. Returns (steps run, live() after
        them), the block's one host read. A lane's first block runs eagerly
        (warm); once a block has run a step, the block is captured, and later
        blocks replay it."""
        ctl = lane.ctl
        ctl.budget.fill_(min(int(budget), BLOCK))

        def head():
            ctl.status.zero_()
            ctl.live.copy_(live().reshape(1))

        def body():
            step()
            ctl.ran.add_(1)
            ctl.live.copy_(live().reshape(1))

        if not self.capturing:
            self._block(lane, head, body)
            return self._read(ctl)
        if lane.graph is not None:
            self._replay(lane)
            ran, alive = self._read(ctl)
            self._count(lane, ran)
            return ran, alive
        self._warm(lambda: self._block(lane, head, body))
        ran, alive = self._read(ctl)
        if ran > 0:  # capture only a step that has run warm
            graphs, _ = self._capture(lane, (head, body), keep_graph=True)
            lane.graph = self._assemble(lane, graphs)
            self._evict()
        return ran, alive

    # -- a whole call ---------------------------------------------------------

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
            (lane.graph,), lane.outputs = self._capture(lane, (lambda: fn(*lane.tensors),))
            self._evict()
            return out
        self.lanes.move_to_end((key, 0))
        for s, t in zip(lane.tensors, inputs):
            s.copy_(t)
        self._replay(lane)
        self._count(lane, 1)
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
    sampled and the beam loops' blocks), `slot` (slot_steps' blocks),
    `vocoder` (a whole bigvgan_apply call), `latent` (a teacher-forced
    latent pass) and `cond` (get_conditioning). `capture=False` (a
    multi-device engine) runs every stage's blocks and calls without
    capture, as the CPU does.

    What a stage keeps: at most `limit` lanes (16 decode keys, 4 slot
    sessions, 32 vocoder keys, 32 latent keys, 16 conditioning keys), and
    its free lanes only while all its lanes hold at most `keep_bytes`, an
    eighth of the card's memory (1 GiB on the CPU): a decode lane holds its
    key's whole KV cache, k and v of [layers, rows x beams, heads, slots,
    head dim] each, so a few lanes of large batches reach the budget before
    the count does."""

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
        self.latent = GraphStage("lat", self, 32)
        self.cond = GraphStage("cond", self, 16)

    @contextlib.contextmanager
    def eager(self):
        """Run the blocks and calls eagerly, on the same static buffers,
        inside the `with`: the comparison and debugging path; nothing else
        turns capture off."""
        was, self.enabled = self.enabled, False
        try:
            yield
        finally:
            self.enabled = was

    def stages(self) -> Tuple[GraphStage, ...]:
        return self.decode, self.slot, self.vocoder, self.latent, self.cond

    def stats(self) -> Dict[str, List[Dict[str, Any]]]:
        return {s.name: s.stats() for s in self.stages()}


def stage_or_uncaptured(stage: Optional[GraphStage], device) -> GraphStage:
    """`stage`, or for a loop run without an engine's stage, a stage of its
    own that runs the same bound blocks without capture."""
    return stage if stage is not None else Graphs(device, capture=False, keep_bytes=0).decode
