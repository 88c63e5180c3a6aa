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
  times the steps it ran (read back with the block's status), so K1-K8's
  `launches` count what ran on the card.

The graphs of a stage share one memory pool; only temporaries live there
(the steps write their results into the static buffers), the BLOCK copies of
a step share one step's temporaries, and the graphs of one engine replay one
after another on one stream. A lane keeps its buffers and its graph after
its state is gone, for the key's next request: a stage keeps at most `limit`
lanes, and its free lanes only while all its lanes hold at most
`keep_bytes` (buffers and the memory each capture added to the pool);
beyond either it drops the least recently used free lanes.

Which stage captures is one rule (`stage_captures`), from the stage's
collectives and the mesh's backend (parallel/mesh.py), as the JAX engine
runs the same compiled programs on one chip and on a mesh:

  stage         collectives in a call / step    one card   gloo mesh   NCCL mesh
  voc, cond     none (replicated models)        yes        yes         yes
  lat           the model group's all-reduces   yes        no          yes
  dec, slot     the same, every step            yes        no          yes

gloo's collectives are host round trips that a graph cannot hold; NCCL's
are kernels on the capturing stream, and a captured step's collectives run
inside the block's IF bodies (csrc/graph_block.cu drops the event nodes
PyTorch captures around them). The CPU captures nothing. The data groups'
gathers, the generator's broadcast and the requests' check stay outside
every graph (engine.py).

On a mesh every rank of a model group must take the same path through a
stage, in the same order: bind, warm, capture, replay, drop (NCCL pairs a
captured collective with its partner's only when both ranks capture or
replay the same step). Two inputs of those decisions are the rank's own: a
lane's liveness (a weak reference, so Python's garbage collector decides
when a state is gone) and the pool bytes a capture reserved. Both are
agreed over the model group's host (gloo) group when a lane is bound or
captured: a lane is free only where it is free on every rank, and a
capture's pool bytes are the largest any rank measured. That is one small
host round trip a bind or a capture, never one a step; the block's
predicate needs none, since the model group's all-reduces make the tensors
it reads equal. Each stage logs its decisions into `Graphs.log` (key
indices in order of first sight, not the keys, which hold the rank's own
weight addresses), so the ranks' logs can be compared. A captured graph of
NCCL collectives keeps their communicator busy: drop an engine, and collect
it (a stage and its Graphs hold each other), before destroy_process_group.

Nothing falls back: a capture, a block's assembly or a replay that fails
raises. `Graphs.eager()` is the private switch that runs the same blocks, on
the same static buffers, without capture, the IF decided on the host
(chip_smoke.py compares the two, and it is the way to debug on the card).
The loops always run their blocks through a stage: where the stage does not
capture, it runs the same head and steps as they are.

While a profiler runs, a stage records spans (tracing.py) around what it
does, never inside a captured function: `<stage>.block` around a loop's
block (its run, warm run or replay and the one read; attributes `event` and
`ran`), `<stage>.call` around a whole call (`event`), `<stage>.capture`
around a capture.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from indextts_tpu_torch import tracing

# the steps of a decode loop's block: one captured graph holds BLOCK
# conditional steps, and the host reads the device once per block
BLOCK = 16
# the stages whose calls or steps hold the tensor-parallel GPT's collectives
COLLECTIVE_STAGES = ("dec", "slot", "lat")
# the decisions Graphs.log keeps, the latest last
LOG_KEEP = 4096
# the most lanes of one stage an agreement over the model group covers (a
# stage keeps at most 32, and one more while a bind evicts)
AGREE_LANES = 64


def stage_captures(name: str, device, backend: Optional[str] = None) -> bool:
    """Whether the stage `name` captures on `device` for a mesh over
    `backend` (None: one process): never on the CPU; on a gloo mesh only
    the stages without collectives; on one card or an NCCL mesh every
    stage."""
    if torch.device(device).type != "cuda":
        return False
    return backend != "gloo" or name not in COLLECTIVE_STAGES


def _counters() -> Dict[Any, int]:
    """The kernel wrappers' launch counters (K1-K8), by module."""
    from indextts_tpu_torch.ops.cuda import (aa_conv_branch, antialias, antialias_folded, antialias_tmajor,
                                             decode_attn, gpt2_chains, qmatmul, ssm_step)

    return {m: m.launches for m in (antialias, aa_conv_branch, antialias_tmajor, antialias_folded, qmatmul,
                                    decode_attn, ssm_step, gpt2_chains)}


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
    pool. `captures` is the stage's rule (stage_captures)."""

    def __init__(self, name: str, graphs: "Graphs", limit: int):
        self.name, self.graphs, self.limit = name, graphs, limit
        self.keep_bytes = graphs.keep_bytes
        self.captures = graphs.capture and stage_captures(name, graphs.device, graphs.backend)
        self.lanes: "OrderedDict[Tuple[Any, int], Lane]" = OrderedDict()
        self._pool = None
        self._ids: Dict[Any, int] = {}  # a key's index in the log, in order of first sight
        self._next_id = 0
        self.reads = 0  # the blocks' host reads, one per block

    @property
    def capturing(self) -> bool:
        """Whether run / call capture and replay (a capturing stage outside
        Graphs.eager()); otherwise they run the function as it is."""
        return self.captures and self.graphs.enabled

    def _note(self, event: str, key, n: int, detail: Any = None) -> None:
        """Log one decision: (stage, event, the key's index, lane, detail)."""
        if key not in self._ids:
            self._ids[key] = self._next_id
            self._next_id += 1
        self.graphs.log.append((self.name, event, self._ids[key], n, detail))

    # -- static buffers ---------------------------------------------------

    def _free(self) -> set:
        """The lanes no live state holds, on every rank of the model group
        (a state's weak reference dies when the rank's garbage collector
        frees it; a lane still held on one rank is held on all)."""
        keys = list(self.lanes)
        if len(keys) > AGREE_LANES:
            raise RuntimeError(f"{self.name}: {len(keys)} lanes, more than the {AGREE_LANES} an agreement holds")
        flags = [int(self.lanes[k].free_for(None)) for k in keys]
        got = self.graphs.agreed([len(keys), -len(keys)] + flags + [1] * (AGREE_LANES - len(keys)),
                                 dist.ReduceOp.MIN)
        if got[0] != -got[1]:
            raise RuntimeError(f"{self.name}: the ranks of the model group keep {got[0]} to {-got[1]} lanes")
        return {k for k, f in zip(keys, got[2:]) if f}

    def bind(self, key, owner, holders: Sequence[Tuple[Any, Sequence[str]]]) -> Lane:
        """Give `owner` (a decode state, held weakly) a lane of `key` and
        point the holders' tensor attributes at its buffers: a new lane takes
        the holders' tensors as they are, or copies of those another lane
        keeps; a lane that held another state gets them copied in (a free
        lane with a graph before one without: the state then replays at
        once); the owner's own lane only copies what changed objects
        (per-call inputs such as a session's knob columns). The owner's lanes
        of other keys are freed (a grown cache moves to a new key). Which
        lanes are free is agreed over the model group (_free)."""
        live = _flatten(holders)
        free = self._free()
        own = cand = None
        for (k, n), lane in self.lanes.items():
            held = None if lane.owner is None else lane.owner()
            if held is owner and k != key:
                lane.owner = None
                free.add((k, n))
            elif k == key and held is owner:
                own = (k, n)
            elif k == key and (k, n) in free and (cand is None or (self.lanes[cand].graph is None
                                                                   and lane.graph is not None)):
                cand = (k, n)
        at = own or cand
        if at is None:
            kept = _storages(t for lane in self.lanes.values() for t in lane.tensors)
            tensors = [t.clone() if t.untyped_storage().data_ptr() in kept else t for t in live]
            _unflatten(holders, tensors)
            lane = Lane(key, tensors)
            lane.ctl = BlockControl(tensors[0].device)
            at = (key, next(n for n in range(len(self.lanes) + 1) if (key, n) not in self.lanes))
            self.lanes[at] = lane
        else:
            lane = self.lanes[at]
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
        self._note("bind", key, at[1], "own" if at == own else "free" if at == cand else "new")
        lane.owner = weakref.ref(owner)
        free.discard(at)
        self.lanes.move_to_end(at)
        self._evict(free)
        return lane

    def _evict(self, free: set) -> None:
        """Drop the least recently used of the `free` lanes while the stage
        keeps more than `limit` lanes or its lanes hold more than
        `keep_bytes`."""
        sizes = {k: lane.nbytes() for k, lane in self.lanes.items()}
        total = sum(sizes.values())
        for k in [k for k in self.lanes if k in free]:
            if len(self.lanes) <= self.limit and total <= self.keep_bytes:
                break
            total -= sizes[k]
            del self.lanes[k]
            self._note("drop", k[0], k[1])
            if not any(key == k[0] for key, _n in self.lanes):
                del self._ids[k[0]]

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
        and the pool's growth (_pool_grew) go to the lane. A span
        <stage>.capture around it all, outside the captured region."""
        with tracing.span(f"{self.name}.capture"):
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
                self._pool_grew(lane, torch.cuda.memory_reserved(dev) - reserved)
            return graphs, out

    def _pool_grew(self, lane: Lane, grown: int) -> None:
        """A capture's pool growth as the lane keeps it: the most that any
        rank of the model group measured (the ranks then evict alike)."""
        lane.pool_bytes = self.graphs.agreed([grown], dist.ReduceOp.MAX)[0]

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

    @staticmethod
    def _head_body(ctl: BlockControl, step: Callable[[], None],
                   live: Callable[[], torch.Tensor]) -> Tuple[Callable[[], None], Callable[[], None]]:
        """A block's head (zero the block's step counter, evaluate the
        condition) and body (one step, the counter's increment and the
        condition again), as run() captures and runs them."""

        def head():
            ctl.status.zero_()
            ctl.live.copy_(live().reshape(1))

        def body():
            step()
            ctl.ran.add_(1)
            ctl.live.copy_(live().reshape(1))

        return head, body

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
        blocks replay it. A span <stage>.block (tracing.py) with the event
        (run, warm or replay) and the steps run."""
        ctl = lane.ctl
        with tracing.span(f"{self.name}.block") as span:
            ctl.budget.fill_(min(int(budget), BLOCK))
            at = next(k for k, v in self.lanes.items() if v is lane)
            head, body = self._head_body(ctl, step, live)
            if not self.capturing:
                event = "run"
                self._block(lane, head, body)
            elif lane.graph is not None:
                event = "replay"
                self._replay(lane)
            else:
                event = "warm"
                self._warm(lambda: self._block(lane, head, body))
            ran, alive = self._read(ctl)
            if event == "replay":
                self._count(lane, ran)
            self._note(event, *at, ran)
            if event == "warm" and ran > 0:  # capture only a step that has run warm
                graphs, _ = self._capture(lane, (head, body), keep_graph=True)
                lane.graph = self._assemble(lane, graphs)
                self._note("capture", *at)
                self._evict(self._free())
            span.set(event=event, ran=ran)
        return ran, alive

    # -- a whole call ---------------------------------------------------------

    def call(self, key, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """fn(*inputs) as a captured program of `key`: the inputs are copied
        into the key's static inputs and the graph replayed; returns a copy
        of its output. The first call of a key runs fn eagerly (warm) on the
        static inputs, returns that, and captures fn. A span <stage>.call
        (tracing.py) with the event (run, warm or replay)."""
        with tracing.span(f"{self.name}.call") as span:
            if not self.capturing:
                span.set(event="run")
                return fn(*inputs)
            lane = self.lanes.get((key, 0))
            if lane is None:
                span.set(event="warm")
                lane = Lane(key, [t.clone() for t in inputs])
                self.lanes[(key, 0)] = lane
                out = self._warm(lambda: fn(*lane.tensors))
                self._note("warm", key, 0)
                (lane.graph,), lane.outputs = self._capture(lane, (lambda: fn(*lane.tensors),))
                self._note("capture", key, 0)
                self._evict(self._free())
                return out
            span.set(event="replay")
            self.lanes.move_to_end((key, 0))
            for s, t in zip(lane.tensors, inputs):
                s.copy_(t)
            self._replay(lane)
            self._count(lane, 1)
            self._note("replay", key, 0)
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
    latent pass) and `cond` (get_conditioning). Which of them capture is
    stage_captures's rule, from the device and `backend`, the mesh's
    ("gloo" or "nccl"; None on one process); `capture=False` (a loop run
    without an engine's stage) turns capture off for every stage. `agree`
    is the model group's host (gloo) Comm on a mesh, over which the stages
    agree their lanes (GraphStage._free) and pool bytes; None on one
    process. `log` keeps the stages' last LOG_KEEP decisions.

    What a stage keeps: at most `limit` lanes (16 decode keys, 4 slot
    sessions, 32 vocoder keys, 32 latent keys, 16 conditioning keys), and
    its free lanes only while all its lanes hold at most `keep_bytes`, an
    eighth of the card's memory (1 GiB on the CPU): a decode lane holds its
    key's whole KV cache, k and v of [layers, rows x beams, heads, slots,
    head dim] each, so a few lanes of large batches reach the budget before
    the count does."""

    def __init__(self, device, backend: Optional[str] = None, agree=None, capture: bool = True,
                 keep_bytes: Optional[int] = None):
        self.device = torch.device(device)
        self.backend, self.agree, self.capture = backend, agree, capture
        self.enabled = True
        self.side_stream = None  # where a key's first run warms, made at the first capture
        self.log: "deque[Tuple[str, str, int, int, Any]]" = deque(maxlen=LOG_KEEP)
        if keep_bytes is None:
            keep_bytes = (torch.cuda.get_device_properties(self.device).total_memory // 8
                          if self.device.type == "cuda" else 1 << 30)
        self.keep_bytes = self.agreed([keep_bytes], dist.ReduceOp.MIN)[0]
        self.decode = GraphStage("dec", self, 16)
        self.slot = GraphStage("slot", self, 4)
        self.vocoder = GraphStage("voc", self, 32)
        self.latent = GraphStage("lat", self, 32)
        self.cond = GraphStage("cond", self, 16)

    def agreed(self, values: List[int], op) -> List[int]:
        """`values` reduced by `op` over the model group's ranks (as they are
        on one process): one host round trip."""
        if self.agree is None or self.agree.size == 1:
            return values
        return self.agree.all_reduce(torch.tensor(values, dtype=torch.int64), op=op).tolist()

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
