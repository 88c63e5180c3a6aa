"""The captured step programs of the port (indextts_tpu_torch/graphs.py) on
the CPU, tiny float32 configurations on JAX-initialized weights.

Every loop runs its steps through a graph stage, in the form a CUDA engine
captures: the loop state on its key's static buffers, the step index a
device counter, every dynamic knob a [B] tensor, each sampled step's
uniforms drawn before it; on the CPU the stage runs the step as it is.
Every step here runs under NoHostReads, a
TorchDispatchMode that fails on a host read (aten._local_scalar_dense), on
any op whose output shape depends on the data (nonzero, masked_select,
boolean indexing, ...) and on host data lifted into a tensor (a Python
scalar set into a tensor, which on the card copies from the host), and the
static buffers must keep their addresses across it: the CPU's proof that
the step can be captured. The loops held
that way give the codes, lengths and latents of the same loops on a stage
of their own bit for bit, and JAX's greedy codes token for token (latents
within 1e-4). No two lanes share a buffer, and a stage keeps its free lanes
within its byte budget. The keys follow
the JAX engine's (`_decode_fn`: ("dec", b, text bucket, gen, capture,
quant_kv); `_vocoder_fn`: ("voc", b, m, frames, int16_out)), with the
cache length of a segment besides. Capture and replay themselves, and the
kernels' launch counts under replay, are held on the card by
chip_smoke.py's graphs phase."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu.models.gpt_slots as jslots
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
import indextts_tpu_torch.models.gpt_decode as tdec
import indextts_tpu_torch.models.gpt_slots as tslots
from indextts_tpu_torch.graphs import GraphStage, Graphs
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg
from tests.test_torch_infer_fast import ckpt_dir, engines  # noqa: F401  (fixtures: the tiny JAX and port engines)

TOL = 1e-4
MAX_NEW = 12
TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 1, 1, 1, 1, 1]], np.int32)
LENS = np.asarray([5, 3], np.int32)
# per-row knobs of a sampled batch, as infer_batch's per_request_kwargs give them
KNOBS = dict(temperature=torch.tensor([1.0, 0.7]), top_p=torch.tensor([0.8, 0.9]),
             repetition_penalty=torch.tensor([10.0, 2.0]), typical_mass=torch.tensor([0.9, 0.9]))


class NoHostReads(TorchDispatchMode):
    """Fails on every op that reads a device value on the host, gives an
    output whose shape depends on the data, or lifts host data into a tensor
    (torch.tensor, a Python scalar set into a tensor: on the card a copy
    from the host): what a CUDA graph cannot hold."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        tags = set(func.tags)
        bad = torch.Tag.data_dependent_output in tags or name in ("_local_scalar_dense", "item", "lift_fresh")
        if func in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default, torch.ops.aten.index_put.default):
            # an integer index has a static output shape; a boolean mask goes through nonzero
            bad = bad or any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8) for i in args[1])
        elif torch.Tag.dynamic_output_shape in tags:
            bad = True
        if bad:
            raise AssertionError(f"a captured step ran {func}, which reads a device value on the host or has a "
                                 "data-dependent output shape")
        return func(*args, **kwargs)


class CheckedStage(GraphStage):
    """A CPU graph stage that runs each block (its head and every step)
    under NoHostReads and checks that the lane's buffers keep their
    addresses across it; only the IF of each step reads the device, outside
    the checked mode, as the card's predicate kernel does."""

    def __init__(self, *args):
        super().__init__(*args)
        self.steps = 0
        self.blocks = 0
        self.calls = []

    def _holds(self, ctl):
        with _disable_current_modes():
            return super()._holds(ctl)

    def _block(self, lane, head, body):
        ptrs = [t.data_ptr() for t in lane.tensors]

        def counted():
            body()
            self.steps += 1

        with NoHostReads():
            super()._block(lane, head, counted)
        assert [t.data_ptr() for t in lane.tensors] == ptrs, "a step moved a static buffer"
        self.blocks += 1

    def call(self, key, fn, inputs):
        self.calls.append(key)
        with NoHostReads():
            return fn(*inputs)


class CheckedGraphs(Graphs):
    def __init__(self):
        super().__init__("cpu")
        self.decode, self.slot, self.vocoder, self.latent, self.cond = (
            CheckedStage(n, self, 16) for n in ("dec", "slot", "voc", "lat", "cond"))


@pytest.fixture(scope="module")
def setup():
    """A sharper mel head than the init's, so that greedy rows run for
    several codes and stop at different lengths; one torch thread (see
    tests/test_torch_infer_fast.py:engines)."""
    rng = np.random.default_rng(41)
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cfg, params, model, conds
    torch.set_num_threads(threads)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


def _args(setup, b=2, model=None):
    cfg, _, m, conds = setup
    return (model or m, cfg), (_t(np.repeat(conds, b, 0)), _t(TEXT[:b]), _t(LENS[:b]))


def _both(fn, setup, gen, b=2, model=None, seed=3, **kw):
    """fn's outputs (numpy) without a stage (the loop's own, unchecked) and
    on a checked graph stage, from generators seeded alike; and the stage."""
    (m, cfg), (conds, text, lens) = _args(setup, b, model)
    stage = CheckedGraphs().decode
    out = []
    for graphs in (None, stage):
        res = fn(m, cfg, tdec.GenerationConfig(**gen), conds.to(next(m.parameters()).dtype), text, lens,
                 torch.Generator().manual_seed(seed), graphs=graphs, **kw)
        out.append([r.float().numpy() for r in res])
    assert stage.steps > 0
    return out[0], out[1], stage


def _assert_same(plain, graph):
    for a, g in zip(plain, graph):
        np.testing.assert_array_equal(g, a)


DECODE_CASES = {
    "greedy": (dict(do_sample=False), {}),
    "int8_kv": (dict(do_sample=False), dict(quant_kv=True)),
    "capture": (dict(do_sample=False), dict(capture_latents=True, pos_off=1)),
    "sampled_row_knobs": (dict(do_sample=True, top_k=30), KNOBS),
    "typical": (dict(do_sample=True, top_k=30, typical_sampling=True), dict(KNOBS, typical_mass=torch.tensor([0.5, 0.8]))),
    "prefix": (dict(do_sample=False), dict(input_tokens=torch.tensor([[3, 9, 17], [4, 8, 15]]))),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_capturable(setup, case):
    """generate_speech on a checked stage: every step free of host reads,
    bit-equal to the loop on its own stage, and greedy token for token with
    JAX."""
    gen, kw = DECODE_CASES[case]
    gen = dict(gen, max_new_tokens=MAX_NEW)
    plain, graph, _ = _both(tdec.generate_speech, setup, gen, **kw)
    _assert_same(plain, graph)
    assert graph[1].max() > 3  # a real decode
    if not gen["do_sample"]:
        cfg, params, _, conds = setup
        jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        gold = jdec.generate_speech(params, cfg, jdec.GenerationConfig(**gen), jnp.asarray(np.repeat(conds, 2, 0)),
                                    jnp.asarray(TEXT), jnp.asarray(LENS), jax.random.PRNGKey(0), **jkw)
        np.testing.assert_array_equal(graph[0], np.asarray(gold[0]))
        np.testing.assert_array_equal(graph[1], np.asarray(gold[1]))
        if kw.get("capture_latents"):
            n = int(np.asarray(gold[1]).max())
            np.testing.assert_allclose(graph[2][:, :n], np.asarray(gold[2])[:, :n], atol=TOL, rtol=0)


def test_decode_step_capturable_bf16(setup):
    """The bf16 cache: the checked step on a bf16 copy of the model gives
    the bf16 loop's codes on its own stage."""
    bf16 = copy.deepcopy(setup[2]).to(torch.bfloat16)
    plain, graph, _ = _both(tdec.generate_speech, setup, dict(do_sample=False, max_new_tokens=MAX_NEW), model=bf16)
    _assert_same(plain, graph)


@pytest.mark.parametrize("beams", [False, True])
def test_segmented_steps_capturable(setup, beams):
    """The segmented loops: one key per segment's cache length, each
    segment's state copied onto its key's buffers, codes bit-equal to the
    segmented loop on its own stage."""
    fn = tdec.generate_speech_beam_segmented if beams else tdec.generate_speech_segmented
    gen = dict(do_sample=False, num_beams=3 if beams else 1, max_new_tokens=MAX_NEW)
    plain, graph, stage = _both(fn, setup, gen, segment=5, repetition_penalty=2.0)
    _assert_same(plain, graph)
    cache_lens = {k[6] for k, _ in stage.lanes}
    assert len(cache_lens) >= 2  # the run crossed a segment


BEAM_CASES = {
    "greedy": (dict(do_sample=False), {}),
    "sampled_row_knobs": (dict(do_sample=True, top_k=30), dict(KNOBS, length_penalty=torch.tensor([1.0, -0.5]))),
    "int8_kv_capture": (dict(do_sample=False), dict(quant_kv=True, capture_latents=True, pos_off=1)),
    "prefix": (dict(do_sample=False), dict(input_tokens=torch.tensor([[3, 9], [4, 8]]))),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_step_capturable(setup, case):
    """generate_speech_beam on a checked stage (the successor choice, the
    best-hypothesis update and the cache reorder in place), bit-equal to the
    loop on its own stage; greedy token for token with JAX
    generate_speech_beam."""
    gen, kw = BEAM_CASES[case]
    gen = dict(gen, num_beams=3, max_new_tokens=MAX_NEW)
    plain, graph, _ = _both(tdec.generate_speech_beam, setup, gen, **kw)
    _assert_same(plain, graph)
    if case == "greedy":
        cfg, params, _, conds = setup
        gold = jdec.generate_speech_beam(params, cfg, jdec.GenerationConfig(**gen),
                                         jnp.asarray(np.repeat(conds, 2, 0)), jnp.asarray(TEXT), jnp.asarray(LENS),
                                         jax.random.PRNGKey(0))
        np.testing.assert_array_equal(graph[0], np.asarray(gold[0]))
        np.testing.assert_array_equal(graph[1], np.asarray(gold[1]))


def _slot_run(setup, gen, graphs, quant_kv=False, capture=False, knobs=None, seed=5):
    """Two rows admitted at once and a third after 3 steps into a 3-slot
    state, drained in chunks of 4 steps."""
    cfg, _, model, conds = setup
    g = torch.Generator().manual_seed(seed)
    gen = tdec.GenerationConfig(**gen)
    state = tslots.slot_state_init(cfg, gen, 3, 64, torch.float32, capture_latents=capture, quant_kv=quant_kv)
    pos_off = 1 if capture else 2

    def admit(row, slot):
        prod = tslots.slot_prefill(model, cfg, gen, _t(conds), _t(TEXT[row : row + 1]), _t(LENS[row : row + 1]), g,
                                   capture_latents=capture, quant_kv=quant_kv)
        tslots.slot_admit(state, prod, slot, cfg)

    kw = dict(knobs or {}, pos_off=pos_off, graphs=graphs)
    admit(0, 0)
    admit(1, 1)
    tslots.slot_steps(model, cfg, gen, state, 3, g, **kw)
    admit(0, 2)
    for _ in range(8):
        tslots.slot_steps(model, cfg, gen, state, 4, g, **kw)
    out = [state.codes.numpy().copy(), state.i_b.numpy().copy(), np.asarray(int(state.tick))]
    return out + ([state.lat.numpy().copy()] if capture else [])


SLOT_CASES = {
    "greedy": (dict(do_sample=False), {}),
    "int8_kv_capture": (dict(do_sample=False), dict(quant_kv=True, capture=True)),
    "sampled_row_knobs": (dict(do_sample=True, top_k=30),
                          dict(knobs={k: torch.cat([v, v[:1]]) for k, v in KNOBS.items()})),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_slot_step_capturable(setup, case):
    """slot_steps on a checked stage (device cursor and tick, the cursor
    column by index_copy_): bit-equal to the slot loop on its own stage;
    greedy rows equal JAX slot_steps row for row."""
    gen, kw = SLOT_CASES[case]
    gen = dict(gen, max_new_tokens=MAX_NEW)
    stage = CheckedGraphs().slot
    plain = _slot_run(setup, gen, None, **kw)
    graph = _slot_run(setup, gen, stage, **kw)
    assert stage.steps > 0 and len(stage.lanes) == 1
    _assert_same(plain, graph)
    if case == "greedy":
        cfg, params, _, conds = setup
        jgen = jdec.GenerationConfig(**gen)
        st = jslots.slot_state_init(cfg, jgen, 3, 64, jnp.float32)
        for row, slot in ((0, 0), (1, 1)):
            prod = jslots.slot_prefill(params, cfg, jgen, jnp.asarray(conds), jnp.asarray(TEXT[row : row + 1]),
                                       jnp.asarray(LENS[row : row + 1]), jax.random.PRNGKey(0))
            st = jslots.slot_admit(st, prod, slot, cfg)
        st = jslots.slot_steps(params, cfg, jgen, st, 3, jax.random.PRNGKey(1))
        prod = jslots.slot_prefill(params, cfg, jgen, jnp.asarray(conds), jnp.asarray(TEXT[:1]), jnp.asarray(LENS[:1]),
                                   jax.random.PRNGKey(0))
        st = jslots.slot_admit(st, prod, 2, cfg)
        st = jslots.slot_steps(params, cfg, jgen, st, 32, jax.random.PRNGKey(1))
        np.testing.assert_array_equal(graph[0], np.asarray(st.codes))


def test_keys_follow_the_jax_engine(setup):
    """Two requests in one text bucket share a key (the second copied onto
    the first's buffers, one lane); a new text bucket, a new gen or a new
    segment makes a new key. The decode key starts as the JAX engine's
    _decode_fn key: ("dec", b, <the prefill length for the text bucket>,
    gen, capture, quant_kv)."""
    cfg, _, model, conds = setup
    stage = Graphs("cpu").decode
    greedy = tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW)

    def run(text, lens, gen=greedy, **kw):
        b = text.shape[0]
        return tdec.generate_speech(model, cfg, gen, _t(np.repeat(conds, b, 0)), _t(text), _t(lens),
                                    torch.Generator(), graphs=stage, **kw)

    a = run(TEXT[:1], LENS[:1])
    b_ = run(TEXT[1:], LENS[1:])  # another row of the same bucket (width 8)
    assert len(stage.lanes) == 1
    (key, lane_no), = stage.lanes
    p = conds.shape[1] + TEXT.shape[1] + 3
    assert key[:6] == ("dec", 1, p, greedy, False, False) and key[6] == p + MAX_NEW and lane_no == 0
    np.testing.assert_array_equal(a[0].numpy(), run(TEXT[:1], LENS[:1])[0].numpy())  # the buffers are reusable
    assert not np.array_equal(a[0].numpy(), b_[0].numpy())
    wide = np.full((1, 16), 1, np.int32)
    wide[0, :5] = TEXT[0, :5]
    run(wide, LENS[:1])  # text bucket 16
    run(TEXT[:1], LENS[:1], tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW - 2))
    run(TEXT[:1], LENS[:1], quant_kv=True)
    keys = [k for k, _ in stage.lanes]
    assert len(keys) == len(set(keys)) == 4
    assert {k[2] for k in keys} == {p, p + 8}


def test_lanes_of_one_key(setup):
    """Two states alive at one key take two lanes (two streams decoding at
    once); a lane whose state is gone serves the next one; the stage keeps
    at most `limit` lanes, dropping the least recently used free ones."""
    cfg, _, model, conds = setup
    stage = Graphs("cpu").decode
    stage.limit = 2
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW)

    def state():
        st, ctx = tdec.prefill_decode_state(model, cfg, gen, _t(conds), _t(TEXT[:1]), _t(LENS[:1]), torch.Generator())
        return tdec.decode_steps(model, cfg, st, ctx, 2, graphs=stage), ctx

    s1, _ = state()
    s2, _ = state()
    assert len(stage.lanes) == 2 and s1.codes.data_ptr() != s2.codes.data_ptr()
    ptr = s1.codes.data_ptr()
    del s1
    s3, ctx3 = state()
    assert s3.codes.data_ptr() == ptr and len(stage.lanes) == 2
    del s2, s3, ctx3
    tdec.generate_speech(model, cfg, tdec.GenerationConfig(do_sample=False, max_new_tokens=4), _t(conds),
                         _t(TEXT[:1]), _t(LENS[:1]), torch.Generator(), graphs=stage)
    assert len(stage.lanes) == 2


def _lane_storages(stage):
    return [{t.untyped_storage().data_ptr() for t in lane.tensors} for lane in stage.lanes.values()]


def test_states_interleave_across_a_segment(setup):
    """A state that grows its cache moves to the next segment's key and
    frees its old lane; a second state bound to the old key takes that lane
    while the first is still decoding. The lanes share no buffer, so each
    state gives the codes it gives alone."""
    cfg, _, model, conds = setup
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW)
    p = conds.shape[1] + TEXT.shape[1] + 3

    def start(row):
        return tdec.prefill_decode_state(model, cfg, gen, _t(conds), _t(TEXT[row : row + 1]),
                                         _t(LENS[row : row + 1]), torch.Generator(), repetition_penalty=2.0,
                                         cache_len=p + 5)

    def segments(st, ctx, stage, first=True, second=True):
        if first:
            tdec.decode_steps(model, cfg, st, ctx, 4, graphs=stage)
            tdec.grow_cache(st, ctx, MAX_NEW - 5)
        if second:
            tdec.decode_steps(model, cfg, st, ctx, MAX_NEW, graphs=stage)
        return st

    alone = [segments(*start(row), Graphs("cpu").decode).codes.numpy().copy() for row in (0, 1)]
    assert all(int((c != cfg.stop_mel_token).sum()) > 6 for c in alone)  # both decode into the second segment
    stage = Graphs("cpu").decode
    a, actx = start(0)
    segments(a, actx, stage, second=False)
    tdec.decode_steps(model, cfg, a, actx, 1, graphs=stage)  # A moves to the second segment's key
    b, bctx = start(1)
    segments(b, bctx, stage, second=False)  # B's first segment takes A's old lane
    assert len(stage.lanes) == 2
    segments(a, actx, stage, first=False)
    segments(b, bctx, stage, first=False)  # B's second segment: a second lane of that key
    assert len(stage.lanes) == 3
    owned = _lane_storages(stage)
    assert all(not (x & y) for i, x in enumerate(owned) for y in owned[i + 1 :])
    np.testing.assert_array_equal(a.codes.numpy(), alone[0])
    np.testing.assert_array_equal(b.codes.numpy(), alone[1])


def test_free_lanes_within_keep_bytes(setup):
    """A stage keeps a free lane (its buffers for the key's next request)
    only while its lanes hold at most keep_bytes; a live lane stays
    whatever its size, and resident_bytes counts each lane's buffers."""
    cfg, _, model, conds = setup
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=MAX_NEW)

    def request(stage, row):
        tdec.generate_speech(model, cfg, gen, _t(conds), _t(TEXT[row : row + 1]), _t(LENS[row : row + 1]),
                             torch.Generator(), graphs=stage, quant_kv=bool(row))

    roomy, tight = Graphs("cpu").decode, Graphs("cpu", keep_bytes=0).decode
    for stage in (roomy, tight):
        request(stage, 0)
        request(stage, 1)  # another key (int8 KV)
    assert len(roomy.lanes) == 2 and len(tight.lanes) == 1  # the first key's free lane went
    assert roomy.resident_bytes() > tight.resident_bytes() > 0
    st, ctx = tdec.prefill_decode_state(model, cfg, gen, _t(conds), _t(TEXT[:1]), _t(LENS[:1]), torch.Generator())
    tdec.decode_steps(model, cfg, st, ctx, 2, graphs=tight)
    assert len(tight.lanes) == 1 and tight.stats()[0]["live"]  # held while its state lives
    assert tight.resident_bytes() >= sum(t.nbytes for t in st.cache)


def test_engine_routes_through_graph_stages(engines):
    """The engine's decode loops (greedy and beams, infer_stream, a slot
    session) and its vocoder calls through checked stages: every step and
    call free of host reads, wav equal to the same engine's own stages
    (which on the CPU capture nothing), and the vocoder keys the JAX
    engine's ("voc", b, m, frames, int16_out)."""
    _, te, _ = engines
    prompt = np.random.default_rng(3).standard_normal((1, 100, 40)).astype(np.float32) * 0.1
    kw = dict(do_sample=False, max_mel_tokens=12, repetition_penalty=2.0)

    def requests():
        out = [te.infer(prompt, "HELLO WORLD.", num_beams=1, **kw)[1],
               te.infer(prompt, "HELLO.", num_beams=3, **kw)[1],
               np.concatenate(list(te.infer_stream(prompt, "HELLO WORLD.", first_chunk_codes=4, chunk_codes=4, **kw)))]
        sess = te.slot_session(n_slots=2, chunk_steps=4, **kw)
        rids = [sess.submit(prompt, t) for t in ("HI.", "HELLO WORLD.", "GOOD DAY.")]
        done = sess.drain()
        return out + [done[r][1] for r in rids]

    own = te._graphs
    assert not (own.decode.capturing or own.slot.capturing or own.vocoder.capturing)  # the CPU captures nothing
    plain = requests()
    te._graphs = checked = CheckedGraphs()
    try:
        graph = requests()
    finally:
        te._graphs = own
    for a, g in zip(plain, graph):
        np.testing.assert_array_equal(g, a)
    assert checked.decode.steps > 0 and checked.slot.steps > 0
    voc = set(checked.vocoder.calls)
    assert {k[4] for k in voc} == {False, True}  # _vocode (float) and _vocode_many (int16)
    for k in voc:
        assert k[0] == "voc" and k[2] % 16 == 0 and k[3] % 100 == 0
