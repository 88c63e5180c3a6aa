"""The decode loops in blocks of graphs.BLOCK conditional steps, and the
latent and conditioning stages (indextts_tpu_torch/graphs.py), on the CPU,
tiny float32 configurations on JAX-initialized weights.

A loop's block runs each step only while the budget allows it and the
loop's condition holds, the condition evaluated from the device state (the
port of lax.while_loop); on the CPU the IF is decided on the host, from the
same predicate the card's kernel computes (CheckedStage reads it outside
NoHostReads; every head and step runs inside). The budgets here are 21
steps, not a multiple of BLOCK = 16, and the stop logit is raised in both
packages' weights so that rows stop at scattered steps, mid-block: greedy,
sampled on a recorded uniform stream, 3 beams with early_stopping, the slot
loop and the segmented loops are token for token JAX's. A loop of n steps
reads the device once a block, ceil(n / BLOCK) times; a replay adds each
kernel's launches per step times the steps that ran (a counting stub in
place of the card). The latent and conditioning passes run through their
stages as the engine calls them, bit for bit the eager call and within
1e-4 of JAX's `_latent_fn` / get_conditioning. Capture and replay on the
card are held by chip_smoke.py's graphs phase."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu.models.gpt_slots as jslots
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
import indextts_tpu_torch.models.gpt_decode as tdec
import indextts_tpu_torch.models.gpt_slots as tslots
from indextts_tpu_torch.graphs import BLOCK, GraphStage, Graphs
from indextts_tpu_torch.models.gpt import UnifiedVoice, get_conditioning
from indextts_tpu_torch.ops.cuda import qmatmul
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg
from tests.test_torch_graphs import CheckedGraphs
from tests.test_torch_infer_fast import ckpt_dir, engines  # noqa: F401  (fixtures: the tiny JAX and port engines)

TOL = 1e-4
STEPS = 21  # a budget that is not a multiple of BLOCK: one full block, then 5 steps
MAX_NEW = STEPS + 1
TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 14, 15, 16, 17, 18], [21, 22, 23, 1, 1, 1, 1, 1]], np.int32)
LENS = np.asarray([5, 8, 3], np.int32)


@pytest.fixture(scope="module")
def setup():
    """Tiny weights with a sharper mel head; one torch thread (see
    tests/test_torch_infer_fast.py:engines)."""
    rng = np.random.default_rng(6)
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cfg, params, conds
    torch.set_num_threads(threads)


def _stopping(setup, stop_bias):
    """Both packages' weights with the stop code's logit raised by
    `stop_bias`: (JAX params, port model)."""
    cfg, params, _ = setup
    bias = params["mel_head"]["bias"].at[cfg.stop_mel_token].add(stop_bias)
    p2 = dict(params, mel_head=dict(params["mel_head"], bias=bias))
    model = UnifiedVoice(cfg)
    load_jax_params(model, p2)
    return p2, model


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


def _port(fn, setup, model, gen, graphs, b=3, **kw):
    cfg, _, conds = setup
    out = fn(model, cfg, tdec.GenerationConfig(**gen), _t(np.repeat(conds, b, 0)), _t(TEXT[:b]), _t(LENS[:b]),
             torch.Generator().manual_seed(3), graphs=graphs, **kw)
    return [o.numpy() for o in out]


def _jax(fn, setup, params, gen, b=3, **kw):
    cfg, _, conds = setup
    out = fn(params, cfg, jdec.GenerationConfig(**gen), jnp.asarray(np.repeat(conds, b, 0)), jnp.asarray(TEXT[:b]),
             jnp.asarray(LENS[:b]), jax.random.PRNGKey(0), **kw)
    return [np.asarray(o) for o in out]


def _stops_mid_block(lengths, budget=STEPS):
    """Some row stopped inside a block (its last step not a block's last)
    and before the budget ran out."""
    steps = np.asarray(lengths) - 1
    return bool(((steps < budget) & (steps % BLOCK != 0)).any())


def test_greedy_blocks_match_jax(setup):
    """generate_speech greedy, 3 rows stopping at scattered steps: codes and
    lengths token for token JAX's; two blocks, the second ended on the card
    (the predicate) before its budget."""
    params, model = _stopping(setup, 2.5)
    gen = dict(do_sample=False, max_new_tokens=MAX_NEW)
    graphs = CheckedGraphs()
    codes, lengths = _port(tdec.generate_speech, setup, model, gen, graphs.decode)
    gold = _jax(jdec.generate_speech, setup, params, gen)
    np.testing.assert_array_equal(codes, gold[0])
    np.testing.assert_array_equal(lengths, gold[1])
    assert _stops_mid_block(lengths) and lengths.max() - 1 > BLOCK
    assert graphs.decode.blocks == 2 and graphs.decode.steps == lengths.max() - 1


def test_sampled_blocks_on_a_recorded_stream(setup, monkeypatch):
    """Sampled rows: both decoders sample by inverse CDF from the uniforms
    JAX's keys give at each step (tests/test_torch_gpt.py), through blocks;
    rows stop mid-block, codes token for token."""
    params, model = _stopping(setup, 2.5)
    gen = dict(do_sample=True, top_k=30, max_new_tokens=MAX_NEW)
    key = jax.random.PRNGKey(0)
    draws = [np.asarray(jax.random.uniform(jax.random.fold_in(key, s), (3,))) for s in range(MAX_NEW)]
    stream = iter([torch.from_numpy(u) for u in draws])  # tensors already: a step lifts no host data

    def jax_inverse_cdf(k, logits):
        u = jax.random.uniform(k, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    monkeypatch.setattr(tdec, "sample_token", lambda logits, u: inverse_cdf_token(logits, next(stream)))
    kw = dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0)
    gold = _jax(jdec.generate_speech, setup, params, gen, **kw)
    codes, lengths = _port(tdec.generate_speech, setup, model, gen, CheckedGraphs().decode, **kw)
    np.testing.assert_array_equal(codes, gold[0])
    np.testing.assert_array_equal(lengths, gold[1])
    assert _stops_mid_block(lengths) and len(set(lengths.tolist())) > 1


@pytest.mark.parametrize("do_sample", [False, True])
def test_beam_blocks_early_stop_match_jax(setup, monkeypatch, do_sample):
    """3 beams with early_stopping: the admissible bound checked on the card
    before every step (the device counter in _beam_stop_bound_base), the
    loop ending mid-block; greedy, and sampled on one recorded stream of
    uniforms [steps, b, nb*V] (tests/test_torch_beam.py); codes and lengths
    token for token JAX generate_speech_beam's."""
    cfg = setup[0]
    params, model = _stopping(setup, 2.0)
    nb, b = 3, 3
    gen = dict(do_sample=do_sample, num_beams=nb, top_k=30, max_new_tokens=MAX_NEW)
    kw = dict(repetition_penalty=1.0, length_penalty=1.0)
    if do_sample:
        stream = np.random.default_rng(15).random((MAX_NEW, b, nb * cfg.number_mel_codes)).astype(np.float32)

        def jax_select(logp_joint, k, step, gen_, nb_):
            u = jnp.take(jnp.asarray(stream), step, axis=0)
            g = -jnp.log(-jnp.log(u + 1e-20) + 1e-20)
            _, idx = jax.lax.top_k(logp_joint + g, 2 * nb_)
            vals = jnp.take_along_axis(logp_joint, idx, axis=1)
            order = jnp.argsort(-vals, axis=1)
            return jnp.take_along_axis(vals, order, axis=1), jnp.take_along_axis(idx, order, axis=1)

        monkeypatch.setattr(jdec, "_select_successors", jax_select)
        draws = iter(stream)
        monkeypatch.setattr(tdec, "beam_uniforms", lambda shape, g, dev: torch.from_numpy(next(draws)))
    stats = {}
    graphs = CheckedGraphs()
    codes, lengths = _port(tdec.generate_speech_beam, setup, model, gen, graphs.decode, b=b, stats=stats, **kw)
    gold = _jax(jdec.generate_speech_beam, setup, params, gen, b=b, **kw)
    np.testing.assert_array_equal(codes, gold[0])
    np.testing.assert_array_equal(lengths, gold[1])
    assert 0 < stats["steps"] < STEPS and stats["steps"] % BLOCK != 0  # the early stop, on the card, mid-block
    assert graphs.decode.steps == stats["steps"]


def _slot_codes(setup, params, model, n_steps, graphs=None):
    """Two rows admitted at once and a third after 3 steps into a 3-slot
    state, then chunks of n_steps steps until every row is harvested: the
    port's codes (through `graphs`) and JAX slot_steps' codes."""
    cfg, _, conds = setup
    gen = dict(do_sample=False, num_beams=1, max_new_tokens=MAX_NEW)
    tgen, jgen = tdec.GenerationConfig(**gen), jdec.GenerationConfig(**gen)
    st = tslots.slot_state_init(cfg, tgen, 3, 96, torch.float32)
    js = jslots.slot_state_init(cfg, jgen, 3, 96, jnp.float32)
    g = torch.Generator().manual_seed(5)

    def admit(row, slot):
        nonlocal js
        text, lens = TEXT[row : row + 1], LENS[row : row + 1]
        prod = tslots.slot_prefill(model, cfg, tgen, _t(conds), _t(text), _t(lens), g)
        tslots.slot_admit(st, prod, slot, cfg)
        jprod = jslots.slot_prefill(params, cfg, jgen, jnp.asarray(conds), jnp.asarray(text), jnp.asarray(lens),
                                    jax.random.PRNGKey(0))
        js = jslots.slot_admit(js, jprod, slot, cfg)

    admit(0, 0)
    admit(1, 1)
    tslots.slot_steps(model, cfg, tgen, st, 3, g, graphs=graphs)
    js = jslots.slot_steps(params, cfg, jgen, js, 3, jax.random.PRNGKey(1))
    admit(2, 2)
    for _ in range(3):
        tslots.slot_steps(model, cfg, tgen, st, n_steps, g, graphs=graphs)
        js = jslots.slot_steps(params, cfg, jgen, js, n_steps, jax.random.PRNGKey(1))
    return st, js


def test_slot_blocks_match_jax(setup):
    """slot_steps in chunks of 21 steps: each chunk a full block and one of
    5, the rows stopping at scattered steps; codes token for token JAX
    slot_steps' (whose while_loop tests j < n & any(active) on the device),
    and the tick equal."""
    params, model = _stopping(setup, 2.5)
    graphs = CheckedGraphs()
    st, js = _slot_codes(setup, params, model, STEPS, graphs.slot)
    np.testing.assert_array_equal(st.codes.numpy(), np.asarray(js.codes))
    assert int(st.tick) == int(js.tick)
    lengths = tslots.slot_lengths(st.codes, setup[0].stop_mel_token).numpy()
    assert not st.active.any() and len(set(lengths.tolist())) > 1
    assert graphs.slot.steps == int(st.tick)  # every step ran through a checked block


@pytest.mark.parametrize("beams", [False, True])
def test_segmented_blocks_match_jax(setup, beams):
    """The segmented loops (segments of 10 slots: blocks of 9, then 10 and
    2, each segment a key of its own), greedy, rows stopping at scattered
    steps: codes and lengths token for token JAX's segmented loops."""
    params, model = _stopping(setup, 0.5 if beams else 2.5)
    kw = dict(repetition_penalty=2.0) if beams else {}
    gen = dict(do_sample=False, num_beams=3 if beams else 1, max_new_tokens=MAX_NEW)
    port_fn = tdec.generate_speech_beam_segmented if beams else tdec.generate_speech_segmented
    jax_fn = jdec.generate_speech_beam_segmented if beams else jdec.generate_speech_segmented
    stats = {}
    graphs = CheckedGraphs()
    codes, lengths = _port(port_fn, setup, model, gen, graphs.decode, segment=10, stats=stats, **kw)
    gold = _jax(jax_fn, setup, params, gen, segment=10, **kw)
    np.testing.assert_array_equal(codes, gold[0])
    np.testing.assert_array_equal(lengths, gold[1])
    assert stats["segments"] >= 2 and len({k[6] for k, _ in graphs.decode.lanes}) == stats["segments"]


class HostReads(TorchDispatchMode):
    """Counts the host reads of device values: a scalar read
    (_local_scalar_dense) or a copy to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if name in ("_local_scalar_dense", "item") or (name == "_to_copy" and kwargs.get("device") == torch.device("cpu")):
            self.reads += 1
        return func(*args, **kwargs)


@pytest.mark.parametrize("loop", ["decode", "beams", "slots"])
@pytest.mark.parametrize("n", [STEPS, 2 * BLOCK + 3])
def test_host_reads_once_per_block(setup, loop, n):
    """A loop of n steps that does not stop reads the device
    ceil(n / BLOCK) times (the IF of each step is the card's); the same
    loop with one host read a step read it n times before blocks."""
    cfg = setup[0]
    _, model = _stopping(setup, -30.0)  # nothing stops
    gen = tdec.GenerationConfig(do_sample=loop != "beams", num_beams=3 if loop == "beams" else 1, top_k=30,
                                max_new_tokens=n + 1)
    conds = _t(setup[2])
    graphs = CheckedGraphs()
    with torch.no_grad():
        if loop == "slots":
            st = tslots.slot_state_init(cfg, gen, 2, 96, torch.float32)
            g = torch.Generator().manual_seed(1)
            for slot in range(2):
                prod = tslots.slot_prefill(model, cfg, gen, conds, _t(TEXT[slot : slot + 1]), _t(LENS[slot : slot + 1]),
                                           g)
                tslots.slot_admit(st, prod, slot, cfg)
            with HostReads() as mode:
                tslots.slot_steps(model, cfg, gen, st, n, g, graphs=graphs.slot)
            ran = int(st.tick)
        elif loop == "beams":
            beam = tdec._BeamLoop(model, cfg, gen, conds, _t(TEXT[:1]), _t(LENS[:1]), torch.Generator(), 1.0, 0.8, 10.0,
                                  0.0, 0.9, False, False, 2, gen.max_new_tokens)
            with HostReads() as mode:
                beam.run(n, graphs.decode)
            ran = beam.i
        else:
            st, ctx = tdec.prefill_decode_state(model, cfg, gen, conds.repeat(2, 1, 1), _t(TEXT[:2]), _t(LENS[:2]),
                                                torch.Generator().manual_seed(1))
            with HostReads() as mode:
                tdec.decode_steps(model, cfg, st, ctx, n, graphs=graphs.decode)
            ran = st.i
    assert ran == n
    assert mode.reads == math.ceil(n / BLOCK)


class StubBlock:
    """The card's replay of a block, on the CPU: the steps run, the kernel
    wrappers' Python does not (their counters are put back)."""

    def __init__(self, stage, lane, head, body):
        self.stage, self.lane, self.head, self.body = stage, lane, head, body

    def replay(self):
        counts = qmatmul.launches
        GraphStage._block(self.stage, self.lane, self.head, self.body)
        qmatmul.launches = counts


class StubStage(GraphStage):
    """A CPU stage that warms, captures and replays as a CUDA stage does, a
    capture stood in for by one run of the head and the step whose state is
    put back (a capture launches nothing) and whose launches go to
    lane.deltas, a block graph by StubBlock."""

    @property
    def capturing(self):
        return True

    def _warm(self, fn):
        return fn()

    def _capture(self, lane, fns, keep_graph=False):
        kept = [t.clone() for t in lane.tensors + [lane.ctl.status]]
        with self._counts_to(lane):
            for fn in fns:
                fn()
        for t, k in zip(lane.tensors + [lane.ctl.status], kept):
            t.copy_(k)
        return fns, None

    def _assemble(self, lane, graphs):
        return StubBlock(self, lane, *graphs)


class _Loop:
    """A counter loop whose step stands for a decode step on int8 weights:
    its Python bumps K5's counter 97 times (one per quantized matmul), and
    it stops once t reaches `stop`."""

    def __init__(self, stop):
        self.t = torch.zeros(1, dtype=torch.long)
        self.stop = torch.full((1,), stop)

    def step(self):
        qmatmul.launches += 97
        self.t.add_(1)


def test_replayed_launches_count_the_steps_that_ran():
    """The launch accounting of a replayed block: the capture's counts are
    per step, and a replay adds them times the steps it ran, read back with
    the block's status: budgets of 5, 16 and 16 with the loop stopping at
    t = 30 (mid-block), then a block that runs nothing, count 97 x 30."""
    stage = StubStage("dec", Graphs("cpu"), 4)
    loop = _Loop(30)
    lane = stage.bind(("stub",), loop, [(loop, ("t", "stop"))])
    start = qmatmul.launches
    runs = [stage.run(lane, loop.step, lambda: loop.t < loop.stop, budget) for budget in (5, 16, 16, 16)]
    assert runs == [(5, True), (16, True), (9, False), (0, False)]
    assert lane.graph is not None and lane.replays == 3 and lane.deltas == {qmatmul: 97}
    assert int(loop.t) == 30 and qmatmul.launches - start == 97 * 30


def test_latent_and_cond_stages(engines):
    """The engine's teacher-forced latent pass and conditioning pass through
    checked stages (no host read), under the JAX engine's keys with the
    batch, dtype, condition type and weights after them: bit for bit the
    engine's own stages (which on the CPU capture nothing), and within
    1e-4 of the JAX engine's `_latent_fn` and conditioning program."""
    je, te, _ = engines
    prompt = np.random.default_rng(8).standard_normal((1, 100, 57)).astype(np.float32) * 0.1
    conds = te._conds_for(prompt)
    codes = np.random.default_rng(9).integers(0, te.cfg.gpt.number_mel_codes - 2, (2, 19))
    text = np.random.default_rng(10).integers(2, 40, (2, 11))
    code_lens, text_lens = np.asarray([19, 12]), np.asarray([11, 6])
    lat = te._gpt_latent(conds, text, codes, code_lens, text_lengths=text_lens).numpy()
    own = te._graphs
    te._graphs = checked = CheckedGraphs()
    te._value_cache.clear()
    try:
        conds2 = te._conds_for(prompt)
        lat2 = te._gpt_latent(conds2, text, codes, code_lens, text_lengths=text_lens).numpy()
    finally:
        te._graphs = own
    np.testing.assert_array_equal(conds2.numpy(), conds.numpy())
    np.testing.assert_array_equal(lat2, lat)
    (ckey,), (lkey,) = checked.cond.calls, checked.latent.calls
    assert ckey[:3] == ("cond", 1, 100) and ckey[3] == te.cfg.gpt.condition_type
    assert lkey[:4] == ("lat", 2, te._text_bucket(11), te._code_bucket(19))
    jconds = np.asarray(je._conds_for(prompt))
    np.testing.assert_allclose(conds.numpy(), jconds, atol=TOL, rtol=0)
    jlat = np.asarray(je._gpt_latent(jnp.asarray(jconds), text, codes, code_lens, text_lengths=text_lens))
    assert lat.shape == jlat.shape == (2, te._code_bucket(19), te.cfg.gpt.model_dim)
    np.testing.assert_allclose(lat, jlat, atol=TOL, rtol=0)


@pytest.mark.parametrize("condition_type", ["perceiver", "default"])
def test_cond_stage_legacy_condition_types(condition_type):
    """The legacy condition types take the same conditioning stage: its
    call on a padded batch is free of host reads, bit for bit the eager
    get_conditioning and within 1e-4 of JAX's."""
    from tests.test_torch_legacy_conditioning import _jax_conds, _legacy_params

    cfg, params = _legacy_params(condition_type)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = np.random.default_rng(4).standard_normal((2, 100, 100)).astype(np.float32)
    lens = [100, 57]
    stage = CheckedGraphs().cond
    fn = lambda m, n: get_conditioning(model, cfg, m, n)
    with torch.no_grad():
        mine = stage.call(("cond", 2, 100, condition_type), fn, (torch.from_numpy(mel), torch.tensor(lens))).numpy()
        eager = fn(torch.from_numpy(mel), torch.tensor(lens)).numpy()
    np.testing.assert_array_equal(mine, eager)
    np.testing.assert_allclose(mine, np.asarray(_jax_conds(cfg, params, mel, lens)), atol=TOL, rtol=0)
    assert stage.calls == [("cond", 2, 100, condition_type)]


def test_bind_prefers_a_captured_free_lane():
    """A new state of a key takes a free lane that holds a graph before one
    that holds none, so it replays at once instead of warming and capturing
    again; its own lane comes first."""
    stage = Graphs("cpu").decode
    a, b = _Loop(5), _Loop(5)
    lane_a = stage.bind(("k",), a, [(a, ("t", "stop"))])
    lane_b = stage.bind(("k",), b, [(b, ("t", "stop"))])
    assert lane_a is not lane_b
    lane_b.graph = object()  # as if captured
    del a, b
    c = _Loop(5)
    assert stage.bind(("k",), c, [(c, ("t", "stop"))]) is lane_b
    assert stage.bind(("k",), c, [(c, ("t", "stop"))]) is lane_b  # its own lane
