"""Slot decoding in the port (models/gpt_slots.py): the seven cases of
tests/test_slots.py, each held three ways on the same JAX-initialized tiny
float32 weights: the port's slot rows against the port's generate_speech per
row, and against JAX slot_steps, token for token. Rows admitted together,
admitted mid-decode, placed across the wrap of the circular cache and into a
reused slot; captured latents against the solo capture (2e-5); the int8
cache; per-row sampling columns; and sampled rows on one recorded uniform
stream (JAX's sample_token is monkeypatched in that test only)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
import indextts_tpu.models.gpt_slots as jslots
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
import indextts_tpu_torch.models.gpt_decode as tdec
import indextts_tpu_torch.models.gpt_slots as tslots
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg

MAX_NEW = 16
GEN = dict(do_sample=False, num_beams=1, max_new_tokens=MAX_NEW)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def setup():
    """A sharper mel head than the init's, so that greedy rows run for
    several codes and stop at different lengths."""
    rng = np.random.default_rng(23)
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    # one torch thread for the eager step loops (see tests/test_torch_infer_fast.py:engines)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cfg, params, model, conds
    torch.set_num_threads(threads)


def _text(lt, seed):
    return np.random.default_rng(seed).integers(2, 48, (1, lt)).astype(np.int32)


class Port:
    """The port's side of a scenario."""

    def __init__(self, setup, gen=GEN):
        self.cfg, _, self.model, conds = setup
        self.conds = torch.from_numpy(np.array(conds))
        self.gen = tdec.GenerationConfig(**gen)
        self.g = torch.Generator().manual_seed(0)

    def init(self, n_slots, cache_len, **kw):
        self.state = tslots.slot_state_init(self.cfg, self.gen, n_slots, cache_len, torch.float32, **kw)

    def admit(self, text, slot, **kw):
        t = torch.from_numpy(text).long()
        prod = tslots.slot_prefill(self.model, self.cfg, self.gen, self.conds, t, torch.tensor([t.shape[1]]), self.g,
                                   **kw)
        tslots.slot_admit(self.state, prod, slot, self.cfg)

    def steps(self, n, **kw):
        tslots.slot_steps(self.model, self.cfg, self.gen, self.state, n, self.g, **kw)

    def drain(self, **kw):
        for _ in range(10):
            self.steps(50, **kw)
            if not bool(self.state.active.any()):
                return
        raise AssertionError("slot decode did not drain")

    def solo(self, text, **kw):
        t = torch.from_numpy(text).long()
        out = tdec.generate_speech(self.model, self.cfg, self.gen, self.conds, t, torch.tensor([t.shape[1]]),
                                   torch.Generator().manual_seed(0), **kw)
        return [o.numpy() for o in out]

    def codes(self, slot):
        return self.state.codes[slot].numpy()

    def lengths(self):
        return tslots.slot_lengths(self.state.codes, self.cfg.stop_mel_token).numpy()


class Jax:
    """The JAX package's side of the same scenario."""

    def __init__(self, setup, gen=GEN):
        self.cfg, self.params, _, conds = setup
        self.conds = jnp.asarray(conds)
        self.gen = jdec.GenerationConfig(**gen)

    def init(self, n_slots, cache_len, **kw):
        self.state = jslots.slot_state_init(self.cfg, self.gen, n_slots, cache_len, jnp.float32, **kw)

    def admit(self, text, slot, **kw):
        t = jnp.asarray(text)
        prod = jslots.slot_prefill(self.params, self.cfg, self.gen, self.conds, t, jnp.asarray([t.shape[1]]), KEY,
                                   **kw)
        self.state = jslots.slot_admit(self.state, prod, slot, self.cfg)

    def steps(self, n, **kw):
        kw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        self.state = jslots.slot_steps(self.params, self.cfg, self.gen, self.state, n, KEY, **kw)

    def drain(self, **kw):
        for _ in range(10):
            self.steps(50, **kw)
            if not bool(np.asarray(self.state.active).any()):
                return
        raise AssertionError("slot decode did not drain")

    def codes(self, slot):
        return np.asarray(self.state.codes[slot])


def _both(setup, gen=GEN):
    return Port(setup, gen), Jax(setup, gen)


def _check_rows(port, jax_side, rows, **solo_kw):
    """rows: (text, slot). Port slot codes == port solo codes == JAX slot codes."""
    for text, slot in rows:
        codes_s, lens_s = port.solo(text, **solo_kw)[:2]
        np.testing.assert_array_equal(port.codes(slot), codes_s[0])
        np.testing.assert_array_equal(port.codes(slot), jax_side.codes(slot))
        assert int(port.lengths()[slot]) == int(lens_s[0])


def test_two_rows_admitted_together(setup):
    ta, tb = _text(6, 1), _text(9, 2)
    port, jx = _both(setup)
    for side in (port, jx):
        side.init(4, 64)
        side.admit(ta, 0)
        side.admit(tb, 2)
        side.drain()
    _check_rows(port, jx, ((ta, 0), (tb, 2)))
    assert int(port.lengths()[0]) > 3  # a real decode, not an immediate stop
    # the untouched slots stayed empty
    assert not bool(port.state.done[1]) and not bool(port.state.done[3])
    np.testing.assert_array_equal(port.state.done.numpy(), np.asarray(jx.state.done))
    assert port.state.tick == int(jx.state.tick) and port.state.cursor == int(jx.state.cursor)


def test_rolling_admission_does_not_perturb_running_rows(setup):
    """B is admitted after A has decoded 4 codes; both equal their solos."""
    ta, tb = _text(8, 3), _text(5, 4)
    port, jx = _both(setup)
    mids = []
    for side in (port, jx):
        side.init(2, 64)
        side.admit(ta, 0)
        side.steps(4)
        mids.append(side.codes(0).copy())
        side.admit(tb, 1)
        side.drain()
    _check_rows(port, jx, ((ta, 0), (tb, 1)))
    np.testing.assert_array_equal(mids[0], mids[1])
    # A's prefix, emitted before B came, was untouched by B's admission
    np.testing.assert_array_equal(port.codes(0)[:5], mids[0][:5])
    # the rows sit at different ages: per-row mel positions are really exercised
    assert int(port.lengths()[0]) > 5


def test_slot_reuse_wraps_the_circular_cache(setup):
    """cache_len at its minimum (p_max + max_new): five requests through ONE
    slot push the cursor around the ring; placement and masks stay exact
    across the wrap."""
    cfg = setup[0]
    texts = [_text(7, 10 + i) for i in range(5)]
    p_max = cfg.condition_num_latent + 7 + 3
    s_len = p_max + MAX_NEW
    port, jx = _both(setup)
    for side in (port, jx):
        side.init(1, s_len)
    for text in texts:
        for side in (port, jx):
            side.admit(text, 0)
            side.drain()
        assert bool(port.state.done[0])
        _check_rows(port, jx, ((text, 0),))
    assert port.state.tick == int(jx.state.tick) and port.state.cursor == int(jx.state.cursor)
    assert port.state.tick > s_len  # the cursor went round the ring (and the first prefill, at cursor 0, wrapped too)


def test_capacity_check(setup):
    cfg = setup[0]
    port = Port(setup)
    port.init(1, cfg.condition_num_latent + 7 + 3 + MAX_NEW - 1)
    with pytest.raises(ValueError, match="lap"):
        port.admit(_text(7, 10), 0)


def test_captured_latents_match_solo_capture(setup):
    ta, tb = _text(6, 20), _text(9, 21)
    port, jx = _both(setup)
    for side in (port, jx):
        side.init(2, 64, capture_latents=True)
        side.admit(ta, 0, capture_latents=True)
        side.steps(3, pos_off=1)
        side.admit(tb, 1, capture_latents=True)
        side.drain(pos_off=1)
    _check_rows(port, jx, ((ta, 0), (tb, 1)), capture_latents=True, pos_off=1)
    for text, slot in ((ta, 0), (tb, 1)):
        _, lens_s, lat_s = port.solo(text, capture_latents=True, pos_off=1)
        n = int(lens_s[0])
        np.testing.assert_allclose(port.state.lat[slot, :n].numpy(), lat_s[0, :n], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port.state.lat[slot, :n].numpy(), np.asarray(jx.state.lat[slot][:n]),
                                   rtol=1e-4, atol=1e-4)


def test_quant_kv_slots_match_quant_solo(setup):
    ta, tb = _text(5, 30), _text(8, 31)
    port, jx = _both(setup)
    for side in (port, jx):
        side.init(2, 64, quant_kv=True)
        side.admit(ta, 0, quant_kv=True)
        side.steps(2)
        side.admit(tb, 1, quant_kv=True)
        side.drain()
    assert len(port.state.cache) == 4 and port.state.cache[0].dtype == torch.int8
    _check_rows(port, jx, ((ta, 0), (tb, 1)), quant_kv=True)


def test_per_row_dynamic_columns(setup):
    """Rows with DIFFERENT repetition penalties share the step; each equals
    its solo run with that scalar."""
    ta, tb = _text(7, 40), _text(7, 41)
    port, jx = _both(setup)
    rp = torch.tensor([1.0, 10.0])
    for side in (port, jx):
        side.init(2, 64)
        side.admit(ta, 0, repetition_penalty=1.0)
        side.admit(tb, 1, repetition_penalty=10.0)
        side.drain(repetition_penalty=rp)
    for text, slot, pen in ((ta, 0, 1.0), (tb, 1, 10.0)):
        _check_rows(port, jx, ((text, slot),), repetition_penalty=pen)
    # the penalty matters here: the other row's value gives other codes
    assert not np.array_equal(port.solo(tb, repetition_penalty=1.0)[0][0], port.codes(1))


def test_sampled_rows_on_a_shared_uniform_stream(setup, monkeypatch):
    """Both packages sample by inverse CDF from the uniforms JAX's own keys
    give: fold_in(KEY, 0) at each prefill, fold_in(KEY, tick) at each step.
    Codes are equal, lengths and code ranges are what slot_lengths says."""
    gen = dict(do_sample=True, num_beams=1, top_k=20, max_new_tokens=12)

    def jax_inverse_cdf(key, logits):
        u = jax.random.uniform(key, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    monkeypatch.setattr(jslots, "sample_token", jax_inverse_cdf)
    u_prefill = np.asarray(jax.random.uniform(jax.random.fold_in(KEY, 0), (1,)))
    stream = iter([u_prefill, u_prefill] + [np.asarray(jax.random.uniform(jax.random.fold_in(KEY, t), (2,)))
                                            for t in range(12)])
    draw = lambda logits, g: inverse_cdf_token(logits, torch.tensor(next(stream)))
    monkeypatch.setattr(tdec, "sample_token", draw)
    monkeypatch.setattr(tslots, "sample_token", draw)
    port, jx = _both(setup, gen)
    for side in (port, jx):
        side.init(2, 60)
        side.admit(_text(6, 50), 0)
        side.admit(_text(6, 51), 1)
        side.drain()
    for slot in (0, 1):
        np.testing.assert_array_equal(port.codes(slot), jx.codes(slot))
    lens = port.lengths()
    np.testing.assert_array_equal(lens, np.asarray(jslots.slot_lengths(jx.state.codes, setup[0].stop_mel_token)))
    assert ((1 <= lens) & (lens <= 12)).all() and lens.max() > 2
    codes = port.state.codes.numpy()
    assert ((0 <= codes) & (codes < setup[0].number_mel_codes)).all()
    assert not np.array_equal(port.codes(0), port.codes(1))
