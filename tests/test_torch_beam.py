"""Beam search and typical sampling: the port's beam helpers and
generate_speech_beam against indextts_tpu on the same JAX-initialized tiny
weights, float32 on the CPU.

The helpers take the same logits and states in both packages. Greedy beam
codes and lengths must equal JAX generate_speech_beam (and its dense oracle,
which reorders the whole cache as the port does) token for token, with the
float32 and the int8 KV cache. Sampled beams cannot share RNG bits, so both
decoders draw their Gumbel noise from one recorded uniform stream: JAX's
_select_successors is monkeypatched in this test only. Scores agree within
1e-5 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import indextts_tpu.models.gpt_decode as jdec
from indextts_tpu.models.gpt import get_conditioning as jax_get_conditioning
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu.ops import sampling as jsamp
import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.ops import sampling as tsamp
from indextts_tpu_torch.ops.sampling import inverse_cdf_token
from indextts_tpu_torch.weights import load_jax_params
from tests.test_gpt import tiny_cfg

NB_MAX_NEW = 16


@pytest.fixture(scope="module")
def setup():
    """Tiny weights whose greedy beams finish at different lengths: a sharper
    mel head and a raised stop logit, so that finished hypotheses compete
    with live beams."""
    rng = np.random.default_rng(6)
    cfg = tiny_cfg()
    params = init_unified_voice(jax.random.PRNGKey(0), cfg)
    params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    params["mel_head"]["bias"] = params["mel_head"]["bias"].at[cfg.stop_mel_token].add(2.0)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    mel = rng.standard_normal((1, 40, 100)).astype(np.float32)
    conds = np.asarray(jax_get_conditioning(params, cfg, jnp.asarray(mel), jnp.asarray([40])))
    return cfg, params, model, conds


# row 0 is padded (5 of 8 tokens), row 1 full
TEXT = np.asarray([[5, 6, 7, 8, 9, 1, 1, 1], [11, 12, 13, 14, 15, 16, 17, 18]], np.int32)
LENS = np.asarray([5, 8], np.int32)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a)


def _jax_beam(setup, gen, b, dense=False, **kw):
    cfg, params, _, conds = setup
    fn = jdec._generate_speech_beam_dense if dense else jdec.generate_speech_beam
    out = fn(params, cfg, jdec.GenerationConfig(**gen), jnp.asarray(np.repeat(conds, b, 0)),
             jnp.asarray(TEXT[:b]), jnp.asarray(LENS[:b]), jax.random.PRNGKey(0), **kw)
    return [np.asarray(o) for o in out]


def _port_beam(setup, gen, b, **kw):
    cfg, _, model, conds = setup
    out = tdec.generate_speech_beam(model, cfg, tdec.GenerationConfig(**gen), _t(np.repeat(conds, b, 0)),
                                    _t(TEXT[:b]), _t(LENS[:b]), torch.Generator().manual_seed(0), **kw)
    return [o.numpy() for o in out]


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


def _logits(rng, rows, v, scale=3.0):
    return (rng.standard_normal((rows, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("mtk", [1, 2])
@pytest.mark.parametrize("mass", [0.2, 0.9])
def test_apply_typical_matches_jax(mtk, mass):
    rng = np.random.default_rng(int(mass * 10) + mtk)
    lf = _logits(rng, 4, 300)
    gold = np.asarray(jsamp.apply_typical(jnp.asarray(lf), mass, min_tokens_to_keep=mtk))
    mine = tsamp.apply_typical(torch.from_numpy(lf), mass, min_tokens_to_keep=mtk).numpy()
    np.testing.assert_array_equal(mine <= tsamp.NEG_INF, gold <= -1e29)
    np.testing.assert_allclose(mine, gold, rtol=1e-6, atol=0)


@pytest.mark.parametrize("top_k,mtk", [(30, 1), (5, 2), (1, 2)])
def test_apply_top_k_top_p_matches_jax(top_k, mtk):
    rng = np.random.default_rng(top_k)
    lf = _logits(rng, 3, 200)
    lf[0, :4] = lf[0, 0]  # ties at the top
    gold = np.asarray(jsamp.apply_top_k_top_p(jnp.asarray(lf), top_k, 0.8, min_tokens_to_keep=mtk))
    mine = tsamp.apply_top_k_top_p(torch.from_numpy(lf), top_k, 0.8, min_tokens_to_keep=mtk).numpy()
    np.testing.assert_array_equal(mine, gold)


@pytest.mark.parametrize("typical,do_sample,num_beams", [(True, True, 1), (True, False, 3), (False, True, 3)])
def test_process_logits_matches_jax(typical, do_sample, num_beams):
    rng = np.random.default_rng(3)
    lf = _logits(rng, 3, 200)
    seen = rng.random((3, 200)) < 0.1
    kw = dict(repetition_penalty=10.0, typical_sampling=typical, typical_mass=0.7, temperature=0.8, top_k=30,
              top_p=0.8, do_sample=do_sample, num_beams=num_beams)
    gold = np.asarray(jsamp.process_logits(jnp.asarray(lf), seen_mask=jnp.asarray(seen), **kw))
    mine = tsamp.process_logits(torch.from_numpy(lf), seen_mask=torch.from_numpy(seen), **kw).numpy()
    np.testing.assert_array_equal(mine <= tsamp.NEG_INF, gold <= -1e29)
    np.testing.assert_allclose(mine, gold, rtol=1e-6, atol=0)


def test_sampled_typical_decode_on_a_shared_uniform_stream(setup, monkeypatch):
    """num_beams = 1, typical sampling: both decoders sample by inverse CDF
    from JAX's own uniforms (as tests/test_torch_gpt.py does without it), on
    the fixture's weights without the raised stop logit (sampling would
    otherwise stop at once)."""
    cfg, params, _, conds = setup
    params = dict(params, mel_head=dict(params["mel_head"], bias=jnp.zeros_like(params["mel_head"]["bias"])))
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    gen = dict(do_sample=True, typical_sampling=True, top_k=30, max_new_tokens=NB_MAX_NEW)
    key = jax.random.PRNGKey(0)
    uniforms = [np.asarray(jax.random.uniform(jax.random.fold_in(key, s), (1,))) for s in range(NB_MAX_NEW)]

    def jax_inverse_cdf(k, logits):
        u = jax.random.uniform(k, (logits.shape[0],))
        cdf = jnp.cumsum(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), axis=-1)
        return jnp.minimum(jnp.sum(cdf <= u[:, None], axis=-1), logits.shape[-1] - 1)

    monkeypatch.setattr(jdec, "sample_token", jax_inverse_cdf)
    stream = iter(uniforms)
    monkeypatch.setattr(tdec, "sample_token", lambda logits, g: inverse_cdf_token(logits, torch.tensor(next(stream))))
    kw = dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0, typical_mass=0.5)
    gold = jdec.generate_speech(params, cfg, jdec.GenerationConfig(**gen), jnp.asarray(conds), jnp.asarray(TEXT[:1]),
                                jnp.asarray(LENS[:1]), key, **kw)
    mine = tdec.generate_speech(model, cfg, tdec.GenerationConfig(**gen), _t(conds), _t(TEXT[:1]), _t(LENS[:1]),
                                torch.Generator(), **kw)
    assert int(gold[1][0]) > 3
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(gold[0]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(gold[1]))


# ---------------------------------------------------------------------------
# the beam helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("do_sample,typical,top_k", [(False, False, 30), (True, False, 30), (True, True, 0)])
def test_beam_joint_scores_match_jax(do_sample, typical, top_k):
    rng = np.random.default_rng(11)
    lf = _logits(rng, 6, 66)
    seen = rng.random((6, 66)) < 0.2
    scores = np.asarray([0.0, -1.5, -2.0, -0.3, jdec.NEG_INF, jdec.NEG_INF], np.float32)
    args = (0.9, 0.8, 10.0, 0.7)  # temperature, top_p, repetition_penalty, typical_mass
    gen = dict(do_sample=do_sample, num_beams=3, typical_sampling=typical, top_k=top_k)
    gold = np.asarray(jdec._beam_joint_scores(jnp.asarray(lf), jnp.asarray(seen), jnp.asarray(scores),
                                              jdec.GenerationConfig(**gen), *args))
    mine = tdec._beam_joint_scores(torch.from_numpy(lf), torch.from_numpy(seen), torch.from_numpy(scores),
                                   tdec.GenerationConfig(**gen), *args).numpy()
    np.testing.assert_allclose(mine, gold, rtol=1e-5, atol=0)


def test_greedy_successors_match_jax():
    rng = np.random.default_rng(12)
    cand = _logits(rng, 2, 3 * 66)
    cand[1, 10:14] = cand[1].max()  # ties go to the lower index, as lax.top_k
    gen = dict(do_sample=False, num_beams=3)
    gv, gi = jdec._select_successors(jnp.asarray(cand), jax.random.PRNGKey(0), 0, jdec.GenerationConfig(**gen), 3)
    mv, mi = tdec._select_successors(torch.from_numpy(cand), torch.Generator(), tdec.GenerationConfig(**gen), 3)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(gi))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(gv))


def _step_inputs(cfg, rng, b=2, nb=3, max_new=NB_MAX_NEW):
    v = cfg.number_mel_codes
    logits = _logits(rng, b * nb, v)
    stop = cfg.stop_mel_token
    logits[0, stop] = logits[0].max() + 2.0  # an eos at the top rank
    logits[4, stop] = logits[4].max() + 1.0
    logits[2, stop] = np.sort(logits[2])[-3]  # an eos below the top ranks
    codes = rng.integers(0, cfg.start_mel_token, (b * nb, max_new))
    scores = np.asarray([-0.5, -0.7, -2.0, -0.2, -1.1, -1.3], np.float32)[: b * nb]
    seen = rng.random((b * nb, v)) < 0.2
    best = (np.asarray([-3.0, jdec.NEG_INF], np.float32)[:b], rng.integers(0, 60, (b, max_new)),
            np.asarray([4, 0])[:b])
    return logits, codes, scores, seen, best


@pytest.mark.parametrize("length_penalty", [0.0, 1.0, -0.5])
def test_beam_step_matches_jax(setup, length_penalty):
    cfg = setup[0]
    rng = np.random.default_rng(13)
    logits, codes, scores, seen, best = _step_inputs(cfg, rng)
    b, nb, si, p = 2, 3, 5, 20
    jgen = jdec.GenerationConfig(do_sample=False, num_beams=nb)
    gold = jdec._beam_step(
        cfg, jgen, si, jnp.asarray(logits), jnp.asarray(codes, jnp.int32), jnp.asarray(scores), jnp.asarray(seen),
        tuple(jnp.asarray(x) for x in best),
        lambda lg, sn, bs: jdec._beam_joint_scores(lg, sn, bs, jgen, 1.0, 0.8, 10.0, 0.9),
        lambda cand, key, step: jdec._select_successors(cand, key, step, jgen, nb),
        jax.random.PRNGKey(0), b, nb, length_penalty, prefill_len=p)
    g_codes, g_scores, g_seen, (g_bs, g_bc, g_bl), g_src, g_tok = [jax.tree_util.tree_map(np.asarray, x) for x in gold]

    tgen = tdec.GenerationConfig(do_sample=False, num_beams=nb)
    tbest = tdec.BeamBest(*(_t(x) for x in best))
    m_codes, m_scores, m_seen, m_src, m_tok = tdec._beam_step(
        cfg, tgen, si, torch.from_numpy(logits), _t(codes), torch.from_numpy(scores), torch.from_numpy(seen), tbest,
        lambda lg, sn, bs: tdec._beam_joint_scores(lg, sn, bs, tgen, 1.0, 0.8, 10.0, 0.9),
        lambda cand: tdec._select_successors(cand, torch.Generator(), tgen, nb),
        b, nb, length_penalty, prefill_len=p)
    assert (g_bl != best[2]).any()  # a hypothesis finished in this step
    np.testing.assert_array_equal(m_src.numpy(), g_src)
    np.testing.assert_array_equal(m_tok.numpy(), g_tok)
    np.testing.assert_array_equal(m_codes.numpy(), g_codes)
    np.testing.assert_array_equal(m_seen.numpy(), g_seen)
    np.testing.assert_allclose(m_scores.numpy(), g_scores, rtol=1e-6)
    np.testing.assert_array_equal(tbest.codes.numpy(), g_bc)
    np.testing.assert_array_equal(tbest.length.numpy(), g_bl)
    np.testing.assert_allclose(tbest.score.numpy(), g_bs, rtol=1e-6)


@pytest.mark.parametrize("length_penalty", [0.0, 1.0, -0.5])
def test_beam_finalize_matches_jax(length_penalty):
    rng = np.random.default_rng(14)
    b, nb, max_new, p = 3, 2, NB_MAX_NEW, 20
    codes = rng.integers(0, 60, (b * nb, max_new))
    scores = np.asarray([-4.0, -6.0, -30.0, -31.0, -9.0, -8.0], np.float32)
    # row 0: the live beam wins at length penalty 0; row 1: the finished one;
    # row 2: nothing finished
    best = (np.asarray([-5.0, -0.1, jdec.NEG_INF], np.float32), rng.integers(0, 60, (b, max_new)),
            np.asarray([7, 3, 0]))
    g_codes, g_len = jdec._beam_finalize(jnp.asarray(codes), jnp.asarray(scores), tuple(jnp.asarray(x) for x in best),
                                         b, nb, max_new, length_penalty, p)
    m_codes, m_len = tdec._beam_finalize(_t(codes), torch.from_numpy(scores), tdec.BeamBest(*(_t(x) for x in best)),
                                         b, nb, max_new, length_penalty, p)
    np.testing.assert_array_equal(m_codes.numpy(), np.asarray(g_codes))
    np.testing.assert_array_equal(m_len.numpy(), np.asarray(g_len))


def test_stop_bound_base_matches_jax():
    for lp in (0.0, 1.0, -0.5):
        for i in (0, 5):
            assert tdec._beam_stop_bound_base(lp, 20, 16, i) == float(jdec._beam_stop_bound_base(lp, 20, 16, i))


# ---------------------------------------------------------------------------
# the decode loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,b,quant_kv,length_penalty", [(2, 1, False, 0.0), (3, 2, False, 1.0), (2, 2, True, 0.0),
                                                          (3, 1, True, -0.5)])
def test_greedy_beam_codes_match_jax(setup, nb, b, quant_kv, length_penalty):
    gen = dict(do_sample=False, num_beams=nb, max_new_tokens=NB_MAX_NEW)
    kw = dict(repetition_penalty=1.0, length_penalty=length_penalty)
    codes, lengths = _port_beam(setup, gen, b, quant_kv=quant_kv, **kw)
    gold_codes, gold_lens = _jax_beam(setup, gen, b, quant_kv=quant_kv, **kw)
    np.testing.assert_array_equal(codes, gold_codes)
    np.testing.assert_array_equal(lengths, gold_lens)
    if not quant_kv:  # the dense oracle has the float cache only
        dense_codes, dense_lens = _jax_beam(setup, gen, b, dense=True, **kw)
        np.testing.assert_array_equal(codes, dense_codes)
        np.testing.assert_array_equal(lengths, dense_lens)


def test_greedy_beam_lengths_vary(setup):
    """The fixture's weights exercise both outcomes: a row that ends on a
    finished hypothesis and a row whose live beam wins at max_new."""
    gen = dict(do_sample=False, num_beams=2, max_new_tokens=NB_MAX_NEW)
    stats = {}
    _, lengths = _port_beam(setup, gen, 2, repetition_penalty=1.0, stats=stats)
    assert sorted(lengths.tolist()) == [3, NB_MAX_NEW]
    assert stats["steps"] == NB_MAX_NEW - 1


@pytest.mark.parametrize("typical", [False, True])
def test_sampled_beam_codes_match_on_a_shared_uniform_stream(setup, monkeypatch, typical):
    """beam_sample: both decoders take the Gumbel noise of each step from
    one recorded stream of uniforms [steps, b, nb*V]."""
    cfg = setup[0]
    nb, b = 3, 2
    stream = np.random.default_rng(15).random((NB_MAX_NEW, b, nb * cfg.number_mel_codes)).astype(np.float32)
    orig = jdec._select_successors

    def jax_select(logp_joint, key, step, gen, nb_):
        u = jnp.take(jnp.asarray(stream), step, axis=0)
        g = -jnp.log(-jnp.log(u + 1e-20) + 1e-20)
        _, idx = jax.lax.top_k(logp_joint + g, 2 * nb_)
        vals = jnp.take_along_axis(logp_joint, idx, axis=1)
        order = jnp.argsort(-vals, axis=1)
        return jnp.take_along_axis(vals, order, axis=1), jnp.take_along_axis(idx, order, axis=1)

    assert orig.__code__.co_argcount == 5
    monkeypatch.setattr(jdec, "_select_successors", jax_select)
    draws = iter(stream)
    monkeypatch.setattr(tdec, "beam_uniforms", lambda shape, g, dev: torch.from_numpy(next(draws)))
    gen = dict(do_sample=True, num_beams=nb, top_k=30, typical_sampling=typical, max_new_tokens=NB_MAX_NEW)
    kw = dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0, typical_mass=0.8)
    codes, lengths = _port_beam(setup, gen, b, **kw)
    gold_codes, gold_lens = _jax_beam(setup, gen, b, **kw)
    np.testing.assert_array_equal(codes, gold_codes)
    np.testing.assert_array_equal(lengths, gold_lens)
