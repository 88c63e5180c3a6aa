"""The granite hybrid decoder (models/granite.py) against the plain
reference, benchmark/reference/models/unifiedvoice-granite-hybrid.py, at a
tiny size in float32 on the CPU: 2 Mamba heads of 16 with a state of 16,
chunks of 8, two periods of 3 Mamba layers and 1 NoPE GQA attention layer
(4 query heads over 2 KV heads), the published init of A and dt.

Covered: the teacher-forced pass's logits and latents; prefill then decode
through both kinds of state (and the int8 KV cache) against the full pass,
logits compared; a left-padded row of a batch against the row alone; a
prompt over several chunks against the recurrence; slot admission into a
busy slot state; the beams' reorder of the states against a dense beam
search on the reference; the engine's infer, infer_batch and slot session
(each served greedy code the reference's best, and the three alike) and its
latent pass; K7's and K6-GQA's plain versions against the reference's
recurrence and attention; the mesh's refusal; the configuration's checks."""

import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from indextts_tpu_torch.config import BigVGANConfig, GPTConfig, IndexTTSConfig, save_config
from indextts_tpu_torch.models import gpt_decode as tdec
from indextts_tpu_torch.models import gpt_slots as tslots
from indextts_tpu_torch.models.gpt import UnifiedVoice, unified_voice_forward
from indextts_tpu_torch.models.granite import split_cache, ssd_scan
from indextts_tpu_torch.ops.cuda import decode_attn as k6
from indextts_tpu_torch.ops.cuda import ssm_step as k7

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")

TYPES = ("mamba", "mamba", "mamba", "attention") * 2
G = dict(layers=8, model_dim=16, heads=4, kv_heads=2, max_text_tokens=60, max_mel_tokens=60, number_text_tokens=40,
         start_text_token=0, stop_text_token=1, number_mel_codes=66, start_mel_token=64, stop_mel_token=65,
         mel_length_compression=1024, condition_type="conformer_perceiver", condition_num_latent=8,
         condition_module=dict(output_size=32, linear_units=64, attention_heads=2, num_blocks=1, input_layer="conv2d2",
                               perceiver_mult=2),
         block="granite_hybrid", layer_types=list(TYPES), intermediate_size=48, mamba_heads=2, mamba_head_dim=16,
         mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_n_groups=1, mamba_chunk_size=8, rms_norm_eps=1e-5,
         embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=0.015625, logits_scaling=8.0)
TOL = 2e-5  # float32 against float32: the chunked scan and the recurrence against the quadratic form
# the mixers' output projections scaled up from the published init (0.02 / sqrt(2 x layers)), so that
# the tiny stack's states move its logits and codes (the tests then see a state lost or misplaced)
MIXER_GAIN = 25.0


def _strengthen(model):
    with torch.no_grad():
        for blk in model.gpt.blocks:
            (blk.out_proj if blk.kind == "mamba" else blk.attn_proj).weight.mul_(MIXER_GAIN)


def _reference():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(
        "granite_reference_under_test", os.path.join(BENCH, "reference", "models", "unifiedvoice-granite-hybrid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    """The tiny model with the published init (its stop code's logit lowered,
    so that rows decode their budget), the reference and its weights."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see tests/test_torch_infer_fast.py:engines
    cfg = GPTConfig.from_dict(G)
    model = UnifiedVoice(cfg)
    model.reset_parameters(torch.Generator().manual_seed(5))
    _strengthen(model)
    with torch.no_grad():
        model.mel_head.bias[cfg.stop_mel_token] = -1e4
    model.eval().requires_grad_(False)
    W = {k: v.float() for k, v in model.state_dict().items()}
    yield SimpleNamespace(cfg=cfg, model=model, ref=_reference(), W=W)
    torch.set_num_threads(threads)


def _inputs(seed, n_text=11, n_codes=20):
    g = torch.Generator().manual_seed(seed)
    conds = torch.randn(8, G["model_dim"], generator=g)
    return conds, torch.randint(2, 40, (n_text,), generator=g), torch.randint(0, 64, (n_codes,), generator=g)


def _close(a, b, tol=TOL):
    err = (a - b).abs().max().item()
    assert err <= tol * max(1.0, b.abs().max().item()), err


def _close_logits(a, b):
    """_close over the mel logits but the stop code's, whose bias of -1e4
    would scale the tolerance past the other logits' whole range."""
    keep = torch.arange(b.shape[-1]) != G["stop_mel_token"]
    _close(a[..., keep], b[..., keep])


def _decode_logits(s, conds, text, codes, pos_off, quant_kv):
    """Prefill of [conds | text | start_mel], then one decode step per code
    but the last, through the cache; the logits of every step."""
    m, cfg = s.model, s.cfg
    emb, mask = tdec.prepare_gpt_inputs(m, cfg, conds[None], text[None], torch.tensor([text.shape[0]]))
    p, n = emb.shape[1], codes.shape[0]
    logits0, cache = tdec._prefill(m, cfg, emb, mask, p + n, quant_kv=quant_kv)
    valid = torch.nn.functional.pad(mask, (0, n))
    out = [logits0]
    for i in range(n - 1):
        v = valid.clone()
        v[:, p : p + i] = True
        out.append(tdec._decode_step(m, cfg, codes[i : i + 1], i + pos_off, cache, p + i, v))
    return torch.cat(out), cache


@pytest.mark.parametrize("pos_off,quant_kv", [(2, False), (1, False), (2, True), (1, True)])
def test_prefill_then_decode_matches_the_full_pass(setup, pos_off, quant_kv):
    """Prefill, then a decode step per code through the KV cache (int8 under
    quant_kv) and the conv and SSM states, against the reference's one causal
    pass; logits compared (not tokens)."""
    conds, text, codes = _inputs(0)
    ref, _ = setup.ref.forward(setup.W, G, conds, text, codes, pos_off, quant_kv)
    got, cache = _decode_logits(setup, conds, text, codes, pos_off, quant_kv)
    _close_logits(got, ref)
    kv, (conv, ssm) = split_cache(cache)
    assert len(kv) == (4 if quant_kv else 2) and kv[0].shape[0] == 2 and conv.shape == (6, 1, 64, 3)
    assert ssm.shape == (6, 1, 2, 16, 16) and ssm.dtype == torch.float32


def test_the_teacher_forced_pass_matches_the_reference(setup):
    """unified_voice_forward's latents (two rows, text padded in the middle of
    the sequence, keys masked) and its mel logits against the reference."""
    conds, text, codes = _inputs(1, n_codes=14)
    _, text2, codes2 = _inputs(2, n_text=7, n_codes=9)
    tl, cl = torch.tensor([11, 7]), torch.tensor([14, 9])
    texts = torch.stack([text, torch.nn.functional.pad(text2, (0, 4), value=1)])
    code_rows = torch.stack([codes, torch.nn.functional.pad(codes2, (0, 5), value=65)])
    lat = unified_voice_forward(setup.model, setup.cfg, None, texts, tl, code_rows, (cl - 1) * 1024, None,
                                conds=conds[None].expand(2, -1, -1), mask_pad_keys=True)
    for r, (t, c) in enumerate(((text, codes), (text2, codes2))):
        _, want = setup.ref.forward(setup.W, G, conds, t, c, 1)
        _close(lat[r, : c.shape[0]], want)
    # the logits of the unpadded row, the loss path's
    _, _, mel_logits = unified_voice_forward(setup.model, setup.cfg, None, text[None], tl[:1], codes[None],
                                             (cl[:1] - 1) * 1024, None, conds=conds[None], return_latent=False)
    want, _ = setup.ref.forward(setup.W, G, conds, text, codes, 1)
    _close_logits(mel_logits[0, :, : codes.shape[0]].T, want)


def test_a_left_padded_row_equals_the_row_alone(setup):
    """Greedy generate_speech over three rows of different text lengths (left
    padded to the longest) gives each row's codes, and its states after the
    prefill, as the row alone."""
    m, cfg = setup.model, setup.cfg
    g = torch.Generator().manual_seed(3)
    conds = 0.5 * torch.randn(3, 8, 16, generator=g)
    text = torch.randint(2, 40, (3, 12), generator=g)
    lens = torch.tensor([12, 9, 4])
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=20)
    codes, _ = tdec.generate_speech(m, cfg, gen, conds, text, lens, torch.Generator())
    state, _ = tdec.prefill_decode_state(m, cfg, gen, conds, text, lens, torch.Generator())
    for r in range(3):
        alone, _ = tdec.generate_speech(m, cfg, gen, conds[r : r + 1], text[r : r + 1, : lens[r]], lens[r : r + 1],
                                        torch.Generator())
        assert torch.equal(codes[r], alone[0])
        st, _ = tdec.prefill_decode_state(m, cfg, gen, conds[r : r + 1], text[r : r + 1, : lens[r]], lens[r : r + 1],
                                          torch.Generator())
        for big, small in zip(split_cache(state.cache)[1], split_cache(st.cache)[1]):
            _close(big[:, r], small[:, 0])


@pytest.mark.parametrize("chunk", [3, 8, 64])
def test_the_chunked_scan_equals_the_recurrence(chunk):
    """ssd_scan over 30 positions in chunks (the state carried between 10, 4
    or 1 of them) against the step-by-step recurrence; the final state too."""
    g = torch.Generator().manual_seed(chunk)
    b, t, h, p, n = 2, 30, 3, 4, 5
    x, bm, cm = torch.randn(b, t, h, p, generator=g), torch.randn(b, t, n, generator=g), torch.randn(b, t, n, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g))
    y, final = ssd_scan(x, dt, a, bm, cm, chunk)
    state = torch.zeros(b, h, p, n)
    for i in range(t):
        da = torch.exp(dt[:, i] * a)
        state = da[..., None, None] * state + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :]
        _close(y[:, i], (state * cm[:, i, None, None, :]).sum(-1), 1e-5)
    _close(final, state, 1e-5)


def test_a_prompt_over_several_chunks(setup):
    """A prompt of 8 + 30 + 3 positions spans six chunks of 8: prefill and
    decode against the full pass (the state carried between chunks)."""
    conds, text, codes = _inputs(4, n_text=30, n_codes=10)
    assert -(-(8 + 30 + 3) // G["mamba_chunk_size"]) == 6
    ref, _ = setup.ref.forward(setup.W, G, conds, text, codes, 2)
    got, _ = _decode_logits(setup, conds, text, codes, 2, False)
    _close_logits(got, ref)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_slot_admit_into_a_busy_slot_state(setup, quant_kv):
    """Slots decoding, one harvested and a new request admitted into it
    mid-decode (its conv and SSM states overwritten whole), across the
    circular cache's wrap: every row's codes equal generate_speech alone."""
    m, cfg = setup.model, setup.cfg
    g = torch.Generator().manual_seed(6)
    conds = 0.5 * torch.randn(4, 8, 16, generator=g)
    text = torch.randint(2, 40, (4, 10), generator=g)
    lens = torch.tensor([10, 6, 8, 9])
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=16)
    st = tslots.slot_state_init(cfg, gen, 3, 40, torch.float32, quant_kv=quant_kv)

    def admit(r, slot):
        prod = tslots.slot_prefill(m, cfg, gen, conds[r : r + 1], text[r : r + 1, : lens[r]], lens[r : r + 1],
                                   torch.Generator(), quant_kv=quant_kv)
        tslots.slot_admit(st, prod, slot, cfg)

    for r in range(3):
        admit(r, r)
    tslots.slot_steps(m, cfg, gen, st, 7, torch.Generator())
    first = st.codes[1].clone()
    tslots.slot_steps(m, cfg, gen, st, 20, torch.Generator())  # row 1 finishes; the others too
    got = {r: st.codes[r].clone() for r in (0, 2)}
    got[1] = first
    admit(3, 1)  # slot 1's states hold row 1's: the admission replaces them
    tslots.slot_steps(m, cfg, gen, st, 20, torch.Generator())
    got[3] = st.codes[1].clone()
    for r in range(4):
        alone, _ = tdec.generate_speech(m, cfg, gen, conds[r : r + 1], text[r : r + 1, : lens[r]], lens[r : r + 1],
                                        torch.Generator(), quant_kv=quant_kv)
        n = 8 if r == 1 else 16
        assert torch.equal(got[r][:n], alone[0][:n]), r


@pytest.mark.parametrize("quant_kv", [False, True])
def test_rows_prefilled_in_one_batch_admit_as_alone(setup, quant_kv):
    """Three rows of different lengths prefilled in one batch (the shorter
    left-padded to the longest), as a slot session admits a hybrid stack's
    rows, and each admitted into its slot: the written K / V columns, the
    conv and SSM states and the first codes equal those of each row
    prefilled alone, and the rows then decode the same codes."""
    m, cfg = setup.model, setup.cfg
    g = torch.Generator().manual_seed(7)
    conds = 0.5 * torch.randn(3, 8, 16, generator=g)
    text = torch.randint(2, 40, (3, 12), generator=g)
    lens = torch.tensor([12, 5, 9])
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=16)
    alone, batched = (tslots.slot_state_init(cfg, gen, 3, 48, torch.float32, quant_kv=quant_kv) for _ in range(2))
    for r in range(3):
        prod = tslots.slot_prefill(m, cfg, gen, conds[r : r + 1], text[r : r + 1, : lens[r]], lens[r : r + 1],
                                   torch.Generator(), quant_kv=quant_kv)
        tslots.slot_admit(alone, prod, r, cfg)
    prod = tslots.slot_prefill(m, cfg, gen, conds, text, lens, torch.Generator(), quant_kv=quant_kv)
    for r in range(3):
        tslots.slot_admit(batched, prod, r, cfg, row=r)
    (kv_a, states_a), (kv_b, states_b) = split_cache(alone.cache), split_cache(batched.cache)
    for r in range(3):
        ma, mb = alone.mask[r], batched.mask[r]
        assert int(ma.sum()) == int(mb.sum()) == 8 + int(lens[r]) + 3
        for a, b in zip(kv_a, kv_b):
            got, want = (t[:, r][:, :, m_] for t, m_ in ((b, mb), (a, ma)))
            _close(got.float(), want.float())
        for a, b in zip(states_a, states_b):
            _close(b[:, r], a[:, r])
    assert torch.equal(batched.codes[:, 0], alone.codes[:, 0])
    for st in (alone, batched):
        tslots.slot_steps(m, cfg, gen, st, 16, torch.Generator())
    assert torch.equal(batched.codes, alone.codes)


def _dense_beams(s, conds, text, nb, steps, penalty):
    """Beam search by the reference's full pass over every beam's prefix:
    log-softmax scores with the repetition penalty on them, plus the beam's
    score; the best nb of all beams' successors (ties to the lower index)."""
    beams = [([], 0.0)]
    moved = False  # a beam took another beam's parent after the first step
    for step in range(steps):
        cands = []
        for codes, score in beams:
            c = torch.tensor(codes + [0], dtype=torch.long)
            logits, _ = s.ref.forward(s.W, G, conds, text, c, 2)
            lp = torch.log_softmax(logits[-1], dim=-1)
            seen = torch.zeros(66, dtype=torch.bool)
            seen[[1, 64] + codes] = True
            lp = torch.where(seen, torch.where(lp > 0, lp / penalty, lp * penalty), lp) + score
            cands.append(lp)
        joint = torch.stack(cands).reshape(-1)
        order = torch.sort(joint, descending=True, stable=True).indices[:nb]
        moved |= step > 0 and [int(i) // 66 for i in order] != list(range(nb))
        beams = [(beams[i // 66][0] + [int(i % 66)], float(joint[i])) for i in order]
    return beams, moved


def test_the_beams_reorder_both_kinds_of_state(setup):
    """Greedy beam search through the cache: after every step the KV cache
    and the conv and SSM states follow their beams (index_select); the
    winner's codes equal a dense beam search on the reference's full pass."""
    conds, text, _ = _inputs(8, n_text=9)
    nb, steps = 3, 8
    gen = tdec.GenerationConfig(do_sample=False, num_beams=nb, max_new_tokens=steps, early_stopping=False)
    codes, lengths = tdec.generate_speech_beam(setup.model, setup.cfg, gen, conds[None], text[None],
                                               torch.tensor([9]), torch.Generator(), repetition_penalty=2.0)[:2]
    beams, moved = _dense_beams(setup, conds, text, nb, steps, 2.0)
    assert moved and int(lengths[0]) == steps and codes[0].tolist() == beams[0][0]


def test_k7_plain_is_the_references_recurrence(setup):
    """A Mamba layer stepped token by token through K7's plain version (from
    zero states) against the reference's mixer over the whole sequence."""
    blk = setup.model.gpt.blocks[1]
    g = torch.Generator().manual_seed(9)
    x = torch.randn(10, 16, generator=g)
    want = setup.ref.mamba(setup.W, G, "gpt.blocks.1", x)
    conv, state = torch.zeros(1, 64, 3), torch.zeros(1, 2, 16, 16)
    got = []
    for t in range(10):
        zx = blk.in_proj(x[t : t + 1])
        gated = k7.ssm_step(zx, conv, blk.conv1d.weight, blk.conv1d.bias, blk.dt_bias, blk.A_log, blk.D, state, 2, 16,
                            16)
        normed = gated * torch.rsqrt(gated.pow(2).mean(-1, keepdim=True) + 1e-5) * blk.norm.weight
        got.append(blk.out_proj(normed))
    _close(torch.cat(got), want)


@pytest.mark.parametrize("quant", [False, True])
def test_k6_gqa_plain_is_the_references_attention(quant):
    """K6's plain version with 2 query heads a KV head and granite's scale:
    one token against a cache of 12 columns, as the reference attends
    (each KV head repeated for its query heads; int8 K / V rounded per
    KV-head pair)."""
    ref = _reference()
    g = torch.Generator().manual_seed(10)
    hq, hk, dh, s = 4, 2, 8, 12
    y = torch.randn(1, (hq + 2 * hk) * dh, generator=g)
    q, k, v = (t.unflatten(-1, (-1, dh)) for t in y.split([hq * dh, hk * dh, hk * dh], dim=-1))
    keys, vals = torch.randn(1, hk, s, dh, generator=g), torch.randn(1, hk, s, dh, generator=g)
    bias = torch.zeros(1, 1, s)
    bias[..., 9:] = torch.finfo(torch.float32).min  # 9 cached columns; the token goes to column 9
    if quant:
        cache = k6.quant_cols(keys) + k6.quant_cols(vals)
        keys, vals = ref.quantize_kv(keys[0])[None], ref.quantize_kv(vals[0])[None]
    else:
        cache = (keys.clone(), vals.clone())
    out = k6.decode_attn(q, k, v, cache, 9, bias, 0.015625)
    kk = torch.cat([keys[0, :, :9], k[0][:, None]], dim=1).repeat_interleave(2, dim=0)
    vv = torch.cat([vals[0, :, :9], v[0][:, None]], dim=1).repeat_interleave(2, dim=0)
    a = torch.softmax((q[0][:, None] @ kk.transpose(-1, -2)) * 0.015625, dim=-1) @ vv
    _close(out, a.reshape(1, -1), 1e-5)


def test_the_mesh_refuses_the_hybrid_stack(setup):
    from indextts_tpu_torch.parallel.mesh import local_heads, shard_gpt_params

    with pytest.raises(NotImplementedError, match="sharded Mamba heads and states"):
        shard_gpt_params(setup.model, SimpleNamespace(shape={"model": 2}))
    assert local_heads(setup.model) == 2  # the KV heads of the cache


@pytest.mark.parametrize("bad", [dict(layer_types=["mamba"] * 7), dict(layer_types=["mamba"] * 7 + ["moe"]),
                                 dict(mamba_n_groups=2), dict(kv_heads=3), dict(block="mamba")])
def test_the_configuration_checks(bad):
    with pytest.raises((ValueError, NotImplementedError)):
        GPTConfig.from_dict(dict(G, **bad))


# ---------------------------------------------------------------------------
# the engine's entry points
# ---------------------------------------------------------------------------

GREEDY = dict(do_sample=False, num_beams=1, max_mel_tokens=10, repetition_penalty=1.0)


@pytest.fixture(scope="module")
def engine(tmp_path_factory, setup):
    from indextts_tpu_torch.engine import IndexTTS

    d = tmp_path_factory.mktemp("granite_engine")
    cfg = IndexTTSConfig(gpt=GPTConfig.from_dict(dict(G, max_text_tokens=120, max_mel_tokens=48)),
                         bigvgan=BigVGANConfig(gpt_dim=16, upsample_initial_channel=32, upsample_rates=(4, 2),
                                               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                                               resblock_dilation_sizes=((1, 3),), speaker_embedding_dim=32))
    save_config(cfg, str(d / "config.yaml"))
    eng = IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d), is_fp16=False, device="cpu",
                   allow_random_init=True, seed=1)
    _strengthen(eng.gpt)
    with torch.no_grad():
        eng.gpt.mel_head.bias[eng.stop_mel_token] = -1e4
    return eng


def _prompt(seed, frames=40):
    return np.random.default_rng(seed).standard_normal((1, 100, frames)).astype(np.float32) * 0.1


def _codes(engine, fn):
    """fn()'s output and the codes of each _gpt_generate call it made."""
    seen = []
    inner = engine._gpt_generate

    def recording(*a, **k):
        out = inner(*a, **k)
        seen.append(out[0])
        return out

    engine._gpt_generate = recording
    try:
        return fn(), seen
    finally:
        del engine._gpt_generate


class _Served:
    """The rows an engine decodes: (conds [C, D], text tokens, codes up to
    the stop code) of each row that _gpt_generate returns (infer,
    infer_batch) and of each row a slot session's harvest takes off."""

    def __init__(self, engine):
        self.rows, self.engine = [], engine
        inner = engine._gpt_generate

        def generate(conds, text_tokens, text_lengths, *a, **k):
            out = inner(conds, text_tokens, text_lengths, *a, **k)
            codes, lengths = out[0], out[1]
            for r in range(text_tokens.shape[0]):
                self._add(conds[min(r, conds.shape[0] - 1)], text_tokens[r, : int(text_lengths[r])],
                          codes[r, : int(lengths[r])])
            return out

        engine._gpt_generate = generate

    def _add(self, conds, tokens, codes):
        c = np.asarray(codes)
        hit = np.nonzero(c == self.engine.stop_mel_token)[0]
        self.rows.append((torch.as_tensor(conds).float().reshape(-1, G["model_dim"]),
                          torch.as_tensor(np.asarray(tokens, np.int64)), torch.as_tensor(c[: hit[0]] if hit.size else c)))

    def session(self, sess):
        inner = sess._harvest

        def harvest(snap):
            if snap is not None:
                seq, done, _ib, codes = snap
                for slot, row in enumerate(sess.slots):
                    if row is not None and row["admit_seq"] <= seq and done[slot]:
                        self._add(row["conds"], row["tokens"][0], codes[slot])
            return inner(snap)

        sess._harvest = harvest
        return sess

    def close(self):
        del self.engine._gpt_generate


def _held_to_the_reference(engine, setup, rows, n_rows):
    """Each greedy code the engine served is the reference's best at its
    step, within a float32 rounding gap: the reference's full pass over the
    row's conditioning latents, text and served codes (through int8-rounded
    K / V under quant_kv; code positions as the engine's path places them)."""
    W = {k: v.float() for k, v in engine.gpt.state_dict().items()}
    g = dict(G, max_text_tokens=120, max_mel_tokens=48)
    pos_off = 1 if engine.fast_latents else 2
    assert len(rows) == n_rows
    for conds, text, codes in rows:
        assert codes.shape[0] == GREEDY["max_mel_tokens"]
        logits, _ = setup.ref.forward(W, g, conds, text, codes, pos_off, engine.quant_kv)
        gap = logits.max(dim=-1).values - logits.gather(-1, codes[:, None])[:, 0]
        assert gap.max().item() <= TOL, (text.tolist(), gap.tolist())


def test_infer_batch_equals_per_request_infer(engine, setup):
    """infer_batch against infer, and both against the reference: every
    served code is the reference's greedy choice."""
    items = [(_prompt(0), "HI THERE."), (_prompt(1), "HELLO WORLD AGAIN.")]
    served = _Served(engine)
    try:
        solo = [engine.infer(mel, text, None, **GREEDY) for mel, text in items]
        _held_to_the_reference(engine, setup, served.rows, len(items))
        served.rows.clear()
        out = engine.infer_batch(items, **GREEDY)
        _held_to_the_reference(engine, setup, served.rows, len(items))
    finally:
        served.close()
    for (_, a), (_, b) in zip(solo, out):
        assert a.shape == b.shape and np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("serving", [False, True], ids=["bf16_path", "fast_latents_quant_kv"])
def test_a_slot_session_equals_infer(engine, setup, serving):
    """A slot session (two slots, three requests, one admitted into a freed
    slot) against infer, and every row it served against the reference."""
    engine.fast_latents = engine.quant_kv = serving
    served = _Served(engine)
    try:
        items = [(_prompt(2), "GOOD DAY."), (_prompt(3), "A LONGER SENTENCE HERE."), (_prompt(4), "SHORT.")]
        solo = [engine.infer(mel, text, None, **GREEDY) for mel, text in items]
        served.rows.clear()
        sess = served.session(engine.slot_session(n_slots=2, chunk_steps=3, **GREEDY))
        rids = [sess.submit(mel, text) for mel, text in items]
        done = dict(sess.drain())
        _held_to_the_reference(engine, setup, served.rows, len(items))
        for rid, (_, want) in zip(rids, solo):
            got = done[rid][1]
            assert got.shape == want.shape and np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
    finally:
        served.close()
        engine.fast_latents = engine.quant_kv = False


def test_the_latent_pass_is_the_references(engine, setup):
    """The engine's teacher-forced latent pass (fast_latents off: text and
    codes padded to their buckets, the keys masked) against the reference's
    latents at the teacher-forced positions."""
    W = {k: v.float() for k, v in engine.gpt.state_dict().items()}
    conds, text, codes = _inputs(11, n_text=13, n_codes=9)
    lat = engine._gpt_latent(conds[None], text[None].numpy(), codes[None].numpy(), np.array([9]))
    _, want = setup.ref.forward(W, dict(G, max_text_tokens=120, max_mel_tokens=48), conds, text, codes, 1)
    assert engine.gpt.hybrid and lat.shape[1] > 9  # the code bucket pads the codes
    _close(lat[0, :9], want)
