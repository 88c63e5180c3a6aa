"""The plain reference against a tiny port on the CPU, in float32: the
conditioning encoder, the GPT's prefill and decode through the cache (greedy
and 3 sampled beams, both positions, the int8 KV cache), the teacher-forced
latents, and the vocoder with its speaker encoder."""

import os

import numpy as np
import pytest
import torch

from indextts_tpu_torch.config import IndexTTSConfig
from indextts_tpu_torch.models.bigvgan import BigVGAN, bigvgan_apply
from indextts_tpu_torch.models.gpt import UnifiedVoice, get_conditioning, unified_voice_forward
from indextts_tpu_torch.models.gpt_decode import GenerationConfig, generate_speech, generate_speech_beam
from portbench.cell import BENCH_DIR, load_module
from reference import gpt as RG
from reference import text as RT
from reference import vocoder as RV
from reference import weights as RW
from tiny import GPT, VOC

# the plain reference of the architecture the configurations name
ARCH = load_module(os.path.join(BENCH_DIR, "reference", "models", "unifiedvoice-gpt2.py"))


@pytest.fixture(scope="module")
def models():
    cfg = IndexTTSConfig.from_dict({"gpt": GPT, "bigvgan": VOC})
    wg, wv = RW.make_model(ARCH, GPT, 5, "cpu", torch.float32), RW.make_vocoder(VOC, 5, "cpu", torch.float32)
    m, v = UnifiedVoice(cfg.gpt), BigVGAN(cfg.bigvgan)
    m.load_state_dict(wg, strict=True)
    v.load_state_dict(wv, strict=True)
    return cfg, m.eval(), v.eval(), wg, wv


def _prompt(frames=137, fb=200):
    g = torch.Generator().manual_seed(3)
    mel = torch.zeros(fb, 100)
    mel[:frames] = torch.randn(frames, 100, generator=g) * 2 - 5
    return mel, frames


@torch.no_grad()
def test_conditioning(models):
    cfg, m, _v, wg, _wv = models
    mel, frames = _prompt()
    port = get_conditioning(m, cfg.gpt, mel[None], torch.tensor([frames]))[0]
    assert (port - ARCH.conditioning(wg, GPT, mel, frames)).abs().max() < 1e-4


@pytest.mark.parametrize("pos_off,quant", [(2, False), (1, False), (1, True)])
@torch.no_grad()
def test_greedy_decode_through_the_cache(models, pos_off, quant):
    cfg, m, _v, wg, _wv = models
    mel, frames = _prompt()
    conds = ARCH.conditioning(wg, GPT, mel, frames)
    text = torch.tensor(RT.tokenize("ABC DEF GHIJK LMNOP."))
    padded = torch.full((1, 24), GPT["stop_text_token"])
    padded[0, : len(text)] = text
    gen = GenerationConfig(do_sample=False, num_beams=1, top_k=0, max_new_tokens=40)
    codes, _lens, lat = generate_speech(m, cfg.gpt, gen, conds[None], padded, torch.tensor([len(text)]),
                                        torch.Generator(), repetition_penalty=10.0, pos_off=pos_off,
                                        capture_latents=True, quant_kv=quant)
    logits, ref_lat = ARCH.forward(wg, GPT, conds, text, codes[0], pos_off, quant_kv=quant)
    knobs = dict(repetition_penalty=10.0, temperature=1.0, do_sample=False, top_k=0, top_p=1.0)
    assert RG.support_gap(logits, codes[0], GPT, knobs, False).max() < 1e-4
    if pos_off == 1:
        assert (lat[0] - ref_lat).abs().max() < 1e-4
    if quant:  # the int8 cache's rounding is in the reference: without it the logits move
        plain, _ = ARCH.forward(wg, GPT, conds, text, codes[0], pos_off, quant_kv=False)
        assert (plain - logits).abs().max() > 10 * (logits - ARCH.forward(wg, GPT, conds, text, codes[0], pos_off,
                                                                          quant_kv=True)[0]).abs().max()


@torch.no_grad()
def test_sampled_beams_stay_inside_the_support(models):
    cfg, m, _v, wg, _wv = models
    mel, frames = _prompt()
    conds = ARCH.conditioning(wg, GPT, mel, frames)
    text = torch.tensor(RT.tokenize("QRS TUVW XYZ."))
    padded = torch.full((1, 16), GPT["stop_text_token"])
    padded[0, : len(text)] = text
    gen = GenerationConfig(do_sample=True, num_beams=3, top_k=30, max_new_tokens=30)
    out = generate_speech_beam(m, cfg.gpt, gen, conds[None], padded, torch.tensor([len(text)]),
                               torch.Generator().manual_seed(1), top_p=0.8, repetition_penalty=10.0)
    codes = out[0][0, : int(out[1][0])]
    codes = codes[codes != GPT["stop_mel_token"]]
    logits, _ = ARCH.forward(wg, GPT, conds, text, codes, 2)
    knobs = dict(repetition_penalty=10.0, temperature=1.0, do_sample=True, top_k=30, top_p=0.8)
    assert RG.support_gap(logits, codes, GPT, knobs, True).max() < 1e-4
    # and a code outside the support reads a gap
    bad = codes.clone()
    bad[5] = int(RG.step_scores(logits, codes, GPT, 10.0, True)[5].argmin())
    assert RG.support_gap(logits, bad, GPT, knobs, True)[5] > 1.0


@torch.no_grad()
def test_teacher_forced_latents(models):
    cfg, m, _v, wg, _wv = models
    mel, frames = _prompt()
    conds = ARCH.conditioning(wg, GPT, mel, frames)
    text = torch.tensor(RT.tokenize("HELLO THERE."))
    codes = torch.randint(0, 256, (21,), generator=torch.Generator().manual_seed(2))
    padded = torch.full((1, 16), 1)
    padded[0, : len(text)] = text
    port = unified_voice_forward(m, cfg.gpt, None, text_inputs=padded, text_lengths=torch.tensor([len(text)]),
                                 mel_codes=torch.cat([codes, torch.full((11,), 257)])[None],
                                 wav_lengths=torch.tensor([21 * 1024]), cond_mel_lengths=None, conds=conds[None],
                                 mask_pad_keys=True)[0, :21]
    assert (port - ARCH.forward(wg, GPT, conds, text, codes, 1)[1]).abs().max() < 1e-4


@torch.no_grad()
def test_vocoder(models):
    cfg, _m, v, _wg, wv = models
    mel, frames = _prompt(113, 200)
    lat = torch.randn(32, 128, generator=torch.Generator().manual_seed(4)) * 0.5
    lat[20:] = 0
    rel = np.float32(frames / 200)
    port = bigvgan_apply(v, cfg.bigvgan, lat[None], mel[None], lens=torch.tensor([rel]), use_cuda_kernel=False)[0, :, 0]
    ref = RV.bigvgan(wv, VOC, lat, RV.ecapa(wv, mel, float(rel)))
    assert (port - ref).abs().max() < 1e-5 * max(1.0, float(ref.abs().max()))
