"""The frozen counts, pinned to the port's PERF.md section 6 at the same
shapes: K1's bound per ~100-code vocoder call and the resblock convolutions
of stages 1-3, at IndexTTS-1.5's published widths."""

import json
import os

import pytest

from counts import flops as F

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg():
    with open(os.path.join(BENCH, "configs", "indextts-1.5.json")) as f:
        return json.load(f)


def test_k1_bound_per_100_code_call():
    h = cfg()["bigvgan"]
    assert F.k1_launches(h) == 109
    assert 1e3 * F.k1_bound_s(F.k1_elements(h, 1, 100)) == pytest.approx(0.308, abs=5e-4)
    # operations bound it: 84 float32 operations an element against 4 bytes
    el = F.k1_elements(h, 1, 100)
    assert el * F.ACT_OPS / F.PEAK_F32 > el * F.ACT_BYTES / F.PEAK_BYTES


def test_resblock_convolutions_of_stages_1_to_3():
    assert F.resblock_convs(cfg()["bigvgan"], 100, stages={0, 1, 2}) / 1e9 == pytest.approx(594, abs=1)


def test_model_flops_scale_with_the_work():
    c = cfg()
    g, h = c["gpt"], c["bigvgan"]
    step = F.gpt_token(g, 300, True)
    assert F.decode_steps(g, 299, 0, 1) == pytest.approx(step)
    assert F.decode_steps(g, 100, 0, 20) == pytest.approx(F.decode_steps(g, 100, 0, 10) + F.decode_steps(g, 100, 10, 10))
    assert 0.15e12 < F.vocoder(h, 24000 / 1024) < 0.2e12  # ~0.16 TFLOP a second of audio
    assert F.prefill(g, 200) > F.latent_pass(g, 200) > 0 and F.conditioning(g, 400) > 0
