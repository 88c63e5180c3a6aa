"""The frozen counts, pinned to the port's PERF.md section 6 at the same
shapes: K1's bound per ~100-code vocoder call and the resblock convolutions
of stages 1-3, at IndexTTS-1.5's published widths; the architecture's model
FLOPs, and K6's bytes as chip_smoke.py's k6 phase counts them."""

import json
import os

import pytest

from counts import flops as F
from portbench.cell import load_module

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = load_module(os.path.join(BENCH, "counts", "models", "unifiedvoice-gpt2.py"))


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
    step = M.gpt_token(g, 300, True)
    assert M.decode_steps(g, 299, 0, 1) == pytest.approx(step)
    assert M.decode_steps(g, 100, 0, 20) == pytest.approx(M.decode_steps(g, 100, 0, 10) + M.decode_steps(g, 100, 10, 10))
    assert 0.15e12 < F.vocoder(h, 24000 / 1024) < 0.2e12  # ~0.16 TFLOP a second of audio
    assert M.prefill(g, 200) > M.latent_pass(g, 200) > 0 and M.conditioning(g, 400) > 0


def _chip_smoke_k6_bytes(b, h, dh, cols_read, s_len, int8):
    """chip_smoke.py's k6 phase count of K6's bytes for one layer's launch."""
    per_col = 2 * dh * (1 if int8 else 2) + (4 if int8 else 0)
    return cols_read * h * per_col + b * s_len * 4 + 4 * b * h * dh * 2 + b * h * 2 * dh * (1 if int8 else 2)


@pytest.mark.parametrize("rows,mb", [(8, 9.60), (3, 3.60)])
@pytest.mark.parametrize("int8", [False, True])
def test_k6_bytes_are_the_k6_phase_count(rows, mb, int8):
    # one step of `rows` rows with 231 valid cached columns each (PERF.md's K6
    # row: 9.60 / 3.60 MB a layer on the bf16 cache); the bias is counted over
    # the columns up to the new one, as a cache of S = 232 would hold it
    c = cfg()
    c["engine"] = dict(c["engine"], quant_kv=int8)
    g = c["gpt"]
    assert set(M.kernels(c, "decode_steps", p=231, first=0, steps=1)) == {M.K6_KERNEL}
    assert M.kernels(c, "prefill", p=231) == {} and M.kernels(c, "latent_pass", t=300) == {}
    layer = {k: v / g["layers"] for k, v in M.k6(c, p=231, first=0, steps=1).items()}
    h, dh = g["heads"], g["model_dim"] // g["heads"]
    assert rows * layer["bytes"] == _chip_smoke_k6_bytes(rows, h, dh, rows * 231, 232, int8)
    if not int8:
        assert rows * layer["bytes"] / 1e6 == pytest.approx(mb, abs=0.01)
    # the bytes bound it; over steps, the columns grow one a step
    assert F.bound_s(**M.k6(c, 231, 0, 1)) == M.k6(c, 231, 0, 1)["bytes"] / F.PEAK_BYTES
    two = M.k6(c, 231, 0, 2)
    assert two["bytes"] == pytest.approx(M.k6(c, 231, 0, 1)["bytes"] + M.k6(c, 231, 1, 1)["bytes"])
