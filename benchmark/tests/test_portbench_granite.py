"""The `unifiedvoice-granite-hybrid` architecture in the harness: it is
found by its files alone, a tiny copy of its cell runs correct on the CPU
and reads incorrect when the reference's Mamba decay rates A are scaled by
1.5, and its frozen counts of K7 and K6 equal a hand count."""

import json
import math
import os

import pytest

import run
import tiny
from portbench.cell import Cell, load_module

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARCH = "unifiedvoice-granite-hybrid"
SEED = 2**31 + 211

# the tiny hybrid: 3 Mamba layers and 1 attention layer, heads of 16 x 16, chunks of 8
GPT = dict(tiny.GPT, layers=4, kv_heads=2, block="granite_hybrid", layer_types=["mamba", "mamba", "attention", "mamba"],
           intermediate_size=192, mamba_heads=16, mamba_head_dim=16, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
           mamba_n_groups=1, mamba_chunk_size=8, rms_norm_eps=1e-5, embedding_multiplier=12.0,
           residual_multiplier=0.22, attention_multiplier=0.015625, logits_scaling=8.0)

# the tiny cell's limits: the float32 program on the CPU reads 0.0 on both (its int16 audio
# and greedy codes are the reference's), the reference with A scaled by 1.5 a wav_rel_err of
# ~4e-4 (the random weights' Mamba layers move a small share of the tiny residual stream)
LIMITS = dict(tiny.LIMITS, logit_gap=1e-4, wav_rel_err=1e-4)

A_SCALED = """

_mamba = mamba


def mamba(W, g, p, x, act=_same):
    W = dict(W)
    W[f"{p}.A_log"] = W[f"{p}.A_log"] + math.log(1.5)  # A = -exp(A_log) times 1.5
    return _mamba(W, g, p, x, act)
"""


def _published():
    with open(os.path.join(BENCH, "configs", "indextts-granite-4.0-h-micro-serve.json")) as f:
        return json.load(f)


def test_the_architecture_comes_by_its_files():
    cell = Cell(ROOT, "slots-granite")
    assert cell.config["architecture"] == ARCH
    assert cell.reference.__file__.endswith(os.path.join("reference", "models", ARCH + ".py"))
    assert cell.counts.__file__.endswith(os.path.join("counts", "models", ARCH + ".py"))
    # the reference's tensors are the program's, name for name and shape for shape
    import torch

    from indextts_tpu_torch.config import GPTConfig
    from indextts_tpu_torch.models.gpt import UnifiedVoice

    with torch.device("meta"):
        model = UnifiedVoice(GPTConfig.from_dict(cell.config["gpt"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: tuple(shape) for name, shape, _kind, _std in cell.reference.weight_spec(cell.config["gpt"])}
    assert got == want
    # every published width and all 40 layers; the vocabulary alone reduced
    g = cell.config["gpt"]
    assert (g["layers"], g["model_dim"], g["heads"], g["kv_heads"], g["intermediate_size"]) == (40, 2048, 32, 8, 8192)
    assert (g["mamba_heads"], g["mamba_head_dim"], g["mamba_d_state"], g["mamba_d_conv"]) == (64, 64, 128, 4)
    assert [i for i, t in enumerate(g["layer_types"]) if t == "attention"] == [5, 15, 25, 35]
    assert cell.config["reduced"] == ["vocab_size"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(str(tmp_path_factory.mktemp("bench")))
    path = os.path.join(root, "benchmark", "configs", "indextts-granite-4.0-h-micro-serve.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["gpt"] = GPT
    with open(path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "limits", "slots-granite.json"), "w") as f:
        json.dump(LIMITS, f)
    return root


@pytest.mark.parametrize("scaled", [False, True], ids=["copy", "A_x1.5"])
def test_a_tiny_granite_cell(root, tmp_path, scaled):
    bench = os.path.join(root, "benchmark")
    if scaled:  # a copy of the harness whose reference scales A by 1.5
        import shutil

        bench = os.path.join(str(tmp_path), "benchmark")
        shutil.copytree(os.path.join(root, "benchmark"), bench)
        with open(os.path.join(bench, "reference", "models", ARCH + ".py"), "a") as f:
            f.write(A_SCALED)
    cell = Cell(root, "slots-granite", bench)
    out = run.run_cell("slots-granite", SEED, 1.5, False, root=root, device="cpu", cell=cell)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "latency_p50_s" in out["metrics"] and "setup_s" in out["metrics"]
    assert out["checks"]["rows_missing"]["value"] == 0 and out["checks"]["len_mismatch"]["value"] == 0
    if scaled:
        assert not out["correct"], out["checks"]
    else:
        assert out["correct"], out["checks"]


def test_k7_bytes_are_a_hand_count():
    # one row, one step, at the published widths in bf16: per Mamba layer the
    # float32 state read and written (64 heads x 64 x 128 x 4 bytes, twice),
    # the bf16 conv state read and written (4352 channels x 3, twice), the
    # token's z, x, B, C and dt (4096 + 4352 + 64 bf16) and the float32 gated
    # output (4096); 36 layers
    cfg = _published()
    counts = load_module(os.path.join(BENCH, "counts", "models", ARCH + ".py"))
    per_layer = 4_194_304 + 52_224 + 17_024 + 16_384
    assert counts.k7(cfg, p=200, first=0, steps=1)["bytes"] == 36 * per_layer
    assert counts.k7(cfg, p=200, first=7, steps=25)["bytes"] == 25 * 36 * per_layer
    # K6 at the same step: 4 layers, 8 KV heads read once over the 200 cached
    # int8 columns (64 + 64 bytes and two float32 scale shares), the bias over
    # 201 columns, q and the output of 32 heads and the new k, v of 8 (bf16),
    # and the written int8 column of 8 heads
    k6 = counts.k6(cfg, p=200, first=0, steps=1)["bytes"]
    assert k6 == 4 * (200 * 8 * (128 + 4) + 201 * 4 + (2 * 32 + 2 * 8) * 64 * 2 + 8 * 2 * 64)
    bound_us = 1e6 * 32 * per_layer / 3.35e12
    assert bound_us == pytest.approx(40.9, abs=0.05)  # K7's least time a layer at 32 slots


def test_model_flops_count_the_published_stack():
    g = _published()["gpt"]
    counts = load_module(os.path.join(BENCH, "counts", "models", ARCH + ".py"))
    dense = counts.token_dense(g)
    # 36 Mamba layers of 76.2 M parameters and 4 attention layers of 60.8 M,
    # two FLOPs a parameter a token, plus the SSM (4 x 64 x 64 x 128 a layer)
    params = 36 * (2048 * 8512 + 4352 * 4 + 4096 * 2048 + 3 * 2048 * 8192) + 4 * (2048 * 3072 + 2048 * 2048
                                                                                 + 3 * 2048 * 8192)
    assert math.isclose(dense, 2 * params + 36 * 4 * 64 * 64 * 128, rel_tol=1e-12)
    assert math.isclose(counts.decode_steps(g, 200, 0, 1), dense + 2 * 2048 * 8194 + 4 * 4 * 32 * 64 * 201)
