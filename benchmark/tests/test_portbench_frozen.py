"""The tiny cells" numbers equal those the harness gave before the model
moved out of its code into the architecture"s files (frozen from that
commit, in float64): the weights made from a seed (bit for bit), the plain
reference"s conditioning latents, logits and latents (float32 on the CPU,
whose sums move in their last bits with the thread count), and the model
FLOPs and K1 elements of each unit of work at the tiny and the published
widths."""

import hashlib
import json
import os

import pytest
import torch

import tiny
from counts import flops as F
from portbench import setup as S
from portbench.cell import load_module
from reference import text as RT

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = load_module(os.path.join(BENCH, "reference", "models", "unifiedvoice-gpt2.py"))
M = load_module(os.path.join(BENCH, "counts", "models", "unifiedvoice-gpt2.py"))
SEED = 2**31 + 101

WEIGHTS = {"gpt": "04847a1506ebab5cdbc36b3a182aae06c76a2a6d7131f5779baa352755facf8d",
           "vocoder": "d01325f8199f34352d76dc9b726d6e1b5415e5159d21755ae84caec88d7ac4d0"}
# [sum, sum of |x|, sum of x * sin(0.37 k + 1)] of each tensor, float64
CONDS = [94.47159000992542, 825.7349811322638, -4.15656510194689]
PASSES = {  # (pos_off, quant_kv): (logits, latents)
    (2, False): ([-821.8326703309431, 1818.02787956252, 8.448820526622006],
                 [-20.203047740491456, 2158.3259559797734, 17.124132120398887]),
    (1, False): ([-811.7349850722239, 1825.7305461660144, -2.256784034460555],
                 [-20.60149905330036, 2149.207597776549, 13.582044170534779]),
    (1, True): ([-811.8544875852531, 1825.725599771482, -2.2479768917413168],
                [-20.598023149796063, 2149.1794539333496, 13.599895848682472]),
}
COUNTS = {"tiny": {"gpt_token": [853504.0, 787456.0, 931328.0, 865280.0, 1159680.0, 1093632.0],
          "prefill": [32342528.0, 104543232.0, 316470272.0],
          "decode_steps": [894464.0, 22668800.0, 199270400.0, 901632.0, 22848000.0, 200704000.0, 987648.0,
                           24998400.0, 217907200.0, 994816.0, 25177600.0, 219340800.0],
          "latent_pass": [40601600.0, 318657024.0],
          "conditioning": [45979264.0, 92360064.0, 196641664.0, 601646464.0],
          "vocoder": [1347072.0, 21553152.0, 134707200.0, 312520704.0],
          "k1_elements": [151552, 303104, 947200, 454656, 909312, 2841600, 1212416, 2424832, 7577600],
          "k1_launches": 37},
 "published": {"gpt_token": [964817920.0, 943841280.0, 974156800.0, 953180160.0, 1001559040.0, 980582400.0],
               "prefill": [37868016640.0, 117027865600.0, 319123194880.0],
               "decode_steps": [969733120.0, 24280192000.0, 196391936000.0, 970593280.0, 24301696000.0,
                                196563968000.0, 980915200.0, 24559744000.0, 198628352000.0, 981775360.0,
                                24581248000.0, 198800384000.0],
               "latent_pass": [47339520000.0, 321071247360.0],
               "conditioning": [5301785600.0, 9600691200.0, 18474982400.0, 47309696000.0],
               "vocoder": [7318093824.0, 117089501184.0, 731809382400.0, 1697797767168.0],
               "k1_elements": [39321600, 78643200, 245760000, 117964800, 235929600, 737280000, 314572800,
                               629145600, 1966080000],
               "k1_launches": 109}}


def _digest(ts):
    h = hashlib.sha256()
    for k in sorted(ts):
        t = ts[k].detach().contiguous().cpu()
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _stats(t):
    x = t.detach().double().reshape(-1)
    w = torch.sin(torch.arange(x.numel(), dtype=torch.float64) * 0.37 + 1.0)
    return [float(x.sum()), float(x.abs().sum()), float((x * w).sum())]


@pytest.fixture(scope="module")
def weights():
    cfg = {"gpt": tiny.GPT, "bigvgan": tiny.VOC, "engine": {"dtype": "float32"}}
    return S.weights(ARCH, cfg, SEED, "cpu")


def test_weights_are_bit_identical(weights):
    wg, wv = weights
    assert _digest(wg) == WEIGHTS["gpt"] and _digest(wv) == WEIGHTS["vocoder"]


@torch.no_grad()
def test_reference_logits_and_latents(weights):
    wg, _wv = weights
    g = tiny.GPT
    mel = torch.zeros(200, 100)
    mel[:137] = torch.randn(137, 100, generator=torch.Generator().manual_seed(3)) * 2 - 5
    conds = ARCH.conditioning(wg, g, mel, 137)
    assert _stats(conds) == pytest.approx(CONDS, rel=1e-6, abs=1e-3)
    text = torch.tensor(RT.tokenize("ABC DEF GHIJK LMNOP."))
    codes = torch.randint(0, 256, (21,), generator=torch.Generator().manual_seed(2))
    for (pos_off, quant), (logits, latents) in PASSES.items():
        lg, lat = ARCH.forward(wg, g, conds, text, codes, pos_off, quant)
        assert _stats(lg) == pytest.approx(logits, rel=1e-6, abs=1e-3), (pos_off, quant)
        assert _stats(lat) == pytest.approx(latents, rel=1e-6, abs=1e-3), (pos_off, quant)


@pytest.mark.parametrize("widths", ["tiny", "published"])
def test_flops_and_k1_elements(widths):
    if widths == "tiny":
        g, h = tiny.GPT, tiny.VOC
    else:
        with open(os.path.join(BENCH, "configs", "indextts-1.5.json")) as f:
            cfg = json.load(f)
        g, h = cfg["gpt"], cfg["bigvgan"]
    got = {
        "gpt_token": [M.gpt_token(g, c, hd) for c in (1, 77, 300) for hd in (True, False)],
        "prefill": [M.prefill(g, p) for p in (40, 123, 331)],
        "decode_steps": [M.decode_steps(g, p, f, n) for p in (40, 131) for f in (0, 7) for n in (1, 25, 200)],
        "latent_pass": [M.latent_pass(g, t) for t in (50, 333)],
        "conditioning": [M.conditioning(g, fr) for fr in (100, 200, 400, 1000)],
        "vocoder": [F.vocoder(h, n) for n in (1, 16, 100, 232)],
        "k1_elements": [F.k1_elements(h, r, n) for r in (1, 3, 8) for n in (16, 32, 100)],
        "k1_launches": F.k1_launches(h),
    }
    assert got == COUNTS[widths]
