"""K8 (ops/cuda/gpt2_chains.py, csrc/gpt2_chains.cu): the GPT-2 block's
residual adds and LayerNorms, and its gelu_new beside them.

On the CPU the wrappers take their plain versions, which must be the
composition the block ran before K8 bit for bit (the add in the working
dtype, ops/norms.layer_norm, ops/activations.gelu_new), and the block, which
now hands its MLP output on to the next LayerNorm instead of adding it
itself, must give the hidden states, caches and logits of the earlier block,
kept below. The decode loops' spans carry `k8_launches`, and the benchmark's
reader kernels.k8_per_step reads them.

The kernel itself, and gelu_new's library call, are held, on an NVIDIA GPU
(tests marked `cuda`), against float64 beside the plain path, and the kernel
through the captured decode, int8, beam and slot loops. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gpt2_chains.py
"""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from indextts_tpu_torch import tracing
from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
from indextts_tpu_torch.models import gpt as tgpt
from indextts_tpu_torch.models import gpt_decode as tdec
from indextts_tpu_torch.models import gpt_slots as tslots
from indextts_tpu_torch.ops import activations, norms
from indextts_tpu_torch.ops.cuda import decode_attn as k6
from indextts_tpu_torch.ops.cuda import gpt2_chains as k8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(layers=2, heads=4, dh=16, device="cpu", dtype=torch.float32, stop_bias=-1e4):
    """A tiny UnifiedVoice, random weights from a fixed seed, the stop code's
    logit lowered so that every loop runs its whole budget."""
    cfg = GPTConfig(layers=layers, model_dim=heads * dh, heads=heads, max_text_tokens=60, max_mel_tokens=48,
                    number_text_tokens=50, number_mel_codes=66, start_mel_token=64, stop_mel_token=65,
                    condition_num_latent=8,
                    condition_module=ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4,
                                                           num_blocks=1, input_layer="conv2d2", perceiver_mult=2))
    model = tgpt.UnifiedVoice(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in model.gpt.blocks:  # LayerNorms and biases away from their identity init
            for p in (blk.ln_1.weight, blk.ln_1.bias, blk.ln_2.weight, blk.ln_2.bias, blk.attn_proj.bias,
                      blk.mlp_proj.bias):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        model.mel_head.bias[cfg.stop_mel_token] = stop_bias
    return cfg, model.to(device, dtype).eval()


# ---------------------------------------------------------------------------
# the block as it was before K8 (residual adds in the block, plain chains)
# ---------------------------------------------------------------------------


def _ln(m, x):
    return norms.layer_norm(x, m.weight, m.bias)


def _old_qkv(block, x, heads):
    y = block.attn_qkv(_ln(block.ln_1, x))
    dl, dh = y.shape[-1] // 3, x.shape[-1] // heads
    return (t.reshape(*t.shape[:-1], dl // dh, dh) for t in y.split(dl, dim=-1))


def _old_proj(block, x, a):
    x = x + block.attn_proj(a)
    return x + block.mlp_proj(activations.gelu_new(block.mlp_fc(_ln(block.ln_2, x))))


def _old_gpt2_apply(gpt, emb, heads, mask):
    t = emb.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool))
    zero = torch.zeros(())
    bias = torch.where(causal, zero, tgpt.NEG)[None, None] + torch.where(mask, zero, tgpt.NEG)[:, None, None, :]
    x, ks, vs = emb, [], []
    for block in gpt.blocks:
        b = x.shape[0]
        q, k, v = (y.transpose(1, 2) for y in _old_qkv(block, x, heads))
        a = tgpt._attn(q, k, v, bias).transpose(1, 2).reshape(b, t, -1)
        x = _old_proj(block, x, a)
        ks.append(k)
        vs.append(v)
    return _ln(gpt.ln_f, x), (torch.stack(ks), torch.stack(vs))


def _old_decode_step(model, cfg, token, mel_pos, cache, pos, valid):
    x = model.mel_embedding[token] + model.mel_pos_embedding[mel_pos]
    bias = torch.where(valid, torch.zeros(()), tgpt.NEG)[:, None, :]
    for layer, block in enumerate(model.gpt.blocks):
        q, k, v = _old_qkv(block, x, cfg.heads)
        x = _old_proj(block, x, k6.decode_attn_plain(q, k, v, [c[layer] for c in cache], pos, bias))
    return tdec._mel_logits(model, _ln(model.gpt.ln_f, x), return_normed=True)


# ---------------------------------------------------------------------------
# CPU: the plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_d", [False, True])
@pytest.mark.parametrize("shape", [(1, 16), (3, 64), (2, 5, 1280)])
def test_plain_route_is_the_earlier_composition(dtype, with_d, shape):
    """On the CPU add_layer_norm is the add in the working dtype, then
    ops/norms.layer_norm, and gelu_new is ops/activations.gelu_new, bit for
    bit; nothing launches."""
    g = torch.Generator().manual_seed(len(shape) * 7 + shape[-1])
    x = torch.randn(shape, generator=g).to(dtype)
    d = torch.randn(shape, generator=g).to(dtype) if with_d else None
    gamma, beta = (torch.randn(shape[-1], generator=g).to(dtype) for _ in range(2))
    before = k8.launches
    x_new, y = k8.add_layer_norm(x, d, gamma, beta)
    want_x = x if d is None else x + d
    assert x_new.dtype == dtype and torch.equal(x_new, want_x)
    assert torch.equal(y, norms.layer_norm(want_x, gamma, beta))
    h = torch.randn(*shape[:-1], 4 * shape[-1], generator=g).to(dtype)
    assert torch.equal(k8.gelu_new(h), activations.gelu_new(h))
    assert k8.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_sequence_pass_equals_the_earlier_block(dtype):
    """gpt2_apply, which carries each block's MLP output into the next
    block's ln_1 (the last into ln_f), against the earlier blocks that added
    it themselves: the hidden states and the K / V of every layer, bit for
    bit, with padded keys masked."""
    cfg, model = _tiny(layers=3, dtype=dtype)
    g = torch.Generator().manual_seed(1)
    emb = torch.randn(2, 11, cfg.model_dim, generator=g).to(dtype)
    mask = torch.ones(2, 11, dtype=torch.bool)
    mask[1, :3] = False
    with torch.no_grad():
        got, (gk, gv) = tgpt.gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask, return_kv=True)
        want, (wk, wv) = _old_gpt2_apply(model.gpt, emb, cfg.heads, mask)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_equals_the_earlier_block(dtype, quant):
    """_decode_step through the streamed blocks against the earlier blocks,
    on the bf16 / float32 cache and the int8 one: logits, the final-norm
    hidden and every cache byte after the step's write, bit for bit."""
    cfg, model = _tiny(dtype=dtype)
    g = torch.Generator().manual_seed(2)
    b, s_len, pos = 3, 20, 13
    dh = cfg.model_dim // cfg.heads
    cache = [torch.randn(cfg.layers, b, cfg.heads, s_len, dh, generator=g).to(dtype) for _ in range(2)]
    if quant:
        (k8c, ks), (v8c, vs) = k6.quant_cols(cache[0]), k6.quant_cols(cache[1])
        cache = [k8c, ks, v8c, vs]
    cols = torch.arange(s_len)[None, :]
    valid = torch.cat([cols < pos, (cols >= 4) & (cols < pos), torch.zeros(1, s_len, dtype=torch.bool)])
    token = torch.tensor([5, 17, 30])
    mine, old = tuple(c.clone() for c in cache), [c.clone() for c in cache]
    with torch.no_grad():
        got = tdec._decode_step(model, cfg, token, 4, mine, pos, valid, return_hidden=True)
        want = _old_decode_step(model, cfg, token, 4, old, pos, valid)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    for c, w in zip(mine, old):
        assert torch.equal(c, w)


def test_wrappers_raise_off_the_cpu_and_the_card():
    """A tensor on neither the CPU nor a CUDA device raises; nothing launches."""
    x = torch.empty(2, 64, device="meta")
    gamma = torch.empty(64, device="meta")
    before = k8.launches
    with pytest.raises(ValueError, match="unsupported device"):
        k8.add_layer_norm(x, x, gamma, gamma)
    with pytest.raises(ValueError, match="unsupported device"):
        k8.add_layer_norm(x, None, gamma, gamma)
    with pytest.raises(ValueError, match="unsupported device"):
        k8.gelu_new(x)
    assert k8.launches == before


def _counting(monkeypatch):
    """On the CPU nothing launches: count the block's calls of K8's
    add_layer_norm as launches, so the loops' spans show what the card runs."""
    def counted(fn):
        def call(*a, **kw):
            k8.launches += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tgpt, "add_layer_norm", counted(k8.add_layer_norm))


@pytest.mark.parametrize("loop", ["decode", "decode_int8", "beam", "slot"])
def test_loop_spans_carry_k8_launches(monkeypatch, loop):
    """Under a profiler each dec.loop / slot.loop span carries k8_launches:
    2 x layers + 1 launches for every step its blocks ran (49 at 24 layers),
    none for the prefill before it."""
    _counting(monkeypatch)
    cfg, model = _tiny()
    g = torch.Generator().manual_seed(3)
    b = 3
    conds = 0.1 * torch.randn(b, 8, cfg.model_dim, generator=g)
    text = torch.randint(2, 50, (b, 12), generator=g)
    lens = torch.tensor([12, 9, 5])
    tracing.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        if loop in ("decode", "decode_int8"):
            gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=20)
            tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator(), quant_kv=loop == "decode_int8")
        elif loop == "beam":
            gen = tdec.GenerationConfig(do_sample=False, num_beams=3, max_new_tokens=20, early_stopping=False)
            tdec.generate_speech_beam(model, cfg, gen, conds[:1], text[:1], lens[:1], torch.Generator())
        else:
            gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=20)
            st = tslots.slot_state_init(cfg, gen, 4, 64, torch.float32, quant_kv=True)
            for slot in range(b):
                prod = tslots.slot_prefill(model, cfg, gen, conds[slot : slot + 1], text[slot : slot + 1],
                                           lens[slot : slot + 1], torch.Generator(), quant_kv=True)
                tslots.slot_admit(st, prod, slot, cfg)
            tslots.slot_steps(model, cfg, gen, st, 25, torch.Generator())
    recs = tracing.spans()
    loops = [s for s in recs if s.name.endswith(".loop")]
    assert loops and all("k8_launches" in s.attrs for s in loops)
    for s in loops:
        steps = sum(int(c.attrs["ran"]) for c in recs if c.parent == s.id and c.name.endswith(".block"))
        assert steps > 0 and s.attrs["k8_launches"] == (2 * cfg.layers + 1) * steps, (s, steps)


def _k8_reader():
    bench = os.path.join(REPO, "benchmark")
    if bench not in sys.path:
        sys.path.append(bench)
    from portbench.cell import load_module

    return load_module(os.path.join(REPO, "benchmark", "metrics", "kernels.k8_per_step.py"))


def test_k8_per_step_reads_the_loop_spans(monkeypatch):
    """kernels.k8_per_step: Σ k8_launches of the window's loops over Σ ran of
    their replayed blocks; a loop with a warm block, and spans outside the
    window, are left out; nothing without a trace or without the count (a
    program before K8)."""
    reader = _k8_reader()
    from portbench import spans as pspans

    S = tracing.Span
    ms = 1_000_000
    recs = [
        S(1, 0, "dec.loop", 10 * ms, 90 * ms, {"k7_launches": 0, "k8_launches": 49 * 20}),
        S(2, 1, "dec.block", 11 * ms, 40 * ms, {"event": "replay", "ran": 16}),
        S(3, 1, "dec.block", 41 * ms, 80 * ms, {"event": "replay", "ran": 4}),
        S(4, 0, "dec.loop", 100 * ms, 190 * ms, {"k7_launches": 0, "k8_launches": 49 * 30}),  # a warm block
        S(5, 4, "dec.block", 101 * ms, 140 * ms, {"event": "warm", "ran": 16}),
        S(6, 4, "dec.block", 141 * ms, 180 * ms, {"event": "replay", "ran": 14}),
        S(7, 0, "dec.loop", 200 * ms, 290 * ms, {"k7_launches": 0, "k8_launches": 49 * 7}),
        S(8, 7, "dec.block", 201 * ms, 280 * ms, {"event": "replay", "ran": 7}),
        S(9, 0, "dec.loop", 900 * ms, 990 * ms, {"k7_launches": 0, "k8_launches": 5}),  # outside the window
        S(10, 9, "dec.block", 901 * ms, 980 * ms, {"event": "replay", "ran": 16}),
    ]
    monkeypatch.setattr(pspans, "program_spans", lambda: recs)
    obs = {"trace": {"start": 0.005, "stop": 0.5}}
    assert reader.read(obs) == 49.0
    assert reader.read({}) is None
    before_k8 = [S(r.id, r.parent, r.name, r.t0, r.t1, {k: v for k, v in r.attrs.items() if k != "k8_launches"})
                 for r in recs]
    monkeypatch.setattr(pspans, "program_spans", lambda: before_k8)
    assert reader.read(obs) is None
    plain = [S(r.id, r.parent, r.name, r.t0, r.t1, {**r.attrs, "k8_launches": 0} if r.name == "dec.loop" else r.attrs)
             for r in recs]
    monkeypatch.setattr(pspans, "program_spans", lambda: plain)
    assert reader.read(obs) == 0.0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# (rows, D): a decode step's rows (1 row, 3 beams, 8 batch rows, 32 slots) at
# IndexTTS-1.5's width, prefill rows (B x T up to 8 x 700), the tiny card-test
# models' widths, and rows wider than the register path holds (float32 8192,
# bf16 16384: the loop over device memory)
LN_SHAPES = ([(r, 1280) for r in (1, 3, 8, 32)] + [(4 * 301, 1280), (8 * 700, 1280)]
             + [(5, 16), (7, 64), (9, 256), (3, 520), (4, 16384)])
GELU_ROWS = (1, 3, 8, 32, 8 * 700)


@pytest.fixture
def card():
    """The CUDA device, with float32 products in full float32; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp(ref, dtype):
    mant = 7 if dtype == torch.bfloat16 else 23
    return 2.0 ** (torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - mant)


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim", LN_SHAPES)
def test_add_layer_norm_is_no_farther_from_float64_than_the_plain_path(card, rows, dim, dtype, with_d):
    """One launch; x_new bit-equal to the card's add in the working dtype; y
    no farther from the LayerNorm of that sum in float64 than the plain
    path's (which rounds once too, at its cast), each value within one ulp
    of its dtype plus 1e-5 (float32 statistics over the row); two runs
    bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(rows * 31 + dim)
    x = (2.0 * torch.randn(rows, dim, device="cuda", generator=g) + 0.5).to(dtype)
    d = torch.randn(rows, dim, device="cuda", generator=g).to(dtype) if with_d else None
    gamma = (1.0 + 0.3 * torch.randn(dim, device="cuda", generator=g)).to(dtype)
    beta = (0.2 * torch.randn(dim, device="cuda", generator=g)).to(dtype)
    before = k8.launches
    x_new, y = k8.add_layer_norm(x, d, gamma, beta)
    x_again, y_again = k8.add_layer_norm(x, d, gamma, beta)
    torch.cuda.synchronize()
    assert k8.launches == before + 2 and y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, y_again) and torch.equal(x_new, x_again)
    assert torch.equal(x_new, x if d is None else x + d)
    ref = k8.add_layer_norm_f64(x, d, gamma, beta)
    _, plain = k8.add_layer_norm_plain(x, d, gamma, beta)
    err = (y.double() - ref).abs()
    err_plain = (plain.double() - ref).abs().max().item()
    bound = _ulp(ref, dtype) + 1e-5
    assert (err <= bound).all(), (err.max().item(), (err / bound).max().item())
    assert err.max().item() <= err_plain, (err.max().item(), err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", GELU_ROWS)
def test_gelu_new_is_no_farther_from_float64_than_the_plain_path(card, rows, dtype):
    """gelu_new on the card, PyTorch's tanh GELU over the mlp_fc output
    [rows, 5120]: no farther from gelu_new in float64 than the plain path's
    ~10 kernels, each value within one ulp of its dtype plus 1e-6; two runs
    bit-equal; K8 counts no launch of it; a tiny model's width (64) and a
    length not a multiple of a block too."""
    g = torch.Generator(device="cuda").manual_seed(rows)
    for shape in ((rows, 5120), (rows, 64), (rows * 3 + 1, 8)):
        x = (3.0 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
        before = k8.launches
        y, again = k8.gelu_new(x), k8.gelu_new(x)
        torch.cuda.synchronize()
        assert k8.launches == before and y.dtype == dtype and torch.equal(y, again)
        ref = k8.gelu_new_f64(x)
        err = (y.double() - ref).abs()
        err_plain = (k8.gelu_new_plain(x).double() - ref).abs().max().item()
        bound = _ulp(ref, dtype) + 1e-6
        assert (err <= bound).all(), (shape, err.max().item(), (err / bound).max().item())
        assert err.max().item() <= err_plain, (shape, err.max().item(), err_plain)


@pytest.mark.cuda
def test_k8_raises_instead_of_falling_back(card):
    """On a CUDA tensor add_layer_norm launches or raises; never the plain
    path."""
    x = torch.randn(4, 64, device="cuda", dtype=torch.bfloat16)
    gamma = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    before = k8.launches
    with pytest.raises(TypeError):
        k8.add_layer_norm(x.half(), None, gamma.half(), gamma.half())
    with pytest.raises(ValueError):
        k8.add_layer_norm(x[:, :60].contiguous(), None, gamma[:60], gamma[:60])  # D not a multiple of 8
    with pytest.raises(ValueError):
        k8.add_layer_norm(x, x.float(), gamma, gamma)  # d of another dtype
    with pytest.raises(ValueError):
        k8.add_layer_norm(x, None, gamma.float(), gamma.float())  # gamma of another dtype
    with pytest.raises(ValueError):
        k8.add_layer_norm(x.t().contiguous().t(), None, gamma, gamma)  # not contiguous
    with pytest.raises(ValueError):
        k8.add_layer_norm(torch.randn(264, device="cuda", dtype=torch.bfloat16)[1:257].view(4, 64), None, gamma,
                          gamma)  # not on a 16-byte boundary
    assert k8.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["decode", "decode_int8", "beam", "slot"])
def test_k8_replayed_blocks_equal_eager(card, loop):
    """A decode loop's blocks captured and replayed (graphs.py) against the
    same blocks run eagerly, the model in bf16 on the card: token for token
    over more than one block, and K8's `launches` count 2 x layers + 1 a
    step and a prefill in both (49 at 24 layers; a replay adds the captured
    step's launches times the steps the block ran)."""
    from indextts_tpu_torch.graphs import BLOCK, Graphs

    cfg, model = _tiny(heads=4, dh=64, device="cuda", dtype=torch.bfloat16)
    per_pass = 2 * cfg.layers + 1
    g = torch.Generator(device="cuda").manual_seed(3)
    b = 3
    conds = (0.1 * torch.randn(b, 8, cfg.model_dim, device="cuda", generator=g)).to(torch.bfloat16)
    text = torch.randint(2, 50, (b, 12), device="cuda", generator=g)
    lens = torch.tensor([12, 9, 5], device="cuda")

    def run(graphs):
        before = k8.launches
        with torch.no_grad():
            if loop in ("decode", "decode_int8"):
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                codes, lengths = tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator(),
                                                      quant_kv=loop == "decode_int8", graphs=graphs.decode)
                steps, prefills = int(lengths.max()) - 1, 1
            elif loop == "beam":
                gen = tdec.GenerationConfig(do_sample=False, num_beams=3, max_new_tokens=40, early_stopping=False)
                stats = {}
                codes, lengths = tdec.generate_speech_beam(model, cfg, gen, conds[:1], text[:1], lens[:1],
                                                           torch.Generator(), stats=stats, graphs=graphs.decode)[:2]
                steps, prefills = stats["steps"], 1
            else:
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                st = tslots.slot_state_init(cfg, gen, 4, 128, torch.bfloat16, device="cuda", quant_kv=True)
                for slot in range(b):
                    prod = tslots.slot_prefill(model, cfg, gen, conds[slot : slot + 1], text[slot : slot + 1, :12],
                                               lens[slot : slot + 1], torch.Generator(), quant_kv=True)
                    tslots.slot_admit(st, prod, slot, cfg)
                tslots.slot_steps(model, cfg, gen, st, 45, torch.Generator(), graphs=graphs.slot)
                codes, steps, prefills = st.codes, int(st.tick), b
        torch.cuda.synchronize()
        return codes.cpu(), steps, k8.launches - before - per_pass * prefills

    graphs = Graphs("cuda")
    eager_graphs = Graphs("cuda")
    with eager_graphs.eager():
        want, want_steps, want_launches = run(eager_graphs)
    got, got_steps, got_launches = run(graphs)
    assert torch.equal(got, want)
    assert got_steps == want_steps > BLOCK and want_launches == got_launches == per_pass * want_steps
    stage = graphs.slot if loop == "slot" else graphs.decode
    assert any(lane.replays > 0 for lane in stage.lanes.values())


@pytest.mark.cuda
def test_k8_step_follows_the_plain_route(card):
    """The tiny model's greedy decode in float32 on the card (K6 and K8)
    against the same weights on the CPU (their plain versions): the same
    codes."""
    cfg, model = _tiny(heads=4, dh=16)
    g = torch.Generator().manual_seed(4)
    conds = 0.1 * torch.randn(2, 8, cfg.model_dim, generator=g)
    text = torch.randint(2, 50, (2, 10), generator=g)
    lens = torch.tensor([10, 7])
    gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=30)
    with torch.no_grad():
        want, _ = tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator())
        model = model.to("cuda")
        before = k8.launches
        got, _ = tdec.generate_speech(model, cfg, gen, conds.cuda(), text.cuda(), lens.cuda(), torch.Generator())
    assert k8.launches > before
    assert torch.equal(got.cpu(), want)
