"""K6's plain version (ops/cuda/decode_attn.py) against the decode step's
attention as GPT2Block.step and _decode_block_q computed it before the step
went through K6, kept below: on the CPU the wrapper takes the plain version,
whose outputs and cache writes must be that arithmetic bit for bit, on both
cache kinds, with `pos` an int or a [1] device index, a row whose only valid
logit is its own, and local head counts of a whole model and of a
tensor-parallel shard. The kernel itself is held against a float64
evaluation on the card (tests/test_torch_cuda_kernels.py)."""

import math

import pytest
import torch
import torch.nn as nn

import indextts_tpu_torch.models.gpt_decode as tdec
from indextts_tpu_torch.models.gpt import NEG, GPT2Block, write_at
from indextts_tpu_torch.ops.cuda import decode_attn as k6


def _old_step(block, x, k_cache, v_cache, pos, bias, heads):
    """GPT2Block.step as it was (the residual stream in and out)."""
    b = x.shape[0]
    x, q, k, v = block.qkv(x, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q[:, :, None] @ k_cache.transpose(-1, -2))[:, :, 0].float()
    scores = torch.cat([s * scale + bias, (q * k).sum(-1, keepdim=True).float() * scale], dim=-1)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    a = (attn[:, :, None, :-1] @ v_cache)[:, :, 0] + attn[..., -1:] * v
    write_at(k_cache, 2, pos, k)
    write_at(v_cache, 2, pos, v)
    return block.proj(x, a.reshape(b, -1))


def _old_block_q(block, x, k8, ks, v8, vs, pos, bias, heads):
    """gpt_decode._decode_block_q as it was (the residual stream in and out)."""
    b = x.shape[0]
    x, q, k, v = block.qkv(x, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ksh, vsh = ks.repeat_interleave(2, dim=1), vs.repeat_interleave(2, dim=1)
    s = (q[:, :, None] @ k8.to(x.dtype).transpose(-1, -2))[:, :, 0].float()
    scores = torch.cat([s * ksh * scale + bias, (q * k).sum(-1, keepdim=True).float() * scale], dim=-1)
    attn = torch.softmax(scores, dim=-1)
    a2 = (attn[..., :-1] * vsh).to(x.dtype)
    a = (a2[:, :, None] @ v8.to(x.dtype))[:, :, 0] + attn[..., -1:].to(x.dtype) * v
    for cache8, cache_s, new in ((k8, ks, k), (v8, vs, v)):
        q8, qs = tdec._quant_cols(new[:, :, None])
        write_at(cache8, 2, pos, q8[:, :, 0])
        write_at(cache_s, 2, pos, qs[:, :, 0])
    return block.proj(x, a.reshape(b, -1))


# (model width, the model's heads, local heads): whole models, and one rank of
# a tensor-parallel pair (attn_qkv holds 10 of the 20 heads, Dh 16)
HEADS = [(64, 4, 4), (320, 20, 20), (320, 20, 10)]


def _case(d, heads, local, dtype, quant, seed=0, b=3, s_len=24, pos=17):
    g = torch.Generator().manual_seed(seed)
    block = GPT2Block(d)
    dh = d // heads
    if local != heads:
        block.attn_qkv = nn.Linear(d, 3 * local * dh)
        block.attn_proj = nn.Linear(local * dh, d)
    for p in block.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g) * (0.3 if p.dim() > 1 else 0.1))
    block = block.to(dtype)
    x = torch.randn(b, d, generator=g).to(dtype)
    cache = [torch.randn(b, local, s_len, dh, generator=g).to(dtype) for _ in range(2)]
    if quant:
        (k8, ks), (v8, vs) = tdec._quant_cols(cache[0]), tdec._quant_cols(cache[1])
        cache = [k8, ks, v8, vs]
    # row 0 sees the prompt and its steps, row 1 a shorter span, row 2 nothing
    # but its own K / V (every column masked)
    cols = torch.arange(s_len)[None, :]
    valid = torch.cat([cols < pos, (cols >= 5) & (cols < pos), torch.zeros(1, s_len, dtype=torch.bool)])
    bias = torch.where(valid, torch.zeros(()), NEG)[:, None, :]
    return block, x, cache, bias


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,local", HEADS)
def test_step_through_k6_equals_the_earlier_arithmetic(d, heads, local, dtype, quant, pos_kind):
    """The step's output and the cache bytes after its write, bit for bit;
    on the CPU the wrapper launches nothing."""
    pos = 17
    block, x, cache, bias = _case(d, heads, local, dtype, quant)
    old = [c.clone() for c in cache]
    initial = old[0].clone()
    p = pos if pos_kind == "int" else torch.tensor([pos])
    before = k6.launches
    with torch.no_grad():
        if quant:
            got = tdec._decode_block_q(block, x, *cache, p, bias, heads)
            want = _old_block_q(block, x, *old, p, bias, heads)
        else:
            got = block.step(x, *cache, p, bias, heads)
            want = _old_step(block, x, *old, p, bias, heads)
    assert k6.launches == before
    assert len(got) == len(want) == 2  # the stream: the sum, and the MLP's output not yet added
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for c, o in zip(cache, old):
        assert c.dtype == o.dtype and torch.equal(c, o)
    # the write reached column pos, and only that column
    untouched = [j for j in range(cache[0].shape[2]) if j != pos]
    assert not torch.equal(cache[0][:, :, pos], initial[:, :, pos])
    assert torch.equal(cache[0][:, :, untouched], initial[:, :, untouched])


@pytest.mark.parametrize("quant", [False, True])
def test_plain_on_a_row_with_only_its_own_logit(quant):
    """Every column masked: the attention is the token's own V exactly (its
    weight is 1), on both cache kinds."""
    block, x, cache, bias = _case(64, 4, 4, torch.float32, quant)
    with torch.no_grad():
        _, q, k, v = block.qkv(x, 4)
        a = k6.decode_attn(q, k, v, cache, 17, bias)
    assert torch.equal(a[2], v[2].reshape(-1))


def test_wrapper_raises_off_the_cpu_and_the_card():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    computed by the plain version."""
    q = torch.zeros(1, 4, 16, device="meta")
    cache = (torch.zeros(1, 4, 8, 16, device="meta"),) * 2
    with pytest.raises(ValueError):
        k6.decode_attn(q, q, q, cache, 0, torch.zeros(1, 1, 8, device="meta"))


def test_quant_cols_is_the_decode_modules():
    """gpt_decode keeps _quant_cols, the quantizer K6's int8 write mirrors."""
    assert tdec._quant_cols is k6.quant_cols
