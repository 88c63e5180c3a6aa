"""K6: the decode step's attention over one layer's KV cache, a CUDA kernel
written for Hopper (csrc/decode_attn.cu), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's decode step leaves this attention
to XLA (indextts_tpu/models/gpt_decode.py _decode_block, _decode_block_q).
Every decode loop of the port runs it once a layer a step
(models/gpt_decode._decode_step, through GPT2Block.step on the bf16 /
float32 cache and _decode_block_q on the int8 one): one new token per row
against the cache, its own K / V as an extra logit, the softmax in float32,
then its K / V written into cache column `pos` (int8: quantized per head
pair, quant_cols). The kernel reads the cache in place, int8 included, and
rounds once, at its output; the plain version is the arithmetic those two
functions ran before, which rounds the scores and the weighted sums to the
working dtype between its products.

`decode_attn` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from indextts_tpu_torch.ops.cuda.common import launch

SOURCE = "decode_attn.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_SIZES = (16, 64)  # the tiny test models' and the published configurations'
# query heads a KV head of each head size: 1 (multi-head), and granite-4.0-h's 4 (the tiny models' 2)
_GROUPS = {16: (1, 2), 64: (1, 4)}

Pos = Union[int, torch.Tensor]


def quant_cols(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of a cache t [..., H, S, Dh] with one scale per head
    pair and position: the amax runs over heads 2g and 2g+1 together, the
    column of JAX's head-paired cache (gpt_decode.py:326-336). Returns (q
    [..., H, S, Dh] int8, s [..., H/2, S] float32), t ~ q * s."""
    *lead, h, s_len, dh = t.shape
    if h % 2:
        raise ValueError(f"the int8 KV cache scales head pairs: {h} heads (a tensor-parallel shard built "
                         "for quant_kv keeps an even count, parallel/mesh._check_divisible)")
    tf = t.float().reshape(*lead, h // 2, 2, s_len, dh)
    amax = tf.abs().amax(dim=(-3, -1))
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / s[..., None, :, None]), -127, 127).to(torch.int8)
    return q.reshape(t.shape), s


def decode_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Sequence[torch.Tensor], pos: Pos,
                      bias: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """K6's function in plain PyTorch. q [B, H, Dh], k, v [B, Hkv, Dh]: the
    new token's, with H a multiple of Hkv (grouped-query attention: query
    head h reads KV head h // (H / Hkv)); cache (k, v) [B, Hkv, S, Dh] or
    int8 (k8, ks, v8, vs) with the scales [B, Hkv/2, S]; bias [B, 1, S]
    float32 masks slot `pos` (an int or a [1] long device index), where the
    token's own K / V then go, in place. `scale` multiplies the scores (None:
    1 / sqrt(Dh)). Returns the attention [B, H * Dh] in q's dtype.

    The int8 cache dequantizes in JAX's order (_decode_block_q): scores
    contract in q's dtype and then take ks in float32; the attention weights
    take vs in float32 before the cast."""
    b = q.shape[0]
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    rep = (lambda t: t) if group == 1 else (lambda t: t.repeat_interleave(group, dim=1))
    col = torch.as_tensor(pos, device=q.device).reshape(1)
    if len(cache) == 2:
        k_cache, v_cache = cache
        s = (q[:, :, None] @ rep(k_cache).transpose(-1, -2))[:, :, 0].float()
        scores = torch.cat([s * scale + bias, (q * rep(k)).sum(-1, keepdim=True).float() * scale], dim=-1)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        a = (attn[:, :, None, :-1] @ rep(v_cache))[:, :, 0] + attn[..., -1:] * rep(v)
        k_cache.index_copy_(2, col, k[:, :, None])
        v_cache.index_copy_(2, col, v[:, :, None])
        return a.reshape(b, -1)
    k8, ks, v8, vs = cache
    ksh, vsh = rep(ks.repeat_interleave(2, dim=1)), rep(vs.repeat_interleave(2, dim=1))  # [B, H, S]
    s = (q[:, :, None] @ rep(k8).to(q.dtype).transpose(-1, -2))[:, :, 0].float()
    scores = torch.cat([s * ksh * scale + bias, (q * rep(k)).sum(-1, keepdim=True).float() * scale], dim=-1)
    attn = torch.softmax(scores, dim=-1)
    a2 = (attn[..., :-1] * vsh).to(q.dtype)
    a = (a2[:, :, None] @ rep(v8).to(q.dtype))[:, :, 0] + attn[..., -1:].to(q.dtype) * rep(v)
    for cache8, cache_s, new in ((k8, ks, k), (v8, vs, v)):
        q8, qs = quant_cols(new[:, :, None])
        cache8.index_copy_(2, col, q8)
        cache_s.index_copy_(2, col, qs)
    return a.reshape(b, -1)


def decode_attn_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Sequence[torch.Tensor],
                    bias: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """K6's formula in float64, the yardstick of the kernel's and the plain
    version's error (the card tests, chip_smoke.py): scores over the columns
    the bias leaves valid (above float32's lowest value), times the int8
    scale, times `scale` (None: 1 / sqrt(Dh)), plus the token's own logit;
    the softmax; V times its scale, plus the own term. Query head h reads KV
    head h // (H / Hkv). Writes nothing."""
    b, _, dh = q.shape
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    rep = lambda t: t.repeat_interleave(group, dim=1)
    if len(cache) == 2:
        kk, vv = (rep(c.double()) for c in cache)
        ksh = vsh = 1.0
    else:
        kk, vv = rep(cache[0].double()), rep(cache[2].double())
        ksh, vsh = (rep(t.double().repeat_interleave(2, dim=1)) for t in (cache[1], cache[3]))
    qd = q.double()
    s = torch.einsum("bhd,bhsd->bhs", qd, kk) * ksh * scale
    s = torch.where(bias > torch.finfo(torch.float32).min, s + bias.double(), -math.inf)
    own = (qd * rep(k.double())).sum(-1, keepdim=True) * scale
    w = torch.softmax(torch.cat([s, own], dim=-1), dim=-1)
    a = torch.einsum("bhs,bhsd->bhd", w[..., :-1] * vsh, vv) + w[..., -1:] * rep(v.double())
    return a.reshape(b, -1)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_decode_attn
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def _check_cache(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """A cache tensor as the kernel reads it: K / V in 16-byte loads, so on a
    16-byte boundary (a layer's slice of the [L, B, H, S, Dh] cache is);
    the int8 scales [B, H/2, S] one float32 at a time."""
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"decode_attn: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"decode_attn: {name} must be contiguous on {device} ({t.device})")
    if t.dim() == 4 and t.data_ptr() % 16:
        raise ValueError(f"decode_attn: {name} must start on a 16-byte boundary")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Sequence[torch.Tensor], pos: Pos,
                bias: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The attention of one new token per row against one layer's KV cache,
    and the write of its K / V into column `pos`: decode_attn_plain's
    function, in one launch on a CUDA tensor. q [B, H, Dh] and k, v [B, Hkv,
    Dh], float32 or bf16 (views of the qkv projection, read in place), H a
    multiple of Hkv (1 or 4 query heads a KV head at Dh 64, 1 or 2 at 16);
    cache (k, v) [B, Hkv, S, Dh] in q's dtype or (k8, ks, v8, vs) int8 /
    float32, contiguous; bias [B, 1, S] (or [B, S]) float32, NEG (or -inf) on
    the masked columns, which the kernel does not read; pos an int or a
    one-element int64 device tensor (read on the card: one outside [0, S)
    traps the kernel and loses the CUDA context, as index_copy_'s device
    assert does; the loops keep it inside); `scale` the scores' factor (None:
    1 / sqrt(Dh)). Returns [B, H * Dh] in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, cache, pos, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attn: q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"decode_attn: q must be [B, H, Dh], got shape {tuple(q.shape)}")
    b, hq, dh = q.shape
    if dh not in _HEAD_SIZES:
        raise ValueError(f"decode_attn: head size {dh} is not one of {_HEAD_SIZES}")
    h = k.shape[1] if k.dim() == 3 else 0
    for name, t in (("k", k), ("v", v)):
        if t.dim() != 3 or t.shape != (b, h, dh) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"decode_attn: {name} {t.dtype} {tuple(t.shape)} on {t.device} does not match q "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    group = hq // h if h and hq % h == 0 else 0
    if group not in _GROUPS[dh]:
        raise ValueError(f"decode_attn: {hq} query heads over {h} KV heads of {dh}: the kernel takes "
                         f"{_GROUPS[dh]} query heads a KV head")
    # one row stride for the three (a single row has none: a view of one row of the projection may give its
    # size-1 batch dimension any stride, and GQA's q, k and v do get different ones)
    if (any(t.stride()[1:] != (dh, 1) for t in (q, k, v))
            or (b > 1 and len({t.stride(0) for t in (q, k, v)}) != 1)):
        raise ValueError(f"decode_attn: q, k and v must share one stride, heads {dh} apart, as the qkv projection's "
                         f"parts do; got {q.stride()}, {k.stride()}, {v.stride()}")
    if len(cache) == 2:
        s_len = cache[0].shape[2] if cache[0].dim() == 4 else -1
        for name, t in zip(("k_cache", "v_cache"), cache):
            _check_cache(name, t, (b, h, s_len, dh), q.dtype, q.device)
        kc, vc, ks, vs = cache[0], cache[1], None, None
    elif len(cache) == 4:
        if h % 2:
            raise ValueError(f"decode_attn: the int8 cache scales head pairs, {h} heads")
        kc, ks, vc, vs = cache
        s_len = kc.shape[2] if kc.dim() == 4 else -1
        for name, t, shape, dtype in (("k8", kc, (b, h, s_len, dh), torch.int8),
                                      ("v8", vc, (b, h, s_len, dh), torch.int8),
                                      ("ks", ks, (b, h // 2, s_len), torch.float32),
                                      ("vs", vs, (b, h // 2, s_len), torch.float32)):
            _check_cache(name, t, shape, dtype, q.device)
    else:
        raise ValueError(f"decode_attn: the cache is (k, v) or (k8, ks, v8, vs), got {len(cache)} tensors")
    if s_len <= 0:
        raise ValueError(f"decode_attn: empty or malformed cache {tuple(cache[0].shape)}")
    if bias.dtype != torch.float32 or bias.numel() != b * s_len or bias.shape[-1] != s_len:
        raise ValueError(f"decode_attn: bias must be float32 [B, 1, S] = [{b}, 1, {s_len}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if bias.device != q.device or not bias.is_contiguous():
        raise ValueError("decode_attn: bias must be contiguous on q's device")
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int64 or pos.device != q.device:
            raise ValueError(f"decode_attn: pos must be one int64 on {q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        pos_ptr, pos_val = pos.data_ptr(), 0
    else:
        if not 0 <= int(pos) < s_len:
            raise ValueError(f"decode_attn: pos {pos} outside the cache's {s_len} columns")
        pos_ptr, pos_val = None, int(pos)
    out = torch.empty(b, hq * dh, dtype=q.dtype, device=q.device)
    if _fn is None:
        _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), kc.data_ptr(), vc.data_ptr(),
            None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(), bias.data_ptr(), pos_ptr,
            pos_val, out.data_ptr(), b, h, group, s_len, dh, 1.0 / math.sqrt(dh) if scale is None else float(scale),
            _DTYPE_CODE[q.dtype], int(ks is not None))
    err = launch(_fn, q, *args)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {err} (q {tuple(q.shape)}, "
                           f"cache {tuple(kc.shape)} {kc.dtype})")
    launches += 1
    return out
