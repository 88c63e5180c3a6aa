#!/usr/bin/env python3
"""Smoke run of the PyTorch port (indextts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the K1, K2, K3, K4 and K5 kernels from
               indextts_tpu_torch/csrc/, one nvcc per source, started together;
  3. kernel  — K1 against its plain PyTorch version at the vocoder's shapes
               for ~100 codes, B = 1 and 4, bf16 and float32, with CUDA-event
               times for both, K1's own device time (profiler events of its
               __global__ function) beside the whole call's, and K4's kernel
               at the same shapes;
     k2      — K2 (aa_snake_dconv) against its plain version at the three
               wide stages of a ~100-code vocoder call, every (k, d) at B = 1
               and one (k, d) per stage at B = 4, bf16 and float32, TF32 off:
               err against a stated bound, K2's profiler and CUDA-event
               times, the plain version's, and the default vocoder path's
               (K1, then cuDNN's conv); the wrapper's first call on a weight
               (it packs the weight) beside its second (it finds it packed);
     k3      — K3 (anti_alias_snake_tmajor) at the three wide stages, B = 1
               and 4, bf16 and float32: the CUDA-core and the tensor-core body
               against their plain versions (err against a stated bound;
               float32 also within 2e-5 of the composed path), the ident body
               bit-equal to its input; own and whole-call profiler times,
               CUDA-event times and GB/s of each body with K1's at the same
               shape; odd shapes (C = 130, C = 9, T not a multiple of a tile
               or of a 16-byte vector, T = 5, 7, 241); each body's bound per
               vocoder call, and the registers and spills ptxas reports for
               each of K3's kernels;
     k4      — K4 (anti_alias_snake_folded) at the three narrow stages
               (C = 96, 48, 24), B = 1 and 4, bf16 and float32, against its
               plain version (err against a stated bound; float32 also within
               2e-5 of the composed path); Snake without beta, plain
               parameters and odd shapes (C = 25, T = 1003, 1004, 5, 1);
               own and whole-call profiler times, CUDA-event times and GB/s
               with K1's and K3's ident body's at the same shape;
  4. k5      — K5 (int8_matmul) against its plain version at the five GPT
               matmul shapes of the published width, M = 1, 3, 4, 8, 15, 16,
               x bf16 and float32, TF32 off, two runs on one input bit-equal;
               CUDA-event and profiler device times for both, with the
               weights cycled past the L2 cache, GB/s over the int8 weight
               bytes, and F.linear on the bf16 weights at the same shape as a
               yardstick; then K not a multiple of 16 and a weight view that
               is not 16-byte aligned; per decode step (97 launches) at every
               M;
  5. engine  — IndexTTS.infer at the published IndexTTS-1.5 width
               (configs/indextts_1_5.yaml), random weights from a fixed seed,
               bf16: a greedy, a sampled and a two-sentence request; the K1
               launch count must be 109 per vocoder call; then one profiled
               bigvgan_apply at 100 codes on the default route (host ms,
               device ms, kernels, device-idle share, K1's own ms);
  6. beam    — the same width with fast_latents and INDEXTTS_WIDE_BRANCH=1:
               infer with the engine's default generation kwargs (num_beams
               3, sampled), infer_fast on two sentences, and a greedy
               num_beams=3 infer on the int8 KV cache; K2 must launch 54 and
               K1 55 times per vocoder call; a default-kwargs infer at
               max_mel_tokens=320, which must take the segmented beam loop
               (two segments); then one forced beam step at B = 1 profiled
               (host vs device, the cache reorder alone);
     stream  — the same width with INDEXTTS_WIDE_TMAJOR=1 (K3 at the 54 wide
               activations, K1 at the other 55): infer_stream, sampled,
               max_mel_tokens=200 with the default chunking (24 / 96 / 8),
               with teacher-forced latents, with fast_latents, and with
               INDEXTTS_WIDE_TMAJOR_MXU=1; each must yield 3 chunks (25, 96
               and 79 codes) of finite samples from 3 vocoder calls, K3 162
               and K1 165 launches; time to first audio and per-chunk times
               beside one infer (num_beams=1) of the same request;
     serve   — the same width with fast_latents, INDEXTTS_FUSED_AA=1 and
               INDEXTTS_WIDE_TMAJOR=1 (K4 54, K3 54, K1 1 launches per
               vocoder call), max_mel_tokens=100: warmup(n_slots=4,
               streaming=True); one infer_batch call of 4 requests over 2
               prompts (one of two sentences) with the default generation
               kwargs and per-request temperatures; a SlotSession of 4 slots
               and chunk_steps=25 serving 8 sampled requests, one of them
               streaming and one admitted while others are mid-decode; one
               forced slot chunk profiled (host vs device); one vocoder call
               under INDEXTTS_FUSED_AA=1 alone (K4 54, K1 55), then one
               profiled as in the engine phase;
     int8    — the same width with quant_kv=True: the max |logit| drift of
               prefill + 16 forced decode steps with the int8 KV cache, and
               with int8 KV and int8 weights, against the bf16 cache (int8 KV
               under JAX's gate of 1.0); then, on weights quantized with
               quantize_unified_voice, a sampled infer_fast request of four
               sentences decoded as one batch of 4 and a greedy infer; K5
               must launch 1 + (4 x layers + 1) x steps times per generate
               call and K1 109 times per vocoder call;
  7. small   — the same engine at a tiny width in float32 on the card
               against the CPU on the same weights (greedy codes equal, wav
               within tolerance), for infer, for greedy num_beams=3 infer
               with INDEXTTS_WIDE_BRANCH=1 (K2 on the card, its plain version
               on the CPU), the card's captured latents against its
               teacher-forced pass, greedy infer_stream under
               INDEXTTS_WIDE_TMAJOR=1 with and without _MXU (chunk sizes
               equal, samples within tolerance, K3 on the card), greedy
               infer_batch and infer_slots against per-request infer on both
               devices, a vocoder call under INDEXTTS_FUSED_AA=1 (K4 on the
               card, its plain version on the CPU), and infer_fast on int8
               weights with the int8 KV cache;
  8. report  — one JSON line of kernel results, the nvidia-smi line, and the
               final {"ok": true, ...} line.

It needs the repository around it and a CUDA device, and imports no JAX.
Details go to chiprun_out/chip_smoke_report.json.
`--phases a,b` (of kernel, k2, k3, k4, k5, engine, beam, stream, serve, int8,
small) runs
only those phases after the build, for work on one of them, with the per
vocoder call sums of kernel, k3 and k4: it prints no kernels line and no
final line, and exits 3. In the kernels line `ms` is a kernel's own device
time per main-path unit and `call_ms` its wrappers' whole calls.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")
FLAGSHIP = os.path.join(REPO, "configs", "indextts_1_5.yaml")
K1_REPLACES = "indextts_tpu/ops/pallas/antialias.py:84"
K1_SOURCE = "indextts_tpu_torch/csrc/anti_alias_snake.cu"
K5_REPLACES = "indextts_tpu/ops/pallas/qmatmul.py:42"
K5_SOURCE = "indextts_tpu_torch/csrc/int8_matmul.cu"
K2_REPLACES = "indextts_tpu/ops/pallas/aa_conv_branch.py:166"
K2_SOURCE = "indextts_tpu_torch/csrc/aa_snake_dconv.cu"
K3_REPLACES = "indextts_tpu/ops/pallas/antialias_tmajor.py:163"
K3_SOURCE = "indextts_tpu_torch/csrc/anti_alias_snake_tmajor.cu"
K4_REPLACES = "indextts_tpu/ops/pallas/antialias_folded.py:111"
K4_SOURCE = "indextts_tpu_torch/csrc/anti_alias_snake_folded.cu"
# the __global__ functions of K1, K3 (every body) and K4: a profiler event whose
# name holds one of these is that kernel's own time
K1_KERNEL, K3_KERNEL, K4_KERNEL = "anti_alias_snake_kernel", "tmajor_", "folded_aa_kernel"
# the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# float32 operations of the anti-aliased activation per output element: two
# 2x-rate samples x (12 for the up taps + 18 for the snake with the polynomial
# sin) + 24 for the down taps
ACT_OPS = 84
# each AMPBlock1 (kernel k, dilations 1, 3, 5) makes per stage 4 half-branch
# calls at (k, 1), one at (k, 3) and one at (k, 5)
K2_CALLS = {(k, d): (4 if d == 1 else 1) for k in (3, 7, 11) for d in (1, 3, 5)}
# the GPT matmuls at the published width, (label, K, N): per layer qkv, attn
# proj, mlp fc, mlp proj; then the mel head
K5_SHAPES = [("qkv", 1280, 3840), ("proj", 1280, 1280), ("fc", 1280, 5120), ("mlp_proj", 5120, 1280),
             ("head", 1280, 8194)]
# four sentences with the random-init tokenizer at max_text_tokens_per_sentence=16
FOUR_SENTENCES = "HELLO WORLD. THIS IS A TEST. GOOD DAY TO YOU."

# vocoder stages for ~100 codes: (label, C, T); T = 100 codes x 4 x the upsampling so far
STAGES = [("stage1", 768, 1600), ("stage2", 384, 6400), ("stage3", 192, 12800), ("stage4", 96, 25600),
          ("stage5", 48, 51200), ("stage6", 24, 102400), ("activation_post", 24, 102400)]


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int, own=()):
    """torch.profiler's reading of `fn`, per call: "call_ms", the summed device
    time of every kernel it launches; "kernels", how many it launches; and
    "own_ms", for each name in `own`, the time of the kernels whose name holds
    it (a kernel's own __global__ function, without the allocations and
    elementwise kernels around it). None when the profiler records no device
    time. Unlike CUDA events around back-to-back calls, this excludes host
    enqueue gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a trace now and then comes back without device records (a few in a row): take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0.0) > 0]
        if events:
            ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / iters
            return {"call_ms": ms(events), "kernels": sum(e.count for e in events) / iters,
                    "own_ms": {name: ms([e for e in events if name in e.key]) for name in own},
                    "exp_kernels": sum(e.count for e in events if "exp_kernel" in e.key) / iters}
    return None


def device_time_ms(fn, iters: int):
    """Summed device time of every kernel `fn` launches, per call, from
    torch.profiler; None when the profiler records no device time."""
    prof = device_profile(fn, iters)
    return None if prof is None else prof["call_ms"]


def own_and_call_ms(fn, iters: int, kernel: str):
    """(the kernel's own device ms, the whole call's device ms, kernels
    launched per call) of `fn`; Nones when the profiler saw nothing."""
    prof = device_profile(fn, iters, (kernel,))
    if prof is None:
        return None, None, None
    return prof["own_ms"][kernel], prof["call_ms"], prof["kernels"]


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def ptxas_counts(log_text: str, name: str) -> dict:
    """From a `-Xptxas -v` build log: registers and spill bytes of each
    compiled entry function whose (mangled) name holds `name`."""
    import re

    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if name in m.group(1) else None
            if entry:
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def kernel_phase(card: str) -> dict:
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_folded as k4

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = [(label, b, c, t, dt, True) for label, c, t in STAGES for b in (1, 4)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [("snake_no_beta", 1, 96, 25600, dt, False) for dt in (torch.bfloat16, torch.float32)]
    rows, failures = [], []
    for label, b, c, t, dtype, with_beta in cases:
        x = torch.randn(b, c, t, device="cuda", generator=g).to(dtype)
        alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
        beta = 0.3 * torch.randn(c, device="cuda", generator=g) if with_beta else None
        logscale = with_beta  # SnakeBeta as the vocoder runs it; Snake with plain alpha
        if not logscale:
            alpha = alpha.abs() + 0.1
        out = k1.fused_anti_alias_snake(x, alpha, beta, logscale)
        torch.cuda.synchronize()
        ref = k1.anti_alias_snake_plain(x, alpha, beta, logscale)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = 1e-5 * scale if dtype == torch.float32 else 2 * bf16_ulp(scale)
        iters = 20 if t * b <= 25600 else 10
        plain_ms = cuda_time_ms(lambda: k1.anti_alias_snake_plain(x, alpha, beta, logscale), iters)
        ms = cuda_time_ms(lambda: k1.fused_anti_alias_snake(x, alpha, beta, logscale), iters)
        own_ms, dev_ms, n_kernels = own_and_call_ms(lambda: k1.fused_anti_alias_snake(x, alpha, beta, logscale),
                                                    iters, K1_KERNEL)
        dev_plain_ms = device_time_ms(lambda: k1.anti_alias_snake_plain(x, alpha, beta, logscale), iters)
        # K4's design (a warp walks a row) on K1's shape, for the comparison of the two
        k4_own_ms = own_and_call_ms(lambda: k4.fused_folded_aa(x, alpha, beta, logscale), iters, K4_KERNEL)[0]
        # moved bytes of the best case: read x once, write z once
        nbytes = 2 * x.numel() * x.element_size()
        gbps = nbytes / (own_ms * 1e-3) / 1e9 if own_ms else None
        row = dict(case=label, B=b, C=c, T=t, dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   bound=bound, ms=ms, plain_ms=plain_ms, own_ms=own_ms, device_ms=dev_ms, call_kernels=n_kernels,
                   device_plain_ms=dev_plain_ms, k4_own_ms=k4_own_ms, kernel_GBps=gbps, ok=bool(err <= bound))
        rows.append(row)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
        log(f"[kernel] {label:16s} B={b} C={c:4d} T={t:6d} {row['dtype']:8s} err={err:.3e} (bound {bound:.3e}) "
            f"events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms | device: K1 own {fmt(own_ms)} ms, whole call "
            f"{fmt(dev_ms)} ms in {n_kernels} kernels, plain {fmt(dev_plain_ms)} ms, {fmt(gbps)} GB/s; K4 own at this "
            f"shape {fmt(k4_own_ms)} ms  [{card}]")
        if not row["ok"]:
            failures.append(row)
        del x, out, ref
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version: {failures}")
    return {"rows": rows}


def k2_phase(card: str) -> dict:
    """K2 at the wide stages of a ~100-code vocoder call: every (k, d) of the
    vocoder at B = 1 and one (k, d) per stage at B = 4, bf16 and float32; the
    wrapper's first call on a weight (which packs it) beside its second."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
    from indextts_tpu_torch.ops.cuda import antialias as k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2468)
    rows, failures = [], []
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    # every (k, d) at B = 1; B = 4 at one (k, d) per stage
    cases = [(label, 1, c, t, k, d) for label, c, t in STAGES[:3] for (k, d) in K2_CALLS]
    cases += [(label, 4, c, t, k, d) for (label, c, t), (k, d) in zip(STAGES[:3], ((7, 3), (3, 1), (11, 5)))]
    for label, b, c, t, k, d in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = (0.5 * torch.randn(b, c, t, device="cuda", generator=g)).to(dtype)
            alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
            beta = 0.3 * torch.randn(c, device="cuda", generator=g)
            w = (torch.randn(c, c, k, device="cuda", generator=g) / (c * k) ** 0.5).to(dtype)
            bias = (0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
            pad = (k * d - d) // 2
            kern = lambda: k2.fused_aa_snake_dconv(x, alpha, beta, w, bias, d, True)
            plain = lambda: k2.aa_snake_dconv_plain(x, alpha, beta, w, bias, d, True)
            # what the vocoder runs without the switch: K1, then cuDNN's conv in x's dtype
            default = lambda: F.conv1d(k1.fused_anti_alias_snake(x, alpha, beta, True), w, bias, padding=pad,
                                       dilation=d)
            # the wrapper's first call on this weight packs it; the second finds it packed
            call_ms = []
            for _ in range(2):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = kern()
                end.record()
                torch.cuda.synchronize()
                call_ms.append(start.elapsed_time(end))
            ref = plain()
            err = (out.float() - ref.float()).abs()
            ratio = (err / k2.aa_snake_dconv_bound(x, alpha, beta, w, d, ref, alpha_logscale=True)).max().item()
            iters = 5
            ms, plain_ms, default_ms = cuda_time_ms(kern, iters), cuda_time_ms(plain, iters), cuda_time_ms(default, iters)
            dev_ms = device_time_ms(kern, iters)
            dev_plain_ms = device_time_ms(plain, iters)
            dev_default_ms = device_time_ms(default, iters)
            tflops = 2 * k * c * c * t * b / (dev_ms * 1e-3) / 1e12 if dev_ms else None
            row = dict(case=label, B=b, C=c, T=t, k=k, d=d, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err.max().item(), err_over_bound=ratio, ms=ms, plain_ms=plain_ms,
                       default_ms=default_ms, device_ms=dev_ms, device_plain_ms=dev_plain_ms,
                       device_default_ms=dev_default_ms, conv_TFLOPs=tflops, first_call_ms=call_ms[0],
                       second_call_ms=call_ms[1], ok=bool(ratio <= 1.0))
            rows.append(row)
            log(f"[k2] {label} B={b} C={c:3d} T={t:5d} k={k:2d} d={d} {row['dtype']:8s} err={row['max_abs_err']:.3e} "
                f"(err/bound {ratio:.3f}) events: kernel {ms:.4f} plain {plain_ms:.4f} K1+conv {default_ms:.4f} ms"
                f" | device: kernel {fmt(dev_ms)} plain {fmt(dev_plain_ms)} K1+conv {fmt(dev_default_ms)} ms, "
                f"conv {fmt(tflops)} TFLOP/s | wrapper's first call {call_ms[0]:.4f} ms, second {call_ms[1]:.4f} ms"
                f"  [{card}]")
            if not row["ok"]:
                failures.append(row)
            del x, w, out, ref, err
    if failures:
        raise AssertionError(f"K2 disagrees with its plain version: {failures}")
    return {"rows": rows}


def k3_phase(card: str) -> dict:
    """K3's three bodies at the wide stages of a ~100-code vocoder call."""
    import torch

    from indextts_tpu_torch.ops.antialias import activation1d
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3

    g = torch.Generator(device="cuda").manual_seed(1357)
    cases = [(label, b, c, t, dt, True, True) for label, c, t in STAGES[:3] for b in (1, 4)
             for dt in (torch.bfloat16, torch.float32)]
    # odd shapes, checked and not timed: C not a multiple of the row tiles and T
    # of no tile; T of no 16-byte vector (the element-wise path); T shorter than
    # the stencil; T = 4 mod 8 (a tensor-core up n-block ends at sample T - 1);
    # Snake without beta
    cases += [(label, 1, c, t, dt, wb, False) for label, c, t, wb in
              (("odd_c130", 130, 1000, True), ("odd_t1003", 130, 1003, True), ("tiny_t5", 8, 5, True),
               ("odd_t7", 9, 7, True), ("odd_t241", 9, 241, True), ("tiny_t4", 9, 4, True), ("odd_t12", 9, 12, True),
               ("odd_t244", 9, 244, True), ("odd_t1004", 130, 1004, True), ("snake_no_beta", 192, 777, False))
              for dt in (torch.bfloat16, torch.float32)]
    rows, failures = [], []
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for label, b, c, t, dtype, with_beta, timed in cases:
        x = torch.randn(b, c, t, device="cuda", generator=g).to(dtype)
        alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
        beta = 0.3 * torch.randn(c, device="cuda", generator=g) if with_beta else None
        logscale = with_beta
        if not logscale:
            alpha = alpha.abs() + 0.1
        row = dict(case=label, B=b, C=c, T=t, dtype=str(dtype).replace("torch.", ""), bodies={})
        nbytes = 2 * x.numel() * x.element_size()  # the best case: read x once, write z once
        oks = []
        for body, kw in (("taps", {}), ("mma", {"mxu": True}), ("ident", {"probe": "ident"})):
            kern = lambda: k3.fused_anti_alias_snake_tmajor(x, alpha, beta, logscale, **kw)
            plain = lambda: k3.anti_alias_snake_tmajor_plain(x, alpha, beta, logscale, **kw)
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            r = {}
            if body == "ident":
                r["bit_equal"] = bool(torch.equal(out, x))
                r["max_abs_err"] = (out.float() - x.float()).abs().max().item()
                ok = r["bit_equal"]
            else:
                err = (out.float() - ref.float()).abs()
                bound = k3.anti_alias_snake_tmajor_bound(x, alpha, beta, ref, logscale, mxu=body == "mma")
                r["max_abs_err"] = err.max().item()
                r["err_over_bound"] = (err / bound).max().item()
                ok = r["err_over_bound"] <= 1.0
                if dtype == torch.float32:  # the contract: the composed path, exact sin, within 2e-5
                    composed = activation1d(x, alpha, beta, logscale, approx_sin_=False)
                    r["max_abs_err_vs_composed"] = (out - composed).abs().max().item()
                    ok = ok and r["max_abs_err_vs_composed"] <= 2e-5
            if timed:
                iters = 10
                r["ms"] = cuda_time_ms(kern, iters)
                r["own_ms"], r["device_ms"], r["call_kernels"] = own_and_call_ms(kern, iters, K3_KERNEL)
                if body != "ident":
                    r["plain_ms"] = cuda_time_ms(plain, iters)
                    r["device_plain_ms"] = device_time_ms(plain, iters)
                best = r["own_ms"] if r["own_ms"] is not None else r["ms"]
                r["GBps"] = nbytes / (best * 1e-3) / 1e9
            r["ok"] = bool(ok)
            oks.append(ok)
            row["bodies"][body] = r
        if timed:
            k1_fn = lambda: k1.fused_anti_alias_snake(x, alpha, beta, logscale)
            row["k1_ms"] = cuda_time_ms(k1_fn, 10)
            row["k1_own_ms"], row["k1_device_ms"], _ = own_and_call_ms(k1_fn, 10, K1_KERNEL)
        row["ok"] = all(oks)
        rows.append(row)
        bd = row["bodies"]
        line = (f"[k3] {label:14s} B={b} C={c:4d} T={t:6d} {row['dtype']:8s} taps err={bd['taps']['max_abs_err']:.3e} "
                f"(err/bound {bd['taps']['err_over_bound']:.3f}) mma err={bd['mma']['max_abs_err']:.3e} "
                f"(err/bound {bd['mma']['err_over_bound']:.3f}) ident bit-equal {bd['ident']['bit_equal']}")
        if dtype == torch.float32:
            line += (f" | vs composed: taps {bd['taps']['max_abs_err_vs_composed']:.2e} "
                     f"mma {bd['mma']['max_abs_err_vs_composed']:.2e}")
        if timed:
            line += (f" | own device ms: taps {fmt(bd['taps']['own_ms'])} ({bd['taps']['GBps']:.0f} GB/s) mma "
                     f"{fmt(bd['mma']['own_ms'])} ({bd['mma']['GBps']:.0f} GB/s) ident {fmt(bd['ident']['own_ms'])} "
                     f"({bd['ident']['GBps']:.0f} GB/s) K1 {fmt(row['k1_own_ms'])} | whole call: taps "
                     f"{fmt(bd['taps']['device_ms'])} in {bd['taps']['call_kernels']} kernels, ident "
                     f"{fmt(bd['ident']['device_ms'])}, K1 {fmt(row['k1_device_ms'])}, plain {fmt(bd['taps']['device_plain_ms'])}"
                     f" | events ms: taps {bd['taps']['ms']:.4f} mma {bd['mma']['ms']:.4f} ident {bd['ident']['ms']:.4f} "
                     f"K1 {row['k1_ms']:.4f}")
        log(line + f"  [{card}]")
        if not row["ok"]:
            failures.append(row)
        del x
    if failures:
        raise AssertionError(f"K3 disagrees with its plain version: {failures}")
    from indextts_tpu_torch.ops.cuda import build

    ptxas = ptxas_counts(build.build_log(k3.SOURCE), K3_KERNEL)
    for entry, counts in ptxas.items():
        log(f"[k3] ptxas {entry}: {counts}")
    return {"rows": rows, "ptxas": ptxas}


def k4_phase(card: str) -> dict:
    """K4 at the narrow stages (C <= 96) of a ~100-code vocoder call."""
    import torch

    from indextts_tpu_torch.ops.antialias import activation1d
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_folded as k4
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3

    g = torch.Generator(device="cuda").manual_seed(9753)
    dtypes = (torch.bfloat16, torch.float32)
    # (label, B, C, T, dtype, beta given, log-scale parameters, timed)
    cases = [(label, b, c, t, dt, True, True, True) for label, c, t in STAGES[3:6] for b in (1, 4) for dt in dtypes]
    # checked and not timed: Snake without beta, SnakeBeta with plain parameters,
    # C of no tile and T of no chunk, T of no 16-byte vector (1003: neither
    # dtype; 1004: float32 only), T shorter than the stencil, T = 1
    cases += [(label, 1, c, t, dt, wb, ls, False) for label, c, t, wb, ls in
              (("snake_no_beta", 96, 777, False, False), ("snakebeta_plain", 48, 2048, True, False),
               ("odd_c25", 25, 1000, True, True), ("odd_t1003", 25, 1003, True, True),
               ("odd_t1004", 25, 1004, True, True), ("tiny_t5", 8, 5, True, True), ("tiny_t1", 3, 1, True, True))
              for dt in dtypes]
    rows, failures = [], []
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for label, b, c, t, dtype, with_beta, logscale, timed in cases:
        x = torch.randn(b, c, t, device="cuda", generator=g).to(dtype)
        alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
        beta = 0.3 * torch.randn(c, device="cuda", generator=g) if with_beta else None
        if not logscale:
            alpha = alpha.abs() + 0.1
            beta = None if beta is None else beta.abs() + 0.1
        kern = lambda: k4.fused_folded_aa(x, alpha, beta, logscale)
        plain = lambda: k4.fused_folded_aa_plain(x, alpha, beta, logscale)
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs()
        bound = k4.fused_folded_aa_bound(x, alpha, beta, ref, logscale)
        ratio = (err / bound).max().item()
        row = dict(case=label, B=b, C=c, T=t, dtype=str(dtype).replace("torch.", ""), beta=with_beta,
                   logscale=logscale, max_abs_err=err.max().item(), err_over_bound=ratio)
        if ratio > 1.0:  # where, for the failure message
            at = int((err / bound).argmax())
            row["worst"] = dict(index=at, out=out.flatten()[at].item(), ref=ref.flatten()[at].item(),
                                bound=bound.flatten()[at].item(), channel=(at // t) % c,
                                alpha=alpha[(at // t) % c].item(), beta=None if beta is None else beta[(at // t) % c].item())
        ok = ratio <= 1.0
        if dtype == torch.float32:  # the contract: the composed path, exact sin, within 2e-5
            composed = activation1d(x, alpha, beta, logscale, approx_sin_=False)
            row["max_abs_err_vs_composed"] = (out - composed).abs().max().item()
            ok = ok and row["max_abs_err_vs_composed"] <= 2e-5
        if timed:
            iters = 10
            others = {"k1": (lambda: k1.fused_anti_alias_snake(x, alpha, beta, logscale), K1_KERNEL),
                      "k3_ident": (lambda: k3.fused_anti_alias_snake_tmajor(x, alpha, beta, logscale, probe="ident"),
                                   K3_KERNEL)}
            row["ms"] = cuda_time_ms(kern, iters)
            row["own_ms"], row["device_ms"], row["call_kernels"] = own_and_call_ms(kern, iters, K4_KERNEL)
            row["plain_ms"], row["device_plain_ms"] = cuda_time_ms(plain, iters), device_time_ms(plain, iters)
            for name, (fn, kname) in others.items():
                row[f"{name}_ms"] = cuda_time_ms(fn, iters)
                row[f"{name}_own_ms"], row[f"{name}_device_ms"], _ = own_and_call_ms(fn, iters, kname)
            best = row["own_ms"] if row["own_ms"] is not None else row["ms"]
            row["GBps"] = 2 * x.numel() * x.element_size() / (best * 1e-3) / 1e9  # x read once, z written once
        row["ok"] = bool(ok)
        rows.append(row)
        line = (f"[k4] {label:15s} B={b} C={c:3d} T={t:6d} {row['dtype']:8s} beta={with_beta!s:5s} log={logscale!s:5s} "
                f"err={row['max_abs_err']:.3e} (err/bound {ratio:.3f})")
        if dtype == torch.float32:
            line += f" vs composed {row['max_abs_err_vs_composed']:.2e}"
        if timed:
            line += (f" | own device ms: K4 {fmt(row['own_ms'])} ({row['GBps']:.0f} GB/s) K1 {fmt(row['k1_own_ms'])} "
                     f"K3 ident {fmt(row['k3_ident_own_ms'])} | whole call: K4 {fmt(row['device_ms'])} in "
                     f"{row['call_kernels']} kernels, K1 {fmt(row['k1_device_ms'])}, K3 ident "
                     f"{fmt(row['k3_ident_device_ms'])}, plain {fmt(row['device_plain_ms'])} | events ms: K4 "
                     f"{row['ms']:.4f} K1 {row['k1_ms']:.4f} K3 ident {row['k3_ident_ms']:.4f} plain {row['plain_ms']:.4f}")
        log(line + f"  [{card}]")
        if not row["ok"]:
            failures.append(row)
        del x
    if failures:
        raise AssertionError(f"K4 disagrees with its plain version: {failures}")
    return {"rows": rows}


def k5_bound(x, wq, scale, ref):
    """Both sides sum exact bf16 x int8 products in float32, so they differ
    only in the order of the sum: 1e-5 of (|bf16(x)| @ |wq|) * scale. A bf16
    output is rounded twice, before and after the bias add (as the JAX
    kernel does), so either side may round the other way each time: one bf16
    ulp of the pre-bias value and two of the output on top."""
    import torch

    xb, w = x.to(torch.bfloat16).float(), wq.float()
    bound = 1e-5 * (xb.abs() @ w.abs().t()) * scale
    if ref.dtype == torch.bfloat16:
        ulp = lambda v: torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)
        bound = bound + ulp((xb @ w.t()) * scale) + 2 * ulp(ref.float())
    return bound


K5_MS = (1, 3, 4, 8, 15, 16)  # decode batches: greedy, 3 beams, slots, 5 rows x 3 beams, a full tile


def k5_phase(card: str) -> dict:
    """K5 at the five GPT matmul shapes, M in K5_MS, bf16 and float32: err
    against k5_bound, two runs on the same input bit-equal (the reduction is
    in a fixed order), device times with the weights cycled past the L2 cache
    (bf16 at every M, float32 at M = 4), and F.linear on the dequantized bf16
    weight at the same shape as a yardstick (another function: twice the
    bytes). Then tails, checked and not timed: K not a multiple of 16, and a
    weight view that is not 16-byte aligned."""
    import itertools

    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.cuda import qmatmul as k5

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4321)
    rows, failures = [], []
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"

    def check(x, wq, scale, bias):
        out = k5.int8_matmul(x, wq, scale, bias)
        again = k5.int8_matmul(x, wq, scale, bias)
        torch.cuda.synchronize()
        ref = k5.int8_matmul_plain(x, wq, scale, bias)
        err = (out.float() - ref.float()).abs()
        return err.max().item(), (err / k5_bound(x, wq, scale, ref)).max().item(), bool(torch.equal(out, again))

    for label, k, n in K5_SHAPES:
        # copies of the weight past the 50 MB L2 cache, cycled: each launch
        # streams its weight from device memory, as in a decode step
        copies = max(2, -(-100_000_000 // (n * k)))
        ws = [torch.randint(-127, 128, (n, k), device="cuda", generator=g, dtype=torch.int32).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, device="cuda", generator=g) * 1e-3 + 1e-4
        wb = [(w.float() * scale[:, None]).to(torch.bfloat16) for w in ws]  # the yardstick's bf16 weights
        for m in K5_MS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
                bias = (0.1 * torch.randn(n, device="cuda", generator=g)).to(dtype)
                max_err, ratio, same = check(x, ws[0], scale, bias)
                it, itb = itertools.cycle(ws), itertools.cycle(wb)
                kern = lambda: k5.int8_matmul(x, next(it), scale, bias)
                plain = lambda: k5.int8_matmul_plain(x, next(it), scale, bias)
                linear = lambda: F.linear(x, next(itb), bias)
                iters = 2 * copies
                ms = cuda_time_ms(kern, iters)
                plain_ms = cuda_time_ms(plain, iters)
                timed = dtype == torch.bfloat16 or m == 4
                dev_ms = device_time_ms(kern, iters) if timed else None
                dev_plain_ms = device_time_ms(plain, iters) if timed else None
                linear_ms = device_time_ms(linear, iters) if dtype == torch.bfloat16 else None
                gbps = n * k / (dev_ms * 1e-3) / 1e9 if dev_ms else None
                row = dict(case=label, M=m, K=k, N=n, dtype=str(dtype).replace("torch.", ""),
                           max_abs_err=max_err, err_over_bound=ratio, bit_equal_runs=same, ms=ms, plain_ms=plain_ms,
                           device_ms=dev_ms, device_plain_ms=dev_plain_ms, bf16_linear_ms=linear_ms,
                           weight_GBps=gbps, ok=bool(ratio <= 1.0 and same))
                rows.append(row)
                log(f"[k5] {label:8s} M={m:2d} K={k:4d} N={n:4d} {row['dtype']:8s} err={max_err:.3e} "
                    f"(err/bound {ratio:.3f}) two runs bit-equal {same} | events: kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms | device: kernel {fmt(dev_ms)} ms plain {fmt(dev_plain_ms)} ms, bf16 F.linear "
                    f"{fmt(linear_ms)} ms, {fmt(gbps)} GB/s of int8 weights  [{card}]")
                if not row["ok"]:
                    failures.append(row)
        del ws, wb
    # tails: K % 16 != 0 (byte loads of the weight; K = 1288 also has no whole
    # 64-k step at its end), and a weight view one byte off a 16-byte boundary
    for label, k, n, offset in (("odd_k1288", 1288, 1280, 0), ("odd_k50_n70", 50, 70, 0), ("unaligned_w", 1280, 1280, 1)):
        flat = torch.randint(-127, 128, (n * k + offset,), device="cuda", generator=g, dtype=torch.int32).to(torch.int8)
        wq = flat[offset:].view(n, k)
        if offset and wq.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned weight view is aligned")
        scale = torch.rand(n, device="cuda", generator=g) * 1e-3 + 1e-4
        for m in (3, 16):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
                bias = (0.1 * torch.randn(n, device="cuda", generator=g)).to(dtype)
                max_err, ratio, same = check(x, wq, scale, bias)
                row = dict(case=label, M=m, K=k, N=n, dtype=str(dtype).replace("torch.", ""), max_abs_err=max_err,
                           err_over_bound=ratio, bit_equal_runs=same, ok=bool(ratio <= 1.0 and same))
                rows.append(row)
                log(f"[k5] {label:12s} M={m:2d} K={k:4d} N={n:4d} {row['dtype']:8s} err={max_err:.3e} (err/bound "
                    f"{ratio:.3f}) two runs bit-equal {same}  [{card}]")
                if not row["ok"]:
                    failures.append(row)
    if failures:
        raise AssertionError(f"K5 disagrees with its plain version, or two runs differ: {failures}")
    return {"rows": rows}


def flagship_engine(quant_kv: bool = False, fast_latents: bool = False):
    from indextts_tpu_torch.engine import IndexTTS

    # configs/ holds no bpe.model: the engine builds its random-init tokenizer
    return IndexTTS(cfg_path=FLAGSHIP, model_dir=os.path.join(REPO, "configs"), is_fp16=True, device="cuda",
                    use_cuda_kernel=True, allow_random_init=True, seed=0, quant_kv=quant_kv,
                    fast_latents=fast_latents)


def engine_phase(card: str) -> dict:
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1

    t0 = time.perf_counter()
    engine = flagship_engine()
    h = engine.cfg.bigvgan
    if len(h.upsample_rates) * sum(2 * len(d) for d in h.resblock_dilation_sizes) + 1 != 109:
        raise AssertionError(f"{FLAGSHIP} is not the published vocoder (109 activations per call)")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[engine] flagship built in {init_s:.1f} s: GPT {engine.cfg.gpt.layers}x{engine.cfg.gpt.model_dim}, "
        f"BigVGAN {engine.cfg.bigvgan.upsample_initial_channel} ch, {engine.dtype}")

    vocoded = []
    vocode = engine._vocode

    def recording_vocode(latent, n_valid, prompt_mel):
        wav = vocode(latent, n_valid, prompt_mel)
        vocoded.append((n_valid, wav))
        return wav

    engine._vocode = recording_vocode
    # a first, cold request: CUDA context, cuBLAS / cuDNN handles and their
    # per-shape choices, the allocator; reported, not part of the measured run
    t = time.perf_counter()
    engine.infer(audio_prompt=PROMPT, text="WARM UP.", num_beams=1, do_sample=True, max_mel_tokens=200)
    cold_s = time.perf_counter() - t
    log(f"[engine] cold first request: {cold_s:.2f} s, {engine.last_stats['audio_s']:.2f} s audio [{card}]")
    vocoded.clear()
    engine._value_cache.clear()  # the measured run computes its conditioning anew

    requests = [
        ("greedy", dict(text="HELLO WORLD.", do_sample=False, num_beams=1, max_mel_tokens=200)),
        ("sampled", dict(text="THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG.", do_sample=True, top_k=30,
                         top_p=0.8, repetition_penalty=10.0, num_beams=1, max_mel_tokens=200)),
        ("two_sentences", dict(text="HELLO WORLD. THIS IS A TEST.", do_sample=True, num_beams=1,
                               max_mel_tokens=200, max_text_tokens_per_sentence=16)),
    ]
    k1.launches = 0  # the main path's run starts here
    results, vocoder_calls = [], 0
    for name, kw in requests:
        start = len(vocoded)
        sr, wav = engine.infer(audio_prompt=PROMPT, **kw)
        st = dict(engine.last_stats)
        these = vocoded[start:]
        vocoder_calls += st["vocoder_calls"]
        n_codes = sum(n for n, _ in these)
        for n, w in these:
            if not np.isfinite(w).all():
                raise AssertionError(f"{name}: non-finite samples in the vocoder output")
            if w.shape[1] != n * engine._samples_per_code():
                raise AssertionError(f"{name}: wav of {w.shape[1]} samples for {n} codes")
        if wav.shape[0] != n_codes * engine._samples_per_code():
            raise AssertionError(f"{name}: returned wav {wav.shape} for {n_codes} codes")
        if name == "sampled" and n_codes < 1:
            raise AssertionError("sampled request produced no codes")
        if name == "two_sentences" and st["vocoder_calls"] != 2:
            raise AssertionError(f"two_sentences ran {st['vocoder_calls']} vocoder calls, not 2")
        ms_step = 1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1)
        row = dict(request=name, codes=n_codes, audio_s=st["audio_s"], cond_ms=1e3 * st["cond_s"],
                   decode_ms_per_step=ms_step, decode_steps=st["gpt_steps"], latent_ms=1e3 * st["gpt_forward_s"],
                   vocoder_ms=1e3 * st["bigvgan_s"], total_s=st["total_s"], rtf=st["rtf"])
        results.append(row)
        log(f"[engine] {name}: {n_codes} codes, {st['audio_s']:.2f} s audio | cond {row['cond_ms']:.1f} ms, "
            f"decode {ms_step:.2f} ms/step over {st['gpt_steps']} steps (prefill included), "
            f"latent {row['latent_ms']:.1f} ms, vocoder {row['vocoder_ms']:.1f} ms, total {st['total_s']:.2f} s, "
            f"RTF {st['rtf']:.4f} [{card}]")
    launches = k1.launches
    h = engine.cfg.bigvgan
    # two activations per dilation in each AMPBlock1, per resblock, per stage, plus activation_post
    per_call = len(h.upsample_rates) * sum(2 * len(d) for d in h.resblock_dilation_sizes) + 1
    want = per_call * vocoder_calls
    log(f"[engine] K1 launches {launches} over {vocoder_calls} vocoder calls (want {per_call} x {vocoder_calls})")
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times, want {per_call} x {vocoder_calls} = {want}")

    # vocoder stage with K1 and with the composed activations, in turns
    latent = torch.randn(1, 112, engine.cfg.gpt.model_dim, device="cuda", dtype=engine.dtype,
                         generator=torch.Generator(device="cuda").manual_seed(5))
    mel = engine.extract_features(PROMPT)
    times = {True: [], False: []}
    for use in (False, True, True, False):
        engine.use_cuda_kernel = use
        torch.cuda.synchronize()
        t = time.perf_counter()
        vocode(latent, 112, mel)
        times[use].append(1e3 * (time.perf_counter() - t))
    engine.use_cuda_kernel = True
    ab = {"kernel_ms": times[True], "composed_ms": times[False]}
    log(f"[engine] vocoder, 112 codes, {engine.dtype}: K1 {times[True]} ms, composed {times[False]} ms [{card}]")
    prof = vocoder_profile(engine)
    log(f"[engine] one profiled bigvgan_apply, {prof['codes']} codes, B=1, {engine.dtype}, default route: "
        f"{vocoder_profile_line(prof)} [{card}]")
    return {"init_s": init_s, "cold_first_request_s": cold_s, "requests": results, "k1_launches": launches, "vocoder_calls": vocoder_calls,
            "vocoder_ab": ab, "vocoder_profile": prof}


def vocoder_profile(engine, codes: int = 100) -> dict:
    """One bigvgan_apply of a `codes`-code latent (the STAGES shapes), B = 1,
    in the engine's dtype, on the route the environment selects: host ms
    (synchronized, the least of three), the device ms and kernels of one call
    under torch.profiler, the device-idle share, and the own device ms of K1,
    K3 and K4 with the `exp` kernels launched beside them."""
    import torch

    from indextts_tpu_torch.models import bigvgan

    g = torch.Generator(device="cuda").manual_seed(5)
    latent = torch.randn(1, codes, engine.cfg.gpt.model_dim, device="cuda", dtype=engine.dtype, generator=g)
    mel_ref, lens = engine._mel_ref_for(engine.extract_features(PROMPT), 1)
    call = lambda: bigvgan.bigvgan_apply(engine.bigvgan, engine.cfg.bigvgan, latent, mel_ref, lens=lens,
                                         use_cuda_kernel=True)
    host = []
    with torch.no_grad():
        call()
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t))
        prof = device_profile(call, 1, (K1_KERNEL, K3_KERNEL, K4_KERNEL))
    out = {"codes": codes, "host_ms": min(host), "host_ms_runs": host}
    if prof is not None:
        out.update(device_ms=prof["call_ms"], kernels=prof["kernels"], exp_kernels=prof["exp_kernels"],
                   device_idle_share=1.0 - prof["call_ms"] / min(host),
                   own_ms={"k1": prof["own_ms"][K1_KERNEL], "k3": prof["own_ms"][K3_KERNEL],
                           "k4": prof["own_ms"][K4_KERNEL]})
    return out


def vocoder_profile_line(v: dict) -> str:
    if "device_ms" not in v:
        return f"host {v['host_ms']:.2f} ms, device not measured"
    own = ", ".join(f"{k.upper()} {ms:.4f}" for k, ms in v["own_ms"].items() if ms > 0)
    return (f"host {v['host_ms']:.2f} ms (runs {[round(h, 2) for h in v['host_ms_runs']]}), device {v['device_ms']:.4f} ms "
            f"in {v['kernels']:.0f} kernels ({v['exp_kernels']:.0f} exp), device idle {100 * v['device_idle_share']:.1f} %; "
            f"own device ms {own}")


def forced_logits(engine, quant_kv: bool, steps: int = 16):
    """Prefill and `steps` forced decode steps at B = 4, text rows of
    different lengths, the tokens drawn from a fixed seed. Returns the logits
    [steps + 1, B, V] (float32, on the host) and a profile of the steps: host
    ms per step (second run, synchronized), device ms per step and device
    kernels per step (third run, torch.profiler)."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.models import gpt_decode as tdec

    cfg = engine.cfg.gpt
    r = np.random.default_rng(7)
    lens = np.asarray([12, 9, 16, 5])
    text = np.full((4, 16), cfg.stop_text_token, np.int64)
    for i, n in enumerate(lens):
        text[i, :n] = r.integers(0, cfg.number_text_tokens - 1, n)
    dev = engine.device
    forced = torch.from_numpy(r.integers(0, cfg.start_mel_token, (4, steps))).to(dev)
    conds = engine._conds_for(engine.extract_features(PROMPT)).expand(4, -1, -1)

    def run(ctx):
        with torch.no_grad():
            emb, mask = tdec.prepare_gpt_inputs(engine.gpt, cfg, conds, torch.from_numpy(text).to(dev),
                                                torch.from_numpy(lens).to(dev))
            p = emb.shape[1]
            logits, cache = tdec._prefill(engine.gpt, cfg, emb, mask, p + steps, quant_kv=quant_kv)
            outs = [logits.float()]
            pv = torch.nn.functional.pad(mask, (0, steps))
            pos = torch.arange(p + steps, device=dev)[None, :]
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx:
                for i in range(steps):
                    valid = pv | ((pos >= p) & (pos < p + i))
                    outs.append(tdec._decode_step(engine.gpt, cfg, forced[:, i], i + 2, cache, p + i, valid).float())
                torch.cuda.synchronize()
            return torch.stack(outs).cpu().numpy(), 1e3 * (time.perf_counter() - t) / steps

    logits, _ = run(contextlib.nullcontext())
    _, host_ms = run(contextlib.nullcontext())
    prof = profile(activities=[ProfilerActivity.CUDA])
    run(prof)  # the profiler covers the decode steps only
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    kernels = sum(e.count for e in events) / steps
    return logits, {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                    "device_kernels_per_step": kernels, "device_idle_share": 1.0 - device_ms / host_ms}


def int8_phase(card: str) -> dict:
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import qmatmul as k5
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    t0 = time.perf_counter()
    engine = flagship_engine(quant_kv=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    base, prof_bf16 = forced_logits(engine, quant_kv=False)
    kv8, prof_kv8 = forced_logits(engine, quant_kv=True)
    quantize_unified_voice(engine.gpt)
    w8kv8, prof_w8kv8 = forced_logits(engine, quant_kv=True)
    drift = {"int8_kv": float(np.abs(kv8 - base).max()), "int8_kv_int8_weights": float(np.abs(w8kv8 - base).max()),
             "max_abs_logit_bf16": float(np.abs(base).max()),
             "argmax_agree_int8_kv": float((kv8.argmax(-1) == base.argmax(-1)).mean()),
             "argmax_agree_int8_kv_int8_weights": float((w8kv8.argmax(-1) == base.argmax(-1)).mean())}
    step_profile = {"bf16": prof_bf16, "int8_kv": prof_kv8, "int8_kv_int8_weights": prof_w8kv8}
    log(f"[int8] flagship built in {init_s:.1f} s; max |logit| drift over prefill + 16 forced steps, B=4, against "
        f"the bf16 cache: int8 KV {drift['int8_kv']:.5f}, int8 KV + int8 weights "
        f"{drift['int8_kv_int8_weights']:.5f} (max |logit| {drift['max_abs_logit_bf16']:.4f}; argmax agreement "
        f"{drift['argmax_agree_int8_kv']:.3f} / {drift['argmax_agree_int8_kv_int8_weights']:.3f}) [{card}]")
    for name, pr in step_profile.items():
        log(f"[int8] forced decode step, B=4, {name}: host {pr['host_ms_per_step']:.2f} ms/step, device "
            f"{pr['device_ms_per_step']:.3f} ms/step in {pr['device_kernels_per_step']:.0f} kernels, device idle "
            f"{100 * pr['device_idle_share']:.1f} % [{card}]")
    if not np.isfinite(w8kv8).all() or not drift["int8_kv"] < 1.0:
        raise AssertionError(f"int8 KV logit drift {drift['int8_kv']} is not under JAX's gate of 1.0 (bench.py:280)")

    vocoded = []
    for name in ("_vocode", "_vocode_many"):
        fn = getattr(engine, name)

        def recording(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            n_valid = [a[1]] if _name == "_vocode" else [c[1] for c in a[0]]
            vocoded.extend(zip(n_valid, out if _name == "_vocode_many" else [out]))
            return out

        setattr(engine, name, recording)
    # a first, cold request of the int8 path: reported, not part of the measured run
    t = time.perf_counter()
    engine.infer_fast(audio_prompt=PROMPT, text="WARM UP. WARM UP AGAIN.", num_beams=1, do_sample=True,
                      max_mel_tokens=200, max_text_tokens_per_sentence=16)
    cold_s = time.perf_counter() - t
    vocoded.clear()
    requests = [
        ("fast_sampled", "infer_fast", dict(text=FOUR_SENTENCES, do_sample=True, top_k=30, top_p=0.8,
                                            repetition_penalty=10.0, num_beams=1, max_mel_tokens=200,
                                            max_text_tokens_per_sentence=16)),
        ("greedy", "infer", dict(text="HELLO WORLD.", do_sample=False, num_beams=1, max_mel_tokens=200)),
    ]
    spc = engine._samples_per_code()
    k1.launches = k5.launches = 0  # the int8 path's run starts here
    results, gen_calls, gen_steps, vocoder_calls = [], 0, 0, 0
    for name, method, kw in requests:
        start = len(vocoded)
        sr, wav = getattr(engine, method)(audio_prompt=PROMPT, **kw)
        st = dict(engine.last_stats)
        gen_calls += st["gpt_calls"]
        gen_steps += st["gpt_steps"]
        vocoder_calls += st["vocoder_calls"]
        n_codes = sum(n for n, _ in vocoded[start:])
        for n, w in vocoded[start:]:
            if w.shape[1] != n * spc or (w.dtype != np.int16 and not np.isfinite(w).all()):
                raise AssertionError(f"{name}: vocoder output {w.shape} {w.dtype} for {n} codes")
        if wav.shape[0] != n_codes * spc or n_codes < 1:
            raise AssertionError(f"{name}: returned wav {wav.shape} for {n_codes} codes")
        if method == "infer_fast" and st["decode_batches"] != [4]:
            raise AssertionError(f"{name}: decode batches {st['decode_batches']}, want one batch of 4")
        row = dict(request=name, method=method, codes=n_codes, audio_s=st["audio_s"], cond_ms=1e3 * st["cond_s"],
                   decode_batches=st.get("decode_batches", [1]), decode_steps=st["gpt_steps"],
                   decode_ms_per_step=1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1),
                   latent_ms=1e3 * st["gpt_forward_s"], vocoder_ms=1e3 * st["bigvgan_s"],
                   vocoder_calls=st["vocoder_calls"], total_s=st["total_s"], rtf=st["rtf"])
        results.append(row)
        log(f"[int8] {name} ({method}, batches {row['decode_batches']}): {n_codes} codes, {st['audio_s']:.2f} s "
            f"audio | cond {row['cond_ms']:.1f} ms, decode {row['decode_ms_per_step']:.2f} ms/step over "
            f"{st['gpt_steps']} steps (prefill included), latent {row['latent_ms']:.1f} ms, vocoder "
            f"{row['vocoder_ms']:.1f} ms in {st['vocoder_calls']} call(s), total {st['total_s']:.2f} s, "
            f"RTF {st['rtf']:.4f} [{card}]")
    per_step = 4 * engine.cfg.gpt.layers + 1
    want_k5 = gen_calls + per_step * gen_steps
    h = engine.cfg.bigvgan
    per_voc = len(h.upsample_rates) * sum(2 * len(d) for d in h.resblock_dilation_sizes) + 1
    want_k1 = per_voc * vocoder_calls
    log(f"[int8] K5 launches {k5.launches} (want {gen_calls} + {per_step} x {gen_steps} = {want_k5}); "
        f"K1 launches {k1.launches} (want {per_voc} x {vocoder_calls} = {want_k1})")
    if k5.launches != want_k5 or k1.launches != want_k1:
        raise AssertionError(f"launch counts: K5 {k5.launches} (want {want_k5}), K1 {k1.launches} (want {want_k1})")
    return {"init_s": init_s, "cold_first_request_s": cold_s, "drift": drift, "step_profile": step_profile,
            "requests": results,
            "k5_launches": k5.launches, "k1_launches": k1.launches, "generate_calls": gen_calls,
            "decode_steps": gen_steps, "vocoder_calls": vocoder_calls}


def forced_beam_steps(engine, steps: int = 16, max_new: int = 200) -> dict:
    """Prefill one sentence and run `steps` beam steps (num_beams = 3, the
    default sampled settings) against a cache sized for max_new codes, as
    generate_speech_beam runs them: the decode step, the successor choice,
    the cache reorder. Host ms per step (second run, synchronized), device ms
    and kernels per step (third run, torch.profiler), and the device time of
    the cache reorder alone (index_select of every cache tensor)."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.models import gpt_decode as tdec

    cfg = engine.cfg.gpt
    nb, dev = 3, engine.device
    text = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.number_text_tokens - 1, (1, 16))).to(dev)
    conds = engine._conds_for(engine.extract_features(PROMPT))
    gen = tdec.GenerationConfig(do_sample=True, num_beams=nb, top_k=30, max_new_tokens=max_new)
    g = torch.Generator(device=dev).manual_seed(0)

    def joint_fn(logits, seen, scores):
        return tdec._beam_joint_scores(logits, seen, scores, gen, 1.0, 0.8, 10.0, 0.9)

    def run(ctx):
        with torch.no_grad():
            emb, mask = tdec.prepare_gpt_inputs(engine.gpt, cfg, conds, text, torch.tensor([16], device=dev))
            p = emb.shape[1]
            logits, cache = tdec._prefill(engine.gpt, cfg, emb, mask, p + max_new)
            cache = tuple(c.repeat_interleave(nb, dim=1) for c in cache)
            logits = logits.repeat_interleave(nb, dim=0)
            pv = torch.nn.functional.pad(mask, (0, max_new)).repeat_interleave(nb, dim=0)
            pos = torch.arange(p + max_new, device=dev)[None, :]
            codes = torch.full((nb, max_new), cfg.stop_mel_token, dtype=torch.long, device=dev)
            scores = torch.tensor([0.0] + [tdec.NEG_INF] * (nb - 1), device=dev)
            seen = tdec._initial_seen(cfg, nb, dev)
            best = tdec.BeamBest(torch.full((1,), tdec.NEG_INF, device=dev), codes[:1].clone(),
                                 torch.zeros(1, dtype=torch.long, device=dev))
            select = lambda cand: tdec._select_successors(cand, g, gen, nb)
            codes, scores, seen, _, cur = tdec._beam_step(cfg, gen, 0, logits, codes, scores, seen, best, joint_fn,
                                                          select, 1, nb, prefill_len=p)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx:
                for i in range(steps):
                    valid = pv | ((pos >= p) & (pos < p + i))
                    logits = tdec._decode_step(engine.gpt, cfg, cur, i + 2, cache, p + i, valid)
                    codes, scores, seen, src, cur = tdec._beam_step(cfg, gen, i + 1, logits, codes, scores, seen,
                                                                    best, joint_fn, select, 1, nb, prefill_len=p)
                    cache = tuple(c.index_select(1, src) for c in cache)
                torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t) / steps, cache, src

    run(contextlib.nullcontext())
    host_ms, cache, src = run(contextlib.nullcontext())
    prof = profile(activities=[ProfilerActivity.CUDA])
    run(prof)
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    kernels = sum(e.count for e in events) / steps
    reorder_ms = device_time_ms(lambda: tuple(c.index_select(1, src) for c in cache), steps)
    nbytes = sum(c.numel() * c.element_size() for c in cache)
    return {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms, "device_kernels_per_step": kernels,
            "device_idle_share": 1.0 - device_ms / host_ms, "reorder_device_ms": reorder_ms,
            "reorder_share_of_device": None if reorder_ms is None else reorder_ms / device_ms,
            "cache_bytes": nbytes, "rows": nb, "cache_slots": int(cache[0].shape[3])}


def beam_phase(card: str) -> dict:
    """The slice's main path: beam search (the engine's default kwargs) with
    fast_latents, and the vocoder with INDEXTTS_WIDE_BRANCH=1 (K2 at the wide
    half-branches, K1 at the rest), at the published width."""
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
    from indextts_tpu_torch.ops.cuda import antialias as k1

    os.environ["INDEXTTS_WIDE_BRANCH"] = "1"
    try:
        t0 = time.perf_counter()
        engine = flagship_engine(fast_latents=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        h = engine.cfg.bigvgan
        stages_wide = sum(1 for i in range(len(h.upsample_rates)) if h.upsample_initial_channel // 2 ** (i + 1) >= 128)
        per_block = sum(2 * len(d) for d in h.resblock_dilation_sizes)
        want_k2, want_k1 = stages_wide * per_block, (len(h.upsample_rates) - stages_wide) * per_block + 1
        if (want_k2, want_k1) != (54, 55):
            raise AssertionError(f"{FLAGSHIP}: {want_k2} K2 and {want_k1} K1 calls per vocoder call, want 54 and 55")
        # a first, cold request of the path: reported, not part of the measured run
        t = time.perf_counter()
        engine.infer(audio_prompt=PROMPT, text="WARM UP.", max_mel_tokens=200)
        cold_s = time.perf_counter() - t
        log(f"[beam] flagship built in {init_s:.1f} s; cold first beam request {cold_s:.2f} s [{card}]")
        requests = [
            ("default_infer", "infer", False, dict(text="HELLO WORLD.", max_mel_tokens=200)),
            ("default_infer_fast", "infer_fast", False, dict(text="HELLO WORLD. THIS IS A TEST.", max_mel_tokens=200,
                                                              max_text_tokens_per_sentence=16)),
            ("greedy_int8_kv", "infer", True, dict(text="HELLO WORLD.", do_sample=False, max_mel_tokens=200)),
            # 320 = two segments of 160: the engine takes generate_speech_beam_segmented
            ("default_infer_320", "infer", False, dict(text="HELLO WORLD.", max_mel_tokens=320)),
        ]
        spc = engine._samples_per_code()
        results, k1_total, k2_total = [], 0, 0
        for name, method, quant_kv, kw in requests:
            engine.quant_kv = quant_kv
            k1.launches = k2.launches = 0  # this request of the main path starts here
            sr, wav = getattr(engine, method)(audio_prompt=PROMPT, **kw)
            launches = {"k1": k1.launches, "k2": k2.launches}
            st = dict(engine.last_stats)
            k1_total += launches["k1"]
            k2_total += launches["k2"]
            calls = st["vocoder_calls"]
            if launches != {"k1": 55 * calls, "k2": 54 * calls}:
                raise AssertionError(f"{name}: launches {launches} over {calls} vocoder calls, want 55 and 54 each")
            if wav.shape[0] < spc or wav.shape[0] % spc or not np.isfinite(wav).all():
                raise AssertionError(f"{name}: returned wav {wav.shape}")
            if method == "infer_fast" and st["decode_batches"] != [2]:
                raise AssertionError(f"{name}: decode batches {st['decode_batches']}, want one batch of 2")
            want_segments = 2 if kw["max_mel_tokens"] >= 320 else 0
            if st["gpt_segments"] != want_segments:
                raise AssertionError(f"{name}: the decode ran {st['gpt_segments']} segments, want {want_segments}")
            row = dict(request=name, method=method, quant_kv=quant_kv, codes=wav.shape[0] // spc,
                       segments=st["gpt_segments"],
                       audio_s=st["audio_s"], cond_ms=1e3 * st["cond_s"], decode_steps=st["gpt_steps"],
                       decode_ms_per_step=1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1),
                       latent_ms=1e3 * st["gpt_forward_s"], teacher_forced_rows=st["tf_latent_rows"],
                       teacher_forced_skipped=st["tf_latent_rows"] == 0, vocoder_ms=1e3 * st["bigvgan_s"],
                       vocoder_calls=calls, k1_launches=launches["k1"], k2_launches=launches["k2"],
                       total_s=st["total_s"], rtf=st["rtf"])
            results.append(row)
            log(f"[beam] {name} ({method}, num_beams 3{', int8 KV' if quant_kv else ''}): {row['codes']} codes, "
                f"{st['audio_s']:.2f} s audio | cond {row['cond_ms']:.1f} ms, decode {row['decode_ms_per_step']:.2f} "
                f"ms/step over {st['gpt_steps']} steps in {st['gpt_segments'] or 'no'} segments, latent "
                f"{row['latent_ms']:.1f} ms (teacher-forced rows "
                f"{st['tf_latent_rows']}), vocoder {row['vocoder_ms']:.1f} ms in {calls} call(s), total "
                f"{st['total_s']:.2f} s, RTF {st['rtf']:.4f}; K2 {launches['k2']}, K1 {launches['k1']} launches [{card}]")
        engine.quant_kv = False
        step = forced_beam_steps(engine)
        log(f"[beam] forced beam step, B=1 x 3 beams, {step['cache_slots']} cache slots: host "
            f"{step['host_ms_per_step']:.2f} ms/step, device {step['device_ms_per_step']:.3f} ms/step in "
            f"{step['device_kernels_per_step']:.0f} kernels, device idle {100 * step['device_idle_share']:.1f} %, "
            f"cache reorder {step['reorder_device_ms']} ms of device time ({step['cache_bytes'] / 1e6:.1f} MB) [{card}]")
    finally:
        del os.environ["INDEXTTS_WIDE_BRANCH"]
    return {"init_s": init_s, "cold_first_request_s": cold_s, "requests": results, "forced_step": step,
            "k1_launches": k1_total, "k2_launches": k2_total}


def stream_phase(card: str) -> dict:
    """This slice's main path: infer_stream at the published width with
    INDEXTTS_WIDE_TMAJOR=1, K3 at the 54 wide activations of every vocoder
    call and K1 at the other 55."""
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3

    os.environ["INDEXTTS_WIDE_TMAJOR"] = "1"
    try:
        t0 = time.perf_counter()
        engine = flagship_engine()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        spc = engine._samples_per_code()
        kw = dict(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=True, max_mel_tokens=200)
        # a first, cold stream: reported, not part of the measured run
        t = time.perf_counter()
        cold = sum(c.size for c in engine.infer_stream(**kw))
        cold_s = time.perf_counter() - t
        log(f"[stream] flagship built in {init_s:.1f} s; cold first stream {cold_s:.2f} s, TTFA "
            f"{engine.last_stats['ttfa_s']:.3f} s, {cold // spc} codes [{card}]")
        results, k1_total, k3_total = [], 0, 0
        for name, fast, mxu in (("teacher_forced", False, False), ("fast_latents", True, False),
                                ("teacher_forced_mxu", False, True)):
            engine.fast_latents = fast
            if mxu:
                os.environ["INDEXTTS_WIDE_TMAJOR_MXU"] = "1"
            try:
                k1.launches = k3.launches = 0  # this stream of the main path starts here
                chunks = list(engine.infer_stream(**kw))
                launches = {"k1": k1.launches, "k3": k3.launches}
            finally:
                os.environ.pop("INDEXTTS_WIDE_TMAJOR_MXU", None)
            st = dict(engine.last_stats)
            k1_total += launches["k1"]
            k3_total += launches["k3"]
            sizes = [c.size // spc for c in chunks]
            total = int(sum(c.size for c in chunks))
            if sizes != [25, 96, 79] or total != 200 * spc or st["vocoder_calls"] != 3:
                raise AssertionError(f"{name}: chunks of {sizes} codes, {total} samples, {st['vocoder_calls']} vocoder "
                                     f"calls; want [25, 96, 79], {200 * spc} and 3")
            if any(c.dtype != np.float32 or not np.isfinite(c).all() for c in chunks):
                raise AssertionError(f"{name}: a chunk is not finite float32")
            if launches != {"k1": 165, "k3": 162}:
                raise AssertionError(f"{name}: launches {launches}, want K3 54 x 3 = 162 and K1 55 x 3 = 165")
            if st["tf_latent_rows"] != (0 if fast else 3):
                raise AssertionError(f"{name}: {st['tf_latent_rows']} teacher-forced passes")
            row = dict(stream=name, fast_latents=fast, mxu=mxu, chunk_codes=sizes, ttfa_ms=1e3 * st["ttfa_s"],
                       chunk_ms=[1e3 * v for v in st["chunk_s"]], total_s=st["total_s"], audio_s=st["audio_s"],
                       decode_steps=st["gpt_steps"], k1_launches=launches["k1"], k3_launches=launches["k3"])
            results.append(row)
            log(f"[stream] {name}: chunks of {sizes} codes, TTFA {row['ttfa_ms']:.1f} ms, chunk times "
                f"{[round(v, 1) for v in row['chunk_ms']]} ms, total {st['total_s']:.2f} s for {st['audio_s']:.2f} s "
                f"audio; K3 {launches['k3']}, K1 {launches['k1']} launches [{card}]")
        # the same request in one piece, for the total and the wait for any audio
        engine.fast_latents = False
        k1.launches = k3.launches = 0
        sr, wav = engine.infer(num_beams=1, **kw)
        st = dict(engine.last_stats)
        if (k1.launches, k3.launches) != (55, 54) or wav.shape[0] != 200 * spc:
            raise AssertionError(f"infer under INDEXTTS_WIDE_TMAJOR=1: K1 {k1.launches}, K3 {k3.launches} launches, "
                                 f"wav {wav.shape}")
        k1_total += k1.launches
        k3_total += k3.launches
        one_shot = dict(total_s=st["total_s"], audio_s=st["audio_s"], vocoder_ms=1e3 * st["bigvgan_s"],
                        decode_ms_per_step=1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1))
        log(f"[stream] infer (num_beams=1) of the same request: total {st['total_s']:.2f} s (all of it before any "
            f"audio), decode {one_shot['decode_ms_per_step']:.2f} ms/step, vocoder {one_shot['vocoder_ms']:.1f} ms "
            f"[{card}]")
    finally:
        del os.environ["INDEXTTS_WIDE_TMAJOR"]
    return {"init_s": init_s, "cold_first_stream_s": cold_s, "streams": results, "one_shot": one_shot,
            "k1_launches": k1_total, "k3_launches": k3_total}


def forced_slot_chunk(engine, steps: int = 16, n_slots: int = 4, cache_len: int = 256, max_new: int = 100) -> dict:
    """Admit `n_slots` sampled rows into a slot state and run chunks of
    `steps` slot steps, as SlotSession.tick runs them (per-row knob columns,
    captured latents): host ms per step (second chunk, synchronized), device
    ms and kernels per step (third chunk, torch.profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.models import gpt_decode as tdec
    from indextts_tpu_torch.models import gpt_slots as tslots

    cfg, dev = engine.cfg.gpt, engine.device
    gen = tdec.GenerationConfig(do_sample=True, num_beams=1, top_k=30, max_new_tokens=max_new)
    g = torch.Generator(device=dev).manual_seed(0)
    r = np.random.default_rng(11)
    conds = engine._conds_for(engine.extract_features(PROMPT)).to(engine.dtype)
    state = tslots.slot_state_init(cfg, gen, n_slots, cache_len, engine.dtype, device=dev, capture_latents=True)
    for slot, n in enumerate((12, 9, 16, 5)[:n_slots]):
        text = np.full((1, 16), cfg.stop_text_token, np.int64)
        text[0, :n] = r.integers(0, cfg.number_text_tokens - 1, n)
        prod = tslots.slot_prefill(engine.gpt, cfg, gen, conds, torch.from_numpy(text).to(dev),
                                   torch.tensor([n], device=dev), g, capture_latents=True)
        state = tslots.slot_admit(state, prod, slot, cfg)
    col = lambda v: torch.full((n_slots,), v, device=dev)
    knobs = dict(temperature=col(1.0), top_p=col(0.8), repetition_penalty=col(10.0), typical_mass=col(0.9))

    def chunk():
        nonlocal state
        before = state.tick
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = tslots.slot_steps(engine.gpt, cfg, gen, state, steps, g, pos_off=1, **knobs)
        torch.cuda.synchronize()
        if state.tick - before != steps or not bool(state.active.all()):
            raise AssertionError(f"the forced slot chunk ran {state.tick - before} of {steps} steps")
        return 1e3 * (time.perf_counter() - t) / steps

    chunk()
    host_ms = chunk()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk()
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    return {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "device_kernels_per_step": sum(e.count for e in events) / steps,
            "device_idle_share": 1.0 - device_ms / host_ms, "rows": n_slots, "cache_slots": cache_len}


def serve_phase(card: str) -> dict:
    """This slice's main path: the serving entry points at the published
    width, fast_latents, with INDEXTTS_FUSED_AA=1 and INDEXTTS_WIDE_TMAJOR=1:
    every vocoder call launches K4 54, K3 54 and K1 1 times."""
    import numpy as np
    import torch

    import indextts_tpu_torch.engine as engine_mod
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_folded as k4
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3

    voc = {"calls": 0}
    apply = engine_mod.bigvgan_apply

    def counting_apply(*a, **kw):
        voc["calls"] += 1
        return apply(*a, **kw)

    def start():
        k1.launches = k3.launches = k4.launches = voc["calls"] = 0

    def launched(what: str, want=(54, 54, 1)) -> dict:
        got = {"k4": k4.launches, "k3": k3.launches, "k1": k1.launches, "vocoder_calls": voc["calls"]}
        if voc["calls"] < 1 or (got["k4"], got["k3"], got["k1"]) != tuple(n * voc["calls"] for n in want):
            raise AssertionError(f"{what}: launches {got}, want K4 {want[0]}, K3 {want[1]}, K1 {want[2]} per vocoder call")
        return got

    engine_mod.bigvgan_apply = counting_apply
    os.environ["INDEXTTS_FUSED_AA"] = os.environ["INDEXTTS_WIDE_TMAJOR"] = "1"
    try:
        t0 = time.perf_counter()
        engine = flagship_engine(fast_latents=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        spc = engine._samples_per_code()
        max_new = 100

        # (a) what a server pays before it binds its port
        start()
        warm_s = engine.warmup(n_slots=4, streaming=True, verbose=False, max_mel_tokens=max_new)
        warm = launched("warmup")
        log(f"[serve] flagship built in {init_s:.1f} s; warmup(n_slots=4, streaming=True) at max_mel_tokens {max_new}: "
            f"{warm_s:.2f} s, {warm['vocoder_calls']} vocoder calls [{card}]")

        # (b) four requests over two prompts in one infer_batch call, beams, per-request temperature
        mel = engine.extract_features(PROMPT)
        half = np.ascontiguousarray(mel[..., : mel.shape[-1] // 2])
        items = [(mel, "HELLO WORLD."), (half, "GOOD DAY."), (mel, "HELLO WORLD. THIS IS A TEST."), (half, "A TEST.")]
        sentences = [len(engine.tokenizer.split_sentences(engine.tokenizer.tokenize(text), 16)) for _, text in items]
        if sentences != [1, 1, 2, 1]:
            raise AssertionError(f"the requests split into {sentences} sentences, want [1, 1, 2, 1]")
        start()
        out = engine.infer_batch(items, max_text_tokens_per_sentence=16, max_mel_tokens=max_new,
                                 per_request_kwargs=[{"temperature": 0.8}, {"temperature": 1.0}, {}, {"temperature": 1.2}])
        batch_launches = launched("infer_batch")
        st = dict(engine.last_stats)
        if len(out) != len(items):
            raise AssertionError(f"infer_batch returned {len(out)} results for {len(items)} requests")
        for i, ((sr, wav), n) in enumerate(zip(out, sentences)):
            # a beam may end on a finished hypothesis: at most the budget, and whole codes
            if (sr != 24000 or wav.dtype != np.int16 or wav.ndim != 2 or wav.shape[1] != 1 or wav.shape[0] % spc
                    or not n * spc <= wav.shape[0] <= n * max_new * spc):
                raise AssertionError(f"infer_batch request {i}: wav {wav.shape} {wav.dtype}, want at most {n} x "
                                     f"{max_new} codes")
        if (sum(st["decode_batches"]) != sum(sentences) or st["tf_latent_rows"] != 0
                or st["vocoder_calls"] != batch_launches["vocoder_calls"]):
            raise AssertionError(f"infer_batch: decode batches {st['decode_batches']}, teacher-forced rows "
                                 f"{st['tf_latent_rows']}, {st['vocoder_calls']} vocoder calls; want {sum(sentences)} "
                                 f"rows, 0 and {batch_launches['vocoder_calls']}")
        batch = dict(requests=len(items), rows=sum(sentences), decode_batches=st["decode_batches"],
                     decode_steps=st["gpt_steps"], cond_ms=1e3 * st["cond_s"],
                     decode_ms_per_step=1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1),
                     vocoder_ms=1e3 * st["bigvgan_s"], total_s=st["total_s"],
                     audio_s=st["audio_s"], rtf=st["rtf"], codes=[int(w.shape[0]) // spc for _, w in out],
                     **batch_launches)
        log(f"[serve] infer_batch, 4 requests over 2 prompts, num_beams 3, per-request temperature: {batch['codes']} codes, decode "
            f"batches {st['decode_batches']}, {st['gpt_steps']} steps at {batch['decode_ms_per_step']:.2f} ms/step, cond "
            f"{batch['cond_ms']:.1f} ms, vocoder {batch['vocoder_ms']:.1f} ms in {st['vocoder_calls']} call(s), total "
            f"{st['total_s']:.2f} s for {st['audio_s']:.2f} s audio, RTF {st['rtf']:.4f}; K4 {batch_launches['k4']}, K3 "
            f"{batch_launches['k3']}, K1 {batch_launches['k1']} launches [{card}]")

        # (c) a slot session: a streaming request and three others fill the four
        # slots, three more wait for the slots to free (reuse), and one is
        # submitted two ticks into the second wave, which has one slot free: it
        # is admitted while the other three are mid-decode
        start()
        sess = engine.slot_session(n_slots=4, chunk_steps=25, do_sample=True, max_mel_tokens=max_new)
        chunks, chunk_at = [], []
        t_submit = time.perf_counter()
        rid_stream = sess.submit(mel, "HELLO WORLD.", on_chunk=lambda rid, c: (chunks.append(c.copy()),
                                                                                chunk_at.append(time.perf_counter())))
        texts = ["GOOD DAY TO YOU.", "THIS IS A TEST.", "THE QUICK BROWN FOX.", "HELLO AGAIN.", "GOOD DAY.", "A TEST."]  # one row each
        rids = [rid_stream] + [sess.submit(half if i % 2 else mel, t) for i, t in enumerate(texts)]
        done, tick_ms = {}, []
        late = None
        while sess.busy and len(tick_ms) < 40:
            t = time.perf_counter()
            done.update(sess.tick())
            tick_ms.append(1e3 * (time.perf_counter() - t))
            if len(tick_ms) == 6:
                if sum(r is not None for r in sess.slots) != 3:
                    raise AssertionError(f"the second wave holds {sum(r is not None for r in sess.slots)} rows, want 3")
                late = sess.submit(mel, "ONE MORE.")
                rids.append(late)
            elif len(tick_ms) == 7:
                row = next(r for r in sess.slots if r is not None and r["rid"] == late)
                others = [r["admit_seq"] for r in sess.slots if r is not None and r["rid"] != late]
                if row["admit_seq"] != 7 or others != [5, 5, 5]:
                    raise AssertionError(f"the late request was not admitted mid-decode: admit_seq {row['admit_seq']}, "
                                         f"the others {others}")
        rest = sess.drain()
        if rest or sess.busy or set(done) != set(rids):
            raise AssertionError(f"slot session: completed {sorted(done)} of {sorted(rids)}; left after the loop {sorted(rest)}")
        slot_launches = launched("slot session")
        for rid in rids:
            sr, wav = done[rid]
            if sr != 24000 or wav.dtype != np.int16 or wav.shape != (max_new * spc, 1):
                raise AssertionError(f"slot request {rid}: wav {wav.shape} {wav.dtype}, want {max_new} codes")
        if not np.array_equal(np.concatenate(chunks), done[rid_stream][1].reshape(-1)):
            raise AssertionError("the streamed chunks do not concatenate to the streaming request's result")
        first_chunk_s = chunk_at[0] - t_submit
        slots = dict(requests=len(rids), ticks=len(tick_ms), tick_ms=tick_ms, chunk_ms=[1e3 * s for s in sess.chunk_s],
                     stream_chunks=[c.size // spc for c in chunks], first_chunk_s=first_chunk_s,
                     tf_latent_rows=sess.tf_latent_rows, cache_len=sess.cache_len, **slot_launches)
        log(f"[serve] slot session, 4 slots x {sess.cache_len} cache slots, chunk_steps 25, {len(rids)} sampled requests "
            f"(one streaming, one admitted mid-decode): {len(tick_ms)} ticks of {[round(v) for v in tick_ms]} ms "
            f"(decode chunks {[round(v) for v in slots['chunk_ms']]} ms), streamed chunks of {slots['stream_chunks']} "
            f"codes, first chunk {first_chunk_s:.3f} s after submit; K4 {slot_launches['k4']}, K3 {slot_launches['k3']}, "
            f"K1 {slot_launches['k1']} launches over {slot_launches['vocoder_calls']} vocoder calls [{card}]")
        if sum(slots["stream_chunks"]) != max_new or sess.tf_latent_rows != 0:
            raise AssertionError(f"slot session: streamed {slots['stream_chunks']} codes, teacher-forced rows "
                                 f"{sess.tf_latent_rows}")

        # (e) one forced slot chunk under the profiler
        step = forced_slot_chunk(engine, cache_len=sess.cache_len, max_new=max_new)
        log(f"[serve] forced slot chunk, 4 active rows x 16 steps, {step['cache_slots']} cache slots: host "
            f"{step['host_ms_per_step']:.2f} ms/step, device {step['device_ms_per_step']:.3f} ms/step in "
            f"{step['device_kernels_per_step']:.0f} kernels, device idle {100 * step['device_idle_share']:.1f} % [{card}]")

        # (d) one vocoder call under INDEXTTS_FUSED_AA=1 alone: K4 at the narrow stages, K1 at the rest
        del os.environ["INDEXTTS_WIDE_TMAJOR"]
        latent = torch.randn(1, 100, engine.cfg.gpt.model_dim, device="cuda", dtype=engine.dtype,
                             generator=torch.Generator(device="cuda").manual_seed(5))
        start()
        wav = engine._vocode(latent, 100, mel)
        fused_only = launched("vocoder call under INDEXTTS_FUSED_AA=1 alone", want=(54, 0, 55))
        if wav.shape != (1, 100 * spc) or not np.isfinite(wav).all():
            raise AssertionError(f"vocoder call under INDEXTTS_FUSED_AA=1 alone: wav {wav.shape}")
        log(f"[serve] one vocoder call under INDEXTTS_FUSED_AA=1 alone: K4 {fused_only['k4']}, K1 {fused_only['k1']} "
            f"launches [{card}]")
        voc_prof = vocoder_profile(engine)
        log(f"[serve] one profiled bigvgan_apply under INDEXTTS_FUSED_AA=1 alone, {voc_prof['codes']} codes, B=1, "
            f"{engine.dtype}: {vocoder_profile_line(voc_prof)} [{card}]")
    finally:
        engine_mod.bigvgan_apply = apply
        os.environ.pop("INDEXTTS_FUSED_AA", None)
        os.environ.pop("INDEXTTS_WIDE_TMAJOR", None)
    return {"init_s": init_s, "warmup_s": warm_s, "warmup": warm, "infer_batch": batch, "slots": slots,
            "forced_slot_chunk": step, "fused_aa_alone": fused_only, "fused_aa_vocoder_profile": voc_prof,
            "k4_launches": warm["k4"] + batch_launches["k4"] + slot_launches["k4"],
            "k3_launches": warm["k3"] + batch_launches["k3"] + slot_launches["k3"],
            "k1_launches": warm["k1"] + batch_launches["k1"] + slot_launches["k1"]}


def tiny_config():
    from indextts_tpu_torch.config import (BigVGANConfig, ConditionModuleConfig, GPTConfig,
                                           IndexTTSConfig)

    return IndexTTSConfig(
        gpt=GPTConfig(layers=2, model_dim=64, heads=4, max_text_tokens=60, max_mel_tokens=48,
                      number_text_tokens=50, number_mel_codes=66, start_mel_token=64, stop_mel_token=65,
                      condition_num_latent=8,
                      condition_module=ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4,
                                                             num_blocks=1, input_layer="conv2d2",
                                                             perceiver_mult=2)),
        bigvgan=BigVGANConfig(gpt_dim=64, upsample_initial_channel=256, upsample_rates=(4, 2),
                              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), speaker_embedding_dim=32),
    )


def small_phase(card: str) -> dict:
    """Tiny width, float32: the card's engine against the CPU's on the same
    weights, for infer and then, on int8 weights with the int8 KV cache, for
    infer_fast (batched on the card, one sentence per batch on the CPU)."""
    import tempfile

    import numpy as np
    import torch

    from indextts_tpu_torch.config import save_config
    from indextts_tpu_torch.engine import IndexTTS
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as d:
        cfg_path = os.path.join(d, "config.yaml")
        save_config(tiny_config(), cfg_path)
        gpu = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cuda", allow_random_init=True)
        cpu = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu", allow_random_init=True)
    with torch.no_grad():
        # a sharper mel head, so greedy runs several tokens before stop
        gpu.gpt.mel_head.weight.mul_(15.0)
        cpu.gpt.load_state_dict({k: v.cpu() for k, v in gpu.gpt.state_dict().items()})
        cpu.bigvgan.load_state_dict({k: v.cpu() for k, v in gpu.bigvgan.state_dict().items()})
    codes = {}
    for name, e in (("gpu", gpu), ("cpu", cpu)):
        gen = e._gpt_generate

        def rec(*a, _gen=gen, _name=name, **k):
            out = _gen(*a, **k)
            codes.setdefault(_name, []).append(out[0])
            return out

        e._gpt_generate = rec
    kw = dict(text="HELLO WORLD.", do_sample=False, num_beams=1, max_mel_tokens=24)
    _, wav_gpu = gpu.infer(audio_prompt=PROMPT, **kw)
    _, wav_cpu = cpu.infer(audio_prompt=PROMPT, **kw)
    same = all(np.array_equal(a, b) for a, b in zip(codes["gpu"], codes["cpu"]))
    diff = int(np.abs(wav_gpu.astype(np.int64) - wav_cpu.astype(np.int64)).max()) if wav_gpu.size else 0
    log(f"[small] tiny f32 greedy: codes equal {same} ({codes['gpu'][0][0, :12].tolist()}...), "
        f"wav {wav_gpu.shape} max |gpu - cpu| = {diff} int16 units [{card}]")
    if not same or wav_gpu.shape != wav_cpu.shape or diff > 8:
        raise AssertionError("the card's engine disagrees with the CPU's at tiny width")

    # greedy beams (num_beams = 3) with the wide-branch vocoder: stage 1 is
    # C = 128, so the card runs K2 there (float32) and the CPU its plain version
    from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2

    codes.clear()
    os.environ["INDEXTTS_WIDE_BRANCH"] = "1"
    try:
        before = k2.launches
        kw = dict(text="HELLO WORLD.", do_sample=False, num_beams=3, max_mel_tokens=24)
        _, wavb_gpu = gpu.infer(audio_prompt=PROMPT, **kw)
        k2_calls = k2.launches - before
        _, wavb_cpu = cpu.infer(audio_prompt=PROMPT, **kw)
    finally:
        del os.environ["INDEXTTS_WIDE_BRANCH"]
    same_b = all(np.array_equal(a, b) for a, b in zip(codes["gpu"], codes["cpu"]))
    diff_b = int(np.abs(wavb_gpu.astype(np.int64) - wavb_cpu.astype(np.int64)).max()) if wavb_gpu.size else 0
    log(f"[small] tiny f32 greedy num_beams=3, INDEXTTS_WIDE_BRANCH=1: codes equal {same_b} "
        f"({codes['gpu'][0][0, :12].tolist()}...), {k2_calls} K2 launches on the card, wav {wavb_gpu.shape} "
        f"max |gpu - cpu| = {diff_b} int16 units [{card}]")
    if not same_b or wavb_gpu.shape != wavb_cpu.shape or diff_b > 1 or k2_calls != 4:
        raise AssertionError("the card's beams / K2 vocoder disagree with the CPU's at tiny width")

    # the card's captured latents (greedy beams, consistent positions) against its teacher-forced pass
    gpu.fast_latents = True
    try:
        conds = gpu._conds_for(gpu.extract_features(PROMPT))
        text = np.asarray([gpu.tokenizer.convert_tokens_to_ids(gpu.tokenizer.tokenize("HELLO WORLD."))])
        gen, dyn, _ = gpu._parse_generation_kwargs(dict(do_sample=False, num_beams=3, max_mel_tokens=24))
        cb, lb, lat, _ = gpu._gpt_generate(conds, text, np.asarray([text.shape[1]]), gen, **dyn)
    finally:
        gpu.fast_latents = False
    n = int(np.nonzero(cb[0] == gpu.stop_mel_token)[0][0]) if (cb[0] == gpu.stop_mel_token).any() else cb.shape[1]
    tf = gpu._gpt_latent(conds, text, cb[:, :n], np.asarray([n]))
    lat_err = float((lat[0, :n].float() - tf[0, :n].float()).abs().max()) if n else 0.0
    log(f"[small] tiny f32 captured latents (num_beams=3, {n} codes) vs teacher-forced: max |diff| {lat_err:.2e} "
        f"[{card}]")
    if n < 2 or not lat_err <= 1e-4:
        raise AssertionError(f"captured latents differ from the teacher-forced pass by {lat_err} ({n} codes)")

    # greedy streams under INDEXTTS_WIDE_TMAJOR=1, with and without _MXU: stage
    # 1 is C = 128, so the card runs K3 there (float32 takes the CUDA-core body
    # either way) and the CPU its plain versions
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3

    streams = {}
    os.environ["INDEXTTS_WIDE_TMAJOR"] = "1"
    try:
        for mxu in (False, True):
            if mxu:
                os.environ["INDEXTTS_WIDE_TMAJOR_MXU"] = "1"
            skw = dict(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=False, max_mel_tokens=24,
                       first_chunk_codes=4, chunk_codes=6, overlap_codes=2)
            before = k3.launches
            c_gpu = list(gpu.infer_stream(**skw))
            k3_calls, voc_calls = k3.launches - before, gpu.last_stats["vocoder_calls"]
            c_cpu = list(cpu.infer_stream(**skw))
            sizes_gpu, sizes_cpu = [c.size for c in c_gpu], [c.size for c in c_cpu]
            diff_s = max((float(np.abs(a - b).max()) * 32767 for a, b in zip(c_gpu, c_cpu) if a.size == b.size),
                         default=0.0)
            log(f"[small] tiny f32 greedy infer_stream, INDEXTTS_WIDE_TMAJOR=1{' _MXU=1' if mxu else ''}: chunk "
                f"samples {sizes_gpu} (CPU {sizes_cpu}), {k3_calls} K3 launches over {voc_calls} vocoder calls, max "
                f"|gpu - cpu| = {diff_s:.3f} int16 units [{card}]")
            if sizes_gpu != sizes_cpu or len(sizes_gpu) < 2 or diff_s > 8 or k3_calls != 4 * voc_calls:
                raise AssertionError("the card's stream / K3 vocoder disagree with the CPU's at tiny width")
            streams["mxu" if mxu else "taps"] = {"chunk_samples": sizes_gpu, "wav_max_abs_diff_int16": diff_s,
                                                 "k3_launches": k3_calls, "vocoder_calls": voc_calls}
    finally:
        os.environ.pop("INDEXTTS_WIDE_TMAJOR_MXU", None)
        del os.environ["INDEXTTS_WIDE_TMAJOR"]

    # greedy infer_batch and infer_slots (3 requests over 2 prompts, 2 slots, so
    # one slot is reused) against per-request infer, on the card and on the CPU;
    # the code rows are read where each path hands them to the silence removal
    mel = gpu.extract_features(PROMPT)
    items = [(mel, "HELLO WORLD."), (np.ascontiguousarray(mel[..., : mel.shape[-1] // 2]), "GOOD DAY."), (mel, "A TEST.")]
    kw = dict(do_sample=False, num_beams=1, max_mel_tokens=24)
    served = {}
    for name, e in (("gpu", gpu), ("cpu", cpu)):
        rows, rls = [], e.remove_long_silence
        e.remove_long_silence = lambda c, _rls=rls, _rows=rows, **k: (_rows.append(np.asarray(c).copy()), _rls(c, **k))[1]
        try:
            for method, run in (("infer", lambda: [e.infer(m, t, None, **kw) for m, t in items]),
                                ("infer_batch", lambda: e.infer_batch(items, **kw)),
                                ("infer_slots", lambda: e.infer_slots(items, n_slots=2, **kw))):
                rows.clear()
                wavs = [w.astype(np.int64) for _, w in run()]
                served[name, method] = (sorted(tuple(r.reshape(-1).tolist()) for r in rows), wavs)
        finally:
            del e.remove_long_silence
    solo_codes, solo_wavs = served["gpu", "infer"]
    serve_diffs = {}
    for (name, method), (rows, wavs) in served.items():
        if rows != solo_codes or len(rows) != len(items) or min(len(r) for r in rows) < 2:
            raise AssertionError(f"{method} on the {name}: code rows {rows} differ from the card's per-request infer "
                                 f"{solo_codes}")
        if [w.shape for w in wavs] != [w.shape for w in solo_wavs]:
            raise AssertionError(f"{method} on the {name}: wav shapes {[w.shape for w in wavs]}")
        serve_diffs[f"{name}_{method}"] = max(int(np.abs(a - b).max()) for a, b in zip(wavs, solo_wavs))
    log(f"[small] tiny f32 greedy infer / infer_batch / infer_slots (3 requests, 2 prompts, 2 slots) on the card and "
        f"the CPU: code rows equal ({[len(r) for r in solo_codes]} codes), max |wav - the card's per-request infer| "
        f"in int16 units {serve_diffs} [{card}]")
    if max(serve_diffs.values()) > 8:
        raise AssertionError("infer_batch / infer_slots disagree with per-request infer at tiny width")

    # one vocoder call under INDEXTTS_FUSED_AA=1: stage 2 is C = 64, so the card
    # runs K4 at its 4 resblock activations and the CPU K4's plain version
    from indextts_tpu_torch.ops.cuda import antialias_folded as k4

    lat = torch.randn(1, 24, gpu.cfg.gpt.model_dim, generator=torch.Generator().manual_seed(3))
    os.environ["INDEXTTS_FUSED_AA"] = "1"
    try:
        before = k4.launches
        wavf_gpu = gpu._vocode(lat.cuda(), 24, mel)
        k4_calls = k4.launches - before
        wavf_cpu = cpu._vocode(lat, 24, mel)
    finally:
        del os.environ["INDEXTTS_FUSED_AA"]
    wavf_default = gpu._vocode(lat.cuda(), 24, mel)
    diff_f = float(np.abs(wavf_gpu - wavf_cpu).max()) * 32767
    diff_fd = float(np.abs(wavf_gpu - wavf_default).max()) * 32767
    log(f"[small] tiny f32 vocoder call, INDEXTTS_FUSED_AA=1: {k4_calls} K4 launches on the card, wav {wavf_gpu.shape} "
        f"max |gpu - cpu| = {diff_f:.4f}, max |K4 - default route| = {diff_fd:.4f} int16 units [{card}]")
    if wavf_gpu.shape != wavf_cpu.shape or k4_calls != 4 or not max(diff_f, diff_fd) <= 1.0:
        raise AssertionError("the card's K4 vocoder disagrees with the CPU's at tiny width")

    # int8 weights and the int8 KV cache; the card decodes the sentences as
    # one batch (K5 at M = 3), the CPU one at a time (K5's plain version)
    for e in (gpu, cpu):
        quantize_unified_voice(e.gpt)
        e.quant_kv = True
    codes.clear()
    kw = dict(text="HELLO WORLD. THIS IS A TEST. GOOD DAY.", do_sample=False, num_beams=1, max_mel_tokens=24,
              max_text_tokens_per_sentence=16)
    _, wav8_gpu = gpu.infer_fast(audio_prompt=PROMPT, **kw)
    batches = gpu.last_stats["decode_batches"]
    _, wav8_cpu = cpu.infer_fast(audio_prompt=PROMPT, **kw)
    rows = lambda name: [r for c in codes[name] for r in c]
    same8 = len(rows("gpu")) == len(rows("cpu")) and all(
        np.array_equal(a, b) for a, b in zip(sorted(map(tuple, rows("gpu"))), sorted(map(tuple, rows("cpu")))))
    diff8 = int(np.abs(wav8_gpu.astype(np.int64) - wav8_cpu.astype(np.int64)).max()) if wav8_gpu.size else 0
    log(f"[small] tiny f32 infer_fast, int8 weights + int8 KV: card batches {batches}, codes equal {same8}, "
        f"wav {wav8_gpu.shape} max |gpu - cpu| = {diff8} int16 units [{card}]")
    if not same8 or wav8_gpu.shape != wav8_cpu.shape or diff8 > 8 or max(batches) < 2:
        raise AssertionError("the card's int8 infer_fast disagrees with the CPU's at tiny width")
    return {"codes_equal": same, "wav_max_abs_diff_int16": diff, "samples": int(wav_gpu.shape[0]),
            "beams_wide_branch": {"codes_equal": same_b, "wav_max_abs_diff_int16": diff_b, "k2_launches": k2_calls,
                                  "samples": int(wavb_gpu.shape[0])},
            "captured_latents": {"codes": n, "max_abs_diff_vs_teacher_forced": lat_err},
            "streams_wide_tmajor": streams,
            "serving_wav_max_abs_diff_int16": serve_diffs,
            "fused_aa_vocoder": {"k4_launches": k4_calls, "wav_max_abs_diff_int16": diff_f,
                                 "wav_max_abs_diff_vs_default_int16": diff_fd},
            "int8_fast": {"codes_equal": same8, "wav_max_abs_diff_int16": diff8, "card_batches": batches,
                          "samples": int(wav8_gpu.shape[0])}}


def activation_bound(stages, calls_per_stage: int, extra=()):
    """The least time the card could take for the anti-aliased activations of
    one vocoder call (bf16, B = 1): `calls_per_stage` calls at each (label, C,
    T) of `stages`, one at each of `extra`. The larger of the bytes (x read
    once, z written once) over the memory rate and ACT_OPS float32 operations
    per element over the CUDA cores' rate. Returns (ms, "bytes" or
    "operations")."""
    elements = sum(calls_per_stage * c * t for _, c, t in stages) + sum(c * t for _, c, t in extra)
    by_bytes, by_ops = 1e3 * elements * 4 / PEAK_BYTES, 1e3 * elements * ACT_OPS / PEAK_F32
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _pick(r: dict, key: str, fallback: str) -> float:
    """r[key], the profiler's device time, or r[fallback], CUDA-event time,
    where the profiler saw nothing."""
    return r[key] if r.get(key) is not None else r[fallback]


def k1_per_vocoder_call(kern: dict, card: str) -> dict:
    """K1's time in one vocoder call at ~100 codes, bf16, B = 1: 18
    activations at each of the six stages plus activation_post. "k1": its own
    device time; "call": the wrappers' whole calls; "plain"; "k4_design": K4's
    kernel at the same shapes."""
    rows = {r["case"]: r for r in kern["rows"] if r["B"] == 1 and r["dtype"] == "bfloat16"}

    def per_call(key: str, fallback: str) -> float:
        return (sum(18 * _pick(rows[s], key, fallback) for s, _, _ in STAGES[:6])
                + _pick(rows["activation_post"], key, fallback))

    out = {"k1": per_call("own_ms", "ms"), "call": per_call("device_ms", "ms"),
           "plain": per_call("device_plain_ms", "plain_ms"), "k4_design": per_call("k4_own_ms", "ms")}
    log(f"[kernel] per vocoder call (109 activations, bf16, B=1), device ms: K1 own {out['k1']:.4f}, whole calls "
        f"{out['call']:.4f}, plain {out['plain']:.3f}; K4's kernel at K1's shapes {out['k4_design']:.4f} [{card}]")
    return out


def k3_per_vocoder_call(kern3: dict, card: str) -> dict:
    """K3's bodies (own device time, and "<body>_call" the whole calls), its
    plain version and K1 (own) in one vocoder call at ~100 codes, bf16, B =
    1: 18 activations at each wide stage."""
    rows = [r for r in kern3["rows"] if r["B"] == 1 and r["dtype"] == "bfloat16" and r["case"] in
            {s for s, _, _ in STAGES[:3]}]
    out = {body: sum(18 * _pick(r["bodies"][body], "own_ms", "ms") for r in rows) for body in ("taps", "mma", "ident")}
    out.update({f"{body}_call": sum(18 * _pick(r["bodies"][body], "device_ms", "ms") for r in rows)
                for body in ("taps", "mma", "ident")})
    out["plain"] = sum(18 * _pick(r["bodies"]["taps"], "device_plain_ms", "plain_ms") for r in rows)
    out["k1"] = sum(18 * _pick(r, "k1_own_ms", "k1_ms") for r in rows)
    out["bound"] = {body: k3_body_bound(body) for body in ("taps", "mma", "ident")}
    bounds = ", ".join(f"{body} {ms:.4f} ({by})" for body, (ms, by) in out["bound"].items())
    log(f"[k3] per vocoder call (54 activations at the wide stages, bf16, B=1), own device ms: CUDA-core body "
        f"{out['taps']:.4f}, tensor-core body {out['mma']:.4f}, ident {out['ident']:.4f}, K1 at the same shapes "
        f"{out['k1']:.4f}; whole calls: {out['taps_call']:.4f}, {out['mma_call']:.4f}, {out['ident_call']:.4f}; "
        f"bounds: {bounds} [{card}]")
    return out


def k3_body_bound(body: str):
    """The least time of one K3 body for a vocoder call's 54 wide activations
    (bf16, B = 1): (ms, what bounds it). Every body moves 4 bytes an element.
    The CUDA-core body does ACT_OPS float32 operations an element; the
    tensor-core body only the snakes' 36 (two samples x 18), and 128 FLOP of
    banded mma.sync an element (4 products of 16 x 8 x 16 per 128 outputs)
    on the tensor cores; the pass-through none."""
    elements = sum(18 * c * t for _, c, t in STAGES[:3])
    if body == "taps":
        return activation_bound(STAGES[:3], 18)
    terms = {"bytes": 1e3 * elements * 4 / PEAK_BYTES}
    if body == "mma":
        terms["operations"] = max(1e3 * elements * 36 / PEAK_F32, 1e3 * elements * 128 / PEAK_BF16)
    by = max(terms, key=terms.get)
    return terms[by], by


def k4_per_vocoder_call(kern4: dict, card: str) -> dict:
    """K4 (own device time; "call" the whole calls), its plain version, K1
    and K3's ident body (own) in one vocoder call at ~100 codes, bf16, B = 1:
    18 activations at each narrow stage."""
    rows = [r for r in kern4["rows"] if r["B"] == 1 and r["dtype"] == "bfloat16" and r["case"] in
            {s for s, _, _ in STAGES[3:6]}]
    keys = {"k4": ("own_ms", "ms"), "call": ("device_ms", "ms"), "plain": ("device_plain_ms", "plain_ms"),
            "k1": ("k1_own_ms", "k1_ms"), "k3_ident": ("k3_ident_own_ms", "k3_ident_ms")}
    out = {name: sum(18 * _pick(r, *kf) for r in rows) for name, kf in keys.items()}
    log(f"[k4] per vocoder call (54 activations at the narrow stages, bf16, B=1), own device ms: K4 {out['k4']:.4f} "
        f"(whole calls {out['call']:.4f}), K1 at the same shapes {out['k1']:.4f}, K3's ident body "
        f"{out['k3_ident']:.4f}; plain {out['plain']:.3f} [{card}]")
    return out


PHASES = ("kernel", "k2", "k3", "k4", "k5", "engine", "beam", "stream", "serve", "int8", "small")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    only = None
    if argv[:1] == ["--phases"] and len(argv) == 2:
        only = argv[1].split(",")
    if (argv and only is None) or (only and set(only) - set(PHASES)):
        print(f"usage: chip_smoke.py [--phases {','.join(PHASES)}]", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = device_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from concurrent.futures import ThreadPoolExecutor

    from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import antialias_folded as k4
    from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
    from indextts_tpu_torch.ops.cuda import build
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.ops.cuda import qmatmul as k5

    # one nvcc per source, started together
    t = time.perf_counter()
    kernels_built = (k1, k2, k3, k4, k5)
    with ThreadPoolExecutor(max_workers=len(kernels_built)) as pool:
        for future in [pool.submit(k._library) for k in kernels_built]:
            future.result()
    log(f"[build] {', '.join(k.SOURCE for k in kernels_built)} built and loaded in {time.perf_counter() - t:.2f} s "
        f"(nvcc {', '.join(f'{build.build_seconds[k.SOURCE]:.2f}' for k in kernels_built)} s, in parallel)")
    for src in (k.SOURCE for k in kernels_built):
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {src}:", line.strip())

    phase_fns = {"kernel": kernel_phase, "k2": k2_phase, "k3": k3_phase, "k4": k4_phase, "k5": k5_phase,
                 "engine": engine_phase, "beam": beam_phase, "stream": stream_phase, "serve": serve_phase,
                 "int8": int8_phase, "small": small_phase}
    if only is not None:
        summaries = {"kernel": k1_per_vocoder_call, "k3": k3_per_vocoder_call, "k4": k4_per_vocoder_call}
        for name in only:
            result = phase_fns[name](card)
            if name in summaries:
                summaries[name](result, card)
        log(f"[partial] ran only {only}: no result lines")
        return 3
    kern = kernel_phase(card)
    kern2 = k2_phase(card)
    kern3 = k3_phase(card)
    kern4 = k4_phase(card)
    kern5 = k5_phase(card)
    eng = engine_phase(card)
    beam = beam_phase(card)
    stream = stream_phase(card)
    serve = serve_phase(card)
    int8 = int8_phase(card)
    small = small_phase(card)

    layers = load_config(FLAGSHIP).gpt.layers

    def per_step(key: str, fallback: str, m: int = 4) -> float:
        """K5 (or plain, or F.linear on bf16 weights) time of one decode step
        at M = m, bf16: four block matmuls in each layer plus the mel head."""
        k5_rows = {r["case"]: r for r in kern5["rows"] if r["M"] == m and r["dtype"] == "bfloat16"}
        pick = lambda r: r[key] if r[key] is not None else r[fallback]
        return layers * sum(pick(k5_rows[c]) for c in ("qkv", "proj", "fc", "mlp_proj")) + pick(k5_rows["head"])

    k5_per_step = {m: {"kernel_ms": per_step("device_ms", "ms", m), "plain_ms": per_step("device_plain_ms", "plain_ms", m),
                       "bf16_linear_ms": per_step("bf16_linear_ms", "bf16_linear_ms", m)} for m in K5_MS}
    for m, v in k5_per_step.items():
        log(f"[k5] per decode step (97 launches, bf16) M={m:2d}: K5 {v['kernel_ms']:.4f} ms ({v['kernel_ms'] / k5_per_step[4]['kernel_ms']:.2f}x "
            f"M=4), plain {v['plain_ms']:.4f} ms, F.linear on bf16 weights {v['bf16_linear_ms']} ms [{card}]")

    k2_rows = {(r["case"], r["k"], r["d"]): r for r in kern2["rows"] if r["dtype"] == "bfloat16" and r["B"] == 1}

    def per_voc(key: str, fallback: str) -> float:
        """K2 (or plain, or K1 + conv) time of one vocoder call at ~100
        codes, bf16, B=1: the 54 wide half-branch calls. Device time from
        the profiler where it saw the kernels, else CUDA-event time."""
        pick = lambda r: r[key] if r[key] is not None else r[fallback]
        return sum(n * pick(k2_rows[(s, k, d)]) for s, _, _ in STAGES[:3] for (k, d), n in K2_CALLS.items())

    k2_per_stage = {s: {name: sum(n * (r[dk] if r[dk] is not None else r[ek])
                                  for (k, d), n in K2_CALLS.items() for r in [k2_rows[(s, k, d)]])
                        for name, dk, ek in (("kernel_ms", "device_ms", "ms"), ("plain_ms", "device_plain_ms", "plain_ms"),
                                             ("k1_conv_ms", "device_default_ms", "default_ms"))}
                    for s, _, _ in STAGES[:3]}
    for s, v in k2_per_stage.items():
        log(f"[k2] {s} per vocoder call (18 half-branches, bf16, B=1): K2 {v['kernel_ms']:.3f} ms, plain "
            f"{v['plain_ms']:.3f} ms, K1 + cuDNN conv {v['k1_conv_ms']:.3f} ms [{card}]")

    k1_per_voc = k1_per_vocoder_call(kern, card)
    k3_per_voc = k3_per_vocoder_call(kern3, card)
    k4_per_voc = k4_per_vocoder_call(kern4, card)

    # the least time the card could take, from the shapes above (bf16)
    k1_bound, k1_by = activation_bound(STAGES[:6], 18, STAGES[6:])
    k3_bound, k3_by = activation_bound(STAGES[:3], 18)
    k4_bound, k4_by = activation_bound(STAGES[3:6], 18)
    k2_terms = {
        "bytes": sum(n * (4 * c * t + 2 * k * c * c) for _, c, t in STAGES[:3] for (k, _), n in K2_CALLS.items()) / PEAK_BYTES,
        "operations": max(sum(n * 2 * k * c * c * t for _, c, t in STAGES[:3] for (k, _), n in K2_CALLS.items()) / PEAK_BF16,
                          sum(18 * c * t for _, c, t in STAGES[:3]) * ACT_OPS / PEAK_F32),
    }
    k2_by = max(k2_terms, key=k2_terms.get)
    m = 4
    step_shapes = [(k, n) for _, k, n in K5_SHAPES[:4]] * layers + [K5_SHAPES[4][1:]]
    k5_terms = {"bytes": sum(n * k + 2 * m * k + 2 * m * n + 6 * n for k, n in step_shapes) / PEAK_BYTES,
                "operations": sum(2 * m * k * n for k, n in step_shapes) / PEAK_BF16}
    k5_by = max(k5_terms, key=k5_terms.get)

    report = {
        "device": card,
        "build_seconds": dict(build.build_seconds),
        "kernel": kern,
        "k2": kern2,
        "k2_per_stage": k2_per_stage,
        "k3": kern3,
        "k1_per_vocoder_call_ms": k1_per_voc,
        "k3_per_vocoder_call_ms": k3_per_voc,
        "k4": kern4,
        "k4_per_vocoder_call_ms": k4_per_voc,
        "k5": kern5,
        "k5_per_decode_step_ms": {str(m): v for m, v in k5_per_step.items()},
        "engine": eng,
        "beam": beam,
        "stream": stream,
        "serve": serve,
        "int8": int8,
        "small": small,
    }
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    # library_ms: no single PyTorch call computes any of these functions (the
    # activation is a transposed conv, a snake and a strided conv; K2 adds a
    # conv; K5's plain version dequantizes, then calls F.linear)
    kernels = [{
        "name": "fused_anti_alias_snake", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": eng["k1_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern["rows"]),
        "ms": k1_per_voc["k1"], "plain_ms": k1_per_voc["plain"],
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None, "call_ms": k1_per_voc["call"],
    }, {
        "name": "aa_snake_dconv", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": beam["k2_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern2["rows"]),
        "ms": per_voc("device_ms", "ms"), "plain_ms": per_voc("device_plain_ms", "plain_ms"),
        "bound_ms": 1e3 * k2_terms[k2_by], "bound_by": k2_by, "library_ms": None,
        "call_ms": per_voc("device_ms", "ms"),  # the wrapper launches nothing but the kernel: ms is the whole call
    }, {
        "name": "fused_anti_alias_snake_tmajor", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
        "launches": stream["k3_launches"],
        "max_abs_err": max(b["max_abs_err"] for r in kern3["rows"] for b in r["bodies"].values()),
        "ms": k3_per_voc["taps"], "plain_ms": k3_per_voc["plain"],
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None, "call_ms": k3_per_voc["taps_call"],
        # the other bodies' own ms and bounds, beside K1's own ms at the same shapes
        "bodies_ms": {"mma": k3_per_voc["mma"], "ident": k3_per_voc["ident"], "k1": k3_per_voc["k1"]},
        "bodies_bound_ms": {body: ms for body, (ms, _) in k3_per_voc["bound"].items()},
    }, {
        "name": "fused_folded_aa", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": serve["k4_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern4["rows"]),
        "ms": k4_per_voc["k4"], "plain_ms": k4_per_voc["plain"],
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "call_ms": k4_per_voc["call"],
    }, {
        "name": "int8_matmul", "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
        "launches": int8["k5_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern5["rows"]),
        "ms": per_step("device_ms", "ms"), "plain_ms": per_step("device_plain_ms", "plain_ms"),
        "bound_ms": 1e3 * k5_terms[k5_by], "bound_by": k5_by, "library_ms": None,
        "call_ms": per_step("device_ms", "ms"),  # the wrapper launches nothing but the kernel at bf16
        "bf16_linear_ms": k5_per_step[4]["bf16_linear_ms"],  # another function (bf16 weights): a yardstick only
    }]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
