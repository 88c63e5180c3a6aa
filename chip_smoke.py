#!/usr/bin/env python3
"""Smoke run of the PyTorch port (indextts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the K1-K8 kernels and the decode
               block's graph assembly (graph_block.cu) from
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
     k6      — K6 (decode_attn) at the decode loops' shapes (8 rows and 3
               beams on the bf16 cache mid-decode, 32 int8 slots): err against
               the formula in float64 beside the plain path's, two runs
               bit-equal, device times of both per layer and per step with
               the 24 layers' caches cycled past the L2 cache, the bound;
               and the rounding rule of PyTorch's int8 scale on the card;
     k7      — K7 (ssm_step) at granite-4.0-h-micro's widths, 3, 8 and 32
               rows, against its plain version (two runs bit-equal), own and
               plain device times per layer with the 36 layers' states cycled
               past the L2 cache, the bound; K6's grouped-query instance
               (32 query over 8 KV heads, granite's scale) against float64;
     k8      — K8 (gpt2_chains.add_layer_norm with a delta) and the
               block's gelu_new (PyTorch's tanh GELU on the card) at the
               GPT-2 step's rows (8 batch rows, 3 beams, 32 slots) and a
               prefill's (8 x 160), bf16: err against float64 beside the plain
               path's, two runs bit-equal, the sum bit-equal to the bf16 add;
               own, plain and library device times, the bound, and per
               decode step;
     hybrid  — in a process of its own: the hybrid decoder's engine at its
               published widths (benchmark/configs/indextts-granite-4.0-h-
               micro-serve.json, random weights): one infer and a slot session
               of 8 slots, K7 launched once a Mamba layer and K6 once an
               attention layer in every decode step; then the profiler's count
               of both kernels a decode step, eager and replayed;
  5. engine  — IndexTTS.infer at the published IndexTTS-1.5 width
               (configs/indextts_1_5.yaml), random weights from a fixed seed,
               bf16: a greedy, a sampled and a two-sentence request; the K1
               launch count must be 109 per vocoder call, K6's one a
               layer in every decode step and K8's 2 x layers + 1 a decode
               step and a whole-sequence pass (as in the beam, serve, int8
               and graphs phases); then one profiled
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
               card, its plain version on the CPU), infer_fast on int8
               weights with the int8 KV cache, greedy inference_speech with
               an 8-code forced prefix and two return sequences (codes
               equal), and one tiny reference-format
               checkpoint directory loaded on both (greedy codes equal, wav
               within 1 int16 unit);
     ckpt    — the published width started from a reference-format
               checkpoint directory written under build/ (tests/
               make_torch_ckpt.py's seeded state dicts rescaled to the random
               init's spread, the stop code's bias at -30): engine A
               converts gpt.pth and bigvgan_generator.pth
               and writes their .npz caches, engine B loads the caches (bf16,
               each construction timed); five weights of both against the
               state dicts with torch alone, bit for bit in bf16; a greedy
               100-code request on A and B, codes and wav bit-equal; then B
               behind the port's web server (create_app, slot_requests=4) on a
               loopback port: the SPA's default form (num_beams 3, sampled,
               max_mel_tokens 100) followed over its SSE status to the wav, a
               streaming request, and 4 concurrent num_beams=1 requests through
               the slot session, each timed; K1 109 launches per vocoder
               call; the directory is deleted at the end;
     legacy  — the GPT code off the engine's default path at the published
               GPT widths, bf16: for condition_type "perceiver" and "default"
               an engine (random init, each AttentionBlock's proj_out set to
               seeded non-zero values), a greedy 100-code infer (K1 109
               launches per vocoder call) and get_conditioning against the
               CPU in float32 (LEGACY_COND_RTOL); on the flagship,
               inference_speech with an 8-code prefix and 2 return
               sequences, greedy (max_new capped at max_mel_tokens - 9) and
               with 3 beams; unified_voice_forward(return_latent=False) on
               200 teacher-forced codes, losses against the CPU's in float32
               (LEGACY_LOSS_RTOL), with times;
     fidelity — tools/eval_fidelity.py's loop on the port at the published
               widths: bigvgan_discriminator.pth (tests/make_torch_ckpt.py)
               and a dvae.pth written from the port's seeded DVAE under
               build/, a flagship greedy 100-code infer as the resynthesized
               wav (K1 109 launches per vocoder call), then
               indextts_tpu_torch.eval_fidelity.main on the card and on the
               CPU, called as shipped with TF32 allowed (the tool runs in
               float32 with TF32 off and restores the flags): both JSON
               reports, the DVAE round trip's and MPD + MRD's
               device-synchronized ms, DVAE codes equal, losses within
               FIDELITY_RTOL;
     mesh    — the multi-device path (indextts_tpu_torch/parallel/mesh.py)
               at the published widths, on mesh_layout's ranks: two sharing
               the card over gloo on one card, two over NCCL on two or
               three, four over NCCL at dp = 2 x tp = 2 on four or more
               (after nccl_probe: a captured 49-collective toy step inside
               the decode block's IF bodies on two cards, NCCL's, torch's
               CUDA and the driver's versions and the step's node types),
               each rank building the whole model from seed 0 and keeping
               its shard, against one process on the first card: float32
               with TF32 off at tp = 2 (16 forced steps' logits within
               MESH_F32_GATE, a greedy 32-code request token for token),
               bf16 at tp = 2 (the forced steps within MESH_BF16_GATE, a
               greedy 100-code request), bf16 at dp = 2 (infer_batch of 4
               requests, K1 109 launches per vocoder call on each rank),
               int8 weights at tp = 2 (K5 on every shard shape against its
               plain version, 97 launches a step on each rank, its own
               device ms beside one process's); then each rank's requests
               eager and through its captured stages (graphs.py's rule for
               the backend): codes token-exact (greedy, sampled and 3 beams,
               with the stop bias raised, infer_batch of 4, a SlotSession of
               4 slots serving 6 requests, infer_stream and int8 weights),
               conditioning and latent passes within 1 bf16 unit, the
               vocoder bit-equal, host reads one a block, the stages'
               decision logs equal across each model group, and host and
               device ms of the B = 4 decode step, eager beside captured,
               beside one process's block, and of the slot session's ticks;
               (`--phases meshgraphs` runs the probe and this second part
               alone);
     graphs  — (in a process of its own) the engine's captured programs
               (indextts_tpu_torch/graphs.py) at the published widths,
               bf16: first a toy loop in
               blocks of conditional steps (csrc/graph_block.cu; torch's and
               the driver's CUDA versions printed), replayed against eager
               with a stop mid-block, also with a step that records and
               waits on an external event (which the IF bodies drop);
               warmup twice (its captures, then
               replays), then each request under the engine's private eager
               switch, replayed, and replayed again, its code rows
               token-exact, K1-K8's launches and the blocks' host reads
               equal in the three: greedy and sampled num_beams=1, greedy
               and default num_beams=3, a 320-code segmented request, with
               fast_latents a sampled and a default request, infer_stream
               and a SlotSession of 4 slots serving 8 requests, then all of
               them again with the stop code's bias raised so that rows stop
               mid-block, and on the int8 KV cache with int8 weights a greedy
               and a default request, without and with the raise; the
               conditioning (b = 1, 2; and each legacy condition type in the
               legacy phase) and latent passes (b = 1 and 4, and on int8
               weights, where K5 must not launch) replayed within 1 bf16 unit
               of eager, ms of each; the vocoder (one 100-code call and one
               batch of 2) on the four routes (default, INDEXTTS_WIDE_BRANCH,
               INDEXTTS_WIDE_TMAJOR, INDEXTTS_FUSED_AA), wav within 1 int16
               unit, launches a call as eager; host and device ms per step,
               kernels and the idle share, eager beside replayed in blocks
               and replayed one step a call, of the B = 4 bf16 and int8 (KV +
               K5) decode steps, a 4-row slot step, a 3-beam step and a
               100-code vocoder call; capture seconds and pool growth per key;
  8. report  — one JSON line of kernel results, the nvidia-smi line, and the
               final {"ok": true, ...} line.

It needs the repository around it and a CUDA device, and imports no JAX.
Details go to chiprun_out/chip_smoke_report.json.
`--phases a,b` (of kernel, k2, k3, k4, k5, engine, beam, stream, serve, int8,
small, ckpt, legacy, fidelity, mesh, meshgraphs, graphs) runs
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
K6_REPLACES = "none: XLA's attention in indextts_tpu/models/gpt_decode.py _decode_block / _decode_block_q"
K6_SOURCE = "indextts_tpu_torch/csrc/decode_attn.cu"
K7_REPLACES = "none: the JAX package runs no state-space layer"
K8_REPLACES = "none: XLA fuses the GPT-2 block's residual adds, LayerNorms and gelu_new (indextts_tpu/models/gpt.py)"
K8_SOURCE = "indextts_tpu_torch/csrc/gpt2_chains.cu"
K7_SOURCE = "indextts_tpu_torch/csrc/ssm_step.cu"
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


# K6 at the decode loops' shapes, (label, cache, B, H, S, valid columns): the
# batch and beam loops mid-decode (32 latents, a text bucket of 96 and 3
# more, 100 of 200 codes written) and 32 int8 slots of S = 320 with 60 % of
# their columns valid, as the benchmark's cells run them; H = 20, Dh = 64
K6_CASES = [("batch8", "bf16", 8, 20, 331, 231), ("beams3", "bf16", 3, 20, 331, 231),
            ("slots32", "int8", 32, 20, 320, None)]


def k6_phase(card: str) -> dict:
    """K6 (decode_attn) at K6_CASES: err against the formula in float64
    beside the plain path's, two runs bit-equal; device times of the kernel
    and of the plain path per layer, with one cache per layer of a step
    cycled (24 layers, past the L2 cache, as a step finds them), and K6's
    bound: the valid columns' K / V (and scales), the bias, q, k, v, the
    output and the written column, over 3.35 TB/s. Then the rule PyTorch's
    int8 scale follows on the card (amax / 127.0 against amax * (1 / 127)
    and a true division), which K6's write reproduces."""
    import itertools

    import torch

    from indextts_tpu_torch.ops.cuda import decode_attn as k6

    g = torch.Generator(device="cuda").manual_seed(6)
    layers = load_config(FLAGSHIP).gpt.layers
    rows, failures = [], []
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for label, kind, b, h, s_len, n_valid in K6_CASES:
        dh, pos = 64, (n_valid if n_valid is not None else 200)
        y = torch.randn(b, 3 * h * dh, device="cuda", generator=g).to(torch.bfloat16)
        q, k, v = (t.reshape(b, h, dh) for t in y.split(h * dh, dim=-1))
        cols = torch.arange(s_len, device="cuda")[None, :]
        if n_valid is None:
            valid = torch.rand(b, s_len, device="cuda", generator=g) < 0.6
        else:
            valid = (cols < n_valid).expand(b, s_len)
        valid = valid & (cols != pos)
        bias = torch.where(valid, torch.zeros((), device="cuda"), torch.finfo(torch.float32).min)[:, None, :]
        posd = torch.tensor([pos], device="cuda")
        caches = []
        for _ in range(layers):
            kv = [torch.randn(b, h, s_len, dh, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2)]
            if kind == "int8":
                (k8, ks), (v8, vs) = k6.quant_cols(kv[0]), k6.quant_cols(kv[1])
                caches.append((k8, ks, v8, vs))
            else:
                caches.append(tuple(kv))
        ref = k6.decode_attn_f64(q, k, v, caches[0], bias)
        first = k6.decode_attn(q, k, v, tuple(c.clone() for c in caches[0]), posd, bias)
        again = k6.decode_attn(q, k, v, tuple(c.clone() for c in caches[0]), posd, bias)
        plain = k6.decode_attn_plain(q, k, v, tuple(c.clone() for c in caches[0]), posd, bias)
        torch.cuda.synchronize()
        err = (first.double() - ref).abs().max().item()
        err_plain = (plain.double() - ref).abs().max().item()
        same = bool(torch.equal(first, again))
        it = itertools.cycle(caches)
        kern = lambda: k6.decode_attn(q, k, v, next(it), posd, bias)
        plain_fn = lambda: k6.decode_attn_plain(q, k, v, next(it), posd, bias)
        ms, plain_ms = cuda_time_ms(kern, 2 * layers), cuda_time_ms(plain_fn, 2 * layers)
        prof = device_profile(kern, 2 * layers, ("decode_attn_kernel",))
        prof_plain = device_profile(plain_fn, 2 * layers)
        dev_ms = None if prof is None else prof["own_ms"]["decode_attn_kernel"]
        dev_plain_ms = None if prof_plain is None else prof_plain["call_ms"]
        plain_kernels = None if prof_plain is None else prof_plain["kernels"]
        cols_read = int(valid.sum())  # (row, column) pairs the kernel reads, per head
        per_col = 2 * dh * (1 if kind == "int8" else 2) + (4 if kind == "int8" else 0)  # K + V (+ their scale share)
        nbytes = (cols_read * h * per_col + b * s_len * 4 + 4 * b * h * dh * 2
                  + b * h * 2 * dh * (1 if kind == "int8" else 2))
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        row = dict(case=label, cache=kind, B=b, H=h, S=s_len, Dh=dh, valid_columns=cols_read, bytes=nbytes,
                   max_abs_err_f64=err, plain_max_abs_err_f64=err_plain, err_over_plain=err / err_plain,
                   bit_equal_runs=same, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, device_plain_ms=dev_plain_ms,
                   plain_kernels=plain_kernels, bound_ms=bound_ms,
                   roofline=None if not dev_ms else bound_ms / dev_ms,
                   per_step_ms=None if dev_ms is None else layers * dev_ms,
                   plain_per_step_ms=None if dev_plain_ms is None else layers * dev_plain_ms,
                   ok=bool(err <= err_plain and same))
        rows.append(row)
        log(f"[k6] {label:8s} {kind} B={b:2d} H={h} S={s_len} ({cols_read} valid row-columns) err vs f64 {err:.3e}, "
            f"plain {err_plain:.3e} (ratio {err / err_plain:.3f}), two runs bit-equal {same} | events: kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms | device: kernel {fmt(dev_ms)} ms, plain {fmt(dev_plain_ms)} ms in "
            f"{fmt(plain_kernels)} kernels; bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB); per step of {layers} "
            f"layers: kernel {fmt(row['per_step_ms'])} ms, plain {fmt(row['plain_per_step_ms'])} ms [{card}]")
        if not row["ok"]:
            failures.append(row)
        del caches
    amax = torch.rand(1 << 20, device="cuda", generator=g) * 10
    torch_scale = amax / 127.0
    rule = {"times_reciprocal": int((torch_scale != amax * (1.0 / 127.0)).sum()),
            "true_division": int((torch_scale != torch.div(amax, torch.full_like(amax, 127.0))).sum())}
    log(f"[k6] amax / 127.0 on the card differs from amax * (1 / 127) in {rule['times_reciprocal']} and from a "
        f"true division in {rule['true_division']} of {amax.numel()} values [{card}]")
    if failures:
        raise AssertionError(f"K6 is farther from float64 than the plain path, or two runs differ: {failures}")
    return {"rows": rows, "scale_rule": rule}


# K8 at the GPT-2 step's shapes, (label, rows): the batch loop's 8 rows, 3 beams, 32 slots a decode step,
# and one prefill of 8 rows x 160 positions; D = 1280 (the LayerNorms), 4 D = 5120 (gelu_new), bf16
K8_CASES = [("batch8", 8), ("beams3", 3), ("slots32", 32), ("prefill8x160", 8 * 160)]


def k8_phase(card: str) -> dict:
    """K8 (gpt2_chains.add_layer_norm, with a delta) at K8_CASES, beside the
    block's gelu_new on the card (PyTorch's tanh GELU): each against float64
    beside the plain path's error, two runs bit-equal, x_new bit-equal to the
    card's bf16 add; add_layer_norm's library yardstick too (the bf16 add,
    then F.layer_norm on the bf16 sum: 2 kernels). Own device time of the
    kernel (profiler events of its __global__ function), the device time of
    the plain path and of the library calls, CUDA-event times, and the
    bound: x and d read, x_new and y written (gelu_new: read and written)
    over 3.35 TB/s. Per decode step: 2 x layers + 1 add_layer_norm (layer
    0's ln_1, which has no delta, counted at the delta's time) and layers
    gelu_new."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8

    cfg = load_config(FLAGSHIP).gpt
    dim, layers = cfg.model_dim, cfg.layers
    g = torch.Generator(device="cuda").manual_seed(8)
    gamma = (1.0 + 0.3 * torch.randn(dim, device="cuda", generator=g)).to(torch.bfloat16)
    beta = (0.2 * torch.randn(dim, device="cuda", generator=g)).to(torch.bfloat16)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    pick = lambda r, key, fallback: r[key] if r[key] is not None else r[fallback]
    rows_out, failures = [], []
    for label, rows in K8_CASES:
        x = (2.0 * torch.randn(rows, dim, device="cuda", generator=g)).to(torch.bfloat16)
        d = torch.randn(rows, dim, device="cuda", generator=g).to(torch.bfloat16)
        h = (3.0 * torch.randn(rows, 4 * dim, device="cuda", generator=g)).to(torch.bfloat16)
        library_ln = lambda: F.layer_norm(x + d, (dim,), gamma, beta, 1e-5)
        # name: (the route's call, its plain version, a library yardstick or None, the kernel's own name or None
        # (the whole call), bytes)
        fns = {"add_layer_norm": (lambda: k8.add_layer_norm(x, d, gamma, beta)[1],
                                  lambda: k8.add_layer_norm_plain(x, d, gamma, beta)[1], library_ln,
                                  "add_layer_norm", (4 * rows * dim + 2 * dim) * 2),
               "gelu_new": (lambda: k8.gelu_new(h), lambda: k8.gelu_new_plain(h), None, None,
                            2 * rows * 4 * dim * 2)}
        row = dict(case=label, rows=rows, D=dim)
        x_new, _ = k8.add_layer_norm(x, d, gamma, beta)
        x_again, _ = k8.add_layer_norm(x, d, gamma, beta)
        torch.cuda.synchronize()
        refs = {"add_layer_norm": k8.add_layer_norm_f64(x, d, gamma, beta), "gelu_new": k8.gelu_new_f64(h)}
        same, ok = bool(torch.equal(x_new, x_again)), True
        sum_exact = bool(torch.equal(x_new, x + d))
        for name, (route, plain_fn, library_fn, own, nbytes) in fns.items():
            err_of = lambda fn: (fn().double() - refs[name]).abs().max().item()
            y, y_again = route(), route()
            same = same and bool(torch.equal(y, y_again))
            err, err_plain = err_of(route), err_of(plain_fn)
            ok = ok and err <= err_plain
            prof, prof_plain = device_profile(route, 200, (own,) if own else ()), device_profile(plain_fn, 200)
            dev_ms = None if prof is None else (prof["own_ms"][own] if own else prof["call_ms"])
            out = dict(max_abs_err_f64=err, plain_max_abs_err_f64=err_plain, ms=cuda_time_ms(route, 200),
                       plain_ms=cuda_time_ms(plain_fn, 200), device_ms=dev_ms,
                       kernels=None if prof is None else prof["kernels"],
                       device_plain_ms=None if prof_plain is None else prof_plain["call_ms"],
                       plain_kernels=None if prof_plain is None else prof_plain["kernels"],
                       bytes=nbytes, bound_ms=1e3 * nbytes / PEAK_BYTES,
                       roofline=None if not dev_ms else 1e3 * nbytes / PEAK_BYTES / dev_ms)
            extra = ""
            if library_fn is not None:
                prof_lib = device_profile(library_fn, 200)
                out.update(library_max_abs_err_f64=err_of(library_fn), library_ms=cuda_time_ms(library_fn, 200),
                           device_library_ms=None if prof_lib is None else prof_lib["call_ms"],
                           library_kernels=None if prof_lib is None else prof_lib["kernels"])
                extra = (f" | library (bf16 add, F.layer_norm): err {out['library_max_abs_err_f64']:.3e}, "
                         f"events {out['library_ms']:.4f} ms, device {fmt(out['device_library_ms'])} ms in "
                         f"{fmt(out['library_kernels'])} kernels")
            row[name] = out
            log(f"[k8] {label:12s} {name:14s} rows={rows:4d} err vs f64 {err:.3e}, plain {err_plain:.3e} "
                f"| events: route {out['ms']:.4f} ms plain {out['plain_ms']:.4f} ms | device: route {fmt(dev_ms)} ms "
                f"in {fmt(out['kernels'])} kernels, plain {fmt(out['device_plain_ms'])} ms in "
                f"{fmt(out['plain_kernels'])} kernels; bound {out['bound_ms']:.5f} ms ({nbytes / 1e3:.1f} KB){extra} "
                f"[{card}]")
        ln, gl = row["add_layer_norm"], row["gelu_new"]
        n_ln = 2 * layers + 1
        row.update(per_step_ms=n_ln * pick(ln, "device_ms", "ms"),
                   plain_per_step_ms=n_ln * pick(ln, "device_plain_ms", "plain_ms"),
                   library_per_step_ms=n_ln * pick(ln, "device_library_ms", "library_ms"),
                   bound_per_step_ms=n_ln * ln["bound_ms"],
                   gelu_per_step_ms=layers * pick(gl, "device_ms", "ms"),
                   gelu_plain_per_step_ms=layers * pick(gl, "device_plain_ms", "plain_ms"),
                   gelu_bound_per_step_ms=layers * gl["bound_ms"],
                   bit_equal_runs=same, sum_bit_equal_to_bf16_add=sum_exact, ok=bool(same and sum_exact and ok))
        log(f"[k8] {label:12s} per decode step: {n_ln} add_layer_norm {row['per_step_ms']:.4f} ms (plain "
            f"{row['plain_per_step_ms']:.4f}, library {row['library_per_step_ms']:.4f}, bound "
            f"{row['bound_per_step_ms']:.4f}); {layers} gelu_new {row['gelu_per_step_ms']:.4f} ms (plain "
            f"{row['gelu_plain_per_step_ms']:.4f}, bound {row['gelu_bound_per_step_ms']:.4f}); two runs bit-equal "
            f"{same}, x_new = the bf16 add {sum_exact} [{card}]")
        rows_out.append(row)
        if not row["ok"]:
            failures.append(row)
    if failures:
        raise AssertionError(f"K8 or gelu_new is farther from float64 than the plain path, or two runs differ: "
                             f"{failures}")
    return {"rows": rows_out}


# granite-4.0-h-micro's hybrid decoder (benchmark/configs/indextts-granite-4.0-h-micro-serve.json): 36 Mamba-2
# layers of 64 heads of 64 x 128, 4 attention layers of 32 query and 8 KV heads of 64
K7_ROWS = (3, 8, 32)
GRANITE = dict(layers=36, heads=64, head_dim=64, d_state=128, d_conv=4, model_dim=2048, attn_layers=4, q_heads=32,
               kv_heads=8, scale=0.015625)


def k7_phase(card: str) -> dict:
    """K7 (ssm_step) and K6's grouped-query instance at granite-4.0-h-micro's
    widths, per layer at 3 / 8 / 32 rows. K7 against its plain version (the
    gated output and both states, two runs bit-equal), the own device time
    of ssm_step_kernel with one state per layer of a step cycled (36 layers,
    past the L2 cache), the plain version's, and the bound: the float32 SSM
    state read and written, the conv state read and written, the token's
    inputs, the output and the weights, over 3.35 TB/s. K6 with 4 query heads
    a KV head on the int8 slot cache (S = 320, 8 KV heads) and on the bf16
    cache, against float64 beside the plain path, with its own time and
    bound (each KV head read once)."""
    import itertools

    import torch

    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import ssm_step as k7

    gz = GRANITE
    h, p, n, k, d = gz["heads"], gz["head_dim"], gz["d_state"], gz["d_conv"], gz["model_dim"]
    di, cd = h * p, h * p + 2 * n
    g = torch.Generator(device="cuda").manual_seed(7)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    rows, failures = [], []
    w = (0.3 * torch.randn(cd, 1, k, device="cuda", generator=g)).to(torch.bfloat16)
    wb = (0.01 * torch.randn(cd, device="cuda", generator=g)).to(torch.bfloat16)
    dt_bias = (2.0 * torch.randn(h, device="cuda", generator=g)).to(torch.bfloat16)
    a_log = (0.5 * torch.randn(h, device="cuda", generator=g)).to(torch.bfloat16)
    d_skip = (1 + 0.05 * torch.randn(h, device="cuda", generator=g)).to(torch.bfloat16)
    for b in K7_ROWS:
        zx = torch.randn(b, di + cd + h, device="cuda", generator=g).to(torch.bfloat16)
        layers = [(torch.randn(b, cd, k - 1, device="cuda", generator=g).to(torch.bfloat16),
                   torch.randn(b, h, p, n, device="cuda", generator=g)) for _ in range(gz["layers"])]
        conv0, st0 = layers[0]
        runs = []
        for _ in range(2):
            conv, st = conv0.clone(), st0.clone()
            out = k7.ssm_step(zx, conv, w, wb, dt_bias, a_log, d_skip, st, h, p, n)
            runs.append((out, conv, st))
        conv, st = conv0.clone(), st0.clone()
        plain = k7.ssm_step_plain(zx, conv, w, wb, dt_bias, a_log, d_skip, st, h, p, n)
        torch.cuda.synchronize()
        abs_err = max((runs[0][0] - plain).abs().max().item(), (runs[0][2] - st).abs().max().item())
        err = max((runs[0][0] - plain).abs().max().item() / plain.abs().max().item(),
                  (runs[0][2] - st).abs().max().item() / st.abs().max().item())
        conv_same = bool(torch.equal(runs[0][1], conv))
        same = all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
        it = itertools.cycle(layers)

        def kern(fn=k7.ssm_step):
            conv, st = next(it)
            return fn(zx, conv, w, wb, dt_bias, a_log, d_skip, st, h, p, n)

        plain_fn = lambda: kern(k7.ssm_step_plain)
        ms, plain_ms = cuda_time_ms(kern, 2 * gz["layers"]), cuda_time_ms(plain_fn, 2 * gz["layers"])
        prof = device_profile(kern, 2 * gz["layers"], ("ssm_step_kernel",))
        prof_plain = device_profile(plain_fn, 2 * gz["layers"])
        dev_ms = None if prof is None else prof["own_ms"]["ssm_step_kernel"]
        dev_plain_ms = None if prof_plain is None else prof_plain["call_ms"]
        nbytes = (b * (2 * 4 * h * p * n + 2 * 2 * cd * (k - 1) + 2 * (di + cd + h) + 4 * di)
                  + 2 * cd * (k + 1) + 3 * 4 * h)
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        row = dict(kernel="k7", B=b, max_rel_err=err, max_abs_err=abs_err, conv_state_equal=conv_same, bit_equal_runs=same, ms=ms,
                   plain_ms=plain_ms, device_ms=dev_ms, device_plain_ms=dev_plain_ms, bytes=nbytes, bound_ms=bound_ms,
                   roofline=None if not dev_ms else bound_ms / dev_ms,
                   per_step_ms=None if dev_ms is None else gz["layers"] * dev_ms,
                   ok=bool(err < 1e-4 and conv_same and same))
        rows.append(row)
        log(f"[k7] B={b:2d} rel err vs plain {err:.3e}, conv state equal {conv_same}, two runs bit-equal {same} | "
            f"events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms | device: kernel {fmt(dev_ms)} ms, plain "
            f"{fmt(dev_plain_ms)} ms; bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB), roofline "
            f"{fmt(None if not dev_ms else 100 * bound_ms / dev_ms)} %; per step of {gz['layers']} layers: kernel "
            f"{fmt(row['per_step_ms'])} ms [{card}]")
        if not row["ok"]:
            failures.append(row)
        del layers
    hq, hk, dh, s_len = gz["q_heads"], gz["kv_heads"], 64, 320
    for kind, b in (("int8", 32), ("bf16", 8), ("bf16", 3)):
        y = torch.randn(b, (hq + 2 * hk) * dh, device="cuda", generator=g).to(torch.bfloat16)
        q, kk, v = (t.unflatten(-1, (-1, dh)) for t in y.split([hq * dh, hk * dh, hk * dh], dim=-1))
        valid = (torch.rand(b, s_len, device="cuda", generator=g) < 0.6) & (torch.arange(s_len, device="cuda") != 200)
        bias = torch.where(valid, torch.zeros((), device="cuda"), torch.finfo(torch.float32).min)[:, None, :]
        posd = torch.tensor([200], device="cuda")
        caches = []
        for _ in range(gz["attn_layers"] * 8):
            kv = [torch.randn(b, hk, s_len, dh, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2)]
            caches.append(k6.quant_cols(kv[0]) + k6.quant_cols(kv[1]) if kind == "int8" else tuple(kv))
        ref = k6.decode_attn_f64(q, kk, v, caches[0], bias, gz["scale"])
        first = k6.decode_attn(q, kk, v, tuple(c.clone() for c in caches[0]), posd, bias, gz["scale"])
        plain = k6.decode_attn_plain(q, kk, v, tuple(c.clone() for c in caches[0]), posd, bias, gz["scale"])
        torch.cuda.synchronize()
        err = (first.double() - ref).abs().max().item()
        err_plain = (plain.double() - ref).abs().max().item()
        it = itertools.cycle(caches)
        kern = lambda: k6.decode_attn(q, kk, v, next(it), posd, bias, gz["scale"])
        plain_fn = lambda: k6.decode_attn_plain(q, kk, v, next(it), posd, bias, gz["scale"])
        prof = device_profile(kern, len(caches), ("decode_attn_kernel",))
        prof_plain = device_profile(plain_fn, len(caches))
        dev_ms = None if prof is None else prof["own_ms"]["decode_attn_kernel"]
        dev_plain_ms = None if prof_plain is None else prof_plain["call_ms"]
        cols_read = int(valid.sum())
        per_col = 2 * dh * (1 if kind == "int8" else 2) + (4 if kind == "int8" else 0)
        nbytes = (cols_read * hk * per_col + b * s_len * 4 + 2 * b * hq * dh * 2 + 2 * b * hk * dh * 2
                  + b * hk * 2 * dh * (1 if kind == "int8" else 2))
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        row = dict(kernel="k6_gqa", cache=kind, B=b, Hq=hq, Hkv=hk, S=s_len, err_f64=err, plain_err_f64=err_plain,
                   device_ms=dev_ms, device_plain_ms=dev_plain_ms, bytes=nbytes, bound_ms=bound_ms,
                   roofline=None if not dev_ms else bound_ms / dev_ms, ok=bool(err <= err_plain))
        rows.append(row)
        log(f"[k6-gqa] {kind} B={b:2d} Hq={hq} Hkv={hk} S={s_len} err vs f64 {err:.3e}, plain {err_plain:.3e} | "
            f"device: kernel {fmt(dev_ms)} ms, plain {fmt(dev_plain_ms)} ms; bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.2f} MB) [{card}]")
        if not row["ok"]:
            failures.append(row)
        del caches
    if failures:
        raise AssertionError(f"K7 differs from its plain version, or K6-GQA is farther from float64 than the plain "
                             f"path: {failures}")
    return {"rows": rows}


GRANITE_CONFIG = os.path.join(REPO, "benchmark", "configs", "indextts-granite-4.0-h-micro-serve.json")


def hybrid_engine():
    """The port's engine of the hybrid configuration (GRANITE_CONFIG's gpt
    and bigvgan sections and engine flags: bf16, the int8 KV cache,
    fast_latents), its own random weights from seed 0."""
    from indextts_tpu_torch.config import IndexTTSConfig, save_config
    from indextts_tpu_torch.engine import IndexTTS

    with open(GRANITE_CONFIG) as f:
        cfg = json.load(f)
    d = os.path.join(REPO, "build", "hybrid_engine")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "config.yaml")
    save_config(IndexTTSConfig.from_dict({"gpt": cfg["gpt"], "bigvgan": cfg["bigvgan"]}), path)
    e = cfg["engine"]
    return IndexTTS(cfg_path=path, model_dir=d, is_fp16=e["dtype"] == "bfloat16", device="cuda",
                    use_cuda_kernel=True, allow_random_init=True, seed=0, quant_kv=e["quant_kv"],
                    fast_latents=e["fast_latents"])


def hybrid_phase(card: str) -> dict:
    """The hybrid decoder at its published widths through the engine's
    entry points on the card: one infer (one sampled row, K6's GQA instance
    on the int8 cache, K7), then a slot session of 8 slots (10 sampled
    requests, one streamed, rows admitted into freed slots), each with the
    launch counters set to 0 just before. K7 must launch once a Mamba layer
    and K6 once an attention layer in every decode step the call ran (steps
    of infer's loop; ticks of the slot state, every slot in each launch),
    eager or replayed. Then 4 sampled rows' decode steps under the profiler,
    eager and replayed: its count of ssm_step_kernel and decode_attn_kernel
    must be the same a step (step_profile). Run in a process of its own (it
    profiles replayed blocks)."""
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import ssm_step as k7

    t0 = time.perf_counter()
    engine = hybrid_engine()
    cfg = engine.cfg.gpt
    with torch.no_grad():  # every row decodes its budget, as the benchmark's weights do (stop_logit)
        engine.gpt.mel_head.bias[engine.stop_mel_token] = -40.0
    mamba = sum(kind == "mamba" for kind in cfg.layer_types)
    attn = len(cfg.layer_types) - mamba
    if (mamba, attn, cfg.model_dim) != (GRANITE["layers"], GRANITE["attn_layers"], GRANITE["model_dim"]):
        raise AssertionError(f"{GRANITE_CONFIG}: {mamba} Mamba and {attn} attention layers of {cfg.model_dim}, want "
                             f"granite-4.0-h-micro's {GRANITE['layers']} and {GRANITE['attn_layers']} of "
                             f"{GRANITE['model_dim']}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spc = engine._samples_per_code()
    max_new = 100
    mel = engine.extract_features(PROMPT)
    half = np.ascontiguousarray(mel[..., : mel.shape[-1] // 2])

    def start():
        k6.launches = k7.launches = 0

    def counted(what: str, steps: int) -> dict:
        want = {"k7": mamba * steps, "k6": attn * steps}
        got = {"k7": k7.launches, "k6": k6.launches}
        if got != want or not steps:
            raise AssertionError(f"{what}: launches {got} over {steps} decode steps, want {want} (one a Mamba / "
                                 f"attention layer a step)")
        return dict(got, steps=steps)

    # (a) one infer: a sampled row, one sentence
    engine.infer(mel, "HELLO WORLD.", None, do_sample=True, num_beams=1, max_mel_tokens=max_new)  # warm, capture
    start()
    t = time.perf_counter()
    sr, wav = engine.infer(mel, "HELLO WORLD.", None, do_sample=True, num_beams=1, max_mel_tokens=max_new)
    infer_s = time.perf_counter() - t
    st = dict(engine.last_stats)
    infer = dict(counted("infer", st["gpt_steps"]), total_s=infer_s, codes=int(wav.shape[0]) // spc,
                 decode_ms_per_step=1e3 * st["gpt_gen_s"] / max(st["gpt_steps"], 1))
    if sr != 24000 or wav.dtype != np.int16 or not spc <= wav.shape[0] <= max_new * spc:
        raise AssertionError(f"infer: wav {wav.shape} {wav.dtype} at {sr} Hz, want 1-{max_new} codes at 24000")
    log(f"[hybrid] engine of {os.path.basename(GRANITE_CONFIG)} ({mamba} Mamba + {attn} attention layers of "
        f"{cfg.model_dim}, int8 KV, fast_latents) built in {init_s:.1f} s; infer, 1 sampled row: {infer['codes']} "
        f"codes, {infer['steps']} steps at {infer['decode_ms_per_step']:.2f} ms/step; K7 {infer['k7']}, K6 "
        f"{infer['k6']} launches [{card}]")

    # (b) a slot session: 10 requests over 8 slots, one streamed; two wait for freed slots
    texts = ["HELLO WORLD.", "GOOD DAY TO YOU.", "THIS IS A TEST.", "THE QUICK BROWN FOX.", "HELLO AGAIN.",
             "GOOD DAY.", "A TEST.", "ONE MORE.", "AND ANOTHER.", "THE LAST ONE."]

    def session():
        sess = engine.slot_session(n_slots=8, chunk_steps=25, do_sample=True, max_mel_tokens=max_new)
        chunks = []
        rids = [sess.submit(half if i % 2 else mel, text, on_chunk=(lambda rid, c: chunks.append(c.copy())) if i == 0
                            else None) for i, text in enumerate(texts)]
        done, ticks = {}, 0
        while sess.busy and ticks < 60:
            done.update(sess.tick())
            ticks += 1
        rest = sess.drain()
        if rest or sess.busy or set(done) != set(rids):
            raise AssertionError(f"slot session: completed {sorted(done)} of {sorted(rids)}; left {sorted(rest)}")
        for rid in rids:
            if done[rid][1].shape != (max_new * spc, 1):
                raise AssertionError(f"slot request {rid}: wav {done[rid][1].shape}, want {max_new} codes")
        if not np.array_equal(np.concatenate(chunks), done[rids[0]][1].reshape(-1)):
            raise AssertionError("the streamed chunks do not concatenate to the streaming request's result")
        return sess, ticks

    session()  # warm: captures the slot stage's keys
    start()
    t = time.perf_counter()
    sess, ticks = session()
    slots = dict(counted("slot session", int(sess.state.tick)), ticks=ticks, total_s=time.perf_counter() - t,
                 chunk_ms_per_step=1e3 * sum(sess.chunk_s) / max(int(sess.state.tick), 1))
    log(f"[hybrid] slot session, 8 slots, {len(texts)} sampled requests (one streamed), {max_new} codes each: "
        f"{ticks} ticks, {slots['steps']} slot steps at {slots['chunk_ms_per_step']:.2f} ms/step; K7 {slots['k7']}, "
        f"K6 {slots['k6']} launches [{card}]")

    # (c) the profiler's count of K6's and K7's kernels a decode step, eager and replayed
    conds1 = engine._conds_for(mel)
    step = step_profile(engine, b4_decode(engine, conds1, 16, True), card, "hybrid decode step, B=4, int8 KV",
                        {"k6": attn, "k7": mamba}, modes=("eager", "graph"), own=("ssm_step_kernel",))
    return {"init_s": init_s, "infer": infer, "slots": slots, "step": step,
            "k7_launches": infer["k7"] + slots["k7"], "k6_launches": infer["k6"] + slots["k6"]}


def flagship_engine(quant_kv: bool = False, fast_latents: bool = False):
    from indextts_tpu_torch.engine import IndexTTS

    # configs/ holds no bpe.model: the engine builds its random-init tokenizer
    return IndexTTS(cfg_path=FLAGSHIP, model_dir=os.path.join(REPO, "configs"), is_fp16=True, device="cuda",
                    use_cuda_kernel=True, allow_random_init=True, seed=0, quant_kv=quant_kv,
                    fast_latents=fast_latents)


def k8_per_pass(cfg) -> int:
    """K8's launches in one GPT-2 decode step or whole-sequence pass (a
    prefill, a latent pass): add_layer_norm into each layer's ln_1 and ln_2
    and into ln_f (49 at 24 layers)."""
    return 2 * cfg.layers + 1


def check_k8(what: str, launches: int, cfg, steps: int, prefills: int) -> int:
    """K8's launches over a run of `steps` decode steps and at least
    `prefills` whole-sequence passes: k8_per_pass a step and a pass, so
    (launches - per pass x steps) is a whole number of passes, at least
    `prefills`. Returns that number of passes."""
    per = k8_per_pass(cfg)
    passes, rest = divmod(launches - per * steps, per)
    log(f"[k8] {what}: {launches} launches = {per} x ({steps} decode steps + {passes} whole-sequence passes)"
        f"{f' + {rest}' if rest else ''}")
    if rest or passes < prefills or not steps:
        raise AssertionError(f"{what}: K8 launched {launches} times over {steps} decode steps, want {per} a step and "
                             f"{per} for each of at least {prefills} whole-sequence passes")
    return passes


def engine_phase(card: str) -> dict:
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8

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
    k1.launches = k6.launches = k8.launches = 0  # the main path's run starts here
    results, vocoder_calls, decode_steps, gpt_calls = [], 0, 0, 0
    for name, kw in requests:
        start = len(vocoded)
        sr, wav = engine.infer(audio_prompt=PROMPT, **kw)
        st = dict(engine.last_stats)
        these = vocoded[start:]
        vocoder_calls += st["vocoder_calls"]
        decode_steps += st["gpt_steps"]
        gpt_calls += st["gpt_calls"]
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
    layers = engine.cfg.gpt.layers
    log(f"[engine] K1 launches {launches} over {vocoder_calls} vocoder calls (want {per_call} x {vocoder_calls}); "
        f"K6 launches {k6.launches} over {decode_steps} decode steps (want {layers} x {decode_steps})")
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times, want {per_call} x {vocoder_calls} = {want}")
    if k6.launches != layers * decode_steps or not decode_steps:
        raise AssertionError(f"K6 launched {k6.launches} times over {decode_steps} decode steps, want {layers} a step")
    k6_launches, k8_launches = k6.launches, k8.launches
    k8_passes = check_k8("engine", k8_launches, engine.cfg.gpt, decode_steps, gpt_calls)

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
            "k6_launches": k6_launches, "k8_launches": k8_launches, "k8_whole_sequence_passes": k8_passes,
            "decode_steps": decode_steps, "vocoder_ab": ab, "vocoder_profile": prof}


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


def forced_logits(engine, quant_kv: bool, steps: int = 16, own=(), warm: bool = True, profiled: bool = True):
    """Prefill and `steps` forced decode steps at B = 4, text rows of
    different lengths, the tokens drawn from a fixed seed. Returns the logits
    [steps + 1, B, V] (float32, on the host) and a profile of the steps: host
    ms per step (second run, synchronized), device ms per step and device
    kernels per step (third run, torch.profiler), and for each name in `own`
    the device ms per step of the kernels whose name holds it. warm=False
    (an engine that has run its shapes already) takes the logits from the
    timed run; profiled=False leaves the device numbers None."""
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

    if warm:
        logits, _ = run(contextlib.nullcontext())
        _, host_ms = run(contextlib.nullcontext())
    else:
        logits, host_ms = run(contextlib.nullcontext())
    if not profiled:
        return logits, {"host_ms_per_step": host_ms, "device_ms_per_step": None, "device_kernels_per_step": None,
                        "device_idle_share": None, "own_ms_per_step": {n: None for n in own}}
    prof = profile(activities=[ProfilerActivity.CUDA])
    run(prof)  # the profiler covers the decode steps only
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    kernels = sum(e.count for e in events) / steps
    own_ms = {n: (sum(e.self_device_time_total for e in events if n in e.key) / 1e3 / steps if events else None)
              for n in own}
    return logits, {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                    "device_kernels_per_step": kernels, "device_idle_share": 1.0 - device_ms / host_ms,
                    "own_ms_per_step": own_ms}


def int8_phase(card: str) -> dict:
    import numpy as np
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8
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
    k1.launches = k5.launches = k6.launches = k8.launches = 0  # the int8 path's run starts here
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
    want_k6 = engine.cfg.gpt.layers * gen_steps
    log(f"[int8] K5 launches {k5.launches} (want {gen_calls} + {per_step} x {gen_steps} = {want_k5}); "
        f"K1 launches {k1.launches} (want {per_voc} x {vocoder_calls} = {want_k1}); "
        f"K6 launches {k6.launches} (want {engine.cfg.gpt.layers} x {gen_steps} = {want_k6})")
    if k5.launches != want_k5 or k1.launches != want_k1 or k6.launches != want_k6 or not gen_steps:
        raise AssertionError(f"launch counts: K5 {k5.launches} (want {want_k5}), K1 {k1.launches} (want {want_k1}), "
                             f"K6 {k6.launches} (want {want_k6})")
    k8_launches = k8.launches
    k8_passes = check_k8("int8", k8_launches, engine.cfg.gpt, gen_steps, gen_calls)
    return {"init_s": init_s, "cold_first_request_s": cold_s, "drift": drift, "step_profile": step_profile,
            "requests": results,
            "k5_launches": k5.launches, "k1_launches": k1.launches, "k6_launches": k6.launches,
            "k8_launches": k8_launches, "k8_whole_sequence_passes": k8_passes,
            "generate_calls": gen_calls,
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
    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8

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
        layers = engine.cfg.gpt.layers
        results, k1_total, k2_total, k6_total, k8_total = [], 0, 0, 0, 0
        for name, method, quant_kv, kw in requests:
            engine.quant_kv = quant_kv
            k1.launches = k2.launches = k6.launches = k8.launches = 0  # this request of the main path starts here
            sr, wav = getattr(engine, method)(audio_prompt=PROMPT, **kw)
            launches = {"k1": k1.launches, "k2": k2.launches}
            st = dict(engine.last_stats)
            k1_total += launches["k1"]
            k2_total += launches["k2"]
            k6_total += k6.launches
            k8_total += k8.launches
            k8_passes = check_k8(name, k8.launches, engine.cfg.gpt, st["gpt_steps"], st["gpt_calls"])
            calls = st["vocoder_calls"]
            if launches != {"k1": 55 * calls, "k2": 54 * calls}:
                raise AssertionError(f"{name}: launches {launches} over {calls} vocoder calls, want 55 and 54 each")
            if k6.launches != layers * st["gpt_steps"] or not st["gpt_steps"]:
                raise AssertionError(f"{name}: K6 launched {k6.launches} times over {st['gpt_steps']} decode steps, "
                                     f"want {layers} a step")
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
                       k6_launches=k6.launches, k8_launches=k8.launches, k8_whole_sequence_passes=k8_passes,
                       total_s=st["total_s"], rtf=st["rtf"])
            results.append(row)
            log(f"[beam] {name} ({method}, num_beams 3{', int8 KV' if quant_kv else ''}): {row['codes']} codes, "
                f"{st['audio_s']:.2f} s audio | cond {row['cond_ms']:.1f} ms, decode {row['decode_ms_per_step']:.2f} "
                f"ms/step over {st['gpt_steps']} steps in {st['gpt_segments'] or 'no'} segments, latent "
                f"{row['latent_ms']:.1f} ms (teacher-forced rows "
                f"{st['tf_latent_rows']}), vocoder {row['vocoder_ms']:.1f} ms in {calls} call(s), total "
                f"{st['total_s']:.2f} s, RTF {st['rtf']:.4f}; K2 {launches['k2']}, K1 {launches['k1']}, K6 "
                f"{k6.launches} ({layers} x {st['gpt_steps']}) launches [{card}]")
        engine.quant_kv = False
        step = forced_beam_steps(engine)
        log(f"[beam] forced beam step, B=1 x 3 beams, {step['cache_slots']} cache slots: host "
            f"{step['host_ms_per_step']:.2f} ms/step, device {step['device_ms_per_step']:.3f} ms/step in "
            f"{step['device_kernels_per_step']:.0f} kernels, device idle {100 * step['device_idle_share']:.1f} %, "
            f"cache reorder {step['reorder_device_ms']} ms of device time ({step['cache_bytes'] / 1e6:.1f} MB) [{card}]")
    finally:
        del os.environ["INDEXTTS_WIDE_BRANCH"]
    return {"init_s": init_s, "cold_first_request_s": cold_s, "requests": results, "forced_step": step,
            "k1_launches": k1_total, "k2_launches": k2_total, "k6_launches": k6_total, "k8_launches": k8_total}


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
        before = int(state.tick)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = tslots.slot_steps(engine.gpt, cfg, gen, state, steps, g, pos_off=1, **knobs)
        torch.cuda.synchronize()
        if int(state.tick) - before != steps or not bool(state.active.all()):
            raise AssertionError(f"the forced slot chunk ran {int(state.tick) - before} of {steps} steps")
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
    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8

    # one vocoder call of an engine: its warm run or a replay of its graph
    voc = {"calls": 0}
    k8_launches = {}  # K8's launches and whole-sequence passes of the batch call and of the slot session
    vocoder_call = engine_mod.IndexTTS._vocoder_call

    def counting_call(self, *a, **kw):
        voc["calls"] += 1
        return vocoder_call(self, *a, **kw)

    def start():
        k1.launches = k3.launches = k4.launches = k6.launches = k8.launches = voc["calls"] = 0

    def decoded(what: str, steps: int, prefills: int) -> int:
        """K6's launches since start(): one a layer in each of `steps` decode
        steps; K8's held to check_k8 with at least `prefills` passes."""
        want = engine.cfg.gpt.layers * steps
        if k6.launches != want or not steps:
            raise AssertionError(f"{what}: K6 launched {k6.launches} times over {steps} decode steps, want {want}")
        k8_launches[what] = (k8.launches, check_k8(what, k8.launches, engine.cfg.gpt, steps, prefills))
        return k6.launches

    def launched(what: str, want=(54, 54, 1)) -> dict:
        got = {"k4": k4.launches, "k3": k3.launches, "k1": k1.launches, "vocoder_calls": voc["calls"]}
        if voc["calls"] < 1 or (got["k4"], got["k3"], got["k1"]) != tuple(n * voc["calls"] for n in want):
            raise AssertionError(f"{what}: launches {got}, want K4 {want[0]}, K3 {want[1]}, K1 {want[2]} per vocoder call")
        return got

    engine_mod.IndexTTS._vocoder_call = counting_call
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
        batch_launches["k6"] = decoded("infer_batch", st["gpt_steps"], st["gpt_calls"])
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
            f"{batch_launches['k3']}, K1 {batch_launches['k1']}, K6 {batch_launches['k6']} launches [{card}]")

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
        slot_launches["k6"] = decoded("slot session", int(sess.state.tick), len(rids))
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
            f"K1 {slot_launches['k1']} launches over {slot_launches['vocoder_calls']} vocoder calls, K6 "
            f"{slot_launches['k6']} over {int(sess.state.tick)} slot steps [{card}]")
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
        engine_mod.IndexTTS._vocoder_call = vocoder_call
        os.environ.pop("INDEXTTS_FUSED_AA", None)
        os.environ.pop("INDEXTTS_WIDE_TMAJOR", None)
    return {"init_s": init_s, "warmup_s": warm_s, "warmup": warm, "infer_batch": batch, "slots": slots,
            "forced_slot_chunk": step, "fused_aa_alone": fused_only, "fused_aa_vocoder_profile": voc_prof,
            "k4_launches": warm["k4"] + batch_launches["k4"] + slot_launches["k4"],
            "k3_launches": warm["k3"] + batch_launches["k3"] + slot_launches["k3"],
            "k1_launches": warm["k1"] + batch_launches["k1"] + slot_launches["k1"],
            "k6_launches": batch_launches["k6"] + slot_launches["k6"],
            "k8_launches": sum(n for n, _ in k8_launches.values()),
            "k8_launches_and_whole_sequence_passes": k8_launches}


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
    # greedy inference_speech with a forced 8-code prefix and two return
    # sequences, token for token on the card and the CPU
    from indextts_tpu_torch.models.gpt_decode import inference_speech

    prompt = gpu.extract_features(PROMPT)
    mel = torch.from_numpy(np.ascontiguousarray(prompt[0].T[None]))
    text, prefix = torch.tensor([[5, 6, 7, 8, 9, 10]]), torch.tensor([[3, 4, 5, 6, 7, 8, 9, 10]])
    prefixed = {}
    for dev, e in (("cuda", gpu), ("cpu", cpu)):
        res = inference_speech(e.gpt, e.cfg.gpt, mel.to(dev), text.to(dev), torch.tensor([6], device=dev),
                               input_tokens=prefix.to(dev), num_return_sequences=2, do_sample=False,
                               max_generate_length=16)
        prefixed[dev] = tuple(t.cpu().numpy() for t in res)
    same_p = all(np.array_equal(a, b) for a, b in zip(prefixed["cuda"], prefixed["cpu"]))
    log(f"[small] tiny f32 greedy inference_speech, 8-code prefix, 2 sequences: codes equal {same_p} "
        f"({prefixed['cuda'][0][0, :12].tolist()}..., lengths {prefixed['cuda'][1].tolist()}) [{card}]")
    if not same_p or prefixed["cuda"][0].shape != (2, 16):
        raise AssertionError("the card's prefixed inference_speech disagrees with the CPU's at tiny width")
    # one tiny reference-format checkpoint directory loaded on the card and on the CPU
    with tempfile.TemporaryDirectory() as d:
        write_checkpoint_dir(tiny_config(), d)
        loaded = {dev: IndexTTS(cfg_path=os.path.join(d, "config.yaml"), model_dir=d, is_fp16=False, device=dev)
                  for dev in ("cuda", "cpu")}
    ckpt_codes, ckpt_wavs = {}, {}
    for dev, e in loaded.items():
        gen, got = e._gpt_generate, []

        def rec(*a, _gen=gen, _got=got, **k):
            out = _gen(*a, **k)
            _got.append(np.asarray(out[0]))
            return out

        e._gpt_generate = rec
        _, ckpt_wavs[dev] = e.infer(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=False, num_beams=1,
                                    max_mel_tokens=24)
        ckpt_codes[dev] = got
    same_c = len(ckpt_codes["cuda"]) == len(ckpt_codes["cpu"]) and all(
        np.array_equal(a, b) for a, b in zip(ckpt_codes["cuda"], ckpt_codes["cpu"]))
    wc, wp = ckpt_wavs["cuda"], ckpt_wavs["cpu"]
    diff_c = int(np.abs(wc.astype(np.int64) - wp.astype(np.int64)).max()) if wc.size and wc.shape == wp.shape else -1
    log(f"[small] tiny f32 checkpoint directory on the card and the CPU: greedy codes equal {same_c} "
        f"({ckpt_codes['cuda'][0][0, :12].tolist()}...), wav {wc.shape} max |gpu - cpu| = {diff_c} int16 units [{card}]")
    if not same_c or wc.shape != wp.shape or not 0 <= diff_c <= 1:
        raise AssertionError("the card's engine disagrees with the CPU's on a tiny checkpoint directory")
    return {"codes_equal": same, "wav_max_abs_diff_int16": diff, "samples": int(wav_gpu.shape[0]),
            "inference_speech_prefix": {"codes_equal": same_p, "lengths": prefixed["cuda"][1].tolist()},
            "checkpoint_dir": {"codes_equal": same_c, "wav_max_abs_diff_int16": diff_c, "samples": int(wc.shape[0])},
            "beams_wide_branch": {"codes_equal": same_b, "wav_max_abs_diff_int16": diff_b, "k2_launches": k2_calls,
                                  "samples": int(wavb_gpu.shape[0])},
            "captured_latents": {"codes": n, "max_abs_diff_vs_teacher_forced": lat_err},
            "streams_wide_tmajor": streams,
            "serving_wav_max_abs_diff_int16": serve_diffs,
            "fused_aa_vocoder": {"k4_launches": k4_calls, "wav_max_abs_diff_int16": diff_f,
                                 "wav_max_abs_diff_vs_default_int16": diff_fd},
            "int8_fast": {"codes_equal": same8, "wav_max_abs_diff_int16": diff8, "card_batches": batches,
                          "samples": int(wav8_gpu.shape[0])}}


def like_random_init(sd: dict) -> None:
    """Rescale, in place, the N(0, 0.05^2) draws of tests/make_torch_ckpt.py
    to the spread of the engine's random init (weights.default_init_ and the
    GPT-2 init): 2-D weights to a std of 0.02, conv weights to U(+-1/sqrt(fan_in))'s
    std 1/sqrt(3 fan_in), each weight-normed conv's g to that init's row norm
    sqrt(1/3). At 0.05 and g = 1 every weight-normed conv of the published
    vocoder has ~1.7x the gain, and its output sits at full scale."""
    for k, v in sd.items():
        if not v.is_floating_point() or v.ndim < 2 or k.endswith(".weight_v"):
            continue  # norms, biases, BatchNorm statistics; v only sets a direction
        if k.endswith(".weight_g"):
            v.fill_(3 ** -0.5)
        elif v.ndim >= 3:
            v.mul_((3 * math.prod(v.shape[1:])) ** -0.5 / 0.05)
        else:
            v.mul_(0.02 / 0.05)


def make_torch_ckpt():
    """tests/make_torch_ckpt.py, loaded by its path: `tests` is a namespace
    package here, and a regular package of that name elsewhere on sys.path
    would shadow it. Its GPT, BigVGAN and discriminator state dicts need torch
    alone (its DVAE one needs jax, which the card's machine lacks)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_torch_ckpt", os.path.join(REPO, "tests", "make_torch_ckpt.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    return make


def write_checkpoint_dir(cfg, d: str, stop_bias=None, scale=False) -> tuple:
    """A reference-format checkpoint directory for `cfg` (the port's config
    objects) under `d`: gpt.pth and bigvgan_generator.pth from
    tests/make_torch_ckpt.py's seeded state dicts (rescaled by
    like_random_init when `scale`), config.yaml and a bpe.model of upper-case
    letters and punctuation. `stop_bias`, when given, goes into mel_head.bias
    at the stop code, so that a request decodes its whole budget. Returns the
    two state dicts."""
    import torch

    from indextts_tpu_torch.config import save_config
    from indextts_tpu_torch.utils.spm import build_vocab_from_pieces, serialize_model_proto

    make = make_torch_ckpt()
    os.makedirs(d, exist_ok=True)
    gpt_sd = make.make_gpt_state_dict(cfg.gpt)
    bigvgan_sd = make.make_bigvgan_state_dict(cfg.bigvgan)
    if scale:
        like_random_init(gpt_sd)
        like_random_init(bigvgan_sd)
    if stop_bias is not None:
        gpt_sd["mel_head.bias"][cfg.gpt.stop_mel_token] = stop_bias
    torch.save(gpt_sd, os.path.join(d, cfg.gpt_checkpoint))
    torch.save({"generator": bigvgan_sd}, os.path.join(d, cfg.bigvgan_checkpoint))
    save_config(cfg, os.path.join(d, "config.yaml"))
    pieces = [(chr(65 + i), -float(i + 1)) for i in range(26)]
    pieces += [("▁", -30.0), (".", -31.0), (",", -32.0), ("!", -33.0), ("?", -34.0), ("-", -35.0), ("'", -36.0)]
    with open(os.path.join(d, "bpe.model"), "wb") as f:
        f.write(serialize_model_proto(build_vocab_from_pieces(pieces, model_type=2)))
    return gpt_sd, bigvgan_sd


def _multipart(fields: dict, files: dict) -> tuple:
    """(body, content type) of a multipart/form-data POST."""
    boundary = "----chipsmoke" + os.urandom(8).hex()
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode())
    for k, (name, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{name}"\r\n'
                     f"Content-Type: audio/wav\r\n\r\n".encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def ckpt_phase(card: str) -> dict:
    """This slice's main path: the published IndexTTS-1.5 width started from a
    reference-format checkpoint directory (convert.py, the engine's load
    order) and served over HTTP by the port's own server, K1 at every
    vocoder activation. Engine A converts the .pth files and writes the .npz
    caches, engine B loads the caches; spot checks of their weights against
    the state dicts with torch alone; a greedy request bit-equal on A and B;
    then B behind create_app(slot_requests=4) on a loopback port: the SPA's
    default form (num_beams 3, sampled) followed to its wav, a streaming
    request, and 4 concurrent num_beams=1 requests through the slot session."""
    import http.client
    import io
    import shutil
    import socket
    import threading
    import wave

    import numpy as np
    import torch

    import indextts_tpu_torch.engine as engine_mod
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.engine import IndexTTS
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.server.webui import create_app

    d = os.path.join(REPO, "build", "ckpt_phase")
    shutil.rmtree(d, ignore_errors=True)
    # one vocoder call of an engine: its warm run or a replay of its graph
    voc = {"calls": 0}
    vocoder_call = engine_mod.IndexTTS._vocoder_call

    def counting_call(self, *a, **kw):
        voc["calls"] += 1
        return vocoder_call(self, *a, **kw)

    engine_mod.IndexTTS._vocoder_call = counting_call
    app = None
    try:
        cfg = load_config(FLAGSHIP)
        h = cfg.bigvgan
        per_call = len(h.upsample_rates) * sum(2 * len(d) for d in h.resblock_dilation_sizes) + 1  # 109 published
        t = time.perf_counter()
        gpt_sd, bigvgan_sd = write_checkpoint_dir(cfg, d, stop_bias=-30.0, scale=True)
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        log(f"[ckpt] wrote {d}: {sizes} in {time.perf_counter() - t:.1f} s")
        cfg_path = os.path.join(d, "config.yaml")
        built = {}
        for name in ("pth", "npz"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=True, device="cuda")
            torch.cuda.synchronize()
            built[name] = (e, time.perf_counter() - t)
            log(f"[ckpt] engine from the {name} path built in {built[name][1]:.2f} s [{card}]")
        (engine_a, pth_s), (engine_b, npz_s) = built["pth"], built["npz"]
        if not all(os.path.exists(os.path.join(d, f + ".npz")) for f in (cfg.gpt_checkpoint, cfg.bigvgan_checkpoint)):
            raise AssertionError("the .pth path wrote no .npz cache")
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}

        # the loaded weights against the state dicts, with torch alone
        def folded(prefix):  # weight norm folded by torch in float64, then float32 as the engine loads it
            v, g = bigvgan_sd[prefix + ".weight_v"].double(), bigvgan_sd[prefix + ".weight_g"].double()
            return torch._weight_norm(v, g, 0).float()

        last = cfg.gpt.condition_module.num_blocks - 1
        spots = {
            "gpt.h.0.attn.c_attn.weight (transposed)": (gpt_sd["gpt.h.0.attn.c_attn.weight"].t(),
                                                        lambda e: e.gpt.gpt.blocks[0].attn_qkv.weight),
            "text_embedding.weight": (gpt_sd["text_embedding.weight"], lambda e: e.gpt.text_embedding),
            f"conditioning_encoder.encoders.{last}.feed_forward.w_2.weight": (
                gpt_sd[f"conditioning_encoder.encoders.{last}.feed_forward.w_2.weight"],
                lambda e: e.gpt.conditioning_encoder.layers[last].ff["w2"].weight),
            "ups.0.0 (weight norm folded)": (folded("ups.0.0"), lambda e: e.bigvgan.ups[0].weight),
            "resblocks.0.convs1.0 (weight norm folded)": (folded("resblocks.0.convs1.0"),
                                                          lambda e: e.bigvgan.resblocks[0].convs1[0].weight),
        }
        spot = {}
        where = dict(device=engine_a.gpt.text_embedding.device, dtype=engine_a.dtype)  # bf16 on the card
        for name, (want, get) in spots.items():
            want = want.to(**where)
            for tag, e in (("A", engine_a), ("B", engine_b)):
                have = get(e)
                if have.dtype != want.dtype or have.shape != want.shape or not torch.equal(have, want):
                    raise AssertionError(f"engine {tag}'s {name} is not the state dict's value in {want.dtype}")
            spot[name] = list(want.shape)
        # a float32 fold rounds otherwise than the converter's float64 norm: how many values that moves
        v, g = bigvgan_sd["ups.0.0.weight_v"], bigvgan_sd["ups.0.0.weight_g"]
        f32_moved = int((torch._weight_norm(v, g, 0).to(**where) != engine_a.bigvgan.ups[0].weight).sum())
        log(f"[ckpt] {len(spot)} weights of engines A and B equal the state dicts' in {where['dtype']}, bit for bit "
            f"(torch alone): {spot}; a float32 fold of ups.0.0 would move {f32_moved} of its {v.numel()} values")
        del gpt_sd, bigvgan_sd

        # the main path's run starts here: a greedy request on A and on B, then HTTP on B
        k1.launches = voc["calls"] = 0
        greedy = dict(text="HELLO WORLD.", do_sample=False, num_beams=1, max_mel_tokens=100)
        runs = {}
        for tag, e in (("A", engine_a), ("B", engine_b)):
            codes, floats = [], []
            gen, vocode = e._gpt_generate, e._vocode

            def recording_generate(*ga, _gen=gen, _codes=codes, **gk):
                out = _gen(*ga, **gk)
                _codes.append(np.asarray(out[0]))
                return out

            def recording_vocode(*va, _vocode=vocode, _floats=floats, **vk):
                wav = _vocode(*va, **vk)
                _floats.append(wav)
                return wav

            e._gpt_generate, e._vocode = recording_generate, recording_vocode
            try:
                t = time.perf_counter()
                sr, wav = e.infer(audio_prompt=PROMPT, **greedy)
                runs[tag] = dict(codes=codes, wav=wav, floats=floats, s=time.perf_counter() - t)
            finally:
                del e._gpt_generate, e._vocode
        a, b = runs["A"], runs["B"]
        n_codes = sum(int(c.shape[-1]) for c in a["codes"])
        finite = all(np.isfinite(w).all() for r in (a, b) for w in r["floats"])
        same_codes = len(a["codes"]) == len(b["codes"]) and all(np.array_equal(x, y) for x, y in zip(a["codes"], b["codes"]))
        same_wav = a["wav"].shape == b["wav"].shape and np.array_equal(a["wav"], b["wav"])
        ab_launches, ab_calls = k1.launches, voc["calls"]
        full_scale = float((np.abs(a["wav"].astype(np.int32)) >= 32767).mean())
        log(f"[ckpt] greedy num_beams=1, max_mel_tokens 100 on A and B: {n_codes} codes, equal {same_codes}; wav "
            f"{a['wav'].shape} bit-equal {same_wav}, finite {finite}, {100 * full_scale:.2f} % of samples at full "
            f"scale, max |sample| {int(np.abs(a['wav'].astype(np.int32)).max())}; {a['s']:.2f} / {b['s']:.2f} s; K1 "
            f"{ab_launches} launches over {ab_calls} vocoder calls [{card}]")
        if not (same_codes and same_wav and finite) or n_codes != 100 or a["wav"].shape[0] != 100 * engine_b._samples_per_code():
            raise AssertionError("engines A (.pth) and B (.npz) disagree, or the request did not decode 100 codes")
        if ab_calls != 2 or ab_launches != per_call * ab_calls:
            raise AssertionError(f"K1 launched {ab_launches} times over {ab_calls} vocoder calls, want {per_call} per call")

        # HTTP: the port's server on engine B, a loopback port, slot batching of 4
        submits, infers = [], []
        make_session, infer = engine_b.slot_session, engine_b.infer

        def recording_session(*sa, **sk):
            sess = make_session(*sa, **sk)
            submit = sess.submit

            def recording_submit(*ra, **rk):
                rid = submit(*ra, **rk)
                submits.append(rid)
                return rid

            sess.submit = recording_submit
            return sess

        def recording_infer(*ia, **ik):
            infers.append(ik.get("text"))
            return infer(*ia, **ik)

        engine_b.slot_session, engine_b.infer = recording_session, recording_infer
        app = create_app(engine_b, base_dir=os.path.join(d, "www"), slot_requests=4)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        threading.Thread(target=app.run, args=("127.0.0.1", port), daemon=True).start()
        deadline = time.time() + 30
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        with open(PROMPT, "rb") as f:
            prompt = {"referenceAudioFile": ("prompt.wav", f.read())}

        def call(method, path, body=None, ctype=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
            return conn, conn.getresponse()

        def post(path, fields):
            body, ctype = _multipart(fields, prompt)
            conn, resp = call("POST", path, body, ctype)
            data = resp.read()
            conn.close()
            if resp.status != 200:
                raise AssertionError(f"POST {path}: {resp.status} {data[:300]!r}")
            return data

        def wav_frames(url):
            conn, resp = call("GET", url)
            data = resp.read()
            conn.close()
            if resp.status != 200:
                raise AssertionError(f"GET {url}: {resp.status}")
            with wave.open(io.BytesIO(data)) as w:
                return w.getnframes()

        spa_form = {"text": "HELLO WORLD.", "infer_mode": "普通推理", "do_sample": "true",
                    "temperature": "1.0", "top_k": "30", "top_p": "0.8", "repetition_penalty": "10.0",
                    "num_beams": "3", "length_penalty": "0.0", "max_mel_tokens": "100",
                    "max_text_tokens_per_sentence": "120", "replacements": "[]"}
        http_rows = {}
        # (a) the SPA's default form, followed over the SSE status stream to its wav
        t = time.perf_counter()
        tid = json.loads(post("/api/synthesize", spa_form))["task_id"]
        conn, resp = call("GET", f"/api/synthesize-stream-status/{tid}")
        last = {}
        for line in resp:
            if line.startswith(b"data: "):
                last = json.loads(line[6:])
                if last.get("status") in ("completed", "failed", "error"):
                    break
        conn.close()
        if last.get("status") != "completed":
            raise AssertionError(f"default-form request ended {last}")
        frames = wav_frames(last["audio_url"])
        http_rows["default_form"] = dict(s=time.perf_counter() - t, samples=frames)
        if frames != 100 * engine_b._samples_per_code():
            raise AssertionError(f"default-form wav has {frames} samples, want 100 codes x {engine_b._samples_per_code()}")
        # (b) a streaming request: a chunked WAV body
        t = time.perf_counter()
        body = post("/api/synthesize-stream", {**spa_form, "infer_mode": "流式"})
        http_rows["stream"] = dict(s=time.perf_counter() - t, bytes=len(body), samples=(len(body) - 44) // 2)
        if len(body) <= 44:
            raise AssertionError(f"the streaming response held {len(body)} bytes: no PCM")
        # (c) four concurrent num_beams=1 requests through the slot session
        n_infer = len(infers)
        rows = [None] * 4

        def client(i):
            t0 = time.perf_counter()
            fields = {**spa_form, "text": ["HELLO WORLD.", "GOOD DAY.", "THIS IS A TEST.", "SEE YOU."][i],
                      "num_beams": "1"}
            tid = json.loads(post("/api/synthesize", fields))["task_id"]
            while True:
                conn, resp = call("GET", f"/api/task-status/{tid}")
                st = json.loads(resp.read())
                conn.close()
                if st.get("status") in ("completed", "failed", "error"):
                    break
                time.sleep(0.05)
            rows[i] = dict(s=time.perf_counter() - t0, status=st["status"],
                           samples=wav_frames(st["audio_url"]) if st["status"] == "completed" else 0)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        http_rows["slots_4"] = dict(s=time.perf_counter() - t, requests=rows)
        if any(r is None or r["status"] != "completed" or r["samples"] <= 0 for r in rows):
            raise AssertionError(f"concurrent num_beams=1 requests: {rows}")
        if len(submits) != 4 or len(infers) != n_infer:
            raise AssertionError(f"{len(submits)} requests went through the slot session, {len(infers) - n_infer} "
                                 f"through infer: want 4 and 0")
        http_launches, http_calls = k1.launches - ab_launches, voc["calls"] - ab_calls
        log(f"[ckpt] HTTP on 127.0.0.1 (create_app, slot_requests=4), wall s: default form (num_beams 3, sampled, "
            f"100 codes) {http_rows['default_form']['s']:.2f} ({frames} samples); stream "
            f"{http_rows['stream']['s']:.2f} ({http_rows['stream']['bytes']} bytes); 4 concurrent num_beams=1 "
            f"{http_rows['slots_4']['s']:.2f} ({[round(r['s'], 2) for r in rows]}, {len(submits)} slot submits); "
            f"K1 {http_launches} launches over {http_calls} vocoder calls [{card}]")
        if http_calls < 3 or http_launches != per_call * http_calls:
            raise AssertionError(f"K1 launched {http_launches} times over {http_calls} vocoder calls, want {per_call} "
                                 "per call")
        return {"files_bytes": sizes, "build_s": {"pth": pth_s, "npz": npz_s}, "spot_checks": spot,
                "f32_fold_moved_values": f32_moved, "greedy_ab": {"codes": n_codes, "equal": True,
                                                                        "s": [a["s"], b["s"]],
                                                                        "full_scale_share": full_scale},
                "http": http_rows, "k1_launches": k1.launches, "vocoder_calls": voc["calls"]}
    finally:
        if app is not None:
            app.shutdown()
        engine_mod.IndexTTS._vocoder_call = vocoder_call
        shutil.rmtree(d, ignore_errors=True)


# the device of the legacy and fidelity phases (a CPU rehearsal sets "cpu")
DEVICE = "cuda"


def activations_per_call(h) -> int:
    """K1 launches per vocoder call on the default route: two activations per
    dilation in each AMPBlock1, per resblock, per stage, plus activation_post
    (109 at the published widths)."""
    return len(h.upsample_rates) * sum(2 * len(d) for d in h.resblock_dilation_sizes) + 1


# tolerances of the legacy phase: the card's bf16 against the CPU's float32 on
# the same (bf16-rounded) weights. Conditioning: max |card - cpu| over the
# latents within this share of max |cpu|; teacher-forced losses: relative.
LEGACY_COND_RTOL = 5e-2
LEGACY_LOSS_RTOL = 1e-2
# fidelity phase, float32 on both (TF32 off on the card, by the tool): each loss and the round-trip
# MSE relative to the CPU's
FIDELITY_RTOL = 1e-3


def recording_vocoder(engine) -> list:
    """Wrap engine._vocode to record (codes, wav) of each vocoder call."""
    calls = []
    vocode = engine._vocode

    def recording(latent, n_valid, prompt_mel):
        wav = vocode(latent, n_valid, prompt_mel)
        calls.append((n_valid, wav))
        return wav

    engine._vocode = recording
    return calls


def cpu_copy(model, cfg):
    """A float32 CPU copy of a UnifiedVoice on the card: built on the meta
    device and given the card's (bf16) tensors, so nothing is initialized
    twice."""
    import torch

    from indextts_tpu_torch.models.gpt import UnifiedVoice

    with torch.device("meta"):
        cpu = UnifiedVoice(cfg)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    return cpu.eval().requires_grad_(False)


def legacy_phase(card: str) -> dict:
    """The GPT's code off the engine's default path, at the published GPT
    widths (configs/indextts_1_5.yaml: 24 x 1280, 20 heads), random weights
    from a fixed seed, bf16. For condition_type "perceiver" and "default" (a
    temporary config): an engine, a greedy 100-code infer (K1 109 launches per
    vocoder call), and get_conditioning on the card against the CPU in
    float32 on the same weights, each AttentionBlock's proj_out set to seeded
    non-zero values first (the init zeroes it: the block would be the
    identity). On the conformer_perceiver flagship: inference_speech with an
    8-code forced prefix and num_return_sequences=2, greedy (max_new capped
    at max_mel_tokens - 1 - 8) and with num_beams=3; then
    unified_voice_forward(return_latent=False) on a 200-code teacher-forced
    row, the card's losses against the CPU's."""
    import tempfile

    import numpy as np
    import torch

    from indextts_tpu_torch.config import load_config, save_config
    from indextts_tpu_torch.engine import IndexTTS
    from indextts_tpu_torch.models.gpt import get_conditioning, unified_voice_forward
    from indextts_tpu_torch.models.gpt_decode import inference_speech
    from indextts_tpu_torch.ops.cuda import antialias as k1

    out = {"conditioning": {}}
    k1_launches, vocoder_calls = 0, 0
    for ct in ("perceiver", "default"):
        cfg = load_config(FLAGSHIP)
        cfg.gpt.condition_type = ct
        with tempfile.TemporaryDirectory() as d:
            cfg_path = os.path.join(d, "config.yaml")
            save_config(cfg, cfg_path)
            engine = IndexTTS(cfg_path=cfg_path, model_dir=os.path.join(REPO, "configs"), is_fp16=True,
                              device=DEVICE, allow_random_init=True, seed=0)
        g = torch.Generator(device=DEVICE).manual_seed(1)
        with torch.no_grad():
            for blk in engine.gpt.conditioning_encoder.attn:
                c = blk.proj_out.weight.shape[0]
                blk.proj_out.weight.copy_(torch.randn(c, c, device=DEVICE, generator=g) / math.sqrt(c))
                blk.proj_out.bias.copy_(0.1 * torch.randn(c, device=DEVICE, generator=g))
        calls = recording_vocoder(engine)
        k1.launches = 0  # the main path's run starts here
        t = time.perf_counter()
        engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=False, num_beams=1, max_mel_tokens=100)
        infer_s = time.perf_counter() - t
        launches, n_calls = k1.launches, len(calls)
        n_codes = sum(n for n, _ in calls)
        per_call = activations_per_call(engine.cfg.bigvgan)
        if n_calls < 1 or launches != per_call * n_calls or not all(np.isfinite(w).all() for _, w in calls):
            raise AssertionError(f"{ct}: K1 launched {launches} times over {n_calls} vocoder calls "
                                 f"(want {per_call} each)")
        k1_launches += launches
        vocoder_calls += n_calls

        # get_conditioning: the card (bf16) against the CPU (float32), same weights
        prompt = engine.extract_features(PROMPT)  # [1, 100, frames]
        mel = torch.from_numpy(np.ascontiguousarray(prompt[0].T[None]))
        lens = torch.tensor([mel.shape[1]])
        cpu = cpu_copy(engine.gpt, engine.cfg.gpt)
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = get_conditioning(engine.gpt, engine.cfg.gpt, mel.to(DEVICE, engine.dtype), lens.to(DEVICE))
            torch.cuda.synchronize()
            cond_ms = 1e3 * (time.perf_counter() - t)
            want = get_conditioning(cpu, engine.cfg.gpt, mel, lens)
        err = float((got.float().cpu() - want).abs().max())
        scale = float(want.abs().max())
        ok = got.shape == want.shape and np.isfinite(err) and err <= LEGACY_COND_RTOL * scale
        out["conditioning"][ct] = {"shape": list(got.shape), "max_abs_err": err, "max_abs_cpu": scale,
                                   "tolerance": LEGACY_COND_RTOL * scale, "card_ms": cond_ms, "codes": n_codes,
                                   "infer_s": infer_s, "k1_launches": launches, "vocoder_calls": n_calls}
        log(f"[legacy] {ct}: greedy infer {n_codes} codes in {infer_s:.2f} s, K1 {launches} launches over {n_calls} "
            f"vocoder call(s); get_conditioning {tuple(got.shape)} {cond_ms:.2f} ms on the card (bf16), max |card - "
            f"cpu f32| = {err:.4g} (tolerance {LEGACY_COND_RTOL} x max|cpu| = {LEGACY_COND_RTOL * scale:.4g}) [{card}]")
        if not ok:
            raise AssertionError(f"{ct}: the card's conditioning disagrees with the CPU's")
        # the engine's conditioning stage on this condition type, replayed against eager
        out["conditioning"][ct]["stage"] = conditioning_vs_eager(engine, card, ct)
        del engine, cpu
        torch.cuda.empty_cache()

    # the flagship: forced prefixes through inference_speech
    engine = flagship_engine()
    cfg = engine.cfg.gpt
    g = torch.Generator(device=DEVICE).manual_seed(2)
    prompt = engine.extract_features(PROMPT)
    mel = torch.from_numpy(np.ascontiguousarray(prompt[0].T[None])).to(DEVICE, engine.dtype)
    text = torch.randint(2, cfg.number_text_tokens, (1, 12), device=DEVICE, generator=g)
    tlens = torch.tensor([12], device=DEVICE)
    prefix = torch.randint(0, cfg.start_mel_token, (1, 8), device=DEVICE, generator=g)
    runs = {}
    for name, kw in (("greedy", dict(max_generate_length=cfg.max_mel_tokens)),
                     ("beams3", dict(num_beams=3, max_generate_length=100))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes, lengths = inference_speech(engine.gpt, cfg, mel, text, tlens, input_tokens=prefix,
                                          num_return_sequences=2, do_sample=False,
                                          generator=torch.Generator(device=DEVICE).manual_seed(0), **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        want_new = min(kw["max_generate_length"], cfg.max_mel_tokens - 1 - prefix.shape[1])
        codes = codes.cpu().numpy()
        ok = codes.shape == (2, want_new) and ((codes >= 0) & (codes < cfg.number_mel_codes)).all()
        if name == "greedy":
            ok = ok and np.array_equal(codes[0], codes[1])  # greedy tiled rows are copies
        runs[name] = {"shape": list(codes.shape), "max_new": want_new, "lengths": lengths.tolist(), "s": s}
        log(f"[legacy] inference_speech {name}, 8-code prefix, num_return_sequences=2: codes {codes.shape} "
            f"(max_new {want_new} = min({kw['max_generate_length']}, max_mel_tokens {cfg.max_mel_tokens} - 1 - 8)), "
            f"lengths {lengths.tolist()}, {s:.2f} s [{card}]")
        if not ok:
            raise AssertionError(f"inference_speech {name}: codes {codes.shape}, want (2, {want_new})")
    out["inference_speech"] = runs

    # teacher-forced losses on a 200-code row: the card (bf16) against the CPU (float32)
    codes = torch.randint(0, cfg.start_mel_token, (1, 200), device=DEVICE, generator=g)
    wav_lens = torch.tensor([200 * cfg.mel_length_compression], device=DEVICE)
    lens = torch.tensor([mel.shape[1]], device=DEVICE)
    fwd = dict(return_latent=False, mask_pad_keys=True)
    with torch.no_grad():
        unified_voice_forward(engine.gpt, cfg, mel, text, tlens, codes, wav_lens, lens, **fwd)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss_text, loss_mel, logits = unified_voice_forward(engine.gpt, cfg, mel, text, tlens, codes, wav_lens, lens,
                                                            **fwd)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t)
        cpu = cpu_copy(engine.gpt, cfg)
        cpu_args = [x.cpu() for x in (mel.float(), text, tlens, codes, wav_lens, lens)]
        t = time.perf_counter()
        want = unified_voice_forward(cpu, cfg, *cpu_args, **fwd)
        cpu_ms = 1e3 * (time.perf_counter() - t)
    losses = {"text": (float(loss_text), float(want[0])), "mel": (float(loss_mel), float(want[1]))}
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in losses.items()}
    logit_err = float((logits.float().cpu() - want[2]).abs().max())
    out["teacher_forced"] = {"codes": 200, "losses_card_cpu": losses, "rel_err": rel, "tolerance": LEGACY_LOSS_RTOL,
                             "mel_logits_shape": list(logits.shape), "mel_logits_max_abs_err": logit_err,
                             "card_ms": card_ms, "cpu_ms": cpu_ms}
    log(f"[legacy] unified_voice_forward(return_latent=False), 200 codes: loss_text {losses['text'][0]:.5f} (cpu "
        f"{losses['text'][1]:.5f}), loss_mel {losses['mel'][0]:.5f} (cpu {losses['mel'][1]:.5f}), rel err "
        f"{max(rel.values()):.3g} (tolerance {LEGACY_LOSS_RTOL}); mel_logits {tuple(logits.shape)} max |card - cpu| "
        f"{logit_err:.4g}; {card_ms:.2f} ms on the card (bf16), {cpu_ms:.0f} ms on the CPU (f32) [{card}]")
    if logits.shape != (1, cfg.number_mel_codes, 202) or not max(rel.values()) <= LEGACY_LOSS_RTOL:
        raise AssertionError("the card's teacher-forced losses disagree with the CPU's")
    out["k1_launches"], out["vocoder_calls"] = k1_launches, vocoder_calls
    return out


def dvae_state_dict(model) -> dict:
    """A DiscreteVAE's weights as the reference's dvae.pth names them (the
    Sequential indices convert_dvae reads, xtts_dvae.py:251-291): the inverse
    of convert_dvae, with torch alone."""
    cfg = model.cfg
    L, R = cfg.num_layers, cfg.num_resnet_blocks
    sd = {}

    def conv(prefix, m):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = m.weight.detach().clone(), m.bias.detach().clone()

    def res(prefix, blk):
        for i, m in zip((0, 2, 4), (blk.conv0, blk.conv1, blk.conv2)):
            conv(f"{prefix}.net.{i}", m)

    for i, m in enumerate(model.enc_convs):
        conv(f"encoder.{i}.0", m)
    for r, blk in enumerate(model.enc_res):
        res(f"encoder.{L + r}", blk)
    conv(f"encoder.{L + R}", model.enc_out)
    dec_off = 1 if R > 0 else 0
    if R > 0:
        conv("decoder.0", model.dec_in)
    for r, blk in enumerate(model.dec_res):
        res(f"decoder.{dec_off + r}", blk)
    for i, m in enumerate(model.dec_convs):
        conv(f"decoder.{dec_off + R + i}.0.conv", m)
    conv(f"decoder.{dec_off + R + L}", model.dec_out)
    for k in ("embed", "cluster_size", "embed_avg"):
        sd[f"codebook.{k}"] = getattr(model.codebook, k).clone()
    return sd


def fidelity_profiles(args: list) -> dict:
    """The device side of eval_fidelity's two stages, on the inputs and
    checkpoints `args` name: host ms of one warm call (synchronized, the least
    of three), device ms and kernels under torch.profiler, device-idle share."""
    import torch

    from indextts_tpu_torch import eval_fidelity as ef

    f = ef.load(ef.parse_args(args + ["-d", "cuda"]))
    out = {}
    for name, call in (("DVAE round trip", lambda: ef.dvae_round_trip(f)),
                       ("MPD + MRD", lambda: ef.discriminator_losses(f))):
        call()
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t))
        prof = device_profile(call, 1)
        out[name] = {"host_ms": min(host), "host_ms_runs": host}
        if prof is not None:
            out[name].update(device_ms=prof["call_ms"], kernels=prof["kernels"],
                             device_idle_share=1.0 - prof["call_ms"] / min(host))
    return out


def fidelity_phase(card: str) -> dict:
    """The fidelity loop (tools/eval_fidelity.py, BASELINE config #5) on the
    port at the published widths: a checkpoint directory under build/ with
    bigvgan_discriminator.pth (tests/make_torch_ckpt.py, BigVGANConfig
    defaults: channel mult 1.0, periods 2, 3, 5, 7, 11, three resolutions)
    and a dvae.pth at the DVAEConfig defaults (80 channels, 8192 codes, 512
    dims, 2 layers, 3 resblocks), written from the port's seeded random init
    through dvae_state_dict; a flagship greedy infer of 100 codes on
    tests/sample_prompt.wav (K1 109 launches per vocoder call) as --wav_hat;
    then eval_fidelity.main on the card (twice: the second run's times are
    the warm ones) and with -d cpu, float32 (the tool turns TF32 off on the
    card itself): the DVAE codes equal,
    dvae_codes_used equal, the round-trip MSE and the four losses within
    FIDELITY_RTOL; then each stage once under torch.profiler
    (fidelity_profiles)."""
    import shutil

    import numpy as np
    import torch

    from indextts_tpu_torch import eval_fidelity
    from indextts_tpu_torch.config import BigVGANConfig, DVAEConfig
    from indextts_tpu_torch.models.dvae import DiscreteVAE
    from indextts_tpu_torch.ops.cuda import antialias as k1

    d = os.path.join(REPO, "build", "fidelity_phase")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t = time.perf_counter()
        torch.save(make_torch_ckpt().make_discriminator_state_dict(BigVGANConfig()),
                   os.path.join(d, "bigvgan_discriminator.pth"))
        dvae = DiscreteVAE(DVAEConfig())
        dvae.reset_parameters(torch.Generator().manual_seed(3))
        torch.save(dvae_state_dict(dvae), os.path.join(d, "dvae.pth"))
        sizes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        log(f"[fidelity] wrote {d}: {sizes} in {time.perf_counter() - t:.1f} s (dvae.pth from the port's seeded "
            f"random init, inverted through dvae_state_dict)")

        engine = flagship_engine()
        calls = recording_vocoder(engine)
        hat = os.path.join(d, "resynth.wav")
        k1.launches = 0  # the main path's run starts here
        engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.", output_path=hat, do_sample=False, num_beams=1,
                     max_mel_tokens=100)
        launches, n_calls = k1.launches, len(calls)
        n_codes = sum(n for n, _ in calls)
        per_call = activations_per_call(engine.cfg.bigvgan)
        log(f"[fidelity] flagship greedy infer: {n_codes} codes -> {hat}; K1 {launches} launches over {n_calls} "
            f"vocoder call(s) [{card}]")
        if n_calls < 1 or launches != per_call * n_calls:
            raise AssertionError(f"K1 launched {launches} times over {n_calls} vocoder calls (want {per_call} each)")
        del engine
        torch.cuda.empty_cache()

        # the tool as shipped turns TF32 off for its own run (float32_numerics):
        # TF32 is allowed here, as a caller may have it, and must be again after
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        args = ["--wav", PROMPT, "--wav_hat", hat, "--model_dir", d]
        runs = {}
        for name, dev in (("cuda_cold", DEVICE), ("cuda", DEVICE), ("cpu", "cpu")):
            report, extras = eval_fidelity.main(args + ["-d", dev])
            runs[name] = (report, extras)
            if not (torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32):
                raise AssertionError("eval_fidelity did not restore the TF32 flags")
            log(f"[fidelity] eval_fidelity -d {dev} ({name}): DVAE round trip {extras['dvae_ms']:.2f} ms "
                f"({extras['mel_frames']} mel frames), MPD + MRD {extras['disc_ms']:.2f} ms ({extras['samples']} "
                f"samples), device-synchronized [{card}]")
        (rep_g, ext_g), (rep_c, ext_c) = runs["cuda"], runs["cpu"]
        codes_equal = np.array_equal(ext_g["codes"], ext_c["codes"])
        names = ("mpd_disc_loss", "mrd_disc_loss", "mpd_feature_loss", "mrd_feature_loss")
        values = dict(zip(names, zip(ext_g["losses"], ext_c["losses"])))
        values["dvae_round_trip_mse"] = (rep_g["dvae_round_trip_mse"], rep_c["dvae_round_trip_mse"])
        rel = {k: abs(a - b) / max(abs(b), 1e-12) for k, (a, b) in values.items()}
        log(f"[fidelity] card vs cpu: codes equal {codes_equal} ({ext_g['codes'].shape[1]} codes, "
            f"{rep_g['dvae_codes_used']} / {rep_c['dvae_codes_used']} used), max rel err {max(rel.values()):.3g} "
            f"(tolerance {FIDELITY_RTOL}) [{card}]")
        ok = (codes_equal and rep_g["dvae_codes_used"] == rep_c["dvae_codes_used"]
              and max(rel.values()) <= FIDELITY_RTOL
              and rep_g["dvae_weights"] == rep_c["dvae_weights"] == os.path.join(d, "dvae.pth")
              and rep_g["discriminator_weights"] == os.path.join(d, "bigvgan_discriminator.pth"))
        if not ok:
            raise AssertionError(f"the card's fidelity report disagrees with the CPU's: {rep_g} vs {rep_c}")
        profiles = fidelity_profiles(args) if DEVICE == "cuda" else {}
        for name, v in profiles.items():
            log(f"[fidelity] one {name} call under torch.profiler: host {v['host_ms']:.2f} ms, " + (
                f"device {v['device_ms']:.3f} ms in {v['kernels']:.0f} kernels, device idle "
                f"{100 * v['device_idle_share']:.1f} %" if "device_ms" in v else "device not measured") + f" [{card}]")
        return {"reports": {"cuda": rep_g, "cpu": rep_c}, "rel_err": rel, "tolerance": FIDELITY_RTOL,
                "profiles": profiles,
                "codes_equal": codes_equal, "codes": int(ext_g["codes"].shape[1]),
                "dvae_ms": {k: v[1]["dvae_ms"] for k, v in runs.items()},
                "disc_ms": {k: v[1]["disc_ms"] for k, v in runs.items()},
                "samples": ext_g["samples"], "mel_frames": ext_g["mel_frames"], "wav_hat_codes": n_codes,
                "k1_launches": launches, "vocoder_calls": n_calls}
    finally:
        shutil.rmtree(d, ignore_errors=True)


# the mesh phase: gates of the tensor-parallel logits against one process,
# float32 with TF32 off and bf16 (JAX's logit gate, bench.py:280)
MESH_F32_GATE = 1e-3
MESH_BF16_GATE = 1.0
K5_KERNEL = "int8_matmul_kernel"
# the mesh ranks' deadline: a hang fails the phase instead of stalling the run
MESH_DEADLINE_S = 240


def mesh_layout(cards: int):
    """(ranks, backend) of the mesh phase on `cards` cards, at tp = 2: four
    ranks over NCCL at dp = 2 x tp = 2 on four cards or more, two over NCCL
    on two or three, two sharing the one card over gloo."""
    if cards >= 4:
        return 4, "nccl"
    return 2, "nccl" if cards >= 2 else "gloo"


def stop_bias_slot(engine):
    """(the mel head's bias, the stop code's index in it) on this rank, or
    None where a vocabulary-split head keeps the stop code on the other
    rank of the model group."""
    lin, stop = engine.gpt.mel_head, engine.cfg.gpt.stop_mel_token
    comm = getattr(lin, "tp_comm", None)
    i = stop - (0 if comm is None else comm.index * lin.bias.shape[0])
    return (lin.bias, i) if 0 <= i < lin.bias.shape[0] else None


def mesh_engine(cfg_path: str, dtype_bf16: bool, device: str, tp=None, mesh: bool = True):
    from indextts_tpu_torch.engine import IndexTTS

    return IndexTTS(cfg_path=cfg_path, model_dir=os.path.join(REPO, "configs"), is_fp16=dtype_bf16, device=device,
                    allow_random_init=True, seed=0, use_mesh=mesh, tp=tp)


def greedy_request(engine, n_codes: int) -> dict:
    """One greedy request (repetition penalty 1, so the raw logits choose)
    through engine.infer: its codes, the top-2 margin of the logits behind
    each code, and the wav."""
    import contextlib

    import numpy as np
    import torch

    from indextts_tpu_torch.models import gpt_decode as tdec

    margins, codes = [], []
    mel_logits, generate = tdec._mel_logits, engine._gpt_generate

    def recording_logits(*a, **k):
        out = mel_logits(*a, **k)
        top2 = (out[0] if isinstance(out, tuple) else out).float().topk(2, dim=-1).values
        margins.append(float((top2[..., 0] - top2[..., 1]).min()))
        return out

    def recording_generate(*a, **k):
        out = generate(*a, **k)
        codes.append(np.asarray(out[0])[0, : int(out[1][0])])
        return out

    tdec._mel_logits, engine._gpt_generate = recording_logits, recording_generate
    # the recorder reads every step's logits on the host, which a captured step
    # cannot: the steps run eagerly here, on one process and on the mesh
    eager = engine._graphs.eager()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with eager:
            sr, wav = engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=False, num_beams=1,
                                   repetition_penalty=1.0, max_mel_tokens=n_codes)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
    finally:
        tdec._mel_logits = mel_logits
        del engine._gpt_generate
    return {"codes": codes[0], "margins": np.asarray(margins[: len(codes[0])]), "wav": wav[:, 0], "sr": sr,
            "total_s": total_s, "decode_ms_per_step": 1e3 * engine.last_stats["gpt_gen_s"]
            / max(engine.last_stats["gpt_steps"], 1)}


def k5_shards(engine) -> list:
    """K5 against its plain version on each int8 shard of the first block
    and on the mel head, at M = 4, bf16, with k5_bound (the k5 phase's
    tolerance). Launches made here are reset by the caller."""
    import torch

    from indextts_tpu_torch.ops.cuda import qmatmul as k5

    g = torch.Generator(device=engine.device).manual_seed(99)
    blk = engine.gpt.gpt.blocks[0]
    rows = []
    for label, lin in (("qkv", blk.attn_qkv), ("proj", blk.attn_proj), ("fc", blk.mlp_fc),
                       ("mlp_proj", blk.mlp_proj), ("head", engine.gpt.mel_head)):
        n, k = lin.weight.shape
        x = torch.randn(4, k, device=engine.device, generator=g).to(torch.bfloat16)
        out = k5.int8_matmul(x, lin.weight, lin.scale, lin.bias)
        ref = k5.int8_matmul_plain(x, lin.weight, lin.scale, lin.bias)
        err = (out.float() - ref.float()).abs()
        rows.append(dict(case=label, M=4, N=n, K=k, max_abs_err=err.max().item(),
                         err_over_bound=(err / k5_bound(x, lin.weight, lin.scale, ref)).max().item()))
    return rows


def mesh_forced(engine, profiled: bool = True, own=()):
    """forced_logits on an engine that has run its shapes (the greedy request
    before it): one timed run for the logits and the host ms, then one under
    the profiler."""
    return forced_logits(engine, quant_kv=False, own=own, warm=False, profiled=profiled)


def comm_ms(mesh, n: int = 100) -> dict:
    """ms per all-reduce of one [4, 1280] float32 activation over the model
    group, as the row-parallel products make them: on the rank's device
    (gloo's CUDA path, or NCCL), and staged through host memory (a copy to
    the host, gloo's CPU all-reduce over the world group, a copy back)."""
    import torch

    x = torch.randn(4, 1280, device=mesh.device)
    out = {}
    for name, fn in (("device", lambda: mesh.model.all_reduce(x)),
                     ("host_staged", lambda: x.copy_(mesh.world.all_reduce(x.cpu())))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t) / n
    return out


def mesh_rank(rank: int, world: int, port: int, backend: str, out_dir: str, cfg_path: str = FLAGSHIP,
              device: str = DEVICE) -> None:
    """One rank of the mesh phase (spawned): (a) float32 with TF32 off at
    tp = 2: 16 forced decode steps and a greedy 32-code request; (b) bf16 at
    tp = 2: the 16 forced steps, a greedy 100-code request, then int8 weights
    (quantize_unified_voice on the shards): K5 on every shard shape against
    its plain version, 16 forced steps with K5's launches counted and its own
    device ms; then bf16 at dp = 2 (tp = world / 2): infer_batch of 4
    requests with K1's launches counted. Writes rank<r>.pkl, or the
    traceback."""
    import pickle
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import qmatmul as k5
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    rank_output(out_dir, "rank", rank)
    if device == "cpu":  # a rehearsal on the CPU (tiny cfg_path): no device to wait for or to trace
        import torch.profiler as tprof

        torch.cuda.synchronize = lambda *a, **k: None
        cpu_profile = tprof.profile
        tprof.profile = lambda activities: cpu_profile(activities=[tprof.ProfilerActivity.CPU])
    else:
        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    out = {"ok": False}
    try:
        marks = out["seconds"] = {}
        t0 = time.perf_counter()
        e = mesh_engine(cfg_path, False, device, tp=2)
        out["describe"] = e.mesh.describe()
        out["comm_ms"] = comm_ms(e.mesh)
        marks["f32_engine"] = time.perf_counter() - t0
        log(f"[mesh rank {rank}] f32_engine done at {marks['f32_engine']:.1f} s")
        out["f32_greedy"] = greedy_request(e, 32)
        out["f32_logits"], out["f32_profile"] = mesh_forced(e, profiled=False)
        marks["f32"] = time.perf_counter() - t0
        log(f"[mesh rank {rank}] f32 done at {marks['f32']:.1f} s")
        del e
        torch.cuda.empty_cache()

        e = mesh_engine(cfg_path, True, device, tp=2)
        out["bf16_greedy"] = greedy_request(e, 100)
        out["bf16_logits"], out["bf16_profile"] = mesh_forced(e)
        marks["bf16"] = time.perf_counter() - t0
        log(f"[mesh rank {rank}] bf16 done at {marks['bf16']:.1f} s")
        quantize_unified_voice(e.gpt)
        out["k5_shards"] = k5_shards(e)
        k5.launches = 0  # the int8 path's forced steps start here: 2 runs of a prefill and 16 steps
        out["int8_logits"], out["int8_profile"] = mesh_forced(e, own=(K5_KERNEL,))
        out["k5_launches"], out["k5_runs"], out["k5_steps"] = k5.launches, 2, 2 * 16
        marks["int8"] = time.perf_counter() - t0
        log(f"[mesh rank {rank}] int8 done at {marks['int8']:.1f} s")
        del e
        torch.cuda.empty_cache()

        e = mesh_engine(cfg_path, True, device, tp=world // 2)
        out["dp_describe"] = e.mesh.describe()
        items = [(PROMPT, t) for t in ("HELLO WORLD.", "GOOD DAY TO YOU.", "THIS IS A TEST.", "HOW ARE YOU.")]
        k1.launches = 0  # the data-parallel batch starts here
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = e.infer_batch(items, do_sample=False, num_beams=1, max_mel_tokens=100)
        torch.cuda.synchronize()
        out["dp_batch"] = {"wavs": [w[:, 0] for _, w in res], "s": time.perf_counter() - t,
                           "k1_launches": k1.launches, "vocoder_calls": e.last_stats["vocoder_calls"],
                           "gpt_steps": e.last_stats["gpt_steps"], "decode_batches": e.last_stats["decode_batches"]}
        marks["dp"] = time.perf_counter() - t0
        log(f"[mesh rank {rank}] dp done at {marks['dp']:.1f} s")
        del e
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        release_graphs()
        dist.destroy_process_group()


def mesh_graph_rank(rank: int, world: int, port: int, backend: str, out_dir: str, cfg_path: str = FLAGSHIP,
                    device: str = DEVICE, stop_raise: float = 0.0) -> None:
    """One rank of the mesh phase's captured programs (spawned), bf16 at
    tp = 2 (dp = world / 2): which stages capture here; each request eager
    (Graphs.eager()), replayed and replayed again, its codes token-exact and
    K1-K8's launches and the host reads equal (graph_vs_eager): greedy and
    sampled num_beams=1 and the default num_beams=3, the same with the stop
    code's bias raised by `stop_raise` (rows stop mid-block), infer_batch of
    4 requests, a SlotSession of 4 slots serving 6 requests (the host ms of
    each tick and of its decode chunk), infer_stream, and a greedy request
    on int8 weights (K5 on the shards,
    inside the blocks over NCCL), at 60 codes over NCCL and at 20 over gloo,
    where only the vocoder and conditioning stages capture. The
    conditioning (and over NCCL the latent) pass within 1 bf16 unit of
    eager; a 100-code vocoder call replayed against eager, with K1's
    launches; host and device ms of the B = 4 decode step, eager (over NCCL
    beside replayed in blocks and one step a call), with the collectives'
    own device ms; the stages' decision log. Log lines go to
    graph<r>.log; writes graph<r>.pkl, or the traceback."""
    import contextlib
    import pickle
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    rank_output(out_dir, "graph", rank)
    if device == "cpu":  # a rehearsal on the CPU (tiny cfg_path): no device to wait for or to trace
        import torch.profiler as tprof

        torch.cuda.synchronize = lambda *a, **k: None
        cpu_profile = tprof.profile
        tprof.profile = lambda activities: cpu_profile(activities=[tprof.ProfilerActivity.CPU])
    else:
        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    out = {"ok": False}
    tag = f"rank {rank}"
    try:
        t0 = time.perf_counter()
        e = mesh_engine(cfg_path, True, device, tp=2)
        nccl = backend == "nccl"
        out.update(describe=e.mesh.describe(), coords=e.mesh.coords,
                   rule={s.name: s.captures for s in e._graphs.stages()})
        out["n_codes"] = n_codes = 60 if nccl else 20
        short = dict(audio_prompt=PROMPT, text="HELLO WORLD.", max_mel_tokens=n_codes)
        requests = [("greedy_nb1", lambda: e.infer(do_sample=False, num_beams=1, **short)),
                    ("sampled_nb1", lambda: e.infer(num_beams=1, **short)),
                    ("default_nb3", lambda: e.infer(**short))]
        rec = CodeRecorder(e)
        try:
            rows = [graph_vs_eager(e, rec, name, fn, tag) for name, fn in requests]
            slot = stop_bias_slot(e)
            base = None if slot is None else slot[0][slot[1]].item()
            try:
                if slot is not None:
                    with torch.no_grad():
                        slot[0][slot[1]] = base + stop_raise
                rows += [graph_vs_eager(e, rec, name + "+stop", fn, tag) for name, fn in requests]
            finally:
                if slot is not None:
                    with torch.no_grad():
                        slot[0][slot[1]] = base
            items = [(PROMPT, t) for t in ("HELLO WORLD.", "GOOD DAY TO YOU.", "THIS IS A TEST.", "HOW ARE YOU.")]
            rows.append(graph_vs_eager(e, rec, "infer_batch_4", lambda: [w.shape[0] for _, w in e.infer_batch(
                items, do_sample=False, num_beams=1, max_mel_tokens=n_codes)], tag))
            ticks = {}  # per run (eager, graph, graph again): host ms of each tick and of its decode chunk

            def slots():
                sess = e.slot_session(n_slots=4, chunk_steps=25, max_mel_tokens=n_codes)
                rids = [sess.submit(PROMPT, t) for t in ("HELLO WORLD.", "GOOD DAY.", "THIS IS A TEST.", "HI.",
                                                          "HELLO AGAIN.", "THE END.")]
                done, ms = {}, []
                while sess.busy:
                    t = time.perf_counter()
                    done.update(sess.tick())
                    ms.append(1e3 * (time.perf_counter() - t))
                ticks[("eager", "graph", "graph_again")[len(ticks)]] = {
                    "tick_ms": ms, "chunk_ms": [1e3 * c for c in sess.chunk_s]}
                return [done[r][1].shape[0] for r in rids]

            rows.append(graph_vs_eager(e, rec, "slot_session_4x6", slots, tag))
            out["slot_ticks"] = ticks
            rows.append(graph_vs_eager(e, rec, "infer_stream", lambda: [c.size for c in e.infer_stream(
                audio_prompt=PROMPT, text="HELLO WORLD.", max_mel_tokens=n_codes)], tag))
            mel = e.extract_features(PROMPT)
            conds1 = e._conds_for(mel)
            passes = {"cond": conditioning_vs_eager(e, tag, "mesh")}
            if nccl:
                r = np.random.default_rng(5)
                codes = r.integers(0, e.cfg.gpt.stop_mel_token, (1, 100))
                text = r.integers(2, e.cfg.gpt.number_text_tokens - 1, (1, 12))
                passes["latent"] = stage_vs_eager(e, "mesh latent pass, b=1, 100 codes", lambda: e._gpt_latent(
                    conds1, text, codes, np.full(1, 100)), tag)
            out["passes"] = passes

            g = torch.Generator(device=e.device).manual_seed(5)
            latent = torch.randn(1, 100, e.cfg.gpt.model_dim, device=e.device, dtype=e.dtype, generator=g)
            voc = {}
            for mode in ("eager", "graph", "graph_again"):
                k1.launches = 0
                with e._graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    wav = e._vocode(latent, 100, mel)
                voc[mode] = (np.clip(np.asarray(wav) * 32767.0, -32767, 32767).astype(np.int16), k1.launches)
            out["vocoder"] = {"max_int16_diff": max(int(np.abs(voc[m][0].astype(np.int32)
                                                               - voc["eager"][0].astype(np.int32)).max())
                                                    for m in ("graph", "graph_again")),
                              "k1_launches": {m: v[1] for m, v in voc.items()}}

            either = lambda flag: bool(e.mesh.world.all_reduce(torch.tensor([int(flag)]), op=dist.ReduceOp.MAX))
            out["step"] = step_profile(e, b4_decode(e, conds1, 32 if nccl else 8, False), tag,
                                       "mesh decode step, B=4, bf16",
                                       {"k6": e.cfg.gpt.layers, "k8": k8_per_pass(e.cfg.gpt)},
                                       modes=("eager", "graph", "graph_per_step") if nccl else ("eager",),
                                       own=("nccl", "Memcpy"), agree=either)
            quantize_unified_voice(e.gpt)
            rows.append(graph_vs_eager(e, rec, "int8_greedy_nb1",
                                       lambda: e.infer(do_sample=False, num_beams=1, **short), tag))
            out["requests"] = rows
        finally:
            rec.close()
        out["log"] = list(e._graphs.log)
        out["stats"] = e._graphs.stats()
        out["seconds"] = time.perf_counter() - t0
        del e, rec
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"graph{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        release_graphs()
        dist.destroy_process_group()


def mesh_phase(card: str, cfg_path: str = FLAGSHIP, device: str = DEVICE) -> dict:
    """The multi-device path (parallel/mesh.py) at the published widths,
    random init from seed 0, on mesh_layout's ranks (four over NCCL at
    dp = 2 x tp = 2 on four cards, two over NCCL on two, two sharing the one
    card over gloo), each building the whole model and keeping its shard,
    against one process on the first card. First the NCCL probe where there
    are two cards (nccl_probe). Then mesh_rank: (a) float32, TF32 off, tp =
    2: the 16 forced steps' logits within MESH_F32_GATE, and a greedy
    32-code request token for token (a first divergence only at a step
    whose top-2 margin is under the gate); (b) bf16, tp = 2: the forced
    steps' drift within MESH_BF16_GATE, a greedy 100-code request,
    infer_batch of 4 requests at dp = 2 with K1 at 109 launches per vocoder
    call on each rank; (c) int8 weights at tp = 2: K5 on each shard shape
    within the k5 phase's bound, 97 launches a step on each rank, and each
    rank's own K5 device ms per step beside one process's. Then
    mesh_graph_rank: the captured programs against Graphs.eager() on the
    mesh (the stages the backend's rule captures; the stop code's bias
    raised by the raise that makes one process's sampled request stop
    mid-block), the stages' decision logs equal across each model group,
    host reads a decode run, and host and device ms of the B = 4 decode
    step on the mesh, eager beside captured, beside one process's block.
    Host ms per decode step beside one process's, with the backend."""
    import shutil

    import numpy as np
    import torch

    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    import gc

    gc.collect()  # the earlier phases' engines: their blocks go back to the card before the ranks start
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    one = {}
    e = mesh_engine(cfg_path, False, device, mesh=False)
    one["f32_greedy"] = greedy_request(e, 32)
    one["f32_logits"], one["f32_profile"] = mesh_forced(e, profiled=False)
    del e
    e = mesh_engine(cfg_path, True, device, mesh=False)
    one["bf16_greedy"] = greedy_request(e, 100)
    one["bf16_logits"], one["bf16_profile"] = mesh_forced(e)
    one["block_ms"] = block_host_ms(b4_decode(e, e._conds_for(e.extract_features(PROMPT)), 32, False))
    log(f"[mesh] one process, decode step, B=4, bf16: host {one['block_ms']:.2f} ms/step replayed in blocks "
        f"[{card}]")
    stop_raise, stop_base = raise_stop_bias(e, card)
    with torch.no_grad():
        e.gpt.mel_head.bias[e.cfg.gpt.stop_mel_token] = stop_base
    quantize_unified_voice(e.gpt)
    one["int8_logits"], one["int8_profile"] = mesh_forced(e, own=(K5_KERNEL,))
    del e
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t_phase

    cards = torch.cuda.device_count() if device != "cpu" else 1
    world, backend = mesh_layout(cards)
    probe = nccl_probe(card) if cards >= 2 else None
    out_dir = os.path.join(REPO, "build", "mesh_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, (world, free_port(), backend, out_dir, cfg_path, device), world, out_dir, "rank",
                        MESH_DEADLINE_S)
    ranks_s = time.perf_counter() - t
    bad = [f"rank {r}: {x.get('error')}" for r, x in enumerate(ranks) if not x["ok"]]
    if bad:
        raise AssertionError("\n".join(bad))

    failures, rows = [], []
    for r, x in enumerate(ranks):
        f32_drift = float(np.abs(x["f32_logits"] - one["f32_logits"]).max())
        bf16_drift = float(np.abs(x["bf16_logits"] - one["bf16_logits"]).max())
        int8_drift = float(np.abs(x["int8_logits"] - one["int8_logits"]).max())
        a, b = x["f32_greedy"]["codes"], one["f32_greedy"]["codes"]
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        first = int(diff[0]) if diff.size else (None if len(a) == len(b) else n)
        margin = None if first is None else float(one["f32_greedy"]["margins"][first])
        exact_ok = first is None or (margin is not None and margin < MESH_F32_GATE)
        k5_rows = x["k5_shards"]
        k5_ok = all(k["err_over_bound"] <= 1.0 for k in k5_rows)
        # each run's prefill launches K5 once, for the mel head on its last position
        per_step = (x["k5_launches"] - x["k5_runs"]) / x["k5_steps"]
        want_step = 4 * load_config(cfg_path).gpt.layers + 1
        dpb = x["dp_batch"]
        want_k1 = activations_per_call(load_config(cfg_path).bigvgan) * dpb["vocoder_calls"]
        finite = all(np.isfinite(w.astype(np.float32)).all() and w.size > 0 for w in dpb["wavs"])
        g16 = x["bf16_greedy"]
        row = dict(rank=r, describe=x["describe"], dp_describe=x["dp_describe"], f32_drift=f32_drift,
                   bf16_drift=bf16_drift, int8_drift=int8_drift, f32_first_divergence=first,
                   f32_divergence_margin=margin, f32_codes=len(a), bf16_codes=len(g16["codes"]),
                   bf16_codes_equal_one_process=bool(np.array_equal(g16["codes"], one["bf16_greedy"]["codes"])),
                   k5_shards=k5_rows, k5_launches_per_step=per_step,
                   k5_own_ms_per_step=x["int8_profile"]["own_ms_per_step"][K5_KERNEL],
                   host_ms_per_step={k: x[f"{k}_profile"]["host_ms_per_step"] for k in ("f32", "bf16", "int8")},
                   device_ms_per_step={k: x[f"{k}_profile"]["device_ms_per_step"] for k in ("f32", "bf16", "int8")},
                   bf16_greedy_ms_per_step=g16["decode_ms_per_step"], comm_ms=x["comm_ms"], seconds=x["seconds"],
                   dp_batch={k: v for k, v in dpb.items() if k != "wavs"}, dp_k1_want=want_k1)
        rows.append(row)
        fmt = lambda v, d=4, unit="": "not measured" if v is None else f"{v:.{d}f}{unit}"
        log(f"[mesh] rank {r}: {x['describe']}; one [4, 1280] float32 all-reduce over the model group: "
            f"{x['comm_ms']['device']:.3f} ms on the device's tensors, {x['comm_ms']['host_staged']:.3f} ms staged "
            f"through host memory; seconds into the rank: {', '.join(f'{k} {v:.1f}' for k, v in x['seconds'].items())}"
            f" [{card}]")
        log(f"[mesh] rank {r} (a) float32, TF32 off, tp=2: max |logit| drift over prefill + 16 forced steps, B=4, "
            f"{f32_drift:.3e} (gate {MESH_F32_GATE}); greedy {len(a)} codes, first divergence from one process "
            f"{first} (top-2 margin there {margin}) [{card}]")
        log(f"[mesh] rank {r} (b) bf16, tp=2: drift {bf16_drift:.4f} (gate {MESH_BF16_GATE}); greedy "
            f"{len(g16['codes'])} codes (equal one process: {row['bf16_codes_equal_one_process']}), "
            f"{g16['decode_ms_per_step']:.2f} ms a step in infer [{card}]")
        log(f"[mesh] rank {r} (b) bf16, dp=2: {x['dp_describe']}; infer_batch of 4: decode batches "
            f"{dpb['decode_batches']}, {dpb['gpt_steps']} steps, {dpb['s']:.2f} s, K1 {dpb['k1_launches']} launches "
            f"over {dpb['vocoder_calls']} vocoder call(s) (want {want_k1}) [{card}]")
        for k in k5_rows:
            log(f"[mesh] rank {r} (c) K5 shard {k['case']:8s} M=4 N={k['N']:5d} K={k['K']:5d} bf16 err "
                f"{k['max_abs_err']:.3e} (err/bound {k['err_over_bound']:.3f}) [{card}]")
        log(f"[mesh] rank {r} (c) int8 weights, tp=2: drift {int8_drift:.4f}; K5 {per_step:.1f} launches a step "
            f"(want {want_step}); K5 own device ms a step {fmt(row['k5_own_ms_per_step'])} (one process "
            f"{fmt(one['int8_profile']['own_ms_per_step'][K5_KERNEL])}) [{card}]")
        for k in ("f32", "bf16", "int8"):
            log(f"[mesh] rank {r} forced decode step, B=4, {k}: host {row['host_ms_per_step'][k]:.2f} ms over "
                f"{backend} (one process {one[f'{k}_profile']['host_ms_per_step']:.2f} ms), device "
                f"{fmt(row['device_ms_per_step'][k], 3, ' ms')} (one process "
                f"{fmt(one[f'{k}_profile']['device_ms_per_step'], 3, ' ms')}) [{card}]")
        ok = (f32_drift <= MESH_F32_GATE and bf16_drift <= MESH_BF16_GATE and exact_ok and k5_ok
              and per_step == want_step and dpb["k1_launches"] == want_k1 and dpb["vocoder_calls"] >= 1 and finite
              and len(g16["codes"]) > 0 and np.isfinite(x["int8_logits"]).all())
        if not ok:
            failures.append(row)
    if failures:
        raise AssertionError(f"the mesh disagrees with one process or miscounts launches: {failures}")

    graph_rows, graph_s = mesh_graphs(card, world, backend, out_dir, cfg_path, device, stop_raise, one["block_ms"])
    total_s = time.perf_counter() - t_phase
    log(f"[mesh] phase {total_s:.1f} s (one process {one_s:.1f} s, the ranks {ranks_s:.1f} s, their captured "
        f"programs {graph_s:.1f} s) [{card}]")
    return {"backend": backend, "world": world, "ranks": rows, "one_process": {
        k: one[f"{k}_profile"] for k in ("f32", "bf16", "int8")}, "one_process_bf16_greedy_ms_per_step":
        one["bf16_greedy"]["decode_ms_per_step"], "seconds": total_s,
        "one_process_block_ms": one["block_ms"], "stop_raise": stop_raise, "probe": probe, "graph_ranks": graph_rows,
        "k5_launches_per_step_per_rank": rows[0]["k5_launches_per_step"],
        "k5_own_ms_per_step": max((r["k5_own_ms_per_step"] for r in rows if r["k5_own_ms_per_step"] is not None),
                                  default=None),
        "k5_own_ms_per_step_one_process": one["int8_profile"]["own_ms_per_step"][K5_KERNEL],
        "k5_max_abs_err": max(k["max_abs_err"] for r in rows for k in r["k5_shards"]),
        "k5_shard_shapes": [(k["case"], k["N"], k["K"]) for k in rows[0]["k5_shards"]],
        "k1_launches": rows[0]["dp_batch"]["k1_launches"], "k1_vocoder_calls": rows[0]["dp_batch"]["vocoder_calls"]}


def mesh_graphs(card: str, world: int, backend: str, out_dir: str, cfg_path: str, device: str, stop_raise: float,
                one_block: float):
    """The mesh phase's captured programs: mesh_graph_rank on `world` ranks
    over `backend` (writing into `out_dir`), against Graphs.eager() on the
    mesh; the stages the rule captures, the decision logs equal across each
    model group, host reads a decode run, rows stopped mid-block, the
    vocoder and K1 and K5's counts, the host and device ms of the B = 4
    decode step (beside one process's block, `one_block` host ms) and of a
    slot session's ticks. Returns (a row per rank, the ranks' seconds)."""
    import math
    import shutil

    import numpy as np

    from indextts_tpu_torch.graphs import BLOCK, stage_captures

    t = time.perf_counter()
    granks = spawn_ranks(mesh_graph_rank, (world, free_port(), backend, out_dir, cfg_path, device, stop_raise), world,
                         out_dir, "graph", MESH_DEADLINE_S)
    graph_s = time.perf_counter() - t
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    for r in range(world):  # each rank's own lines (graph_vs_eager, stage_vs_eager, step_profile)
        lines = open(os.path.join(out_dir, f"graph{r}.log")).read()
        with open(os.path.join(REPO, "chiprun_out", f"mesh_rank{r}.log"), "w") as f:
            f.write(lines)
        if r == 0:
            for line in lines.splitlines():
                if line.startswith("["):
                    log(f"[mesh] {line} [{card}]")
    shutil.rmtree(out_dir, ignore_errors=True)
    bad = [f"rank {r}: {x.get('error')}" for r, x in enumerate(granks) if not x["ok"]]
    if bad:
        raise AssertionError("\n".join(bad))
    nccl = backend == "nccl"
    want_rule = {name: stage_captures(name, device, backend) for name in ("dec", "slot", "voc", "lat", "cond")}
    k1_want = activations_per_call(load_config(cfg_path).bigvgan)
    graph_rows, failures = [], []
    for r, x in enumerate(granks):
        group = [y for y in granks if y["coords"][0] == x["coords"][0]]  # the rank's model group
        logs_equal = all(y["log"] == x["log"] for y in group)
        reads = {q["request"]: (q["host_reads"], q["gpt_steps"]) for q in x["requests"]}
        # one decode run a request: ceil(steps / BLOCK) host reads through blocks of conditional steps
        reads_ok = not nccl or all(n == math.ceil(st / BLOCK) for name, (n, st) in reads.items()
                                   if "nb1" in name and st)
        stopped = [q["request"] for q in x["requests"] if "+stop" in q["request"]
                   and any((n - 1) % BLOCK and n < x["n_codes"] for n in q["row_lengths"])]
        voc = x["vocoder"]
        k5_rows = [q for q in x["requests"] if q["request"].startswith("int8")]
        k5_ok = all(q["launches"].get("k5", 0) >= (4 * load_config(cfg_path).gpt.layers + 1) * q["gpt_steps"]
                    for q in k5_rows)
        step = x["step"]
        row = dict(rank=r, describe=x["describe"], rule=x["rule"], logs_equal_in_model_group=logs_equal,
                   log_len=len(x["log"]), decisions=dict(sorted(_count_events(x["log"]).items())),
                   reads=reads, stopped_mid_block=stopped, vocoder=voc, passes=x["passes"],
                   requests=x["requests"], step=step, seconds=x["seconds"], stats=x["stats"],
                   slot_ticks=x["slot_ticks"])
        graph_rows.append(row)
        fmt = lambda v: "not measured" if v is None else f"{v:.3f}"
        log(f"[mesh] rank {r} graphs: {x['describe']}; stages that capture "
            f"{[k for k, v in x['rule'].items() if v]} (rule {[k for k, v in want_rule.items() if v]}); decision log of "
            f"{len(x['log'])} entries {row['decisions']}, equal across the model group: {logs_equal}; "
            f"{x['seconds']:.1f} s [{card}]")
        log(f"[mesh] rank {r} graphs: codes eager = graph = graph again in {[q['request'] for q in x['requests']]}; "
            f"host reads (reads, steps) {reads}; rows stopped mid-block in {stopped}; vocoder within "
            f"{voc['max_int16_diff']} int16 units of eager, K1 {voc['k1_launches']} (want {k1_want} a call); "
            f"conditioning / latent bf16 units "
            f"{ {k: (v['bf16_units'] if 'bf16_units' in v else {b: u['bf16_units'] for b, u in v.items()}) for k, v in x['passes'].items()} }"
            f" [{card}]")
        for mode, v in step.items():
            log(f"[mesh] rank {r} decode step, B=4, bf16, {mode} over {backend}: host {v['host_ms_per_step']:.2f} ms, "
                f"device {fmt(v['device_ms_per_step'])} ms in {fmt(v['kernels_per_step'])} kernels, idle "
                f"{fmt(v['device_idle_share'])}; collectives' own device ms {v['own_ms_per_step']} (one process's "
                f"block {one_block:.2f} ms host) [{card}]")
        log(f"[mesh] rank {r} slot session, 4 slots, 6 requests, chunks of up to 25 steps over {backend}: host ms a "
            f"tick / a decode chunk (medians) " + "; ".join(
                f"{mode} {np.median(v['tick_ms']):.2f} / {np.median(v['chunk_ms']):.2f} over {len(v['tick_ms'])} ticks"
                for mode, v in x["slot_ticks"].items()) + f" [{card}]")
        ok = (x["rule"] == want_rule and logs_equal and reads_ok and voc["max_int16_diff"] == 0
              and all(n == k1_want for n in voc["k1_launches"].values()) and k5_ok and stopped
              and len(k5_rows) == 1)
        if not ok:
            failures.append({k: v for k, v in row.items()
                             if k not in ("requests", "stats", "passes", "step", "slot_ticks")})
    if failures:
        raise AssertionError(f"the mesh's captured programs fail their gates: {failures}")
    return graph_rows, graph_s


def mesh_graphs_phase(card: str, cfg_path: str = FLAGSHIP, device: str = DEVICE) -> dict:
    """The mesh phase's captured programs alone (`--phases meshgraphs`), on
    mesh_layout's ranks after the NCCL probe where there are two cards:
    mesh_graphs, without the one-process references of the mesh phase's
    other gates. The stop code's raise and one process's block host ms come
    from one process on the first card."""
    import gc
    import shutil

    import torch

    t_phase = time.perf_counter()
    e = mesh_engine(cfg_path, True, device, mesh=False)
    one_block = block_host_ms(b4_decode(e, e._conds_for(e.extract_features(PROMPT)), 32, False))
    stop_raise, _base = raise_stop_bias(e, card)
    del e
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[meshgraphs] one process, decode step, B=4, bf16: host {one_block:.2f} ms/step replayed in blocks "
        f"[{card}]")
    cards = torch.cuda.device_count() if device != "cpu" else 1
    world, backend = mesh_layout(cards)
    probe = nccl_probe(card) if cards >= 2 else None
    out_dir = os.path.join(REPO, "build", "mesh_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rows, graph_s = mesh_graphs(card, world, backend, out_dir, cfg_path, device, stop_raise, one_block)
    total_s = time.perf_counter() - t_phase
    log(f"[meshgraphs] phase {total_s:.1f} s (the ranks {graph_s:.1f} s) [{card}]")
    return {"backend": backend, "world": world, "probe": probe, "graph_ranks": rows, "one_process_block_ms": one_block,
            "stop_raise": stop_raise, "seconds": total_s}


def _count_events(entries) -> dict:
    """How many decisions of each (stage, event) a Graphs.log holds."""
    out = {}
    for stage, event, *_ in entries:
        out[f"{stage}.{event}"] = out.get(f"{stage}.{event}", 0) + 1
    return out


# the kernel wrappers' launch counters, K1-K8 (the graphs phase compares them eager against replayed)
K_NAMES = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8")
# the __global__ functions of K1-K8 (indextts_tpu_torch/csrc), as the profiler names the kernels that ran
# steps (or vocoder calls) in the short window where step_profile counts K1-K8's kernels
COUNT_STEPS = 4
# a window whose count of K1-K8's kernels falls short of the launches (the profiler dropped
# records: a replayed int8 window once read 387 of 388 K5 kernels over 4 steps) is taken
# again, up to this many windows; a count above the launches fails at once
COUNT_TRIES = 3
K_KERNELS = {"k1": ("anti_alias_snake_kernel",), "k2": ("aa_snake_dconv_f32_kernel", "aa_snake_dconv_wgmma_kernel"),
             "k3": ("tmajor_taps_kernel", "tmajor_ident_kernel", "tmajor_mma_kernel"), "k4": ("folded_aa_kernel",),
             "k5": ("int8_matmul_kernel",), "k6": ("decode_attn_kernel",), "k7": ("ssm_step_kernel",),
             "k8": ("add_layer_norm",)}


def kernel_counts(prof) -> dict:
    """How many kernels of K1-K8 a profile recorded on the card, by name.
    Kernels inside a replayed CUDA graph are recorded one by one, so this
    count does not depend on the wrappers' counters, which a replay does not
    run."""
    counts = {k: 0 for k in K_NAMES}
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0) <= 0:
            continue  # not a kernel
        for k, names in K_KERNELS.items():
            if any(n in e.key for n in names):
                counts[k] += e.count
    return counts


def run_profiled(fn, tries: int = 3):
    """fn() under torch.profiler, device activity only: its result and the
    profile. The profiler at times records no device event at all (PRs 6-8):
    such a profile is taken again, up to `tries` runs of fn in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        if any(getattr(e, "self_device_time_total", 0) > 0 for e in prof.key_averages()):
            return out, prof
        log(f"[profile] no device event recorded (run {attempt + 1} of {tries})")
    return out, prof


def kernel_modules() -> dict:
    from indextts_tpu_torch.ops.cuda import (aa_conv_branch, antialias, antialias_folded, antialias_tmajor,
                                             decode_attn, gpt2_chains, qmatmul, ssm_step)

    return dict(zip(K_NAMES, (antialias, aa_conv_branch, antialias_tmajor, antialias_folded, qmatmul, decode_attn,
                              ssm_step, gpt2_chains)))


class CodeRecorder:
    """Records every code row an engine decodes: the rows infer, infer_fast,
    infer_batch and a SlotSession hand to remove_long_silence, and a
    stream's codes after each of its decode_steps runs."""

    def __init__(self, engine):
        import numpy as np

        import indextts_tpu_torch.engine as engine_mod

        self.rows, self.engine, self.mod = [], engine, engine_mod
        self.silence, self.steps = engine.remove_long_silence, engine_mod.decode_steps

        def silence(codes, *a, **kw):
            self.rows.append(np.asarray(codes).copy())
            return self.silence(codes, *a, **kw)

        def steps(model, cfg, state, *a, **kw):
            out = self.steps(model, cfg, state, *a, **kw)
            self.rows.append(out.codes[:, : out.i + 1].cpu().numpy())
            return out

        engine.remove_long_silence = silence
        engine_mod.decode_steps = steps

    def close(self):
        del self.engine.remove_long_silence
        self.mod.decode_steps = self.steps


def graph_vs_eager(engine, rec, name: str, fn, card: str, seed: int = 11) -> dict:
    """fn() three times: under the engine's private eager switch, then
    through its graphs (capturing the keys it has not seen), then once more
    (replays only), the engine's generator reseeded alike before each (a
    slot session seeds its own). Every code row the three decode must be
    token-exact, K1-K8's wrappers must count as many launches in each (a
    replay adds the counts its capture took), and a list fn returns (chunk
    or wav sizes) must be the same. The profiler's own count of K1-K8's
    kernels under replay is step_profile's and the vocoder routes'. Returns
    the wall seconds, the launches of one run and the decode ms per step of
    each."""
    import contextlib

    import torch

    mods = kernel_modules()
    import numpy as np

    loops = (engine._graphs.decode, engine._graphs.slot)
    runs = {}
    for mode in ("eager", "graph", "graph_again"):
        engine._generator.manual_seed(seed)
        engine.last_stats = {}
        rec.rows.clear()
        for m in mods.values():
            m.launches = 0  # this run of the path starts here
        reads = sum(stage.reads for stage in loops)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with engine._graphs.eager() if mode == "eager" else contextlib.nullcontext():
            result = fn()
        torch.cuda.synchronize()
        runs[mode] = dict(s=time.perf_counter() - t, rows=list(rec.rows), result=result,
                          launches={k: m.launches for k, m in mods.items()}, stats=dict(engine.last_stats),
                          reads=sum(stage.reads for stage in loops) - reads)
    base = runs["eager"]
    if not base["rows"]:
        raise AssertionError(f"{name}: no code rows were recorded")
    for mode in ("graph", "graph_again"):
        rows = runs[mode]["rows"]
        if len(rows) != len(base["rows"]) or any(a.shape != b.shape or not (a == b).all()
                                                 for a, b in zip(rows, base["rows"])):
            raise AssertionError(f"{name}: the {mode} run's codes differ from the eager run's")
        if runs[mode]["launches"] != base["launches"]:
            raise AssertionError(f"{name}: launches {runs[mode]['launches']} under {mode}, "
                                 f"{base['launches']} eager")
        if isinstance(base["result"], list) and runs[mode]["result"] != base["result"]:
            raise AssertionError(f"{name}: {runs[mode]['result']} under {mode}, {base['result']} eager")
    if runs["graph"]["reads"] != base["reads"] or runs["graph_again"]["reads"] != base["reads"]:
        raise AssertionError(f"{name}: host reads {[r['reads'] for r in runs.values()]} (eager, graph, again)")
    steps = lambda r: max(r["stats"].get("gpt_steps", 0), 1)
    stop = engine.cfg.gpt.stop_mel_token
    # each recorded row's length up to its first stop code (its budget if none)
    lengths = sorted(int(np.argmax(r == stop)) if (r == stop).any() else r.shape[-1]
                     for rr in base["rows"] for r in np.atleast_2d(rr))
    row = {"request": name, "codes": int(sum(r.shape[-1] for r in base["rows"])),
           "rows": len(base["rows"]), "launches": base["launches"], "segments": base["stats"].get("gpt_segments"),
           "gpt_steps": base["stats"].get("gpt_steps"), "host_reads": base["reads"], "row_lengths": lengths,
           **{f"{mode}_s": runs[mode]["s"] for mode in runs},
           **{f"{mode}_decode_ms_per_step": 1e3 * runs[mode]["stats"].get("gpt_gen_s", 0.0) / steps(runs[mode])
              for mode in runs if "gpt_gen_s" in runs[mode]["stats"]},
           **{f"{mode}_{key}_ms": 1e3 * runs[mode]["stats"][stat] for mode in runs
              for key, stat in (("latent", "gpt_forward_s"), ("cond", "cond_s")) if stat in runs[mode]["stats"]}}
    gs = row["gpt_steps"]
    reads = (f"{row['host_reads']} host reads for {gs} decode steps (one a step before blocks)" if gs
             else f"{row['host_reads']} host reads")
    lat = (f"; latent pass {row['eager_latent_ms']:.1f} ms eager, {row['graph_again_latent_ms']:.1f} replayed"
           if "eager_latent_ms" in row else "")
    log(f"[graphs] {name}: {row['rows']} code rows token-exact in eager, graph and graph again (lengths to the "
        f"first stop {lengths}); {reads}; wall {row['eager_s']:.2f} / {row['graph_s']:.2f} / "
        f"{row['graph_again_s']:.2f} s{lat}; launches { {k: v for k, v in base['launches'].items() if v} } in each "
        f"[{card}]")
    return row


def bf16_units(got, want) -> float:
    """The largest |got - want|, element by element, in units of the bf16
    spacing at |want| (a bit-equal pair reads 0)."""
    import torch

    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return float(((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def stage_vs_eager(engine, name: str, fn, card: str, iters: int = 5) -> dict:
    """fn() (one of the engine's latent or conditioning passes) under
    Graphs.eager() and replayed from its stage: the replay within 1 bf16
    unit of eager (bit-equal unless cuBLAS picks another algorithm under
    capture), and ms per call of each, host clock synchronized, the least of
    `iters` (the first graph call of a new key captures and is not timed)."""
    import torch

    with torch.no_grad():
        with engine._graphs.eager():
            want = fn()
        fn()  # a new key's warm run and capture
        got = fn()
        units = bf16_units(got, want)
        ms = {}
        for mode in ("eager", "replayed"):
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if mode == "eager":
                    with engine._graphs.eager():
                        fn()
                else:
                    fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t))
            ms[mode] = min(times)
    log(f"[graphs] {name}: replayed within {units:.3g} bf16 unit(s) of eager (gate 1), {tuple(got.shape)}; "
        f"{ms['eager']:.2f} ms eager, {ms['replayed']:.2f} ms replayed [{card}]")
    if not units <= 1.0 or got.shape != want.shape:
        raise AssertionError(f"{name}: the replayed pass differs from eager by {units} bf16 units")
    return {"bf16_units": units, "shape": list(got.shape), "eager_ms": ms["eager"], "replayed_ms": ms["replayed"]}


def conditioning_vs_eager(engine, card: str, label: str) -> dict:
    """The engine's conditioning stage on the sample prompt (its frame
    bucket, b = 1) and on a batch of two prompts (the prompt and its first
    half, one bucket: _conds_for_many's batched call), replayed against
    eager (stage_vs_eager)."""
    import numpy as np
    import torch

    prompt = engine.extract_features(PROMPT)  # [1, 100, frames]
    frames = prompt.shape[-1]
    bucket = max(-(-frames // 100) * 100, 100)
    mel = np.zeros((2, bucket, prompt.shape[1]), np.float32)
    mel[0, :frames] = prompt[0].T
    mel[1, : frames // 2] = prompt[0, :, : frames // 2].T
    mel_t = torch.from_numpy(mel).to(engine.device, engine.dtype)
    lens = torch.tensor([frames, frames // 2], device=engine.device)
    return {f"b{b}": stage_vs_eager(engine, f"{label} conditioning, b={b}, {bucket} frames",
                                    lambda b=b: engine._conditioning(mel_t[:b], lens[:b]), card) for b in (1, 2)}


def raise_stop_bias(engine, card: str, sample: bool = True):
    """Random weights never emit the stop code. Raise its mel-head bias, in
    place (the captured programs read it at its address), until a sampled
    (`sample`, else greedy) one-row 60-code request, eager, stops after 4 codes and before its
    budget: the first raise of a grid that does, else a bisection between
    the last raise that never stopped and the first that stopped at once
    (which it keeps when the bisection finds nothing between: the request
    then stops at its first steps). The rows of the routes then stop before
    their budgets, mid-block. Returns (the raise, left applied; the bias
    before it, to put back)."""
    import torch

    bias = engine.gpt.mel_head.bias
    stop = engine.cfg.gpt.stop_mel_token
    base = bias[stop].item()
    tried, kind = [], "sampled" if sample else "greedy"

    def steps_at(delta: float) -> int:
        with torch.no_grad():
            bias[stop] = base + delta
        engine._generator.manual_seed(11)
        with engine._graphs.eager():
            engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.", do_sample=sample, num_beams=1, max_mel_tokens=60)
        tried.append((round(delta, 4), engine.last_stats["gpt_steps"]))
        return engine.last_stats["gpt_steps"]

    lo = hi = None
    for delta in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0):
        n = steps_at(delta)
        if 4 <= n < 59:
            lo = hi = delta
            break
        if n >= 59:
            lo = delta
        else:
            hi = delta
            break
    for _ in range(10):
        if lo is None or hi is None or lo == hi:
            break
        mid = 0.5 * (lo + hi)
        n = steps_at(mid)
        if 4 <= n < 59:
            lo = hi = mid
        elif n >= 59:
            lo = mid
        else:
            hi = mid
    if hi is None:
        with torch.no_grad():
            bias[stop] = base
        raise AssertionError(f"no raise of the stop bias stopped a {kind} 60-code request: {tried}")
    lo = hi
    with torch.no_grad():
        bias[stop] = base + lo
    log(f"[graphs] stop code's bias raised by {lo:.4f} (tried {tried}: decode steps of a {kind} 60-code request): "
        f"rows now stop mid-block [{card}]")
    return lo, base


def step_profile(engine, prepare, card: str, label: str, want: dict, modes=("eager", "graph", "graph_per_step"),
                 own=(), agree=None) -> dict:
    """Host and device ms per step of a decode route, eager beside replayed:
    prepare() sets up a fresh state (prefill, admission) and returns go(),
    which runs the steps and returns how many ran. Per mode: one run to warm
    (and capture), one timed on the host clock (synchronized), one under
    torch.profiler (the summed device time of every kernel, their count, and
    the span from the first kernel's start to the last one's end: what the
    span adds to the sum is the gaps between kernels, what the host time
    adds to the span is the host's own part of a step). Then one short run,
    go(COUNT_STEPS), under the profiler again: its count of K1-K8's kernels,
    by name, must be `want` a step (the wrappers' count) in each mode; under
    replay, the count that does not rest on the wrappers' counters. The
    window is short because the profiler drops a kernel record now and then
    in long ones (1 of 3104 K5 kernels over 32 eager int8 steps, 73 of 109
    K1 kernels over a whole eager request, in earlier runs). The replayed
    route runs twice: in blocks (go(n): up to graphs.BLOCK steps a replay,
    one host read a block) and one step a call (go(1) n times: a replay and
    a read each step, the host's pattern before blocks). `modes` picks some
    of the three; for each name in `own`, the device ms per step of the
    kernels whose name holds it. On a mesh, `agree(flag)` is the flag
    or-ed over the ranks: a run is taken again on every rank or on none
    (each run's collectives pair up across the ranks)."""
    import contextlib
    import inspect

    import torch

    def per_step(go):
        """go, one step a call: a replay and a host read each step."""
        default = inspect.signature(go).parameters["n"].default
        return lambda n=default: sum(go(1) for _ in range(n))

    out = {}
    either = agree or (lambda flag: flag)
    for mode in modes:
        fresh = (lambda: per_step(prepare())) if mode == "graph_per_step" else prepare
        with engine._graphs.eager() if mode == "eager" else contextlib.nullcontext():
            fresh()()
            go = fresh()
            torch.cuda.synchronize()
            t = time.perf_counter()
            n = go()
            torch.cuda.synchronize()
            host = 1e3 * (time.perf_counter() - t) / n
            go = fresh()
            torch.cuda.synchronize()
            n2, prof = run_profiled(go, tries=1)
            if either(not any(getattr(e, "self_device_time_total", 0) > 0 for e in prof.key_averages())):
                go = fresh()  # the profiler recorded nothing: profile a fresh run again
                torch.cuda.synchronize()
                n2, prof = run_profiled(go, tries=1)
            dropped = []
            for _ in range(COUNT_TRIES):
                go = fresh()
                torch.cuda.synchronize()
                n3, short = run_profiled(lambda: go(COUNT_STEPS), tries=1 if agree else 3)
                counted = kernel_counts(short)
                expected = {k: want.get(k, 0) * n3 for k in K_NAMES}
                if not either(not (counted == expected or any(counted[k] > expected[k] for k in K_NAMES))):
                    break
                dropped.append(counted)  # fewer records than launches: the profiler dropped some
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        if dropped:
            log(f"[profile] {label}, {mode}: windows with records dropped, taken again: {dropped} [{card}]")
        if counted != expected:
            raise AssertionError(f"{label}: the profiler counted {counted} kernels of K1-K8 over {n3} {mode} steps, "
                                 f"want {want} a step (earlier windows: {dropped})")
        device = sum(e.self_device_time_total for e in events) / 1e3 / n2 if events else None
        kernels = [e for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        span = ((max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3 / n2
                if kernels else None)
        go = None  # the mode's last state goes, and its lane is free for the next mode's runs
        out[mode] = {"steps": n, "host_ms_per_step": host, "device_ms_per_step": device,
                     "kernels_per_step": sum(e.count for e in events) / n2 if events else None,
                     "device_span_ms_per_step": span, "k_kernels": counted, "count_steps": n3,
                     "device_idle_share": None if device is None else 1.0 - device / host,
                     "own_ms_per_step": {name: (sum(e.self_device_time_total for e in events if name in e.key)
                                                / 1e3 / n2 if events else None) for name in own}}
    dev = lambda v: "not measured" if v["device_ms_per_step"] is None else (
        f"{v['device_ms_per_step']:.3f} ms in {v['kernels_per_step']:.0f} kernels over a span of "
        f"{v['device_span_ms_per_step']:.3f} ms, idle {100 * v['device_idle_share']:.1f} %; K1-K8 kernels "
        f"{ {k: c for k, c in v['k_kernels'].items() if c} } by the profiler over {v['count_steps']} steps"
        + "".join(f"; {name} kernels {ms:.4f} ms" for name, ms in v["own_ms_per_step"].items() if ms is not None))
    names = {"eager": "eager", "graph": "replayed in blocks", "graph_per_step": "replayed one step a call"}
    log(f"[graphs] {label}: host " + ", ".join(f"{out[m]['host_ms_per_step']:.2f} ms/step {names[m]}" for m in modes)
        + "; device " + "; ".join(f"{names[m]} {dev(out[m])}" for m in modes) + f" [{card}]")
    return out


def block_host_ms(prepare) -> float:
    """Host ms a step of prepare()'s decode run (step_profile's prepare)
    replayed in blocks, synchronized, after one run that warms and captures
    its key. No profiler: after a profiled run of replayed blocks,
    torch.profiler records fewer kernels than ran in every later profile of
    the process (phase_in_child)."""
    import torch

    prepare()()
    go = prepare()
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = go()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / n


def b4_decode(engine, conds, steps: int, quant_kv: bool):
    """step_profile's prepare for the B = 4 sampled decode step: text rows
    of 12, 9, 16 and 5 tokens from a fixed seed, prefilled for `steps`
    steps, run through the engine's decode stage."""
    import numpy as np
    import torch

    from indextts_tpu_torch.models import gpt_decode as tdec

    cfg, dev = engine.cfg.gpt, engine.device
    r = np.random.default_rng(7)
    lens4 = np.asarray([12, 9, 16, 5])
    text4 = np.full((4, 16), cfg.stop_text_token, np.int64)
    for i, n in enumerate(lens4):
        text4[i, :n] = r.integers(0, cfg.number_text_tokens - 1, n)
    text4_t, lens4_t = torch.from_numpy(text4).to(dev), torch.from_numpy(lens4).to(dev)

    def prepare():
        gen = tdec.GenerationConfig(do_sample=True, top_k=30, max_new_tokens=steps + 1)
        with torch.no_grad():
            st, ctx = tdec.prefill_decode_state(engine.gpt, cfg, gen, conds.expand(4, -1, -1), text4_t, lens4_t,
                                                torch.Generator(device=dev).manual_seed(0), quant_kv=quant_kv)

        def go(n=steps):
            i0 = st.i
            with torch.no_grad():
                tdec.decode_steps(engine.gpt, cfg, st, ctx, n, graphs=engine._graphs.decode)
            return st.i - i0
        return go
    return prepare


def cuda_driver_version() -> int:
    """The CUDA driver's version (cuDriverGetVersion: 12040 is 12.4)."""
    import ctypes

    v = ctypes.c_int(0)
    if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(v)) != 0:
        raise RuntimeError("cuDriverGetVersion failed")
    return v.value


def if_node_check(card: str) -> dict:
    """The block of conditional steps (graphs.py, csrc/graph_block.cu) on a
    toy loop, before any model: a counter loop whose condition is t < stop,
    each step adding its row of a uniforms buffer, run through a decode
    stage in blocks of BLOCK, replayed and under Graphs.eager(); budgets of
    3, 16 and 16 with the stop at 10 must run 3, 7 (a stop mid-block, read
    back as the condition false) and 0 steps in both, to the same state.
    The same with a step that records an external event and waits on it,
    as PyTorch's ProcessGroupNCCL does around each collective it captures:
    its captured step must hold event nodes, which the block's bodies drop
    (csrc/graph_block.cu). Then a step of cuBLAS (a bf16 [4, 1280] x
    [1280, 8194] product), a sort, a top-k and a 64 MiB temporary: replayed
    equal to eager, and the pool growth of its block against one step's
    temporaries. Prints torch's CUDA and the driver's."""
    import contextlib

    import torch

    from indextts_tpu_torch.graphs import BLOCK, Graphs

    class Toy:  # a loop state (held weakly by its lane)
        def __init__(self, **tensors):
            self.__dict__.update(tensors)

    info = {"torch": torch.__version__, "torch_cuda": torch.version.cuda, "driver": cuda_driver_version(),
            "block": BLOCK}
    log(f"[ifnode] torch {info['torch']}, torch.version.cuda {info['torch_cuda']}, CUDA driver {info['driver']}; "
        f"blocks of {BLOCK} conditional steps [{card}]")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(1280, 8194, device=dev, dtype=torch.bfloat16, generator=g)

    def loop(graphs, kind: str):
        st = Toy(t=torch.zeros(1, dtype=torch.long, device=dev), x=torch.zeros(4, device=dev),
                 stop=torch.full((1,), 10, dtype=torch.long, device=dev),
                 h=torch.randn(4, 1280, device=dev, dtype=torch.bfloat16, generator=g),
                 top=torch.zeros(4, 30, device=dev), u=torch.zeros(BLOCK, 4, device=dev))
        lane = graphs.decode.bind(("toy", kind), st, [(st, ("t", "x", "stop", "h", "top", "u"))])
        ev = torch.cuda.Event(external=True)

        def step():
            st.x.add_(st.u.index_select(0, lane.ctl.ran)[0])
            if kind == "events":
                ev.record()
                ev.wait()
                st.x.mul_(0.75)
            if kind == "heavy":
                tmp = torch.empty(16 << 20, device=dev)
                tmp.fill_(1.0)
                logits = (st.h @ w).float() + tmp[:1]
                vals, _ = torch.sort(logits, dim=-1, descending=True)
                st.top.copy_(torch.topk(vals, 30, dim=-1)[0])
                st.h.add_(st.top[:, :1].to(st.h.dtype) * 1e-3)
            st.t.add_(1)

        runs = []
        for budget in (3, 16, 16):
            st.u.copy_(torch.rand(BLOCK, 4, device=dev, generator=g))
            runs.append(graphs.decode.run(lane, step, lambda: st.t < st.stop, budget))
        torch.cuda.synchronize()
        return runs, st, lane

    out = {}
    for kind in ("light", "events", "heavy"):
        res = {}
        for mode in ("eager", "graph"):
            graphs = Graphs("cuda")
            g.manual_seed(3)
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                runs, st, lane = loop(graphs, kind)
            res[mode] = (runs, st, lane)
        (re, se, _), (rg, sg, lg) = res["eager"], res["graph"]
        if [r for r, _ in re] != [3, 7, 0] or [a for _, a in re] != [True, False, False] or re != rg:
            raise AssertionError(f"blocks ran {rg} replayed, {re} eager; want (3, True), (7, False), (0, False)")
        if lg.graph is None or lg.replays != 2:
            raise AssertionError(f"the toy block was not captured and replayed twice ({lg.replays} replays)")
        for name in ("t", "x", "h", "top"):
            if not torch.equal(getattr(se, name), getattr(sg, name)):
                raise AssertionError(f"toy block ({kind}): {name} replayed differs from eager")
        out[kind] = {"runs": rg, "capture_s": lg.capture_s, "pool_bytes": lg.pool_bytes,
                     "step_nodes": graph_node_types(lg.graph.step.raw_cuda_graph())}
    events = out["events"]["step_nodes"]
    if not events.get("event_record") or not events.get("event_wait"):
        raise AssertionError(f"the events step was captured without event nodes: {events}")
    info.update(out)
    log(f"[ifnode] toy blocks replayed as eager: budgets 3, 16, 16 ran {[r for r, _ in out['light']['runs']]} steps "
        f"(a stop mid-block); a step of {events} nodes run in bodies without its event nodes: equal to eager; "
        f"a cuBLAS + sort + top-k step with a 64 MiB temporary: equal to eager, block "
        f"captured in {out['heavy']['capture_s']:.3f} s, pool +{out['heavy']['pool_bytes'] / 2**20:.1f} MiB for "
        f"{BLOCK} copies of one step [{card}]")
    return info


# the driver API's CUgraphNodeType values, by name
CU_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child_graph", 5: "empty", 6: "event_wait",
                 7: "event_record", 8: "ext_semaphore_signal", 9: "ext_semaphore_wait", 10: "mem_alloc",
                 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
# the node types CUDA allows in a conditional node's body
IF_BODY_TYPES = {"kernel", "memcpy", "memset", "empty", "child_graph", "conditional"}
# a probe step's collectives: per layer, an all-reduce of a bf16 [4, 1280] (staged in float32, as
# Comm.all_reduce does) and one of a float32 [4, 1280], then the head's gather: 49, as a tp = 2 decode step
PROBE_LAYERS = 24


def graph_node_types(graph: int) -> dict:
    """How many nodes of each type a CUDA graph (a cudaGraph_t's address,
    torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()) holds, the
    nodes of its child graphs counted in, through the driver API."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    counts = {}

    def check(err):
        if err != 0:
            raise RuntimeError(f"CUDA driver error {err} while walking a graph")

    def walk(g):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(ctypes.c_void_p(g), None, ctypes.byref(n)))
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(ctypes.c_void_p(g), nodes, ctypes.byref(n)))
        for node in nodes:
            kind = ctypes.c_int(0)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
            name = CU_NODE_TYPES.get(kind.value, str(kind.value))
            counts[name] = counts.get(name, 0) + 1
            if name == "child_graph":
                child = ctypes.c_void_p()
                check(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node), ctypes.byref(child)))
                walk(child.value)

    walk(graph)
    return counts


def probe_block(dev) -> dict:
    """One rank of the NCCL probe: a toy loop whose step makes a tp = 2
    decode step's 49 collectives over the world group (Comm's all-reduce
    and gather) and stops once its counter reaches 10, run in blocks of
    BLOCK with budgets 3, 16 and 16: eagerly (the IF read on the host), in
    a block graph whose IF bodies are copies of the captured step
    (csrc/graph_block.cu), and one captured step a replay with a host read
    a step. The captured step's node types; whether the block builds and
    replays, and to the same state and steps as eager (bit-equal); host
    ms a step of each route over 64 steps."""
    import torch
    import torch.distributed as dist

    from indextts_tpu_torch.graphs import BLOCK, BlockControl
    from indextts_tpu_torch.ops.cuda.graph_block import BlockGraph
    from indextts_tpu_torch.parallel.mesh import Comm

    comm = Comm(dist.group.WORLD, list(range(dist.get_world_size())))
    info = {"nccl": ".".join(map(str, torch.cuda.nccl.version())), "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "driver": cuda_driver_version(),
            "nccl_env": {k: v for k, v in os.environ.items() if k.startswith("NCCL_")}}
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(1280, 1280, device=dev, dtype=torch.bfloat16, generator=g) * 0.03

    class Toy:
        def __init__(self, stop):
            gen = torch.Generator(device=dev).manual_seed(7 + comm.index)  # each rank its own start
            self.h = torch.randn(4, 1280, device=dev, dtype=torch.bfloat16, generator=gen)
            self.f = torch.randn(4, 1280, device=dev, generator=gen)
            self.out = torch.zeros(4, 1280 * comm.size, device=dev, dtype=torch.bfloat16)
            self.t = torch.zeros(1, dtype=torch.long, device=dev)
            self.stop = torch.full((1,), stop, dtype=torch.long, device=dev)
            self.ctl = BlockControl(dev)

    def fns(s):
        def head():
            s.ctl.status.zero_()
            s.ctl.live.copy_((s.t < s.stop).reshape(1))

        def body():
            for _ in range(PROBE_LAYERS):
                y = torch.tanh(s.h @ w)
                comm.all_reduce(y)
                s.h.copy_(y * 0.5)
                comm.all_reduce(s.f)
                s.f.mul_(0.5)
            s.out.copy_(comm.gather(s.h, dim=1))
            s.t.add_(1)
            s.ctl.ran.add_(1)
            s.ctl.live.copy_((s.t < s.stop).reshape(1))
        return head, body

    def read(s):
        ran, live = s.ctl.status.tolist()
        return ran, bool(live)

    def eager_block(s, budget):
        head, body = fns(s)
        s.ctl.budget.fill_(budget)
        head()
        for _ in range(BLOCK):
            if not bool(s.ctl.holds()):
                break
            body()
        return read(s)

    def capture(s):
        """Warm one block of 3 eagerly on a side stream, then capture the
        head and the step (keep_graph: the block reads the graphs)."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            first = eager_block(s, 3)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for fn in fns(s):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                fn()
            graphs.append(graph)
        return first, graphs

    def per_step_block(s, graphs, budget):
        head, step = graphs
        s.ctl.budget.fill_(budget)
        head.replay()
        for _ in range(BLOCK):
            if not bool(s.ctl.holds()):  # the host read of each step
                break
            step.replay()
        return read(s)

    def state(s):
        return [t.clone() for t in (s.h, s.f, s.out, s.t)]

    budgets = (16, 16)
    ref = Toy(10)
    runs = {"eager": [eager_block(ref, 3)] + [eager_block(ref, b) for b in budgets]}
    want = state(ref)

    s = Toy(10)
    first, (head, step) = capture(s)
    info["step_graph_nodes"] = graph_node_types(step.raw_cuda_graph())
    info["head_graph_nodes"] = graph_node_types(head.raw_cuda_graph())
    info["outside_if_body"] = sorted(set(info["step_graph_nodes"]) - IF_BODY_TYPES)
    runs["per_step"] = [first] + [per_step_block(s, (head, step), b) for b in budgets]
    info["per_step_equal"] = runs["per_step"] == runs["eager"] and all(
        torch.equal(a, b) for a, b in zip(state(s), want))

    s = Toy(10)
    first, (head, step) = capture(s)
    try:
        block = BlockGraph(head, step, BLOCK, s.ctl.status, s.ctl.budget)

        def block_run(budget):
            s.ctl.budget.fill_(budget)
            block.replay()
            return read(s)

        runs["block"] = [first] + [block_run(b) for b in budgets]
        info["block_equal"] = runs["block"] == runs["eager"] and all(
            torch.equal(a, b) for a, b in zip(state(s), want))
        info["block_error"] = None
    except RuntimeError as err:
        block, info["block_equal"], info["block_error"] = None, False, str(err)
    info["runs"] = runs

    # host ms a step over 4 blocks of 16 (a stop far away), each route on a fresh state
    timing = {}
    for route in ("eager", "per_step", "block"):
        if route == "block" and block is None:
            continue
        s = Toy(10 ** 6)
        if route == "eager":
            go = lambda b: eager_block(s, b)
        else:
            first, graphs = capture(s)
            if route == "per_step":
                go = lambda b: per_step_block(s, graphs, b)
            else:
                block = BlockGraph(*graphs, BLOCK, s.ctl.status, s.ctl.budget)

                def go(b):
                    s.ctl.budget.fill_(b)
                    block.replay()
                    return read(s)
        go(16)
        torch.cuda.synchronize(dev)
        dist.barrier()
        t = time.perf_counter()
        steps = sum(go(16)[0] for _ in range(4))
        torch.cuda.synchronize(dev)
        timing[route] = 1e3 * (time.perf_counter() - t) / steps
    info["host_ms_per_step"] = timing
    return info


def probe_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One spawned rank of nccl_probe, on cuda:{rank}; writes probe<r>.pkl,
    or the traceback."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    out = {"ok": False}
    try:
        out.update(probe_block(dev))
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"probe{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def phase_child(rank: int, name: str, card: str, out_dir: str) -> None:
    """phase_in_child's process: runs the phase, its lines to
    out_dir/phase0.log; writes phase0.pkl (the result, or the traceback)."""
    import pickle
    import traceback

    sys.path.insert(0, REPO)
    sys.stdout = sys.stderr = open(os.path.join(out_dir, "phase0.log"), "w", buffering=1)
    out = {"ok": False}
    try:
        out["result"] = {"graphs": graphs_phase, "hybrid": hybrid_phase}[name](card)
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, "phase0.pkl"), "wb") as f:
            pickle.dump(out, f)


def phase_in_child(name: str, card: str, deadline_s: float = 900) -> dict:
    """Phase `name` in a spawned process of its own; its result, its lines
    printed here. The graphs phase profiles replayed blocks of conditional
    steps, and torch.profiler then records fewer kernels than ran in every
    later profile of the process (the kernel phases read 0.4-0.7 records a
    launch after it, one card); a profiled window of replayed blocks late
    in a long process missed records the same way (387 or 0 of 388 K5
    kernels). Its own process keeps both sides whole."""
    import gc
    import shutil

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(REPO, "build", f"{name}_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        (res,) = spawn_ranks(phase_child, (name, card, out_dir), 1, out_dir, "phase", deadline_s)
    finally:
        path = os.path.join(out_dir, "phase0.log")
        if os.path.exists(path):
            for line in open(path).read().splitlines():
                if line.startswith("["):
                    log(line)
    return res["result"]


def release_graphs() -> None:
    """Free the dropped engines' captured graphs before the process group
    goes: a graph stage and its Graphs hold each other, so only the
    collector frees them, and destroy_process_group waits on NCCL's
    communicators while a graph of their captured collectives lives (seen
    on four cards: every rank done in 64 s, then waiting there until its
    deadline)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()


def rank_output(out_dir: str, prefix: str, rank: int) -> None:
    """A spawned rank's stdout and stderr to out_dir/<prefix><r>.log, line by
    line, with every thread's stack written there 20 s before the mesh
    ranks' deadline (a hang then shows where it waits)."""
    import faulthandler

    f = open(os.path.join(out_dir, f"{prefix}{rank}.log"), "w", buffering=1)
    sys.stdout = sys.stderr = f
    faulthandler.dump_traceback_later(MESH_DEADLINE_S - 20, file=f)


def spawn_ranks(fn, args, world: int, out_dir: str, prefix: str, deadline_s: float) -> list:
    """fn(rank, *args) on `world` spawned processes; each must finish
    within deadline_s (a hang is killed and fails, with the end of each
    rank's out_dir/<prefix><r>.log where it keeps one). Returns what each
    rank wrote to out_dir/<prefix><r>.pkl."""
    import pickle

    import torch

    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + deadline_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise AssertionError(f"the ranks did not finish in {deadline_s:.0f} s")
    except Exception as err:
        tails = []
        for r in range(world):
            path = os.path.join(out_dir, f"{prefix}{r}.log")
            if os.path.exists(path):
                tails.append(f"--- rank {r}, the end of {prefix}{r}.log:\n" + open(path).read()[-6000:])
        raise AssertionError(f"{err}\n" + "\n".join(tails)) from err
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{prefix}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_probe(card: str) -> dict:
    """Whether NCCL's captured collectives can live inside the decode
    block's IF bodies on this machine: two ranks over NCCL, a card each
    (probe_block). Prints NCCL's, torch's CUDA and the driver's versions
    and the captured step's node types. Fails only if the captured step
    (the block's or one a replay) disagrees with eager."""
    import shutil

    out_dir = os.path.join(REPO, "build", "nccl_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ranks = spawn_ranks(probe_rank, (2, free_port(), out_dir), 2, out_dir, "probe", 240)
    bad = [f"rank {r}: {x.get('error')}" for r, x in enumerate(ranks) if not x["ok"]]
    if bad:
        raise AssertionError("\n".join(bad))
    for r, x in enumerate(ranks):
        log(f"[probe] rank {r}: NCCL {x['nccl']}, torch {x['torch']}, torch.version.cuda {x['torch_cuda']}, CUDA "
            f"driver {x['driver']}, NCCL_* {x['nccl_env']} [{card}]")
        log(f"[probe] rank {r}: captured step's nodes {x['step_graph_nodes']} (head {x['head_graph_nodes']}); "
            f"types an IF body refuses: {x['outside_if_body'] or 'none'} [{card}]")
        log(f"[probe] rank {r}: block of {len(x['runs']['eager'])} runs eager {x['runs']['eager']}; one step a "
            f"replay {x['runs']['per_step']} equal {x['per_step_equal']}; IF-body block "
            f"{x['runs'].get('block')} equal {x['block_equal']} (error {x['block_error']}) [{card}]")
        log(f"[probe] rank {r}: host ms a step of {2 * PROBE_LAYERS + 1} collectives: "
            f"{ {k: round(v, 4) for k, v in x['host_ms_per_step'].items()} } [{card}]")
    if not all(x["per_step_equal"] for x in ranks):
        raise AssertionError("a captured NCCL step replayed one a call differs from eager")
    if any(x["block_error"] is None and not x["block_equal"] for x in ranks):
        raise AssertionError("the IF-body block of a captured NCCL step built but differs from eager")
    return {"ranks": ranks, "if_body": all(x["block_equal"] for x in ranks)}


def graphs_phase(card: str) -> dict:
    """The engine's captured programs (indextts_tpu_torch/graphs.py) at the
    published widths, bf16, random init from seed 0: the toy block check;
    each request eager (the private switch), then replayed twice, also with
    the stop code's bias raised (rows stop mid-block); codes token-exact,
    K1-K8 launch counts and host reads equal; conditioning and latent passes
    within 1 bf16 unit; vocoder wav within 1 int16 unit on the four routes;
    host and device ms per step eager beside replayed in blocks and one step
    a call; capture seconds and pool bytes per key; warmup seconds."""
    import contextlib

    import numpy as np
    import torch

    from indextts_tpu_torch.graphs import BLOCK
    from indextts_tpu_torch.models import gpt_decode as tdec
    from indextts_tpu_torch.models import gpt_slots as tslots
    from indextts_tpu_torch.ops.cuda import qmatmul
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    t0 = time.perf_counter()
    engine = flagship_engine()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not engine._graphs.decode.capturing:
        raise AssertionError("a CUDA engine that captures nothing")
    ifnode = if_node_check(card)
    # the first warmup captures the keys it visits; the second replays them
    warm = [engine.warmup(texts=("WARM UP.",), verbose=False, max_mel_tokens=60) for _ in range(2)]
    log(f"[graphs] flagship built in {init_s:.1f} s; warmup (default kwargs, 60 codes) {warm[0]:.2f} s with its "
        f"captures, {warm[1]:.2f} s again [{card}]")
    rec = CodeRecorder(engine)
    rows = []
    # run by this phase's profiled replays (the vocoder routes' graph runs and
    # step_profile's replayed steps), as the profiler counted them
    graph_launches = {k: 0 for k in K_NAMES}
    short = dict(audio_prompt=PROMPT, text="HELLO WORLD.", max_mel_tokens=60)
    try:
        requests = [
            ("greedy_nb1", lambda: engine.infer(do_sample=False, num_beams=1, **short)),
            ("sampled_nb1", lambda: engine.infer(num_beams=1, **short)),
            ("greedy_nb3", lambda: engine.infer(do_sample=False, **short)),
            ("default_nb3", lambda: engine.infer(**short)),
            # 320 = two segments of 160: the segmented beam loop, one key per segment
            ("default_nb3_320_segmented", lambda: engine.infer(audio_prompt=PROMPT, text="HELLO WORLD.",
                                                               max_mel_tokens=320)),
        ]
        def slots():
            sess = engine.slot_session(n_slots=4, chunk_steps=25, max_mel_tokens=60)
            rids = [sess.submit(PROMPT, t) for t in ("HELLO WORLD.", "GOOD DAY.", "THIS IS A TEST.", "HI.",
                                                      "HELLO AGAIN.", "ONE MORE.", "A B C.", "THE END.")]
            done = sess.drain()
            return [done[r][1].shape[0] for r in rids]

        def bf16_routes(suffix: str) -> list:
            out = [graph_vs_eager(engine, rec, name + suffix, fn, card) for name, fn in requests]
            engine.fast_latents = True
            try:
                out.append(graph_vs_eager(engine, rec, "fast_latents_sampled_nb1" + suffix,
                                          lambda: engine.infer(num_beams=1, **short), card))
                out.append(graph_vs_eager(engine, rec, "fast_latents_default_nb3" + suffix,
                                          lambda: engine.infer(**short), card))
                out.append(graph_vs_eager(engine, rec, "fast_latents_infer_stream" + suffix, lambda: [
                    c.size for c in engine.infer_stream(audio_prompt=PROMPT, text="HELLO WORLD.", max_mel_tokens=100)],
                                          card))
                out.append(graph_vs_eager(engine, rec, "slot_session_4x8" + suffix, slots, card))
            finally:
                engine.fast_latents = False
            return out

        rows += bf16_routes("")
        if rows[4]["segments"] != 2:
            raise AssertionError(f"the 320-code request ran {rows[4]['segments']} segments, want 2")
        # the same routes with the stop code's bias raised: rows stop at scattered steps, mid-block
        stop_raise, stop_base = raise_stop_bias(engine, card)
        try:
            stopped = bf16_routes("+stop")
        finally:
            with torch.no_grad():
                engine.gpt.mel_head.bias[engine.cfg.gpt.stop_mel_token] = stop_base
        mid_block = [r["request"] for r in stopped if any((n - 1) % BLOCK and n < 60 for n in r["row_lengths"])]
        if not mid_block:
            raise AssertionError("no route stopped a row mid-block with the stop bias raised")
        log(f"[graphs] with the stop bias raised by {stop_raise}, rows stopped mid-block in {mid_block} [{card}]")
        rows += stopped

        # the latent and conditioning stages, replayed against eager
        mel = engine.extract_features(PROMPT)
        conds1 = engine._conds_for(mel)
        r = np.random.default_rng(5)
        passes = {"cond": conditioning_vs_eager(engine, card, "flagship"), "latent": {}}
        for b, n_codes in ((1, 200), (4, 100)):
            codes = r.integers(0, engine.cfg.gpt.stop_mel_token, (b, n_codes))
            text = r.integers(2, engine.cfg.gpt.number_text_tokens - 1, (b, 12))
            passes["latent"][f"b{b}_{n_codes}"] = stage_vs_eager(
                engine, f"latent pass, b={b}, {n_codes} codes", lambda: engine._gpt_latent(
                    conds1, text, codes, np.full(b, n_codes)), card)

        # the vocoder on the four routes: wav within 1 int16 unit, launches per call as eager
        g = torch.Generator(device=engine.device).manual_seed(5)
        latent = torch.randn(1, 100, engine.cfg.gpt.model_dim, device=engine.device, dtype=engine.dtype, generator=g)
        latent2 = torch.randn(1, 72, engine.cfg.gpt.model_dim, device=engine.device, dtype=engine.dtype, generator=g)
        mel = engine.extract_features(PROMPT)
        mods = kernel_modules()
        routes = {"default": {}, "wide_branch": {"INDEXTTS_WIDE_BRANCH": "1"},
                  "wide_tmajor": {"INDEXTTS_WIDE_TMAJOR": "1"}, "fused_aa": {"INDEXTTS_FUSED_AA": "1"}}
        want = {"default": {"k1": 109}, "wide_branch": {"k1": 55, "k2": 54}, "wide_tmajor": {"k1": 55, "k3": 54},
                "fused_aa": {"k1": 55, "k4": 54}}
        vocoder = {}
        for route, env in routes.items():
            os.environ.update(env)
            try:
                outs, counts, by_profiler = {}, {}, {}

                def calls():
                    for m in mods.values():
                        m.launches = 0  # this run starts here (a run the profiler missed is made again)
                    return (engine._vocode(latent, 100, mel),
                            engine._vocode_many([(latent, 100, mel), (latent2, 72, mel)]))

                for mode in ("eager", "graph", "graph_again"):
                    with engine._graphs.eager() if mode == "eager" else contextlib.nullcontext():
                        (one, many), prof = run_profiled(calls)
                    kernels = kernel_counts(prof)
                    outs[mode] = (np.clip(np.asarray(one) * 32767.0, -32767, 32767).astype(np.int16), many)
                    counts[mode] = {k: m.launches for k, m in mods.items() if m.launches}
                    by_profiler[mode] = {k: v for k, v in kernels.items() if v}
                    if mode != "eager":
                        for k, v in kernels.items():
                            graph_launches[k] += v
            finally:
                for k in env:
                    del os.environ[k]
            err = 0
            for mode in ("graph", "graph_again"):
                pairs = [(outs[mode][0], outs["eager"][0])] + list(zip(outs[mode][1], outs["eager"][1]))
                for a, b in pairs:
                    if a.shape != b.shape:
                        raise AssertionError(f"vocoder {route}: {mode} wav {a.shape}, eager {b.shape}")
                    err = max(err, int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
                if counts[mode] != counts["eager"] or by_profiler[mode] != counts["eager"]:
                    raise AssertionError(f"vocoder {route}: launches {counts[mode]} (profiler {by_profiler[mode]}) under "
                                         f"{mode}, eager {counts['eager']}")
            if by_profiler["eager"] != counts["eager"]:
                raise AssertionError(f"vocoder {route}: the profiler counted {by_profiler['eager']} eager, the wrappers "
                                     f"{counts['eager']}")
            if err > 1:
                raise AssertionError(f"vocoder {route}: graph and eager wav differ by {err} int16 units (gate 1)")
            per_call = {k: v // 2 for k, v in counts["eager"].items()}  # one _vocode and one _vocode_many call of 2 rows
            if per_call != want[route] or any(v % 2 for v in counts["eager"].values()):
                raise AssertionError(f"vocoder {route}: {counts['eager']} launches over 2 calls, want {want[route]} a call")
            vocoder[route] = {"max_int16_diff": err, "launches": counts["graph"], "kernels_profiled": by_profiler}
            log(f"[graphs] vocoder {route}: graph vs eager within {err} int16 unit(s); K1-K8 kernels {by_profiler['graph']} "
                f"for one 100-code call and one batch of 2 by the profiler, as the wrappers launched eager [{card}]")

        # host vs device per step, eager beside replayed
        cfg, dev = engine.cfg.gpt, engine.device
        r = np.random.default_rng(7)
        lens4 = np.asarray([12, 9, 16, 5])
        text4 = np.full((4, 16), cfg.stop_text_token, np.int64)
        for i, n in enumerate(lens4):
            text4[i, :n] = r.integers(0, cfg.number_text_tokens - 1, n)
        text4_t, lens4_t = torch.from_numpy(text4).to(dev), torch.from_numpy(lens4).to(dev)
        graphs = engine._graphs
        steps = 32
        prepare_b4 = lambda quant_kv: b4_decode(engine, conds1, steps, quant_kv)

        def prepare_beams():
            gen = tdec.GenerationConfig(do_sample=True, num_beams=3, top_k=30, max_new_tokens=200)
            # cache slots: p = 32 latents + 16 text + 3, and 200 generated
            with torch.no_grad():
                loop = tdec._BeamLoop(engine.gpt, cfg, gen, conds1, text4_t[:1], lens4_t[:1],
                                      torch.Generator(device=dev).manual_seed(0), 1.0, 0.8, 10.0, 0.0, 0.9, False,
                                      False, 2, 200)

            def go(n=steps):
                i0 = loop.i
                with torch.no_grad():
                    loop.run(n, graphs.decode)
                return loop.i - i0
            return go

        def prepare_slots():
            gen = tdec.GenerationConfig(do_sample=True, num_beams=1, top_k=30, max_new_tokens=100)
            g = torch.Generator(device=dev).manual_seed(0)
            st = tslots.slot_state_init(cfg, gen, 4, 256, engine.dtype, device=dev, capture_latents=True)
            for slot in range(4):
                prod = tslots.slot_prefill(engine.gpt, cfg, gen, conds1.to(engine.dtype), text4_t[slot : slot + 1],
                                           lens4_t[slot : slot + 1], g, capture_latents=True)
                tslots.slot_admit(st, prod, slot, cfg)
            col = lambda v: torch.full((4,), v, device=dev)
            knobs = dict(temperature=col(1.0), top_p=col(0.8), repetition_penalty=col(10.0), typical_mass=col(0.9))

            def go(n=16):
                t0 = int(st.tick)
                tslots.slot_steps(engine.gpt, cfg, gen, st, n, g, pos_off=1, graphs=graphs.slot, **knobs)
                return int(st.tick) - t0
            return go

        mel_ref, lens = engine._mel_ref_for(mel, 1)

        def prepare_vocoder():
            def go(n=1):
                with torch.no_grad():
                    for _ in range(n):
                        engine._vocoder_call(latent, mel_ref, lens)
                return n
            return go

        # K6: one launch a layer in every decode step; K8: 2 a layer and ln_f's
        k6_step = {"k6": cfg.layers, "k8": k8_per_pass(cfg)}
        timing = {"b4_bf16": step_profile(engine, prepare_b4(False), card, "decode step, B=4, bf16 cache", k6_step),
                  "slot_chunk_4_rows": step_profile(engine, prepare_slots, card, "slot step, 4 sampled rows, 256 slots",
                                                    k6_step),
                  "beams_b1x3": step_profile(engine, prepare_beams, card, "beam step, B=1 x 3 beams, 251 slots",
                                             k6_step),
                  "vocoder_100_codes": step_profile(engine, prepare_vocoder, card,
                                                    "vocoder call, 100 codes, default route (per call)", {"k1": 109})}

        # int8: the int8 KV cache and int8 weights (K5 at every decode matmul)
        engine.quant_kv = True
        quantize_unified_voice(engine.gpt)
        int8_routes = (("int8_greedy_nb1", lambda: engine.infer(do_sample=False, num_beams=1, **short)),
                       ("int8_default_nb3", lambda: engine.infer(**short)))
        for name, fn in int8_routes:
            row = graph_vs_eager(engine, rec, name, fn, card)
            if row["launches"]["k5"] < 97:
                raise AssertionError(f"{name}: K5 launched {row['launches']['k5']} times")
            rows.append(row)
        # the latent pass on int8 weights: a new key (the weights moved), and K5 nowhere (a 3-D input dequantizes)
        k5_before = qmatmul.launches
        passes["latent"]["int8_b1_100"] = stage_vs_eager(
            engine, "latent pass on int8 weights, b=1, 100 codes", lambda: engine._gpt_latent(
                conds1, text[:1], codes[:1], np.full(1, 100)), card)
        if qmatmul.launches != k5_before:
            raise AssertionError(f"the latent pass launched K5 {qmatmul.launches - k5_before} times")
        # raised until the greedy route stops mid-block: a raise found on a sampled request can stop it at its first
        # code, before any decode step (and K5 at none)
        stop_raise8, stop_base8 = raise_stop_bias(engine, card, sample=False)
        try:
            for name, fn in int8_routes:
                row = graph_vs_eager(engine, rec, name + "+stop", fn, card)
                if row["launches"]["k5"] < 97:
                    raise AssertionError(f"{name}+stop: K5 launched {row['launches']['k5']} times")
                rows.append(row)
        finally:
            with torch.no_grad():
                engine.gpt.mel_head.bias[cfg.stop_mel_token] = stop_base8
        timing["b4_int8_kv_k5"] = step_profile(engine, prepare_b4(True), card, "decode step, B=4, int8 KV + K5",
                                               {"k5": 97, **k6_step})
        # K6 once a layer in every decode step of every route, eager as replayed (graph_vs_eager holds them equal);
        # a slot session's steps are not in last_stats, so its rows need K6 only to have run
        def k6_wrong(r):
            steps = r["gpt_steps"]
            return r["launches"]["k6"] != cfg.layers * steps if steps is not None else not r["launches"]["k6"]

        k6_off = [(r["request"], r["launches"]["k6"], r["gpt_steps"]) for r in rows if k6_wrong(r)]
        if k6_off:
            raise AssertionError(f"K6 launches (request, launches, decode steps) off {cfg.layers} a step: {k6_off}")
        log(f"[graphs] K6 launches = {cfg.layers} x decode steps in every route, eager and replayed: "
            f"{sum(r['launches']['k6'] for r in rows)} over {len(rows)} requests [{card}]")
    finally:
        rec.close()
        engine.quant_kv = False
    stats = engine._graphs.stats()
    resident = {}
    for stage_name, lanes in stats.items():
        captured = [lane for lane in lanes if lane["captured"]]
        buffers = sum(lane["buffer_bytes"] for lane in lanes)
        pool = sum(lane["pool_bytes"] for lane in lanes)
        resident[stage_name] = {"lanes": len(lanes), "live": sum(lane["live"] for lane in lanes),
                                "buffer_bytes": buffers, "pool_bytes": pool,
                                "largest_lane_bytes": max((lane["buffer_bytes"] + lane["pool_bytes"] for lane in lanes),
                                                          default=0)}
        log(f"[graphs] stage {stage_name}: {len(captured)} captured keys, capture "
            f"{sum(lane['capture_s'] for lane in captured):.2f} s in all (the most "
            f"{max((lane['capture_s'] for lane in captured), default=0.0):.3f} s); {len(lanes)} lanes kept "
            f"({resident[stage_name]['live']} live) hold {buffers / 1e6:.1f} MB of buffers and {pool / 1e6:.1f} MB of "
            f"pool growth, the largest lane {resident[stage_name]['largest_lane_bytes'] / 1e6:.1f} MB; the stage keeps "
            f"free lanes within {engine._graphs.keep_bytes / 1e9:.2f} GB [{card}]")
        if stage_name in ("dec", "slot"):
            log(f"[graphs] stage {stage_name}, each captured block key ({BLOCK} conditional steps): capture s and pool MB "
                f"{[(round(lane['capture_s'], 3), round(lane['pool_bytes'] / 1e6, 1)) for lane in captured]} [{card}]")
    for t in timing.values():
        for k, v in t["graph"]["k_kernels"].items():
            graph_launches[k] += v
    return {"init_s": init_s, "warmup_s": warm, "requests": rows, "vocoder": vocoder, "timing": timing,
            "graph_stats": stats, "resident": resident, "keep_bytes": engine._graphs.keep_bytes,
            "launches": graph_launches, "if_nodes": ifnode, "passes": passes, "block": BLOCK,
            "stop_raise": [stop_raise, stop_raise8]}


def load_config(path: str):
    from indextts_tpu_torch.config import load_config as load

    return load(path)


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


PHASES = ("kernel", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "hybrid", "engine", "beam", "stream", "serve", "int8", "small",
          "ckpt", "legacy", "fidelity", "mesh", "meshgraphs", "graphs")


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
    from indextts_tpu_torch.ops.cuda import graph_block
    from indextts_tpu_torch.ops.cuda import decode_attn as k6
    from indextts_tpu_torch.ops.cuda import gpt2_chains as k8
    from indextts_tpu_torch.ops.cuda import qmatmul as k5
    from indextts_tpu_torch.ops.cuda import ssm_step as k7

    # one nvcc per source, started together (K1-K8, and the decode block's
    # predicate kernel and graph assembly, which every CUDA engine's loops use)
    t = time.perf_counter()
    kernels_built = (k1, k2, k3, k4, k5, k6, k7, k8, graph_block)
    with ThreadPoolExecutor(max_workers=len(kernels_built)) as pool:
        for future in [pool.submit(k._library) for k in kernels_built]:
            future.result()
    log(f"[build] {', '.join(k.SOURCE for k in kernels_built)} built and loaded in {time.perf_counter() - t:.2f} s "
        f"(nvcc {', '.join(f'{build.build_seconds[k.SOURCE]:.2f}' for k in kernels_built)} s, in parallel)")
    for src in (k.SOURCE for k in kernels_built):
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {src}:", line.strip())

    phase_fns = {"kernel": kernel_phase, "k2": k2_phase, "k3": k3_phase, "k4": k4_phase, "k5": k5_phase, "k6": k6_phase,
                 "k7": k7_phase, "k8": k8_phase, "hybrid": lambda c: phase_in_child("hybrid", c),
                 "engine": engine_phase, "beam": beam_phase, "stream": stream_phase, "serve": serve_phase,
                 "int8": int8_phase, "small": small_phase, "ckpt": ckpt_phase, "legacy": legacy_phase,
                 "fidelity": fidelity_phase, "mesh": mesh_phase, "meshgraphs": mesh_graphs_phase, "graphs": lambda c: phase_in_child("graphs", c)}
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
    kern6 = k6_phase(card)
    kern7 = k7_phase(card)
    kern8 = k8_phase(card)
    hybrid = phase_in_child("hybrid", card)
    eng = engine_phase(card)
    beam = beam_phase(card)
    stream = stream_phase(card)
    serve = serve_phase(card)
    int8 = int8_phase(card)
    small = small_phase(card)
    ckpt = ckpt_phase(card)
    legacy = legacy_phase(card)
    fidelity = fidelity_phase(card)
    mesh = mesh_phase(card)
    graphs = phase_in_child("graphs", card)

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
    # the same step on one rank's int8 shards at tp = 2 (the mesh phase's shapes)
    shard = {label: (k, n) for label, n, k in mesh["k5_shard_shapes"]}
    tp2_shapes = [shard[c] for c in ("qkv", "proj", "fc", "mlp_proj")] * layers + [shard["head"]]
    k5_tp2_terms = {"bytes": sum(n * k + 2 * m * k + 2 * m * n + 6 * n for k, n in tp2_shapes) / PEAK_BYTES,
                    "operations": sum(2 * m * k * n for k, n in tp2_shapes) / PEAK_BF16}
    k5_tp2_by = max(k5_tp2_terms, key=k5_tp2_terms.get)

    k7_rows = {r["B"]: r for r in kern7["rows"] if r["kernel"] == "k7"}

    def k7_step(b: int, key: str, fallback: str) -> float:
        """K7's (or the plain version's, or the bound's) ms a decode step of
        the hybrid decoder's Mamba layers at b rows: profiler device time
        where it saw the kernels, else CUDA-event time."""
        r = k7_rows[b]
        return GRANITE["layers"] * (r[key] if r[key] is not None else r[fallback])

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
        "k6": kern6,
        "k7": kern7,
        "k8": kern8,
        "hybrid": hybrid,
        "engine": eng,
        "beam": beam,
        "stream": stream,
        "serve": serve,
        "int8": int8,
        "small": small,
        "ckpt": ckpt,
        "legacy": legacy,
        "fidelity": fidelity,
        "mesh": mesh,
        "graphs": graphs,
    }
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    # library_ms: no single PyTorch call computes any of these functions (the
    # activation is a transposed conv, a snake and a strided conv; K2 adds a
    # conv; K5's plain version dequantizes, then calls F.linear)
    kernels = [{
        "name": "fused_anti_alias_snake", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": ckpt["k1_launches"], "launches_engine_phase": eng["k1_launches"],
        "launches_legacy_phase": legacy["k1_launches"], "launches_fidelity_phase": fidelity["k1_launches"],
        "launches_mesh_phase_per_rank": mesh["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kern["rows"]),
        "ms": k1_per_voc["k1"], "plain_ms": k1_per_voc["plain"],
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None, "call_ms": k1_per_voc["call"],
        "launches_graphs_phase": graphs["launches"]["k1"],
    }, {
        "name": "aa_snake_dconv", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": beam["k2_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern2["rows"]),
        "ms": per_voc("device_ms", "ms"), "plain_ms": per_voc("device_plain_ms", "plain_ms"),
        "bound_ms": 1e3 * k2_terms[k2_by], "bound_by": k2_by, "library_ms": None,
        "call_ms": per_voc("device_ms", "ms"),  # the wrapper launches nothing but the kernel: ms is the whole call
        "launches_graphs_phase": graphs["launches"]["k2"],
    }, {
        "name": "fused_anti_alias_snake_tmajor", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
        "launches": stream["k3_launches"],
        "max_abs_err": max(b["max_abs_err"] for r in kern3["rows"] for b in r["bodies"].values()),
        "ms": k3_per_voc["taps"], "plain_ms": k3_per_voc["plain"],
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None, "call_ms": k3_per_voc["taps_call"],
        # the other bodies' own ms and bounds, beside K1's own ms at the same shapes
        "bodies_ms": {"mma": k3_per_voc["mma"], "ident": k3_per_voc["ident"], "k1": k3_per_voc["k1"]},
        "bodies_bound_ms": {body: ms for body, (ms, _) in k3_per_voc["bound"].items()},
        "launches_graphs_phase": graphs["launches"]["k3"],
    }, {
        "name": "fused_folded_aa", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": serve["k4_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern4["rows"]),
        "ms": k4_per_voc["k4"], "plain_ms": k4_per_voc["plain"],
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "call_ms": k4_per_voc["call"],
        "launches_graphs_phase": graphs["launches"]["k4"],
    }, {
        "name": "int8_matmul", "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
        "launches": int8["k5_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern5["rows"]),
        "ms": per_step("device_ms", "ms"), "plain_ms": per_step("device_plain_ms", "plain_ms"),
        "bound_ms": 1e3 * k5_terms[k5_by], "bound_by": k5_by, "library_ms": None,
        "call_ms": per_step("device_ms", "ms"),  # the wrapper launches nothing but the kernel at bf16
        "bf16_linear_ms": k5_per_step[4]["bf16_linear_ms"],  # another function (bf16 weights): a yardstick only
        "launches_graphs_phase": graphs["launches"]["k5"],
        # one rank's int8 shards at tp = 2, per decode step at M = 4: launches, own device ms (profiler, in the
        # forced steps), the bound of the shards' bytes / operations, and one process's own ms beside them
        "mesh_tp2": {"launches_per_step_per_rank": mesh["k5_launches_per_step_per_rank"],
                     "ms": mesh["k5_own_ms_per_step"], "one_process_ms": mesh["k5_own_ms_per_step_one_process"],
                     "bound_ms": 1e3 * k5_tp2_terms[k5_tp2_by], "bound_by": k5_tp2_by,
                     "max_abs_err": mesh["k5_max_abs_err"], "shapes_N_K": mesh["k5_shard_shapes"]},
    }, {
        # per decode step (one launch a layer) of the batch loop's 8 rows; the beams' and the slots' rows beside it
        "name": "decode_attn", "route": "cuda", "source": K6_SOURCE, "replaces": K6_REPLACES,
        "launches": eng["k6_launches"], "launches_beam_phase": beam["k6_launches"],
        "launches_serve_phase": serve["k6_launches"], "launches_int8_phase": int8["k6_launches"],
        "launches_graphs_phase": graphs["launches"]["k6"],
        "max_abs_err": max(r["max_abs_err_f64"] for r in kern6["rows"]),
        "ms": kern6["rows"][0]["per_step_ms"], "plain_ms": kern6["rows"][0]["plain_per_step_ms"],
        "bound_ms": layers * kern6["rows"][0]["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "call_ms": kern6["rows"][0]["per_step_ms"],  # the wrapper launches nothing but the kernel
        "cases": {r["case"]: {"ms": r["per_step_ms"], "plain_ms": r["plain_per_step_ms"],
                              "bound_ms": layers * r["bound_ms"]} for r in kern6["rows"]},
        # the hybrid decoder's 4 attention layers: K6's grouped-query instance
        "launches_hybrid_phase": hybrid["k6_launches"],
    }, {
        # per decode step (one launch a Mamba layer) of the hybrid decoder at 32 slot rows; 3 and 8 rows beside it
        "name": "ssm_step", "route": "cuda", "source": K7_SOURCE, "replaces": K7_REPLACES,
        "launches": hybrid["k7_launches"], "launches_hybrid_phase_by_profiler": {
            mode: v["k_kernels"]["k7"] for mode, v in hybrid["step"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in k7_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in k7_rows.values()),
        "ms": k7_step(32, "device_ms", "ms"), "plain_ms": k7_step(32, "device_plain_ms", "plain_ms"),
        "bound_ms": k7_step(32, "bound_ms", "bound_ms"), "bound_by": "bytes", "library_ms": None,
        "call_ms": k7_step(32, "device_ms", "ms"),  # the wrapper launches nothing but the kernel
        "cases": {f"B{b}": {"ms": k7_step(b, "device_ms", "ms"), "plain_ms": k7_step(b, "device_plain_ms", "plain_ms"),
                            "bound_ms": k7_step(b, "bound_ms", "bound_ms")} for b in k7_rows},
    }, {
        # per decode step (2 x layers + 1 add_layer_norm) of the batch loop's 8 rows; the beams', the slots' and a
        # prefill's rows beside it; the step's gelu_new (PyTorch's, layers launches) beside K8
        "name": "gpt2_chains", "route": "cuda", "source": K8_SOURCE, "replaces": K8_REPLACES,
        "launches": eng["k8_launches"], "launches_beam_phase": beam["k8_launches"],
        "launches_serve_phase": serve["k8_launches"], "launches_int8_phase": int8["k8_launches"],
        "launches_graphs_phase": graphs["launches"]["k8"],
        "max_abs_err": max(r["add_layer_norm"]["max_abs_err_f64"] for r in kern8["rows"]),
        "ms": kern8["rows"][0]["per_step_ms"], "plain_ms": kern8["rows"][0]["plain_per_step_ms"],
        "bound_ms": kern8["rows"][0]["bound_per_step_ms"], "bound_by": "bytes",
        "library_ms": kern8["rows"][0]["library_per_step_ms"],
        "call_ms": kern8["rows"][0]["per_step_ms"],  # the wrapper launches nothing but the kernel
        "cases": {r["case"]: {"ms": r["per_step_ms"], "plain_ms": r["plain_per_step_ms"],
                              "library_ms": r["library_per_step_ms"], "bound_ms": r["bound_per_step_ms"],
                              "gelu_new_ms": r["gelu_per_step_ms"], "gelu_new_plain_ms": r["gelu_plain_per_step_ms"]}
                  for r in kern8["rows"]},
    }]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
