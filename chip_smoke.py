#!/usr/bin/env python3
"""Smoke run of the PyTorch port (indextts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the K1 kernel from indextts_tpu_torch/csrc/;
  3. kernel  — K1 against its plain PyTorch version at the vocoder's shapes
               for ~100 codes, B = 1 and 4, bf16 and float32, with CUDA-event
               times for both;
  4. engine  — IndexTTS.infer at the published IndexTTS-1.5 width
               (configs/indextts_1_5.yaml), random weights from a fixed seed,
               bf16: a greedy, a sampled and a two-sentence request; the K1
               launch count must be 109 per vocoder call;
  5. small   — the same engine at a tiny width in float32 on the card
               against the CPU on the same weights (greedy codes equal, wav
               within tolerance);
  6. report  — one JSON line of kernel results, the nvidia-smi line, and the
               final {"ok": true, ...} line.

It needs the repository around it and a CUDA device, and imports no JAX.
Details go to chiprun_out/chip_smoke_report.json.
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


def device_time_ms(fn, iters: int):
    """Summed device time of every kernel `fn` launches, per call, from
    torch.profiler; None when the profiler records no device time. Unlike
    CUDA events around back-to-back calls, this excludes host enqueue gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else None


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def kernel_phase(card: str) -> dict:
    import torch

    from indextts_tpu_torch.ops.cuda import antialias as k1

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
        dev_ms = device_time_ms(lambda: k1.fused_anti_alias_snake(x, alpha, beta, logscale), iters)
        dev_plain_ms = device_time_ms(lambda: k1.anti_alias_snake_plain(x, alpha, beta, logscale), iters)
        # moved bytes of the best case: read x once, write z once
        nbytes = 2 * x.numel() * x.element_size()
        gbps = nbytes / (dev_ms * 1e-3) / 1e9 if dev_ms else None
        row = dict(case=label, B=b, C=c, T=t, dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   bound=bound, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, device_plain_ms=dev_plain_ms,
                   kernel_GBps=gbps, ok=bool(err <= bound))
        rows.append(row)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
        log(f"[kernel] {label:16s} B={b} C={c:4d} T={t:6d} {row['dtype']:8s} err={err:.3e} (bound {bound:.3e}) "
            f"events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms | device: kernel {fmt(dev_ms)} ms "
            f"plain {fmt(dev_plain_ms)} ms, {fmt(gbps)} GB/s  [{card}]")
        if not row["ok"]:
            failures.append(row)
        del x, out, ref
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version: {failures}")
    return {"rows": rows}


def flagship_engine():
    from indextts_tpu_torch.engine import IndexTTS

    # configs/ holds no bpe.model: the engine builds its random-init tokenizer
    return IndexTTS(cfg_path=FLAGSHIP, model_dir=os.path.join(REPO, "configs"), is_fp16=True, device="cuda",
                    use_cuda_kernel=True, allow_random_init=True, seed=0)


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
        ms_step = 1e3 * st["gpt_gen_s"] / max(st["gpt_tokens"], 1)
        row = dict(request=name, codes=n_codes, audio_s=st["audio_s"], cond_ms=1e3 * st["cond_s"],
                   decode_ms_per_step=ms_step, decode_tokens=st["gpt_tokens"], latent_ms=1e3 * st["gpt_forward_s"],
                   vocoder_ms=1e3 * st["bigvgan_s"], total_s=st["total_s"], rtf=st["rtf"])
        results.append(row)
        log(f"[engine] {name}: {n_codes} codes, {st['audio_s']:.2f} s audio | cond {row['cond_ms']:.1f} ms, "
            f"decode {ms_step:.2f} ms/step over {st['gpt_tokens']} tokens (prefill included), "
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
    return {"init_s": init_s, "cold_first_request_s": cold_s, "requests": results, "k1_launches": launches, "vocoder_calls": vocoder_calls,
            "vocoder_ab": ab}


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
    """Tiny width, float32: the card's engine against the CPU's on the same weights."""
    import tempfile

    import numpy as np
    import torch

    from indextts_tpu_torch.config import save_config
    from indextts_tpu_torch.engine import IndexTTS

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
    return {"codes_equal": same, "wav_max_abs_diff_int16": diff, "samples": int(wav_gpu.shape[0])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = device_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from indextts_tpu_torch.ops.cuda import antialias as k1
    from indextts_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    k1._library()
    log(f"[build] {k1.SOURCE} built and loaded in {time.perf_counter() - t:.2f} s "
        f"(nvcc {build.build_seconds[k1.SOURCE]:.2f} s)")
    for line in build.build_log(k1.SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())

    kern = kernel_phase(card)
    eng = engine_phase(card)
    small = small_phase(card)

    main_rows = {r["case"]: r for r in kern["rows"] if r["B"] == 1 and r["dtype"] == "bfloat16"}

    def per_call(key: str, fallback: str) -> float:
        """K1 (or plain) time of one vocoder call at ~100 codes, bf16, B=1:
        18 activations per stage plus activation_post. Device time from the
        profiler where it saw the kernels, else CUDA-event time."""
        pick = lambda r: r[key] if r[key] is not None else r[fallback]
        return sum(18 * pick(main_rows[s]) for s, _, _ in STAGES[:6]) + pick(main_rows["activation_post"])
    report = {
        "device": card,
        "kernel": kern,
        "engine": eng,
        "small": small,
    }
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    kernels = [{
        "name": "fused_anti_alias_snake", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": eng["k1_launches"], "max_abs_err": max(r["max_abs_err"] for r in kern["rows"]),
        "ms": per_call("device_ms", "ms"), "plain_ms": per_call("device_plain_ms", "plain_ms"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
