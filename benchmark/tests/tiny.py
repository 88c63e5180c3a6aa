"""A tiny copy of the benchmark for the CPU tests: the harness's files as
they are, with a BENCHMARK.json of tiny cells (a 2-layer GPT and a 2-stage
vocoder, the same mixes cut to a few codes a row)."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

GPT = dict(layers=2, model_dim=128, heads=4, max_text_tokens=120, max_mel_tokens=100, number_text_tokens=40,
           start_text_token=0, stop_text_token=1, number_mel_codes=258, start_mel_token=256, stop_mel_token=257,
           mel_length_compression=1024, condition_type="conformer_perceiver", condition_num_latent=8,
           condition_module=dict(output_size=64, linear_units=128, attention_heads=2, num_blocks=2,
                                 input_layer="conv2d2", perceiver_mult=2))
VOC = dict(gpt_dim=128, upsample_initial_channel=64, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
           resblock="1", resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
           activation="snakebeta", snake_logscale=True, feat_upsample=True,
           cond_d_vector_in_each_upsampling_layer=True, num_mels=100, speaker_embedding_dim=64, sampling_rate=24000)

LIMITS = {"rows_missing": 0, "len_mismatch": 0, "logit_gap": 1e-3, "wav_rel_err": 1e-3}


def _tiny_mix(mix: dict) -> dict:
    m = copy.deepcopy(mix)
    m["sentences"]["tokens"] = [16, 40]
    m["prompts"]["frames"] = [101, 180]
    m["judge"]["requests"] = 8
    m["trace"] = {"after_s": 0.0, "seconds": 0.5}
    if m["entry"] == "slots":
        m["session"] = {"n_slots": 4, "chunk_steps": 8, "stream_overlap_codes": 4, "max_text_tokens_per_sentence": 48}
        m["generation"]["max_mel_tokens"] = 20
        m["rate_per_s"] = 2.0
        m["tail_s"] = 1.0
        m["prompts"]["pool"] = 2
        m["greedy_every"] = 2
    elif m["entry"] == "batch":
        m["call"] = {"requests": 3, "compositions": 2, "sentences_bucket_max_size": 4,
                     "max_text_tokens_per_sentence": 48}
        m["generation"]["max_mel_tokens"] = 24
        m["prompts"]["pool"] = 2
        m["greedy_every"] = 2
    else:
        m["max_text_tokens_per_sentence"] = 48
        m["generation"]["max_mel_tokens"] = 24
        m["requests"] = 4
    return m


def make_root(tmp: str) -> str:
    """A checkout-like directory: benchmark/ copied, and BENCHMARK.json,
    configurations, mixes and limits for tiny cells of each entry driver."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(os.path.dirname(BENCH), c["file"])) as f:
            cfg = json.load(f)
        cfg["gpt"], cfg["bigvgan"] = GPT, VOC
        cfg["engine"]["dtype"] = "float32"
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in spec["workloads"]:
        path = os.path.join(root, "benchmark", "workloads", w["traffic"] + ".json")
        with open(path) as f:
            mix = json.load(f)
        with open(path, "w") as f:
            json.dump(_tiny_mix(mix), f)
        with open(os.path.join(root, "benchmark", "limits", w["name"] + ".json"), "w") as f:
            json.dump(LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
