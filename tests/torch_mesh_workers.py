"""The ranks of the spawned torch.distributed groups of
tests/test_torch_mesh_engine.py, and the helpers both sides share. Torch
only: a spawned child imports this module, and no jax.

Each group is gloo over CPU processes, one torch thread each. A rank runs its
checks on a mesh engine built from the test's checkpoint directory (the JAX
engine's weights as .npz caches) and writes what it got to
out_dir/rank<r>.pkl, or the traceback when a check raised; the test holds
the results against the one-process engine and the JAX engine.
"""

from __future__ import annotations

import gc
import io
import itertools
import os
import pickle
import time
import traceback
import uuid
import wave

import numpy as np
import torch
import torch.distributed as dist

from indextts_tpu_torch.engine import IndexTTS
from indextts_tpu_torch.models.gpt_decode import GenerationConfig, _decode_step, _prefill, prepare_gpt_inputs

GREEDY = GenerationConfig(do_sample=False, num_beams=1, max_new_tokens=10)
SAMPLED = GenerationConfig(do_sample=True, num_beams=1, top_k=30, max_new_tokens=10)
BEAMS = GenerationConfig(do_sample=False, num_beams=2, max_new_tokens=8)
KNOBS = dict(temperature=1.0, top_p=0.8, repetition_penalty=1.0)
SAMPLED_KNOBS = dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0)
SOLO = dict(do_sample=False, num_beams=1, max_mel_tokens=10, repetition_penalty=1.0)
LR = 1e-4


def engine(spec, mesh: bool, tp=None, **kw) -> IndexTTS:
    """An engine on the test's tiny float32 weights: a rank of the mesh, or
    one process."""
    return IndexTTS(cfg_path=spec["cfg"], model_dir=spec["dir"], is_fp16=False, device="cpu",
                    allow_random_init=True, use_mesh=mesh, tp=tp, **kw)


def decode(e: IndexTTS, spec, rows: str, gen: GenerationConfig, knobs=KNOBS, seed=None):
    """(codes, lengths) of _gpt_generate on the spec's text rows."""
    if seed is not None:
        e._generator.manual_seed(seed)
    codes, lens, _, _ = e._gpt_generate(e._conds_for(spec["mel"]), spec["tokens" + rows], spec["lens" + rows], gen,
                                        **knobs)
    return np.asarray(codes), np.asarray(lens)


@torch.no_grad()
def forced_logits(e: IndexTTS, spec) -> np.ndarray:
    """Prefill and forced decode steps on the spec's 4 text rows: the logits
    [steps + 1, 4, V] (decode steps through K5 on int8 weights)."""
    cfg = e.cfg.gpt
    forced = torch.from_numpy(spec["forced"])
    conds = e._conds_for(spec["mel"]).expand(4, -1, -1)
    emb, mask = prepare_gpt_inputs(e.gpt, cfg, conds, torch.from_numpy(spec["tokens4"]),
                                   torch.from_numpy(spec["lens4"]))
    p, steps = emb.shape[1], forced.shape[1]
    logits, cache = _prefill(e.gpt, cfg, emb, mask, p + steps)
    outs = [logits]
    valid0 = torch.nn.functional.pad(mask, (0, steps))
    pos = torch.arange(p + steps)[None, :]
    for i in range(steps):
        valid = valid0 | ((pos >= p) & (pos < p + i))
        outs.append(_decode_step(e.gpt, cfg, forced[:, i], i + 2, cache, p + i, valid))
    return torch.stack(outs).numpy()


def vocoder_inputs(e: IndexTTS, spec):
    """The spec's 4 vocoder rows as _vocode_rows takes them."""
    v = spec["vocoder"]
    return (torch.from_numpy(v["latent"]), torch.from_numpy(v["mel_ref"]), torch.from_numpy(v["rel"]))


def vocoder_chunks(spec):
    """Three chunks for _vocode_many (one batch of 3, padded to 4)."""
    v = spec["vocoder"]
    return [(torch.from_numpy(v["latent"][i : i + 1, : 16 + 8 * i]), 10 + 4 * i, spec["mel"]) for i in range(3)]


def train_step(model, cfg, batch, mesh=None):
    """One step as __graft_entry__.dryrun_multichip takes it for JAX: text +
    mel cross-entropy means, their gradient, and SGD at LR. On a mesh each
    data group takes its rows; the global means are its sums over the
    all-reduced token counts, and the gradients are summed over the data
    group. Returns the loss."""
    from indextts_tpu_torch.models.gpt import unified_voice_forward
    from indextts_tpu_torch.parallel.mesh import reduce_data_gradients

    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        start, stop = mesh.rows(t["mel"].shape[0])
        t = {k: v[start:stop] for k, v in t.items()}
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss_text, loss_mel, _ = unified_voice_forward(model, cfg, t["mel"], t["text"], t["text_lens"], t["codes"],
                                                       t["wav_lens"], t["mel_lens"], return_latent=False)
        rows = t["text"].shape[0]
        counts = torch.tensor([rows * (t["text"].shape[1] + 2), rows * (t["codes"].shape[1] + 2)], dtype=torch.float64)
        local = counts.clone()
        if mesh is not None:
            mesh.data.all_reduce(counts)
        loss = loss_text * float(local[0] / counts[0]) + loss_mel * float(local[1] / counts[1])
        loss.backward()
    if mesh is not None:
        reduce_data_gradients(model, mesh)
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= LR * p.grad
    total = loss.detach().clone()
    if mesh is not None:
        mesh.data.all_reduce(total)
    return float(total)


def train_model(spec):
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.convert import load_params_npz
    from indextts_tpu_torch.models.gpt import UnifiedVoice
    from indextts_tpu_torch.weights import load_jax_params

    cfg = load_config(spec["cfg"]).gpt
    model = UnifiedVoice(cfg)
    load_jax_params(model, load_params_npz(os.path.join(spec["dir"], "gpt.pth.npz")))
    return model, cfg


# ---------------------------------------------------------------------------
# the groups
# ---------------------------------------------------------------------------


def run(rank: int, world: int, port: int, kind: str, spec, out_dir: str, groups=None) -> None:
    """One rank of a spawned group: init gloo, run `kind`'s checks (a
    function of `groups`, by default this module's), write rank<r>.pkl
    ({"ok": ..., results} or the traceback), and raise again on failure so
    the parent sees a non-zero exit."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    out = {"ok": False}
    try:
        groups = groups or {"tp": tp_group, "dp": dp_group, "server": server_group}
        out.update(groups[kind](rank, spec, out_dir))
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        gc.collect()  # the engines (a stage and its Graphs hold each other) and their groups go first
        dist.destroy_process_group()


def tp_group(rank, spec, out_dir):
    """tp = 2 on 2 ranks: greedy codes, sampled codes (equal across the
    ranks), slot mode against the engine's solo infer, int8 weights (both
    orders of quantize and shard give the same bytes; forced logits), and a
    request that differs on one rank."""
    from indextts_tpu_torch.ops.quant import QuantLinear, quantize_unified_voice
    from indextts_tpu_torch.parallel.mesh import local_heads, shard_gpt_params

    e = engine(spec, True, tp=2)
    out = {"shape": e.mesh.shape, "coords": e.mesh.coords, "heads": local_heads(e.gpt),
           "mel_head_rows": e.gpt.mel_head.weight.shape[0], "text_head_rows": e.gpt.text_head.weight.shape[0]}
    out["greedy4"] = decode(e, spec, "4", GREEDY)
    out["sampled4"] = decode(e, spec, "4", SAMPLED, SAMPLED_KNOBS, seed=7)
    items = [(spec["mel"], "HELLO WORLD."), (spec["mel"], "GOOD DAY.")]
    out["slots"] = e.infer_slots(items, n_slots=2, **SOLO)
    out["solo"] = [e.infer(m, t, None, **SOLO) for m, t in items]

    whole, _ = train_model(spec)
    quantize_unified_voice(whole)  # the whole weights, then the shard
    shard_gpt_params(whole, e.mesh)
    quantize_unified_voice(e.gpt)  # the shard, its row-parallel scales over the whole input
    mods = [n for n, m in e.gpt.named_modules() if isinstance(m, QuantLinear)]
    sd_a, sd_b = whole.state_dict(), e.gpt.state_dict()
    out["int8_modules"] = len(mods)
    out["int8_orders_equal"] = all(torch.equal(sd_a[k], sd_b[k]) for k in sd_b)
    out["int8_shapes"] = {k: tuple(v.shape) for k, v in sd_b.items() if v.dtype == torch.int8}
    out["int8_logits"] = forced_logits(e, spec)

    text = "HELLO WORLD." if rank == 0 else "GOOD DAY TO YOU."
    t = time.perf_counter()
    try:
        e.infer(spec["mel"], text, None, **SOLO)
        out["disagree"] = None
    except RuntimeError as err:
        out["disagree"] = str(err)
    out["disagree_s"] = time.perf_counter() - t
    return out


def dp_group(rank, spec, out_dir):
    """dp = 2 x tp = 2 on 4 ranks: greedy codes of 4 rows and of 5 (padded
    to 6), the int8-KV beam decode, sampled codes from a seed with the
    generator state after them, the vocoder's rows and _vocode_many, and one
    TP + DP training step."""
    from indextts_tpu_torch.parallel.mesh import gathered_state_dict, shard_gpt_params

    e = engine(spec, True, tp=2)
    out = {"shape": e.mesh.shape, "coords": e.mesh.coords}
    out["greedy4"] = decode(e, spec, "4", GREEDY)
    out["greedy5"] = decode(e, spec, "5", GREEDY)
    out["sampled4"] = decode(e, spec, "4", SAMPLED, SAMPLED_KNOBS, seed=7)
    out["generator_state"] = e._generator.get_state().numpy()
    with torch.no_grad():
        out["vocode_rows"] = e._vocode_rows(*vocoder_inputs(e, spec), split=True).numpy()
        out["vocode_many"] = e._vocode_many(vocoder_chunks(spec))
    e.quant_kv = True  # 2 heads a rank: the head pairs of the int8 cache stay whole
    out["beams_int8_kv"] = decode(e, spec, "4", BEAMS)

    model, cfg = train_model(spec)
    shard_gpt_params(model, e.mesh)
    out["train_loss"] = train_step(model, cfg, spec["train"], e.mesh)
    out["train_params"] = {k: v.numpy() for k, v in gathered_state_dict(model, e.mesh).items()}
    return out


def server_group(rank, spec, out_dir):
    """The web server on tp = 2: rank 0 serves one /api/synthesize request
    through an EngineProxy (in process, no socket), then takes one chunk of
    a stream and closes it; rank 1 follows until rank 0 stops."""
    from indextts_tpu_torch.server.mesh_proxy import EngineProxy, follow
    from indextts_tpu_torch.server.webui import create_app

    e = engine(spec, True, tp=2)
    if rank != 0:
        follow(e)
        return {"followed": True}
    proxy = EngineProxy(e)
    app = create_app(proxy, base_dir=os.path.join(out_dir, "www"))
    try:
        out = {"wav": synthesize(app, os.path.join(out_dir, "www"), spec["prompt_wav"])}
        stream = proxy.infer_stream(spec["mel"], "HELLO WORLD. GOOD DAY.", first_chunk_codes=4, chunk_codes=4,
                                    do_sample=False, max_mel_tokens=10, repetition_penalty=1.0)
        out["first_chunk"] = next(stream)
        stream.close()
        out["after_stream"] = proxy.infer(spec["mel"], "GOOD DAY.", None, **SOLO)
    finally:
        app.shutdown()
        proxy.stop()
    return out


# ---------------------------------------------------------------------------
# an in-process client of the web app
# ---------------------------------------------------------------------------


def _call(app, method: str, path: str, body: bytes = b"", ctype=None):
    env = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
           "wsgi.input": io.BytesIO(body)}
    if ctype:
        env["CONTENT_TYPE"] = ctype
    status = {}
    data = b"".join(app(env, lambda s, h: status.setdefault("code", int(s.split()[0]))))
    return status["code"], data


def synthesize(app, base: str, prompt_wav: str, timeout: float = 120.0) -> np.ndarray:
    """POST one greedy /api/synthesize request with `prompt_wav` as the
    reference audio, wait for its task, and return the int16 wav it wrote."""
    import json

    boundary = uuid.uuid4().hex
    fields = {"text": "HELLO WORLD.", "do_sample": "false", "num_beams": "1", "max_mel_tokens": "10",
              "repetition_penalty": "1.0"}
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    with open(prompt_wav, "rb") as f:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="referenceAudioFile"; '
                     f'filename="p.wav"\r\nContent-Type: audio/wav\r\n\r\n'.encode() + f.read() + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    code, data = _call(app, "POST", "/api/synthesize", body, f"multipart/form-data; boundary={boundary}")
    if code != 200:
        raise AssertionError(f"/api/synthesize answered {code}: {data!r}")
    task = json.loads(data)["task_id"]
    deadline = time.time() + timeout
    for _ in itertools.count():
        st = dict(app._tasks_status.get(task, {}))
        if st.get("status") in ("completed", "failed") or time.time() > deadline:
            break
        time.sleep(0.05)
    if st.get("status") != "completed":
        raise AssertionError(f"task {task}: {st}")
    with wave.open(os.path.join(base, st["audio_url"].lstrip("/")), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16).copy()
