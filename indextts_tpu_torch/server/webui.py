"""Web server: SPA backend with async synthesis tasks and SSE progress.

Same REST surface as the reference Flask app (webui.py):
  GET  /                                   -> SPA (templates/index.html)
  GET  /audio/<filename>                   -> synthesized audio
  GET  /static/<path>                      -> static assets
  GET  /api/history-audios                 -> history list
  DELETE /api/delete-audio                 -> delete history item
  GET/POST /api/rulesets                   -> regex replacement rulesets
  GET/DELETE /api/rulesets/<name>
  GET  /api/saved-voices                   -> saved voice-feature list
  DELETE /api/saved-voices/<voice_id>
  POST /api/save-voice-feature             -> persist cached cond-mel as .npy
  POST /api/synthesize                     -> start async synthesis task
  GET  /api/synthesize-stream-status/<id>  -> SSE progress stream

Implementation differences vs the reference: stdlib WSGI instead of Flask
(not available here); uploads decode natively for WAV and through ffmpeg for
mp3/ogg/flac/m4a (utils/audio.decode_audio — the reference goes through
torchaudio); and the synthesis worker queue is a single worker thread guarded
by a lock — the reference spawns a raw thread per request and shares one
mutable progress callback across tasks (webui.py:224-283), a race this
implementation closes by serializing jobs.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
import traceback
import uuid
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from indextts_tpu_torch.server.wsgi import App, Request, Response, SSEResponse, StreamResponse, jsonify
from indextts_tpu_torch.utils.audio import UnsupportedAudioFormat, decode_audio, resample, write_wav
from indextts_tpu_torch.utils.mel import MelSpectrogramFeatures

# Every app whose dispatcher threads are still alive. The reference's Flask
# app leaks a raw thread per request and has no teardown at all
# (reference webui.py:224-283); here each create_app() registers itself so
# callers (tests, embedding servers) can reap ALL dispatcher threads with
# one shutdown_all() — a leaked daemon thread pins its engine and every
# compiled executable the engine holds for the life of the process.
_LIVE_APPS: "list" = []
_LIVE_APPS_LOCK = threading.Lock()


def shutdown_all(timeout: float = 2.0) -> None:
    """Stop the dispatcher threads of every live app (idempotent)."""
    with _LIVE_APPS_LOCK:
        apps, _LIVE_APPS[:] = list(_LIVE_APPS), []
    for a in apps:
        try:
            a.shutdown(timeout=timeout)
        except Exception:
            traceback.print_exc()


def apply_replacements(text: str, raw) -> str:
    """Apply the SPA's regex ruleset (JSON list of {original, replacement})
    to `text`. ONE implementation shared by /api/synthesize and the
    streaming endpoint so the semantics cannot drift; malformed JSON or a
    bad regex logs a warning and keeps the rules applied so far."""
    if not raw:
        return text
    try:
        for rule in json.loads(raw):
            if rule.get("original"):
                text = re.sub(rule["original"], rule.get("replacement", ""), text)
    except (json.JSONDecodeError, TypeError, AttributeError, re.error) as e:
        print(f"Warning: Could not apply replacements: {e}")
    return text


def sanitize_filename(name: str) -> str:
    name = re.sub(r"[^\w\s.-]", "", str(name)).strip()
    return re.sub(r"[-\s]+", "-", name).replace("/", "_").replace("\\", "_")


def create_download_filename(text: str, voice_name: Optional[str] = None) -> str:
    text_chars = re.findall(r"[\w一-鿥]", text)
    part = "".join(text_chars)[:10] or "synthesis_result"
    if voice_name:
        return f"{sanitize_filename(voice_name)}_{part}"
    return part


def create_app(engine=None, base_dir: Optional[str] = None,
               batch_requests: int = 1, batch_window_s: float = 0.08,
               slot_requests: int = 0) -> App:
    """batch_requests > 1 enables continuous batching: concurrent
    /api/synthesize tasks with identical generation parameters are merged
    into one engine.infer_batch call (up to batch_requests requests,
    collected over a batch_window_s gather window), so concurrent users
    share decode batches instead of queueing at batch 1. The reference
    serializes whole requests (webui.py:232); output parity of the merged
    path is pinned by tests/test_infer_batch.py.

    slot_requests > 0 enables ROLLING-admission continuous batching instead
    (mutually exclusive with batch_requests): a persistent slot_requests-row
    SlotSession where a new request joins the live decode at the next chunk
    boundary rather than waiting for the running batch — no head-of-line
    blocking (indextts_tpu/serving.py). num_beams must be 1 for the slot
    path; beam requests (the web form's DEFAULT, num_beams=3) ride a
    gather-window batch lane (same machinery as batch_requests, wave size =
    slot_requests) so concurrent default-form requests still share decode
    batches. Sessions are keyed by static generation knobs (bounded at 2 —
    each holds a device-resident circular KV cache); per-request dynamic
    knobs merge per-row."""
    base_dir = base_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
    base_dir = os.path.abspath(base_dir)
    static_dir = os.path.join(base_dir, "static")
    template_dir = os.path.join(base_dir, "templates")
    output_dir = os.path.join(static_dir, "outputs")
    temp_dir = os.path.join(static_dir, "temp_audio")
    rulesets_dir = os.path.join(static_dir, "replacement_rulesets")
    voices_dir = os.path.join(static_dir, "saved_voice_features")
    for d in (output_dir, temp_dir, rulesets_dir, voices_dir):
        os.makedirs(d, exist_ok=True)

    if batch_requests > 1 and slot_requests > 0:
        raise ValueError("batch_requests and slot_requests are mutually "
                         "exclusive continuous-batching modes")
    app = App(static_dir=static_dir)
    tasks_status: Dict[str, Dict[str, Any]] = {}
    tasks_lock = threading.Lock()
    temp_features_cache: Dict[str, Dict[str, Any]] = {}
    temp_features_lock = threading.Lock()
    worker_lock = threading.Lock()  # serializes engine use across tasks
    batch_cond = threading.Condition()
    batch_pending: list = []  # queued jobs awaiting the batching dispatcher
    stop_event = threading.Event()  # app.shutdown(): dispatcher loops exit
    _disp_threads: list = []  # dispatcher threads, joined by shutdown()

    # ------------------------------------------------------------------
    @app.route("/")
    def index(req: Request):
        path = os.path.join(template_dir, "index.html")
        if not os.path.exists(path):
            return Response("<h1>indextts-tpu</h1><p>templates/index.html missing</p>")
        with open(path, "rb") as f:
            return Response(f.read())

    @app.route("/audio/<path:filename>")
    def serve_audio(req: Request, filename: str):
        full = os.path.normpath(os.path.join(output_dir, filename))
        if not full.startswith(output_dir + os.sep) or not os.path.isfile(full):
            return jsonify({"error": "not found"}, 404)
        with open(full, "rb") as f:
            return Response(f.read(), content_type="audio/wav")

    # ------------------------------------------------------------------
    @app.route("/api/history-audios")
    def history_audios(req: Request):
        if not os.path.exists(output_dir):
            return jsonify([])
        audio_files = []
        for filename in os.listdir(output_dir):
            if filename.lower().endswith((".wav", ".mp3", ".ogg")):
                try:
                    stat = os.stat(os.path.join(output_dir, filename))
                except OSError:
                    continue  # deleted between listdir and stat (concurrent DELETE)
                audio_files.append(
                    {
                        "name": filename,
                        "url": f"/static/outputs/{filename}",
                        "date": datetime.fromtimestamp(stat.st_ctime).strftime("%Y-%m-%d %H:%M"),
                    }
                )
        audio_files.sort(key=lambda x: x["date"], reverse=True)
        return jsonify(audio_files)

    @app.route("/api/delete-audio", methods=["DELETE"])
    def delete_audio(req: Request):
        data = req.get_json() or {}
        filename = data.get("filename")
        if not filename:
            return jsonify({"error": "missing filename"}, 400)
        # basename strips any directory components: the reference joins the
        # raw name (path traversal / absolute-path delete); every other
        # endpoint here sanitizes, so must this one
        file_path = os.path.join(output_dir, os.path.basename(str(filename)))
        if not os.path.isfile(file_path):
            return jsonify({"error": "file not found"}, 404)
        os.remove(file_path)
        return jsonify({"success": True})

    # ------------------------------------------------------------------
    @app.route("/api/rulesets", methods=["GET"])
    def list_rulesets(req: Request):
        files = [f.replace(".json", "") for f in os.listdir(rulesets_dir) if f.endswith(".json")]
        return jsonify(sorted(files))

    @app.route("/api/rulesets", methods=["POST"])
    def save_ruleset(req: Request):
        data = req.get_json() or {}
        name = data.get("name")
        rules = data.get("rules")
        if not name or not isinstance(rules, list):
            return jsonify({"error": "Invalid data provided"}, 400)
        safe_name = sanitize_filename(name)
        with open(os.path.join(rulesets_dir, f"{safe_name}.json"), "w", encoding="utf-8") as f:
            json.dump(rules, f, ensure_ascii=False, indent=2)
        return jsonify({"message": f"Ruleset '{name}' saved successfully.", "filename": safe_name})

    @app.route("/api/rulesets/<ruleset_name>", methods=["GET"])
    def get_ruleset(req: Request, ruleset_name: str):
        filepath = os.path.join(rulesets_dir, f"{sanitize_filename(ruleset_name)}.json")
        if not os.path.exists(filepath):
            return jsonify({"error": "Ruleset not found"}, 404)
        with open(filepath, "r", encoding="utf-8") as f:
            return jsonify(json.load(f))

    @app.route("/api/rulesets/<ruleset_name>", methods=["DELETE"])
    def delete_ruleset(req: Request, ruleset_name: str):
        filepath = os.path.join(rulesets_dir, f"{sanitize_filename(ruleset_name)}.json")
        if os.path.exists(filepath):
            os.remove(filepath)
            return jsonify({"message": f"Ruleset '{ruleset_name}' deleted."})
        return jsonify({"error": "Ruleset not found"}, 404)

    # ------------------------------------------------------------------
    @app.route("/api/saved-voices", methods=["GET"])
    def list_saved_voices(req: Request):
        voices = []
        for f_name in os.listdir(voices_dir):
            if f_name.endswith(".meta.json"):
                try:
                    with open(os.path.join(voices_dir, f_name), "r", encoding="utf-8") as mf:
                        meta = json.load(mf)
                        voices.append(
                            {
                                "id": meta.get("id", f_name.replace(".meta.json", "")),
                                "name": meta.get("user_given_name", "Unknown"),
                            }
                        )
                except (json.JSONDecodeError, KeyError) as e:
                    print(f"Warning: Could not parse meta file {f_name}: {e}")
        return jsonify(sorted(voices, key=lambda x: x["name"]))

    @app.route("/api/saved-voices/<voice_id>", methods=["DELETE"])
    def delete_saved_voice(req: Request, voice_id: str):
        safe_id = sanitize_filename(voice_id)
        deleted = 0
        for fname in (f"{safe_id}.cond_mel.npy", f"{safe_id}.meta.json"):
            fpath = os.path.join(voices_dir, fname)
            if os.path.exists(fpath):
                os.remove(fpath)
                deleted += 1
        if deleted:
            return jsonify({"message": f"Voice '{voice_id}' deleted."})
        return jsonify({"error": "Voice not found"}, 404)

    @app.route("/api/save-voice-feature", methods=["POST"])
    def save_voice_feature(req: Request):
        data = req.get_json() or {}
        user_given_name = data.get("name")
        source_feature_key = data.get("source_reference_identifier")
        if not user_given_name or not source_feature_key:
            return jsonify({"error": "Missing name or source identifier"}, 400)
        with temp_features_lock:
            feature = temp_features_cache.pop(source_feature_key, None)
        if not feature or "cond_mel_numpy" not in feature:
            return jsonify({"error": f"No cached feature for '{source_feature_key}' (may have been replaced)."}, 404)
        safe_id = sanitize_filename(user_given_name)
        np.save(os.path.join(voices_dir, f"{safe_id}.cond_mel.npy"), feature["cond_mel_numpy"])
        with open(os.path.join(voices_dir, f"{safe_id}.meta.json"), "w", encoding="utf-8") as f:
            json.dump({"id": safe_id, "user_given_name": user_given_name}, f, ensure_ascii=False, indent=2)
        return jsonify({"message": f"Voice feature '{user_given_name}' saved.", "id": safe_id, "name": user_given_name})

    # ------------------------------------------------------------------
    def synthesis_worker(task_id, text_input, prompt_mel, output_filename, infer_mode,
                         max_text_tokens_per_sentence, verbose_tts, kwargs):
        def progress_callback(fraction, description):
            with tasks_lock:
                if task_id in tasks_status:
                    tasks_status[task_id].update({"progress": int(fraction * 100), "message": description})

        with worker_lock:
            engine.set_gr_progress_callback(progress_callback)
            try:
                _update_status(task_id, {"status": "processing", "progress": 0, "message": "preparing..."})
                infer = engine.infer_fast if infer_mode == "批次推理" else engine.infer
                infer(
                    prompt_mel=prompt_mel,
                    text=text_input,
                    output_path=output_filename,
                    max_text_tokens_per_sentence=int(max_text_tokens_per_sentence),
                    verbose=verbose_tts,
                    **kwargs,
                )
                _update_status(task_id, _completed_fields(text_input, output_filename))
            except Exception as e:
                print(f"Error in synthesis_worker for task {task_id}: {e}")
                traceback.print_exc()
                _update_status(task_id, {"status": "failed", "message": f"synthesis failed: {e}", "finished_at": time.time()})
            finally:
                engine.set_gr_progress_callback(None)

    def _completed_fields(text_input, output_filename):
        base = create_download_filename(text_input)
        _, ext = os.path.splitext(output_filename)
        return {
            "status": "completed", "progress": 100, "message": "synthesis complete!",
            "audio_url": f"/static/outputs/{os.path.basename(output_filename)}",
            "download_filename": f"{base}{ext}", "finished_at": time.time(),
        }

    # sampling knobs that may differ across jobs in ONE batch — they ride
    # the decode as per-row traced vectors. Sourced from the engine so the
    # two lists cannot drift (a stale copy here would either fail whole
    # batches in infer_batch's validation or needlessly refuse merges).
    _DYN = tuple(getattr(engine, "BATCH_DYNAMIC_PARAMS",
                         ("temperature", "top_p", "repetition_penalty",
                          "length_penalty", "typical_mass")))

    def _job_sig(job):
        # jobs must share every STATIC generation parameter (shape/trace:
        # do_sample, num_beams, top_k, typical_sampling, max_mel_tokens…) to
        # share a decode batch; dynamic sampling knobs merge per-row.
        # infer_mode stays in the signature because a signature group of
        # size 1 falls back to the solo worker, where the mode selects
        # engine.infer vs engine.infer_fast — merging modes would make that
        # fallback depend on which request arrived first.
        return (job["infer_mode"], str(job["max_tokens"]),
                tuple(sorted((k, v) for k, v in job["kwargs"].items() if k not in _DYN)))

    def _update_status(task_id, fields):
        with tasks_lock:
            entry = tasks_status.get(task_id)
            if entry is not None:
                entry.update(fields)

    def _upload_to_mel(temp_path, form):
        """Uploaded reference audio -> [1, 100, frames] mel: decode (wav
        natively; mp3/ogg/flac via ffmpeg when present, matching the
        reference's torchaudio acceptance, webui.py:307-389), resample,
        apply cropStart/cropEnd bounds, mel. ONE pipeline shared by
        /api/synthesize and /api/synthesize-stream — the stream route used
        to carry a drifted copy that silently ignored crop bounds.
        Returns (mel, None) or (None, (error_dict, http_status))."""
        target_sr = engine.cfg.bigvgan.sampling_rate
        try:
            waveform, orig_sr = decode_audio(temp_path)
        except UnsupportedAudioFormat as e:
            return None, ({"error": str(e)}, 415)
        if orig_sr != target_sr:
            waveform = resample(waveform, orig_sr, target_sr)
        crop_start = form.get("cropStart")
        crop_end = form.get("cropEnd")
        if crop_start is not None or crop_end is not None:
            try:
                # OverflowError too: int(float("1e999")) -> inf -> raises
                start = int(float(crop_start) * target_sr) if crop_start else 0
                end = int(float(crop_end) * target_sr) if crop_end else waveform.shape[1]
                if start < 0 or end < 0:
                    # negative indices would silently slice from the tail
                    raise ValueError("negative crop")
            except (ValueError, TypeError, OverflowError):
                return None, ({"error": "invalid crop range"}, 400)
            if start < end and start < waveform.shape[1]:
                waveform = waveform[:, start:end]
        # reference prompts are seconds long (zero-shot voice cloning);
        # featurizing an hour-long upload is never intentional and wastes
        # minutes of host CPU per request — clean 400 instead
        max_s = 300
        if waveform.shape[1] > max_s * target_sr:
            return None, ({"error": f"reference audio too long "
                           f"(max {max_s}s; crop it with cropStart/cropEnd)"},
                          400)
        mel = MelSpectrogramFeatures()(np.clip(waveform.mean(axis=0, keepdims=True), -1, 1))
        return mel.astype(np.float32), None

    def _run_batch(jobs, wave_size=None):
        """Run a group of same-signature jobs as ONE engine.infer_batch call
        (single job falls back to the solo worker for identical behavior)."""
        if wave_size is None:
            wave_size = batch_requests
        if len(jobs) == 1:
            j = jobs[0]
            synthesis_worker(j["task_id"], j["text"], j["prompt_mel"], j["output"],
                             j["infer_mode"], j["max_tokens"], j["verbose"], j["kwargs"])
            return
        ids = [j["task_id"] for j in jobs]
        # output paths are unique by construction (task-id suffix at request
        # time), so no within-batch de-collision is needed here

        def progress_callback(fraction, description):
            for tid in ids:
                _update_status(tid, {"progress": int(fraction * 100), "message": description})

        with worker_lock:
            engine.set_gr_progress_callback(progress_callback)
            try:
                for j in jobs:
                    _update_status(j["task_id"], {"status": "processing", "progress": 0,
                                                  "message": f"batched with {len(jobs) - 1} other request(s)..."})
                static_kwargs = {k: v for k, v in jobs[0]["kwargs"].items() if k not in _DYN}
                engine.infer_batch(
                    [(j["prompt_mel"], j["text"]) for j in jobs],
                    output_paths=[j["output"] for j in jobs],
                    # decode bucket >= the configured wave size, or a full
                    # wave decodes in slices of 8 and loses the weight-
                    # stream amortization batching exists for (SERVING.md:
                    # 128 reqs at bucket 8 measured 4.6x the bucket-128 wall)
                    sentences_bucket_max_size=max(8, wave_size),
                    max_text_tokens_per_sentence=int(jobs[0]["max_tokens"]),
                    verbose=any(j["verbose"] for j in jobs),
                    per_request_kwargs=[
                        {k: v for k, v in j["kwargs"].items() if k in _DYN} for j in jobs
                    ],
                    **static_kwargs,
                )
                for j in jobs:
                    _update_status(j["task_id"], _completed_fields(j["text"], j["output"]))
            except Exception as e:
                print(f"Error in batched synthesis for tasks {ids}: {e}")
                traceback.print_exc()
                for j in jobs:
                    _update_status(j["task_id"], {"status": "failed",
                                                  "message": f"synthesis failed: {e}",
                                                  "finished_at": time.time()})
            finally:
                engine.set_gr_progress_callback(None)

    def batch_dispatcher(pending=batch_pending, cond=batch_cond, wave_size=None):
        """Gather-window batching loop over `pending`. Runs as the main
        dispatcher in --batch-requests mode, AND as the slot dispatcher's
        beam lane (see below) — ONE loop definition so the two modes cannot
        drift on signature grouping or failure handling."""
        wave = wave_size or batch_requests
        while not stop_event.is_set():
            with cond:
                while not pending and not stop_event.is_set():
                    cond.wait()
                if stop_event.is_set():
                    return
            time.sleep(batch_window_s)  # gather window for concurrent arrivals
            with cond:
                if not pending:
                    continue
                sig0 = _job_sig(pending[0])
                take = [j for j in pending if _job_sig(j) == sig0][:wave]
                for j in take:
                    pending.remove(j)
            try:
                _run_batch(take, wave_size=wave)
            except Exception as e:
                # the dispatcher is the ONLY consumer: if it dies, every
                # future request queues forever — never let a job kill it
                print(f"Error in batch dispatcher: {e}")
                traceback.print_exc()
                for j in take:
                    _update_status(j["task_id"], {"status": "failed",
                                                  "message": f"synthesis failed: {e}",
                                                  "finished_at": time.time()})

    if batch_requests > 1:
        t = threading.Thread(target=batch_dispatcher, daemon=True)
        t.start()
        _disp_threads.append(t)

    # slot mode's BEAM lane: requests the slot path cannot decode
    # (num_beams != 1 — the web form's DEFAULT is 3, matching the reference's
    # infer.py:122) ride the SAME gather-window batcher as --batch-requests
    # instead of serializing solo. Wave size = slot_requests, the operator's
    # stated concurrency budget. Beam batches and slot ticks interleave on
    # worker_lock at whole-batch vs chunk granularity.
    beam_cond = threading.Condition()
    beam_pending: list = []
    if slot_requests > 0:
        t = threading.Thread(
            target=batch_dispatcher,
            args=(beam_pending, beam_cond, max(2, slot_requests)),
            daemon=True,
        )
        t.start()
        _disp_threads.append(t)

    def _solo_fallback(j):
        threading.Thread(
            target=synthesis_worker,
            args=(j["task_id"], j["text"], j["prompt_mel"], j["output"],
                  j["infer_mode"], j["max_tokens"], j["verbose"], j["kwargs"]),
            daemon=True,
        ).start()

    def slot_dispatcher():
        """Rolling-admission loop: drain queued jobs into per-signature
        SlotSessions, run one decode chunk per busy session, publish
        completions. Sessions never block each other's admission. Jobs the
        slot path cannot serve are never silently dropped: beam jobs go to
        the gather-window beam lane above (concurrent ones merge into
        batched decodes); a third distinct static signature while both live
        sessions are busy (idle sessions are evicted to make room) falls
        back to the solo worker."""
        from indextts_tpu_torch.serving import SLOT_DYNAMIC_PARAMS as _SLOT_DYN

        sessions: Dict[Any, Any] = {}
        live: Dict[Any, Dict[str, Any]] = {}  # (sig, rid) -> job

        def _sig(job):
            # the batch dispatcher's signature minus infer_mode: a slot
            # session only cares about static decode knobs, not which solo
            # entry point a fallback would use (ONE definition — _job_sig —
            # so the two dispatchers can never drift on what "static" means)
            return _job_sig(job)[1:]

        def _job_fail(j, msg):
            # streaming jobs have no task-status row: releasing stream_done
            # ends the chunked HTTP response (truncated audio, loud log)
            if "stream_done" in j:
                j["stream_done"].set()
            else:
                _update_status(j["task_id"],
                               {"status": "failed", "message": msg,
                                "finished_at": time.time()})

        while not stop_event.is_set():
            with batch_cond:
                if not batch_pending and not any(s.busy for s in sessions.values()):
                    batch_cond.wait()
                if stop_event.is_set():
                    return
                take = list(batch_pending)
                batch_pending.clear()
            for j in take:
                try:
                    if ("stream_cancel" in j and j["stream_cancel"].is_set()):
                        j["stream_done"].set()  # client left before admission
                        continue
                    if int(j["kwargs"].get("num_beams", 3)) != 1:
                        # beams aren't slot-decodable — hand them to the
                        # gather-window batch lane (concurrent beam requests
                        # merge into one infer_batch call; a lone one runs
                        # solo), never to serialized solo-only inference
                        with beam_cond:
                            beam_pending.append(j)
                            beam_cond.notify()
                        continue
                    sig = _sig(j)
                    sess = sessions.get(sig)
                    if sess is None:
                        if len(sessions) >= 2:
                            # evict an idle session (no live jobs, nothing
                            # decoding) so a new signature reuses its device
                            # memory; only when ALL are busy fall back solo
                            idle = [s for s in sessions
                                    if not sessions[s].busy
                                    and not any(k[0] == s for k in live)]
                            if idle:
                                sessions.pop(idle[0])
                            elif "stream_done" in j:
                                # streaming jobs fall back to the route's
                                # own solo infer_stream producer
                                j["stream_solo"] = True
                                j["stream_done"].set()
                                continue
                            else:
                                _solo_fallback(j)
                                continue
                        static_kwargs = {k: v for k, v in j["kwargs"].items()
                                         if k not in _DYN}
                        with worker_lock:
                            sess = sessions[sig] = engine.slot_session(
                                n_slots=slot_requests,
                                max_text_tokens_per_sentence=int(j["max_tokens"]),
                                **static_kwargs)
                    # slot rows take only the knobs the slot step graph
                    # consumes; length_penalty is dropped (it only shapes
                    # beam scores and slot mode is num_beams=1, where the
                    # solo path ignores it too)
                    dyn = {k: v for k, v in j["kwargs"].items()
                           if k in _DYN and k in _SLOT_DYN}
                    # submit() runs engine work (conditioning + the shared
                    # _cond_cache); worker_lock serializes it against the
                    # solo/streaming workers (one process per TPU)
                    with worker_lock:
                        rid = sess.submit(j["prompt_mel"], j["text"],
                                          output_path=j["output"],
                                          on_chunk=j.get("stream_chunk"), **dyn)
                    live[(sig, rid)] = j
                    if "stream_done" not in j:
                        _update_status(j["task_id"],
                                       {"status": "processing", "progress": 5,
                                        "message": "decoding (slot batch)..."})
                except Exception as e:
                    traceback.print_exc()
                    _job_fail(j, f"synthesis failed: {e}")
            # propagate client disconnects: stop the abandoned row at the
            # next tick boundary instead of decoding+vocoding for nobody
            for (sig, rid), j in list(live.items()):
                ev = j.get("stream_cancel")
                if ev is not None and ev.is_set() and sig in sessions:
                    with worker_lock:
                        sessions[sig].cancel(rid)
                    j.pop("stream_cancel", None)  # fire once
            for sig, sess in list(sessions.items()):
                if not sess.busy:
                    continue
                try:
                    with worker_lock:
                        done = sess.tick()
                except Exception as e:
                    # a poisoned session would fail every future tick: fail
                    # its live jobs loudly and drop it (next job rebuilds)
                    traceback.print_exc()
                    for key, j in list(live.items()):
                        if key[0] == sig:
                            _job_fail(j, f"synthesis failed: {e}")
                            live.pop(key)
                    sessions.pop(sig)
                    continue
                for rid, _res in done:
                    j = live.pop((sig, rid), None)
                    if j is None:
                        continue
                    if "stream_done" in j:
                        j["stream_done"].set()
                    else:
                        _update_status(j["task_id"],
                                       _completed_fields(j["text"], j["output"]))

    if slot_requests > 0:
        t = threading.Thread(target=slot_dispatcher, daemon=True)
        t.start()
        _disp_threads.append(t)

    @app.route("/api/synthesize", methods=["POST"])
    def synthesize(req: Request):
        if engine is None:
            return jsonify({"error": "TTS Engine not loaded."}, 503)
        _reap_stale_tasks()
        task_id = str(uuid.uuid4())
        form = req.form
        prompt_mel = None
        is_new_upload = False
        source_identifier_for_save = None
        files_to_delete = []
        try:
            if req.files.get("referenceAudioFile") or form.get("saved_voice_identifier"):
                with temp_features_lock:
                    temp_features_cache.clear()

            safe_voice_id = ""
            if form.get("saved_voice_identifier"):
                safe_voice_id = sanitize_filename(form["saved_voice_identifier"])
                mel_path = os.path.join(voices_dir, f"{safe_voice_id}.cond_mel.npy")
                if not os.path.exists(mel_path):
                    return jsonify({"error": f"Saved voice '{safe_voice_id}' not found."}, 404)
                prompt_mel = np.load(mel_path)
            elif req.files.get("referenceAudioFile"):
                is_new_upload = True
                filename, data = req.files["referenceAudioFile"]
                temp_name = f"temp_upload_{task_id}_{sanitize_filename(filename)}"
                temp_path = os.path.join(temp_dir, temp_name)
                with open(temp_path, "wb") as f:
                    f.write(data)
                # opaque identifier: the SPA echoes it back to
                # /api/save-voice-feature; never expose server paths
                source_identifier_for_save = f"upload:{task_id}"
                files_to_delete.append(temp_path)

                prompt_mel, err = _upload_to_mel(temp_path, form)
                if err is not None:
                    # client errors (415 bad format / 400 bad crop) clean
                    # the temp upload like the empty-text path
                    for fpath in files_to_delete:
                        try:
                            os.remove(fpath)
                        except OSError:
                            pass
                    return jsonify(*err)
                with temp_features_lock:
                    temp_features_cache[source_identifier_for_save] = {"cond_mel_numpy": prompt_mel}
            else:
                return jsonify({"error": "A reference audio or saved voice feature is required."}, 400)

            # typed sampling params (reference param map: webui.py:393-402)
            kwargs_for_engine: Dict[str, Any] = {}
            param_map = {
                "do_sample": bool,
                "temperature": float,
                "top_k": int,
                "top_p": float,
                "repetition_penalty": float,
                "num_beams": int,
                "length_penalty": float,
                "max_mel_tokens": int,
                "typical_sampling": bool,
            }
            for key, target in param_map.items():
                if key in form:
                    try:
                        if target is bool:
                            kwargs_for_engine[key] = form[key].lower() in ("true", "on", "1")
                        else:
                            kwargs_for_engine[key] = target(form[key])
                    except (ValueError, TypeError):
                        print(f"Warning: bad param {key}={form[key]!r}; skipped")

            # replacements run BEFORE the empty check so a text-deleting rule
            # yields a clean 400, not a mid-synthesis engine error
            text_input = apply_replacements(form.get("text", ""), form.get("replacements"))
            if not text_input.strip():
                # early return skips task creation, so the TTL reaper will
                # never see the uploaded temp file — clean it here
                for fpath in files_to_delete:
                    try:
                        os.remove(fpath)
                    except OSError:
                        pass
                return jsonify({"error": "text is empty"}, 400)
            try:
                # "" (cleared number input) or garbage falls back to the
                # default like every param_map knob, instead of int("")
                # blowing up the whole task inside the worker
                max_tokens = int(float(form.get("max_text_tokens_per_sentence", 100)))
            except (TypeError, ValueError):
                max_tokens = 100
            verbose_tts = str(form.get("verbose_tts", "true")).lower() in ("true", "on", "1")

            # task-id suffix: two requests sharing a 10-char text prefix (and
            # voice) must not write the same path, or one user downloads the
            # other's audio. The pretty name survives in download_filename.
            output_filename = os.path.join(
                output_dir,
                f"{create_download_filename(text_input, safe_voice_id)}_{task_id[:8]}.wav")
            infer_mode = form.get("infer_mode", "普通推理")

            with tasks_lock:
                tasks_status[task_id] = {
                    "status": "queued",
                    "progress": 0,
                    "message": "task queued",
                    "files_to_delete": files_to_delete,
                    "created_at": time.time(),
                }
                if is_new_upload and source_identifier_for_save:
                    tasks_status[task_id]["is_from_new_upload"] = True
                    tasks_status[task_id]["source_reference_identifier_for_save"] = source_identifier_for_save

            if batch_requests > 1 or slot_requests > 0:
                job = {"task_id": task_id, "text": text_input, "prompt_mel": prompt_mel,
                       "output": output_filename, "infer_mode": infer_mode,
                       "max_tokens": max_tokens, "verbose": verbose_tts,
                       "kwargs": kwargs_for_engine}
                with batch_cond:
                    batch_pending.append(job)
                    batch_cond.notify()
            else:
                threading.Thread(
                    target=synthesis_worker,
                    args=(task_id, text_input, prompt_mel, output_filename, infer_mode, max_tokens, verbose_tts,
                          kwargs_for_engine),
                    daemon=True,
                ).start()
            return jsonify({"message": "synthesis task started", "task_id": task_id})
        except Exception as e:
            traceback.print_exc()
            for f in files_to_delete:
                if os.path.exists(f):
                    try:
                        os.remove(f)
                    except Exception:
                        pass
            return jsonify({"error": f"request failed: {e}"}, 500)

    @app.route("/api/synthesize-stream", methods=["POST"])
    def synthesize_stream(req: Request):
        """Streaming synthesis (new capability — the reference has no audio
        streaming): returns a chunked WAV whose PCM arrives as the AR decode
        produces codes (engine.infer_stream). Uses the max-size RIFF length
        trick so players start before the total length is known."""
        if engine is None:
            return jsonify({"error": "TTS Engine not loaded."}, 503)
        form = req.form
        # replacements BEFORE the empty check (shared semantics with
        # /api/synthesize): a text-deleting rule must 400 here, not raise
        # inside wav_stream() after the 200 + RIFF header went out
        text_input = apply_replacements(form.get("text", ""), form.get("replacements"))
        if not text_input.strip():
            return jsonify({"error": "text is empty"}, 400)
        prompt_mel = None
        if form.get("saved_voice_identifier"):
            safe_voice_id = sanitize_filename(form["saved_voice_identifier"])
            mel_path = os.path.join(voices_dir, f"{safe_voice_id}.cond_mel.npy")
            if not os.path.exists(mel_path):
                return jsonify({"error": f"Saved voice '{safe_voice_id}' not found."}, 404)
            prompt_mel = np.load(mel_path)
        elif req.files.get("referenceAudioFile"):
            filename, data = req.files["referenceAudioFile"]
            tmp = os.path.join(temp_dir, f"stream_{uuid.uuid4()}_{sanitize_filename(filename)}")
            with open(tmp, "wb") as f:
                f.write(data)
            try:
                prompt_mel, err = _upload_to_mel(tmp, form)
                if err is not None:
                    return jsonify(*err)
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        else:
            return jsonify({"error": "A reference audio or saved voice feature is required."}, 400)

        kwargs: Dict[str, Any] = {}
        for key, target in (("do_sample", bool), ("temperature", float), ("top_k", int),
                            ("top_p", float), ("repetition_penalty", float), ("max_mel_tokens", int)):
            if key in form:
                try:
                    kwargs[key] = (form[key].lower() in ("true", "on", "1")) if target is bool else target(form[key])
                except (ValueError, TypeError):
                    pass

        def wav_stream():
            import queue as _queue
            import struct

            # the engine vocodes at the BigVGAN config rate — the same
            # authority _upload_to_mel resamples inputs to; a hardcoded
            # 24000 here would mis-declare the rate for other configs
            sr = engine.cfg.bigvgan.sampling_rate
            # Decouple engine execution from client socket writes: the
            # producer thread holds worker_lock only while synthesizing and
            # queues PCM; the generator yields from the queue OUTSIDE the
            # lock. Yielding under the lock would let one slow-reading
            # streaming client stall every other synthesis server-wide (the
            # generator suspends mid-`with` while wsgiref blocks on the
            # socket). Queue memory is bounded by the audio itself
            # (~48 KB/s of PCM). A client disconnect sets `cancelled`, which
            # stops the decode at the next chunk instead of synthesizing to
            # completion for nobody.
            q: "_queue.Queue[Optional[bytes]]" = _queue.Queue()
            cancelled = threading.Event()

            def produce():
                try:
                    # under --slot-batching on a fast_latents engine, the
                    # stream rides the rolling decode batch (SlotSession
                    # on_chunk): streaming TTFA under sustained load instead
                    # of queueing behind the solo worker. The dispatcher
                    # sets stream_solo when it cannot place the job (both
                    # sessions busy with another signature) — then fall
                    # through to the solo infer_stream path.
                    use_slots = (slot_requests > 0
                                 and getattr(engine, "fast_latents", False))
                    if use_slots:
                        done_evt = threading.Event()

                        def on_chunk(_rid, chunk):
                            if not cancelled.is_set():
                                q.put(np.ascontiguousarray(chunk, dtype="<i2").tobytes())

                        job = {"task_id": f"stream-{uuid.uuid4()}",
                               "prompt_mel": prompt_mel, "text": text_input,
                               "output": None, "verbose": False,
                               "kwargs": {**kwargs, "num_beams": 1},
                               "max_tokens": 120, "infer_mode": "stream",
                               "stream_chunk": on_chunk, "stream_done": done_evt,
                               "stream_cancel": cancelled}
                        with batch_cond:
                            batch_pending.append(job)
                            batch_cond.notify_all()
                        deadline = time.time() + 3600
                        while not done_evt.wait(timeout=0.25):
                            if cancelled.is_set() or time.time() > deadline:
                                break
                        if job.get("stream_solo") and not cancelled.is_set():
                            use_slots = False
                    if not use_slots:
                        with worker_lock:
                            for chunk in engine.infer_stream(prompt_mel, text_input, **kwargs):
                                if cancelled.is_set():
                                    break
                                # NaN passes np.clip and casts to garbage
                                # PCM with a RuntimeWarning — stream silence
                                # for non-finite samples instead
                                pcm = np.clip(
                                    np.nan_to_num(chunk * 32767.0, nan=0.0,
                                                  posinf=32767.0, neginf=-32767.0),
                                    -32767, 32767).astype("<i2")
                                q.put(pcm.tobytes())
                except Exception:
                    traceback.print_exc()
                finally:
                    q.put(None)

            threading.Thread(target=produce, daemon=True).start()
            try:
                # RIFF header with max sizes: players treat it as "until EOF"
                yield (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
                       + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                       + b"data" + struct.pack("<I", 0xFFFFFFFF))
                while True:
                    buf = q.get()
                    if buf is None:
                        break
                    yield buf
            finally:
                cancelled.set()

        return StreamResponse(wav_stream(), content_type="audio/wav")

    def _cleanup_task_files(entry):
        for f_path in (entry or {}).get("files_to_delete", []):
            if os.path.exists(f_path):
                try:
                    os.remove(f_path)
                except Exception as e:
                    print(f"Error cleaning temp file {f_path}: {e}")

    def _reap_stale_tasks(ttl_done: float = 600.0, ttl_any: float = 7200.0):
        """Drop terminal tasks nobody collected within ttl_done, and any task
        older than ttl_any (orphaned by a client that never polled). Keeps the
        completed result available for reconnecting clients in the meantime —
        the previous design popped the entry in the SSE finally block, which
        also ran on client disconnect and destroyed the result."""
        now = time.time()
        reaped = []
        with tasks_lock:
            for tid, entry in list(tasks_status.items()):
                done = entry.get("status") in ("completed", "failed", "error")
                old = now - entry.get("created_at", now) > ttl_any
                collected = now - entry.get("finished_at", now) > ttl_done
                # a task actively being synthesized OR still waiting its turn
                # is never stale, however old: the serialized worker queue /
                # batch dispatcher can legitimately sit on a deep backlog for
                # hours, and reaping a live entry would strand its eventual
                # result (clients polling it would get "unknown task id"
                # while the synthesis still burns device time to completion)
                if entry.get("status") in ("processing", "queued"):
                    continue
                if (done and collected) or old:
                    reaped.append(tasks_status.pop(tid))
        for entry in reaped:
            _cleanup_task_files(entry)

    @app.route("/api/task-status/<task_id>")
    def task_status(req: Request, task_id: str):
        """One-shot JSON status (programmatic clients / tools/load_test.py;
        the SSE route below is the browser channel). Extra server surface
        beyond the reference (its webui.py serves status via SSE only)."""
        with tasks_lock:
            st = tasks_status.get(task_id)
            if st is None:
                return jsonify({"error": "unknown task"}, 404)
            safe = {k: v for k, v in st.items() if k != "files_to_delete"}
        return jsonify(safe)

    @app.route("/api/synthesize-stream-status/<task_id>")
    def synthesize_stream_status(req: Request, task_id: str):
        def generate():
            terminal = False
            while True:
                with tasks_lock:
                    known = task_id in tasks_status
                    task_info = dict(tasks_status.get(task_id, {}))
                if not known:
                    # unknown/expired id: emit a terminal event instead of an
                    # infinite stream of empty dicts
                    yield {"status": "error", "message": "unknown task id"}
                    break
                task_info.pop("files_to_delete", None)
                task_info.pop("created_at", None)
                task_info.pop("finished_at", None)
                yield task_info
                if task_info.get("status") in ("completed", "failed", "error"):
                    terminal = True
                    break
                time.sleep(0.2)
            if terminal:
                # pop only after a terminal status was actually delivered; a
                # client that disconnects mid-processing can reconnect and
                # still collect the result (TTL sweep reaps true orphans)
                with tasks_lock:
                    cleaned = tasks_status.pop(task_id, None)
                _cleanup_task_files(cleaned)

        return SSEResponse(generate())

    app._tasks_status = tasks_status  # exposed for tests
    app._temp_features_cache = temp_features_cache

    def _shutdown(timeout: float = 2.0) -> None:
        """Stop the dispatcher threads (idempotent). Without this every
        create_app(batch_requests>1 / slot_requests>0) leaks a daemon thread
        parked in cond.wait() that pins the engine — and through it every
        compiled XLA executable — for the life of the process (the round-4
        suite accumulated dozens across server tests)."""
        stop_event.set()
        for cond in (batch_cond, beam_cond):
            with cond:
                cond.notify_all()
        for t in _disp_threads:
            t.join(timeout=timeout)
        with _LIVE_APPS_LOCK:
            if app in _LIVE_APPS:
                _LIVE_APPS.remove(app)

    app.shutdown = _shutdown
    if _disp_threads:
        with _LIVE_APPS_LOCK:
            _LIVE_APPS.append(app)
    return app


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="indextts-tpu-torch web server (PyTorch engine)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("-c", "--config", default="checkpoints/config.yaml")
    parser.add_argument("--model_dir", default="checkpoints")
    parser.add_argument("--random-init", action="store_true", help="serve with random weights (demo/testing)")
    parser.add_argument("-d", "--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--fast-latents", action="store_true",
        help="capture vocoder latents during decode (skips the teacher-forced "
        "pass when silence removal changes nothing)",
    )
    parser.add_argument(
        "--quant-kv", action="store_true",
        help="int8 KV cache for the AR decode (lower HBM traffic, near-parity)",
    )
    parser.add_argument(
        "--batch-requests", type=int, default=1,
        help="continuous batching: merge up to N concurrent same-parameter "
        "synthesis requests into one batched decode (1 = serialize, the "
        "reference behavior; 4-8 recommended for busy serving)",
    )
    parser.add_argument(
        "--slot-batching", type=int, default=0,
        help="ROLLING-admission continuous batching with N decode slots "
        "(mutually exclusive with --batch-requests): new requests join the "
        "live decode at the next chunk instead of waiting for the running "
        "batch; num_beams=1 requests only (beams fall back to solo)",
    )
    parser.add_argument(
        "--tp", type=int, default=None,
        help="tensor-parallel degree over the ranks of a torchrun launch "
        "(default 2 when the world is even; one process ignores it): rank 0 "
        "binds HTTP and the other ranks replay its engine calls",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="pre-compile the serving graphs for this server's mode and the "
        "web form's default sampling config before binding the port (first "
        "compiles are minutes on TPU; warmed servers answer the first "
        "request at steady-state speed)",
    )
    args = parser.parse_args(argv)
    if args.batch_requests > 1 and args.slot_batching > 0:
        # reject BEFORE engine init/warmup — create_app re-checks, but by
        # then a misconfigured launch has paid minutes of TPU compiles
        parser.error("--batch-requests and --slot-batching are mutually "
                     "exclusive continuous-batching modes")

    engine = None
    try:
        from indextts_tpu_torch.engine import IndexTTS

        engine = IndexTTS(
            cfg_path=args.config, model_dir=args.model_dir, device=args.device,
            allow_random_init=args.random_init,
            fast_latents=args.fast_latents, quant_kv=args.quant_kv,
            tp=args.tp,
        )
        print(f"Successfully initialized IndexTTS PyTorch engine on {args.device}.")
    except Exception as e:
        print(f"ERROR: Failed to initialize IndexTTS engine: {e}")
        traceback.print_exc()

    if getattr(engine, "mesh", None) is not None:
        from indextts_tpu_torch.server.mesh_proxy import EngineProxy, follow

        if engine.mesh.rank != 0:
            follow(engine)  # until rank 0's server shuts down
            return
        engine = EngineProxy(engine)

    if args.warmup and engine is not None:
        # the static knobs of the SPA form's defaults (templates/index.html)
        # — these select the compiled graphs; traced scalars don't
        spa_defaults = dict(do_sample=True, temperature=1.0, top_k=30,
                            top_p=0.8, repetition_penalty=10.0, num_beams=3,
                            max_mel_tokens=600)
        print(">> warming up serving graphs (this pays the first-request "
              "compiles now)...")
        if args.slot_batching:
            engine.warmup(n_slots=args.slot_batching,
                          streaming=engine.fast_latents, **spa_defaults)
            # default-form requests carry num_beams=3 and fall back to the
            # solo worker in slot mode — warm that path too, including the
            # solo infer_stream graphs (streaming requests take the solo
            # path when fast_latents is off or the slot sessions are busy)
            engine.warmup(streaming=True, **spa_defaults)
        elif args.batch_requests > 1:
            engine.warmup(batch=args.batch_requests, streaming=True,
                          **spa_defaults)
        else:
            engine.warmup(streaming=True, **spa_defaults)

    app = create_app(engine, batch_requests=args.batch_requests,
                     slot_requests=args.slot_batching)
    if engine is None:
        print("\nFATAL: TTS Engine could not be initialized; serving API errors only.")
    try:
        app.run(args.host, args.port)
    finally:
        app.shutdown()
        if hasattr(engine, "stop"):  # the mesh's followers end with the server
            engine.stop()


if __name__ == "__main__":
    main()
