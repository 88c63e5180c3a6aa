"""The port's web server (indextts_tpu_torch/server/) under the cases of
tests/test_server.py, with every import on the port's modules: the full REST
surface exercised through the WSGI app directly (no sockets), with a fake
engine for synthesis. Then: the port's wsgi.py and webui.py pinned to the JAX
package's text, a tiny port engine behind create_app, and main's arguments."""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_infer_fast import engines  # noqa: F401  (a fixture: a tiny port engine, one torch thread)

from indextts_tpu_torch.config import IndexTTSConfig
from indextts_tpu_torch.server.webui import create_app, create_download_filename, sanitize_filename
from indextts_tpu_torch.utils.audio import write_wav


@pytest.fixture(autouse=True)
def _reap_port_dispatchers():
    """Stop the dispatcher threads a test's app left running (tests/conftest.py
    does this for the JAX package's webui)."""
    yield
    import indextts_tpu_torch.server.webui as webui

    webui.shutdown_all()


class FakeEngine:
    def __init__(self):
        self.cfg = IndexTTSConfig()
        self.callback = None
        self.calls = []

    def set_gr_progress_callback(self, cb):
        self.callback = cb

    def infer(self, prompt_mel=None, text="", output_path=None, **kw):
        self.calls.append(("infer", text, kw))
        if self.callback:
            self.callback(0.5, "halfway")
        write_wav(output_path, np.zeros((1, 2400), np.int16), 24000)
        return output_path

    def infer_fast(self, prompt_mel=None, text="", output_path=None, **kw):
        self.calls.append(("infer_fast", text, kw))
        write_wav(output_path, np.zeros((1, 2400), np.int16), 24000)
        return output_path


class Client:
    """Tiny WSGI test client."""

    def __init__(self, app):
        self.app = app

    def request(self, method, path, body=b"", content_type=None):
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "QUERY_STRING": "",
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
        }
        if content_type:
            environ["CONTENT_TYPE"] = content_type
        captured = {}

        def start_response(status, headers):
            captured["status"] = int(status.split()[0])
            captured["headers"] = dict(headers)

        result = self.app(environ, start_response)
        return captured["status"], captured["headers"], result

    def json(self, method, path, obj=None):
        body = json.dumps(obj).encode() if obj is not None else b""
        status, headers, result = self.request(method, path, body, "application/json")
        data = b"".join(result)
        return status, json.loads(data) if data else None

    def multipart(self, path, fields, files=None):
        # ONE encoder (_multipart_body) for every test — two copies would
        # silently diverge on boundary/framing details
        body, ctype = _multipart_body(fields, files)
        status, headers, result = self.request("POST", path, body, ctype)
        data = b"".join(result)
        return status, json.loads(data) if data else None


@pytest.fixture()
def server(tmp_path):
    engine = FakeEngine()
    app = create_app(engine, base_dir=str(tmp_path))
    return Client(app), engine, app, str(tmp_path)


_WAV_CACHE = {}


def _wav_bytes():
    # per-process unique temp path (a fixed /tmp name races under
    # pytest-xdist: a reader can pick up a partially-written file), cached
    # so the encode runs once
    if "wav" not in _WAV_CACHE:
        import tempfile

        fd, buf_path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        try:
            t = np.linspace(0, 0.2, 4800, endpoint=False)
            write_wav(buf_path, (0.3 * np.sin(2 * np.pi * 220 * t) * 32767)[None, :], 24000)
            with open(buf_path, "rb") as f:
                _WAV_CACHE["wav"] = f.read()
        finally:
            os.remove(buf_path)
    return _WAV_CACHE["wav"]


class TestHelpers:
    def test_sanitize(self):
        assert sanitize_filename("a b/c\\d!") == "a-bcd"

    def test_download_filename(self):
        assert create_download_filename("你好 world, nice!") .startswith("你好world")
        assert create_download_filename("!!!") == "synthesis_result"
        assert create_download_filename("hey", "my voice").startswith("my-voice_")


class TestRulesets:
    def test_crud(self, server):
        client, _, _, _ = server
        status, data = client.json("GET", "/api/rulesets")
        assert status == 200 and data == []
        status, data = client.json("POST", "/api/rulesets", {"name": "t1", "rules": [{"original": "a", "replacement": "b"}]})
        assert status == 200
        status, data = client.json("GET", "/api/rulesets/t1")
        assert status == 200 and data[0]["original"] == "a"
        status, data = client.json("GET", "/api/rulesets")
        assert data == ["t1"]
        status, data = client.json("DELETE", "/api/rulesets/t1")
        assert status == 200
        status, data = client.json("GET", "/api/rulesets/t1")
        assert status == 404

    def test_invalid_post(self, server):
        client, _, _, _ = server
        status, data = client.json("POST", "/api/rulesets", {"name": "", "rules": "notalist"})
        assert status == 400


class TestVoices:
    def test_list_empty_and_delete_missing(self, server):
        client, _, _, _ = server
        status, data = client.json("GET", "/api/saved-voices")
        assert status == 200 and data == []
        status, data = client.json("DELETE", "/api/saved-voices/nope")
        assert status == 404


class TestSynthesis:
    def _drain_sse(self, app, client, task_id, timeout=10.0):
        status, headers, result = client.request("GET", f"/api/synthesize-stream-status/{task_id}")
        assert headers["Content-Type"].startswith("text/event-stream")
        events = []
        start = time.time()
        for chunk in result:
            for line in chunk.decode().strip().split("\n"):
                if line.startswith("data: "):
                    events.append(json.loads(line[6:]))
            if time.time() - start > timeout:
                break
        return events

    def test_upload_synthesize_and_save_voice(self, server):
        client, engine, app, base = server
        status, data = client.multipart(
            "/api/synthesize",
            {"text": "hello there.", "infer_mode": "普通推理", "temperature": "0.9", "top_k": "20",
             "replacements": json.dumps([{"original": "there", "replacement": "world"}])},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200, data
        task_id = data["task_id"]
        events = self._drain_sse(app, client, task_id)
        assert events[-1]["status"] == "completed"
        assert events[-1]["audio_url"].startswith("/static/outputs/")
        # regex replacement applied before synthesis
        mode, text, kw = engine.calls[-1]
        assert mode == "infer" and text == "hello world."
        assert kw["temperature"] == 0.9 and kw["top_k"] == 20
        # save the cached voice feature
        src = events[-1].get("source_reference_identifier_for_save")
        assert src
        status, data = client.json(
            "POST", "/api/save-voice-feature", {"name": "My Voice", "source_reference_identifier": src}
        )
        assert status == 200, data
        status, voices = client.json("GET", "/api/saved-voices")
        assert voices and voices[0]["name"] == "My Voice"
        # synthesize again from the saved voice, batch mode
        status, data = client.multipart(
            "/api/synthesize",
            {"text": "again.", "infer_mode": "批次推理", "saved_voice_identifier": voices[0]["id"]},
        )
        assert status == 200
        events = self._drain_sse(app, client, data["task_id"])
        assert events[-1]["status"] == "completed"
        assert engine.calls[-1][0] == "infer_fast"

    def test_missing_voice_400(self, server):
        client, _, _, _ = server
        status, data = client.multipart("/api/synthesize", {"text": "hi"})
        assert status == 400

    def test_overlong_prompt_400(self, server):
        """A reference upload past the duration cap answers a clean 400
        instead of featurizing a giant STFT (OOM guard)."""
        client, _, _, _ = server
        import io
        import wave as wave_mod

        buf = io.BytesIO()
        with wave_mod.open(buf, "wb") as w:  # 301 s of 8 kHz silence
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(b"\x00\x00" * (301 * 8000))
        status, data = client.multipart(
            "/api/synthesize", {"text": "hi"},
            files={"referenceAudioFile": ("long.wav", buf.getvalue())},
        )
        assert status == 400 and "too long" in data["error"]

    def test_empty_text_400(self, server):
        client, _, _, _ = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "   "},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 400 and "empty" in data["error"]

    def test_history_and_delete(self, server):
        client, engine, app, base = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "make history."},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        self._drain_sse(app, client, data["task_id"])
        status, items = client.json("GET", "/api/history-audios")
        assert status == 200 and len(items) == 1
        status, out = client.json("DELETE", "/api/delete-audio", {"filename": items[0]["name"]})
        assert status == 200
        status, items = client.json("GET", "/api/history-audios")
        assert items == []

    def test_engine_unavailable_503(self, tmp_path):
        client = Client(create_app(None, base_dir=str(tmp_path)))
        status, data = client.multipart("/api/synthesize", {"text": "x"})
        assert status == 503

    def test_non_wav_upload_without_decoder_415(self, server, monkeypatch):
        """mp3/ogg uploads need ffmpeg; without it the server answers a clear
        415, not a parse traceback (reference parity: webui.py:307-389
        accepts mp3 via torchaudio)."""
        import indextts_tpu_torch.utils.audio as audio_mod

        monkeypatch.setattr(audio_mod, "ffmpeg_available", lambda: False)
        client, _, _, _ = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "hi"},
            files={"referenceAudioFile": ("voice.mp3", b"\xff\xfb\x90\x00" + b"\x00" * 256)},
        )
        assert status == 415
        assert "ffmpeg" in data["error"]

    def test_non_wav_upload_with_decoder(self, server, tmp_path, monkeypatch):
        """With a decoder on PATH, non-wav uploads transcode and synthesize.
        Uses a stub ffmpeg executable that emits a valid wav, exercising the
        real subprocess plumbing."""
        import indextts_tpu_torch.utils.audio as audio_mod

        fixture = os.path.join(str(tmp_path), "fixture.wav")
        t = np.linspace(0, 0.2, 4800, endpoint=False)
        write_wav(fixture, (0.3 * np.sin(2 * np.pi * 220 * t) * 32767)[None, :], 24000)
        fake = os.path.join(str(tmp_path), "bin", "ffmpeg")
        os.makedirs(os.path.dirname(fake), exist_ok=True)
        with open(fake, "w") as f:
            f.write(f"#!/bin/sh\n# args: -y -v error -i <in> -f wav -acodec pcm_s16le <out>\ncp {fixture} \"${{10}}\"\n")
        os.chmod(fake, 0o755)
        monkeypatch.setenv("PATH", os.path.dirname(fake) + os.pathsep + os.environ["PATH"])

        client, engine, app, base = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "decode me."},
            files={"referenceAudioFile": ("voice.mp3", b"\xff\xfb\x90\x00" + b"\x00" * 256)},
        )
        assert status == 200, data
        events = self._drain_sse(app, client, data["task_id"])
        assert events[-1]["status"] == "completed"

    def test_delete_audio_traversal_blocked(self, server, tmp_path):
        """delete-audio must not follow ../ or absolute paths out of
        output_dir (the reference joins the raw name: advisory finding)."""
        client, _, _, base = server
        victim = os.path.join(base, "dont_delete_me.txt")
        with open(victim, "w") as f:
            f.write("payload")
        for name in (f"../../{os.path.basename(victim)}", victim, "../dont_delete_me.txt"):
            status, _ = client.json("DELETE", "/api/delete-audio", {"filename": name})
            assert status == 404, name
            assert os.path.exists(victim)

    def test_unknown_task_sse_terminates(self, server):
        """Polling an unknown task id must emit one terminal error event, not
        stream empty dicts forever."""
        client, _, app, _ = server
        status, headers, result = client.request("GET", "/api/synthesize-stream-status/no-such-task")
        events = list(result)  # must terminate on its own
        assert len(events) == 1
        assert json.loads(events[0].decode().split("data: ", 1)[1])["status"] == "error"

    def test_disconnect_preserves_result_for_reconnect(self, server):
        """A client that drops mid-processing must still be able to collect
        the completed result on reconnect (round-1 popped the task in the SSE
        finally block, destroying it on disconnect)."""
        client, engine, app, base = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "keep me."},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        task_id = data["task_id"]
        # simulate disconnect: open the SSE stream, read one event, close it
        _, _, result = client.request("GET", f"/api/synthesize-stream-status/{task_id}")
        next(iter(result))
        result.close() if hasattr(result, "close") else None
        # wait for the worker to finish, then reconnect and drain
        deadline = time.time() + 10
        while time.time() < deadline:
            if app._tasks_status.get(task_id, {}).get("status") in ("completed", "failed"):
                break
            time.sleep(0.05)
        assert app._tasks_status.get(task_id, {}).get("status") == "completed"
        final = self._drain_sse(app, client, task_id)[-1]
        assert final.get("status") == "completed" and final.get("audio_url")


class TestStatic:
    def test_index_served(self, tmp_path):
        # use the repo root so the real template is found
        client = Client(create_app(FakeEngine(), base_dir=REPO))
        status, headers, result = client.request("GET", "/")
        assert status == 200
        body = b"".join(result)
        assert b"IndexTTS" in body

    def test_static_js_served(self):
        client = Client(create_app(FakeEngine(), base_dir=REPO))
        status, headers, result = client.request("GET", "/static/js/script.js")
        assert status == 200
        assert "javascript" in headers["Content-Type"]

    def test_static_traversal_blocked(self):
        client = Client(create_app(FakeEngine(), base_dir=REPO))
        status, headers, result = client.request("GET", "/static/../SURVEY.md")
        assert status == 404


class TestAudioStreaming:
    def test_synthesize_stream_returns_progressive_wav(self, server):
        client, engine, app, base = server

        # fake engine gains a streaming generator
        def fake_stream(prompt_mel, text, **kw):
            engine.calls.append(("infer_stream", text, kw))
            for _ in range(3):
                yield np.zeros(800, np.float32)

        engine.infer_stream = fake_stream
        status, headers, result = client.request(
            "POST",
            "/api/synthesize-stream",
            *_multipart_body({"text": "stream me."}, {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 200
        assert headers["Content-Type"] == "audio/wav"
        chunks = [bytes(c) for c in result]
        assert chunks[0].startswith(b"RIFF")
        total_pcm = sum(len(c) for c in chunks[1:])
        assert total_pcm == 3 * 800 * 2  # 3 chunks of int16 PCM
        assert engine.calls[-1][0] == "infer_stream"

    def test_stream_applies_replacements(self, server):
        """The SPA streaming mode sends the active ruleset; the stream
        endpoint must apply it with the same regex semantics as
        /api/synthesize (webui.py:348-353)."""
        client, engine, app, base = server

        def fake_stream(prompt_mel, text, **kw):
            engine.calls.append(("infer_stream", text, kw))
            yield np.zeros(8, np.float32)

        engine.infer_stream = fake_stream
        import json as _json

        status, headers, result = client.request(
            "POST",
            "/api/synthesize-stream",
            *_multipart_body(
                {"text": "hello WORLD", "replacements": _json.dumps([
                    {"original": "WORLD", "replacement": "THERE"}
                ])},
                {"referenceAudioFile": ("p.wav", _wav_bytes())},
            ),
        )
        assert status == 200
        list(result)  # drain
        assert engine.calls[-1][1] == "hello THERE"

    def test_stream_honors_crop_bounds(self, server):
        """The stream route shares /api/synthesize's upload pipeline
        (_upload_to_mel): crop bounds apply, malformed crops 400 instead of
        being silently ignored (the pre-fix drifted copy dropped them)."""
        client, engine, app, base = server
        seen = []

        def fake_stream(prompt_mel, text, **kw):
            seen.append(np.asarray(prompt_mel).shape)
            yield np.zeros(8, np.float32)

        engine.infer_stream = fake_stream
        status, _, _ = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "hi", "cropStart": "-1"},
                             {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 400
        status, _, result = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "hi", "cropStart": "0.0", "cropEnd": "0.05"},
                             {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 200
        list(result)
        full_status, _, full_result = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "hi"},
                             {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        list(full_result)
        assert len(seen) == 2
        assert seen[0][-1] < seen[1][-1]  # cropped prompt has fewer frames

    def test_stream_requires_voice(self, server):
        client, engine, app, base = server
        status, data = client.multipart("/api/synthesize-stream", {"text": "hi"})
        assert status == 400

    def test_stream_requires_text(self, server):
        client, engine, app, base = server
        status, data = client.multipart(
            "/api/synthesize-stream", {"text": "  "}, files={"referenceAudioFile": ("p.wav", _wav_bytes())}
        )
        assert status == 400


def _multipart_body(fields, files=None):
    boundary = "testboundary123"
    parts = []
    for k, v in fields.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
        )
    for k, (fname, data) in (files or {}).items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{fname}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n"
        )
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class BatchFakeEngine(FakeEngine):
    def infer_batch(self, items, output_paths=None, **kw):
        self.calls.append(("infer_batch", [t for _, t in items], kw))
        if self.callback:
            self.callback(0.5, "batched halfway")
        for p in output_paths:
            write_wav(p, np.zeros((1, 2400), np.int16), 24000)
        return output_paths


class TestContinuousBatching:
    """batch_requests > 1: concurrent same-parameter tasks merge into ONE
    engine.infer_batch call; mixed-parameter tasks stay separate."""

    def _submit(self, client, text, extra=None):
        fields = {"text": text, "infer_mode": "普通推理"}
        fields.update(extra or {})
        status, data = client.multipart(
            "/api/synthesize", fields,
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200, data
        return data["task_id"]

    def _wait(self, app, ids, timeout=10.0):
        start = time.time()
        while time.time() - start < timeout:
            st = {i: app._tasks_status.get(i, {}).get("status") for i in ids}
            if all(s in ("completed", "failed") for s in st.values()):
                return st
            time.sleep(0.02)
        return {i: app._tasks_status.get(i, {}).get("status") for i in ids}

    def test_two_requests_merge(self, tmp_path):
        engine = BatchFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.6)  # wide: 2nd submit runs mel extraction first
        client = Client(app)
        ids = [self._submit(client, "first one."), self._submit(client, "second one.")]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        batch_calls = [c for c in engine.calls if c[0] == "infer_batch"]
        assert len(batch_calls) == 1
        assert sorted(batch_calls[0][1]) == ["first one.", "second one."]
        # verbose rides through to infer_batch (default verbose_tts=true)
        assert batch_calls[0][2]["verbose"] is True
        # decode bucket must cover the configured wave size or a full wave
        # decodes in slices of 8 and loses the weight-stream amortization
        assert batch_calls[0][2]["sentences_bucket_max_size"] >= 8
        for i in ids:
            assert app._tasks_status[i]["audio_url"].startswith("/static/outputs/")

    def test_dynamic_params_merge_per_request(self, tmp_path):
        """Different SAMPLING knobs still merge — they ride the decode as
        per-row traced vectors (engine.BATCH_DYNAMIC_PARAMS)."""
        engine = BatchFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.6)  # wide: 2nd submit runs mel extraction first
        client = Client(app)
        ids = [
            self._submit(client, "cool one.", {"temperature": "0.7"}),
            self._submit(client, "hot one.", {"temperature": "1.3"}),
        ]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        batch_calls = [c for c in engine.calls if c[0] == "infer_batch"]
        assert len(batch_calls) == 1
        prk = batch_calls[0][2]["per_request_kwargs"]
        assert sorted(d["temperature"] for d in prk) == [0.7, 1.3]

    def test_static_params_do_not_merge(self, tmp_path):
        """top_k is static (shape/trace: GenerationConfig) -> no merge."""
        engine = BatchFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.6)  # wide: 2nd submit runs mel extraction first
        client = Client(app)
        ids = [
            self._submit(client, "narrow one.", {"top_k": "5"}),
            self._submit(client, "wide one.", {"top_k": "50"}),
        ]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        assert not [c for c in engine.calls if c[0] == "infer_batch"]
        assert len([c for c in engine.calls if c[0] == "infer"]) == 2

    def test_single_request_uses_solo_path(self, tmp_path):
        engine = BatchFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.05)
        client = Client(app)
        tid = self._submit(client, "alone.")
        st = self._wait(app, [tid])
        assert st[tid] == "completed"
        assert engine.calls[-1][0] == "infer"  # solo fallback, exact legacy path

    def test_same_prefix_texts_get_distinct_files(self, tmp_path):
        """Two batched requests whose texts share the 10-char filename prefix
        must not overwrite each other within one batch."""
        engine = BatchFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.6)  # wide: 2nd submit runs mel extraction first
        client = Client(app)
        ids = [self._submit(client, "SAME PREFIX ONE."), self._submit(client, "SAME PREFIX TWO.")]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        urls = {app._tasks_status[i]["audio_url"] for i in ids}
        assert len(urls) == 2, urls

    def test_dispatcher_survives_engine_failure(self, tmp_path):
        """A batch that raises marks its tasks failed but must NOT kill the
        dispatcher thread — the next request still completes."""

        class FlakyEngine(BatchFakeEngine):
            def __init__(self):
                super().__init__()
                self.boom = True

            def infer_batch(self, items, output_paths=None, **kw):
                if self.boom:
                    self.boom = False
                    raise RuntimeError("synthetic batch failure")
                return super().infer_batch(items, output_paths=output_paths, **kw)

        engine = FlakyEngine()
        app = create_app(engine, base_dir=str(tmp_path), batch_requests=4,
                         batch_window_s=0.6)
        client = Client(app)
        ids = [self._submit(client, "boom one."), self._submit(client, "boom two.")]
        st = self._wait(app, ids)
        assert all(s == "failed" for s in st.values()), st
        assert "synthetic batch failure" in app._tasks_status[ids[0]]["message"]
        # dispatcher still alive: a fresh pair completes normally
        ids2 = [self._submit(client, "retry one."), self._submit(client, "retry two.")]
        st2 = self._wait(app, ids2)
        assert all(s == "completed" for s in st2.values()), st2


class TestReplacements:
    def test_text_deleting_rule_400s_on_both_endpoints(self, server):
        """A ruleset that empties the text must yield a clean 400 — on the
        stream endpoint BEFORE any 200/RIFF bytes go out (review finding)."""
        client, _, _, _ = server
        rules = json.dumps([{"original": ".*", "replacement": ""}])
        status, data = client.multipart(
            "/api/synthesize", {"text": "hello", "replacements": rules},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 400 and "empty" in data["error"]
        status, data = client.multipart(
            "/api/synthesize-stream", {"text": "hello", "replacements": rules},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 400 and "empty" in data["error"]

    def test_bad_regex_does_not_500(self, server):
        client, engine, app, _ = server
        rules = json.dumps([{"original": "[", "replacement": "x"}])
        status, data = client.multipart(
            "/api/synthesize", {"text": "keep me.", "replacements": rules},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200, data


class TestWSGIProtocol:
    """Protocol-layer regressions in the stdlib WSGI shim (review findings)."""

    def _parse(self, fields, files=None, content_length=None, body=None):
        from indextts_tpu_torch.server.wsgi import Request

        if body is None:
            body, ctype = _multipart_body(fields, files)
        else:
            ctype = f"multipart/form-data; boundary=testboundary123"
        environ = {
            "REQUEST_METHOD": "POST", "PATH_INFO": "/x", "QUERY_STRING": "",
            "CONTENT_TYPE": ctype,
            "CONTENT_LENGTH": str(len(body) if content_length is None else content_length),
            "wsgi.input": io.BytesIO(body),
        }
        return Request(environ)

    def test_multipart_preserves_trailing_crlf_bytes(self):
        """File data whose final bytes are 0x0D/0x0A must survive parsing
        byte-exact — a character-class strip(b'\\r\\n') eats them (a WAV whose
        last PCM samples look like newlines would be silently truncated)."""
        for payload in (b"DATA\x0a", b"DATA\x0d", b"DATA\x0d\x0a\x0a",
                        b"\x0aDATA", b"DATA\r\n\r\n", b"\r\nDATA\r\n"):
            req = self._parse({"k": "v"}, {"f": ("a.wav", payload)})
            assert req.files["f"][1] == payload, payload
            assert req.form["k"] == "v"

    def test_negative_content_length_reads_nothing(self):
        """'Content-Length: -1' must not become read(-1) (unbounded
        read-until-EOF on the raw socket, bypassing MAX_BODY_BYTES)."""
        from indextts_tpu_torch.server.wsgi import Request

        class Guard:
            def read(self, n=-1):
                assert n > 0, f"unbounded/empty read({n}) reached wsgi.input"
                return b"x" * n

        environ = {
            "REQUEST_METHOD": "POST", "PATH_INFO": "/x", "QUERY_STRING": "",
            "CONTENT_TYPE": "multipart/form-data; boundary=b",
            "CONTENT_LENGTH": "-1", "wsgi.input": Guard(),
        }
        req = Request(environ)
        assert req.body == b"" and not req.too_large

    def test_empty_file_input_treated_as_absent(self, server):
        """An unselected browser <input type=file> (filename="", empty body)
        must behave like no upload: 400 'reference audio required', and it
        must NOT clear another user's pending save-voice feature cache."""
        client, _, app, _ = server
        app._temp_features_cache["upload:other-user"] = {"cond_mel_numpy": np.zeros((1, 2, 2))}
        status, data = client.multipart(
            "/api/synthesize", {"text": "hi"},
            files={"referenceAudioFile": ("", b"")},
        )
        assert status == 400 and "required" in data["error"]
        assert "upload:other-user" in app._temp_features_cache

    def test_empty_max_text_tokens_uses_default(self, server):
        """A cleared number input submits ""; the server must fall back to
        the default (100) like every param_map knob, not fail the task with
        int('')."""
        client, engine, app, _ = server
        status, data = client.multipart(
            "/api/synthesize", {"text": "default me.", "max_text_tokens_per_sentence": ""},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200
        tid = data["task_id"]
        deadline = time.time() + 10
        while time.time() < deadline:
            if app._tasks_status.get(tid, {}).get("status") in ("completed", "failed"):
                break
            time.sleep(0.02)
        assert app._tasks_status[tid]["status"] == "completed"
        assert engine.calls[-1][2]["max_text_tokens_per_sentence"] == 100

    def test_invalid_crop_values_400(self, server, tmp_path):
        client, _, app, base = server
        temp_dir = os.path.join(base, "static", "temp_audio")
        # "abc" (ValueError), "1e999" (OverflowError at int(inf)), and
        # negative values must all 400 with the temp upload cleaned up
        for bad in ("abc", "1e999", "-5"):
            status, data = client.multipart(
                "/api/synthesize", {"text": "hello", "cropStart": bad},
                files={"referenceAudioFile": ("p.wav", _wav_bytes())},
            )
            assert status == 400 and "crop" in data["error"], bad
            assert os.listdir(temp_dir) == [], bad


class TestMultipartFuzz:
    def test_round_trip_random_bytes(self):
        """Property: any (field, file) combination the test encoder can
        build must parse back byte-exact — file payloads drawn to include
        CR/LF/boundary-ish bytes at the edges (the framing hazard class)."""
        import random

        from indextts_tpu_torch.server.wsgi import Request

        rng = random.Random(7)
        edge = [b"", b"\r", b"\n", b"\r\n", b"\n\r", b"\r\n\r\n", b"--", b"--test"]
        for trial in range(40):
            fields = {f"f{i}": f"v{i}-{rng.randint(0, 999)}" for i in range(rng.randint(0, 3))}
            files = {}
            for i in range(rng.randint(0, 2)):
                core = bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 64)))
                data = rng.choice(edge) + core + rng.choice(edge)
                files[f"u{i}"] = (f"n{i}.bin", data)
            body, ctype = _multipart_body(fields, files)
            environ = {
                "REQUEST_METHOD": "POST", "PATH_INFO": "/x", "QUERY_STRING": "",
                "CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body)),
                "wsgi.input": io.BytesIO(body),
            }
            req = Request(environ)
            assert req.form == fields, (trial, req.form, fields)
            for k, (fname, data) in files.items():
                assert req.files.get(k) == (fname, data), (trial, k)


class TestConcurrentTraffic:
    def test_mixed_concurrent_requests_no_500s(self, server):
        """ThreadingWSGIServer semantics: synthesize / history / rulesets /
        delete hammered concurrently must never 500 (races between listdir
        and delete, task-status reaping, ruleset CRUD)."""
        client, engine, app, _ = server
        errors = []

        def worker(i):
            try:
                for j in range(4):
                    status, data = client.multipart(
                        "/api/synthesize", {"text": f"thread {i} item {j}."},
                        files={"referenceAudioFile": ("p.wav", _wav_bytes())},
                    )
                    if status != 200:
                        errors.append(("synthesize", status, data))
                    client.json("GET", "/api/history-audios")
                    client.json("POST", "/api/rulesets",
                                {"name": f"r{i}", "rules": [{"original": "a", "replacement": "b"}]})
                    client.json("GET", "/api/rulesets")
                    client.json("DELETE", f"/api/rulesets/r{i}")
                    st, items = client.json("GET", "/api/history-audios")
                    for item in (items or [])[:1]:
                        client.json("DELETE", "/api/delete-audio", {"filename": item["name"]})
            except Exception as e:  # any traceback is a failure
                errors.append(("exception", repr(e)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:5]
        # every submitted task reaches a terminal state
        deadline = time.time() + 20
        while time.time() < deadline:
            states = {v.get("status") for v in app._tasks_status.values()}
            if states <= {"completed", "failed"}:
                break
            time.sleep(0.05)
        assert {v.get("status") for v in app._tasks_status.values()} <= {"completed", "failed"}


class TestTaskLifecycle:
    def test_queued_tasks_survive_ttl_reap(self, server):
        """A task still waiting on a deep backlog ('queued' for > ttl_any)
        must not be reaped — its synthesis WILL run, and popping the entry
        strands the result (clients get 'unknown task id')."""
        client, engine, app, _ = server
        old = time.time() - 3 * 7200
        app._tasks_status["stale-queued"] = {
            "status": "queued", "progress": 0, "message": "m", "created_at": old}
        app._tasks_status["stale-done"] = {
            "status": "completed", "progress": 100, "message": "m",
            "created_at": old, "finished_at": old}
        # any synthesize triggers _reap_stale_tasks
        status, data = client.multipart(
            "/api/synthesize", {"text": "trigger reap."},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200
        assert "stale-queued" in app._tasks_status
        assert "stale-done" not in app._tasks_status

    def test_same_text_sequential_requests_distinct_outputs(self, server):
        """Two requests sharing text+voice must write distinct files — the
        second must not overwrite audio the first user is about to download
        (cross-request collision, not just within-batch)."""
        client, engine, app, _ = server
        urls = []
        for _ in range(2):
            status, data = client.multipart(
                "/api/synthesize", {"text": "identical words."},
                files={"referenceAudioFile": ("p.wav", _wav_bytes())},
            )
            tid = data["task_id"]
            deadline = time.time() + 10
            while time.time() < deadline:
                st = app._tasks_status.get(tid, {})
                if st.get("status") in ("completed", "failed"):
                    break
                time.sleep(0.02)
            assert st.get("status") == "completed"
            urls.append(st["audio_url"])
        assert urls[0] != urls[1]

    def test_slow_stream_client_does_not_block_other_synthesis(self, server):
        """The streaming route must not hold worker_lock across client
        socket writes: with a stalled stream consumer (header read, then
        nothing), a normal /api/synthesize must still complete."""
        client, engine, app, _ = server

        def fake_stream(prompt_mel, text, **kw):
            for _ in range(3):
                yield np.zeros(800, np.float32)

        engine.infer_stream = fake_stream
        status, headers, result = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "stall me."}, {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 200
        it = iter(result)
        assert next(it).startswith(b"RIFF")  # header out; consumer now stalls
        # worker must be free for the next job even though the stream client
        # never drains its remaining chunks
        status, data = client.multipart(
            "/api/synthesize", {"text": "unblocked."},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        tid = data["task_id"]
        deadline = time.time() + 10
        while time.time() < deadline:
            if app._tasks_status.get(tid, {}).get("status") in ("completed", "failed"):
                break
            time.sleep(0.02)
        assert app._tasks_status.get(tid, {}).get("status") == "completed"


class TestBodyLimit:
    def test_oversized_body_413(self, server, monkeypatch):
        """A hostile Content-Length must not be read into memory (OOM DoS);
        the server answers 413 without touching wsgi.input."""
        import indextts_tpu_torch.server.wsgi as wsgi

        client, _, app, _ = server

        class Bomb:
            def read(self, n):  # pragma: no cover - must never be called
                raise AssertionError("oversized body was read")

        environ = {
            "REQUEST_METHOD": "POST", "PATH_INFO": "/api/synthesize",
            "QUERY_STRING": "", "CONTENT_TYPE": "multipart/form-data; boundary=x",
            "CONTENT_LENGTH": str(wsgi.MAX_BODY_BYTES + 1), "wsgi.input": Bomb(),
        }
        captured = {}

        def start_response(status, headers):
            captured["status"] = int(status.split()[0])

        body = b"".join(app(environ, start_response))
        assert captured["status"] == 413
        assert b"too large" in body

    def test_oversized_json_body_413(self, server):
        """The cap must apply to JSON bodies too — the lazy body read used
        to leave too_large unset for non-form content types, turning the
        413 into a misleading 400 downstream."""
        import indextts_tpu_torch.server.wsgi as wsgi

        client, _, app, _ = server

        class Bomb:
            def read(self, n=-1):  # pragma: no cover - must never be called
                raise AssertionError("oversized body was read")

        environ = {
            "REQUEST_METHOD": "DELETE", "PATH_INFO": "/api/delete-audio",
            "QUERY_STRING": "", "CONTENT_TYPE": "application/json",
            "CONTENT_LENGTH": str(wsgi.MAX_BODY_BYTES + 1), "wsgi.input": Bomb(),
        }
        captured = {}
        body = b"".join(app(environ, lambda s, h: captured.update(status=int(s.split()[0]))))
        assert captured["status"] == 413

    def test_non_utf8_urlencoded_body_is_clean_error(self, server):
        """A non-UTF-8 urlencoded body must produce an app-level JSON error,
        not a UnicodeDecodeError escaping to wsgiref's plain-text page."""
        client, _, _, _ = server
        status, headers, result = client.request(
            "POST", "/api/synthesize", b"\xff\xfe\x00text=x",
            "application/x-www-form-urlencoded",
        )
        assert status in (400, 415)
        assert headers["Content-Type"].startswith("application/json")

    def test_task_status_route(self, server):
        client, engine, app, _ = server
        status, data = client.json("GET", "/api/task-status/nope")
        assert status == 404
        status, data = client.multipart(
            "/api/synthesize", {"text": "status probe."},
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        tid = data["task_id"]
        deadline = time.time() + 10
        while time.time() < deadline:
            status, st = client.json("GET", f"/api/task-status/{tid}")
            assert status == 200
            if st["status"] in ("completed", "failed"):
                break
            time.sleep(0.02)
        assert st["status"] == "completed"
        assert "files_to_delete" not in st


class SlotFakeSession:
    """Deterministic fake SlotSession: every submitted request completes on
    its second tick (exercises the dispatcher's submit/tick/harvest loop
    without a real decode)."""

    def __init__(self, engine, **kw):
        self.engine = engine
        self.kw = kw
        self.pending = {}
        self._next = 0
        self.fail_ticks = False

    def submit(self, prompt, text, output_path=None, on_chunk=None, **dyn):
        if not text.strip():
            raise ValueError("text is empty")
        rid = self._next
        self._next += 1
        self.engine.calls.append(("slot_submit", text, dict(self.kw), dyn))
        self.pending[rid] = [output_path, 0, on_chunk]
        return rid

    @property
    def busy(self):
        return bool(self.pending)

    def tick(self):
        if self.fail_ticks:
            raise RuntimeError("synthetic slot failure")
        if self.engine.gate is not None and not self.engine.gate.is_set():
            return []  # held busy until the test releases the gate
        done = []
        for rid, ent in list(self.pending.items()):
            ent[1] += 1
            if ent[2] is not None:  # streaming request: one chunk per tick
                ent[2](rid, np.full((16,), 7, np.int16))
            if ent[1] >= 2:
                if ent[0] is not None:
                    write_wav(ent[0], np.zeros((1, 2400), np.int16), 24000)
                done.append((rid, ent[0]))
                self.pending.pop(rid)
        return done


class SlotFakeEngine(BatchFakeEngine):
    # inherits infer_batch: slot-mode servers route beam jobs through the
    # gather-window batch lane, so the fake needs the batched entry point too
    def __init__(self):
        super().__init__()
        self.sessions = []
        self.poison_next = False
        self.gate = None  # threading.Event: sessions stay busy until set

    def slot_session(self, **kw):
        s = SlotFakeSession(self, **kw)
        s.fail_ticks = self.poison_next
        self.poison_next = False
        self.sessions.append(s)
        return s


class TestSlotBatching:
    """slot_requests > 0: the rolling-admission dispatcher. Jobs route to a
    per-static-signature SlotSession; beams and overflow signatures fall
    back to the solo worker; a poisoned session fails its jobs loudly and
    the next job rebuilds it."""

    def _submit(self, client, text, extra=None):
        fields = {"text": text, "infer_mode": "普通推理", "num_beams": "1"}
        fields.update(extra or {})
        status, data = client.multipart(
            "/api/synthesize", fields,
            files={"referenceAudioFile": ("p.wav", _wav_bytes())},
        )
        assert status == 200, data
        return data["task_id"]

    def _wait(self, app, ids, timeout=10.0):
        start = time.time()
        while time.time() - start < timeout:
            st = {i: app._tasks_status.get(i, {}).get("status") for i in ids}
            if all(s in ("completed", "failed") for s in st.values()):
                return st
            time.sleep(0.02)
        return {i: app._tasks_status.get(i, {}).get("status") for i in ids}

    def test_mutually_exclusive_with_batch_requests(self, tmp_path):
        with pytest.raises(ValueError, match="mutually exclusive"):
            create_app(SlotFakeEngine(), base_dir=str(tmp_path),
                       batch_requests=4, slot_requests=2)

    def test_requests_share_one_session(self, tmp_path):
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        ids = [self._submit(client, "slot one."), self._submit(client, "slot two.")]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        assert len(engine.sessions) == 1
        assert engine.sessions[0].kw["n_slots"] == 4
        texts = sorted(c[1] for c in engine.calls if c[0] == "slot_submit")
        assert texts == ["slot one.", "slot two."]
        for i in ids:
            assert app._tasks_status[i]["audio_url"].startswith("/static/outputs/")

    def test_lone_beam_job_runs_solo(self, tmp_path):
        """A single beam request in slot mode rides the beam batch lane; a
        wave of one falls through to the solo worker (identical behavior)."""
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        tid = self._submit(client, "beam job.", {"num_beams": "3"})
        st = self._wait(app, [tid])
        assert st[tid] == "completed"
        assert engine.sessions == []
        assert [c[0] for c in engine.calls] == ["infer"]

    def test_concurrent_beam_jobs_merge_into_batched_decode(self, tmp_path):
        """Composed dispatchers: DEFAULT-quality requests (num_beams=3, the
        web form default matching ref infer.py:122) on a --slot-batching
        server must merge into ONE engine.infer_batch call with the same
        wave semantics as a --batch-requests 8 server — NOT serialize
        through the solo worker (round-3 verdict Weak #2)."""
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=8,
                         batch_window_s=0.6)  # wide gather: all 8 in one wave
        client = Client(app)
        ids = [self._submit(client, f"beam wave item {i}.", {"num_beams": "3"})
               for i in range(8)]
        st = self._wait(app, ids, timeout=20.0)
        assert all(s == "completed" for s in st.values()), st
        assert engine.sessions == []  # beams never touch slot sessions
        batch_calls = [c for c in engine.calls if c[0] == "infer_batch"]
        assert len(batch_calls) == 1, engine.calls
        assert sorted(batch_calls[0][1]) == sorted(
            f"beam wave item {i}." for i in range(8))
        # identical decode-bucket semantics to a --batch-requests 8 server
        assert batch_calls[0][2]["sentences_bucket_max_size"] >= 8
        assert batch_calls[0][2]["num_beams"] == 3
        assert not [c for c in engine.calls if c[0] == "infer"]

    def test_beam_and_slot_jobs_coexist(self, tmp_path):
        """Mixed traffic: greedy jobs ride slot sessions while beam jobs ride
        the batch lane, in the same server, all completing."""
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4,
                         batch_window_s=0.4)
        client = Client(app)
        ids = [
            self._submit(client, "greedy one."),
            self._submit(client, "beamy one.", {"num_beams": "3"}),
            self._submit(client, "greedy two."),
            self._submit(client, "beamy two.", {"num_beams": "3"}),
        ]
        st = self._wait(app, ids, timeout=20.0)
        assert all(s == "completed" for s in st.values()), st
        slot_texts = sorted(c[1] for c in engine.calls if c[0] == "slot_submit")
        assert slot_texts == ["greedy one.", "greedy two."]
        batch_calls = [c for c in engine.calls if c[0] == "infer_batch"]
        assert len(batch_calls) == 1
        assert sorted(batch_calls[0][1]) == ["beamy one.", "beamy two."]

    def test_third_signature_solo_while_both_sessions_busy(self, tmp_path):
        engine = SlotFakeEngine()
        engine.gate = threading.Event()  # hold every session mid-decode
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        ida = self._submit(client, "sig a.", {"top_k": "5"})
        idb = self._submit(client, "sig b.", {"top_k": "50"})
        start = time.time()
        while time.time() - start < 10 and len(engine.sessions) < 2:
            time.sleep(0.02)
        assert len(engine.sessions) == 2
        # 3rd signature with both sessions busy -> solo worker, no eviction
        idc = self._submit(client, "sig c.", {"top_k": "99"})
        st = self._wait(app, [idc])
        assert st[idc] == "completed", st
        assert len([c for c in engine.calls if c[0] == "infer"]) == 1
        assert len(engine.sessions) == 2
        engine.gate.set()
        st = self._wait(app, [ida, idb])
        assert all(s == "completed" for s in st.values()), st

    def test_idle_session_evicted_for_new_signature(self, tmp_path):
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        ida = self._submit(client, "sig a.", {"top_k": "5"})
        idb = self._submit(client, "sig b.", {"top_k": "50"})
        st = self._wait(app, [ida, idb])
        assert all(s == "completed" for s in st.values()), st
        # both sessions idle: a third signature evicts one instead of
        # falling back to the solo worker
        idc = self._submit(client, "sig c.", {"top_k": "99"})
        st = self._wait(app, [idc])
        assert st[idc] == "completed", st
        assert len(engine.sessions) == 3  # a fresh session was built
        assert not [c for c in engine.calls if c[0] == "infer"]

    def test_dynamic_knobs_ride_per_request(self, tmp_path):
        engine = SlotFakeEngine()
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        ids = [
            self._submit(client, "cool.", {"temperature": "0.7"}),
            self._submit(client, "hot.", {"temperature": "1.3"}),
        ]
        st = self._wait(app, ids)
        assert all(s == "completed" for s in st.values()), st
        assert len(engine.sessions) == 1
        temps = sorted(c[3]["temperature"] for c in engine.calls
                       if c[0] == "slot_submit")
        assert temps == [0.7, 1.3]

    def test_stream_rides_slot_batch(self, tmp_path):
        """/api/synthesize-stream under --slot-batching on a fast_latents
        engine: the chunked response is fed by the SlotSession's on_chunk
        callback (rolling admission) instead of the solo infer_stream."""
        engine = SlotFakeEngine()
        engine.fast_latents = True
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        status, headers, result = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "stream me."},
                             {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 200
        assert headers["Content-Type"] == "audio/wav"
        chunks = [bytes(c) for c in result]
        assert chunks[0].startswith(b"RIFF")
        total_pcm = sum(len(c) for c in chunks[1:])
        assert total_pcm == 2 * 16 * 2  # two fake 16-sample int16 chunks
        assert any(c[0] == "slot_submit" for c in engine.calls)
        assert not any(c[0] == "infer_stream" for c in engine.calls)

    def test_stream_solo_fallback_when_sessions_busy(self, tmp_path):
        """A streaming job that cannot be placed (both sessions busy with
        other signatures) falls back to the route's solo infer_stream."""
        engine = SlotFakeEngine()
        engine.fast_latents = True
        engine.gate = threading.Event()  # hold sessions busy

        def fake_stream(prompt_mel, text, **kw):
            engine.calls.append(("infer_stream", text, kw))
            yield np.zeros(8, np.float32)

        engine.infer_stream = fake_stream
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        ida = self._submit(client, "sig a.", {"top_k": "5"})
        idb = self._submit(client, "sig b.", {"top_k": "50"})
        start = time.time()
        while time.time() - start < 10 and len(engine.sessions) < 2:
            time.sleep(0.02)
        assert len(engine.sessions) == 2
        status, headers, result = client.request(
            "POST", "/api/synthesize-stream",
            *_multipart_body({"text": "stream me.", "top_k": "99"},
                             {"referenceAudioFile": ("p.wav", _wav_bytes())}),
        )
        assert status == 200
        list(result)  # drain the chunked body
        assert any(c[0] == "infer_stream" for c in engine.calls)
        engine.gate.set()
        self._wait(app, [ida, idb])

    def test_poisoned_session_fails_jobs_and_recovers(self, tmp_path):
        engine = SlotFakeEngine()
        engine.poison_next = True  # first session fails every tick
        app = create_app(engine, base_dir=str(tmp_path), slot_requests=4)
        client = Client(app)
        tid1 = self._submit(client, "will fail.")
        st = self._wait(app, [tid1])
        assert st[tid1] == "failed"
        # the next job must get a FRESH session and complete
        tid2 = self._submit(client, "after recovery.")
        st = self._wait(app, [tid2])
        assert st[tid2] == "completed", st
        assert len(engine.sessions) == 2


# ---------------------------------------------------------------------------
# the port's own: its copies pinned, a real engine, main's arguments
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")

# the edits that make the JAX package's webui.py the port's: its imports, and
# main's argument list and engine construction (no --tp: multi-GPU is not
# ported; no --compile-cache: an XLA cache; -d/--device as the port's CLI)
WEBUI_EDITS = [
    ("from indextts_tpu.server.wsgi import", "from indextts_tpu_torch.server.wsgi import"),
    ("from indextts_tpu.utils.audio import", "from indextts_tpu_torch.utils.audio import"),
    ("from indextts_tpu.utils.mel import", "from indextts_tpu_torch.utils.mel import"),
    ("from indextts_tpu.serving import", "from indextts_tpu_torch.serving import"),
    ('argparse.ArgumentParser(description="indextts-tpu web server")',
     'argparse.ArgumentParser(description="indextts-tpu-torch web server (PyTorch engine)")'),
    ('help="serve with random weights (demo/testing)")\n',
     'help="serve with random weights (demo/testing)")\n'
     '    parser.add_argument("-d", "--device", default="cuda", help="torch device (default cuda)")\n'),
    ("""        help="tensor-parallel degree over the TPU mesh (default: all visible "
        "chips on the model axis when more than one is present; ignored "
        "single-chip)",
    )
    parser.add_argument(
        "--compile-cache", type=str, default=None, metavar="DIR",
        help="persistent XLA compile cache directory (also env "
        "INDEXTTS_COMPILE_CACHE): with --warmup, a restarted server reaches "
        "steady state in seconds instead of recompiling for minutes",
    )
""", """        help="tensor-parallel degree over the ranks of a torchrun launch "
        "(default 2 when the world is even; one process ignores it): rank 0 "
        "binds HTTP and the other ranks replay its engine calls",
    )
"""),
    ("from indextts_tpu.engine import IndexTTS", "from indextts_tpu_torch.engine import IndexTTS"),
    ("cfg_path=args.config, model_dir=args.model_dir,\n",
     "cfg_path=args.config, model_dir=args.model_dir, device=args.device,\n"),
    ("            tp=args.tp, compile_cache_dir=args.compile_cache,\n", "            tp=args.tp,\n"),
    ('print("Successfully initialized IndexTTS TPU engine.")',
     'print(f"Successfully initialized IndexTTS PyTorch engine on {args.device}.")'),
    # on a mesh (--tp under torchrun) rank 0 serves through the proxy and the
    # other ranks follow it (server/mesh_proxy.py)
    ("""        traceback.print_exc()

    if args.warmup and engine is not None:""", """        traceback.print_exc()

    if getattr(engine, "mesh", None) is not None:
        from indextts_tpu_torch.server.mesh_proxy import EngineProxy, follow

        if engine.mesh.rank != 0:
            follow(engine)  # until rank 0's server shuts down
            return
        engine = EngineProxy(engine)

    if args.warmup and engine is not None:"""),
    ("""    finally:
        app.shutdown()
""", """    finally:
        app.shutdown()
        if hasattr(engine, "stop"):  # the mesh's followers end with the server
            engine.stop()
"""),
]


def _read(*parts):
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


def test_server_modules_are_copies_of_jax():
    """wsgi.py is the JAX package's text; webui.py is too, but for the edits
    above, each made exactly once."""
    assert _read("indextts_tpu_torch", "server", "wsgi.py") == _read("indextts_tpu", "server", "wsgi.py")
    text = _read("indextts_tpu", "server", "webui.py")
    for old, new in WEBUI_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert _read("indextts_tpu_torch", "server", "webui.py") == text


def test_tiny_port_engine_behind_the_app(engines, tmp_path):
    """A greedy /api/synthesize on a tiny port engine completes, and its wav
    file is the one engine.infer writes for the same prompt and text."""
    _, te, _ = engines
    app = create_app(te, base_dir=str(tmp_path / "www"))
    client = Client(app)
    form = {"text": "HELLO WORLD.", "do_sample": "false", "num_beams": "1", "max_mel_tokens": "16",
            "repetition_penalty": "1.0", "max_text_tokens_per_sentence": "100"}
    with open(PROMPT, "rb") as f:
        prompt = f.read()
    status, body = client.multipart("/api/synthesize", form, {"referenceAudioFile": ("prompt.wav", prompt)})
    assert status == 200, body
    tid = body["task_id"]
    start = time.time()
    while time.time() - start < 120:
        st = app._tasks_status[tid]["status"]
        if st in ("completed", "failed"):
            break
        time.sleep(0.05)
    entry = app._tasks_status[tid]
    assert entry["status"] == "completed", entry
    served = os.path.join(str(tmp_path / "www"), entry["audio_url"].lstrip("/"))
    want = str(tmp_path / "direct.wav")
    te.infer(audio_prompt=PROMPT, text="HELLO WORLD.", output_path=want, do_sample=False, num_beams=1,
             max_mel_tokens=16, repetition_penalty=1.0, max_text_tokens_per_sentence=100)
    with open(served, "rb") as a, open(want, "rb") as b:
        got, ref = a.read(), b.read()
    assert len(ref) > 44 + 2 * 3 * te._samples_per_code() and got == ref


def test_main_arguments(monkeypatch, tmp_path):
    """--batch-requests with --slot-batching is rejected before the engine is
    built; --compile-cache is not an option; -d and --tp reach the engine,
    whose device defaults to cuda, and random weights only with --random-init."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.server import webui

    built, ran = [], []
    monkeypatch.setattr(engine_mod, "IndexTTS", lambda **kw: built.append(kw) or FakeEngine())
    monkeypatch.setattr(webui, "create_app", lambda engine, **kw: create_app(engine, base_dir=str(tmp_path), **kw))
    monkeypatch.setattr(webui.App, "run", lambda self, host, port: ran.append((host, port)))
    for argv in (["--batch-requests", "2", "--slot-batching", "2"], ["--compile-cache", str(tmp_path)]):
        with pytest.raises(SystemExit):
            webui.main(argv)
    assert built == [] and ran == []
    webui.main(["-c", "c.yaml", "--model_dir", "m", "-d", "cpu", "--port", "5099", "--slot-batching", "2"])
    webui.main(["--random-init"])
    webui.main(["--random-init", "--tp", "2"])
    assert built == [
        dict(cfg_path="c.yaml", model_dir="m", device="cpu", allow_random_init=False, fast_latents=False,
             quant_kv=False, tp=None),
        dict(cfg_path="checkpoints/config.yaml", model_dir="checkpoints", device="cuda", allow_random_init=True,
             fast_latents=False, quant_kv=False, tp=None),
        dict(cfg_path="checkpoints/config.yaml", model_dir="checkpoints", device="cuda", allow_random_init=True,
             fast_latents=False, quant_kv=False, tp=2),
    ]
    assert ran == [("0.0.0.0", 5099), ("0.0.0.0", 5000), ("0.0.0.0", 5000)]
