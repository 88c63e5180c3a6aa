"""Minimal threaded WSGI micro-framework (stdlib only).

Flask is not available in this environment, so the web server
(server/webui.py) runs on this ~150-line routing/request/response layer:
path-parameter routes, JSON and multipart/form-data parsing, JSON responses,
server-sent-event streaming responses, and static file serving — the exact
feature set the reference's Flask app uses (webui.py).
"""

from __future__ import annotations

import json
import mimetypes
import os
import re
from socketserver import ThreadingMixIn
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server


# request bodies are read fully into memory (multipart WAV uploads); cap the
# declared size so a hostile Content-Length cannot OOM the serving process.
# 64 MB >> any real reference prompt (a 10-minute 48 kHz stereo WAV is 115 MB,
# but prompts are seconds long; the reference trims to 15 s of mel anyway).
MAX_BODY_BYTES = int(os.environ.get("INDEXTTS_MAX_BODY_BYTES", 64 * 1024 * 1024))


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"].upper()
        self.path = environ.get("PATH_INFO", "/")
        # keep_blank_values: Flask (the layer this replaces) keeps
        # present-but-empty params as '' — dropping them would make
        # "field cleared" indistinguishable from "field absent"
        self.query = {k: v[0] for k, v in parse_qs(
            environ.get("QUERY_STRING", ""), keep_blank_values=True).items()}
        self._body: Optional[bytes] = None
        self.too_large = False
        self.form: Dict[str, str] = {}
        self.files: Dict[str, Tuple[str, bytes]] = {}  # name -> (filename, data)
        _ = self.body  # eager read: too_large must be set BEFORE dispatch
        self._parse_body()

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            if length > MAX_BODY_BYTES:
                self.too_large = True
                self._body = b""
            else:
                # length > 0 (not truthiness): a hostile "Content-Length: -1"
                # must not become read(-1) = unbounded read-until-EOF on
                # wsgiref's raw rfile, which bypasses the cap above.
                self._body = self.environ["wsgi.input"].read(length) if length > 0 else b""
        return self._body

    @property
    def json(self) -> Any:
        try:
            return json.loads(self.body.decode("utf-8"))
        except Exception:
            return None

    def get_json(self):
        return self.json

    def _parse_body(self):
        ctype = self.environ.get("CONTENT_TYPE", "")
        if self.method in ("POST", "PUT", "DELETE") and ctype:
            if ctype.startswith("application/x-www-form-urlencoded"):
                # "replace", not strict: a non-UTF-8 body must yield a clean
                # app-level error, not a UnicodeDecodeError during Request
                # construction (multipart headers already decode this way)
                self.form = {k: v[0] for k, v in parse_qs(
                    self.body.decode("utf-8", "replace"),
                    keep_blank_values=True).items()}
            elif ctype.startswith("multipart/form-data"):
                m = re.search(r'boundary="?([^";]+)"?', ctype)
                if m:
                    self._parse_multipart(m.group(1).encode())

    def _parse_multipart(self, boundary: bytes):
        body = self.body
        delim = b"--" + boundary
        parts = body.split(delim)
        # parts[0] is the RFC 2046 preamble; the closing delimiter leaves a
        # part starting with b"--". Frame removal must strip EXACTLY one CRLF
        # on each side — a character-class strip(b"\r\n") eats trailing
        # 0x0D/0x0A bytes that belong to the uploaded file data.
        for part in parts[1:]:
            if part.startswith(b"--"):
                break  # closing delimiter; anything after is epilogue
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if not part:
                continue
            if b"\r\n\r\n" not in part:
                continue
            head, _, data = part.partition(b"\r\n\r\n")
            headers = {}
            for line in head.decode("utf-8", "replace").split("\r\n"):
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            if file_m:
                # an unselected browser <input type=file> submits
                # filename="" with an empty body; Flask's empty FileStorage
                # is falsy (the reference relies on `if file:` checks,
                # ref webui.py form handling) — treat it as absent here.
                if file_m.group(1) == "" and not data:
                    continue
                self.files[name] = (file_m.group(1), data)
            else:
                self.form[name] = data.decode("utf-8", "replace")


class Response:
    def __init__(self, body: Any = b"", status: int = 200, content_type: str = "text/html; charset=utf-8",
                 headers: Optional[List[Tuple[str, str]]] = None):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or []


def jsonify(obj: Any, status: int = 200) -> Response:
    return Response(json.dumps(obj, ensure_ascii=False), status=status, content_type="application/json; charset=utf-8")


class SSEResponse:
    """Streaming text/event-stream response from a generator of dicts/strings."""

    def __init__(self, generator: Iterable[Any]):
        self.generator = generator


class StreamResponse:
    """Raw chunked byte stream (e.g. progressive WAV audio)."""

    def __init__(self, generator: Iterable[bytes], content_type: str = "application/octet-stream"):
        self.generator = generator
        self.content_type = content_type


_STATUS = {
    200: "200 OK", 201: "201 Created", 400: "400 Bad Request", 404: "404 Not Found",
    405: "405 Method Not Allowed", 413: "413 Request Entity Too Large",
    415: "415 Unsupported Media Type",
    500: "500 Internal Server Error", 503: "503 Service Unavailable",
}


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # keep stdout for the engine's printouts
        pass


class App:
    def __init__(self, static_dir: Optional[str] = None, static_url: str = "/static"):
        self.routes: List[Tuple[re.Pattern, List[str], Callable]] = []
        # absolute once, so containment checks compare like with like even
        # when the app is constructed with a relative static_dir
        self.static_dir = os.path.abspath(static_dir) if static_dir else None
        self.static_url = static_url.rstrip("/")

    def route(self, pattern: str, methods: Optional[List[str]] = None):
        methods = [m.upper() for m in (methods or ["GET"])]
        regex = re.compile("^" + re.sub(r"<(?:path:)?([a-zA-Z_]+)>",
                                        lambda m: f"(?P<{m.group(1)}>.+)" if "path:" in m.group(0) else f"(?P<{m.group(1)}>[^/]+)",
                                        pattern) + "$")

        def deco(fn):
            self.routes.append((regex, methods, fn))
            return fn

        return deco

    def _serve_static(self, path: str):
        # PATH_INFO arrives ALREADY percent-decoded (PEP 3333; wsgiref
        # unquotes it) as a latin-1-bytes-in-str surrogate — a second
        # unquote() would corrupt filenames containing %XX lookalikes, and
        # skipping the latin-1->utf-8 dance breaks non-ASCII names
        rel = path[len(self.static_url) + 1 :]
        try:
            rel = rel.encode("latin-1").decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            pass  # already a proper str (test clients) or not utf-8
        full = os.path.normpath(os.path.join(self.static_dir, rel))
        # trailing-separator check: a sibling dir sharing the prefix
        # (static_evil/ next to static/) must not be servable
        if not full.startswith(self.static_dir + os.sep) or not os.path.isfile(full):
            return jsonify({"error": "not found"}, 404)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(f.read(), content_type=ctype)

    def __call__(self, environ, start_response):
        try:
            # Request construction parses the body — it must sit INSIDE the
            # try so a malformed body becomes the JSON 500/413, not
            # wsgiref's plain-text error page
            req = Request(environ)
            if req.too_large:
                result = jsonify({"error": "request body too large"}, 413)
            else:
                result = self._dispatch(req)
        except Exception as e:  # route errors -> 500 JSON like Flask's default
            import traceback

            traceback.print_exc()
            result = jsonify({"error": str(e)}, 500)

        if isinstance(result, StreamResponse):
            start_response("200 OK", [
                ("Content-Type", result.content_type),
                ("Cache-Control", "no-cache"),
                ("Access-Control-Allow-Origin", "*"),
            ])
            return (bytes(chunk) for chunk in result.generator)

        if isinstance(result, SSEResponse):
            # no Connection header: hop-by-hop headers are forbidden by the
            # WSGI spec and wsgiref enforces it (found by live driving)
            start_response("200 OK", [
                ("Content-Type", "text/event-stream"),
                ("Cache-Control", "no-cache"),
                ("Access-Control-Allow-Origin", "*"),
            ])

            def stream():
                for item in result.generator:
                    if isinstance(item, (dict, list)):
                        yield f"data: {json.dumps(item, ensure_ascii=False)}\n\n".encode("utf-8")
                    else:
                        # strings get the same SSE framing — raw bytes would
                        # glue onto the next event and corrupt its JSON
                        yield f"data: {item}\n\n".encode("utf-8")

            return stream()

        if not isinstance(result, Response):
            result = jsonify(result)
        headers = [("Content-Type", result.content_type),
                   ("Content-Length", str(len(result.body))),
                   ("Access-Control-Allow-Origin", "*")] + result.headers
        start_response(_STATUS.get(result.status, f"{result.status} "), headers)
        return [result.body]

    def _dispatch(self, req: Request):
        if self.static_dir and req.path.startswith(self.static_url + "/"):
            return self._serve_static(req.path)
        matched_path = False
        for regex, methods, fn in self.routes:
            m = regex.match(req.path)
            if m:
                matched_path = True
                if req.method in methods:
                    return fn(req, **m.groupdict())
        if matched_path:
            return jsonify({"error": "method not allowed"}, 405)
        return jsonify({"error": "not found"}, 404)

    def run(self, host: str = "0.0.0.0", port: int = 5000):
        srv = make_server(host, port, self, server_class=ThreadingWSGIServer, handler_class=QuietHandler)
        print(f" * Serving on http://{host}:{port}")
        srv.serve_forever()
