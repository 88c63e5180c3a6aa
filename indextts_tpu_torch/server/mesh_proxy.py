"""The web server on a mesh (webui.py --tp under torchrun): rank 0 binds HTTP
and serves through an EngineProxy; every other rank runs follow().

The engine's ranks must make the same calls with the same arguments (its
collectives pair up call by call). EngineProxy wraps rank 0's engine: before
each engine call the server makes (infer, infer_fast, infer_batch,
infer_stream, warmup, slot_session and a session's submit / tick / cancel /
drain) it broadcasts (method, args, kwargs) over the mesh's gloo group, and
the followers replay the calls in that order. Output paths reach the
followers as None (rank 0 writes the files) and callbacks as a no-op
callback. A stream is driven chunk by chunk: before each chunk rank 0 sends
"next", and "close" when its consumer stops early, so a follower never
decodes a chunk rank 0 does not. stop() ends the followers' loops. On one
process there is no proxy. Replaying the same calls in the same order, a
follower's captured stages (graphs.py) bind, warm, capture and replay the
same keys as rank 0's, `warmup` included; their lanes are agreed over the
model group.
"""

from __future__ import annotations

import threading
import traceback
import weakref
from typing import Any, Dict

_CALLS = ("infer", "infer_fast", "infer_batch", "warmup")
_SESSION_CALLS = ("submit", "tick", "cancel", "drain")
_CALLBACK = "<callback>"  # a callable of rank 0's, replaced on the followers


def _for_followers(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """kwargs as the followers get them: no output paths, callbacks marked."""
    out = {}
    for k, v in kwargs.items():
        if k in ("output_path", "output_paths"):
            v = None
        elif callable(v):
            v = _CALLBACK
        out[k] = v
    return out


def _noop(*_a, **_k) -> None:
    return None


def _from_leader(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_noop if isinstance(v, str) and v == _CALLBACK else v) for k, v in kwargs.items()}


class EngineProxy:
    """Rank 0's engine, each of whose calls is first sent to the followers.
    Other attributes (cfg, fast_latents, set_gr_progress_callback, ...) are
    the engine's own and send nothing."""

    def __init__(self, engine):
        self._engine = engine
        self._comm = engine.mesh.world
        self._lock = threading.RLock()
        self._sessions: Dict[int, Any] = {}  # id -> weakref to the SessionProxy
        self._next_sid = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _send(self, *msg) -> None:
        """Broadcast one message; sessions rank 0 no longer holds go with it."""
        dead = [sid for sid, ref in self._sessions.items() if ref() is None]
        for sid in dead:
            del self._sessions[sid]
        self._comm.broadcast_object((dead, msg), 0)

    def _call(self, method: str, args, kwargs):
        with self._lock:
            self._send("call", method, args, _for_followers(kwargs))
            return getattr(self._engine, method)(*args, **kwargs)

    def infer(self, *args, **kwargs):
        return self._call("infer", args, kwargs)

    def infer_fast(self, *args, **kwargs):
        return self._call("infer_fast", args, kwargs)

    def infer_batch(self, *args, **kwargs):
        return self._call("infer_batch", args, kwargs)

    def warmup(self, *args, **kwargs):
        return self._call("warmup", args, kwargs)

    def infer_stream(self, *args, **kwargs):
        """A generator over the engine's stream; the followers take a chunk
        whenever rank 0 does."""
        with self._lock:
            self._send("stream", "infer_stream", args, _for_followers(kwargs))
            gen = self._engine.infer_stream(*args, **kwargs)
            ended = False
            try:
                while True:
                    self._comm.broadcast_object("next", 0)
                    try:
                        chunk = next(gen)
                    except StopIteration:
                        ended = True
                        return
                    yield chunk
            except GeneratorExit:
                raise
            except BaseException:
                ended = True  # the followers raised at the same chunk
                raise
            finally:
                if not ended:
                    self._comm.broadcast_object("close", 0)
                    gen.close()

    def slot_session(self, **kwargs):
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._send("session", sid, _for_followers(kwargs))
            proxy = SessionProxy(self, sid, self._engine.slot_session(**kwargs))
            self._sessions[sid] = weakref.ref(proxy)
            return proxy

    def stop(self) -> None:
        """End the followers' loops (the server's shutdown)."""
        with self._lock:
            self._send("stop")


class SessionProxy:
    """Rank 0's SlotSession; submit / tick / cancel / drain are sent first."""

    def __init__(self, owner: EngineProxy, sid: int, session):
        self._owner, self._sid, self._session = owner, sid, session

    def __getattr__(self, name):
        return getattr(self._session, name)

    def _call(self, method: str, args, kwargs):
        with self._owner._lock:
            self._owner._send("session_call", self._sid, method, args, _for_followers(kwargs))
            return getattr(self._session, method)(*args, **kwargs)

    def submit(self, *args, **kwargs):
        return self._call("submit", args, kwargs)

    def tick(self):
        return self._call("tick", (), {})

    def cancel(self, rid: int):
        return self._call("cancel", (rid,), {})

    def drain(self):
        return self._call("drain", (), {})


def follow(engine) -> None:
    """A follower rank's loop: replay rank 0's engine calls until stop. A
    call that raises is reported and the loop goes on (rank 0 raised at the
    same point)."""
    comm = engine.mesh.world
    sessions: Dict[int, Any] = {}
    while True:
        dead, msg = comm.broadcast_object(None, 0)
        for sid in dead:
            sessions.pop(sid, None)
        kind, rest = msg[0], msg[1:]
        if kind == "stop":
            return
        try:
            if kind == "call":
                method, args, kwargs = rest
                assert method in _CALLS, method
                getattr(engine, method)(*args, **_from_leader(kwargs))
            elif kind == "stream":
                _follow_stream(comm, engine.infer_stream(*rest[1], **_from_leader(rest[2])))
            elif kind == "session":
                sid, kwargs = rest
                sessions[sid] = engine.slot_session(**_from_leader(kwargs))
            elif kind == "session_call":
                sid, method, args, kwargs = rest
                assert method in _SESSION_CALLS, method
                getattr(sessions[sid], method)(*args, **_from_leader(kwargs))
            else:
                raise ValueError(f"unknown message {kind!r} from rank 0")
        except Exception:
            traceback.print_exc()


def _follow_stream(comm, gen) -> None:
    """Take a chunk of `gen` at each "next" of rank 0, until the stream ends
    or rank 0 sends "close"."""
    try:
        while comm.broadcast_object(None, 0) == "next":
            try:
                next(gen)
            except StopIteration:
                return
    finally:
        gen.close()
