"""Line-delimited JSON-RPC surface over the AudioEngine (port of
audio_analyzer_rs_tpu/api/rpc.py: the same protocol and methods; the
engines run on the server's torch `device`, default "cuda").

The reference embeds in Swift/Kotlin frontends through uniffi FFI with
poll-based JSON methods (ref src/lib.rs).  The equivalent embedding story
here is a process boundary: any frontend (RN, web, native) talks
newline-delimited JSON over stdio or TCP to this server, calling the same
method names and receiving the same JSON payloads the uniffi objects return.

Protocol: one request per line {"id": n, "method": "...", "params": [...]},
one response per line {"id": n, "result": ...} or {"id": n, "error": "..."}.
Audio pushes are base64-encoded little-endian samples — float32 by default,
or i16/u16 interleaved multichannel via push_audio's format/channels params
(downmixed like the reference's generic input streams, ref mod.rs:657-806).

Methods mirror the engine surface: start_input/start_output, create_* /
stop_* for metronome, synth, player, recording, onset detection, tuner,
practice session, the poll_* JSON getters, push_audio, advance (virtual
time) and run_realtime.

Multi-session (beyond the reference, whose uniffi object graph is one
engine per process — ref src/audio_io/mod.rs:960-1129): a request may
carry {"session": id} to address one of several engines hosted by the
same server.  `session.create` opens a new session (id returned),
`session.close` drops it, `session.list` enumerates.  `pool.join` puts
every session into ONE EnginePool (api/pool.py) so each slot wave of all
K sessions runs as the lanes of one batched slot program — the classroom
scenario over the embedding boundary: one frontend (or hub process)
pushes K students' audio and polls K result surfaces while the card runs
one program per wave.  While pooled, `advance`/`run_realtime` drive ALL
sessions in lockstep (the pool's wave schedule), whichever session the
request addresses.  Requests without a "session" field address session 0,
so single-session embeddings (and the C client, runtime/engine_client)
are untouched.
"""

from __future__ import annotations

import base64
import json
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .device import PushSource
from .engine import AudioEngine, AudioEngineError


class RpcServer:
    def __init__(self, sample_rate: float = 48000.0, buffer_size: int = 1024,
                 loopback_latency_samples: int = 0, loopback_gain: float = 0.0,
                 device: str = "cuda"):
        # The torch device of every engine this server creates.
        self.device = device
        self.source = PushSource()
        self.engine = AudioEngine(
            input_source=self.source, sample_rate=sample_rate,
            buffer_size=buffer_size,
            loopback_latency_samples=loopback_latency_samples,
            loopback_gain=loopback_gain, device=device)
        # session id -> (PushSource, AudioEngine); session 0 is the default
        # (self.source/self.engine stay aliases so embedders and subclasses
        # that predate multi-session keep working).
        self.sessions: Dict[int, tuple] = {0: (self.source, self.engine)}
        self.pool = None            # EnginePool over ALL sessions, or None
        self._next_session = 1

    # ── dispatch ─────────────────────────────────────────────────────────

    def handle(self, request: dict) -> dict:
        rid = request.get("id")
        method = request.get("method", "")
        params = request.get("params", [])
        session = request.get("session", 0)
        try:
            result = self._dispatch(method, params, session)
            return {"id": rid, "result": result}
        except AudioEngineError as exc:
            return {"id": rid, "error": str(exc)}
        except Exception as exc:  # malformed params etc.
            return {"id": rid, "error": f"{type(exc).__name__}: {exc}"}

    # ── session / pool management (no reference analog: the reference is
    # one engine per process, ref src/audio_io/mod.rs:960-1129) ──────────

    def _session_methods(self, method: str, params: List[Any],
                         session: int):
        if method == "session.create":
            cfg = params[0] if params else {}
            e0 = self.sessions[0][1]
            src = PushSource()
            eng = AudioEngine(
                input_source=src,
                sample_rate=float(cfg.get("sample_rate", e0.sample_rate)),
                buffer_size=int(cfg.get("buffer_size", e0.buffer_size)),
                loopback_latency_samples=int(
                    cfg.get("loopback_latency_samples", 0)),
                loopback_gain=float(cfg.get("loopback_gain", 0.0)),
                device=self.device)
            # Pool admission BEFORE registration: add() enforces shared
            # sr/buffer_size, and a rejected engine must not linger in
            # self.sessions outside the pool (the pooled advance/
            # run_realtime paths drive members only — a zombie session
            # would silently never advance; ADVICE r4).
            if self.pool is not None:
                self.pool.add(eng)
            sid = self._next_session
            self._next_session += 1
            self.sessions[sid] = (src, eng)
            return sid
        if method == "session.close":
            if session == 0:
                raise AudioEngineError("session 0 cannot be closed")
            src, eng = self._session(session)
            if self.pool is not None:
                self.pool.remove(eng)   # surfaces its deferred waves
            eng.flush_analysis()
            del self.sessions[session]
            return True
        if method == "session.list":
            return sorted(self.sessions)
        if method == "pool.join":
            # Pool EVERY session: each subsequent slot wave of all K
            # engines runs as the lanes of ONE slot program (api/pool.py).
            from .pool import EnginePool
            cfg = params[0] if params else {}
            if self.pool is not None:
                raise AudioEngineError("pool already active")
            self.pool = EnginePool(
                [eng for _, eng in self.sessions.values()],
                pipeline_depth=int(cfg.get("pipeline_depth", 1)),
                aggregate_slots=int(cfg.get("aggregate_slots", 1)),
                capacity=int(cfg.get("capacity", 0)))
            return {"k": len(self.sessions)}
        if method == "pool.leave":
            if self.pool is None:
                return False
            pool, self.pool = self.pool, None
            pool.flush()
            for eng in list(pool.engines):
                pool.remove(eng)
            return True
        if method == "pool.flush":
            if self.pool is not None:
                self.pool.flush()
            return True
        if method == "pool.stats":
            if self.pool is None:
                return None
            return {"k": len(self.pool.engines), "waves": self.pool.waves,
                    "pipeline_depth": self.pool.pipeline_depth,
                    "aggregate_slots": self.pool.aggregate_slots}
        return NotImplemented

    def _session(self, session: int):
        try:
            return self.sessions[session]
        except KeyError:
            raise AudioEngineError(f"unknown session {session}") from None

    def _dispatch(self, method: str, params: List[Any], session: int = 0):
        if method == "ping":
            return "pong"
        handled = self._session_methods(method, params, session)
        if handled is not NotImplemented:
            return handled
        src, e = self._session(session)
        if method == "configure":
            # Declare the host device's format before any stream starts —
            # the reference adapts to whatever cpal reports (ref mod.rs:
            # 121-128); an embedding host declares it here instead.
            if (e.device.input_running or e.device.output_running
                    or e.transport.get_input_frames() > 0):
                raise AudioEngineError(
                    "configure must precede stream start")
            if session != 0 or len(self.sessions) > 1 or self.pool:
                raise AudioEngineError(
                    "configure applies to a fresh single-session server; "
                    "give per-session formats to session.create instead")
            cfg = params[0] if params else {}
            if float(cfg.get("sample_rate", 48000.0)) <= 0:
                raise AudioEngineError("sample_rate must be positive")
            if int(cfg.get("buffer_size", 1024)) <= 0:
                raise AudioEngineError("buffer_size must be positive")
            self.source = PushSource()
            self.engine = AudioEngine(
                input_source=self.source,
                sample_rate=float(cfg.get("sample_rate", 48000.0)),
                buffer_size=int(cfg.get("buffer_size", 1024)),
                loopback_latency_samples=int(
                    cfg.get("loopback_latency_samples", 0)),
                loopback_gain=float(cfg.get("loopback_gain", 0.0)),
                device=self.device)
            self.sessions[0] = (self.source, self.engine)
            return {"sample_rate": self.engine.sample_rate,
                    "buffer_size": self.engine.buffer_size}
        if method == "push_audio":
            # params: [b64, format?, channels?] — format "f32" (default),
            # "i16", or "u16"; interleaved frames are downmixed like the
            # reference's generic input callbacks (ref mod.rs:657-806).
            fmt = params[1] if len(params) > 1 else "f32"
            channels = int(params[2]) if len(params) > 2 else 1
            dtype = {"f32": "<f4", "i16": "<i2", "u16": "<u2"}.get(fmt)
            if dtype is None:
                raise ValueError(f"unsupported sample format {fmt!r}")
            samples = np.frombuffer(base64.b64decode(params[0]), dtype=dtype)
            src.push(samples, channels=channels)
            return len(samples)
        if method == "advance":
            # While pooled, time is shared: one call advances EVERY session
            # in lockstep (each slot wave = one batched slot program).
            if self.pool is not None:
                self.pool.advance(float(params[0]))
            else:
                e.advance(float(params[0]))
            return True
        if method == "run_realtime":
            if self.pool is not None:
                self.pool.run_realtime(float(params[0]))
            else:
                e.run_realtime(float(params[0]))
            return True
        if method in ("start_input", "start_output", "clean_input",
                      "clean_output", "stop_metronome", "stop_synth",
                      "stop_player", "stop_recording", "stop_onset_detection",
                      "stop_tuner", "stop_practice_session",
                      "flush_analysis"):
            getattr(e, method)()
            return True
        if method == "poll_dynamics":
            return json.loads(e.poll_dynamics())
        if method == "poll_transport":
            return json.loads(e.poll_transport())
        if method == "create_metronome":
            e.create_metronome(*params)
            return True
        if method.startswith("metronome."):
            return getattr(e.active_metronome, method.split(".", 1)[1])(*params)
        if method == "create_synth":
            e.create_synth()
            return True
        if method.startswith("synth."):
            return getattr(e.active_synth, method.split(".", 1)[1])(*params)
        if method == "create_player":
            e.create_player()
            return True
        if method.startswith("player."):
            return getattr(e.active_player, method.split(".", 1)[1])(*params)
        if method == "start_recording":
            e.start_recording(params[0])
            return True
        if method.startswith("recording."):
            return getattr(e.active_recording, method.split(".", 1)[1])(*params)
        if method == "start_onset_detection":
            e.start_onset_detection()
            return True
        if method == "poll_onsets":
            return json.loads(e.active_onset.poll_onsets())
        if method.startswith("onset."):
            return getattr(e.active_onset, method.split(".", 1)[1])(*params)
        if method == "start_tuner":
            e.start_tuner()
            return True
        if method == "poll_output":
            return json.loads(e.active_tuner.poll_output())
        if method.startswith("tuner."):
            return getattr(e.active_tuner, method.split(".", 1)[1])(*params)
        if method == "create_practice_session":
            e.create_practice_session(*params)
            return True
        if method in ("practice.poll_transport", "practice.poll_errors",
                      "practice.get_metrics"):
            return json.loads(getattr(e.active_practice_session,
                                      method.split(".", 1)[1])())
        if method.startswith("practice."):
            return getattr(e.active_practice_session,
                           method.split(".", 1)[1])(*params)
        raise ValueError(f"unknown method '{method}'")

    # ── transports ───────────────────────────────────────────────────────

    def serve_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            if line == "quit":
                break
            try:
                request = json.loads(line)
            except json.JSONDecodeError as exc:
                stdout.write(json.dumps({"id": None,
                                         "error": f"bad json: {exc}"}) + "\n")
                stdout.flush()
                continue
            stdout.write(json.dumps(self.handle(request)) + "\n")
            stdout.flush()

    def serve_tcp(self, host: str = "127.0.0.1", port: int = 0,
                  max_clients: Optional[int] = None) -> None:
        """Serve the same line protocol over TCP, one client at a time (the
        engine is a single session, like the reference's uniffi object
        graph).  Binds before accepting; the chosen port is published on
        `self.tcp_port` (port=0 picks an ephemeral one).  A client's
        ``quit`` line ends that client's session; the server then accepts
        the next connection, up to `max_clients` (None = forever)."""
        import socket

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        self.tcp_port = srv.getsockname()[1]
        # Announce the bound address — with port=0 (ephemeral) an external
        # client has no other way to discover where to connect.
        print(f"rpc: listening on {host}:{self.tcp_port}",
              file=sys.stderr, flush=True)
        try:
            served = 0
            while max_clients is None or served < max_clients:
                conn, _ = srv.accept()
                served += 1
                with conn:
                    rf = conn.makefile("r", encoding="utf-8")
                    wf = conn.makefile("w", encoding="utf-8")
                    try:
                        self.serve_stdio(stdin=rf, stdout=wf)
                    except (UnicodeDecodeError, OSError):
                        # Client vanished (Broken pipe / reset), or sent
                        # non-UTF-8 garbage into the line iterator — either
                        # way drop that client and accept the next one
                        # rather than killing the whole accept loop.
                        pass
        finally:
            srv.close()


def main() -> None:
    """``python -m audio_analyzer_rs_tpu_torch.api.rpc [--tcp [HOST:]PORT]``

    With ``--tcp`` the bound address is announced on stderr (port 0 binds
    an ephemeral port).  A bare number is a port on 127.0.0.1.  The
    engines run on CUDA."""
    args = sys.argv[1:]
    if args and args[0] == "--tcp":
        spec = args[1] if len(args) > 1 else "127.0.0.1:0"
        if ":" in spec:
            host, _, port = spec.rpartition(":")
            host = host or "127.0.0.1"
        else:
            host, port = "127.0.0.1", spec
        if not port.isdigit():
            print(f"rpc: invalid --tcp address {spec!r} "
                  f"(expected [HOST:]PORT)", file=sys.stderr)
            sys.exit(2)
        RpcServer().serve_tcp(host, int(port))
    else:
        RpcServer().serve_stdio()


if __name__ == "__main__":
    main()
