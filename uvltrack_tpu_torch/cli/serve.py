"""HTTP tracking service: many concurrent streams, one compiled step (port
of uvltrack_tpu/cli/serve.py, the same routes, bodies, status codes and
errors).

One process serves any number of independent tracking streams over HTTP.
All streams share ONE JitTracker (track/tracker.py) -- the CUDA graphs of
the per-frame step and of the re-mine, and the device-resident weights --
so opening a new stream costs per-sequence state init (template crop + text
prefix), never a capture.

Protocol (JSON request bodies; responses are JSON):

  GET  /health -> {"streams": N, "mode": ..., "platform": "gpu" | "cpu"}
  GET  /stats  -> {"streams": {stream: {"frames", "seconds", "last_score", "fps"}}}
  POST /initialize {"stream": "cam0", "image": <b64>, "bbox": [x,y,w,h]?,
                    "language": "..."?, "format": "jpeg"|"npy"?}
  POST /track      {"stream": "cam0", "image": <b64>} -> {"bbox": [...],
                    "score": s}
  POST /close      {"stream": "cam0"}

`image` is base64: JPEG bytes (default; decoded to RGB by the port's libjpeg
decoder, native/, with cv2 used only where that library cannot be built)
or np.save bytes ("format": "npy", HxWx3 uint8 RGB -- the zero-decode path
for local producers). Which of bbox/language is required follows
cfg.TEST.MODE, exactly like the offline tracker (BBOX needs bbox, NL needs
language, NLBBOX needs both). Errors: 400 (bad JSON, a missing field, an
undecodable image), 404 (unknown route or stream), 429 (--max_streams),
503 (pool full, dispatch timeout).

Device work is serialized behind one lock, the JitTracker's (the step is
sequential per stream anyway, and the graphs of one JitTracker share their
buffers and a memory pool); HTTP I/O and image decode run in the handler
threads, overlapping the device.

Two execution modes:

- default: every stream is its own Tracker sharing one JitTracker -- each
  /track is one replay of the batch-1 step graph. Any mix of resolutions
  (a graph per frame size).
- `--lockstep S`: a StreamPool (track/pool.py) of S slots + a coalescing
  dispatcher -- concurrent /track requests across streams are batched into
  ONE batch-S step per round (continuous batching; fires as soon as every
  open stream has a frame pending, or after `--batch_window` seconds).
  Streams must share a frame resolution within a round (a camera fleet),
  like the pool.

Left out: the JAX service's --multichip (slots sharded over a device mesh)
waits for the port's parallel/mesh.py.

    python -m uvltrack_tpu_torch.cli.serve uvltrack baseline_base [--lockstep 4]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import native


def _decode_jpeg(raw: bytes) -> np.ndarray:
    """RGB uint8 from JPEG bytes: the port's libjpeg decoder (native/), or
    cv2 where that library cannot be built."""
    img = native.decode_jpeg_bytes(raw)  # ValueError on undecodable bytes
    if img is not None:
        return img
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("no JPEG decoder: the native libjpeg decoder did not build "
                           "and cv2 is not installed; send \"format\": \"npy\"") from e
    bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("undecodable image bytes")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _decode_image(payload: dict) -> np.ndarray:
    raw = base64.b64decode(payload["image"])
    if payload.get("format", "jpeg") == "npy":
        img = np.load(io.BytesIO(raw), allow_pickle=False)
    else:
        img = _decode_jpeg(raw)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected HxWx3 uint8, got {img.shape} {img.dtype}")
    return img


class TooManyStreams(RuntimeError):
    """New-stream admission rejected by --max_streams (HTTP 429)."""


class _LockstepDispatcher:
    """Coalesces concurrent /track requests into one StreamPool.submit per
    round. Handler threads block on a per-request event; the dispatcher
    thread fires when every open stream has a pending frame or the window
    expires (a stream that stops sending costs each round at most the
    window)."""

    def __init__(self, pool, device_lock, window_s: float):
        self.pool = pool
        self.device_lock = device_lock
        self.window = window_s
        self.cv = threading.Condition()
        self.pending = {}  # stream -> [frame, event, result_holder]
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def track(self, stream: str, frame, timeout_s: float = 600.0) -> dict:
        ev = threading.Event()
        holder = {}
        with self.cv:
            if stream not in self.pool.slot_of:
                raise LookupError(f"stream {stream!r} not initialized")
            if stream in self.pending:
                raise ValueError(
                    f"stream {stream!r} already has a frame in flight")
            self.pending[stream] = [frame, ev, holder]
            self.cv.notify_all()
        if not ev.wait(timeout_s):
            raise TimeoutError("dispatch timed out")
        if "error" in holder:
            raise holder["error"]
        return holder["out"]

    def stop(self):
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        self.thread.join(timeout=10)

    def _run(self):
        while True:
            with self.cv:
                while not self.pending and not self._stop:
                    self.cv.wait(0.5)
                if self._stop:
                    for _, ev, holder in self.pending.values():
                        holder["error"] = RuntimeError("server stopped")
                        ev.set()
                    return
                deadline = time.monotonic() + self.window
                while (set(self.pool.slot_of) - set(self.pending)
                       and time.monotonic() < deadline and not self._stop):
                    self.cv.wait(max(deadline - time.monotonic(), 0.001))
                taken = self.pending
                self.pending = {}
            # a stream closed between enqueue and dispatch fails alone, not
            # the whole round
            stale = [s for s in taken if s not in self.pool.slot_of]
            for s in stale:
                _, ev, holder = taken.pop(s)
                holder["error"] = LookupError(f"stream {s!r} closed")
                ev.set()
            if not taken:
                continue
            try:
                with self.device_lock:
                    outs = self.pool.submit(
                        {s: f for s, (f, _, _) in taken.items()})
                for s, (_, ev, holder) in taken.items():
                    holder["out"] = outs[s]
                    ev.set()
            except Exception as e:
                for _, ev, holder in taken.values():
                    holder["error"] = e
                    ev.set()


class _Handler(BaseHTTPRequestHandler):
    server_version = "uvltrack_tpu_torch"

    def log_message(self, fmt, *args):  # quiet: the CLI prints its own line
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server
        if self.path == "/stats":
            with srv.lock:
                stats = {s: dict(c) for s, c in srv.counters.items()}
            for c in stats.values():
                if c["frames"]:
                    c["fps"] = round(c["frames"] / max(c["seconds"], 1e-9), 2)
            return self._reply(200, {"streams": stats})
        if self.path != "/health":
            return self._reply(404, {"error": f"no route {self.path}"})
        n = (len(srv.pool.slot_of) if srv.pool is not None
             else len(srv.streams))
        self._reply(200, {"streams": n,
                          "mode": ("lockstep" if srv.pool is not None
                                   else "per-stream"),
                          "platform": "gpu" if srv.device.type == "cuda" else "cpu"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": f"bad JSON body: {e}"})
        try:
            if self.path == "/initialize":
                return self._reply(200, self._initialize(payload))
            if self.path == "/track":
                return self._reply(200, self._track(payload))
            if self.path == "/close":
                return self._reply(200, self._close(payload))
            return self._reply(404, {"error": f"no route {self.path}"})
        except KeyError as e:
            return self._reply(400, {"error": f"missing field {e}"})
        except LookupError as e:
            return self._reply(404, {"error": str(e)})
        except (ValueError, TypeError) as e:
            return self._reply(400, {"error": str(e)})
        except TooManyStreams as e:
            return self._reply(429, {"error": str(e)})
        except (RuntimeError, TimeoutError) as e:
            # pool full / dispatch timeout: retryable server-side conditions
            return self._reply(503, {"error": str(e)})

    def _initialize(self, payload: dict) -> dict:
        stream = payload["stream"]
        image = _decode_image(payload)
        info = {}
        if "bbox" in payload:
            info["init_bbox"] = [float(v) for v in payload["bbox"]]
        if "language" in payload:
            info["language"] = str(payload["language"])
        srv = self.server
        if srv.pool is not None:
            with srv.lock:
                box = srv.pool.open(stream, image, info)
                srv.last_seen[stream] = time.monotonic()
            return {"stream": stream, "bbox": list(box)}
        with srv.lock:
            tracker = srv.streams.get(stream)
            if (tracker is None and srv.max_streams
                    and len(srv.streams) >= srv.max_streams):
                raise TooManyStreams(
                    f"{len(srv.streams)} open streams (--max_streams "
                    f"{srv.max_streams}); close one or retry later")
            tracker = tracker or srv.make_tracker()
            out = tracker.initialize(image, info)
            srv.streams[stream] = tracker
            srv.last_seen[stream] = time.monotonic()
        return {"stream": stream, "bbox": list(out["target_bbox"])}

    def _track(self, payload: dict) -> dict:
        stream = payload["stream"]
        image = _decode_image(payload)
        srv = self.server
        with srv.lock:
            known = (stream in srv.pool.slot_of if srv.pool is not None
                     else stream in srv.streams)
            if known:  # never resurrect an evicted/unknown stream's ttl
                srv.last_seen[stream] = time.monotonic()
        t0 = time.perf_counter()
        if srv.pool is not None:
            out = srv.dispatcher.track(stream, image)
            result = {"stream": stream, **out}
        else:
            with srv.lock:
                tracker = srv.streams.get(stream)
                if tracker is None:
                    raise LookupError(f"stream {stream!r} not initialized")
                out = tracker.track(image)
            result = {"stream": stream, "bbox": list(out["target_bbox"]),
                      "score": out["score"]}
        with srv.lock:
            c = srv.counters.setdefault(
                stream, {"frames": 0, "seconds": 0.0, "last_score": None})
            c["frames"] += 1
            c["seconds"] += time.perf_counter() - t0
            c["last_score"] = result["score"]
            # stamp at COMPLETION too: a first step/round (its graph capture) can run
            # far longer than the ttl, and the arrival stamp alone would
            # make every participating stream look idle the moment the
            # lock releases — the reaper would evict right after success
            srv.last_seen[stream] = time.monotonic()
        return result

    def _close(self, payload: dict) -> dict:
        stream = payload["stream"]
        srv = self.server
        if srv.pool is not None:
            with srv.lock:
                srv.pool.close(stream)  # raises LookupError -> 404
                srv.last_seen.pop(stream, None)
                srv.counters.pop(stream, None)
            return {"stream": stream, "closed": True}
        with srv.lock:
            gone = srv.streams.pop(stream, None)
            srv.last_seen.pop(stream, None)
            srv.counters.pop(stream, None)
        if gone is None:
            raise LookupError(f"stream {stream!r} not initialized")
        return {"stream": stream, "closed": True}


class _StreamReaper:
    """Evicts streams idle for longer than ttl_s (last_seen stamped at every
    /initialize//track request): a camera that silently disappears must not
    hold a pool slot (lockstep capacity is fixed) or a Tracker's device
    state forever. Runs as a daemon; stop() joins it."""

    def __init__(self, server, ttl_s: float):
        self.server = server
        self.ttl = ttl_s
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=10)

    def _evict_idle(self):
        srv = self.server
        now = time.monotonic()
        with srv.lock:
            # a stream waiting in the lockstep dispatcher is mid-request,
            # not idle — evicting it would fail its (and potentially the
            # whole round's) in-flight dispatch
            in_flight = (set(srv.dispatcher.pending)
                         if srv.dispatcher is not None else set())
            idle = [s for s, t in srv.last_seen.items()
                    if now - t > self.ttl and s not in in_flight]
            for s in idle:
                srv.last_seen.pop(s, None)
                srv.counters.pop(s, None)
                if srv.pool is not None:
                    try:
                        srv.pool.close(s)
                    except LookupError:
                        pass
                else:
                    srv.streams.pop(s, None)
        return idle

    def _run(self):
        period = max(min(self.ttl / 4.0, 10.0), 0.05)
        while not self._stop.wait(period):
            for s in self._evict_idle():
                if self.server.verbose:
                    print(f"[reaper] evicted idle stream {s!r}", flush=True)


def make_server(proto_tracker, host: str = "127.0.0.1", port: int = 0,
                verbose: bool = False, lockstep: int = 0,
                batch_window: float = 0.05, max_streams: int = 0,
                stream_ttl: float = 0.0) -> ThreadingHTTPServer:
    """Wrap an existing Tracker as the prototype. Default mode: every stream
    is a fresh Tracker sharing the prototype's JitTracker (weights + step
    and re-mine graphs). lockstep>0: a StreamPool of that many slots on the
    same JitTracker + a coalescing dispatcher batches concurrent /track
    requests into one batch-S step per round."""
    from ..track.pool import StreamPool
    from ..track.tracker import Tracker

    server = ThreadingHTTPServer((host, port), _Handler)
    server.streams = {}
    server.counters = {}  # /stats: per-stream frames/seconds/last_score
    server.last_seen = {}  # stream -> monotonic time of last request
    server.max_streams = int(max_streams)  # per-stream mode admission cap
    # the JitTracker's lock: every thread stepping its graphs holds it, so
    # servers that share one JitTracker serialize their device work too
    server.lock = proto_tracker.jt.lock
    server.verbose = verbose
    server.device = proto_tracker.device
    server.pool = None
    server.dispatcher = None
    server.reaper = None
    jt = proto_tracker.jt
    if lockstep > 0:
        server.pool = StreamPool(proto_tracker.cfg, jt.model, lockstep,
                                 tokenizer=proto_tracker.tokenizer, jit_tracker=jt,
                                 graphs=proto_tracker.graphs)
        server.dispatcher = _LockstepDispatcher(server.pool, server.lock,
                                                batch_window)
    if stream_ttl > 0:
        server.reaper = _StreamReaper(server, stream_ttl)
    server.make_tracker = lambda: Tracker(
        proto_tracker.cfg, tokenizer=proto_tracker.tokenizer, jit_tracker=jt,
        graphs=proto_tracker.graphs)
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve tracking streams over HTTP")
    p.add_argument("tracker_name", nargs="?", default="uvltrack")
    p.add_argument("tracker_param", nargs="?", default="baseline_base")
    p.add_argument("--test_checkpoint", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8712)
    p.add_argument("--lockstep", type=int, default=0, metavar="S",
                   help="continuous batching: S pool slots, concurrent "
                        "/track requests coalesce into one batch-S dispatch")
    p.add_argument("--batch_window", type=float, default=0.05,
                   help="lockstep: max seconds to wait for stragglers "
                        "before dispatching a partial round")
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="weight-only quantization of the ViT matmul kernels "
                        "at tracker build (cfg.TPU.WEIGHT_QUANT)")
    p.add_argument("--max_streams", type=int, default=0,
                   help="per-stream mode: reject new streams beyond this "
                        "count with 429 (0 = unlimited; lockstep capacity "
                        "is already bounded by S)")
    p.add_argument("--stream_ttl", type=float, default=0.0, metavar="SEC",
                   help="evict streams idle for this many seconds (0 = "
                        "never): frees pool slots / tracker state when a "
                        "client disappears without /close")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cpu runs the eager step)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from .test import build_tracker

    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.tracker_name,
                                       args.tracker_param))
    if args.quant:
        cfg.TPU.WEIGHT_QUANT = args.quant
    proto = build_tracker(cfg, args.test_checkpoint, device=args.device)
    server = make_server(proto, args.host, args.port, verbose=args.verbose,
                         lockstep=args.lockstep,
                         batch_window=args.batch_window,
                         max_streams=args.max_streams,
                         stream_ttl=args.stream_ttl)
    mode = (f"lockstep x{args.lockstep}" if args.lockstep else "per-stream")
    print(f"serving {args.tracker_param} ({cfg.TEST.MODE}, {mode}) on "
          f"http://{args.host}:{server.server_address[1]}  "
          "(POST /initialize, /track, /close; GET /health)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if server.reaper is not None:
            server.reaper.stop()
        if server.dispatcher is not None:
            server.dispatcher.stop()
        server.server_close()


if __name__ == "__main__":
    main()
