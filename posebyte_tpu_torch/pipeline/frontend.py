"""Socket front end for the stream servers, after
posebyte_tpu/pipeline/frontend.py: clients connect over TCP, open
streams, push raw frames and poll tracked outputs in frame coordinates,
with per-stream backpressure. Its wire protocol is the JAX package's, so
that a client of either package talks to a server of either.

  * Stdlib only: socket, threading, struct, json.
  * Length-prefixed binary protocol (little-endian):
      request:  magic u32 'PBS1' | op u8 | stream_id i32 | len u32 | payload
      reply:    status u8 | len u32 | payload
    ops: OPEN(1) payload b"" -> {"sid": n}; FRAME(2) payload = raw
    H*W*3 uint8 BGR bytes; POLL(3) -> JSON list of per-frame track
    lists; CLOSE(4); STATS(5) -> server counters. status: 0 = ok,
    1 = error (payload JSON {"error": ...}), 2 = busy (backpressure).
  * One stepper thread owns the device: it runs the server's step(),
    which serves every queued stream at once, so clients never contend
    for the card. Client handler threads touch only host-side queues, all
    under one lock.
  * Backpressure: a stream whose input queue holds max_queue frames
    refuses FRAME with BUSY instead of buffering without bound; the
    client decides to wait, drop or downsample.
  * Outputs are un-letterboxed to frame pixels on the serving host
    (runner.frame_tracks, as PosePipeline.fetch_outputs; reference:
    scaleTrackOutputs, main.cpp:48-68): [{"id", "score", "bbox",
    "keypoints"}].
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np

from .runner import frame_tracks

MAGIC = 0x50425331                      # 'PBS1'
_REQ = struct.Struct("<IbiI")           # magic, op, sid, payload len
_REP = struct.Struct("<bI")             # status, payload len

OP_OPEN, OP_FRAME, OP_POLL, OP_CLOSE, OP_STATS = 1, 2, 3, 4, 5
ST_OK, ST_ERR, ST_BUSY = 0, 1, 2

_MAX_PAYLOAD = 64 * 1024 * 1024


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class PoseServingFrontend:
    """Serve a StreamServer or ChunkedStreamServer over a socket.

    server: a constructed serving.StreamServer (or subclass); the front
    end makes its lifecycle calls from here on.
    max_queue: per-stream input-queue bound before FRAME answers BUSY
    (default twice the server's chunk, or 8 for a per-frame server).
    auto_step: run the stepper thread. False: the caller drives the device
    through step_once() (deterministic tests, external schedulers).
    close() stops the threads and closes every socket the front end
    opened or accepted.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 0, auto_step: bool = True):
        self.server = server
        self.max_queue = max_queue or 2 * getattr(server, "chunk", 4)
        self._lock = threading.Lock()      # guards the server and counters
        self._stop = threading.Event()
        self._frames_in = 0
        self._frames_tracked = 0
        self._steps = 0
        self._conns: list[socket.socket] = []

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address = self._sock.getsockname()

        self._threads = [threading.Thread(target=self._accept_loop,
                                          daemon=True)]
        if auto_step:
            self._threads.append(
                threading.Thread(target=self._step_loop, daemon=True))
        for t in self._threads:
            t.start()

    # -- device loop --------------------------------------------------------
    def step_once(self) -> int:
        """One explicit step (auto_step=False mode)."""
        with self._lock:
            served = self.server.step()
            if served:
                self._steps += 1
                self._frames_tracked += served
        return served

    def _step_loop(self):
        while not self._stop.is_set():
            if not self.step_once():
                time.sleep(0.002)           # idle; nothing queued

    # -- network ------------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # socket closed on shutdown
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, _REQ.size)
                magic, op, sid, plen = _REQ.unpack(hdr)
                if magic != MAGIC or plen > _MAX_PAYLOAD:
                    self._reply(conn, ST_ERR,
                                {"error": "bad magic or oversized"})
                    return
                payload = _recv_exact(conn, plen) if plen else b""
                self._handle(conn, op, sid, payload)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _reply(self, conn, status: int, obj=None):
        payload = b"" if obj is None else json.dumps(obj).encode()
        conn.sendall(_REP.pack(status, len(payload)) + payload)

    def _handle(self, conn, op: int, sid: int, payload: bytes):
        srv = self.server
        try:
            if op == OP_OPEN:
                with self._lock:
                    new_sid = srv.open_stream()
                self._reply(conn, ST_OK, {"sid": new_sid})
            elif op == OP_FRAME:
                h, w = srv.frame_h, srv.frame_w
                if len(payload) != h * w * 3:
                    self._reply(conn, ST_ERR, {
                        "error": f"frame payload {len(payload)} != "
                                 f"{h}x{w}x3"})
                    return
                frame = np.frombuffer(payload, np.uint8).reshape(h, w, 3)
                with self._lock:
                    srv._check(sid)           # KeyError on bad/unopened
                    queued = len(srv._in[sid])
                    if queued < self.max_queue:
                        srv.submit(sid, frame)
                        self._frames_in += 1
                if queued >= self.max_queue:
                    self._reply(conn, ST_BUSY, {"queued": queued})
                else:
                    self._reply(conn, ST_OK, {"queued": True})
            elif op == OP_POLL:
                with self._lock:
                    outs = srv.poll(sid)
                self._reply(conn, ST_OK, [self._tracks(o) for o in outs])
            elif op == OP_CLOSE:
                with self._lock:
                    srv.close_stream(sid)
                self._reply(conn, ST_OK, {"closed": True})
            elif op == OP_STATS:
                self._reply(conn, ST_OK, self.stats())
            else:
                self._reply(conn, ST_ERR, {"error": f"bad op {op}"})
        except (KeyError, IndexError, ValueError, RuntimeError) as e:
            self._reply(conn, ST_ERR, {"error": str(e)})

    def _tracks(self, out: dict) -> list:
        """One frame's host outputs -> emitted tracks in frame pixels."""
        srv = self.server
        return [{"id": t.track_id, "score": t.score,
                 "bbox": [round(float(v), 2) for v in t.bbox],
                 "keypoints": [[round(float(v), 2) for v in row]
                               for row in t.keypoints]}
                for t in frame_tracks(out["ids"], out["scores"],
                                      out["poses"], out["boxes"],
                                      out["emit"], srv.frame_w, srv.frame_h,
                                      srv.config.detector.input_size)]

    def stats(self) -> dict:
        with self._lock:
            return {"frames_in": self._frames_in,
                    "frames_tracked": self._frames_tracked,
                    "steps": self._steps,
                    "open_streams": int(sum(self.server._open)),
                    "max_queue": self.max_queue}

    def close(self):
        self._stop.set()
        with self._lock:
            conns = list(self._conns)
        for conn in [self._sock] + conns:   # shutdown wakes a blocked accept
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._sock.close()
        for t in self._threads:
            t.join(timeout=5.0)


class PoseClient:
    """Minimal blocking client for PoseServingFrontend (the same protocol;
    one socket per client, for one thread). timeout: seconds for the
    connection and for each reply (None waits for ever)."""

    def __init__(self, host: str, port: int, timeout: float | None = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, op: int, sid: int = -1, payload: bytes = b""):
        self._sock.sendall(_REQ.pack(MAGIC, op, sid, len(payload))
                           + payload)
        status, plen = _REP.unpack(_recv_exact(self._sock, _REP.size))
        body = _recv_exact(self._sock, plen) if plen else b""
        obj = json.loads(body) if body else None
        if status == ST_ERR:
            raise RuntimeError(obj.get("error", "server error"))
        return status, obj

    def open_stream(self) -> int:
        return self._call(OP_OPEN)[1]["sid"]

    def send_frame(self, sid: int, frame_bgr: np.ndarray) -> bool:
        """True if accepted; False on backpressure (queue full)."""
        status, _ = self._call(
            OP_FRAME, sid, np.ascontiguousarray(frame_bgr).tobytes())
        return status == ST_OK

    def poll(self, sid: int) -> list:
        """List of per-frame track lists (frame pixel coordinates)."""
        return self._call(OP_POLL, sid)[1]

    def close_stream(self, sid: int):
        self._call(OP_CLOSE, sid)

    def stats(self) -> dict:
        return self._call(OP_STATS)[1]

    def close(self):
        self._sock.close()
