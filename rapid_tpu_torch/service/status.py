"""Live status API for resident runs: atomic file + line-protocol socket.

The port's own copy of the reference's status API (standard library
only): the same file, the same socket protocol, the same frames.

A resident service is only observable through its JSONL sink today,
which nothing external can poll mid-run. This module publishes the
latest chunk-boundary snapshot two read-only ways:

- **status file** — the snapshot JSON is written to ``<path>.tmp`` and
  ``os.replace``d over ``<path>``, so a reader never sees a torn
  document (rename is atomic on POSIX);
- **status socket** — a unix-domain stream socket speaking a one-line
  protocol: a client sends ``status\\n`` and receives the latest
  snapshot as one JSON line, or sends ``watch\\n`` and receives the
  latest snapshot followed by every subsequent one until it
  disconnects. Unknown commands answer one ``{"error": ...}`` line.

Non-perturbation is the design invariant (``tests/test_torch_stream.py``
holds the non-wall records equal with the socket on and off):
``publish`` consumes an already-drained host-side dict — it
never touches device state, never blocks the engine loop (watch fan-out
is bounded ``put_nowait`` queues; a slow subscriber drops frames, the
engine never waits), and every socket client is served from its own
thread.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import threading
from typing import List, Optional

from rapid_tpu_torch.telemetry import json_artifact_line

#: Frames a slow ``watch`` subscriber may buffer before older frames
#: are dropped (the publisher never blocks on a reader).
WATCH_QUEUE_DEPTH = 64


class StatusFile:
    """Atomically-replaced status JSON document."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = path + ".tmp"

    def publish(self, line: str) -> None:
        with open(self._tmp, "w") as fh:
            fh.write(line)
        os.replace(self._tmp, self.path)

    def close(self) -> None:
        pass


class StatusSocket:
    """Unix-domain line-protocol endpoint serving the latest snapshot."""

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._latest: Optional[str] = None
        self._lock = threading.Lock()
        self._watchers: List[queue.Queue] = []
        self._closed = threading.Event()
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(path)
        self._server.listen(8)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="status-accept", daemon=True)
        self._accept_thread.start()

    # --- publisher side (the engine loop) --------------------------------

    def publish(self, line: str) -> None:
        with self._lock:
            self._latest = line
            for q in self._watchers:
                try:
                    q.put_nowait(line)
                except queue.Full:
                    # Drop the oldest frame for this subscriber; the
                    # publisher must never block on a slow reader.
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait(line)
                    except queue.Full:
                        pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._server.close()
        finally:
            if os.path.exists(self.path):
                os.unlink(self.path)
        with self._lock:
            for q in self._watchers:
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass

    # --- subscriber side --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="status-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("rw", encoding="utf-8",
                                     newline="\n") as fh:
                for raw in fh:
                    cmd = raw.strip()
                    if cmd == "status":
                        with self._lock:
                            latest = self._latest
                        fh.write(latest if latest is not None
                                 else '{"error": "no snapshot yet"}\n')
                        fh.flush()
                    elif cmd == "watch":
                        self._watch(fh)
                        return
                    elif cmd:
                        fh.write(json.dumps(
                            {"error": f"unknown command {cmd!r}"}) + "\n")
                        fh.flush()
        except (OSError, ValueError):
            pass  # client went away mid-write; nothing to clean up

    def _watch(self, fh) -> None:
        q: queue.Queue = queue.Queue(maxsize=WATCH_QUEUE_DEPTH)
        with self._lock:
            latest = self._latest
            self._watchers.append(q)
        try:
            if latest is not None:
                fh.write(latest)
                fh.flush()
            while not self._closed.is_set():
                try:
                    line = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                if line is None:
                    return
                fh.write(line)
                fh.flush()
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                if q in self._watchers:
                    self._watchers.remove(q)


class StatusPublisher:
    """File and/or socket fan-out for one resident run's snapshots."""

    def __init__(self, file_path: Optional[str] = None,
                 socket_path: Optional[str] = None):
        self._outs = []
        if file_path:
            self._outs.append(StatusFile(file_path))
        if socket_path:
            self._outs.append(StatusSocket(socket_path))

    def publish(self, snapshot: dict) -> None:
        line = json_artifact_line(snapshot, sort_keys=True)
        for out in self._outs:
            out.publish(line)

    def close(self) -> None:
        for out in self._outs:
            out.close()


def read_status(socket_path: str, command: str = "status",
                max_lines: int = 1, timeout: float = 10.0) -> List[dict]:
    """Tiny line-protocol client (tests and smokes): send one command,
    collect up to ``max_lines`` snapshot lines."""
    out: List[dict] = []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sk:
        sk.settimeout(timeout)
        sk.connect(socket_path)
        sk.sendall((command + "\n").encode())
        with sk.makefile("r", encoding="utf-8") as fh:
            for line in fh:
                out.append(json.loads(line))
                if len(out) >= max_lines:
                    break
    return out
