"""JSONL telemetry sink on the env storage seam.

Records land under ``<exp_dir>/telemetry/worker_<pid>.jsonl`` — identically on
a local disk (the JAX package's ``gs://`` env is ROADMAP queue 1 item 9).
Local roots append per flush; remote object stores cannot append, so the sink
buffers the full record history and republishes the whole object each flush
(bounded, same trade the Reporter's remote log makes).

**Rotation (local roots):** a multi-day serve fleet would grow one unbounded
file, so when a worker file passes ``max_bytes``
(``MAGGY_TPU_TELEMETRY_MAX_BYTES``, default 64 MiB) it is rotated shift-style
— ``worker_0.jsonl`` → ``worker_0.jsonl.1`` → ``.2`` … up to
``max_segments``, oldest dropped. The exporters
(:func:`maggy_tpu_torch.telemetry.export.load_records`) and
``tools/analyze_trace.py`` read rotated segments oldest-first, so rotation is
invisible to every consumer.
"""

from __future__ import annotations

import json
import os
import posixpath
import threading
from typing import Any, Dict, List, Optional

# remote (object-store) sinks cap the republished history; oldest records are
# dropped with an explicit truncation marker, mirroring Reporter's remote log
_REMOTE_MAX_RECORDS = 50_000

ENV_MAX_BYTES = "MAGGY_TPU_TELEMETRY_MAX_BYTES"
DEFAULT_MAX_BYTES = 64 << 20  # per segment, before rotation
DEFAULT_MAX_SEGMENTS = 4  # rotated segments kept beside the live file


def telemetry_dir(exp_dir: str) -> str:
    return posixpath.join(str(exp_dir), "telemetry")


def default_max_bytes() -> int:
    try:
        return int(os.environ[ENV_MAX_BYTES])
    except (KeyError, ValueError):
        return DEFAULT_MAX_BYTES


class JsonlSink:
    """Append-oriented JSONL writer for one worker's telemetry file."""

    def __init__(
        self,
        path: str,
        env=None,
        max_bytes: Optional[int] = None,
        max_segments: int = DEFAULT_MAX_SEGMENTS,
    ):
        self.path = str(path)
        self._env = env
        self._remote = "://" in self.path
        self.max_bytes = default_max_bytes() if max_bytes is None else int(max_bytes)
        self.max_segments = max(1, int(max_segments))
        self._history: List[str] = []
        self._truncated = 0
        self._closed = False
        self._size: Optional[int] = None  # lazy: current segment's byte size
        # a sink may be shared by recorders flushing from different threads;
        # the rotate-then-append sequence must be atomic or a rotation racing
        # a write drops/interleaves records
        self._lock = threading.Lock()

    @property
    def env(self):
        if self._env is None:
            from maggy_tpu_torch.core.env import EnvSing

            self._env = EnvSing.get_instance()
        return self._env

    def _rotate(self) -> None:  # guarded-by: _lock
        """Shift-rotate the live file: ``.jsonl`` -> ``.jsonl.1`` -> … up to
        ``max_segments`` (oldest removed). Local filesystem only — the
        remote path bounds history by republishing instead."""
        oldest = f"{self.path}.{self.max_segments}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_segments - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")
        self._size = 0

    def write(self, records: List[Dict[str, Any]]) -> None:  # thread-entry — recorders flush from heartbeat/flusher threads
        if self._closed or not records:
            return
        lines = [
            json.dumps(rec, separators=(",", ":"), default=str) for rec in records
        ]
        try:
            if self._remote:
                with self._lock:
                    self._history.extend(lines)
                    if len(self._history) > _REMOTE_MAX_RECORDS:
                        dropped = len(self._history) - _REMOTE_MAX_RECORDS
                        self._history = self._history[dropped:]
                        self._truncated += dropped
                    head = (
                        [json.dumps({"kind": "truncated", "dropped": self._truncated})]
                        if self._truncated
                        else []
                    )
                    body = "\n".join(head + self._history) + "\n"
                self.env.dump(body, self.path)
            else:
                data = "\n".join(lines) + "\n"
                with self._lock:
                    if self._size is None:  # first write: adopt an existing file
                        try:
                            self._size = os.path.getsize(self.path)
                        except OSError:
                            self._size = 0
                    if self._size and self._size + len(data) > self.max_bytes:
                        self._rotate()
                    with self.env.open_file(self.path, "a") as f:
                        f.write(data)
                    self._size += len(data)
        except Exception:  # noqa: BLE001 - telemetry is best-effort, never fatal
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._history = []


def worker_telemetry(partition_id, exp_dir: str, role: str = "worker", env=None):
    """Build a worker's recorder with its JSONL sink attached — or the shared
    no-op recorder when ``MAGGY_TPU_TELEMETRY=0``, so executors need no flag
    checks of their own. Also points the process stall watchdog's dump dir
    at ``<exp_dir>/telemetry/`` so flight-recorder dumps land beside the
    JSONL they explain."""
    from maggy_tpu_torch.telemetry import flightrec, recorder

    if not recorder.enabled():
        return recorder.NULL
    tel = recorder.Telemetry(worker=partition_id, role=role)
    tdir = telemetry_dir(exp_dir)
    tel.attach_sink(JsonlSink(posixpath.join(tdir, f"worker_{partition_id}.jsonl" if role != "driver" else "driver.jsonl"), env=env))
    flightrec.get().configure(dump_dir=tdir, env=env)
    return tel
