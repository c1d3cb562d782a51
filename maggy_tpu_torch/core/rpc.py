"""Control-plane RPC: driver <-> executor messaging.

This is the entire control plane, the analogue of the reference's
``maggy/core/rpc.py`` (§2.4 of SURVEY.md) with the same verb set —
REG / QUERY / METRIC / FINAL / GET / LOG / EXEC_CONFIG / RESERVATIONS — but a
different transport design:

* **Framing:** 4-byte big-endian length + UTF-8 JSON. The reference frames
  cloudpickle (rpc.py:205-257); JSON removes arbitrary-code-execution risk from
  the wire and keeps messages debuggable. Functions are never shipped over this
  channel — workers receive the train_fn in-process (threads) or at launch.
* **Server:** one asyncio event loop on a daemon thread (replacing the reference's
  select() loop, rpc.py:350-381). Handlers must be non-blocking: they read
  thread-safe shared stores and enqueue heavy work for the driver's digestion
  thread — the socket loop never waits on an optimizer.
* **Auth:** every message carries the experiment secret, checked with
  ``secrets.compare_digest`` (reference rpc.py:366-375).

The client is synchronous (worker loops are plain Python), with a main socket and
a separate heartbeat socket so the heartbeat thread never interleaves frames with
the trial loop (reference rpc.py:647-651).
"""

from __future__ import annotations

import asyncio
import json
import queue
import random
import secrets as secrets_mod
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from maggy_tpu_torch import constants
from maggy_tpu_torch.exceptions import (
    ReservationTimeoutError,
    RpcError,
    RpcRejectedError,
)
from maggy_tpu_torch.resilience import chaos as chaos_mod
from maggy_tpu_torch.telemetry import flightrec
from maggy_tpu_torch.telemetry import tracing as tracing_mod

_LEN = struct.Struct(">I")


def _retry_delay(attempt: int) -> float:
    """Reconnect/retry backoff: linear base growth with a ±50% random spread.
    Without the jitter a whole pod of workers that lost the driver at the
    same instant (driver GC pause, network blip) would sleep identical
    delays and reconnect in lockstep, hammering the recovered server with a
    synchronized thundering herd. Base and retry count take env overrides
    via constants (MAGGY_TPU_RPC_RETRY_BASE / MAGGY_TPU_RPC_MAX_RETRIES)."""
    base = constants.RPC_RETRY_BASE * (attempt + 1)
    return base * (0.5 + random.random())


# --------------------------------------------------------------------------- framing


def send_frame(sock: socket.socket, payload: Dict[str, Any]) -> None:
    data = json.dumps(payload, separators=(",", ":"), default=str).encode("utf-8")
    if len(data) > constants.RPC_MAX_MESSAGE:
        raise RpcError(f"Message of {len(data)} bytes exceeds frame cap")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_frame(sock: socket.socket) -> Dict[str, Any]:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > constants.RPC_MAX_MESSAGE:
        raise RpcError(f"Incoming frame of {length} bytes exceeds cap")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(constants.RPC_BUFSIZE, n - len(buf)))
        if not chunk:
            raise RpcError("Connection closed by peer")
        buf.extend(chunk)
    return bytes(buf)


# ----------------------------------------------------------------------- reservations


class Reservations:
    """Thread-safe registry: partition_id -> registration + current trial assignment.

    The driver's scheduling substrate (reference rpc.py:45-123): the digestion
    thread writes assignments, the server's GET handler reads them.
    """

    def __init__(self, required: int):
        self.required = required
        self._lock = threading.RLock()
        self._entries: Dict[int, Dict[str, Any]] = {}
        self._assignments: Dict[int, Optional[str]] = {}

    def register(self, partition_id: int, meta: Dict[str, Any]) -> bool:
        """Returns True if a *different* worker instance had already registered this
        partition (re-registration = restarted worker; triggers lost-trial handling,
        reference rpc.py:415-437). A retried REG from the same instance carries the
        same ``attempt`` nonce and is idempotent — a lost reply must not look like
        a worker restart."""
        with self._lock:
            prev = self._entries.get(partition_id)
            restarted = prev is not None and prev.get("attempt") != meta.get("attempt")
            self._entries[partition_id] = dict(meta)
            if prev is None:
                self._assignments.setdefault(partition_id, None)
            return restarted

    def done(self) -> bool:
        with self._lock:
            return len(self._entries) >= self.required

    def count(self) -> int:
        with self._lock:
            return len(self._entries)

    def assign_trial(self, partition_id: int, trial_id: Optional[str]) -> None:
        with self._lock:
            self._assignments[partition_id] = trial_id

    def get_assignment(self, partition_id: int) -> Optional[str]:
        with self._lock:
            return self._assignments.get(partition_id)

    def get_assignments(self) -> Dict[int, Optional[str]]:
        with self._lock:
            return dict(self._assignments)

    def cluster_spec(self) -> List[Dict[str, Any]]:
        """All registrations ordered by partition id — the EXEC_CONFIG payload that
        lets rank 0 become the coordinator (reference rpc.py:544-553)."""
        with self._lock:
            return [
                {"partition_id": pid, **self._entries[pid]}
                for pid in sorted(self._entries)
            ]


# ---------------------------------------------------------------------------- server


class Server:
    """Asyncio TCP control-plane server owned by the experiment driver.

    ``callbacks`` maps verb -> handler(msg_dict) -> reply_dict. Handlers run on
    the event loop and must not block; anything heavy goes through
    ``message_queue`` to the driver's digestion thread.
    """

    def __init__(self, num_executors: int, secret: Optional[str] = None):
        self.reservations = Reservations(num_executors)
        self.secret = secret or secrets_mod.token_hex(16)
        # driver-owned telemetry recorder (set by Driver.init); _dispatch
        # records per-verb handler counts/latencies into it
        self.telemetry = None
        self.message_queue: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.callbacks: Dict[str, Callable[[Dict[str, Any]], Dict[str, Any]]] = {}
        # the four attributes below are published by the server thread
        # before it calls _started.set(); every other-thread reader first
        # waits on the Event, so the Event's release/acquire pair orders
        # the writes before the reads (stop() additionally only hands
        # _loop to call_soon_threadsafe, the documented thread-safe seam)
        self._loop: Optional[asyncio.AbstractEventLoop] = None  # race: ok — published before _started.set(); readers wait on the Event
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None  # race: ok — published before _started.set(); readers wait on the Event
        self.host = "127.0.0.1"  # race: ok — published before _started.set(); readers wait on the Event
        self.port = 0  # race: ok — published before _started.set(); readers wait on the Event

    # ------------------------------------------------------------------ lifecycle

    def start(self, host: str = "0.0.0.0", port: int = 0) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self._run_loop, args=(host, port), name="maggy-rpc-server", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            if self._start_error is not None:
                raise RpcError(
                    f"RPC server failed to start: {self._start_error}"
                ) from self._start_error
            raise RpcError("RPC server failed to start within 10s")
        if self._start_error is not None:  # e.g. EADDRINUSE on a preset port
            raise RpcError(
                f"RPC server failed to start: {self._start_error}"
            ) from self._start_error
        return self.host, self.port

    def _run_loop(self, host: str, port: int) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def _main():
            try:
                self._server = await asyncio.start_server(
                    self._handle_client, host, port
                )
            except OSError as e:  # surface EADDRINUSE etc. to start()
                self._start_error = e
                self._started.set()
                return
            sockname = self._server.sockets[0].getsockname()
            self.host = "127.0.0.1" if host in ("0.0.0.0", "") else host
            self.port = sockname[1]
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        try:
            self._loop.run_until_complete(_main())
        except asyncio.CancelledError:
            pass
        finally:
            try:
                pending = asyncio.all_tasks(self._loop)
                for t in pending:
                    t.cancel()
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            finally:
                self._loop.close()

    def stop(self) -> None:
        if self._loop and self._loop.is_running():

            def _shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------------ handling

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Per-connection loop, hardened against hostile/buggy peers: an
        oversized declared length gets an ERR reply and a close (the payload
        cannot be skipped safely); a correctly-framed garbage payload (bad
        JSON, or JSON that isn't an object) gets an ERR reply and the loop
        continues — framing is still aligned; a truncated frame (peer died
        mid-send) ends the connection silently. Every path is strictly
        per-connection: the accept loop and other clients never notice."""

        async def _reply(payload: Dict[str, Any]) -> None:
            data = json.dumps(payload, separators=(",", ":"), default=str).encode()
            writer.write(_LEN.pack(len(data)) + data)
            await writer.drain()

        def _frame_err(what: str) -> None:
            if self.telemetry is not None:
                self.telemetry.count(f"rpc_frame_errors.{what}")

        try:
            while True:
                header = await reader.readexactly(_LEN.size)
                (length,) = _LEN.unpack(header)
                if length > constants.RPC_MAX_MESSAGE:
                    _frame_err("oversized")
                    await _reply(
                        {
                            "type": "ERR",
                            "error": f"frame of {length} bytes exceeds cap "
                            f"({constants.RPC_MAX_MESSAGE})",
                        }
                    )
                    break
                raw = await reader.readexactly(length)
                try:
                    msg = json.loads(raw.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    _frame_err("garbage")
                    await _reply({"type": "ERR", "error": "malformed frame payload"})
                    continue
                if not isinstance(msg, dict):
                    _frame_err("not_object")
                    await _reply(
                        {"type": "ERR", "error": "frame payload must be a JSON object"}
                    )
                    continue
                reply = self._dispatch(msg)
                await _reply(reply)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 - peer already gone; close is best-effort
                pass

    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        if not secrets_mod.compare_digest(str(msg.get("secret", "")), self.secret):
            return {"type": "ERR", "error": "bad secret"}
        verb = msg.get("type", "")
        # stall watchdog: the mark is armed for the whole dispatch —
        # including an injected chaos stall, which wedges the event loop
        # exactly like a stuck driver host — so a reply that never comes
        # back trips a flight-recorder dump (docs/observability.md)
        wd = flightrec.get()
        wd.begin(f"rpc.{verb}")
        try:
            ch = chaos_mod.get()
            if ch is not None:
                # chaos harness only: a matching rpc_stall rule delays this
                # verb's reply — deliberately blocking the event loop, the
                # way a wedged driver host stalls every connection at once
                stall = ch.rpc_stall(verb)
                if stall > 0:
                    time.sleep(stall)
            handler = self.callbacks.get(verb)
            if handler is None:
                return {"type": "ERR", "error": f"unknown verb {verb!r}"}
            tel = self.telemetry
            t0 = time.perf_counter() if tel is not None else 0.0
            try:
                # the frame's trace id becomes ambient for the handler, so
                # everything it records correlates with the caller's request
                with tracing_mod.scope(msg.get("trace")):
                    reply = handler(msg)
            except Exception as e:  # handler bugs must not kill the socket loop
                if tel is not None:
                    tel.rpc(f"srv.{verb}", (time.perf_counter() - t0) * 1e3, ok=False)
                return {"type": "ERR", "error": f"{type(e).__name__}: {e}"}
            if tel is not None:
                tel.rpc(f"srv.{verb}", (time.perf_counter() - t0) * 1e3)
            return reply if reply is not None else {"type": "OK"}
        finally:
            wd.end(f"rpc.{verb}")

    # ------------------------------------------------------------------ helpers

    def register_callback(self, verb: str, handler) -> None:
        self.callbacks[verb] = handler

    def register_metrics(self, source) -> None:
        """Expose a time-series store (or stores) under the ``METRICS`` verb.

        ``source`` is a zero-arg callable returning the reply body — usually
        a closure over ``SeriesStore.snapshot()`` — or a store itself. The
        reply is ``{"type": "METRICS", ...body}``; handlers run on the event
        loop, and ``snapshot()`` only copies bounded rings, so this is safe
        to serve while the owner keeps sampling."""

        def _on_metrics(_msg: Dict[str, Any]) -> Dict[str, Any]:
            body = source() if callable(source) else source.snapshot()
            out = {"type": "METRICS"}
            out.update(body or {})
            return out

        self.register_callback("METRICS", _on_metrics)

    def enqueue(self, msg: Dict[str, Any]) -> None:
        self.message_queue.put(msg)

    def await_reservations(
        self, timeout: float = constants.RESERVATION_TIMEOUT, abort: Optional[threading.Event] = None
    ) -> None:
        """Block until all executors registered (reference rpc.py:282-305)."""
        deadline = time.time() + timeout
        while not self.reservations.done():
            if abort is not None and abort.is_set():
                raise RpcError("Experiment aborted while awaiting reservations")
            if time.time() > deadline:
                raise ReservationTimeoutError(
                    self.reservations.count(), self.reservations.required, timeout
                )
            time.sleep(0.01)


# ---------------------------------------------------------------------------- client


class Client:
    """Synchronous worker-side client (reference rpc.py:636-802).

    Two sockets: the main socket serves the trial loop (register / GET / FINAL);
    the heartbeat socket belongs to the heartbeat thread, which drains the
    reporter every ``hb_interval`` seconds, sends METRIC, and flips the
    reporter's early-stop flag when the driver replies STOP.
    """

    def __init__(
        self,
        server_addr: Tuple[str, int],
        partition_id: int,
        secret: str,
        hb_interval: float = 1.0,
        telemetry=None,
    ):
        self.server_addr = tuple(server_addr)
        self.partition_id = partition_id
        self.secret = secret
        self.hb_interval = hb_interval
        # worker recorder: per-verb client latencies + heartbeat RTT land
        # here, and each beat attaches its snapshot for the driver's STATUS
        # aggregation. An explicit reference (not the thread-ambient getter)
        # because the heartbeat runs on its own thread.
        self.telemetry = telemetry
        # one nonce per client instance: lets the server tell a retried REG
        # (same nonce) from a restarted worker (new nonce)
        self.attempt_id = secrets_mod.token_hex(8)
        # elastic membership (docs/resilience.md): the executor installs its
        # MembershipMonitor here; every beat then reports the epoch the
        # worker is running under, and a RESHAPE reply signals the monitor
        self.membership = None
        self._main_sock = self._connect()  # guarded-by: _main_lock
        self._main_lock = threading.Lock()
        self._hb_sock: Optional[socket.socket] = None  # race: ok — heartbeat-thread-confined between start_heartbeat() and the post-join close in stop()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()

    def _connect(self) -> socket.socket:
        last_err = None
        for attempt in range(constants.RPC_MAX_RETRIES):
            try:
                sock = socket.create_connection(self.server_addr, timeout=30)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError as e:
                last_err = e
                time.sleep(_retry_delay(attempt))
        raise RpcError(f"Could not connect to driver at {self.server_addr}: {last_err}")

    def _request(self, msg: Dict[str, Any], heartbeat: bool = False) -> Dict[str, Any]:
        """Send one frame and read the reply, reconnecting up to MAX_RETRIES
        (reference rpc.py:660-688)."""
        verb = msg.get("type", "?")
        msg = {**msg, "secret": self.secret, "partition_id": self.partition_id}
        if "trace" not in msg:
            # propagate the thread-ambient trace id on every frame — the
            # server re-installs it around its handler, so one request's
            # records correlate across processes (docs/observability.md)
            trace = tracing_mod.current()
            if trace is not None:
                msg["trace"] = trace
        last_err: Optional[Exception] = None
        tel = self.telemetry
        for attempt in range(constants.RPC_MAX_RETRIES):
            try:
                t0 = time.perf_counter()
                if heartbeat:
                    send_frame(self._hb_sock, msg)
                    reply = recv_frame(self._hb_sock)
                else:
                    with self._main_lock:
                        send_frame(self._main_sock, msg)  # blocking: ok — _main_lock exists to serialize whole round-trips on the shared main socket
                        reply = recv_frame(self._main_sock)  # blocking: ok — _main_lock exists to serialize whole round-trips on the shared main socket
                if tel is not None:
                    tel.rpc(verb, (time.perf_counter() - t0) * 1e3)
                if reply.get("type") == "ERR":
                    raise RpcRejectedError(
                        f"Driver rejected message: {reply.get('error')}"
                    )
                return reply
            except (OSError, RpcError) as e:
                if isinstance(e, RpcRejectedError):
                    raise
                if tel is not None:
                    tel.rpc(verb, None, ok=False)
                last_err = e
                time.sleep(_retry_delay(attempt))
                try:
                    if heartbeat:
                        self._hb_sock.close()
                        self._hb_sock = self._connect()
                    else:
                        with self._main_lock:
                            self._main_sock.close()
                            self._main_sock = self._connect()
                except RpcError:
                    pass
        raise RpcError(f"Request {msg.get('type')} failed after retries: {last_err}")

    # public alias: non-worker callers (serve client/router, monitor) speak
    # ad-hoc verbs over the same socket discipline — give them a supported
    # name instead of the private underscore
    request = _request

    # ------------------------------------------------------------------ verbs

    def register(self, meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._request(
            {"type": "REG", "meta": {**(meta or {}), "attempt": self.attempt_id}}
        )

    def await_reservations(
        self, timeout: float = constants.RESERVATION_TIMEOUT
    ) -> None:
        deadline = time.time() + timeout
        while True:
            reply = self._request({"type": "QUERY"})
            if reply.get("ready"):
                return
            if time.time() > deadline:
                raise RpcError("Timed out waiting for all executors to register")
            time.sleep(constants.POLL_INTERVAL)

    def get_suggestion(self, poll: float = constants.POLL_INTERVAL) -> Dict[str, Any]:
        """Blocking poll for the next trial; returns the TRIAL or GSTOP reply
        (reference rpc.py:739-748).

        Adaptive backoff: right after FINAL the driver's digestion thread
        assigns the next trial within ~a millisecond, so the first retries
        come fast (2 ms, doubling) and only a genuinely idle executor backs
        off to the full ``poll`` interval — "executors always busy" is the
        reference's one published claim (DistributedML'20), and a fixed
        50 ms first retry measurably taxed it (tools/bench_async_vs_bsp.py)."""
        delay = 0.002
        while True:
            reply = self._request({"type": "GET"})
            if reply.get("type") in ("TRIAL", "GSTOP"):
                return reply
            time.sleep(delay)
            delay = min(delay * 2, poll)

    def finalize_metric(
        self,
        trial_id: str,
        metric: Optional[float],
        outputs: Optional[Dict[str, Any]] = None,
        error: Optional[str] = None,
        early_stopped: bool = False,
    ) -> None:
        self._request(
            {
                "type": "FINAL",
                "trial_id": trial_id,
                "metric": metric,
                "outputs": outputs or {},
                "error": error,
                "early_stopped": early_stopped,
            }
        )

    def get_message(self, verb: str, timeout: float = 60.0) -> Dict[str, Any]:
        """Generic typed fetch with timeout (reference rpc.py:750-762)."""
        deadline = time.time() + timeout
        while True:
            reply = self._request({"type": verb})
            if reply.get("type") == verb:
                return reply
            if time.time() > deadline:
                raise RpcError(f"No {verb} reply within {timeout}s")
            time.sleep(constants.POLL_INTERVAL)

    # ------------------------------------------------------------------ heartbeat

    def start_heartbeat(self, reporter) -> None:
        self._hb_sock = self._connect()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            args=(reporter,),
            name=f"maggy-heartbeat-{self.partition_id}",
            daemon=True,
        )
        self._hb_thread.start()

    def _heartbeat_loop(self, reporter) -> None:
        """Reference rpc.py:716-737: drain reporter -> METRIC -> handle STOP reply."""
        while not self._hb_stop.wait(self.hb_interval):
            self._send_beat(reporter)
        self._send_beat(reporter)  # final flush so no metrics/logs are lost

    def _send_beat(self, reporter) -> None:
        ch = chaos_mod.get()
        if ch is not None and ch.drop_heartbeat(self.partition_id):
            return  # chaos: this worker goes silent for a beat
        trial_id, metric, step, logs = reporter.get_data()
        tel = self.telemetry
        beat = {
            "type": "METRIC",
            "trial_id": trial_id,
            "metric": metric,
            "step": step,
            "logs": logs,
        }
        membership = self.membership
        if membership is not None:
            # the driver compares this against its membership view and
            # replies RESHAPE when this worker is running a stale epoch
            beat["epoch"] = membership.epoch
        if tel is not None and tel.active:
            snap = tel.snapshot()
            if snap:
                beat["telemetry"] = snap
        t0 = time.perf_counter()
        try:
            reply = self._request(beat, heartbeat=True)
        except RpcError:
            return  # skip this beat; next one reconnects
        if tel is not None:
            # driver round-trip as seen by the worker: control-plane health
            tel.gauge("heartbeat_rtt_ms", (time.perf_counter() - t0) * 1e3)
            # heartbeat cadence doubles as the durable-flush cadence: events
            # reach the JSONL sink every beat, so a crash loses <=1 interval
            tel.flush()
        if reply.get("type") == "STOP":
            reporter.early_stop()
        elif reply.get("type") == "RESHAPE" and membership is not None:
            # membership moved: Trainer.fit sees the pending epoch at its
            # next step boundary and raises MembershipChanged
            membership.signal(reply.get("epoch"))

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=2 * self.hb_interval + 5)
        for sock in (self._hb_sock, self._main_sock):  # race: ok — shutdown path after hb join; a racing close raises OSError, swallowed below
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
