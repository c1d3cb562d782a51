"""RPC front-end for the serving engine.

A copy of :mod:`maggy_tpu.serve.server`. Rides the control-plane transport
(:mod:`maggy_tpu_torch.core.rpc` —
length-framed JSON over TCP, secret-authenticated) with a serving verb set:

* ``SUBMIT``  — ``{prompt: [int], temperature, top_k, max_new, eos_id,
  seed, deadline_s}`` -> ``{id}``
* ``POLL``    — ``{id}`` -> request snapshot (``state``, ``tokens``,
  ``ttft_ms``, ``done``)
* ``CANCEL``  — ``{id}`` -> ``{cancelled: bool}``
* ``SSTATS``  — scheduler/engine stats (queue depth, slot occupancy,
  tokens/sec, TTFT percentiles, compile counts)
* ``METRICS`` — the scheduler's time-series store as a versioned snapshot
  (``telemetry/timeseries.py``), for the router's fleet merge and
  ``tools/metrics_query.py``
* ``STATUS`` / ``LOG`` — the monitor's dashboard verbs
  (:mod:`maggy_tpu_torch.monitor`).

Handlers only touch the scheduler's lock-guarded host state — never device
work — so the socket loop stays responsive under load (the same contract the
experiment driver's handlers follow).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from maggy_tpu_torch import telemetry
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.serve.request import SamplingParams
from maggy_tpu_torch.serve.scheduler import Scheduler


class ServeServer:
    """Owns the RPC server + scheduler pair for one serving process."""

    def __init__(
        self,
        scheduler: Scheduler,
        secret: Optional[str] = None,
        name: str = "maggy-serve",
        telemetry_recorder=None,
    ):
        self.scheduler = scheduler
        self.name = name
        self.telemetry = telemetry_recorder or scheduler.telemetry or telemetry.get()
        self._rpc = rpc.Server(num_executors=0, secret=secret)
        self._rpc.telemetry = self.telemetry
        self._log: deque = deque(maxlen=500)
        self._started_ts = time.time()
        for verb, handler in (
            ("SUBMIT", self._on_submit),
            ("POLL", self._on_poll),
            ("CANCEL", self._on_cancel),
            ("SSTATS", self._on_stats),
            ("STATUS", self._on_status),
            ("LOG", self._on_log),
        ):
            self._rpc.register_callback(verb, handler)
        self._rpc.register_metrics(self._metrics_body)

    @property
    def secret(self) -> str:
        return self._rpc.secret

    # -------------------------------------------------------------- lifecycle

    def start(self, host: str = "0.0.0.0", port: int = 0) -> Tuple[str, int]:
        addr = self._rpc.start(host=host, port=port)
        self.scheduler.start()
        self.log(f"serving on {addr[0]}:{addr[1]} "
                 f"({self.scheduler.engine.slots.num_slots} slots)")
        return addr

    def stop(self) -> None:
        self.scheduler.stop()
        self._rpc.stop()

    def log(self, line: str) -> None:
        self._log.append(f"[{time.strftime('%H:%M:%S')}] {line}")

    # ----------------------------------------------------------------- verbs

    def _on_submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        prompt = msg.get("prompt")
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            raise ValueError("prompt must be a list of token ids")
        params = SamplingParams(
            temperature=float(msg.get("temperature", 0.0)),
            top_k=int(msg.get("top_k", 0)),
            max_new=int(msg.get("max_new", 16)),
            eos_id=int(msg.get("eos_id", -1)),
            seed=int(msg.get("seed", 0)),
        )
        deadline_s = msg.get("deadline_s")
        req = self.scheduler.submit(
            prompt,
            params,
            deadline_s=float(deadline_s) if deadline_s else None,
            # the frame's trace id (client- or router-minted) keeps this
            # request's lifecycle correlated end to end
            trace=msg.get("trace"),
            tenant=msg.get("tenant"),
            qos=msg.get("qos"),
        )
        self.log(f"submit {req.id} len={len(prompt)} max_new={params.max_new}")
        return {"type": "SUBMIT", "id": req.id}

    def _on_poll(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"type": "POLL", **self.scheduler.poll(str(msg.get("id")))}

    def _on_cancel(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        cancelled = self.scheduler.cancel(str(msg.get("id")))
        if cancelled:
            self.log(f"cancel {msg.get('id')}")
        return {"type": "CANCEL", "cancelled": cancelled}

    def _on_stats(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"type": "SSTATS", **self.scheduler.stats()}

    def _metrics_body(self) -> Dict[str, Any]:
        sched = self.scheduler
        return {
            "scope": "worker",
            "metrics": sched.metrics.snapshot(),
            "alerts": sched.alerts.firing() + sched.sentinel.firing(),
        }

    def _on_status(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """The monitor dashboard's STATUS shape, serving flavour."""
        stats = self.scheduler.stats()
        status: Dict[str, Any] = {
            "type": "STATUS",
            "name": self.name,
            "kind": "serve",
            "state": "serving",
            "app_id": self.name,
            "run_id": 0,
            "elapsed_s": time.time() - self._started_ts,
            "serve": stats,
        }
        tel = self.telemetry
        if getattr(tel, "active", False):
            snap = tel.snapshot()
            if snap:
                status["telemetry"] = {"serve": snap}
        return status

    def _on_log(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        lines = list(self._log)
        self._log.clear()
        s = self.scheduler.stats()
        progress = (
            f"slots {s['active_slots']}/{s['num_slots']}  "
            f"queue {s['queue_depth']}  done {s['requests_done']}"
        )
        return {"type": "LOG", "logs": lines, "progress": progress}
