"""Prefill worker: the compute-bound half of disaggregated serving.

The port's counterpart of :mod:`maggy_tpu.serve.fleet.prefill`. Prefill is
compute-bound (one big batched forward over the prompt), decode is
memory-bound (one token per step). Mixing them on one replica makes every
decode wave stall behind whichever prompt is currently prefilling. A fleet
can instead tag replicas ``role="prefill"``
(:class:`~maggy_tpu_torch.serve.fleet.replica.ReplicaSpec`): the router
sends each SUBMIT's prompt to a prefill replica first, then hands the
resulting KV pack to a decode replica, which admits it without running the
prompt (``Engine.admit_from_kv``).

The handoff payload is :meth:`Engine.prefill_only`'s host-resident pack
(CPU tensors, as JAX's is numpy leaves); the decode replica copies it onto
its own card. In-process replicas pass the pack by reference. ``req.prefilled``
and ``req.handoff`` trace events plus the ``serve.handoff_ms`` histogram make
the hop visible on each request's trace lane.

A :class:`PrefillWorker` wraps a prefill-role replica's engine behind a
lock (prefill programs are single-threaded by engine contract) and runs on
the router's pump thread, which it points at the engine's card first. If
every prefill replica is down, the router falls back to plain dispatch —
decode replicas still own a full engine, so disaggregation degrades to the
classic path instead of an outage.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

from maggy_tpu_torch.serve.request import SamplingParams


class PrefillWorkerError(RuntimeError):
    """Prefill-side failure; the router falls back to plain dispatch."""


class PrefillWorker:
    """Router-owned prefill front over a ``role="prefill"`` replica."""

    def __init__(self, replica):
        self.replica = replica
        self._lock = threading.Lock()
        self.prefills = 0

    @property
    def index(self) -> int:
        return self.replica.index

    def alive(self) -> bool:
        return self.replica.alive() and self.replica.server is not None

    def prefill(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Run one SUBMIT payload's prompt on the prefill replica's engine
        and return the host-resident KV pack (``Engine.prefill_only``)."""
        server = self.replica.server
        if not self.alive() or server is None:
            raise PrefillWorkerError(f"prefill replica {self.index} is down")
        params = SamplingParams(
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            max_new=int(payload.get("max_new", 16)),
            eos_id=int(payload.get("eos_id", -1)),
            seed=int(payload.get("seed", 0)),
        )
        try:
            engine = server.scheduler.engine
            with self._lock, engine.host_lock:
                if engine.device.type == "cuda":
                    # the pump thread's current card is not the engine's
                    torch.cuda.set_device(engine.device)
                pack = engine.prefill_only(payload["prompt"], params)
        except Exception as e:  # noqa: BLE001 - surface as a worker failure, router falls back
            raise PrefillWorkerError(
                f"prefill on replica {self.index} failed: "
                f"{type(e).__name__}: {e}"
            ) from e
        self.prefills += 1
        return pack


def pick_worker(workers, cursor: int) -> Optional[PrefillWorker]:
    """Round-robin over live prefill workers (None when all are down)."""
    if not workers:
        return None
    for offset in range(len(workers)):
        w = workers[(cursor + offset) % len(workers)]
        if w.alive():
            return w
    return None
