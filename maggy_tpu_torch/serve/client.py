"""Synchronous Python client for the serving front-end.

A copy of :mod:`maggy_tpu.serve.client`. Thin wrapper over the
control-plane :class:`maggy_tpu_torch.core.rpc.Client`
(framed JSON, secret-authenticated, auto-reconnect) speaking the serving
verbs against a single engine OR a fleet router — the verb set is
identical. One socket per client; safe to use from multiple threads (the
underlying client serializes the main socket).

    client = ServeClient((host, port), secret)
    rid = client.submit([1, 2, 3], max_new=8)
    result = client.result(rid, timeout=30)   # poll until terminal
    print(result["tokens"])

**Failover (default):** a transport-level failure (connection loss, server
restart) is retried with the control plane's jittered backoff instead of
raised on first error — the transparent-failover contract the fleet needs:
a replica dying mid-request surfaces to a polling client only as a
``state="requeued"`` snapshot, never an exception, and a briefly
unreachable router heals under the same backoff. Note SUBMIT retries are
at-least-once: a submit whose reply was lost may have landed, so a retried
submit can duplicate work (never corrupt it — requests are independent).
Rejections (validation errors) and 429-style ``BUSY`` sheds are typed
(:class:`~maggy_tpu_torch.exceptions.RpcRejectedError` /
:class:`~maggy_tpu_torch.exceptions.ServerBusyError`) and never retried unless
``submit(retry_busy=N)`` asks for BUSY re-tries.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from maggy_tpu_torch import constants
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.exceptions import RpcError, RpcRejectedError, ServerBusyError
from maggy_tpu_torch.telemetry import tracing


class ServeClient:
    def __init__(
        self,
        server_addr: Tuple[str, int],
        secret: str,
        failover: bool = True,
        max_retries: Optional[int] = None,
    ):
        self._client = rpc.Client(tuple(server_addr), partition_id=-1, secret=secret)
        self.failover = failover
        self.max_retries = (
            constants.RPC_MAX_RETRIES if max_retries is None else int(max_retries)
        )

    def _call(self, msg: Dict[str, Any], retry_busy: int = 0) -> Dict[str, Any]:
        """One verb round-trip with the failover ladder: transport errors
        (the rpc client already reconnect-retried underneath) get the same
        jittered backoff again up to ``max_retries``; BUSY replies retry
        only within the caller's ``retry_busy`` budget; rejections raise
        immediately."""
        attempts = max(1, self.max_retries if self.failover else 1)
        busy_left = int(retry_busy)
        last_err: Optional[Exception] = None
        attempt = 0
        while attempt < attempts:
            try:
                reply = self._client.request(msg)
            except RpcRejectedError:
                raise
            except (RpcError, OSError) as e:
                last_err = e
                attempt += 1
                if attempt >= attempts:
                    break
                time.sleep(rpc._retry_delay(attempt - 1))
                continue
            if reply.get("type") == "BUSY":
                if busy_left <= 0:
                    raise ServerBusyError(
                        f"server busy: {reply.get('error')} "
                        f"(projected_ttft_ms={reply.get('projected_ttft_ms')})"
                    )
                busy_left -= 1
                # prefer the server's projected-drain hint (retry_after_ms,
                # staggered per shed so clients don't re-arrive in lockstep)
                hint_ms = reply.get("retry_after_ms")
                if hint_ms is not None:
                    delay = float(hint_ms) / 1e3
                else:
                    delay = float(reply.get("retry_after_s") or 0.25)
                time.sleep(delay)
                continue  # BUSY retries don't consume transport attempts
            return reply
        raise RpcError(
            f"{msg.get('type')} failed after {attempts} attempt(s): {last_err}"
        )

    def submit(
        self,
        prompt: List[int],
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        max_new: int = 16,
        eos_id: int = -1,
        seed: int = 0,
        deadline_s: Optional[float] = None,
        retry_busy: int = 0,
        trace: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
    ) -> str:
        """Submit one request. A request-scoped ``trace`` id is minted here
        (or adopted from the caller / ambient scope) and rides the SUBMIT
        frame — the server stamps every lifecycle event with it, so the
        request's whole cross-worker journey correlates in the exported
        trace (docs/observability.md). Retried submits reuse the same id.
        ``tenant``/``qos`` select the QoS class (docs/fleet.md "QoS
        classes"); omitted means best_effort under the anonymous tenant."""
        msg = {
            "type": "SUBMIT",
            "prompt": [int(t) for t in prompt],
            "temperature": temperature,
            "top_k": top_k,
            "max_new": max_new,
            "eos_id": eos_id,
            "seed": seed,
            "deadline_s": deadline_s,
            "trace": trace or tracing.ensure(),
        }
        if tenant is not None:
            msg["tenant"] = str(tenant)
        if qos is not None:
            msg["qos"] = str(qos)
        reply = self._call(msg, retry_busy=retry_busy)
        return reply["id"]

    def poll(self, request_id: str) -> Dict[str, Any]:
        return self._call({"type": "POLL", "id": request_id})

    def result(
        self, request_id: str, timeout: float = 60.0, poll_interval: float = 0.01
    ) -> Dict[str, Any]:
        """Poll until the request reaches a terminal state. A fleet request
        whose replica died reports ``state="requeued"`` in between — keep
        polling; the router re-runs it on a survivor under the same id."""
        deadline = time.time() + timeout
        while True:
            snap = self.poll(request_id)
            if snap.get("done"):
                return snap
            if time.time() > deadline:
                raise RpcError(
                    f"request {request_id} not done within {timeout}s "
                    f"(state={snap.get('state')})"
                )
            time.sleep(poll_interval)

    def generate(self, prompt: List[int], timeout: float = 60.0, **params) -> List[int]:
        """submit + result convenience; returns the generated tokens."""
        rid = self.submit(prompt, **params)
        snap = self.result(rid, timeout=timeout)
        if snap.get("state") != "done":
            raise RpcError(
                f"request {rid} ended {snap.get('state')}: {snap.get('error')}"
            )
        return list(snap["tokens"])

    def cancel(self, request_id: str) -> bool:
        return bool(self._call({"type": "CANCEL", "id": request_id}).get("cancelled"))

    def stats(self) -> Dict[str, Any]:
        return self._call({"type": "SSTATS"})

    def close(self) -> None:
        self._client.stop()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
