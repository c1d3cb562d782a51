"""Request lifecycle for the serving engine.

A copy of :mod:`maggy_tpu.serve.request`.

A :class:`Request` is the unit the scheduler moves through QUEUED ->
RUNNING -> (DONE | CANCELLED | EXPIRED | FAILED). State mutation belongs to
the scheduler thread alone; RPC handlers read wire snapshots taken under the
scheduler lock, so a request object never needs its own lock.
"""

from __future__ import annotations

import dataclasses
import secrets
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.serve.qos import DEFAULT_QOS, DEFAULT_TENANT

# terminal states never transition again; the scheduler drops terminal
# requests from its index after RETENTION_S so poll() has a grace window
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
EXPIRED = "expired"
FAILED = "failed"

TERMINAL = frozenset((DONE, CANCELLED, EXPIRED, FAILED))


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls, all static-shape-safe: temperature and
    top_k ride into the compiled step as arrays (top_k via a fixed-size
    top-``TOPK_CAP`` filter), so no combination ever retraces it."""

    temperature: float = 0.0
    top_k: int = 0
    max_new: int = 16
    eos_id: int = -1
    seed: int = 0

    def validate(self) -> None:
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


@dataclasses.dataclass
class Request:
    prompt: List[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    id: str = dataclasses.field(default_factory=lambda: secrets.token_hex(8))
    # request-scoped trace id (docs/observability.md): arrives on the SUBMIT
    # frame (client- or router-minted), else minted at scheduler admission;
    # every lifecycle event this request produces carries it
    trace: Optional[str] = None
    state: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    # wall-clock lifecycle marks (None until reached)
    submitted_ts: float = dataclasses.field(default_factory=time.time)
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    done_ts: Optional[float] = None
    # absolute wall-clock deadline; queued or running past it -> EXPIRED
    deadline_ts: Optional[float] = None
    # set by cancel(); the scheduler enacts it at the next loop boundary
    cancel_requested: bool = False
    # disaggregated serving (docs/fleet.md): a KV pack from a prefill
    # replica — the decode engine admits from it instead of prefilling.
    # Consumed on first admission; a preempted request re-prefills locally.
    prefilled: Optional[Dict[str, Any]] = None
    # times this request was preempted for pages (docs/serving.md); its
    # generated tokens are retained and re-admission resumes byte-identically
    preemptions: int = 0
    # per-tenant QoS (docs/fleet.md "QoS classes"): tenant is the accounting
    # identity, qos the scheduling class (admission priority, quota ledger
    # bucket, preemption ordering); wire default is best_effort
    tenant: str = DEFAULT_TENANT
    qos: str = DEFAULT_QOS

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return (self.first_token_ts - self.submitted_ts) * 1e3

    @property
    def queue_wait_ms(self) -> Optional[float]:
        if self.admitted_ts is None:
            return None
        return (self.admitted_ts - self.submitted_ts) * 1e3

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.done_ts is None:
            return None
        return (self.done_ts - self.submitted_ts) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean per-token decode time after the first token (the Gemma
        serving comparison's TPOT); needs >= 2 tokens and a terminal ts."""
        if self.done_ts is None or self.first_token_ts is None:
            return None
        if len(self.tokens) < 2:
            return None
        return (self.done_ts - self.first_token_ts) * 1e3 / (len(self.tokens) - 1)

    def finish(self, state: str, error: Optional[str] = None) -> None:
        self.state = state
        self.error = error
        self.done_ts = time.time()

    def snapshot(self) -> Dict[str, Any]:
        """Wire-format view for the POLL verb (JSON-safe, no live refs)."""
        return {
            "id": self.id,
            "trace": self.trace,
            "state": self.state,
            "tokens": list(self.tokens),
            "n_tokens": len(self.tokens),
            "prompt_len": len(self.prompt),
            "error": self.error,
            "ttft_ms": self.ttft_ms,
            "tenant": self.tenant,
            "qos": self.qos,
            "preemptions": self.preemptions,
            "done": self.state in TERMINAL,
        }
