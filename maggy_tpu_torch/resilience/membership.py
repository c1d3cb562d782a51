"""Elastic membership: epoch-numbered views of the active slice set.

The distributed tier's bounded elastic restart relaunches a lost
partition at the *same* world size — if a slice is preempted and never comes
back, the run dies once ``max_restarts`` is exhausted. This module holds the
state machine that turns "restartable" into "degrades and recovers"
(ROADMAP item 5, the TPU-concurrency-limits posture): the data mesh
*reshapes* when a slice leaves or rejoins, checkpoint-consistently.

Concepts:

* :class:`MembershipView` — an immutable, **epoch-numbered** snapshot of
  which slices are in the data mesh. Every transition (``drop`` /
  ``rejoin``) returns a new view with ``epoch + 1``; shrinking below
  ``min_slices`` raises :class:`MembershipViolation` instead (a clean
  deterministic failure, never a hang).
* :class:`MembershipMonitor` — the worker-side handle: holds the view the
  worker is currently *running under*, receives reshape signals (the
  driver's RESHAPE heartbeat reply, or a locally observed slice event) and
  surfaces them to ``Trainer.fit`` as a pending epoch checked at step
  boundaries.
* Control-flow exceptions — ``Trainer.fit`` raises one of these at a step
  boundary and the distributed executor's elastic loop catches it,
  negotiates the new view with the driver (the *reshape barrier*), rebuilds
  the mesh over the surviving slices, and re-enters the train_fn, which
  resumes from the latest complete checkpoint via ``fit(resume="auto")``:

  - :class:`SliceLost` (a :class:`~maggy_tpu_torch.exceptions.WorkerLost`) — a
    slice died under us; its device state is gone, so the run falls back
    to the last *retained* checkpoint.
  - :class:`SliceRejoin` — a previously lost slice came back; graceful, so
    fit checkpoints the current step first and no step re-runs.
  - :class:`MembershipChanged` — another member's membership event reached
    us (heartbeat RESHAPE); graceful like a rejoin.

A "slice" is one ICI-connected failure domain. On a real fleet that is a
TPU slice (one worker process per slice, cross-slice traffic on DCN); on a
single host the driver *simulates* slices as contiguous partitions of the
``xla_force_host_platform_device_count`` CPU mesh (see
``parallel.mesh.slice_device_groups``), so n=16+ elastic geometries are
testable without hardware — the same generalization the dryrun machinery
uses. Docs: docs/resilience.md "Elastic membership".
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

from maggy_tpu_torch.exceptions import MaggyError, WorkerLost


class MembershipViolation(MaggyError):
    """A membership transition would shrink the mesh below ``min_slices``.
    Deterministic by design: the run aborts with this error instead of
    degrading past the configured floor (or hanging on a barrier that can
    never complete)."""

    def __init__(self, slice_id: Any, n_active: int, min_slices: int):
        super().__init__(
            f"dropping slice {slice_id} would leave {n_active - 1} active "
            f"slice(s), below min_slices={min_slices}; aborting instead of "
            "degrading further"
        )
        self.slice_id = slice_id


class SliceLost(WorkerLost):
    """A slice left the mesh out from under the step loop (preemption, host
    loss, chaos ``slice_drop``). Transient: the elastic membership protocol
    reshapes around it instead of failing the run."""

    def __init__(self, slice_id: Any, step: Optional[int] = None):
        super().__init__(
            f"slice {slice_id} lost"
            + (f" at step {step}" if step is not None else "")
        )
        self.slice_id = slice_id
        self.step = step


class SliceRejoin(MaggyError):
    """Control flow, not an error: a previously lost slice is back and the
    mesh should reshape to re-admit it (chaos ``slice_rejoin``, or a dead
    partition re-registering). Raised by ``Trainer.fit`` at a step boundary
    AFTER checkpointing the current step, caught by the executor loop."""

    def __init__(self, slice_id: Any, step: Optional[int] = None):
        super().__init__(
            f"slice {slice_id} rejoining"
            + (f" at step {step}" if step is not None else "")
        )
        self.slice_id = slice_id
        self.step = step


class MembershipChanged(MaggyError):
    """Control flow: the driver announced a newer membership epoch (another
    slice left or rejoined). Raised by ``Trainer.fit`` at a step boundary
    after checkpointing, caught by the executor loop, which re-runs the
    EXEC_CONFIG exchange and rebuilds the mesh for the new view."""

    def __init__(self, epoch: int):
        super().__init__(f"membership moved to epoch {epoch}; reshape required")
        self.epoch = epoch


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One epoch of the membership state machine.

    ``total_slices`` is the full-width slice count the run was launched
    with; ``active`` the (sorted) slice ids currently in the mesh. The view
    is immutable — transitions return the successor epoch's view, so a
    reader can never observe a half-applied reshape.
    """

    epoch: int = 0
    total_slices: int = 1
    active: Tuple[int, ...] = (0,)
    min_slices: int = 1
    # "sim" = slices are simulated device-partitions inside one worker
    # process; "workers" = one worker process per slice (pods)
    mode: str = "workers"

    def __post_init__(self):
        if self.min_slices < 1:
            raise ValueError("min_slices must be >= 1")
        if not self.active:
            raise ValueError("a MembershipView needs at least one active slice")
        object.__setattr__(self, "active", tuple(sorted(self.active)))

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def inactive(self) -> Tuple[int, ...]:
        return tuple(s for s in range(self.total_slices) if s not in self.active)

    @classmethod
    def full(
        cls, total_slices: int, min_slices: int = 1, mode: str = "workers"
    ) -> "MembershipView":
        return cls(
            epoch=0,
            total_slices=total_slices,
            active=tuple(range(total_slices)),
            min_slices=min_slices,
            mode=mode,
        )

    def drop(self, slice_id: int) -> "MembershipView":
        """The successor view with ``slice_id`` removed (epoch + 1).
        Raises :class:`MembershipViolation` below the floor; dropping an
        already-inactive slice is idempotent noise from a duplicate fault
        report and returns ``self`` unchanged (no epoch burn)."""
        if slice_id not in self.active:
            return self
        if self.n_active - 1 < self.min_slices:
            raise MembershipViolation(slice_id, self.n_active, self.min_slices)
        return dataclasses.replace(
            self,
            epoch=self.epoch + 1,
            active=tuple(s for s in self.active if s != slice_id),
        )

    def rejoin(self, slice_id: int) -> "MembershipView":
        """The successor view with ``slice_id`` re-admitted (epoch + 1);
        idempotent for an already-active slice."""
        if slice_id in self.active:
            return self
        if not 0 <= int(slice_id) < self.total_slices:
            raise ValueError(
                f"slice {slice_id} is outside the launch topology "
                f"(total_slices={self.total_slices})"
            )
        return dataclasses.replace(
            self,
            epoch=self.epoch + 1,
            active=tuple(sorted(self.active + (int(slice_id),))),
        )

    def as_dict(self) -> Dict[str, Any]:
        """Wire form (EXEC_CONFIG / MEMBERSHIP payload)."""
        return {
            "epoch": self.epoch,
            "total_slices": self.total_slices,
            "active": list(self.active),
            "min_slices": self.min_slices,
            "mode": self.mode,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MembershipView":
        return cls(
            epoch=int(d["epoch"]),
            total_slices=int(d["total_slices"]),
            active=tuple(int(s) for s in d["active"]),
            min_slices=int(d.get("min_slices", 1)),
            mode=str(d.get("mode", "workers")),
        )


class MembershipMonitor:
    """Worker-side membership handle.

    Holds the view this worker's mesh was built for, plus an optional
    *pending* epoch set asynchronously (the rpc heartbeat thread on a
    RESHAPE reply). ``Trainer.fit`` polls :meth:`pending_epoch` at step
    boundaries; the executor's elastic loop calls :meth:`adopt` once the
    reshape barrier delivered the new view.
    """

    def __init__(self, view: MembershipView, self_slice: Optional[int] = None):
        self._lock = threading.Lock()
        self._view = view
        self._pending: Optional[int] = None
        # worker-mode runs: the one slice THIS worker embodies — chaos
        # slice_drop then only targets it (a drop of another slice reaches
        # us as that worker's death + a RESHAPE signal, never locally), and
        # sim-mode-only seams (local rejoin) stay off
        self.self_slice = self_slice

    @property
    def view(self) -> MembershipView:
        with self._lock:
            return self._view

    @property
    def epoch(self) -> int:
        return self.view.epoch

    @property
    def active(self) -> Tuple[int, ...]:
        return self.view.active

    @property
    def inactive(self) -> Tuple[int, ...]:
        return self.view.inactive

    def signal(self, epoch: Any) -> None:  # thread-entry — the rpc heartbeat thread signals RESHAPE replies
        """Note that the driver is at a newer epoch (heartbeat thread)."""
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return
        with self._lock:
            if epoch > self._view.epoch:
                self._pending = max(self._pending or 0, epoch)

    def pending_epoch(self) -> Optional[int]:
        """The newer epoch a reshape is pending for, or None."""
        with self._lock:
            return self._pending

    def adopt(self, view: MembershipView) -> None:
        """Install the view the mesh is being rebuilt for; clears a pending
        signal the view satisfies."""
        with self._lock:
            self._view = view
            if self._pending is not None and view.epoch >= self._pending:
                self._pending = None
