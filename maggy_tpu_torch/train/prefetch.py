"""Host→device input prefetcher: the training tier's overlap seam.

Counterpart of :mod:`maggy_tpu.train.prefetch`. A :class:`DevicePrefetcher`
moves the host side of a step's input (``put``, normally
``Trainer.shard_batch``) and the host-to-device copy onto a background
thread that runs ``depth`` batches ahead, so the copy of batch ``i+1``
overlaps the compute of batch ``i`` and the consumer's per-step cost is a
queue pop.

On a CUDA device the copy works as follows:

* **The producer thread makes the card current** (``torch.cuda.set_device``)
  before its first copy: CUDA's current device is per host thread.
* **Pinned ring, side stream.** Each batch's arrays are copied on the host
  into one slot of a small ring of pinned buffers (``depth + 1`` slots,
  allocated once per shape: pinning per batch would cost a
  ``cudaHostAlloc`` each time), then to the card with ``non_blocking=True``
  on a dedicated side stream; an event recorded after the copies marks the
  slot free again, and the producer waits on it before it refills that
  slot.
* **Stream handoff.** The consumer makes its current stream wait on the
  batch's event and calls ``record_stream`` on every tensor it hands out,
  so the caching allocator cannot reuse their memory while the step still
  reads them.
* **No fallback.** A failed copy is relayed to the consumer and raised
  there, never swallowed into a host batch.

With no device (or the CPU) ``put``'s result is handed out as it is.

As in the JAX package: ``max_items`` caps how many batches are ever pulled
from ``source`` (``fit`` passes its step budget, so a shared iterator keeps
its position across calls); producer errors are relayed verbatim and stick;
``skip`` before the first ``__next__`` delegates to the source's own
``skip``; ``set_depth`` retunes the lookahead live; each placement records
a ``shard_batch`` span, and the consumer the ``input_wait_ms`` and
``prefetch_depth`` gauges; the producer holds only a weakref to the
prefetcher, so an un-closed one that goes out of scope is collected and its
thread exits.

:func:`skip_batches` is the resume fast path: it routes ``fit``'s
``resume="auto"`` fast-forward through a loader's ``skip(n)`` (index
advance, no data materialization — ``batch_iterator`` and
``NativeBatchLoader`` implement it) and falls back to draining ``next()``
for plain generators.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from maggy_tpu_torch import telemetry


def skip_batches(source: Any, n: int) -> int:
    """Advance ``source`` by ``n`` batches, preferring its ``skip(n)`` fast
    path (no materialization) over draining ``next()``. Returns how many
    batches were actually skipped (short on exhaustion)."""
    if n <= 0:
        return 0
    src_skip = getattr(source, "skip", None)
    if callable(src_skip):
        out = src_skip(n)
        return n if out is None else int(out)
    skipped = 0
    for _ in range(n):
        try:
            next(source)
        except StopIteration:
            break
        skipped += 1
    return skipped


class _Error:
    """Producer-side exception, relayed to the consumer verbatim."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Staged:
    """A batch copied to the card on the side stream, and the event that
    marks the copy done."""

    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value = value
        self.event = event


_END = object()  # end-of-source sentinel


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _PinnedSlot:
    """One ring slot: pinned host buffers by leaf, and the event recorded
    after the last copy out of them."""

    def __init__(self):
        self.buffers: dict = {}
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, key, arr: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        buf = self.buffers.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.buffers[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf


class DevicePrefetcher:
    """Double-buffered host→device iterator over any batch iterator.

    ``for batch in DevicePrefetcher(loader, trainer.shard_batch,
    device=trainer.device): ...`` yields batches in source order, their
    arrays on the card, while the producer thread stays ``depth`` batches
    ahead.
    """

    def __init__(
        self,
        source: Iterator,
        put: Callable[[Any], Any],
        depth: int = 2,
        max_items: Optional[int] = None,
        telemetry_recorder=None,
        ledger=None,
        device=None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._put = put
        self.depth = depth
        self.max_items = max_items
        self._tel = telemetry_recorder or telemetry.get()
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._cuda = self.device is not None and self.device.type == "cuda"
        self._ring: List[_PinnedSlot] = []  # producer-thread-confined
        self._side: Optional[torch.cuda.Stream] = None  # producer-thread-confined
        # optional memtrack.MemoryLedger: its "prefetch" account follows the
        # staged-batch bytes (per-batch size x queue occupancy), sized once
        # from the first consumed batch — fit batches are shape-stable
        self._ledger = ledger
        self._batch_bytes: Optional[int] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # _END or _Error once the stream finished; consumer-thread-confined:
        # terminal markers travel through the queue
        self._terminal: Any = None

    # ------------------------------------------------------------------ iterate

    def __iter__(self) -> "DevicePrefetcher":
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None

    def _start(self) -> None:
        if self._thread is not None:
            return
        # lazy start: skip() before the first __next__ still sees the source
        # untouched, so the resume fast-forward never races the producer
        self._thread = threading.Thread(
            target=_prefetch_loop,
            args=(weakref.ref(self),),
            name="maggy-device-prefetch",
            daemon=True,
        )
        self._thread.start()

    def _stage(self, item, index: int):
        """Producer side: copy ``item``'s arrays into a pinned slot and from
        there to the card on the side stream (CUDA only)."""
        if not self._cuda:
            return item
        if self._side is None:
            torch.cuda.set_device(self.device)
            self._side = torch.cuda.Stream(self.device)
        n_slots = self.depth + 1
        while len(self._ring) < n_slots:
            self._ring.append(_PinnedSlot())
        slot = self._ring[index % n_slots]
        if slot.event is not None:
            slot.event.synchronize()  # the copy out of this slot is done
        with torch.cuda.stream(self._side):
            value = self._copy(slot, item, ())
            event = torch.cuda.Event()
            event.record(self._side)
        slot.event = event
        return _Staged(value, event)

    def _copy(self, slot: _PinnedSlot, node, key: tuple):
        """``node`` with each host array copied through ``slot`` to the card
        on the current stream. A method, not a nested function: a closure
        that calls itself is a reference cycle, and it would keep this
        prefetcher (and, through ``put``, the trainer's model) alive until
        the cyclic collector ran."""
        if isinstance(node, dict):
            return {k: self._copy(slot, v, key + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)([self._copy(slot, v, key + (i,)) for i, v in enumerate(node)])
        if isinstance(node, torch.Tensor) and node.device.type != "cpu":
            return node
        if isinstance(node, (np.ndarray, torch.Tensor)):
            host = slot.buffer(key, node.numpy() if isinstance(node, torch.Tensor) else node)
            out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            out.copy_(host, non_blocking=True)
            return out
        return node

    def _hand_out(self, item):
        """Consumer side: order the current stream after the copy, and keep
        the allocator from reusing the tensors before the step is done."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for t in _tensors(item.value):
            t.record_stream(stream)
        return item.value

    def __next__(self):
        if self._terminal is not None:
            if isinstance(self._terminal, _Error):
                raise self._terminal.exc
            raise StopIteration
        self._start()
        self._tel.gauge("prefetch_depth", self._queue.qsize())
        t0 = time.perf_counter()
        item = self._queue.get()
        self._tel.gauge("input_wait_ms", (time.perf_counter() - t0) * 1e3)
        if item is _END:
            self._terminal = item
            raise StopIteration
        if isinstance(item, _Error):
            self._terminal = item
            raise item.exc
        item = self._hand_out(item)
        if self._ledger is not None:
            if self._batch_bytes is None:
                from maggy_tpu_torch.telemetry import memtrack

                self._batch_bytes = memtrack.array_bytes(item)
            self._ledger.register(
                "prefetch", self._batch_bytes * (self._queue.qsize() + 1)
            )
        return item

    # -------------------------------------------------------------------- tune

    def set_depth(self, depth: int) -> None:
        """Live-retune the lookahead depth. Growing takes effect immediately
        — the producer's bounded put wakes and fills the larger queue;
        shrinking applies lazily as the consumer drains below the new bound
        (already-placed batches are never dropped)."""
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        q = self._queue
        with q.mutex:
            q.maxsize = depth
            q.not_full.notify_all()

    # -------------------------------------------------------------------- skip

    def skip(self, n: int) -> int:
        """Fast-forward by ``n`` batches. Before the first ``__next__`` this
        delegates to the source's own ``skip`` (no materialization); after
        the pipeline started it drains already-placed batches."""
        if n <= 0:
            return 0
        if self._thread is None:
            return skip_batches(self._source, n)
        skipped = 0
        for _ in range(n):
            try:
                next(self)
            except StopIteration:
                break
            skipped += 1
        return skipped

    # ------------------------------------------------------------------- close

    def close(self) -> None:
        """Stop the producer and drop buffered batches. Idempotent."""
        if self._ledger is not None:
            self._ledger.unregister("prefetch")
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _enqueue(ref: "weakref.ref", stop, q, item) -> bool:
    """Blocking bounded put that stays responsive to close() and collection.
    Caller must NOT hold a strong prefetcher ref across this call."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if ref() is None:
                return False
    return False


def _prefetch_loop(ref: "weakref.ref") -> None:
    """Producer body; re-derefs the prefetcher each batch so collection
    stops it (same lifecycle idiom as ``native_loader._producer_loop``)."""
    i = 0
    terminal = _END
    while True:
        pf = ref()
        if pf is None or pf._stop.is_set():
            return
        if pf.max_items is not None and i >= pf.max_items:
            break
        try:
            batch = next(pf._source)
            with pf._tel.span("shard_batch", step=i):
                item = pf._stage(pf._put(batch), i)
        except StopIteration:
            break
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            terminal = _Error(e)
            break
        stop, q = pf._stop, pf._queue
        del pf  # no strong ref while blocked on the bounded queue
        if not _enqueue(ref, stop, q, item):
            return
        i += 1
    pf = ref()
    if pf is not None:
        stop, q = pf._stop, pf._queue
        del pf
        _enqueue(ref, stop, q, terminal)
