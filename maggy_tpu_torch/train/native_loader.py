"""Native-backed prefetching batch loader.

Counterpart of :mod:`maggy_tpu.train.native_loader`: shuffled minibatches
are assembled by the C++ gather in the port's own
``maggy_tpu_torch/native/batcher.cpp`` on a background thread with a
bounded queue — ctypes releases the GIL during the gather, so host batching
overlaps the card's step time.

The library is compiled by ``g++`` at first use, never at import, into
``maggy_tpu_torch/_build/<hash>/``, where the hash covers the source and the
compiler flags (as :mod:`maggy_tpu_torch.ops._build` does for the CUDA
kernels), so an edited source is rebuilt and a stale library never loaded.
Without a compiler it falls back to numpy fancy indexing and numpy's
permutation, with a logged warning; :attr:`NativeBatchLoader.using_native`
says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "native" / "batcher.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 1
# the C entry points' ctypes prototypes, (argtypes, restype)
PROTOTYPES = {
    "mtl_version": ([], ctypes.c_int64),
    "mtl_perm": ([ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p], None),
    "mtl_gather": (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32],
        None,
    ),
}

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def library_path() -> Path:
    """Where the batcher library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbatcher.so"


def _build() -> Path:
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"libbatcher.{os.getpid()}.tmp.so")
        subprocess.run(
            ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            check=True, capture_output=True,
        )
        os.replace(tmp, path)  # atomic: readers never see a partial file
    return path


def _native_lib() -> Optional[ctypes.CDLL]:
    """Compile (once, cached) and load the batcher library; None if impossible."""
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
            for name, (argtypes, restype) in PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            if lib.mtl_version() != ABI_VERSION:
                raise RuntimeError("batcher ABI mismatch")
            _LIB = lib
        except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
            logger.warning("Native batcher unavailable (%s); using numpy fallback", e)
            _LIB = None
        return _LIB


def perm_indices(lib: Optional[ctypes.CDLL], n: int, seed: int) -> np.ndarray:
    """Permutation of [0, n) from the native RNG (numpy fallback)."""
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.mtl_perm(
            n,
            ctypes.c_uint64(seed & (2**64 - 1)),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


def gather_rows(
    lib: Optional[ctypes.CDLL],
    arr: np.ndarray,
    idx: np.ndarray,
    threads: int = 4,
) -> np.ndarray:
    """Row gather via the C++ library (GIL released); numpy fallback."""
    if lib is None or not arr.flags.c_contiguous:
        return np.asarray(arr[idx])
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= arr.shape[0]):
        raise IndexError(f"row index out of range for {arr.shape[0]} rows")
    row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + arr.shape[1:], dtype=arr.dtype)
    lib.mtl_gather(
        arr.ctypes.data_as(ctypes.c_void_p),
        row_bytes,
        idx.ctypes.data_as(ctypes.c_void_p),
        len(idx),
        out.ctypes.data_as(ctypes.c_void_p),
        threads,
    )
    return out


class NativeBatchLoader:
    """Iterator of shuffled dict batches over host arrays.

    ``for batch in NativeBatchLoader({"tokens": toks}, batch_size=32): ...``
    """

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        loop: bool = True,
        prefetch: int = 2,
        gather_threads: int = 4,
    ):
        if not arrays:
            raise ValueError("arrays must be a non-empty dict")
        self.arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        lengths = {v.shape[0] for v in self.arrays.values()}
        if len(lengths) != 1:
            raise ValueError(f"All arrays need equal leading dims, got {lengths}")
        self.n = lengths.pop()
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.loop = loop
        self.gather_threads = gather_threads
        self._lib = _native_lib()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        # skip(n) bookkeeping: batches are queued tagged with their global
        # index; the producer skips the gather for indices below _min_index
        # and the consumer discards any already-materialized stragglers, so
        # a resume fast-forward costs index arithmetic, not 10k gathers
        self._next_index = 0  # global index of the next batch the consumer expects
        self._min_index = 0  # first index the consumer still wants
        self.gathers = 0  # row gathers performed (skip test hook)
        # the producer holds only a weakref: an un-closed loader that goes out
        # of scope gets collected, and the thread exits instead of pinning the
        # dataset forever
        self._thread = threading.Thread(
            target=_producer_loop,
            args=(weakref.ref(self),),
            name="maggy-native-loader",
            daemon=True,
        )
        self._thread.start()

    # ------------------------------------------------------------------ internals

    def _perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n, dtype=np.int64)
        return perm_indices(self._lib, self.n, self.seed * 1_000_003 + epoch)

    def _gather(self, arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
        return gather_rows(self._lib, arr, idx, self.gather_threads)

    # ------------------------------------------------------------------ interface

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            item = self._queue.get()
            if item is None:
                raise StopIteration
            idx, batch = item
            if idx < self._min_index:
                continue  # materialized before a skip() landed; discard
            self._next_index = idx + 1
            return batch

    def skip(self, n: int) -> int:
        """Advance the stream ``n`` batches without gathering their rows.
        The producer's permutation stream is untouched (one draw per epoch
        either way), so the post-skip sequence is exactly what ``n`` calls
        of ``next()`` would have left. At most the already-queued/in-flight
        batches (bounded by ``prefetch + 1``) are materialized wastefully.
        """
        if n <= 0:
            return 0
        self._next_index += n
        self._min_index = self._next_index
        return n

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    @property
    def using_native(self) -> bool:
        return self._lib is not None


def _producer_loop(loader_ref: "weakref.ref") -> None:
    """Producer body; re-derefs the loader every batch so collection stops it."""
    epoch = 0
    global_idx = 0  # batch counter across epochs (the skip() coordinate)
    while True:
        loader = loader_ref()
        if loader is None or loader._stop.is_set():
            return
        perm = loader._perm(epoch)
        end = (
            (loader.n // loader.batch_size) * loader.batch_size
            if loader.drop_remainder
            else loader.n
        )
        batch_size, one_epoch = loader.batch_size, not loader.loop
        q = loader._queue
        for i in range(0, end, batch_size):
            loader = loader_ref()
            if loader is None or loader._stop.is_set():
                return
            if global_idx < loader._min_index:
                # skipped range: advance the index, never touch the rows
                # (a slightly stale _min_index read just gathers one batch
                # the consumer will discard — the sequence stays exact)
                global_idx += 1
                continue
            idx = np.ascontiguousarray(perm[i : i + batch_size])
            batch = {k: loader._gather(v, idx) for k, v in loader.arrays.items()}
            loader.gathers += 1
            item = (global_idx, batch)
            global_idx += 1
            stop = loader._stop
            del loader  # do not hold a strong ref while blocked on the queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    if loader_ref() is None:
                        return
            if stop.is_set():
                return
        epoch += 1
        if one_epoch:
            q.put(None)  # end-of-data sentinel
            return
