"""Streaming sharded dataset: file-backed input pipeline.

Counterpart of :mod:`maggy_tpu.train.sharded_dataset`, with the same layout
on disk, so either package reads a directory the other wrote. It replaces
the reference's petastorm delegation (parquet row-groups sharded by
RANK/WORLD_SIZE under the hood of a torch DataLoader). Layout on disk::

    data_dir/
      tokens/shard-00000.npy
      tokens/shard-00001.npy
      labels/shard-00000.npy
      ...

One ``.npy`` per (field, shard). Local shards are memory-mapped — a training
run touches only the pages its batches gather, never the full dataset; shards
that only the Env seam can reach stream shard-at-a-time through it. Work splits
across processes at shard granularity, round-robin by ``process_index %
num_processes`` — exactly petastorm's row-group semantics, so per-process
coverage is disjoint by construction (tested).

Batches come off a background producer thread through the same bounded queue /
C++ gather machinery as :class:`~maggy_tpu_torch.train.native_loader.NativeBatchLoader`
(two-level shuffle: shard order, then rows within the shard), overlapping host
IO+assembly with device step time.
"""

from __future__ import annotations

import io
import os
import queue
import re
import threading
import weakref
from typing import Dict, Iterator, List, Optional

import numpy as np

from maggy_tpu_torch.train import native_loader

_SHARD_RE = re.compile(r"shard-(\d{5})\.npy$")


def _validate_and_split(arrays: Dict[str, np.ndarray], num_chunks: int) -> np.ndarray:
    """Shared writer validation: non-empty dict, equal leading dims, a chunk
    count in [1, rows]. Returns the row bounds for ``num_chunks`` chunks."""
    if not arrays:
        raise ValueError("arrays must be a non-empty dict")
    n = {v.shape[0] for v in arrays.values()}
    if len(n) != 1:
        raise ValueError(f"All arrays need equal leading dims, got {n}")
    n = n.pop()
    if num_chunks < 1 or num_chunks > n:
        raise ValueError(f"chunk count must be in [1, {n}], got {num_chunks}")
    return np.linspace(0, n, num_chunks + 1, dtype=np.int64)


def write_sharded(
    data_dir: str, arrays: Dict[str, np.ndarray], num_shards: int
) -> None:
    """Split ``arrays`` row-wise into ``num_shards`` .npy files per field."""
    bounds = _validate_and_split(arrays, num_shards)
    for field, arr in arrays.items():
        field_dir = os.path.join(data_dir, field)
        os.makedirs(field_dir, exist_ok=True)
        for s in range(num_shards):
            np.save(
                os.path.join(field_dir, f"shard-{s:05d}.npy"),
                np.ascontiguousarray(arr[bounds[s] : bounds[s + 1]]),
            )


class _ShardLoaderMixin:
    """Shared process-split + loader construction for shard-unit datasets
    (``.npy`` field shards, Parquet row groups). Subclasses provide
    ``fields``, ``num_shards`` and ``open_shard(field, shard)``."""

    def read_shard(self, shard: int) -> Dict[str, np.ndarray]:
        """All fields of one shard. Default: per-field ``open_shard`` calls;
        columnar subclasses override to read every column in one pass. Must
        be thread-safe — each loader reads from its own producer thread."""
        return {f: self.open_shard(f, shard) for f in self.fields}

    def my_shards(self, process_index: int = 0, num_processes: int = 1) -> List[int]:
        """Round-robin shard assignment (petastorm RANK/WORLD_SIZE split,
        reference dataloader.py:116-131): disjoint, near-balanced."""
        if not 0 <= process_index < num_processes:
            raise ValueError(f"process_index {process_index} not in [0, {num_processes})")
        if num_processes > self.num_shards:
            raise ValueError(
                f"{num_processes} processes but only {self.num_shards} shards; "
                "write more shards than processes"
            )
        return list(range(process_index, self.num_shards, num_processes))

    def loader(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        loop: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        num_processes: int = 1,
        ctx=None,
    ) -> "ShardedStreamLoader":
        """Build the streaming loader for this process's shard subset.

        Pass ``ctx`` (the injected TrainContext) to derive process topology;
        the batches are *process-local*.
        """
        if ctx is not None:
            process_index = ctx.process_index
            num_processes = ctx.num_processes
        return ShardedStreamLoader(
            self,
            self.my_shards(process_index, num_processes),
            batch_size,
            shuffle=shuffle,
            seed=seed + process_index,  # decorrelate shard/row order per process
            loop=loop,
            prefetch=prefetch,
        )


class ShardedDataset(_ShardLoaderMixin):
    """Handle on a sharded dataset directory (local path or Env-seam URL).

    ``columns`` restricts the fields read (e.g. LOCO feature ablation drops
    one column without touching the files)."""

    def __init__(self, data_dir: str, columns: Optional[List[str]] = None):
        self.data_dir = data_dir
        self.fields = sorted(
            d for d in self._listdir(data_dir)
            if self._isdir(os.path.join(data_dir, d))
        )
        if not self.fields:
            raise ValueError(f"No field directories under {data_dir!r}")
        if columns is not None:
            if not columns:
                raise ValueError("columns must be a non-empty list (or None)")
            missing = [c for c in columns if c not in self.fields]
            if missing:
                raise ValueError(
                    f"Columns {missing} not in dataset fields {self.fields}"
                )
            self.fields = sorted(columns)
        per_field = {}
        for f in self.fields:
            shards = sorted(
                m.group(0)
                for m in map(_SHARD_RE.search, self._listdir(os.path.join(data_dir, f)))
                if m
            )
            per_field[f] = shards
        names = {tuple(s) for s in per_field.values()}
        if len(names) != 1:
            # exact same shard file names in every field, or rows pair up wrong
            raise ValueError(f"Inconsistent shard files across fields: {per_field}")
        self._shard_names = per_field[self.fields[0]]
        self.num_shards = len(self._shard_names)
        if self.num_shards == 0:
            raise ValueError(f"No shard files under {data_dir!r}")

    # ---------------------------------------------------------------- fs seam

    def _env(self):
        from maggy_tpu_torch.core.env import EnvSing

        return EnvSing.get_instance()

    def _listdir(self, path: str) -> List[str]:
        if os.path.isdir(path):
            return os.listdir(path)
        return [os.path.basename(p) for p in self._env().listdir(path)]

    def _isdir(self, path: str) -> bool:
        if os.path.exists(path):
            return os.path.isdir(path)
        try:
            return bool(self._env().listdir(path))
        except Exception:
            return False

    def open_shard(self, field: str, shard: int) -> np.ndarray:
        """mmap local shards (page-level IO); stream remote ones whole."""
        path = os.path.join(self.data_dir, field, self._shard_names[shard])
        if os.path.exists(path):
            return np.load(path, mmap_mode="r")
        with self._env().open_file(path, "rb") as f:
            return np.load(io.BytesIO(f.read()))

class ParquetShardedDataset(_ShardLoaderMixin):
    """Columnar (Parquet/Arrow) ingestion — the reference's actual input
    format: petastorm reads parquet row groups sharded by RANK/WORLD_SIZE
    (reference dataloader.py:100-144). Here the **row group** is the shard
    unit: files under ``data_dir`` (or a single ``.parquet`` path) are
    enumerated sorted, their row groups form one global shard list split
    round-robin across processes, and batches flow through the same
    two-level shuffle + C++ row-gather as :class:`ShardedDataset`.

    Gated on pyarrow (optional dependency): importing this module never
    touches it; constructing without pyarrow raises with guidance.

    Columns may be scalars (one value per row) or fixed-length lists (token
    sequences); each maps to a ``[rows, ...]`` numpy field array.
    """

    def __init__(self, path: str, columns: Optional[List[str]] = None):
        if columns is not None and not columns:
            raise ValueError("columns must be a non-empty list (or None)")
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - env without pyarrow
            raise ImportError(
                "ParquetShardedDataset needs pyarrow; install it or convert "
                "the data with write_sharded() to the .npy layout."
            ) from e
        self.path = path
        if os.path.isdir(path):
            self.files = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.endswith((".parquet", ".pq"))
            )
        else:
            self.files = [path]
        if not self.files:
            raise ValueError(f"No .parquet files under {path!r}")
        # global shard list: (file, row_group) in deterministic order; every
        # file's schema is checked for the selected columns AND their types
        # (a missing column or a different fixed-list width must fail here,
        # not as a mid-training producer error)
        self._units: List[tuple] = []
        first_schema = None
        col_types = None
        for f in self.files:
            pf = pq.ParquetFile(f)
            schema = pf.schema_arrow
            if first_schema is None:
                first_schema = schema
                self.fields = list(columns) if columns else list(schema.names)
                missing = [c for c in self.fields if c not in schema.names]
                if missing:
                    raise ValueError(
                        f"Columns {missing} not in parquet schema {schema.names}"
                    )
                col_types = {c: schema.field(c).type for c in self.fields}
            else:
                for c in self.fields:
                    if c not in schema.names:
                        raise ValueError(
                            f"File {f!r} lacks column {c!r} present in "
                            f"{self.files[0]!r}"
                        )
                    if schema.field(c).type != col_types[c]:
                        raise ValueError(
                            f"Column {c!r} type mismatch: {schema.field(c).type} "
                            f"in {f!r} vs {col_types[c]} in {self.files[0]!r}"
                        )
            self._units.extend((f, g) for g in range(pf.metadata.num_row_groups))
        self.num_shards = len(self._units)
        if self.num_shards == 0:
            raise ValueError(f"No row groups in {path!r}")
        # ParquetFile handles are stateful and not thread-safe; each loader
        # reads from its own producer thread, so cache handles per thread
        self._tls = threading.local()

    def _file(self, path: str):
        import pyarrow.parquet as pq

        handles = getattr(self._tls, "handles", None)
        if handles is None:
            handles = self._tls.handles = {}
        pf = handles.get(path)
        if pf is None:
            if len(handles) >= 8:  # bounded per-thread handle cache
                handles.pop(next(iter(handles)))
            pf = handles[path] = pq.ParquetFile(path)
        return pf

    def read_shard(self, shard: int) -> Dict[str, np.ndarray]:
        """One row group, all selected columns in a single read."""
        path, group = self._units[shard]
        table = self._file(path).read_row_group(group, columns=self.fields)
        return {f: _arrow_column_to_numpy(table.column(f)) for f in self.fields}

    def open_shard(self, field: str, shard: int) -> np.ndarray:
        """One row group's column as a ``[rows, ...]`` array."""
        path, group = self._units[shard]
        table = self._file(path).read_row_group(group, columns=[field])
        return _arrow_column_to_numpy(table.column(field))


def _arrow_column_to_numpy(col) -> np.ndarray:
    """Arrow column -> contiguous numpy rows: scalars as 1-D, (fixed-size)
    lists as 2-D — ragged lists are rejected (pad/pack upstream)."""
    import pyarrow as pa

    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    t = arr.type
    if pa.types.is_fixed_size_list(t):
        values = arr.flatten().to_numpy(zero_copy_only=False)
        return np.ascontiguousarray(values.reshape(len(arr), t.list_size))
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        lengths = arr.value_lengths().to_numpy(zero_copy_only=False)
        uniq = np.unique(lengths)
        if len(uniq) != 1:
            raise ValueError(
                f"Ragged list column (lengths {uniq[:5]}...); sequences must "
                "be padded/packed to a fixed length upstream"
            )
        values = arr.flatten().to_numpy(zero_copy_only=False)
        return np.ascontiguousarray(values.reshape(len(arr), int(uniq[0])))
    return np.ascontiguousarray(arr.to_numpy(zero_copy_only=False))


def write_parquet(
    path: str,
    arrays: Dict[str, np.ndarray],
    *,
    rows_per_group: int,
    num_files: int = 1,
) -> None:
    """Test/example helper: write ``arrays`` as Parquet with explicit row
    groups (2-D arrays become fixed-size-list columns)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    # empty part files would each still carry one empty row group, which
    # becomes a shard whose loader busy-spins — reject up front
    bounds = _validate_and_split(arrays, num_files)

    def column(arr):
        if arr.ndim == 1:
            return pa.array(arr)
        if arr.ndim == 2:
            flat = pa.array(np.ascontiguousarray(arr).reshape(-1))
            return pa.FixedSizeListArray.from_arrays(flat, arr.shape[1])
        raise ValueError("write_parquet supports 1-D and 2-D arrays")

    os.makedirs(path, exist_ok=True)
    for i in range(num_files):
        chunk = {k: v[bounds[i] : bounds[i + 1]] for k, v in arrays.items()}
        table = pa.table({k: column(v) for k, v in chunk.items()})
        pq.write_table(
            table,
            os.path.join(path, f"part-{i:05d}.parquet"),
            row_group_size=rows_per_group,
        )


class ShardedStreamLoader:
    """Background-thread iterator of dict batches over a shard subset."""

    def __init__(
        self,
        dataset: ShardedDataset,
        shard_ids: List[int],
        batch_size: int,
        *,
        shuffle: bool,
        seed: int,
        loop: bool,
        prefetch: int,
    ):
        self.dataset = dataset
        self.shard_ids = list(shard_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.loop = loop
        self._lib = native_loader._native_lib()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_stream_producer,
            args=(weakref.ref(self),),
            name="maggy-sharded-loader",
            daemon=True,
        )
        self._thread.start()

    def _perm(self, n: int, salt: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(n, dtype=np.int64)
        return native_loader.perm_indices(self._lib, n, self.seed * 1_000_003 + salt)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, _ProducerError):
            raise RuntimeError(
                f"Sharded loader producer failed: {item.message}"
            ) from item.cause
        return item

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


class _ProducerError:
    """Queue sentinel carrying a producer-thread failure to the consumer."""

    def __init__(self, message: str, cause: BaseException):
        self.message = message
        self.cause = cause


def _emit(q: "queue.Queue", item, stop: threading.Event, loader_ref) -> bool:
    """Blocking put that aborts on stop/collection; True when delivered."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if loader_ref() is None:
                return False
    return False


def _stream_producer(loader_ref: "weakref.ref") -> None:
    loader = loader_ref()
    if loader is None:
        return
    q, stop = loader._queue, loader._stop
    del loader
    try:
        _stream_batches(loader_ref, q, stop)
    except Exception as e:  # noqa: BLE001 — surfaced to the consumer
        _emit(q, _ProducerError(f"{type(e).__name__}: {e}", e), stop, loader_ref)


def _stream_batches(loader_ref, q, stop) -> None:
    epoch = 0
    carry: Optional[Dict[str, np.ndarray]] = None  # shard-tail rows
    while True:
        loader = loader_ref()
        if loader is None or stop.is_set():
            return
        shard_order = [
            loader.shard_ids[i]
            for i in loader._perm(len(loader.shard_ids), salt=epoch)
        ]
        ds, bs, one_epoch = loader.dataset, loader.batch_size, not loader.loop
        del loader
        for s in shard_order:
            loader = loader_ref()
            if loader is None or stop.is_set():
                return
            lib = loader._lib
            arrays = ds.read_shard(s)
            n = next(iter(arrays.values())).shape[0]
            perm = loader._perm(n, salt=epoch * 100_003 + s + 1)
            del loader
            if carry is not None:
                # complete the boundary batch with just enough head rows —
                # the rest of the shard stays mmap'd, no full-shard copy
                need = min(bs - len(carry[ds.fields[0]]), n)
                head = np.ascontiguousarray(perm[:need])
                boundary = {
                    f: np.concatenate(
                        [carry[f], native_loader.gather_rows(lib, arrays[f], head)]
                    )
                    for f in ds.fields
                }
                perm = perm[need:]
                n -= need
                carry = None
                if len(boundary[ds.fields[0]]) == bs:
                    if not _emit(q, boundary, stop, loader_ref):
                        return
                else:  # tiny shard: still short of a full batch
                    carry = boundary
                    continue
            for i in range(0, n - bs + 1, bs):
                idx = np.ascontiguousarray(perm[i : i + bs])
                batch = {
                    f: native_loader.gather_rows(lib, arrays[f], idx)
                    for f in ds.fields
                }
                if not _emit(q, batch, stop, loader_ref):
                    return
            tail = np.ascontiguousarray(perm[(n // bs) * bs :])
            if len(tail):
                carry = {
                    f: native_loader.gather_rows(lib, arrays[f], tail)
                    for f in ds.fields
                }
        epoch += 1
        if one_epoch:
            _emit(q, None, stop, loader_ref)  # non-pinning end-of-data put
            return
