"""The port's data plane against the JAX package's: the native batcher, the
sharded ``.npy`` layout (read and written by either package), the sharded
stream loader, the Parquet datasets and ``host_shard``.

Both packages compile the same C++ batcher (each from its own copy), so the
same arrays and seed give the same batches exactly, across epochs and after
``skip``; without a compiler both fall back to numpy's permutation and a
numpy gather, again equal to each other.
"""

import logging
import time

import numpy as np
import pytest

from maggy_tpu.train import data as jdata
from maggy_tpu.train import native_loader as jnative
from maggy_tpu.train import sharded_dataset as jsharded
from maggy_tpu_torch.train import (
    NativeBatchLoader,
    ShardedDataset,
    ShardedStreamLoader,
    host_shard,
    write_sharded,
)
from maggy_tpu_torch.train import native_loader as tnative
from maggy_tpu_torch.train import sharded_dataset as tsharded


@pytest.fixture()
def jax_lib(monkeypatch):
    """The JAX package's batcher library, loaded. Its build writes the
    library in place, so a test in another worker process may find it half
    written: try again, as that worker's compile ends within seconds."""
    for _ in range(20):
        lib = jnative._native_lib()
        if lib is not None:
            return lib
        monkeypatch.setattr(jnative, "_LIB_TRIED", False)
        time.sleep(0.5)
    raise AssertionError("the JAX package's batcher did not load")


def _arrays(n=203, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, 1000, (n, 12)).astype(np.int32),
        "labels": rng.integers(0, 5, n).astype(np.int64),
    }


def _drain(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_loader_equals_jax_across_epochs(shuffle, jax_lib):
    arrays = _arrays()
    mine = NativeBatchLoader(arrays, 16, seed=5, shuffle=shuffle)
    ref = jnative.NativeBatchLoader(arrays, 16, seed=5, shuffle=shuffle)
    assert mine.using_native and ref.using_native
    _same(_drain(mine, 40), _drain(ref, 40))  # 12 batches an epoch: 3+ epochs


def test_native_loader_equals_jax_after_skip(jax_lib):
    arrays = _arrays()
    mine = NativeBatchLoader(arrays, 16, seed=2)
    ref = jnative.NativeBatchLoader(arrays, 16, seed=2)
    assert mine.skip(29) == ref.skip(29) == 29
    _same(_drain(mine, 8), _drain(ref, 8))


def test_native_loader_one_epoch_ends(jax_lib):
    arrays = _arrays(n=40)
    mine = NativeBatchLoader(arrays, 16, seed=1, loop=False)
    ref = jnative.NativeBatchLoader(arrays, 16, seed=1, loop=False)
    _same(list(mine), list(ref))
    mine.close()
    ref.close()


def test_native_primitives_equal_jax(jax_lib):
    lib, jlib = tnative._native_lib(), jax_lib
    assert lib is not None
    for n, seed in ((1, 0), (97, 3), (1000, 2**63 + 5)):
        np.testing.assert_array_equal(tnative.perm_indices(lib, n, seed), jnative.perm_indices(jlib, n, seed))
        np.testing.assert_array_equal(tnative.perm_indices(None, n, seed), jnative.perm_indices(None, n, seed))
    arr = _arrays()["tokens"]
    idx = tnative.perm_indices(lib, len(arr), 7)[:50]
    np.testing.assert_array_equal(tnative.gather_rows(lib, arr, idx), arr[idx])
    with pytest.raises(IndexError):
        tnative.gather_rows(lib, arr, np.array([len(arr)]))


def test_without_a_compiler_falls_back_to_numpy(monkeypatch, tmp_path, caplog):
    """No g++: a logged warning, numpy's permutation and gather, and the
    same batches as the JAX package's own fallback."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_TRIED", False)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    with caplog.at_level(logging.WARNING, logger=tnative.__name__):
        mine = NativeBatchLoader(_arrays(), 16, seed=4)
    assert not mine.using_native
    assert "numpy fallback" in caplog.text
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_LIB_TRIED", True)
    ref = jnative.NativeBatchLoader(_arrays(), 16, seed=4)
    assert not ref.using_native
    _same(_drain(mine, 20), _drain(ref, 20))


def test_library_is_hashed_on_its_source():
    path = tnative.library_path()
    assert path.parent.parent == tnative.BUILD_ROOT
    assert tnative._native_lib() is not None and path.exists()
    assert tnative.SOURCE.read_bytes().count(b"mtl_gather") >= 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_layout_cross_reads(tmp_path, writer):
    arrays = _arrays()
    (jsharded if writer == "jax" else tsharded).write_sharded(str(tmp_path / "d"), arrays, num_shards=5)
    mine = ShardedDataset(str(tmp_path / "d"))
    ref = jsharded.ShardedDataset(str(tmp_path / "d"))
    assert mine.fields == ref.fields == ["labels", "tokens"]
    assert mine.num_shards == ref.num_shards == 5
    for s in range(5):
        for f in mine.fields:
            got = mine.open_shard(f, s)
            assert isinstance(got, np.memmap)  # local shards are mapped, not read
            np.testing.assert_array_equal(got, ref.open_shard(f, s))
    np.testing.assert_array_equal(
        np.concatenate([mine.open_shard("tokens", s) for s in range(5)]), arrays["tokens"])
    assert mine.my_shards(1, 2) == ref.my_shards(1, 2) == [1, 3]
    only = ShardedDataset(str(tmp_path / "d"), columns=["tokens"])
    assert only.fields == ["tokens"]


def test_sharded_stream_loader_equals_jax(tmp_path, jax_lib):
    write_sharded(str(tmp_path / "d"), _arrays(), num_shards=7)
    mine = ShardedDataset(str(tmp_path / "d")).loader(16, seed=3, process_index=1, num_processes=2)
    ref = jsharded.ShardedDataset(str(tmp_path / "d")).loader(16, seed=3, process_index=1, num_processes=2)
    assert isinstance(mine, ShardedStreamLoader) and mine.using_native
    _same(_drain(mine, 15), _drain(ref, 15))


def test_sharded_stream_loader_relays_producer_errors(tmp_path):
    write_sharded(str(tmp_path / "d"), _arrays(), num_shards=3)
    ds = ShardedDataset(str(tmp_path / "d"))

    def broken(shard):
        raise OSError("shard gone")

    ds.read_shard = broken
    loader = ds.loader(16, seed=0)
    with pytest.raises(RuntimeError, match="shard gone"):
        next(loader)
    loader.close()


def test_writer_and_dataset_validation(tmp_path):
    with pytest.raises(ValueError):
        write_sharded(str(tmp_path / "x"), {}, 2)
    with pytest.raises(ValueError):
        write_sharded(str(tmp_path / "x"), {"a": np.zeros(3), "b": np.zeros(4)}, 2)
    with pytest.raises(ValueError):
        ShardedDataset(str(tmp_path / "missing_fields"))
    write_sharded(str(tmp_path / "d"), _arrays(), num_shards=2)
    with pytest.raises(ValueError, match="not in dataset fields"):
        ShardedDataset(str(tmp_path / "d"), columns=["nope"])
    with pytest.raises(ValueError, match="only 2 shards"):
        ShardedDataset(str(tmp_path / "d")).my_shards(0, 3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_cross_reads(tmp_path, writer, jax_lib):
    pytest.importorskip("pyarrow")
    arrays = _arrays()
    (jsharded if writer == "jax" else tsharded).write_parquet(
        str(tmp_path / "pq"), arrays, rows_per_group=40, num_files=2)
    mine = tsharded.ParquetShardedDataset(str(tmp_path / "pq"))
    ref = jsharded.ParquetShardedDataset(str(tmp_path / "pq"))
    assert mine.num_shards == ref.num_shards and mine.fields == ref.fields
    for s in range(mine.num_shards):
        got, want = mine.read_shard(s), ref.read_shard(s)
        for f in mine.fields:
            np.testing.assert_array_equal(got[f], want[f])
    _same(_drain(mine.loader(16, seed=1), 10), _drain(ref.loader(16, seed=1), 10))


def test_parquet_without_pyarrow_raises_with_guidance(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.startswith("pyarrow"):
            raise ImportError("no pyarrow here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="write_sharded"):
        tsharded.ParquetShardedDataset(str(tmp_path))


def test_host_shard_equals_jax():
    arrays = _arrays(n=50)
    for i in range(3):
        got, want = host_shard(arrays, i, 3), jdata.host_shard(arrays, i, 3)
        for k in arrays:
            np.testing.assert_array_equal(got[k], want[k])
    assert host_shard(arrays, 0, 1) is arrays
