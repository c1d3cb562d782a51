"""The port's DevicePrefetcher and skip paths: the cases of the JAX
package's ``tests/test_prefetch.py`` (order and the consumption cap, error
relay, ``skip`` before start, telemetry, ``skip_batches`` over generators,
``batch_iterator`` and ``NativeBatchLoader`` skips), run against the port,
plus ``set_depth``, ``close`` and collection of an un-closed prefetcher.

The card side (pinned ring, side stream, ``record_stream``) is in
``tests/test_torch_train_cuda.py``.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from maggy_tpu_torch import telemetry
from maggy_tpu_torch.train import DevicePrefetcher, NativeBatchLoader, batch_iterator, skip_batches
from maggy_tpu_torch.train import data as tdata


def test_prefetcher_preserves_order_and_caps_consumption():
    pulled = {"n": 0}

    def src():
        i = 0
        while True:
            pulled["n"] += 1
            yield i
            i += 1

    pf = DevicePrefetcher(src(), put=lambda x: x * 10, depth=2, max_items=5)
    out = [next(pf) for _ in range(5)]
    assert out == [0, 10, 20, 30, 40]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    # max_items bounds SOURCE consumption exactly: a shared iterator keeps
    # its position across consecutive fit calls
    assert pulled["n"] == 5


def test_prefetcher_relays_source_and_put_errors():
    def exploding():
        yield 1
        raise RuntimeError("loader died")

    pf = DevicePrefetcher(exploding(), put=lambda x: x, depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="loader died"):
        next(pf)
    with pytest.raises(RuntimeError, match="loader died"):
        next(pf)  # terminal: the error sticks, no hang on an empty queue
    pf.close()

    pf2 = DevicePrefetcher(iter([1, 2]), put=lambda x: 1 / 0, depth=2)
    with pytest.raises(ZeroDivisionError):
        next(pf2)
    pf2.close()


def test_prefetcher_skip_delegates_before_start():
    it = batch_iterator({"x": np.arange(120).reshape(30, 4)}, 5, seed=2)
    pf = DevicePrefetcher(it, put=lambda b: b, depth=2)
    assert pf.skip(7) == 7
    assert it.batches_materialized == 0  # index advance, nothing gathered
    ref = batch_iterator({"x": np.arange(120).reshape(30, 4)}, 5, seed=2)
    skip_batches(ref, 7)
    np.testing.assert_array_equal(next(pf)["x"], next(ref)["x"])
    # after the start a skip drains placed batches instead
    assert pf.skip(2) == 2
    skip_batches(ref, 2)
    np.testing.assert_array_equal(next(pf)["x"], next(ref)["x"])
    pf.close()


def test_prefetcher_records_telemetry():
    tel = telemetry.Telemetry(worker="t")
    pf = DevicePrefetcher(
        iter(range(4)), put=lambda x: x, depth=2, telemetry_recorder=tel
    )
    for _ in range(4):
        next(pf)
    pf.close()
    g = tel.snapshot()["gauges"]
    assert "input_wait_ms" in g and "prefetch_depth" in g
    spans = [e["name"] for e in tel.drain_events() if e["kind"] == "span"]
    assert spans.count("shard_batch") == 4


def test_prefetcher_set_depth_and_close():
    pulled = {"n": 0}

    def src():
        while True:
            pulled["n"] += 1
            yield pulled["n"]

    pf = DevicePrefetcher(src(), put=lambda x: x, depth=1)
    assert next(pf) == 1
    with pytest.raises(ValueError):
        pf.set_depth(0)
    pf.set_depth(4)
    deadline = time.monotonic() + 10
    while pf._queue.qsize() < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._queue.qsize() == 4  # the larger window filled
    pf.close()
    pf.close()  # idempotent
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError):
        DevicePrefetcher(src(), put=lambda x: x, depth=0)


def test_unclosed_prefetcher_is_collected():
    pf = DevicePrefetcher(iter(range(100)), put=lambda x: x, depth=2)
    next(pf)
    thread = pf._thread
    del pf
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_prefetcher_on_cpu_device_hands_out_the_batch():
    batch = {"tokens": np.arange(8, dtype=np.int32).reshape(2, 4)}
    pf = DevicePrefetcher(iter([batch]), put=lambda b: b, depth=2, device="cpu")
    out = next(pf)
    assert out is batch  # nothing to copy on the host
    pf.close()


# --------------------------------------------------------------- skip(n) paths


def test_skip_batches_falls_back_to_next_for_generators():
    def gen():
        yield from range(10)

    g = gen()
    assert skip_batches(g, 3) == 3
    assert next(g) == 3
    assert skip_batches(g, 100) == 6  # short on exhaustion
    assert skip_batches(g, 0) == 0


def test_batch_iterator_skip_matches_next_across_epochs():
    arrays = {"x": np.arange(80).reshape(20, 4)}
    a = batch_iterator(arrays, 8, seed=7)  # 2 batches/epoch
    b = batch_iterator(arrays, 8, seed=7)
    for _ in range(11):
        next(a)
    assert b.skip(11) == 11
    assert b.batches_materialized == 0
    for _ in range(4):
        np.testing.assert_array_equal(next(a)["x"], next(b)["x"])
    assert isinstance(a, tdata.BatchIterator)


def test_native_loader_skip_avoids_gathers():
    arrays = {"x": np.arange(4000).reshape(1000, 4)}
    a = NativeBatchLoader(arrays, 10, seed=3)
    b = NativeBatchLoader(arrays, 10, seed=3)
    try:
        for _ in range(250):
            next(a)
        assert b.skip(250) == 250
        for _ in range(3):
            np.testing.assert_array_equal(next(a)["x"], next(b)["x"])
        time.sleep(0.2)  # let the producer run ahead to its bound
        # only the pre-skip in-flight/queued batches plus the 3 consumed and
        # the refilled prefetch window were ever gathered — not 250
        assert b.gathers <= 12, b.gathers
    finally:
        a.close()
        b.close()


def test_fit_resume_skips_without_materializing(tmp_path):
    """fit(resume="auto") fast-forwards a skip()-capable loader by index:
    the skipped range is never gathered."""
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Checkpointer, Trainer, adamw

    cfg = DecoderConfig.tiny()
    arrays = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab_size, (64, 16)).astype(np.int32)}
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")
    state = trainer.make_state(0, {"tokens": arrays["tokens"][:4]})
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    state, _ = trainer.fit(state, batch_iterator(arrays, 4, seed=0), 5, checkpointer=ckpt, checkpoint_every=5)
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")
    state = trainer.make_state(1, {"tokens": arrays["tokens"][:4]})
    it = batch_iterator(arrays, 4, seed=0)
    state, out = trainer.fit(state, it, 7, checkpointer=ckpt, resume="auto")
    ckpt.close()
    assert out["resumed_from"] == 5.0 and state.step == 7
    assert it.batches_materialized == 2  # only the two steps that ran


def test_prefetch_env_knob(monkeypatch):
    from maggy_tpu_torch.train.trainer import _prefetch_depth

    monkeypatch.delenv("MAGGY_TPU_PREFETCH", raising=False)
    assert _prefetch_depth(None) == 2
    monkeypatch.setenv("MAGGY_TPU_PREFETCH", "0")
    assert _prefetch_depth(None) == 0
    monkeypatch.setenv("MAGGY_TPU_PREFETCH", "junk")
    assert _prefetch_depth(None) == 2
    assert _prefetch_depth(3) == 3


def test_fit_leaves_no_prefetch_thread():
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    cfg = DecoderConfig.tiny()
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")
    data = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=0)
    state = trainer.make_state(0, next(data))
    trainer.fit(state, data, 3)
    alive = [t for t in threading.enumerate() if t.name == "maggy-device-prefetch"]
    for t in alive:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in alive)


class _CountingScalar:
    """A loss that counts the host reads (``float``) of what it adds up to."""

    def __init__(self, value, counter):
        self.value, self.counter = value, counter

    def __add__(self, other):
        return _CountingScalar(self.value + other.value, self.counter)

    def __float__(self):
        self.counter["n"] += 1
        return float(self.value)


@pytest.mark.parametrize("prefetch", [None, 0, 2, 10])
def test_evaluate_reads_once_and_takes_exactly_num_batches(prefetch):
    """JAX's ``test_evaluate_accumulates_on_device_single_conversion``: the
    losses add up on the device and are read once; and the iterator gives
    exactly ``num_batches`` batches, whatever the prefetch depth."""
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    cfg = DecoderConfig.tiny()
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")
    source = synthetic_lm_batches(cfg.vocab_size, 2, 16, seed=0)
    state = trainer.make_state(0, next(source))
    pulled = {"n": 0}

    def counted():
        for batch in source:
            pulled["n"] += 1
            yield batch

    data = counted()
    want = trainer.evaluate(state, data, 5, prefetch=prefetch)
    assert pulled["n"] == 5 and np.isfinite(want["loss"])
    reads = {"n": 0}
    real = trainer._losses
    trainer._losses = lambda logits, batch: tuple(_CountingScalar(x, reads) for x in real(logits, batch))
    try:
        got = trainer.evaluate(state, data, 5, prefetch=prefetch)
    finally:
        trainer._losses = real
    assert reads["n"] == 1 and pulled["n"] == 10 and np.isfinite(got["loss"])
    alive = [t for t in threading.enumerate() if t.name == "maggy-device-prefetch"]
    for t in alive:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in alive)


def test_prefetcher_started_is_lazy():
    pf = DevicePrefetcher(iter(range(3)), put=lambda x: x, depth=2)
    assert not pf.started
    assert next(pf) == 0 and pf.started
    pf.close()
