"""The port's Checkpointer: a bit-exact round trip, the JAX sidecar meta,
pruning, async saves, atomic commits and the dense-only ZeRO restore.

Everything runs on the CPU at ``DecoderConfig.tiny()``. The round trip is
exact (``torch.equal``): a checkpoint holds the bytes of every tensor. The
meta test builds the JAX package's single-device dense trainer beside the
port's and compares their ``checkpoint_meta()``; the compute dtype is held
by its name (``bfloat16``), since each package prints its own dtype object.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.train import TrainContext as JTrainContext
from maggy_tpu.train.checkpoint import Checkpointer as JCheckpointer
from maggy_tpu_torch import telemetry
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.train import (
    Checkpointer,
    Trainer,
    adamw,
    restore_zero_compat,
    synthetic_lm_batches,
)

torch.set_num_threads(2)


def _trainer(seed=0, steps=2, lr=1e-3):
    cfg = DecoderConfig.tiny()
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(lr), device="cpu")
    data = synthetic_lm_batches(cfg.vocab_size, 4, 16, seed=0)
    state = trainer.make_state(seed, next(data))
    for _ in range(steps):
        state, _ = trainer.step(state, next(data))
    return trainer, state, data


def _flat(state):
    """Every tensor of a TrainState, by name, and its scalars."""
    out = {f"p.{n}": p.detach().clone() for n, p in state.model.named_parameters()}
    osd = state.optimizer.state_dict()
    for i, per in osd["state"].items():
        for k, v in per.items():
            out[f"o.{i}.{k}"] = v.clone()
    return out, osd["param_groups"], state.step


def _assert_same(a, b):
    ta, ga, sa = a
    tb, gb, sb = b
    assert sa == sb and ga == gb and list(ta) == list(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def test_round_trip_is_bit_exact(tmp_path):
    trainer, state, data = _trainer(seed=0, steps=3)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
    ckpt.wait()
    want = _flat(state)

    # another seed, another learning rate, and an optimizer that has not
    # made its state yet: all of it must come back from the file
    other, fresh, _ = _trainer(seed=7, steps=0, lr=5e-2)
    restored = ckpt.restore(fresh, expect_meta=other.checkpoint_meta())
    assert restored is fresh
    _assert_same(_flat(restored), want)
    assert ckpt.latest_step() == 3 and ckpt.all_steps() == [3]

    # and restoring over a live optimizer state overwrites it in place
    live, moved, _ = _trainer(seed=5, steps=2, lr=5e-2)
    p0 = next(moved.model.parameters())
    m0 = moved.optimizer.state[p0]["exp_avg"]
    ckpt.restore(moved)
    assert moved.optimizer.state[p0]["exp_avg"] is m0
    _assert_same(_flat(moved), want)

    params = ckpt.restore_params()
    assert list(params) == [n for n, _ in state.model.named_parameters()]
    for n, p in state.model.named_parameters():
        assert torch.equal(params[n], p.detach())
    ckpt.close()


def test_restored_run_continues_bit_exact(tmp_path):
    trainer, state, data = _trainer(seed=0, steps=2)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(state.step, state)
    batches = [next(data) for _ in range(3)]
    ref = [float(trainer.step(state, b)[1]["loss"]) for b in batches]

    _, fresh, _ = _trainer(seed=3, steps=0)
    ckpt.restore(fresh)
    got = [float(trainer.step(fresh, b)[1]["loss"]) for b in batches]
    assert got == ref
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    ckpt.close()


def test_meta_equals_jax_checkpoint_meta(tmp_path):
    ctx = JTrainContext.create("dp", devices=jax.devices()[:1])
    jmeta = ctx.trainer(JDecoder(JConfig.tiny()), optax.adamw(1e-3)).checkpoint_meta()
    trainer, state, _ = _trainer(steps=0)
    meta = trainer.checkpoint_meta()
    assert set(meta) == set(jmeta)
    for key in meta:
        if key == "dtype":  # each package prints its own dtype object
            assert meta[key].rsplit(".", 1)[-1] == np.dtype(JConfig.tiny().dtype).name == "bfloat16"
            assert "bfloat16" in jmeta[key]
        else:
            assert meta[key] == jmeta[key], key

    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(0, state, meta=meta)
    assert ckpt.saved_meta(0) == meta == ckpt.saved_meta()
    ckpt.close()


def test_meta_mismatch_warns_and_still_restores(tmp_path):
    trainer, state, _ = _trainer(steps=1)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(1, state, meta=trainer.checkpoint_meta())
    _, fresh, _ = _trainer(seed=4, steps=0)
    live = dict(trainer.checkpoint_meta(), num_devices=4, mesh_axes={"sp": 4})
    tel = telemetry.Telemetry(worker="t")
    with telemetry.current(tel), pytest.warns(UserWarning, match="different system config"):
        ckpt.restore(fresh, expect_meta=live)
    assert tel.snapshot()["counters"]["resilience.ckpt_reshards"] == 1
    assert fresh.step == 1
    ckpt.close()


def test_max_to_keep_prunes_oldest(tmp_path):
    _, state, _ = _trainer(steps=0)
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, state)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    with pytest.raises(ValueError, match="max_to_keep"):
        Checkpointer(str(tmp_path / "ck2"), max_to_keep=0)
    ckpt.close()


def test_async_save_then_wait(tmp_path, monkeypatch):
    """save() returns once the state is in host memory; the write runs on a
    thread that wait() joins, and training may move on meanwhile."""
    import threading

    from maggy_tpu_torch.train import checkpoint as ckpt_mod

    trainer, state, data = _trainer(steps=1)
    want = _flat(state)
    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        assert gate.wait(timeout=30)
        real_save(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", slow_save)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    tel = telemetry.Telemetry(worker="ck")
    with telemetry.current(tel):
        ckpt.save(1, state)
    assert ckpt.latest_step() is None  # not committed yet
    state, _ = trainer.step(state, next(data))  # the live state moves on
    gate.set()
    ckpt.wait()
    assert ckpt.latest_step() == 1
    # the loop's stall and the writer thread's commit, both in the recorder
    # current at save()
    spans = {e["name"]: e for e in tel.drain_events() if e["kind"] == "span"}
    assert spans["checkpoint_save"]["attrs"] == {"step": 1}
    commit = spans["checkpoint_commit"]
    assert commit["attrs"]["step"] == 1 and commit["dur_ms"] >= 0
    assert commit["attrs"]["bytes"] == sum(t.numel() * t.element_size() for t in want[0].values())
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    _, fresh, _ = _trainer(seed=9, steps=0)
    _assert_same(_flat(ckpt.restore(fresh)), want)  # the step-1 bytes, not the later ones
    ckpt.close()


def test_failed_write_is_raised_by_wait(tmp_path, monkeypatch):
    from maggy_tpu_torch.train import checkpoint as ckpt_mod

    _, state, _ = _trainer(steps=0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(1, state)
    ckpt.wait()

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    ckpt.save(2, state)
    with pytest.raises(RuntimeError, match="checkpoint write"):
        ckpt.wait()
    # the interrupted step never became a step; the previous one stands
    assert ckpt.all_steps() == [1]
    assert sorted(os.listdir(tmp_path / "ck")) == ["1"]


def test_leftover_temporary_directory_is_ignored(tmp_path):
    _, state, _ = _trainer(steps=0)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(2, state)
    ckpt.close()
    # a process killed mid-save leaves its temporary directory behind, with
    # a partial file, and a bare step directory without its state file
    tmp = tmp_path / "ck" / "5.tmp-123-456"
    tmp.mkdir()
    (tmp / "state.pt").write_bytes(b"truncated")
    (tmp_path / "ck" / "7").mkdir()
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    assert ckpt.latest_step() == 2 and ckpt.all_steps() == [2]
    assert not tmp.exists()  # the next checkpointer removes it
    ckpt.close()


def test_unreadable_latest_falls_back(tmp_path):
    trainer, state, _ = _trainer(steps=1)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(1, state)
    want = _flat(state)
    ckpt.save(2, state)
    (tmp_path / "ck" / "2" / "state.pt").write_bytes(b"corrupt")
    _, fresh, _ = _trainer(seed=2, steps=0)
    tel = telemetry.Telemetry(worker="t")
    with telemetry.current(tel), pytest.warns(UserWarning, match="falling back"):
        ckpt.restore(fresh)
    assert tel.snapshot()["counters"]["checkpoint_fallback"] == 1
    _assert_same(_flat(fresh), (want[0], want[1], 1))
    with pytest.raises(Exception):
        ckpt.restore(fresh, step=2)  # an explicit step never falls back
    ckpt.close()


def test_missing_directory_behaves_as_jax(tmp_path):
    """Both packages create the directory, find no step, and raise
    FileNotFoundError on a restore."""
    jck = JCheckpointer(str(tmp_path / "jax_empty"), async_save=False)
    assert jck.latest_step() is None and jck.all_steps() == [] and jck.saved_meta() is None
    with pytest.raises(FileNotFoundError):
        jck.restore({"x": np.zeros(2)})
    jck.close()

    ckpt = Checkpointer(str(tmp_path / "empty"))
    assert os.path.isdir(tmp_path / "empty")
    assert ckpt.latest_step() is None and ckpt.all_steps() == [] and ckpt.saved_meta() is None
    _, state, _ = _trainer(steps=0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params()
    ckpt.close()


@pytest.mark.parametrize("side", ["saved", "live"])
def test_zero_layout_raises_naming_item_7(tmp_path, side):
    """ZeRO-1 layouts convert now (the multi-rank restores are in
    ``tests/test_torch_zero_dist.py``). ``saved``: a checkpoint holding the
    flat ZeRO-1 layout (two shards, 4 KiB buckets) restores into a dense
    trainer with a warning and a ``resilience.ckpt_zero_reshards`` count,
    its optimizer state equal to the dense state it was made from.
    ``live``: the dense payload converted for a live ZeRO-1 layout holds
    each bucket's moments as one flat padded vector, JAX's leaf order, and
    converts back exactly."""
    from maggy_tpu_torch.parallel import overlap
    from maggy_tpu_torch.train.checkpoint import convert_zero_payload

    trainer, state, _ = _trainer(steps=2)
    dense = trainer.checkpoint_meta()
    zero1 = dict(dense, zero={"stage": 1, "bucket_mb": 4 / 1024, "shards": 2})
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(2, state, meta=dense)
    payload = ckpt._load(2)
    flat = convert_zero_payload(payload, saved=dense["zero"], live=zero1["zero"])
    params = payload["params"]
    order = overlap.jax_leaf_order(list(params))
    plan = overlap.plan_buckets([params[n] for n in order], 4 / 1024, pad_to=2)
    assert len(plan.buckets) > 2 and sorted(flat["optimizer"]["state"]) == list(range(len(plan.buckets)))
    index = {n: i for i, n in enumerate(params)}
    for j, b in enumerate(plan.buckets):
        for key in ("exp_avg", "exp_avg_sq"):
            want = overlap.flatten_buckets([payload["optimizer"]["state"][index[order[i]]][key] for i in b.indices],
                                           overlap.plan_buckets([params[order[i]] for i in b.indices][::-1],
                                                                None, pad_to=2))
            assert torch.equal(flat["optimizer"]["state"][j][key], next(iter(want.values())))
    if side == "live":
        back = convert_zero_payload(flat, saved=zero1["zero"], live=dense["zero"])
        for i, per in payload["optimizer"]["state"].items():
            for key, value in per.items():
                assert torch.equal(back["optimizer"]["state"][i][key], value), (i, key)
    else:  # rewrite the checkpoint in the ZeRO-1 layout, then restore it dense
        path = os.path.join(ckpt.directory, "2", "state.pt")
        torch.save(flat, path + ".zero")  # the loaded payload maps the old file: a new inode
        os.replace(path + ".zero", path)
        ckpt._write_meta(2, zero1)
        tel = telemetry.Telemetry(worker="test-zero")
        _, fresh, _ = _trainer(seed=8, steps=0)
        with telemetry.current(tel), pytest.warns(UserWarning, match=r"ZeRO-1 \(shards=2"):
            restore_zero_compat(ckpt, fresh, live_meta=dense)
        assert tel.snapshot()["counters"]["resilience.ckpt_zero_reshards"] == 1
        _assert_same(_flat(fresh), _flat(state))
    ckpt.close()


def test_dense_zero_compat_is_restore(tmp_path):
    trainer, state, _ = _trainer(steps=2)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ckpt.save(2, state, meta=trainer.checkpoint_meta())
    _, fresh, _ = _trainer(seed=8, steps=0)
    restore_zero_compat(ckpt, fresh, live_meta=trainer.checkpoint_meta())
    _assert_same(_flat(fresh), _flat(state))
    ckpt.close()


def test_exit_waits_for_an_async_save(tmp_path):
    """A process that exits right after an async save leaves it committed."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    child = textwrap.dedent("""
        import sys
        from maggy_tpu_torch.models import Decoder, DecoderConfig
        from maggy_tpu_torch.train import Checkpointer, Trainer, adamw, synthetic_lm_batches
        cfg = DecoderConfig.tiny()
        trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-3), device="cpu")
        state = trainer.make_state(0, next(synthetic_lm_batches(cfg.vocab_size, 2, 16)))
        Checkpointer(sys.argv[1]).save(3, state)
    """)
    repo = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", child, str(tmp_path / "ck")], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(repo)))
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 3
