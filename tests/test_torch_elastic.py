"""Elastic membership in the port: the counterparts of the JAX package's
``tests/test_elastic_membership.py``, on gloo ranks on the CPU.

A slice in the port is a contiguous block of rank processes. JAX simulates
2 slices x ``fsdp=4`` on its 8 CPU devices in one executor; the port runs 2
slices x ``fsdp=2`` of spawned gloo ranks (4 processes) over the same
global batch of 8 rows, both in fp32 from the same weights (JAX's
``make_state(key(0))``), on the same synthetic stream and the same train_fn
(a checkpoint every 2 steps, ``fit(resume="auto")``, no prefetch).

* The ``slice`` axis: ``slice_device_groups``, ``make_slice_mesh`` and
  ``slice_rules`` against JAX's (the rule table equal to JAX's).
* The uninterrupted sliced run ends within 2e-5 of JAX's.
* ``slice_drop`` at step 5: the final loss within 2e-5 of JAX's drop run,
  ``resume_from`` 4, every global batch index in the chief's committed
  trajectory exactly once, and the counters and gauges JAX's run exports.
* Drop at 3, rejoin at 6: ``resume_from`` 2 then 6, epoch 2, the loss
  within 2e-5 of JAX's.
* A drop of slice 0: the ranks of slice 1 form the group, the new rank 0
  finds the old rank 0's checkpoint, the loss equals the slice-1 drop's;
  with one rank a slice the survivor is a group of one and still resumes
  from step 4.
* 2 slices x ``dp=2``: the HSDP layout over the flattened (``slice``,
  ``data``) replicas, and ZeRO-1 with small buckets summed over ``data``
  then ``slice``, each within 2e-5 of JAX's uninterrupted sliced run.
* ``min_slices=2``: ``MembershipViolation`` matching "min_slices=2", no
  hang, no restart.
* Workers mode (``num_slices=None``, one slice a rank), a rank killed at
  step 4: under ``data_plane="local"`` the survivor reshapes in its
  process, under ``"auto"`` the driver relaunches it at the new width; one
  worker's result, one slice drop, no restart slot. Under ``"auto"`` a
  kill of rank 0 too: the relaunched survivor resumes from its checkpoint.
* ``EXEC_CONFIG`` carries the membership view (and the group of the active
  slices' ranks).

Every ``lagom`` call runs on a thread, waited for under 120 s and stopped
past it (``test_torch_pod._lagom``).
"""

import glob
import json
import os

import pytest
import torch

# lagom on a thread, stopped (its ranks reaped) if it outlives its wait
from test_torch_pod import _lagom
from maggy_tpu_torch import experiment
from maggy_tpu_torch.config import DistributedConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig

VOCAB_SEED = 5
NUM_STEPS = 8
LR = 3e-3
ROWS, SEQ = 8, 16


@pytest.fixture()
def port_env(tmp_path, monkeypatch):
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.resilience import chaos

    root = tmp_path / "torch"
    env_mod.set_instance(BaseEnv(str(root)))
    monkeypatch.delenv("MAGGY_TPU_CHAOS", raising=False)
    # one intra-op thread a spawned rank: the tiny model gains nothing from
    # more, and the file runs beside other test processes
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chaos.reset()
    yield env_mod.get_instance()
    chaos.reset()
    env_mod.set_instance(None)


class RecordingBatches:
    """JAX's data-parity harness: the synthetic stream, logging the global
    index of every batch served to ``fit`` and where a resume skipped to."""

    def __init__(self, vocab_size):
        from maggy_tpu_torch.train.data import synthetic_lm_batches

        self._it = synthetic_lm_batches(vocab_size, ROWS, SEQ, seed=VOCAB_SEED)
        self._pos = 0
        self.segment = {"resume_from": 0, "served": []}

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.segment["served"].append(self._pos)
        self._pos += 1
        return batch

    def skip(self, n):
        for _ in range(n):
            next(self._it)
        self._pos += n
        self.segment["resume_from"] = self._pos
        return n


class _HoldForEpoch:
    """A reporter whose broadcast of step ``hold_at`` waits (up to 60 s)
    until the heartbeat has announced a newer membership epoch: the
    survivor of a workers-mode kill then meets the reshape at the next step
    boundary however fast it trains."""

    def __init__(self, membership, hold_at):
        self.membership, self.hold_at = membership, hold_at

    def broadcast(self, value, step):
        import time

        if step == self.hold_at and self.membership.epoch == 0:
            deadline = time.time() + 60
            while self.membership.pending_epoch() is None and time.time() < deadline:
                time.sleep(0.01)


def elastic_train(model, dataset, hparams, ctx, trial_dir):
    """JAX's ``_train_fn_factory`` train_fn, from JAX's weights: every entry
    appends its segment (the rank, the epoch, the resume point, the batches
    served) to this process's log."""
    from maggy_tpu_torch.train import adamw
    from maggy_tpu_torch.train.checkpoint import Checkpointer
    from maggy_tpu_torch.train.data import synthetic_lm_batches

    trainer = ctx.trainer(model, adamw(LR))
    data = RecordingBatches(model.cfg.vocab_size)
    init = {k: torch.from_numpy(v) for k, v in dataset["init"].items()}
    state = trainer.make_state(0, next(synthetic_lm_batches(model.cfg.vocab_size, ROWS, SEQ, seed=VOCAB_SEED)),
                               params=init)
    ckpt = Checkpointer(os.path.join(trial_dir, "ckpt"), async_save=False)
    try:
        hold = _HoldForEpoch(ctx.membership, hparams["hold_at"]) if "hold_at" in hparams else None
        state, metrics = trainer.fit(state, data, num_steps=NUM_STEPS, reporter=hold, report_every=1,
                                     checkpointer=ckpt, checkpoint_every=2, resume="auto", prefetch=0,
                                     metrics_window=0)
    finally:
        ckpt.close()
        segment = dict(data.segment, rank=ctx.process_index, world=ctx.num_processes,
                       epoch=ctx.membership.epoch if ctx.membership is not None else None,
                       mesh=dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)),
                       overlap=trainer._overlap_mode()[0])
        with open(os.path.join(hparams["log_dir"], f"{os.getpid()}.jsonl"), "a") as f:
            f.write(json.dumps(segment) + "\n")
    return {"metric": -metrics["loss"], "loss": metrics["loss"]}


def _segments(log_dir):
    """Every entry's segment, per process (in entry order). A process the
    driver reaped between opening its log and writing its line (a group
    torn down after a death) left an empty file or a line without its
    newline: nothing of it was recorded, so it is skipped."""
    out = []
    for path in sorted(glob.glob(os.path.join(str(log_dir), "*.jsonl"))):
        with open(path) as f:
            entries = [json.loads(line) for line in f if line.endswith("\n")]
        if entries:
            out.append(entries)
    return out


def _chief(log_dir):
    """The committed trajectory's segments: rank 0's at each epoch."""
    segs = [s for proc in _segments(log_dir) for s in proc if s["rank"] == 0]
    return sorted(segs, key=lambda s: s["epoch"])


def _assert_exactly_once(segments, total):
    """JAX's check: truncating each segment at its successor's resume point
    tiles 0..total-1 with no gap and no overlap."""
    committed = []
    for i, seg in enumerate(segments):
        start = seg["resume_from"]
        assert seg["served"] == list(range(start, start + len(seg["served"])))
        end = segments[i + 1]["resume_from"] if i + 1 < len(segments) else total
        committed.extend(range(start, end))
    assert committed == list(range(total))


def _exported(exp_dir, kind):
    """Counters (summed) or gauges (the last written) of every telemetry
    JSONL under the experiment directory, as JAX's test merges them."""
    merged = {}
    for path in glob.glob(os.path.join(exp_dir, "telemetry", "*.jsonl")):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") != "snapshot":
                    continue
                for k, v in (rec.get(kind) or {}).items():
                    merged[k] = merged.get(k, 0) + v if kind == "counters" else v
    return merged


# ------------------------------------------------------------ the JAX side

_JAX = {}


def _jax_init():
    """JAX's tiny fp32 Decoder weights from ``make_state(key(0))`` on its
    sliced mesh, as the port's state dict (numpy)."""
    if "init" not in _JAX:
        import jax
        import jax.numpy as jnp
        import optax

        from maggy_tpu.models import Decoder as JDecoder
        from maggy_tpu.models import DecoderConfig as JConfig
        from maggy_tpu.parallel.sharding import unbox
        from maggy_tpu.train import TrainContext as JTrainContext
        from maggy_tpu.train.data import synthetic_lm_batches
        from maggy_tpu_torch.convert import decoder_params_from_flax

        jcfg = JConfig.tiny(dtype=jnp.float32)
        jctx = JTrainContext.create_sliced("fsdp", total_slices=2)
        state = jctx.trainer(JDecoder(jcfg), optax.adamw(LR)).make_state(
            jax.random.key(0), next(synthetic_lm_batches(jcfg.vocab_size, ROWS, SEQ, seed=VOCAB_SEED)))
        params = decoder_params_from_flax(jax.device_get(unbox(state.params)), DecoderConfig.tiny(dtype=torch.float32))
        _JAX["init"] = {k: v.numpy() for k, v in params.items()}
    return _JAX["init"]


def _jax_run(chaos_spec, tmp_path):
    """JAX's elastic run (its test's train_fn and config, in fp32): the
    result and the segments of its one executor."""
    if chaos_spec not in _JAX:
        from maggy_tpu import experiment as jexperiment
        from maggy_tpu.core import env as jenv
        from maggy_tpu.core.env.base import BaseEnv as JBaseEnv
        from maggy_tpu.models import DecoderConfig as JConfig
        from maggy_tpu.resilience import chaos as jchaos
        from test_elastic_membership import _elastic_conf, _train_fn_factory

        root = tmp_path / f"jax_{len(_JAX)}"
        jenv.set_instance(JBaseEnv(str(root)))
        jchaos.reset()
        if chaos_spec:
            jchaos.install(jchaos.Chaos.parse(chaos_spec))
        log = []
        try:
            cfg = JConfig.tiny()
            result = jexperiment.lagom(_train_fn_factory(cfg, data_log=log),
                                       _elastic_conf(cfg, mixed_precision=False))
        finally:
            jchaos.reset()
            jenv.set_instance(None)
        _JAX[chaos_spec] = (result, log)
    return _JAX[chaos_spec]


def _config(log_dir, **kw):
    defaults = dict(module=Decoder(DecoderConfig.tiny(), device="meta"), dataset={"init": _jax_init()},
                    hparams={"log_dir": str(log_dir)}, sharding="fsdp", num_executors=4, elastic=True,
                    num_slices=2, min_slices=1, mixed_precision=False, hb_interval=0.05, device="cpu")
    defaults.update(kw)
    return DistributedConfig(**defaults)


def _port_run(tmp_path, monkeypatch, chaos_spec=None, hparams=None, **kw):
    log_dir = tmp_path / "segments"
    log_dir.mkdir()
    if chaos_spec:
        monkeypatch.setenv("MAGGY_TPU_CHAOS", chaos_spec)
    result = _lagom(elastic_train, _config(log_dir, hparams={"log_dir": str(log_dir), **(hparams or {})}, **kw))
    return result, log_dir


def _exp_dir(env):
    return env.experiment_dir(experiment.APP_ID, experiment.RUN_ID)


# ------------------------------------------------------------------- units


def test_slice_topology_mesh_and_rules():
    """The ``slice`` axis against JAX's: contiguous slices of the ranks (a
    count that does not split raises JAX's error), a sliced mesh over gloo
    ranks of a fake process group (its axis sizes), the reshape
    transition, and ``slice_rules`` equal to JAX's table."""
    import jax
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from maggy_tpu.parallel import mesh as jmesh
    from maggy_tpu.parallel import sharding as jshd
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
    from maggy_tpu.parallel.spec import SliceTopology as JSliceTopology
    from maggy_tpu_torch.parallel import sharding as shd
    from maggy_tpu_torch.parallel.mesh import make_slice_mesh, mesh_shape, slice_device_groups
    from maggy_tpu_torch.parallel.spec import AXIS_SLICE, SLICE_MESH_AXES, ShardingSpec, SliceTopology

    groups = slice_device_groups(2, range(8))
    jgroups = jmesh.slice_device_groups(2)
    assert [len(g) for g in groups] == [len(g) for g in jgroups] == [4, 4]
    assert groups[0] + groups[1] == list(range(8))
    with pytest.raises(ValueError, match="do not split into 3 equal slices"):
        slice_device_groups(3, range(8))
    with pytest.raises(ValueError, match="do not split into 3 equal slices"):
        jmesh.slice_device_groups(3)

    topo = SliceTopology(n_slices=2, slice_spec=ShardingSpec(fsdp=4))
    jtopo = JSliceTopology(n_slices=2, slice_spec=JShardingSpec(fsdp=4))
    assert (topo.num_devices, topo.devices_per_slice, topo.axis_sizes()) == (
        jtopo.num_devices, jtopo.devices_per_slice, jtopo.axis_sizes())
    assert topo.with_slices(1).slice_spec == topo.slice_spec
    assert topo.with_slices(1).axis_sizes() == jtopo.with_slices(1).axis_sizes()

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_slice_mesh(topo, "cpu")
        jshape = dict(jmesh.make_slice_mesh(jtopo).shape)
        assert mesh.mesh_dim_names == SLICE_MESH_AXES
        assert mesh_shape(mesh) == {a: jshape[a] for a in SLICE_MESH_AXES}
        assert mesh_shape(mesh)[AXIS_SLICE] == 2 and mesh_shape(mesh)["fsdp"] == 4
        with pytest.raises(ValueError, match="SliceTopology covers 4 devices"):
            make_slice_mesh(topo.with_slices(1), "cpu")
    finally:
        dist.destroy_process_group()
    wide = dict(jmesh.make_slice_mesh(JSliceTopology(n_slices=8, slice_spec=JShardingSpec())).shape)
    assert SliceTopology(n_slices=8).axis_sizes()[0] == wide[AXIS_SLICE] == 8
    assert len(jax.devices()) == 8

    rules = dict(shd.slice_rules())
    assert shd.slice_rules() == jshd.slice_rules(jshd.DEFAULT_RULES)
    assert rules["batch"] == (AXIS_SLICE, "data", "fsdp")
    assert rules["embed"] == "fsdp"


def test_exec_config_carries_membership_view(port_env):
    """The EXEC_CONFIG exchange is how a reshape reaches the ranks: the
    payload carries the current epoch's view (JAX's keys) and the group of
    the active slices' ranks, each rank at its place among them."""
    from maggy_tpu_torch.core.driver.distributed import DistributedTrainingDriver

    cfg = DistributedConfig(hparams={}, sharding="fsdp", num_executors=4, elastic=True, num_slices=2,
                            min_slices=1, device="cpu")
    driver = DistributedTrainingDriver(cfg, "app", 0)
    driver.server = driver._make_server()  # not started; cluster_spec is empty
    out = driver._exec_config_callback({"partition_id": 3})
    assert out["membership"]["epoch"] == 0
    assert out["membership"]["active"] == [0, 1]
    assert out["membership"]["mode"] == "sim"
    assert (out["ranks_per_slice"], out["world_size"], out["rank"]) == (2, 4, 3)

    driver.membership = driver.membership.drop(0)
    out = driver._exec_config_callback({"partition_id": 3})
    assert out["membership"]["epoch"] == 1
    assert out["membership"]["active"] == [1]
    assert (out["world_size"], out["rank"], out["num_processes"]) == (2, 1, 2)
    assert driver._exec_config_callback({"partition_id": 0})["rank"] is None  # parked

    workers = DistributedTrainingDriver(
        DistributedConfig(hparams={}, sharding="dp", data_plane="local", elastic=True, num_executors=2,
                          device="cpu"), "app", 1)
    workers.server = workers._make_server()
    assert workers._exec_config_callback({"partition_id": 1})["membership"]["mode"] == "workers"
    workers.membership = workers.membership.drop(0)
    assert workers._exec_config_callback({"partition_id": 1})["num_processes"] == 1


# ------------------------------------------------------------ acceptance


def test_sliced_run_matches_jax(port_env, tmp_path, monkeypatch):
    """The uninterrupted run on 2 slices x fsdp=2 ends on JAX's loss; every
    rank trained on the sliced mesh through all 8 steps."""
    jresult, _ = _jax_run(None, tmp_path)
    result, log_dir = _port_run(tmp_path, monkeypatch)
    assert result["num_workers"] == 4
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)
    procs = _segments(log_dir)
    assert len(procs) == 4 and all(len(p) == 1 for p in procs)
    for (seg,) in procs:
        assert seg["mesh"] == {"slice": 2, "stage": 1, "data": 1, "fsdp": 2, "expert": 1, "seq": 1, "tensor": 1}
        assert seg["served"] == list(range(NUM_STEPS))


def test_slice_drop_reshapes_and_matches_jax(port_env, tmp_path, monkeypatch):
    """ACCEPTANCE: drop slice 1 of 2 at step 5. The run completes at the
    reduced width (2 ranks, one slice), epoch 1, the reshape's metrics
    exported, the final loss within 2e-5 of JAX's drop run, a resume from
    step 4, and every global batch index committed exactly once."""
    spec = "slice_drop:slice=1,step=5"
    jresult, jlog = _jax_run(spec, tmp_path)
    result, log_dir = _port_run(tmp_path, monkeypatch, spec)
    assert result["num_workers"] == 2
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)

    chief = _chief(log_dir)
    assert [s["resume_from"] for s in chief] == [s["resume_from"] for s in jlog] == [0, 4]
    _assert_exactly_once(chief, NUM_STEPS)
    assert chief[1]["world"] == 2 and chief[1]["mesh"]["slice"] == 1
    parked = [p for p in _segments(log_dir) if len(p) == 1]
    assert len(parked) == 2 and all(p[0]["served"] == list(range(5)) for p in parked)

    exp_dir = _exp_dir(port_env)
    counters = _exported(exp_dir, "counters")
    assert counters.get("resilience.slice_drops", 0) == 1
    assert counters.get("resilience.dist_restarts", 0) == 0
    gauges = _exported(exp_dir, "gauges")
    assert gauges.get("resilience.membership_epoch") == 1
    assert gauges.get("resilience.active_slices") == 1
    assert gauges.get("resilience.reshape_ms", 0) > 0


def test_slice_rejoin_restores_width(port_env, tmp_path, monkeypatch):
    """ACCEPTANCE: drop slice 1 at step 3, rejoin at step 6. The group is
    re-formed twice in process: full width again at epoch 2, both
    transitions counted, the loss within 2e-5 of JAX's, and the chief's
    trajectory exactly once across both reshapes (the rejoin saves first,
    so nothing re-runs)."""
    spec = "slice_drop:slice=1,step=3;slice_rejoin:slice=1,step=6"
    jresult, jlog = _jax_run(spec, tmp_path)
    result, log_dir = _port_run(tmp_path, monkeypatch, spec)
    assert result["num_workers"] == 4
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)

    chief = _chief(log_dir)
    assert [s["resume_from"] for s in chief] == [s["resume_from"] for s in jlog] == [0, 2, 6]
    assert [s["epoch"] for s in chief] == [0, 1, 2]
    _assert_exactly_once(chief, NUM_STEPS)
    for proc in _segments(log_dir):  # the parked slice's ranks came back at step 6
        assert proc[-1]["world"] == 4 and proc[-1]["served"] == [6, 7]

    exp_dir = _exp_dir(port_env)
    counters = _exported(exp_dir, "counters")
    assert counters.get("resilience.slice_drops", 0) == 1
    assert counters.get("resilience.slice_rejoins", 0) == 1
    assert counters.get("resilience.reshape_checkpoints", 0) >= 1
    gauges = _exported(exp_dir, "gauges")
    assert gauges.get("resilience.membership_epoch") == 2
    assert gauges.get("resilience.active_slices") == 2


def test_drop_of_slice_0_keeps_the_checkpoint(port_env, tmp_path, monkeypatch):
    """Drop slice 0 (the old rank 0's) at step 5: slice 1's ranks form the
    group, the new rank 0 reads the checkpoint the old one wrote (the
    chief's directory is worker_0, whichever partition is rank 0), resumes
    from step 4 and ends where the drop of slice 1 ends (JAX's drop run)."""
    jresult, _ = _jax_run("slice_drop:slice=1,step=5", tmp_path)
    result, log_dir = _port_run(tmp_path, monkeypatch, "slice_drop:slice=0,step=5")
    assert result["num_workers"] == 2
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)
    chief = _chief(log_dir)
    assert [s["resume_from"] for s in chief] == [0, 4]
    _assert_exactly_once(chief, NUM_STEPS)
    procs = _segments(log_dir)
    parked = [p for p in procs if len(p) == 1]
    survivors = [p for p in procs if len(p) == 2]
    assert sorted(p[0]["rank"] for p in parked) == [0, 1]  # slice 0's ranks
    # slice 1's ranks (2 and 3 of the launch) are ranks 0 and 1 of the new group
    assert sorted((p[0]["rank"], p[1]["rank"]) for p in survivors) == [(2, 0), (3, 1)]


def test_drop_of_slice_0_one_rank_a_slice(port_env, tmp_path, monkeypatch):
    """Drop slice 0 of 2 slices of one rank each at step 5: the survivor is
    a group of one rank, which still reads the chief's directory
    (worker_0), resumes from step 4 (not from step 0) and commits every
    batch exactly once, ending on JAX's drop run."""
    jresult, _ = _jax_run("slice_drop:slice=1,step=5", tmp_path)
    result, log_dir = _port_run(tmp_path, monkeypatch, "slice_drop:slice=0,step=5", num_executors=2)
    assert result["num_workers"] == 1
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)
    chief = _chief(log_dir)
    assert [s["resume_from"] for s in chief] == [0, 4]
    assert [(s["world"], s["mesh"]["slice"]) for s in chief] == [(2, 2), (1, 1)]
    _assert_exactly_once(chief, NUM_STEPS)


def test_min_slices_violation_fails_clean(port_env, tmp_path, monkeypatch):
    """Shrinking below min_slices aborts with the violation as the
    experiment's error: not a hang, not a restart."""
    from maggy_tpu_torch.resilience.membership import MembershipViolation

    with pytest.raises(MembershipViolation, match="min_slices=2"):
        _port_run(tmp_path, monkeypatch, "slice_drop:slice=1,step=3", min_slices=2, num_executors=2)


@pytest.mark.parametrize("data_plane", ["local", "auto"])
def test_worker_mode_shrink_completes(port_env, tmp_path, monkeypatch, data_plane):
    """Workers mode: killing rank 1 of 2 under elastic=True is a membership
    drop, not a restart. Under "local" the survivor reshapes in its process
    (its own EXEC_CONFIG re-run); under "auto" the driver relaunches it at
    the new width from the latest checkpoint. One worker's result, one
    drop, no restart slot."""
    result, log_dir = _port_run(tmp_path, monkeypatch, "kill:worker=1,step=4", hparams={"hold_at": 5},
                                sharding="dp", num_executors=2, num_slices=None, data_plane=data_plane)
    assert result["num_workers"] == 1
    counters = _exported(_exp_dir(port_env), "counters")
    assert counters.get("resilience.slice_drops", 0) == 1
    assert counters.get("resilience.dist_restarts", 0) == 0
    procs = _segments(log_dir)
    if data_plane == "local":
        # each replica is rank 0 of its own group: the killed one has one entry
        (killed,) = [p for p in procs if len(p) == 1]
        assert killed[0]["served"] == [0, 1, 2, 3]
        # the survivor met the new epoch by step 5 (each replica keeps its
        # own pace) and saved there: no step re-ran
        (survivor,) = [p for p in procs if len(p) == 2]
        assert [s["epoch"] for s in survivor] == [0, 1]
        assert survivor[1]["resume_from"] == len(survivor[0]["served"]) <= 5
        _assert_exactly_once(survivor, NUM_STEPS)
    else:
        # rank 1 killed at step 4; rank 0 lost its peer inside a collective
        # of step 4 (its membership check's, or the step's), unless the
        # driver killed it first, before it could log its entry
        first = dict((p[0]["rank"], p[0]["served"]) for p in procs if p[0]["epoch"] == 0)
        assert first[1] == [0, 1, 2, 3]
        assert first.get(0, [0, 1, 2, 3]) in ([0, 1, 2, 3], [0, 1, 2, 3, 4])
        # relaunched at width 1 from the periodic checkpoint of step 4
        relaunched = [p for p in procs if p[0]["epoch"] == 1]
        assert [(s["resume_from"], s["served"], s["world"]) for p in relaunched for s in p] == [
            (4, [4, 5, 6, 7], 1)]


def test_worker_mode_drop_of_worker_0_keeps_the_checkpoint(port_env, tmp_path, monkeypatch):
    """Workers mode under "auto", rank 0 (the checkpoint's writer) killed at
    step 4: the driver relaunches rank 1 alone, as rank 0 of a group of one,
    and it resumes from rank 0's checkpoint of step 4, not from step 0;
    every batch is committed exactly once and no restart slot is spent."""
    result, log_dir = _port_run(tmp_path, monkeypatch, "kill:worker=0,step=4", hparams={"hold_at": 5},
                                sharding="dp", num_executors=2, num_slices=None, data_plane="auto")
    assert result["num_workers"] == 1
    counters = _exported(_exp_dir(port_env), "counters")
    assert counters.get("resilience.slice_drops", 0) == 1
    assert counters.get("resilience.dist_restarts", 0) == 0
    procs = _segments(log_dir)
    first = dict((p[0]["rank"], p[0]["served"]) for p in procs if p[0]["epoch"] == 0)
    assert first[0] == [0, 1, 2, 3]
    (relaunched,) = [p for p in procs if p[0]["epoch"] == 1]
    assert [(s["resume_from"], s["world"], s["rank"]) for s in relaunched] == [(4, 1, 0)]
    _assert_exactly_once([{"resume_from": 0, "served": first[0]}, relaunched[0]], NUM_STEPS)


@pytest.mark.parametrize("zero", [False, True], ids=["hsdp", "zero1"])
def test_sliced_data_axis_matches_jax(port_env, tmp_path, monkeypatch, zero):
    """2 slices x ``dp=2``: the parameters replicated over (``slice``,
    ``data``) flattened into one replica dimension (HSDP with fsdp=1), or
    with ``zero_stage=1`` and small buckets the bucketed step that sums
    each ZeRO-1 shard over ``data`` and then over ``slice``. Either run
    ends within 2e-5 of JAX's uninterrupted sliced run."""
    jresult, _ = _jax_run(None, tmp_path)
    kw = dict(zero_stage=1, bucket_mb=0.05) if zero else {}
    result, log_dir = _port_run(tmp_path, monkeypatch, sharding="dp", **kw)
    assert result["num_workers"] == 4
    assert result["loss"] == pytest.approx(jresult["loss"], rel=2e-5)
    for (seg,) in _segments(log_dir):
        assert (seg["mesh"]["slice"], seg["mesh"]["data"], seg["mesh"]["fsdp"]) == (2, 2, 1)
        assert seg["overlap"] == ("zero" if zero else "off")
        assert seg["served"] == list(range(NUM_STEPS))
