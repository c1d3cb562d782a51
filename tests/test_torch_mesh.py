"""The port's mesh layer against the JAX package's: ``ShardingSpec`` and its
presets, the ``DeviceMesh`` axes, where each Decoder parameter lies, and
what still raises.

The meshes are built in this process over torch's fake process group
(``torch.testing._internal.distributed.fake_pg``: a world of any size in one
process, whose collectives move no data), which is enough to lay a model
out and read its placements; ``tests/test_torch_dist_train.py`` runs the
same layouts over real gloo ranks. The JAX side is its ``make_mesh`` and
``Trainer.state_shardings_for`` on the conftest's 8 CPU devices.

The placement table holds, for every Decoder parameter, the set of mesh
axes (of extent above 1) that shard it against JAX's, allowing exactly the
two recorded divergences: ``wk``/``wv`` also over ``tensor`` (the port's
``kv`` rule), and every parameter over ``fsdp`` (FSDP2 shards dim 0,
norm scales included, which JAX replicates).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.distributed as dist

from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.parallel.mesh import make_mesh as jmake_mesh
from maggy_tpu.parallel.mesh import mesh_for as jmesh_for
from maggy_tpu.parallel.sharding import DEFAULT_RULES as J_RULES
from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
from maggy_tpu.parallel.spec import SliceTopology as JSliceTopology
from maggy_tpu.train import TrainContext as JTrainContext
from maggy_tpu.train import data as jdata
from maggy_tpu_torch.config import DistributedConfig, TpuDistributedConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.ops.flash import flash_attention
from maggy_tpu_torch.parallel import DEFAULT_RULES, MESH_AXES, PORT_RULES, ShardingSpec, SliceTopology, make_mesh, mesh_for
from maggy_tpu_torch.parallel.mesh import ambient_mesh, mesh_shape
from maggy_tpu_torch.parallel.sharding import logical_axes, placed_mesh_axes, shard_decoder
from maggy_tpu_torch.train import TrainContext, Trainer, adamw

REPO = Path(__file__).resolve().parent.parent
PRESETS = ("dp", "ddp", "fsdp", "zero", "zero3", "tp", "2d", "sp")
LAYOUTS = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "tp2": dict(tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2),
           "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2), "fsdp4": dict(fsdp=4)}


@pytest.fixture()
def fake_world():
    """``fake_world(n)``: a default process group of ``n`` ranks in this
    process (rank 0), destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_presets_and_scaling_match_jax(n):
    assert MESH_AXES == ("stage", "data", "fsdp", "expert", "seq", "tensor")
    for name in PRESETS:
        mine, ref = ShardingSpec.preset(name, n), JShardingSpec.preset(name, n)
        assert mine.axis_sizes() == ref.axis_sizes() and mine.num_devices == ref.num_devices, name
    for kw in (dict(fsdp=2), dict(tp=2), dict(fsdp=2, tp=2), dict(dp=3)):
        mine, ref = ShardingSpec(**kw), JShardingSpec(**kw)
        if n % (ref.num_devices // ref.dp):
            with pytest.raises(ValueError, match="not divisible"):
                mine.scaled_to(n)
            with pytest.raises(ValueError, match="not divisible"):
                ref.scaled_to(n)
        else:
            assert mine.scaled_to(n).axis_sizes() == ref.scaled_to(n).axis_sizes()
    topo, jtopo = SliceTopology(n, ShardingSpec(fsdp=2)), JSliceTopology(n, JShardingSpec(fsdp=2))
    assert (topo.num_devices, topo.devices_per_slice, topo.axis_sizes()) == (
        jtopo.num_devices, jtopo.devices_per_slice, jtopo.axis_sizes())
    assert topo.with_slices(1).axis_sizes() == jtopo.with_slices(1).axis_sizes()


def test_spec_is_a_value_and_checks_its_fields():
    assert ShardingSpec(fsdp=2, tp=2) == ShardingSpec(tp=2, fsdp=2)
    assert hash(ShardingSpec(dp=2)) == hash(ShardingSpec(dp=2))
    with pytest.raises(ValueError, match="positive int"):
        ShardingSpec(tp=0)
    with pytest.raises(ValueError, match="zero_stage"):
        ShardingSpec(zero_stage=2)
    with pytest.raises(TypeError, match="unknown fields"):
        ShardingSpec(cp=2)
    with pytest.raises(ValueError, match="Unknown sharding preset"):
        ShardingSpec.preset("3d", 8)
    assert DistributedConfig(device="cpu").resolve_sharding(4) == ShardingSpec(fsdp=4)
    assert DistributedConfig(sharding=ShardingSpec(tp=2), device="cpu").resolve_sharding(8) == ShardingSpec(
        dp=4, tp=2)
    assert DistributedConfig(zero_lvl=0, device="cpu").sharding == "dp"
    assert DistributedConfig(zero_lvl=3, device="cpu").sharding == "fsdp"
    assert TpuDistributedConfig is DistributedConfig


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_mesh_axes_match_jax(fake_world, key):
    spec, jspec = ShardingSpec(**LAYOUTS[key]), JShardingSpec(**LAYOUTS[key])
    fake_world(spec.num_devices)
    mesh = make_mesh(spec, "cpu")
    jmesh = jmake_mesh(jspec, jax.devices()[: jspec.num_devices])
    assert mesh.mesh_dim_names == tuple(jmesh.axis_names)
    assert mesh_shape(mesh) == dict(jmesh.shape)
    with pytest.raises(ValueError, match="scaled_to"):
        make_mesh(ShardingSpec(dp=spec.num_devices * 2), "cpu")
    # mesh_for resolves a preset or a spec of another size against the ranks
    mesh2, spec2 = mesh_for(sharding="fsdp", device_type="cpu")
    jmesh2, jspec2 = jmesh_for(sharding="fsdp", devices=jax.devices()[: spec.num_devices])
    assert spec2.axis_sizes() == jspec2.axis_sizes() and mesh_shape(mesh2) == dict(jmesh2.shape)


def _jax_param_axes(jspec):
    """``{port parameter name: set of mesh axes (extent > 1) JAX shards it
    over}`` from the JAX Trainer's own state shardings."""
    ctx = JTrainContext.create(jspec, devices=jax.devices()[: jspec.num_devices])
    cfg = JConfig.tiny(dtype=jnp.float32, scan_layers=False)
    trainer = ctx.trainer(JDecoder(cfg), optax.adamw(1e-3))
    shardings = trainer.state_shardings_for(next(jdata.synthetic_lm_batches(cfg.vocab_size, 8, 16))).params
    extent = dict(ctx.mesh.shape)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [k.key for k in path]
        if keys[0].startswith("layers_"):
            keys = ["layers", keys[0].split("_")[1]] + keys[2:]
        name = ".".join(keys).replace(".kernel", ".weight")
        axes = set()
        for entry in s.spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and extent[a] > 1:
                    axes.add(a)
        out[name] = axes
    return out


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_placement_table_matches_jax(fake_world, key):
    spec = ShardingSpec(**LAYOUTS[key])
    fake_world(spec.num_devices)
    mesh = make_mesh(spec, "cpu")
    model = Decoder(DecoderConfig.tiny(dtype=torch.float32), device="cpu")
    trainer = Trainer(model, adamw(1e-3), device="cpu", mesh=mesh)
    layout = trainer.state_shardings_for()
    shard_decoder(model, mesh)
    want = _jax_param_axes(JShardingSpec(**LAYOUTS[key]))
    shape = mesh_shape(mesh)
    got = {name: set(placed_mesh_axes(p)) for name, p in model.named_parameters()}
    assert set(got) == set(want)
    # one mesh for every parameter: an optimizer's foreach kernels take one
    # list, which cannot mix plain tensors and DTensors, or two meshes
    assert len({p.device_mesh for p in model.parameters()}) == 1
    for name in got:
        allowed = set(want[name])
        if shape["tensor"] > 1 and logical_axes(name)[0] == "kv":
            allowed.add("tensor")  # divergence 1: wk/wv colwise
        if shape["fsdp"] > 1:
            allowed.add("fsdp")  # divergence 2: FSDP2 shards every dim 0
        assert got[name] == allowed, (name, got[name], want[name])
        # the layout computed from the rules alone is the one applied
        assert {a for dim in layout[name] if dim for a in dim} == got[name], name
    assert DEFAULT_RULES == J_RULES
    assert dict(PORT_RULES) == {**dict(J_RULES), "kv": "tensor"}  # the one rule the port changes


def test_batch_rows_follow_the_batch_rule(fake_world):
    """Rank 0's rows under each layout: the batch splits over (data,
    fsdp), data outer; tensor ranks share rows."""
    import numpy as np

    batch = {"tokens": np.arange(8 * 4).reshape(8, 4)}
    for kw, rows in ((dict(dp=2, fsdp=2, tp=2), 2), (dict(tp=4), 8), (dict(fsdp=4), 2)):
        fake_world(ShardingSpec(**kw).num_devices)
        ctx = TrainContext.create(ShardingSpec(**kw), device="cpu")
        trainer = ctx.trainer(Decoder(DecoderConfig.tiny(n_kv_heads=4), device="meta"), adamw(1e-3))
        mine = trainer.shard_batch(batch)["tokens"]
        assert mine.shape == (rows, 4) and (mine == batch["tokens"][:rows]).all()
        assert trainer.shard_batch(batch, local=True) is batch
        assert ctx.shard(batch)["tokens"].shape == (rows, 4)
        assert trainer.batch_shardings(batch)["tokens"][1] is None
        assert ctx.process_index == 0 and ctx.num_processes == ShardingSpec(**kw).num_devices
        assert ambient_mesh() is ctx.mesh
    with pytest.raises(ValueError, match="do not split"):
        ctx.shard({"tokens": np.zeros((3, 4))})


def test_no_fallback(fake_world):
    """A head count tp does not divide raises at construction, on the CPU;
    a DTensor at the flash wrappers raises; a rank asked for CUDA does not
    carry on on the CPU."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    fake_world(4)
    mesh = make_mesh(ShardingSpec(tp=4), "cpu")
    with pytest.raises(ValueError, match="n_kv_heads"):  # tiny: 2 KV heads over tp=4
        Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), device="cpu", mesh=mesh)
    q = distribute_tensor(torch.zeros(1, 8, 2, 64), mesh["tensor"], [Replicate()])
    with pytest.raises(TypeError, match="not DTensors"):
        flash_attention(q, q, q)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(ShardingSpec(tp=4))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainContext.create(ShardingSpec(tp=4))


def _trainer_zero_stage_1():
    from maggy_tpu_torch.train import pipeline_adapter

    pipeline_adapter._overlap_fallback_warned = False  # the one-time warning, fresh
    tr = TrainContext(ShardingSpec(), None, torch.device("cpu")).trainer(
        Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), zero_stage=1)
    with pytest.warns(UserWarning, match="no data/slice mesh axis"):  # one device: nothing to shard over, as in JAX
        mode = tr._overlap_mode()
    return (tr.zero_stage, mode), (1, ("off", (), 1))


def _dist_config(**kw):
    """The same DistributedConfig in both packages: every attribute the JAX
    one sets but its default name, on the port's (plus its ``device``)."""
    from maggy_tpu.config import DistributedConfig as JDistributedConfig

    want = {k: v for k, v in vars(JDistributedConfig(**kw)).items() if k != "name"}
    got = vars(DistributedConfig(device="cpu", **kw))
    return {k: got[k] for k in want}, want


def _trainer_membership():
    """``Trainer(membership=)`` keeps the monitor, as JAX's does."""
    from maggy_tpu_torch.resilience.membership import MembershipMonitor, MembershipView

    monitor = MembershipMonitor(MembershipView.full(2))
    trainer = Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), device="cpu", membership=monitor)
    return trainer.membership, monitor


# what raised naming items 7a2, 7c, 7e, 7f, 7f2, 8 and 8b until they were
# ported: each builds now, as the JAX package's does
@pytest.mark.parametrize("make", [
    lambda: (ShardingSpec(sp=2, fsdp=2).axis_sizes(), JShardingSpec(sp=2, fsdp=2).axis_sizes()),
    lambda: (ShardingSpec(sp=2, tp=2).axis_sizes(), JShardingSpec(sp=2, tp=2).axis_sizes()),
    lambda: (ShardingSpec(zero_stage=1).zero_stage, JShardingSpec(zero_stage=1).zero_stage),
    lambda: (ShardingSpec(bucket_mb=4.0).bucket_mb, JShardingSpec(bucket_mb=4.0).bucket_mb),
    lambda: (DistributedConfig(zero_lvl=1, device="cpu").resolve_sharding(4),
             ShardingSpec(dp=4, zero_stage=1)),
    lambda: (DistributedConfig(zero_stage=1, device="cpu").resolve_sharding(4),
             ShardingSpec(fsdp=4, zero_stage=1)),
    lambda: (DistributedConfig(bucket_mb=8.0, device="cpu").resolve_sharding(4),
             ShardingSpec(fsdp=4, bucket_mb=8.0)),
    _trainer_zero_stage_1,
    lambda: (ShardingSpec(pp=2).axis_sizes(), JShardingSpec(pp=2).axis_sizes()),
    lambda: (ShardingSpec.preset("pp", 4).axis_sizes(), JShardingSpec.preset("pp", 4).axis_sizes()),
    lambda: (TrainContext(ShardingSpec(), None, torch.device("cpu")).trainer(
        Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), n_microbatches=2).n_microbatches, 2),
    lambda: _dist_config(max_restarts=1),
    lambda: _dist_config(evaluator=True, num_executors=2, data_plane="local"),
    lambda: _dist_config(driver_addr="localhost:1"),
    lambda: _dist_config(data_plane="local"),
    lambda: _dist_config(elastic=True),
    lambda: _dist_config(elastic=True, num_slices=2),
    lambda: _dist_config(elastic=True, min_slices=2),
    _trainer_membership,
    lambda: (ShardingSpec(ep=2).axis_sizes(), JShardingSpec(ep=2).axis_sizes()),
    lambda: (ShardingSpec.preset("ep", 4).axis_sizes(), JShardingSpec.preset("ep", 4).axis_sizes()),
    lambda: (DistributedConfig(sharding="ep", device="cpu").resolve_sharding(4), ShardingSpec(ep=2, fsdp=2)),
    lambda: (ShardingSpec(ep=2, tp=2).axis_sizes(), JShardingSpec(ep=2, tp=2).axis_sizes()),
    lambda: (ShardingSpec(ep=2, pp=2).axis_sizes(), JShardingSpec(ep=2, pp=2).axis_sizes()),
], ids=["sp2_fsdp2", "sp2_tp2", "zero_stage", "bucket_mb", "zero_lvl_1", "config_zero_stage",
        "config_bucket_mb", "trainer_zero_stage", "pp2", "pp_preset", "trainer_n_microbatches",
        "max_restarts", "evaluator", "driver_addr", "data_plane_local", "elastic", "num_slices",
        "min_slices", "trainer_membership", "ep2", "ep_preset", "config_ep", "ep2_tp2", "ep2_pp2"])
def test_ported_parts_build(make):
    got, want = make()
    assert got == want


@pytest.mark.parametrize("make, item", [
    (lambda: ShardingSpec(ep=2, sp=2), "8c"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unported_parts_raise_naming_their_items(make, item):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP queue 1 item {item}\b"):
        make()
    roadmap = (REPO / "ROADMAP.md").read_text()
    assert f"**{item}." in roadmap or f"\n{item}. **" in roadmap, f"ROADMAP lists no item {item}"


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import maggy_tpu_torch.parallel.mesh, maggy_tpu_torch.parallel.sharding\n"
        "import maggy_tpu_torch.config.distributed, maggy_tpu_torch.core.driver.distributed\n"
        "import maggy_tpu_torch.core.executors.distributed, maggy_tpu_torch.experiment\n"
        "import maggy_tpu_torch.parallel.pipeline, maggy_tpu_torch.train.pipeline_adapter\n"
        "import maggy_tpu_torch.core.pod, maggy_tpu_torch.run\n"
        "print(sorted(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    modules = ast.literal_eval(out.splitlines()[0])
    assert [m for m in modules if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "maggy_tpu"}] == []
    assert "maggy_tpu_torch.core.executors.distributed" in modules
    assert "maggy_tpu_torch.parallel.pipeline" in modules and "maggy_tpu_torch.train.pipeline_adapter" in modules
    assert "maggy_tpu_torch.core.pod" in modules and "maggy_tpu_torch.run" in modules
