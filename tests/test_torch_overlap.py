"""The port's bucketing, ZeRO-1 layout helpers and overlap-mode resolution
against the JAX package's (``maggy_tpu/parallel/overlap.py`` and the JAX
Trainer's ``_overlap_mode``), in one process; the bucketed and ZeRO-1
steps themselves run on gloo ranks in ``tests/test_torch_zero_dist.py``.

* ``plan_buckets`` on the small mixed tree of ``tests/test_overlap.py`` and
  on ``DecoderConfig.tiny()``'s parameters: every bucket holds the same
  leaves (by index, and for the Decoder by name through
  ``jax_leaf_order``, the per-layer tree ``decoder_params_from_flax``
  maps), with the same sizes and padding, for several caps and shard
  counts; the dtype split; the errors.
* flatten/unflatten of parameters and of AdamW's state: the flat vectors
  equal JAX's (parameters exactly, the moments after one step within 1e-7
  relative: torch and optax round ``1 - b1`` and ``1 - b2`` apart), and
  every round trip, across plans too, exact.
* ``record_overlap_gauges``, the spec's and ``DistributedConfig``'s ZeRO
  fields, and ``_overlap_mode`` with its one-time warning, against JAX's
  on the same specs (the port's meshes over torch's fake process group).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from maggy_tpu.config.distributed import DistributedConfig as JDistributedConfig
from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.parallel import overlap as jovl
from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
from maggy_tpu.train import TrainContext as JTrainContext
from maggy_tpu.train import pipeline_adapter
from maggy_tpu_torch.config import DistributedConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.parallel import ShardingSpec, make_mesh
from maggy_tpu_torch.parallel import overlap as ovl
from maggy_tpu_torch.train import Trainer, adamw
from maggy_tpu_torch.train import pipeline_adapter as port_adapter

CAPS = [None, float("inf"), 100 / 2**20, 120 / 2**20, 1.0]


def _tree(seed=0):
    """``tests/test_overlap.py``'s small mixed-shape tree (numpy)."""
    rng = np.random.default_rng(seed)
    return {
        "emb": {"w": rng.normal(size=(7, 5)).astype(np.float32)},
        "layers": [
            {"k": rng.normal(size=(5, 5)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
            for _ in range(3)
        ],
        "head": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
    }


def _torch_leaves(tree):
    """The tree's leaves in JAX's flatten order, as torch tensors."""
    return [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(tree)]


def _same_plan(mine, ref):
    assert (mine.n_leaves, mine.pad_to) == (ref.n_leaves, ref.pad_to)
    assert len(mine.buckets) == len(ref.buckets)
    for b, r in zip(mine.buckets, ref.buckets):
        assert (b.name, b.indices, b.sizes, b.dtype, b.size, b.padded_size) == (
            r.name, r.indices, r.sizes, r.dtype, r.size, r.padded_size)


@pytest.mark.parametrize("cap", CAPS, ids=["none", "inf", "100B", "120B", "1MiB"])
@pytest.mark.parametrize("pad_to", [1, 4, 8])
def test_plan_buckets_matches_jax(cap, pad_to):
    tree = _tree()
    mine = ovl.plan_buckets(_torch_leaves(tree), cap, pad_to=pad_to)
    _same_plan(mine, jovl.plan_buckets(tree, cap, pad_to=pad_to))
    # reverse flatten order: bucket 0 starts at the last leaf, indices walk backwards
    flat_order = [i for b in mine.buckets for i in b.indices]
    assert flat_order == list(range(mine.n_leaves))[::-1]
    for b in mine.buckets:
        assert b.padded_size % pad_to == 0 and b.padded_size >= b.size
        if cap is not None and np.isfinite(cap):  # the cap holds unless one leaf exceeds it
            assert b.size * 4 <= cap * 2**20 or len(b.indices) == 1
    assert [b.name for b in mine.buckets] == sorted(b.name for b in mine.buckets)


def test_plan_buckets_splits_dtypes_and_refuses():
    leaves = [torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16), torch.zeros(4)]
    mine = ovl.plan_buckets(leaves, None)
    ref = jovl.plan_buckets({"a": jnp.zeros((4,), jnp.float32), "b": jnp.zeros((4,), jnp.bfloat16),
                             "c": jnp.zeros((4,), jnp.float32)}, None)
    _same_plan(mine, ref)
    assert [b.dtype for b in mine.buckets] == ["float32", "bfloat16", "float32"]
    with pytest.raises(ValueError, match="empty"):
        ovl.plan_buckets([], 1.0)
    with pytest.raises(ValueError, match="pad_to"):
        ovl.plan_buckets(_torch_leaves(_tree()), 1.0, pad_to=0)


def _jax_decoder_leaf_names():
    """The JAX per-layer Decoder's parameter leaves, in flatten order, each
    named as the port names it (``layers_3/layer/attn/wq/kernel`` ->
    ``layers.3.attn.wq.weight``), and the tree."""
    cfg = JConfig.tiny(scan_layers=False, dtype=jnp.float32)
    params = jax.eval_shape(lambda: JDecoder(cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    from maggy_tpu.parallel.sharding import unbox

    params = unbox(params)
    names = []
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[0].startswith("layers_"):
            keys = ["layers", keys[0].split("_")[1]] + keys[2:]
        names.append(".".join("weight" if k == "kernel" else k for k in keys))
    return names, params


@pytest.mark.parametrize("cap", [None, 0.05, 0.02], ids=["none", "50KiB", "20KiB"])
@pytest.mark.parametrize("pad_to", [1, 8])
def test_decoder_bucket_membership_matches_jax(cap, pad_to):
    jnames, jparams = _jax_decoder_leaf_names()
    model = Decoder(DecoderConfig.tiny(dtype=torch.float32), device="meta")
    params = dict(model.named_parameters())
    order = ovl.jax_leaf_order(list(params))
    assert order == jnames  # one port parameter per JAX leaf, in its order
    mine = ovl.plan_buckets([params[n] for n in order], cap, pad_to=pad_to)
    ref = jovl.plan_buckets(jparams, cap, pad_to=pad_to)
    _same_plan(mine, ref)
    assert [[order[i] for i in b.indices] for b in mine.buckets] == [[jnames[i] for i in b.indices]
                                                                     for b in ref.buckets]
    assert len(mine.buckets) > (1 if cap is not None else 0)


def test_flatten_unflatten_roundtrip_matches_jax():
    tree = _tree(1)
    leaves = _torch_leaves(tree)
    plan = ovl.plan_buckets(leaves, 120 / 2**20, pad_to=4)
    flats = ovl.flatten_buckets(leaves, plan)
    ref = jovl.flatten_buckets(tree, jovl.plan_buckets(tree, 120 / 2**20, pad_to=4))
    assert list(flats) == list(ref)
    for name, vec in flats.items():
        np.testing.assert_array_equal(vec.numpy(), np.asarray(ref[name]))
    back = ovl.unflatten_buckets(flats, plan, leaves)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))
    named = ovl.unflatten_buckets(flats, plan, {f"l{i}": t for i, t in enumerate(leaves)})
    assert list(named) == [f"l{i}" for i in range(len(leaves))]
    with pytest.raises(ValueError, match="leaves"):
        ovl.flatten_buckets([torch.zeros(3)], plan)


def _adamw_state(leaves):
    """A torch AdamW's state_dict over ``leaves`` after one step on
    all-ones gradients (optax.adamw's defaults)."""
    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    opt = adamw(1e-3)(params)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    return opt.state_dict()


def test_opt_state_flatten_and_reflatten():
    tree = _tree(2)
    leaves = _torch_leaves(tree)
    sd = _adamw_state(leaves)
    plan = ovl.plan_buckets(leaves, 100 / 2**20, pad_to=4)
    flat = ovl.flatten_opt_state(sd, plan, leaves)
    # JAX's flat mu/nu after the same step
    jtree = jax.tree.map(jnp.asarray, tree)
    tx = optax.adamw(1e-3)
    jopt = tx.update(jax.tree.map(jnp.ones_like, jtree), tx.init(jtree), jtree)[1]
    jflat = jovl.flatten_opt_state(jopt, jovl.plan_buckets(jtree, 100 / 2**20, pad_to=4), jtree)
    assert sorted(flat["state"]) == list(range(len(plan.buckets)))
    for j, b in enumerate(plan.buckets):
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            np.testing.assert_allclose(flat["state"][j][key].numpy(), np.asarray(getattr(jflat[0], jkey)[b.name]),
                                       rtol=1e-7, atol=0)
        assert float(flat["state"][j]["step"]) == 1.0
    assert flat["param_groups"][0]["params"] == list(range(len(plan.buckets)))
    back = ovl.unflatten_opt_state(flat, plan, leaves)
    assert sorted(back["state"]) == sorted(sd["state"])
    for i, per in sd["state"].items():
        for key, value in per.items():
            assert torch.equal(back["state"][i][key], value), (i, key)
    # across plans (another bucket_mb and width): exact both ways
    plan2 = ovl.plan_buckets(leaves, None, pad_to=2)
    re2 = ovl.reflatten_opt_state(flat, plan, plan2, leaves)
    assert sorted(re2["state"]) == list(range(len(plan2.buckets)))
    back2 = ovl.unflatten_opt_state(re2, plan2, leaves)
    for i, per in sd["state"].items():
        for key, value in per.items():
            assert torch.equal(back2["state"][i][key], value), (i, key)


class _FakeTel:
    def __init__(self):
        self.gauges = {}

    def gauge(self, name, value):
        self.gauges[name] = value


def test_record_overlap_gauges_matches_jax():
    times = {"dense": 10.0, "bucketed": 7.0, "nocomm": 5.0, "only_data": 6.0, "only_slice": 8.5}
    mine, ref = _FakeTel(), _FakeTel()
    out = ovl.record_overlap_gauges(times, ("slice", "data"), telemetry_recorder=mine)
    assert out == jovl.record_overlap_gauges(times, ("slice", "data"), telemetry_recorder=ref)
    assert mine.gauges == ref.gauges
    assert out["comm_exposed_ms"] == pytest.approx(2.0) and out["comm_overlapped_ms"] == pytest.approx(3.0)
    assert mine.gauges["train.comm_exposed_ms.slice"] == pytest.approx(3.5)


def test_sharding_spec_zero_fields_match_jax():
    for kw in (dict(dp=8, zero_stage=1, bucket_mb=4.0), dict(sp=2, dp=4), dict(sp=2, fsdp=2, tp=2)):
        mine, ref = ShardingSpec(**kw), JShardingSpec(**kw)
        assert (mine.zero_stage, mine.bucket_mb, mine.axis_sizes()) == (ref.zero_stage, ref.bucket_mb,
                                                                        ref.axis_sizes())
    scaled = ShardingSpec(dp=8, zero_stage=1, bucket_mb=4.0).scaled_to(4)
    assert (scaled.dp, scaled.zero_stage, scaled.bucket_mb) == (4, 1, 4.0)
    for bad in (dict(dp=8, zero_stage=2), dict(dp=8, bucket_mb=0)):
        with pytest.raises(ValueError):
            JShardingSpec(**bad)
        with pytest.raises(ValueError):
            ShardingSpec(**bad)


@pytest.mark.parametrize("kw", [dict(zero_lvl=1), dict(zero_lvl=1, zero_stage=0), dict(sharding="dp", bucket_mb=16),
                                dict(zero_lvl=0), dict(zero_lvl=3), dict(zero_stage=1, bucket_mb=0.25)],
                         ids=["zero_lvl_1", "explicit_wins", "bucket", "zero_lvl_0", "zero_lvl_3", "stage_and_bucket"])
def test_distributed_config_zero_mapping_matches_jax(kw):
    mine, ref = DistributedConfig(device="cpu", **kw), JDistributedConfig(**kw)
    assert (mine.sharding, mine.zero_stage, mine.bucket_mb) == (ref.sharding, ref.zero_stage, ref.bucket_mb)
    a, b = mine.resolve_sharding(8), ref.resolve_sharding(8)
    assert (a.axis_sizes(), a.zero_stage, a.bucket_mb) == (b.axis_sizes(), b.zero_stage, b.bucket_mb)
    with pytest.raises(ValueError):
        DistributedConfig(zero_stage=3, device="cpu")


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


def _port_trainer(spec, **kw):
    return Trainer(Decoder(DecoderConfig.tiny(), device="meta"), adamw(1e-3), device="cpu",
                   mesh=make_mesh(spec, "cpu"), **kw)


def _jax_trainer(spec, **kw):
    ctx = JTrainContext.create(spec, devices=jax.devices()[:spec.num_devices])
    return ctx.trainer(JDecoder(JConfig.tiny()), optax.adamw(1e-3), **kw)


MODES = {
    "none": (dict(dp=8), {}),
    "inf_bucket": (dict(dp=8), dict(bucket_mb=float("inf"))),
    "bucket": (dict(dp=8), dict(bucket_mb=1)),
    "zero": (dict(dp=8), dict(zero_stage=1)),
    "zero_bucket_dp4": (dict(dp=4), dict(zero_stage=1, bucket_mb=0.25)),
}


@pytest.mark.parametrize("key", list(MODES))
def test_overlap_mode_resolution_matches_jax(fake_world, key):
    spec_kw, kw = MODES[key]
    fake_world(JShardingSpec(**spec_kw).num_devices)
    mine = _port_trainer(ShardingSpec(**spec_kw), **kw)._overlap_mode()
    assert mine == _jax_trainer(JShardingSpec(**spec_kw), **kw)._overlap_mode()
    assert mine == {"none": ("off", (), 1), "inf_bucket": ("off", (), 1), "bucket": ("bucket", ("data",), 1),
                    "zero": ("zero", ("data",), 8), "zero_bucket_dp4": ("zero", ("data",), 4)}[key]


@pytest.mark.parametrize("spec_kw, blocker", [(dict(fsdp=8), "fsdp"), (dict(sp=2, dp=4), "seq"),
                                              (dict(tp=2, dp=4), "tensor"), (dict(), "no data")],
                         ids=["fsdp", "seq", "tensor", "one_device"])
def test_overlap_fallback_warns_once_as_jax(fake_world, monkeypatch, spec_kw, blocker):
    monkeypatch.setattr(pipeline_adapter, "_overlap_fallback_warned", False)
    monkeypatch.setattr(port_adapter, "_overlap_fallback_warned", False)
    spec = ShardingSpec(**spec_kw)
    fake_world(spec.num_devices)
    with pytest.warns(UserWarning, match="unbucketed") as ref:
        assert _jax_trainer(JShardingSpec(**spec_kw), zero_stage=1)._overlap_mode()[0] == "off"
    with pytest.warns(UserWarning, match="unbucketed") as got:
        assert _port_trainer(spec, zero_stage=1)._overlap_mode()[0] == "off"
    assert blocker in str(got[0].message) and blocker in str(ref[0].message)
    # one-time: a second ineligible trainer stays silent on both sides
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert _port_trainer(spec, bucket_mb=4)._overlap_mode()[0] == "off"
        assert _jax_trainer(JShardingSpec(**spec_kw), bucket_mb=4)._overlap_mode()[0] == "off"
    assert not [w for w in rec if "unbucketed" in str(w.message)]
    # and after a reset it warns again
    monkeypatch.setattr(port_adapter, "_overlap_fallback_warned", False)
    with pytest.warns(UserWarning, match=blocker):
        _port_trainer(spec, zero_stage=1)._overlap_mode()


def test_trainer_validates_knobs_as_jax(fake_world):
    fake_world(8)
    for kw in (dict(zero_stage=2), dict(bucket_mb=0), dict(bucket_mb=-1.0)):
        with pytest.raises(ValueError):
            _port_trainer(ShardingSpec(dp=8), **kw)
        with pytest.raises(ValueError):
            _jax_trainer(JShardingSpec(dp=8), **kw)
    meta = _port_trainer(ShardingSpec(dp=8), zero_stage=1, bucket_mb=0.25).checkpoint_meta()
    assert meta["zero"] == {"stage": 1, "bucket_mb": 0.25, "shards": 8}
    assert _port_trainer(ShardingSpec(dp=8), bucket_mb=4).checkpoint_meta()["zero"] == {
        "stage": 0, "bucket_mb": None, "shards": 1}


@pytest.mark.parametrize("kw", [dict(bucket_mb=1), dict(zero_stage=1)], ids=["bucket", "zero"])
def test_a_dropped_overlap_state_frees_its_parameters(fake_world, kw):
    """The per-bucket hooks live in autograd's C++ nodes, where the cycle
    collector cannot see them: a hook that held its reducer strongly kept
    every parameter and gradient buffer of a dropped state alive (on four
    H100s, a bucketed state's 15.4 GB stayed behind into the next)."""
    import gc
    import weakref

    fake_world(2)
    trainer = _port_trainer(ShardingSpec(dp=2), **kw)
    state = trainer.make_state(0, {"tokens": np.zeros((2, 8), np.int32)})
    param = weakref.ref(next(state.model.parameters()))
    flat = weakref.ref(state.layout.grads.flats[0])
    del trainer, state
    gc.collect()
    assert param() is None and flat() is None
