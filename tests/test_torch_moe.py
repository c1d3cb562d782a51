"""The port's MoE decoder (``maggy_tpu_torch.models.moe``) against the JAX
package's, on one CPU process.

Both start from the same weights: the JAX ``MoEDecoder``'s init, converted
by ``convert.moe_params_from_flax``; the inputs are made with numpy from a
seed. Everything is fp32 (``tiny_moe(dtype=float32)``), so the logits agree
within 1e-5 and the router's aux loss within 1e-6 (the same math, summed in
another order). The cases are the port's counterparts of the JAX package's
MoE tests (``test_model_zoo.py``, ``test_kv_cache.py``,
``test_packed_sequences.py``, ``test_ablation_factory_free.py``), plus a
planted top-k tie, a capacity that drops tokens, the Trainer's first five
steps against the JAX Trainer's (loss, aux loss and grad norm within 2e-5
relative, as ``tests/test_torch_trainer.py`` holds the dense Decoder), and
each parameter's mesh axes under ep, ep x fsdp and ep x dp against JAX's
(meshes over torch's fake process group, as ``tests/test_torch_mesh.py``
builds them). The JAX runs are cached per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from maggy_tpu.models import MoEConfig as JConfig
from maggy_tpu.models import MoEDecoder as JMoE
from maggy_tpu.models.generate import init_cache as jinit_cache
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec
from maggy_tpu.train import TrainContext as JTrainContext
from maggy_tpu.train.trainer import collect_aux_losses as jcollect
from maggy_tpu_torch import convert
from maggy_tpu_torch.models import MoEConfig, MoEDecoder
from maggy_tpu_torch.models.generate import generate, generate_cached, init_cache
from maggy_tpu_torch.models.moe import capacity_of, top_k_lowest_first
from maggy_tpu_torch.parallel import ShardingSpec, make_mesh
from maggy_tpu_torch.parallel.mesh import mesh_shape
from maggy_tpu_torch.parallel.sharding import logical_axes, placed_mesh_axes, shard_decoder
from maggy_tpu_torch.train import Trainer, adamw
from maggy_tpu_torch.train.trainer import collect_aux_losses

torch.set_num_threads(2)
LOGITS_ATOL = 1e-5
AUX_ATOL = 1e-6
RTOL = 2e-5
LR = 5e-3


def _cfgs(**kw):
    return JConfig.tiny_moe(dtype=jnp.float32, **kw), MoEConfig.tiny_moe(dtype=torch.float32, **kw)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """``weights(**cfg)``: the JAX init's params (numpy) for a tiny_moe
    config, made once per config."""
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            jcfg, _ = _cfgs(**kw)
            v = jax.jit(JMoE(jcfg).init)(jax.random.key(0), jnp.asarray(_tokens(0, 1, 16)))
            made[key] = jax.device_get(unbox(v["params"]))
        return made[key]

    return get


def _both(params, jcfg, cfg, tokens, *args):
    """The JAX and the port's logits and aux loss for the same inputs."""
    jl, mods = JMoE(jcfg).apply({"params": params}, jnp.asarray(tokens), *args, mutable=["intermediates"])
    model = MoEDecoder(cfg, device="cpu")
    model.load_state_dict(convert.moe_params_from_flax(params, cfg))
    targs = [None if a is None else torch.from_numpy(np.asarray(a)) for a in args]
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens), *targs)
    return (np.asarray(jl), float(jcollect(mods))), (logits.numpy(), float(collect_aux_losses(model)), model)


def _close(j, p):
    np.testing.assert_allclose(p[0], j[0], rtol=0, atol=LOGITS_ATOL)
    assert abs(p[1] - j[1]) <= AUX_ATOL, (p[1], j[1])


def test_moe_forward_and_routing(weights):
    params = weights()
    jcfg, cfg = _cfgs()
    j, p = _both(params, jcfg, cfg, np.arange(32)[None, :].astype(np.int32) % cfg.vocab_size)
    assert p[0].shape == (1, 32, cfg.vocab_size) and np.isfinite(p[0]).all()
    _close(j, p)
    model = p[2]
    assert all(layer.moe.w_gate.shape == (cfg.n_experts, 64, 96) for layer in model.layers)
    assert params["layers"]["layer"]["moe"]["w_gate"].shape == (cfg.n_layers, cfg.n_experts, 64, 96)
    # several groups and a padded last group (75 tokens in groups of 32)
    jcfg, cfg = _cfgs(group_size=32)
    _close(*_both(params, jcfg, cfg, _tokens(1, 3, 25))[:2])


def test_moe_capacity_drops_are_bounded(weights):
    params = weights()
    jcfg, cfg = _cfgs(capacity_factor=2.0)
    j, p = _both(params, jcfg, cfg, np.arange(64)[None, :].astype(np.int32) % cfg.vocab_size)
    assert np.isfinite(p[0]).all()
    _close(j, p)


def _dropped(model, tokens):
    """How many (token, k) assignments of the first layer's router find no
    capacity slot, from the port's own routing of that layer's input."""
    cfg, moe = model.cfg, model.layers[0].moe
    seen = []
    hook = moe.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    with torch.no_grad():
        model(tokens)
        hook.remove()
        probs = torch.softmax(moe.router(seen[0].reshape(1, -1, cfg.d_model)).float(), -1)
    _, idx = top_k_lowest_first(probs, cfg.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int(torch.clamp(counts - capacity_of(cfg, tokens.numel()), min=0).sum())


def test_capacity_drops_tokens_as_jax(weights):
    """capacity_factor 0.5: 16 slots an expert for 64 tokens x top-2, so
    the experts overflow and tokens are dropped; the outputs still agree."""
    params = weights()
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    tokens = _tokens(2, 1, 64)
    j, p = _both(params, jcfg, cfg, tokens)
    _close(j, p)
    assert _dropped(p[2], torch.from_numpy(tokens)) > 0


def test_planted_top_k_tie_goes_to_the_lower_expert(weights):
    """Experts 1 and 2 given the same router row: their logits, hence
    probabilities, are equal for every token. jax.lax.top_k takes expert 1
    first; so must the port (its top-1 decides capacity priority and the
    aux loss's ``ce`` term)."""
    params = jax.tree_util.tree_map(np.array, weights())
    router = params["layers"]["layer"]["moe"]["router"]["kernel"]  # [L, d, e]
    router[..., 2] = router[..., 1]
    router[..., 1:3] *= 8.0  # the tied pair wins the top-2 for most tokens
    jcfg, cfg = _cfgs()
    tokens = _tokens(3, 2, 32)
    j, p = _both(params, jcfg, cfg, tokens)
    _close(j, p)
    # the rule itself against jax.lax.top_k on planted ties
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    v, i = top_k_lowest_first(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_moe_decoder_accepts_segment_ids(weights):
    params = weights()
    jcfg, cfg = _cfgs()
    B, S = 2, 32
    tokens = _tokens(0, B, S)
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 2:] = 1
    j, p = _both(params, jcfg, cfg, tokens, None, seg)
    _close(j, p)
    (_, _), (plain, _, model) = _both(params, jcfg, cfg, tokens)
    assert not np.allclose(p[0], plain, atol=1e-4)  # the mask bites
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens[:, :S // 2])).numpy()
    # routing groups differ between the two forwards (32 tokens a group
    # here, 64 there), so only JAX's 2e-2 holds
    np.testing.assert_allclose(p[0][:, :S // 2], ref, atol=2e-2)


def test_moe_without_gates_forward(weights):
    params = weights()
    jcfg, cfg = _cfgs()
    tokens = _tokens(4, 2, 16)
    base = _both(params, jcfg, cfg, tokens)
    _close(*base[:2])
    ablated = _both(params, jcfg.without("layers.1"), cfg.without("layers.1"), tokens)
    _close(*ablated[:2])
    assert not np.allclose(base[1][0], ablated[1][0], atol=1e-5)
    all_off = _both(params, jcfg.without(["attn", "mlp"]), cfg.without(["attn", "mlp"]), tokens)
    _close(*all_off[:2])
    assert not np.allclose(ablated[1][0], all_off[1][0], atol=1e-5)
    # the gate silences the router aux loss of the ablated blocks, exactly
    no_mlp = _both(params, jcfg.without("mlp"), cfg.without("mlp"), tokens)
    assert no_mlp[0][1] == 0.0 and no_mlp[1][1] == 0.0
    assert float(collect_aux_losses(no_mlp[1][2])) == 0.0
    assert base[1][1] > 0.0


def test_moe_decoder_cached_generation(weights):
    """The MoE decoder shares the Attention module, so the KV-cache path
    works for it: each cached step's logits equal JAX's decode step's, and
    the full forward's within JAX's 3e-2 (one token a step never meets the
    capacity limit); greedy generation with and without the cache agree as
    JAX's test holds them."""
    params = weights()
    jcfg, cfg = _cfgs(max_seq_len=24)
    tokens = (np.arange(12)[None, :] % cfg.vocab_size).astype(np.int32)
    model = MoEDecoder(cfg, device="cpu")
    model.load_state_dict(convert.moe_params_from_flax(params, cfg))
    jdec = JMoE(dataclasses.replace(jcfg, decode=True))
    jcache = jinit_cache(jdec, jnp.asarray(tokens))
    jstep = jax.jit(lambda c, t, pos: jdec.apply({"params": params, "cache": c}, t, pos, mutable=["cache"]))
    cache = init_cache(model, torch.from_numpy(tokens))
    outs, jouts = [], []
    with torch.no_grad():
        full = model(torch.from_numpy(tokens)).numpy()
        for i in range(12):
            logits = model(torch.from_numpy(tokens[:, i:i + 1]), torch.full((1, 1), i), cache=cache, kv_len=i + 1)
            outs.append(logits[:, 0].numpy())
            jl, mut = jstep(jcache, jnp.asarray(tokens[:, i:i + 1]), jnp.full((1, 1), i, jnp.int32))
            jcache = mut["cache"]
            jouts.append(np.asarray(jl[:, 0]))
    np.testing.assert_allclose(np.stack(outs, 1), np.stack(jouts, 1), rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(np.stack(outs, 1), full, atol=3e-2)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :4] = [1, 2, 3, 4]
    a = generate(model, torch.from_numpy(prompt), torch.tensor([4])).numpy()
    b = generate_cached(model, torch.from_numpy(prompt), torch.tensor([4])).numpy()
    assert (a == b).mean() > 0.9


@pytest.fixture(scope="module")
def jax_trajectory(weights):
    """The JAX Trainer's first five steps on one device: per step its
    loss, aux loss and grad norm, and its state after step 2."""
    from maggy_tpu.train import data as jdata

    jcfg, _ = _cfgs()
    ctx = JTrainContext.create(JShardingSpec(), devices=jax.devices()[:1])
    trainer = ctx.trainer(JMoE(jcfg), optax.adamw(LR))
    data = jdata.synthetic_lm_batches(jcfg.vocab_size, 4, 32, seed=5)
    batches = [next(data) for _ in range(6)]
    state = trainer.make_state(jax.random.key(0), batches[0])
    init = jax.device_get(unbox(state.params))
    out, mid = [], None
    for i, batch in enumerate(batches[1:]):
        state, m = trainer.step(state, trainer.shard_batch(batch))
        out.append([float(m["loss"]), float(m["aux_loss"]), float(m["grad_norm"]), float(m["total_loss"])])
        if i == 1:
            mid = (jax.device_get(unbox(state.params)), jax.device_get(state.opt_state))
    return init, batches, np.array(out), mid


def test_trainer_matches_jax_trainer(jax_trajectory):
    init, batches, want, mid = jax_trajectory
    _, cfg = _cfgs()
    trainer = Trainer(MoEDecoder(cfg, device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, batches[0], params=convert.moe_params_from_flax(init, cfg))
    got = []
    for batch in batches[1:]:
        state, m = trainer.step(state, batch)
        got.append([float(m["loss"]), float(m["aux_loss"]), float(m["grad_norm"]), float(m["total_loss"])])
    got = np.array(got)
    assert want[-1, 0] < want[0, 0] and (got[:, 1] > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got[:, 3], got[:, 0] + got[:, 1], rtol=1e-6)
    # JAX's state after step 2 (params and AdamW moments, converted) takes
    # JAX's steps 3-5
    params, opt_state = mid
    trainer = Trainer(MoEDecoder(cfg, device="meta"), adamw(LR), device="cpu")
    state = trainer.make_state(0, batches[0], params=convert.moe_params_from_flax(params, cfg))
    moments = convert.adamw_state_from_optax(opt_state, cfg)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = moments[name]
    for i, batch in enumerate(batches[3:]):
        state, m = trainer.step(state, batch)
        np.testing.assert_allclose([float(m["loss"]), float(m["aux_loss"]), float(m["grad_norm"])],
                                   want[2 + i, :3], rtol=RTOL)


def test_remat_keeps_the_step(jax_trajectory):
    """Under remat the router terms are recomputed with the layer in the
    backward: the same loss, aux loss and gradients as without."""
    init, batches, _, _ = jax_trajectory
    runs = []
    for remat in (False, True):
        _, cfg = _cfgs(remat=remat, remat_policy="nothing")
        trainer = Trainer(MoEDecoder(cfg, device="meta"), adamw(LR), device="cpu")
        state = trainer.make_state(0, batches[0], params=convert.moe_params_from_flax(init, cfg))
        _, m = trainer.step(state, batches[1])
        runs.append(([float(m["loss"]), float(m["aux_loss"]), float(m["grad_norm"])],
                     {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for name, p in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], p, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ placement

LAYOUTS = {"ep2": dict(ep=2), "ep2_fsdp2": dict(ep=2, fsdp=2), "ep2_dp2": dict(ep=2, dp=2), "tp2": dict(tp=2),
           "tp2_fsdp2": dict(tp=2, fsdp=2), "ep2_tp2": dict(ep=2, tp=2)}


@pytest.fixture()
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_param_axes(jspec):
    """``{port parameter name: mesh axes (extent > 1) JAX shards it over}``
    from the JAX Trainer's own state shardings of the tiny MoE."""
    ctx = JTrainContext.create(jspec, devices=jax.devices()[: jspec.num_devices])
    jcfg = JConfig.tiny_moe(dtype=jnp.float32, scan_layers=False)
    trainer = ctx.trainer(JMoE(jcfg), optax.adamw(1e-3))
    shardings = trainer.state_shardings_for({"tokens": np.zeros((8, 16), np.int32)}).params
    extent = dict(ctx.mesh.shape)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [k.key for k in path]
        if keys[0].startswith("layers_"):
            keys = ["layers", keys[0].split("_")[1]] + keys[2:]
        name = ".".join(keys).replace(".kernel", ".weight")
        out[name] = {a for entry in s.spec for a in (entry if isinstance(entry, tuple) else (entry,))
                     if a is not None and extent[a] > 1}
    return out


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_placement_table_matches_jax(fake_world, key):
    """Every MoE parameter's mesh axes against JAX's, allowing the
    recorded divergences: FSDP2 shards every parameter's dim 0 over fsdp
    (norm scales included, which JAX replicates), and ``wk``/``wv`` lie
    over ``tensor`` (the port's ``kv`` rule). The experts lie over
    ``expert`` and their ``mlp`` dim over ``tensor`` as JAX's rules put
    them, the router nowhere but fsdp; every parameter lies on one mesh."""
    spec = ShardingSpec(**LAYOUTS[key])
    fake_world(spec.num_devices)
    mesh = make_mesh(spec, "cpu")
    model = MoEDecoder(MoEConfig.tiny_moe(dtype=torch.float32), device="cpu")
    trainer = Trainer(model, adamw(1e-3), device="cpu", mesh=mesh)
    layout = trainer.state_shardings_for()
    shard_decoder(model, mesh)
    want = _jax_param_axes(JShardingSpec(**LAYOUTS[key]))
    got = {name: set(placed_mesh_axes(p)) for name, p in model.named_parameters()}
    assert set(got) == set(want)
    assert len({p.device_mesh for p in model.parameters()}) == 1  # one list for the foreach kernels
    shape = mesh_shape(mesh)
    for name in got:
        allowed = set(want[name])
        if shape["fsdp"] > 1:
            allowed.add("fsdp")
        if shape["tensor"] > 1 and logical_axes(name)[0] == "kv":
            allowed.add("tensor")
        assert got[name] == allowed, (name, got[name], want[name])
        assert {a for dim in layout[name] if dim for a in dim} == got[name], name
    # a rank's experts (of four), its hidden columns as a DTensor's local shard
    w_gate = model.layers[0].moe.w_gate
    assert w_gate.shape == (4 // shape["expert"], 64, 96)
    assert getattr(w_gate, "to_local", lambda: w_gate)().shape[2] == 96 // shape["tensor"]


def test_refusals(fake_world):
    """What an MoE model cannot train on yet raises, naming item 8c (MoE
    under ``seq``: the ring, Ulysses); ``tensor`` and pipeline stages build;
    an ``expert`` extent that does not divide the experts raises as JAX's
    pipeline does; a rank whose rows do not hold whole routing groups
    raises."""
    from maggy_tpu_torch.parallel import LocalRing

    cfg = MoEConfig.tiny_moe(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 8c\b"):
        ShardingSpec(ep=2, sp=2)
    for kw in (dict(fsdp=2, sp=2), dict(sp=2, tp=2)):
        fake_world(ShardingSpec(**kw).num_devices)
        with pytest.raises(NotImplementedError, match=r"item 8c\b"):
            Trainer(MoEDecoder(cfg, device="meta"), adamw(1e-3), device="cpu", mesh=make_mesh(ShardingSpec(**kw), "cpu"))
    with pytest.raises(NotImplementedError, match=r"item 8c\b"):
        Trainer(MoEDecoder(cfg, device="meta"), adamw(1e-3), device="cpu", ring=LocalRing(2))
    for kw in (dict(tp=2), dict(pp=2), dict(ep=2, tp=2), dict(pp=2, ep=2), dict(pp=2, tp=2, ep=2)):
        fake_world(ShardingSpec(**kw).num_devices)
        Trainer(MoEDecoder(cfg, device="meta"), adamw(1e-3), device="cpu", mesh=make_mesh(ShardingSpec(**kw), "cpu"))
    fake_world(3)
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        Trainer(MoEDecoder(cfg, device="meta"), adamw(1e-3), device="cpu", mesh=make_mesh(ShardingSpec(ep=3), "cpu"))
    fake_world(2)
    model = MoEDecoder(dataclasses.replace(cfg, group_size=48), device="cpu")
    shard_decoder(model, make_mesh(ShardingSpec(dp=2), "cpu"))
    with pytest.raises(ValueError, match="whole routing groups"):
        model(torch.zeros((2, 32), dtype=torch.long))
