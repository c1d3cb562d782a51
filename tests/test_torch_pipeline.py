"""The port's pipeline schedules (``maggy_tpu_torch.parallel.pipeline``)
against the JAX package's on the same inputs.

The problem is JAX's own test problem (``tests/test_pipeline.py``): a stack
of residual layers ``x + tanh(x @ W_l)``, its weights, microbatches and
targets drawn with numpy from a seed. The JAX side runs on the conftest's
8 CPU devices (``pp=S, dp=8/S``); the port's on four gloo ranks, one
``torch.multiprocessing`` spawn shared by the module (a file rendezvous,
every wait under ``TIMEOUT_S``), over two meshes of the same four ranks:
``pp=2 x dp=2`` and ``pp=4``. Each dp rank passes its rows of every
microbatch, as JAX's ``batch`` placement gives them.

* GPipe (``pipeline_apply``) against the sequential model at 2 and 4
  stages, its gradients through autograd, ``out_mode="scatter"``.
* 1F1B (``pipeline_grads_1f1b``) against the port's GPipe-autograd step
  and against JAX's ``pipeline_grads_1f1b`` at (S, M) = (2, 4), (4, 8) and
  (4, 5): loss and gradients within 2e-5; its clock (ticks, one forward a
  microbatch on every stage but the last, which only runs backward ticks)
  and no stage holding more than S + 1 stage inputs at once.
* JAX's ``first_fn`` and ``stage_takes_raw`` contracts: int token ids
  embedded on stage 0 (every stage holds the table, as JAX's uniform stage
  tree does; only stage 0's gets a gradient) and a side input read from
  the raw microbatch on every stage, against JAX's 1F1B at 2 and 4 stages;
  the hand-off shape comes from stage 0's ``first_fn``, sent to the others.
* The single-stage paths (``mesh=None``) and the refusals (fewer
  microbatches than stages, ``scatter`` with M not divisible by S, layers
  not divisible by the stages, a bad ``out_mode``), the latter on torch's
  fake process group in this process.
"""

import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from maggy_tpu_torch.parallel import ShardingSpec, make_mesh
from maggy_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_grads_1f1b, stack_stage_params

TIMEOUT_S = 120
WORLD = 4
D, MB = 16, 4
TOL = 2e-5
F1B_CASES = [(2, 4), (4, 8), (4, 5)]
MESHES = {2: dict(pp=2, dp=2), 4: dict(pp=4)}


def problem(n_layers=8, n_micro=8, seed=0):
    """Weights ``[L, D, D]``, microbatches ``[M, MB, D]`` and targets."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n_layers, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, MB, D)).astype(np.float32)
    t = rng.normal(size=(n_micro, MB, D)).astype(np.float32)
    return w, x, t


def stage_fn(stage_w, x):
    for w in stage_w:
        x = x + torch.tanh(x @ w)
    return x


def mse(params, y, t):
    return ((y - t) ** 2).mean()


VOCAB = 32


def embed_problem(n_micro, seed=1):
    """An embedding table, layer weights, int token microbatches and targets."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(VOCAB, D)).astype(np.float32)
    w = (rng.normal(size=(8, D, D)) * 0.3).astype(np.float32)
    raw = rng.integers(0, VOCAB, (n_micro, MB)).astype(np.int64)
    t = rng.normal(size=(n_micro, MB, D)).astype(np.float32)
    return emb, w, raw, t


def embed_first(p, raw):
    return p["emb"][raw]


def raw_stage(p, x, raw):
    gate = 1.0 + (raw[..., None] % 2)  # a side input every stage reads from the raw rows
    for w in p["w"]:
        x = x + torch.tanh(x @ w) * gate
    return x


def sequential(w, x):
    for layer in w:
        x = x + np.tanh(x @ layer)
    return x


def _mine(mesh, w, x, t=None):
    """This rank's stage of the weights and its rows of the microbatches."""
    s, n = mesh.get_local_rank("stage"), mesh.size(0)
    d, dp = mesh.get_local_rank("data"), mesh.size(1)
    rows = slice(d * MB // dp, (d + 1) * MB // dp)
    stage_w = torch.from_numpy(np.ascontiguousarray(stack_stage_params(torch.from_numpy(w), n)[s].numpy()))
    out = [stage_w, torch.from_numpy(x[:, rows].copy())]
    if t is not None:
        out.append(torch.from_numpy(t[:, rows].copy()))
    return out


def _rank(rank, init_file, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
        res = {}
        for S, kw in MESHES.items():
            mesh = make_mesh(ShardingSpec(**kw), "cpu")
            coord = dict(stage=mesh.get_local_rank("stage"), data=mesh.get_local_rank("data"))
            w, x, _ = problem()
            sw, xs = _mine(mesh, w, x)
            res[("gpipe", S)] = dict(coord, out=pipeline_apply(stage_fn, sw, xs, mesh=mesh).numpy())
            if S == 4:
                res["scatter"] = dict(coord, out=pipeline_apply(stage_fn, sw, xs, mesh=mesh, out_mode="scatter").numpy())
                w4, x4, _ = problem(n_layers=4, n_micro=4)
                sw4, xs4 = _mine(mesh, w4, x4)
                sw4.requires_grad_(True)
                pipeline_apply(stage_fn, sw4, xs4, mesh=mesh).sum().backward()
                res["grads"] = dict(coord, grad=sw4.grad.numpy())
            for S_, M in F1B_CASES:
                if S_ != S:
                    continue
                w, x, t = problem(n_micro=M)
                sw, xs, ts = _mine(mesh, w, x, t)
                stats = {}
                loss, grads = pipeline_grads_1f1b(stage_fn, mse, sw, xs, ts, mesh=mesh, stats=stats)
                # the GPipe-autograd reference: each rank's mean over its
                # rows, over the dp ranks, is the global mean
                g_sw = sw.clone().requires_grad_(True)
                outs = pipeline_apply(stage_fn, g_sw, xs, mesh=mesh)
                ref = torch.stack([mse(None, outs[m], ts[m]) for m in range(M)]).mean() / kw.get("dp", 1)
                ref.backward()
                ref_loss = ref.detach().clone()
                if kw.get("dp", 1) > 1:
                    dist.all_reduce(ref_loss, group=mesh.get_group("data"))
                res[("1f1b", S, M)] = dict(coord, loss=float(loss), grad=grads.numpy(), stats=stats,
                                           gpipe_loss=float(ref_loss), gpipe_grad=g_sw.grad.numpy())
            emb, w, raw, t = embed_problem(n_micro=2 * S)
            sw, _, ts = _mine(mesh, w, np.zeros((2 * S, MB, D), np.float32), t)
            d, dp = coord["data"], kw.get("dp", 1)
            rows = slice(d * MB // dp, (d + 1) * MB // dp)
            params = {"emb": torch.from_numpy(emb), "w": sw}
            loss, grads = pipeline_grads_1f1b(raw_stage, mse, params, torch.from_numpy(raw[:, rows].copy()), ts,
                                              mesh=mesh, first_fn=embed_first, stage_takes_raw=True)
            res[("first_fn", S)] = dict(coord, loss=float(loss), emb=grads["emb"].numpy(), w=grads["w"].numpy())
        out.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, in rank order; raises with a rank's traceback,
    or after TIMEOUT_S, and leaves no rank running."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = str(tmp_path_factory.mktemp("pipeline") / "rendezvous")
    procs = [ctx.Process(target=_rank, args=(r, init, out)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(WORLD)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if len(r) == 3]
    if failed:
        raise AssertionError("\n".join(failed))
    return [r[1] for r in results]


def _jax():
    import jax
    import jax.numpy as jnp

    from maggy_tpu.parallel import pipeline as jp
    from maggy_tpu.parallel.mesh import make_mesh as jmake_mesh
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec

    def jstage(sw, x):
        out, _ = jax.lax.scan(lambda x, w: (x + jnp.tanh(x @ w), None), x, sw)
        return out

    def mesh(S):
        return jmake_mesh(JShardingSpec(pp=S, dp=8 // S))

    return jax, jnp, jp, jstage, mesh


def _rows(results, key):
    """The stage-(S-1) copies of ``key``'s output, rows reassembled by the
    data coordinate."""
    parts = {r[key]["data"]: r[key]["out"] for r in results}
    return np.concatenate([parts[d] for d in sorted(parts)], axis=1)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_sequential(ranks, n_stages):
    """GPipe over S stages: every stage holds the last stage's outputs,
    equal to the sequential model and to JAX's ``pipeline_apply``."""
    jax, jnp, jp, jstage, mesh = _jax()
    w, x, _ = problem()
    with mesh(n_stages):
        ref = np.asarray(jp.pipeline_apply(jstage, jp.stack_stage_params(jnp.asarray(w), n_stages),
                                           jnp.asarray(x), mesh=mesh(n_stages)))
    np.testing.assert_allclose(ref, sequential(w, x), atol=1e-5)
    for s in range(n_stages):
        got = _rows([r for r in ranks if r[("gpipe", n_stages)]["stage"] == s], ("gpipe", n_stages))
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_pipeline_single_stage_path():
    jax, jnp, jp, jstage, _ = _jax()
    from maggy_tpu.parallel.mesh import make_mesh as jmake_mesh
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec

    w, x, _ = problem(n_layers=4)
    jm = jmake_mesh(JShardingSpec(dp=8))
    with jm:
        ref = np.asarray(jp.pipeline_apply(jstage, jp.stack_stage_params(jnp.asarray(w), 1), jnp.asarray(x), mesh=jm))
    got = pipeline_apply(stage_fn, stack_stage_params(torch.from_numpy(w), 1)[0], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), sequential(w, x), atol=1e-5)


def test_pipeline_gradients_match(ranks):
    """Autograd through GPipe at 4 stages: each stage's gradient equals
    JAX's ``jax.grad`` through its ``pipeline_apply`` and the sequential
    model's."""
    jax, jnp, jp, jstage, mesh = _jax()
    w, x, _ = problem(n_layers=4, n_micro=4)
    m4 = mesh(4)

    def loss_pipe(sw):
        with m4:
            return jp.pipeline_apply(jstage, sw, jnp.asarray(x), mesh=m4).sum()

    ref = np.asarray(jax.grad(loss_pipe)(jp.stack_stage_params(jnp.asarray(w), 4)))
    for r in ranks:
        np.testing.assert_allclose(r["grads"]["grad"], ref[r["grads"]["stage"]], atol=TOL, rtol=0)


def test_pipeline_scatter_output_matches_replicated(ranks):
    """``out_mode="scatter"``: stage s holds microbatches [2s, 2s+2) of the
    replicated output, as JAX's reduce-scatter gives them."""
    jax, jnp, jp, jstage, mesh = _jax()
    w, x, _ = problem()
    with mesh(4):
        ref = np.asarray(jp.pipeline_apply(jstage, jp.stack_stage_params(jnp.asarray(w), 4), jnp.asarray(x),
                                           mesh=mesh(4), out_mode="scatter"))
    for r in ranks:
        s = r["scatter"]["stage"]
        np.testing.assert_allclose(r["scatter"]["out"], r[("gpipe", 4)]["out"][2 * s:2 * s + 2], atol=0, rtol=0)
        np.testing.assert_allclose(r["scatter"]["out"], ref[2 * s:2 * s + 2], atol=TOL, rtol=0)


@pytest.mark.parametrize("n_stages,n_micro", F1B_CASES)
def test_1f1b_matches_gpipe_autodiff_and_jax(ranks, n_stages, n_micro):
    """The 1F1B step's loss and gradients equal the port's autograd through
    GPipe and JAX's ``pipeline_grads_1f1b``, for even and ragged
    microbatch/stage ratios."""
    jax, jnp, jp, jstage, mesh = _jax()
    w, x, t = problem(n_micro=n_micro)
    jm = mesh(n_stages)
    with jm:
        jloss, jgrads = jp.pipeline_grads_1f1b(jstage, lambda p, y, tt: ((y - tt) ** 2).mean(),
                                               jp.stack_stage_params(jnp.asarray(w), n_stages),
                                               jnp.asarray(x), jnp.asarray(t), mesh=jm)
    jgrads = np.asarray(jgrads)
    for r in ranks:
        res = r[("1f1b", n_stages, n_micro)]
        assert res["loss"] == pytest.approx(float(jloss), rel=TOL)
        assert res["loss"] == pytest.approx(res["gpipe_loss"], rel=TOL)
        np.testing.assert_allclose(res["grad"], jgrads[res["stage"]], atol=TOL, rtol=0)
        np.testing.assert_allclose(res["grad"], res["gpipe_grad"], atol=TOL, rtol=0)


@pytest.mark.parametrize("n_stages,n_micro", F1B_CASES)
def test_1f1b_clock_holds_at_most_s_plus_1_inputs(ranks, n_stages, n_micro):
    """JAX's closed-form clock: T = 2M + 2S - 2 ticks, M backward ops on
    every stage, M forward-only ops on every stage but the last (whose
    backward tick re-runs its forward), and at most S + 1 stage inputs held
    by any stage at once."""
    for r in ranks:
        res = r[("1f1b", n_stages, n_micro)]
        st = res["stats"]
        last = res["stage"] == n_stages - 1
        assert st["ticks"] == 2 * n_micro + 2 * n_stages - 2
        assert st["backward_ops"] == n_micro
        assert st["forward_ops"] == (0 if last else n_micro)
        assert st["max_inputs_held"] <= n_stages + 1
        assert st["max_inputs_held"] >= (0 if res["stage"] == 0 else 1)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_1f1b_first_fn_and_raw_side_inputs_match_jax(ranks, n_stages):
    jax, jnp, jp, jstage, mesh = _jax()
    emb, w, raw, t = embed_problem(n_micro=2 * n_stages)

    def jraw_stage(p, x, r):
        gate = 1.0 + (r[..., None] % 2)
        out, _ = jax.lax.scan(lambda x, wl: (x + jnp.tanh(x @ wl) * gate, None), x, p["w"])
        return out

    params = {"emb": jnp.broadcast_to(jnp.asarray(emb)[None], (n_stages,) + emb.shape),
              "w": jp.stack_stage_params(jnp.asarray(w), n_stages)}
    jm = mesh(n_stages)
    with jm:
        jloss, jgrads = jp.pipeline_grads_1f1b(jraw_stage, lambda p, y, tt: ((y - tt) ** 2).mean(), params,
                                               jnp.asarray(raw), jnp.asarray(t), mesh=jm,
                                               first_fn=lambda p, r: p["emb"][r], stage_takes_raw=True)
    for r in ranks:
        res = r[("first_fn", n_stages)]
        s = res["stage"]
        assert res["loss"] == pytest.approx(float(jloss), rel=TOL)
        np.testing.assert_allclose(res["w"], np.asarray(jgrads["w"])[s], atol=TOL, rtol=0)
        np.testing.assert_allclose(res["emb"], np.asarray(jgrads["emb"])[s], atol=TOL, rtol=0)
        assert np.any(res["emb"] != 0) == (s == 0)  # the table's gradient lands on stage 0 alone


def test_1f1b_single_stage_path():
    jax, jnp, jp, jstage, _ = _jax()
    from maggy_tpu.parallel.mesh import make_mesh as jmake_mesh
    from maggy_tpu.parallel.spec import ShardingSpec as JShardingSpec

    w, x, t = problem(n_layers=4, n_micro=4)
    jm = jmake_mesh(JShardingSpec(dp=8))
    with jm:
        jloss, jgrads = jp.pipeline_grads_1f1b(jstage, lambda p, y, tt: ((y - tt) ** 2).mean(),
                                               jp.stack_stage_params(jnp.asarray(w), 1), jnp.asarray(x),
                                               jnp.asarray(t), mesh=jm)
    sw = stack_stage_params(torch.from_numpy(w), 1)[0]
    stats = {}
    loss, grads = pipeline_grads_1f1b(stage_fn, mse, sw, torch.from_numpy(x), torch.from_numpy(t), stats=stats)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads)[0], atol=TOL, rtol=0)
    assert grads.shape == sw.shape and stats["backward_ops"] == 4 and stats["forward_ops"] == 4


def test_pipeline_validation():
    """Fewer microbatches than stages, ``scatter`` with M not divisible by
    S, layers not divisible by the stages and an unknown ``out_mode`` raise
    as JAX's do (here over torch's fake process group: nothing is sent)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh(ShardingSpec(pp=4), "cpu")
        w, x, t = problem(n_layers=8, n_micro=2)
        sw = stack_stage_params(torch.from_numpy(w), 4)[0]
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_apply(stage_fn, sw, torch.from_numpy(x), mesh=mesh)  # 2 micro < 4 stages
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_grads_1f1b(stage_fn, mse, sw, torch.from_numpy(x), torch.from_numpy(t), mesh=mesh)
        _, x6, _ = problem(n_micro=6)
        with pytest.raises(ValueError, match="divisible"):
            pipeline_apply(stage_fn, sw, torch.from_numpy(x6), mesh=mesh, out_mode="scatter")
        with pytest.raises(ValueError, match="out_mode"):
            pipeline_apply(stage_fn, sw, torch.from_numpy(x6), mesh=mesh, out_mode="gather")
        with pytest.raises(ValueError, match="divisible"):
            stack_stage_params(torch.from_numpy(w), 3)
    finally:
        dist.destroy_process_group()
