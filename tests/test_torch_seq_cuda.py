"""The seq axis and ZeRO-1 on CUDA cards: the flash kernels at Ulysses'
local shape against their plain versions; with two or more cards,
Ulysses over NCCL against the flash kernels on the whole sequence, and
ZeRO-1 against the bucketed step.

These need a CUDA card and nvcc: they skip elsewhere. On the card, run them
without the JAX package's test configuration:

    python -m pytest tests/test_torch_seq_cuda.py -q --noconftest
"""

import socket
import traceback

import pytest
import torch
import torch.multiprocessing as mp

from maggy_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda

TIMEOUT_S = 300


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    yield torch.device("cuda", 0)


@pytest.fixture()
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    yield 2


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(torch.bfloat16)


@pytest.mark.parametrize("b, s, h, kh", [(1, 8192, 8, 2), (2, 2048, 8, 2), (1, 2048, 16, 4)],
                         ids=["ring_train_sp4", "train_sp4", "train_sp2_dp2"])
def test_flash_kernels_at_ulysses_local_shapes(card, b, s, h, kh):
    """Llama-3-8B's 32 query and 8 KV heads over sp ranks, the whole
    sequence on each: each kernel against its plain version (the
    tolerances of ``tests/test_torch_cuda.py``)."""
    gen = torch.Generator(device=card).manual_seed(0)
    d = 128
    q, k, v, do = _rand(gen, b, s, h, d), _rand(gen, b, s, kh, d), _rand(gen, b, s, kh, d), _rand(gen, b, s, h, d)
    flash.reset_launches()
    o, lse = flash.flash_fwd(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = flash.flash_fwd_reference(*f32)
    assert float((o.float() - o_ref).abs().max()) <= 2e-2
    assert float((o.float() - o_ref).norm() / o_ref.norm()) <= 1e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    del o_ref, lse_ref
    args, ref_args = (q, k, v, o, do, lse), (*f32, o.float(), do.float(), lse)
    dq = flash.flash_bwd_dq(*args)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq_ref = flash.flash_dq_reference(*ref_args)
    assert float((dq.float() - dq_ref).norm() / dq_ref.norm()) <= 2e-2
    del dq_ref
    dk_ref, dv_ref = flash.flash_dkv_reference(*ref_args)
    for a, r in ((dk, dk_ref), (dv, dv_ref)):
        assert float((a.float() - r).norm() / r.norm()) <= 2e-2
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(target, n, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, n, port, out, *args)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=TIMEOUT_S) for _ in range(n)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [f"rank {r[0]} failed:\n{r[2]}" for r in results if isinstance(r[1], str) and r[1] == "error"]
    assert not failed, "\n".join(failed)
    return [r[1] for r in results]


def _ulysses_rank(rank, n, port, out):
    import torch.distributed as dist

    from maggy_tpu_torch.parallel import ShardingSpec, make_mesh, ulysses_attention

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
        mesh = make_mesh(ShardingSpec(sp=n))
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, s, h, kh, d = 1, 4096, 8, 2, 128
        q, k, v, do = _rand(gen, b, s, h, d), _rand(gen, b, s, kh, d), _rand(gen, b, s, kh, d), _rand(gen, b, s, h, d)
        seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        seg[:, s // 3:] = 1
        # the whole sequence through the flash kernels on this card
        full = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = flash.flash_attention(*full, causal=True, segment_ids=seg)
        ref.backward(do)
        c = s // n
        mine = [t[:, rank * c:(rank + 1) * c].clone().requires_grad_(True) for t in (q, k, v)]
        flash.reset_launches()
        o = ulysses_attention(*mine, mesh=mesh, causal=True, segment_ids=seg[:, rank * c:(rank + 1) * c])
        o.backward(do[:, rank * c:(rank + 1) * c])
        torch.cuda.synchronize()

        def rel(a, r):
            return float((a.float() - r.float()).norm() / r.float().norm())

        chunk = slice(rank * c, (rank + 1) * c)
        out.put((rank, dict(o=rel(o, ref[:, chunk]),
                            grads=[rel(m.grad, f.grad[:, chunk]) for m, f in zip(mine, full)],
                            launches=dict(flash.LAUNCHES))))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def test_ulysses_over_cards_matches_flash_on_one(two_cards):
    """Ulysses over NCCL (all-to-all, the flash kernels at H/n heads over
    the whole sequence) against the flash kernels over it on one card, a
    packed boundary included: the same kernels on the same heads, so only
    bf16 rounding of the exchanged tensors differs."""
    for r in _spawn(_ulysses_rank, two_cards):
        assert r["o"] <= 1e-2 and max(r["grads"]) <= 2e-2, r
        assert r["launches"] == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def _zero_rank(rank, n, port, out):
    import torch.distributed as dist

    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.parallel import ShardingSpec
    from maggy_tpu_torch.train import TrainContext, adamw, synthetic_lm_batches

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
        ctx = TrainContext.create(ShardingSpec(dp=n), device=f"cuda:{rank}")
        cfg = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256)
        res = {}
        for mode, kw in (("bucket", dict(bucket_mb=1)), ("zero", dict(zero_stage=1, bucket_mb=1))):
            trainer = ctx.trainer(Decoder(cfg, device="meta"), adamw(1e-3), **kw)
            data = synthetic_lm_batches(cfg.vocab_size, 2 * n, 256, seed=0)
            state = trainer.make_state(0, next(data))
            ms = [trainer.step(state, ctx.shard_batch(next(data)))[1] for _ in range(3)]
            res[mode] = dict(mode=trainer._overlap_mode()[0], losses=[float(m["loss"]) for m in ms],
                             norms=[float(m["grad_norm"]) for m in ms])
        out.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def test_zero_matches_bucket_over_cards(two_cards):
    """ZeRO-1 (reduce-scatter, AdamW on the shard, all-gather) against the
    bucketed step (all-reduce) over NCCL: the same sums."""
    for r in _spawn(_zero_rank, two_cards):
        assert (r["bucket"]["mode"], r["zero"]["mode"]) == ("bucket", "zero")
        for key in ("losses", "norms"):
            for a, b in zip(r["zero"][key], r["bucket"][key]):
                assert a == pytest.approx(b, rel=1e-5)
