"""The MoE decoder on a CUDA card: its attention through the flash kernels,
held to the same weights with the plain attention, the launches counted,
and one Trainer step.

These need a CUDA card and nvcc: they skip elsewhere. On the card, run them
without the JAX package's test configuration:

    python -m pytest tests/test_torch_moe_cuda.py -q --noconftest
"""

import dataclasses

import pytest
import torch

from maggy_tpu_torch.models import MoEConfig, MoEDecoder, default_attention
from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.train import Trainer, adamw, collect_aux_losses

pytestmark = pytest.mark.cuda

# head_dim 64 in bf16, two layers of four experts: the flash kernels take it
CFG = MoEConfig.tiny_moe(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256,
                         group_size=128)
B, S = 2, 256


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    yield torch.device("cuda", 0)


def _tokens(device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (B, S), generator=g).to(device)


def test_flash_forward_matches_plain_attention(card):
    gen = torch.Generator(device=card).manual_seed(0)
    model = MoEDecoder(CFG, device=card, generator=gen)
    plain = MoEDecoder(dataclasses.replace(CFG, attention_fn=default_attention), device="meta")
    plain.to_empty(device=card)
    plain.load_state_dict(model.state_dict())
    tokens = _tokens(card)
    flash.reset_launches()
    with torch.no_grad():
        got = model(tokens)
        want = plain(tokens)
    assert flash.LAUNCHES["flash_fwd"] == CFG.n_layers
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 3e-2
    assert float(collect_aux_losses(model)) > 0


def test_trainer_step_launches_the_backward_kernels(card):
    trainer = Trainer(MoEDecoder(CFG, device="meta"), adamw(1e-3), device=card)
    batch = {"tokens": _tokens("cpu", 1).numpy()}
    state = trainer.make_state(0, batch)
    flash.reset_launches()
    state, m = trainer.step(state, batch)
    torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_bwd_dq"] == flash.LAUNCHES["flash_bwd_dkv"] == CFG.n_layers
    assert all(torch.isfinite(m[k]).item() for k in ("loss", "aux_loss", "grad_norm"))
    assert float(m["aux_loss"]) > 0


def test_pipeline_stage_launches_the_kernels_and_reports_aux(card):
    """One stage of the MoE decoder's pipeline (the single-stage 1F1B path,
    two microbatches of one row): each layer's forward and both backward
    kernels once a microbatch, the router terms reported beside the loss,
    and the loss that of the whole model on the same weights."""
    from maggy_tpu_torch.parallel.pipeline import pipeline_grads_1f1b
    from maggy_tpu_torch.train import lm_loss_fn
    from maggy_tpu_torch.train.pipeline_adapter import decoder_pipeline_parts

    parts = decoder_pipeline_parts(MoEDecoder(CFG, device="meta"), 1)
    assert parts.stage_has_aux
    stage = parts.make_stage(0, card)
    stage.reset_parameters(torch.Generator(device=card).manual_seed(0))
    model = MoEDecoder(CFG, device=card, generator=torch.Generator(device=card).manual_seed(0))
    tokens = _tokens(card)
    flash.reset_launches()
    loss, grads, aux = pipeline_grads_1f1b(
        parts.stage_fn, lambda st, y, t: lm_loss_fn(parts.head_fn(st, y), t), stage, tokens.view(B, 1, S),
        {"tokens": tokens.view(B, 1, S)}, first_fn=parts.first_fn, stage_takes_raw=True, stage_has_aux=True)
    torch.cuda.synchronize()
    assert dict(flash.LAUNCHES) == {k: B * CFG.n_layers for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    assert torch.isfinite(loss) and float(aux) > 0
    assert all(torch.isfinite(g).all() for g in grads.values())
    with torch.no_grad():
        want = float(lm_loss_fn(model(tokens), {"tokens": tokens}))
    assert abs(float(loss) - want) <= 2e-2 * abs(want)


def _tp_rank(rank, port, out):
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                                device_id=torch.device("cuda", rank))
        from maggy_tpu_torch.parallel import ShardingSpec
        from maggy_tpu_torch.train import TrainContext

        ctx = TrainContext.create(ShardingSpec(tp=2))
        trainer = ctx.trainer(MoEDecoder(CFG, device="meta"), adamw(1e-3))
        batch = {"tokens": _tokens("cpu", 1).numpy()}
        state = trainer.make_state(0, batch)
        flash.reset_launches()
        state, m = trainer.step(state, ctx.shard_batch(batch))
        torch.cuda.synchronize()
        out.put((rank, dict(loss=float(m["loss"]), aux=float(m["aux_loss"]), launches=dict(flash.LAUNCHES))))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, traceback.format_exc()))


def test_tensor_parallel_step_on_two_cards(card):
    """tp=2 over two NCCL ranks: each rank's flash kernels at half the
    heads once a layer, the expert FFNs' partial products summed over
    ``tensor``; the step's loss and router terms those of one card."""
    import socket

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    trainer = Trainer(MoEDecoder(CFG, device="meta"), adamw(1e-3), device=card)
    batch = {"tokens": _tokens("cpu", 1).numpy()}
    _, want = trainer.step(trainer.make_state(0, batch), batch)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=300) for _ in range(2)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, res in results:
        assert isinstance(res, dict), res
        assert res["launches"] == {k: CFG.n_layers for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert res["loss"] == pytest.approx(float(want["loss"]), rel=1e-2)
        assert res["aux"] == pytest.approx(float(want["aux_loss"]), abs=1e-3)
