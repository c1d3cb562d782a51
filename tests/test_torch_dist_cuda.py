"""Multi-device training on CUDA cards: ``lagom(train_fn,
DistributedConfig(sharding="fsdp", num_executors=1))`` as one NCCL rank
through FSDP2 and the flash kernels, held to the dense ``Trainer``; and the
flash kernels at a tensor-parallel rank's head counts against their plain
versions.

These need a CUDA card and nvcc: they skip elsewhere. On the card, run them
without the JAX package's test configuration:

    python -m pytest tests/test_torch_dist_cuda.py -q --noconftest
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

pytestmark = pytest.mark.cuda

# head_dim 64 in bf16: the flash kernels take it; whole-layer remat, as in llama3_8b
CFG = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256,
                         remat=True, remat_policy="nothing")
B, S, STEPS = 2, 256, 3
LR = 1e-3


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    yield torch.device("cuda", 0)


def rank_train(model, hparams, reporter, ctx):
    """One rank: the dense test's steps under the rank's mesh."""
    trainer = ctx.trainer(model, adamw(LR))
    data = synthetic_lm_batches(model.cfg.vocab_size, B, S, seed=0)
    state = trainer.make_state(0, next(data))
    flash.reset_launches()
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = trainer.step(state, trainer.shard_batch(next(data)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"metric": losses[-1], "losses": losses, "norms": norms, "launches": dict(flash.LAUNCHES),
            "params_on_card": all(p.device == ctx.device for p in state.model.parameters())}


def test_lagom_fsdp_one_rank_matches_dense_trainer(card, tmp_path):
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv

    trainer = Trainer(Decoder(CFG, device="meta"), adamw(LR), device=card)
    data = synthetic_lm_batches(CFG.vocab_size, B, S, seed=0)
    state = trainer.make_state(0, next(data))
    want = [trainer.step(state, next(data))[1] for _ in range(STEPS)]
    del trainer, state
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info(0)[0]

    env_mod.set_instance(BaseEnv(str(tmp_path)))
    try:
        result = experiment.lagom(rank_train, DistributedConfig(
            module=Decoder(CFG, device="meta"), sharding="fsdp", num_executors=1, hb_interval=0.2,
            worker_timeout=120))
    finally:
        env_mod.set_instance(None)
    assert result["num_workers"] == 1
    got = json.loads(next(Path(tmp_path).rglob("worker_0/.outputs.json")).read_text())
    np.testing.assert_allclose(got["losses"], [float(m["loss"]) for m in want], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], [float(m["grad_norm"]) for m in want], rtol=1e-4)
    per_step = {"flash_fwd": 2 * CFG.n_layers, "flash_bwd_dq": CFG.n_layers, "flash_bwd_dkv": CFG.n_layers}
    assert got["launches"] == {k: STEPS * v for k, v in per_step.items()}
    assert got["params_on_card"]
    # the rank's process is gone, and with it its memory
    assert torch.cuda.mem_get_info(0)[0] >= free_before - (1 << 30)


@pytest.mark.parametrize("h, kh", [(16, 4), (8, 2)], ids=["tp2_local", "tp4_local"])
def test_flash_kernels_at_tensor_parallel_head_counts(card, h, kh):
    """Llama-3-8B's 32 query and 8 KV heads split over tp=2 and tp=4: each
    kernel against its plain version (the tolerances of
    ``tests/test_torch_cuda.py``)."""
    gen = torch.Generator(device=card).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(torch.bfloat16)

    b, s, d = 2, 512, 128
    q, k, v, do = rand(b, s, h, d), rand(b, s, kh, d), rand(b, s, kh, d), rand(b, s, h, d)
    flash.reset_launches()
    o, lse = flash.flash_fwd(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = flash.flash_fwd_reference(*f32)
    assert float((o.float() - o_ref).abs().max()) <= 2e-2
    assert float((o.float() - o_ref).norm() / o_ref.norm()) <= 1e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    args, ref_args = (q, k, v, o, do, lse), (*f32, o.float(), do.float(), lse)
    dq = flash.flash_bwd_dq(*args)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq_ref = flash.flash_dq_reference(*ref_args)
    dk_ref, dv_ref = flash.flash_dkv_reference(*ref_args)
    for a, r in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert float((a.float() - r).norm() / r.norm()) <= 2e-2
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
