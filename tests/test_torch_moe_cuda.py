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
