"""The port's Bert against the JAX package's, on converted weights.

The JAX ``Bert`` is initialised from a key, its params go through
``maggy_tpu_torch.convert.bert_params_from_flax``, and the same tokens and
padded attention mask (numpy, from a seed) go through both, at
``BertConfig.tiny()`` widths (vocab 256, d 64, 2 layers, 4 heads, d_ff 128)
and at a 3-layer variant so that dropping ``layer_0`` leaves two layers.

Tolerances. fp32: 1e-5 absolute plus 1e-5 relative on the pooled logits and
the sequence output (|x| up to ~4): the same math, the sums taken in another
order; measured ~1e-6. Gradients of one cross-entropy loss, fp32: 1e-5
absolute plus 1e-4 relative. bf16: relative L2 of 2e-2 on the sequence
output and the logits — both frameworks round to bf16 after every
projection, LayerNorm and residual add, but the JAX side also rounds inside
attention and GELU where the port's math stays fp32; measured 6e-3 and 9e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import bert as jb
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import bert_params_from_flax
from maggy_tpu_torch.models import Bert, BertConfig

torch.set_num_threads(2)
B, S = 3, 32
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_REL_L2 = 2e-2


def _inputs(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0  # padded tails
    mask[2, 5:] = 0
    labels = rng.integers(0, 2, (B,)).astype(np.int32)
    return tokens, mask, labels


def _pair(dtype="float32", ablated=frozenset(), n_layers=3):
    jcfg = jb.BertConfig.tiny(dtype=getattr(jnp, dtype), ablated=ablated, n_layers=n_layers)
    tcfg = BertConfig.tiny(dtype=getattr(torch, dtype), ablated=ablated, n_layers=n_layers)
    tokens, mask, _ = _inputs()
    variables = jb.Bert(jcfg).init(jax.random.key(0), jnp.asarray(tokens), jnp.asarray(mask))
    params = jax.device_get(unbox(variables["params"]))
    model = Bert(tcfg, device="cpu").eval()
    model.load_state_dict(bert_params_from_flax(params, tcfg))
    return jcfg, variables, model


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


VARIANTS = {
    "full": frozenset(),
    "layer_0": frozenset({"layer_0"}),
    "pooler": frozenset({"pooler"}),
    "position_embeddings": frozenset({"position_embeddings"}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bert_matches_fp32(variant):
    jcfg, variables, model = _pair(ablated=VARIANTS[variant])
    tokens, mask, _ = _inputs()
    jl, jx = jb.Bert(jcfg).apply(variables, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        tl, tx = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tl.shape == (B, 2) and tx.shape == (B, S, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FP32_ATOL, rtol=FP32_RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=FP32_ATOL, rtol=FP32_RTOL)


def test_bert_without_mask_matches_fp32():
    jcfg, variables, model = _pair()
    tokens, _, _ = _inputs(1)
    jl, jx = jb.Bert(jcfg).apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tx = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FP32_ATOL, rtol=FP32_RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=FP32_ATOL, rtol=FP32_RTOL)


def test_bert_bf16_rel_l2():
    jcfg, variables, model = _pair("bfloat16")
    tokens, mask, _ = _inputs()
    jl, jx = jb.Bert(jcfg).apply(variables, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        tl, tx = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert tx.dtype == torch.bfloat16 and tl.dtype == torch.float32
    assert _rel_l2(tx.float().numpy(), np.asarray(jx, np.float32)) < BF16_REL_L2
    assert _rel_l2(tl.numpy(), np.asarray(jl)) < BF16_REL_L2


def test_bert_gradients_match_fp32():
    """The gradients of one cross-entropy loss: JAX's tree, through the same
    converter, against the port's parameter gradients."""
    jcfg, variables, model = _pair()
    tokens, mask, labels = _inputs()

    def jloss(params):
        logits, _ = jb.Bert(jcfg).apply({"params": params}, jnp.asarray(tokens), jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean()

    jgrads = bert_params_from_flax(jax.device_get(unbox(jax.grad(jloss)(variables["params"]))), model.cfg)
    logits, _ = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(labels).long()[:, None]).mean()
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == jgrads.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("variant", ["layer_0", "pooler", "position_embeddings"])
def test_ablated_variant_drops_exactly_its_parameters(variant):
    full = Bert(BertConfig.tiny(n_layers=3), device="meta")
    cut = Bert(BertConfig.tiny(n_layers=3, ablated={variant}), device="meta")
    own = {"layer_0": "layers.layer_0.", "pooler": "pooler.", "position_embeddings": "position_embedding"}[variant]
    full_names = dict(full.named_parameters())
    dropped = {n for n in full_names if n.startswith(own)}
    assert dropped and set(dict(cut.named_parameters())) == set(full_names) - dropped
    assert (sum(p.numel() for p in full.parameters()) - sum(p.numel() for p in cut.parameters())
            == sum(full_names[n].numel() for n in dropped))
    if variant == "layer_0":  # survivors keep their own names, as in the JAX tree
        assert list(cut.layers) == ["layer_1", "layer_2"]


def test_dropout_only_in_train_mode_from_a_generator():
    cfg = BertConfig.tiny(dtype=torch.float32, dropout=0.5)
    model = Bert(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        model.eval()
        a, b = model(tokens)[1], model(tokens)[1]
        assert torch.equal(a, b)  # eval: nothing dropped
        model.train()
        c = model(tokens, generator=torch.Generator().manual_seed(1))[1]
        d = model(tokens, generator=torch.Generator().manual_seed(1))[1]
        e = model(tokens, generator=torch.Generator().manual_seed(2))[1]
    assert torch.equal(c, d) and not torch.equal(c, e) and not torch.equal(a, c)
    # with cfg.dropout == 0 train mode changes nothing
    quiet = Bert(BertConfig.tiny(dtype=torch.float32), device="cpu").train()
    with torch.no_grad():
        assert torch.equal(quiet(tokens)[1], quiet.eval()(tokens)[1])


def test_init_draws_from_the_generator_and_meta_builds_shapes_only():
    cfg = BertConfig.tiny()
    a = Bert(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Bert(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert abs(float(a.embedding.detach().std()) - 0.02) < 2e-3
    assert float(a.classifier.weight.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    meta = Bert(cfg, device="meta")
    assert all(p.is_meta for p in meta.parameters())
    meta.to_empty(device="cpu")
    meta.reset_parameters(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(meta.state_dict().values(), a.state_dict().values()))


def test_bert_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract is not observable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Bert(BertConfig.tiny())
