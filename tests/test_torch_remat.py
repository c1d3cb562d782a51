"""The remat policies ``nothing``, ``dots``, ``dots_attn`` and ``everything``.

Within the port every policy recomputes with the same operations on the
same values, so the loss and every gradient equal ``remat=False``'s
exactly (``torch.equal``, fp32 and bf16). Against the JAX package's
``Decoder`` under the same policy, from the same weights (the JAX init of
``DecoderConfig.tiny()`` in fp32, converted), the loss is held to 1e-5
absolute and each gradient to ``rtol=2e-5`` with ``atol=1e-7`` — the
trainer parity tolerances of ``tests/test_torch_trainer.py`` (the same fp32
math, sums in another order).

What each policy recomputes is counted on the CPU too: the flash forward
(its plain version here, the kernel on a card) and the ``aten.mm`` calls.
The JAX side is counted in the jaxpr of its gradient, with the Pallas
kernels in interpret mode.
"""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from maggy_tpu.models import Decoder as JDecoder
from maggy_tpu.models import DecoderConfig as JConfig
from maggy_tpu.ops.flash import flash_attention as jflash
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.ops import flash

torch.set_num_threads(2)
POLICIES = ("nothing", "dots", "dots_attn", "everything")
B, S = 2, 32


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _loss(logits, tokens):
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()


@pytest.fixture()
def fwd_calls(monkeypatch):
    """Counts the flash forward (its plain version, on the CPU)."""
    calls = {"n": 0}
    plain = flash.flash_fwd_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_fwd_reference", counted)
    return calls


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _grads(remat, policy, dtype=torch.float32, params=None, count=None):
    cfg = DecoderConfig.tiny(remat=remat, remat_policy=policy, dtype=dtype)
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    if params is not None:
        model.load_state_dict(params)
    tokens = torch.from_numpy(_tokens())
    if count is not None:
        with count:
            loss = _loss(model(tokens), tokens)
            loss.backward()
    else:
        loss = _loss(model(tokens), tokens)
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_equal_no_remat_exactly(policy, dtype):
    ref_loss, ref = _grads(False, policy, dtype)
    loss, grads = _grads(True, policy, dtype)
    assert torch.equal(loss, ref_loss)
    assert list(grads) == list(ref)
    for name in ref:
        assert torch.equal(grads[name], ref[name]), name


@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, "nothing", 1), (True, "nothing", 2), (True, "dots", 2), (True, "dots_attn", 1), (True, "everything", 1),
])
def test_flash_forward_runs_as_the_policy_says(fwd_calls, remat, policy, per_layer):
    _grads(remat, policy)
    assert fwd_calls["n"] == per_layer * DecoderConfig.tiny().n_layers


def test_dots_keeps_the_matmuls():
    """Under "dots" and "dots_attn" no projection is multiplied again in
    the backward; under "nothing" six of each layer's seven are (the
    recompute stops once it has what the backward needs, and no gradient
    needs w_down's output)."""
    counts = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots"), (True, "dots_attn")):
        mode = CountOps()
        _grads(remat, policy, count=mode)
        counts[(remat, policy)] = mode.ops[torch.ops.aten.mm.default]
    base = counts[(False, "nothing")]
    assert counts[(True, "dots")] == counts[(True, "dots_attn")] == base
    assert counts[(True, "nothing")] == base + 6 * DecoderConfig.tiny().n_layers


def _jax_grads(policy, jcfg_kw=None):
    kw = dict(remat=True, remat_policy=policy) if policy else dict(remat=False)
    jcfg = JConfig.tiny(dtype=jnp.float32, **kw, **(jcfg_kw or {}))
    model = JDecoder(jcfg)
    tokens = jnp.asarray(_tokens())
    variables = model.init(jax.random.key(0), tokens)

    def loss_fn(v):
        logits = model.apply(v, tokens).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits[:, :-1], -1)
        return -jnp.take_along_axis(logp, tokens[:, 1:, None], -1).mean()

    loss, grads = jax.value_and_grad(loss_fn)(variables)
    return variables, float(loss), grads


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_equal_jax(policy):
    variables, jloss, jgrads = _jax_grads(policy)
    tcfg = DecoderConfig.tiny(dtype=torch.float32)
    params = decoder_params_from_flax(jax.device_get(unbox(variables)), tcfg)
    want = decoder_params_from_flax(jax.device_get(unbox(jgrads)), tcfg)
    loss, grads = _grads(True, policy, params=params)
    assert float(loss) == pytest.approx(jloss, abs=1e-5)
    for name in want:
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(), rtol=2e-5, atol=1e-7, err_msg=name)


def _pallas_forward_calls(jaxpr) -> int:
    """Flash forward pallas_calls in a jaxpr and its sub-jaxprs: the forward
    takes q, k, v (and segment ids); the backward kernels take six operands."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call" and len(eqn.invars) <= 4:
            n += 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _pallas_forward_calls(inner)
    return n


def test_dots_attn_runs_the_forward_once_where_jax_runs_it_twice(fwd_calls):
    """JAX's "dots_attn" saves the attention output but not the LSE, so its
    backward re-runs the Pallas forward as "nothing" does; the port's keeps
    both and runs the forward once per layer."""
    attn = functools.partial(jflash, interpret=True)
    geometry = dict(attention_fn=attn, d_model=256, n_heads=2, n_kv_heads=1, scan_layers=False)
    jax_calls = {}
    for policy in (None, "nothing", "dots_attn"):
        kw = dict(remat=True, remat_policy=policy) if policy else dict(remat=False)
        model = JDecoder(JConfig.tiny(**geometry, **kw))
        tokens = jnp.zeros((1, 128), jnp.int32)
        variables = model.init(jax.random.key(0), tokens)
        grad = jax.grad(lambda v: model.apply(v, tokens).astype(jnp.float32).mean())
        jax_calls[policy] = _pallas_forward_calls(jax.make_jaxpr(grad)(variables).jaxpr)
    layers = JConfig.tiny().n_layers
    assert jax_calls == {None: layers, "nothing": 2 * layers, "dots_attn": 2 * layers}
    _grads(True, "dots_attn")
    assert fwd_calls["n"] == layers
