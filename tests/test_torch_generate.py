"""The port's generate paths against the JAX package's: greedy tokens equal.

``generate`` (prefix recompute through the training forward),
``generate_cached`` (KV cache) and ``generate_cached_packed`` (one packed
prefill, then cached steps) on ``DecoderConfig.tiny`` in float32 with weights
converted from the JAX init, with and without ``eos_id``. Greedy tokens
must be equal exactly: the logits agree to ~1e-6 (``test_torch_decode.py``)
and argmax is the same function on both sides. The sampling warning fires
only when sampling.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.models import generate as jg
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import generate as tg
from maggy_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=32, decode_chunk=16, dtype=jnp.float32)
TCFG = tt.DecoderConfig.tiny(max_seq_len=32, decode_chunk=16, dtype=torch.float32)
MAX_LEN = 16


@pytest.fixture(scope="module")
def models():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    model = tt.Decoder(TCFG, device="cpu")
    model.load_state_dict(decoder_params_from_flax(jax.device_get(params), TCFG))
    return params, model


def _prompts():
    buf = np.zeros((3, MAX_LEN), np.int32)
    lens = np.array([3, 6, 1], np.int32)
    rng = np.random.default_rng(0)
    for b, n in enumerate(lens):
        buf[b, :n] = rng.integers(1, 256, n)
    return buf, lens


def _both(models, name, eos_id):
    params, model = models
    buf, lens = _prompts()
    decode = jt.Decoder(dataclasses.replace(JCFG, decode=True))
    if name == "generate":
        want = jg.generate(jt.Decoder(JCFG), {"params": params}, jnp.asarray(buf), jnp.asarray(lens), eos_id=eos_id)
        got = tg.generate(model, torch.from_numpy(buf), torch.from_numpy(lens), eos_id=eos_id)
    else:
        want = jg.generate_cached(decode, params, jnp.asarray(buf), jnp.asarray(lens), eos_id=eos_id)
        got = tg.generate_cached(model, torch.from_numpy(buf), torch.from_numpy(lens), eos_id=eos_id)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", ["generate", "generate_cached"])
def test_greedy_tokens_equal_jax(models, name):
    want, got = _both(models, name, eos_id=-1)
    np.testing.assert_array_equal(got, want)
    buf, lens = _prompts()
    for b, n in enumerate(lens):  # the prompts stay, the rest is generated
        np.testing.assert_array_equal(got[b, :n], buf[b, :n])


@pytest.mark.parametrize("name", ["generate", "generate_cached"])
def test_greedy_tokens_equal_jax_with_eos(models, name):
    """The token row 0 emits third becomes EOS: every row repeats it once
    emitted, on both sides."""
    want, _ = _both(models, name, eos_id=-1)
    eos = int(want[0, 3 + 2])
    want, got = _both(models, name, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5:] == eos).all()


def _packed():
    rng = np.random.default_rng(1)
    t = 12
    seg = np.zeros((2, t), np.int32)
    seg[:, 5:] = 1
    seg[1, 9:] = 2
    pos = np.zeros((2, t), np.int32)
    for b in range(2):
        for s in np.unique(seg[b]):
            where = np.where(seg[b] == s)[0]
            pos[b, where] = np.arange(len(where))
    return rng.integers(1, 256, (2, t)).astype(np.int32), pos, seg


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_packed_greedy_tokens_equal_jax(models, eos):
    params, model = models
    tok, pos, seg = _packed()
    decode = jt.Decoder(dataclasses.replace(JCFG, decode=True))
    args = (jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(seg))
    targs = (torch.from_numpy(tok), torch.from_numpy(pos), torch.from_numpy(seg))
    eos_id = -1
    if eos:
        _, first = jg.generate_cached_packed(decode, params, *args, max_new=6)
        eos_id = int(np.asarray(first)[1, 1])
    jl, want = jg.generate_cached_packed(decode, params, *args, max_new=6, eos_id=eos_id)
    tl, got = tg.generate_cached_packed(model, *targs, max_new=6, eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    if eos:
        assert (got.numpy()[1, 1:] == eos_id).all()
    with pytest.raises(ValueError, match="exceeds the cache"):
        tg.generate_cached_packed(model, *targs, max_new=32)


def test_sampling_warns_only_when_sampling(models):
    _, model = models
    buf, lens = _prompts()
    prompt, plen = torch.from_numpy(buf), torch.from_numpy(lens)
    with pytest.warns(UserWarning, match="fixed default generator"):
        a = tg.generate_cached(model, prompt, plen, temperature=0.8, top_k=8)
    with pytest.warns(UserWarning, match="fixed default generator"):
        b = tg.generate_cached(model, prompt, plen, temperature=0.8, top_k=8)
    assert torch.equal(a, b)  # the footgun the warning names
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tg.generate_cached(model, prompt, plen)  # greedy: silent
        c = tg.generate_cached(model, prompt, plen, temperature=0.8, top_k=8,
                               rng=torch.Generator().manual_seed(5))
    assert not torch.equal(a, c)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tg.init_cache(model, prompt, mesh=object())
