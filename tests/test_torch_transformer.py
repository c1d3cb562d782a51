"""The port's Decoder against the JAX package's, on converted weights.

The JAX ``Decoder`` is initialised from a key, its params go through
``maggy_tpu_torch.convert.decoder_params_from_flax``, and the same tokens
(numpy) go through both. The geometry is the one ``__graft_entry__.entry()``
builds: vocab 2048, d 256, 4 layers, 8 heads, 4 KV heads, d_ff 704, S 128.

Tolerances. fp32: 1e-5 absolute plus 1e-4 relative on logits of magnitude
~1.6; the tied-embedding logits (rms ~17) get 1e-5 times their rms as the
absolute part, their rounding being that much larger — the same
math with sums taken in another order (the port's CPU attention is the flash
kernels' plain version, the JAX side's is ``default_attention``); measured
6e-7. bf16: relative L2 of 1e-2 — both frameworks round activations to bf16
after every projection, but at other places inside attention (the JAX
scores are rounded to bf16, the port's stay fp32); measured 3e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
ENTRY = dict(vocab_size=2048, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
             d_ff=704)
B, S = 2, 128
FP32_ATOL = 1e-5
BF16_REL_L2 = 1e-2


def _configs(dtype="float32", **kw):
    jcfg = jt.DecoderConfig(**ENTRY, max_seq_len=512, dtype=getattr(jnp, dtype), **kw)
    tcfg = tt.DecoderConfig(**ENTRY, dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _pair(jcfg, tcfg, tokens):
    variables = jt.Decoder(jcfg).init(jax.random.key(0), jnp.asarray(tokens))
    params = jax.device_get(unbox(variables["params"]))
    model = tt.Decoder(tcfg, device="cpu")
    model.load_state_dict(decoder_params_from_flax(params, tcfg))
    return variables, model


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, ENTRY["vocab_size"], (B, S)).astype(np.int32)


def _packed():
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 3:] = 1
    seg[1, 2 * S // 3:] = 2
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        for s_id in np.unique(seg[b]):
            idx = np.where(seg[b] == s_id)[0]
            pos[b, idx] = np.arange(len(idx))
    return pos, seg


VARIANTS = {
    "scan": dict(),
    "no_scan": dict(scan_layers=False),
    "tied": dict(tie_embeddings=True),
    "softcap": dict(logits_softcap=30.0),
    "ablated": dict(ablated=frozenset({"layers.1.mlp"})),
    "packed": dict(),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decoder_logits_match_fp32(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    tokens = _tokens()
    variables, model = _pair(jcfg, tcfg, tokens)
    extra_j, extra_t = (), ()
    if variant == "packed":
        pos, seg = _packed()
        extra_j = (jnp.asarray(pos), jnp.asarray(seg))
        extra_t = (torch.from_numpy(pos), torch.from_numpy(seg))
    ref = np.asarray(jt.Decoder(jcfg).apply(variables, jnp.asarray(tokens), *extra_j))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens), *extra_t)
    assert out.dtype == torch.float32 and out.shape == (B, S, ENTRY["vocab_size"])
    atol = FP32_ATOL
    if variant == "tied":
        # the tied head dots the final norm with the N(0, 1) embedding: its
        # logits (rms ~17, up to ~300) are 256-term fp32 sums whose rounding
        # grows with their size, so a logit near 0 that cancels such terms
        # misses by up to ~2e-5 in either framework (each against float64)
        atol = FP32_ATOL * float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=1e-4)


def test_decoder_without_matches_ablated_config():
    """cfg.without() builds the same gates as the ablated field."""
    _, tcfg = _configs()
    assert tcfg.without("layers.1.mlp").ablated == frozenset({"layers.1.mlp"})
    with pytest.raises(ValueError, match="Unknown ablated"):
        tcfg.without("layers.1.bogus")


def test_decoder_logits_match_bf16():
    jcfg, tcfg = _configs("bfloat16")
    tokens = _tokens(1)
    variables, model = _pair(jcfg, tcfg, tokens)
    ref = np.asarray(jt.Decoder(jcfg).apply(variables, jnp.asarray(tokens)))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens)).numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < BF16_REL_L2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (rng.random(64) + 0.5).astype(np.float32)
    jcfg = jt.DecoderConfig.tiny(dtype=getattr(jnp, dtype))
    tcfg = tt.DecoderConfig.tiny(dtype=getattr(torch, dtype))
    ref = jt.RMSNorm(jcfg).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x).astype(jcfg.dtype))
    norm = tt.RMSNorm(tcfg, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        out = norm(torch.from_numpy(x).to(tcfg.dtype))
    assert out.dtype == tcfg.dtype
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref).astype(np.float32),
        atol=1e-5 if dtype == "float32" else 1e-2, rtol=1e-5 if dtype == "float32" else 1e-2,
    )


def test_rope_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 7)).astype(np.int32)
    ref = jt.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    out = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_default_attention_matches():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    seg = np.array([[0] * 4 + [1] * 5, [0] * 9], np.int32)
    ref = jt.default_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=jnp.asarray(seg))
    out = tt.default_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_config_surface():
    cfg = tt.DecoderConfig.llama3_8b(n_layers=4)
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.rope_theta, cfg.remat, cfg.remat_policy) == (
        128_256, 4096, 32, 8, 128, 14_336, 5e5, True, "nothing")
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    # the serving fields and their validation are the JAX config's
    assert (tt.DecoderConfig().max_seq_len, cfg.max_seq_len, tt.DecoderConfig.tiny().max_seq_len) == (
        2048, 8192, 128)
    d = tt.DecoderConfig()
    assert (d.page_size, d.num_pages, d.decode_chunk) == (64, 0, 256)
    assert tt.DecoderConfig.tiny(decode=True).decode
    tt.DecoderConfig.tiny(decode=True, paged=True, page_size=16, num_pages=9)
    for kw, msg in ((dict(paged=True, num_pages=9), "requires decode"),
                    (dict(decode=True, paged=True, page_size=24, num_pages=9), "power of two"),
                    (dict(decode=True, paged=True, page_size=256, num_pages=9), "must divide"),
                    (dict(decode=True, paged=True, page_size=16, num_pages=1), "num_pages >= 2")):
        with pytest.raises(ValueError, match=msg):
            tt.DecoderConfig.tiny(**kw)
        with pytest.raises(ValueError, match=msg):
            jt.DecoderConfig.tiny(**kw)
    # every JAX remat policy is ported; an unknown one raises in both
    assert set(tt.REMAT_POLICIES) == set(jt.REMAT_POLICIES)
    for policy in tt.REMAT_POLICIES:
        assert tt.DecoderConfig.tiny(remat=True, remat_policy=policy).remat_policy == policy
    with pytest.raises(ValueError, match="remat_policy"):
        tt.DecoderConfig.tiny(remat=True, remat_policy="dots_everything")
    # the JAX config's training fields all exist in the port's
    jfields = {f.name for f in dataclasses.fields(jt.DecoderConfig)}
    tfields = {f.name for f in dataclasses.fields(tt.DecoderConfig)}
    assert {"vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
            "rope_theta", "norm_eps", "remat", "remat_policy", "logits_softcap",
            "tie_embeddings", "attention_fn", "ablated", "scan_layers", "max_seq_len",
            "decode", "paged", "page_size", "num_pages", "decode_chunk"} <= jfields & tfields


@pytest.mark.parametrize("policy", ["nothing", "everything"])
def test_remat_gradients_match_plain(policy):
    """remat changes memory, not gradients (fp32, 1e-6 absolute)."""
    cfg = tt.DecoderConfig.tiny(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    plain = tt.Decoder(cfg, device="cpu", generator=gen)
    remat = tt.Decoder(dataclasses.replace(cfg, remat=True, remat_policy=policy), device="cpu")
    remat.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(_tokens()[:, :16] % cfg.vocab_size)
    for m in (plain, remat):
        m(tokens).square().mean().backward()
    for (name, a), (_, b) in zip(plain.named_parameters(), remat.named_parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), atol=1e-6, err_msg=name)
