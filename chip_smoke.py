#!/usr/bin/env python3
"""Drive the PyTorch port (``maggy_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --profile  # and a by-kind device breakdown of a step

Phases, each printing one line:

1. device   the card, its power limit, and the build of the CUDA kernels
            from ``maggy_tpu_torch/csrc`` (nvcc, sm_90a) with each source's
            ptxas registers and spill bytes; it fails if any of the three
            Hopper kernels spills or ptxas notes that it serialised its
            wgmma. Three kernels serve both paths: flash attention is the
            one-step ring.
2. kernels  each flash kernel (forward, dQ, dK/dV) against its plain PyTorch
            version, run in fp32 from the same bf16 inputs, on a causal, a
            packed (3 segments per row) and a ragged (S=1000) case at
            B=2, S=2048, H=32, Kh=8, D=128. Device times by CUDA events
            around calls back to back (the median of 5 batches of 10),
            beside the bound (and the share of it reached) and PyTorch's
            own SDPA as a yardstick.
3. model    ``Decoder(llama3_8b(n_layers=4))`` through the kernels: each
            layer's attention output against the plain version on the same
            activations, and the logits against the same weights with
            ``default_attention``, with the plain version, and with a
            planted fault that the logits limit must catch.
4. train    ``Trainer.fit`` for a few AdamW steps at B=2, S=2048 on
            synthetic batches: every loss finite, and each kernel launched
            exactly as often as the layers and remat demand.
5. ring.kernels  each ring step kernel (forward, dQ, dK/dV) against its plain
            version at one rank's shapes of the ring below (B=1, C=2048,
            H=32, Kh=8, D=128): the diagonal step, a past step, the
            finalizing step, the dK/dV accumulators added to, and a packed
            case whose segments cross the chunk boundary; times of a past
            step beside the bound and SDPA on the same chunk pair, and of
            the diagonal forward and dQ steps. Then the LocalRing's
            backward at S=8192: its leaf gradients against the flash
            kernels'.
6. ring.model  ``Decoder(llama3_8b(n_layers=4))`` at B=1, S=8192 attending over
            ``LocalRing(4)``: each layer's ring output against the flash
            kernels on the same q/k/v, the logits against the same weights
            with the flash kernels, and a planted fault (every step taken as
            the diagonal) that the logits limit must catch.
7. ring.train  ``TrainContext.local(ShardingSpec(sp=4))`` and ``Trainer.fit``
            at B=1, S=8192: every loss finite, the ring kernels launched
            exactly as the schedule demands and no flash kernel at all.
8. ring.dist  with two or more cards, one process per card (up to 4) over
            NCCL with a ``ProcessGroupRing``; each takes one step on the same
            batch and weights, and every rank's loss and per-leaf gradient
            norms must match the ``LocalRing`` step's. A planted transport
            fault (the last dK/dV rotation skipped) must land above the
            gradient limit. Each rank then times one more step. With one card
            it reports that it did not run.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before that line. With no CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the smoke's shapes: one layer of the slice's model at B=2, S=2048
B, S, H, KH, D = 2, 2048, 32, 8, 128
RAGGED_S = 1000
N_LAYERS = 4  # Llama-3-8B widths at depth 4: fp32 params + AdamW fit one card
TRAIN_STEPS = 6
# the ring phases: Llama-3-8B widths at depth 4, S=8192 cut into RING_N chunks
RING_N = 4
RING_B, RING_S = 1, 8192
RING_C = RING_S // RING_N
# tolerances, kernel (bf16 in, fp32 accumulate) vs plain version (fp32 math
# on the same bf16 inputs): the LSE stays fp32 but sums in another order; the
# gradients round P and dS to bf16 before their products, as the TPU kernels
# do; O is rounded to bf16, so its max abs error is held to one rounding of
# values below 8 (half an ulp there is 1.6e-2), and its relative L2 to 1e-2
# (the rounding noise is about 2e-3): at S=2048 a typical |O| is only 0.04-
# 0.06, so an error spread over many rows can stay under the max-abs limit
# but not under this one
TOL_O_ABS = 2e-2
TOL_O_REL_L2 = 1e-2
TOL_LSE_ABS = 1e-3
TOL_GRAD_REL_L2 = 2e-2
# the model phase holds each layer's attention output, computed by the
# kernel from the model's own activations, to TOL_O_ABS and TOL_O_REL_L2
# against the plain version on the same q/k/v. The whole model's logits
# (bf16 model, random weights) are held more loosely: every attention output
# differs from another by bf16 roundings, and four layers plus the bf16
# lm_head amplify that to about 1.2-1.4e-2 relative L2 between any two right
# attentions (measured on an H100). A planted fault, the plain version with
# the causal mask left off, must land above this limit, or the run fails: it
# shows that the limit tells a wrong attention from a right one
TOL_LOGITS_REL_L2 = 3e-2
# ring.dist: every rank's loss and each parameter's gradient norm against the
# LocalRing step on the same batch and weights. The ring kernels run the same
# steps on the same chunks in both; what differs is the order of the sums:
# the loss parts and the gradients summed over the ranks, and the weight
# gradients of the projections taken over a [C, d] chunk, not the [S, d]
# sequence, before that sum. On 4 H100s the loss read equal to the last bit
# and the largest per-parameter difference 1.2e-5; the planted fault (the
# last dK/dV rotation skipped) moved a parameter's gradient norm by 1.1e-1
# but the global norm only by 2.8e-3 and the loss not at all
TOL_DIST_LOSS_REL = 1e-6
TOL_DIST_LEAF_GRAD_REL = 1e-4
# H100 SXM dense peaks (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TPU_KERNELS = {
    "flash_fwd": "maggy_tpu/ops/flash.py:135",
    "flash_bwd_dq": "maggy_tpu/ops/flash.py:307",
    "flash_bwd_dkv": "maggy_tpu/ops/flash.py:337",
    "ring_fwd": "maggy_tpu/ops/ring_flash.py:359",
    # _ring_bwd_kernel is one Pallas call; its dQ and dK/dV are two kernels here
    "ring_bwd_dq": "maggy_tpu/ops/ring_flash.py:715",
    "ring_bwd_dkv": "maggy_tpu/ops/ring_flash.py:715",
}
# flash attention is the one-step ring: each flash wrapper launches a ring kernel
SOURCES = {name: f"maggy_tpu_torch/csrc/{name.replace('flash', 'ring')}.cu" for name in TPU_KERNELS}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=float), flush=True)


def time_ms(torch, fn, batches: int = 5, reps: int = 10) -> float:
    """Device time of one call: the median over ``batches`` of the mean of
    ``reps`` calls enqueued back to back between two CUDA events, after two
    warm-up calls. The host's own work for a call (the wrapper's checks, the
    tensor maps, the launch) then runs while the device works on the call
    before, instead of adding to the time as it does when a single call
    stands between the events; the median drops a batch that a pause of the
    host (a collection, an allocation) stretched."""
    fn()
    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def time_sdpa_bwd(torch, q, k, v, do, is_causal: bool) -> float:
    """SDPA's backward alone (dQ, dK and dV in one call) on [B, H, S, D]
    leaves: one forward, then the backward timed again and again."""
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=is_causal, enable_gqa=True)
    return time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_of(source: str) -> dict:
    """The largest register count and the total spill bytes ptxas reported
    for the kernels of ``csrc/<source>.cu`` (every head_dim and output type),
    from the build's own log."""
    from maggy_tpu_torch.ops import _build

    kernels = _build.ptxas_report()[source]["kernels"].values()
    return dict(registers=max(k["registers"] for k in kernels), spill_bytes=sum(k["spill_bytes"] for k in kernels))


def kernel_row(name, ms, plain_ms, work, max_err, library_ms) -> dict:
    """One kernel's line in ``*.times``: its time beside its bound, the share
    of the bound it reaches, and its ptxas registers and spills."""
    b_ms, b_by = bound(*work)
    return dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        tflops=work[0] / ms / 1e9, share_of_bound=b_ms / ms, ptxas=ptxas_of(name.replace("flash", "ring")),
    )


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def make_case(torch, name: str, gen):
    s = RAGGED_S if name == "ragged" else S
    dev = "cuda"

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rand(B, s, H, D), rand(B, s, KH, D), rand(B, s, KH, D)
    do = rand(B, s, H, D)
    segs = None
    if name == "packed":
        # three segments per row with cut points drawn from the generator
        rows = []
        for _ in range(B):
            cuts = sorted(torch.randint(1, s, (2,), generator=gen, device=dev).tolist())
            lens = [cuts[0], cuts[1] - cuts[0], s - cuts[1]]
            lens = [n for n in lens if n > 0]
            rows.append(torch.cat([
                torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(lens)
            ]))
        segs = torch.stack(rows).to(dev)
    return dict(q=q, k=k, v=v, do=do, segs=segs)


def phase_kernels(torch):
    from maggy_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for case in ("causal", "packed", "ragged"):
        c = make_case(torch, case, gen)
        q, k, v, do, segs = c["q"], c["k"], c["v"], c["do"], c["segs"]
        kw = dict(causal=True, segment_ids=segs)
        f32 = [t.float() for t in (q, k, v)]
        o, lse = flash.flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = flash.flash_fwd_reference(*f32, **kw)
        torch.cuda.synchronize()
        err = {
            "o_max_abs": float((o.float() - o_ref).abs().max()),
            "o_rel_l2": rel_l2(o, o_ref),
            "lse_max_abs": float((lse - lse_ref).abs().max()),
        }
        bwd_in = (q, k, v, o, do, lse)
        bwd_ref_in = (*f32, o.float(), do.float(), lse)
        dq = flash.flash_bwd_dq(*bwd_in, **kw)
        dq_ref = flash.flash_dq_reference(*bwd_ref_in, **kw)
        dk, dv = flash.flash_bwd_dkv(*bwd_in, **kw)
        dk_ref, dv_ref = flash.flash_dkv_reference(*bwd_ref_in, **kw)
        torch.cuda.synchronize()
        for name, a, r in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            err[f"{name}_rel_l2"] = rel_l2(a, r)
            err[f"{name}_max_abs"] = float((a.float() - r).abs().max())
        ok = (
            err["o_max_abs"] <= TOL_O_ABS
            and err["o_rel_l2"] <= TOL_O_REL_L2
            and err["lse_max_abs"] <= TOL_LSE_ABS
            and all(err[f"{n}_rel_l2"] <= TOL_GRAD_REL_L2 for n in ("dq", "dk", "dv"))
            and all(torch.isfinite(t).all() for t in (o, lse, dq, dk, dv))
        )
        emit(f"kernels.{case}", ok=ok, **err)
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version ({case}): {err}")
        results[case] = dict(c=c, err=err, o=o, lse=lse)
        del dq_ref, dk_ref, dv_ref, o_ref, lse_ref
        torch.cuda.empty_cache()

    # times at the main path's shapes (causal, S=2048)
    c = results["causal"]["c"]
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    o, lse = results["causal"]["o"], results["causal"]["lse"]
    f32 = [t.float() for t in (q, k, v)]
    bwd_in = (q, k, v, o, do, lse)
    bwd_ref_in = (*f32, o.float(), do.float(), lse)
    ms = {
        "flash_fwd": time_ms(torch, lambda: flash.flash_fwd(q, k, v)),
        "flash_bwd_dq": time_ms(torch, lambda: flash.flash_bwd_dq(*bwd_in)),
        "flash_bwd_dkv": time_ms(torch, lambda: flash.flash_bwd_dkv(*bwd_in)),
    }
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda: flash.flash_fwd_reference(*f32)),
        "flash_bwd_dq": time_ms(torch, lambda: flash.flash_dq_reference(*bwd_ref_in)),
        "flash_bwd_dkv": time_ms(torch, lambda: flash.flash_dkv_reference(*bwd_ref_in)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_fwd_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    sdpa_fwd_bwd_ms = time_ms(torch, sdpa_fwd_bwd)
    sdpa_bwd_ms = time_sdpa_bwd(torch, qg, kg, vg, dot, is_causal=True)

    pairs = B * S * (S + 1) // 2  # (q, k) pairs the causal mask leaves visible
    el = 2  # bf16 bytes
    q_bytes, kv_bytes, lse_bytes = B * S * H * D * el, B * S * KH * D * el, B * H * S * 4
    work = {  # (flops, bytes) of each function, each input read once, each output written once
        "flash_fwd": (4 * D * pairs * H, q_bytes + 2 * kv_bytes + q_bytes + lse_bytes),
        "flash_bwd_dq": (6 * D * pairs * H, 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes),
        "flash_bwd_dkv": (8 * D * pairs * H, 3 * q_bytes + 2 * kv_bytes + lse_bytes + 2 * kv_bytes),
    }
    err_key = {"flash_fwd": "o_max_abs", "flash_bwd_dq": "dq_max_abs", "flash_bwd_dkv": None}
    rows = {}
    for name in ms:
        if err_key[name] is None:
            max_err = max(max(r["err"]["dk_max_abs"], r["err"]["dv_max_abs"]) for r in results.values())
        else:
            max_err = max(r["err"][err_key[name]] for r in results.values())
        # one SDPA backward computes dQ, dK and dV together: it stands beside
        # each of the two backward kernels
        rows[name] = kernel_row(name, ms[name], plain_ms[name], work[name], max_err,
                                sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms)
    emit(
        "kernels.times", shape=dict(B=B, S=S, H=H, KH=KH, D=D, causal=True),
        sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
        ours_fwd_bwd_ms=sum(ms.values()), **{k: v for k, v in rows.items()},
    )
    return rows


def phase_model(torch, n_layers: int, seq: int):
    from maggy_tpu_torch.models import Decoder, DecoderConfig, default_attention
    from maggy_tpu_torch.models.transformer import rope
    from maggy_tpu_torch.ops import flash

    def plain_flash(q, k, v, *, causal=True, segment_ids=None):
        return flash.flash_fwd_reference(q, k, v, causal=causal, segment_ids=segment_ids)[0]

    def planted_fault(q, k, v, *, causal=True, segment_ids=None):
        return plain_flash(q, k, v, causal=False, segment_ids=segment_ids)

    cfg = DecoderConfig.llama3_8b(n_layers=n_layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    model = Decoder(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, seq), generator=gen, device="cuda")
    # each layer's attention input, and the kernel's output on its way to wo;
    # the hooks only read
    seen = []
    hooks = []
    for layer in model.layers:
        hooks.append(layer.attn.register_forward_pre_hook(lambda _m, args: seen.append([args[0], args[1]])))
        hooks.append(layer.attn.wo.register_forward_pre_hook(lambda _m, args: seen[-1].append(args[0])))
    with torch.no_grad():
        n0 = flash.LAUNCHES["flash_fwd"]
        logits = model(tokens)
        launched = flash.LAUNCHES["flash_fwd"] - n0
        for hook in hooks:
            hook.remove()
        # the kernel's output in every layer against the plain version on the
        # same q/k/v, recomputed from the layer's input as Attention does
        attn_errs = []
        shape = (B, seq, -1, cfg.head_dim)
        for layer, (x, positions, out) in zip(model.layers, seen):
            a = layer.attn
            q = rope(a.wq(x).view(shape), positions, cfg.rope_theta)
            k = rope(a.wk(x).view(shape), positions, cfg.rope_theta)
            v = a.wv(x).view(shape)
            ref = plain_flash(q.float(), k.float(), v.float())
            o = out.view(ref.shape)
            attn_errs.append({
                "o_max_abs": float((o.float() - ref).abs().max()), "o_rel_l2": rel_l2(o, ref),
                # TOL_O_ABS is one bf16 rounding only while this stays below 8
                "ref_max_abs": float(ref.abs().max()),
            })
            del q, k, v, ref
        del seen
        # the same weights with other attention: PyTorch's dense reference,
        # the kernels' plain version (fp32 scores, as the kernel keeps), and
        # the planted fault
        refs = {}
        for name, fn in (("default_attention", default_attention), ("plain_version", plain_flash),
                         ("planted_fault", planted_fault)):
            other = Decoder(DecoderConfig.llama3_8b(n_layers=n_layers, attention_fn=fn), device="meta")
            other.load_state_dict(model.state_dict(), assign=True)
            refs[name] = other(tokens)
            del other
    torch.cuda.synchronize()
    errs = {
        "kernel_vs_default_attention": rel_l2(logits, refs["default_attention"]),
        "kernel_vs_plain_version": rel_l2(logits, refs["plain_version"]),
        # the yardstick: two plain attentions on the same weights
        "plain_version_vs_default_attention": rel_l2(refs["plain_version"], refs["default_attention"]),
        # must exceed the limit: a wrong attention
        "planted_fault_vs_plain_version": rel_l2(refs["planted_fault"], refs["plain_version"]),
    }
    ok = (
        tuple(logits.shape) == (B, seq, cfg.vocab_size)
        and logits.dtype == torch.float32
        and bool(torch.isfinite(logits).all())
        and launched == n_layers
        and len(attn_errs) == n_layers
        and all(e["o_max_abs"] <= TOL_O_ABS and e["o_rel_l2"] <= TOL_O_REL_L2 for e in attn_errs)
        and errs["kernel_vs_default_attention"] <= TOL_LOGITS_REL_L2
        and errs["kernel_vs_plain_version"] <= TOL_LOGITS_REL_L2
        and errs["planted_fault_vs_plain_version"] > TOL_LOGITS_REL_L2
    )
    emit(
        "model", ok=ok, shape=list(logits.shape), fwd_launches=launched,
        attention_per_layer=attn_errs, tol_o=dict(max_abs=TOL_O_ABS, rel_l2=TOL_O_REL_L2),
        logits_rel_l2=errs, tol_logits_rel_l2=TOL_LOGITS_REL_L2,
    )
    if not ok:
        raise SystemExit("model phase failed: the kernels' attention or logits disagree with the "
                         "plain attention, or the logits limit let the planted fault through")
    del model, logits, refs
    torch.cuda.empty_cache()


def phase_train(torch, n_layers: int, seq: int, steps: int, card: str, profile: bool):
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    cfg = DecoderConfig.llama3_8b(n_layers=n_layers)
    model = Decoder(cfg, device="meta")
    trainer = Trainer(model, adamw(1e-4), device="cuda")
    data = synthetic_lm_batches(cfg.vocab_size, B, seq, seed=0)
    state = trainer.make_state(0, next(data))
    losses = []

    class Record:
        def broadcast(self, value, step):
            losses.append((step, value))

    state, _ = trainer.step(state, next(data))  # warm-up: first-call set-up stays out of the times
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()
    state, metrics = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    expected = {
        "flash_fwd": 2 * n_layers * steps,  # forward, and again under remat
        "flash_bwd_dq": n_layers * steps,
        "flash_bwd_dkv": n_layers * steps,
    }
    finite = all(math.isfinite(v) for _, v in losses)
    ok = finite and len(losses) == steps and launches == expected
    step_ms = 1e3 / metrics["steps_per_sec"]
    emit(
        "train", ok=ok, steps=steps, losses=[v for _, v in losses],
        grad_norm=metrics["grad_norm"], launches=launches, expected=expected,
        step_ms=step_ms, tokens_per_sec=B * seq * metrics["steps_per_sec"],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card,
    )
    if not ok:
        raise SystemExit(f"train phase failed: losses {losses}, launches {launches} != {expected}")
    if profile:
        profile_steps(torch, trainer, state, data, card, step_ms)
    return launches


def ring_chunks(torch, gen, packed: bool):
    """One rank's operands, rank 1 of a ring: its q chunk and dO, its own KV
    chunk (the diagonal step) and the past chunk 0. With ``packed``, segment
    ids over the two chunks' 2C positions, cut once inside each chunk, so
    the middle segment crosses the boundary: (q's chunk, past chunk)."""
    b, c = RING_B, RING_C

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, do = rand(b, c, H, D), rand(b, c, H, D)
    own = (rand(b, c, KH, D), rand(b, c, KH, D))
    past = (rand(b, c, KH, D), rand(b, c, KH, D))
    segs = (None, None)
    if packed:
        cuts = torch.randint(1, c, (2,), generator=gen, device="cuda").tolist()
        pos = torch.arange(2 * c, device="cuda")
        ids = ((pos >= cuts[0]).int() + (pos >= c + cuts[1]).int())[None].repeat(b, 1)
        segs = (ids[:, c:].contiguous(), ids[:, :c].contiguous())
    return q, do, own, past, segs


def ring_state(torch, o_dtype):
    """Fresh (acc, m, l, o, lse) of one rank's chunk."""
    f32 = dict(dtype=torch.float32, device="cuda")
    return [torch.empty(RING_B, RING_C, H, D, **f32), torch.empty(RING_B, H, RING_C, **f32),
            torch.empty(RING_B, H, RING_C, **f32), torch.empty(RING_B, RING_C, H, D, dtype=o_dtype, device="cuda"),
            torch.empty(RING_B, H, RING_C, **f32)]


def phase_ring_kernels(torch):
    """Each ring step kernel against its plain version (fp32, same bf16
    inputs, same fp32 state), then the times of a past step."""
    from maggy_tpu_torch.ops import ring_flash as rf

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    f32 = lambda t: t.float()  # noqa: E731
    cases = {}
    for case in ("plain", "packed"):
        q, do, (k0, v0), (k1, v1), (qs, ps) = ring_chunks(torch, gen, case == "packed")
        kern, ref = ring_state(torch, torch.bfloat16), ring_state(torch, torch.float32)
        err = {}

        def step(kw, k, v):
            rf.ring_fwd(q, k, v, *kern, **kw)
            rf.ring_fwd_step_reference(f32(q), f32(k), f32(v), *ref, **kw)

        def state_err(name):
            # acc and l are O's numerator and denominator: O's relative limit
            err[f"{name}_acc_rel_l2"] = rel_l2(kern[0], ref[0])
            err[f"{name}_l_rel_l2"] = rel_l2(kern[2], ref[2])
            err[f"{name}_m_max_abs"] = float((kern[1] - ref[1]).abs().max())

        # the diagonal: the rank's first step, on its own chunk
        step(dict(diagonal=True, first=True, finalize_step=False, q_segs=qs, k_segs=qs), k0, v0)
        state_err("diagonal")
        after_diagonal = [t.clone() for t in ref[:3]]
        # a past step from that state, kept; then the same step finalized
        for finalize in (False, True):
            for i in range(3):
                kern[i].copy_(after_diagonal[i])
                ref[i].copy_(after_diagonal[i])
            step(dict(diagonal=False, first=False, finalize_step=finalize, q_segs=qs, k_segs=ps), k1, v1)
            if not finalize:
                state_err("past")
        o, lse = kern[3], kern[4]
        err["finalize_o_max_abs"] = float((o.float() - ref[3]).abs().max())
        err["finalize_o_rel_l2"] = rel_l2(o, ref[3])
        err["finalize_lse_max_abs"] = float((lse - ref[4]).abs().max())
        # the backward of both steps: one dq, and each chunk's dK/dV
        dq, dq_ref = (torch.empty(RING_B, RING_C, H, D, device="cuda") for _ in range(2))
        dkv, dkv_ref = ([[torch.empty(RING_B, RING_C, KH, D, device="cuda") for _ in range(2)]
                         for _ in range(2)] for _ in range(2))
        for i, (k, v, kseg, diagonal) in enumerate(((k0, v0, qs, True), (k1, v1, ps, False))):
            kw = dict(diagonal=diagonal, first=i == 0, q_segs=qs, k_segs=kseg)
            rf.ring_bwd_dq(q, k, v, o, do, lse, dq, **kw)
            rf.ring_dq_step_reference(f32(q), f32(k), f32(v), f32(o), f32(do), lse, dq_ref, **kw)
            kw["first"] = True  # each chunk's accumulators start at its own step
            rf.ring_bwd_dkv(q, k, v, o, do, lse, *dkv[i], **kw)
            rf.ring_dkv_step_reference(f32(q), f32(k), f32(v), f32(o), f32(do), lse, *dkv_ref[i], **kw)
        # the read-add-write of dK/dV (first=False, as on every later step of
        # a chunk): the past step added into the diagonal step's accumulators
        dkv.append([t.clone() for t in dkv[0]])
        dkv_ref.append([t.clone() for t in dkv_ref[0]])
        kw = dict(diagonal=False, first=False, q_segs=qs, k_segs=ps)
        rf.ring_bwd_dkv(q, k1, v1, o, do, lse, *dkv[2], **kw)
        rf.ring_dkv_step_reference(f32(q), f32(k1), f32(v1), f32(o), f32(do), lse, *dkv_ref[2], **kw)
        torch.cuda.synchronize()
        err["dq_rel_l2"] = rel_l2(dq, dq_ref)
        err["dq_max_abs"] = float((dq - dq_ref).abs().max())
        for i, chunk in enumerate(("own", "past", "added")):
            for j, name in enumerate(("dk", "dv")):
                err[f"{name}_{chunk}_rel_l2"] = rel_l2(dkv[i][j], dkv_ref[i][j])
                err[f"{name}_{chunk}_max_abs"] = float((dkv[i][j] - dkv_ref[i][j]).abs().max())
        ok = (
            all(err[f"{n}_{x}_rel_l2"] <= TOL_O_REL_L2 for n in ("diagonal", "past") for x in ("acc", "l"))
            and all(err[f"{n}_m_max_abs"] <= TOL_LSE_ABS for n in ("diagonal", "past"))
            and err["finalize_o_max_abs"] <= TOL_O_ABS and err["finalize_o_rel_l2"] <= TOL_O_REL_L2
            and err["finalize_lse_max_abs"] <= TOL_LSE_ABS
            and all(v <= TOL_GRAD_REL_L2 for n, v in err.items()
                    if n.split("_")[0] in ("dq", "dk", "dv") and n.endswith("rel_l2"))
            and all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, *sum(dkv, [])))
        )
        emit(f"ring.kernels.{case}", ok=ok, **err)
        if not ok:
            raise SystemExit(f"a ring kernel disagrees with its plain version ({case}): {err}")
        cases[case] = dict(q=q, do=do, kv=((k0, v0), (k1, v1)), o=o, lse=lse, err=err)
        del ref, dq_ref, dkv_ref
        torch.cuda.empty_cache()

    # times at one rank's shapes: a past step (every pair visible; 6 of the
    # 10 steps per attention call at n=4), and the diagonal forward and dQ
    # steps (the other 4)
    c = cases["plain"]
    q, do, ((k0, v0), (k1, v1)), o, lse = c["q"], c["do"], c["kv"], c["o"], c["lse"]
    acc, m, l, o_buf, lse_buf = ring_state(torch, torch.bfloat16)
    rf.ring_fwd(q, k0, v0, acc, m, l, o_buf, lse_buf, diagonal=True, first=True, finalize_step=False)
    dq = torch.zeros(RING_B, RING_C, H, D, device="cuda")
    dk, dv = (torch.zeros(RING_B, RING_C, KH, D, device="cuda") for _ in range(2))
    fq, fk, fv, fo, fdo = (t.float() for t in (q, k1, v1, o, do))
    acc_r, m_r, l_r, dq_r, dk_r, dv_r = (t.clone() for t in (acc, m, l, dq, dk, dv))
    past = dict(diagonal=False, first=False)
    ms = {
        "ring_fwd": time_ms(torch, lambda: rf.ring_fwd(q, k1, v1, acc, m, l, o_buf, lse_buf,
                                                        finalize_step=False, **past)),
        "ring_bwd_dq": time_ms(torch, lambda: rf.ring_bwd_dq(q, k1, v1, o, do, lse, dq, **past)),
        "ring_bwd_dkv": time_ms(torch, lambda: rf.ring_bwd_dkv(q, k1, v1, o, do, lse, dk, dv, **past)),
    }
    diagonal_fwd_ms = time_ms(torch, lambda: rf.ring_fwd(q, k0, v0, acc, m, l, o_buf, lse_buf, diagonal=True,
                                                          first=False, finalize_step=False))
    diagonal_dq_ms = time_ms(torch, lambda: rf.ring_bwd_dq(q, k0, v0, o, do, lse, dq, diagonal=True, first=False))
    plain_ms = {
        "ring_fwd": time_ms(torch, lambda: rf.ring_fwd_step_reference(
            fq, fk, fv, acc_r, m_r, l_r, None, None, finalize_step=False, **past)),
        "ring_bwd_dq": time_ms(torch, lambda: rf.ring_dq_step_reference(fq, fk, fv, fo, fdo, lse, dq_r, **past)),
        "ring_bwd_dkv": time_ms(torch, lambda: rf.ring_dkv_step_reference(
            fq, fk, fv, fo, fdo, lse, dk_r, dv_r, **past)),
    }
    # SDPA on the same chunk pair, no mask: the forward, and the backward alone
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k1, v1, do))
    sdpa_fwd_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
    sdpa_bwd_ms = time_sdpa_bwd(torch, qg, kg, vg, dot, is_causal=False)
    kt0, vt0 = (t.transpose(1, 2) for t in (k0, v0))
    sdpa_diagonal_fwd_ms = time_ms(torch, lambda: sdpa(qt, kt0, vt0, is_causal=True, enable_gqa=True))
    kg0, vg0 = (t.detach().clone().requires_grad_(True) for t in (kt0, vt0))
    sdpa_diagonal_bwd_ms = time_sdpa_bwd(torch, qg, kg0, vg0, dot, is_causal=True)

    pairs = RING_B * RING_C * RING_C  # a past step: every pair visible
    el = 2
    q_bytes, kv_bytes = RING_B * RING_C * H * D * el, RING_B * RING_C * KH * D * el
    acc_bytes, row_bytes = RING_B * RING_C * H * D * 4, RING_B * H * RING_C * 4
    work = {  # (flops, bytes): inputs read once, outputs written once; fp32 state read and written
        "ring_fwd": (4 * D * pairs * H, q_bytes + 2 * kv_bytes + 2 * (acc_bytes + 2 * row_bytes)),
        "ring_bwd_dq": (6 * D * pairs * H, 3 * q_bytes + 2 * kv_bytes + row_bytes + 2 * acc_bytes),
        "ring_bwd_dkv": (8 * D * pairs * H, 3 * q_bytes + 2 * kv_bytes + row_bytes + 4 * (2 * kv_bytes)),
    }
    diag_pairs = RING_B * RING_C * (RING_C + 1) // 2
    diagonal_bound = bound(4 * D * diag_pairs * H, work["ring_fwd"][1])[0]
    diagonal_dq_bound = bound(6 * D * diag_pairs * H, work["ring_bwd_dq"][1])[0]
    max_err = {
        "ring_fwd": max(r["err"]["finalize_o_max_abs"] for r in cases.values()),
        "ring_bwd_dq": max(r["err"]["dq_max_abs"] for r in cases.values()),
        "ring_bwd_dkv": max(v for r in cases.values() for n, v in r["err"].items()
                            if n[:3] in ("dk_", "dv_") and n.endswith("max_abs")),
    }
    # one SDPA backward computes dQ, dK and dV: it stands beside both backward kernels
    rows = {name: kernel_row(name, ms[name], plain_ms[name], work[name], max_err[name],
                             sdpa_fwd_ms if name == "ring_fwd" else sdpa_bwd_ms) for name in ms}
    emit(
        "ring.kernels.times", shape=dict(B=RING_B, C=RING_C, H=H, KH=KH, D=D, step="past"),
        sdpa_fwd_ms=sdpa_fwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
        diagonal_fwd=dict(ms=diagonal_fwd_ms, bound_ms=diagonal_bound, share_of_bound=diagonal_bound / diagonal_fwd_ms,
                          sdpa_causal_fwd_ms=sdpa_diagonal_fwd_ms),
        # SDPA's causal backward computes dQ, dK and dV together
        diagonal_dq=dict(ms=diagonal_dq_ms, bound_ms=diagonal_dq_bound,
                         share_of_bound=diagonal_dq_bound / diagonal_dq_ms, sdpa_causal_bwd_ms=sdpa_diagonal_bwd_ms),
        **rows,
    )
    del cases, acc, m, l, o_buf, lse_buf, dq, dk, dv, acc_r, m_r, l_r, dq_r, dk_r, dv_r, qg, kg, vg, kg0, vg0
    torch.cuda.empty_cache()
    local_ring_grads(torch, gen)
    return rows


def local_ring_grads(torch, gen):
    """The LocalRing's schedule at the main path's shapes: output and leaf
    gradients of ``ring_attention`` over ``LocalRing(RING_N)`` against
    ``flash_attention`` on the same q/k/v and dO (B=1, S=8192). A step
    left out, taken twice, or folded into the wrong chunk's dK/dV moves a
    gradient by about a chunk's share, far above the limits."""
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.parallel import LocalRing, ring_attention

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rand(RING_B, RING_S, H, D), rand(RING_B, RING_S, KH, D), rand(RING_B, RING_S, KH, D), \
        rand(RING_B, RING_S, H, D)
    got = {}
    for name, fn in (("ring", lambda *t: ring_attention(*t, ring=LocalRing(RING_N))),
                     ("flash", flash.flash_attention)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        got[name] = [out.detach()] + [t.grad for t in leaves]
    torch.cuda.synchronize()
    err = {f"{n}_rel_l2": rel_l2(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"), got["ring"], got["flash"])}
    ok = err["o_rel_l2"] <= TOL_O_REL_L2 and all(err[f"{n}_rel_l2"] <= TOL_GRAD_REL_L2 for n in ("dq", "dk", "dv"))
    emit("ring.kernels.local_ring_grads", ok=ok, shape=dict(B=RING_B, S=RING_S, ring=RING_N), **err)
    if not ok:
        raise SystemExit(f"LocalRing's backward disagrees with the flash kernels': {err}")


def planted_fault_ring(n: int):
    """Planted fault for ``ring.model``: a LocalRing whose every step is
    taken as the diagonal, so each past chunk is masked as if it were
    aligned with the q chunk (the chunk offsets are lost)."""
    from maggy_tpu_torch.parallel import LocalRing

    class AllDiagonal(LocalRing):
        def visits(self, my, causal):
            return [(s, src, causal) for s, src, _ in super().visits(my, causal)]

    return AllDiagonal(n)


def phase_ring_model(torch, n_layers: int, seq: int):
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.models.transformer import auto_attention, rope
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.ops import ring_flash as rf
    from maggy_tpu_torch.parallel import LocalRing, make_ring_attention

    cfg = DecoderConfig.llama3_8b(n_layers=n_layers, attention_fn=make_ring_attention(LocalRing(RING_N)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    model = Decoder(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (RING_B, seq), generator=gen, device="cuda")
    seen, hooks = [], []
    for layer in model.layers:
        hooks.append(layer.attn.register_forward_pre_hook(lambda _m, args: seen.append([args[0], args[1]])))
        hooks.append(layer.attn.wo.register_forward_pre_hook(lambda _m, args: seen[-1].append(args[0])))
    with torch.no_grad():
        rf.reset_launches()
        logits = model(tokens)
        launched = rf.LAUNCHES["ring_fwd"]
        for hook in hooks:
            hook.remove()
        # the ring's output in every layer against the flash kernels on the
        # same q/k/v, recomputed from the layer's input as Attention does
        attn_errs = []
        shape = (RING_B, seq, -1, cfg.head_dim)
        for layer, (x, positions, out) in zip(model.layers, seen):
            a = layer.attn
            q = rope(a.wq(x).view(shape), positions, cfg.rope_theta)
            k = rope(a.wk(x).view(shape), positions, cfg.rope_theta)
            ref = flash.flash_attention(q, k, a.wv(x).view(shape))
            o = out.view(ref.shape)
            attn_errs.append({"o_max_abs": float((o.float() - ref.float()).abs().max()),
                              "o_rel_l2": rel_l2(o, ref), "ref_max_abs": float(ref.float().abs().max())})
            del q, k, ref
        del seen
        refs = {}
        for name, fn in (("flash_kernels", auto_attention),
                         ("planted_fault", make_ring_attention(planted_fault_ring(RING_N)))):
            other = Decoder(DecoderConfig.llama3_8b(n_layers=n_layers, attention_fn=fn), device="meta")
            other.load_state_dict(model.state_dict(), assign=True)
            refs[name] = other(tokens)
            del other
    torch.cuda.synchronize()
    errs = {
        "ring_vs_flash_kernels": rel_l2(logits, refs["flash_kernels"]),
        # must exceed the limit: the chunk offsets lost
        "planted_fault_vs_flash_kernels": rel_l2(refs["planted_fault"], refs["flash_kernels"]),
    }
    steps = RING_N * (RING_N + 1) // 2
    ok = (
        tuple(logits.shape) == (RING_B, seq, cfg.vocab_size)
        and bool(torch.isfinite(logits).all())
        and launched == n_layers * steps
        and len(attn_errs) == n_layers
        and all(e["o_max_abs"] <= TOL_O_ABS and e["o_rel_l2"] <= TOL_O_REL_L2 for e in attn_errs)
        and errs["ring_vs_flash_kernels"] <= TOL_LOGITS_REL_L2
        and errs["planted_fault_vs_flash_kernels"] > TOL_LOGITS_REL_L2
    )
    emit(
        "ring.model", ok=ok, shape=list(logits.shape), ring=RING_N, ring_fwd_launches=launched,
        attention_per_layer=attn_errs, tol_o=dict(max_abs=TOL_O_ABS, rel_l2=TOL_O_REL_L2),
        logits_rel_l2=errs, tol_logits_rel_l2=TOL_LOGITS_REL_L2,
    )
    if not ok:
        raise SystemExit("ring.model failed: the ring's attention or logits disagree with the flash "
                         "kernels, or the logits limit let the planted fault through")
    del model, logits, refs
    torch.cuda.empty_cache()


def ring_trainer(torch, ctx, n_layers: int, seq: int, attention_ring=None):
    """A trainer of ``llama3_8b(n_layers)`` over ``ctx``'s ring (the model
    attends over ``attention_ring`` if given), and its synthetic batches (the
    same global batches on every rank)."""
    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.parallel import make_ring_attention
    from maggy_tpu_torch.train import adamw, synthetic_lm_batches

    ring = ctx.ring if attention_ring is None else attention_ring
    cfg = DecoderConfig.llama3_8b(n_layers=n_layers, attention_fn=make_ring_attention(ring))
    trainer = ctx.trainer(Decoder(cfg, device="meta"), adamw(1e-4))
    return trainer, synthetic_lm_batches(cfg.vocab_size, RING_B, seq, seed=0)


def leaf_grad_norms(torch, model):
    """Each parameter's gradient norm, in parameter order."""
    return torch.stack([p.grad.float().norm() for p in model.parameters()]).tolist()


def phase_ring_train(torch, n_layers: int, seq: int, steps: int, card: str, profile: bool):
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.ops import ring_flash as rf
    from maggy_tpu_torch.parallel import ShardingSpec
    from maggy_tpu_torch.train import TrainContext

    ctx = TrainContext.local(ShardingSpec(sp=RING_N))
    trainer, data = ring_trainer(torch, ctx, n_layers, seq)
    state = trainer.make_state(0, next(data))
    losses = []

    class Record:
        def broadcast(self, value, step):
            losses.append((step, value))

    state, _ = trainer.step(state, next(data))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()
    rf.reset_launches()
    state, metrics = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0)
    torch.cuda.synchronize()
    launches = {**flash.LAUNCHES, **rf.LAUNCHES}
    per_call = RING_N * (RING_N + 1) // 2  # causal: each rank skips its future chunks
    expected = {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "ring_fwd": 2 * n_layers * per_call * steps,  # forward, and again under remat
        "ring_bwd_dq": n_layers * per_call * steps,
        "ring_bwd_dkv": n_layers * per_call * steps,
    }
    finite = all(math.isfinite(v) for _, v in losses)
    ok = finite and len(losses) == steps and launches == expected
    step_ms = 1e3 / metrics["steps_per_sec"]
    emit(
        "ring.train", ok=ok, ring=RING_N, steps=steps, losses=[v for _, v in losses],
        grad_norm=metrics["grad_norm"], launches=launches, expected=expected,
        step_ms=step_ms, tokens_per_sec=RING_B * seq * metrics["steps_per_sec"],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, card=card,
    )
    if not ok:
        raise SystemExit(f"ring.train failed: losses {losses}, launches {launches} != {expected}")
    if profile:
        profile_steps(torch, trainer, state, data, card, step_ms, phase="ring.train.profile")
    return launches


def planted_fault_process_ring():
    """Planted fault for ``ring.dist``: a ProcessGroupRing whose backward
    skips the last rotation of dK/dV, so each rank keeps the accumulators of
    its right neighbour's chunk instead of taking its own home. The loss is
    untouched; the gradients of wk and wv (and below them) are not."""
    from maggy_tpu_torch.parallel import ProcessGroupRing

    class KeepLastDkv(ProcessGroupRing):
        def backward(self, *args):
            self.rotations = 0
            try:
                return super().backward(*args)
            finally:
                self.rotations = None

        def _rotate(self, send, recv):
            if getattr(self, "rotations", None) is not None:
                # the backward rotates k/v n-1 times and dK/dV n times; the last is dK/dV home
                self.rotations += 1
                if self.rotations == 2 * self.size - 1:
                    for out, into in zip(send, recv):
                        into.copy_(out)
                    return None
            return super()._rotate(send, recv)

    return KeepLastDkv()


def _ring_dist_rank(rank: int, n: int, port: int, n_layers: int, seq: int, out) -> None:
    """One rank of ``ring.dist``: its own card, NCCL, a ProcessGroupRing, one
    step on the global batch, then one more step timed; then the planted
    fault's step from the same weights. Puts (rank, result) or (rank,
    "error", traceback) on ``out``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        sys.path.insert(0, REPO)
        from maggy_tpu_torch.ops import ring_flash as rf
        from maggy_tpu_torch.parallel import ShardingSpec
        from maggy_tpu_torch.train import TrainContext

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
        ctx = TrainContext.create(ShardingSpec(sp=n))
        result = {}
        for name, ring in (("ring", None), ("planted_fault", planted_fault_process_ring())):
            trainer, data = ring_trainer(torch, ctx, n_layers, seq, attention_ring=ring)
            batch = next(data)
            state = trainer.make_state(0, batch)
            rf.reset_launches()
            state, metrics = trainer.step(state, ctx.shard_batch(batch))
            result[name] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                                leaf_grad_norms=leaf_grad_norms(torch, state.model), launches=dict(rf.LAUNCHES))
            if ring is None:  # a second step, timed: the first carries the set-up
                shard = ctx.shard_batch(next(data))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step(state, shard)
                torch.cuda.synchronize()
                result["step_ms"] = (time.perf_counter() - t0) * 1e3
            del trainer, state, metrics
            torch.cuda.empty_cache()
        out.put((rank, result))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _max_rel(got, want) -> float:
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def phase_ring_dist(torch, n_layers: int, seq: int, card: str) -> None:
    """The NCCL ring across cards, against the LocalRing step."""
    import multiprocessing
    import socket

    cards = torch.cuda.device_count()
    if cards < 2:
        emit("ring.dist", ran=False, cards=cards)
        return
    from maggy_tpu_torch.parallel import ShardingSpec
    from maggy_tpu_torch.train import TrainContext

    n = 4 if cards >= 4 else 2  # S=8192 cuts evenly into 2 or 4 chunks
    ctx = TrainContext.local(ShardingSpec(sp=n))
    trainer, data = ring_trainer(torch, ctx, n_layers, seq)
    batch = next(data)
    state = trainer.make_state(0, batch)
    state, metrics = trainer.step(state, batch)
    want = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                leaf_grad_norms=leaf_grad_norms(torch, state.model))
    del trainer, state, metrics
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp = multiprocessing.get_context("spawn")
    out = mp.Queue()
    procs = [mp.Process(target=_ring_dist_rank, args=(r, n, port, n_layers, seq, out)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        results = sorted((out.get(timeout=300) for _ in range(n)), key=lambda r: r[0])
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r in results if r[1] == "error"]
    if failed:
        raise SystemExit(f"ring.dist: rank {failed[0][0]} failed:\n{failed[0][2]}")
    ranks = []
    ok = True
    for rank, res in results:
        visits = rank + 1  # causal: rank r computes r + 1 of the n steps
        expected = {"ring_fwd": 2 * n_layers * visits, "ring_bwd_dq": n_layers * visits,
                    "ring_bwd_dkv": n_layers * visits}
        row = dict(rank=rank, step_ms=res["step_ms"])
        for name in ("ring", "planted_fault"):
            r = res[name]
            row[name] = dict(loss=r["loss"], grad_norm=r["grad_norm"], launches=r["launches"],
                             loss_rel=abs(r["loss"] - want["loss"]) / abs(want["loss"]),
                             leaf_grad_max_rel=_max_rel(r["leaf_grad_norms"], want["leaf_grad_norms"]))
        ranks.append(row)
        good, fault = row["ring"], row["planted_fault"]
        ok = ok and good["launches"] == expected and fault["launches"] == expected \
            and good["loss_rel"] <= TOL_DIST_LOSS_REL and good["leaf_grad_max_rel"] <= TOL_DIST_LEAF_GRAD_REL \
            and fault["leaf_grad_max_rel"] > TOL_DIST_LEAF_GRAD_REL
    emit("ring.dist", ran=True, ok=ok, cards=cards, ring=n, local_ring_loss=want["loss"],
         local_ring_grad_norm=want["grad_norm"], leaves=len(want["leaf_grad_norms"]), ranks=ranks,
         tol=dict(loss_rel=TOL_DIST_LOSS_REL, leaf_grad_rel=TOL_DIST_LEAF_GRAD_REL), card=card)
    if not ok:
        raise SystemExit("ring.dist failed: a rank's loss, gradients or launches disagree with the LocalRing "
                         "step, or the gradient limit let the planted fault through")


def _category(name: str) -> str:
    low = name.lower()
    # the three attention kernels, whether a flash or a ring wrapper launched them
    for key in ("ring_fwd_kernel", "ring_dq_kernel", "ring_dkv_kernel"):
        if key in name:
            return key
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer_and_grad_norm"
    if "softmax" in low or "nll" in low or "gather" in low or "scatter" in low:
        return "loss"
    return "other"


def profile_steps(torch, trainer, state, data, card: str, step_ms: float, n: int = 2,
                  phase: str = "train.profile") -> None:
    """Device time by kind of kernel over ``n`` train steps (torch.profiler),
    and the device's idle share of the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = trainer.step(state, next(data))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cats, top = {}, []
    for evt in prof.key_averages():
        # kernels only: a user annotation (e.g. "Optimizer.step#AdamW.step")
        # is also timed on the device and would count its kernels twice
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        ms = evt.self_device_time_total / 1e3 / n
        if ms <= 0:
            continue
        cats[_category(evt.key)] = cats.get(_category(evt.key), 0.0) + ms
        top.append((ms, evt.key[:80], evt.count // n))
    busy = sum(cats.values())
    top.sort(reverse=True)
    emit(
        phase, steps=n, device_ms_per_step=busy,
        # the profiler's own host work slows the profiled steps, so the idle
        # share is read against the unprofiled step time of the fit
        wall_ms_per_step_profiled=wall_ms / n, idle_share=1.0 - busy / step_ms,
        by_kind_ms=cats,
        top_kernels=[dict(ms=m, name=k, launches=c) for m, k, c in top[:12]], card=card,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each train phase, profile two steps by kind of kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from maggy_tpu_torch.ops import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.build()
    # every source is a Hopper design (wgmma from a TMA-fed ring): none may
    # spill, and ptxas may not serialise its wgmma for want of registers
    ptxas = {src: ptxas_of(src) for src in _build.KERNELS}
    notes = {src: r["notes"] for src, r in _build.ptxas_report().items() if r["notes"]}
    spills = {src: p["spill_bytes"] for src, p in ptxas.items() if p["spill_bytes"]}
    serialised = [n for lines in notes.values() for n in lines if "wgmma" in n and "serializ" in n.lower()]
    emit(
        "device", ok=not spills and not serialised, name=torch.cuda.get_device_name(0), card=card,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=time.perf_counter() - t0, ptxas=ptxas, ptxas_notes=notes,
    )
    if spills or serialised:
        raise SystemExit(f"a Hopper kernel spills registers (bytes: {spills}) or has its wgmma serialised: "
                         f"{serialised}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rows = phase_kernels(torch)
    phase_model(torch, N_LAYERS, S)
    launches = phase_train(torch, N_LAYERS, S, TRAIN_STEPS, card, args.profile)
    rows.update(phase_ring_kernels(torch))
    phase_ring_model(torch, N_LAYERS, RING_S)
    ring_launches = phase_ring_train(torch, N_LAYERS, RING_S, TRAIN_STEPS, card, args.profile)
    launches.update({k: v for k, v in ring_launches.items() if k.startswith("ring_")})
    phase_ring_dist(torch, N_LAYERS, RING_S, card)

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
             launches=launches[name],
             **{k: v for k, v in rows[name].items() if k not in ("tflops", "share_of_bound", "ptxas")})
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
