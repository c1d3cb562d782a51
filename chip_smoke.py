#!/usr/bin/env python3
"""Drive the PyTorch port (``maggy_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --profile  # and a by-kind device breakdown of a step

Phases, each printing one line:

1. device   the card, its power limit, and the build of the CUDA kernels
            from ``maggy_tpu_torch/csrc`` (nvcc, sm_90a).
2. kernels  each flash kernel (forward, dQ, dK/dV) against its plain PyTorch
            version, run in fp32 from the same bf16 inputs, on a causal, a
            packed (3 segments per row) and a ragged (S=1000) case at
            B=2, S=2048, H=32, Kh=8, D=128. Times by CUDA events (median of
            10), beside the bound and PyTorch's own SDPA as a yardstick.
3. model    ``Decoder(llama3_8b(n_layers=4))`` through the kernels: each
            layer's attention output against the plain version on the same
            activations, and the logits against the same weights with
            ``default_attention``, with the plain version, and with a
            planted fault that the logits limit must catch.
4. train    ``Trainer.fit`` for a few AdamW steps at B=2, S=2048 on
            synthetic batches: every loss finite, and each kernel launched
            exactly as often as the layers and remat demand.

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
# H100 SXM dense peaks (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TPU_KERNELS = {
    "flash_fwd": "maggy_tpu/ops/flash.py:135",
    "flash_bwd_dq": "maggy_tpu/ops/flash.py:307",
    "flash_bwd_dkv": "maggy_tpu/ops/flash.py:337",
}
SOURCES = {
    "flash_fwd": "maggy_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "maggy_tpu_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "maggy_tpu_torch/csrc/flash_bwd_dkv.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=float), flush=True)


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
        b_ms, b_by = bound(*work[name])
        rows[name] = dict(
            max_abs_err=max_err, ms=ms[name], plain_ms=plain_ms[name],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=sdpa_fwd_ms if name == "flash_fwd" else None,
            tflops=work[name][0] / ms[name] / 1e9,
        )
    emit(
        "kernels.times", shape=dict(B=B, S=S, H=H, KH=KH, D=D, causal=True),
        sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
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


def _category(name: str) -> str:
    low = name.lower()
    for kernel, key in (("flash_fwd", "fwd_kernel"), ("flash_bwd_dq", "dq_kernel"),
                        ("flash_bwd_dkv", "dkv_kernel")):
        if key in name:
            return kernel
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer_and_grad_norm"
    if "softmax" in low or "nll" in low or "gather" in low or "scatter" in low:
        return "loss"
    return "other"


def profile_steps(torch, trainer, state, data, card: str, step_ms: float, n: int = 2) -> None:
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
        "train.profile", steps=n, device_ms_per_step=busy,
        # the profiler's own host work slows the profiled steps, so the idle
        # share is read against the unprofiled step time of the fit
        wall_ms_per_step_profiled=wall_ms / n, idle_share=1.0 - busy / step_ms,
        by_kind_ms=cats,
        top_kernels=[dict(ms=m, name=k, launches=c) for m, k, c in top[:12]], card=card,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the train phase, profile two steps by kind of kernel")
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
    emit(
        "device", name=torch.cuda.get_device_name(0), card=card,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=time.perf_counter() - t0, ptxas=_build.build_info.get("ptxas"),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rows = phase_kernels(torch)
    phase_model(torch, N_LAYERS, S)
    launches = phase_train(torch, N_LAYERS, S, TRAIN_STEPS, card, args.profile)

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
             launches=launches[name], **{k: v for k, v in rows[name].items() if k != "tflops"})
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
