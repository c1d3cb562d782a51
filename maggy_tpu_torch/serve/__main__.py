"""Serving CLI: load a checkpoint onto a card and serve it over RPC.

The port's counterpart of ``python -m maggy_tpu.serve``, with the same
flags plus ``--device`` (default: the current CUDA card; ``cpu`` serves on
the CPU)::

    python -m maggy_tpu_torch.serve --config tiny --slots 8 --device cpu
    python -m maggy_tpu_torch.serve --config llama3_8b --checkpoint /ckpts/run7 \\
        --slots 16 --port 7777

Without ``--checkpoint`` the model is randomly initialized on the device
(``--seed``) — the demo/smoke path. The process prints the address and the
RPC secret on stderr; point clients
(:class:`maggy_tpu_torch.serve.ServeClient`) at it. SIGTERM stops the
scheduler (or the router and its replicas) and the RPC server and exits 0.
With ``--exp-dir`` the engine's telemetry lands in
``<exp_dir>/telemetry/worker_serve.jsonl``.

``--replicas N`` (N > 1) or ``--prefill-replicas M`` serves a fleet: a
:class:`~maggy_tpu_torch.serve.fleet.Router` on the address over N decode
replicas (plus M prefill replicas), leasing cards round-robin and sharing
one copy of the serving weights per card::

    python -m maggy_tpu_torch.serve --config llama3_8b --replicas 2 --prefill-replicas 1

Not ported yet, and refused before anything loads: a ``--mesh`` other than
``none`` (ROADMAP queue 1 item 7g; ``auto`` consults the tuner, item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time


def build_config(name: str, max_seq_len=None):
    """A ``DecoderConfig`` from a preset name or a JSON file of overrides
    (``dtype``/``param_dtype`` spelled as torch dtype names, e.g.
    ``"float32"``)."""
    import torch

    from maggy_tpu_torch.models import DecoderConfig

    presets = {"tiny": DecoderConfig.tiny, "llama3_8b": DecoderConfig.llama3_8b}
    if name.endswith(".json"):
        with open(name) as f:
            fields = json.load(f)
        for key in ("dtype", "param_dtype"):
            if isinstance(fields.get(key), str):
                fields[key] = getattr(torch, fields[key])
        cfg = DecoderConfig(**fields)
    elif name in presets:
        cfg = presets[name]()
    else:
        raise SystemExit(
            f"unknown --config {name!r}: use {sorted(presets)} or a "
            ".json file of DecoderConfig fields"
        )
    if max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    return cfg


def load_or_init_params(cfg, checkpoint=None, step=None, seed=0, device=None):
    """The parameters as a ``state_dict`` on ``device``: a params-only
    restore through the port's :class:`~maggy_tpu_torch.train.checkpoint.
    Checkpointer`, or a ``Decoder`` initialised on the device from
    ``seed`` for checkpoint-free demo serving."""
    import torch

    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.util import resolve_device

    dev = resolve_device(device)
    if checkpoint:
        from maggy_tpu_torch.train.checkpoint import Checkpointer

        params = Checkpointer(checkpoint, async_save=False).restore_params(step)
        return {name: t.to(dev) for name, t in params.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Decoder(cfg, device=dev, generator=gen).state_dict()


def _refuse_unported(args) -> None:
    if args.mesh == "auto":
        raise NotImplementedError(
            "--mesh auto consults the tuner, which is not ported yet (ROADMAP queue 1 item 9)"
        )
    if args.mesh and args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: a sharded engine is not ported yet (ROADMAP queue 1 item 7g)"
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m maggy_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config", default="tiny",
                        help="DecoderConfig preset name or .json file")
    parser.add_argument("--checkpoint", help="Checkpointer directory to restore")
    parser.add_argument("--step", type=int, help="checkpoint step (default latest)")
    parser.add_argument("--slots", type=int, default=4,
                        help="KV-cache slots = max concurrent requests")
    parser.add_argument("--mesh", default="none",
                        help="'none' (a mesh preset or 'auto' is not ported yet)")
    parser.add_argument("--device",
                        help="torch device to serve on (default: the current CUDA card; "
                             "'cpu' serves on the CPU)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--secret", help="RPC secret (default: random)")
    parser.add_argument("--seed", type=int, default=0,
                        help="param init seed when serving without a checkpoint")
    parser.add_argument("--max-seq-len", type=int,
                        help="override the config's max_seq_len (cache size)")
    parser.add_argument("--exp-dir",
                        help="directory for telemetry JSONL export")
    parser.add_argument("--name", default="maggy-serve")
    parser.add_argument("--replicas", type=int, default=1,
                        help=">1 serves a fleet: a router front-end over N "
                             "engine replicas")
    parser.add_argument("--slo-ttft-ms", type=float,
                        help="TTFT budget: fleet admission sheds/queues "
                             "requests whose projected TTFT exceeds it; "
                             "single-engine mode counts slo_ok/slo_miss "
                             "attainment in SSTATS")
    parser.add_argument("--admission", choices=("queue", "shed"),
                        default="queue",
                        help="fleet behavior when projection exceeds the SLO")
    parser.add_argument("--max-restarts", type=int, default=1,
                        help="fleet-wide replica respawn budget")
    parser.add_argument("--paged", dest="paged", action="store_true",
                        default=None,
                        help="paged KV cache (default on)")
    parser.add_argument("--no-paged", dest="paged", action="store_false",
                        help="dense row-per-slot KV cache fallback")
    parser.add_argument("--page-size", type=int,
                        help="KV page size in tokens (power of two dividing "
                             "max_seq_len; default 16)")
    parser.add_argument("--num-pages", type=int,
                        help="KV page pool size; default reserves the dense "
                             "equivalent (slots x max_seq_len/page_size + 1)")
    parser.add_argument("--prefill-replicas", type=int, default=0,
                        help="disaggregated fleet: N extra prefill-only "
                             "replicas; prompts prefill there and the KV "
                             "packs hand off to decode replicas")
    args = parser.parse_args(argv)
    if args.prefill_replicas and args.replicas < 1:
        raise SystemExit("--prefill-replicas needs at least one decode replica")
    _refuse_unported(args)

    from maggy_tpu_torch.serve import Engine, Scheduler, ServeServer
    from maggy_tpu_torch.serve.engine import serving_state
    from maggy_tpu_torch.telemetry import worker_telemetry
    from maggy_tpu_torch.util import resolve_device

    dev = resolve_device(args.device)
    cfg = build_config(args.config, args.max_seq_len)
    t0 = time.time()
    params = load_or_init_params(cfg, checkpoint=args.checkpoint, step=args.step,
                                 seed=args.seed, device=dev)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)  # the init ran on the card: time it whole
    src = args.checkpoint or f"random init (seed {args.seed})"
    print(f"[serve] params from {src} on {dev} in {time.time() - t0:.3f}s", file=sys.stderr)
    # the projections cast once; the fp32 masters of them go
    params = serving_state(cfg, params, dev)

    tel = None
    if args.exp_dir:
        tel = worker_telemetry("serve", args.exp_dir, role="serve")
    if args.replicas > 1 or args.prefill_replicas > 0:
        from maggy_tpu_torch.serve.fleet import ReplicaSpec, launch_fleet

        tel_factory = None
        if args.exp_dir:
            tel_factory = lambda i: worker_telemetry(  # noqa: E731
                f"replica{i}", args.exp_dir, role="serve"
            )
        spec = ReplicaSpec(
            cfg, params, num_slots=args.slots, device=dev,
            telemetry_factory=tel_factory, paged=args.paged,
            page_size=args.page_size, num_pages=args.num_pages,
        )
        server = launch_fleet(
            spec, replicas=args.replicas, secret=args.secret, name=args.name,
            slo_ttft_ms=args.slo_ttft_ms, admission=args.admission,
            max_restarts=args.max_restarts, telemetry_recorder=tel,
            prefill_replicas=args.prefill_replicas,
        )
        host, port = server.start(host=args.host, port=args.port)
        what = f"fleet router ({args.replicas} replicas"
        if args.prefill_replicas:
            what += f" + {args.prefill_replicas} prefill"
        what += ")"
    else:
        engine = Engine(
            cfg, params, num_slots=args.slots, device=dev,
            telemetry_recorder=tel, paged=args.paged,
            page_size=args.page_size, num_pages=args.num_pages,
        )
        scheduler = Scheduler(engine, slo_ttft_ms=args.slo_ttft_ms)
        server = ServeServer(scheduler, secret=args.secret, name=args.name)
        host, port = server.start(host=args.host, port=args.port)
        what = "engine"
    print(
        f"[serve] {what} listening on {host}:{port}\n"
        f"[serve] secret: {server.secret}\n"
        f"[serve] monitor: python -m maggy_tpu_torch.monitor {host}:{port} "
        f"{server.secret} --dashboard",
        file=sys.stderr, flush=True,
    )

    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    print("[serve] shutting down", file=sys.stderr)
    server.stop()
    if tel is not None:
        tel.close()
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[serve] peak {peak:.3f} GiB allocated on {dev}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
