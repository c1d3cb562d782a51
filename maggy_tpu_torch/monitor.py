"""Live experiment monitor — the LOG-polling client as a CLI.

The port's counterpart of :mod:`maggy_tpu.monitor`, for the port's drivers
(``maggy_tpu_torch.experiment.lagom``), serving engines and fleet routers:

    python -m maggy_tpu_torch.monitor <host:port> <secret> [--interval 1.0]
    python -m maggy_tpu_torch.monitor --latest            # auto-attach via registry
    python -m maggy_tpu_torch.monitor --app <app_id>      # attach a specific run
    python -m maggy_tpu_torch.monitor <host:port> <secret> --dashboard

Polls the LOG verb, printing shipped log lines and the progress bar; with
``--dashboard`` it redraws :func:`render_status`'s panel from the STATUS verb
(HPO, distributed, serving engine and fleet panels). Auto-attach resolves
host/port/secret from the driver registry every running driver writes under
``<MAGGY_TPU_LOG_ROOT>/.drivers/``; explicit host:port + secret works
against any reachable driver, ``ServeServer`` or fleet ``Router``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _record_addr(rec):
    """Connectable (host, port) for a registry record: pod records advertise
    a cross-host hostname, local records mean loopback."""
    host = rec["host"] if rec.get("scope", "pod") == "pod" else "127.0.0.1"
    return host, int(rec["port"])


def _driver_alive(host, port, timeout: float = 0.75) -> bool:
    """True when something accepts TCP connections at host:port."""
    import socket

    try:
        socket.create_connection((host, port), timeout=timeout).close()
        return True
    except OSError:
        return False


def resolve_target(env, app_id=None):
    """(host, port, secret) from the driver registry. ``app_id=None`` picks
    the newest record whose driver still accepts connections — a SIGKILLed
    driver cannot unregister, so stale records are skipped AND pruned (best
    effort) instead of attaching to a dead address. Raises LookupError when
    nothing live is registered."""
    if app_id:
        rec = env.lookup_driver(app_id)
        if rec is None:
            raise LookupError(
                f"No driver registered for app {app_id!r} under {env.root}"
            )
    else:
        recs = env.list_drivers()
        if not recs:
            raise LookupError(f"No drivers registered under {env.root}")
        rec = None
        pruned = 0
        for candidate in recs:  # newest first
            host, port = _record_addr(candidate)
            if _driver_alive(host, port):
                rec = candidate
                break
            pruned += 1
            stale_app = candidate.get("app_id")
            if stale_app:
                print(
                    f"[monitor] pruning stale registry record for {stale_app} "
                    f"({host}:{port} refuses connections)",
                    file=sys.stderr,
                )
                env.unregister_driver(stale_app)
        if rec is None:
            raise LookupError(
                f"No live drivers under {env.root} "
                f"({pruned} stale record(s) pruned)"
            )
    host, port = _record_addr(rec)
    # address-only records (MAGGY_TPU_REGISTRY_NO_SECRET=1 drivers) rely on
    # the secret arriving out-of-band via env
    secret = rec.get("secret") or os.environ.get("MAGGY_TPU_SECRET", "")
    return host, port, secret


def _parse_addr(addr: str):
    """(host, port) from ``host:port``; an empty host means loopback."""
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"the address must be 'host:port', got {addr!r}")
    return host or "127.0.0.1", int(port)


def _pid_key(kv):  # JSON stringifies pids; sort numerically
    try:
        return (0, int(kv[0]))
    except ValueError:
        return (1, kv[0])


def _heartbeat_line(seen: dict) -> str:
    """'last heartbeat: w0:1.2s w1:0.4s ...' — shared by the HPO and
    distributed dashboard branches."""
    return "last heartbeat: " + "  ".join(
        f"w{pid}:{age}s" for pid, age in sorted(seen.items(), key=_pid_key)
    )


def _telemetry_lines(status: dict, width: int) -> list:
    """Throughput/step-time panel from the per-worker telemetry snapshots the
    driver folds into STATUS (heartbeat-attached recorder state)."""
    snaps = status.get("telemetry") or {}
    if not snaps:
        return []
    lines = []
    gauges = {pid: (snap.get("gauges") or {}) for pid, snap in snaps.items()}
    tok_total = sum(
        g["tokens_per_sec"] for g in gauges.values() if "tokens_per_sec" in g
    )
    step_times = [g["step_time_ms"] for g in gauges.values() if "step_time_ms" in g]
    agg = []
    if tok_total:
        agg.append(f"throughput {tok_total:,.0f} tok/s")
    if step_times:
        agg.append(f"mean step {sum(step_times) / len(step_times):.1f}ms")
    lines.append(("-- telemetry --" + ("  " + "  ".join(agg) if agg else ""))[:width])
    for pid, snap in sorted(snaps.items(), key=_pid_key):
        g = snap.get("gauges") or {}
        parts = []
        if "step_time_ms" in g:
            parts.append(f"{g['step_time_ms']:.1f}ms/step")
        if "steps_per_sec" in g:
            parts.append(f"{g['steps_per_sec']:.2f}st/s")
        if "tokens_per_sec" in g:
            parts.append(f"{g['tokens_per_sec']:,.0f}tok/s")
        # host-overlap health (docs/performance.md): time the step loop sat
        # waiting on the input pipeline, prefetch queue occupancy, and how
        # many steps behind the lagged metrics drain is running
        if "input_wait_ms" in g:
            parts.append(f"in-wait {g['input_wait_ms']:.1f}ms")
        if "prefetch_depth" in g:
            parts.append(f"prefetch {g['prefetch_depth']:.0f}")
        if "metrics_lag" in g:
            parts.append(f"lag {g['metrics_lag']:.0f}")
        if "mfu_est" in g:
            parts.append(f"mfu {100 * g['mfu_est']:.1f}%")
        # gradient-overlap health (docs/distributed.md "Gradient overlap &
        # ZeRO"): reduction buckets in the compiled step, and how much comm
        # is still exposed on the critical path vs hidden under backward
        if "train.bucket_count" in g:
            parts.append(f"buckets {g['train.bucket_count']:.0f}")
        if "train.comm_exposed_ms" in g:
            parts.append(
                f"comm {g['train.comm_exposed_ms']:.1f}ms exposed"
                f"/{g.get('train.comm_overlapped_ms', 0):.1f}ms hidden"
            )
        if "compile_time_ms" in g:
            parts.append(f"compile {g['compile_time_ms'] / 1e3:.1f}s")
        if "heartbeat_rtt_ms" in g:
            parts.append(f"hb {g['heartbeat_rtt_ms']:.1f}ms")
        if "serve.tokens_per_sec" in g:
            parts.append(f"{g['serve.tokens_per_sec']:,.0f}tok/s")
        if "serve.ttft_ms" in g:
            parts.append(f"ttft {g['serve.ttft_ms']:.0f}ms")
        if "serve.queue_depth" in g:
            parts.append(f"queue {g['serve.queue_depth']:.0f}")
        if "serve.active_slots" in g:
            parts.append(f"slots {g['serve.active_slots']:.0f}")
        if "serve.drain_ms" in g:
            parts.append(f"drain {g['serve.drain_ms']:.1f}ms")
        if "serve.decode_retraces" in g:
            parts.append(f"compiles {g['serve.decode_retraces']:.0f}")
        # paged KV cache (docs/serving.md "Paged KV cache")
        if "serve.pages_free" in g:
            parts.append(
                f"pages {g['serve.pages_free']:.0f} free"
                f"/{g.get('serve.pages_shared', 0):.0f} shared"
            )
        if "serve.handoff_ms" in g:
            parts.append(f"handoff {g['serve.handoff_ms']:.1f}ms")
        # capacity (docs/observability.md "Capacity"): ledger headroom and
        # page-heat buckets from the worker's metrics tick
        if "mem.headroom_pct" in g:
            parts.append(f"headroom {100 * g['mem.headroom_pct']:.0f}%")
        if "serve.pages_hot" in g:
            parts.append(
                f"heat {g['serve.pages_hot']:.0f}"
                f"/{g.get('serve.pages_warm', 0):.0f}"
                f"/{g.get('serve.pages_cold', 0):.0f} h/w/c"
            )
        if "fleet.healthy_replicas" in g:
            parts.append(f"healthy {g['fleet.healthy_replicas']:.0f}")
        c0 = snap.get("counters") or {}
        if "serve.prefix_hits" in c0:
            parts.append(
                f"prefix {c0['serve.prefix_hits']}/"
                f"{c0.get('serve.prefix_tokens_saved', 0)}tok"
            )
        if c0.get("serve.preemptions"):
            parts.append(f"preempt {c0['serve.preemptions']}")
        # autotuner progress (tune/): candidate grid, AOT prunes,
        # and the best measured step time so far
        if "tune.candidates" in g:
            parts.append(f"tune {g['tune.candidates']:.0f} cand")
        if "tune.pruned_oom" in g:
            parts.append(f"oom-pruned {g['tune.pruned_oom']:.0f}")
        if "tune.best_step_time" in g:
            parts.append(f"best {g['tune.best_step_time']:.1f}ms/step")
        # resilience counters (resilience/): what the runtime
        # absorbed — requeued/exhausted trials, quarantines, worker deaths,
        # elastic restarts, auto-resumes, preemption saves
        # elastic membership gauges: epoch/active width and the last
        # reshape-barrier latency (docs/resilience.md)
        if "resilience.active_slices" in g:
            parts.append(
                f"slices {g['resilience.active_slices']:.0f}"
                f"@e{g.get('resilience.membership_epoch', 0):.0f}"
            )
        if "resilience.reshape_ms" in g:
            parts.append(f"reshape {g['resilience.reshape_ms']:.0f}ms")
        c = snap.get("counters") or {}
        res = {
            k[len("resilience."):]: v
            for k, v in c.items()
            if k.startswith("resilience.")
        }
        if res:
            parts.append(
                "resilience "
                + " ".join(f"{k}={v}" for k, v in sorted(res.items()))
            )
        if "checkpoint_fallback" in c:
            parts.append(f"ckpt-fallback {c['checkpoint_fallback']}")
        # autopilot (autopilot/): the telemetry→config loop's
        # scoreboard — windows diagnosed, guarded re-tunes kept, rollbacks
        if "autopilot.diagnoses" in c:
            parts.append(
                f"autopilot diag={c['autopilot.diagnoses']}"
                f" retune={c.get('autopilot.retunes', 0)}"
                f" rb={c.get('autopilot.rollbacks', 0)}"
            )
        if "flightrec.dumps" in c:
            # a stall dump is a red flag worth surfacing on the panel
            parts.append(f"STALL-DUMPS {c['flightrec.dumps']}")
        if "profcap.captures" in c:
            # an alert armed a profile capture — evidence is on disk
            parts.append(f"PROFCAP {c['profcap.captures']}")
        if not parts:
            continue
        tag = pid if pid == "driver" else f"w{pid}"
        lines.append(f"{tag}: " + "  ".join(parts)[: width - 5])
    return lines


def _latency_parts(sv: dict) -> list:
    """Histogram-derived latency summary for a serve/fleet SSTATS dict:
    TTFT percentiles, TPOT, and SLO attainment when a budget is set
    (docs/observability.md)."""
    parts = []
    if sv.get("ttft_ms_p50") is not None:
        parts.append(f"ttft p50 {sv['ttft_ms_p50']:.0f}ms")
    if sv.get("ttft_ms_p95") is not None:
        parts.append(f"p95 {sv['ttft_ms_p95']:.0f}ms")
    if sv.get("ttft_ms_p99") is not None:
        parts.append(f"p99 {sv['ttft_ms_p99']:.0f}ms")
    if sv.get("tpot_ms_p50") is not None:
        parts.append(f"tpot {sv['tpot_ms_p50']:.1f}ms")
    if sv.get("slo_attainment") is not None:
        parts.append(
            f"slo {100 * sv['slo_attainment']:.1f}%"
            f" ({sv.get('slo_ok', 0)}/{sv.get('slo_ok', 0) + sv.get('slo_miss', 0)})"
        )
    return parts


def _paging_parts(sv: dict) -> list:
    """Paged-KV summary for a serve/fleet SSTATS dict: pool occupancy,
    sharing, and preemptions (docs/serving.md "Paged KV cache"). The
    single-engine dict nests under ``paging``; the fleet aggregate is
    flat (summed over paged replicas)."""
    paging = sv.get("paging") or {}
    parts = []
    if paging.get("paged"):
        parts.append(
            f"pages {paging.get('pages_free', 0)}"
            f"/{paging.get('pages_total', 0)} free"
        )
        if paging.get("pages_shared"):
            parts.append(f"{paging['pages_shared']} shared")
    elif sv.get("pages_total"):
        parts.append(f"pages {sv.get('pages_free', 0)}/{sv['pages_total']} free")
        if sv.get("pages_shared"):
            parts.append(f"{sv['pages_shared']} shared")
    if sv.get("preemptions"):
        parts.append(f"preempt {sv['preemptions']}")
    return parts


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:,.0f}{unit}"
        n /= 1024
    return f"{n:,.0f}GB"  # unreachable; keeps the return type total


def _capacity_parts(sv: dict) -> list:
    """Capacity summary (docs/observability.md "Capacity"): HBM headroom
    from the memory ledger, page-heat buckets, free-pool fragmentation,
    resident-prefix KV, and profile-capture count. Single-engine SSTATS
    nests ``memory``/``profcap``/``prefix_residency`` dicts and
    ``paging.heat``; the fleet aggregate folds the same view (headroom =
    tightest replica) under ``capacity``."""
    parts = []
    mem = sv.get("memory") or {}
    cap = sv.get("capacity") or {}
    paging = sv.get("paging") or {}
    hp = mem.get("headroom_pct")
    if hp is None:
        hp = cap.get("headroom_pct")
    if hp is not None:
        parts.append(f"headroom {100 * float(hp):.0f}%")
    if mem.get("unattributed"):
        parts.append(f"unattrib {_fmt_bytes(mem['unattributed'])}")
    heat = paging.get("heat") or {}
    hot = heat.get("hot", cap.get("pages_hot"))
    warm = heat.get("warm", cap.get("pages_warm"))
    cold = heat.get("cold", cap.get("pages_cold"))
    if hot or warm or cold:
        parts.append(f"heat {hot or 0}/{warm or 0}/{cold or 0} h/w/c")
    frag = (paging.get("fragmentation") or {}).get("frag_ratio")
    if frag is None:
        frag = cap.get("fragmentation")
    if frag:
        parts.append(f"frag {100 * float(frag):.0f}%")
    resid = sv.get("prefix_residency") or {}
    rb = resid.get("resident_bytes", cap.get("resident_bytes"))
    rc = resid.get("resident_prefixes", cap.get("resident_prefixes"))
    if rb:
        parts.append(f"resident {rc or 0}pfx/{_fmt_bytes(rb)}")
    top = resid.get("top") or cap.get("top_prefixes") or []
    if top:
        t = top[0]
        parts.append(f"top {t.get('digest', '?')} x{t.get('hits', 0)}")
    # host-DRAM KV tier (docs/serving.md "Host-DRAM page tier"): pool
    # occupancy plus spill/fill traffic; the fleet aggregate sums the
    # same counters across enabled replicas under capacity.tier
    tier = sv.get("tier") or cap.get("tier") or {}
    if tier.get("enabled") or tier.get("replicas"):
        total = tier.get("host_pages_total", 0)
        free = tier.get("host_pages_free", 0)
        parts.append(
            f"tier {total - free}/{total}pg "
            f"{tier.get('resident_packs', 0)}pk "
            f"s{tier.get('spills', 0)}/f{tier.get('fills', 0)}"
        )
    pc = sv.get("profcap") or {}
    if pc.get("captures"):
        parts.append(f"PROFCAP {pc['captures']}")
    return parts


def _autopilot_line(sv: dict) -> list:
    """One panel line for the serve/fleet autopilot status the scheduler/
    router folds into SSTATS: last verdict, last guarded move, and the
    commit/rollback scoreboard (docs/autotune.md "Continuous tuning")."""
    ap = sv.get("autopilot")
    if not ap:
        return []
    parts = [f"autopilot[{ap.get('phase', '?')}]"]
    if ap.get("bottleneck"):
        parts.append(ap["bottleneck"])
    if ap.get("last_move"):
        parts.append(f"-> {ap['last_move']}")
    parts.append(
        f"(retunes {ap.get('retunes', 0)}, rollbacks {ap.get('rollbacks', 0)})"
    )
    return [" ".join(parts)]


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _spark(values: list, width: int = 16) -> str:
    """Unicode sparkline over the last ``width`` values, scaled to the
    window's own min/max (a trend display, not an absolute scale)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_BLOCKS[0] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK_BLOCKS[min(7, int((v - lo) / span * 8))] for v in vals
    )


def _trend_lines(sv: dict, width: int) -> list:
    """Sparkline trend block from the router's fleet time-series store
    (``trends`` in SSTATS — docs/observability.md "Time series")."""
    trends = sv.get("trends") or {}
    lines = []
    for name in sorted(trends):
        vals = trends[name]
        if not vals:
            continue
        short = name.split(".", 1)[-1]
        latest = vals[-1]
        shown = f"{latest:,.1f}" if isinstance(latest, float) else str(latest)
        lines.append(f"  ~ {short:<18} {_spark(vals)}  {shown}"[:width])
    return lines


def _alert_lines(sv: dict, width: int) -> list:
    """ALERTS line from the firing set the scheduler/router folds into
    SSTATS (``telemetry/alerts.py``); silent when nothing is firing."""
    alerts = sv.get("alerts") or []
    if not alerts:
        return []
    parts = []
    for a in alerts:
        tag = str(a.get("alert", "?"))
        tag = tag[len("alert."):] if tag.startswith("alert.") else tag
        if a.get("program"):
            tag += f":{a['program']}"
        if a.get("severity") == "critical":
            tag += "(!)"
        if a.get("replica") is not None:
            tag += f"@r{a['replica']}"
        parts.append(tag)
    return _wrap_parts([f"ALERTS[{len(alerts)}]:"] + parts, width)


def _wrap_parts(parts: list, width: int) -> list:
    """Flow ``parts`` onto as many panel lines as needed, breaking only at
    part boundaries — the latency summary outgrew one line, and truncating
    silently would hide the trailing parts (compile counts, SLO)."""
    lines, cur = [], ""
    for part in parts:
        cand = f"{cur}  {part}" if cur else part
        if cur and len(cand) > width:
            lines.append(cur)
            cur = part
        else:
            cur = cand
    if cur:
        lines.append(cur)
    return lines


def render_status(status: dict, width: int = 78) -> str:
    """Format a STATUS snapshot as a plain-ANSI dashboard panel (no external
    TUI dependency — the runtime image carries none)."""
    from maggy_tpu_torch import util

    lines = []
    head = (
        f"{status.get('name', '?')} [{status.get('kind', '?')}] "
        f"state={status.get('state', '?')} app={status.get('app_id', '?')}"
        f"/{status.get('run_id', '?')}"
    )
    lines.append(head[:width])
    elapsed = status.get("elapsed_s")
    if status.get("trials_total") is not None:
        done = status.get("trials_done", 0)
        bar = util.progress_bar(done, status["trials_total"], width=28)
        lines.append(
            f"{bar}  running={status.get('trials_running', 0)} "
            f"stopped={status.get('early_stopped', 0)} "
            f"errors={status.get('errors', 0)}"
            + (f"  {elapsed:.0f}s" if elapsed is not None else "")
        )
        best = status.get("best")
        if best:
            params = ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(best.get("params", {}).items())
            )
            lines.append(
                f"best {status.get('direction', '')} "
                f"{best['metric']:.6g}  ({best['trial_id']})  {params}"[:width]
            )
        seen = status.get("last_seen") or {}
        if seen:  # pod-mode HPO: remote trial workers' heartbeat ages
            lines.append(_heartbeat_line(seen))
        # fault-recovery state: trials waiting out their retry backoff and
        # workers sitting in quarantine (seconds until probation release)
        requeued = status.get("trials_requeued")
        quarantined = status.get("quarantined") or {}
        if requeued or quarantined:
            q = "  ".join(
                f"w{pid}:{secs}s"
                for pid, secs in sorted(quarantined.items(), key=_pid_key)
            )
            lines.append(
                (
                    f"resilience: requeued={requeued or 0}"
                    + (f"  quarantined {q}" if q else "")
                )[:width]
            )
        lines.extend(_telemetry_lines(status, width))
        tail = status.get("controller_log") or []
        if tail:
            lines.append(f"-- {status.get('controller', 'controller')} decisions --")
            lines.extend(line[:width] for line in tail[-8:])
    elif status.get("fleet") is not None:
        # serving fleet panel (serve/fleet Router STATUS verb):
        # aggregate line + routing counters + one row per replica
        sv = status.get("serve") or {}
        fleet = status["fleet"]
        routing = fleet.get("routing") or {}
        lines.append(
            f"fleet: queue={sv.get('queue_depth', 0)}"
            f"  done={sv.get('requests_done', 0)}"
            f"  routed={routing.get('routed', 0)}"
            f"  requeued={routing.get('requeued', 0)}"
            f"  shed={routing.get('shed', 0)}"
            f"  respawned={routing.get('respawned', 0)}"
            + (
                f"  handoffs={routing.get('handoffs', 0)}"
                if routing.get("prefilled")
                else ""
            )
            + (f"  {elapsed:.0f}s" if elapsed is not None else "")
        )
        agg = []
        if sv.get("prefix_hits"):
            agg.append(
                f"prefix hits {sv['prefix_hits']} "
                f"({sv.get('prefix_tokens_saved', 0)} tok saved)"
            )
        agg.extend(_paging_parts(sv))
        agg.extend(_capacity_parts(sv))
        agg.extend(_latency_parts(sv))
        lines.extend(_wrap_parts(agg, width))
        lines.extend(line[:width] for line in _autopilot_line(sv))
        autoscale = sv.get("autoscale")
        if autoscale:
            n_up = sum(
                1
                for row in fleet.get("replicas") or []
                if row.get("state") in ("up", "draining", "quarantined")
            )
            last = autoscale.get("last_event") or {}
            lines.append(
                (
                    f"autoscale: {n_up} replicas"
                    f" [{autoscale.get('min_replicas', '?')}"
                    f"..{autoscale.get('max_replicas', '?')}]"
                    f"  phase={autoscale.get('phase', '?')}"
                    + (
                        f"  last={last.get('event', '')}"
                        f"({last.get('reason', '')})"
                        if last
                        else ""
                    )
                    + ("  AT-CAPACITY" if autoscale.get("at_capacity") else "")
                )[:width]
            )
        lines.extend(_alert_lines(sv, width))
        lines.extend(_trend_lines(sv, width))
        for row in fleet.get("replicas") or []:
            bar = util.progress_bar(
                row.get("active_slots", 0), max(row.get("num_slots", 1), 1),
                width=10,
            )
            tag = {
                "up": "up",
                "quarantined": "QUAR",
                "draining": "DRAI",
                "dead": "DEAD",
            }.get(row.get("state"), row.get("state", "?"))
            role = row.get("role")
            lines.append(
                (
                    f"  r{row.get('replica', '?')} [{tag:>4}]"
                    + (f" {role}" if role and role != "any" else "")
                    + f" slots {bar}"
                    f"  queue={row.get('queue_depth', 0)}"
                    f"  done={row.get('requests_done', 0)}"
                    f"  prefix={row.get('prefix_hits', 0)}"
                    + (
                        f"  restarts={row['restarts']}"
                        if row.get("restarts")
                        else ""
                    )
                )[:width]
            )
        lines.extend(_telemetry_lines(status, width))
    elif status.get("serve") is not None:
        # serving engine panel (serve ServeServer STATUS verb)
        sv = status["serve"]
        bar = util.progress_bar(
            sv.get("active_slots", 0), max(sv.get("num_slots", 1), 1), width=16
        )
        lines.append(
            f"slots {bar}"
            f"  queue={sv.get('queue_depth', 0)}"
            f"  done={sv.get('requests_done', 0)}"
            f"  failed={sv.get('requests_failed', 0)}"
            + (f"  {elapsed:.0f}s" if elapsed is not None else "")
        )
        parts = [f"{sv.get('tokens_out', 0):,} tokens"]
        if sv.get("tokens_per_sec"):
            parts.append(f"{sv['tokens_per_sec']:,.0f} tok/s")
        parts.extend(_paging_parts(sv))
        parts.extend(_capacity_parts(sv))
        parts.extend(_latency_parts(sv))
        compiles = (sv.get("compile_counts") or {}).get("decode")
        if compiles is not None:
            parts.append(f"decode compiles {compiles}")
        lines.extend(_wrap_parts(parts, width))
        lines.extend(line[:width] for line in _autopilot_line(sv))
        lines.extend(_alert_lines(sv, width))
        lines.extend(_telemetry_lines(status, width))
    elif status.get("workers_done") is not None:
        lines.append(
            f"workers {status['workers_done']}/{status.get('num_executors', '?')} done"
            + (
                f"  evaluator=partition {status['evaluator_partition']}"
                if status.get("evaluator_partition") is not None
                else ""
            )
            + (f"  {elapsed:.0f}s" if elapsed is not None else "")
        )
        if status.get("membership_epoch") is not None:
            # elastic membership (docs/resilience.md): current epoch and
            # which slices are in the data mesh vs the launch width
            active = status.get("active_slices") or []
            total = status.get("num_slices", len(active))
            lines.append(
                (
                    f"membership: epoch={status['membership_epoch']}"
                    f"  slices {len(active)}/{total} active {active}"
                    f"  min={status.get('min_slices', 1)}"
                    f"  mode={status.get('membership_mode', '?')}"
                )[:width]
            )
        seen = status.get("last_seen") or {}
        if seen:
            lines.append(_heartbeat_line(seen))
        lines.extend(_telemetry_lines(status, width))
    return "\n".join(lines)


def monitor(
    host: str, port: int, secret: str, interval: float = 1.0,
    dashboard: bool = False,
) -> int:
    from maggy_tpu_torch.core import rpc
    from maggy_tpu_torch.exceptions import RpcError

    from collections import deque

    try:
        client = rpc.Client((host, port), partition_id=-1, secret=secret)
    except RpcError as e:
        # A SIGKILLed driver cannot unregister, so a registry record may
        # outlive its driver — surface that instead of a raw traceback.
        print(
            f"[monitor] cannot reach driver at {host}:{port}: {e}\n"
            "[monitor] if you attached via --latest/--app, the registry "
            "record may be stale (driver killed before it could unregister)",
            file=sys.stderr,
        )
        return 1
    last_progress = ""
    # the LOG verb destructively drains the driver buffer, so the dashboard
    # accumulates every drained line locally and shows a rolling tail (plain
    # mode prints everything as it arrives)
    log_tail = deque(maxlen=500)
    try:
        while True:
            try:
                reply = client._request({"type": "LOG"})
                # capture the (destructively drained) lines BEFORE the STATUS
                # request — a driver dying between the two must not eat the
                # final log lines that explain why
                if dashboard:
                    log_tail.extend(reply.get("logs") or [])
                status = (
                    client._request({"type": "STATUS"}) if dashboard else None
                )
            except RpcError as e:
                for line in log_tail:
                    print(line, flush=True)
                if "rejected" in str(e):
                    print(f"[monitor] {e}", flush=True)  # e.g. bad secret
                    return 1
                print("[monitor] driver gone; exiting", flush=True)
                return 0
            if dashboard and status is not None:
                panel = render_status(status)
                # clear screen + home, then the panel and the rolling log tail
                sys.stdout.write("\x1b[2J\x1b[H" + panel + "\n")
                for line in list(log_tail)[-12:]:
                    sys.stdout.write(line + "\n")
                sys.stdout.flush()
            else:
                for line in reply.get("logs") or []:
                    print(line, flush=True)
                progress = reply.get("progress") or ""
                if progress and progress != last_progress:
                    print(progress, flush=True)
                    last_progress = progress
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0
    finally:
        client.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("addr", nargs="?", help="driver host:port")
    parser.add_argument("secret", nargs="?", help="experiment secret")
    parser.add_argument("--app", help="auto-attach this app id via the registry")
    parser.add_argument(
        "--latest", action="store_true",
        help="auto-attach the newest registered driver",
    )
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument(
        "--dashboard", action="store_true",
        help="full-screen status panel (STATUS verb) instead of a log tail",
    )
    args = parser.parse_args(argv)
    if args.app or args.latest:
        from maggy_tpu_torch.core.env import EnvSing

        try:
            host, port, secret = resolve_target(EnvSing.get_instance(), args.app)
        except LookupError as e:
            print(f"[monitor] {e}", file=sys.stderr)
            return 1
        print(f"[monitor] attaching to {host}:{port}", flush=True)
        return monitor(host, port, secret, args.interval, dashboard=args.dashboard)
    if not args.addr or args.secret is None:
        parser.error("need <addr> <secret>, or --app/--latest for auto-attach")
    try:
        host, port = _parse_addr(args.addr)
    except ValueError as e:
        parser.error(str(e))
    return monitor(host, port, args.secret, args.interval, dashboard=args.dashboard)


if __name__ == "__main__":
    sys.exit(main())
