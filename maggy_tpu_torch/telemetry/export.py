"""Telemetry exporters: merged Chrome trace + TensorBoard scalar mirror.

``export_chrome_trace`` folds every worker's JSONL under
``<exp_dir>/telemetry/`` into one Perfetto-loadable ``trace.json``: spans
become complete (``ph="X"``) events and gauges become counter (``ph="C"``)
events, all on the shared wall-clock microsecond base the recorder stamps, so
spans from different workers/hosts interleave correctly on one timeline.

Request lanes: lifecycle events (``kind="event"``) carrying a trace id are
additionally folded into a synthetic ``requests`` process — one thread
(lane) per trace, with the raw milestones as instants and the gaps between
consecutive milestones rendered as labeled phase spans (``route`` /
``queue`` / ``prefill`` / ``decode`` / ``lost`` …). Because the trace id is
propagated across workers (docs/observability.md), a request that hopped
client → router → replica → survivor renders as ONE contiguous lane even
though its records came from several worker files.

``mirror_to_tensorboard`` replays each worker's gauge series through the
existing :mod:`maggy_tpu_torch.tensorboard` seam (``events.jsonl`` always, real TF
event files when the tensorboard package is importable).
"""

from __future__ import annotations

import json
import posixpath
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.telemetry.sink import telemetry_dir


def _worker_pid(worker: Any, assigned: Dict[str, int]) -> int:
    """Chrome-trace pid for a worker id: numeric ids map directly; named
    workers (driver, standalone) get stable slots from 1000 up."""
    s = str(worker)
    if s.lstrip("-").isdigit():
        return int(s)
    if s not in assigned:
        assigned[s] = 1000 + len(assigned)
    return assigned[s]


def _jsonl_segments(names: List[str]) -> List[Any]:
    """(stem, path-name) pairs for every JSONL file including rotated
    segments (``x.jsonl.3``), ordered oldest-first within each stem so a
    rotated worker's records concatenate in write order."""
    entries = []
    for name in names:
        stem, sep, suffix = name.partition(".jsonl")
        if not sep:
            continue
        if suffix and not (suffix.startswith(".") and suffix[1:].isdigit()):
            continue  # e.g. trace.json / stray temp files
        seg = int(suffix[1:]) if suffix else 0
        entries.append((stem, -seg, name))
    return [(stem, name) for stem, _seg, name in sorted(entries)]


def load_records(env, exp_dir: str) -> Dict[str, List[Dict[str, Any]]]:
    """All telemetry JSONL records under ``exp_dir``, keyed by file stem —
    rotated segments (``worker_0.jsonl.1`` …) fold into their stem oldest
    first. Unparseable lines are skipped — a crashed worker may leave a
    torn tail."""
    tdir = telemetry_dir(exp_dir)
    out: Dict[str, List[Dict[str, Any]]] = {}
    try:
        names = list(env.listdir(tdir))
    except OSError:
        return out
    for stem, name in _jsonl_segments(names):
        records = out.setdefault(stem, [])
        try:
            with env.open_file(posixpath.join(tdir, name), "r") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return {stem: records for stem, records in out.items() if records}


# synthetic process id for the per-request lanes (well clear of worker pids:
# numeric partition ids and the 1000+ named-worker slots)
REQUESTS_PID = 9000

# (previous milestone, this milestone) -> phase-span label on a request lane
_PHASE_LABELS: Dict[Any, str] = {
    ("req.accepted", "req.dispatched"): "route",
    ("req.requeued", "req.dispatched"): "route",
    ("req.accepted", "req.shed"): "route",
    ("req.dispatched", "req.queued"): "transit",
    ("req.accepted", "req.queued"): "transit",
    ("req.queued", "req.admitted"): "queue",
    ("req.queued", "req.prefix_admitted"): "queue",
    ("req.admitted", "req.first_token"): "prefill",
    ("req.prefix_admitted", "req.first_token"): "prefill",
    ("req.first_token", "req.finished"): "decode",
    ("req.finished", "req.completed"): "completion",
    ("req.queued", "req.finished"): "queue",
}


def _request_lanes(
    traces: Dict[str, List[Dict[str, Any]]], events: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Fold per-trace lifecycle events into lane metadata + instants +
    phase spans under the synthetic ``requests`` process. Returns the
    thread-name metadata records (the events are appended in place)."""
    meta: List[Dict[str, Any]] = []
    order = sorted(traces, key=lambda t: min(float(e["ts"]) for e in traces[t]))
    for tid, trace in enumerate(order, start=1):
        recs = sorted(traces[trace], key=lambda e: float(e["ts"]))
        rid = None
        for rec in recs:
            rid = (rec.get("attrs") or {}).get("rid") or rid
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "ts": 0,
                "pid": REQUESTS_PID,
                "tid": tid,
                "args": {"name": f"req {rid or trace}"},
            }
        )
        for rec in recs:
            events.append(
                {
                    "name": rec.get("name", "?"),
                    "cat": "request",
                    "ph": "i",
                    "s": "t",
                    "ts": int(float(rec["ts"]) * 1e6),
                    "pid": REQUESTS_PID,
                    "tid": tid,
                    "args": {"trace": trace, **(rec.get("attrs") or {})},
                }
            )
        for prev, cur in zip(recs, recs[1:]):
            t0, t1 = float(prev["ts"]), float(cur["ts"])
            if t1 <= t0:
                continue
            label = _PHASE_LABELS.get(
                (prev.get("name"), cur.get("name")),
                "lost" if cur.get("name") == "req.requeued" else "other",
            )
            events.append(
                {
                    "name": label,
                    "cat": "request",
                    "ph": "X",
                    "ts": int(t0 * 1e6),
                    "dur": max(1, int((t1 - t0) * 1e6)),
                    "pid": REQUESTS_PID,
                    "tid": tid,
                    "args": {"trace": trace},
                }
            )
    return meta


def export_chrome_trace(env, exp_dir: str, out_name: str = "trace.json") -> Optional[str]:
    """Merge all worker JSONLs into ``<exp_dir>/telemetry/trace.json``.
    Returns the written path, or None when there is nothing to export."""
    by_worker = load_records(env, exp_dir)
    if not by_worker:
        return None
    assigned: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, str] = {}
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for stem, records in sorted(by_worker.items()):
        for rec in records:
            worker = rec.get("worker", stem)
            pid = _worker_pid(worker, assigned)
            seen_pids.setdefault(pid, str(worker))
            ts = rec.get("ts")
            if ts is None:
                continue
            kind = rec.get("kind")
            trace = rec.get("trace")
            if kind == "span":
                args = dict(rec.get("attrs") or {})
                if trace:
                    args["trace"] = trace
                events.append(
                    {
                        "name": rec.get("name", "?"),
                        "cat": "span",
                        "ph": "X",
                        "ts": int(float(ts) * 1e6),
                        "dur": max(1, int(float(rec.get("dur_ms", 0.0)) * 1e3)),
                        "pid": pid,
                        "tid": int(rec.get("tid", 0)),
                        "args": args,
                    }
                )
            elif kind == "gauge":
                events.append(
                    {
                        "name": rec.get("name", "?"),
                        "cat": "gauge",
                        "ph": "C",
                        "ts": int(float(ts) * 1e6),
                        "pid": pid,
                        "tid": 0,
                        "args": {rec.get("name", "value"): rec.get("value")},
                    }
                )
            elif kind == "event" and trace:
                # request lanes are cross-worker: bucket by trace id now,
                # fold into the synthetic process after the sweep
                traces.setdefault(trace, []).append(rec)
    lane_meta = _request_lanes(traces, events) if traces else []
    if not events:
        return None
    events.sort(key=lambda e: e["ts"])
    # process-name metadata first (ts 0 keeps them ahead after the sort above)
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "ts": 0,
            "pid": pid,
            "tid": 0,
            "args": {"name": f"worker {label}"},
        }
        for pid, label in sorted(seen_pids.items())
    ]
    if lane_meta:
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0,
                "pid": REQUESTS_PID,
                "tid": 0,
                "args": {"name": "requests"},
            }
        )
        meta.extend(lane_meta)
    path = posixpath.join(telemetry_dir(exp_dir), out_name)
    env.dump(
        json.dumps(
            {"traceEvents": meta + events, "displayTimeUnit": "ms"},
            separators=(",", ":"),
        ),
        path,
    )
    return path


def mirror_to_tensorboard(env, exp_dir: str) -> int:
    """Replay gauge series as TensorBoard scalars under
    ``<exp_dir>/telemetry/tb/<worker>/`` via the tensorboard.py seam.
    Returns the number of scalars written (0 when there is nothing)."""
    from maggy_tpu_torch import tensorboard as tb

    by_worker = load_records(env, exp_dir)
    written = 0
    for stem, records in sorted(by_worker.items()):
        gauges = [r for r in records if r.get("kind") == "gauge"]
        if not gauges:
            continue
        logdir = posixpath.join(telemetry_dir(exp_dir), "tb", stem)
        tb._register(logdir)
        try:
            steps: Dict[str, int] = {}
            for rec in gauges:
                tag = str(rec.get("name", "value"))
                step = steps.get(tag, 0)
                steps[tag] = step + 1
                try:
                    tb.scalar(f"telemetry/{tag}", float(rec.get("value", 0.0)), step)
                    written += 1
                except (TypeError, ValueError, OSError):
                    continue
        finally:
            tb._unregister()
    return written
