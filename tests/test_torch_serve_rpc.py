"""The port's serving front-end over RPC on the CPU: Engine -> Scheduler ->
ServeServer -> ServeClient, the counterpart of ``tests/test_serve_rpc.py``.
Staggered greedy requests through B=4 slots give the JAX server's streams
token for token; cancel, deadline and submit validation behave as JAX's;
the METRICS, STATUS and LOG verbs answer; the gauges land in the JSONL.
Float32 ``DecoderConfig.tiny`` with weights converted from the JAX init."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from maggy_tpu import serve as jserve
from maggy_tpu.models import transformer as jt
from maggy_tpu.parallel.sharding import unbox
from maggy_tpu_torch.convert import decoder_params_from_flax
from maggy_tpu_torch.exceptions import RpcError
from maggy_tpu_torch.models import transformer as tt
from maggy_tpu_torch.serve import Engine, Scheduler, ServeClient, ServeServer
from maggy_tpu_torch.telemetry import worker_telemetry

torch.set_num_threads(2)
JCFG = jt.DecoderConfig.tiny(max_seq_len=64, dtype=jnp.float32)
CFG = tt.DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 10, 11, 12, 13], [2, 4, 6, 8, 10, 12], [7, 3], [20, 21, 22, 23],
           [30, 31], [40, 41, 42, 44, 45, 46, 47]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def weights():
    params = unbox(jt.Decoder(JCFG).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"])
    return params, decoder_params_from_flax(jax.device_get(params), CFG)


def serve_stack(sd, num_slots=4, tel=None):
    engine = Engine(CFG, sd, num_slots=num_slots, device="cpu", telemetry_recorder=tel)
    return ServeServer(Scheduler(engine))


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX server's greedy streams for PROMPTS."""
    params, _ = weights
    server = jserve.ServeServer(jserve.Scheduler(jserve.Engine(JCFG, params, num_slots=4)))
    host, port = server.start(host="127.0.0.1")
    try:
        with jserve.ServeClient((host, port), server.secret) as client:
            ids = [client.submit(p, max_new=MAX_NEW) for p in PROMPTS]
            return [client.result(rid, timeout=90)["tokens"] for rid in ids]
    finally:
        server.stop()


def test_staggered_requests_equal_jax_server(weights, jax_streams, tmp_path):
    """8 requests, staggered arrivals from their own clients, B=4."""
    _, sd = weights
    tel = worker_telemetry("serve", str(tmp_path), role="serve")
    server = serve_stack(sd, tel=tel)
    host, port = server.start(host="127.0.0.1")
    results, errors = {}, []

    def drive(i, prompt, delay):
        try:
            time.sleep(delay)
            with ServeClient((host, port), server.secret) as client:
                results[i] = client.generate(prompt, max_new=MAX_NEW, timeout=90)
        except Exception as e:  # noqa: BLE001 - surfaced via the errors list
            errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=drive, args=(i, p, 0.03 * i)) for i, p in enumerate(PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert [results[i] for i in range(len(PROMPTS))] == jax_streams
        with ServeClient((host, port), server.secret) as client:
            stats = client.stats()
            status = client._client._request({"type": "STATUS"})
            log = client._client._request({"type": "LOG"})
            metrics = client._client._request({"type": "METRICS"})
        assert stats["compile_counts"]["decode"] == 1, stats["compile_counts"]
        assert stats["requests_done"] == len(PROMPTS) and stats["requests_failed"] == 0
        assert stats["tokens_out"] >= len(PROMPTS) * MAX_NEW and stats["ttft_ms_p50"] is not None
        assert status["kind"] == "serve" and status["serve"]["num_slots"] == 4
        assert "slots" in log["progress"] and any("submit" in line for line in log["logs"])
        assert metrics["scope"] == "worker" and "metrics" in metrics
    finally:
        server.stop()
    tel.close()
    with open(os.path.join(str(tmp_path), "telemetry", "worker_serve.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    gauges = {r["name"] for r in records if r.get("kind") == "gauge"}
    for expected in ("serve.ttft_ms", "serve.queue_depth", "serve.tokens_per_sec", "serve.active_slots",
                     "serve.decode_retraces"):
        assert expected in gauges, (expected, sorted(gauges))


def test_cancel_and_deadline(weights):
    _, sd = weights
    server = serve_stack(sd)
    host, port = server.start(host="127.0.0.1")
    try:
        with ServeClient((host, port), server.secret) as client:
            # cancel mid-decode (once it has a token: the CPU decodes the
            # tiny model fast): a long request is stopped well short
            rid = client.submit([1, 2, 3], max_new=60)
            deadline = time.time() + 30
            while client.poll(rid)["n_tokens"] < 1 and time.time() < deadline:
                time.sleep(0.002)
            assert client.cancel(rid)
            snap = client.result(rid, timeout=30)
            assert snap["state"] == "cancelled" and snap["n_tokens"] < 60
            # cancel of a finished request reports False
            done = client.submit([4, 5], max_new=2)
            client.result(done, timeout=30)
            assert client.cancel(done) is False
            # a deadline in the past expires without decoding
            rid = client.submit([6, 7, 8], max_new=20, deadline_s=-0.1)
            snap = client.result(rid, timeout=30)
            assert snap["state"] == "expired" and snap["error"]
    finally:
        server.stop()


def test_submit_validation_over_rpc(weights):
    _, sd = weights
    server = serve_stack(sd)
    host, port = server.start(host="127.0.0.1")
    try:
        with ServeClient((host, port), server.secret) as client:
            with pytest.raises(RpcError, match="max_seq_len"):
                client.submit(list(range(60)), max_new=20)
            with pytest.raises(RpcError, match="list of token ids"):
                client._client._request({"type": "SUBMIT", "prompt": "oops"})
            with pytest.raises(RpcError, match="unknown request"):
                client.poll("nonexistent")
            with pytest.raises(RpcError, match="qos"):
                client.submit([1, 2], max_new=2, qos="gold")
            # the connection survives every rejected submit
            assert client.stats()["requests_submitted"] == 0
    finally:
        server.stop()


def test_qos_and_tenants_over_rpc(weights):
    """QoS class and tenant ride the SUBMIT frame into the scheduler's
    per-class counters."""
    _, sd = weights
    server = serve_stack(sd, num_slots=2)
    host, port = server.start(host="127.0.0.1")
    try:
        with ServeClient((host, port), server.secret) as client:
            ids = [client.submit([3 + i, 4], max_new=3, qos=q, tenant=t)
                   for i, (q, t) in enumerate([("premium", "acme"), ("standard", "bulk"), ("best_effort", "bulk")])]
            assert all(client.result(rid, timeout=60)["state"] == "done" for rid in ids)
            counters = client.stats()["qos"]["counters"]
        assert {c: counters[c]["admitted"] for c in counters} == {"premium": 1, "standard": 1, "best_effort": 1}
    finally:
        server.stop()
