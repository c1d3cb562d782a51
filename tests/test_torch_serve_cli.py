"""``python -m maggy_tpu_torch.serve`` on the CPU: ``build_config``, a
params-only restore through the port's ``Checkpointer``, the CLI as a
subprocess serving a restored checkpoint over RPC from one engine and from a
fleet (its greedy streams equal an in-process engine's over the same weights,
and SIGTERM exits 0), and the refusals of what the port does not have yet."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.serve import Engine, Request, SamplingParams, ServeClient
from maggy_tpu_torch.serve.__main__ import build_config, load_or_init_params, main
from maggy_tpu_torch.train.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def test_build_config(tmp_path):
    assert build_config("tiny") == DecoderConfig.tiny()
    assert build_config("llama3_8b", max_seq_len=4096).max_seq_len == 4096
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2, "n_kv_heads": 1,
                                "d_ff": 64, "max_seq_len": 32, "dtype": "float32"}))
    cfg = build_config(str(path))
    assert cfg.dtype == torch.float32 and cfg.n_layers == 1 and cfg.max_seq_len == 32
    with pytest.raises(SystemExit, match="unknown --config"):
        build_config("gpt5")


def _checkpoint(tmp_path, cfg, seed=3):
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    ckpt = Checkpointer(str(tmp_path / "ckpt"), async_save=False)
    ckpt.save(7, types.SimpleNamespace(model=model, optimizer=torch.optim.AdamW(model.parameters())))
    ckpt.close()
    return model, str(tmp_path / "ckpt")


def test_restore_params_round_trip(tmp_path):
    cfg = DecoderConfig.tiny()
    model, path = _checkpoint(tmp_path, cfg)
    params = load_or_init_params(cfg, checkpoint=path, device="cpu")
    assert list(params) == [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert torch.equal(params[n], p.detach()) and params[n].device.type == "cpu"
    init = load_or_init_params(cfg, seed=0, device="cpu")
    again = load_or_init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(init[n], again[n]) for n in init)


def _read_address(proc, timeout=120):
    """(host, port), secret from the server's stderr, within ``timeout``: a
    reader thread feeds a queue, so a server that prints nothing cannot
    block the test."""
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stderr], daemon=True).start()
    deadline = time.time() + timeout
    addr = secret = None
    seen = []
    while secret is None and time.time() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.time()))
        except queue.Empty:
            break
        seen.append(line)
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        if m:
            addr = (m.group(1), int(m.group(2)))
        m = re.search(r"secret: (\S+)", line)
        if m:
            secret = m.group(1)
    assert addr and secret, "".join(seen)
    return addr, secret


def test_cli_serves_a_checkpoint_over_rpc(tmp_path):
    cfg = DecoderConfig.tiny()
    model, path = _checkpoint(tmp_path, cfg)
    engine = Engine(cfg, model, num_slots=2, device="cpu")
    slot, first = engine.admit(Request(prompt=PROMPT, params=SamplingParams(max_new=5)))
    want = [first]
    while len(want) < 5:
        want.extend(engine.step().tokens.values())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "maggy_tpu_torch.serve", "--config", "tiny", "--slots", "2", "--device", "cpu",
         "--checkpoint", path, "--host", "127.0.0.1", "--port", "0"],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
    )
    try:
        addr, secret = _read_address(proc)
        with ServeClient(addr, secret) as client:
            assert client.generate(PROMPT, max_new=5, timeout=60) == want[:5]
            stats = client.stats()
        assert stats["requests_done"] == 1 and stats["num_slots"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_serves_a_fleet_over_rpc(tmp_path):
    """``--replicas 2 --prefill-replicas 1``: a router on the address over
    two decode replicas and one prefill replica; every greedy stream
    equals an in-process engine's over the same checkpoint, every request
    goes through the prefill replica's handoff, and SIGTERM exits 0."""
    cfg = DecoderConfig.tiny()
    model, path = _checkpoint(tmp_path, cfg)
    prompts = [PROMPT, PROMPT[:3], [7, 7, 2, 9, 30, 31], [11, 12]]
    engine = Engine(cfg, model, num_slots=1, device="cpu", async_decode=False)
    want = []
    for prompt in prompts:
        slot, first = engine.admit(Request(prompt=prompt, params=SamplingParams(max_new=5)))
        stream = [first]
        while len(stream) < 5:
            stream.append(engine.step().tokens[slot])
        engine.release(slot)
        want.append(stream)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "maggy_tpu_torch.serve", "--config", "tiny", "--slots", "2", "--device", "cpu",
         "--checkpoint", path, "--host", "127.0.0.1", "--port", "0", "--replicas", "2",
         "--prefill-replicas", "1", "--slo-ttft-ms", "60000"],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
    )
    try:
        addr, secret = _read_address(proc)
        with ServeClient(addr, secret) as client:
            ids = [client.submit(p, max_new=5) for p in prompts]
            got = [client.result(i, timeout=60)["tokens"] for i in ids]
            stats = client.stats()
        assert got == want
        assert stats["fleet"] is True and len(stats["replicas"]) == 3
        assert [r["role"] for r in stats["replicas"]] == ["decode", "decode", "prefill"]
        assert stats["routing"]["handoffs"] == stats["routing"]["completed"] == len(prompts)
        assert stats["slo_ttft_ms"] == 60000
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("argv, item", [
    (["--mesh", "fsdp"], "item 7"),
    (["--mesh", "auto"], "item 9"),
    (["--replicas", "2", "--mesh", "fsdp"], "item 7"),
    (["--prefill-replicas", "1", "--mesh", "auto"], "item 9"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP queue 1 {item}")):
        main(["--config", "tiny", "--device", "cpu", *argv])


def test_cli_without_cuda_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("the refusal without CUDA needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", "tiny"])
