"""``Replica.start()`` against a ``kill()`` from another thread.

``start()`` builds the engine, scheduler and server, then publishes
``server`` and ``client`` under the replica's lock, where ``kill()`` and
``stop()`` clear them. A kill that lands while the stack is being built
wins: the replica stays DEAD with no server or client, the new stack is
shut down (its scheduler thread ends) and ``start()`` raises.
"""

import threading

import pytest
import torch

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.serve import ServeServer
from maggy_tpu_torch.serve.fleet import ReplicaSpec
from maggy_tpu_torch.serve.fleet.replica import DEAD, UP, Replica

torch.set_num_threads(2)
CFG = DecoderConfig.tiny(max_seq_len=64, dtype=torch.float32)


def _replica():
    state = Decoder(CFG, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    return Replica(0, ReplicaSpec(CFG, state, num_slots=1, device="cpu"), "secret")


def _scheduler_threads():
    return [t for t in threading.enumerate() if t.is_alive() and "sched" in t.name.lower()]


def test_kill_during_start_leaves_the_replica_dead(monkeypatch):
    replica = _replica()
    before = set(_scheduler_threads())
    started = ServeServer.start
    built = []

    def start_then_killed(server, *args, **kwargs):
        addr = started(server, *args, **kwargs)
        built.append(server)
        killer = threading.Thread(target=replica.kill)
        killer.start()
        killer.join(timeout=30)
        assert not killer.is_alive()
        return addr

    monkeypatch.setattr(ServeServer, "start", start_then_killed)
    with pytest.raises(RuntimeError, match="killed while it started"):
        replica.start()
    assert replica.state == DEAD and replica.server is None and replica.client is None
    assert not replica.alive() and replica.local_stats() is None
    assert built and built[0].scheduler is None  # the stack it built is let go
    for t in set(_scheduler_threads()) - before:
        t.join(timeout=10)
        assert not t.is_alive()


def test_start_then_kill_still_works():
    replica = _replica()
    replica.start()
    try:
        assert replica.state == UP and replica.server is not None and replica.client is not None
        assert replica.local_stats() is not None
    finally:
        replica.kill()
    assert replica.state == DEAD and replica.server is None and replica.client is None
