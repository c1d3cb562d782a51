"""The rest of the Trainer on a CUDA card: the prefetcher's pinned-ring,
side-stream copies, a checkpoint round trip, a bit-exact resume through the
flash kernels and the remat policies' kernel launches.

These need a CUDA card and nvcc: they skip elsewhere. On the card, run them
without the JAX package's test configuration:

    python -m pytest tests/test_torch_train_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from maggy_tpu_torch.models import Decoder, DecoderConfig
from maggy_tpu_torch.ops import flash
from maggy_tpu_torch.resilience import preemption
from maggy_tpu_torch.train import (
    Checkpointer,
    DevicePrefetcher,
    NativeBatchLoader,
    Trainer,
    adamw,
)

pytestmark = pytest.mark.cuda

# head_dim 64 in bf16: the flash kernels take it; whole-layer remat, as in llama3_8b
CFG = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256,
                         remat=True, remat_policy="nothing")
B, S = 2, 256


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    preemption.clear()
    yield torch.device("cuda", 0)
    preemption.clear()


def _tokens(rows=32, seed=0):
    return {"tokens": np.random.default_rng(seed).integers(0, CFG.vocab_size, (rows, S)).astype(np.int32)}


def test_prefetcher_hands_out_synchronised_tensors_on_the_card(card):
    # 64 MiB a batch, so a copy that the step did not wait for would show
    rows = [np.full((4096, 4096), i, dtype=np.float32) for i in range(6)]
    devices = []
    pf = DevicePrefetcher(iter([{"x": r, "n": np.int64(i)} for i, r in enumerate(rows)]),
                          put=lambda b: (devices.append(torch.cuda.current_device()), b)[1], depth=2, device=card)
    for i in range(6):
        batch = next(pf)
        x = batch["x"]
        assert x.device == card and batch["n"] == i
        # read on the current stream right away: it waited on the copy's event
        assert float(x.mean()) == float(i)
        del batch, x
        torch.empty((4096, 4096), device=card).fill_(-1)  # memory freed early would be reused here
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert set(devices) == {card.index}  # the producer thread made the card current


def test_prefetcher_raises_a_failed_copy(card):
    bad = {"x": np.array([object()], dtype=object)}  # no tensor type for it
    pf = DevicePrefetcher(iter([bad]), put=lambda b: b, depth=2, device=card)
    with pytest.raises(TypeError):
        next(pf)
    pf.close()


def test_prefetched_fit_on_a_second_card_from_a_trial_thread(card):
    """A trial thread that leased cuda:1 (as the port's lagom executors do)
    trains through fit's prefetcher: its producer thread copies onto cuda:1,
    nothing lands on cuda:0, and the losses equal those of the same fit
    without the prefetcher on that card, bit for bit."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.synchronize(0)
    before = torch.cuda.memory_allocated(0)
    out, errors = {}, []

    def trial():
        try:
            torch.cuda.set_device(1)
            lease = torch.device("cuda", 1)
            for depth in (2, 0):
                trainer = Trainer(Decoder(CFG, device="meta"), adamw(1e-3), device=lease)
                state = trainer.make_state(0, {"tokens": _tokens()["tokens"][:B]})
                seen = []

                class Record:
                    def broadcast(self, value, step):
                        seen.append(value)

                loader = NativeBatchLoader(_tokens(), B, seed=1)
                state, _ = trainer.fit(state, loader, 4, reporter=Record(), report_every=1, metrics_window=0,
                                       prefetch=depth)
                loader.close()
                out[depth] = (seen, all(p.device == lease for p in state.model.parameters()))
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(e)

    t = threading.Thread(target=trial)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    assert out[2][1] and out[0][1]
    assert len(out[2][0]) == 4 and out[2][0] == out[0][0]
    torch.cuda.synchronize(0)
    assert torch.cuda.memory_allocated(0) == before
    assert torch.cuda.current_device() == 0  # the trial's card stayed the trial thread's


def _trainer(seed):
    trainer = Trainer(Decoder(CFG, device="meta"), adamw(1e-3), device=card_device())
    state = trainer.make_state(seed, {"tokens": _tokens()["tokens"][:B]})
    return trainer, state


def card_device():
    return torch.device("cuda", torch.cuda.current_device())


def test_prefetched_fit_frees_the_model_without_the_collector(card):
    """The prefetcher holds the trainer (``put`` is its ``shard_batch``) only
    while the fit runs: once the caller drops its references, reference
    counting alone frees the model and the optimizer, with the cyclic
    collector off. A cycle through the prefetcher kept a finished trial's
    parameters and gradients on the card until a collection ran."""
    import gc
    import weakref

    trainer, state = _trainer(0)  # first-use set-up in this process, outside the check
    trainer.fit(state, NativeBatchLoader(_tokens(), B, seed=1), 1, prefetch=2)
    del trainer, state
    gc.collect()
    gc.disable()
    try:
        trainer, state = _trainer(0)
        loader = NativeBatchLoader(_tokens(), B, seed=1)
        state, _ = trainer.fit(state, loader, 3, prefetch=2)
        loader.close()
        refs = [weakref.ref(state.model), weakref.ref(state.optimizer), weakref.ref(trainer)]
        del trainer, state, loader
        assert [r() is None for r in refs] == [True, True, True]
    finally:
        gc.enable()


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    trainer, state = _trainer(0)
    loader = NativeBatchLoader(_tokens(), B, seed=1)
    state, _ = trainer.fit(state, loader, 3)
    loader.close()
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state.step, state, meta=trainer.checkpoint_meta())
    ckpt.wait()
    _, fresh = _trainer(7)
    ckpt.restore(fresh, expect_meta=trainer.checkpoint_meta())
    for (name, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert q.device == card and torch.equal(p, q), name
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        for key, v in state.optimizer.state[p].items():
            w = fresh.optimizer.state[q][key]
            assert w.device == v.device and torch.equal(w, v), key
    ckpt.close()


def test_resume_is_bit_exact_on_the_card(card, tmp_path):
    class Notice:
        def __init__(self, at):
            self.seen, self.at = [], at

        def broadcast(self, value, step):
            self.seen.append(value)
            if step == self.at:
                preemption.request()

    kw = dict(report_every=1, metrics_window=0)
    trainer, state = _trainer(0)
    loader = NativeBatchLoader(_tokens(), B, seed=1)
    assert loader.using_native
    ref = Notice(None)
    state, _ = trainer.fit(state, loader, 8, reporter=ref, **kw)
    loader.close()

    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=1)
    trainer, b_state = _trainer(0)
    loader = NativeBatchLoader(_tokens(), B, seed=1)
    first = Notice(5)
    b_state, out_b = trainer.fit(b_state, loader, 8, reporter=first, checkpointer=ckpt, checkpoint_every=4, **kw)
    loader.close()
    assert out_b["preempted"] == 1.0 and ckpt.latest_step() == 5 and ckpt.all_steps() == [5]
    preemption.clear()

    trainer, c_state = _trainer(99)
    loader = NativeBatchLoader(_tokens(), B, seed=1)
    rest = Notice(None)
    c_state, out_c = trainer.fit(c_state, loader, 8, reporter=rest, checkpointer=ckpt, resume="auto", **kw)
    loader.close()
    ckpt.close()
    assert out_c["resumed_from"] == 5.0
    assert first.seen + rest.seen == ref.seen
    for (name, p), q in zip(state.model.named_parameters(), c_state.model.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("remat,policy,fwd", [(False, "nothing", 1), (True, "nothing", 2), (True, "dots", 2),
                                              (True, "dots_attn", 1)])
def test_remat_policy_launches_and_gradients(card, remat, policy, fwd):
    import dataclasses

    tokens = torch.from_numpy(_tokens(rows=B)["tokens"]).to(card)

    def grads(cfg):
        model = Decoder(cfg, device=card, generator=torch.Generator(device=card).manual_seed(3))
        logits = model(tokens)
        logp = torch.log_softmax(logits[:, :-1].float(), -1)
        loss = -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()
        loss.backward()
        return loss.detach(), [p.grad for p in model.parameters()]

    ref_loss, ref = grads(dataclasses.replace(CFG, remat=False))
    flash.reset_launches()
    loss, got = grads(dataclasses.replace(CFG, remat=remat, remat_policy=policy))
    torch.cuda.synchronize()
    n = CFG.n_layers
    assert flash.LAUNCHES == {"flash_fwd": fwd * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert torch.equal(loss, ref_loss)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
