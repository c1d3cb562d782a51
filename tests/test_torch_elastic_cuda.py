"""Elastic membership on CUDA cards, at a small Decoder through the flash
kernels, by ``chip_smoke.py``'s ``dist.elastic`` train_fn and runner:

* workers mode under ``data_plane="local"``: two replicas from one seed,
  rank 1 killed by chaos at step 2; the survivor reshapes once at its next
  step boundary (one save, no step re-run), and every loss it reports is
  the dense ``Trainer``'s on the same card, bit for bit;
* with two cards, ``num_slices=2`` over NCCL: slice 1 dropped at step 3 and
  rejoined at step 5, each rank leaving its group and joining one at the
  new width twice in its process; the chief resumes from 2, then 5, at
  epoch 2, every loss within 5e-4 of the dense ``Trainer``'s.

These need a CUDA card and nvcc: they skip elsewhere. On the card, run them
without the JAX package's test configuration:

    python -m pytest tests/test_torch_elastic_cuda.py -q --noconftest
"""

import pytest
import torch

from maggy_tpu_torch.models import DecoderConfig

pytestmark = pytest.mark.cuda

# head_dim 64 in bf16: the flash kernels take it; whole-layer remat, as in llama3_8b
CFG = DecoderConfig.tiny(vocab_size=1024, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=256,
                         remat=True, remat_policy="nothing")
S, STEPS = 256, 6


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    yield torch.device("cuda", 0)


def test_workers_mode_survivor_is_bit_equal_to_one_process(card):
    import chip_smoke as c

    ref, _ = c.reference_steps(torch, CFG, 2, S, STEPS)
    hparams = dict(mode="workers", rows=2, seq=S, steps=STEPS, every=10 * STEPS, hold_at=3)
    result, procs, counters, gauges, _, _ = c._elastic_run(
        torch, CFG, "kill:worker=1,step=2", hparams, 120, sharding="dp", num_executors=2, data_plane="local")
    assert result["num_workers"] == 1
    assert counters.get("resilience.slice_drops") == 1 and counters.get("resilience.dist_restarts", 0) == 0
    assert gauges.get("resilience.membership_epoch") == 1
    (survivor,) = [p for p in procs if len(p) == 2]
    assert survivor[1]["resume_from"] == len(survivor[0]["served"]) <= 3
    assert c._committed(survivor, STEPS)
    assert [t[0] for e in survivor for t in e["times"]] == ["save", "restore"]
    for entry in survivor:
        for step, loss in entry["losses"].items():
            assert loss == ref[int(step) - 1], (entry["epoch"], step)
    per_step = c.flash_launches_per_step(CFG.n_layers)
    assert all(c._launches_exact(e, per_step) for p in procs for e in p)


def test_two_slices_reform_over_nccl(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import chip_smoke as c

    ref, norms = c.reference_steps(torch, CFG, 4, S, STEPS)
    hparams = dict(mode="slices", rows=4, seq=S, steps=STEPS, every=2, keep=[2, 5])
    result, procs, counters, gauges, _, _ = c._elastic_run(
        torch, CFG, "slice_drop:slice=1,step=3;slice_rejoin:slice=1,step=5", hparams, 120, sharding="fsdp",
        num_executors=2, num_slices=2, data_plane="auto")
    assert result["num_workers"] == 2
    assert gauges.get("resilience.membership_epoch") == 2
    assert counters.get("resilience.slice_drops") == 1 and counters.get("resilience.slice_rejoins") == 1
    chief = sorted((e for p in procs for e in p if e["rank"] == 0), key=lambda e: e["epoch"])
    assert [(e["epoch"], e["resume_from"], e["world"]) for e in chief] == [(0, 0, 2), (1, 2, 1), (2, 5, 2)]
    assert c._committed(chief, STEPS)
    for p in procs:
        assert len({e["device"] for e in p}) == 1  # a rank keeps its card
        for e in p:
            for step, loss in e["losses"].items():
                assert abs(loss - ref[int(step) - 1]) <= 5e-4 * abs(ref[int(step) - 1])
