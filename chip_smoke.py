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
            synthetic batches, through fit's prefetcher (depth 2), after a
            one-step warm-up fit: every loss finite, and each kernel
            launched exactly as often as the layers and remat demand.
    moe.model  ``MoEDecoder(mixtral_8x7b(n_layers=2))`` (vocab 32,000, d 4096,
            32 / 8 heads, d_ff 14,336, 8 experts, top-2; 3.16 B fp32
            parameters) from a seed at B=2, S=2048 through the flash
            kernels: each layer's attention output against the plain
            version on the same q/k/v; the logits against the same weights
            with ``default_attention``, with the plain version and with a
            planted fault (no causal mask), each over the tokens that both
            route to the same experts in every layer (a router near a bf16
            tie sends a token elsewhere under any other right attention; the
            share that flips stands beside the yardstick's); 2 / 0 / 0
            launches; then 16 greedy cached-decode steps after a 32-token
            prompt against the full forward (at the capacity that drops no
            token) and ``generate``'s tokens; budget 30 s.
    moe.train  ``Trainer.fit`` of that model (remat ``dots_attn``): a warm-up
            step, 6 steps; finite losses, the router's aux loss in
            ``aux_loss`` and ``total_loss``, flash launches 2 / 2 / 2 a step,
            peak under 75 GiB; step ms, tokens/s, the step's matmul TFLOP
            and bound; ``--profile`` splits a step by kind (expert matmuls,
            dispatch and combine einsums, projections, attention, AdamW,
            loss); budget 90 s.
    dist.moe  with two or more cards, ``lagom(train_fn,
            DistributedConfig(sharding=ShardingSpec(...)))``, one NCCL
            rank a card, moe.train's weights, data and steps: ep=2 on two;
            ep=4 (2 experts a rank), fsdp=2 and ep=2 x fsdp=2 (4 a rank) on
            four. Expert parallelism alone is held to moe.train's rank at
            every step (dist.mesh's limits); under a batch split the warm-up
            step is, and ep=2 x fsdp=2 at every step to fsdp=2 alone, its
            yardstick (the same split, no expert axis). Experts a rank,
            exact launches, the trainer's grad norm against the gathered
            gradients, step ÷ moe.train's, peak; budget 150 s. With one
            card ``"ran": false``. Its specs and dist.moe.mesh's run as one
            study a rank count (their ranks run the specs in turn; a
            study's first spec is its ``DistributedConfig(sharding=)``:
            ep=2 on two cards, pp=2 and pp=2 x ep=2 on four), whose seconds
            both phases hold to their budgets.
    dist.moe.mesh  the same under tensor and pipeline parallelism, alone
            and with the expert axis, 3 steps after the warm-up: tp=2 and
            pp=2 (2 microbatches of one row) on two cards; ep=2 x tp=2,
            pp=2 x ep=2 and pp=2 x tp=2 on four; pp=2 x tp=2 x ep=2 on
            eight (else ``"ran": false`` for it). Every step held to
            moe.train's rank (dist.mesh's loss limit; the warm-up's grad
            norm too, its aux loss within JAX's 1e-3), every step of a spec
            with ``expert`` to its yardstick without it (ep=2 x tp=2 to
            tp=2, pp=2 x ep=2 to pp=2); each step's share of tokens routed
            to other experts than on one card; a planted fault (tp=2, the
            expert weights left out of the optimizer) must break the loss
            limit; exact launches per rank (16 / 4 heads a rank under tp; a
            stage's layers per microbatch under pp), experts a rank, step ÷
            moe.train's, peak; budget 180 s. With one card ``"ran": false``.
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
9. serve.model  ``Decoder(llama3_8b(n_layers=16))`` (cut from 32 layers for
            the run's time; fp32 masters from a seed, a bf16 copy of the
            projections): prompts of
            100, 517, 1000 and 2000 tokens prefilled into a dense and a paged
            batch cache (shuffled page tables), then 32 greedy steps of the
            batch. Every position's logits against the training forward (the
            flash forward kernel) over the same tokens, beside the kernel's
            plain version as the yardstick; paged against dense bit for bit;
            a planted fault (one request's page table with two pages swapped)
            that the limit must catch; the cache path launches no kernel.
10. serve.engine  ``Engine`` over that model, ``num_slots=8``, with its defaults
            (paged, page 16, prefix reuse, async): 16 requests, 64-1536
            tokens, eight sharing a 512-token system prefix, half greedy and
            half sampled. Every request finishes; prefix hits; the streams
            again paged-sync and dense-async and in a permuted order, equal;
            each prefix hit's first-token logits against a full prefill; the
            streams once more without prefix reuse (the full-prefill streams
            a prefill handoff gives). Then ``serve.engine.times``: prefill
            per bucket, a decode step with every slot busy beside its bound,
            and the device's busy share over it (torch.profiler); then the
            same engine serves the 16 requests and the busy step is taken
            again (``after_run``), with the cyclic collector off as well and
            the top host operations beside the kernels.
    serve.sched  the same requests through the serving stack: ``Engine``
            with its defaults (the host tier on) behind the ``Scheduler`` and
            a ``ServeServer`` on localhost, submitted by a ``ServeClient``
            over the three QoS classes and two tenants. Every request done,
            none failed, rejected or expired; every stream equal to
            ``serve.engine``'s bit for bit; the prefix hits; no flash launch;
            one decode shape and no recompile alert. TTFT, TPOT and queue
            wait percentiles and tokens/s from SSTATS; with every slot
            busy, the loop's decode step beside the same engine stepped
            directly; a profile capture, forced on the loop's metrics
            tick, that must write a torch.profiler trace.
    serve.tier  page pressure: a pool of half the requests' worst case; the
            shared-prefix requests best-effort in every slot, then the rest
            premium. At least two preemptions, every victim best-effort,
            every one spilled to host memory and swapped back in; then four
            requests through the prefill handoff (``prefill_only``, a pack,
            the scheduler's ``admit_from_kv``) and three shared-prefix
            requests filled from the host tier's prefix pack. Every stream
            equal to ``serve.engine``'s bit for bit; no request failed. The
            spill, swap-in, ``prefill_only`` and ``admit_from_kv`` times.
    serve.fleet  the fp32 masters of the projections freed, one serving
            state on the card: ``launch_fleet`` with 2 decode replicas and 1
            prefill replica of 8 slots, all on ``cuda:0``. The 16 requests
            through the router, staggered: every stream equal to
            ``serve.engine``'s full-prefill stream, 16 routed and completed,
            none requeued, both decode replicas serving, 16 handoffs, no
            flash launch, every replica's projections one storage, the
            monitor's fleet panel with every replica row. Again with replica
            1 killed mid-stream (``replica_kill``): equal streams, requeues,
            one respawn inside the budget, the card's allocated memory back
            within 1 GiB without the collector. Then one replica under the
            autoscaler (min 1, max 2): a scale-out built on the card and
            admitted through the probation gate, a drain-safe scale-in,
            streams equal. TTFT, TPOT, tokens/s, each decode replica's step
            in the first and last quarter of the run, spawn to UP, peak.
    serve.cli  after the weights are freed: ``python -m maggy_tpu_torch.serve
            --config llama3_8b --slots 4`` as its own process, four requests
            through ``ServeClient``, SIGTERM and exit 0 within 60 s; its
            init time, start-up, first TTFT and peak memory. Then
            ``serve.cli.fleet``: the same with ``--replicas 2
            --prefill-replicas 1``, every request handed off.
11. lagom.train  the ``train`` configuration as the train_fn of the port's
            ``lagom``: ``HyperparameterOptConfig(num_trials=2,
            optimizer="randomsearch", seed=0)`` over ``lr`` in [1e-5, 1e-4],
            no ``device``, so each executor leases a card and makes it
            current. Each trial builds the model on its lease, takes a
            warm-up step and 4 ``Trainer.fit`` steps at B=2, S=2048. It fails
            unless both trials finish without error, each returned metric
            is its last broadcast, every loss is finite, each trial ran on
            its lease (current device and every parameter), the flash
            kernels launched 2 x (1 + 4) x the ``train`` step's count, no
            executor thread is left, each leased card's memory is back
            within 1 GiB and the phase's peak is within 2 GiB of one
            trial's (trials in turn on one card do not stack up). With two
            or more cards the trials run at once on disjoint cards. Each
            trial's step time (``fit``'s wall over its steps, as in
            ``train``) stands beside the ``train`` phase's, with the gaps
            between broadcasts and their median as a side figure, and the
            study's wall time beside the union of the ``train_fn`` windows.
12. lagom.ablation  the ablation experiment: two LOCO studies under the
            port's ``lagom(train_fn, AblationConfig(...))``, no factory, the
            config model on the meta device, each trial on its leased card.
            BERT-base (BASELINE config 4: 12 layers, d 768, 12 heads, d_ff
            3072, vocab 30,522, S=512) over ``layer_0``, ``layer_11``,
            ``pooler``, ``position_embeddings`` and the feature
            ``attention_mask`` (6 trials) on a seeded dataset with padded
            tails, each trial a warm-up and 10 AdamW steps at B=32 in bf16
            (dropout on): every trial's variant new and on the meta device,
            its parameter count the base's less exactly the dropped
            component's own, the feature trial's dataset without the key,
            no marker in any ``hparams``, finite losses, no flash launch (as
            in JAX, BERT's attention is the plain blockwise version), and
            the full model's bf16 forward within 5e-2 relative L2 of its
            fp32 forward. Then the ``train`` Decoder over ``mlp`` and
            ``layers.1`` (3 trials of a warm-up step and 3 fit steps): the
            flash kernels launched 3 x (1 + 3) x the ``train`` step's count
            (a gate multiplies; it skips nothing), the gated components'
            last gradients exactly zero through the CUDA dQ and dK/dV
            kernels and the baseline's not, each trial's step within 1.25 x
            ``train``'s. After both: no executor thread left and the card's
            memory back within 1 GiB. Steps/s, peaks, times; budget 120 s.
13. dist.lagom  the ``train`` configuration as the train_fn of the port's
            ``lagom(train_fn, DistributedConfig(sharding="fsdp",
            num_executors=1))``: one spawned process, an NCCL rank on card
            0, FSDP2 over a one-rank mesh. Its warm-up step and 6 fit steps
            from the ``train`` phase's weights and batches: every loss within
            1e-5 and the first and last grad norms within 1e-4 of ``train``'s
            (relative), the trainer's grad norm within 1e-5 of the one
            from every gradient gathered whole, the flash kernels launched
            8 / 4 / 4 a step as in ``train``, every parameter on the card,
            the card's free memory
            back within 1 GiB after the study, the phase inside 90 s (the
            rank is killed past it). Its step time beside ``train``'s.
14. dist.mesh  the flash kernels at the tensor-parallel head counts (tp=2:
            16 and 4 heads, tp=4: 8 and 2) against their plain versions,
            timed beside their bounds, SDPA and the plain versions, on any
            number of cards. With two or more cards, one process per card
            over NCCL under dp=2, fsdp=2 and tp=2 (and fsdp=2 x tp=2 on
            four), each the same steps from the same weights: every rank's
            losses within 5e-4 and grad norms within 2e-3 of dist.lagom's
            single rank, the warm-up step's norm of each gradient group
            (each gradient gathered whole) within 2e-2 of its, and the
            trainer's grad norm within 1e-5 of the groups', the launches as there; budget 150 s. With one card
            it reports ``"ran": false`` beside the kernel times.
15. dist.seq  the flash kernels at Ulysses' local shape of ``ring.train``
            (B=1, S=8192, sp=4: 8 query and 2 KV heads, D=128, causal; never
            run as one chunk before) against their plain versions, timed
            beside their bounds, SDPA and the plain versions, on any number
            of cards. With four cards, one process per card over NCCL, the
            ``train`` configuration from ``dist.lagom``'s weights and
            batches under ring attention over the mesh's ``seq`` axis at
            sp=2 x fsdp=2 and sp=2 x tp=2, and Ulysses
            (``make_ulysses_attention``) at sp=4 and sp=2 x dp=2: every
            rank held to dist.lagom's single rank under dist.mesh's limits,
            the ring launches exact for the rank's chunk (chunk r runs r + 1
            steps of the causal ring) and Ulysses' flash launches as
            ``train``'s; budget 150 s. With fewer cards ``"ran": false``
            beside the kernel times.
16. dist.zero  with two or more cards, dp=2 dense, bucketed
            (``bucket_mb=64``) and ZeRO-1 (``zero_stage=1, bucket_mb=64``),
            and dp=4 ZeRO-1 on four: every rank held to dist.lagom's single
            rank alike, the trainer's resolved mode, the flash launches,
            and ZeRO-1's optimizer bytes a rank at most the dense layout's
            / dp + 10 %; each mode's step and peak beside dense dp=2's;
            budget 120 s. With one card ``"ran": false``.
17. dist.pipe  on any number of cards, the single-stage path of
            ``pipeline_grads_1f1b`` on the ``train`` configuration (a
            ``DecoderStage`` holding the whole Decoder, from the ``train``
            phase's seed): M = 4 microbatches a step, each the ``train``
            batch (its rows 4 times), so the mean and the gradient are
            ``train``'s own: every loss within 1e-5 and the first and last
            grad norms within 1e-4 of ``train``'s, the flash kernels launched
            16 / 16 / 16 a step (4 layers x 4 microbatches: no layer remat in
            a stage). With two cards pp=2, with four pp=4, pp=2 x dp=2 and
            pp=2 x tp=2, one process per card over NCCL from dist.lagom's
            weights, ``n_microbatches = 2 pp``, each microbatch the ``train``
            batch: every rank held to dist.lagom's single rank under
            dist.mesh's limits (its gradient groups over the stages), the
            flash launches exact for its stage (layers a stage x
            microbatches, the forward twice on every stage but the last,
            whose backward tick runs the only forward), each stage's step
            beside M x the single rank's and the bubble (S-1)/(M+S-1), its
            peak; budget 150 s. With fewer cards ``"ran": false``.
18. pod.elastic  pod mode: a user script run by ``python -m
            maggy_tpu_torch.run --workers 2 --elastic 1`` as a subprocess
            (this process frees its cached card memory first), whose
            ``lagom(train_fn, DistributedConfig(sharding="dp"))`` trains the
            ``train`` widths at depth 1 (1.27 B fp32 parameters, B=2,
            S=2048) in both processes: on one card two replicas on
            ``cuda:0`` (``data_plane="local"``), on two or more
            ``--global-mesh`` dp=2 over NCCL (rank r on card r, every loss
            within 5e-4 of one process's); one checkpoint, rank 0's. Six
            steps, a synchronous checkpoint after step 2; generation 0's
            rank 1 SIGKILLs itself after step 3. The launcher must restart
            the generation, which resumes at step 2 and ends at step 6 on
            both ranks; its step-3 losses equal generation 0's bit for bit;
            on one card the replicas' losses are equal; the flash launches
            2 / 1 / 1 a step on every rank. Each process's start to first
            step, the save and restore, the restart's wall time and the
            peak a rank; budget 120 s.
19. pod.hpo  ``python -m maggy_tpu_torch.run --workers 2 --respawn 1``
            over ``lagom(train_fn, HyperparameterOptConfig(num_trials=3))``:
            the driver's process runs one local trial executor on
            ``cuda:0``, the worker process leases ``cuda:0`` through
            ``MAGGY_TPU_WORKER_DEVICES=0``; each trial 2 steps of the depth-1
            Decoder. The worker SIGKILLs itself inside its first trial: the
            launcher respawns it, the lost trial is requeued, all 3 trials
            finish once, each with exact flash launches. Each trial's mean
            step and the study's wall time; budget 90 s.
    dist.elastic  elastic membership under ``lagom(train_fn,
            DistributedConfig(elastic=True))`` at the ``train`` widths and
            depth 1 (1.27 B fp32 parameters, S=2048), from this process (its
            cached card memory freed first). Workers mode, one slice a
            rank, ``data_plane="local"``: two replicas from seed 0 (on one
            card both on ``cuda:0``), each a ``Trainer`` with the rank's
            membership; chaos kills rank 1 at step 3. The driver makes the
            death a slice drop (epoch 1, no restart slot); the survivor
            meets the new epoch at its next step boundary, saves once there
            (the only save: no periodic one in the run) and re-enters its
            train_fn from it. The run completes with one worker, 0 restart
            slots, one drop; every loss of the survivor, after the reshape
            too, equal bit for bit to one uninterrupted process's; no step
            re-run; the flash launches 2 / 1 / 1 a step. The save, the
            restore, the reshape barrier and the phase's time; budget 120 s.
    dist.elastic.slices  with two or more cards: ``num_slices=2``,
            ``data_plane="auto"`` over NCCL, one rank a slice (two, fsdp=2,
            on four cards), 4 rows a batch, 6 steps; chaos drops slice 1 at
            step 3 and rejoins it at step 5, so each rank leaves its group
            and joins one at the new width twice in its process. The
            periodic checkpoint at step 2 (the others are skipped: each is
            a 15.3 GB synchronous write) and the rejoin's graceful one at 5.
            Epoch 2, the chief resuming from 2 then 5, every batch index
            committed once, the parked slice's ranks back at step 5, every
            rank's losses within 5e-4 and its last grad norm within 2e-3 of
            one process's, flash launches exact; the reshape barriers and
            each re-formation's time; budget 180 s. With one card
            ``"ran": false``.
20. train.resume  the ``train`` configuration cut to 2 layers (so that the
            whole run keeps under its time), from disk: seeded tokens
            written by ``write_sharded`` into a temporary directory, read
            through ``ShardedDataset`` and the native batcher (it must be
            native) into ``fit``'s prefetcher (depth 2). Run A takes 8
            steps; run B, from the same seed, checkpoints every 4 steps
            (``Checkpointer(max_to_keep=1)``) and gets a preemption notice
            from its reporter after step 5: an async save at 4, the
            synchronous save at 5, ``preempted=1.0``; run C, from another
            seed, calls ``fit(num_steps=8, resume="auto")``. Steps 6-8 of C
            must equal A's losses bit for bit and the final parameters A's
            (an exact checksum per tensor); the flash launches exact; the
            card's memory back within 1 GiB and the phase's peak within
            2 GiB of the ``train`` phase's (nothing staged on the card). It
            fails, before running, when the disk holds less than two
            checkpoints. It prints the bytes a checkpoint, each save's
            blocked and commit time, the restore time, the step through
            the prefetcher and ``input_wait_ms``.
21. train.remat  one forward and backward of the ``train`` configuration on
            one batch under ``remat=False``, ``"nothing"``, ``"dots"`` and
            ``"dots_attn"``, from the same parameters, gradients cleared
            between them: the loss and every gradient equal to
            ``remat=False``'s bit for bit, flash forward launches 4 / 8 / 8 /
            4 and backward 4 + 4 under each; each policy's time and peak.

Then a ``{"kernels": [...]}`` line (each kernel's launches: those of
``train``, ``moe.model``, ``moe.train``, rank 0 of ``dist.moe`` and of each ``dist.moe.mesh`` spec, ``ring.train``, ``lagom.ablation``'s Decoder study,
``dist.lagom``'s rank, rank 0 of ``dist.mesh``, ``dist.seq``, ``dist.zero``
and ``dist.pipe`` (its single-stage part too), every rank of
``pod.elastic``, every trial of ``pod.hpo``, every rank of both
``dist.elastic`` runs, ``train.resume`` and ``train.remat``), the card's
name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before that line. With no CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import statistics
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
# the serving phases: Llama-3-8B at depth SERVE_LAYERS (cut from the full
# 32 so that the whole run, with the MoE phases, keeps under ~950 s), fp32
# masters and a bf16 serving copy of the projections on one card; the CLI
# phases still start the full model in their own process. serve.model's
# prompts are ragged, no multiple of the 256-token read chunk or the 16-token
# page
SERVE_LAYERS = 16
SERVE_PROMPTS = (100, 517, 1000, 2000)
SERVE_STEPS = 32
SERVE_PAGE = 16
ENGINE_SLOTS = 8
ENGINE_REQUESTS = 16
ENGINE_SHARED = 8  # requests that share a system prefix of ENGINE_SYSTEM tokens
ENGINE_SYSTEM = 512
PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048)
# the cache path's logits against the training forward's, per row (one
# position's logits over the vocabulary). At 32 layers of random bf16 weights
# two right attentions are further apart than at 4: the flash kernel and its
# plain version (fp32 scores) on the same weights and tokens differed by
# 4.3e-2 (median) to 5.9e-2 (worst row) on an H100, so the 4-layer model
# phase's 3e-2 cannot hold; the planted page-table fault moved its rows by
# 0.72 (median) to 0.92. The limit sits between: 1.7x the yardstick's worst
# row, and the fault must exceed it at its median row, not only its worst.
# The limit was set at 32 layers and holds at SERVE_LAYERS unchanged
TOL_SERVE_LOGITS_REL_L2 = 1e-1
# lagom.train: the `train` configuration as the train_fn of an HPO study of
# LAGOM_TRIALS trials, LAGOM_STEPS steps each after a warm-up step
LAGOM_TRIALS = 2
LAGOM_STEPS = 4
LAGOM_HB = 0.5
# lagom.ablation: two LOCO studies under the port's lagom. BERT-base (BASELINE
# config 4: 12 layers, d 768, 12 heads, d_ff 3072, vocab 30,522, S=512) over
# two layers, the pooler, the position embeddings and the attention mask,
# each trial ABL_BERT_STEPS AdamW steps (after a warm-up step) at B=32 in
# bf16 on a synthetic dataset of ABL_BERT_ROWS rows with padded tails; then
# the `train` Decoder over the MLPs and layer 1, each trial a warm-up step
# and ABL_DECODER_STEPS fit steps. The phase's budget is ABL_BUDGET_S
ABL_BERT_B = 32
ABL_BERT_ROWS = 64
ABL_BERT_STEPS = 10
ABL_BERT_COMPONENTS = ("layer_0", "layer_11", "pooler", "position_embeddings")
ABL_BERT_FEATURE = "attention_mask"
ABL_DECODER_COMPONENTS = ("mlp", "layers.1")
ABL_DECODER_STEPS = 3
ABL_BUDGET_S = 120
# BERT-base's bf16 forward against its fp32 forward on the same weights and
# eight rows of the dataset (eval mode): every projection, LayerNorm output
# and residual add rounds to bf16, through 12 layers; a CPU rehearsal at
# these widths measured 1.1e-2 on the sequence output and 1.5e-2 on the two
# pooled logits a row
TOL_BERT_BF16_REL_L2 = 5e-2
# a Decoder trial's step (fit's mean, as in `train`) against the `train`
# phase's: the gates add two multiplies a layer
ABL_STEP_FACTOR = 1.25
# the card's allocated memory after both studies against before the phase
ABL_MEMORY_MARGIN_GIB = 1.0
# dist.lagom: the `train` configuration as the train_fn of
# lagom(train_fn, DistributedConfig(sharding="fsdp", num_executors=1)): one
# spawned NCCL rank, FSDP2 on a one-rank mesh. Its warm-up step and
# TRAIN_STEPS fit steps run on the `train` phase's weights and batches, in
# the same order, so each loss and grad norm stands beside `train`'s. On one
# rank FSDP2's gather and reduction are copies and the step computes what
# the dense step computes; what differs is the order of the grad norm's sum
# (a sum of shard squares, then one all-reduce): the loss is held to 1e-5 and
# the grad norm to 1e-4 relative. The rank is killed, and the phase fails,
# past DIST_LAGOM_BUDGET_S
TOL_DIST_LAGOM_LOSS_REL = 1e-5
TOL_DIST_LAGOM_GRAD_NORM_REL = 1e-4
DIST_LAGOM_BUDGET_S = 90
DIST_MEMORY_MARGIN_GIB = 1.0
# dist.mesh: with two or more cards, one process per card under dp=2,
# fsdp=2 and tp=2 (and the "2d" preset on four cards), each the same steps
# from the same weights, every rank held to dist.lagom's single rank. The
# batch rows (dp, fsdp) or the heads (tp) are split over the cards, so bf16
# products sum in another order (a GEMM over one row instead of two, tp's
# partial sums of wo and w_down added over the cards). Four H100s read at
# most 3.7e-5 (loss) and 1.2e-4 (grad norm) relative over the 7 steps; the
# limits sit about 13 x and 16 x above, and tools/mesh_fault_check.py
# reads what planted mesh faults do against them. Budget
# DIST_MESH_BUDGET_S for the phase; it also times the flash kernels at the
# tp-local head counts (tp=2: 16 and 4 heads, tp=4: 8 and 2), on one card too
TOL_MESH_LOSS_REL = 5e-4
TOL_MESH_GRAD_NORM_REL = 2e-3
# A fault on a small leaf hides under those: the norm scales' gradients
# are too small a share of the norm and of the loss's 7 steps (four
# H100s: one rank's norm-scale gradients zeroed, or a replicated gradient
# counted twice in the norm, read at most 1.5e-4 and 3.7e-4 under tp). So
# each rank also takes, at the warm-up step, the norm of each gradient
# group (norm scales, embedding, attention, MLP, lm_head), every gradient
# gathered whole: each within TOL_MESH_GROUP_NORM_REL of the one rank's,
# and the trainer's sharded grad norm within TOL_GRAD_NORM_COUNT_REL of
# the groups' (the same fp32 squares summed in another order)
TOL_MESH_GROUP_NORM_REL = 2e-2
TOL_GRAD_NORM_COUNT_REL = 1e-5
DIST_MESH_BUDGET_S = 150
# dist.seq: with four cards, the seq axis inside the mesh (the ring over
# sp=2 x fsdp=2 and sp=2 x tp=2, Ulysses over sp=4 and sp=2 x dp=2), the
# same steps from the same weights, every rank held to dist.lagom's single
# rank under dist.mesh's limits; on any number of cards the flash kernels
# at Ulysses' local shape of ring.train (B=1, S=8192, sp=4: 8 and 2 heads)
DIST_SEQ_BUDGET_S = 150
# dist.zero: with two or more cards dp=2 dense, bucketed and ZeRO-1 (dp=4
# ZeRO-1 on four), held alike; ZeRO-1's optimizer bytes a rank at most the
# dense layout's / dp, plus ZERO_BYTES_MARGIN (JAX's test: the bucket
# padding and the step counters)
DIST_ZERO_BUDGET_S = 120
ZERO_BUCKET_MB = 64
ZERO_BYTES_MARGIN = 0.10
# dist.pipe: the single-stage 1F1B path over PIPE_SINGLE_MICRO microbatches
# of the `train` batch, held to `train` under dist.lagom's limits; with two
# or more cards the stages over NCCL (n_microbatches = 2 pp), each rank held
# to dist.lagom's single rank under dist.mesh's limits
PIPE_SINGLE_MICRO = 4
DIST_PIPE_BUDGET_S = 150
# pod.elastic and pod.hpo: the `train` widths at depth POD_LAYERS (fp32
# parameters, ~1.27 B of them: two processes fit one card), each process
# started by `python -m maggy_tpu_torch.run`. pod.elastic: POD_STEPS steps, a
# synchronous checkpoint after step POD_SAVE_AT, rank 1 of generation 0
# killed after step POD_KILL_AT; pod.hpo: POD_HPO_TRIALS trials of
# POD_HPO_STEPS steps, the worker killed inside its first trial
POD_LAYERS = 1
POD_STEPS = 6
POD_SAVE_AT = 2
POD_KILL_AT = 3
POD_ELASTIC_BUDGET_S = 120
POD_HPO_TRIALS = 3
POD_HPO_STEPS = 2
POD_HPO_BUDGET_S = 90
# dist.elastic: the `train` widths at depth POD_LAYERS under elastic
# membership. Workers mode: two replicas, rank 1 killed by chaos at step
# ELASTIC_KILL_AT, the survivor held at the broadcast of step
# ELASTIC_KILL_AT + 1 until the heartbeat announced the new epoch (up to
# ELASTIC_HOLD_S), so that it meets the reshape at the next step boundary
# however fast it trains. Slices (2+ cards): 2 slices, ELASTIC_ROWS rows a
# batch (a row for each of four ranks), slice 1 dropped at ELASTIC_DROP_AT
# and rejoined at ELASTIC_REJOIN_AT, the periodic checkpoint only at
# ELASTIC_SAVE_AT
ELASTIC_STEPS = 6
ELASTIC_KILL_AT = 3
ELASTIC_HOLD_S = 60
ELASTIC_ROWS = 4
ELASTIC_DROP_AT, ELASTIC_REJOIN_AT, ELASTIC_SAVE_AT = 3, 5, 2
DIST_ELASTIC_BUDGET_S = 120
DIST_ELASTIC_SLICES_BUDGET_S = 180
# train.resume: the `train` configuration at depth RESUME_LAYERS (cut from
# N_LAYERS so that the whole run, with dist.elastic, keeps under ~900 s)
# from ROWS rows of tokens written as SHARDS shards; run A takes STEPS
# steps, run B checkpoints every EVERY steps until a preemption notice
# after step NOTICE, run C resumes it. A checkpoint is the fp32 parameters
# and both AdamW moments, 12 bytes a parameter
RESUME_LAYERS = 2
RESUME_STEPS = 8
RESUME_EVERY = 4
RESUME_NOTICE = 5
RESUME_ROWS = 64
RESUME_SHARDS = 4
RESUME_DATA_SEED = 7
# the MoE phases: Mixtral-8x7B widths (vocab 32,000, d 4096, 32 / 8 heads,
# d_ff 14,336, 8 experts, top-2, capacity factor 1.25, groups of 512
# tokens) at depth MOE_LAYERS: 1.451 B parameters a layer, 3.16 B in all,
# ~50.6 GB of fp32 state with the gradients and both AdamW moments. B=2,
# S=2048: 8 groups, 160 slots an expert and group. moe.model's cached
# decode runs MOE_DECODE_STEPS greedy steps after a MOE_DECODE_PROMPT-token
# prompt, against the full forward of the same weights at the capacity
# factor that drops no token (n_experts / top_k: every expert can take
# every token of a group), which is what one token a step computes
MOE_LAYERS = 2
MOE_DECODE_PROMPT = 32
MOE_DECODE_STEPS = 16
TOL_MOE_DECODE_REL_L2 = 3e-2
MOE_PEAK_LIMIT_GIB = 75.0
MOE_MODEL_BUDGET_S = 30
MOE_TRAIN_BUDGET_S = 90
DIST_MOE_BUDGET_S = 150
# dist.moe.mesh: the MoE decoder under tensor and pipeline parallelism, with
# and without the expert axis; pp specs run MOE_MESH_MICRO microbatches (one
# of moe.train's two rows each)
DIST_MOE_MESH_BUDGET_S = 180
MOE_MESH_MICRO = 2
MOE_MESH_STEPS = 3
# JAX's bound on a pipelined MoE step's aux loss against the whole batch's:
# a pipeline's router statistics are each microbatch's
TOL_PIPE_AUX_ABS = 1e-3
# train.remat: each setting in turn, remat=False first (the reference)
REMAT_ORDER = ((False, "nothing"), (True, "nothing"), (True, "dots"), (True, "dots_attn"))
# the whole run must end inside 1200 s: one still going at RUN_DEADLINE_S
# prints every thread's Python stack on stderr and exits non-zero
RUN_DEADLINE_S = 1140
T0 = time.perf_counter()
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
    # progress on stderr, where a run cut short shows how far it got
    print(f"chip_smoke: {phase} at {time.perf_counter() - T0:.1f} s", file=sys.stderr, flush=True)


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


def flash_launches_per_step(n_layers: int) -> dict:
    """What one train step of ``Decoder(llama3_8b(n_layers))`` launches."""
    return {
        "flash_fwd": 2 * n_layers,  # forward, and again under remat
        "flash_bwd_dq": n_layers,
        "flash_bwd_dkv": n_layers,
    }


def phase_train(torch, n_layers: int, seq: int, steps: int, card: str, profile: bool, reference=None):
    """Phase 4. With a ``reference`` dict, fills it with the dense steps
    dist.lagom is held to: the warm-up step's loss and grad norm, then the
    timed fit's losses and its last grad norm."""
    from maggy_tpu_torch import telemetry
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

    # warm-up: first-call set-up stays out of the times. It is a one-step
    # fit, so the prefetcher's one-time set-up in this process (its thread's
    # first CUDA stream makes PyTorch build its stream pool) is paid here;
    # its wait for that first batch is reported beside the steps
    warm = telemetry.Telemetry(worker="train.warmup")
    with telemetry.current(warm):
        state, warm_metrics = trainer.fit(state, data, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()

    def timed_fit(name, depth):
        """One fit of ``steps`` steps at prefetch ``depth``, each under its
        own recorder and with the same reporter settings (every step's loss
        read), so the fits differ in the prefetcher alone. (A fit with no
        recorder in scope records into the process's default one, so
        telemetry is on either way.)"""
        rec = telemetry.Telemetry(worker=name)
        with telemetry.current(rec):
            out = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0,
                              prefetch=depth)
        return out, gauge_values(rec.drain_events(), "input_wait_ms")

    # the timed fit, through fit's default prefetch (depth 2)
    (state, metrics), input_wait = timed_fit("train", None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(flash.LAUNCHES)
    # the same fit without the prefetcher, then with it again: its cost
    # within this call
    (_, sync), _ = timed_fit("train.sync", 0)
    (_, again), again_wait = timed_fit("train.prefetch_again", 2)
    del losses[steps:]  # the turns' broadcasts; the timed fit's are checked
    expected = {k: v * steps for k, v in flash_launches_per_step(n_layers).items()}
    finite = all(math.isfinite(v) for _, v in losses)
    ok = finite and len(losses) == steps and launches == expected
    step_ms = 1e3 / metrics["steps_per_sec"]
    emit(
        "train", ok=ok, steps=steps, losses=[v for _, v in losses],
        grad_norm=metrics["grad_norm"], launches=launches, expected=expected,
        step_ms=step_ms, tokens_per_sec=B * seq * metrics["steps_per_sec"],
        step_ms_without_prefetch=1e3 / sync["steps_per_sec"], step_ms_prefetch_again=1e3 / again["steps_per_sec"],
        input_wait_ms=input_wait, input_wait_ms_prefetch_again=again_wait,
        warmup_input_wait_ms=gauge_values(warm.drain_events(), "input_wait_ms"),
        max_memory_allocated_gib=peak / 2**30,
        card=card,
    )
    if not ok:
        raise SystemExit(f"train phase failed: losses {losses}, launches {launches} != {expected}")
    if reference is not None:
        reference.update(losses=[warm_metrics["loss"]] + [v for _, v in losses],
                         first_grad_norm=warm_metrics["grad_norm"], last_grad_norm=metrics["grad_norm"])
    if profile:
        profile_steps(torch, trainer, state, data, card, step_ms)
    return launches, step_ms, peak


def gauge_values(events, name: str) -> list:
    """Every value gauge ``name`` took in a recorder's drained events, in order."""
    return [e["value"] for e in events if e["kind"] == "gauge" and e["name"] == name]


def tensor_checksums(torch, model) -> list:
    """One exact checksum per parameter: the sum of its fp32 bit patterns as
    int64, summed in slices so no full-size int64 copy is made. Any changed
    bit changes it (but for a collision that leaves every sum equal)."""
    out = []
    for p in model.parameters():
        bits = p.detach().reshape(-1).view(torch.int32)
        out.append(sum(int(part.to(torch.int64).sum()) for part in bits.split(1 << 26)))
    return out


def phase_train_resume(torch, cfg, seq: int, card: str, train_peak, train_step_ms):
    """Phase 13: the ``train`` configuration from shards on local disk,
    through the native batcher and fit's prefetcher: run A uninterrupted;
    run B checkpointing every RESUME_EVERY steps until a preemption notice
    after step RESUME_NOTICE; run C from other weights with
    ``resume="auto"``. C's losses and final parameters must equal A's bit
    for bit."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from maggy_tpu_torch import telemetry
    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.resilience import preemption
    from maggy_tpu_torch.train import Checkpointer, NativeBatchLoader, ShardedDataset, Trainer, adamw, write_sharded

    dev = torch.device("cuda", 0)
    steps, every, notice = RESUME_STEPS, RESUME_EVERY, RESUME_NOTICE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    root = tempfile.mkdtemp(prefix="train_resume_")
    checks, runs = {}, {}
    try:
        free_start = shutil.disk_usage(root).free
        n_params = sum(p.numel() for p in Decoder(cfg, device="meta").parameters())
        need = 2 * 12 * n_params  # two checkpoints on disk while the second commits
        if free_start < need:
            raise SystemExit(f"train.resume: {free_start / 1e9:.1f} GB free under {root}, the phase needs "
                             f"{need / 1e9:.1f} GB (two checkpoints of {12 * n_params / 1e9:.1f} GB)")
        toks = np.random.default_rng(RESUME_DATA_SEED).integers(0, cfg.vocab_size, (RESUME_ROWS, seq)).astype(np.int32)
        write_sharded(os.path.join(root, "data"), {"tokens": toks}, num_shards=RESUME_SHARDS)
        ds = ShardedDataset(os.path.join(root, "data"))
        arrays = {"tokens": np.concatenate([ds.open_shard("tokens", i) for i in range(ds.num_shards)])}
        checks["data_round_trip"] = bool(np.array_equal(arrays["tokens"], toks))

        def run(name, seed, ckpt=None, num=steps, **kw):
            trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-4), device=dev)
            state = trainer.make_state(seed, {"tokens": toks[:B]})
            loader = NativeBatchLoader(arrays, B, seed=RESUME_DATA_SEED)
            losses = []

            class Record:
                def broadcast(self, value, step):
                    losses.append((step, value))
                    if kw.get("notice") == step:
                        preemption.request()

            tel = telemetry.Telemetry(worker=name)
            flash.reset_launches()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with telemetry.current(tel):
                state, out = trainer.fit(state, loader, num, reporter=Record(), report_every=1, metrics_window=0,
                                         prefetch=2, checkpointer=ckpt, checkpoint_every=kw.get("every", 0),
                                         resume=kw.get("resume"))
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            loader.close()
            if ckpt is not None:
                ckpt.close()  # the last commit's span lands in this run's recorder; frees the host buffers
            events = tel.drain_events()
            spans = [e for e in events if e["kind"] == "span"]
            rec = dict(losses=losses, out=out, launches=dict(flash.LAUNCHES), wall_s=wall, native=loader.using_native,
                       checksums=tensor_checksums(torch, state.model), input_wait_ms=gauge_values(events, "input_wait_ms"),
                       restore_s=[e["dur_ms"] / 1e3 for e in spans if e["name"] == "checkpoint_restore"],
                       # the loop's stall and the writer thread's commit, per save
                       blocked_s={e["attrs"]["step"]: e["dur_ms"] / 1e3 for e in spans
                                  if e["name"] == "checkpoint_save"},
                       commits={e["attrs"]["step"]: (e["dur_ms"] / 1e3, e["attrs"]["bytes"]) for e in spans
                                if e["name"] == "checkpoint_commit"})
            del trainer, state
            gc.collect()
            torch.cuda.empty_cache()
            return rec

        runs["a"] = run("resume.a", 0)
        ckpt_b = Checkpointer(os.path.join(root, "ckpt"), max_to_keep=1)
        runs["b"] = run("resume.b", 0, ckpt_b, every=every, notice=notice)
        latest_b = ckpt_b.latest_step()
        preemption.clear()
        ckpt_c = Checkpointer(os.path.join(root, "ckpt"), max_to_keep=1)  # a new process would open it anew
        runs["c"] = run("resume.c", 1, ckpt_c, resume="auto")
    finally:
        preemption.clear()
        shutil.rmtree(root, ignore_errors=True)
    a, b, c = runs["a"], runs["b"], runs["c"]
    per_step = flash_launches_per_step(cfg.n_layers)
    la = [v for _, v in a["losses"]]
    saves = [dict(step=step, blocked_s=b["blocked_s"].get(step), commit_s=t, bytes=n)
             for step, (t, n) in sorted(b["commits"].items())]
    checks.update(
        native_loader=a["native"] and b["native"] and c["native"],
        preempted=b["out"].get("preempted") == 1.0 and latest_b == notice and len(b["losses"]) == notice,
        saves=[r["step"] for r in saves] == [every, notice],
        resumed_from=c["out"].get("resumed_from") == notice and [s for s, _ in c["losses"]] == list(
            range(notice + 1, steps + 1)),
        losses_bit_equal=[v for _, v in b["losses"]] + [v for _, v in c["losses"]] == la,
        params_bit_equal=c["checksums"] == a["checksums"],
        launches=all(r["launches"] == {k: v * n for k, v in per_step.items()}
                     for r, n in ((a, steps), (b, notice), (c, steps - notice))),
        losses_finite=all(math.isfinite(v) for v in la),
    )
    gib = 2**30
    torch.cuda.synchronize(dev)
    peak, after = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev)
    checks["memory_back"] = abs(after - base) <= gib
    checks["peak_near_train"] = peak <= train_peak + 2 * gib
    nbytes = saves[0]["bytes"] if saves else None
    ok = all(checks.values())
    emit(
        "train.resume", ok=ok, checks=checks, steps=steps, checkpoint_every=every, notice_after=notice,
        disk_free_gb_at_start=free_start / 1e9, checkpoint_bytes=nbytes,
        saves=[dict(r, d2h_gb_per_s=r["bytes"] / r["blocked_s"] / 1e9 if r["blocked_s"] else None,
                    commit_gb_per_s=r["bytes"] / r["commit_s"] / 1e9) for r in saves],
        restore_s=c["restore_s"], restore_gb_per_s=[nbytes / t / 1e9 for t in c["restore_s"]] if nbytes else None,
        step_ms={k: 1e3 / r["out"]["steps_per_sec"] for k, r in runs.items()}, train_step_ms=train_step_ms,
        wall_s={k: r["wall_s"] for k, r in runs.items()},
        input_wait_ms={k: r["input_wait_ms"] for k, r in runs.items()},
        losses={k: [v for _, v in r["losses"]] for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()},
        peak_gib=peak / gib, train_peak_gib=train_peak / gib, memory_after_minus_before_gib=(after - base) / gib,
        card=card,
    )
    if not ok:
        raise SystemExit(f"train.resume failed: {[k for k, v in checks.items() if not v]}")
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in per_step}
    return total


def phase_train_remat(torch, cfg, seq: int, card: str):
    """Phase 14: one forward and backward of the ``train`` configuration on
    one batch under each remat setting, from the same parameters, gradients
    cleared between them; each policy's loss and gradients must equal
    ``remat=False``'s bit for bit, and the flash forward must launch as the
    policy says (the kernels' backward once a layer under every one)."""
    import dataclasses
    import gc

    import numpy as np

    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train.trainer import lm_loss_fn

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Decoder(dataclasses.replace(cfg, remat=False), device=dev, generator=gen)
    toks = np.random.default_rng(RESUME_DATA_SEED).integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    rows, ref = {}, None
    n = cfg.n_layers
    for remat, policy in REMAT_ORDER:
        model.cfg = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        name = policy if remat else "remat=False"
        times = []
        for _ in range(2):  # the first is a warm-up; the second is timed and checked
            model.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            flash.reset_launches()
            t0 = time.perf_counter()
            loss = lm_loss_fn(model(batch["tokens"]), batch)
            loss.backward()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        launches = dict(flash.LAUNCHES)
        grads = [p.grad for p in model.parameters()]
        peak = torch.cuda.max_memory_allocated(dev)
        if ref is None:
            ref = (loss.detach(), grads)
        fwd = {"remat=False": 1, "nothing": 2, "dots": 2, "dots_attn": 1}[name]
        rows[name] = dict(
            step_ms=times[-1] * 1e3, launches=launches,
            expected={"flash_fwd": fwd * n, "flash_bwd_dq": n, "flash_bwd_dkv": n},
            bit_equal=bool(torch.equal(loss.detach(), ref[0])) and all(
                torch.equal(g, r) for g, r in zip(grads, ref[1])),
            loss=float(loss.detach()), peak_gib=peak / 2**30, step_peak_gib=(peak - held) / 2**30,
        )
    del model, ref, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    checks = {name: r["bit_equal"] and r["launches"] == r["expected"] for name, r in rows.items()}
    ok = all(checks.values())
    emit("train.remat", ok=ok, checks=checks, policies=rows, batch=[B, seq], card=card)
    if not ok:
        raise SystemExit(f"train.remat failed: {[k for k, v in checks.items() if not v]}")
    return {k: sum(r["launches"][k] for r in rows.values()) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


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


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def row_rel_l2(a, b):
    """Relative L2 of each row of [N, V] logits against the reference's."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def _spread(errs) -> dict:
    errs = errs.float().sort().values
    return dict(max=float(errs[-1]), p99=float(errs[int(0.99 * (len(errs) - 1))]),
                median=float(errs[len(errs) // 2]))


def shuffled_page_tables(torch, rows, gen, page: int, per_row: int, steps: int, device):
    """A page pool twice the size ``rows`` (prompt lengths) need and their
    page tables: each row's pages drawn from a random permutation of the
    pool, so no row's pages are contiguous or in order."""
    need = [-(-(n + steps) // page) for n in rows]
    num_pages = 2 * sum(need) + 1
    perm = 1 + torch.randperm(num_pages - 1, generator=gen, device=device)
    table = torch.zeros((len(rows), per_row), dtype=torch.int32, device=device)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    return num_pages, table


def phase_serve_model(torch, master, card: str, prompt_lens=SERVE_PROMPTS, steps=SERVE_STEPS, page=SERVE_PAGE):
    """The cache path at full depth: each prompt prefilled into a dense and
    a paged batch cache (shuffled pages), then ``steps`` greedy steps of
    the whole batch, rows at different positions. Every prompt and generated
    position's logits against the training forward (the flash kernel) over
    the same tokens; paged against dense bit for bit; and a planted fault,
    one request's page table with two pages swapped, that the logits limit
    must catch."""
    import dataclasses

    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.models.generate import init_cache
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.serve.engine import serving_model

    def plain_attention(q, k, v, *, causal=True, segment_ids=None):
        return flash.flash_fwd_reference(q, k, v, causal=causal, segment_ids=segment_ids)[0]

    cfg, dev = master.cfg, master.embedding.device
    gen = torch.Generator(device=dev).manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev) for n in prompt_lens]
    n, s = len(prompts), cfg.max_seq_len
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = serving_model(cfg, master, dev)
    num_pages, table = shuffled_page_tables(torch, prompt_lens, gen, page, s // page, steps, dev)
    paged_cfg = dataclasses.replace(cfg, decode=True, paged=True, page_size=page, num_pages=num_pages)
    zeros = torch.zeros((n, 1), device=dev)
    caches = {"dense": init_cache(cfg, zeros), "paged": init_cache(paged_cfg, zeros)}
    caches["paged"].pages.copy_(table)
    logits = {name: [[] for _ in prompts] for name in caches}
    fed = {name: [[] for _ in prompts] for name in caches}
    flash.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for name, cache in caches.items():
            for i, p in enumerate(prompts):
                pos = torch.arange(len(p), device=dev)[None]
                logits[name][i].append(model(p[None], pos, cache=cache.row(i), kv_len=len(p))[0])
            tokens = torch.stack([rows[0][-1].argmax() for rows in logits[name]])
            start = torch.tensor(prompt_lens, device=dev)
            for j in range(steps):
                for i in range(n):
                    fed[name][i].append(tokens[i])
                out = model(tokens[:, None], (start + j)[:, None], cache=cache, kv_len=max(prompt_lens) + j + 1)
                for i in range(n):
                    logits[name][i].append(out[i])
                tokens = out[:, 0].argmax(-1)
        _sync(torch, dev)
        cache_path_s = time.perf_counter() - t0
        cache_path_launches = dict(flash.LAUNCHES)
        cat = {name: [torch.cat(rows) for rows in per] for name, per in logits.items()}
        paged_equals_dense = all(torch.equal(a, b) for a, b in zip(cat["dense"], cat["paged"]))
        del logits, cat["paged"], caches
        # the training forward over each prompt and its generated tokens
        # (the flash kernel); the yardstick: the same forward with the
        # kernel's plain version (fp32 scores), two right attentions apart
        plain = Decoder(dataclasses.replace(cfg, attention_fn=plain_attention), device="meta")
        plain.load_state_dict(master.state_dict(), assign=True)
        rows, fault_ref, ref_launches = [], None, 0
        for i, p in enumerate(prompts):
            seq = torch.cat([p, torch.stack(fed["dense"][i])])[None]
            flash.reset_launches()
            ref = master(seq)[0]
            ref_launches += flash.LAUNCHES["flash_fwd"]
            err = row_rel_l2(cat["dense"][i], ref)
            plain_ref = plain(seq)[0]
            rows.append(dict(prompt=len(p), prefill=_spread(err[:len(p)]), decode=_spread(err[len(p):]),
                             plain_vs_kernel=_spread(row_rel_l2(plain_ref, ref)),
                             cache_vs_plain=_spread(row_rel_l2(cat["dense"][i], plain_ref))))
            del plain_ref
            if i == 0:
                fault_ref = ref[len(p):]
            del ref
        # planted fault: prompt 0 through its own paged cache, whose table has
        # its first page and the page the decode writes into swapped, then the
        # same tokens fed as above
        p0 = prompts[0]
        fault_cache = init_cache(paged_cfg, zeros[:1])
        fault_cache.pages.copy_(table[:1])
        pos = torch.arange(len(p0), device=dev)[None]
        model(p0[None], pos, cache=fault_cache, kv_len=len(p0))
        tail = len(p0) // page
        fault_cache.pages[0, [0, tail]] = fault_cache.pages[0, [tail, 0]]
        fault_rows = []
        for j, tok in enumerate(fed["dense"][0]):
            at = torch.full((1, 1), len(p0) + j, device=dev)
            fault_rows.append(model(tok.view(1, 1), at, cache=fault_cache, kv_len=len(p0) + j + 1)[0])
        fault = _spread(row_rel_l2(torch.cat(fault_rows), fault_ref))
    _sync(torch, dev)
    worst = max(max(r["prefill"]["max"], r["decode"]["max"]) for r in rows)
    expected_ref = cfg.n_layers * n if dev.type == "cuda" else 0
    ok = (
        paged_equals_dense
        and worst <= TOL_SERVE_LOGITS_REL_L2
        and fault["median"] > TOL_SERVE_LOGITS_REL_L2
        and all(v == 0 for v in cache_path_launches.values())
        and ref_launches == expected_ref
        and all(bool(torch.isfinite(r).all()) for r in cat["dense"])
    )
    emit(
        "serve.model", ok=ok, layers=cfg.n_layers, prompts=list(prompt_lens), steps=steps, page=page,
        paged_equals_dense=paged_equals_dense, logits_rel_l2_per_row=rows, worst=worst,
        tol_logits_rel_l2_per_row=TOL_SERVE_LOGITS_REL_L2, planted_fault=fault,
        cache_path_flash_launches=cache_path_launches, reference_flash_fwd_launches=ref_launches,
        cache_path_s=cache_path_s, max_memory_allocated_gib=_peak_gib(torch, dev), card=card,
    )
    if not ok:
        raise SystemExit("serve.model failed: the cache path's logits disagree with the training forward, "
                         "paged with dense, or the limit let the planted page-table fault through")
    del model, fault_cache, cat, plain


def _peak_gib(torch, dev):
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None


def engine_requests(torch, cfg, n=ENGINE_REQUESTS, shared=ENGINE_SHARED, system=ENGINE_SYSTEM,
                    lengths=(64, 1536), max_new=(16, 64), seed=6):
    """The engine phase's requests: ``shared`` prompts of a ``system``-token
    prefix plus a suffix (first, so they share one admission wave) and the
    rest unshared, ``lengths`` tokens (one of each end: the longest fills the
    2048 bucket); ``max_new`` drawn from its range; even ones greedy, odd
    ones sampled at 0.8, top-k 40."""
    from maggy_tpu_torch.serve import Request, SamplingParams

    gen = torch.Generator().manual_seed(seed)
    lo, hi = lengths

    def draw(a, b, k=1):
        return torch.randint(a, b + 1, (k,), generator=gen).tolist()

    sys_prompt = draw(0, cfg.vocab_size - 1, system)
    prompts = [sys_prompt + draw(0, cfg.vocab_size - 1, draw(16, hi - system)[0]) for _ in range(shared)]
    prompts += [draw(0, cfg.vocab_size - 1, k) for k in [hi, lo] + draw(lo, hi, n - shared - 2)]
    out = []
    for i, prompt in enumerate(prompts):
        sampled = i % 2 == 1
        out.append(Request(prompt=prompt, id=f"r{i}", params=SamplingParams(
            max_new=draw(*max_new)[0], temperature=0.8 if sampled else 0.0, top_k=40 if sampled else 0, seed=i)))
    return out


def drive_engine(engine, requests, order=None):
    """Admit in ``order`` as slots free, step, release each request at its
    ``max_new``. Returns ({id: tokens}, the first-token logits of every
    prefix-hit admission by id)."""
    import copy

    pending = [copy.deepcopy(requests[i]) for i in (order or range(len(requests)))]
    streams, owner, hit_logits = {}, {}, {}
    while pending or engine.slots.active_count:
        while pending and engine.slots.free_slots():
            req = pending.pop(0)
            hits = engine.prefix_hits
            slot, first = engine.admit(req)
            if engine.prefix_hits > hits:
                hit_logits[req.id] = engine.last_admit_logits
            streams[req.id], owner[slot] = [first], req
        for slot, tok in engine.step().tokens.items():
            req = owner[slot]
            streams[req.id].append(tok)
            if len(streams[req.id]) >= req.params.max_new:
                engine.release(slot)
    engine.flush()
    return streams, hit_logits


def phase_serve_engine(torch, master, card: str, requests, num_slots=ENGINE_SLOTS, system=ENGINE_SYSTEM,
                       timed_steps=10, profiled_steps=3, buckets=PREFILL_BUCKETS):
    """``Engine`` with its defaults (paged, page 16, prefix reuse, async,
    the host tier): the requests to completion; the greedy streams again
    paged-sync and dense-async; every stream again admitted in a permuted
    order; each prefix hit's first-token logits against a full prefill;
    the streams once more without prefix reuse (full prefills only).
    Then the numbers: prefill time per bucket, a steady decode step at every
    slot busy beside its bound, and the device's busy share over it.
    Returns the paged-async streams by request id, the no-prefix-reuse
    streams and that decode step's ms, which the later serving phases are
    held to."""
    import gc

    from maggy_tpu_torch.models.generate import prefill
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.serve import Engine, Request, SamplingParams

    cfg, dev = master.cfg, master.embedding.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def fresh(**kw):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return Engine(cfg, master, num_slots=num_slots, device=dev, **kw)

    flash.reset_launches()
    runs, hits = {}, {}
    t0 = time.perf_counter()
    engine = fresh()
    runs["paged_async"], hit_logits = drive_engine(engine, requests)
    _sync(torch, dev)
    run_s = time.perf_counter() - t0
    hits["paged_async"] = engine.prefix_hits
    # each prefix hit's first-token logits against a full prefill of its prompt
    hit_errs = {}
    with torch.no_grad():
        for req in requests:
            if req.id in hit_logits:
                tokens = torch.tensor([req.prompt], device=dev)
                pos = torch.arange(len(req.prompt), device=dev)[None]
                full, _ = prefill(engine.model, tokens, pos)
                hit_errs[req.id] = float(row_rel_l2(hit_logits[req.id][None], full[0, -1:])[0])
                del full
    stats = dict(steps=engine.steps, tokens_out=engine.tokens_out, compile_counts=engine.compile_counts,
                 prefix=engine.prefix_stats, pages=engine.paging_stats)
    del engine, hit_logits
    for name, kw in (("paged_sync", dict(async_decode=False)), ("dense_async", dict(paged=False)),
                     ("no_prefix", dict(prefix_reuse=False))):
        engine = fresh(**kw)
        runs[name], _ = drive_engine(engine, requests)
        hits[name] = engine.prefix_hits
        del engine
    # shared-prefix requests reversed after the first (which prefills the
    # prefix for all), the others reversed: other slots, other batch-mates
    n_shared = sum(1 for r in requests if r.prompt[:system] == requests[0].prompt[:system])
    order = [0] + list(range(n_shared - 1, 0, -1)) + list(range(len(requests) - 1, n_shared - 1, -1))
    engine = fresh()
    runs["permuted"], _ = drive_engine(engine, requests, order)
    hits["permuted"] = engine.prefix_hits
    del engine
    greedy = [r.id for r in requests if r.params.temperature == 0.0]
    sampled = [r.id for r in requests if r.params.temperature > 0.0]
    base = runs["paged_async"]
    checks = dict(
        all_finished=all(len(base.get(r.id, ())) == r.params.max_new for r in requests),
        prefix_hits=hits["paged_async"],
        greedy_equal_across_engines=all(runs[k][i] == base[i] for k in ("paged_sync", "dense_async") for i in greedy),
        all_streams_equal_across_engines=all(runs[k] == base for k in ("paged_sync", "dense_async")),
        sampled_equal_permuted=all(runs["permuted"][i] == base[i] for i in sampled),
        greedy_equal_permuted=all(runs["permuted"][i] == base[i] for i in greedy),
        hit_logits_max_rel_l2=max(hit_errs.values(), default=None),
        no_kernel_launched=all(v == 0 for v in flash.LAUNCHES.values()),
        # full prefills only: the streams a disaggregated fleet's handoff
        # computes, equal to the prefix hits' only where the bits agree
        no_prefix_finished=all(len(runs["no_prefix"].get(r.id, ())) == r.params.max_new for r in requests),
        no_prefix_differing=[i for i in base if runs["no_prefix"].get(i) != base[i]],
    )
    ok = (checks["all_finished"] and checks["no_prefix_finished"] and checks["prefix_hits"] >= n_shared - 1
          and checks["greedy_equal_across_engines"] and checks["sampled_equal_permuted"]
          and checks["no_kernel_launched"] and len(hit_errs) == checks["prefix_hits"]
          and checks["hit_logits_max_rel_l2"] <= TOL_SERVE_LOGITS_REL_L2)
    emit("serve.engine", ok=ok, slots=num_slots, requests=len(requests), run_s=run_s, **checks,
         hits_by_run=hits, hit_logits_rel_l2=hit_errs, tol_logits_rel_l2=TOL_SERVE_LOGITS_REL_L2, **stats,
         card=card)
    if not ok:
        raise SystemExit(f"serve.engine failed: {checks}")
    step_ms = serve_engine_times(torch, fresh(), requests, card, timed_steps, profiled_steps, buckets)
    return base, runs["no_prefix"], step_ms


def _busy_decode_step(torch, engine, requests, timed_steps, profiled_steps) -> dict:
    """Every slot busy with ``requests``' first prompts (long enough not to
    finish), then ``timed_steps`` decode steps timed, as many again with the
    cyclic collector off, and ``profiled_steps`` under torch.profiler on a
    card: the step's ms both ways, the rows' cache lengths, the objects the
    collector tracks, and per step the device's busy ms, the kernel
    launches, the top kernels and the top host operations (self CPU ms),
    the host's self CPU ms in all and in CUDA runtime calls, the profiled
    step's wall ms, the admissions that hit the prefix cache, and the
    caching allocator's retries, device allocations and frees over the
    timed steps. The slots are released afterwards."""
    import gc

    from maggy_tpu_torch.serve import Request, SamplingParams

    dev = engine.device
    hits = engine.prefix_hits
    for req in requests[:engine.slots.num_slots]:
        engine.admit(Request(prompt=list(req.prompt), params=SamplingParams(max_new=engine.max_seq_len // 4)))
    for _ in range(4):
        engine.step()
    out = dict(cache_lengths=[engine.slots.get(s).next_pos for s in engine.slots.active_slots()],
               tracked_objects=len(gc.get_objects()), admission_prefix_hits=engine.prefix_hits - hits)
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")

    def alloc_counts():
        stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        return {k: stats.get(k, 0) for k in alloc_keys}

    def timed():
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            engine.step()
        _sync(torch, dev)
        return (time.perf_counter() - t0) * 1e3 / timed_steps

    before = alloc_counts()
    out["decode_step_ms"] = timed()
    out["allocator"] = {k: v - before[k] for k, v in alloc_counts().items()}
    gc.disable()
    try:
        out["decode_step_ms_collector_off"] = timed()
    finally:
        gc.enable()
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled_steps):
                engine.step()
            _sync(torch, dev)
            out["profiled_wall_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / profiled_steps
        events = [e for e in prof.key_averages() if not e.is_user_annotation]
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        out.update(
            device_busy_ms_per_step=sum(e.self_device_time_total for e in kernels) / 1e3 / profiled_steps,
            kernel_launches_per_step=sum(e.count for e in kernels) / profiled_steps,
            top_kernels=[dict(ms=m, name=k, launches=c) for m, k, c in sorted(
                ((e.self_device_time_total / 1e3 / profiled_steps, e.key[:70], e.count // profiled_steps)
                 for e in kernels), reverse=True)[:10]],
            top_host=[dict(ms=m, name=k, calls=c) for m, k, c in sorted(
                ((e.self_cpu_time_total / 1e3 / profiled_steps, e.key[:60], e.count // profiled_steps)
                 for e in host), reverse=True)[:8]],
            host_self_ms_per_step=sum(e.self_cpu_time_total for e in host) / 1e3 / profiled_steps,
            cuda_runtime={e.key: dict(ms=e.self_cpu_time_total / 1e3 / profiled_steps, calls=e.count / profiled_steps)
                          for e in host if e.key.startswith("cuda")})
        # the profile's events (millions of objects) sit in reference
        # cycles: left to the collector, every later full collection walks
        # them, and every later phase's host-bound steps pay for it
        del prof, events, kernels, host
        gc.collect()
    for slot in list(engine.slots.active_slots()):
        engine.release(slot)
    engine.flush()
    return out


def serve_engine_times(torch, engine, requests, card, timed_steps, profiled_steps, buckets):
    """Prefill time per bucket, then a steady decode step with every slot
    busy: its time, tokens/s, bound, and the device's busy share. Then the
    same engine serves ``requests`` to the end and the busy step is taken
    again (``after_run``): whether an engine that has served steps slower,
    single-threaded, with no scheduler in the way, and where the time goes
    (collector off, host operations)."""
    from maggy_tpu_torch.models.transformer import Dense
    from maggy_tpu_torch.serve import Request, SamplingParams

    cfg, dev = engine.cfg, engine.device
    gen = torch.Generator().manual_seed(7)
    prefill_ms = {}
    for bucket in buckets:
        times = []
        for _ in range(2):
            prompt = torch.randint(0, cfg.vocab_size, (bucket,), generator=gen).tolist()
            _sync(torch, dev)
            t0 = time.perf_counter()
            slot, _ = engine.admit(Request(prompt=prompt, params=SamplingParams(max_new=1)))
            times.append((time.perf_counter() - t0) * 1e3)
            engine.release(slot)
        prefill_ms[bucket] = times
    fresh = _busy_decode_step(torch, engine, requests, timed_steps, profiled_steps)
    drive_engine(engine, requests)
    after = _busy_decode_step(torch, engine, requests, timed_steps, profiled_steps)
    step_ms, lengths, busy_ms = fresh["decode_step_ms"], fresh["cache_lengths"], fresh.get("device_busy_ms_per_step")
    # the least a step could take: every bf16 projection weight and every
    # cached K/V of the active rows read once (mid-window lengths)
    weight_bytes = sum(m.weight.numel() * m.weight.element_size() for m in engine.model.modules()
                       if isinstance(m, Dense))
    per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    kv_bytes = sum(n + 1 + timed_steps // 2 for n in lengths) * per_token
    bound_ms = (weight_bytes + kv_bytes) / PEAK_BYTES * 1e3
    slots = len(lengths)
    after_busy = after.get("device_busy_ms_per_step")
    emit("serve.engine.times", slots=slots, prefill_ms=prefill_ms, tokens_per_sec=slots * 1e3 / step_ms,
         decode_bound_ms=bound_ms, bound_by="bytes", weight_gib=weight_bytes / 2**30, kv_gib=kv_bytes / 2**30,
         share_of_bound=bound_ms / step_ms, busy_share=None if busy_ms is None else busy_ms / step_ms, **fresh,
         after_run=dict(requests=len(requests), over_fresh=after["decode_step_ms"] / step_ms,
                        busy_share=None if after_busy is None else after_busy / after["decode_step_ms"], **after),
         max_memory_allocated_gib=_peak_gib(torch, dev), card=card)
    del engine
    return step_ms


def _wait(pred, timeout: float, what: str) -> None:
    """Poll ``pred`` every 10 ms until it holds; fail the phase after
    ``timeout`` seconds."""
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise SystemExit(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def _submit(client, req, **kw) -> str:
    """``req`` (a ``Request`` of ``engine_requests``) over ``client``'s SUBMIT."""
    p = req.params
    return client.submit(list(req.prompt), temperature=p.temperature, top_k=p.top_k, max_new=p.max_new,
                         eos_id=p.eos_id, seed=p.seed, **kw)


def _percentile(stats, signal: str, q: float):
    from maggy_tpu_torch.telemetry.histogram import LatencyHistogram

    return LatencyHistogram.from_dict(stats["latency"][signal]).percentile(q)


def _timed(torch, dev, fn, out: list):
    """``fn`` timed between device syncs into ``out`` (ms); returns its
    result, and records nothing when it returns None (no tier admission)."""
    def wrapper(*a, **kw):
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        _sync(torch, dev)
        if res is not None and res is not False:
            out.append((time.perf_counter() - t0) * 1e3)
        return res
    return wrapper


def _trace_kernels(path) -> int:
    """CUDA kernel events in a Chrome trace written by torch.profiler."""
    if not path or not os.path.exists(os.path.join(path, "trace.json")):
        return 0
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


def phase_serve_sched(torch, master, card: str, requests, base, engine_step_ms, num_slots=ENGINE_SLOTS,
                      long_new=512, timed_s=3.0, direct_steps=20, timeout_s=600):
    """``Engine(num_slots=8)`` with its defaults (paged, the host tier on)
    behind the ``Scheduler`` and a ``ServeServer`` on localhost: a
    ``ServeClient`` submits ``serve.engine``'s requests over two tenants:
    the shared-prefix ones premium and standard (the first wave, as in
    ``serve.engine``), the rest best-effort, so admission keeps the
    request order and no class waits behind a lower one. Every request done, none failed, rejected or expired;
    every stream equal to ``serve.engine``'s paged-async stream bit for bit;
    the prefix hits; no flash launch; one decode shape and no recompile
    alert. Then every slot busy with long requests: the loop's decode step
    (the median gap between its steps) beside the same engine stepped
    directly once the server stops, and a profile capture forced on the
    loop's metrics tick that must write a torch.profiler trace."""
    import gc
    import tempfile

    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.serve import Engine, Scheduler, ServeClient, ServeServer
    from maggy_tpu_torch.telemetry.alerts import ALERT_FIRING

    dev = master.embedding.device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = Engine(master.cfg, master, num_slots=num_slots, device=dev)
    sched = Scheduler(engine)
    server = ServeServer(sched)
    addr = server.start(host="127.0.0.1", port=0)
    classes = ["premium"] * (ENGINE_SHARED // 2) + ["standard"] * (ENGINE_SHARED - ENGINE_SHARED // 2)
    classes += ["best_effort"] * (len(requests) - ENGINE_SHARED)
    flash.reset_launches()
    try:
        with ServeClient(addr, server.secret) as client:
            t0 = time.perf_counter()
            ids = {r.id: _submit(client, r, qos=classes[i], tenant=("acme", "bulk")[i % 2])
                   for i, r in enumerate(requests)}
            snaps = {rid: client.result(sid, timeout=timeout_s) for rid, sid in ids.items()}
            run_s = time.perf_counter() - t0
            stats = client.stats()
            # every slot busy: the decode step as the loop runs it
            for r in requests[:num_slots]:
                client.submit(list(r.prompt), max_new=long_new)
            _wait(lambda: engine.slots.active_count == num_slots, timeout_s, "every slot busy")
            time.sleep(0.5)
            # the loop's steps, stamped where the loop calls them
            stamps, step = [], engine.step

            def stamped():
                out = step()
                stamps.append(time.perf_counter())
                return out

            engine.step = stamped
            time.sleep(timed_s)
            engine.step = step
            sched_step_ms = statistics.median(b - a for a, b in zip(stamps, stamps[1:])) * 1e3
            with tempfile.TemporaryDirectory() as tmp:
                # forced where the scheduler ticks it, on its loop thread:
                # a profiler started in one thread while another launches
                # work crashed one of five card runs (a segfault)
                sched.profcap.configure(dump_dir=tmp)
                paths, tick = [], sched._metrics_tick

                def tick_then_capture(now, wd=None):
                    tick(now, wd)
                    if not paths:
                        paths.append(sched.profcap.tick([{"event": ALERT_FIRING, "alert": "alert.hbm_headroom"}],
                                                        now=now))

                sched._metrics_tick = tick_then_capture
                _wait(lambda: paths, 30, "the loop's forced profile capture")
                sched._metrics_tick = tick
                capture = sched.profcap.last_capture or {}
                trace_file = bool(paths[0]) and os.path.exists(os.path.join(paths[0], "trace.json"))
                trace_kernels = _trace_kernels(paths[0])
            final = client.stats()
    finally:
        server.stop()
    # the same engine and rows, stepped directly from this thread: the
    # loop's cost per step, without another engine or another call between
    direct_rows = engine.slots.active_count
    _sync(torch, dev)
    t1 = time.perf_counter()
    for _ in range(direct_steps):
        engine.step()
    _sync(torch, dev)
    direct_step_ms = (time.perf_counter() - t1) * 1e3 / direct_steps
    streams = {rid: s["tokens"] for rid, s in snaps.items()}
    greedy = [r.id for r in requests if r.params.temperature == 0.0]
    checks = dict(
        done=sum(s["state"] == "done" for s in snaps.values()),
        failed=stats["requests_failed"], rejected=stats["requests_rejected"], expired=stats["requests_expired"],
        greedy_equal_serve_engine=all(streams[i] == base[i] for i in greedy),
        all_streams_equal_serve_engine=streams == base,
        differing=[i for i in base if streams.get(i) != base[i]],
        prefix_hits=stats["prefix_hits"], preemptions=stats["preemptions"],
        no_kernel_launched=all(v == 0 for v in flash.LAUNCHES.values()),
        decode_shapes=final["compile_counts"]["decode"],
        recompile_alert=any(a["alert"] == "alert.recompile" for a in final["alerts"]),
        profiler=capture.get("profiler"), trace_file=trace_file, trace_kernel_events=trace_kernels,
        direct_rows=direct_rows,
    )
    ok = (checks["done"] == len(requests) and not (checks["failed"] or checks["rejected"] or checks["expired"])
          and checks["all_streams_equal_serve_engine"] and checks["prefix_hits"] >= ENGINE_SHARED - 1
          and checks["no_kernel_launched"] and checks["decode_shapes"] == 1 and not checks["recompile_alert"]
          and checks["profiler"] == "torch.profiler" and trace_file and direct_rows == num_slots)
    emit("serve.sched", ok=ok, slots=num_slots, requests=len(requests), run_s=run_s, **checks,
         ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p99=stats["ttft_ms_p99"],
         tpot_ms_p50=stats["tpot_ms_p50"], tpot_ms_p99=_percentile(stats, "tpot_ms", 0.99),
         queue_wait_ms_p50=stats["queue_wait_ms_p50"], queue_wait_ms_p99=_percentile(stats, "queue_wait_ms", 0.99),
         e2e_ms_p50=stats["e2e_ms_p50"], tokens_per_sec=stats["tokens_per_sec"],
         sched_decode_step_ms=sched_step_ms, direct_decode_step_ms=direct_step_ms,
         sched_over_direct=sched_step_ms / direct_step_ms, engine_times_decode_step_ms=engine_step_ms,
         qos=stats["qos"]["counters"],
         tier={k: v for k, v in stats["tier"].items() if k != "prefix_digests"},
         max_memory_allocated_gib=_peak_gib(torch, dev), card=card)
    if not ok:
        raise SystemExit(f"serve.sched failed: {checks}")
    del engine, sched, server


def phase_serve_tier(torch, master, card: str, requests, base, num_slots=ENGINE_SLOTS, system=ENGINE_SYSTEM,
                     handoff=(8, 9, 10, 11), refills=3, timeout_s=900):
    """Page pressure with the host tier: a pool of half the requests' worst
    case (never less than the premium ones' together, so a premium request
    is never a victim). The shared-prefix requests, best-effort, fill the
    slots; then the others arrive premium and preempt them. Every victim
    best-effort, every preemption spilled to host memory and swapped back
    in; streams equal to ``serve.engine``'s bit for bit. Then four requests
    through the prefill handoff (``prefill_only`` before the loop runs, a
    pack through ``Request.prefilled`` and the scheduler's
    ``admit_from_kv``), and three shared-prefix requests again with nothing
    resident on the card: prefix fills from the host tier. Streams equal
    ``serve.engine``'s bit for bit throughout."""
    import gc

    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.serve import Engine, Scheduler, ServeClient, ServeServer
    from maggy_tpu_torch.serve.prefix import PrefixIndex

    cfg, dev = master.cfg, master.embedding.device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    shared = [r for r in requests if r.prompt[:system] == requests[0].prompt[:system]]
    others = [r for r in requests if r not in shared]
    page = SERVE_PAGE
    worst = {r.id: -(-(len(r.prompt) + r.params.max_new) // page) for r in requests}
    num_pages = max(sum(worst.values()) // 2, sum(worst[r.id] for r in others) + 1) + 1
    engine = Engine(cfg, master, num_slots=num_slots, num_pages=num_pages, page_size=page, device=dev)
    times = {k: [] for k in ("spill_ms", "prefix_spill_ms", "swap_in_ms", "prefill_only_ms", "admit_from_kv_ms")}
    engine.spill_stream = _timed(torch, dev, engine.spill_stream, times["spill_ms"])
    spill_prefix = engine._spill_prefix

    def timed_spill_prefix(slot):
        n = engine.tier_policy.prefix_spills
        _sync(torch, dev)
        t = time.perf_counter()
        spill_prefix(slot)
        _sync(torch, dev)
        if engine.tier_policy.prefix_spills > n:
            times["prefix_spill_ms"].append((time.perf_counter() - t) * 1e3)

    engine._spill_prefix = timed_spill_prefix
    engine._tier_admit = _timed(torch, dev, engine._tier_admit, times["swap_in_ms"])
    engine.admit_from_kv = _timed(torch, dev, engine.admit_from_kv, times["admit_from_kv_ms"])
    packs = {}
    for i in handoff:
        r = requests[i]
        _sync(torch, dev)
        t0 = time.perf_counter()
        packs[r.id] = engine.prefill_only(r.prompt, r.params)
        times["prefill_only_ms"].append((time.perf_counter() - t0) * 1e3)
    pack_bytes = [p["k"].numel() * p["k"].element_size() * 2 for p in packs.values()]
    sched = Scheduler(engine)
    server = ServeServer(sched)
    addr = server.start(host="127.0.0.1", port=0)
    flash.reset_launches()
    streams = {}
    try:
        with ServeClient(addr, server.secret) as client:
            t0 = time.perf_counter()
            ids = {r.id: _submit(client, r, qos="best_effort", tenant="bulk") for r in shared}
            _wait(lambda: engine.slots.active_count == num_slots or sched.stats()["requests_done"],
                  timeout_s, "the best-effort requests in every slot")
            ids.update({r.id: _submit(client, r, qos="premium", tenant="acme") for r in others})
            streams.update({rid: client.result(sid, timeout=timeout_s)["tokens"] for rid, sid in ids.items()})
            pressure_s = time.perf_counter() - t0
            after_pressure = client.stats()
            # the prefill handoff: packs made before the loop ran
            handed = {rid: sched.submit_prefilled(requests[i].prompt, requests[i].params, packs[rid],
                                                  qos="standard", tenant="acme")
                      for i, rid in zip(handoff, packs)}
            _wait(lambda: all(r.state in ("done", "failed", "cancelled", "expired") for r in handed.values()),
                  timeout_s, "the handed-off requests")
            streams.update({f"handoff:{rid}": r.tokens for rid, r in handed.items()})
            # nothing resident on the card now: shared-prefix requests fill
            # from the host tier's prefix pack (one whose own prompt is not
            # the pack's, so the shared length is the system prefix's)
            got = engine.tier.get(f"px:{PrefixIndex.digest(tuple(shared[0].prompt))}")
            pack_tokens = tuple(got[1]["tokens"]) if got else ()
            again = [r for r in shared if tuple(r.prompt) != pack_tokens][:refills]
            refill_ids = {r.id: _submit(client, r, qos="standard", tenant="bulk") for r in again}
            streams.update({f"refill:{rid}": client.result(sid, timeout=timeout_s)["tokens"]
                            for rid, sid in refill_ids.items()})
            final = client.stats()
    finally:
        server.stop()
    tier = final["tier"]
    qos = final["qos"]["counters"]
    preemptions = final["preemptions"]
    bytes_per_page = 2 * cfg.n_layers * page * cfg.n_kv_heads * cfg.head_dim * torch.empty((), dtype=cfg.dtype).element_size()
    want = {**base, **{f"handoff:{rid}": base[rid] for rid in packs}, **{f"refill:{r.id}": base[r.id] for r in again}}
    checks = dict(
        requests_done=final["requests_done"], requests_failed=final["requests_failed"],
        preemptions=preemptions,
        victims_best_effort=qos["best_effort"]["preempted"] == preemptions
        and qos["premium"]["preempted"] == qos["standard"]["preempted"] == 0,
        resume_spills=tier["spills"] - tier["prefix_spills"], resume_fills=tier["fills"] - tier["prefix_fills"],
        tier_spills=tier["spills"], tier_fills=tier["fills"], prefix_fills=tier["prefix_fills"],
        streams_compared=len(want), streams_equal_serve_engine=all(streams.get(k) == v for k, v in want.items()),
        differing=[k for k, v in want.items() if streams.get(k) != v],
        no_kernel_launched=all(v == 0 for v in flash.LAUNCHES.values()),
    )
    ok = (checks["requests_failed"] == 0 and checks["requests_done"] == len(requests) + len(packs) + len(again)
          and preemptions >= 2 and checks["victims_best_effort"]
          and checks["resume_spills"] == preemptions and checks["resume_fills"] == preemptions
          and checks["tier_spills"] >= 1 and checks["tier_fills"] >= 1 and checks["prefix_fills"] >= 1
          and len(again) == refills and checks["streams_equal_serve_engine"] and checks["no_kernel_launched"])
    emit("serve.tier", ok=ok, slots=num_slots, num_pages=num_pages, worst_case_pages=sum(worst.values()),
         pressure_s=pressure_s, **checks, preemptions_after_pressure=after_pressure["preemptions"],
         spilled_pages=tier["spilled_pages"], filled_pages=tier["filled_pages"], bytes_per_page=bytes_per_page,
         pages_per_spill=(tier["spilled_pages"] / tier["spills"]) if tier["spills"] else None,
         host_bytes=tier["host_bytes"], host_evictions=tier["host_evictions"], pack_bytes=pack_bytes, **times,
         max_memory_allocated_gib=_peak_gib(torch, dev), card=card)
    if not ok:
        raise SystemExit(f"serve.tier failed: {checks}")
    del engine, sched, server


# the client runs in the fleet's own process here, so it polls gently: a
# client elsewhere would not share the decode loops' interpreter lock
FLEET_POLL_S = 0.05


def _fleet_streams(client, requests, stagger_s: float, timeout_s: float):
    """``requests`` submitted ``stagger_s`` apart over one client to the
    router, then every result: ({id: tokens}, the run's wall s)."""
    t0 = time.perf_counter()
    ids = {}
    for r in requests:
        ids[r.id] = _submit(client, r)
        time.sleep(stagger_s)
    snaps = {rid: client.result(sid, timeout=timeout_s, poll_interval=FLEET_POLL_S) for rid, sid in ids.items()}
    return {rid: s["tokens"] for rid, s in snaps.items()}, time.perf_counter() - t0


def _stamp_steps(engine, log: list) -> None:
    """Record (time, active rows) where the replica's loop returns from
    each decode step. The wrapper holds the engine weakly: a killed
    replica's engine must still be freed without the cyclic collector."""
    import weakref

    ref, step = weakref.ref(engine), type(engine).step

    def stamped():
        eng = ref()
        rows = eng.slots.active_count
        out = step(eng)
        log.append((time.perf_counter(), rows))
        return out

    engine.step = stamped


def _step_trend(log: list) -> dict:
    """The median gap between a replica's decode steps in the first and in
    the last quarter of its run (ms), with the median active rows there."""
    gaps = [((b - a) * 1e3, rows) for (a, _), (b, rows) in zip(log, log[1:])]
    q = max(1, len(gaps) // 4)
    first, last = gaps[:q], gaps[-q:]
    return dict(steps=len(log), first_ms=statistics.median(g for g, _ in first) if gaps else None,
                last_ms=statistics.median(g for g, _ in last) if gaps else None,
                first_rows=statistics.median(r for _, r in first) if gaps else None,
                last_rows=statistics.median(r for _, r in last) if gaps else None)


def _thread_cpu_s() -> dict:
    """CPU seconds each live thread of this process has used, by thread
    name (numbered where names repeat)."""
    import threading

    out = {}
    for t in threading.enumerate():
        try:
            cpu = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, TypeError):  # the thread ended meanwhile
            continue
        name, n = t.name, 1
        while name in out:
            n += 1
            name = f"{t.name}#{n}"
        out[name] = cpu
    return out


def _fleet_latency(stats) -> dict:
    return dict(ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p99=stats["ttft_ms_p99"],
                tpot_ms_p50=stats["tpot_ms_p50"], tpot_ms_p99=_percentile(stats, "tpot_ms", 0.99))


def phase_serve_fleet(torch, cfg, serving, card: str, requests, base, full, engine_step_ms,
                      num_slots=ENGINE_SLOTS, stagger_s=0.1, timeout_s=240):
    """The serving fleet on one card: ``launch_fleet`` over two decode
    replicas and one prefill replica, all on the card's one lease and one
    copy of the serving weights (``serving``). ``serve.engine``'s requests
    through a ``ServeClient`` at the router's address, staggered: every
    stream equal to ``serve.engine``'s full-prefill stream (a handoff
    prefills the whole prompt), routed = completed = 16, no requeue, both
    decode replicas serving, 16 handoffs, no flash launch, every replica's
    projections one storage. The same requests with replica 1 killed
    mid-stream (the ``replica_kill`` chaos kind): equal streams, requeues,
    the dead replica respawned inside the restart budget, and the card's
    memory back within 1 GiB of its value before the kill without the
    cyclic collector. Then a fleet of one replica under the autoscaler (min
    1, max 2): the first wave fills it and it scales out; the spawned
    replica passes the probation gate and takes the second wave; idle, it
    scales in by a drain; streams equal ``serve.engine``'s. Prints the
    fleet's TTFT, TPOT and tokens/s, each decode replica's step in the first
    and last quarter of the steady run, the time from spawn to UP, the peak
    memory and the monitor's fleet panel."""
    import gc
    import threading

    from maggy_tpu_torch.models.transformer import Dense
    from maggy_tpu_torch.monitor import render_status
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.resilience import chaos
    from maggy_tpu_torch.serve import ServeClient
    from maggy_tpu_torch.serve.fleet import AutoscaleConfig, ReplicaSpec, RouterConfig, launch_fleet

    dev = next(iter(serving.values())).device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    alloc = (lambda: torch.cuda.memory_allocated(dev)) if dev.type == "cuda" else (lambda: 0)
    spec = ReplicaSpec(cfg, serving, num_slots=num_slots, device=dev)
    ok = True
    out = {}
    router = launch_fleet(spec, replicas=2, prefill_replicas=1, config=RouterConfig(max_restarts=1))
    try:
        t0 = time.perf_counter()
        addr = router.start(host="127.0.0.1")
        start_s = time.perf_counter() - t0
        engines = {r.index: r.server.scheduler.engine for r in router.replicas}
        dense = [n + ".weight" for n, m in engines[0].model.named_modules() if isinstance(m, Dense)]
        shared = all(e.model.get_submodule(n[:-7]).weight.data_ptr() == serving[n].data_ptr()
                     for e in engines.values() for n in dense)
        logs = {i: [] for i in (0, 1)}
        for i in logs:
            _stamp_steps(engines[i], logs[i])
        del engines
        tracked = len(gc.get_objects())
        flash.reset_launches()
        cpu0 = _thread_cpu_s()
        with ServeClient(addr, router.secret) as client:
            streams, run_s = _fleet_streams(client, requests, stagger_s, timeout_s)
            cpu1 = _thread_cpu_s()
            stats = client.stats()
            status = client._client.request({"type": "STATUS"})
        routing = stats["routing"]
        decode_rows = [r for r in stats["replicas"] if r["role"] == "decode"]
        steady = dict(
            streams_equal_full_prefill=streams == full, differing=[i for i in full if streams.get(i) != full[i]],
            streams_equal_serve_engine=streams == base,
            routed=routing["routed"], completed=routing["completed"], requeued=routing["requeued"],
            prefilled=routing["prefilled"], handoffs=routing["handoffs"],
            done_by_replica={r["replica"]: r["requests_done"] for r in stats["replicas"]},
            no_kernel_launched=all(v == 0 for v in flash.LAUNCHES.values()), weights_one_storage=shared,
            run_s=run_s, start_s=start_s, **_fleet_latency(stats),
            tokens_per_sec=sum(len(t) for t in streams.values()) / run_s,
            replica_tokens_per_sec_ema={r["replica"]: r["tokens_per_sec"] for r in decode_rows},
            step_trend={i: _step_trend(log) for i, log in logs.items()},
            engine_times_decode_step_ms=engine_step_ms, tracked_objects=tracked,
            # where the host's time went: each thread's CPU seconds over the run
            thread_cpu_s=dict(sorted(((k, v - cpu0[k]) for k, v in cpu1.items() if k in cpu0), key=lambda kv: -kv[1])),
        )
        panel = render_status(status)
        steady["panel_replica_rows"] = all(f"r{i} [" in panel for i in (0, 1, 2))
        steady["panel"] = panel.splitlines()
        steady_ok = (steady["streams_equal_full_prefill"] and steady["routed"] == steady["completed"] == len(requests)
                     and steady["requeued"] == 0 and all(r["requests_done"] > 0 for r in decode_rows)
                     and steady["prefilled"] == steady["handoffs"] == len(requests)
                     and steady["no_kernel_launched"] and shared and steady["panel_replica_rows"])
        out["steady"] = steady
    finally:
        router.stop()
    del router
    gc.collect()

    # chaos on a fresh fleet: breakers the steady run opened would keep
    # traffic off replica 1, and a replica that never decodes is never
    # killed. Replica 1 is killed once it decodes; memory is read before
    # the kill and after the respawned fleet is idle again, no collection
    router = launch_fleet(spec, replicas=2, prefill_replicas=1, config=RouterConfig(max_restarts=1))
    try:
        addr = router.start(host="127.0.0.1")
        before = alloc()
        seen = []
        done = threading.Event()

        def watch():
            while not done.wait(0.1):
                rows = router._on_status({})["fleet"]["replicas"]
                seen.extend(r["state"] for r in rows if r["replica"] == 1 and r["state"] not in seen)

        watcher = threading.Thread(target=watch, daemon=True)
        chaos.install(chaos.Chaos.parse("replica_kill:replica=1"))
        try:
            watcher.start()
            with ServeClient(addr, router.secret) as client:
                streams, run_s = _fleet_streams(client, requests, stagger_s, timeout_s)
                try:
                    _wait(lambda: router.counters["respawned"] >= 1 and router._replica(1).alive(), timeout_s,
                          "replica 1's respawn")
                except SystemExit as e:
                    raise SystemExit(f"{e}; chaos fired: {chaos.get().fired}; "
                                     f"router log: {list(router._log)[-20:]}") from None
                _wait(lambda: client.stats()["in_flight"] == 0, timeout_s, "an idle fleet")
                stats = client.stats()
            fired = chaos.get().fired
        finally:
            chaos.reset()
            done.set()
            watcher.join(timeout=10)
        after = alloc()
        routing = stats["routing"]
        chaos_out = dict(
            fired=bool(fired), streams_equal_full_prefill=streams == full,
            differing=[i for i in full if streams.get(i) != full[i]], requeued=routing["requeued"],
            respawned=routing["respawned"], max_restarts=router.config.max_restarts,
            replica1_states_seen=seen, completed=routing["completed"],
            down_logged=any("replica 1 down: requeued" in line for line in router._log),
            allocated_before_kill_gib=before / 2**30, allocated_after_respawn_gib=after / 2**30,
            run_s=run_s, **_fleet_latency(stats),
        )
        chaos_ok = (chaos_out["fired"] and chaos_out["streams_equal_full_prefill"] and routing["requeued"] >= 1
                    and routing["respawned"] == 1 <= router.config.max_restarts and chaos_out["down_logged"]
                    and router._replica(1).restarts == 1 and abs(after - before) <= 2**30)
        out["chaos"] = chaos_out
        ok = steady_ok and chaos_ok
    finally:
        router.stop()
    del router
    gc.collect()

    # the autoscaler: one replica, min 1, max 2 decode replicas
    scale_cfg = AutoscaleConfig(min_replicas=1, max_replicas=2, target_util=0.75, low_util=0.3, high_hold_s=1.0,
                                low_hold_s=1.0, scale_cooldown_s=5.0, guard_window_s=2.0, drain_grace_s=3.0,
                                drain_timeout_s=120.0, warm_timeout_s=300.0)
    router = launch_fleet(spec, replicas=1, autoscale=scale_cfg, config=RouterConfig(default_service_ms=500.0))
    try:
        addr = router.start(host="127.0.0.1")
        scaler = router.autoscaler

        def events(name):
            return [e for e in scaler.snapshot()["events"] if e["event"] == name]

        first, second = requests[:num_slots], requests[num_slots:]
        with ServeClient(addr, router.secret) as client:
            ids = {}
            for r in first:
                ids[r.id] = _submit(client, r)
                time.sleep(stagger_s)
            _wait(lambda: events("fleet.scale.admitted"), 180, "the scale-out's admission")
            spawned = router._replica(1)
            on_card = spawned is not None and spawned.server.scheduler.engine.device == dev
            for r in second:
                ids[r.id] = _submit(client, r)
                time.sleep(stagger_s)
            streams = {rid: client.result(sid, timeout=timeout_s, poll_interval=FLEET_POLL_S)["tokens"]
                       for rid, sid in ids.items()}
            served = {r["replica"]: r["requests_done"] for r in client.stats()["replicas"]}
            _wait(lambda: events("fleet.scale.retired"), 120, "the scale-in's retirement")
            stats = client.stats()
        # the probation gate: a canary's TTFT closed the spawned replica's
        # breaker (the router logs the transition; nothing drained the log)
        breaker_closed = any("breaker CLOSED on replica 1" in line for line in router._log)
        up, admitted, retired = events("fleet.scale.up"), events("fleet.scale.admitted"), events("fleet.scale.retired")
        scale = dict(
            streams_equal_serve_engine=all(streams[i] == base[i] or streams[i] == full[i] for i in base),
            streams_equal_base=streams == base, differing=[i for i in base if streams.get(i) != base[i]],
            scale_ups=len(up), spawned_on_card=on_card, breaker_closed=breaker_closed,
            spawn_to_up_s=admitted[0]["warm_s"], retired_mode=retired[0]["mode"],
            requeued=stats["routing"]["requeued"], failed=stats["routing"]["failed"],
            done_by_replica_before_scale_in=served,
            events=[(e["event"], e.get("replica"), e.get("reason") or e.get("mode")) for e in scaler.snapshot()["events"]],
        )
        scale_ok = (scale["streams_equal_serve_engine"] and len(up) == 1 and on_card and breaker_closed
                    and scale["failed"] == 0 and len(retired) == 1)
        out["autoscale"] = scale
        ok = ok and scale_ok
    finally:
        router.stop()
    emit("serve.fleet", ok=ok, slots=num_slots, requests=len(requests), **out,
         max_memory_allocated_gib=_peak_gib(torch, dev), card=card)
    if not ok:
        raise SystemExit(f"serve.fleet failed: {out}")


def phase_serve_cli(torch, card: str, slots=4, n=4, prompt_len=256, max_new=32, start_s=600, timeout_s=300,
                    fleet=None):
    """``python -m maggy_tpu_torch.serve --config llama3_8b --slots 4`` as its
    own process on ``cuda:0`` (random init from its seed): its address and
    secret read from its stderr, four requests through ``ServeClient``, all
    done; SIGTERM, then exit 0 within 60 s. Prints the parameter init time,
    the process's start-up, the first request's TTFT and its peak memory.
    With ``fleet=(replicas, prefill_replicas)`` the process serves a fleet
    (``serve.cli.fleet``): a router over that many replicas on the card,
    every request handed off through a prefill replica. Every wait has its
    own timeout, and the process is killed if the phase fails."""
    import queue
    import re
    import signal
    import threading

    from maggy_tpu_torch.models import DecoderConfig
    from maggy_tpu_torch.serve import ServeClient

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "maggy_tpu_torch.serve", "--config", "llama3_8b", "--slots", str(slots),
           "--host", "127.0.0.1", "--port", "0"]
    if fleet:
        cmd += ["--replicas", str(fleet[0]), "--prefill-replicas", str(fleet[1])]
    lines: "queue.Queue[str]" = queue.Queue()
    log = []

    def expect(pattern: str, timeout: float):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                break
            log.append(line.rstrip())
            m = re.search(pattern, line)
            if m:
                return m
        raise SystemExit(f"serve.cli: no {pattern!r} within {timeout} s; stderr: {log[-20:]}")

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stderr], daemon=True).start()
    try:
        init_s = float(expect(r"params from .* in ([\d.]+)s", start_s).group(1))
        m = expect(r"listening on ([\d.]+):(\d+)", start_s)
        addr = (m.group(1), int(m.group(2)))
        secret = expect(r"secret: (\S+)", 30).group(1)
        up_s = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(9)
        vocab = DecoderConfig.llama3_8b().vocab_size
        prompts = [torch.randint(0, vocab, (prompt_len,), generator=gen).tolist() for _ in range(n)]
        with ServeClient(addr, secret) as client:
            t1 = time.perf_counter()
            first = client.result(client.submit(prompts[0], max_new=max_new), timeout=timeout_s)
            first_s = time.perf_counter() - t1
            rest = [client.submit(p, max_new=max_new, seed=i) for i, p in enumerate(prompts[1:], 1)]
            snaps = [first] + [client.result(rid, timeout=timeout_s) for rid in rest]
            stats = client.stats()
        proc.send_signal(signal.SIGTERM)
        t2 = time.perf_counter()
        rc = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t2
        peak = float(expect(r"peak ([\d.]+) GiB", 30).group(1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    ok = (rc == 0 and all(s["state"] == "done" and s["n_tokens"] == max_new for s in snaps)
          and stats["requests_failed"] == 0)
    extra = {}
    if fleet:
        extra = dict(replicas=[(r["replica"], r["role"], r["state"]) for r in stats["replicas"]],
                     routing=stats["routing"])
        ok = ok and len(stats["replicas"]) == sum(fleet) and stats["routing"]["handoffs"] == n
    phase = "serve.cli.fleet" if fleet else "serve.cli"
    emit(phase, ok=ok, cmd=" ".join(cmd[1:]), exit_code=rc, exit_s=exit_s, params_init_s=init_s,
         startup_s=up_s, first_ttft_ms=first["ttft_ms"], first_request_s=first_s,
         done=sum(s["state"] == "done" for s in snaps), tpot_ms_p50=stats["tpot_ms_p50"],
         peak_allocated_gib=peak, **extra, card=card)
    if not ok:
        raise SystemExit(f"{phase} failed: rc {rc}, states {[s['state'] for s in snaps]}")


def phase_lagom_train(torch, cfg, seq: int, steps: int, card: str, train_step_ms):
    """Phase 11: LAGOM_TRIALS HPO trials of the ``train`` configuration under
    the port's ``lagom``, each on the card its executor leased."""
    import gc
    import statistics
    import tempfile
    import threading

    from maggy_tpu_torch import Searchspace, experiment
    from maggy_tpu_torch.config import HyperparameterOptConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    cards = range(torch.cuda.device_count())
    trials, lock = [], threading.Lock()

    def train_fn(hparams, reporter, devices):
        dev = devices[0]
        rec = dict(lease=str(dev), lr=hparams["lr"], t0=time.perf_counter(),
                   start_bytes=torch.cuda.memory_allocated(dev), before_peak=torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(Decoder(cfg, device="meta"), adamw(hparams["lr"]), device=dev)
        data = synthetic_lm_batches(cfg.vocab_size, B, seq, seed=0)
        state = trainer.make_state(0, next(data))
        rec["current"] = str(torch.device("cuda", torch.cuda.current_device()))
        rec["params_on_lease"] = all(p.device == dev for p in state.model.parameters())
        state, _ = trainer.step(state, next(data))  # warm-up, as in `train`
        broadcasts = []

        class Record:
            """The trial's reporter, with the host clock read at each
            broadcast (each follows a step's loss read, which waits for the
            card): the gaps are a side figure beside ``fit``'s mean step."""

            def broadcast(self, value, step):
                broadcasts.append((time.perf_counter(), value))
                reporter.broadcast(value, step=step)

        torch.cuda.synchronize(dev)
        t_fit = time.perf_counter()
        state, metrics = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0)
        marks = [t_fit] + [t for t, _ in broadcasts]
        each_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        # the ratio's step is the `train` phase's statistic: fit's wall time
        # over its steps, a mean that keeps a stall in
        rec.update(losses=[v for _, v in broadcasts], metric=metrics["loss"],
                   step_ms=1e3 / metrics["steps_per_sec"], step_ms_each=each_ms,
                   step_ms_median=statistics.median(each_ms), t1=time.perf_counter(),
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        with lock:
            trials.append(rec)
        return {"metric": metrics["loss"]}

    gc.collect()
    torch.cuda.init()  # every card's allocator, before its stats are read or reset
    torch.cuda.empty_cache()
    base = {i: torch.cuda.memory_allocated(i) for i in cards}
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    cfg_hpo = HyperparameterOptConfig(
        num_trials=LAGOM_TRIALS, optimizer="randomsearch", seed=0,
        searchspace=Searchspace(lr=("DOUBLE", [1e-5, 1e-4])), direction="min",
        es_policy="none", hb_interval=LAGOM_HB,
    )
    flash.reset_launches()
    with tempfile.TemporaryDirectory(prefix="lagom_train_") as root:
        env_mod.set_instance(BaseEnv(root))  # logs in a temporary root, never the repo
        try:
            t0 = time.perf_counter()
            result = experiment.lagom(train_fn, cfg_hpo)
            wall_s = time.perf_counter() - t0
        finally:
            env_mod.set_instance(None)
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    expected = {k: LAGOM_TRIALS * (1 + steps) * v for k, v in flash_launches_per_step(cfg.n_layers).items()}
    left = [t.name for t in threading.enumerate() if t.name.startswith("maggy-executor")]

    trials.sort(key=lambda r: r["t0"])
    by_metric = sorted(r["metric"] for r in trials)
    leased = sorted({r["lease"] for r in trials})
    checks = {
        "two_trials_no_error": result["num_trials"] == LAGOM_TRIALS and result["errors"] == 0
        and len(trials) == LAGOM_TRIALS,
        "metric_is_last_broadcast": all(r["losses"] and r["metric"] == r["losses"][-1] for r in trials)
        and sorted([result["best"]["metric"], result["worst"]["metric"]]) == [by_metric[0], by_metric[-1]],
        "losses_finite": all(math.isfinite(v) for r in trials for v in r["losses"]),
        "on_lease": all(r["current"] == r["lease"] and r["params_on_lease"] for r in trials),
        "launches": launches == expected,
        "no_executor_left": not left,
    }
    concurrent = len(cards) >= 2
    if concurrent:  # two executors, disjoint cards, overlapping windows
        checks["concurrent"] = len(leased) == LAGOM_TRIALS and max(r["t0"] for r in trials) < min(
            r["t1"] for r in trials)
    gib = 2**30
    after = {i: torch.cuda.memory_allocated(i) for i in cards}
    # a card's peak over the phase: its peak before each trial's reset, and
    # since the last one
    phase_peak = {i: max([torch.cuda.max_memory_allocated(i)] + [
        r["before_peak"] for r in trials if r["lease"] == f"cuda:{i}"]) - base[i] for i in cards}
    trial_peak = max(r["peak_bytes"] - r["start_bytes"] for r in trials)
    lease_ids = [int(s.split(":")[1]) for s in leased]
    checks["memory_back"] = all(abs(after[i] - base[i]) <= gib for i in lease_ids)
    checks["trials_do_not_stack"] = max(phase_peak.values()) <= trial_peak + 2 * gib
    # the time some train_fn ran: the union of the trials' windows (sorted by
    # start), which overlap when trials run at once
    fn_s, reach = 0.0, -math.inf
    for r in trials:
        fn_s += max(0.0, r["t1"] - max(r["t0"], reach))
        reach = max(reach, r["t1"])
    ok = all(checks.values())
    emit(
        "lagom.train", ok=ok, checks=checks, concurrent=concurrent, leases=leased,
        trials=[dict(lease=r["lease"], lr=r["lr"], losses=r["losses"], metric=r["metric"],
                     step_ms=r["step_ms"], step_ms_each=r["step_ms_each"], step_ms_median=r["step_ms_median"],
                     ratio_to_train_step=None if train_step_ms is None else r["step_ms"] / train_step_ms,
                     train_fn_s=r["t1"] - r["t0"]) for r in trials],
        train_step_ms=train_step_ms, wall_s=wall_s, train_fn_union_s=fn_s, wall_minus_train_fn_s=wall_s - fn_s,
        launches=launches, expected=expected,
        memory_after_minus_before_gib={i: (after[i] - base[i]) / gib for i in lease_ids},
        peak_gib=max(phase_peak.values()) / gib, trial_peak_gib=trial_peak / gib, card=card,
    )
    if not ok:
        raise SystemExit(f"lagom.train failed: {[k for k, v in checks.items() if not v]}")
    return launches


def bert_dataset(cfg, rows: int, seq: int, seed: int = 0) -> dict:
    """BERT's synthetic classification data from a seed: tokens, an
    attention mask whose rows keep 1/4 to all of ``seq`` tokens (a padded
    tail of 0s), and a label that a token of the kept part decides."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (rows, seq)).astype(np.int64)
    keep = rng.integers(seq // 4, seq + 1, (rows,))
    mask = (np.arange(seq)[None, :] < keep[:, None]).astype(np.int64)
    tokens = tokens * mask  # padding is token 0
    return {"tokens": tokens, ABL_BERT_FEATURE: mask, "label": (tokens[:, 1] % 2).astype(np.int64)}


def component_params(model, component: str) -> list:
    """The names of ``model``'s parameters that belong to ``component`` of a
    LOCO study (BERT's names: ``layer_<i>``, ``pooler``,
    ``position_embeddings``)."""
    if component == "position_embeddings":
        return [n for n, _ in model.named_parameters() if n == "position_embedding"]
    return [n for n, _ in model.named_parameters() if component in n.split(".")]


def decoder_gated(component: str, name: str) -> bool:
    """Whether the Decoder parameter ``name`` feeds only what ``component``
    (``mlp`` or ``layers.<i>``) gates: its gradient must then be zero."""
    if component == "mlp":
        return ".mlp." in name or ".mlp_norm." in name
    return name.startswith(component + ".")


def phase_lagom_ablation(torch, bert_cfg, dec_cfg, seq: int, steps: int, card: str, train_step_ms):
    """Phase 12: two LOCO studies under the port's ``lagom``, each trial on
    the card its executor leased: ``bert_cfg`` at its ``max_seq_len`` (no
    flash kernel, as in JAX), then ``dec_cfg`` at B=2 and ``seq`` tokens
    (the ``train`` configuration), whose trials, gated or not, train through
    the flash kernels for a warm-up step and ``steps`` fit steps. Returns
    the Decoder study's flash launches."""
    import dataclasses
    import gc
    import tempfile
    import threading

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.ablation import AblationStudy
    from maggy_tpu_torch.config import AblationConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.models import Bert, Decoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    t_phase = time.perf_counter()
    gib = 2**30
    gc.collect()
    torch.cuda.empty_cache()
    dev0 = torch.device("cuda", torch.cuda.current_device())
    base_bytes = torch.cuda.memory_allocated(dev0)
    torch.cuda.reset_peak_memory_stats(dev0)
    data = bert_dataset(bert_cfg, ABL_BERT_ROWS, bert_cfg.max_seq_len)
    bert_base = Bert(bert_cfg, device="meta")
    dec_base = Decoder(dec_cfg, device="meta")
    bert_recs, dec_recs, lock = [], [], threading.Lock()

    def on_lease(model, dev) -> dict:
        return dict(lease=str(dev), current=str(torch.device("cuda", torch.cuda.current_device())),
                    params_on_lease=all(p.device == dev for p in model.parameters()))

    def bert_fn(model, dataset, hparams, reporter, devices, ablated_feature, ablated_component):
        dev = devices[0]
        rec = dict(feature=ablated_feature, component=ablated_component, keys=sorted(dataset),
                   hparams=dict(hparams), params=sum(p.numel() for p in model.parameters()),
                   was_meta=all(p.is_meta for p in model.parameters()))
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
        model.to_empty(device=dev)
        model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
        model.train()  # dropout 0.1, from the model's own generator on the card
        rec.update(on_lease(model, dev))
        opt = adamw(1e-4)(model.parameters())
        tokens = torch.as_tensor(dataset["tokens"], device=dev)
        mask = dataset.get(ABL_BERT_FEATURE)
        mask = None if mask is None else torch.as_tensor(mask, device=dev)
        labels = torch.as_tensor(dataset["label"], device=dev)
        losses = []
        t0 = None
        for i in range(1 + ABL_BERT_STEPS):
            if i == 1:  # the first step is the warm-up, outside the time
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            rows = slice((i * ABL_BERT_B) % len(labels), (i * ABL_BERT_B) % len(labels) + ABL_BERT_B)
            logits, _ = model(tokens[rows], None if mask is None else mask[rows])
            loss = torch.nn.functional.cross_entropy(logits, labels[rows])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        losses = [float(v) for v in losses]  # one read, after the last step
        dt = time.perf_counter() - t0
        rec.update(losses=losses, steps_per_sec=ABL_BERT_STEPS / dt, step_ms=1e3 * dt / ABL_BERT_STEPS,
                   peak_gib=(torch.cuda.max_memory_allocated(dev) - start_bytes) / gib)
        with lock:
            bert_recs.append(rec)
        reporter.broadcast(losses[-1], step=ABL_BERT_STEPS)
        return losses[-1]

    def dec_fn(model, reporter, devices, ablated_component):
        dev = devices[0]
        rec = dict(component=ablated_component, was_meta=all(p.is_meta for p in model.parameters()))
        trainer = Trainer(model, adamw(1e-4), device=dev)
        batches = synthetic_lm_batches(dec_cfg.vocab_size, B, seq, seed=0)
        state = trainer.make_state(0, next(batches))
        rec.update(on_lease(state.model, dev))
        state, _ = trainer.step(state, next(batches))  # warm-up, as in `train`
        torch.cuda.synchronize(dev)
        state, metrics = trainer.fit(state, batches, steps, reporter=reporter, report_every=1, metrics_window=0)
        # the last step's gradients, left on the parameters by fit
        rec.update(loss=metrics["loss"], step_ms=1e3 / metrics["steps_per_sec"],
                   grad_max={n: float(p.grad.abs().max()) for n, p in state.model.named_parameters()})
        with lock:
            dec_recs.append(rec)
        return metrics["loss"]

    def run(train_fn, config):
        with tempfile.TemporaryDirectory(prefix="lagom_ablation_") as root:
            env_mod.set_instance(BaseEnv(root))  # logs in a temporary root, never the repo
            try:
                t0 = time.perf_counter()
                return experiment.lagom(train_fn, config), time.perf_counter() - t0
            finally:
                env_mod.set_instance(None)

    # BERT-base: config model on the meta device, no factory
    bert_study = AblationStudy()
    bert_study.features.include(ABL_BERT_FEATURE)
    bert_study.model.layers.include(*ABL_BERT_COMPONENTS)
    flash.reset_launches()
    bert_result, bert_wall = run(bert_fn, AblationConfig(
        bert_study, model=bert_base, dataset=data, direction="min", hb_interval=LAGOM_HB))
    torch.cuda.synchronize()
    bert_launches = dict(flash.LAUNCHES)

    # the bf16 forward of the full model against its fp32 forward, same weights
    fwd = Bert(bert_cfg, device=dev0, generator=torch.Generator(device=dev0).manual_seed(0)).eval()
    fwd32 = Bert(dataclasses.replace(bert_cfg, dtype=torch.float32), device="meta")
    fwd32.to_empty(device=dev0)
    fwd32.load_state_dict(fwd.state_dict())
    fwd32.eval()
    rows = slice(0, 8)
    tok8 = torch.as_tensor(data["tokens"][rows], device=dev0)
    mask8 = torch.as_tensor(data[ABL_BERT_FEATURE][rows], device=dev0)
    with torch.no_grad():
        logits16, seq16 = fwd(tok8, mask8)
        logits32, seq32 = fwd32(tok8, mask8)
    bf16_err = dict(sequence=rel_l2(seq16, seq32), logits=rel_l2(logits16, logits32))
    del fwd, fwd32, logits16, seq16, logits32, seq32

    # the Decoder at the `train` widths and depth: gates, through the kernels
    dec_study = AblationStudy()
    dec_study.model.layers.include(*ABL_DECODER_COMPONENTS)
    flash.reset_launches()
    dec_result, dec_wall = run(dec_fn, AblationConfig(
        dec_study, model=dec_base, direction="min", hb_interval=LAGOM_HB))
    torch.cuda.synchronize()
    launches = dict(flash.LAUNCHES)
    expected = {k: len(dec_recs) * (1 + steps) * v for k, v in flash_launches_per_step(dec_cfg.n_layers).items()}
    left = [t.name for t in threading.enumerate() if t.name.startswith("maggy-executor")]
    after_bytes = torch.cuda.memory_allocated(dev0)
    peak = (torch.cuda.max_memory_allocated(dev0) - base_bytes) / gib

    base_count = sum(p.numel() for p in bert_base.parameters())
    base_params = dict(bert_base.named_parameters())
    own = {c: sum(base_params[n].numel() for n in component_params(bert_base, c)) for c in ABL_BERT_COMPONENTS}
    want_markers = {(None, None), (ABL_BERT_FEATURE, None)} | {(None, c) for c in ABL_BERT_COMPONENTS}
    by_comp = {r["component"]: r for r in dec_recs}
    base_rec = by_comp.get(None, {"grad_max": {}})
    checks = {
        "bert_trials_no_error": bert_result["num_trials"] == 2 + len(ABL_BERT_COMPONENTS)
        and bert_result["errors"] == 0 and len(bert_recs) == 2 + len(ABL_BERT_COMPONENTS),
        "bert_markers": {(r["feature"], r["component"]) for r in bert_recs} == want_markers,
        "bert_fresh_meta_variants": all(r["was_meta"] for r in bert_recs),
        "bert_on_lease": all(r["current"] == r["lease"] and r["params_on_lease"] for r in bert_recs),
        "bert_param_counts": all(
            r["params"] == base_count - (own[r["component"]] if r["component"] else 0) for r in bert_recs)
        and all(own.values()),
        "feature_trial_data": all(
            (ABL_BERT_FEATURE not in r["keys"]) == (r["feature"] == ABL_BERT_FEATURE) for r in bert_recs),
        "no_marker_in_hparams": all(
            not {"ablated_feature", "ablated_component"} & set(r["hparams"]) for r in bert_recs),
        "bert_losses_finite": all(math.isfinite(v) for r in bert_recs for v in r["losses"]),
        "bert_launches_no_flash": not any(bert_launches.values()),
        "bert_bf16_vs_fp32": max(bf16_err.values()) <= TOL_BERT_BF16_REL_L2,
        "decoder_trials_no_error": dec_result["num_trials"] == 1 + len(ABL_DECODER_COMPONENTS)
        and dec_result["errors"] == 0 and len(dec_recs) == 1 + len(ABL_DECODER_COMPONENTS),
        "decoder_fresh_meta_variants": all(r["was_meta"] for r in dec_recs),
        "decoder_on_lease": all(r["current"] == r["lease"] and r["params_on_lease"] for r in dec_recs),
        "decoder_losses_finite": all(math.isfinite(r["loss"]) for r in dec_recs),
        "launches": launches == expected,
        "gated_grads_zero": all(
            c in by_comp and all(g == 0.0 for n, g in by_comp[c]["grad_max"].items() if decoder_gated(c, n))
            for c in ABL_DECODER_COMPONENTS),
        "baseline_grads_nonzero": all(
            g > 0.0 for c in ABL_DECODER_COMPONENTS for n, g in base_rec["grad_max"].items()
            if decoder_gated(c, n)) and bool(base_rec["grad_max"]),
        "no_executor_left": not left,
        "memory_back": abs(after_bytes - base_bytes) <= ABL_MEMORY_MARGIN_GIB * gib,
    }
    if train_step_ms is not None:
        checks["decoder_step_within_factor"] = all(r["step_ms"] <= ABL_STEP_FACTOR * train_step_ms for r in dec_recs)
    phase_s = time.perf_counter() - t_phase
    ok = all(checks.values())
    emit(
        "lagom.ablation", ok=ok, checks=checks, card=card,
        bert=dict(
            config=dict(n_layers=bert_cfg.n_layers, d_model=bert_cfg.d_model, n_heads=bert_cfg.n_heads,
                        d_ff=bert_cfg.d_ff, vocab=bert_cfg.vocab_size, seq=bert_cfg.max_seq_len, batch=ABL_BERT_B,
                        steps=ABL_BERT_STEPS),
            trials=[dict(feature=r["feature"], component=r["component"], params=r["params"],
                         loss_first=r["losses"][0], loss_last=r["losses"][-1], steps_per_sec=r["steps_per_sec"],
                         step_ms=r["step_ms"], peak_gib=r["peak_gib"], lease=r["lease"]) for r in bert_recs],
            base_params=base_count, component_params=own, bf16_vs_fp32_rel_l2=bf16_err,
            best=bert_result["best"]["params"], wall_s=bert_wall, flash_launches=bert_launches,
        ),
        decoder=dict(
            trials=[dict(component=r["component"], loss=r["loss"], step_ms=r["step_ms"],
                         ratio_to_train_step=None if train_step_ms is None else r["step_ms"] / train_step_ms,
                         lease=r["lease"],
                         gated_grad_max=max([g for c in ABL_DECODER_COMPONENTS for n, g in r["grad_max"].items()
                                             if decoder_gated(c, n) and (r["component"] in (None, c))],
                                            default=None)) for r in dec_recs],
            launches=launches, expected=expected, wall_s=dec_wall, train_step_ms=train_step_ms,
        ),
        memory_after_minus_before_gib=(after_bytes - base_bytes) / gib, peak_gib=peak,
        phase_s=phase_s, budget_s=ABL_BUDGET_S,
    )
    if not ok:
        raise SystemExit(f"lagom.ablation failed: {[k for k, v in checks.items() if not v]}")
    return launches


def zero_grads(torch, layout) -> dict:
    """A ZeRO-1 state's gradients gathered whole: each bucket's
    reduce-scattered shards all-gathered over ``data`` and cut into its
    parameters, by name. Every rank must call it."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel import overlap

    flats = {}
    for b, shard in zip(layout.plan.buckets, layout.grads.out):
        full = torch.empty(b.padded_size, dtype=shard.dtype, device=shard.device)
        overlap.all_gather_flat(dist)(full, shard, group=layout.group)
        flats[b.name] = full
    return dict(zip(layout.names, overlap.unflatten_buckets(flats, layout.plan, list(layout.names))))


def grad_norms_by_group(model, state=None) -> dict:
    """The L2 norm of each group of the model's gradients (the norm scales,
    the embedding, attention, the MLP or the MoE block, ``lm_head``), every gradient
    gathered whole (``full_tensor``; a ZeRO-1 state's from its shards) on
    every rank and summed there, each group over the pipeline stages that
    hold a share of it: a count of its own, apart from the trainer's
    sharded norm. Every rank must call it."""
    import torch

    from maggy_tpu_torch.parallel.expert import expert_params, gather_expert_tensor

    layout = getattr(state, "layout", None)
    whole = zero_grads(torch, layout) if layout is not None and layout.zero is not None else None
    experts = expert_params(model)  # an MoE rank's experts: gathered over `expert` too
    sums = {}
    for name, p in model.named_parameters():
        g = whole[name] if whole is not None else p.grad
        if g is None:
            continue
        if name in experts:
            g = gather_expert_tensor(g, experts[name][1])
        else:
            g = g.full_tensor() if hasattr(g, "full_tensor") else g
        group = "norm" if name.endswith("scale") else next(k for k in ("embedding", "attn", "mlp", "moe", "lm_head")
                                                            if k in name)
        sums[group] = sums.get(group, 0.0) + float(g.float().square().sum())
        del g
    pipe = getattr(state, "pipeline", None)
    if pipe is not None:  # a stage holds its share of each group: summed over the stages
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.mesh import stage_group

        keys = ("norm", "embedding", "attn", "mlp", "moe", "lm_head")
        p0 = next(model.parameters())
        t = torch.tensor([sums.get(k, 0.0) for k in keys], dtype=torch.float64,
                         device=getattr(p0, "to_local", lambda: p0)().device)
        dist.all_reduce(t, group=stage_group(pipe.mesh))
        # the model's own groups: a Decoder has no MoE block, an MoEDecoder no MLP
        sums = {k: v for k, v in zip(keys, t.tolist()) if v > 0}
    return {k: math.sqrt(v) for k, v in sums.items()}


def record_routes(model):
    """Forward hooks on the router of every MoE block of ``model`` (a model
    or a pipeline stage) that keep each call's top-k experts of every token
    (sorted, uint8 ``[tokens, k]``, on the device) by layer index. Returns
    ``(hooks, records)``; the hooks only read."""
    import torch

    from maggy_tpu_torch.models.moe import top_k_lowest_first
    from maggy_tpu_torch.parallel.expert import moe_blocks

    records, hooks = {}, []
    for name, block in moe_blocks(model):
        layer, k = int(name.split(".")[-2]), block.cfg.top_k

        def hook(_mod, _args, out, layer=layer, k=k):
            out = out.to_local() if hasattr(out, "to_local") else out
            with torch.no_grad():
                idx = top_k_lowest_first(torch.softmax(out.detach().float(), -1), k)[1].sort(-1).values
            records.setdefault(layer, []).append(idx.reshape(-1, k).to(torch.uint8))

        hooks.append(block.router.register_forward_hook(hook))
    return hooks, records


def encode_routes(records: dict) -> dict:
    """:func:`record_routes`' records as ``{layer: base64 of uint8 [calls x
    tokens, k]}``, each forward once: a call equal to one of the layer's
    last four is the same forward run again (remat's recompute, a pipeline
    stage's forward at its backward tick: at most two microbatches of a
    step apart); two forwards of different batches never route every token
    alike."""
    import base64

    import torch

    out = {}
    for layer, recs in records.items():
        unique = []
        for r in recs:
            if not any(r.shape == u.shape and torch.equal(r, u) for u in unique[-4:]):
                unique.append(r)
        out[str(layer)] = base64.b64encode(torch.cat(unique).cpu().numpy().tobytes()).decode()
    return out


def decode_routes(encoded: dict, k: int, tokens: int) -> dict:
    """``{layer: uint8 [steps, tokens, k]}`` from :func:`encode_routes`,
    ``tokens`` a step (a pipeline's microbatches in order: the batch's
    rows); a layer whose calls do not make whole steps is left out."""
    import base64

    import numpy as np

    out = {}
    for layer, text in encoded.items():
        flat = np.frombuffer(base64.b64decode(text), dtype=np.uint8).reshape(-1, k)
        if len(flat) % tokens == 0:
            out[int(layer)] = flat.reshape(-1, tokens, k)
    return out


def routed_differently(routes: dict, ref: dict) -> list:
    """The share of tokens routed to other experts than in ``ref`` in any
    layer, a step (as moe.model counts a flip), over the steps both hold;
    ``[]`` when a layer of ``ref`` is missing."""
    import numpy as np

    if not ref or set(ref) - set(routes):
        return []
    n = min(min(len(v) for v in routes.values()), min(len(v) for v in ref.values()))
    flips = np.zeros((n, next(iter(ref.values())).shape[1]), dtype=bool)
    for layer, want in ref.items():
        flips |= (routes[layer][:n] != want[:n]).any(-1)
    return [float(f.mean()) for f in flips]


def skip_expert_weights(optimizer):
    """A planted fault: ``optimizer`` over every parameter but the MoE
    expert weights, which then never move (an optimizer step that misses
    the sharded expert weights)."""
    from maggy_tpu_torch.parallel.expert import EXPERT_ATTR

    return lambda params: optimizer([p for p in params if not hasattr(p, EXPERT_ATTR)])


def mesh_steps(ctx, model, steps: int, seq: int, reporter=None, rows_repeat: int = 1, optimizer=None,
               routes: bool = False, **trainer_kw) -> dict:
    """The ``train`` phase's steps on a rank of ``ctx``'s mesh: its weights
    (seed 0) and batches, a one-step warm-up fit, then ``steps`` fit steps
    (prefetch 2, every loss broadcast). Each rank passes the global batch;
    fit takes its rows (and their chunk of the sequence under ``seq``).
    ``rows_repeat`` > 1 stacks each batch's B rows that many times, so a
    mesh of more batch ranks than rows gets a row each: the token-weighted
    mean over repeated rows, and its gradient, are the B rows' own.
    ``trainer_kw`` goes to ``ctx.trainer`` (``zero_stage``, ``bucket_mb``,
    ``n_microbatches``), ``optimizer`` (default ``adamw(1e-4)``) too.
    Returns the losses, the grad norms, the warm-up step's norm of each
    gradient group (:func:`grad_norms_by_group`) and how far the trainer's
    grad norm lies from theirs, the mean step, the peak memory, the
    optimizer's bytes on this rank, the overlap mode, and the flash and
    ring launches of both fits; with ``routes``, every step's routing of
    an MoE model's layers on this rank (:func:`encode_routes`)."""
    import torch

    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.ops import ring_flash as rf
    from maggy_tpu_torch.parallel import overlap
    from maggy_tpu_torch.train import adamw, synthetic_lm_batches

    import numpy as np

    trainer = ctx.trainer(model, optimizer or adamw(1e-4), **trainer_kw)
    data = synthetic_lm_batches(model.cfg.vocab_size, B, seq, seed=0)
    if rows_repeat > 1:
        data = ({k: np.concatenate([v] * rows_repeat) for k, v in batch.items()} for batch in data)
    state = trainer.make_state(0, next(data))
    hooks, records = record_routes(state.model) if routes else ([], {})
    flash.reset_launches()
    rf.reset_launches()
    state, warm = trainer.fit(state, data, 1)
    groups = grad_norms_by_group(state.model, state)  # the warm-up step's gradients, still held
    whole = math.sqrt(sum(v * v for v in groups.values()))
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30  # what a state holds between steps
    torch.cuda.reset_peak_memory_stats()
    losses = []

    class Record:
        def broadcast(self, value, step):
            losses.append(value)
            if reporter is not None:
                reporter.broadcast(value, step=step)

    state, metrics = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0)
    torch.cuda.synchronize()
    pipe = {}
    for hook in hooks:
        hook.remove()
    if routes:
        pipe["routes"] = encode_routes(records)
    on_card = all(getattr(p, "to_local", lambda: p)().device == ctx.device for p in state.model.parameters())
    pipe.update({} if state.pipeline is None else dict(stage=state.pipeline.stage, n_micro=trainer._n_micro()))
    from maggy_tpu_torch.parallel.expert import moe_blocks

    block = next((b for _, b in moe_blocks(state.model)), None)
    if block is not None:  # the experts this rank holds
        pipe["experts"] = int(block.w_gate.shape[0])
    return dict(metric=metrics["loss"], losses=[warm["loss"]] + losses, first_grad_norm=warm["grad_norm"],
                first_aux_loss=warm["aux_loss"], params_on_card=on_card, group_grad_norms=groups,
                grad_norm_count_rel=_rel(warm["grad_norm"], whole),
                last_grad_norm=metrics["grad_norm"], step_ms=1e3 / metrics["steps_per_sec"],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, state_gib=state_gib,
                launches=dict(flash.LAUNCHES), ring_launches=dict(rf.LAUNCHES), opt_bytes=overlap.opt_state_bytes_per_device(state),
                mode=trainer._overlap_mode()[0], seq_rank=ctx.mesh.get_local_rank("seq"), **pipe,
                device=str(ctx.device), mesh={k: v for k, v in zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)
                                              if v > 1})


def dist_lagom_train(model, hparams, reporter, ctx):
    """dist.lagom's train_fn, run by each rank of the study: the ``train``
    phase's steps under the rank's mesh."""
    return mesh_steps(ctx, model, hparams["steps"], hparams["seq"], reporter)


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def phase_dist_lagom(torch, cfg, seq: int, steps: int, card: str, train_ref: dict, train_step_ms):
    """``lagom(train_fn, DistributedConfig(sharding="fsdp", num_executors=1))``:
    one spawned rank on card 0, FSDP2 on a one-rank mesh, the ``train``
    phase's steps, held to them. Returns the rank's result."""
    import gc
    import tempfile
    from pathlib import Path

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.models import Decoder

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info(0)[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dist_lagom_") as root:
        env_mod.set_instance(BaseEnv(root))  # logs in a temporary root, never the repo
        try:
            result = experiment.lagom(dist_lagom_train, DistributedConfig(
                module=Decoder(cfg, device="meta"), hparams=dict(steps=steps, seq=seq), sharding="fsdp",
                num_executors=1, hb_interval=LAGOM_HB, worker_timeout=DIST_LAGOM_BUDGET_S,
            ))
            rank = json.loads(next(Path(root).rglob("worker_0/.outputs.json")).read_text())
        finally:
            env_mod.set_instance(None)
    phase_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    free_after = torch.cuda.mem_get_info(0)[0]
    expected = {k: (1 + steps) * v for k, v in flash_launches_per_step(cfg.n_layers).items()}
    want = train_ref["losses"][: steps + 1]
    loss_rel = [_rel(g, w) for g, w in zip(rank["losses"], want)]
    norm_rel = dict(first=_rel(rank["first_grad_norm"], train_ref["first_grad_norm"]),
                    last=_rel(rank["last_grad_norm"], train_ref["last_grad_norm"]))
    checks = {
        "one_worker": result["num_workers"] == 1 and rank["device"] == "cuda:0" and rank["params_on_card"],
        "losses_finite": all(math.isfinite(v) for v in rank["losses"]),
        "losses_match_train": len(loss_rel) == steps + 1 and max(loss_rel) <= TOL_DIST_LAGOM_LOSS_REL,
        "grad_norms_match_train": max(norm_rel.values()) <= TOL_DIST_LAGOM_GRAD_NORM_REL,
        "grad_norm_counts_every_gradient": rank["grad_norm_count_rel"] <= TOL_GRAD_NORM_COUNT_REL,
        "launches": rank["launches"] == expected,
        "memory_back": free_after >= free_before - DIST_MEMORY_MARGIN_GIB * 2**30,
        "within_budget": phase_s <= DIST_LAGOM_BUDGET_S,
    }
    ok = all(checks.values())
    emit(
        "dist.lagom", ok=ok, checks=checks, losses=rank["losses"], train_losses=want, loss_rel=loss_rel,
        grad_norms=dict(first=rank["first_grad_norm"], last=rank["last_grad_norm"]), grad_norm_rel=norm_rel,
        group_grad_norms=rank["group_grad_norms"], grad_norm_count_rel=rank["grad_norm_count_rel"],
        tol=dict(loss_rel=TOL_DIST_LAGOM_LOSS_REL, grad_norm_rel=TOL_DIST_LAGOM_GRAD_NORM_REL,
                 grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL),
        step_ms=rank["step_ms"], train_step_ms=train_step_ms,
        ratio_to_train_step=None if train_step_ms is None else rank["step_ms"] / train_step_ms,
        peak_gib=rank["peak_gib"], launches=rank["launches"], expected=expected, mesh=rank["mesh"],
        free_gib_before=free_before / 2**30, free_gib_after=free_after / 2**30,
        phase_s=phase_s, budget_s=DIST_LAGOM_BUDGET_S, card=card,
    )
    if not ok:
        raise SystemExit(f"dist.lagom failed: {[k for k, v in checks.items() if not v]}")
    return rank


def tp_local_kernels(torch, tp: int) -> dict:
    """The flash kernels at a tensor-parallel rank's head counts (Llama-3-8B's
    32 query and 8 KV heads over ``tp``) on the ``train`` shapes: each
    against its plain version (the ``kernels`` tolerances), its time beside
    its bound, the plain version's and SDPA's."""
    return local_flash_kernels(torch, B, S, H // tp, KH // tp, seed=tp)


def local_flash_kernels(torch, b: int, s: int, h: int, kh: int, seed: int) -> dict:
    """The flash kernels at one rank's local shape (``b`` rows of ``s``
    tokens, ``h`` query and ``kh`` KV heads, D=128, causal): each against
    its plain version (the ``kernels`` tolerances), its time beside its
    bound, the plain version's and SDPA's."""
    from maggy_tpu_torch.ops import flash

    B, S = b, s  # noqa: N806 - the module's shape names, at this rank's shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rand(B, S, h, D), rand(B, S, kh, D), rand(B, S, kh, D), rand(B, S, h, D)
    f32 = [t.float() for t in (q, k, v)]
    o, lse = flash.flash_fwd(q, k, v)
    o_ref, lse_ref = flash.flash_fwd_reference(*f32)
    bwd_in, bwd_ref_in = (q, k, v, o, do, lse), (*f32, o.float(), do.float(), lse)
    dq = flash.flash_bwd_dq(*bwd_in)
    dk, dv = flash.flash_bwd_dkv(*bwd_in)
    dq_ref = flash.flash_dq_reference(*bwd_ref_in)
    dk_ref, dv_ref = flash.flash_dkv_reference(*bwd_ref_in)
    torch.cuda.synchronize()
    err = dict(o_max_abs=float((o.float() - o_ref).abs().max()), o_rel_l2=rel_l2(o, o_ref),
               lse_max_abs=float((lse - lse_ref).abs().max()), dq_rel_l2=rel_l2(dq, dq_ref),
               dk_rel_l2=rel_l2(dk, dk_ref), dv_rel_l2=rel_l2(dv, dv_ref),
               dq_max_abs=float((dq.float() - dq_ref).abs().max()),
               dkv_max_abs=max(float((dk.float() - dk_ref).abs().max()), float((dv.float() - dv_ref).abs().max())))
    ok = (err["o_max_abs"] <= TOL_O_ABS and err["o_rel_l2"] <= TOL_O_REL_L2 and err["lse_max_abs"] <= TOL_LSE_ABS
          and all(err[f"{n}_rel_l2"] <= TOL_GRAD_REL_L2 for n in ("dq", "dk", "dv")))
    del dq_ref, dk_ref, dv_ref, o_ref, lse_ref
    ms = {"flash_fwd": time_ms(torch, lambda: flash.flash_fwd(q, k, v)),
          "flash_bwd_dq": time_ms(torch, lambda: flash.flash_bwd_dq(*bwd_in)),
          "flash_bwd_dkv": time_ms(torch, lambda: flash.flash_bwd_dkv(*bwd_in))}
    plain_ms = {"flash_fwd": time_ms(torch, lambda: flash.flash_fwd_reference(*f32)),
                "flash_bwd_dq": time_ms(torch, lambda: flash.flash_dq_reference(*bwd_ref_in)),
                "flash_bwd_dkv": time_ms(torch, lambda: flash.flash_dkv_reference(*bwd_ref_in))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_fwd_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
    sdpa_bwd_ms = time_sdpa_bwd(torch, qg, kg, vg, do.transpose(1, 2), is_causal=True)
    pairs = B * S * (S + 1) // 2
    q_bytes, kv_bytes, lse_bytes = B * S * h * D * 2, B * S * kh * D * 2, B * h * S * 4
    work = {"flash_fwd": (4 * D * pairs * h, q_bytes + 2 * kv_bytes + q_bytes + lse_bytes),
            "flash_bwd_dq": (6 * D * pairs * h, 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes),
            "flash_bwd_dkv": (8 * D * pairs * h, 3 * q_bytes + 2 * kv_bytes + lse_bytes + 2 * kv_bytes)}
    max_err = {"flash_fwd": err["o_max_abs"], "flash_bwd_dq": err["dq_max_abs"], "flash_bwd_dkv": err["dkv_max_abs"]}
    rows = {name: kernel_row(name, ms[name], plain_ms[name], work[name], max_err[name],
                             sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms) for name in ms}
    for row in rows.values():
        row.pop("ptxas")
    torch.cuda.empty_cache()
    return dict(ok=ok, heads=h, kv_heads=kh, err=err, rows=rows)


def _mesh_rank(rank: int, n: int, port: int, specs, n_layers: int, seq: int, steps: int, out) -> None:
    """One rank of ``dist.mesh``: its own card, NCCL, then each spec's
    steps in turn. Puts (rank, results) or (rank, "error", traceback)."""
    import gc
    import traceback

    import torch
    import torch.distributed as dist

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        sys.path.insert(0, REPO)
        from maggy_tpu_torch.models import Decoder, DecoderConfig
        from maggy_tpu_torch.parallel import ShardingSpec
        from maggy_tpu_torch.train import TrainContext

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
        results = {}
        for key, kw in specs:
            ctx = TrainContext.create(ShardingSpec(**kw))
            model = Decoder(DecoderConfig.llama3_8b(n_layers=n_layers), device="meta")
            results[key] = mesh_steps(ctx, model, steps, seq)
            del ctx, model
            gc.collect()
            torch.cuda.empty_cache()
        out.put((rank, results))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_dist_mesh(torch, n_layers: int, seq: int, steps: int, card: str, single: dict) -> dict:
    """The mesh across cards, each rank against dist.lagom's single rank;
    and, on any number of cards, the flash kernels at the tp-local head
    counts. Returns rank 0's flash launches, summed over the specs."""
    import multiprocessing
    import socket

    t0 = time.perf_counter()
    tp_local = {f"tp{tp}": tp_local_kernels(torch, tp) for tp in (2, 4)}
    kernels_ok = all(r["ok"] for r in tp_local.values())
    cards = torch.cuda.device_count()
    common = dict(tp_local_kernels=tp_local, card=card)
    if not kernels_ok:
        emit("dist.mesh", ok=False, ran=False, cards=cards, **common)
        raise SystemExit("dist.mesh failed: a flash kernel at tp-local heads disagrees with its plain version")
    if cards < 2:
        emit("dist.mesh", ok=True, ran=False, cards=cards, **common)
        return {}
    groups = [(2, [("dp2", dict(dp=2)), ("fsdp2", dict(fsdp=2)), ("tp2", dict(tp=2))])]
    if cards >= 4:
        groups.append((4, [("2d", dict(fsdp=2, tp=2))]))  # ShardingSpec.preset("2d", 4)
    mp = multiprocessing.get_context("spawn")
    ranks, launches = [], {}
    for n, specs in groups:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        out = mp.Queue()
        procs = [mp.Process(target=_mesh_rank, args=(r, n, port, specs, n_layers, seq, steps, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            left = max(1.0, DIST_MESH_BUDGET_S - (time.perf_counter() - t0))
            results = sorted((out.get(timeout=left) for _ in range(n)), key=lambda r: r[0])
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r in results if r[1] == "error"]
        if failed:
            raise SystemExit(f"dist.mesh: rank {failed[0][0]} failed:\n{failed[0][2]}")
        for rank, per_spec in results:
            for key, res in per_spec.items():
                ranks.append(dict(spec=key, rank=rank, res=res))
                if rank == 0:
                    for name, count in res["launches"].items():
                        launches[name] = launches.get(name, 0) + count
    expected = {k: (1 + steps) * v for k, v in flash_launches_per_step(n_layers).items()}
    rows = []
    for r in ranks:
        res = r["res"]
        loss_rel = max(_rel(g, w) for g, w in zip(res["losses"], single["losses"]))
        norm_rel = max(_rel(res["first_grad_norm"], single["first_grad_norm"]),
                       _rel(res["last_grad_norm"], single["last_grad_norm"]))
        group_rel = {k: _rel(v, single["group_grad_norms"][k]) for k, v in res["group_grad_norms"].items()}
        rows.append(dict(spec=r["spec"], rank=r["rank"], mesh=res["mesh"], losses=res["losses"],
                         loss_rel=loss_rel, grad_norm_rel=norm_rel, group_grad_norm_rel=group_rel,
                         grad_norm_count_rel=res["grad_norm_count_rel"], step_ms=res["step_ms"],
                         ratio_to_single=res["step_ms"] / single["step_ms"], peak_gib=res["peak_gib"],
                         launches_ok=res["launches"] == expected,
                         ok=loss_rel <= TOL_MESH_LOSS_REL and norm_rel <= TOL_MESH_GRAD_NORM_REL
                         and set(group_rel) == set(single["group_grad_norms"])
                         and max(group_rel.values()) <= TOL_MESH_GROUP_NORM_REL
                         and res["grad_norm_count_rel"] <= TOL_GRAD_NORM_COUNT_REL
                         and res["launches"] == expected and len(res["losses"]) == steps + 1
                         and res["params_on_card"]))
    phase_s = time.perf_counter() - t0
    ok = all(r["ok"] for r in rows) and phase_s <= DIST_MESH_BUDGET_S
    emit("dist.mesh", ok=ok, ran=True, cards=cards, ranks=rows, expected_launches=expected,
         tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL,
                  group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL, grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL),
         phase_s=phase_s, budget_s=DIST_MESH_BUDGET_S, **common)
    if not ok:
        raise SystemExit("dist.mesh failed: a rank's losses, grad norms (whole, by group, or as its trainer "
                         "counts them) or launches disagree with dist.lagom's single rank, or the phase ran past "
                         "its budget")
    return launches


def _spec_rank(rank: int, n: int, port: int, specs, n_layers: int, seq: int, steps: int, out) -> None:
    """One rank of ``dist.seq`` or ``dist.zero``: its own card, NCCL, then
    each spec's steps in turn. ``specs`` holds ``(key, ShardingSpec
    fields, attention, trainer keywords)``; the attention is ``"ring"``
    (over the mesh's ``seq`` axis), ``"ulysses"`` or None (the flash
    kernels). Puts (rank, results) or (rank, "error", traceback)."""
    import gc
    import traceback

    import torch
    import torch.distributed as dist

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        sys.path.insert(0, REPO)
        from maggy_tpu_torch.models import Decoder, DecoderConfig
        from maggy_tpu_torch.parallel import ShardingSpec, make_ring_attention, make_ulysses_attention
        from maggy_tpu_torch.train import TrainContext

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
        results = {}
        for key, kw, attention, trainer_kw in specs:
            t0 = time.perf_counter()
            ctx = TrainContext.create(ShardingSpec(**kw))
            attn = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}.get(attention)
            cfg = DecoderConfig.llama3_8b(n_layers=n_layers, attention_fn=None if attn is None else attn(ctx.mesh))
            results[key] = mesh_steps(ctx, Decoder(cfg, device="meta"), steps, seq, **trainer_kw)
            results[key]["spec_s"] = time.perf_counter() - t0
            del ctx
            gc.collect()
            torch.cuda.empty_cache()
        out.put((rank, results))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_spec_groups(phase: str, groups, n_layers: int, seq: int, steps: int, t0: float, budget_s: float):
    """Each ``(n, specs)`` of ``groups`` as n spawned NCCL ranks
    (:func:`_spec_rank`), every wait inside the phase's budget; a failed
    rank fails the phase. Returns ``[(spec key, rank, result)]``."""
    import multiprocessing
    import socket

    mp = multiprocessing.get_context("spawn")
    rows = []
    for n, specs in groups:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        out = mp.Queue()
        procs = [mp.Process(target=_spec_rank, args=(r, n, port, specs, n_layers, seq, steps, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            left = max(1.0, budget_s - (time.perf_counter() - t0))
            results = sorted((out.get(timeout=left) for _ in range(n)), key=lambda r: r[0])
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r in results if r[1] == "error"]
        if failed:
            raise SystemExit(f"{phase}: rank {failed[0][0]} failed:\n{failed[0][2]}")
        rows += [(key, rank, res) for rank, per_spec in results for key, res in per_spec.items()]
        print(f"chip_smoke: {phase} group of {n} ranks done at {time.perf_counter() - t0:.1f} s of the phase",
              file=sys.stderr, flush=True)
    return rows


def held_to_single(res: dict, single: dict) -> dict:
    """A mesh rank's figures against dist.lagom's single rank, under
    dist.mesh's limits."""
    loss_rel = max(_rel(g, w) for g, w in zip(res["losses"], single["losses"]))
    norm_rel = max(_rel(res["first_grad_norm"], single["first_grad_norm"]),
                   _rel(res["last_grad_norm"], single["last_grad_norm"]))
    group_rel = {k: _rel(v, single["group_grad_norms"][k]) for k, v in res["group_grad_norms"].items()}
    ok = (loss_rel <= TOL_MESH_LOSS_REL and norm_rel <= TOL_MESH_GRAD_NORM_REL
          and set(group_rel) == set(single["group_grad_norms"])
          and max(group_rel.values()) <= TOL_MESH_GROUP_NORM_REL
          and res["grad_norm_count_rel"] <= TOL_GRAD_NORM_COUNT_REL
          and len(res["losses"]) == len(single["losses"]) and res["params_on_card"])
    return dict(ok=ok, loss_rel=loss_rel, grad_norm_rel=norm_rel, group_grad_norm_rel=group_rel,
                grad_norm_count_rel=res["grad_norm_count_rel"], spec_s=res["spec_s"], step_ms=res["step_ms"],
                ratio_to_single=res["step_ms"] / single["step_ms"], peak_gib=res["peak_gib"], mesh=res["mesh"])


def ring_launches_per_step(n_layers: int, seq_rank: int) -> dict:
    """What one train step launches on the rank holding chunk ``seq_rank``
    of a causal ring: that many past chunks and its diagonal, the forward
    again under remat."""
    visits = seq_rank + 1
    return {"ring_fwd": 2 * n_layers * visits, "ring_bwd_dq": n_layers * visits, "ring_bwd_dkv": n_layers * visits}


def phase_dist_seq(torch, n_layers: int, seq: int, steps: int, card: str, single: dict) -> dict:
    """The seq axis inside the mesh, each rank against dist.lagom's single
    rank; and, on any number of cards, the flash kernels at Ulysses' local
    shape of ``ring.train``. Returns rank 0's launches, summed over the
    specs."""
    t0 = time.perf_counter()
    sp = RING_N
    local = local_flash_kernels(torch, RING_B, RING_S, H // sp, KH // sp, seed=sp)
    cards = torch.cuda.device_count()
    common = dict(ulysses_local_kernels=dict(shape=dict(b=RING_B, s=RING_S, sp=sp), **local),
                  kernels_s=time.perf_counter() - t0, card=card)
    if not local["ok"]:
        emit("dist.seq", ok=False, ran=False, cards=cards, **common)
        raise SystemExit("dist.seq failed: a flash kernel at Ulysses' local shape disagrees with its plain version")
    if cards < 4:
        emit("dist.seq", ok=True, ran=False, cards=cards, **common)
        return {}
    specs = [("ring_sp2_fsdp2", dict(sp=2, fsdp=2), "ring", {}),
             ("ring_sp2_tp2", dict(sp=2, tp=2), "ring", {}),
             ("ulysses_sp4", dict(sp=4), "ulysses", {}),
             ("ulysses_sp2_dp2", dict(sp=2, dp=2), "ulysses", {})]
    flash_step = flash_launches_per_step(n_layers)
    rows, launches = [], {}
    for key, rank, res in run_spec_groups("dist.seq", [(4, specs)], n_layers, seq, steps, t0, DIST_SEQ_BUDGET_S):
        ring = key.startswith("ring")
        want_flash = {k: 0 if ring else (1 + steps) * v for k, v in flash_step.items()}
        want_ring = {k: (1 + steps) * v if ring else 0
                     for k, v in ring_launches_per_step(n_layers, res["seq_rank"]).items()}
        row = held_to_single(res, single)
        row.update(spec=key, rank=rank, seq_rank=res["seq_rank"], launches={**res["launches"], **res["ring_launches"]},
                   expected_launches={**want_flash, **want_ring})
        row["ok"] = row["ok"] and res["launches"] == want_flash and res["ring_launches"] == want_ring
        rows.append(row)
        if rank == 0:
            for name, count in row["launches"].items():
                launches[name] = launches.get(name, 0) + count
    phase_s = time.perf_counter() - t0
    ok = all(r["ok"] for r in rows) and phase_s <= DIST_SEQ_BUDGET_S
    emit("dist.seq", ok=ok, ran=True, cards=cards, ranks=rows,
         tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL,
                  group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL, grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL),
         phase_s=phase_s, budget_s=DIST_SEQ_BUDGET_S, **common)
    if not ok:
        raise SystemExit("dist.seq failed: a rank's losses, grad norms (whole, by group, or as its trainer counts "
                         "them) or ring and flash launches disagree with dist.lagom's single rank, or the phase ran "
                         "past its budget")
    return launches


def phase_dist_zero(torch, n_layers: int, seq: int, steps: int, card: str, single: dict) -> dict:
    """ZeRO-1 and bucketed reduction over ``data``, each rank against
    dist.lagom's single rank, the optimizer's bytes a rank against the dense
    layout's. Returns rank 0's flash launches, summed over the modes."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("dist.zero", ok=True, ran=False, cards=cards, card=card)
        return {}
    groups = [(2, [("dense_dp2", dict(dp=2), None, {}),
                   ("bucket_dp2", dict(dp=2), None, dict(bucket_mb=ZERO_BUCKET_MB)),
                   ("zero_dp2", dict(dp=2), None, dict(zero_stage=1, bucket_mb=ZERO_BUCKET_MB))])]
    if cards >= 4:
        # B=2 rows over 4 data ranks: each batch's rows twice, a row a rank
        groups.append((4, [("zero_dp4", dict(dp=4), None,
                            dict(zero_stage=1, bucket_mb=ZERO_BUCKET_MB, rows_repeat=2))]))
    results = run_spec_groups("dist.zero", groups, n_layers, seq, steps, t0, DIST_ZERO_BUDGET_S)
    dense = {rank: res for key, rank, res in results if key == "dense_dp2"}
    dense_step = statistics.mean(r["step_ms"] for r in dense.values())
    dense_peak = max(r["peak_gib"] for r in dense.values())
    dense_bytes = dense[0]["opt_bytes"]
    expected = {k: (1 + steps) * v for k, v in flash_launches_per_step(n_layers).items()}
    rows, launches = [], {}
    for key, rank, res in results:
        dp = res["mesh"]["data"]
        want_mode = key.split("_")[0].replace("dense", "off")
        row = held_to_single(res, single)
        bytes_limit = dense_bytes / dp * (1 + ZERO_BYTES_MARGIN) if want_mode == "zero" else None
        row.update(spec=key, rank=rank, mode=res["mode"], state_gib=res["state_gib"], opt_bytes=res["opt_bytes"],
                   opt_bytes_limit=bytes_limit,
                   step_ms_over_dense_dp2=res["step_ms"] / dense_step, launches=res["launches"])
        row["ok"] = (row["ok"] and res["mode"] == want_mode and res["launches"] == expected
                     and (bytes_limit is None or res["opt_bytes"] <= bytes_limit))
        rows.append(row)
        if rank == 0:
            for name, count in res["launches"].items():
                launches[name] = launches.get(name, 0) + count
    phase_s = time.perf_counter() - t0
    ok = all(r["ok"] for r in rows) and phase_s <= DIST_ZERO_BUDGET_S
    emit("dist.zero", ok=ok, ran=True, cards=cards, ranks=rows, dense_dp2_step_ms=dense_step,
         dense_dp2_peak_gib=dense_peak, dense_opt_bytes=dense_bytes, bucket_mb=ZERO_BUCKET_MB,
         expected_launches=expected,
         tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL,
                  group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL, grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL,
                  opt_bytes_margin=ZERO_BYTES_MARGIN),
         phase_s=phase_s, budget_s=DIST_ZERO_BUDGET_S, card=card)
    if not ok:
        raise SystemExit("dist.zero failed: a rank's losses, grad norms, mode, launches or optimizer bytes disagree "
                         "with dist.lagom's single rank and the dense layout, or the phase ran past its budget")
    return launches


def pipe_launches_per_step(n_layers: int, pp: int, stage: int, n_micro: int) -> dict:
    """What one pipelined train step launches on ``stage``: its layers for
    each microbatch, the forward twice (the forward tick and the
    recompute at the backward tick) on every stage but the last."""
    per = n_layers // pp * n_micro
    return {"flash_fwd": per * (1 if stage == pp - 1 else 2), "flash_bwd_dq": per, "flash_bwd_dkv": per}


def pipe_single_stage(torch, cfg, seq: int, steps: int, train_ref: dict) -> dict:
    """The single-stage path of ``pipeline_grads_1f1b`` on the ``train``
    configuration: the ``train`` phase's weights (seed 0) and batches, each
    step over PIPE_SINGLE_MICRO microbatches that are each the ``train``
    batch, AdamW as ``train``'s. Its losses and grad norms against
    ``train``'s, its launches, its step."""
    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.parallel.pipeline import pipeline_grads_1f1b
    from maggy_tpu_torch.train import adamw, lm_loss_fn, synthetic_lm_batches
    from maggy_tpu_torch.train.pipeline_adapter import decoder_pipeline_parts

    parts = decoder_pipeline_parts(Decoder(cfg, device="meta"), 1)
    stage = parts.make_stage(0, "cuda")
    stage.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(1e-4)(stage.parameters())
    data = synthetic_lm_batches(cfg.vocab_size, B, seq, seed=0)
    next(data)  # the sample batch the `train` phase's make_state takes
    m = PIPE_SINGLE_MICRO

    def loss_fn(st, y, tgt):
        return lm_loss_fn(parts.head_fn(st, y), tgt)

    losses, norms, stats = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_steps = None
    for i in range(1 + steps):
        if i == 1:  # the warm-up step's launches and time stay out
            torch.cuda.synchronize()
            flash.reset_launches()
            t_steps = time.perf_counter()
        tokens = torch.as_tensor(next(data)["tokens"]).cuda().repeat(m, 1).view(m, B, seq)
        opt.zero_grad(set_to_none=True)
        loss, grads = pipeline_grads_1f1b(parts.stage_fn, loss_fn, stage, tokens, {"tokens": tokens},
                                          first_fn=parts.first_fn, stage_takes_raw=True, stats=stats)
        norms.append(float(torch.nn.utils.get_total_norm(list(grads.values()))))
        opt.step()
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_steps) * 1e3 / steps
    launches = dict(flash.LAUNCHES)
    expected = {k: steps * v for k, v in pipe_launches_per_step(cfg.n_layers, 1, 0, m).items()}
    loss_rel = [_rel(g, w) for g, w in zip(losses, train_ref["losses"])]
    norm_rel = dict(first=_rel(norms[0], train_ref["first_grad_norm"]),
                    last=_rel(norms[-1], train_ref["last_grad_norm"]))
    ok = (len(loss_rel) == steps + 1 and max(loss_rel) <= TOL_DIST_LAGOM_LOSS_REL
          and max(norm_rel.values()) <= TOL_DIST_LAGOM_GRAD_NORM_REL and launches == expected
          and all(math.isfinite(v) for v in losses))
    out = dict(ok=ok, microbatches=m, losses=losses, loss_rel=loss_rel, grad_norm_rel=norm_rel, launches=launches,
               expected_launches=expected, step_ms=step_ms, stats=stats,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del stage, opt, grads
    return out


def phase_dist_pipe(torch, cfg, seq: int, steps: int, card: str, train_ref: dict, single: dict,
                    train_step_ms) -> dict:
    """Pipeline parallelism: the single-stage 1F1B path against ``train`` on
    any card count, then the stages across cards against dist.lagom's
    single rank. Returns the single-stage part's launches plus rank 0's of
    every spec."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    one = pipe_single_stage(torch, cfg, seq, steps, train_ref)
    gc.collect()
    torch.cuda.empty_cache()
    one["step_ms_over_m_train_steps"] = None if train_step_ms is None else one["step_ms"] / (
        PIPE_SINGLE_MICRO * train_step_ms)
    cards = torch.cuda.device_count()
    launches = dict(one["launches"])
    common = dict(single_stage=one, tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL,
                                             group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL,
                                             grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL,
                                             single_stage_loss_rel=TOL_DIST_LAGOM_LOSS_REL,
                                             single_stage_grad_norm_rel=TOL_DIST_LAGOM_GRAD_NORM_REL), card=card)
    if not one["ok"]:
        emit("dist.pipe", ok=False, ran=False, cards=cards, phase_s=time.perf_counter() - t0, **common)
        raise SystemExit("dist.pipe failed: the single-stage 1F1B path's losses, grad norms or launches disagree "
                         "with the train phase's")
    if cards < 2:
        emit("dist.pipe", ok=True, ran=False, cards=cards, phase_s=time.perf_counter() - t0, **common)
        return launches

    def spec(key, pp, **kw):
        n_micro = 2 * pp
        rows = n_micro * kw.get("dp", 1)  # each microbatch on each data rank: the B train rows
        return (key, dict(pp=pp, **kw), None, dict(n_microbatches=n_micro, rows_repeat=rows))

    groups = [(4, [spec("pp4", 4), spec("pp2_dp2", 2, dp=2), spec("pp2_tp2", 2, tp=2)])] if cards >= 4 else [
        (2, [spec("pp2", 2)])]
    rows_out = []
    for key, rank, res in run_spec_groups("dist.pipe", groups, cfg.n_layers, seq, steps, t0, DIST_PIPE_BUDGET_S):
        pp = res["mesh"]["stage"]
        m = res["n_micro"]
        want = {k: (1 + steps) * v for k, v in pipe_launches_per_step(cfg.n_layers, pp, res["stage"], m).items()}
        row = held_to_single(res, single)
        row.update(spec=key, rank=rank, stage=res["stage"], microbatches=m, launches=res["launches"],
                   expected_launches=want, bubble=(pp - 1) / (m + pp - 1),
                   step_ms_over_m_single_steps=res["step_ms"] / (m * single["step_ms"]),
                   state_gib=res["state_gib"])
        row["ok"] = row["ok"] and res["launches"] == want
        rows_out.append(row)
        if rank == 0:
            for name, count in res["launches"].items():
                launches[name] = launches.get(name, 0) + count
    phase_s = time.perf_counter() - t0
    ok = all(r["ok"] for r in rows_out) and phase_s <= DIST_PIPE_BUDGET_S
    emit("dist.pipe", ok=ok, ran=True, cards=cards, ranks=rows_out, phase_s=phase_s, budget_s=DIST_PIPE_BUDGET_S,
         **common)
    if not ok:
        raise SystemExit("dist.pipe failed: a rank's losses, grad norms (whole, by group, or as its trainer counts "
                         "them) or launches disagree with dist.lagom's single rank, or the phase ran past its budget")
    return launches


def run_launcher(flags, script: str, timeout_s: float, env_extra=None):
    """``python -m maggy_tpu_torch.run [flags] script`` as its own process
    group: every process it starts is killed with it past ``timeout_s``, and
    any left behind once it exits. Returns its exit code, stdout and
    stderr."""
    import signal

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **(env_extra or {}))
    proc = subprocess.Popen([sys.executable, "-m", "maggy_tpu_torch.run", *flags, script], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate(timeout=30)
        err += f"\n(chip_smoke: the launcher was killed after {timeout_s} s)"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, out, err


def _dump_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def pod_elastic_train(model, hparams, reporter, ctx):
    """pod.elastic's train_fn, run by every rank of every generation in its
    own process: the ``train`` steps from seed 0 (batch ``i + 1`` at step
    ``i``), resumed from the latest checkpoint, a synchronous save after
    step ``save_at``; rank 1 of generation 0 SIGKILLs itself after step
    ``kill_at``, once the checkpoint is committed. There is one
    checkpoint: rank 0's, under a process group, as every mesh checkpoint
    is; of two replicas (one-rank groups) rank 0 writes it and both resume
    from it, since they hold the same state. After every step the rank
    writes its losses, flash launches and times to
    ``<out>/g<generation>.r<rank>.json``, with its start-up timeline
    (seconds from the script's first line)."""
    import signal

    import torch

    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Checkpointer, adamw, synthetic_lm_batches

    gen, rank = int(os.environ["MAGGY_TPU_GENERATION"]), int(os.environ["MAGGY_TPU_PARTITION"])
    cuda = ctx.device.type == "cuda"  # the CPU only in a rehearsal
    t0 = float(os.environ["MT_POD_T0"])
    path = os.path.join(hparams["out"], f"g{gen}.r{rank}.json")
    rec = dict(gen=gen, rank=rank, device=str(ctx.device), world=ctx.num_processes, losses={}, launches={},
               timeline=dict(imported=float(os.environ["MT_POD_T_IMPORTED"]) - t0, train_fn=time.time() - t0))
    trainer = ctx.trainer(model, adamw(1e-4))
    data = synthetic_lm_batches(model.cfg.vocab_size, B, hparams["seq"], seed=0)
    batches = [next(data) for _ in range(hparams["steps"] + 1)]
    state = trainer.make_state(0, batches[0])
    if cuda:
        torch.cuda.synchronize()
    rec["timeline"]["state"] = time.time() - t0
    saves = ctx.num_processes > 1 or rank == 0  # a mesh's save is every rank's call
    ckpt = Checkpointer(hparams["ckpt"], max_to_keep=1, async_save=False)
    start = ckpt.latest_step() or 0
    if start:
        t = time.perf_counter()
        state = ckpt.restore(state, step=start, expect_meta=trainer.checkpoint_meta())
        if cuda:
            torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t
    rec["start"] = start
    flash.reset_launches()
    for i in range(start, hparams["steps"]):
        state, m = trainer.step(state, trainer.shard_batch(batches[i + 1]))
        rec["losses"][str(i + 1)] = float(m["loss"])
        rec["launches"][str(i + 1)] = dict(flash.LAUNCHES)
        if "first_step_s" not in rec:
            rec["first_step_at"] = time.time()
            rec["first_step_s"] = rec["timeline"]["first_step"] = rec["first_step_at"] - t0
        if i + 1 == hparams["save_at"] and saves:
            t = time.perf_counter()
            ckpt.save(i + 1, state, meta=trainer.checkpoint_meta())
            ckpt.wait()
            rec["save_s"] = time.perf_counter() - t
        _dump_json(path, rec)
        if gen == 0 and rank == 1 and i + 1 == hparams["kill_at"]:
            deadline = time.time() + 60
            while not os.path.isdir(os.path.join(hparams["ckpt"], str(hparams["save_at"]))) and time.time() < deadline:
                time.sleep(0.05)
            rec["killed_at"] = time.time()
            _dump_json(path, rec)
            os.kill(os.getpid(), signal.SIGKILL)
    ckpt.close()
    rec.update(end_step=int(state.step), grad_norm=float(m["grad_norm"]),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
    rec["timeline"]["returned"] = time.time() - t0
    _dump_json(path, rec)
    return {"metric": rec["losses"][str(hparams["steps"])], "end_step": float(state.step)}


def pod_hpo_train(hparams, reporter, devices, trial_dir):
    """pod.hpo's train_fn: a Decoder of POD_LAYERS layers at ``train``'s
    widths on the trial's lease, POD_HPO_STEPS steps. The driver's executor
    holds its first trial until the worker holds one; the first worker's
    first trial SIGKILLs its process after one step. Each trial writes
    ``start``, ``killed`` and ``done`` records under ``<out>``."""
    import gc
    import signal

    import torch

    from maggy_tpu_torch.models import Decoder, DecoderConfig
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    out, role = hparams["out"], os.environ.get("MAGGY_TPU_ROLE")
    cuda = devices[0].type == "cuda"  # the CPU only in a rehearsal
    marker = os.path.join(out, "worker_holds_a_trial")
    tid = os.path.basename(trial_dir.rstrip("/"))
    name = f"{tid}.{role}.{os.getpid()}"
    rec = dict(trial=tid, role=role, pid=os.getpid(), device=str(devices[0]), lr=hparams["lr"])
    kill = role == "worker" and not os.path.exists(marker)
    _dump_json(os.path.join(out, f"start.{name}.json"), rec)
    if role == "worker":
        open(marker, "a").close()
    else:
        deadline = time.time() + 60
        while not os.path.exists(marker) and time.time() < deadline:
            time.sleep(0.05)
    preset, kw = hparams["model"]
    cfg = getattr(DecoderConfig, preset)(**kw)
    if cuda:
        torch.cuda.reset_peak_memory_stats(devices[0])
    trainer = Trainer(Decoder(cfg, device="meta"), adamw(hparams["lr"]), device=devices[0])
    data = synthetic_lm_batches(cfg.vocab_size, B, hparams["seq"], seed=0)
    state = trainer.make_state(0, next(data))
    flash.reset_launches()
    losses, step_ms = [], []
    for i in range(POD_HPO_STEPS):
        t = time.perf_counter()
        state, m = trainer.step(state, next(data))
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        reporter.broadcast(losses[-1], step=i)
        if kill:
            _dump_json(os.path.join(out, f"killed.{name}.json"), dict(rec, losses=losses))
            os.kill(os.getpid(), signal.SIGKILL)
    rec.update(losses=losses, step_ms=step_ms, launches=dict(flash.LAUNCHES),
               peak_gib=torch.cuda.max_memory_allocated(devices[0]) / 2**30 if cuda else None)
    del state, trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()  # the other process shares the card
    _dump_json(os.path.join(out, f"done.{name}.json"), rec)
    return {"metric": losses[-1]}


POD_ELASTIC_SCRIPT = """
import os, time
os.environ["MT_POD_T0"] = repr(time.time())
import json, sys
sys.path.insert(0, {repo!r})
import torch
import maggy_tpu_torch
if {global_mesh}:
    assert maggy_tpu_torch.initialize_data_plane(device={device!r}), "the launcher exports MAGGY_TPU_COORDINATOR"
import chip_smoke
from maggy_tpu_torch import experiment
from maggy_tpu_torch.config import DistributedConfig
from maggy_tpu_torch.models import Decoder, DecoderConfig
os.environ["MT_POD_T_IMPORTED"] = repr(time.time())

result = experiment.lagom(chip_smoke.pod_elastic_train, DistributedConfig(
    module=Decoder(DecoderConfig.{preset}(**{model_kw!r}), device="meta"), hparams={hparams!r},
    sharding="dp", data_plane={plane!r}, hb_interval={hb}, worker_timeout={timeout}, device={device!r}))
if result.get("role") is None:
    with open(os.path.join({out!r}, "result.json"), "w") as f:
        json.dump(result, f)
chip_smoke._dump_json(os.path.join({out!r}, "lagom_returned.g" + os.environ["MAGGY_TPU_GENERATION"] + ".r"
                                   + os.environ["MAGGY_TPU_PARTITION"] + ".json"),
                      dict(gen=os.environ["MAGGY_TPU_GENERATION"], rank=os.environ["MAGGY_TPU_PARTITION"],
                           t0=float(os.environ["MT_POD_T0"]), at=time.time()))
"""

POD_HPO_SCRIPT = """
import os, time
os.environ["MT_POD_T0"] = repr(time.time())
import json, sys
sys.path.insert(0, {repo!r})
import torch
import chip_smoke
from maggy_tpu_torch import Searchspace, experiment
from maggy_tpu_torch.config import HyperparameterOptConfig

config = HyperparameterOptConfig(
    num_trials={trials}, optimizer="randomsearch", searchspace=Searchspace(lr=("DOUBLE", [1e-5, 1e-4])),
    direction="min", es_policy="none", seed=0, num_executors=2, hb_interval={hb}, worker_timeout={timeout},
    device={device!r})
config.hparams = {hparams!r}
result = experiment.lagom(chip_smoke.pod_hpo_train, config)
if result.get("role") is None:
    with open(os.path.join({out!r}, "result.json"), "w") as f:
        json.dump(result, f)
"""


def _pod_records(out: str, prefix: str = "") -> list:
    recs = []
    for name in sorted(os.listdir(out)):
        if name.startswith(prefix) and name.endswith(".json") and name != "result.json":
            with open(os.path.join(out, name)) as f:
                recs.append(json.load(f))
    return recs


def _pod_root(torch, phase: str, n_checkpoints: int, cfg):
    """A temporary root for a pod phase, after this process frees its
    cached card memory; fails when the disk cannot hold the checkpoints."""
    import gc
    import shutil
    import tempfile

    from maggy_tpu_torch.models import Decoder

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix=phase.replace(".", "_") + "_")
    n_params = sum(p.numel() for p in Decoder(cfg, device="meta").parameters())
    need = n_checkpoints * 12 * n_params
    free = shutil.disk_usage(root).free
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        raise SystemExit(f"{phase}: {free / 1e9:.1f} GB free under {root}, the phase needs {need / 1e9:.1f} GB")
    os.makedirs(os.path.join(root, "out"))
    return root, n_params


def pod_reference_losses(torch, cfg, seq: int, steps: int) -> list:
    """One process's losses for pod.elastic's steps (no mesh): what the ranks
    of a process group are held to."""
    import gc

    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-4), device="cuda:0")
    data = synthetic_lm_batches(cfg.vocab_size, B, seq, seed=0)
    state = trainer.make_state(0, next(data))
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, next(data))
        losses.append(float(m["loss"]))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def phase_pod_elastic(torch, card: str, model=("llama3_8b", dict(n_layers=POD_LAYERS)), device=None,
                      seq: int = S) -> dict:
    """pod.elastic: ``python -m maggy_tpu_torch.run --workers 2 --elastic 1``
    over a script whose ``lagom(train_fn, DistributedConfig(sharding="dp"))``
    trains the ``train`` widths at depth POD_LAYERS in both processes. One
    card: ``data_plane="local"``, two replicas on ``cuda:0`` from one seed.
    Two or more: ``--global-mesh``, ``data_plane="auto"``, dp=2 over NCCL,
    rank r on card r. One checkpoint, rank 0's, which every rank of the
    next generation restores. Rank 1 of generation 0 SIGKILLs itself after step
    POD_KILL_AT; the launcher restarts the generation, which resumes from
    the step-POD_SAVE_AT checkpoint. Returns the ranks' flash launches.
    ``model`` (a DecoderConfig preset and its arguments) and
    ``device="cpu"`` rehearse the phase on the CPU at a tiny size, where
    every check but the launches, the devices and the budget can pass."""
    import shutil

    from maggy_tpu_torch.models import DecoderConfig

    cfg = getattr(DecoderConfig, model[0])(**model[1])
    global_mesh = torch.cuda.device_count() >= 2
    reference = pod_reference_losses(torch, cfg, seq, POD_STEPS) if global_mesh else None
    root, n_params = _pod_root(torch, "pod.elastic", 1, cfg)
    out = os.path.join(root, "out")
    hparams = dict(out=out, ckpt=os.path.join(root, "ckpt"), seq=seq, steps=POD_STEPS, save_at=POD_SAVE_AT,
                   kill_at=POD_KILL_AT)
    script = os.path.join(root, "pod_elastic_script.py")
    with open(script, "w") as f:
        f.write(POD_ELASTIC_SCRIPT.format(repo=REPO, global_mesh=global_mesh, preset=model[0], model_kw=model[1],
                                          hparams=hparams, plane="auto" if global_mesh else "local", hb=LAGOM_HB,
                                          timeout=POD_ELASTIC_BUDGET_S, out=out, device=device))
    flags = ["--workers", "2", "--elastic", "1"] + (["--global-mesh"] if global_mesh else [])
    t0, wall0 = time.perf_counter(), time.time()
    try:
        rc, stdout, stderr = run_launcher(flags, script, POD_ELASTIC_BUDGET_S + 60,
                                          dict(MAGGY_TPU_LOG_ROOT=os.path.join(root, "logs")))
        phase_s = time.perf_counter() - t0
        recs = {(r["gen"], r["rank"]): r for r in _pod_records(out, "g")}
        # when each process started and its lagom returned, from the launch
        ends = {f"g{r['gen']}.r{r['rank']}": (r["t0"] - wall0, r["at"] - wall0)
                for r in _pod_records(out, "lagom_returned")}
        result = json.load(open(os.path.join(out, "result.json"))) if os.path.exists(os.path.join(out,
                                                                                                  "result.json")) else {}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    per_step = flash_launches_per_step(POD_LAYERS)
    g0 = [recs.get((0, r), {}) for r in (0, 1)]
    g1 = [recs.get((1, r), {}) for r in (0, 1)]
    kill = str(POD_KILL_AT)

    def launches_exact(rec):
        return bool(rec.get("launches")) and all(
            n == {k: (int(step) - rec["start"]) * v for k, v in per_step.items()}
            for step, n in rec["launches"].items())

    losses = [v for rec in g0 + g1 for v in rec.get("losses", {}).values()]
    checks = {
        "launcher_exit_0": rc == 0,
        "generation_restarted": "restarting generation 0 -> 1" in stderr
        and "restarting generation 1 -> 2" not in stderr,
        "rank1_killed_after_step": "killed_at" in g0[1] and kill in g0[1].get("losses", {}),
        "gen1_starts_at_checkpoint": all(rec.get("start") == POD_SAVE_AT for rec in g1),
        "both_end_at_last_step": all(rec.get("end_step") == POD_STEPS for rec in g1)
        and result.get("num_workers") == 2 and result.get("end_step") == POD_STEPS,
        "recomputed_step_bit_equal": all(g1[r].get("losses", {}).get(kill) == g0[r]["losses"][kill]
                                         for r in (0, 1) if kill in g0[r].get("losses", {}))
        and kill in g0[1].get("losses", {}),
        "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
        "launches": all(launches_exact(rec) for rec in g0 + g1),
        "devices": [rec.get("device") for rec in g1] == (["cuda:0", "cuda:1"] if global_mesh else ["cuda:0"] * 2),
        "within_budget": phase_s <= POD_ELASTIC_BUDGET_S,
    }
    if global_mesh:
        loss_rel = max((_rel(rec["losses"][str(i + 1)], reference[i]) for rec in g1
                        for i in range(POD_SAVE_AT, POD_STEPS)), default=float("inf"))
        checks["held_to_one_process"] = loss_rel <= TOL_MESH_LOSS_REL
    else:
        loss_rel = None
        # one seed, one card: the two replicas' trajectories are the same
        checks["replicas_equal"] = g1[0].get("losses") == g1[1].get("losses") and bool(g1[0].get("losses"))
    ok = all(checks.values())
    restart_s = (min(rec.get("first_step_at", float("inf")) for rec in g1) - g0[1]["killed_at"]
                 if "killed_at" in g0[1] else None)
    emit(
        "pod.elastic", ok=ok, checks=checks, global_mesh=global_mesh, n_params=n_params, steps=POD_STEPS,
        start_to_first_step_s={f"g{g}.r{r}": recs.get((g, r), {}).get("first_step_s") for g in (0, 1) for r in (0, 1)},
        save_s=[rec.get("save_s") for rec in g0], restore_s=[rec.get("restore_s") for rec in g1],
        timeline={f"g{g}.r{r}": recs.get((g, r), {}).get("timeline") for g in (0, 1) for r in (0, 1)},
        started_and_returned_s=ends, launcher_log=[line for line in stderr.splitlines() if "maggy_tpu_torch.run]" in line],
        restart_s=restart_s, peak_gib=[rec.get("peak_gib") for rec in g1],
        losses={f"g{g}.r{r}": recs.get((g, r), {}).get("losses") for g in (0, 1) for r in (0, 1)},
        reference=reference, loss_rel=loss_rel, tol_loss_rel=TOL_MESH_LOSS_REL if global_mesh else 0.0,
        launches_per_step=per_step, phase_s=phase_s, budget_s=POD_ELASTIC_BUDGET_S, card=card,
    )
    if not ok:
        print(stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f"pod.elastic failed: {[k for k, v in checks.items() if not v]}")
    total = {k: 0 for k in per_step}
    for rec in g0 + g1:
        last = rec["launches"][max(rec["launches"], key=int)]
        for k in total:
            total[k] += last[k]
    return total


def phase_pod_hpo(torch, card: str, model=("llama3_8b", dict(n_layers=POD_LAYERS)), device=None,
                  seq: int = S) -> dict:
    """pod.hpo: ``python -m maggy_tpu_torch.run --workers 2 --respawn 1``
    over a script whose ``lagom(train_fn, HyperparameterOptConfig(
    num_trials=POD_HPO_TRIALS))`` runs one local trial executor on
    ``cuda:0`` in the driver's process; the worker process leases
    ``cuda:0`` through ``MAGGY_TPU_WORKER_DEVICES=0``. The worker SIGKILLs
    itself inside its first trial; the launcher respawns it, the driver
    requeues the lost trial, and every trial finishes once. Returns the
    trials' flash launches. ``model`` and ``device`` as in
    :func:`phase_pod_elastic`."""
    import shutil

    from maggy_tpu_torch.models import DecoderConfig

    cfg = getattr(DecoderConfig, model[0])(**model[1])
    root, n_params = _pod_root(torch, "pod.hpo", 0, cfg)
    out = os.path.join(root, "out")
    script = os.path.join(root, "pod_hpo_script.py")
    with open(script, "w") as f:
        f.write(POD_HPO_SCRIPT.format(repo=REPO, trials=POD_HPO_TRIALS, hb=LAGOM_HB, timeout=POD_HPO_BUDGET_S,
                                      hparams=dict(out=out, seq=seq, model=model), out=out, device=device))
    t0 = time.perf_counter()
    try:
        rc, stdout, stderr = run_launcher(["--workers", "2", "--respawn", "1"], script, POD_HPO_BUDGET_S + 60,
                                          dict(MAGGY_TPU_LOG_ROOT=os.path.join(root, "logs"),
                                               MAGGY_TPU_WORKER_DEVICES="0"))
        phase_s = time.perf_counter() - t0
        started, killed, done = (_pod_records(out, p + ".") for p in ("start", "killed", "done"))
        result = json.load(open(os.path.join(out, "result.json"))) if os.path.exists(os.path.join(out,
                                                                                                  "result.json")) else {}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    per_step = flash_launches_per_step(POD_LAYERS)
    finished = [rec["trial"] for rec in done]
    lost = killed[0]["trial"] if len(killed) == 1 else None
    losses = [v for rec in done for v in rec["losses"]]
    checks = {
        "launcher_exit_0": rc == 0,
        "worker_respawned": "respawning into the live experiment" in stderr,
        "one_worker_killed": len(killed) == 1 and killed[0]["role"] == "worker",
        "every_trial_finished": result.get("num_trials") == POD_HPO_TRIALS and not result.get("errors")
        and len(set(finished)) == POD_HPO_TRIALS,
        "no_trial_finished_twice": len(finished) == len(set(finished)),
        "lost_trial_requeued": lost in finished
        and all(rec["pid"] != killed[0]["pid"] for rec in done if rec["trial"] == lost),
        "both_processes_served": {rec["role"] for rec in done} == {"driver", "worker"},
        "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
        "launches": bool(done) and all(rec["launches"] == {k: POD_HPO_STEPS * v for k, v in per_step.items()}
                                       for rec in done),
        "leases": all(rec["device"] == "cuda:0" for rec in started),
        "within_budget": phase_s <= POD_HPO_BUDGET_S,
    }
    ok = all(checks.values())
    emit(
        "pod.hpo", ok=ok, checks=checks, n_params=n_params, trials=POD_HPO_TRIALS, steps=POD_HPO_STEPS,
        # the first step of a trial carries its warm-up (allocator, cuBLAS)
        trial_step_ms={f"{rec['trial']}.{rec['role']}": dict(mean=statistics.mean(rec["step_ms"]), steps=rec["step_ms"])
                       for rec in done},
        trial_peak_gib={f"{rec['trial']}.{rec['role']}": rec["peak_gib"] for rec in done},
        lost_trial=lost, started=[(rec["trial"], rec["role"]) for rec in started],
        study_s=phase_s, phase_s=phase_s, budget_s=POD_HPO_BUDGET_S, card=card,
    )
    if not ok:
        print(stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f"pod.hpo failed: {[k for k, v in checks.items() if not v]}")
    total = {k: 0 for k in per_step}
    for rec in done + killed:
        for k in total:
            total[k] += rec.get("launches", {}).get(k, 0)
    return total


# ------------------------------------------------------------- dist.elastic


def _elastic_checkpointer(directory: str, keep=None):
    """A ``Checkpointer`` (every save synchronous) that times each save and
    restore into its ``times`` and, with ``keep``, writes only the steps in
    it."""
    from maggy_tpu_torch.train import Checkpointer

    class Timed(Checkpointer):
        def save(self, step, state, meta=None):
            if keep is not None and step not in keep:
                return
            t = time.perf_counter()
            super().save(step, state, meta=meta)
            super().wait()
            self.times.append(("save", int(step), time.perf_counter() - t))

        def restore(self, *args, **kw):
            t = time.perf_counter()
            out = super().restore(*args, **kw)
            self.times.append(("restore", out.step, time.perf_counter() - t))
            return out

    ckpt = Timed(directory, max_to_keep=2, async_save=False)
    ckpt.times = []
    return ckpt


class _ElasticRecord:
    """A train_fn entry's reporter: each step's loss (``fit`` broadcasts the
    step it just took, ``metrics_window=0``) and the flash launches since
    the entry began; with ``hold_at``, the broadcast of that step waits (up
    to ELASTIC_HOLD_S) until the heartbeat announced a newer epoch."""

    def __init__(self, rec: dict, membership, hold_at=None):
        self.rec, self.membership, self.hold_at = rec, membership, hold_at

    def broadcast(self, value, step):
        from maggy_tpu_torch.ops import flash

        self.rec["losses"][str(step)] = value
        self.rec["launches"][str(step)] = dict(flash.LAUNCHES)
        self.rec.setdefault("first_step_at", time.time())
        if step == self.hold_at and self.membership.epoch == 0:
            t, deadline = time.time(), time.time() + ELASTIC_HOLD_S
            while self.membership.pending_epoch() is None and time.time() < deadline:
                time.sleep(0.01)
            self.rec["held_s"] = time.time() - t


class _ServedBatches:
    """The ``train`` stream after its first batch (the sample ``make_state``
    takes), logging the index of every batch served to ``fit`` and where a
    resume skipped to."""

    def __init__(self, data, segment: dict):
        self._it, self._pos, self.segment = data, 0, segment

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.segment["served"].append(self._pos)
        self._pos += 1
        return batch

    def skip(self, n):
        for _ in range(n):
            next(self._it)
        self._pos += n
        self.segment["resume_from"] = self._pos
        return n


def dist_elastic_train(model, hparams, ctx, trial_dir):
    """dist.elastic's train_fn, run by every rank at every entry: the
    ``train`` steps from seed 0 (batch ``i + 1`` at step ``i``), a
    checkpoint in the chief's directory, ``fit(resume="auto")``. Workers
    mode trains each replica alone (a ``Trainer`` with the rank's
    membership, no mesh); slices train on the context's sliced mesh. Each
    entry appends its record (the rank, the epoch, the resume point, the
    batches served, the losses, the launches, the save and restore times)
    to ``<out>/<pid>.jsonl``."""
    import torch

    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    rec = dict(t0=time.time(), rank=ctx.process_index, world=ctx.num_processes, epoch=ctx.membership.epoch,
               device=str(ctx.device), mesh={k: v for k, v in zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)
                                             if v > 1},
               losses={}, launches={}, resume_from=0, served=[])
    if hparams["mode"] == "workers":
        trainer = Trainer(model, adamw(1e-4), device=ctx.device, membership=ctx.membership)
    else:
        trainer = ctx.trainer(model, adamw(1e-4))
    data = synthetic_lm_batches(model.cfg.vocab_size, hparams["rows"], hparams["seq"], seed=0)
    state = trainer.make_state(0, next(data))
    keep = hparams.get("keep")
    ckpt = _elastic_checkpointer(os.path.join(trial_dir, "ckpt"), keep=None if keep is None else set(keep))
    report = _ElasticRecord(rec, ctx.membership, hparams.get("hold_at"))
    flash.reset_launches()
    try:
        state, metrics = trainer.fit(state, _ServedBatches(data, rec), hparams["steps"], reporter=report,
                                     report_every=1, metrics_window=0, checkpointer=ckpt,
                                     checkpoint_every=hparams["every"], resume="auto", prefetch=0)
        rec.update(end_step=int(state.step), grad_norm=float(metrics["grad_norm"]))
    finally:
        ckpt.close()
        rec.update(times=ckpt.times, ended=time.time(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30 if ctx.device.type == "cuda" else None)
        with open(os.path.join(hparams["out"], f"{os.getpid()}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    return {"metric": float(metrics["loss"]), "loss": float(metrics["loss"])}


def reference_steps(torch, cfg, rows: int, seq: int, steps: int, device: str = "cuda:0"):
    """One process's steps (no mesh, no membership) on the ``train`` stream
    from seed 0: ``(losses, grad norms)``, step by step."""
    import gc

    from maggy_tpu_torch.models import Decoder
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    trainer = Trainer(Decoder(cfg, device="meta"), adamw(1e-4), device=device)
    data = synthetic_lm_batches(cfg.vocab_size, rows, seq, seed=0)
    state = trainer.make_state(0, next(data))
    losses, norms = [], []
    for _ in range(steps):
        state, m = trainer.step(state, next(data))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del state, trainer
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return losses, norms


def _elastic_run(torch, cfg, chaos_spec: str, hparams: dict, budget_s: float, **config_kw):
    """``lagom(dist_elastic_train, DistributedConfig(elastic=True, ...))``
    with ``chaos_spec`` in the ranks' environment, in a temporary root:
    the result, each process's entries, the exported counters (summed over
    the processes) and the driver's gauges,
    the driver's and executors' log lines about the membership, the
    phase's seconds. The disk must hold two checkpoints."""
    import glob
    import shutil

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.models import Decoder

    root, _ = _pod_root(torch, "dist.elastic", 2, cfg)
    out = os.path.join(root, "out")
    before = os.environ.get("MAGGY_TPU_CHAOS")
    os.environ["MAGGY_TPU_CHAOS"] = chaos_spec  # the spawned ranks' fault plan
    env_mod.set_instance(BaseEnv(os.path.join(root, "logs")))
    t0 = time.perf_counter()
    try:
        result = experiment.lagom(dist_elastic_train, DistributedConfig(
            module=Decoder(cfg, device="meta"), hparams=dict(hparams, out=out), elastic=True,
            hb_interval=LAGOM_HB, worker_timeout=budget_s + 60, **config_kw))
        phase_s = time.perf_counter() - t0
        exp_dir = env_mod.get_instance().experiment_dir(experiment.APP_ID, experiment.RUN_ID)
        procs = []
        for path in sorted(glob.glob(os.path.join(out, "*.jsonl"))):
            with open(path) as f:
                procs.append([json.loads(line) for line in f])
        counters, gauges = {}, {}
        for path in glob.glob(os.path.join(exp_dir, "telemetry", "*.jsonl")):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("kind") == "snapshot":
                        for k, v in (rec.get("counters") or {}).items():
                            counters[k] = counters.get(k, 0) + v
                        # the gauges of the membership's owner, the driver: a
                        # worker's is its own last view (a parked slice's stays
                        # at the epoch it left), whichever file glob lists last
                        if os.path.basename(path) == "driver.jsonl":
                            gauges.update(rec.get("gauges") or {})
        log = []
        for path in sorted(glob.glob(os.path.join(exp_dir, "*.log"))):
            with open(path) as f:
                log += [line.strip() for line in f if "membership epoch" in line or "reshape barrier" in line
                        or "formed the group" in line]
    finally:
        env_mod.set_instance(None)
        if before is None:
            os.environ.pop("MAGGY_TPU_CHAOS", None)
        else:
            os.environ["MAGGY_TPU_CHAOS"] = before
        shutil.rmtree(root, ignore_errors=True)
    return result, procs, counters, gauges, log, phase_s


def _launches_exact(entry: dict, per_step: dict) -> bool:
    """Every step's flash launches since the entry began: the steps taken
    in it times a step's."""
    return bool(entry.get("launches")) and all(
        n == {k: (int(step) - entry["resume_from"]) * v for k, v in per_step.items()}
        for step, n in entry["launches"].items())


def _committed(segments: list, total: int) -> bool:
    """Whether the segments' batches, each cut at the next one's resume
    point, are every index below ``total`` once."""
    committed = []
    for i, seg in enumerate(segments):
        start = seg["resume_from"]
        if seg["served"] != list(range(start, start + len(seg["served"]))):
            return False
        end = segments[i + 1]["resume_from"] if i + 1 < len(segments) else total
        committed.extend(range(start, end))
    return committed == list(range(total))


def phase_dist_elastic(torch, card: str, model=("llama3_8b", dict(n_layers=POD_LAYERS)), device=None,
                       seq: int = S) -> dict:
    """dist.elastic: elastic membership in workers mode (every card count),
    then dist.elastic.slices with two or more cards. Returns every rank's
    flash launches. ``model`` and ``device="cpu"`` rehearse it on the CPU
    at a tiny size, where every check but the launches and the budget can
    pass (the slices part needs cards)."""
    from maggy_tpu_torch.models import DecoderConfig

    t_phase = time.perf_counter()
    cfg = getattr(DecoderConfig, model[0])(**model[1])
    per_step = flash_launches_per_step(cfg.n_layers)
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref_losses, _ = reference_steps(torch, cfg, B, seq, ELASTIC_STEPS, device=device or "cuda:0")
    hparams = dict(mode="workers", rows=B, seq=seq, steps=ELASTIC_STEPS, every=10 * ELASTIC_STEPS,
                   hold_at=ELASTIC_KILL_AT + 1)
    result, procs, counters, gauges, log, lagom_s = _elastic_run(
        torch, cfg, f"kill:worker=1,step={ELASTIC_KILL_AT}", hparams, DIST_ELASTIC_BUDGET_S, sharding="dp",
        num_executors=2, data_plane="local", device=device)
    phase_s = time.perf_counter() - t_phase
    entries = [e for p in procs for e in p]
    survivor = next((p for p in procs if len(p) == 2), [])
    killed = next((p for p in procs if len(p) == 1 and p[0].get("end_step") is None), [])
    times = [t for e in entries for t in e["times"]]
    losses_equal = bool(survivor) and all(
        v == ref_losses[int(step) - 1] for e in survivor + killed for step, v in e["losses"].items())
    checks = {
        "one_worker": result.get("num_workers") == 1,
        "no_restart_slot": counters.get("resilience.dist_restarts", 0) == 0,
        "one_drop_epoch_1": counters.get("resilience.slice_drops") == 1 and gauges.get(
            "resilience.membership_epoch") == 1,
        "rank1_killed_at_step": bool(killed) and killed[0]["served"] == list(range(ELASTIC_KILL_AT)),
        "survivor_reshaped_once": [e["epoch"] for e in survivor] == [0, 1]
        and survivor[1]["resume_from"] == len(survivor[0]["served"]) <= ELASTIC_KILL_AT + 1,
        "no_step_rerun": bool(survivor) and _committed(survivor, ELASTIC_STEPS)
        and survivor[1].get("end_step") == ELASTIC_STEPS,
        "one_save": [list(t[:2]) for t in times if t[0] == "save"] == [["save", survivor[1]["resume_from"]]]
        if survivor else False,
        "losses_bit_equal_to_one_process": losses_equal,
        "launches": bool(entries) and all(_launches_exact(e, per_step) for e in entries),
        "devices": all(e["device"] == ("cpu" if device == "cpu" else "cuda:0") for e in survivor),
        "within_budget": phase_s <= DIST_ELASTIC_BUDGET_S,
    }
    ok = all(checks.values())
    emit(
        "dist.elastic", ok=ok, checks=checks, mode="workers", data_plane="local", steps=ELASTIC_STEPS,
        kill_at=ELASTIC_KILL_AT, result=result,
        segments=[dict(epoch=e["epoch"], resume_from=e["resume_from"], served=e["served"], device=e["device"])
                  for e in survivor + killed],
        losses={f"epoch{e['epoch']}": e["losses"] for e in survivor}, reference=ref_losses,
        save_and_restore_s=times, held_s=[e.get("held_s") for e in survivor],
        reshape_ms=gauges.get("resilience.reshape_ms"), membership_log=log,
        counters={k: v for k, v in counters.items() if k.startswith("resilience.")},
        peak_gib=[e.get("peak_gib") for e in entries], launches_per_step=per_step, lagom_s=lagom_s,
        phase_s=phase_s, budget_s=DIST_ELASTIC_BUDGET_S, card=card,
    )
    if not ok:
        raise SystemExit(f"dist.elastic failed: {[k for k, v in checks.items() if not v]}")
    total = {k: 0 for k in per_step}
    for e in entries:
        last = e["launches"][max(e["launches"], key=int)]
        for k in total:
            total[k] += last[k]
    if (torch.cuda.device_count() if device is None else 0) >= 2:
        for k, v in phase_dist_elastic_slices(torch, cfg, card, seq).items():
            total[k] += v
    else:
        emit("dist.elastic.slices", ran=False, ok=True, reason="needs two or more cards", card=card)
    return total


def phase_dist_elastic_slices(torch, cfg, card: str, seq: int = S, device=None, ranks=None) -> dict:
    """dist.elastic.slices (two or more cards): 2 slices of one rank (two,
    fsdp=2, on four cards) over NCCL; slice 1 dropped at ELASTIC_DROP_AT
    and rejoined at ELASTIC_REJOIN_AT. Returns every rank's flash
    launches. ``device="cpu"`` and ``ranks`` rehearse it over gloo ranks,
    where every check but the launches and the devices can pass."""
    t_phase = time.perf_counter()
    per_step = flash_launches_per_step(cfg.n_layers)
    ranks = ranks or (4 if torch.cuda.device_count() >= 4 else 2)
    ref_losses, ref_norms = reference_steps(torch, cfg, ELASTIC_ROWS, seq, ELASTIC_STEPS, device=device or "cuda:0")
    hparams = dict(mode="slices", rows=ELASTIC_ROWS, seq=seq, steps=ELASTIC_STEPS, every=ELASTIC_SAVE_AT,
                   keep=[ELASTIC_SAVE_AT, ELASTIC_REJOIN_AT])
    spec = f"slice_drop:slice=1,step={ELASTIC_DROP_AT};slice_rejoin:slice=1,step={ELASTIC_REJOIN_AT}"
    result, procs, counters, gauges, log, lagom_s = _elastic_run(
        torch, cfg, spec, hparams, DIST_ELASTIC_SLICES_BUDGET_S, sharding="fsdp", num_executors=ranks,
        num_slices=2, data_plane="auto", device=device)
    phase_s = time.perf_counter() - t_phase
    entries = [e for p in procs for e in p]
    chief = sorted((e for e in entries if e["rank"] == 0), key=lambda e: e["epoch"])
    loss_rel = max((_rel(v, ref_losses[int(step) - 1]) for e in entries for step, v in e["losses"].items()),
                   default=float("inf"))
    finals = [e for e in entries if "grad_norm" in e]
    norm_rel = max((_rel(e["grad_norm"], ref_norms[-1]) for e in finals), default=float("inf"))
    times = [t for e in entries for t in e["times"]]
    checks = {
        "every_rank_at_the_end": result.get("num_workers") == ranks and len(finals) == ranks,
        "epoch_2": gauges.get("resilience.membership_epoch") == 2 and counters.get(
            "resilience.slice_drops") == 1 and counters.get("resilience.slice_rejoins") == 1,
        "chief_resumes_from": [e["resume_from"] for e in chief] == [0, ELASTIC_SAVE_AT, ELASTIC_REJOIN_AT]
        and [e["epoch"] for e in chief] == [0, 1, 2],
        "exactly_once": _committed(chief, ELASTIC_STEPS),
        "widths": [e["world"] for e in chief] == [ranks, ranks // 2, ranks],
        "parked_slice_back": sum(1 for p in procs if [e["epoch"] for e in p] == [0, 2]) == ranks // 2,
        "held_to_one_process": loss_rel <= TOL_MESH_LOSS_REL and norm_rel <= TOL_MESH_GRAD_NORM_REL,
        "launches": bool(entries) and all(_launches_exact(e, per_step) for e in entries),
        "devices": sorted({p[0]["device"] for p in procs}) == [f"cuda:{r}" for r in range(ranks)]
        and all(len({e["device"] for e in p}) == 1 for p in procs),
        "within_budget": phase_s <= DIST_ELASTIC_SLICES_BUDGET_S,
    }
    ok = all(checks.values())
    emit(
        "dist.elastic.slices", ran=True, ok=ok, checks=checks, ranks=ranks, steps=ELASTIC_STEPS,
        drop_at=ELASTIC_DROP_AT, rejoin_at=ELASTIC_REJOIN_AT, result=result,
        chief=[dict(epoch=e["epoch"], world=e["world"], mesh=e["mesh"], resume_from=e["resume_from"],
                    served=e["served"]) for e in chief],
        losses={f"rank{e['rank']}.epoch{e['epoch']}.{e['device']}": e["losses"] for e in entries},
        reference=ref_losses, reference_grad_norms=ref_norms, loss_rel=loss_rel, grad_norm_rel=norm_rel,
        tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL),
        save_and_restore_s=times, reshape_ms=gauges.get("resilience.reshape_ms"), membership_log=log,
        peak_gib=[e.get("peak_gib") for e in entries], launches_per_step=per_step, lagom_s=lagom_s,
        phase_s=phase_s, budget_s=DIST_ELASTIC_SLICES_BUDGET_S, card=card,
    )
    if not ok:
        raise SystemExit(f"dist.elastic.slices failed: {[k for k, v in checks.items() if not v]}")
    total = {k: 0 for k in per_step}
    for e in entries:
        last = e["launches"][max(e["launches"], key=int)]
        for k in total:
            total[k] += last[k]
    return total


def moe_config(**overrides):
    """Mixtral-8x7B widths at the MoE phases' depth."""
    from maggy_tpu_torch.models import MoEConfig

    return MoEConfig.mixtral_8x7b(n_layers=MOE_LAYERS, **overrides)


def moe_launches_per_step(n_layers: int) -> dict:
    """What one train step of the MoE decoder launches: under its remat
    policy (``dots_attn``, Mixtral's default as JAX's) the recompute keeps
    the flash forward's O and LSE, so the forward runs once a layer."""
    return {"flash_fwd": n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}


def moe_step_flops(cfg, b: int, seq: int) -> float:
    """The matmul operations of one train step (forward, the forward again
    under remat, backward at twice the forward): attention projections and
    scores, the router, the dispatch and combine einsums over every capacity
    slot, the expert FFNs over every slot (capacity_factor x the top-k
    assignments) and the head."""
    from maggy_tpu_torch.models.moe import capacity_of

    t = b * seq
    g = min(cfg.group_size, t)
    n, c, e = -(-t // g), capacity_of(cfg, g), cfg.n_experts
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    attn = 2 * t * d * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd + 2 * 2 * b * cfg.n_heads * seq * seq * hd / 2
    router = 2 * t * d * e
    dispatch = 2 * 2 * n * g * e * c * d  # dispatch and combine
    experts = 3 * 2 * e * n * c * d * f
    forward = cfg.n_layers * (attn + router + dispatch + experts) + 2 * t * d * cfg.vocab_size
    return 4 * forward  # forward, recomputed forward, backward (2 x)


def moe_routed_forward(torch, model, tokens):
    """``model(tokens)`` and each layer's top-k experts of every token
    (sorted, ``[L, B, S, k]``), read from the layer's router on its MoE
    input; and each layer's attention input and the kernel's output on its
    way to ``wo``. The hooks only read."""
    from maggy_tpu_torch.models.moe import top_k_lowest_first

    seen, attn = [], []
    hooks = []
    for layer in model.layers:
        hooks.append(layer.moe.register_forward_pre_hook(lambda _m, args: seen.append(args[0])))
        hooks.append(layer.attn.register_forward_pre_hook(lambda _m, args: attn.append([args[0], args[1]])))
        hooks.append(layer.attn.wo.register_forward_pre_hook(lambda _m, args: attn[-1].append(args[0])))
    try:
        logits = model(tokens)
    finally:
        for hook in hooks:
            hook.remove()
    k = model.cfg.top_k
    experts = torch.stack([
        top_k_lowest_first(torch.softmax(layer.moe.router(x).float(), -1), k)[1].sort(-1).values
        for layer, x in zip(model.layers, seen)])
    return logits, experts, attn


def phase_moe_model(torch, card: str, seq: int = S, device: str = "cuda"):
    """``MoEDecoder(mixtral_8x7b(n_layers=MOE_LAYERS))`` on one card from
    seeded weights at B=2, S=2048 through the flash kernels: each layer's
    attention output against the kernels' plain version on the same q/k/v;
    the logits against the same weights with ``default_attention``, with
    the plain version and with a planted fault (the causal mask left off),
    each over the tokens routed to the same experts in every layer (a token
    whose top-2 flips between two right attentions, at a router near a tie
    in bf16, goes to other experts: the share that flips is reported beside
    the yardstick's, two plain attentions); the forward launches counted.
    Then cached greedy decode against the full forward and ``generate``.
    ``device`` is for a rehearsal on the CPU at a tiny config (``moe_config``
    patched)."""
    import dataclasses

    from maggy_tpu_torch.models import MoEDecoder, default_attention
    from maggy_tpu_torch.models.generate import generate, init_cache
    from maggy_tpu_torch.models.transformer import rope
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import collect_aux_losses

    def plain_flash(q, k, v, *, causal=True, segment_ids=None):
        return flash.flash_fwd_reference(q, k, v, causal=causal, segment_ids=segment_ids)[0]

    def planted_fault(q, k, v, *, causal=True, segment_ids=None):
        return plain_flash(q, k, v, causal=False, segment_ids=segment_ids)

    t0 = time.perf_counter()
    cfg = moe_config()
    gen = torch.Generator(device=device).manual_seed(11)
    model = MoEDecoder(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, seq), generator=gen, device=device)
    prompt_len, steps = MOE_DECODE_PROMPT, MOE_DECODE_STEPS
    with torch.no_grad():
        flash.reset_launches()
        logits, experts, seen = moe_routed_forward(torch, model, tokens)
        torch.cuda.synchronize()
        launched = dict(flash.LAUNCHES)
        aux = float(collect_aux_losses(model))
        attn_errs = []
        shape = (B, seq, -1, cfg.head_dim)
        for layer, (x, positions, out) in zip(model.layers, seen):
            a = layer.attn
            q = rope(a.wq(x).view(shape), positions, cfg.rope_theta)
            k = rope(a.wk(x).view(shape), positions, cfg.rope_theta)
            ref = plain_flash(q.float(), k.float(), a.wv(x).view(shape).float())
            o = out.view(ref.shape)
            attn_errs.append({"o_max_abs": float((o.float() - ref).abs().max()), "o_rel_l2": rel_l2(o, ref)})
            del q, k, ref
        del seen
        refs = {}
        for name, fn in (("default_attention", default_attention), ("plain_version", plain_flash),
                         ("planted_fault", planted_fault)):
            other = MoEDecoder(dataclasses.replace(cfg, attention_fn=fn), device="meta")
            other.load_state_dict(model.state_dict(), assign=True)
            refs[name] = moe_routed_forward(torch, other, tokens)[:2]
            del other

        def held(a, b):
            """(rel L2 over the tokens both route alike, share of tokens that flip)"""
            same = (a[1] == b[1]).all(-1).all(0)  # [B, S]
            return rel_l2(a[0][same], b[0][same]), 1.0 - float(same.float().mean())

        errs = {
            "kernel_vs_default_attention": held((logits, experts), refs["default_attention"]),
            "kernel_vs_plain_version": held((logits, experts), refs["plain_version"]),
            # the yardstick: two plain attentions on the same weights
            "plain_version_vs_default_attention": held(refs["plain_version"], refs["default_attention"]),
            # must exceed the limit: a wrong attention
            "planted_fault_vs_plain_version": held(refs["planted_fault"], refs["plain_version"]),
        }
        all_tokens_rel = rel_l2(logits, refs["default_attention"][0])
        del refs
        # cached greedy decode at the capacity that drops no token, held to
        # the full forward of the tokens it produced
        free = MoEDecoder(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k), device="meta")
        free.load_state_dict(model.state_dict(), assign=True)
        prompt = tokens[:1, :prompt_len]
        flash.reset_launches()
        cache = init_cache(free, prompt)
        out = free(prompt, torch.arange(prompt_len, device=device)[None], cache=cache, kv_len=prompt_len)
        step_logits, produced = [out[:, -1]], [prompt]
        for i in range(steps):
            nxt = step_logits[-1].argmax(-1)[:, None]
            produced.append(nxt)
            pos = torch.full((1, 1), prompt_len + i, device=device)
            step_logits.append(free(nxt, pos, cache=cache, kv_len=prompt_len + i + 1)[:, 0])
        torch.cuda.synchronize()
        cache_launches = sum(flash.LAUNCHES.values())
        seq_tokens = torch.cat(produced, 1)
        full = free(seq_tokens)[0, prompt_len - 1:]
        decode_rel = [rel_l2(c[0], w) for c, w in zip(step_logits, full)]
        decode_max_abs = float((torch.stack(step_logits)[:, 0] - full).abs().max())
        buf = torch.zeros((1, prompt_len + steps), dtype=tokens.dtype, device=device)
        buf[:, :prompt_len] = prompt
        recomputed = generate(free, buf, torch.tensor([prompt_len], device=device))
        agree = float((recomputed[0, prompt_len:] == seq_tokens[0, prompt_len:]).float().mean())
        del free, cache
    phase_s = time.perf_counter() - t0
    checks = {
        "logits": tuple(logits.shape) == (B, seq, cfg.vocab_size) and logits.dtype == torch.float32
        and bool(torch.isfinite(logits).all()),
        "attention_per_layer": len(attn_errs) == cfg.n_layers
        and all(e["o_max_abs"] <= TOL_O_ABS and e["o_rel_l2"] <= TOL_O_REL_L2 for e in attn_errs),
        "kernel_vs_default_attention": errs["kernel_vs_default_attention"][0] <= TOL_LOGITS_REL_L2,
        "kernel_vs_plain_version": errs["kernel_vs_plain_version"][0] <= TOL_LOGITS_REL_L2,
        "planted_fault_caught": errs["planted_fault_vs_plain_version"][0] > TOL_LOGITS_REL_L2,
        "launches": launched == {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
        "aux_loss": math.isfinite(aux) and aux > 0,
        "cached_decode_vs_full_forward": len(decode_rel) == steps + 1 and max(decode_rel) <= TOL_MOE_DECODE_REL_L2,
        "cache_path_launches_nothing": cache_launches == 0,
        "generate_agrees": agree >= 0.9,
        "within_budget": phase_s <= MOE_MODEL_BUDGET_S,
    }
    ok = all(checks.values())
    emit("moe.model", ok=ok, checks=checks, layers=cfg.n_layers, shape=list(logits.shape), launches=launched,
         aux_loss=aux, attention_per_layer=attn_errs, tol_o=dict(max_abs=TOL_O_ABS, rel_l2=TOL_O_REL_L2),
         logits_rel_l2_and_flipped_share=errs, logits_rel_l2_every_token=all_tokens_rel,
         tol_logits_rel_l2=TOL_LOGITS_REL_L2, decode_rel_l2=decode_rel, decode_max_abs=decode_max_abs,
         tol_decode_rel_l2=TOL_MOE_DECODE_REL_L2, generate_token_agreement=agree, phase_s=phase_s,
         budget_s=MOE_MODEL_BUDGET_S, card=card)
    if not ok:
        raise SystemExit(f"moe.model failed: {[k for k, v in checks.items() if not v]}")
    del model, logits
    torch.cuda.empty_cache()
    return launched


def phase_moe_train(torch, card: str, profile: bool, seq: int = S, steps: int = TRAIN_STEPS, device: str = "cuda"):
    """``Trainer.fit`` of the MoE decoder at ``moe.model``'s shape: a one-
    step warm-up fit, then ``steps`` fit steps (every loss read). Returns
    the launches and the single rank ``dist.moe`` is held to."""
    import gc

    from maggy_tpu_torch.models import MoEDecoder
    from maggy_tpu_torch.ops import flash
    from maggy_tpu_torch.train import Trainer, adamw, synthetic_lm_batches

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = moe_config()
    trainer = Trainer(MoEDecoder(cfg, device="meta"), adamw(1e-4), device=device)
    data = synthetic_lm_batches(cfg.vocab_size, B, seq, seed=0)
    state = trainer.make_state(0, next(data))
    hooks, records = record_routes(state.model)  # every step's routing, for dist.moe.mesh
    state, warm = trainer.fit(state, data, 1)
    groups = grad_norms_by_group(state.model)  # the warm-up step's gradients, still held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()
    losses = []

    class Record:
        def broadcast(self, value, step):
            losses.append(value)

    state, metrics = trainer.fit(state, data, steps, reporter=Record(), report_every=1, metrics_window=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(flash.LAUNCHES)
    for hook in hooks:
        hook.remove()
    routes = decode_routes(encode_routes(records), cfg.top_k, B * seq)
    phase_s = time.perf_counter() - t0
    expected = {k: v * steps for k, v in moe_launches_per_step(cfg.n_layers).items()}
    step_ms = 1e3 / metrics["steps_per_sec"]
    flops = moe_step_flops(cfg, B, seq)
    checks = {
        "losses_finite": len(losses) == steps and all(math.isfinite(v) for v in [warm["loss"]] + losses),
        "aux_loss": math.isfinite(metrics["aux_loss"]) and metrics["aux_loss"] > 0,
        "total_is_loss_plus_aux": abs(metrics["total_loss"] - metrics["loss"] - metrics["aux_loss"]) <= 1e-5,
        "launches": launches == expected,
        "peak_within_limit": peak <= MOE_PEAK_LIMIT_GIB,
        "within_budget": phase_s <= MOE_TRAIN_BUDGET_S,
    }
    ok = all(checks.values())
    emit("moe.train", ok=ok, checks=checks, layers=cfg.n_layers, steps=steps, losses=losses,
         aux_loss=metrics["aux_loss"], total_loss=metrics["total_loss"], grad_norm=metrics["grad_norm"],
         step_ms=step_ms, tokens_per_sec=B * seq * metrics["steps_per_sec"], max_memory_allocated_gib=peak,
         launches=launches, expected=expected, matmul_tflop_per_step=flops / 1e12,
         matmul_bound_ms=flops / PEAK_BF16_FLOPS * 1e3, phase_s=phase_s, budget_s=MOE_TRAIN_BUDGET_S, card=card)
    if not ok:
        raise SystemExit(f"moe.train failed: {[k for k, v in checks.items() if not v]}")
    if profile:
        profile_moe_steps(torch, trainer, state, data, card, step_ms, cfg.d_ff)
    single = dict(losses=[warm["loss"]] + losses, first_grad_norm=warm["grad_norm"], first_aux_loss=warm["aux_loss"],
                  last_grad_norm=metrics["grad_norm"], group_grad_norms=groups, step_ms=step_ms, routes=routes)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, single


def profile_moe_steps(torch, trainer, state, data, card: str, step_ms: float, d_ff: int, n: int = 2) -> None:
    """``moe.train.profile``: device time by kind over ``n`` steps. The
    matmul kernels are split by the operator that launched them: a batched
    matmul with the FFN width among its shapes is an expert matmul, any
    other batched matmul a dispatch or combine einsum, a plain one a
    projection (attention, router, head)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(n):
            state, _ = trainer.step(state, next(data))
        torch.cuda.synchronize()
    kinds = dict(attention=0.0, adamw_and_grad_norm=0.0, loss_and_softmax=0.0, matmul=0.0, other=0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        ms = evt.self_device_time_total / 1e3 / n
        cat = _category(evt.key)
        if cat.startswith("ring_"):
            kinds["attention"] += ms
        elif cat == "optimizer_and_grad_norm":
            kinds["adamw_and_grad_norm"] += ms
        elif cat == "loss" and ("softmax" in evt.key.lower() or "nll" in evt.key.lower()):
            kinds["loss_and_softmax"] += ms
        elif cat == "matmul":
            kinds["matmul"] += ms
        else:
            kinds["other"] += ms
    matmuls = dict(expert_matmuls=0.0, dispatch_combine_einsums=0.0, projections=0.0)
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key not in ("aten::bmm", "aten::mm", "aten::addmm"):
            continue
        ms = evt.self_device_time_total / 1e3 / n
        if evt.key != "aten::bmm":
            matmuls["projections"] += ms
        elif any(d_ff in shape for shape in evt.input_shapes if shape):
            matmuls["expert_matmuls"] += ms
        else:
            matmuls["dispatch_combine_einsums"] += ms
    busy = sum(kinds.values())
    emit("moe.train.profile", steps=n, device_ms_per_step=busy, idle_share=1.0 - busy / step_ms,
         by_kind_ms=kinds, matmul_by_operator_ms=matmuls, card=card)


def moe_study_groups(cards: int) -> list:
    """dist.moe's and dist.moe.mesh's specs as one ``lagom`` study a rank
    count (a study's spawn, NCCL set-up and first step cost 15-40 s),
    each spec ``{key, kw (its ShardingSpec), steps, phase}`` (phase
    ``"fault"`` for the planted fault; every spec but dist.moe's records
    its routing). A study's first spec is its ``DistributedConfig(sharding=)``:
    ep=2 on two cards; pp=2 and pp=2 x ep=2 on four. The planted fault
    (tp=2, the expert weights left out of the optimizer) runs beside tp=2."""

    def moe(key, **kw):
        return dict(key=key, kw=kw, steps=TRAIN_STEPS, phase="dist.moe")

    def mesh(key, fault=False, **kw):
        return dict(key=key, kw=kw, steps=MOE_MESH_STEPS, phase="fault" if fault else "dist.moe.mesh")

    if cards < 2:
        return []
    fault = mesh("tp2_fault", fault=True, tp=2)
    if cards < 4:
        return [[moe("ep2", ep=2), mesh("tp2", tp=2), mesh("pp2", pp=2), fault]]
    groups = [[mesh("pp2", pp=2), mesh("tp2", tp=2), moe("fsdp2", fsdp=2), fault],
              [mesh("pp2_ep2", pp=2, ep=2), moe("ep4", ep=4), moe("ep2_fsdp2", ep=2, fsdp=2),
               mesh("ep2_tp2", ep=2, tp=2), mesh("pp2_tp2", pp=2, tp=2)]]
    if cards >= 8:
        groups.append([mesh("pp2_tp2_ep2", pp=2, tp=2, ep=2)])
    return groups


def dist_moe_study_train(model, hparams, reporter, ctx):
    """dist.moe's and dist.moe.mesh's train_fn, run by each rank:
    ``moe.train``'s steps under each of ``hparams["specs"]`` in turn, over
    the study's ranks: the first spec is the study's own (its context),
    each later one a ``TrainContext.create`` over the same ranks, a fresh
    meta model each (``n_microbatches`` under pp; the planted fault's
    optimizer skips the expert weights). Returns ``{"metric", "specs":
    {key: mesh_steps' figures, the spec's seconds and what the card held
    before it}}``: a spec's peak counts what an earlier spec left alive."""
    import gc

    import torch

    from maggy_tpu_torch.parallel import ShardingSpec
    from maggy_tpu_torch.train import TrainContext, adamw

    out = {}
    for i, spec in enumerate(hparams["specs"]):
        key, kw = spec["key"], spec["kw"]
        t0 = time.perf_counter()
        held = torch.cuda.memory_allocated() / 2**30  # what the specs before left on the card
        spec_ctx = ctx if i == 0 else TrainContext.create(ShardingSpec(**kw), device=ctx.device)
        trainer_kw = dict(n_microbatches=MOE_MESH_MICRO) if kw.get("pp", 1) > 1 else {}
        if spec["phase"] == "fault":
            trainer_kw["optimizer"] = skip_expert_weights(adamw(1e-4))
        out[key] = mesh_steps(spec_ctx, model if i == 0 else type(model)(model.cfg, device="meta"), spec["steps"],
                              hparams["seq"], reporter if i == 0 else None, routes=spec["phase"] != "dist.moe",
                              **trainer_kw)
        out[key].update(spec_s=time.perf_counter() - t0, held_before_gib=held)
        if i == 0:  # the study's module stays referenced: its gradients at least go
            for p in model.parameters():
                p.grad = None
        del spec_ctx
        gc.collect()
        torch.cuda.empty_cache()
    return {"metric": out[hparams["specs"][0]["key"]]["metric"], "specs": out}


def lagom_ranks(train_fn, cfg, spec, hparams: dict, left: float) -> list:
    """``lagom(train_fn, DistributedConfig(sharding=spec))`` over an
    ``MoEDecoder(cfg)``, one spawned NCCL rank a card, its logs in a
    temporary root (never the repo), every rank inside ``left`` seconds;
    returns each rank's output, by rank."""
    import tempfile
    from pathlib import Path

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core import env as env_mod
    from maggy_tpu_torch.core.env.base import BaseEnv
    from maggy_tpu_torch.models import MoEDecoder

    with tempfile.TemporaryDirectory(prefix="dist_moe_") as root:
        env_mod.set_instance(BaseEnv(root))
        try:
            experiment.lagom(train_fn, DistributedConfig(
                module=MoEDecoder(cfg, device="meta"), hparams=hparams, sharding=spec,
                num_executors=spec.num_devices, hb_interval=LAGOM_HB, worker_timeout=left,
            ))
            outs = sorted(Path(root).rglob("worker_*/.outputs.json"), key=lambda p: int(p.parent.name[7:]))
            return [json.loads(p.read_text()) for p in outs]
        finally:
            env_mod.set_instance(None)


def moe_studies(torch, seq: int = S) -> dict:
    """The studies of :func:`moe_study_groups` on this host's cards, in
    turn, inside the smaller of dist.moe's and dist.moe.mesh's budgets:
    each spec's outputs by rank, the studies' seconds, and the whole."""
    import gc

    from maggy_tpu_torch.parallel import ShardingSpec

    groups = moe_study_groups(torch.cuda.device_count())
    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_config()
    budget = min(DIST_MOE_BUDGET_S, DIST_MOE_MESH_BUDGET_S)
    t0 = time.perf_counter()
    results, study_s = {}, []
    for group in groups:
        left = max(1.0, budget - (time.perf_counter() - t0))
        t_study = time.perf_counter()
        outs = lagom_ranks(dist_moe_study_train, cfg, ShardingSpec(**group[0]["kw"]), dict(seq=seq, specs=group),
                           left)
        study_s.append(time.perf_counter() - t_study)
        print(f"chip_smoke: MoE study {[s['key'] for s in group]} done at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        for spec in group:
            results[spec["key"]] = [o["specs"][spec["key"]] for o in outs]
    return dict(cfg=cfg, seq=seq, specs=[s for g in groups for s in g], results=results, study_s=study_s,
                phase_s=time.perf_counter() - t0, leads=[g[0]["key"] for g in groups])


def phase_dist_moe(torch, card: str, single: dict, studies: dict) -> dict:
    """Expert parallelism across cards under ``lagom(train_fn,
    DistributedConfig(sharding=ShardingSpec(...)))``, one spawned NCCL
    rank a card, ``moe.train``'s weights, data and steps: ep=2 on two
    cards; ep=4, ep=2 x fsdp=2 and, as the latter's yardstick, fsdp=2 alone
    (the same batch split, no expert axis) on four; run in the studies of
    :func:`moe_studies`, beside dist.moe.mesh's specs (a study's first spec
    reaches the ranks through the config, the others through
    ``TrainContext.create``). A spec with no batch split (ep alone) is held
    to ``moe.train``'s single rank under dist.mesh's limits at every step.
    Under a batch split the sums run in another order, and a router near a
    bf16 tie sends a token to another expert, which the later steps
    amplify: its warm-up step is held to the single rank (loss, gradient
    groups, the trainer's count), and every step of ep=2 x fsdp=2 to the
    fsdp=2 yardstick's under dist.mesh's limits. The studies' seconds are
    held to this phase's budget. Returns rank 0's flash launches, summed
    over the specs."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("dist.moe", ok=True, ran=False, cards=cards, card=card)
        return {}
    specs = [s for s in studies["specs"] if s["phase"] == "dist.moe"]
    results, cfg = studies["results"], studies["cfg"]
    yardstick = {"ep2_fsdp2": "fsdp2"}
    launches = {}
    for spec in specs:
        for name, count in results[spec["key"]][0]["launches"].items():
            launches[name] = launches.get(name, 0) + count
    phase_s = studies["phase_s"]
    expected = {k: (1 + TRAIN_STEPS) * v for k, v in moe_launches_per_step(cfg.n_layers).items()}
    rows = []
    for spec in specs:
        key, kw = spec["key"], spec["kw"]
        for rank, res in enumerate(results[key]):
            loss_rel = [_rel(g, w) for g, w in zip(res["losses"], single["losses"])]
            norm_rel = dict(first=_rel(res["first_grad_norm"], single["first_grad_norm"]),
                            last=_rel(res["last_grad_norm"], single["last_grad_norm"]))
            group_rel = {k: _rel(v, single["group_grad_norms"][k]) for k, v in res["group_grad_norms"].items()}
            split = math.prod(kw.get(a, 1) for a in ("dp", "fsdp")) > 1
            ref = results[yardstick[key]][0] if key in yardstick else None
            ref_loss_rel = None if ref is None else max(_rel(g, w) for g, w in zip(res["losses"], ref["losses"]))
            ref_norm_rel = None if ref is None else max(_rel(res["first_grad_norm"], ref["first_grad_norm"]),
                                                         _rel(res["last_grad_norm"], ref["last_grad_norm"]))
            held = (loss_rel[0] <= TOL_MESH_LOSS_REL and norm_rel["first"] <= TOL_MESH_GRAD_NORM_REL
                    if split else max(loss_rel) <= TOL_MESH_LOSS_REL and max(norm_rel.values()) <= TOL_MESH_GRAD_NORM_REL)
            if ref is not None:
                held = held and ref_loss_rel <= TOL_MESH_LOSS_REL and ref_norm_rel <= TOL_MESH_GRAD_NORM_REL
            rows.append(dict(spec=key, rank=rank, mesh=res["mesh"], experts=res.get("experts"), losses=res["losses"],
                             loss_rel_to_single=loss_rel, grad_norm_rel_to_single=norm_rel,
                             loss_rel_to_yardstick=ref_loss_rel, grad_norm_rel_to_yardstick=ref_norm_rel,
                             group_grad_norm_rel=group_rel, grad_norm_count_rel=res["grad_norm_count_rel"],
                             step_ms=res["step_ms"], ratio_to_single=res["step_ms"] / single["step_ms"],
                             peak_gib=res["peak_gib"], held_before_gib=res["held_before_gib"],
                             launches=res["launches"],
                             ok=held and len(res["losses"]) == TRAIN_STEPS + 1
                             and set(group_rel) == set(single["group_grad_norms"])
                             and max(group_rel.values()) <= TOL_MESH_GROUP_NORM_REL
                             and res["grad_norm_count_rel"] <= TOL_GRAD_NORM_COUNT_REL
                             and res["launches"] == expected
                             and res.get("experts") == cfg.n_experts // kw.get("ep", 1) and res["params_on_card"]))
    from maggy_tpu_torch.parallel import ShardingSpec

    n_ranks = sum(ShardingSpec(**s["kw"]).num_devices for s in specs)
    ok = len(rows) == n_ranks and all(r["ok"] for r in rows) and phase_s <= DIST_MOE_BUDGET_S
    emit("dist.moe", ok=ok, ran=True, cards=cards, ranks=rows, yardsticks=yardstick, expected_launches=expected,
         tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL,
                  group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL, grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL),
         studies_s=studies["study_s"], study_leads=studies["leads"], phase_s=phase_s, budget_s=DIST_MOE_BUDGET_S,
         card=card)
    if not ok:
        raise SystemExit("dist.moe failed: a rank's losses, grad norms (whole, by group, or as its trainer counts "
                         "them), experts or launches disagree with moe.train's single rank or its yardstick, or "
                         "the phase ran past its budget")
    return launches


def spec_routes(cfg, outs: list, tokens: int) -> dict:
    """A spec's routing of every layer (decoded, ``tokens`` a step), from
    the first rank holding each layer: every rank of a stage routes the
    whole batch alike (no batch split in these specs)."""
    routes = {}
    for res in outs:
        for layer, r in decode_routes(res.get("routes") or {}, cfg.top_k, tokens).items():
            routes.setdefault(layer, r)
    return routes


def phase_dist_moe_mesh(torch, card: str, single: dict, studies: dict) -> dict:
    """The MoE decoder under tensor and pipeline parallelism across cards,
    under ``lagom(train_fn, DistributedConfig(sharding=ShardingSpec(...)))``,
    one spawned NCCL rank a card, ``moe.train``'s weights and data for
    MOE_MESH_STEPS steps after the warm-up: tp=2 and pp=2 (MOE_MESH_MICRO
    microbatches, one row each) on two cards; on four also ep=2 x tp=2,
    pp=2 x ep=2 and pp=2 x tp=2; pp=2 x tp=2 x ep=2 on eight (else
    reported not run). Run in the studies of :func:`moe_studies`, beside
    dist.moe's specs: a study's first spec reaches the ranks through
    ``DistributedConfig(sharding=)`` (pp=2 and pp=2 x ep=2 on four cards),
    the others through ``TrainContext.create`` over the same ranks.
    Every step of every spec is held to ``moe.train``'s single rank under
    dist.mesh's loss limit, its warm-up step's grad norm, gradient groups
    and the trainer's count too, its aux loss within JAX's 1e-3 (a
    pipeline's router statistics are each microbatch's); every step of a
    spec that adds ``expert`` to its yardstick without it (ep=2 x tp=2 to
    tp=2, pp=2 x ep=2 to pp=2) under the same limits. Beside each step, the
    share of tokens routed to other experts than on one card (a router near
    a bf16 tie, after the tensor all-reduce summed in another order, sends
    a token elsewhere, and the later steps carry it). A planted fault, tp=2
    with the expert weights left out of the optimizer, must break the loss
    limit at some step. Exact flash launches per rank (tp: 16 / 4 heads a
    rank; pp: a stage's layers per microbatch, the forward twice but on
    the last stage), experts a rank, step ÷ one card's, peak. The studies'
    seconds are held to this phase's budget. Returns rank 0's launches,
    summed over the specs."""
    cards = torch.cuda.device_count()
    not_run = [dict(spec="pp2_tp2_ep2", ran=False, cards_needed=8)] if cards < 8 else []
    if cards < 2:
        emit("dist.moe.mesh", ok=True, ran=False, cards=cards, specs_not_run=not_run, card=card)
        return {}
    specs = [s for s in studies["specs"] if s["phase"] == "dist.moe.mesh"]
    results, cfg = studies["results"], studies["cfg"]
    yardstick = {"ep2_tp2": "tp2", "pp2_ep2": "pp2", "pp2_tp2_ep2": "pp2_tp2"}
    launches = {}
    for spec in specs:
        for name, count in results[spec["key"]][0]["launches"].items():
            launches[name] = launches.get(name, 0) + count
    phase_s = studies["phase_s"]
    spec_s = {s["key"]: results[s["key"]][0]["spec_s"] for s in studies["specs"]}
    flips = {s["key"]: routed_differently(spec_routes(cfg, results[s["key"]], B * studies["seq"]), single["routes"])
             for s in studies["specs"] if s["phase"] != "dist.moe"}
    rows = []
    for spec in specs:
        key, kw, steps = spec["key"], spec["kw"], spec["steps"]
        pp = kw.get("pp", 1)
        for rank, res in enumerate(results[key]):
            if pp > 1:
                per_step = pipe_launches_per_step(cfg.n_layers, pp, res["stage"], res["n_micro"])
            else:
                per_step = moe_launches_per_step(cfg.n_layers)
            expected = {k: (1 + steps) * v for k, v in per_step.items()}
            loss_rel = [_rel(g, w) for g, w in zip(res["losses"], single["losses"])]
            warm = dict(loss_rel=loss_rel[0], grad_norm_rel=_rel(res["first_grad_norm"], single["first_grad_norm"]),
                        aux_abs=abs(res["first_aux_loss"] - single["first_aux_loss"]))
            group_rel = {k: _rel(v, single["group_grad_norms"][k]) for k, v in res["group_grad_norms"].items()
                         if k in single["group_grad_norms"]}
            held = (max(loss_rel) <= TOL_MESH_LOSS_REL and warm["grad_norm_rel"] <= TOL_MESH_GRAD_NORM_REL
                    and warm["aux_abs"] <= TOL_PIPE_AUX_ABS)
            ref = results[yardstick[key]][0] if key in yardstick else None
            ref_loss_rel = ref_norm_rel = None
            if ref is not None:
                ref_loss_rel = max(_rel(g, w) for g, w in zip(res["losses"], ref["losses"]))
                ref_norm_rel = max(_rel(res["first_grad_norm"], ref["first_grad_norm"]),
                                   _rel(res["last_grad_norm"], ref["last_grad_norm"]))
                held = (held and len(res["losses"]) == len(ref["losses"]) and ref_loss_rel <= TOL_MESH_LOSS_REL
                        and ref_norm_rel <= TOL_MESH_GRAD_NORM_REL)
            rows.append(dict(spec=key, rank=rank, stage=res.get("stage"), mesh=res["mesh"],
                             experts=res.get("experts"), losses=res["losses"], warm_up_to_single=warm,
                             loss_rel_to_single=loss_rel, routed_differently=flips[key],
                             loss_rel_to_yardstick=ref_loss_rel, grad_norm_rel_to_yardstick=ref_norm_rel,
                             group_grad_norm_rel=group_rel, grad_norm_count_rel=res["grad_norm_count_rel"],
                             step_ms=res["step_ms"], ratio_to_single=res["step_ms"] / single["step_ms"],
                             peak_gib=res["peak_gib"], state_gib=res["state_gib"],
                             held_before_gib=res["held_before_gib"], launches=res["launches"],
                             expected_launches=expected,
                             ok=held and len(res["losses"]) == steps + 1 and len(flips[key]) == steps + 1
                             and set(group_rel) == set(res["group_grad_norms"]) == set(single["group_grad_norms"])
                             and max(group_rel.values()) <= TOL_MESH_GROUP_NORM_REL
                             and res["grad_norm_count_rel"] <= TOL_GRAD_NORM_COUNT_REL
                             and res["launches"] == expected
                             and res.get("experts") == cfg.n_experts // kw.get("ep", 1) and res["params_on_card"]))
    fault = results["tp2_fault"][0]
    fault_rel = [_rel(g, w) for g, w in zip(fault["losses"], single["losses"])]
    planted = dict(spec="tp2_fault", optimizer="adamw(1e-4) without the expert weights", losses=fault["losses"],
                   loss_rel_to_single=fault_rel, routed_differently=flips["tp2_fault"],
                   caught=max(fault_rel) > TOL_MESH_LOSS_REL)
    from maggy_tpu_torch.parallel import ShardingSpec

    n_ranks = sum(ShardingSpec(**s["kw"]).num_devices for s in specs)
    ok = (len(rows) == n_ranks and all(r["ok"] for r in rows) and planted["caught"]
          and phase_s <= DIST_MOE_MESH_BUDGET_S)
    emit("dist.moe.mesh", ok=ok, ran=True, cards=cards, ranks=rows, planted_fault=planted, specs_not_run=not_run,
         yardsticks=yardstick, microbatches=MOE_MESH_MICRO, steps=MOE_MESH_STEPS, spec_s=spec_s,
         studies_s=studies["study_s"], study_leads=studies["leads"],
         tol=dict(loss_rel=TOL_MESH_LOSS_REL, grad_norm_rel=TOL_MESH_GRAD_NORM_REL, aux_abs=TOL_PIPE_AUX_ABS,
                  group_grad_norm_rel=TOL_MESH_GROUP_NORM_REL, grad_norm_count_rel=TOL_GRAD_NORM_COUNT_REL),
         phase_s=phase_s, budget_s=DIST_MOE_MESH_BUDGET_S, card=card)
    if not ok:
        raise SystemExit("dist.moe.mesh failed: a rank's steps (loss; the warm-up's grad norm, aux loss, gradient "
                         "groups, its trainer's count), its yardstick's steps, its experts or its launches "
                         "disagree, the planted fault went unseen, or the studies ran past the budget")
    return launches


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
    # a crash in native code prints every thread's Python stack first
    faulthandler.enable()
    faulthandler.dump_traceback_later(RUN_DEADLINE_S, exit=True)

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
    train_ref = {}
    launches, train_step_ms, train_peak = phase_train(torch, N_LAYERS, S, TRAIN_STEPS, card, args.profile,
                                                      train_ref)
    # the MoE decoder at Mixtral widths: its forward and cached decode
    # through the flash kernels, its training, then expert parallelism
    # across cards held to that one card's steps
    moe_launches = [phase_moe_model(torch, card)]
    train_launches, moe_single = phase_moe_train(torch, card, args.profile)
    studies = moe_studies(torch)  # dist.moe's and dist.moe.mesh's specs, one study a rank count
    moe_launches += [train_launches, phase_dist_moe(torch, card, moe_single, studies),
                     phase_dist_moe_mesh(torch, card, moe_single, studies)]
    rows.update(phase_ring_kernels(torch))
    phase_ring_model(torch, N_LAYERS, RING_S)
    ring_launches = phase_ring_train(torch, N_LAYERS, RING_S, TRAIN_STEPS, card, args.profile)
    launches.update({k: v for k, v in ring_launches.items() if k.startswith("ring_")})
    phase_ring_dist(torch, N_LAYERS, RING_S, card)

    # serving: the full model, its weights shared by both phases
    import gc

    from maggy_tpu_torch.models import Decoder, DecoderConfig

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    master = Decoder(DecoderConfig.llama3_8b(n_layers=SERVE_LAYERS), device="cuda", generator=gen)
    phase_serve_model(torch, master, card)
    gc.collect()
    torch.cuda.empty_cache()
    requests = engine_requests(torch, master.cfg)
    streams, full, step_ms = phase_serve_engine(torch, master, card, requests)
    # the serving stack over the same weights: the scheduler behind the RPC
    # server, then page pressure with the host tier and the prefill
    # handoff; then the fleet over one copy of the serving weights (the
    # fp32 masters of the projections freed first); then the CLI in its
    # own process, one engine and a fleet, after the weights are gone
    phase_serve_sched(torch, master, card, requests, streams, step_ms)
    phase_serve_tier(torch, master, card, requests, streams)
    from maggy_tpu_torch.serve.engine import serving_state

    serving, cfg = serving_state(master.cfg, master, master.embedding.device), master.cfg
    del master
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_fleet(torch, cfg, serving, card, requests, streams, full, step_ms)
    del serving
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_cli(torch, card)
    phase_serve_cli(torch, card, fleet=(2, 1))
    # the HPO control plane on top: the `train` configuration as two trials
    phase_lagom_train(torch, DecoderConfig.llama3_8b(n_layers=N_LAYERS), S, LAGOM_STEPS, card, train_step_ms)
    # the ablation experiment: BERT-base (BASELINE config 4) and the `train`
    # Decoder as LOCO studies; the Decoder trials' flash launches join the
    # kernels line
    from maggy_tpu_torch.models import BertConfig

    ablation_launches = phase_lagom_ablation(torch, BertConfig.base(), DecoderConfig.llama3_8b(n_layers=N_LAYERS), S,
                                             ABL_DECODER_STEPS, card, train_step_ms)
    # multi-device training: the `train` configuration as one NCCL rank
    # through FSDP2 under lagom(DistributedConfig), then the mesh across cards
    # (dp, fsdp, tp; 2d on four) held to it; their flash launches join the
    # kernels line
    cfg = DecoderConfig.llama3_8b(n_layers=N_LAYERS)
    single = phase_dist_lagom(torch, cfg, S, TRAIN_STEPS, card, train_ref, train_step_ms)
    mesh_launches = phase_dist_mesh(torch, N_LAYERS, S, TRAIN_STEPS, card, single)
    # the seq axis inside the mesh (ring and Ulysses), then ZeRO-1 and the
    # bucketed reduction over data, each rank held to the single rank
    seq_launches = phase_dist_seq(torch, N_LAYERS, S, TRAIN_STEPS, card, single)
    zero_launches = phase_dist_zero(torch, N_LAYERS, S, TRAIN_STEPS, card, single)
    # pipeline stages: the single-stage 1F1B path held to `train`, then the
    # stages across cards held to the single rank
    pipe_launches = phase_dist_pipe(torch, cfg, S, TRAIN_STEPS, card, train_ref, single, train_step_ms)
    # pod mode: the same script in two processes under the launcher, a
    # distributed run restarted after a lost rank, then an HPO study whose
    # worker process is killed and respawned
    pod_launches = phase_pod_elastic(torch, card)
    hpo_launches = phase_pod_hpo(torch, card)
    # elastic membership: a replica's death as a slice drop, then (2+
    # cards) slices dropped and rejoined inside a live NCCL run
    elastic_launches = phase_dist_elastic(torch, card)
    # the rest of the Trainer: checkpoints, the preemption save and resume
    # from sharded data, then the remat policies; their flash launches join
    # the `train` phase's in the kernels line
    for more in (*moe_launches, ablation_launches, single["launches"], mesh_launches, seq_launches, zero_launches,
                 pipe_launches, pod_launches, hpo_launches, elastic_launches,
                 phase_train_resume(torch, DecoderConfig.llama3_8b(n_layers=RESUME_LAYERS), S, card, train_peak,
                                    train_step_ms),
                 phase_train_remat(torch, cfg, S, card)):
        for name, n in more.items():
            launches[name] += n

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
             launches=launches[name],
             **{k: v for k, v in rows[name].items() if k not in ("tflops", "share_of_bound", "ptxas")})
        for name in SOURCES
    ]
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
