"""Continuous-batching decode engine: one decode program, slot-based KV cache.

Counterpart of :mod:`maggy_tpu.serve.engine`, with the method surface its
scheduler calls. The engine owns a fixed-``B`` batch cache whose rows are
*slots* and runs three programs:

* **prefill** — one request's prompt, padded to a power-of-two bucket, runs
  through the cache path straight into its slot's row (a one-row view of the
  batch cache, or of the page pool through the slot's page-table row); the
  first token is sampled from the last valid logit (the request's TTFT
  token), and the slot's write index is pinned to the TRUE prompt length
  (the pad's K/V sit above it, masked until decode overwrites them);
* **admit-from-prefix** — a prompt sharing at least ``prefix_min`` tokens
  with a *resident* slot's prompt (:class:`~maggy_tpu_torch.serve.prefix.
  PrefixIndex`) reuses that slot's K/V: copied rows in dense mode, aliased
  ref-counted pages in paged mode (only a partial boundary page is copied),
  and only the suffix is prefilled;
* **decode step** — one token for every slot under an active mask. Every
  input that varies as requests churn is a same-shape tensor, so the step
  runs at one shape for the life of the engine (``compile_counts``).

Eager PyTorch compiles nothing; ``compile_counts`` counts the distinct input
shapes each program has run at — the set a CUDA-graph capture of the
program would have to hold.

**Sampling.** A request's stream depends only on (params, prompt, seed),
never on its slot or batch-mates: the Gumbel noise for generated token
``i`` and vocab id ``v`` is a fixed integer hash of (seed, i, v) computed on
the device (:func:`sample_rows`), so no generator state exists at all.
``temperature <= 0`` is exact greedy (argmax, first index on ties).

**Paged KV cache** (the default, page 16): a host-side
:class:`~maggy_tpu_torch.serve.paging.BlockAllocator` owns the pool's pages;
a request holds ``ceil(tokens/page_size)`` of them. Pages are copy-on-write
by construction: decode only writes past the prompt into privately owned
tail pages. ``paged=False`` (or ``MAGGY_TPU_SERVE_PAGED=0``) keeps a dense
row per slot; streams are byte-identical either way.

**Async decode** (the default): ``step()`` dispatches decode step ``i+1``
BEFORE host-reading step ``i``'s tokens. Continuing slots take their input
token straight from the in-flight device output, and step ``i``'s tokens
reach the host through a pinned buffer copied right after that step, so the
host waits for step ``i`` only while step ``i+1`` runs. In steady state the
dispatch builds no host array and reads nothing back. The one extra step a
slot decodes before the host learns it finished is discarded at drain.
``async_decode=False`` (or ``MAGGY_TPU_SERVE_ASYNC=0``) is the synchronous
path; streams are byte-identical.

**Weights.** The engine computes with a bf16 copy of every projection
(``Dense``) weight, cast once at construction and at :meth:`reconfigure`:
the same values the model's per-forward cast produces, without re-reading
the fp32 masters on every decoded token. Norm scales and the embedding stay
the fp32 masters (multiplied in fp32, gathered then cast, as before).

**Host-DRAM KV tier** (on by default under a paged cache;
``MAGGY_TPU_SERVE_TIER=0`` turns it off, ``MAGGY_TPU_SERVE_TIER_PAGES`` sizes
it, default twice the pool): a preempted stream's valid pages are spilled
to host memory before its slot is released (:meth:`spill_stream`, a resume
pack) and a released prompt's full pages are kept there as a prefix pack;
admission swaps a matching pack back into fresh pages and prefills only the
suffix. A capture is a gather of the pool on the engine's stream followed by
a copy to the host, so it is ordered after every decode step already
enqueued; a swap-in is an ``index_copy_`` enqueued before the suffix
prefill that reads it.

**Disaggregated prefill**: :meth:`prefill_only` runs one prompt through a
one-row dense cache of its own (slots and pages untouched) and returns its
K/V as CPU tensors; :meth:`admit_from_kv` writes such a pack into a slot
(through fresh pages when paged). A mesh raises (ROADMAP queue 1 item 7g).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from maggy_tpu_torch.exceptions import BadArgumentsError
from maggy_tpu_torch.models.generate import init_cache
from maggy_tpu_torch.models.transformer import Decoder, Dense, KVCache, _read_chunk
from maggy_tpu_torch.serve.paging import BlockAllocator, OutOfPagesError, PageTable
from maggy_tpu_torch.serve.prefix import PrefixIndex
from maggy_tpu_torch.serve.request import Request
from maggy_tpu_torch.serve.slots import SlotManager, SlotOccupiedError
from maggy_tpu_torch.serve.tier import HostPagePool, TieringPolicy
from maggy_tpu_torch.telemetry import NULL, memtrack
from maggy_tpu_torch.util import resolve_device

# fixed-size top-k filter: a request's top_k rides in as a tensor, the kth
# threshold is read from a top-TOPK_CAP sort, keeping the decode step one
# shape for any requested k in [1, TOPK_CAP]
TOPK_CAP = 64

# smallest prefill bucket; prompts shorter than this share one shape
MIN_PREFILL_BUCKET = 8

# default KV page size (tokens) for the paged cache; must divide max_seq_len
DEFAULT_PAGE_SIZE = 16

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 tensors
    holding values in [0, 2^32): every product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, gen_idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """[R, V] fp32 standard Gumbel noise, a pure function of (seed, generated-
    token index, vocab id) per row: the counter-based draw that makes a
    request's samples independent of its slot and batch-mates."""
    s = seeds.long()
    key = _mix32((s & _M32) ^ _mix32((s >> 32) & _M32))
    key = _mix32(key ^ _mix32(gen_idx.long() & _M32))
    ids = _mix32(torch.arange(vocab, device=seeds.device) ^ 0x5851F42D)
    bits = _mix32(key[:, None] ^ ids[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_rows(logits, temp, top_k, seeds, gen_idx) -> torch.Tensor:
    """One token per row from [R, V] logits with per-row temperature and
    (capped) top-k, as the JAX engine's ``_sample_one``: the Gumbel-max draw
    over the temperature-scaled, top-k-filtered logits; ``temp <= 0`` is
    exact argmax and its noise is never used. Returns [R] int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    cap = min(TOPK_CAP, logits.shape[-1])
    top_vals = torch.topk(logits, cap, dim=-1).values  # sorted desc
    kth = top_vals.gather(1, torch.clamp(top_k.long() - 1, 0, cap - 1)[:, None])
    filtered = torch.where((top_k[:, None] > 0) & (logits < kth), float("-inf"), logits)
    scaled = filtered / torch.clamp(temp, min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel_noise(seeds, gen_idx, logits.shape[-1]), dim=-1)
    return torch.where(temp > 0.0, sampled, greedy).to(torch.int32)


def serving_state(cfg, params, device) -> Dict[str, torch.Tensor]:
    """``params`` (a state_dict or a module) on ``device`` with every
    projection weight cast to ``cfg.dtype``; norm scales and the embedding
    stay the fp32 masters themselves, not copies. A state that already is a
    serving state on ``device`` comes back as the same tensors, so engines
    built over it share one copy of the weights."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    meta = Decoder(cfg, device="meta")
    dense = {name + ".weight" for name, mod in meta.named_modules() if isinstance(mod, Dense)}
    state = {}
    for name, t in params.items():
        t = t.to(device)
        state[name] = t.to(cfg.dtype) if name in dense else t
    return state


def serving_model(cfg, params, device) -> Decoder:
    """A ``Decoder`` over :func:`serving_state`'s tensors: projection
    weights cast to ``cfg.dtype`` once, the rest the fp32 masters."""
    model = Decoder(cfg, device="meta")
    model.load_state_dict(serving_state(cfg, params, device), assign=True)
    return model.eval()


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: through pinned
    memory with a non-blocking copy on CUDA (the pinned block is not reused
    before the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _HostCopy:
    """A device tensor's copy on the host, enqueued now and waited for on
    :meth:`numpy`: on CUDA into pinned memory behind an event, so waiting
    for it waits for the work before the copy only."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class StepOutput:
    """One decode step's per-slot results (host-side)."""

    tokens: Dict[int, int]  # slot -> sampled token (active slots only)


class Engine:
    """Slot-based continuous-batching engine over a ``DecoderConfig`` model.

    Synchronous and single-threaded by design: the scheduler serializes all
    calls. ``params`` are the trained weights: a ``Decoder`` or its
    ``state_dict``. ``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` to serve on the CPU.

    ``host_lock`` is held by the scheduler's loop around each pass of
    launches (admissions, the decode step) and by a prefill worker around
    ``prefill_only``. Engines on one card in one process share one, so their
    loops take turns: every PyTorch op releases and retakes the interpreter
    lock, and two decode loops running at once trade it at each of a step's
    thousands of launches. Each engine has its own by default.
    """

    def __init__(
        self,
        cfg,
        params: Any,
        num_slots: int = 4,
        mesh=None,
        telemetry_recorder=None,
        async_decode: Optional[bool] = None,
        prefix_reuse: Optional[bool] = None,
        prefix_min: Optional[int] = None,
        paged: Optional[bool] = None,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        max_pages_per_req: Optional[int] = None,
        tier: Optional[bool] = None,
        tier_host_pages: Optional[int] = None,
        tier_low_water_pct: Optional[float] = None,
        device=None,
        host_lock=None,
    ):
        if cfg.decode:
            raise BadArgumentsError(
                "pass the TRAINING config; the engine builds the decode variant itself"
            )
        if mesh is not None:
            raise NotImplementedError(
                "a sharded engine belongs to the multi-device slice (ROADMAP queue 1 item 7g)"
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card this engine allocates on, named: the scheduler's loop
            # thread makes it current
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.host_lock = host_lock if host_lock is not None else threading.RLock()
        self.cfg = cfg
        self.params = params.state_dict() if isinstance(params, nn.Module) else dict(params)
        self.slots = SlotManager(num_slots)
        self.max_seq_len = int(cfg.max_seq_len)
        self.telemetry = telemetry_recorder or NULL

        if async_decode is None:
            async_decode = os.environ.get("MAGGY_TPU_SERVE_ASYNC", "1").lower() not in ("0", "false", "off")
        self.async_decode = async_decode

        if prefix_reuse is None:
            prefix_reuse = os.environ.get("MAGGY_TPU_SERVE_PREFIX", "1").lower() not in ("0", "false", "off")
        self.prefix_reuse = prefix_reuse
        if prefix_min is None:
            prefix_min = int(os.environ.get("MAGGY_TPU_SERVE_PREFIX_MIN", MIN_PREFILL_BUCKET))
        self.prefix_min = max(1, int(prefix_min))
        self.prefix_index = PrefixIndex(min_len=self.prefix_min)
        # prefix-reuse accounting
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.prefill_calls = 0  # full (from-scratch) prefills
        # prompt tokens ACTUALLY computed by prefill (suffix-only on a hit)
        self.prefill_tokens = 0

        # ---- paged KV cache
        if paged is None:
            paged = os.environ.get("MAGGY_TPU_SERVE_PAGED", "1").lower() not in ("0", "false", "off")
        self.paged = bool(paged)
        if page_size is None:
            page_size = int(os.environ.get("MAGGY_TPU_SERVE_PAGE_SIZE", DEFAULT_PAGE_SIZE))
        self.page_size = max(1, int(page_size))
        while self.max_seq_len % self.page_size:
            # any max_seq_len is served: fall back to the largest divisor
            self.page_size //= 2
        self.pages_per_row = self.max_seq_len // self.page_size
        # the pool defaults to the dense capacity (num_slots full rows) plus
        # the scratch page; pass num_pages to run under the dense budget
        self._num_pages_explicit = num_pages is not None
        self.num_pages = int(num_pages) if num_pages is not None else num_slots * self.pages_per_row + 1
        self.max_pages_per_req = min(
            self.pages_per_row,
            int(max_pages_per_req) if max_pages_per_req is not None else self.pages_per_row,
        )
        self.pages_aliased = 0  # cumulative pages shared instead of copied
        self._last_page_gauges = None
        # per-slot high-water page count while resident (cleared in release)
        self._peak_pages: Dict[int, int] = {}

        # ---- host-DRAM KV tier: a paged-cache feature, off in dense mode
        if tier is None:
            tier = os.environ.get("MAGGY_TPU_SERVE_TIER", "1").lower() not in ("0", "false", "off")
        self._tier_pages_explicit = tier_host_pages is not None
        if self.paged and tier:
            if tier_host_pages is None:
                tier_host_pages = int(os.environ.get("MAGGY_TPU_SERVE_TIER_PAGES", 2 * self.num_pages))
            self.tier = HostPagePool(int(tier_host_pages), telemetry_recorder=self.telemetry,
                                     pin_memory=self.device.type == "cuda")
            self.tier_policy = (TieringPolicy(low_water_pct=float(tier_low_water_pct))
                                if tier_low_water_pct is not None else TieringPolicy())
        else:
            self.tier = None
            self.tier_policy = None

        # distinct input shapes per program (see compile_counts)
        self._shapes: Dict[str, set] = {"decode": set(), "prefill": set(), "admit": set(), "prefix_admit": set()}
        self._last_compile_gauges = None
        # the logits the last admission sampled its first token from ([V] fp32)
        self.last_admit_logits: Optional[torch.Tensor] = None
        # last async-drain host cost
        self.last_drain_ms = 0.0
        self.steps = 0
        self.tokens_out = 0
        self.memory = memtrack.MemoryLedger()
        self.model = None
        self.cache = None
        self._build(num_slots)

    def _build(self, num_slots: int) -> None:
        """(Re)build the serving weights, the batch cache and the per-slot
        device state for ``num_slots`` rows, freeing the old ones first."""
        self.model = self.cache = None
        B = num_slots
        self.model = serving_model(self.cfg, self.params, self.device)
        self.decode_cfg = dataclasses.replace(
            self.cfg, decode=True, paged=self.paged, page_size=self.page_size,
            num_pages=self.num_pages if self.paged else 0,
        )
        if self.paged:
            self.allocator = BlockAllocator(self.num_pages, self.page_size)
            self.page_table = PageTable(B, self.pages_per_row)
        else:
            self.allocator = None
            self.page_table = None
        self.cache = init_cache(self.decode_cfg, torch.zeros((B, 1), dtype=torch.int32, device=self.device))
        self._push_page_table()
        # per-slot request seeds (the sampler's counter base)
        self.seeds = torch.zeros((B,), dtype=torch.int64, device=self.device)
        self._zero_tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        # async double buffer: the dispatched-but-undrained decode step
        self._pending: Optional[Dict[str, Any]] = None
        self._register_memory_accounts()

    def _register_memory_accounts(self) -> None:
        """(Re)register this engine's ledger accounts from live tensor sizes:
        the fp32 masters plus the bf16 serving copy, the KV cache, and the
        per-slot workspace (idempotent: no double counting)."""
        self.memory.register("params", memtrack.array_bytes([self.params, self.model.state_dict()]))
        cache_bytes = memtrack.array_bytes(self.cache)
        self.memory.register("kv_pages", cache_bytes)
        self.memory.register("workspace", memtrack.array_bytes([self.seeds, self._zero_tokens]))
        cap_tokens = self.num_pages * self.page_size if self.paged else self.slots.num_slots * self.max_seq_len
        self.prefix_index.bytes_per_token = max(1, cache_bytes // max(1, cap_tokens))

    def _note_shape(self, program: str, shape) -> None:
        self._shapes[program].add(tuple(shape))

    def _row_shape(self):
        """What admission writes a slot through: its dense K row, or its
        page-table row."""
        return (1, self.pages_per_row) if self.paged else tuple(self.cache.k[:, :1].shape)

    def _scalars(self, temp: float, top_k: int, seed: int, gen0: int):
        dev = self.device
        return (torch.tensor([temp], dtype=torch.float32, device=dev),
                torch.tensor([top_k], dtype=torch.int32, device=dev),
                torch.tensor([_seed64(seed)], dtype=torch.int64, device=dev),
                torch.tensor([gen0], dtype=torch.int32, device=dev))

    # ------------------------------------------------------------ programs

    def _prefill_row(self, slot: int, tokens: np.ndarray, start: int, plen: int, p, gen0: int):
        """Run ``tokens`` [1, bucket] (positions ``start..``) through slot
        ``slot``'s row, whose cache length is ``start``; pin the row's length
        to ``plen`` and sample the first token from the logit at ``plen-1``.
        Returns the token as a [1] device tensor."""
        self.seeds[slot] = _seed64(p.seed)
        return self._prefill_into(self.cache.row(slot), tokens, start, plen, p, gen0)

    def _prefill_into(self, row: KVCache, tokens: np.ndarray, start: int, plen: int, p, gen0: int):
        """:meth:`_prefill_row` through any one-row cache ``row``."""
        bucket = tokens.shape[1]
        row.index.fill_(start)
        positions = torch.arange(start, start + bucket, dtype=torch.int32, device=self.device)[None]
        logits = self.model(_to_device(tokens, self.device), positions, cache=row, kv_len=start + bucket)
        row.index.fill_(plen)
        # the logit that predicts the next generated token (a copy: the
        # bucket's other logits are freed)
        last = logits[0, plen - start - 1].clone()
        self.last_admit_logits = last
        temp, top_k, seed, g = self._scalars(p.temperature, p.top_k, p.seed, gen0)
        return sample_rows(last[None], temp, top_k, seed, g)

    def _decode(self, prev_tokens, host_tokens, use_prev, pos, active, temp, top_k, gen_idx, kv_len: int):
        """One token for every slot; inactive rows run masked, and their
        cache index is reset to 0 afterwards so they never inflate the read
        bound or run past max_seq_len. Rows with ``use_prev`` take the
        previous dispatch's on-device token (the async double buffer); the
        rest take ``host_tokens``."""
        self._note_shape("decode", pos.shape)
        tokens = torch.where(use_prev, prev_tokens, host_tokens)
        logits = self.model(tokens[:, None], pos[:, None], cache=self.cache, kv_len=kv_len)
        sampled = sample_rows(logits[:, 0], temp, top_k, self.seeds, gen_idx)
        sampled = torch.where(active, sampled, 0)
        self.cache.index.masked_fill_(~active, 0)
        # advanced coordinates for the steady-state async fast path: while the
        # slot set is unchanged, the next dispatch reuses these device tensors
        next_pos = torch.where(active, pos + 1, pos)
        next_gen = torch.where(active, gen_idx + 1, gen_idx)
        return sampled, next_pos, next_gen

    # -------------------------------------------------------------- admission

    def _bucket(self, plen: int) -> int:
        b = MIN_PREFILL_BUCKET
        while b < plen:
            b *= 2
        return min(b, self.max_seq_len)

    def admit(self, request: Request) -> Tuple[int, int]:
        """Prefill ``request``'s prompt and claim a free slot for it.

        Returns ``(slot, first_token)`` — the first token IS the TTFT token,
        produced here, not in the decode loop. Raises
        :class:`SlotOccupiedError` when no slot is free,
        :class:`OutOfPagesError` when the paged pool cannot hold the prompt
        (the scheduler's cue to wait or preempt — never a failed request),
        and :class:`BadArgumentsError` when the request cannot fit at all.

        A request carrying generated tokens is a PREEMPTED request being
        re-admitted: the effective prompt is prompt+tokens and the sampling
        chain resumes at ``gen0 = len(tokens)``, so the continued stream is
        byte-identical to one that was never preempted.
        """
        prompt = [int(t) for t in request.prompt] + [int(t) for t in request.tokens]
        gen0 = len(request.tokens)
        plen = len(prompt)
        p = request.params
        if len(request.prompt) < 1:
            raise BadArgumentsError("empty prompt")
        if len(request.prompt) + p.max_new > self.max_seq_len:
            raise BadArgumentsError(
                f"prompt ({len(request.prompt)}) + max_new ({p.max_new}) "
                f"exceeds max_seq_len ({self.max_seq_len})"
            )
        if not self.slots.free_slots():
            raise SlotOccupiedError("no free slot")
        if self.paged:
            worst = -(-(len(request.prompt) + p.max_new) // self.page_size)
            cap = min(self.max_pages_per_req, self.allocator.pages_total)
            if worst > cap:
                raise BadArgumentsError(
                    f"request needs up to {worst} pages "
                    f"(page_size {self.page_size}) > cap {cap} "
                    "(max_pages_per_req / pool size)"
                )
        slot = self.slots.free_slots()[0]
        reuse = self._match_prefix(prompt)
        with torch.no_grad():
            tok = None
            if self.tier is not None:
                tok = self._try_tier_admit(prompt, p, slot, gen0, reuse, request)
            if tok is None and self.paged:
                tok = self._admit_paged(prompt, p, slot, gen0, reuse)
            elif tok is None:
                tok = self._admit_dense(prompt, p, slot, gen0, reuse)
        # claim the slot only after every device op succeeded — a throwing
        # prefill must not leak an occupied slot bound to a dead request
        first = int(tok)
        if self.slots.admit(request, first, next_pos=plen, generated=gen0 + 1) != slot:
            raise RuntimeError("slot bookkeeping diverged from the engine's choice")
        self.prefix_index.insert(slot, prompt, gen=self.steps)
        self.tokens_out += 1
        self._record_compile_gauges()
        return slot, first

    def _padded(self, tokens: List[int], bucket: int) -> np.ndarray:
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(tokens)] = tokens
        return padded

    def _admit_dense(self, prompt, p, slot, gen0, reuse):
        """Dense-mode admission: prefill into the slot's row; on a prefix hit
        the source row's shared K/V are copied in first and only the suffix
        runs."""
        plen = len(prompt)
        if reuse is not None:
            src, shared = reuse
            # the suffix bucket must still fit above the shared rows, so the
            # row write is never position-clamped
            bucket = min(self._bucket(plen - shared), self.max_seq_len - shared)
            with self.telemetry.span("serve.prefix_admit", bucket=bucket, shared=shared):
                self._note_shape("prefix_admit", (1, bucket))
                self._note_shape("admit", self._row_shape())
                for buf in (self.cache.k, self.cache.v):
                    buf[:, slot, :shared] = buf[:, src, :shared]
                tok = self._prefill_row(slot, self._padded(prompt[shared:], bucket), shared, plen, p, gen0)
            self._note_prefix_hit(shared, 0)
            self.prefill_tokens += plen - shared
        else:
            bucket = self._bucket(plen)
            with self.telemetry.span("serve.prefill", bucket=bucket):
                self._note_shape("prefill", (1, bucket))
                self._note_shape("admit", self._row_shape())
                tok = self._prefill_row(slot, self._padded(prompt, bucket), 0, plen, p, gen0)
            self.prefill_calls += 1
            self.prefill_tokens += plen
        return tok

    def _admit_paged(self, prompt, p, slot, gen0, reuse):
        """Paged admission: allocate the prompt's pages (aliasing the shared
        full pages on a prefix hit, the partial boundary page copied into a
        fresh one), point the slot's page-table row at them, and prefill
        through it (suffix-only on a hit). Pad positions past the prompt's
        pages land on the scratch page. Allocation and the table row are
        rolled back if any device op throws, so a poison request leaks
        nothing."""
        plen = len(prompt)
        P = self.page_size
        n_prompt_pages = -(-plen // P)
        if reuse is not None:
            src, shared = reuse
            src_pages = self.page_table.pages(src)
            shared_full = min(shared // P, len(src_pages), n_prompt_pages)
            fresh = self.allocator.alloc(n_prompt_pages - shared_full)
            aliased = src_pages[:shared_full]
            try:
                self.allocator.share(aliased)
            except Exception:
                self.allocator.release(fresh)
                raise
            page_list = aliased + fresh
            bucket = min(self._bucket(plen - shared), self.max_seq_len - shared)
            span = self.telemetry.span("serve.prefix_admit", bucket=bucket, shared=shared)
            program, start, tokens = "prefix_admit", shared, prompt[shared:]
            boundary = (src_pages[shared_full], fresh[0]) if shared % P else None
        else:
            page_list = self.allocator.alloc(n_prompt_pages)
            bucket = self._bucket(plen)
            span = self.telemetry.span("serve.prefill", bucket=bucket)
            program, start, tokens, boundary = "prefill", 0, prompt, None
        self.page_table.assign(slot, page_list)
        try:
            with span:
                self._note_shape(program, (1, bucket))
                self._note_shape("admit", self._row_shape())
                if boundary is not None:
                    # copy-on-write of the partial page the prefix ends in
                    for buf in (self.cache.k, self.cache.v):
                        buf[:, boundary[1]] = buf[:, boundary[0]]
                self._push_page_table()
                tok = self._prefill_row(slot, self._padded(tokens, bucket), start, plen, p, gen0)
        except Exception:
            self.page_table.clear(slot)
            self._push_page_table()
            self.allocator.release(page_list)
            raise
        if reuse is not None:
            self._note_prefix_hit(shared, shared_full)
            self.prefill_tokens += plen - shared
        else:
            self.prefill_calls += 1
            self.prefill_tokens += plen
        self.allocator.touch(page_list, self.steps)
        self._peak_pages[slot] = len(page_list)
        self._pages_gauges()
        return tok

    def _note_prefix_hit(self, shared: int, shared_full_pages: int) -> None:
        self.prefix_hits += 1
        self.prefix_tokens_saved += shared
        self.pages_aliased += shared_full_pages
        self.telemetry.count("serve.prefix_hits")
        self.telemetry.count("serve.prefix_tokens_saved", shared)

    def _match_prefix(self, prompt) -> Optional[Tuple[int, int]]:
        """``(src_slot, shared_len)`` when a resident slot shares a usable
        prefix with ``prompt``. The shared length is clamped to ``plen - 1``:
        at least one suffix token must run through the model to produce the
        logit that samples the request's first token."""
        if not self.prefix_reuse:
            return None
        m = self.prefix_index.match(prompt, gen=self.steps)
        if m is None:
            return None
        src, lcp = m
        shared = min(lcp, len(prompt) - 1)
        if shared < self.prefix_min:
            return None
        return src, shared

    # ------------------------------------------------- host-DRAM KV tier

    def _tier_capture_pages(self, page_ids) -> Dict[str, torch.Tensor]:
        """The pool pages ``page_ids`` as one ``[n, L, P, Kh, D]`` stack per
        cache leaf, gathered on the engine's stream (so after every step
        already enqueued); the host pool copies them out."""
        ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long, device=self.device)
        return {name: buf.index_select(1, ids).movedim(1, 0).contiguous()
                for name, buf in (("k", self.cache.k), ("v", self.cache.v))}

    def _tier_write_pages(self, page_ids, blocks) -> None:
        """Scatter host page blocks back into the pool at ``page_ids`` — the
        inverse of :meth:`_tier_capture_pages`, enqueued before the suffix
        prefill that reads them."""
        ids = torch.tensor([int(p) for p in page_ids], dtype=torch.long, device=self.device)
        for name, buf in (("k", self.cache.k), ("v", self.cache.v)):
            b = blocks[name].to(self.device, non_blocking=True)
            buf.index_copy_(1, ids, b.movedim(0, 1).to(buf.dtype))

    def spill_stream(self, slot: int, pressure: bool = False) -> bool:
        """Capture a resident stream's valid KV pages into the host tier as a
        resume pack (``rid:<id>``) — the scheduler calls this immediately
        BEFORE preempt-releasing the slot, so re-admission becomes a swap-in
        instead of a full re-prefill. Valid rows are ``[0, len(prompt+tokens)
        - 1)``: prefill wrote the prompt's rows, each drained decode step
        wrote one more, and the newest sampled token was never fed back —
        exactly the rows re-prefill would recompute. False (no side effects)
        when the tier is off, the slot is empty, or the pack does not fit the
        host budget."""
        if self.tier is None:
            return False
        st = self.slots.get(slot)
        if st is None:
            return False
        tokens = [int(t) for t in st.request.prompt] + [int(t) for t in st.request.tokens]
        valid = len(tokens) - 1
        if valid < 1:
            return False
        pages = self.page_table.pages(slot)
        need = (valid - 1) // self.page_size + 1
        if len(pages) < need:
            return False
        t0 = time.perf_counter()
        with torch.no_grad():
            blocks = self._tier_capture_pages(pages[:need])
        ok = self.tier.put(f"rid:{st.request.id}", blocks,
                           {"tokens": tuple(tokens), "valid": valid, "kind": "resume"})
        if ok:
            self.tier_policy.note_spill(need, pressure=pressure)
            self.telemetry.count("tier.spills")
            self.telemetry.count("tier.spilled_pages", need)
            if pressure:
                self.telemetry.count("tier.pressure_spills")
            self.telemetry.histogram("tier.spill_ms", (time.perf_counter() - t0) * 1e3)
        return ok

    def _spill_prefix(self, slot: int) -> None:
        """On release, park the departing prompt's full KV pages in the host
        tier as a prefix pack (``px:<digest>``) so a later request sharing
        the prefix swaps it in instead of re-prefilling — prefix reuse that
        survives eviction. Gated to prompts of at least one full page."""
        if self.tier is None:
            return
        prompt = self.prefix_index.resident().get(slot)
        if not prompt:
            return
        prompt = tuple(int(t) for t in prompt)
        if len(prompt) < self.page_size:
            return  # under one page: re-prefill beats a pack round trip
        pages = self.page_table.pages(slot)
        valid = min(len(prompt), len(pages) * self.page_size)
        if valid < self.page_size:
            return
        need = (valid - 1) // self.page_size + 1
        t0 = time.perf_counter()
        with torch.no_grad():
            blocks = self._tier_capture_pages(pages[:need])
        if self.tier.put(f"px:{PrefixIndex.digest(prompt)}", blocks,
                         {"tokens": prompt, "valid": valid, "kind": "prefix"}):
            self.tier_policy.note_spill(need, prefix=True)
            self.telemetry.count("tier.spills")
            self.telemetry.count("tier.prefix_spills")
            self.telemetry.count("tier.spilled_pages", need)
            self.telemetry.histogram("tier.spill_ms", (time.perf_counter() - t0) * 1e3)

    def _try_tier_admit(self, prompt, p, slot, gen0, reuse, request):
        """Tier-first admission: a resume pack (exact token match on this
        request's id) wins outright; otherwise a prefix pack is used only
        when it covers MORE shared tokens than the device-resident prefix
        index would. Returns the first sampled token, or None to fall through
        to the normal admit paths."""
        plen = len(prompt)
        if gen0 > 0:
            key = f"rid:{request.id}"
            got = self.tier.get(key) if self.tier.has(key) else None
            if got is not None:
                blocks, meta = got
                start = int(meta.get("valid", 0))
                if (meta.get("kind") == "resume" and tuple(meta.get("tokens", ())) == tuple(prompt)
                        and 1 <= start <= plen - 1):
                    t0 = time.perf_counter()
                    tok = self._tier_admit(prompt, p, slot, gen0, blocks, start, resume=True)
                    self.tier.drop(key)  # one resume per preemption
                    n = next(iter(blocks.values())).shape[0]
                    self.tier_policy.note_fill(n)
                    self.telemetry.count("tier.fills")
                    self.telemetry.count("tier.filled_pages", n)
                    self.telemetry.histogram("tier.swap_in_ms", (time.perf_counter() - t0) * 1e3)
                    self.prefill_tokens += plen - start
                    return tok
                self.tier.drop(key)  # stale pack: request state moved on
        if not self.prefix_reuse or plen - 1 < self.prefix_min:
            return None
        key = f"px:{PrefixIndex.digest(prompt)}"
        got = self.tier.get(key) if self.tier.has(key) else None
        if got is None:
            return None
        blocks, meta = got
        shared = 0
        for a, b in zip(tuple(meta.get("tokens", ())), prompt):
            if a != b:
                break
            shared += 1
        shared = min(shared, int(meta.get("valid", 0)), plen - 1)
        dev_shared = reuse[1] if reuse is not None else 0
        if shared < self.prefix_min or shared <= dev_shared:
            return None  # digest collision, or device-resident reuse is better
        t0 = time.perf_counter()
        cover = (shared - 1) // self.page_size + 1
        tok = self._tier_admit(prompt, p, slot, gen0, {ks: a[:cover] for ks, a in blocks.items()}, shared)
        self.tier_policy.note_fill(cover, prefix=True)
        self.telemetry.count("tier.fills")
        self.telemetry.count("tier.prefix_fills")
        self.telemetry.count("tier.filled_pages", cover)
        self.telemetry.histogram("tier.swap_in_ms", (time.perf_counter() - t0) * 1e3)
        self.prefill_tokens += plen - shared
        self._note_prefix_hit(shared, 0)
        return tok

    def _tier_admit(self, prompt, p, slot, gen0, blocks, start, resume=False):
        """Shared restore path for both pack kinds: write the pack's pages
        into freshly allocated pool pages, point the slot's page-table row at
        them, and run ONLY the suffix (positions ``start..plen``): the
        restored rows are the original computation's own bytes, and the
        suffix write leaves the boundary page's rows below ``start`` as
        restored. A prefix pack's suffix runs through the prefix-admit path;
        a resume pack's suffix, the one token sampled but never fed back,
        runs through :meth:`_resume_row` at the decode step's shape, so the
        resumed stream is the uninterrupted one bit for bit."""
        plen = len(prompt)
        P = self.page_size
        cover = (start - 1) // P + 1
        fresh = self.allocator.alloc(-(-plen // P))
        bucket = 1 if resume else min(self._bucket(plen - start), self.max_seq_len - start)
        self.page_table.assign(slot, fresh)
        try:
            with self.telemetry.span("serve.prefix_admit", bucket=bucket, shared=start):
                self._note_shape("admit", self._row_shape())
                self._tier_write_pages(fresh[:cover], {ks: a[:cover] for ks, a in blocks.items()})
                self._push_page_table()
                if resume:
                    tok = self._resume_row(slot, prompt[-1], start, p, gen0)
                else:
                    self._note_shape("prefix_admit", (1, bucket))
                    tok = self._prefill_row(slot, self._padded(prompt[start:], bucket), start, plen, p, gen0)
        except Exception:
            self.page_table.clear(slot)
            self._push_page_table()
            self.allocator.release(fresh)
            raise
        self.allocator.touch(fresh, self.steps)
        self._peak_pages[slot] = len(fresh)
        self._pages_gauges()
        return tok

    def _resume_row(self, slot: int, token: int, pos: int, p, gen0: int):
        """Feed one token at ``pos`` through slot ``slot``'s row with the
        decode step's own shapes: a batch of every slot, the others reading
        and writing only the scratch page. A decode row's result depends on
        its own inputs only, so the token's K/V and logits are the bytes the
        uninterrupted decode step would have produced, and so is the token
        sampled from them (a one-token prefill runs other matmul shapes,
        whose low bits differ on a card). Pins the row's length to
        ``pos + 1``; returns the sampled token as a [1] device tensor."""
        B, dev = self.slots.num_slots, self.device
        pick = torch.arange(B, device=dev) == slot
        tokens = torch.where(pick, token, 0).to(torch.int32)
        pos_b = torch.where(pick, pos, 0).to(torch.int32)
        pages = torch.where(pick[:, None], self.cache.pages, 0)
        view = KVCache(self.cache.k, self.cache.v, pos_b.clone(), pages)
        self._note_shape("decode", pos_b.shape)
        logits = self.model(tokens[:, None], pos_b[:, None], cache=view, kv_len=pos + 1)
        self.cache.index[slot] = pos + 1
        self.seeds[slot] = _seed64(p.seed)
        temp = torch.where(pick, float(p.temperature), 0.0)
        top_k = torch.where(pick, int(p.top_k), 0).to(torch.int32)
        gen = torch.where(pick, gen0, 0).to(torch.int32)
        self.last_admit_logits = logits[slot, 0].clone()
        return sample_rows(logits[:, 0], temp, top_k, self.seeds, gen)[slot:slot + 1]

    # ------------------------------------------------- disaggregated prefill

    def _handoff_len(self, bucket: int) -> int:
        """Rows of :meth:`prefill_only`'s one-row cache: the bucket rounded up
        to the batch cache's read chunk, so the prefill reads its K/V in the
        same chunks (and so the same bits) as a prefill through a slot."""
        chunk = _read_chunk(self.cfg.decode_chunk, self.max_seq_len)
        if self.paged:
            chunk = max(1, chunk // self.page_size) * self.page_size
        s = min(self.max_seq_len, -(-bucket // chunk) * chunk)
        return s if _read_chunk(self.cfg.decode_chunk, s) == chunk else self.max_seq_len

    def prefill_only(self, prompt: List[int], params, gen0: int = 0) -> Dict[str, Any]:
        """The prefill half of disaggregated serving: run one prompt through
        a one-row dense cache of its own — slots, batch cache and page pool
        untouched — and return a host-resident pack: the row's K/V as CPU
        tensors ``k``/``v`` ``[L, plen, Kh, D]`` in the cache dtype, ``plen``
        and the sampled ``first`` token. The stream a pack admits is the one
        :meth:`admit` gives: prefill is a pure function of (params, prompt,
        seed) and the host round trip keeps every bit."""
        prompt = [int(t) for t in prompt]
        plen = len(prompt)
        if plen < 1:
            raise BadArgumentsError("empty prompt")
        if plen >= self.max_seq_len:
            raise BadArgumentsError(f"prompt ({plen}) exceeds max_seq_len ({self.max_seq_len})")
        bucket = self._bucket(plen)
        cfg = self.cfg
        shape = (cfg.n_layers, 1, self._handoff_len(bucket), cfg.n_kv_heads, cfg.head_dim)
        dev = self.device
        row = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev), torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      torch.zeros((1,), dtype=torch.int32, device=dev))
        with self.telemetry.span("serve.prefill", bucket=bucket), torch.no_grad():
            self._note_shape("prefill", (1, bucket))
            tok = self._prefill_into(row, self._padded(prompt, bucket), 0, plen, params, gen0)
            pack = {"k": row.k[:, 0, :plen].cpu(), "v": row.v[:, 0, :plen].cpu(), "plen": plen, "first": int(tok)}
        self.prefill_calls += 1
        self.prefill_tokens += plen
        self._record_compile_gauges()
        return pack

    def admit_from_kv(self, request: Request, pack: Dict[str, Any]) -> Tuple[int, int]:
        """Admit a request whose prompt :meth:`prefill_only` already ran: the
        pack's rows go back to the device and into a slot's row (through
        fresh pages in paged mode) — no model forward runs here for the
        prompt. Returns ``(slot, first_token)``; the first token was sampled
        at prefill time and rides in the pack."""
        p = request.params
        plen = int(pack["plen"])
        if request.tokens or plen != len(request.prompt):
            raise BadArgumentsError("KV pack does not match the request state (stale handoff)")
        if plen + p.max_new > self.max_seq_len:
            raise BadArgumentsError(
                f"prompt ({plen}) + max_new ({p.max_new}) exceeds max_seq_len ({self.max_seq_len})"
            )
        if not self.slots.free_slots():
            raise SlotOccupiedError("no free slot")
        slot = self.slots.free_slots()[0]
        with self.telemetry.span("serve.kv_admit", plen=plen), torch.no_grad():
            self._note_shape("admit", self._row_shape())
            k = pack["k"].to(self.device, non_blocking=True)
            v = pack["v"].to(self.device, non_blocking=True)
            if self.paged:
                P = self.page_size
                worst = -(-(plen + p.max_new) // P)
                cap = min(self.max_pages_per_req, self.allocator.pages_total)
                if worst > cap:
                    raise BadArgumentsError(f"request needs up to {worst} pages > cap {cap}")
                n = -(-plen // P)
                fresh = self.allocator.alloc(n)
                self.page_table.assign(slot, fresh)
                try:
                    ids = torch.tensor(fresh, dtype=torch.long, device=self.device)
                    for buf, rows in ((self.cache.k, k), (self.cache.v, v)):
                        paged = buf.new_zeros((buf.shape[0], n * P) + tuple(buf.shape[3:]))
                        paged[:, :plen] = rows
                        buf.index_copy_(1, ids, paged.view(buf.shape[0], n, P, *buf.shape[3:]))
                    self._push_page_table()
                except Exception:
                    self.page_table.clear(slot)
                    self._push_page_table()
                    self.allocator.release(fresh)
                    raise
                self.allocator.touch(fresh, self.steps)
                self._peak_pages[slot] = n
                self._pages_gauges()
            else:
                self.cache.k[:, slot, :plen] = k
                self.cache.v[:, slot, :plen] = v
            self.cache.index[slot] = plen
            self.seeds[slot] = _seed64(p.seed)
        first = int(pack["first"])
        if self.slots.admit(request, first) != slot:
            raise RuntimeError("slot bookkeeping diverged from the engine's choice")
        self.prefix_index.insert(slot, [int(t) for t in request.prompt], gen=self.steps)
        self.tokens_out += 1
        self._record_compile_gauges()
        return slot, first

    # ------------------------------------------------------------ lifecycle

    def reconfigure(self, num_slots: int) -> None:
        """Drain-and-reconfigure seam: rebuild the slot geometry with
        ``num_slots`` rows. Must be called with NO active slots; resident
        prefix anchors are dropped with the old cache, the serving weights
        are cast again from the masters, and one all-inactive decode step
        runs at the new shape."""
        num_slots = int(num_slots)
        if num_slots < 1:
            raise BadArgumentsError(f"num_slots must be >= 1, got {num_slots}")
        if self.slots.active_count:
            raise SlotOccupiedError(
                f"reconfigure with {self.slots.active_count} active slot(s); drain first"
            )
        self.flush()
        if num_slots == self.slots.num_slots:
            return
        B = num_slots
        self.slots = SlotManager(B)
        self.prefix_index = PrefixIndex(min_len=self.prefix_min)
        if self.paged and not self._num_pages_explicit:
            # the pool scales with the slot count unless the operator pinned
            # an explicit page budget
            self.num_pages = B * self.pages_per_row + 1
        if self.tier is not None and not self._tier_pages_explicit:
            # the host tier survives reconfigure (block shapes depend only on
            # page_size, prefix packs are content-addressed); an un-pinned
            # budget tracks the new pool size
            self.tier.set_capacity(2 * self.num_pages)
        self._last_page_gauges = None
        self._peak_pages = {}
        with self.telemetry.span("serve.reconfigure", num_slots=B), torch.no_grad():
            self._build(B)
            zeros_i = torch.zeros((B,), dtype=torch.int32, device=self.device)
            no = torch.zeros((B,), dtype=torch.bool, device=self.device)
            self._decode(zeros_i, zeros_i, no, zeros_i, no,
                         torch.zeros((B,), dtype=torch.float32, device=self.device), zeros_i, zeros_i, kv_len=1)
        self._record_compile_gauges()

    def release(self, slot: int) -> Request:
        """Free a slot (EOS / max_new / cancel / deadline / preempt). THE
        one cache-resource release seam: pages and the prefix anchor are
        returned here on every exit path. Host-side only: the decode step
        zeroes inactive rows' index, a cleared row's paged writes land on
        the scratch page, and admission overwrites what it reads."""
        if self.paged:
            if self.tier is not None:
                try:
                    self._spill_prefix(slot)
                except Exception:  # noqa: BLE001 - best-effort: a failed spill never blocks release
                    pass
            pages = self.page_table.clear(slot)
            if pages:
                self.allocator.release(pages)
            self._peak_pages.pop(slot, None)
            self._pages_gauges()
        self.prefix_index.remove(slot)
        return self.slots.evict(slot)

    def pages_held_peak(self, slot: int) -> int:
        """High-water page count of the request resident in ``slot`` (0 in
        dense mode). Read BEFORE :meth:`release`."""
        return self._peak_pages.get(slot, 0)

    # ------------------------------------------------------------ page growth

    def _lag(self, slot: int, st) -> int:
        """1 when ``slot`` still holds the request it held at the undrained
        previous dispatch (one token of it is in flight), else 0."""
        prev = self._pending
        return int(self.async_decode and prev is not None and prev["slots"].get(slot) == st.request.id)

    def prepare_step(self) -> List[int]:
        """Paged only: make sure every active row owns the page its next
        write lands in. Returns the slots whose growth the allocator refused
        — the scheduler preempts and retries; an empty list means
        :meth:`step` is safe to dispatch. Dense mode returns ``[]``."""
        if not self.paged:
            return []
        needy: List[int] = []
        P = self.page_size
        grew = False
        for s in self.slots.active_slots():
            st = self.slots.get(s)
            need = (st.next_pos + self._lag(s, st)) // P + 1
            while self.page_table.count(s) < need:
                try:
                    page = self.allocator.alloc(1)[0]
                except OutOfPagesError:
                    needy.append(s)
                    break
                self.page_table.grow(s, page)
                grew = True
            held = self.page_table.count(s)
            if held > self._peak_pages.get(s, 0):
                self._peak_pages[s] = held
            self.allocator.touch(self.page_table.pages(s), self.steps)
        if grew:
            self._pages_gauges()
        return needy

    def _push_page_table(self) -> None:
        """Copy the host page-table mirror into the cache's table when
        admission, release or growth dirtied it; the steady-state decode
        path transfers nothing."""
        if not self.paged or not self.page_table.dirty:
            return
        self.cache.pages.copy_(_to_device(self.page_table.table, self.device), non_blocking=True)
        self.page_table.dirty = False

    def _pages_gauges(self) -> None:
        a = self.allocator
        vals = (a.pages_free, a.pages_shared)
        if vals != self._last_page_gauges:
            self._last_page_gauges = vals
            self.telemetry.gauge("serve.pages_free", a.pages_free)
            self.telemetry.gauge("serve.pages_shared", a.pages_shared)

    # ----------------------------------------------------------------- decode

    def step(self) -> StepOutput:
        """Decode one token for every active slot.

        Synchronous mode returns THIS dispatch's tokens. Async mode (the
        default) returns the PREVIOUS dispatch's tokens — the new dispatch is
        issued first (its inputs chain from the in-flight device output), so
        the host-side drain below overlaps device compute. With all slots
        free this degenerates to :meth:`flush`.
        """
        if not self.slots.active_slots():
            return self.flush()
        prev, dispatched = self._dispatch()
        if not self.async_decode:
            return self._drain(dispatched)
        self._pending = dispatched
        # drain the PREVIOUS step while this one runs on the device
        return self._drain(prev)

    def _dispatch(self):
        """The dispatch half of :meth:`step`: page growth, the step's inputs
        and the decode program, enqueued without waiting for the device.
        Returns ``(previous pending dispatch, this dispatch)``."""
        active_ids = self.slots.active_slots()
        if self.paged:
            needy = self.prepare_step()
            if needy:
                raise OutOfPagesError(
                    f"slots {needy} need pages and the pool is dry; release or preempt before stepping"
                )
            self._push_page_table()
        prev = self._pending
        entries = {s: self.slots.get(s).request.id for s in active_ids}
        # the longest row's cache length after this step, known on the host
        kv_len = 1 + max(self.slots.get(s).next_pos + self._lag(s, self.slots.get(s)) for s in active_ids)
        if self.async_decode and prev is not None and prev["slots"] == entries:
            # steady state (no churn since the last dispatch): every input is
            # a carried device tensor — the previous step's own outputs — so
            # no host array is built or transferred for this token
            c = prev["carry"]
            inputs = (prev["sampled"], self._zero_tokens, c["active"], c["pos"], c["active"],
                      c["temp"], c["top_k"], c["gen"])
            carry_static = c
        else:
            B = self.slots.num_slots
            host_tokens = np.zeros((B,), np.int32)
            use_prev = np.zeros((B,), bool)
            pos = np.zeros((B,), np.int32)
            active = np.zeros((B,), bool)
            temp = np.zeros((B,), np.float32)
            top_k = np.zeros((B,), np.int32)
            gen_idx = np.zeros((B,), np.int32)
            for s in active_ids:
                st = self.slots.get(s)
                # a slot still holding the request it held at the previous
                # dispatch has exactly ONE undrained token in flight: feed it
                # forward on the device and advance pos/gen_idx past it
                lag = self._lag(s, st)
                if lag:
                    use_prev[s] = True
                else:
                    host_tokens[s] = st.last_token
                pos[s] = st.next_pos + lag
                gen_idx[s] = st.generated + lag
                active[s] = True
                temp[s] = st.request.params.temperature
                top_k[s] = st.request.params.top_k
            dev = self.device
            prev_tokens = prev["sampled"] if prev is not None else self._zero_tokens
            active_dev, temp_dev, top_k_dev = (_to_device(a, dev) for a in (active, temp, top_k))
            inputs = (prev_tokens, _to_device(host_tokens, dev), _to_device(use_prev, dev),
                      _to_device(pos, dev), active_dev, temp_dev, top_k_dev, _to_device(gen_idx, dev))
            carry_static = {"active": active_dev, "temp": temp_dev, "top_k": top_k_dev}
        with self.telemetry.span("serve.decode_step", active=len(active_ids)), torch.no_grad():
            sampled, next_pos, next_gen = self._decode(*inputs, kv_len=kv_len)
        self.steps += 1
        self._record_compile_gauges()
        dispatched = {
            "sampled": sampled,
            "host": _HostCopy(sampled),
            "slots": entries,
            "carry": {**carry_static, "pos": next_pos, "gen": next_gen},
        }
        return prev, dispatched

    def flush(self) -> StepOutput:
        """Drain the in-flight async dispatch, if any; the synchronous path
        has nothing pending and returns an empty output."""
        prev, self._pending = self._pending, None
        return self._drain(prev)

    def _drain(self, pending: Optional[Dict[str, Any]]) -> StepOutput:
        """Host-read one dispatched step's tokens and advance the slot
        mirror. Rows whose slot was released or re-admitted since dispatch
        are discarded — slot/request identity gates every emit."""
        if pending is None:
            return StepOutput(tokens={})
        t0 = time.perf_counter()
        sampled = pending["host"].numpy()  # waits for that step only
        drain_ms = (time.perf_counter() - t0) * 1e3
        self.last_drain_ms = drain_ms
        self.telemetry.gauge("serve.drain_ms", drain_ms)
        self.telemetry.histogram("serve.drain_ms", drain_ms)
        out: Dict[int, int] = {}
        for s, rid in pending["slots"].items():
            st = self.slots.get(s)
            if st is None or st.request.id != rid:
                continue  # slot churned since dispatch; the token belongs to no one
            tok = int(sampled[s])
            self.slots.advance(s, tok)
            out[s] = tok
        self.tokens_out += len(out)
        return StepOutput(tokens=out)

    # -------------------------------------------------------------- telemetry

    def _record_compile_gauges(self) -> None:
        counts = (len(self._shapes["decode"]), len(self._shapes["prefill"]))
        if counts != self._last_compile_gauges:
            self._last_compile_gauges = counts
            self.telemetry.gauge("serve.decode_retraces", counts[0])
            self.telemetry.gauge("serve.prefill_retraces", counts[1])

    @property
    def compile_counts(self) -> Dict[str, int]:
        """Distinct input shapes each program has run at: ``decode`` stays 1
        under any churn, ``prefill``/``prefix_admit`` grow with the bucket
        ladder. Eager PyTorch compiles nothing; these are the shapes a
        CUDA-graph capture of each program would have to hold."""
        return {name: len(shapes) for name, shapes in self._shapes.items()}

    @property
    def prefix_stats(self) -> Dict[str, Any]:
        """Reuse accounting: hits, tokens the reuse saved from prefill, full
        prefills actually run, and the residency view."""
        return {
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefill_calls": self.prefill_calls,
            "prefill_tokens": self.prefill_tokens,
            "prefix_residency": self.prefix_index.residency_stats(gen=self.steps),
        }

    @property
    def paging_stats(self) -> Dict[str, Any]:
        """Paged-cache accounting: pool occupancy, sharing, and the
        per-request page cap. ``{"paged": False}`` on the dense path."""
        if not self.paged:
            return {"paged": False}
        return {
            "paged": True,
            "max_pages_per_req": self.max_pages_per_req,
            "pages_aliased_total": self.pages_aliased,
            **self.allocator.stats(),
            "fragmentation": self.allocator.fragmentation(),
            "heat": self.allocator.heat_buckets(self.steps),
        }

    def set_max_pages_per_req(self, value: int) -> None:
        """Caps how many pages ONE request may hold. Applies to future
        admissions and growth denials only."""
        self.max_pages_per_req = max(1, min(self.pages_per_row, int(value)))

    @property
    def tier_stats(self) -> Dict[str, Any]:
        """Host-DRAM tier accounting: pool occupancy plus the policy's
        spill/fill ledger; ``{"enabled": False}`` when the tier is off."""
        if self.tier is None:
            return {"enabled": False}
        return {
            "enabled": True,
            **self.tier.stats(),
            **self.tier_policy.stats(),
            # host-resident prefix digests: a spilled-but-swappable prefix
            # counts as held by this engine
            "prefix_digests": [k[3:] for k in self.tier.keys() if k.startswith("px:")],
        }

    def set_tier_host_pages(self, value: int) -> None:
        """Resize the host tier's page budget. Shrink evicts LRU packs
        immediately; an explicit value pins the budget across reconfigures."""
        if self.tier is None:
            return
        self._tier_pages_explicit = True
        self.tier.set_capacity(int(value))

    def set_tier_low_water(self, value: float) -> None:
        """Move the pressure-spill trigger's headroom threshold."""
        if self.tier_policy is None:
            return
        self.tier_policy.low_water_pct = float(value)


def _seed64(seed: int) -> int:
    """A request seed as the int64 the sampler hashes."""
    return int(seed) & 0x7FFFFFFFFFFFFFFF
