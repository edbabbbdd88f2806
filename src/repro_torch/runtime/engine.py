"""InferenceEngine and ContinuousEngine of the port.

Counterparts of `repro.runtime.engine`:

- :class:`InferenceEngine` runs the paper's one-shot classification
  (:meth:`~InferenceEngine.classify`, the ``execute`` callable of
  `repro_torch.core.serving.ServingSystem`) and its warm-up, which
  measures classify over a grid into the DP scheduler's
  ``cached_cost`` table (:meth:`~InferenceEngine.warmup`); and, for
  generation, bucketed prompt prefill
  (:meth:`~InferenceEngine.prefill_batch`) and the fused decode tick
  (:meth:`~InferenceEngine.decode_step_batch`: one decode step, token
  selection, emission and stop flags) over a device-resident
  :class:`GenState`.  No tick reads anything back to the host; emitted
  tokens accumulate on the device and move once per flush.  Where the
  JAX package compiles one cell per bucket, the port runs eagerly.
- :class:`ContinuousEngine` layers iteration-level continuous batching
  on top: a persistent slot cache that newly admitted prefills splice
  into while other rows are mid-decode, over ONE paged KV pool
  (``kv_layout="paged"``, the default) or a contiguous stripe per slot
  (``"contiguous"``).  It implements
  `repro_torch.core.pipeline.PipelineBackend`.

On the paged layout every admission group is prefilled as ONE packed
dispatch (:meth:`ContinuousEngine.prefill_pack`, the JAX package's
default): the prompts are concatenated into one flat row with segment ids
and per-token positions, prefilled once through the flash kernel's
segment-masked mode and scattered into each session's own blocks.
``packed_prefill=False`` and the contiguous layout keep the per-group
path.  Chunked prefill and the prefix cache are not ported yet; the
constructor refuses their options.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import TableCostModel, block_round
from repro_torch.core.pipeline import PipelineBackend
from repro_torch.core.serving import Request
from repro_torch.models import (decode_step, forward_hidden, logits_at,
                                make_cache, make_paged_cache, prefill,
                                prefill_packed)
from repro_torch.runtime import sanitizer
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.kv_cache import (DEFAULT_KV_BLOCK,
                                          BlockTableManager, KVSlabManager,
                                          kv_bytes_per_token)
from repro_torch.runtime.sampling import (DEFAULT_SAMPLE_CANDIDATES,
                                          sample_tokens)
from repro_torch.runtime.session import GenerationParams, Session

# stop-id slots per row in GenState.eos: column 0 is the request's eos_id,
# the rest hold extra GenerationParams.stop ids (-1 = unused)
STOP_SLOTS = 4

# ContinuousEngine options of the JAX package not ported yet
NOT_PORTED_OPTIONS = ("prefix_cache", "chunked_prefill",
                      "prefill_chunk_tokens")

#: packed dispatches whose (segments, flat tokens, pack bucket) the
#: ContinuousEngine keeps in ``pack_log``
PACK_LOG_LEN = 1024

KV_LAYOUTS = ("paged", "contiguous")


@dataclass
class GenState:
    """Device-resident state of an in-flight generation batch: the KV
    cache, the last token per row, the emission buffer, per-row stop
    bookkeeping and sampling params.

    ``cache`` is a contiguous decode cache (``k``/``v`` (L, B, S, KV,
    dh), ``len``, ``pos_offset``; a prefill produces one) or a paged one
    (``k``/``v`` pools, ``block_tables``, ``len``, ``pos_offset``); both
    decode."""
    cache: Dict[str, torch.Tensor]
    cur: torch.Tensor                 # (B,) last token
    emitted: torch.Tensor             # (B, cap) generated tokens
    counts: torch.Tensor              # (B,) number emitted
    done: torch.Tensor                # (B,) bool
    budget: torch.Tensor              # (B,) per-row max_new_tokens
    eos: torch.Tensor                 # (B, STOP_SLOTS) stop ids, -1 unused
    temp: torch.Tensor                # (B,) temperature (0 = greedy)
    top_k: torch.Tensor               # (B,) top-k cutoff (0 = off)
    top_p: torch.Tensor               # (B,) nucleus mass (1 = off)
    seed: torch.Tensor                # (B,) per-request PRNG seed
    # host-side: does any live row sample?  Greedy-only batches run the
    # argmax tick and never draw noise.
    sampling: bool = False

    @property
    def capacity(self) -> int:
        return self.emitted.shape[1]


def segment_labels(lengths: Sequence[int], offsets: Sequence[int],
                   width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Segment ids and positions (each (width,) int32) of a packed row:
    segment i's ``lengths[i]`` slots back to back, at positions
    ``offsets[i]..``, then padding (id -1, position 0) up to ``width``."""
    seg = np.full((width,), -1, np.int32)
    pos = np.zeros((width,), np.int32)
    at = 0
    for i, (n, off) in enumerate(zip(lengths, offsets)):
        seg[at:at + n] = i
        pos[at:at + n] = np.arange(off, off + n)
        at += n
    return seg, pos


def _host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy (the flush points of the serving loop)."""
    return t.cpu().numpy()


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceEngine:
    """Bucketed prompt prefill and the fused decode tick over one model.

    ``device`` defaults to ``"cuda"`` and raises without a card unless
    the caller passes ``device="cpu"``; ``params`` are moved there (a
    no-op when they already live on it)."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 ladder: Optional[BucketLadder] = None, pad_id: int = 0,
                 sample_candidates: Optional[int] = None,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.ladder = ladder if ladder is not None else BucketLadder()
        self.pad_id = pad_id
        if sample_candidates is None:
            sample_candidates = DEFAULT_SAMPLE_CANDIDATES
        if sample_candidates < 1:
            raise ValueError(f"sample_candidates must be >= 1, got "
                             f"{sample_candidates}")
        self.sample_candidates = sample_candidates
        self.kv_slab = KVSlabManager()
        self._next_gen_id = 0

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # One-shot classification (the paper's BERT-style service)
    # ------------------------------------------------------------------
    def _pad_batch(self, token_lists: Sequence[Sequence[int]]):
        """Right-pad a ragged batch to its (sequence, batch) bucket:
        tokens (batch_b, seq_b) and each row's last real index (0 for
        the padding rows), on the device."""
        lens = [len(t) for t in token_lists]
        seq_b = self.ladder.seq_bucket(max(lens))
        batch_b = self.ladder.batch_bucket(len(token_lists))
        toks = np.full((batch_b, seq_b), self.pad_id, np.int64)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        last = np.array([n - 1 for n in lens] + [0] * (batch_b - len(lens)),
                        np.int32)
        return self._tensor(toks, torch.int64), self._tensor(last,
                                                             torch.int32)

    def classify_logits(self, token_lists: Sequence[Sequence[int]]
                        ) -> torch.Tensor:
        """Last-token logits (n, V) of a variable-length batch, on the
        device: one causal pass at the batch's bucket through the naive
        attention route (scores, the fused softmax kernel, weights times
        V — the JAX package's ``_attn`` choice below its chunked
        threshold), then the head over each row's last real token."""
        toks, last = self._pad_batch(token_lists)
        h, _ = forward_hidden(self.cfg, self.params, toks, attn="naive")
        return logits_at(self.cfg, self.params, h, last)[:len(token_lists)]

    def classify(self, token_lists: Sequence[Sequence[int]]) -> List[int]:
        """Last-token classification over a variable-length batch (the
        paper's BERT-based service): host ints, so the call returns only
        once the card has finished the batch."""
        logits = self.classify_logits(token_lists)
        return [int(p) for p in _host(torch.argmax(logits, dim=-1))]

    def execute_requests(self, requests: List[Request], padded_len: int
                         ) -> List[int]:
        """ServingSystem adapter: requests carry token payloads."""
        return self.classify([r.payload for r in requests])

    # ------------------------------------------------------------------
    # Warm-up (paper §5: builds cached_cost)
    # ------------------------------------------------------------------
    def warmup(self, lengths: Optional[Sequence[int]] = None,
               batches: Optional[Sequence[int]] = None,
               repeats: int = 3) -> TableCostModel:
        """Time ``classify`` at every (length, batch) of the grid (the
        first four sequence and batch buckets by default) into the DP
        scheduler's cost table."""
        lengths = list(lengths or self.ladder.seq_buckets[:4])
        batches = list(batches or self.ladder.batch_buckets[:4])

        def measure(seq_len: int, batch: int) -> float:
            token_lists = [[1] * seq_len for _ in range(batch)]
            self.classify(token_lists)      # allocator pools, handles
            # classify returns host ints, so each call has waited for
            # the card: the host clock brackets the device work
            t0 = time.perf_counter()
            for _ in range(repeats):
                self.classify(token_lists)
            return (time.perf_counter() - t0) / repeats

        return TableCostModel.warmup(measure, lengths, batches)

    # ------------------------------------------------------------------
    # Resumable generation primitives
    # ------------------------------------------------------------------
    def prefill_batch(self, token_lists: Sequence[Sequence[int]], *,
                      max_len: int, max_new_tokens, eos_id=None,
                      cap_new: Optional[int] = None,
                      sampling: Optional[Sequence[GenerationParams]] = None,
                      prompt_kv_only: bool = False) -> GenState:
        """Prompt pass producing a :class:`GenState` over a contiguous
        cache of ``max_len`` positions (which decodes in place, or
        splices into a slot cache).  With ``prompt_kv_only`` the cache
        holds just the prompt bucket's positions, for a caller that
        copies them into a paged pool.  ``max_new_tokens`` / ``eos_id``
        may be scalars or per-request sequences; ``sampling`` carries
        each row's temperature / top-k / top-p / seed / extra stop ids
        (None is greedy)."""
        n = len(token_lists)
        lens = [len(t) for t in token_lists]
        prompt_b = self.ladder.seq_bucket(max(lens))
        batch_b = self.ladder.batch_bucket(n)
        budgets = list(max_new_tokens) if hasattr(max_new_tokens, "__len__") \
            else [int(max_new_tokens)] * n
        eos_ids = list(eos_id) if hasattr(eos_id, "__len__") \
            else [eos_id] * n
        if max(lens[i] + budgets[i] for i in range(n)) > max_len:
            raise ValueError(f"prompt+budget exceeds max_len {max_len}")
        cap = cap_new if cap_new is not None else max(max(budgets), 1)
        if cap < max(budgets):
            raise ValueError(f"cap_new={cap} cannot hold a "
                             f"max_new_tokens={max(budgets)} budget")
        toks = np.full((batch_b, prompt_b), self.pad_id, np.int64)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        true_lens = np.array(lens + [1] * (batch_b - n), np.int32)
        logits, cache = prefill(self.cfg, self.params,
                                self._tensor(toks, torch.int64),
                                max_len=None if prompt_kv_only else max_len,
                                true_lengths=self._tensor(true_lens,
                                                          torch.int32))
        return self._finish_gen_state(logits, cache, n, batch_b, budgets,
                                      eos_ids, cap, sampling)

    def prefill_packed_flat(self, suffixes: Sequence[Sequence[int]],
                            offsets: Sequence[int], prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, prefix_seg: torch.Tensor,
                            prefix_pos: torch.Tensor):
        """ONE device pass prefilling many independent segments.

        ``suffixes[i]`` is segment i's fresh (uncached) tokens and
        ``offsets[i]`` how many of its tokens are already cached: the
        segment's queries run at positions ``offsets[i]..`` against its own
        prefix slots in ``prefix_k`` / ``prefix_v`` (L, P_pre, KV, dh: every
        segment's cached prefix concatenated, labelled by ``prefix_seg`` /
        ``prefix_pos``).  Everything is padded here to the (pack, prefix,
        segment) buckets, so the card sees a bounded set of shapes.

        Returns ``(logits, parts)``: per-segment last-token logits (seg_b,
        V), rows past ``len(suffixes)`` padding, and the flat suffix KV
        (L, pack_b, KV, dh) laid out as the concatenated suffixes, for
        per-segment scatter into paged blocks."""
        lens = [len(x) for x in suffixes]
        if min(lens) < 1:
            raise ValueError("every packed segment needs >= 1 fresh token")
        flat = sum(lens)
        pack_b = self.ladder.pack_bucket(flat)
        seg_ids, positions = segment_labels(lens, offsets, pack_b)
        toks = np.full((1, pack_b), self.pad_id, np.int64)
        toks[0, :flat] = np.concatenate([np.asarray(x) for x in suffixes])
        last_idx = np.zeros((self.ladder.batch_bucket(len(lens)),), np.int32)
        last_idx[:len(lens)] = np.cumsum(lens) - 1
        pre = int(prefix_k.shape[1])
        pre_b = self.ladder.pack_bucket(pre) if pre else 0
        if pre_b > pre:
            pad = pre_b - pre
            zeros = prefix_k.new_zeros((prefix_k.shape[0], pad) +
                                       tuple(prefix_k.shape[2:]))
            prefix_k = torch.cat([prefix_k, zeros], dim=1)
            prefix_v = torch.cat([prefix_v, zeros], dim=1)
            prefix_seg = torch.cat([prefix_seg, prefix_seg.new_full((pad,),
                                                                    -1)])
            prefix_pos = torch.cat([prefix_pos, prefix_pos.new_zeros(pad)])
        return prefill_packed(
            self.cfg, self.params, self._tensor(toks, torch.int64),
            self._tensor(seg_ids, torch.int32),
            self._tensor(positions, torch.int32),
            self._tensor(last_idx, torch.int32), prefix_k, prefix_v,
            prefix_seg, prefix_pos, cache_dtype=torch.float32)

    def _finish_gen_state(self, logits, cache, n: int, batch_b: int,
                          budgets: Sequence[int], eos_ids: Sequence,
                          cap: int,
                          sampling: Optional[
                              Sequence[GenerationParams]] = None
                          ) -> GenState:
        """Seed the per-row control state (first token — sampled with
        each row's params at step 0 — emission buffer, budget, stops,
        done) around an already-populated cache."""
        specs = list(sampling) if sampling is not None else []
        specs += [GenerationParams(max_new_tokens=0)] * (batch_b -
                                                         len(specs))
        over = [i for i, p in enumerate(specs)
                if len(p.stop) > STOP_SLOTS - 1]
        if over:
            raise ValueError(f"rows {over}: at most {STOP_SLOTS - 1} "
                             "extra stop ids per request")
        temp = self._tensor([p.temperature for p in specs], torch.float32)
        top_k = self._tensor([p.top_k for p in specs], torch.int32)
        top_p = self._tensor([p.top_p for p in specs], torch.float32)
        seed = self._tensor([p.seed for p in specs], torch.int32)
        stops = np.full((batch_b, STOP_SLOTS), -1, np.int32)
        for i, e in enumerate(eos_ids):
            if e is not None:
                stops[i, 0] = e
        for i, p in enumerate(specs):
            for j, t in enumerate(p.stop):
                stops[i, 1 + j] = t
        eos = self._tensor(stops, torch.int32)
        use_sampling = any(p.temperature > 0 for p in specs)
        if use_sampling:
            # first generated token: drawn at step 0 with the row's key
            cur = sample_tokens(
                logits, temperature=temp, top_k=top_k, top_p=top_p,
                seed=seed, step=torch.zeros_like(seed),
                candidates=self.sample_candidates)
        else:
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
        budget = self._tensor(list(budgets) + [0] * (batch_b - n),
                              torch.int32)
        emitted = torch.zeros((batch_b, cap), dtype=torch.int32,
                              device=self.device)
        emitted[:, 0] = cur
        counts = torch.clamp(budget, max=1)
        done = (counts >= budget) | \
            ((cur[:, None] == eos).any(dim=-1) & (counts > 0))
        return GenState(cache, cur, emitted, counts, done, budget, eos,
                        temp, top_k, top_p, seed, sampling=use_sampling)

    def decode_step_batch(self, state: GenState) -> GenState:
        """One decode tick for every live row of ``state``, on device;
        finished rows are frozen (no KV advance, no emission).
        Greedy-only states take the argmax; states with sampled rows run
        the sampling kernel (greedy rows still get the argmax)."""
        cache = state.cache
        prev_len = cache["len"]
        logits, cache2 = decode_step(self.cfg, self.params, cache,
                                     state.cur)
        if state.sampling:
            nxt = sample_tokens(logits, temperature=state.temp,
                                top_k=state.top_k, top_p=state.top_p,
                                seed=state.seed, step=state.counts,
                                candidates=self.sample_candidates)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        done = state.done
        cache2["len"] = torch.where(done, prev_len, cache2["len"])
        col = torch.clamp(state.counts, max=state.capacity - 1).long()
        written = state.emitted.scatter(1, col[:, None], nxt[:, None])
        emitted = torch.where(done[:, None], state.emitted, written)
        counts = torch.where(done, state.counts, state.counts + 1)
        done2 = done | (counts >= state.budget) | \
            (nxt[:, None] == state.eos).any(dim=-1)
        cur = torch.where(done, state.cur, nxt)
        return replace(state, cache=cache2, cur=cur, emitted=emitted,
                       counts=counts, done=done2)

    def read_out(self, state: GenState,
                 token_lists: Sequence[Sequence[int]]) -> List[List[int]]:
        """ONE host transfer for the whole batch: prompt + emitted."""
        em = _host(state.emitted)
        cnt = _host(state.counts)
        return [list(t) + [int(x) for x in em[i, :cnt[i]]]
                for i, t in enumerate(token_lists)]

    def own_pool(self, state: GenState, max_len: int,
                 block_size: int = DEFAULT_KV_BLOCK) -> GenState:
        """Move a prefilled state's prompt KV into a private paged pool:
        row b owns the contiguous run of ``ceil(max_len / block_size)``
        blocks after the trash block."""
        parts = state.cache
        nl, b, s = parts["k"].shape[:3]
        mb = -(-max_len // block_size)
        cache = make_paged_cache(self.cfg, b, 1 + b * mb, block_size, mb,
                                 parts["k"].dtype, self.device)
        rows = torch.arange(b, dtype=torch.int32, device=self.device)
        cache["block_tables"] = 1 + rows[:, None] * mb + \
            torch.arange(mb, dtype=torch.int32, device=self.device)[None]
        flat = (block_size * (1 + rows.long() * mb))[:, None] + \
            torch.arange(s, device=self.device)[None]
        for key in ("k", "v"):
            pool = cache[key].view((nl, -1) + cache[key].shape[3:])
            pool[:, flat.reshape(-1)] = parts[key].reshape(
                (nl, b * s) + parts[key].shape[3:])
        cache["len"] = parts["len"].clone()
        cache["pos_offset"] = parts["pos_offset"].clone()
        return replace(state, cache=cache)

    def generate(self, token_lists: Sequence[Sequence[int]],
                 max_new_tokens: int = 16,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Greedy decode over a ragged batch (right-padded; per-request
        last-token gather), with its own paged pool.  Tokens accumulate
        on the device and transfer once at the end."""
        lens = [len(t) for t in token_lists]
        seq_b = self.ladder.seq_bucket(max(lens) + max_new_tokens)
        per_tok = kv_bytes_per_token(self.cfg)
        # negative ids: a namespace disjoint from serving req_ids
        req_ids = [-(self._next_gen_id + i + 1)
                   for i in range(len(token_lists))]
        self._next_gen_id += len(token_lists)
        try:
            for rid, ln in zip(req_ids, lens):
                self.kv_slab.allocate(rid, per_tok * seq_b,
                                      tokens=ln + max_new_tokens)
            if max_new_tokens == 0:
                return [list(t) for t in token_lists]
            state = self.prefill_batch(token_lists, max_len=seq_b,
                                       max_new_tokens=max_new_tokens,
                                       eos_id=eos_id, prompt_kv_only=True)
            state = self.own_pool(state, seq_b)
            for _ in range(max_new_tokens - 1):
                state = self.decode_step_batch(state)
            return self.read_out(state, token_lists)
        finally:
            for rid in req_ids:
                if self.kv_slab.has_region(rid):
                    self.kv_slab.free(rid)
            self.kv_slab.gc()


class ContinuousEngine(PipelineBackend):
    """Iteration-level continuous batching over a persistent slot cache.

    ``max_slots`` sequences decode concurrently in one tick; newly
    admitted prefills splice into free slots between ticks, and a
    sequence's KV is freed the moment it hits EOS or its budget.  Two KV
    layouts, selected by ``kv_layout``:

    - ``"paged"`` (default): K/V live in one preallocated pool of
      ``block_size``-token blocks managed by a :class:`BlockTableManager`.
      Blocks covering the prompt are allocated at admission and appended
      as decoding crosses block boundaries, the rest of a request's
      budget is reserved, and a prefill that cannot get blocks is vetoed
      at admission.
    - ``"contiguous"``: the slot cache holds one ``max_len`` stripe per
      slot, sized at the first admission (or by ``max_len``) and grown by
      padding the sequence axis when a longer request arrives; the
      JAX package's equivalence baseline for the paged pool, and the
      layout SSM / hybrid families need.

    With ``packed_prefill=True`` (the default, as in the JAX package) the
    paged layout prefills each admission group as one packed dispatch
    (:meth:`prefill_pack`); ``False`` keeps the per-group path, the
    equivalence baseline the packed path is tested against.
    """

    def __init__(self, engine: InferenceEngine, max_slots: int = 8,
                 max_len: Optional[int] = None, cap_new: int = 64,
                 clock: Callable[[], float] = time.monotonic, *,
                 kv_layout: str = "paged",
                 block_size: int = DEFAULT_KV_BLOCK,
                 num_blocks: Optional[int] = None,
                 packed_prefill: bool = True, **options) -> None:
        missing = [k for k in options if k in NOT_PORTED_OPTIONS]
        if missing:
            raise ValueError(f"{missing}: the port's engine serves whole "
                             "prompts, packed or per group; these options "
                             "are not ported yet")
        if options:
            raise TypeError(f"unexpected options {sorted(options)}")
        cfg = engine.cfg
        if cfg.num_codebooks or cfg.family != "dense":
            raise ValueError("ContinuousEngine serves dense single-codebook "
                             "token models")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.engine = engine
        self.max_slots = max_slots
        self.cap_new = cap_new
        self.clock = clock
        self.kv_layout = kv_layout
        self.block_size = block_size
        self.block_table: Optional[BlockTableManager] = None
        if kv_layout == "paged":
            if max_len is None:
                max_len = engine.ladder.seq_buckets[-1]
            if max_len % block_size:
                raise ValueError(f"max_len {max_len} must be a multiple "
                                 f"of block_size {block_size}")
            bad = [b for b in engine.ladder.seq_buckets if b % block_size]
            if bad:
                raise ValueError(f"ladder buckets {bad} not multiples of "
                                 f"block_size {block_size}")
            self.max_blocks = max_len // block_size
            # num_blocks=None: the pool is sized at the FIRST prefill to
            # max_slots x that admission's bucket (+ the trash block)
            if num_blocks is not None:
                self.block_table = sanitizer.make_block_manager(
                    num_blocks, block_size)
        # contiguous: None until the first prefill sizes the slot cache
        self.max_len = max_len
        self.prefill_tokens = 0      # tokens run through prefill
        self.prefill_dispatches = 0  # prefill passes issued
        # packed prefill: many segments per dispatch (paged layout only)
        self.packed_prefill = packed_prefill
        self.pack_dispatches = 0     # ... of which were packed
        self.pack_segments = 0       # segments across all packed ones
        #: (segments, flat tokens, pack bucket) of the latest packed
        #: dispatches; flat / bucket is the pack's occupancy
        self.pack_log: Deque[Tuple[int, int, int]] = collections.deque(
            maxlen=PACK_LOG_LEN)
        # pack ledger: req_id -> pool blocks the most recent packed
        # dispatch scattered into (check_invariants audits ownership)
        self._last_pack: Dict[int, List[int]] = {}
        self.sessions: List[Optional[Session]] = [None] * max_slots
        self.state: Optional[GenState] = None
        # next KV write position per slot (mirrors the device cache's
        # len; advanced conservatively, so a row that finished on device
        # between host syncs may hold one extra block until the sync)
        self._slot_len: List[int] = [0] * max_slots
        # blocks a live request will still append (reserved at admission,
        # so mid-decode appends can never fail)
        self._reserved: Dict[int, int] = {}
        self.decode_ticks = 0

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def _index(self, values: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    # -- PipelineBackend -------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self.sessions if s is None)

    def observe_metrics(self, m) -> None:
        """Tick-boundary gauges (host-side bookkeeping only)."""
        m.gauge("engine.prefill_tokens").set(self.prefill_tokens)
        m.gauge("engine.prefill_dispatches").set(self.prefill_dispatches)
        m.gauge("engine.decode_ticks").set(self.decode_ticks)
        for k, v in self.engine.kv_slab.metrics().items():
            m.gauge("slab." + k).set(v)
        if self.block_table is not None:
            for k, v in self.block_table.metrics().items():
                m.gauge("kv." + k).set(v)
            m.gauge("kv.reserved_blocks").set(sum(self._reserved.values()))

    def free_kv_tokens(self) -> Optional[int]:
        """Token capacity of blocks neither held nor reserved; unbounded
        until the pool exists."""
        if self.block_table is None:
            return None
        free = self.block_table.free_blocks - sum(self._reserved.values())
        return max(free, 0) * self.block_size

    def kv_demand(self, session: Session) -> int:
        if self.kv_layout != "paged":
            return session.total_len
        return max(block_round(session.total_len, self.block_size),
                   self.block_size)

    def validate(self, session: Session) -> None:
        """Reject un-servable sessions at submit time."""
        if session.prompt is None:
            raise ValueError(f"session {session.req_id} has no prompt "
                             "tokens")
        if session.max_new_tokens > self.cap_new:
            raise ValueError(
                f"session {session.req_id}: max_new_tokens="
                f"{session.max_new_tokens} exceeds cap_new={self.cap_new}")
        if session.temperature < 0:
            raise ValueError(f"session {session.req_id}: temperature "
                             "must be >= 0")
        if not 0.0 < session.top_p <= 1.0:
            raise ValueError(f"session {session.req_id}: top_p must be "
                             "in (0, 1]")
        if len(session.stop) > STOP_SLOTS - 1:
            raise ValueError(
                f"session {session.req_id}: at most {STOP_SLOTS - 1} "
                f"extra stop ids (got {len(session.stop)})")
        if self.engine.kv_slab.has_region(session.req_id):
            raise ValueError(f"session {session.req_id}: req_id already "
                             "in flight")
        if self.kv_layout == "paged" or (self.state is None and
                                         self.max_len is not None):
            ceiling = self.max_len
        else:
            # the contiguous slot cache grows up to the top ladder bucket
            ceiling = self.engine.ladder.seq_buckets[-1]
        if session.total_len > ceiling:
            raise ValueError(
                f"session {session.req_id}: prompt+budget="
                f"{session.total_len} exceeds max_len {ceiling}")
        if self.block_table is not None:
            demand = self.block_table.blocks_needed(session.total_len)
            if demand > self.block_table.num_blocks - 1:
                raise ValueError(
                    f"session {session.req_id}: needs {demand} KV blocks "
                    f"but the pool holds {self.block_table.num_blocks - 1}")

    def check_invariants(self, pipeline) -> None:
        """Sanitizer cross-check of engine accounting against the
        pipeline's live set: the slot<->session bijection (both layouts),
        then for the paged pool block conservation and shadow refcounts,
        reservation balance, and the leak check at idle."""
        seen_slots: Dict[int, int] = {}
        for s in pipeline.live:
            slot = s.slot
            if not 0 <= slot < self.max_slots or \
                    self.sessions[slot] is not s:
                raise sanitizer.SanitizerError(
                    f"slot<->session bijection broken: live session "
                    f"{s.req_id} claims slot {slot} but the engine maps "
                    "it elsewhere")
            if slot in seen_slots:
                raise sanitizer.SanitizerError(
                    f"slot {slot} shared by sessions "
                    f"{seen_slots[slot]} and {s.req_id}")
            seen_slots[slot] = s.req_id
        occupied = {i for i, s in enumerate(self.sessions) if s is not None}
        stray = occupied - set(seen_slots)
        if stray:
            held = [self.sessions[i].req_id for i in sorted(stray)]
            raise sanitizer.SanitizerError(
                f"slots {sorted(stray)} hold sessions {held} the "
                "pipeline no longer tracks")
        btm = self.block_table
        if btm is None:
            return
        resv = sum(self._reserved.values())
        if resv > btm.free_blocks:
            raise sanitizer.SanitizerError(
                f"reservation balance broken: {resv} blocks reserved "
                f"but only {btm.free_blocks} free")
        stray_resv = set(self._reserved) - {s.req_id for s in pipeline.live}
        if stray_resv:
            raise sanitizer.SanitizerError(
                f"reservations held for sessions {sorted(stray_resv)} "
                "that are not live")
        # pack ledger: every block the most recent packed dispatch wrote
        # must still be owned by the segment it was written for (a freed
        # or re-assigned block would mean the pack scattered into memory
        # another request now owns); a freed session's entry is dropped
        # with its table
        for req, blocks in self._last_pack.items():
            if not btm.has_request(req):
                continue
            owned = set(btm.block_table(req))
            stray_blocks = [b for b in blocks if b not in owned]
            if stray_blocks:
                raise sanitizer.SanitizerError(
                    f"pack ledger: session {req} no longer owns blocks "
                    f"{stray_blocks} its packed prefill scattered into")
        if isinstance(btm, sanitizer.SanitizedBlockTableManager):
            btm.check_conservation()
            if pipeline.idle():
                btm.check_idle(live_requests=())

    def prefill_batch(self, sessions: List[Session],
                      padded_len: int) -> None:
        if self.supports_packed_prefill():
            # one flat dispatch for the whole admission group
            self.prefill_pack(sessions)
            return
        eng = self.engine
        # everything that can fail is checked BEFORE any device-state or
        # slab mutation — a partial prefill must not poison the slot cache
        over = [s.req_id for s in sessions
                if s.max_new_tokens > self.cap_new]
        if over:
            raise ValueError(
                f"sessions {over} exceed the emission buffer "
                f"(max_new_tokens > cap_new={self.cap_new}); raise "
                f"cap_new or lower the budget")
        dup = [s.req_id for s in sessions
               if eng.kv_slab.has_region(s.req_id)]
        if dup:
            raise ValueError(f"req_ids {dup} already hold KV regions "
                             "(duplicate in-flight submission?)")
        need = eng.ladder.seq_bucket(max(s.total_len for s in sessions))
        self._ensure_state(need)
        slots = [i for i, s in enumerate(self.sessions) if s is None]
        slots = slots[:len(sessions)]
        if len(slots) != len(sessions):
            raise RuntimeError("admitted beyond free slots")
        btm = self.block_table
        if btm is not None:
            want = sum(btm.blocks_needed(s.total_len) for s in sessions)
            deficit = want + sum(self._reserved.values()) - btm.free_blocks
            if deficit > 0:
                raise ValueError(
                    f"prefill batch needs {want} fresh KV blocks beyond "
                    f"reservations, pool has {btm.free_blocks} free — the "
                    "admission planner should have vetoed this batch")
        try:
            rows = eng.prefill_batch(
                [list(s.prompt) for s in sessions],
                max_len=need if btm is not None else self.max_len,
                max_new_tokens=[s.max_new_tokens for s in sessions],
                eos_id=[s.eos_id for s in sessions], cap_new=self.cap_new,
                sampling=[s.params for s in sessions],
                prompt_kv_only=btm is not None)
            if btm is not None:
                self._splice_paged(rows, slots, sessions)
            else:
                self._splice(rows, slots)
            self.prefill_dispatches += 1
            self.prefill_tokens += sum(s.seq_len for s in sessions)
        except Exception:
            if btm is not None:
                self._release_tables(sessions, slots)
            raise
        now = self.clock()
        per_tok = kv_bytes_per_token(eng.cfg)
        for slot, s in zip(slots, sessions):
            self.sessions[slot] = s
            self._slot_len[slot] = s.seq_len
            eng.kv_slab.allocate(s.req_id, max(per_tok * s.total_len, 1),
                                 tokens=s.total_len)
            s.start_decode(now, slot=slot)
        # a budget-1 or instant-EOS prompt may be done already
        self._sync()
        self._publish_stream()     # the prefill's seed token streams too

    # -- packed prefill --------------------------------------------------
    def supports_packed_prefill(self) -> bool:
        """Packed prefill concatenates many segments into one flat
        dispatch and scatters per-segment KV into paged blocks, so it
        needs the paged layout (and the option on)."""
        return self.kv_layout == "paged" and self.packed_prefill

    def pack_bucket(self, flat_tokens: int) -> int:
        """Pack bucket a flat token count pads to (the pack occupancy's
        denominator)."""
        return self.engine.ladder.pack_bucket(flat_tokens)

    def prefill_pack(self, admissions: List[Session],
                     chunks: Sequence = (),
                     decoding: Optional[List[Session]] = None) -> None:
        """ONE packed dispatch serving a whole admission group: the
        prompts concatenated with segment ids and per-token positions,
        prefilled once (`InferenceEngine.prefill_packed_flat`), then
        scattered into each session's own block table in one scatter
        (`sanitizer.check_write` on every segment's exact block range),
        and the decode rows, seeded from each segment's last-token logits,
        spliced into the slot cache together.

        ``chunks`` (resumable-prefill chunk advances) and ``decoding`` (a
        decode tick fused behind a pack that splices nothing) belong to
        chunked prefill, which is not ported yet: they raise."""
        eng = self.engine
        if not self.supports_packed_prefill():
            raise ValueError("packed prefill requires kv_layout='paged' "
                             "with packed_prefill enabled")
        if chunks:
            raise ValueError("prefill_pack: resumable chunks belong to "
                             "chunked prefill, which is not ported yet")
        if decoding is not None and admissions:
            raise ValueError("prefill_pack: a decode tick fuses only behind "
                             "a pack that splices nothing")
        if not admissions:
            return
        # the segment-id row caps at the ladder's top batch bucket; a
        # group composed past it splits into ladder-sized packs
        cap = eng.ladder.batch_buckets[-1]
        if len(admissions) > cap:
            for at in range(0, len(admissions), cap):
                self.prefill_pack(admissions[at:at + cap])
            return
        # ---- pre-checks (nothing mutated before they pass) -------------
        over = [s.req_id for s in admissions
                if s.max_new_tokens > self.cap_new]
        if over:
            raise ValueError(
                f"sessions {over} exceed the emission buffer "
                f"(max_new_tokens > cap_new={self.cap_new}); raise "
                f"cap_new or lower the budget")
        dup = [s.req_id for s in admissions
               if eng.kv_slab.has_region(s.req_id)]
        if dup:
            raise ValueError(f"req_ids {dup} already hold KV regions "
                             "(duplicate in-flight submission?)")
        self._ensure_state(eng.ladder.seq_bucket(
            max(s.total_len for s in admissions)))
        slots = [i for i, s in enumerate(self.sessions)
                 if s is None][:len(admissions)]
        if len(slots) != len(admissions):
            raise RuntimeError("admitted beyond free slots")
        btm = self.block_table
        want = sum(btm.blocks_needed(s.total_len) for s in admissions)
        if want + sum(self._reserved.values()) > btm.free_blocks:
            raise ValueError(
                f"packed prefill needs {want} fresh KV blocks beyond "
                f"reservations, pool has {btm.free_blocks} free — the "
                "admission planner should have vetoed this pack")
        suffixes = [list(s.prompt) for s in admissions]
        cache = self.state.cache
        nl = cache["k"].shape[0]
        no_prefix = cache["k"].new_zeros((nl, 0) + cache["k"].shape[3:])
        no_ids = torch.zeros((0,), dtype=torch.int32, device=self.device)
        bs = self.block_size
        try:
            # ---- THE dispatch --------------------------------------------
            logits, parts = eng.prefill_packed_flat(
                suffixes, [0] * len(suffixes), no_prefix, no_prefix, no_ids,
                no_ids)
            # ---- tables, and every segment's scatter target --------------
            # blocks covering the prompt plus the first decode write; the
            # rest of the budget is reserved and appended mid-decode
            seg_bids: List[List[int]] = []
            for s in admissions:
                bids = btm.allocate(s.req_id, min(s.seq_len + 1, s.total_len))
                self._reserved[s.req_id] = max(
                    btm.blocks_needed(s.total_len) - len(bids), 0)
                seg_bids.append(bids)
            tgt: List[np.ndarray] = []
            pack_ledger: Dict[int, List[int]] = {}
            written: set = set()
            table_rows = np.zeros((len(admissions), self.max_blocks),
                                  np.int32)
            for i, (s, bids) in enumerate(zip(admissions, seg_bids)):
                seg_blocks = bids[:(s.seq_len - 1) // bs + 1]
                sanitizer.check_write(btm, s.req_id, seg_blocks)
                overlap = [b for b in seg_blocks if b in written]
                if overlap:
                    raise sanitizer.SanitizerError(
                        f"pack segments overlap on blocks {overlap} "
                        f"(session {s.req_id}) — cross-request KV "
                        "corruption")
                written.update(seg_blocks)
                pack_ledger[s.req_id] = list(seg_blocks)
                pos = np.arange(s.seq_len)
                tgt.append(np.asarray(bids, np.int64)[pos // bs] * bs +
                           pos % bs)
                table_rows[i, :len(bids)] = bids
            # ---- ONE scatter: the flat pack lines up with the
            # concatenated per-segment targets -----------------------------
            flat = sum(len(x) for x in suffixes)
            fidx = self._index(np.concatenate(tgt))
            for key in ("k", "v"):
                pool = cache[key]
                pool.view((nl, -1) + pool.shape[3:])[:, fidx] = \
                    parts[key][:, :flat].to(pool.dtype)
            # ---- splice the decode rows ----------------------------------
            n = len(admissions)
            batch_b = eng.ladder.batch_bucket(n)
            ctl = {"len": eng._tensor([s.seq_len for s in admissions] +
                                      [1] * (batch_b - n), torch.int32),
                   "pos_offset": torch.zeros((batch_b,), dtype=torch.int32,
                                             device=self.device)}
            rows = eng._finish_gen_state(
                logits[:batch_b], ctl, n, batch_b,
                budgets=[s.max_new_tokens for s in admissions],
                eos_ids=[s.eos_id for s in admissions], cap=self.cap_new,
                sampling=[s.params for s in admissions])
            idx = self._index(slots)
            cache["block_tables"][idx] = torch.as_tensor(table_rows,
                                                         device=self.device)
            self._splice_rows(rows, idx, n)
        except Exception:
            # free whatever tables the pack got and neutralize their rows
            self._release_tables(admissions, slots)
            raise
        # ---- host bookkeeping --------------------------------------------
        self._last_pack = pack_ledger
        self.prefill_dispatches += 1
        self.pack_dispatches += 1
        self.pack_segments += n
        self.prefill_tokens += flat
        self.pack_log.append((n, flat, eng.ladder.pack_bucket(flat)))
        now = self.clock()
        per_tok = kv_bytes_per_token(eng.cfg)
        for slot, s in zip(slots, admissions):
            self.sessions[slot] = s
            self._slot_len[slot] = s.seq_len
            eng.kv_slab.allocate(s.req_id, max(per_tok * s.total_len, 1),
                                 tokens=s.total_len)
            s.start_decode(now, slot=slot)
        # a budget-1 or instant-EOS prompt may be done already
        self._sync()
        self._publish_stream()

    def _release_tables(self, sessions: List[Session],
                        slots: List[int]) -> None:
        """After a failed paged prefill: free whatever tables the batch
        got, and neutralize their device rows (trash-block tables, done)
        so freed blocks can be reallocated without a stale row writing
        into them."""
        btm = self.block_table
        bad_slots: List[int] = []
        for i, s in enumerate(sessions):
            if btm.has_request(s.req_id):
                bad_slots.append(slots[i])
                btm.free(s.req_id)
                self._reserved.pop(s.req_id, None)
        if bad_slots:
            idx = self._index(bad_slots)
            self.state.cache["block_tables"][idx] = 0
            self.state.done[idx] = True

    def decode_tick(self, sessions: List[Session]) -> None:
        if self.block_table is not None:
            self._append_blocks()
        self.state = self.engine.decode_step_batch(self.state)
        self.decode_ticks += 1
        self._sync()
        self._publish_stream()

    def _publish_stream(self) -> None:
        """Incremental token delivery for streaming sessions: one small
        host read of the counts/emitted buffers per tick, and none when
        no occupied slot streams."""
        wanted = [(slot, s) for slot, s in enumerate(self.sessions)
                  if s is not None and s.stream]
        if not wanted:
            return
        counts = _host(self.state.counts)
        emitted = _host(self.state.emitted)
        for slot, s in wanted:
            s.generated = [int(x) for x in emitted[slot, :counts[slot]]]

    def warmup_aot(self) -> Dict[str, float]:
        """One throwaway greedy request per sequence bucket (a prompt one
        token short of the bucket plus one decode tick) through the
        engine's ``generate``, so library handles and allocator pools
        exist before the first real request; the slot cache is
        untouched.  The JAX package compiles its cells here; the port
        runs eagerly and has none to compile."""
        eng = self.engine
        t0 = time.perf_counter()
        for bucket in eng.ladder.seq_buckets:
            eng.generate([[eng.pad_id] * max(bucket - 2, 1)],
                         max_new_tokens=2)
        return {"buckets": len(eng.ladder.seq_buckets),
                "seconds": time.perf_counter() - t0}

    def cancel_session(self, session: Session) -> None:
        """Tear down a mid-decode session NOW: publish its partial
        generation (one row read), release its slab region and block
        table, clear its reservation, and neutralize the device row
        (done, table -> trash) so its freed blocks can be reallocated
        without the stale row writing into them."""
        slot = session.slot
        if slot < 0 or self.sessions[slot] is not session:
            raise ValueError(f"session {session.req_id} holds no decode "
                             "slot")
        st = self.state
        counts = int(_host(st.counts[slot]))
        emitted = _host(st.emitted[slot])
        session.generated = [int(x) for x in emitted[:counts]]
        self.engine.kv_slab.free(session.req_id)
        self.engine.kv_slab.gc()
        if self.block_table is not None:
            self.block_table.free(session.req_id)
            self._reserved.pop(session.req_id, None)
            st.cache["block_tables"][slot] = 0
        self._last_pack.pop(session.req_id, None)
        self.sessions[slot] = None
        self._slot_len[slot] = 0
        st.done[slot] = True

    # -- internals -------------------------------------------------------
    def _ensure_state(self, need_len: int) -> None:
        if self.state is not None:
            if self.kv_layout == "contiguous" and need_len > self.max_len:
                self._grow(need_len)
            return      # the pool and tables are fixed-shape for life
        eng = self.engine
        b = self.max_slots
        if self.kv_layout == "paged":
            if self.block_table is None:
                self.block_table = sanitizer.make_block_manager(
                    b * (need_len // self.block_size) + 1, self.block_size)
            cache = make_paged_cache(eng.cfg, b,
                                     self.block_table.num_blocks,
                                     self.block_size, self.max_blocks,
                                     torch.float32, self.device)
        else:
            if self.max_len is None:
                self.max_len = need_len
            if need_len > self.max_len:
                raise ValueError(f"prompt+budget needs {need_len} > slot "
                                 f"cache max_len {self.max_len}")
            cache = make_cache(eng.cfg, b, self.max_len, torch.float32,
                               self.device)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.state = GenState(
            cache=cache,
            cur=zeros((b,), torch.int32),
            emitted=zeros((b, self.cap_new), torch.int32),
            counts=zeros((b,), torch.int32),
            done=torch.ones((b,), dtype=torch.bool, device=self.device),
            budget=zeros((b,), torch.int32),
            eos=torch.full((b, STOP_SLOTS), -1, dtype=torch.int32,
                           device=self.device),
            temp=zeros((b,), torch.float32),
            top_k=zeros((b,), torch.int32),
            top_p=torch.ones((b,), dtype=torch.float32, device=self.device),
            seed=zeros((b,), torch.int32))

    def _grow(self, need_len: int) -> None:
        """Contiguous layout: re-make the slot cache with a longer
        sequence axis (zero-padded), keeping every row's KV."""
        cache = self.state.cache
        for key in ("k", "v"):
            old = cache[key]
            shape = old.shape[:2] + (need_len,) + old.shape[3:]
            new = torch.zeros(shape, dtype=old.dtype, device=old.device)
            new[:, :, :old.shape[2]] = old
            cache[key] = new
        self.max_len = need_len

    def _splice(self, rows: GenState, slots: List[int]) -> None:
        """Contiguous layout: copy the first ``len(slots)`` rows of a
        freshly prefilled state (a ``max_len`` cache) into the slot
        cache's stripes, whole, so nothing of a slot's last occupant
        survives."""
        idx = self._index(slots)
        k = len(slots)
        cache = self.state.cache
        for key in ("k", "v"):
            cache[key][:, idx] = rows.cache[key][:, :k].to(cache[key].dtype)
        self._splice_rows(rows, idx, k)

    def _splice_rows(self, rows: GenState, idx: torch.Tensor,
                     k: int) -> None:
        """Write the first ``k`` rows' lengths and control leaves of
        ``rows`` at slots ``idx`` (both layouts)."""
        st = self.state
        for key in ("len", "pos_offset"):
            st.cache[key][idx] = rows.cache[key][:k]
        for name in ("cur", "emitted", "counts", "done", "budget", "eos",
                     "temp", "top_k", "top_p", "seed"):
            getattr(st, name)[idx] = getattr(rows, name)[:k]
        # sticky: once a sampled row joins, the sampling tick serves the
        # whole slot cache (greedy rows keep their argmax values)
        st.sampling = st.sampling or rows.sampling

    def _splice_paged(self, rows: GenState, slots: List[int],
                      sessions: List[Session]) -> None:
        """Allocate block tables for newly admitted sessions and scatter
        their prompt KV from the prefill parts into the pool (one scatter
        for the whole batch); existing rows' blocks are untouched."""
        btm = self.block_table
        bs = self.block_size
        st = self.state
        k = len(slots)
        flat: List[np.ndarray] = []
        src_rows: List[np.ndarray] = []
        table_rows = np.zeros((k, self.max_blocks), np.int32)
        s_pad = rows.cache["k"].shape[2]
        for i, s in enumerate(sessions):
            # blocks covering the prompt plus the first decode write; the
            # rest of the budget is reserved and appended mid-decode
            bids = btm.allocate(s.req_id, min(s.seq_len + 1, s.total_len))
            self._reserved[s.req_id] = max(
                btm.blocks_needed(s.total_len) - len(bids), 0)
            sanitizer.check_write(btm, s.req_id,
                                  bids[:(s.seq_len - 1) // bs + 1])
            pos = np.arange(s.seq_len)
            flat.append(np.asarray(bids, np.int64)[pos // bs] * bs +
                        pos % bs)
            src_rows.append(i * s_pad + pos)
            table_rows[i, :len(bids)] = bids
        fidx = self._index(np.concatenate(flat))
        sidx = self._index(np.concatenate(src_rows))
        cache = st.cache
        for key in ("k", "v"):
            pool = cache[key]
            nl = pool.shape[0]
            part = rows.cache[key]
            src = part.reshape((nl, -1) + part.shape[3:])[:, sidx]
            pool.view((nl, -1) + pool.shape[3:])[:, fidx] = src.to(pool.dtype)
        idx = self._index(slots)
        cache["block_tables"][idx] = torch.as_tensor(table_rows,
                                                     device=self.device)
        self._splice_rows(rows, idx, k)

    def _append_blocks(self) -> None:
        """Before a decode tick: every occupied slot is about to write KV
        at its current length — append a pool block to any row crossing
        a block boundary and publish it in the device block table."""
        btm = self.block_table
        upd_slots: List[int] = []
        upd_idx: List[int] = []
        upd_bid: List[int] = []
        for slot, s in enumerate(self.sessions):
            if s is None:
                continue
            pos = self._slot_len[slot]
            if pos >= s.total_len:
                continue      # budget exhausted; row is (about to be) done
            fresh = btm.ensure(s.req_id, pos + 1)
            if fresh:
                self._reserved[s.req_id] = max(
                    self._reserved[s.req_id] - len(fresh), 0)
                base = btm.blocks_of(s.req_id) - len(fresh)
                for off, bid in enumerate(fresh):
                    upd_slots.append(slot)
                    upd_idx.append(base + off)
                    upd_bid.append(bid)
            self._slot_len[slot] = pos + 1
        if upd_slots:
            tables = self.state.cache["block_tables"]
            tables[self._index(upd_slots), self._index(upd_idx)] = \
                torch.as_tensor(np.asarray(upd_bid, np.int32),
                                device=self.device)

    def _sync(self) -> None:
        """Flush: read the (tiny) stop flags; only when an occupied slot
        newly finished is the token buffer transferred."""
        st = self.state
        done = _host(st.done)
        if not any(done[slot] for slot, s in enumerate(self.sessions)
                   if s is not None):
            return
        counts = _host(st.counts)
        emitted = _host(st.emitted)
        now = self.clock()
        freed_slots: List[int] = []
        for slot, s in enumerate(self.sessions):
            if s is None or not done[slot]:
                continue
            s.generated = [int(x) for x in emitted[slot, :counts[slot]]]
            s.result = list(s.prompt or []) + s.generated
            s.finish(now)
            self.engine.kv_slab.free(s.req_id)
            if self.block_table is not None:
                self.block_table.free(s.req_id)
                self._reserved.pop(s.req_id, None)
            self._last_pack.pop(s.req_id, None)
            self.sessions[slot] = None
            self._slot_len[slot] = 0
            freed_slots.append(slot)
        if freed_slots:
            self.engine.kv_slab.gc()
            if self.block_table is not None:
                # point freed rows at the trash block: their device rows
                # keep writing at a frozen position until re-admission,
                # and the freed physical blocks may be re-assigned
                st.cache["block_tables"][self._index(freed_slots)] = 0

    @property
    def live_tokens(self) -> int:
        return self.engine.kv_slab.live_tokens
