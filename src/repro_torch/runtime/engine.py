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
  JAX package compiles its cells, the port captures CUDA graphs
  (`repro_torch.runtime.graphs`), keyed as the reference keys its
  cells: the classify, per-group prefill, suffix and packed prefill
  cells (``classify_cells``, ``prefill_cells``) and, one per
  ``sampling`` flag, the in-place form of the tick
  (:meth:`~InferenceEngine.decode_step_inplace`).  The public prefill
  and classify-logits methods run the same cell bodies eagerly on
  tensors of their own.
- :class:`ContinuousEngine` layers iteration-level continuous batching
  on top: a persistent slot cache that newly admitted prefills splice
  into while other rows are mid-decode, over ONE paged KV pool
  (``kv_layout="paged"``, the default) or a contiguous stripe per slot
  (``"contiguous"``).  It implements
  `repro_torch.core.pipeline.PipelineBackend`.  On the card each of its
  prefills and decode ticks replays one captured graph (``warmup_aot``
  captures them before serving, by the reference's walk); on the CPU
  the same functions run eagerly.

On the paged layout every admission group is prefilled as ONE packed
dispatch (:meth:`ContinuousEngine.prefill_pack`, the JAX package's
default): the prompts are concatenated into one flat row with segment ids
and per-token positions, prefilled once through the flash kernel's
segment-masked mode and scattered into each session's own blocks.
``packed_prefill=False`` and the contiguous layout keep the per-group
path.  The paged layout also serves the JAX package's prefix cache
(``prefix_cache=True``: radix-matched prompt prefixes shared across
requests, copy-on-write tails, LRU eviction) and chunked prefill (the
resumable PREFILL primitives the pipeline's ``chunked_prefill`` drives,
chunks packed beside admissions).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FAMILIES, SSM_FAMILIES, ModelConfig
from repro_torch.core.cost_model import TableCostModel, block_round
from repro_torch.core.pipeline import PipelineBackend
from repro_torch.core.serving import Request
from repro_torch.models import (DEFAULT_RUNTIME, ModelRuntime, decode_step,
                                forward_hidden, logits_at, make_cache,
                                make_paged_cache, prefill, prefill_packed,
                                prefill_suffix)
from repro_torch.models.transformer import SEQ_LEAVES, state_specs
from repro_torch.runtime import graphs, sanitizer
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.graphs import CellArena, CellTable, Fill, TickCells
from repro_torch.runtime.kv_cache import (DEFAULT_KV_BLOCK,
                                          BlockExhausted, BlockTableManager,
                                          KVSlabManager, kv_bytes_per_token,
                                          ssm_state_bytes)
from repro_torch.runtime.prefix_cache import PrefixMatch, RadixPrefixCache
from repro_torch.runtime.sampling import (DEFAULT_SAMPLE_CANDIDATES,
                                          sample_tokens)
from repro_torch.runtime.session import GenerationParams, Session

# cache leaves whose batch axis is 0 (every other per-row leaf batches on
# axis 1: k/v/conv/state are (L, B, ...), shared_k/v are (n_apps, B, ...))
_BATCH_AXIS0 = ("len", "pos_offset")

# stop-id slots per row in GenState.eos: column 0 is the request's eos_id,
# the rest hold extra GenerationParams.stop ids (-1 = unused)
STOP_SLOTS = 4

#: packed dispatches whose (segments, flat tokens, pack bucket) the
#: ContinuousEngine keeps in ``pack_log``
PACK_LOG_LEN = 1024

KV_LAYOUTS = ("paged", "contiguous")

#: the InferenceEngine's bucket ladder where none is given (frozen), the
#: reference's default
DEFAULT_LADDER = BucketLadder()

#: the ContinuousEngine's serving counters, which a warm-up leaves as it
#: found them
SERVING_COUNTERS = ("prefill_tokens", "prefill_dispatches", "decode_ticks",
                    "cow_blocks", "pack_dispatches", "pack_segments")


@dataclass
class GenState:
    """Device-resident state of an in-flight generation batch: the KV
    cache, the last token per row, the emission buffer, per-row stop
    bookkeeping and sampling params.

    ``cache`` is a contiguous decode cache (``k``/``v`` (L, B, S, KV,
    dh), ``len``, ``pos_offset``; a prefill produces one; an SSM model's
    holds its state instead, `repro_torch.models.transformer.state_specs`)
    or a paged one (``k``/``v`` pools, ``block_tables``, ``len``,
    ``pos_offset``); both decode."""
    cache: Dict[str, torch.Tensor]
    cur: torch.Tensor                 # (B,) last token, (B, K) codebooks
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


def _device_call(fn):
    """Run ``fn`` under its engine's lock and the process's device gate
    (shared).  The lock keeps two backends that share one
    `InferenceEngine` (as the JAX package's serving CLI builds its pool)
    from interleaving inside its cells: a cell's outputs live in static
    buffers until the engine's next cell call, so each call runs from
    the write of its inputs to the read of its outputs alone.  The gate
    keeps every device call out of another thread's CUDA graph capture
    (`repro_torch.runtime.graphs.DEVICE_GATE`)."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with _device_held(self if isinstance(self, InferenceEngine)
                          else self.engine):
            return fn(self, *args, **kwargs)
    return call


@contextlib.contextmanager
def _device_held(engine: "InferenceEngine"):
    """`_device_call`'s hold, for a block of code."""
    with engine.lock, graphs.DEVICE_GATE.shared():
        yield


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _per_row(value, n: int) -> list:
    """A scalar repeated ``n`` times, or the per-row sequence given."""
    return list(value) if hasattr(value, "__len__") else [value] * n


class InferenceEngine:
    """Bucketed prompt prefill and the fused decode tick over one model.

    ``device`` defaults to ``"cuda"`` and raises without a card unless
    the caller passes ``device="cpu"``; ``params`` are moved there (a
    no-op when they already live on it).  ``rt`` (the model runtime)
    reaches every model call, as in the JAX package; the engines serve
    one device, so of its knobs only ``seq_shard`` would act, and only
    under a mesh, which they do not set up."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 rt: ModelRuntime = DEFAULT_RUNTIME,
                 ladder: BucketLadder = DEFAULT_LADDER, pad_id: int = 0,
                 sample_candidates: Optional[int] = None,
                 device=None) -> None:
        self.cfg = cfg
        self.rt = rt
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
        #: held by every device call of this engine and of the backends
        #: over it (`_device_call`)
        self.lock = threading.RLock()
        #: cells captured as CUDA graphs, as the JAX package counts its
        #: jitted cells here: the classify and prefill cells below and the
        #: ContinuousEngine's decode-tick cells (0 on the CPU)
        self.compile_count = 0
        arena = CellArena(self.device)
        #: the reference's ``_classify_cache``: (seq bucket, batch bucket)
        self.classify_cells = CellTable(arena, self._weight_pointers)
        #: the reference's ``_prefill_cache``: (max_len, batch bucket,
        #: prompt bucket), ("sfx", prefix_len, suffix bucket, batch
        #: bucket) and ("pack", pack bucket, prefix bucket, segment slots)
        self.prefill_cells = CellTable(arena, self._weight_pointers)
        self.cell_arena = arena
        self._next_gen_id = 0

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # Cells: the JAX package's compiled classify and prefill cells
    # ------------------------------------------------------------------
    def _weight_pointers(self) -> Tuple[int, ...]:
        return tuple(t.data_ptr() for t in _leaves(self.params))

    def _run_cell(self, table: Optional[CellTable], key, body,
                  inputs: Dict[str, graphs.Value],
                  outputs: Dict[str, graphs.Spec]
                  ) -> Dict[str, torch.Tensor]:
        """``body`` through ``table``'s cell ``key`` (on the card a graph
        replay whose outputs live until the next cell call of this
        engine, captured at first use and counted in ``compile_count``),
        or with ``table`` None eagerly, on tensors of its own: the public
        methods, whose results a caller may keep."""
        if table is None:
            return graphs.run_eager(body, inputs, outputs, self.device)
        before = table.captures
        outs = table.run(key, body, inputs, outputs)
        self.compile_count += table.captures - before
        return outs

    def _logits_spec(self, rows: int) -> graphs.Spec:
        """(rows, V) logits, (rows, K, V) for a codebook model."""
        cfg = self.cfg
        k = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        return (rows,) + k + (cfg.vocab_size,), \
            self.params["embed"]["tok"].dtype

    def _kv_spec(self, *dims: int) -> Dict[str, graphs.Spec]:
        """k/v outputs (L, *dims, KV, dh) in f32, the reference's
        ``cache_dtype``."""
        cfg = self.cfg
        shape = (cfg.num_layers,) + dims + (cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, torch.float32), "v": (shape, torch.float32)}

    # The cell bodies: pure functions of device tensors, each writing its
    # outputs (the reference's ``run`` / ``pf`` bodies)
    def _classify_body(self, ins, outs) -> None:
        h, _ = forward_hidden(self.cfg, self.params, ins["tokens"],
                              rt=self.rt, attn="naive")
        outs["logits"].copy_(logits_at(self.cfg, self.params, h,
                                       ins["last_idx"]))

    def _prefill_body(self, max_len: int, ins, outs) -> None:
        # an SSM model's prompts are exact: its pass takes no lengths
        ssm = self.cfg.family in SSM_FAMILIES
        logits, _ = prefill(self.cfg, self.params, ins["tokens"],
                            max_len=max_len, rt=self.rt,
                            true_lengths=None if ssm else
                            ins["true_lengths"], kv_out=outs)
        outs["logits"].copy_(logits)

    def _suffix_body(self, prefix_len: int, ins, outs) -> None:
        logits, _ = prefill_suffix(
            self.cfg, self.params, ins["tokens"], ins["prefix_k"],
            ins["prefix_v"], prefix_len=prefix_len, rt=self.rt,
            true_lengths=ins["true_lengths"], kv_out=outs)
        outs["logits"].copy_(logits)

    def _packed_body(self, ins, outs) -> None:
        logits, _ = prefill_packed(
            self.cfg, self.params, ins["tokens"], ins["seg_ids"],
            ins["positions"], ins["last_idx"], ins["prefix_k"],
            ins["prefix_v"], ins["prefix_seg"], ins["prefix_pos"],
            rt=self.rt, kv_out=outs)
        outs["logits"].copy_(logits)

    # ------------------------------------------------------------------
    # One-shot classification (the paper's BERT-style service)
    # ------------------------------------------------------------------
    def _classify(self, token_lists: Sequence[Sequence[int]],
                  table: Optional[CellTable]) -> torch.Tensor:
        """Last-token logits (batch bucket, V) of a variable-length batch
        right-padded to its (sequence, batch) bucket, through cell
        (seq_b, batch_b); the rows past the batch are padding."""
        lens = [len(t) for t in token_lists]
        seq_b = self.ladder.seq_bucket(max(lens))
        batch_b = self.ladder.batch_bucket(len(token_lists))
        toks = np.full((batch_b, seq_b), self.pad_id, np.int64)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        last = np.array([n - 1 for n in lens] + [0] * (batch_b - len(lens)),
                        np.int32)
        outs = self._run_cell(table, (seq_b, batch_b), self._classify_body,
                              {"tokens": toks, "last_idx": last},
                              {"logits": self._logits_spec(batch_b)})
        return outs["logits"]

    @_device_call
    def classify_logits(self, token_lists: Sequence[Sequence[int]]
                        ) -> torch.Tensor:
        """Last-token logits (n, V) of a variable-length batch, on the
        device, on tensors of their own: one causal pass at the batch's
        bucket through the naive attention route (scores, the fused
        softmax kernel, weights times V — the JAX package's ``_attn``
        choice below its chunked threshold), then the head over each
        row's last real token.  The same function as :meth:`classify`'s
        cell, run eagerly."""
        return self._classify(token_lists, None)[:len(token_lists)]

    @_device_call
    def classify(self, token_lists: Sequence[Sequence[int]]) -> List[int]:
        """Last-token classification over a variable-length batch (the
        paper's BERT-based service) through its (seq bucket, batch
        bucket) cell: host ints, so the call returns only once the card
        has finished the batch."""
        logits = self._classify(token_lists, self.classify_cells)
        # turbolint: allow-sync(one-shot classification returns host ints)
        return [int(p) for p in _host(torch.argmax(
            logits[:len(token_lists)], dim=-1))]

    @_device_call
    def execute_requests(self, requests: List[Request], padded_len: int
                         ) -> List[int]:
        """ServingSystem adapter: requests carry token payloads."""
        return self.classify([r.payload for r in requests])

    # ------------------------------------------------------------------
    # Warm-up (paper §5: builds cached_cost)
    # ------------------------------------------------------------------
    @_device_call
    def warmup(self, lengths: Optional[Sequence[int]] = None,
               batches: Optional[Sequence[int]] = None,
               repeats: int = 3) -> TableCostModel:
        """Time ``classify`` at every (length, batch) of the grid (the
        first four sequence and batch buckets by default) into the DP
        scheduler's cost table: the first call of a grid point captures
        its cell on the card, the timed repeats replay it."""
        lengths = list(lengths or self.ladder.seq_buckets[:4])
        batches = list(batches or self.ladder.batch_buckets[:4])

        def measure(seq_len: int, batch: int) -> float:
            token_lists = [[1] * seq_len for _ in range(batch)]
            self.classify(token_lists)      # capture (compile) + first run
            # classify returns host ints, so each call has waited for
            # the card: the host clock brackets the device work
            t0 = time.perf_counter()
            for _ in range(repeats):
                self.classify(token_lists)
            return (time.perf_counter() - t0) / repeats

        return TableCostModel.warmup(measure, lengths, batches)

    # ------------------------------------------------------------------
    # Resumable generation primitives.  The public methods return tensors
    # of their own (the cell bodies run eagerly); the ContinuousEngine
    # calls the underscored ones with ``self.prefill_cells``.
    # ------------------------------------------------------------------
    def _budgets(self, n: int, max_new_tokens, eos_id,
                 cap_new: Optional[int]) -> Tuple[list, list, int]:
        budgets = [int(b) for b in _per_row(max_new_tokens, n)]
        cap = cap_new if cap_new is not None else max(max(budgets), 1)
        if cap < max(budgets):
            raise ValueError(f"cap_new={cap} cannot hold a "
                             f"max_new_tokens={max(budgets)} budget")
        return budgets, _per_row(eos_id, n), cap

    @_device_call
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
        return self._prefill_batch(
            token_lists, None, max_len=max_len,
            max_new_tokens=max_new_tokens, eos_id=eos_id, cap_new=cap_new,
            sampling=sampling, prompt_kv_only=prompt_kv_only)

    def _prefill_batch(self, token_lists: Sequence[Sequence[int]],
                       table: Optional[CellTable], *, max_len: int,
                       max_new_tokens, eos_id=None,
                       cap_new: Optional[int] = None,
                       sampling: Optional[Sequence[GenerationParams]] = None,
                       prompt_kv_only: bool = False) -> GenState:
        """:meth:`prefill_batch` through cell (max_len, batch bucket,
        prompt bucket).  A ``prompt_kv_only`` pass computes what
        ``max_len`` = the prompt bucket does, and is keyed so.  An SSM or
        hybrid model's prompts must have one length, which stands for the
        bucket: padding would roll through its state."""
        n = len(token_lists)
        lens = [len(t) for t in token_lists]
        if self.cfg.family in SSM_FAMILIES:
            if len(set(lens)) > 1:
                raise ValueError("SSM prompts must be grouped by exact "
                                 "length")
            prompt_b = max(lens)   # no pad: state would roll through it
        else:
            prompt_b = self.ladder.seq_bucket(max(lens))
        batch_b = self.ladder.batch_bucket(n)
        budgets, eos_ids, cap = self._budgets(n, max_new_tokens, eos_id,
                                              cap_new)
        if max(lens[i] + budgets[i] for i in range(n)) > max_len:
            raise ValueError(f"prompt+budget exceeds max_len {max_len}")
        toks = np.full((batch_b, prompt_b), self.pad_id, np.int64)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        true_lens = np.array(lens + [1] * (batch_b - n), np.int32)
        width = prompt_b if prompt_kv_only else max(prompt_b, max_len)
        # the cache at width positions in f32, the reference's
        # cache_dtype: k/v, or an SSM model's state
        leaves = state_specs(self.cfg, batch_b, width, torch.float32)
        outs = self._run_cell(
            table, (width, batch_b, prompt_b),
            functools.partial(self._prefill_body, width),
            {"tokens": toks, "true_lengths": true_lens},
            {"logits": self._logits_spec(batch_b), **leaves})
        cache = {name: outs[name] for name in leaves}
        cache["len"] = self._tensor(true_lens, torch.int32)
        cache["pos_offset"] = torch.zeros((batch_b,), dtype=torch.int32,
                                          device=self.device)
        return self._finish_gen_state(outs["logits"], cache, n, batch_b,
                                      budgets, eos_ids, cap, sampling)

    @_device_call
    def prefill_suffix_batch(self, token_lists: Sequence[Sequence[int]], *,
                             prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                             prefix_len: int, max_new_tokens, eos_id=None,
                             cap_new: Optional[int] = None,
                             sampling: Optional[
                                 Sequence[GenerationParams]] = None
                             ) -> GenState:
        """Resumable suffix prefill: like :meth:`prefill_batch`, but the
        first ``prefix_len`` tokens of every prompt are served from
        ``prefix_k`` / ``prefix_v`` (prefix KV gathered from the paged
        pool, (L, n, prefix_len, KV, dh)) and only the remaining suffix
        runs through the model, at positions offset by the prefix.

        The returned state's cache holds ONLY the suffix KV (k/v: (L, B,
        suffix bucket, KV, dh)) with ``len`` already at the FULL prompt
        lengths; it is meant for the continuous engine's paged splice,
        which scatters the suffix into the request's own blocks — never
        into the shared prefix blocks."""
        return self._prefill_suffix_batch(
            token_lists, None, prefix_k=prefix_k, prefix_v=prefix_v,
            prefix_len=prefix_len, max_new_tokens=max_new_tokens,
            eos_id=eos_id, cap_new=cap_new, sampling=sampling)

    def _prefill_suffix_batch(self, token_lists: Sequence[Sequence[int]],
                              table: Optional[CellTable], *,
                              prefix_k: graphs.Value,
                              prefix_v: graphs.Value, prefix_len: int,
                              max_new_tokens, eos_id=None,
                              cap_new: Optional[int] = None,
                              sampling: Optional[
                                  Sequence[GenerationParams]] = None
                              ) -> GenState:
        """:meth:`prefill_suffix_batch` through cell ("sfx", prefix_len,
        suffix bucket, batch bucket); the prefix KV (L, n, prefix_len,
        KV, dh) may be a Fill that gathers it straight into the cell."""
        n = len(token_lists)
        suffixes = [list(t)[prefix_len:] for t in token_lists]
        lens = [len(x) for x in suffixes]
        if min(lens) < 1:
            raise ValueError("every prompt must keep >= 1 uncached token "
                             "(the last position's logits seed decoding)")
        suffix_b = self.ladder.seq_bucket(max(lens))
        batch_b = self.ladder.batch_bucket(n)
        budgets, eos_ids, cap = self._budgets(n, max_new_tokens, eos_id,
                                              cap_new)
        toks = np.full((batch_b, suffix_b), self.pad_id, np.int64)
        for i, t in enumerate(suffixes):
            toks[i, :len(t)] = t
        true_lens = np.array(lens + [1] * (batch_b - n), np.int32)
        outs = self._run_cell(
            table, ("sfx", prefix_len, suffix_b, batch_b),
            functools.partial(self._suffix_body, prefix_len),
            {"tokens": toks, "true_lengths": true_lens,
             "prefix_k": graphs.padded(prefix_k, 1, batch_b),
             "prefix_v": graphs.padded(prefix_v, 1, batch_b)},
            {"logits": self._logits_spec(batch_b),
             **self._kv_spec(batch_b, suffix_b)})
        cache = {"len": self._tensor([prefix_len + ln for ln in lens] +
                                     [1] * (batch_b - n), torch.int32),
                 "pos_offset": torch.zeros((batch_b,), dtype=torch.int32,
                                           device=self.device),
                 "k": outs["k"], "v": outs["v"]}
        return self._finish_gen_state(outs["logits"], cache, n, batch_b,
                                      budgets, eos_ids, cap, sampling)

    @_device_call
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
        return self._prefill_packed_flat(suffixes, offsets, None, prefix_k,
                                         prefix_v, prefix_seg, prefix_pos)

    def _prefill_packed_flat(self, suffixes: Sequence[Sequence[int]],
                             offsets: Sequence[int],
                             table: Optional[CellTable],
                             prefix_k: graphs.Value, prefix_v: graphs.Value,
                             prefix_seg: graphs.Value,
                             prefix_pos: graphs.Value):
        """:meth:`prefill_packed_flat` through cell ("pack", pack bucket,
        prefix bucket, segment slots); the prefix inputs (P_pre wide) may
        be host arrays, or Fills that gather straight into the cell."""
        lens = [len(x) for x in suffixes]
        if min(lens) < 1:
            raise ValueError("every packed segment needs >= 1 fresh token")
        flat = sum(lens)
        pack_b = self.ladder.pack_bucket(flat)
        seg_b = self.ladder.batch_bucket(len(lens))
        seg_ids, positions = segment_labels(lens, offsets, pack_b)
        toks = np.full((1, pack_b), self.pad_id, np.int64)
        toks[0, :flat] = np.concatenate([np.asarray(x) for x in suffixes])
        last_idx = np.zeros((seg_b,), np.int32)
        last_idx[:len(lens)] = np.cumsum(lens) - 1
        pre = graphs.spec(prefix_k)[0][1]
        pre_b = self.ladder.pack_bucket(pre) if pre else 0
        outs = self._run_cell(
            table, ("pack", pack_b, pre_b, seg_b), self._packed_body,
            {"tokens": toks, "seg_ids": seg_ids, "positions": positions,
             "last_idx": last_idx,
             "prefix_k": graphs.padded(prefix_k, 1, pre_b),
             "prefix_v": graphs.padded(prefix_v, 1, pre_b),
             "prefix_seg": graphs.padded(prefix_seg, 0, pre_b, -1),
             "prefix_pos": graphs.padded(prefix_pos, 0, pre_b)},
            {"logits": self._logits_spec(seg_b), **self._kv_spec(pack_b)})
        return outs["logits"], {"k": outs["k"], "v": outs["v"]}

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
        if use_sampling and logits.dim() != 2:
            raise ValueError("temperature sampling is unsupported for "
                             "codebook models (greedy only)")
        if use_sampling:
            # first generated token: drawn at step 0 with the row's key
            cur = sample_tokens(
                logits, temperature=temp, top_k=top_k, top_p=top_p,
                seed=seed, step=torch.zeros_like(seed),
                candidates=self.sample_candidates)
        else:
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
        # a codebook model emits its first codebook's token
        tok0 = cur if cur.dim() == 1 else cur[:, 0]
        budget = self._tensor(list(budgets) + [0] * (batch_b - n),
                              torch.int32)
        emitted = torch.zeros((batch_b, cap), dtype=torch.int32,
                              device=self.device)
        emitted[:, 0] = tok0
        counts = torch.clamp(budget, max=1)
        done = (counts >= budget) | \
            ((tok0[:, None] == eos).any(dim=-1) & (counts > 0))
        return GenState(cache, cur, emitted, counts, done, budget, eos,
                        temp, top_k, top_p, seed, sampling=use_sampling)

    @_device_call
    def decode_step_batch(self, state: GenState) -> GenState:
        """One decode tick for every live row of ``state``, on device;
        finished rows are frozen (no KV advance, no emission).
        Greedy-only states take the argmax; states with sampled rows run
        the sampling kernel (greedy rows still get the argmax).  A
        codebook model's state (``cur`` (B, K)) is always greedy and
        emits its first codebook, as the JAX package's tick of token
        rank 2."""
        cache = state.cache
        prev_len = cache["len"]
        logits, cache2 = decode_step(self.cfg, self.params, cache,
                                     state.cur, rt=self.rt)
        if state.sampling and state.cur.dim() == 1:
            nxt = sample_tokens(logits, temperature=state.temp,
                                top_k=state.top_k, top_p=state.top_p,
                                seed=state.seed, step=state.counts,
                                candidates=self.sample_candidates)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = nxt if nxt.dim() == 1 else nxt[:, 0]
        done = state.done
        cache2["len"] = torch.where(done, prev_len, cache2["len"])
        col = torch.clamp(state.counts, max=state.capacity - 1).long()
        written = state.emitted.scatter(1, col[:, None], tok[:, None])
        emitted = torch.where(done[:, None], state.emitted, written)
        counts = torch.where(done, state.counts, state.counts + 1)
        done2 = done | (counts >= state.budget) | \
            (tok[:, None] == state.eos).any(dim=-1)
        mask = done if state.cur.dim() == 1 else done[:, None]
        cur = torch.where(mask, state.cur, nxt)
        return replace(state, cache=cache2, cur=cur, emitted=emitted,
                       counts=counts, done=done2)

    def decode_step_inplace(self, state: GenState) -> None:
        """:meth:`decode_step_batch` written back into ``state``'s own
        tensors (``cur``, ``emitted``, ``counts``, ``done`` and the cache's
        ``len``; the KV write, and an SSM model's state write, are in
        place already, and a cache leaf the step returns anew is copied
        back), so the tensors the tick reads are the tensors it writes:
        the form a CUDA graph captures and replays."""
        out = self.decode_step_batch(state)
        for name, t in out.cache.items():
            if t is not state.cache[name]:
                state.cache[name].copy_(t)
        for name in ("cur", "emitted", "counts", "done"):
            getattr(state, name).copy_(getattr(out, name))

    @_device_call
    def read_out(self, state: GenState,
                 token_lists: Sequence[Sequence[int]]) -> List[List[int]]:
        """ONE host transfer for the whole batch: prompt + emitted."""
        em = _host(state.emitted)  # turbolint: allow-sync(final flush)
        cnt = _host(state.counts)  # turbolint: allow-sync(final flush)
        return [list(t) + [int(x) for x in em[i, :cnt[i]]]
                for i, t in enumerate(token_lists)]

    @_device_call
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

    @_device_call
    def generate(self, token_lists: Sequence[Sequence[int]],
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 per_token_host_sync: bool = False) -> List[List[int]]:
        """Greedy decode over a ragged batch (right-padded; per-request
        last-token gather), with its own paged pool; an SSM or hybrid
        model (prompts of one length) decodes its prefilled contiguous
        state in place instead.  Tokens accumulate
        on the device and transfer once at the end; on the card each tick
        is a replay of one graph of the in-place tick, as the JAX package
        runs its compiled tick (the graph is captured on the call's own
        state and dropped with it, so it is not counted in
        ``compile_count``, whose cells live on).
        ``per_token_host_sync=True`` runs the JAX package's old loop
        instead, one device-to-host read a token, as a baseline.  A
        codebook model emits its first codebook's tokens."""
        lens = [len(t) for t in token_lists]
        seq_b = self.ladder.seq_bucket(max(lens) + max_new_tokens)
        per_tok = kv_bytes_per_token(self.cfg)
        fixed = ssm_state_bytes(self.cfg)
        ssm = self.cfg.family in SSM_FAMILIES
        # negative ids: a namespace disjoint from serving req_ids
        req_ids = [-(self._next_gen_id + i + 1)
                   for i in range(len(token_lists))]
        self._next_gen_id += len(token_lists)
        try:
            for rid, ln in zip(req_ids, lens):
                self.kv_slab.allocate(
                    rid,
                    per_tok * seq_b + fixed if per_tok else max(fixed, 1),
                    tokens=ln + max_new_tokens)
            if max_new_tokens == 0:
                return [list(t) for t in token_lists]
            if per_token_host_sync:
                return self._generate_host_synced(token_lists,
                                                  max_new_tokens, seq_b)
            state = self.prefill_batch(token_lists, max_len=seq_b,
                                       max_new_tokens=max_new_tokens,
                                       eos_id=eos_id,
                                       prompt_kv_only=not ssm)
            if not ssm:
                state = self.own_pool(state, seq_b)
            ticks = TickCells(self.decode_step_inplace) \
                if self.device.type == "cuda" else None
            for _ in range(max_new_tokens - 1):
                if ticks is not None:
                    ticks.run(state)
                else:
                    state = self.decode_step_batch(state)
            return self.read_out(state, token_lists)
        finally:
            for rid in req_ids:
                if self.kv_slab.has_region(rid):
                    self.kv_slab.free(rid)
            self.kv_slab.gc()

    def _generate_host_synced(self, token_lists, max_new_tokens: int,
                              seq_b: int) -> List[List[int]]:
        """The JAX package's pre-refactor loop: a contiguous cache of
        ``seq_b`` positions decoded in place one step at a time, each
        step's token read back to the host (one sync a token).  Kept as
        the baseline that shows what the sync costs."""
        state = self.prefill_batch(token_lists, max_len=seq_b,
                                   max_new_tokens=max_new_tokens)
        outs = [list(t) for t in token_lists]
        cache, cur = state.cache, state.cur
        for _ in range(max_new_tokens):
            cur_np = _host(cur)  # turbolint: allow-sync(deliberate per-token baseline for benchmarks)
            for i in range(len(token_lists)):
                outs[i].append(int(cur_np[i].reshape(-1)[0]))
            logits, cache = decode_step(self.cfg, self.params, cache, cur,
                                        rt=self.rt)
            cur = torch.argmax(logits, dim=-1)
        return outs


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
      layout SSM / hybrid families need (their O(1) state cannot be
      paged; the hybrid's shared-block KV rides in the slot cache).
      Their admissions prefill as groups of one exact prompt length.

    With ``packed_prefill=True`` (the default, as in the JAX package) the
    paged layout prefills each admission group — and each pack group of
    resumable-prefill chunks — as one packed dispatch
    (:meth:`prefill_pack`); ``False`` keeps the per-group path, the
    equivalence baseline the packed path is tested against.

    ``prefix_cache=True`` (paged only) adds cross-request prompt-prefix
    sharing: admissions are matched against a
    :class:`~repro_torch.runtime.prefix_cache.RadixPrefixCache`, matched
    blocks are mapped straight into the new request's table
    (refcounted), only the uncached suffix is prefilled, a partially
    valid matched block is copied on the device before the suffix writes
    into it, a live sequence's first decode token copies its cached tail
    block (copy-on-write), and unreferenced cached blocks are
    LRU-evicted when admissions need the space.  Generated tokens are
    the same with the cache on or off; only the prefill work and block
    footprint shrink.

    Chunked prefill (the pipeline's ``chunked_prefill``) runs through
    :meth:`begin_prefill_chunks`, :meth:`prefill_chunk` and the chunk half
    of :meth:`prefill_pack`, on the paged layout only.
    """

    def __init__(self, engine: InferenceEngine, max_slots: int = 8,
                 max_len: Optional[int] = None, cap_new: int = 64,
                 sync_every: int = 1,
                 clock: Callable[[], float] = time.monotonic, *,
                 kv_layout: str = "paged",
                 block_size: int = DEFAULT_KV_BLOCK,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 packed_prefill: bool = True) -> None:
        cfg = engine.cfg
        if cfg.num_codebooks:
            raise ValueError("ContinuousEngine supports single-codebook "
                             "token models only")
        if cfg.family not in FAMILIES:
            raise ValueError(f"ContinuousEngine serves the families "
                             f"{FAMILIES}, not {cfg.family!r}")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "paged" and cfg.family in SSM_FAMILIES:
            raise ValueError("paged KV requires an attention-family "
                             "model; use kv_layout='contiguous' for "
                             "SSM/hybrid")
        if prefix_cache and kv_layout != "paged":
            raise ValueError("prefix_cache requires kv_layout='paged' "
                             "(sharing happens at block granularity)")
        self.engine = engine
        self.max_slots = max_slots
        self.cap_new = cap_new
        # host syncs (the stop-flag read) every sync_every decode ticks;
        # a row that finishes between them is frozen on the device
        self.sync_every = sync_every
        self._since_sync = 0
        self.clock = clock
        self.kv_layout = kv_layout
        self.block_size = block_size
        self.block_table: Optional[BlockTableManager] = None
        self._prefix_enabled = prefix_cache
        self.prefix_cache: Optional[RadixPrefixCache] = None
        # cluster-tier donation seam: forwarded onto the prefix cache's
        # `on_insert` whenever the (lazily created) cache materializes,
        # so a ReplicaPool can subscribe before the first prefill
        self.on_prefix_insert: Optional[
            Callable[[List[int], List[int]], None]] = None
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
                if prefix_cache:
                    self.prefix_cache = RadixPrefixCache(self.block_table)
        # contiguous: None until the first prefill sizes the slot cache
        self.max_len = max_len
        self.prefill_tokens = 0      # tokens run through prefill
        self.prefill_dispatches = 0  # prefill passes issued
        self.cow_blocks = 0          # copy-on-write block copies made
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
        # chunked prefills in flight: req_id -> the decode slot reserved
        # for it at admission (claimed when the final chunk splices)
        self._chunk_slots: Dict[int, int] = {}
        self.decode_ticks = 0
        #: the decode tick's CUDA graphs, one cell per sampling flag
        self.tick_cells = TickCells(engine.decode_step_inplace)
        self.warmup_stats: Optional[Dict[str, float]] = None
        # warm-up sessions' req_ids: far below any serving or generate id
        self._warm_id = -(10 ** 9)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def _index(self, values: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    # -- PipelineBackend -------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self.sessions if s is None) \
            - len(self._chunk_slots)

    def _open_slots(self) -> List[int]:
        """Free slots, less those reserved for in-flight chunked
        prefills: a final chunk will splice there, and a row spliced in
        meanwhile would be overwritten mid-decode."""
        taken = set(self._chunk_slots.values())
        return [i for i, s in enumerate(self.sessions)
                if s is None and i not in taken]

    def observe_metrics(self, m) -> None:
        """Tick-boundary gauges (host-side bookkeeping only)."""
        m.gauge("engine.compile_count").set(self.engine.compile_count)
        m.gauge("engine.prefill_tokens").set(self.prefill_tokens)
        m.gauge("engine.prefill_dispatches").set(self.prefill_dispatches)
        m.gauge("engine.decode_ticks").set(self.decode_ticks)
        m.gauge("engine.cow_blocks").set(self.cow_blocks)
        for k, v in self.engine.kv_slab.metrics().items():
            m.gauge("slab." + k).set(v)
        if self.block_table is not None:
            for k, v in self.block_table.metrics().items():
                m.gauge("kv." + k).set(v)
            m.gauge("kv.reserved_blocks").set(sum(self._reserved.values()))
        if self.prefix_cache is not None:
            for k, v in self.prefix_cache.metrics().items():
                m.gauge("prefix." + k).set(v)

    def free_kv_tokens(self) -> Optional[int]:
        """Token capacity of blocks neither held nor reserved — the
        admission budget the pipeline charges ``kv_demand`` against.
        With the prefix cache on, cached blocks that eviction can
        reclaim (held by the cache alone, with nothing held below them)
        count as free.  Unbounded until the pool exists."""
        if self.block_table is None:
            return None
        free = self.block_table.free_blocks - sum(self._reserved.values())
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks()
        return max(free, 0) * self.block_size

    def kv_demand(self, session: Session) -> int:
        """Tokens of KV capacity admitting ``session`` takes from what
        :meth:`free_kv_tokens` reports: exactly what the admission will
        draw (its fresh blocks, the tail copy included) plus the
        reclaimable cached blocks its match pins, so the engine's own
        capacity check never fails on a planned batch."""
        if self.kv_layout != "paged":
            return session.total_len
        bs = self.block_size
        demand = block_round(session.total_len, bs)
        if self.prefix_cache is not None and session.prompt:
            m = self.prefix_cache.match(list(session.prompt),
                                        take_refs=False)
            held = self.prefix_cache.reclaimable_blocks()
            # a matched full block eviction could not reclaim costs no
            # capacity; one it could was counted free by free_kv_tokens
            # and the match pins it, so it stays charged
            demand -= sum(1 for b in m.full_blocks if b not in held) * bs
            if m.tail_block is not None and m.tail_block in held:
                # the match pins a reclaimable tail block AND the copy
                # takes a fresh one: both leave the reported capacity
                demand += bs
        return max(demand, bs)

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
        pipeline's live set: the slot<->session bijection and the
        chunk-slot ledger (both layouts), then for the paged pool block
        conservation and shadow refcounts, reservation balance, the pack
        ledger, and the leak check at idle (every used block accounted
        for by the prefix cache)."""
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
        chunk_reqs = {s.req_id for s in pipeline.chunking}
        if set(self._chunk_slots) != chunk_reqs:
            raise sanitizer.SanitizerError(
                f"chunk-slot ledger {sorted(self._chunk_slots)} does not "
                f"match the pipeline's chunking queue "
                f"{sorted(chunk_reqs)}")
        btm = self.block_table
        if btm is None:
            return
        resv = sum(self._reserved.values())
        if resv > btm.free_blocks:
            raise sanitizer.SanitizerError(
                f"reservation balance broken: {resv} blocks reserved "
                f"but only {btm.free_blocks} free")
        allowed = {s.req_id for s in pipeline.live} | chunk_reqs
        stray_resv = set(self._reserved) - allowed
        if stray_resv:
            raise sanitizer.SanitizerError(
                f"reservations held for sessions {sorted(stray_resv)} "
                "that are neither live nor chunking")
        # pack ledger: every block the most recent packed dispatch wrote
        # must still be owned by the segment it was written for (a freed
        # or re-assigned block would mean the pack scattered into memory
        # another request now owns).  A copy-on-write swaps the recorded
        # id for the private copy; a freed session's entry is dropped
        # with its table.
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
                cache_blocks = self.prefix_cache.cached_blocks \
                    if self.prefix_cache is not None else 0
                btm.check_idle(live_requests=(), cache_blocks=cache_blocks)

    # -- admission internals ---------------------------------------------
    def _match(self, sessions: Sequence[Session]
               ) -> Optional[List[PrefixMatch]]:
        """Prefix matches of every session (None without the cache).
        Matching takes refcount holds on every matched block up front, so
        one session's LRU eviction can never reclaim blocks a sibling in
        the same batch is about to share; every exit past this point
        either adopts the holds into a table or releases them."""
        if self.prefix_cache is None or not sessions:
            return None
        return [self.prefix_cache.match(list(s.prompt)) for s in sessions]

    def _check_capacity(self, sessions: Sequence[Session],
                        matches: Optional[List[PrefixMatch]], what: str,
                        unit: str) -> None:
        """The engine's own capacity check, before anything is mutated:
        the fresh blocks the admissions take (matched full blocks are
        covered) plus every reservation must fit the free list, after
        evicting warm cache if needed.  On a deficit the matches are
        released and the admission raises — the planner should have
        vetoed it."""
        btm = self.block_table
        want = 0
        for i, s in enumerate(sessions):
            covered = len(matches[i].full_blocks) if matches else 0
            want += btm.blocks_needed(s.total_len) - covered
        deficit = want + sum(self._reserved.values()) - btm.free_blocks
        if deficit > 0 and self.prefix_cache is not None:
            deficit -= self.prefix_cache.evict(deficit)
        if deficit > 0:
            for m in matches or ():
                self.prefix_cache.release(m)
            raise ValueError(
                f"{what} needs {want} fresh KV blocks beyond reservations, "
                f"pool has {btm.free_blocks} free — the admission planner "
                f"should have vetoed this {unit}")

    def _adopt_match(self, m: Optional[PrefixMatch]
                     ) -> Tuple[int, List[int]]:
        """Turn a match's holds into the head of a new table: the full
        blocks as they are, and a partially valid tail block copied on
        the device into a private block first (copy-on-write: the suffix
        writes into it).  Returns (cached tokens, prefix blocks)."""
        if m is None:
            return 0, []
        btm = self.block_table
        m.consumed = True            # holds transfer to the table
        prefix_blocks = list(m.full_blocks)
        if m.tail_block is not None:
            try:
                cow = btm.take(1)[0]
            except BlockExhausted:
                for b in prefix_blocks:
                    btm.unref(b)
                btm.unref(m.tail_block)
                raise
            self._copy_blocks([m.tail_block], [cow])
            btm.unref(m.tail_block)
            prefix_blocks.append(cow)
            self.cow_blocks += 1
        return m.cached_tokens, prefix_blocks

    def _allocate(self, s: Session, tokens: int,
                  prefix_blocks: List[int]) -> List[int]:
        """``s``'s table: ``prefix_blocks`` then fresh blocks up to
        ``tokens``; the rest of its budget is reserved."""
        btm = self.block_table
        try:
            bids = btm.allocate(s.req_id, tokens,
                                prefix_blocks=prefix_blocks)
        except BlockExhausted:
            for b in prefix_blocks:
                btm.unref(b)
            raise
        self._reserved[s.req_id] = max(
            btm.blocks_needed(s.total_len) - len(bids), 0)
        return bids

    def _copy_blocks(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Copy whole pool blocks ``src[i] -> dst[i]`` (every layer, K and
        V) on the device, in place.  The copy is queued on the pool's
        stream, so it lands before any later scatter or decode write."""
        cache = self.state.cache
        si, di = self._index(src), self._index(dst)
        for key in ("k", "v"):
            pool = cache[key]
            pool.index_copy_(1, di, pool.index_select(1, si))

    def _scatter(self, fidx: np.ndarray, parts: Dict[str, torch.Tensor],
                 sidx: Optional[np.ndarray] = None) -> None:
        """Write prefilled KV into the pool at flat slots ``fidx``
        (block * block_size + offset).  ``parts`` k/v are (L, N, KV, dh),
        or (L, B, S, KV, dh) read at flat rows ``sidx`` of B * S."""
        cache = self.state.cache
        fi = self._index(fidx)
        si = None if sidx is None else self._index(sidx)
        for key in ("k", "v"):
            pool = cache[key]
            nl = pool.shape[0]
            part = parts[key]
            src = part.reshape((nl, -1) + tuple(part.shape[-2:]))
            src = src[:, si] if si is not None else src[:, :len(fidx)]
            pool.view((nl, -1) + pool.shape[3:])[:, fi] = src.to(pool.dtype)

    def _publish_tables(self, slots: Sequence[int],
                        tables: Sequence[Sequence[int]]) -> None:
        """Write the device block-table rows of ``slots``."""
        rows = np.zeros((len(slots), self.max_blocks), np.int32)
        for i, bids in enumerate(tables):
            rows[i, :len(bids)] = bids
        self.state.cache["block_tables"][self._index(slots)] = \
            torch.as_tensor(rows, device=self.device)

    @_device_call
    def prefill_batch(self, sessions: List[Session],
                      padded_len: int) -> None:
        if self.supports_packed_prefill():
            # one flat dispatch for the whole admission group, prefix
            # hits included
            self.prefill_pack(sessions, [])
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
        slots = self._open_slots()[:len(sessions)]
        if len(slots) != len(sessions):
            raise RuntimeError("admitted beyond free slots")
        btm = self.block_table
        matches = self._match(sessions)
        if btm is not None:
            self._check_capacity(sessions, matches, "prefill batch",
                                 "batch")
        # ragged prefill is unsupported for SSM state, so SSM/hybrid
        # admissions run as equal-prompt-length sub-batches; prefix-cache
        # hits group by cached length (one suffix pass per distinct
        # shared-prefix length); otherwise the whole right-padded group
        # prefills at once
        if eng.cfg.family in SSM_FAMILIES:
            groups: Dict[int, List[int]] = {}
            for i, s in enumerate(sessions):
                groups.setdefault(s.seq_len, []).append(i)
            parts = list(groups.values())
        elif matches is not None:
            groups = {}
            for i, m in enumerate(matches):
                groups.setdefault(m.cached_tokens, []).append(i)
            parts = list(groups.values())
        else:
            parts = [list(range(len(sessions)))]
        try:
            for part in parts:
                p_sessions = [sessions[i] for i in part]
                p_slots = [slots[i] for i in part]
                p_matches = [matches[i] for i in part] \
                    if matches is not None else None
                cached = p_matches[0].cached_tokens if p_matches else 0
                common = dict(
                    max_new_tokens=[s.max_new_tokens for s in p_sessions],
                    eos_id=[s.eos_id for s in p_sessions],
                    cap_new=self.cap_new,
                    sampling=[s.params for s in p_sessions])
                if cached:
                    pk, pv = self._gather_prefix(p_matches, cached)
                    rows = eng._prefill_suffix_batch(
                        [list(s.prompt) for s in p_sessions],
                        eng.prefill_cells, prefix_k=pk, prefix_v=pv,
                        prefix_len=cached, **common)
                else:
                    rows = eng._prefill_batch(
                        [list(s.prompt) for s in p_sessions],
                        eng.prefill_cells,
                        max_len=need if btm is not None else self.max_len,
                        prompt_kv_only=btm is not None, **common)
                if btm is not None:
                    self._splice_paged(rows, p_slots, p_sessions, p_matches)
                else:
                    self._splice(rows, p_slots)
                self.prefill_dispatches += 1
                self.prefill_tokens += sum(s.seq_len - cached
                                           for s in p_sessions)
                for s in p_sessions:
                    s.cached_tokens = cached
        except Exception:
            if btm is not None:
                self._release_tables(sessions, slots, matches)
            raise
        now = self.clock()
        per_tok = kv_bytes_per_token(eng.cfg)
        for slot, s in zip(slots, sessions):
            self.sessions[slot] = s
            self._slot_len[slot] = s.seq_len
            eng.kv_slab.allocate(s.req_id, max(per_tok * s.total_len, 1),
                                 tokens=s.total_len)
            s.start_decode(now, slot=slot)
        if self.prefix_cache is not None:
            self._donate_prompts(sessions)
        # a budget-1 or instant-EOS prompt may be done already
        self._sync()
        self._publish_stream()     # the prefill's seed token streams too

    # -- chunked prefill -------------------------------------------------
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill scatters each chunk's KV into the request's
        own pool blocks, so it needs the paged layout (the contiguous
        slot cache has no per-request home for a half-built prompt)."""
        return self.kv_layout == "paged"

    def supports_fused_chunk_decode(self) -> bool:
        """Non-final prefill chunks are pure device work — gather the
        prefix KV, run the suffix pass, scatter — with no host sync, so
        the inherited ``chunk_decode_tick`` (chunk then decode tick)
        queues both back to back and the decode batch never waits on the
        chunk's completion."""
        return self.kv_layout == "paged"

    def chunk_quantum(self) -> int:
        return self.block_size

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

    def _check_chunk(self, s: Session, upto: int) -> None:
        off = s.prefilled_tokens
        if s.req_id not in self._chunk_slots:
            raise ValueError(f"session {s.req_id} has no chunked prefill "
                             "in flight")
        if not off < upto <= s.seq_len:
            raise ValueError(f"chunk [{off}, {upto}) out of range for "
                             f"prompt length {s.seq_len}")

    def _ensure_chunk_blocks(self, s: Session, upto: int) -> List[int]:
        """Blocks covering the chunk (the final one also covers the
        first decode write), drawn from the admission's reservation so
        they cannot exhaust the pool.  Returns the session's table."""
        btm = self.block_table
        cover = min(s.seq_len + 1, s.total_len) if upto == s.seq_len \
            else upto
        fresh = btm.ensure(s.req_id, cover)
        if fresh:
            self._reserved[s.req_id] = max(
                self._reserved[s.req_id] - len(fresh), 0)
        return btm.block_table(s.req_id)

    @_device_call
    def prefill_pack(self, admissions: List[Session],
                     chunks: Sequence[Tuple[Session, int]],
                     decoding: Optional[List[Session]] = None) -> None:
        """ONE packed dispatch serving a whole pack group: ``admissions``
        (newly planned sessions — whole prompts, or the uncached suffixes
        of prefix-cache hits) and ``chunks`` (``(session, upto)``
        next-chunk advances of resumable prefills), concatenated with
        segment ids and per-token positions, prefilled once
        (`InferenceEngine.prefill_packed_flat`, with every hit's and
        chunk's prefix as prefix keys), then scattered into each
        session's own block table in one scatter
        (`sanitizer.check_write` on every segment's exact block range).
        Admissions and final chunks seed their decode rows from their
        segment's last-token logits and splice into the slot cache
        together.

        ``decoding`` (only legal when nothing in the pack splices) runs
        the decode tick right behind the pack, as ``chunk_decode_tick``
        does."""
        eng = self.engine
        if not self.supports_packed_prefill():
            raise ValueError("packed prefill requires kv_layout='paged' "
                             "with packed_prefill enabled")
        chunks = list(chunks)
        if not admissions and not chunks:
            return
        # the segment-id row caps at the ladder's top batch bucket; a
        # group composed past it splits into ladder-sized packs
        cap = eng.ladder.batch_buckets[-1]
        if len(admissions) + len(chunks) > cap:
            work = [("a", s) for s in admissions] + \
                [("c", c) for c in chunks]
            for at in range(0, len(work), cap):
                grp = work[at:at + cap]
                last = at + cap >= len(work)
                self.prefill_pack([w for k, w in grp if k == "a"],
                                  [w for k, w in grp if k == "c"],
                                  decoding if last else None)
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
        for s, upto in chunks:
            self._check_chunk(s, upto)
        finals_due = any(upto == s.seq_len for s, upto in chunks)
        if decoding is not None and (admissions or finals_due):
            raise ValueError("prefill_pack: a decode tick fuses only behind "
                             "a pack that splices nothing")
        if admissions:
            self._ensure_state(eng.ladder.seq_bucket(
                max(s.total_len for s in admissions)))
        slots = self._open_slots()[:len(admissions)]
        if len(slots) != len(admissions):
            raise RuntimeError("admitted beyond free slots")
        btm = self.block_table
        matches = self._match(admissions)
        if admissions:
            self._check_capacity(admissions, matches, "packed prefill",
                                 "pack")
        chunk_tables = [self._ensure_chunk_blocks(s, upto)
                        for s, upto in chunks]
        # ---- segment descriptors: admissions first, then chunks -------
        bs = self.block_size
        suffixes: List[List[int]] = []
        offsets: List[int] = []
        pre_fidx: List[np.ndarray] = []
        pre_seg: List[np.ndarray] = []
        pre_pos: List[np.ndarray] = []

        def add_prefix(seg: int, blocks: List[int], length: int) -> None:
            pre_fidx.append(self._slots(blocks, 0, length))
            pre_seg.append(np.full((length,), seg, np.int32))
            pre_pos.append(np.arange(length, dtype=np.int32))

        for i, s in enumerate(admissions):
            cached = matches[i].cached_tokens if matches else 0
            suffixes.append(list(s.prompt)[cached:])
            offsets.append(cached)
            if cached:
                blocks = list(matches[i].full_blocks)
                if matches[i].tail_block is not None:
                    blocks.append(matches[i].tail_block)
                add_prefix(i, blocks, cached)
        for j, ((s, upto), table) in enumerate(zip(chunks, chunk_tables)):
            off = s.prefilled_tokens
            suffixes.append(list(s.prompt)[off:upto])
            offsets.append(off)
            if off:
                add_prefix(len(admissions) + j, table, off)
        # ---- every segment's prefix KV in one pool read, straight into
        # the cell's inputs ----------------------------------------------
        no_ids = np.zeros((0,), np.int32)
        pre_slots = np.concatenate(pre_fidx) if pre_fidx else no_ids
        prefix_k, prefix_v = self._prefix_fills(pre_slots,
                                                (len(pre_slots),))
        prefix_seg = np.concatenate(pre_seg) if pre_seg else no_ids
        prefix_pos = np.concatenate(pre_pos) if pre_pos else no_ids
        try:
            # ---- THE dispatch --------------------------------------------
            logits, parts = eng._prefill_packed_flat(
                suffixes, offsets, eng.prefill_cells, prefix_k, prefix_v,
                prefix_seg, prefix_pos)
            # ---- admission tables (prefix refs adopted, tail copied) and
            # every segment's scatter target -------------------------------
            seg_bids: List[List[int]] = []
            for i, s in enumerate(admissions):
                _, prefix_blocks = self._adopt_match(
                    matches[i] if matches is not None else None)
                seg_bids.append(self._allocate(
                    s, min(s.seq_len + 1, s.total_len), prefix_blocks))
            seg_bids += chunk_tables
            spans = [(s, off, s.seq_len)
                     for s, off in zip(admissions, offsets)] + \
                [(s, s.prefilled_tokens, upto) for s, upto in chunks]
            tgt: List[np.ndarray] = []
            pack_ledger: Dict[int, List[int]] = {}
            written: set = set()
            for (s, off, end), bids in zip(spans, seg_bids):
                seg_blocks = bids[off // bs:(end - 1) // bs + 1]
                sanitizer.check_write(btm, s.req_id, seg_blocks)
                overlap = [b for b in seg_blocks if b in written]
                if overlap:
                    raise sanitizer.SanitizerError(
                        f"pack segments overlap on blocks {overlap} "
                        f"(session {s.req_id}) — cross-request KV "
                        "corruption")
                written.update(seg_blocks)
                pack_ledger[s.req_id] = list(seg_blocks)
                tgt.append(self._slots(bids, off, end))
            # ---- ONE scatter: the flat pack lines up with the
            # concatenated per-segment targets -----------------------------
            flat = sum(len(x) for x in suffixes)
            self._scatter(np.concatenate(tgt), parts)
            # ---- splice decode rows: admissions + final chunks ------------
            splicers: List[Tuple[int, int, Session]] = [
                (i, slot, s) for i, (slot, s) in
                enumerate(zip(slots, admissions))]
            for j, (s, upto) in enumerate(chunks):
                if upto == s.seq_len:
                    splicers.append((len(admissions) + j,
                                     self._chunk_slots[s.req_id], s))
            if splicers:
                ns = len(splicers)
                batch_b = eng.ladder.batch_bucket(ns)
                sel = self._index([seg for seg, _, _ in splicers] +
                                  [0] * (batch_b - ns))
                ctl = {"len": eng._tensor(
                    [s.seq_len for _, _, s in splicers] +
                    [1] * (batch_b - ns), torch.int32),
                    "pos_offset": torch.zeros((batch_b,), dtype=torch.int32,
                                              device=self.device)}
                rows = eng._finish_gen_state(
                    logits[sel], ctl, ns, batch_b,
                    budgets=[s.max_new_tokens for _, _, s in splicers],
                    eos_ids=[s.eos_id for _, _, s in splicers],
                    cap=self.cap_new,
                    sampling=[s.params for _, _, s in splicers])
                self._publish_tables([slot for _, slot, _ in splicers],
                                     [seg_bids[seg] for seg, _, _ in
                                      splicers])
                self._splice_rows(rows, self._index(
                    [slot for _, slot, _ in splicers]), ns)
        except Exception:
            # free the admissions' tables and holds and neutralize their
            # rows; chunk sessions keep their reservations — the pipeline
            # aborts them explicitly
            self._release_tables(admissions, slots, matches)
            raise
        # ---- host bookkeeping --------------------------------------------
        self._last_pack = pack_ledger
        self.prefill_dispatches += 1
        self.pack_dispatches += 1
        self.pack_segments += len(suffixes)
        self.prefill_tokens += flat
        self.pack_log.append((len(suffixes), flat,
                              eng.ladder.pack_bucket(flat)))
        now = self.clock()
        per_tok = kv_bytes_per_token(eng.cfg)
        for i, (slot, s) in enumerate(zip(slots, admissions)):
            s.cached_tokens = offsets[i]
            self.sessions[slot] = s
            self._slot_len[slot] = s.seq_len
            eng.kv_slab.allocate(s.req_id, max(per_tok * s.total_len, 1),
                                 tokens=s.total_len)
            s.start_decode(now, slot=slot)
        finals: List[Session] = []
        for s, upto in chunks:
            s.prefilled_tokens = upto
            if upto == s.seq_len:
                slot = self._chunk_slots.pop(s.req_id)
                self.sessions[slot] = s
                self._slot_len[slot] = s.seq_len
                s.start_decode(now, slot=slot)
                finals.append(s)
        if self.prefix_cache is not None and (admissions or finals):
            self._donate_prompts(list(admissions) + finals)
        if admissions or finals:
            # a budget-1 or instant-EOS prompt may be done already
            self._sync()
            self._publish_stream()
        if decoding is not None:
            self.decode_tick(decoding)

    @_device_call
    def begin_prefill_chunks(self, session: Session) -> None:
        """Reserve everything the resumable prefill will need — a decode
        slot and blocks/reservations covering the WHOLE prompt + first
        decode write — before any chunk runs, so no chunk can fail on
        capacity mid-prompt.  With the prefix cache on, the matched
        prefix maps in here (tail copy-on-write included) and
        ``session.prefilled_tokens`` starts at the cached length: the
        chunks only cover the uncached remainder."""
        if self.kv_layout != "paged":
            raise ValueError("chunked prefill requires kv_layout='paged'")
        eng = self.engine
        if eng.kv_slab.has_region(session.req_id):
            raise ValueError(f"req_id {session.req_id} already holds a "
                             "KV region (duplicate in-flight submission?)")
        self._ensure_state(eng.ladder.seq_bucket(session.total_len))
        free = self._open_slots()
        if not free:
            raise RuntimeError("chunked admission beyond free slots")
        matches = self._match([session])
        self._check_capacity([session], matches, "chunked prefill",
                             "session")
        cached, prefix_blocks = self._adopt_match(
            matches[0] if matches else None)
        self._allocate(session, max(cached, 1), prefix_blocks)
        self._chunk_slots[session.req_id] = free[0]
        per_tok = kv_bytes_per_token(eng.cfg)
        eng.kv_slab.allocate(session.req_id,
                             max(per_tok * session.total_len, 1),
                             tokens=session.total_len)
        session.cached_tokens = cached
        session.prefilled_tokens = cached

    @_device_call
    def prefill_chunk(self, session: Session, upto: int) -> None:
        """One resumable-prefill pass over prompt positions
        ``[prefilled_tokens, upto)``: gather the already-built prefix KV
        from the session's own blocks, run the suffix pass at that
        offset (causal attention continued across the chunk seam), and
        scatter the chunk's KV into the session's blocks.  The final
        chunk (``upto == seq_len``) seeds the decode row from its
        last-token logits and splices it into the reserved slot."""
        eng = self.engine
        req = session.req_id
        off = session.prefilled_tokens
        self._check_chunk(session, upto)
        final = upto == session.seq_len
        bids = self._ensure_chunk_blocks(session, upto)
        # the left side of the chunk seam, from the request's own blocks
        pk, pv = self._prefix_fills(self._slots(bids, 0, off), (1, off))
        rows = eng._prefill_suffix_batch(
            [list(session.prompt)[:upto]], eng.prefill_cells, prefix_k=pk,
            prefix_v=pv, prefix_len=off,
            max_new_tokens=[session.max_new_tokens],
            eos_id=[session.eos_id], cap_new=self.cap_new,
            sampling=[session.params])
        bs = self.block_size
        # sanitizer: the chunk scatters into exactly these blocks
        sanitizer.check_write(self.block_table, req,
                              bids[off // bs:(upto - 1) // bs + 1])
        self._scatter(self._slots(bids, off, upto), rows.cache,
                      np.arange(upto - off))
        session.prefilled_tokens = upto
        self.prefill_dispatches += 1
        self.prefill_tokens += upto - off
        if not final:
            return
        # final chunk: claim the reserved slot and splice the control row
        slot = self._chunk_slots.pop(req)
        self._publish_tables([slot], [bids])
        self._splice_rows(rows, self._index([slot]), 1)
        self.sessions[slot] = session
        self._slot_len[slot] = session.seq_len
        session.start_decode(self.clock(), slot=slot)
        if self.prefix_cache is not None:
            self._donate_prompts([session])
        # a budget-1 or instant-EOS prompt may be done already
        self._sync()
        self._publish_stream()

    @_device_call
    def abort_chunked(self, session: Session) -> None:
        """Drop every hold a failed (or cancelled) chunked prefill still
        has.  Its slot was never claimed and its block-table row was
        never published, so freeing the blocks is safe — no device row
        can write into them.  Matched shared-prefix blocks were adopted
        into the table at ``begin_prefill_chunks``, so ``free`` unrefs
        them back to the trie without disturbing other holders."""
        req = session.req_id
        if self.block_table is not None:
            self.block_table.free(req)
        self._reserved.pop(req, None)
        self._chunk_slots.pop(req, None)
        self._last_pack.pop(req, None)
        if self.engine.kv_slab.has_region(req):
            self.engine.kv_slab.free(req)
            self.engine.kv_slab.gc()

    def _release_tables(self, sessions: List[Session], slots: List[int],
                        matches: Optional[List[PrefixMatch]] = None
                        ) -> None:
        """After a failed paged prefill: free whatever tables the batch
        got, give back match holds never adopted, and neutralize their
        device rows (trash-block tables, done) so freed blocks can be
        reallocated without a stale row writing into them."""
        btm = self.block_table
        bad_slots: List[int] = []
        for i, s in enumerate(sessions):
            if btm.has_request(s.req_id):
                bad_slots.append(slots[i])
                btm.free(s.req_id)
                self._reserved.pop(s.req_id, None)
            if matches is not None:
                self.prefix_cache.release(matches[i])
        if bad_slots and self.state is not None:
            idx = self._index(bad_slots)
            self.state.cache["block_tables"][idx] = 0
            self.state.done[idx] = True

    @_device_call
    def decode_tick(self, sessions: List[Session]) -> None:
        if self.block_table is not None:
            self._append_blocks()
        self._run_tick()
        self.decode_ticks += 1
        self._since_sync += 1
        if self._since_sync >= self.sync_every:
            self._sync()
        self._publish_stream()

    def _run_tick(self) -> None:
        """One in-place decode tick of the slot state: on the card a
        replay of its cell's graph (captured here on first use, like the
        JAX package's first-hit compile), on the CPU the same tick run
        eagerly."""
        if self.device.type == "cuda":
            if self.tick_cells.run(self.state):
                self.engine.compile_count += 1
        else:
            self.engine.decode_step_inplace(self.state)

    def _publish_stream(self) -> None:
        """Incremental token delivery for streaming sessions: one small
        host read of the counts/emitted buffers per tick, and none when
        no occupied slot streams."""
        wanted = [(slot, s) for slot, s in enumerate(self.sessions)
                  if s is not None and s.stream]
        if not wanted:
            return
        # turbolint: allow-sync(per-tick streaming flush for stream=True rows)
        counts = _host(self.state.counts)
        # turbolint: allow-sync(per-tick streaming flush for stream=True rows)
        emitted = _host(self.state.emitted)
        for slot, s in wanted:
            s.generated = [int(x) for x in emitted[slot, :counts[slot]]]

    def warmup_aot(self, progress: Optional[Callable[[int], None]] = None
                   ) -> Dict[str, float]:
        """Capture every reachable serving-path cell before the first
        request, as the JAX package's ``warmup_aot`` compiles them, by the
        reference's walk: throwaway sessions (far-negative req_ids, prefix
        cache suspended) through the real ``prefill_batch`` /
        ``decode_tick``:

        1. the slot state at its top size (``max_len``, else the top
           bucket), so later admissions keep its tensors;
        2. one sampled round per reachable (seq bucket, prompt bucket,
           admission size): each prefill cell of the admission path, and
           the eager splice and first-token sampling at every size;
        3. a greedy round per admission size, then one greedy and one
           sampled decode round (the two tick cells);
        4. on the packed path, one pack with prefix keys (the cell a
           resumable chunk's first pack needs) and one pack of one-token
           segments per admission size (the smallest pack bucket).

        On the card each first use captures its cell (prefill cells in
        ``engine.prefill_cells``, the two tick cells, by the decode
        rounds, in ``tick_cells``), and each capture counts in
        ``compile_count``; on the CPU the same rounds run eagerly.  The serving counters and ``pack_log`` are
        saved and restored, and the sampling flag is left off.  Returns
        ``{"compile_count", "warmup_seconds", "rounds"}``: the cells
        captured (0 on the CPU), the seconds and the rounds walked.
        ``progress`` (if given) is called with the cumulative round count
        after every round, as the JAX package's is."""
        eng = self.engine
        ladder = eng.ladder
        t0 = time.perf_counter()
        compiles0 = eng.compile_count
        top = self.max_len if self.max_len is not None \
            else ladder.seq_buckets[-1]
        saved = {k: getattr(self, k) for k in SERVING_COUNTERS}
        pack_log = list(self.pack_log)
        prefix_was, pc = self._prefix_enabled, self.prefix_cache
        self._prefix_enabled, self.prefix_cache = False, None
        rounds = 0

        def _bump() -> None:
            nonlocal rounds
            rounds += 1
            if progress is not None:
                progress(rounds)

        try:
            with _device_held(eng):
                self._ensure_state(top)
            seqs = [b for b in ladder.seq_buckets if b <= top]
            sizes = [n for n in range(1, self.max_slots + 1)
                     if n <= ladder.batch_buckets[-1]]
            cells = []
            for need in seqs:
                below = [b for b in seqs if b < need]
                prev = below[-1] if below else 0
                for pb in [b for b in seqs if b <= need]:
                    if pb == need:
                        plen, budget = need - 1, 1
                    else:
                        plen = pb
                        budget = prev + 1 - plen
                        if budget > self.cap_new:
                            plen = prev + 1 - self.cap_new
                            budget = self.cap_new
                    if plen < 1 or budget < 1 or budget > self.cap_new \
                            or ladder.seq_bucket(plen) != pb:
                        continue
                    cells.append((plen, budget))
            for plen, budget in cells:
                for n in sizes:
                    if self.block_table is not None:
                        bn = self.block_table.blocks_needed(plen + budget)
                        if bn * n > self.block_table.num_blocks - 1:
                            continue
                    self._warm_round(plen, budget, n, temperature=0.8)
                    _bump()
            self.state.sampling = False
            plen = max(seqs[0] - 3, 1)
            for n in sizes:
                self._warm_round(plen, 1, n, temperature=0.0)
                _bump()
            n = min(2, self.max_slots)
            for temp in (0.0, 0.8):
                self._warm_round(plen, 3, n, temperature=temp)
                _bump()
            if self.supports_packed_prefill():
                cache = self.state.cache
                shape = (cache["k"].shape[0],) + tuple(cache["k"].shape[3:])
                bs = self.block_size
                # each round under the device hold, each progress call
                # outside it (a background warm-up serves there)
                with _device_held(eng):
                    pre = torch.zeros((shape[0], 2 * bs) + shape[1:],
                                      dtype=cache["k"].dtype,
                                      device=self.device)
                    eng._prefill_packed_flat(
                        [[1] * bs, [2] * bs], [bs, bs], eng.prefill_cells,
                        pre, pre,
                        np.repeat(np.arange(2, dtype=np.int32), bs),
                        np.tile(np.arange(bs, dtype=np.int32), 2))
                _bump()
                zero = pre[:, :0]
                no_ids = np.zeros((0,), np.int32)
                for n in sizes:
                    with _device_held(eng):
                        eng._prefill_packed_flat([[1]] * n, [0] * n,
                                                 eng.prefill_cells, zero,
                                                 zero, no_ids, no_ids)
                    _bump()
        finally:
            # every warm row is done; a greedy admission must get the
            # greedy tick back
            if self.state is not None:
                self.state.sampling = False
            for k, v in saved.items():
                setattr(self, k, v)
            self.pack_log.clear()
            self.pack_log.extend(pack_log)
            self._prefix_enabled = prefix_was
            if prefix_was:
                self.prefix_cache = pc if pc is not None else \
                    RadixPrefixCache(self.block_table)
                self.prefix_cache.on_insert = self.on_prefix_insert
        self.warmup_stats = {
            "compile_count": eng.compile_count - compiles0,
            "warmup_seconds": time.perf_counter() - t0,
            "rounds": rounds}
        return self.warmup_stats

    @_device_call
    def _warm_round(self, plen: int, budget: int, n: int, *,
                    temperature: float) -> None:
        """One throwaway admission: ``n`` sessions of ``plen`` prompt
        tokens decoding ``budget`` tokens, run to completion so every
        slot frees again."""
        bucket = self.engine.ladder.seq_bucket(plen)
        sessions = []
        for j in range(n):
            rid = self._warm_id
            self._warm_id -= 1
            prompt = [(7 * j + i) % 17 + 1 for i in range(plen)]
            s = Session.from_params(rid, prompt, GenerationParams(
                max_new_tokens=budget, temperature=temperature,
                seed=j + 1))
            s.start_prefill(0.0, n, bucket)
            sessions.append(s)
        self.prefill_batch(sessions, bucket)
        for _ in range((budget + 2) * max(self.sync_every, 1) + 4):
            if all(s.is_finished for s in sessions):
                break
            self.decode_tick(sessions)
        else:
            raise RuntimeError("warmup round failed to converge")

    @_device_call
    def cancel_session(self, session: Session) -> None:
        """Tear down a mid-decode session NOW: publish its partial
        generation (one row read), release its slab region and block
        table (shared prefix blocks just lose one holder — sibling
        sequences and the prefix trie keep theirs), clear its
        reservation, and neutralize the device row (done, table -> trash)
        so its freed blocks can be reallocated without the stale row
        writing into them."""
        slot = session.slot
        if slot < 0 or self.sessions[slot] is not session:
            raise ValueError(f"session {session.req_id} holds no decode "
                             "slot")
        st = self.state
        # turbolint: allow-sync(cancellation reads the partial result once)
        counts = int(_host(st.counts[slot]))
        # turbolint: allow-sync(cancellation reads the partial result once)
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

    def _slots(self, blocks: Sequence[int], start: int,
               end: int) -> np.ndarray:
        """Flat pool slots (block * block_size + offset) of positions
        ``[start, end)`` of a request whose table is ``blocks``."""
        bs = self.block_size
        pos = np.arange(start, end)
        return np.asarray(blocks, np.int64)[pos // bs] * bs + pos % bs

    def _prefix_fills(self, slots: np.ndarray, dims: Tuple[int, ...]
                      ) -> Tuple[Fill, Fill]:
        """The pool's KV at flat ``slots`` as two cell inputs (L, *dims,
        KV, dh), where ``dims`` (rows, tokens a row) or (tokens,) hold
        ``len(slots)`` positions in the order of ``slots``: each gathers
        its pool's slots straight into the tensor it is given (one
        ``index_select``, in the pool's dtype)."""
        idx = self._index(slots)
        fills = []
        for key in ("k", "v"):
            pool = self.state.cache[key]
            src = pool.view((pool.shape[0], -1) + pool.shape[3:])
            shape = (pool.shape[0],) + tuple(dims) + tuple(pool.shape[3:])

            def write(t, src=src):
                torch.index_select(src, 1, idx, out=t.view(
                    (src.shape[0], len(slots)) + src.shape[2:]))
            fills.append(Fill(shape, pool.dtype, write))
        return fills[0], fills[1]

    def _gather_prefix(self, matches: List[PrefixMatch], cached: int
                       ) -> Tuple[Fill, Fill]:
        """The matched prefix KV of a suffix-prefill group, (L, B,
        cached, KV, dh): each session's matched blocks, read from the
        pool up to the exact cached length."""
        slots = [self._slots(list(m.full_blocks) +
                             ([m.tail_block] if m.tail_block is not None
                              else []), 0, cached) for m in matches]
        return self._prefix_fills(np.concatenate(slots),
                                  (len(matches), cached))

    def _donate_prompts(self, sessions: List[Session]) -> None:
        """Donate every admitted prompt to the trie.  A donated partial
        tail makes the owner's first decode write copy-on-write, which
        needs one extra block later — so the tail is donated only when
        that block can be reserved NOW (evicting warm cache if needed);
        otherwise only the full-block prefix is cached.  This keeps the
        reservation invariant (free blocks always cover reservations)
        without charging speculative COW blocks at admission."""
        btm = self.block_table
        bs = self.block_size
        for s in sessions:
            table = btm.block_table(s.req_id)
            tokens = list(s.prompt)
            donate_tail = bool(s.seq_len % bs) and s.max_new_tokens > 0
            if donate_tail:
                deficit = sum(self._reserved.values()) + 1 - \
                    btm.free_blocks
                if deficit > 0:
                    self.prefix_cache.evict(deficit)
                if sum(self._reserved.values()) + 1 <= btm.free_blocks:
                    self._reserved[s.req_id] += 1
                else:
                    donate_tail = False
            if not donate_tail and s.seq_len % bs:
                tokens = tokens[:(s.seq_len // bs) * bs]
            self.prefix_cache.insert(tokens, table)
            if donate_tail:
                tail = table[(s.seq_len - 1) // bs]
                if btm.ref_count(tail) == 1:
                    # tail deduped against an existing node: the owner
                    # keeps writing its private block, no COW coming
                    self._reserved[s.req_id] -= 1

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
            if self._prefix_enabled and self.prefix_cache is None:
                self.prefix_cache = RadixPrefixCache(self.block_table)
                self.prefix_cache.on_insert = self.on_prefix_insert
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
        sequence axis (zero-padded), keeping every row's KV: k/v, and
        the hybrid's shared_k/shared_v (an SSM model's conv and scan
        state have no sequence axis)."""
        cache = self.state.cache
        for key in [k for k in SEQ_LEAVES if k in cache]:
            old = cache[key]
            shape = old.shape[:2] + (need_len,) + old.shape[3:]
            new = torch.zeros(shape, dtype=old.dtype, device=old.device)
            new[:, :, :old.shape[2]] = old
            cache[key] = new
        self.max_len = need_len

    def _splice(self, rows: GenState, slots: List[int]) -> None:
        """Contiguous layout: copy the first ``len(slots)`` rows of a
        freshly prefilled state (a ``max_len`` cache) into the slot
        cache's rows, whole (every per-row leaf: k/v, or an SSM model's
        conv, state and shared_k/shared_v), so nothing of a slot's last
        occupant survives."""
        idx = self._index(slots)
        k = len(slots)
        cache = self.state.cache
        for key in [k for k in cache if k not in _BATCH_AXIS0]:
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
                      sessions: List[Session],
                      matches: Optional[List[PrefixMatch]] = None) -> None:
        """Allocate block tables for newly admitted sessions and scatter
        their prefilled KV from the prefill parts into the pool (one
        scatter for the whole batch); existing rows' blocks are
        untouched.  With prefix matches, a session's table opens with the
        matched shared blocks (a partially valid tail copied first), and
        only the uncached suffix KV is scattered."""
        bs = self.block_size
        flat: List[np.ndarray] = []
        src_rows: List[np.ndarray] = []
        tables: List[List[int]] = []
        s_pad = rows.cache["k"].shape[2]
        for i, s in enumerate(sessions):
            cached, prefix_blocks = self._adopt_match(
                matches[i] if matches is not None else None)
            # blocks covering the prompt plus the first decode write; the
            # rest of the budget is reserved and appended mid-decode
            bids = self._allocate(s, min(s.seq_len + 1, s.total_len),
                                  prefix_blocks)
            sanitizer.check_write(self.block_table, s.req_id,
                                  bids[cached // bs:(s.seq_len - 1) // bs +
                                       1])
            flat.append(self._slots(bids, cached, s.seq_len))
            src_rows.append(i * s_pad + np.arange(s.seq_len - cached))
            tables.append(bids)
        self._scatter(np.concatenate(flat), rows.cache,
                      np.concatenate(src_rows))
        self._publish_tables(slots, tables)
        self._splice_rows(rows, self._index(slots), len(slots))

    def _append_blocks(self) -> None:
        """Before a decode tick: every occupied slot is about to write KV
        at its current length — append a pool block to any row crossing
        a block boundary and publish it in the device block table.  With
        the prefix cache on, a row whose write position lands in a block
        other holders also map (its own prompt tail donated to the trie,
        e.g.) copies that block first: copy-on-write keeps shared prompt
        KV immutable, and the copy is queued before the tick's write."""
        btm = self.block_table
        upd_slots: List[int] = []
        upd_idx: List[int] = []
        upd_bid: List[int] = []
        cow_old: List[int] = []
        cow_new: List[int] = []
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
            elif self.prefix_cache is not None:
                bidx = pos // self.block_size
                bid = btm.block_table(s.req_id)[bidx]
                if btm.ref_count(bid) > 1:
                    new = btm.copy_on_write(s.req_id, bidx)
                    self._reserved[s.req_id] = max(
                        self._reserved.get(s.req_id, 0) - 1, 0)
                    self.cow_blocks += 1
                    if s.req_id in self._last_pack:
                        # the packed KV was copied with the block: the
                        # ledger follows ownership to the private copy
                        self._last_pack[s.req_id] = [
                            new if b == bid else b
                            for b in self._last_pack[s.req_id]]
                    cow_old.append(bid)
                    cow_new.append(new)
                    upd_slots.append(slot)
                    upd_idx.append(bidx)
                    upd_bid.append(new)
            self._slot_len[slot] = pos + 1
        if cow_old:
            self._copy_blocks(cow_old, cow_new)
        if upd_slots:
            tables = self.state.cache["block_tables"]
            tables[self._index(upd_slots), self._index(upd_idx)] = \
                torch.as_tensor(np.asarray(upd_bid, np.int32),
                                device=self.device)

    def _sync(self) -> None:
        """Flush: read the (tiny) stop flags; only when an occupied slot
        newly finished is the token buffer transferred."""
        self._since_sync = 0
        st = self.state
        done = _host(st.done)  # turbolint: allow-sync(stop-flag flush every sync_every ticks)
        if not any(done[slot] for slot, s in enumerate(self.sessions)
                   if s is not None):
            return
        # turbolint: allow-sync(finished rows only: the once-per-generation flush)
        counts = _host(st.counts)
        # turbolint: allow-sync(finished rows only: the once-per-generation flush)
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

    @property
    def kv_footprint_tokens(self) -> int:
        """Token capacity of the KV actually held: live paged blocks
        (cached prefix blocks included — they occupy pool capacity until
        evicted), or the contiguous slab's live reservations."""
        if self.block_table is not None:
            return self.block_table.footprint_tokens
        return self.engine.kv_slab.live_tokens

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache telemetry plus engine-side integration counters
        (empty when prefix caching is off or the pool does not exist
        yet)."""
        if self.prefix_cache is None:
            return {}
        out = self.prefix_cache.stats()
        out["cow_blocks"] = self.cow_blocks
        out["prefill_tokens"] = self.prefill_tokens
        return out
