"""CUDA graphs of the continuous engine's decode tick.

The port's counterpart of the JAX package's compiled tick cells
(`InferenceEngine._tick_fn` in src/repro/runtime/engine.py, kept in its
``_decode_cache``): where the reference jits one tick per ``sampling``
flag, the port captures the in-place tick
(`repro_torch.runtime.engine.InferenceEngine.decode_step_inplace`) into
one `torch.cuda.CUDAGraph` per cell and replays it, so the host issues
one graph launch a tick instead of some two thousand kernel launches.

A cell is keyed by ``sampling`` and by the data pointer, shape, stride
and dtype of every state tensor the tick touches.  A graph therefore
never replays against other tensors than those it was captured on: when
the state's tensors change (the contiguous layout's grow replaces
``k``/``v``), every cell captured on the old ones is dropped, and the next
tick captures its cell anew.  The cells share one memory pool and one
capture stream.

Before a capture the tick runs once on the capture stream, on a copy of
the control tensors with every row done, so cuBLAS's handle and
workspace and the decode kernel's merge tickets exist for that stream.
A done row writes KV only at its frozen length, which is what the next
real tick writes there anyway (or the trash block, for a free slot), and
the copy takes every other write.  The capture itself runs nothing.
Nothing here falls back to the eager tick: a failed capture, a stale key
or merge tickets too few under capture raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_decode import reserve_tickets

#: the control tensors of a GenState that the tick reads or writes
CONTROL = ("cur", "emitted", "counts", "done", "budget", "eos", "temp",
           "top_k", "top_p", "seed")


def signature(state) -> Tuple:
    """(name, data pointer, shape, stride, dtype) of every tensor of
    ``state`` the tick touches: its cache's and its control tensors."""
    named = sorted(state.cache.items()) + \
        [(name, getattr(state, name)) for name in CONTROL]
    return tuple((name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for name, t in named)


def warm_copy(state):
    """``state`` with its own copy of every control tensor the tick
    writes and every row done; the KV tensors are shared."""
    cache = dict(state.cache, len=state.cache["len"].clone())
    return dataclasses.replace(
        state, cache=cache, cur=state.cur.clone(),
        emitted=state.emitted.clone(), counts=state.counts.clone(),
        done=torch.ones_like(state.done))


@dataclasses.dataclass
class TickCell:
    """One captured tick: its key, its graph, what one replay launches
    (by wrapper and shape class) and the merge tickets it launches
    with."""
    key: Tuple
    graph: torch.cuda.CUDAGraph
    launches: Dict[tuple, int]
    tickets: torch.Tensor

    def replay(self, key: Tuple) -> None:
        if key != self.key:
            raise RuntimeError("stale tick cell: the state's tensors are "
                               "not those the graph was captured on")
        self.graph.replay()
        cuda_lib.add_launches(self.launches)


class TickCells:
    """The cell table of one engine state: at most one graph per
    ``sampling`` flag, all captured on the same tensors.  ``tick`` is the
    in-place tick, a function of the state alone."""

    def __init__(self, tick: Callable[[object], None]) -> None:
        self._tick = tick
        self._cells: Dict[bool, TickCell] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0            # cells captured, dropped ones too
        self.warm_ticks = 0          # eager ticks run before captures
        self.capture_seconds = 0.0   # warm-up and capture, all cells

    def __len__(self) -> int:
        return len(self._cells)

    def cell(self, state) -> Tuple[TickCell, Tuple, bool]:
        """``state``'s cell, captured first where the table lacks it, its
        key, and whether this call captured it."""
        sig = signature(state)
        for flag in [f for f, c in self._cells.items() if c.key[1] != sig]:
            del self._cells[flag]      # captured on tensors now gone
        key = (state.sampling, sig)
        found = self._cells.get(state.sampling)
        if found is not None:
            return found, key, False
        cell = self._capture(state, key)
        self._cells[state.sampling] = cell
        return cell, key, True

    def run(self, state) -> bool:
        """One tick of ``state`` as a graph replay; True when its cell was
        captured by this call."""
        cell, key, captured = self.cell(state)
        cell.replay(key)
        return captured

    def pool_bytes(self) -> int:
        """Device memory held by the cells' pool (its segments' bytes)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _capture(self, state, key: Tuple) -> TickCell:
        dev = state.cur.device
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(dev)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            tickets = reserve_tickets(
                dev, state.cur.shape[0] * state.cache["k"].shape[3])
            self._tick(warm_copy(state))
        self.warm_ticks += 1
        graph = torch.cuda.CUDAGraph()
        with cuda_lib.recording() as launches:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                self._tick(state)
        main.wait_stream(self._stream)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return TickCell(key, graph, dict(launches), tickets)
