"""CUDA graphs of the engine's compiled cells.

The port's counterpart of the JAX package's compiled cells
(src/repro/runtime/engine.py): where the reference jits a function once
per cell key and reuses the executable, the port captures one
`torch.cuda.CUDAGraph` per cell and replays it, so the host makes one
graph launch where the eager function makes a thousand and more kernel
launches.  Two kinds of cells:

- :class:`TickCells`, the decode tick (the reference's ``_tick_fn``
  cells in its ``_decode_cache``): the in-place tick
  (`repro_torch.runtime.engine.InferenceEngine.decode_step_inplace`) per
  ``sampling`` flag, keyed also by the data pointer, shape, stride and
  dtype of every state tensor the tick touches.  A graph therefore never
  replays against other tensors than those it was captured on: when the
  state's tensors change (the contiguous layout's grow replaces
  ``k``/``v``), every cell captured on the old ones is dropped, and the
  next tick captures its cell anew.  Before a capture the tick runs once
  on the capture stream, on a copy of the control tensors with every row
  done, so cuBLAS's handle and workspace and the decode kernel's merge
  tickets exist for that stream.  A done row writes KV only at its frozen
  length, which is what the next real tick writes there anyway (or the
  trash block, for a free slot), and the copy takes every other write.
  An SSM model's step writes every row's conv window and scan state
  whether done or not, so the copy has its own of those as well (and
  the hybrid's KV write at the frozen length then sees the same state
  the real tick will).
- :class:`CellTable`, pure functions of device tensors: the reference's
  classify, per-group prefill, suffix and packed prefill cells
  (``_classify_fn``, ``_prefill_fn``, ``_suffix_fn``, ``_packed_fn``),
  each keyed by the reference's key tuple for its kind.  A call writes
  the host-built inputs into the cell's static inputs and replays the
  graph.  The first call of a key runs the function eagerly on the
  capture stream with those inputs (so cuBLAS's handle and workspace
  exist there), returns that result, and captures the cell for the next
  call.  On the CPU a table only records the keys it was asked for and
  runs the function eagerly on tensors of its own.

Where the cells' memory lives (:class:`CellArena`, one per engine).  The
graphs of one engine's tables share one pool, which holds only their
intermediates: each capture reuses what the previous ones freed.  Static
inputs and outputs are views at the start of one buffer per (input or
output name, dtype), shared by every cell of the engine; a buffer too
small for a new cell is replaced by one of at least twice its size, and
the cells made on the old one keep it.  So the bytes held grow with the
largest cell, not with the number of cells: the buffers of one name hold
together less than twice the newest one, which holds less than twice
the largest cell's need, whatever the number of cells.  The rule that
follows: **an output is
valid until the next call of any cell of the same engine.**  The
continuous engine consumes each prefill's outputs (scatter, splice, the
first token) before its next prefill; the engine's public methods run
the same functions eagerly on tensors of their own.

Every capture runs with Python's cyclic collector held off
(:func:`collector_held`), so no collection can destroy another graph
while a stream captures.  The hold is counted process-wide: where two
threads hold it, the collector comes back on only when the last leaves.

Captures and other device work are exclusive (:data:`DEVICE_GATE`).  A
capture runs in CUDA's global capture mode, where a ``cudaMalloc``, a
synchronization or a graph's destruction from ANY thread fails the
capture ("operation not permitted when stream is capturing"), and
``torch.cuda.graph`` itself synchronizes the device and empties the
caching allocator before it begins.  Replicas of a pool tick on their
own threads and a background warm-up captures on its own, so every
device-facing call of the engines holds the gate shared, and a capture
holds it alone: it waits until every other thread has left its device
call, and no other thread enters one until the capture ends.

Nothing here falls back to the eager function: a failed capture, a
stale key (the engine's weights are not those the graph was captured
on), an input whose shape or dtype differs from the cell's, or merge
tickets too few under capture raise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_decode import reserve_tickets

#: the control tensors of a GenState that the tick reads or writes
CONTROL = ("cur", "emitted", "counts", "done", "budget", "eos", "temp",
           "top_k", "top_p", "seed")


def decode_heads(cache: Dict[str, torch.Tensor]) -> int:
    """KV heads a row of ``cache``'s decode attention reads (a KV leaf's
    axis 3: (L or n_apps, B, S, KV, dh) or a pool's (L, NB, BS, KV, dh));
    0 for an attention-free model."""
    for name in ("k", "shared_k"):
        if name in cache:
            return cache[name].shape[3]
    return 0


def signature(state) -> Tuple:
    """(name, data pointer, shape, stride, dtype) of every tensor of
    ``state`` the tick touches: its cache's and its control tensors."""
    named = sorted(state.cache.items()) + \
        [(name, getattr(state, name)) for name in CONTROL]
    return tuple((name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for name, t in named)


#: cache leaves a tick writes on every row, done or not (an SSM model's
#: conv window and scan state)
STEP_STATE = ("conv", "state")


def warm_copy(state):
    """``state`` with its own copy of every control tensor the tick
    writes, and of an SSM model's state, and every row done; the KV
    tensors are shared."""
    cache = dict(state.cache, len=state.cache["len"].clone())
    for name in STEP_STATE:
        if name in cache:
            cache[name] = cache[name].clone()
    return dataclasses.replace(
        state, cache=cache, cur=state.cur.clone(),
        emitted=state.emitted.clone(), counts=state.counts.clone(),
        done=torch.ones_like(state.done))


#: the collector's process-wide hold: (holders, whether it was on when
#: the first of them came)
_collector = {"holders": 0, "was_on": False}
_collector_lock = threading.Lock()


@contextlib.contextmanager
def collector_held():
    """Hold Python's cyclic collector off until the block ends (raised
    or not; a collector the caller had off stays off).  An automatic
    collection inside a capture may destroy an older CUDA graph left in
    a reference cycle, and destroying a graph while a stream captures
    invalidates the capture ("operation not permitted when stream is
    capturing"); held off, the cycle waits for a collection after the
    capture.  No collection runs first: a full one costs the serving
    path, where cells are captured at first use, more than the capture
    itself.  The hold is counted across threads: the collector's state
    is saved by the first holder and restored by the last, so a thread
    that leaves while another still captures leaves it off."""
    with _collector_lock:
        if _collector["holders"] == 0:
            _collector["was_on"] = gc.isenabled()
            gc.disable()
        _collector["holders"] += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector["holders"] -= 1
            if _collector["holders"] == 0 and _collector["was_on"]:
                gc.enable()


class DeviceGate:
    """A process-wide shared / exclusive gate between device work and
    CUDA graph captures.  Device calls hold it shared (many threads at
    once; a thread may re-enter); a capture holds it alone.  A thread
    inside a device call that must capture lets its shared holds go
    while it waits and captures, and takes them back after, so two
    threads that capture from inside device calls never wait on each
    other.  Waiting captures go first: no thread takes a new shared hold
    while one waits, so a stream of ticks cannot starve a capture."""

    def __init__(self) -> None:
        self._cv = threading.Condition(threading.Lock())
        self._shared = 0                 # shared holds, all threads
        self._writer: Optional[int] = None
        self._waiting = 0                # captures waiting for the gate
        self._local = threading.local()
        self.captures_waited = 0         # captures that had to wait
        self.wait_seconds = 0.0          # and how long, all together

    def _mine(self) -> int:
        return getattr(self._local, "shared", 0)

    @contextlib.contextmanager
    def shared(self):
        """Hold the gate shared for one device call."""
        me = threading.get_ident()
        with self._cv:
            if self._writer != me and self._mine() == 0:
                while self._writer is not None or self._waiting:
                    self._cv.wait()
            self._shared += 1
        self._local.shared = self._mine() + 1
        try:
            yield
        finally:
            self._local.shared = self._mine() - 1
            with self._cv:
                self._shared -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        """Hold the gate alone, for one capture."""
        me = threading.get_ident()
        with self._cv:
            if self._writer == me:       # a capture inside a capture
                nested = True
            else:
                nested = False
                held = self._mine()
                self._shared -= held
                self._cv.notify_all()
                self._waiting += 1
                if self._writer is not None or self._shared:
                    self.captures_waited += 1
                    t0 = time.perf_counter()
                    while self._writer is not None or self._shared:
                        self._cv.wait()
                    self.wait_seconds += time.perf_counter() - t0
                self._waiting -= 1
                self._writer = me
        try:
            yield
        finally:
            if not nested:
                with self._cv:
                    self._writer = None
                    self._shared += held
                    self._cv.notify_all()


#: the gate of the process: every engine's device calls and captures
DEVICE_GATE = DeviceGate()


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
        return _pool_bytes(self._pool)

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
                dev, state.cur.shape[0] * decode_heads(state.cache))
            self._tick(warm_copy(state))
        self.warm_ticks += 1
        graph = torch.cuda.CUDAGraph()
        with DEVICE_GATE.exclusive(), collector_held(), \
                cuda_lib.recording() as launches:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                self._tick(state)
        main.wait_stream(self._stream)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return TickCell(key, graph, dict(launches), tickets)


# ---------------------------------------------------------------------------
# Cells of pure functions of device tensors
# ---------------------------------------------------------------------------

#: (shape, dtype) of a cell's input or output
Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class Fill:
    """An input its caller writes itself, into the tensor it is given (a
    gather from the paged pool straight into a cell's static input)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    write: Callable[[torch.Tensor], None]


#: a cell input: a host array, a tensor, or a Fill
Value = Union[np.ndarray, torch.Tensor, Fill]

#: a cell's body: reads its inputs, writes every one of its outputs
Body = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], None]


def spec(value: Value) -> Spec:
    if isinstance(value, np.ndarray):
        return tuple(value.shape), torch.from_numpy(value).dtype
    return tuple(value.shape), value.dtype


def write(dst: torch.Tensor, value: Value) -> None:
    """Write ``value`` into ``dst``, whose shape and dtype it must have
    (nothing is broadcast or cast)."""
    if isinstance(value, Fill):
        value.write(dst)
        return
    src = torch.from_numpy(value) if isinstance(value, np.ndarray) \
        else value
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"input of shape {tuple(src.shape)} {src.dtype} "
                         f"for a tensor of {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def padded(value: Value, dim: int, width: int, fill=0) -> Value:
    """``value`` padded with ``fill`` along ``dim`` up to ``width``
    (``value`` itself where it is that wide already)."""
    shape, dtype = spec(value)
    n = shape[dim]
    if n == width:
        return value
    if isinstance(value, np.ndarray):
        pad = [(0, 0)] * value.ndim
        pad[dim] = (0, width - n)
        return np.pad(value, pad, constant_values=fill)

    def fill_in(t: torch.Tensor) -> None:
        write(t.narrow(dim, 0, n), value)
        t.narrow(dim, n, width - n).fill_(fill)

    return Fill(shape[:dim] + (width,) + shape[dim + 1:], dtype, fill_in)


def run_eager(body: Body, inputs: Dict[str, Value],
              outputs: Dict[str, Spec],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """``body`` run once, eagerly, on tensors of its own: the inputs on
    ``device`` (a tensor there already is used as it is) and new
    outputs."""
    ins = {}
    for name, value in inputs.items():
        if isinstance(value, torch.Tensor) and value.device == device:
            ins[name] = value
            continue
        shape, dtype = spec(value)
        ins[name] = torch.empty(shape, dtype=dtype, device=device)
        write(ins[name], value)
    outs = {name: torch.empty(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in outputs.items()}
    body(ins, outs)
    return outs


class CellArena:
    """What one engine's cells share: the capture stream, the graph pool
    (the cells' intermediates) and the static buffers, one per (input or
    output name, dtype), that every cell's static tensors are views of."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None
        self._buffers: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self._held: List[torch.Tensor] = []

    def open(self) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def view(self, name: str, shape: Tuple[int, ...],
             dtype: torch.dtype) -> torch.Tensor:
        """A static tensor of ``shape`` at the start of ``name``'s
        buffer, which grows to at least twice its size where it is too
        small."""
        need = math.prod(shape)
        buf = self._buffers.get((name, dtype))
        if buf is None or buf.numel() < need:
            buf = self._new(name, dtype, max(
                need, 2 * buf.numel() if buf is not None else 1))
        return buf[:need].view(shape)

    def reserve(self, name: str, numel: int, dtype: torch.dtype) -> None:
        """Make ``name``'s buffer hold ``numel`` elements before the cells
        that view it are captured: a buffer outgrown stays held by the
        cells captured on it, so one grown cell by cell holds about twice
        its largest view."""
        buf = self._buffers.get((name, dtype))
        if buf is None or buf.numel() < numel:
            self._new(name, dtype, numel)

    def _new(self, name: str, dtype: torch.dtype, size: int) -> torch.Tensor:
        buf = torch.empty((size,), dtype=dtype, device=self.device)
        self._buffers[(name, dtype)] = buf
        self._held.append(buf)
        return buf

    def buffer_bytes(self) -> int:
        """Device memory held by the static buffers, the replaced ones
        that older cells still use included."""
        return sum(b.numel() * b.element_size() for b in self._held)

    def pool_bytes(self) -> int:
        """Device memory held by the graph pool (its segments' bytes)."""
        return _pool_bytes(self.pool)


def _pool_bytes(pool) -> int:
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


@dataclasses.dataclass
class Cell:
    """One captured function: its key, its static inputs and outputs
    (views of the arena's buffers), its graph, what one replay launches
    and the weights it was captured on."""
    key: Hashable
    inputs: Dict[str, torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    weights: Tuple = ()

    def check(self, inputs: Dict[str, Spec],
              outputs: Dict[str, Spec]) -> None:
        for what, got, have in (("input", inputs, self.inputs),
                                ("output", outputs, self.outputs)):
            want = {n: (tuple(t.shape), t.dtype) for n, t in have.items()}
            if got != want:
                raise ValueError(f"cell {self.key}: {what}s {got} differ "
                                 f"from those it was made with, {want}")


class CellTable:
    """The cells of one engine for one family of keys (the reference's
    ``_classify_cache`` or ``_prefill_cache``).  ``weights`` gives the
    pointers of the tensors every cell reads besides its inputs (the
    engine's parameters): a cell replays only against those it was
    captured on."""

    def __init__(self, arena: CellArena,
                 weights: Callable[[], Tuple]) -> None:
        self._arena = arena
        self._weights = weights
        self._cells: Dict[Hashable, Cell] = {}
        #: every key asked for, with its number of calls (on the CPU too)
        self.calls: Dict[Hashable, int] = {}
        self.captures = 0            # cells captured
        self.capture_seconds = 0.0   # first calls and captures, all cells

    def __len__(self) -> int:
        return len(self._cells)

    def keys(self) -> List[Hashable]:
        """The keys asked for, in the order of their first call."""
        return list(self.calls)

    def static_bytes(self) -> Dict[Hashable, int]:
        """Each cell's static inputs and outputs, in bytes."""
        return {key: sum(t.numel() * t.element_size() for t in
                         list(c.inputs.values()) + list(c.outputs.values()))
                for key, c in self._cells.items()}

    def run(self, key: Hashable, body: Body, inputs: Dict[str, Value],
            outputs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
        """``body`` on ``inputs`` through cell ``key``: on the card its
        graph's replay (the first call runs ``body`` eagerly on the
        capture stream and captures it), on the CPU ``body`` itself.
        Returns the outputs, on the card the cell's static ones."""
        self.calls[key] = self.calls.get(key, 0) + 1
        arena = self._arena
        if arena.device.type != "cuda":
            return run_eager(body, inputs, outputs, arena.device)
        in_specs = {name: spec(v) for name, v in inputs.items()}
        cell = self._cells.get(key)
        if cell is None:
            cell = Cell(key, {n: arena.view("in:" + n, *s)
                              for n, s in in_specs.items()},
                        {n: arena.view("out:" + n, *s)
                         for n, s in outputs.items()})
            self._cells[key] = cell
        else:
            cell.check(in_specs, dict(outputs))
        if cell.graph is not None and self._weights() != cell.weights:
            raise RuntimeError(f"stale cell {key}: the engine's weights are "
                               "not those the graph was captured on")
        for name, value in inputs.items():
            write(cell.inputs[name], value)
        if cell.graph is None:
            self._capture(cell, body)
        else:
            cell.graph.replay()
            cuda_lib.add_launches(cell.launches)
        return cell.outputs

    def _capture(self, cell: Cell, body: Body) -> None:
        arena = self._arena
        t0 = time.perf_counter()
        arena.open()
        main = torch.cuda.current_stream(arena.device)
        arena.stream.wait_stream(main)
        with torch.cuda.stream(arena.stream):
            body(cell.inputs, cell.outputs)      # this call's result
        graph = torch.cuda.CUDAGraph()
        with DEVICE_GATE.exclusive(), collector_held(), \
                cuda_lib.recording() as launches:
            with torch.cuda.graph(graph, pool=arena.pool,
                                  stream=arena.stream):
                body(cell.inputs, cell.outputs)
        main.wait_stream(arena.stream)
        cell.graph, cell.launches = graph, dict(launches)
        cell.weights = self._weights()
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
