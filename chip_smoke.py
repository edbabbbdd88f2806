#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build: compile the port's CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and load them;
3. kernels: hold every Hopper kernel against its plain PyTorch version at
   the full-width shapes of the serving path, with the tolerance stated,
   and time kernel, plain version and (where one PyTorch call computes
   the same function) that library call: ``ms`` from CUDA events around
   back-to-back calls (host time included when the host is slower than
   the card), ``device_ms`` and ``library_device_ms`` from the self
   device time that ``torch.profiler`` records for the same loop; the
   norm, sampling and decode kernels' ``device_ms`` with the L2 flushed
   before every call (``device_ms_warm_l2`` back to back); the norm at
   the decode tick's 8 rows and a prefill's 8192, beside the empty
   ``repro_floor`` kernel's device time; the sampler on f32 and bf16
   logits with ties at rank C and a row of fewer than C finite values;
   the causal flash kernel in suffix alignment (B 8, 256 queries after
   768 cached keys, beside SDPA with a lower-right causal mask); the
   flash kernel's packed mode (segment ids and positions) on eight
   segments of 1024, on mixed lengths padded to their pack bucket and on
   segments after prefix keys, against SDPA with the dense mask, each
   over its pack's plan built before and timed apart, case (a) beside
   the causal kernel at B 8 x 1024 (the same visible pairs; fails above
   ``PACKED_OVER_CAUSAL_LIMIT`` times its device time, or where its rows
   differ from the causal kernel's by a bit); the packed mode's plan
   kernel on the three packs and on random ids and positions, equal to
   its plain version entry for entry; the newer models' shapes: the
   norm in LayerNorm mode at C 6144 and RMS at C 3584, the causal kernel
   at dh 64 (32 heads, B 8 x 1024, the wgmma body), the packed mode at
   groups 7 and 12, the paged decode at groups 7 and 12 and at dh 64,
   the sampler at V 152064 and 49152; and what the norm, sampling,
   decode and packed kernels compiled to (``norm_build``,
   ``sample_build``, ``flash_decode_build`` for every instantiation,
   ``flash_attention_packed_build``);
4. serve: build ``TurboClient.from_arch("internlm2-1.8b", smoke=False)``
   (its default ``warmup=True``; 24 layers, d_model 2048, vocab 92544,
   bf16 weights from a seed, f32 KV pool; ``warmup_aot`` walks the reference's rounds and
   captures each prefill cell it reaches and both decode-tick cells as
   CUDA graphs, and no cell may be captured while serving; the phase
   prints the cells by kind, their capture seconds, the graph pools' and
   static buffers' bytes and the peak memory), serve a
   mixed greedy / sampled workload with mid-decode
   arrivals through the default packed admission (one plan launch per
   pack, one packed flash launch per layer per pack, each pack's
   occupancy), check every greedy
   stream against ``engine.generate`` of its prompt alone and every
   sampled stream against the request served again alone with its seed
   (a divergence passes only where the alone run's margin at the first
   differing step and the served token's gap there, ``draw_margins``,
   are below twice the largest logit drift between a packed pass and
   each prompt's own prefill, which the phase prints and holds to
   ``PACKED_LOGIT_ULPS``), the leak invariants, and that every kernel of
   the path launched;
4b. serve_prefix_chunked: the same model with ``prefix_cache=True`` and
   chunked prefill (256-token chunk turns) at batch buckets (1, 2, 4, 8):
   16 requests (10 sharing a 512-token system prompt, 2 a 520-token
   prefix that ends inside a block, 4 cold prompts of 700 to 1000
   tokens, 4 sampled) with mid-decode arrivals, once through the packed
   admission (hits and chunks as prefix keys of the packs) and once per
   group (the causal kernel in suffix alignment): cache hits, copies,
   chunked prefills, a pack carrying a chunk and suffix-aligned launches
   all above 0, the pool after the drain held by the cache alone, and
   every stream against the request alone under the margin rule, with
   the drift of a packed pass, a suffix pass and a decode step at batch
   8 against batch 1, and the suffix and packed cells captured while
   serving (the reference keys a suffix cell by the exact cached length);
5. profile_decode and profile_decode_sampled: eight greedy or sampled
   rows decoding at full width, in a window of graphed ticks and one of
   the eager ``decode_step_batch`` on a copy of the same rows: the host
   time per tick, the host's launch calls per tick (at most 10 for a
   graphed tick) and, from ``torch.profiler``, the device kernels per
   tick, the device's busy time by kernel family and its idle share (the
   sampled windows also the sample kernel's device time and what
   ``gumbel_noise`` launches); profile_prefill: prefills of eight
   prompts at the 1024 bucket, in a window through the engine's cell (a
   graph replay) and one through the eager public method on the same
   prompts, the same breakdown per prefill (at most 64 host launch calls
   a graphed prefill), the graphed logits and KV bit-equal to the eager
   ones, and the flash kernel's share; profile_prefill_packed: the same
   prompts as one pack; profile_prefill_suffix: the same prompts with
   their first 768 tokens served from a paged pool (gathered in the
   window), 24 suffix-aligned causal launches a prefill.
   Each window's count of the port's kernels in the trace is held against
   the launch counters; busy totals read "not measured" where the trace
   lost kernels, beside the busy time of the kernels it holds;
6. classify: the paper's one-shot classification service at full width
   (``InferenceEngine.warmup`` into a bucketed cost table, which
   captures its grid's classify cells, then every other cell a batch of
   at most 20 reaches, then 64 Poisson requests of 5 to 500 tokens
   through
   ``ServingSystem(execute=engine.execute_requests)`` under the dp, naive
   and nobatch policies), each served batch's last-token logits held
   against ``classify`` of each request alone, and the launch counters:
   24 masked-softmax launches per executed batch, no flash attention;
6b. allocator: the paper's allocator (C2) at full width.  The classify
   cell's forward (``forward_hidden(attn="naive")`` then ``logits_at``)
   at batch 1 over the reference benchmark's 24 lengths
   (``random.Random(0).randint(5, 500)``): at each length its usage
   records, traced in fake mode from the port's op graph (each kernel
   wrapper one node), planned by ``SequenceAwareAllocator`` (all records,
   and apart those ``dedup_repeated_structure`` keeps), the simulated
   ``CachingAllocator`` and ``GSOCAllocator``, ``validate_plan`` on every
   plan; then the same forward eagerly: its activation peak
   (``max_memory_allocated`` above its start, after one warm call), the
   card's caching allocator's reserve above the phase's start (one
   ``empty_cache`` first) and the forward's time (CUDA events).  One line
   a length (record counts, the records' peak live bytes, the three
   footprints, planning and tracing ms), then Fig. 11's peaks and final
   footprints, Fig. 12's allocation and free traffic (the card's own
   allocator beside the three), Fig. 13's planning time as a share of
   the measured forward, and the paper's two orderings (reported, not
   asserted).  It fails where a plan is invalid, the records' peak is
   above the card's measured peak plus 512 bytes a record, or the norm
   and softmax kernels did not launch once a call;
7. serve_contiguous: the serve phase's workload through
   ``kv_layout="contiguous"`` (per-group prefill through the causal
   kernel) from a slot cache of 1024 positions, plus a 1200-token prompt
   arriving mid-decode that grows it to 2048 and re-captures the tick's
   cell, every stream equal to the request alone, 24 contiguous-decode
   launches per decode tick and no paged-decode launch, and the per-group
   prefill cells the grow makes new captured while serving;
8. serve_moe: the MoE family, ``TurboClient.from_arch("olmoe-1b-7b",
   smoke=False)`` (16 layers, d_model 2048, 64 experts top 8, qk-norm,
   bf16 weights from a seed, f32 KV pool, paged, packed admission,
   ``warmup_aot``) after the earlier phases' clients are freed: the
   serve phase's 14 requests served once timed (tok/s, TTFT p50 / p99,
   peak memory, ``warmup_aot`` seconds, the launches, two qk-norm
   launches a layer beside the two norms) and once more with every tick
   and prefill cell replay held to its eager body bit for bit and every
   prefill pass's routing read from its dispatch in an eager re-run
   (the capacity and largest expert load of its first layer, the
   assignments it dropped, which prompts lost one; a decode tick that
   drops fails); each stream against the request alone with its
   prefill dropping exactly what its served pass dropped, where a
   difference must fall at a near tie of the drawn token (against twice
   the logit drift between a packed pass and each prompt's own prefill
   at every position with no capacity binding, held to
   ``MOE_PACKED_LOGIT_ULPS``; the drift with routing pinned to the own
   prefill's choices, rounding alone, held to ``MOE_ROUNDING_ULPS``,
   and the choices the change of shape flips printed beside it); the
   kernels at the MoE path's shapes (qk-norm rows of 128 without a
   residual, group 1, V 50304) are checked with the others above; then
   profile_decode_moe (greedy and sampled) and
   profile_prefill_moe_packed (the eight 1024-bucket prompts as one
   8192 pack), their device busy time split into matmuls, the port's
   kernels, the index, sort and scan kernels of the MoE's dispatch and
   combine, and the elementwise ones;
8b. serve_vlm: ``TurboClient.from_arch("qwen2-vl-7b", smoke=False)``
   (28 layers, d_model 3584, H 28 over KV 4, M-RoPE, vocab 152064) on
   the serve phase's mix and rules (every decode launch at group 7, the
   norm in RMS mode); then serve_vlm_image: four ~1000-token prompts
   behind a 121-patch image (``frontend.vision_patch_embeds``) through
   ``prefill(embeds_override=...)`` and 32 greedy ``decode_step``s, every
   step's logits against the plain versions' on the same inputs
   (``plain_versions``, ``PLAIN_LOGIT_ULPS``), the positions off plain
   RoPE's at the patches and ``pos_offset`` -(121 - 1);
8c. serve_starcoder2: ``from_arch("starcoder2-15b", smoke=False)`` (40
   layers, d_model 6144, H 48 over KV 4, LayerNorm + GELU) on the same
   mix (group 12, the norm in LayerNorm mode);
8d. generate_musicgen: MusicGen-large (48 layers, 32 heads of dh 64,
   LayerNorm + GELU, 4 codebooks) through ``InferenceEngine.generate``
   (8 prompts of 100 to 1000 tokens, 256 new frames, greedy: frames/s,
   the launches of causal flash at dh 64 and paged decode at dh 64, the
   two longest prompts alone equal to their batched streams), then the
   model functions on (B, 4, S) delayed codes from
   ``io.synthetic_prompts``, a prefill and 64 decode steps held against
   the plain versions for each codebook;
8e. serve_falcon_mamba: ``TurboClient.from_arch("falcon-mamba-7b",
   smoke=False, kv_layout="contiguous")`` (64 Mamba1 layers, d_model
   4096, d_inner 8192, state 16, vocab 65024, attention-free; bf16
   weights from a seed, f32 conv window and scan state) with
   ``SSM_SLOTS`` slots, on the serve mix and rules of phase 7 (the slot
   cache from 1024 positions grown to 2048 by a 1200-token prompt; an
   SSM model prefills each prompt at its exact length, so every new
   length is a prefill cell captured while serving; no attention
   launch; one norm a layer), then ``replay_audit``: the mix's four
   shortest prompts served twice with every tick replay and prefill cell
   call held bit for bit to its eager body (every cache leaf);
   profile_decode_falcon_mamba: a greedy graphed window of its slots,
   the device time split into matmuls, the port's kernels and the
   elementwise kernels and reductions (the SSM step's);
8f. serve_zamba2: ``from_arch("zamba2-1.2b", ...)`` (38 Mamba2 layers of
   64 heads of 64, state 64, d_model 2048; the shared attention + FFN
   block after every 6 layers, H 32 / KV 32 at dh 64, vocab 32000) the
   same way: the causal kernel at dh 64 over exact prompt lengths (row
   4z checks it at 1, 63, 937 and 1000 tokens) and the contiguous decode
   at group 1, dh 64, six launches a tick; the grow pads the shared KV
   and re-captures the tick's cell;
9. serve_pool: the serving tier, after every other client is freed.
   (a) ``TurboClient.from_arch("internlm2-1.8b", smoke=False,
   replicas=2, prefix_cache=True, auto_pump="thread")`` at full width
   and depth, 4 slots a replica (one set of weights read by both, each
   replica its own engine, cells and KV pool; the sanitizer on): 16
   requests, two cohorts of 6 sharing a 512-token prefix and 4 cold
   prompts of 700 to 960 tokens, 32 to 64 new tokens, greedy and
   seeded-sampled, the cohort heads served first; once timed (tok/s,
   TTFT, the launches of the port's kernels, each of which must launch,
   the cells captured while serving and their seconds), once more on
   warm caches, once with the first cohort's replica killed while it holds a decoding
   and a queued session (its queued sessions fail over and finish, its
   decoding ones raise ``ReplicaFailure``; ``check_pool_ownership`` on a
   consistent snapshot between ticks until every request ends), and the
   same requests through one replica, twice, for its tok/s; routed, affinity
   hits, failovers, resubmitted and failed sessions, prefix hits by
   replica, cells by replica after ``warmup_aot`` and after serving,
   peak memory, and every finished stream against the request alone
   under the margin rule; (b) ``warmup="background"`` with a pump
   thread, 4 requests submitted before the warm-up ends: its rounds and
   seconds, the requests' TTFT, the cells captured outside its walk, the
   streams under the rule; (c) ``simulate`` under nobatch, naive and dp
   with the classify phase's cost table, on that phase's requests and on
   a Poisson draw at its rate, beside the measured resp/s and p99; (d)
   ``python -m repro_torch.launch.serve --no-smoke --replicas 2`` in a
   subprocess, rc 0 and every request finished;
10. train: training at full width, after every serving client is freed.
   The norm's and the softmax's Functions alone at the train path's
   shapes (norm R 2048 x C 2048 bf16 with a residual, softmax R 32768 x
   C 512 f32 with causal lengths), each gradient against autograd through
   the plain version and each backward timed; (a) full-width, full-depth
   InternLM2-1.8B (f32 master weights from a seed, bf16 compute), one
   microbatch of 4 x 512 through the kernels, again under
   ``plain_versions`` and in f32 compute (plain), the loss and every
   leaf's gradient held to the bf16 floor (``TRAIN_GRAD_WHY``), 49 norm
   and 24 softmax launches; (b) ``Trainer`` with AdamW, batch 8 x 512 in
   two microbatches, 6 steps: seconds a step, tokens a second, peak
   memory, each step's loss and gradient norm, the launches a microbatch
   (49 and 24), and two steps on one batch whose second loss must be
   lower; (c) one step profiled: device busy time by kernel family, the
   backward's norm and softmax gradients and the optimizer apart (their
   profiler ranges), idle share; (d) the crash and resume drill at 2
   layers with Adafactor (a checkpoint every 2 steps, a failure at step
   4, resumed: parameters and optimizer state bit-equal to an
   uninterrupted run; a checkpoint's bytes and write seconds); (e)
   ``python -m repro_torch.launch.train --arch internlm2-1.8b --steps 2
   --batch 2 --seq 128`` in a subprocess, rc 0;
11. examples: the four examples of ``examples/torch`` in this process
   through their ``main(argv)``, the launch counters set to 0 before
   each (``EXAMPLES``: quickstart and serve_e2e with ``--no-smoke``, the
   full-width model, since the reduced config's dh 16 has no attention
   kernel; train_small at its reduced config, whose train path runs only
   the norm and softmax kernels and whose checkpoints are small, with a
   checkpoint written before its injected failure and the resumed run
   bitwise identical; the allocator demo, which traces a plain encoder
   and launches nothing): each kernel its path reaches launched, its
   results checked, its seconds;
12. dryrun: the dry run of InternLM2-1.8B's three global shapes at full
   width, traced on the CPU by a worker process started with the script
   (``dryrun_worker``, pinned to one CPU, fake tensors only), its records
   printed; then the card's own steps (``DRYRUN_CHIP_SHAPES``: prefill B
   8 x 1024, the decode tick's 8 rows over 1024 positions, the train
   step of 8 x 512 in two microbatches), each run eager with weights
   from a seed beside its record: the dry run's FLOPs against
   ``FlopCounterMode``'s on the real step (held to ``DRYRUN_FLOPS_REL``;
   where they differ, by op), the predicted peak against
   ``max_memory_allocated`` after a reset, and the record's bound against
   the step's device time (CUDA events, and the profiler's busy time),
   the roofline fraction of each; and the worker's mesh records
   (``--mesh single``: one rank of the (16, 16) pod, ``pod16x16``) of
   the same three shapes, per device;
13. distributed: full-width InternLM2-1.8B (bf16 from a seed, an f32
   KV) over a one-rank NCCL group and a (1, 1) ``("data", "model")``
   DeviceMesh, placed by `repro_torch.distributed.plan` and run under
   ``sharding_rules``: a prefill of B 8 x 1024 (the flash kernel),
   ``DIST_DECODE_STEPS`` decode steps over the contiguous cache (the
   decode kernel) and one train step of 8 x 512 in two microbatches (the
   norm and the softmax), each bit-equal to the same call without the
   mesh with the same kernel launches, the eager wall time of each with
   and without the mesh (DTensor's host cost), and the trained state's
   ``reshard`` onto the mesh and back bit-equal; then each rank's local
   call of the decode and causal-flash wrappers as tensor parallelism of
   2, 4, 8 and 16 splits InternLM2's 16 / 8 and Qwen3-32B's 64 / 8 heads
   (the kv heads of each rank's query heads,
   `repro_torch.distributed.sharding.local_kv_heads`), concatenated over heads
   and bit-equal to the full call.

Then a ``{"kernels": [...]}`` line (each kernel's launches in the serving
paths, ``launches_in_train``, ``launches_in_examples`` and
``launches_in_distributed``), the
``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  It also refuses to run without a
CUDA device or outside a checkout of the repository.

TF32 is switched off for matmuls and cuDNN, so every f32 product in the
plain versions is a full f32 product.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, data sheet (SXM)
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_us(evt) -> float:
    """An averaged profiler event's self device time in microseconds."""
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else getattr(evt, "self_cuda_time_total", 0)


def is_kernel(evt) -> bool:
    """A device-side event (kernel, memset, copy): device time, no host
    self time."""
    return device_us(evt) > 0 and evt.self_cpu_time_total == 0


def device_ms(fn, iters: int, before=None) -> dict:
    """Device time per call of ``fn`` from torch.profiler over ``iters``
    back-to-back calls, after one warm-up call: for each kernel the calls
    launch, its mean self device time over the launches the trace
    recorded times its launches per call, summed over the port's kernels
    (names holding ``repro``) as ``port`` and over every kernel as
    ``all``.  Averaging over recorded launches, not over ``iters``, keeps
    a trace that lost events from reading low.  "not measured" where the
    profiler shows no device time.  ``before``, where given, runs before
    each call (an L2 flush); only ``port`` is then the calls' own."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):     # the trace now and then comes back empty: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        port = every = 0.0
        for evt in prof.key_averages():
            if is_kernel(evt):
                per_call = device_us(evt) / evt.count * \
                    max(1, round(evt.count / iters))
                every += per_call
                if "repro" in evt.key:
                    port += per_call
        if every > 0:
            break
    return {k: (us / 1e3 if us > 0 else "not measured")
            for k, us in (("port", port), ("all", every))}


_L2_FLUSH = []


def l2_flush():
    """A call that reads 256 MB, five times the H100's 50 MB L2, so the
    next kernel finds its inputs in device memory, as a decode layer does
    after the ~120 MB of weights the tick reads between two attention
    calls.  Its kernel's name holds no ``repro``."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(64 << 20, device="cuda"))
    buf = _L2_FLUSH[0]
    return lambda: buf.sum()


def device_fields(kernel, library, iters: int) -> dict:
    """``device_ms`` of a kernel check (its port kernels' own time) and,
    where the check has a library call, ``library_device_ms`` (every
    kernel that call launches)."""
    out = {"device_ms": device_ms(kernel, iters)["port"]}
    out["library_device_ms"] = (device_ms(library, iters)["all"]
                                if library is not None else None)
    return out


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3g}, "
                             f"{int(bad.sum())} elements beyond atol "
                             f"{atol} + rtol {rtol})")
    return err


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def cold_with_writeback_ms(kernel, iters: int):
    """Device time a call adds to an L2 flush: (flush, call) pairs minus
    the flush alone, over every kernel.  The flush only reads, so a call's
    writes still dirty in the L2 when it ends reach device memory during
    the next flush; this counts them, which ``device_ms`` with the L2
    flushed does not."""
    flush = l2_flush()

    def pair():
        flush()
        return kernel()
    both = device_ms(pair, iters)["all"]
    alone = device_ms(flush, iters)["all"]
    if isinstance(both, float) and isinstance(alone, float):
        return both - alone
    return "not measured"


def cold_warm(kernel, nbytes: int, flops: float, peak_flops: float,
              iters: int, writeback: bool = False) -> dict:
    """A kernel's device time with the L2 flushed before every call
    (``device_ms``) and back to back (``device_ms_warm_l2``), beside its
    bound; with ``writeback``, also cold with its writes' trip to device
    memory counted (``device_ms_cold_writeback``)."""
    b_ms, b_by = bound_ms(nbytes, flops, peak_flops)
    cold = device_ms(kernel, iters, before=l2_flush())["port"]
    warm = device_ms(kernel, iters)["port"]
    line = {"device_ms": cold, "device_ms_warm_l2": warm, "bound_ms": b_ms,
            "bound_by": b_by}
    if isinstance(cold, float):
        line["share_of_bound"] = b_ms / cold
    if isinstance(warm, float):
        line["share_of_bound_warm_l2"] = b_ms / warm
    if writeback:
        wb = cold_with_writeback_ms(kernel, iters)
        line["device_ms_cold_writeback"] = wb
        if isinstance(wb, float) and wb > 0:
            line["share_of_bound_cold_writeback"] = b_ms / wb
    return line


NORM_TOL = dict(atol=3e-2, rtol=2e-2)   # bf16 output: ~2 ulp at |y| <= 4
#: the norm checks' rows: the decode tick's 8 and a B 8 x 1024 prefill's
NORM_ROWS = (8, 8192)
#: the MoE path's qk-norm (RMS over rows of dh 128, no residual): a decode
#: tick's 8 tokens x 16 heads, and an 8192-token pack's
QK_NORM_ROWS = (8 * 16, 8192 * 16)
#: the newer served models' rows, at NORM_ROWS: (RMS?, C): StarCoder2's
#: LayerNorm at d_model 6144 (MusicGen's at 2048 is the check above),
#: Qwen2-VL's RMS at 3584 and Falcon-Mamba's at 4096 (Zamba2's RMS at
#: 2048 is the check above)
MODEL_NORM_COLS = ((False, 6144), (True, 3584), (True, 4096))


def norm_case(dev, gen, rms: bool, r: int, c: int, tol: dict,
              residual: bool = True) -> dict:
    """One shape of the fused norm: kernel against its plain version (the
    updated residual bit for bit), and the times of kernel, plain version
    and library call; the kernel's device time cold and warm.  Without
    ``residual`` (RMS only, as qk-norm calls it) the kernel normalises x
    alone and returns y only."""
    from repro_torch.kernels import layernorm, ref
    import torch.nn.functional as F
    x = torch.randn((r, c), generator=gen, device=dev).bfloat16()
    res = torch.randn((r, c), generator=gen, device=dev).bfloat16()
    g = (1 + 0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
    if not residual:
        if not rms:
            raise ValueError("norm_case: no-residual mode is RMS only")

        def kernel():
            return layernorm.norm_cuda(x, g, rms=True)

        def plain():
            return ref.rmsnorm_ref(x, g)

        def library():
            return F.rms_norm(x, (c,), g, 1e-6)
    elif rms:
        def kernel():
            return layernorm.norm_cuda(x, g, residual=res, rms=True,
                                       return_residual=True)

        def plain():
            return ref.rmsnorm_ref(x, g, residual=res, return_residual=True)
        s_sum = (x.float() + res.float()).bfloat16()

        def library():
            return F.rms_norm(s_sum, (c,), g, 1e-6)
    else:
        beta = (0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
        bias = (0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()

        def kernel():
            return layernorm.norm_cuda(x, g, beta, bias, res, rms=False,
                                       return_residual=True)

        def plain():
            return ref.layernorm_ref(x, g, beta, bias, res,
                                     return_residual=True)
        s_sum = (x.float() + bias.float() + res.float()).bfloat16()

        def library():
            return F.layer_norm(s_sum, (c,), g, beta, 1e-6)
    y, y_ref = kernel(), plain()
    if residual:
        (y, s), (y_ref, s_ref) = y, y_ref
    torch.cuda.synchronize()
    err = check_close("norm y", y, y_ref, **tol)
    if residual and not torch.equal(s, s_ref):
        raise AssertionError(f"norm residual: not bit-equal to the plain "
                             f"version (max abs {max_err(s, s_ref)})")
    iters = 200 if r <= 64 else 50
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    if residual:
        nbytes = (4 * r * c + (1 if rms else 3) * c) * 2
        counts = ("x and residual read, y and residual written, gamma (and "
                  "beta, bias) read once")
        library_is = ("F.rms_norm" if rms else "F.layer_norm") + \
            " of the pre-summed row (half the bytes: no residual read, " \
            "no residual written)"
    else:
        nbytes = (2 * r * c + c) * 2
        counts = "x read, y written, gamma read once"
        library_is = "F.rms_norm of the same rows (the same bytes)"
    return {"phase": "kernel_check", "kernel": "fused_norm",
            "mode": "rms" if rms else "layernorm",
            "residual": residual,
            "shape": [r, c], "dtype": "bfloat16",
            "tolerance": {**tol, "why": "bf16 output; kernel and plain "
                          "version sum the row in other orders; the "
                          "updated residual (where there is one) bit for "
                          "bit"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "library": library_is,
            **cold_warm(kernel, nbytes, (6 if residual else 5) * r * c,
                        H100_F32_FLOPS, iters, writeback=r > 64),
            "library_device_ms": device_ms(library, iters)["all"],
            "bound_counts": counts}


def floor_device_ms(blocks: int, threads: int, iters: int = 200):
    """Device time of the empty ``repro_floor`` kernel on (blocks,
    threads): the floor under any launch of that shape."""
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        cuda_lib.check(lib.repro_floor(blocks, threads, stream),
                       "repro_floor")
    return device_ms(launch, iters)["port"]


def norm_build_facts() -> dict:
    """What the norm bodies on the port's paths compiled to: registers
    and spills (ptxas) and resident blocks per SM."""
    from repro_torch.kernels import cuda_lib, layernorm
    lib = cuda_lib.library()
    facts = {}
    for label, dtype, code, mangled in (
            ("bf16 C2048", torch.bfloat16, 1, "I13__nv_bfloat16"),
            ("f32 C2048", torch.float32, 0, "If")):
        plan = layernorm.norm_plan(2048, dtype)
        needle = (f"norm_kernel{mangled}Li{plan.threads}E"
                  f"Li{plan.vectors}E")
        ptxas = next((u for name, u in cuda_lib.BUILD_INFO["ptxas"].items()
                      if needle in name), {})
        blocks = lib.repro_norm_blocks_per_sm(code, plan.threads,
                                              plan.vectors)
        if blocks < 1:
            raise AssertionError(f"fused_norm {label}: occupancy query gave "
                                 f"{blocks}")
        facts[label] = {"threads_per_row": plan.threads,
                        "vectors_per_thread": plan.vectors,
                        "blocks_per_sm": blocks,
                        "registers": ptxas.get("registers", "not measured"),
                        "spill_bytes": ptxas.get("spill_stores", 0) +
                        ptxas.get("spill_loads", 0)}
    return facts


def check_norm(dev, gen, results):
    lines = []
    for rms in (True, False):
        for r in NORM_ROWS:
            lines.append(norm_case(dev, gen, rms, r, 2048, NORM_TOL))
    for r in QK_NORM_ROWS:
        lines.append(norm_case(dev, gen, True, r, 128, NORM_TOL,
                               residual=False))
    for rms, c in MODEL_NORM_COLS:
        for r in NORM_ROWS:
            lines.append(norm_case(dev, gen, rms, r, c, NORM_TOL))
    # the floor under the decode tick's launch: the same grid, no work
    from repro_torch.kernels import layernorm
    floor = floor_device_ms(
        NORM_ROWS[0], layernorm.norm_plan(2048, torch.bfloat16).threads)
    for line in lines:
        if line["shape"][0] == 8:
            line["floor_device_ms"] = floor
            if isinstance(floor, float) and \
                    isinstance(line["device_ms"], float):
                line["device_ms_above_floor"] = line["device_ms"] - floor
        emit(line)
    emit({"phase": "norm_build", **norm_build_facts()})
    # the kernels line reports the decode-tick shape of the main path (RMS
    # mode, R = 8) and the worst error over every mode and shape checked
    entry = dict(lines[0])
    entry["max_abs_err"] = max(ln["max_abs_err"] for ln in lines)
    results["fused_norm"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/norm.cu",
        replaces="src/repro/kernels/layernorm.py:64")


def flash_case(dev, gen, b: int, s: int, tol: dict, h: int = 16,
               kv: int = 8, dh: int = 128) -> dict:
    """One causal prefill shape: kernel against its plain version, and the
    times of kernel, plain version and SDPA (CUDA events and device
    time)."""
    from repro_torch.kernels import flash_attention, ref
    import torch.nn.functional as F
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev).bfloat16()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return flash_attention.flash_attention_cuda(qt, kt, vt, causal=True)

    def plain():
        return ref.flash_attention_ref(qt, kt, vt, causal=True)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close("flash_attention", out, want, **tol)
    iters = 20
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    nbytes = b * s * dh * 2 * (2 * h + 2 * kv)
    flops = 4.0 * b * h * dh * s * (s + 1) / 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    line = {"phase": "kernel_check", "kernel": "flash_attention",
            "shape": {"B": b, "S": s, "H": h, "KV": kv, "dh": dh},
            "dtype": "bfloat16", "causal": True,
            "tolerance": {**tol, "why": tol_why_attention()},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "library": "F.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by, **dev_t,
            "tflops": flops / (k_ms * 1e-3) / 1e12,
            "share_of_bound": b_ms / k_ms}
    if isinstance(dev_t["device_ms"], float):
        line["device_tflops"] = flops / (dev_t["device_ms"] * 1e-3) / 1e12
    return line


#: the suffix-aligned check (PERF.md row 4c): B 8 rows of Sq queries
#: after ``cached`` keys served from the prefix cache
SUFFIX_CASE = dict(b=8, sq=256, cached=768)
#: exact prompt lengths of the causal check at dh 64 (row 4z): one
#: token, one short of a 64-key tile, and two long prompts off the tiles
RAGGED_LENS = (1, 63, 937, 1000)


def flash_suffix_case(dev, gen, b: int, sq: int, cached: int,
                      tol: dict) -> dict:
    """The causal kernel in suffix alignment: queries as the last Sq of
    Sk = cached + Sq keys (a prefix-cache hit's or a chunk's suffix
    prefill), against its plain version, beside SDPA with a lower-right
    causal mask.  The bound counts the pairs the rows see: each query
    its cached keys and the suffix keys up to its own."""
    from repro_torch.kernels import flash_attention, ref
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    h, kv, dh = 16, 8, 128
    sk = cached + sq
    q = torch.randn((b, sq, h, dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev).bfloat16()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    bias = causal_lower_right(sq, sk)

    def kernel():
        return flash_attention.flash_attention_cuda(qt, kt, vt, causal=True)

    def plain():
        return ref.flash_attention_ref(qt, kt, vt, causal=True)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                              enable_gqa=True)
    out, want = kernel(), plain()
    err = check_close("flash_attention (suffix)", out, want, **tol)
    lib_err = max_err(library(), want)
    torch.cuda.synchronize()
    iters = 20
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    pairs = sq * cached + sq * (sq + 1) / 2
    nbytes = 2 * b * dh * (2 * sq * h + 2 * sk * kv)
    flops = 4.0 * b * h * dh * pairs
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    line = {"phase": "kernel_check", "kernel": "flash_attention",
            "case": "4c: suffix alignment",
            "shape": {"B": b, "Sq": sq, "Sk": sk, "cached": cached, "H": h,
                      "KV": kv, "dh": dh},
            "dtype": "bfloat16", "causal": "lower right (queries at the "
            "last Sq keys)",
            "tolerance": {**tol, "why": tol_why_attention()},
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "library": "F.scaled_dot_product_attention with "
                       "causal_lower_right(Sq, Sk), enable_gqa",
            "visible_pairs": b * pairs, "bound_ms": b_ms, "bound_by": b_by,
            **dev_t, "share_of_bound": b_ms / k_ms}
    if isinstance(dev_t["device_ms"], float):
        line["device_tflops"] = flops / (dev_t["device_ms"] * 1e-3) / 1e12
        line["device_share_of_bound"] = b_ms / dev_t["device_ms"]
    return line


def flash_build_facts() -> dict:
    """What the flash kernels compiled to: resident blocks per SM (CUDA
    occupancy calculator), registers and spills (ptxas), and the
    tensor-core (HMMA / HGMMA) and f32 FMA instructions in each body's
    SASS (cuobjdump; "not measured" where the tool is missing)."""
    import shutil
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    facts = {}
    bodies = (("bf16", 1, 128, "flash_attention_bf16_kernelILi128E"),
              ("f32", 0, 128, "flash_attention_kernelIfLi128E"),
              ("bf16 dh64", 1, 64, "flash_attention_bf16_kernelILi64E"))
    for label, code, dh, needle in bodies:
        blocks = lib.repro_flash_attention_blocks_per_sm(code, dh)
        if blocks < 0:
            raise AssertionError(f"flash_attention {label}: occupancy query "
                                 f"failed with CUDA error {-blocks}")
        ptxas = {k: v for k, v in cuda_lib.BUILD_INFO["ptxas"].items()
                 if needle in k}
        facts[label] = {"blocks_per_sm": blocks,
                        "ptxas": next(iter(ptxas.values()), "not measured")}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        for label, _, _, needle in bodies:
            facts[label]["sass"] = cuda_lib.sass_opcodes(
                sass, needle, ("HMMA", "HGMMA", "FFMA", "MUFU", "LDSM"))
    else:
        for label in facts:
            facts[label]["sass"] = "not measured: no cuobjdump"
    for label in ("bf16", "bf16 dh64"):
        tc_ops = facts[label]["sass"]
        if isinstance(tc_ops, dict) and tc_ops["HMMA"] + tc_ops["HGMMA"] == 0:
            raise AssertionError(f"flash_attention {label}: no tensor-core "
                                 f"instruction in its SASS: {facts[label]}")
    return facts


def check_flash_attention(dev, gen, results):
    """The causal prefill kernel at the earlier slices' three shapes, at
    the serve path's own (B 8, as ``batch_buckets=(8,)`` pads every
    prefill, at each seq bucket) and in suffix alignment (``SUFFIX_CASE``,
    row 4c); the kernels line reports B 2, S 1024 with the suffix case
    beside it, and the worse error of the two."""
    tol = dict(atol=2e-2, rtol=2e-2)   # bf16 in/out; see tol_why_attention
    entry = {}
    for b, s in ((4, 128), (4, 512), (2, 1024),
                 (8, 128), (8, 256), (8, 512), (8, 1024)):
        line = flash_case(dev, gen, b, s, tol)
        emit(line)
        if (b, s) == (2, 1024):
            entry = line
    suffix = flash_suffix_case(dev, gen, tol=tol, **SUFFIX_CASE)
    emit(suffix)
    # MusicGen's prefill (B 8 at the 1024 bucket, 32 heads of dh 64): the
    # tensor-core body at dh 64 (row 4a)
    dh64 = flash_case(dev, gen, 8, 1024, tol, h=32, kv=32, dh=64)
    emit(dict(dh64, case="4a: dh 64 (MusicGen)"))
    # Zamba2's shared block prefills a prompt at its exact length, not a
    # bucket's (an SSM model's prompts are not padded): the same body at
    # lengths off the 64-key tile, at the SSM phases' batch (row 4z)
    ragged = []
    for s in RAGGED_LENS:
        line = flash_case(dev, gen, SSM_SLOTS, s, tol, h=32, kv=32, dh=64)
        emit(dict(line, case="4z: dh 64 at an exact prompt length "
                             "(Zamba2)"))
        ragged.append(line)
    emit({"phase": "flash_attention_build", **flash_build_facts()})
    results["flash_attention"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91",
        max_abs_err=max([entry["max_abs_err"], suffix["max_abs_err"],
                         dh64["max_abs_err"]] +
                        [ln["max_abs_err"] for ln in ragged]),
        dh64_exact_lengths=[{k: ln[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "device_ms", "bound_ms")} for ln in ragged],
        suffix_alignment={k: suffix[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "device_ms", "library_device_ms", "bound_ms", "bound_by")},
        dh64={k: dh64[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "device_ms", "library_device_ms", "bound_ms", "bound_by")})


#: the packed-mode checks' packs: (label, fresh lengths, prefix lengths,
#: pack width, prefix width): eight tile-aligned segments of 1024 (flat
#: 8192); mixed lengths with a one-token segment and boundaries inside
#: tiles, padded to their pack bucket; segments after 128, 256 and no
#: prefix keys (the prefix region padded to its bucket)
PACKED_CASES = (
    ("a: 8 x 1024", (1024,) * 8, (0,) * 8, 8192, 0),
    ("b: mixed 1..1024", (1, 64, 200, 333, 512, 700, 960, 1024), (0,) * 8,
     4096, 0),
    ("c: prefix 128, 256, 0", (300, 500, 700), (128, 256, 0), 2048, 512),
)
#: the packed kernel's device time in case (a) against the causal kernel's
#: at B 8 x 1024 (the same visible pairs), the plan apart (0.79 on an H100
#: 80GB HBM3 at 700 W: the body shares each K and V tile between the two
#: heads of a GQA pair): above this it has fallen behind the causal
#: kernel, so tiles are not being skipped or the body lost its schedule
PACKED_OVER_CAUSAL_LIMIT = 1.0
#: the MoE path's packs (OLMoE: H 16 over KV 16, group 1): (label, fresh
#: lengths, prefix lengths, pack width, prefix width, KV heads)
MOE_PACKED_CASES = (
    ("d: 8 x 1024, KV 16", (1024,) * 8, (0,) * 8, 8192, 0, 16),
    ("e: mixed 1..1024, KV 16", (1, 64, 200, 333, 512, 700, 960, 1024),
     (0,) * 8, 4096, 0, 16),
)
#: the odd and wide groups of Qwen2-VL (H 28 over KV 4, group 7: a block's
#: second consumer idles on the last head of each group) and StarCoder2
#: (H 48 over KV 4, group 12): mixed lengths in a 4096 pack, as case (b);
#: (label, fresh, prefix, width, prefix width, KV heads, heads)
WIDE_PACKED_CASES = (
    ("v: mixed 1..1024, H 28 / KV 4", (1, 64, 200, 333, 512, 700, 960,
                                       1024), (0,) * 8, 4096, 0, 4, 28),
    ("s: mixed 1..1024, H 48 / KV 4", (1, 64, 200, 333, 512, 700, 960,
                                       1024), (0,) * 8, 4096, 0, 4, 48),
)


def packed_inputs(dev, gen, fresh, prefix, width, pre_width, h=16, kv=8):
    """bf16 q (1, H, width, 128), k and v (1, KV, pre_width + width, 128)
    as views of (1, S, heads, 128) activations, and the segment ids and
    positions (q_seg, k_seg, q_pos, k_pos) of the pack."""
    from repro_torch.runtime.engine import segment_labels
    q_seg, q_pos = segment_labels(fresh, prefix, width)
    p_seg, p_pos = segment_labels(prefix, [0] * len(prefix), pre_width)
    ids = [torch.from_numpy(a).to(dev) for a in
           (q_seg, np.concatenate([p_seg, q_seg]), q_pos,
            np.concatenate([p_pos, q_pos]))]
    q, k, v = [torch.randn((1, n, heads, 128), generator=gen,
                           device=dev).bfloat16().transpose(1, 2)
               for n, heads in ((width, h), (pre_width + width, kv),
                                (pre_width + width, kv))]
    return q, k, v, ids


def packed_mask(ids) -> torch.Tensor:
    """The (Sq, Sk) visibility of a pack: one id and k_pos <= q_pos, or the
    query's own key."""
    q_seg, k_seg, q_pos, k_pos = ids
    sq, sk = q_seg.numel(), k_seg.numel()
    keys = torch.arange(sk, device=q_seg.device)
    own = keys[None, :] - (sk - sq) == torch.arange(sq, device=q_seg.device
                                                    )[:, None]
    return ((q_seg[:, None] == k_seg[None, :]) &
            (k_pos[None, :] <= q_pos[:, None])) | own


def packed_case(dev, gen, label, fresh, prefix, width, pre_width,
                kv: int = 8, h: int = 16) -> dict:
    """One pack at ``h`` heads over ``kv`` KV heads: the packed mode
    against its plain version on real rows (padding rows finite), and the
    times of kernel, plain version and SDPA with the dense boolean mask;
    the bound counts the visible pairs of the real rows."""
    from repro_torch.kernels import flash_attention, ref
    import torch.nn.functional as F
    dh = 128
    q, k, v, ids = packed_inputs(dev, gen, fresh, prefix, width, pre_width,
                                 h=h, kv=kv)
    mask = packed_mask(ids)
    plan = flash_attention.flash_attention_packed_plan_cuda(*ids)

    def kernel():
        return flash_attention.flash_attention_packed_cuda(q, k, v, *ids,
                                                           plan=plan)

    def plan_kernel():
        return flash_attention.flash_attention_packed_plan_cuda(*ids)

    def plain():
        return ref.flash_attention_packed_ref(q, k, v, *ids)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    tol = dict(atol=2e-2, rtol=2e-2)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    real = ids[0] >= 0
    err = check_close(f"flash_attention_packed {label}", out[:, :, real],
                      want[:, :, real], **tol)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"flash_attention_packed {label}: a padding "
                             "row is not finite")
    del want
    pairs = int(mask[real].sum())
    sq, sk = width, pre_width + width
    nbytes = 2 * (2 * sq * h * dh + 2 * sk * kv * dh) + 4 * 2 * (sq + sk)
    flops = 4.0 * dh * h * pairs
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    iters = 20
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, 3),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    plan_t = {"ms": time_ms(plan_kernel, iters),
              "device_ms": device_ms(plan_kernel, iters)["port"],
              "bytes": plan.numel() * 4, "rows": plan.shape[0],
              "visited_tiles": int(plan[:, 0].sum())}
    line = {"phase": "kernel_check", "kernel": "flash_attention_packed",
            "case": label,
            "shape": {"H": h, "KV": kv, "dh": dh, "Sq": sq, "Sk": sk,
                      "segments": list(fresh), "prefix": list(prefix),
                      "flat": int(real.sum())},
            "dtype": "bfloat16",
            "tolerance": {**tol, "why": tol_why_attention() +
                          "; real rows only (padding rows finite)"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": "F.scaled_dot_product_attention with the dense "
                       "boolean (Sq, Sk) mask (a yardstick, not on the path)",
            "visible_pairs": pairs, "dense_pairs": sq * sk,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_counts": "4 dh H flops a visible pair of a real row; "
                            "q, k, v, ids read once, output written once",
            **dev_t, "share_of_bound": b_ms / k_ms,
            "plan": plan_t, "times_exclude": "the plan, built once a "
            "pack and timed apart under \"plan\""}
    if isinstance(dev_t["device_ms"], float):
        line["device_tflops"] = flops / (dev_t["device_ms"] * 1e-3) / 1e12
        line["device_share_of_bound"] = b_ms / dev_t["device_ms"]
    if label.startswith("a"):
        line["against_causal"] = packed_against_causal(
            dev, gen, q, k, v, out, fresh, dev_t["device_ms"], k_ms, iters)
    return line


def packed_against_causal(dev, gen, q, k, v, packed_out, fresh,
                          packed_device_ms, packed_ms, iters) -> dict:
    """Case (a) beside the causal kernel at B 8 x 1024 on the same rows
    (the same visible pairs): their times, and whether the packed rows
    equal the causal ones bit for bit (each segment starts on a tile)."""
    from repro_torch.kernels import flash_attention
    b, s = len(fresh), fresh[0]

    def rows(t):             # (1, heads, B * S, dh) -> (B, heads, S, dh)
        return t[0].reshape(t.shape[1], b, s, 128).transpose(0, 1)

    qb, kb, vb = rows(q), rows(k), rows(v)

    def causal():
        return flash_attention.flash_attention_cuda(qb, kb, vb, causal=True)
    out = causal()
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, rows(packed_out)))
    c_ms = time_ms(causal, iters)
    c_dev = device_ms(causal, iters)["port"]
    if isinstance(packed_device_ms, float) and isinstance(c_dev, float):
        ratio, by = packed_device_ms / c_dev, "device_ms"
    else:
        ratio, by = packed_ms / c_ms, "ms"
    flops = 4.0 * b * 16 * 128 * s * (s + 1) / 2
    nbytes = b * s * 128 * 2 * (2 * 16 + 2 * 8)
    return {"causal_shape": {"B": b, "S": s}, "causal_ms": c_ms,
            "causal_device_ms": c_dev,
            "causal_bound_ms": bound_ms(nbytes, flops, H100_BF16_FLOPS)[0],
            "packed_over_causal": ratio, "compared_by": by,
            "limit": PACKED_OVER_CAUSAL_LIMIT,
            "bit_equal_to_causal": equal}


def packed_build_facts() -> dict:
    """What the packed mode's attention body and its plan kernel compiled
    to: resident blocks per SM, ptxas registers and spills, and the
    body's tensor-core, TMA and barrier instructions in SASS."""
    import shutil
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    blocks = lib.repro_flash_attention_packed_blocks_per_sm()
    if blocks < 1:
        raise AssertionError(f"flash_attention_packed: occupancy query gave "
                             f"{blocks}")
    facts = {}
    for label, needle in (("body", "flash_attention_packed_kernel"),
                          ("plan", "flash_packed_plan_kernel")):
        ptxas = next((u for name, u in cuda_lib.BUILD_INFO["ptxas"].items()
                      if needle in name), {})
        facts[label] = {"registers": ptxas.get("registers", "not measured"),
                        "spill_bytes": ptxas.get("spill_stores", 0) +
                        ptxas.get("spill_loads", 0),
                        "static_smem_bytes": ptxas.get("static_smem_bytes",
                                                       0)}
    facts["body"].update(
        blocks_per_sm=blocks, threads=384,
        registers_note="ptxas reports the launch's 168; setmaxnreg gives "
                       "the producer warpgroup 24 and each consumer 240")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        facts["body"]["sass"] = cuda_lib.sass_opcodes(
            sass, "flash_attention_packed_kernel",
            ("HGMMA", "UTMALDG", "LDGSTS", "SYNCS", "MUFU", "BAR"))
        if facts["body"]["sass"]["HGMMA"] == 0 or \
                facts["body"]["sass"]["UTMALDG"] == 0:
            raise AssertionError("flash_attention_packed: no wgmma (HGMMA) "
                                 "or TMA load (UTMALDG) in its SASS")
    else:
        facts["body"]["sass"] = "not measured: no cuobjdump"
    return facts


def check_flash_attention_packed(dev, gen, results):
    """The packed mode on cases (a) to (c), and (d), (e) at the MoE path's
    group 1; the kernels line reports case (a) with the worst error over
    the five."""
    lines = []
    for case in PACKED_CASES + MOE_PACKED_CASES + WIDE_PACKED_CASES:
        lines.append(packed_case(dev, gen, *case))
        emit(lines[-1])
        release_memory()
    ratio = lines[0]["against_causal"]["packed_over_causal"]
    if ratio > PACKED_OVER_CAUSAL_LIMIT:
        raise AssertionError(
            f"flash_attention_packed: {ratio:.2f}x the causal kernel's time "
            f"on the same visible pairs (limit {PACKED_OVER_CAUSAL_LIMIT})")
    if not lines[0]["against_causal"]["bit_equal_to_causal"]:
        raise AssertionError(
            "flash_attention_packed: case (a)'s rows differ from the causal "
            "kernel's on the same tile-aligned segments")
    emit({"phase": "flash_attention_packed_build", **packed_build_facts()})
    results["flash_attention_packed"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91")


#: random ids and positions the plan kernel is held to its plain version
#: on, besides the three packs: (seed, Sq up to, extra keys up to)
PLAN_RANDOM = [(seed, 2048, 1024) for seed in range(8)]


def plan_layouts(dev, gen):
    """(label, ids) of the plan check: the packs of ``PACKED_CASES`` and
    ``PLAN_RANDOM``'s ids and positions drawn one by one."""
    from repro_torch.runtime.engine import segment_labels
    out = []
    for label, fresh, prefix, width, pre_width in PACKED_CASES:
        q_seg, q_pos = segment_labels(fresh, prefix, width)
        p_seg, p_pos = segment_labels(prefix, [0] * len(prefix), pre_width)
        out.append((label, [torch.from_numpy(a).to(dev) for a in (
            q_seg, np.concatenate([p_seg, q_seg]), q_pos,
            np.concatenate([p_pos, q_pos]))]))
    for seed, sq_max, extra in PLAN_RANDOM:
        rng = np.random.default_rng(SEED + seed)
        sq = int(rng.integers(1, sq_max + 1))
        sk = sq + int(rng.integers(0, extra + 1))
        q_seg = rng.integers(-2, 6, sq).astype(np.int32)
        q_pos = rng.integers(0, 200, sq).astype(np.int32)
        k_seg = rng.integers(-2, 6, sk).astype(np.int32)
        k_pos = rng.integers(0, 200, sk).astype(np.int32)
        k_seg[sk - sq:], k_pos[sk - sq:] = q_seg, q_pos
        out.append((f"random {seed}", [torch.from_numpy(a).to(dev) for a in
                                       (q_seg, k_seg, q_pos, k_pos)]))
    return out


def check_flash_attention_packed_plan(dev, gen, results):
    """The packed mode's plan kernel against its plain version, entry for
    entry, on the packs of ``PACKED_CASES`` and on random layouts; times
    at case (a), the 8192 pack of the serve path's profile.  Bound: the
    bytes of the ids and positions read once and the plan written once
    (the kernel reads the keys' ids and positions once a query tile,
    from L2).  It replaces the part of the packed mode (the TPU kernel
    ``flash_attention_pallas``'s counterpart) that each block planned
    for itself."""
    from repro_torch.kernels import flash_attention, ref
    checked = []
    for label, ids in plan_layouts(dev, gen):
        got = flash_attention.flash_attention_packed_plan_cuda(*ids)
        want = ref.flash_attention_packed_plan_ref(*ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"flash_attention_packed_plan {label}: "
                                 f"{bad} rows differ from the plain plan")
        checked.append({"layout": label, "Sq": int(ids[0].numel()),
                        "Sk": int(ids[1].numel()),
                        "visited_tiles": int(got[:, 0].sum())})
    ids = plan_layouts(dev, gen)[0][1]

    def kernel():
        return flash_attention.flash_attention_packed_plan_cuda(*ids)

    def plain():
        return ref.flash_attention_packed_plan_ref(*ids)
    plan = kernel()
    sq, sk = ids[0].numel(), ids[1].numel()
    nbytes = 8 * (sq + sk) + plan.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 0.0, H100_BF16_FLOPS)
    iters = 20
    k_ms, p_ms = time_ms(kernel, iters), time_ms(plain, 3)
    line = {"phase": "kernel_check", "kernel": "flash_attention_packed_plan",
            "case": PACKED_CASES[0][0], "shape": {"Sq": sq, "Sk": sk},
            "plan_shape": list(plan.shape), "plan_bytes": plan.numel() * 4,
            "layouts_checked": checked,
            "tolerance": "exact: every entry equal to the plain plan's",
            "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None, "library_device_ms": None,
            "library": "none: no PyTorch call computes a tile plan",
            "device_ms": device_ms(kernel, iters)["port"],
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_counts": "q_seg, q_pos, k_seg, k_pos read once, the "
                            "plan written once",
            "share_of_bound": b_ms / k_ms}
    if isinstance(line["device_ms"], float):
        line["device_share_of_bound"] = b_ms / line["device_ms"]
    emit(line)
    results["flash_attention_packed_plan"] = dict(
        line, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91")


def tol_why_attention() -> str:
    return ("bf16 inputs and output; the kernel rounds the unnormalised "
            "probabilities to bf16 before P.V and divides by their f32 "
            "sum after, the plain version rounds the normalised weights; "
            "sums in other orders")


DECODE_TOL = dict(atol=4e-3, rtol=4e-3)    # a few bf16 ulps of the output
DECODE_TOL_WHY = ("the cache is f32 and the kernel keeps f32 throughout; "
                  "the plain version rounds the softmax weights to q's "
                  "bf16, and both round the output to bf16: a few of its "
                  "ulps apart")
#: the decode checks' cases: the serve-like spread of lengths (the
#: kernels line's), and the full load
DECODE_CASES = (("lengths 1..1024", "spread"),
                ("full load, every row 1024", "full"))
#: the MoE path's paged decode (OLMoE: H 16 over KV 16, group 1)
MOE_DECODE_CASES = (("lengths 1..1024, KV 16", "spread", 16),
                    ("full load, every row 1024, KV 16", "full", 16))
#: the newer served models' paged decode: (label, lengths, KV, H, dh):
#: Qwen2-VL's group 7 and StarCoder2's group 12 at dh 128, MusicGen's
#: group 1 at dh 64.  Their tolerance allows one bf16 ulp of the output
#: (2**-7 relative) beside DECODE_TOL's atol: 48 heads give outputs near
#: 3, where one ulp (1/64) passes DECODE_TOL
MODEL_DECODE_TOL = dict(atol=4e-3, rtol=2 ** -7)
MODEL_DECODE_CASES = tuple(
    (f"{which_label}, H {h} / KV {kv}, dh {dh}", which, kv, h, dh)
    for kv, h, dh in ((4, 28, 128), (4, 48, 128), (32, 32, 64))
    for which_label, which in (("lengths 1..1024", "spread"),
                               ("full load", "full")))


def decode_lengths(dev, b: int, s: int, which) -> torch.Tensor:
    """``which``: "spread" (1 to S evenly), "full" (every row S), or the
    B lengths themselves."""
    if which == "full":
        return torch.full((b,), s, dtype=torch.int32, device=dev)
    if which == "spread":
        return torch.linspace(1, s, b, device=dev).round().to(torch.int32)
    return torch.tensor(which, dtype=torch.int32, device=dev)


def decode_timing(kernel, nbytes: int, flops: float, iters: int) -> dict:
    """A decode kernel's times and bound: ``ms`` from CUDA events over
    back-to-back calls (host time included); ``device_ms`` its own device
    time with the L2 flushed before every call, as the decode tick finds
    it; ``device_ms_warm_l2`` back to back, the inputs left in L2 by the
    call before (how PR 14 timed it)."""
    line = {"ms": time_ms(kernel, iters),
            **cold_warm(kernel, nbytes, flops, H100_F32_FLOPS, iters),
            "bound_counts": "live K and V rows read once, q read, output "
                            "written, tables and lengths read"}
    if isinstance(line["device_ms"], float):
        line["gbytes_per_s"] = nbytes / (line["device_ms"] * 1e-3) / 1e9
    return line


def paged_decode_case(dev, gen, label: str, which, kv: int = 8,
                      h: int = 16, dh: int = 128) -> dict:
    """The paged decode kernel at B 8, ``h`` heads over ``kv`` KV heads of
    ``dh``, BS 16, MB 64 over a pool of randomly placed blocks: against
    its plain version, then timed (``decode_timing``)."""
    from repro_torch.kernels import flash_decode, ref
    b, bs, mb = 8, 16, 64
    nb = b * mb + 1
    lengths = decode_lengths(dev, b, mb * bs, which)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lengths.tolist()):
        nblk = -(-ln // bs)
        tables[i, :nblk] = perm[used:used + nblk].to(torch.int32)
        used += nblk               # logical blocks past the length: trash 0
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    k_pool = torch.randn((nb, bs, kv, dh), generator=gen, device=dev)
    v_pool = torch.randn((nb, bs, kv, dh), generator=gen, device=dev)

    def kernel():
        return flash_decode.flash_decode_paged_cuda(q, k_pool, v_pool,
                                                    tables, lengths)

    def plain():
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, tables,
                                          lengths)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = DECODE_TOL if (h // kv, dh) in ((2, 128), (1, 128)) \
        else MODEL_DECODE_TOL
    err = check_close(f"flash_decode_paged {label}", out, want, **tol)
    live = int(lengths.sum())
    nbytes = 2 * live * kv * dh * 4 + 2 * b * h * dh * 2 + b * mb * 4 + b * 4
    line = {"phase": "kernel_check", "kernel": "flash_decode_paged",
            "case": label,
            "shape": {"B": b, "H": h, "KV": kv, "dh": dh, "BS": bs,
                      "MB": mb, "lengths": lengths.tolist()},
            "dtype": "q bfloat16, pool float32",
            "tolerance": {**tol, "why": DECODE_TOL_WHY},
            "max_abs_err": err,
            **decode_timing(kernel, nbytes, 4.0 * h * dh * live, 200),
            "plain_ms": time_ms(plain, 20),
            "library_ms": None, "library_device_ms": None}
    return line


def check_paged_decode(dev, gen, results):
    lines = [paged_decode_case(dev, gen, *case)
             for case in DECODE_CASES + MOE_DECODE_CASES +
             MODEL_DECODE_CASES]
    for line in lines:
        emit(line)
    results["flash_decode_paged"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:207")


def flash_decode_build_facts() -> dict:
    """What the decode kernels compiled to, per (layout, q dtype, group):
    registers and spills (ptxas), static and dynamic shared memory and
    resident blocks per SM (CUDA occupancy calculator); and, for the
    serve path's instantiation (paged, bf16 q, G 2), the async copies
    (LDGSTS), shuffles and exp units in its SASS (cuobjdump)."""
    import shutil
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_decode
    lib = cuda_lib.library()
    facts = {}
    for layout, rows, paged in (("paged", "PagedRows", 1),
                                ("contiguous", "StridedRows", 0)):
        for dtype, code, mangled in (("f32", 0, "decode_kernelIf"),
                                     ("bf16", 1, "decode_kernelI13__nv_")):
            for g, dh in flash_decode.INSTANTIATIONS:
                blocks = lib.repro_flash_decode_blocks_per_sm(code, g, paged,
                                                              dh)
                if blocks < 1:
                    raise AssertionError(
                        f"flash_decode {layout} {dtype} G {g} dh {dh}: "
                        f"occupancy query gave {blocks}")
                ptxas = next((u for name, u in
                              cuda_lib.BUILD_INFO["ptxas"].items()
                              if mangled in name and
                              f"Li{g}ELi{dh}E" in name and rows in name), {})
                facts[f"{layout} {dtype} G{g} dh{dh}"] = {
                    "blocks_per_sm": blocks,
                    "registers": ptxas.get("registers", "not measured"),
                    "spill_bytes": ptxas.get("spill_stores", 0) +
                    ptxas.get("spill_loads", 0),
                    "smem_bytes": lib.repro_flash_decode_ring_bytes(dh) +
                    ptxas.get("static_smem_bytes", 0)}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        facts["sass_paged_bf16_G2"] = cuda_lib.sass_opcodes(
            sass, "decode_kernelI13__nv_bfloat16Li2ELi128ENS_9PagedRows",
            ("LDGSTS", "SHFL", "MUFU", "FFMA", "ATOMG", "RED"))
        if facts["sass_paged_bf16_G2"]["LDGSTS"] == 0:
            raise AssertionError("flash_decode: no cp.async (LDGSTS) in "
                                 "the paged kernel's SASS")
    else:
        facts["sass_paged_bf16_G2"] = "not measured: no cuobjdump"
    return facts


def softmax_case(dev, gen, label: str, lengths, c: int,
                 dtype: torch.dtype) -> dict:
    """One shape of the masked softmax: kernel against its plain version,
    exact zeros past each length, and the times of kernel, plain version
    and torch.softmax of the pre-masked input."""
    from repro_torch.kernels import ref, softmax
    r = lengths.numel()
    x = (4 * torch.randn((r, c), generator=gen, device=dev)).to(dtype)
    scale = 1 / math.sqrt(128)

    def kernel():
        return softmax.softmax_cuda(x, lengths, scale=scale)

    def plain():
        return ref.softmax_ref(x, lengths, scale)
    valid = torch.arange(c, device=dev)[None, :] < lengths[:, None]
    x_masked = torch.where(valid, x.float() * scale, float("-inf"))

    def library():
        return torch.softmax(x_masked, dim=-1)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=1e-5, rtol=8e-3)
    err = check_close(f"fused_softmax {label}", out, want, **tol)
    if bool((out[~valid] != 0).any()):
        raise AssertionError(f"fused_softmax {label}: a column past its "
                             "row's length is not exactly zero")
    iters = 50 if r > 4096 else 200
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    # what the function needs: the columns below min(length, C) read
    # once, every column written once (zeros past the length), lengths
    live = int(lengths.clamp(0, c).sum())
    nbytes = (live + r * c) * x.element_size() + r * 4
    b_ms, b_by = bound_ms(nbytes, 5.0 * live, H100_F32_FLOPS)
    return {"phase": "kernel_check", "kernel": "fused_softmax",
            "case": label, "shape": [r, c], "dtype": str(dtype),
            "tolerance": {**tol, "why": "f32 math in both; the row sum is "
                          "taken in another order (bf16: one ulp of the "
                          "rounded output)"},
            "zeros_past_length": "exact",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": "torch.softmax of the pre-masked, pre-scaled input",
            "bound_ms": b_ms, "bound_by": b_by, **dev_t,
            "bound_counts": "live columns read, whole rows written",
            "share_of_bound": b_ms / k_ms}


def check_softmax(dev, gen, results):
    """The masked softmax at the classify shape (B 16, H 16, S 512, causal
    row lengths), at S 1024, and on rows of length 0 and past C."""
    def causal(bh: int, s: int):        # the rows of a (B*H, S, S) score
        return torch.arange(1, s + 1, dtype=torch.int32,
                            device=dev).repeat(bh)

    def ragged(c: int):
        lengths = torch.randint(-2, 2 * c, (4096,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[:8] = torch.tensor([0, 0, c, c + 1, 5 * c, 1, -1, 7],
                                   dtype=torch.int32)
        return lengths
    lines = [softmax_case(dev, gen, "classify B16 H16 S512",
                          causal(16 * 16, 512), 512, torch.float32),
             softmax_case(dev, gen, "B4 H16 S1024", causal(4 * 16, 1024),
                          1024, torch.float32),
             softmax_case(dev, gen, "ragged C300, lengths 0 and > C",
                          ragged(300), 300, torch.float32),
             softmax_case(dev, gen, "ragged bf16 C512, lengths 0 and > C",
                          ragged(512), 512, torch.bfloat16)]
    for line in lines:
        emit(line)
    # the kernels line reports the classify shape and the worst error
    results["fused_softmax"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/softmax.cu",
        replaces="src/repro/kernels/softmax.py:42")


def contiguous_decode_case(dev, gen, label: str, which) -> dict:
    """Contiguous decode at B 8, H 16, KV 8, S 1024 on a strided view of a
    (B, S, KV, dh) cache whose positions past each length are NaN: against
    its plain version, bit for bit against the paged kernel on the same
    keys, then timed (``decode_timing``), with SDPA beside it."""
    from repro_torch.kernels import flash_decode, ref
    import torch.nn.functional as F
    b, h, kv, dh, s, bs = 8, 16, 8, 128, 1024, 16
    lengths = decode_lengths(dev, b, s, which)
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    kc = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    vc = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= lengths[:, None]
    kc[past] = float("nan")            # never written, never to be read
    vc[past] = float("nan")
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)     # (B, KV, S, dh)
    # the plain version multiplies masked weights (0) into V: give it the
    # same keys with a finite tail
    k0 = kc.masked_fill(past[:, :, None, None], 0).transpose(1, 2)
    v0 = vc.masked_fill(past[:, :, None, None], 0).transpose(1, 2)

    def kernel():
        return flash_decode.flash_decode_cuda(q, k, v, lengths)

    def plain():
        return ref.flash_decode_ref(q, k0, v0, lengths)
    mask = ~past[:, None, None, :]
    qf = q.float()[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(qf, k0, v0, attn_mask=mask,
                                              enable_gqa=True)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close(f"flash_decode {label}", out, want, **DECODE_TOL)
    # the same keys in a pool: row r owns blocks 1 + r * MB ... in order
    mb = s // bs
    pool_k = torch.cat([torch.zeros((1, bs, kv, dh), device=dev),
                        kc.reshape(b * mb, bs, kv, dh)])
    pool_v = torch.cat([torch.zeros((1, bs, kv, dh), device=dev),
                        vc.reshape(b * mb, bs, kv, dh)])
    tables = (1 + torch.arange(b * mb, device=dev, dtype=torch.int32)
              ).reshape(b, mb)
    paged = flash_decode.flash_decode_paged_cuda(q, pool_k, pool_v, tables,
                                                 lengths)
    torch.cuda.synchronize()
    bit_diff = max_err(out, paged)
    if not torch.equal(out, paged):
        raise AssertionError(f"flash_decode {label}: differs from the "
                             f"paged kernel on the same keys (max abs "
                             f"{bit_diff})")
    del pool_k, pool_v
    live = int(lengths.sum())
    nbytes = 2 * live * kv * dh * 4 + 2 * b * h * dh * 2 + b * 4
    return {"phase": "kernel_check", "kernel": "flash_decode",
            "case": label,
            "shape": {"B": b, "H": h, "KV": kv, "dh": dh, "S": s,
                      "lengths": lengths.tolist(),
                      "layout": "strided (B, KV, S, dh) view of a "
                                "(B, S, KV, dh) cache, NaN past each length"},
            "dtype": "q bfloat16, cache float32",
            "tolerance": {**DECODE_TOL, "why": DECODE_TOL_WHY},
            "max_abs_err": err, "max_abs_diff_vs_paged_kernel": bit_diff,
            **decode_timing(kernel, nbytes, 4.0 * h * dh * live, 200),
            "plain_ms": time_ms(plain, 20),
            "library_ms": time_ms(library, 50),
            "library_device_ms": device_ms(library, 50)["all"],
            "library": "F.scaled_dot_product_attention (f32 q, bool mask, "
                       "enable_gqa), back to back (warm L2)"}


def check_contiguous_decode(dev, gen, results):
    lines = [contiguous_decode_case(dev, gen, label, which)
             for label, which in DECODE_CASES]
    for line in lines:
        emit(line)
    emit({"phase": "flash_decode_build", **flash_decode_build_facts()})
    results["flash_decode"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:81")


def sample_inputs(dev, gen, dtype: torch.dtype, v: int = 92544):
    """The sampling check's eight rows at B 8, V ``v``, C 64: two greedy
    rows; row 1 with ten ties at the top; row 2 with 40 ties at the top
    and the C-th rank inside a run of 60 more ties (spread over the row,
    so over every block of its cluster); row 5 with 20 finite values and
    the rest -inf, fewer than C."""
    from repro_torch.runtime.sampling import gumbel_noise
    b, c = 8, 64
    logits = 3 * torch.randn((b, v), generator=gen, device=dev)
    logits[1, 100:110] = logits[1].max() + 1     # a tie at the top
    spread = torch.randperm(v, generator=gen, device=dev)
    logits[2, spread[:40]] = 30.0                # exact in bf16 too
    logits[2, spread[40:100]] = 25.0             # ranks 41..100 tie
    logits[5] = float("-inf")
    logits[5, spread[100:120]] = 3 * torch.randn((20,), generator=gen,
                                                 device=dev)
    logits = logits.to(dtype)
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.0, 0.9, 0.5, 2.0],
                        device=dev)
    top_k = torch.tensor([0, 0, 40, 5, 0, 100, 1, 0], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 0.9, 1.0, 0.8, 1.0, 0.95, 1.0, 0.5],
                         device=dev)
    seed = torch.arange(b, dtype=torch.int32, device=dev) + 11
    gumbel = gumbel_noise(seed, torch.full_like(seed, 3), c)
    return logits, temp, top_k, top_p, gumbel


def sample_case(dev, gen, dtype: torch.dtype, v: int = 92544) -> dict:
    """The fused sampler at B 8, V ``v``, C 64 with ``dtype`` logits:
    every token against the plain version, then its device time cold and
    warm (the LM head has just written the logits, so the tick finds them
    in L2)."""
    from repro_torch.kernels import ref, sampling
    args = sample_inputs(dev, gen, dtype, v)
    logits, _, _, _, gumbel = args
    b, v = logits.shape
    c = gumbel.shape[-1]

    def kernel():
        return sampling.sample_cuda(*args)

    def plain():
        return ref.sample_ref(*args)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    mismatch = int((out != want).sum())
    if mismatch:
        raise AssertionError(f"fused_sample {dtype}: {mismatch} rows differ "
                             f"from the plain version: {out.tolist()} vs "
                             f"{want.tolist()}")
    nbytes = b * v * logits.element_size() + b * c * 4 + b * 16
    return {"phase": "kernel_check", "kernel": "fused_sample",
            "shape": {"B": b, "V": v, "C": c}, "dtype": str(dtype),
            "rows": "greedy 0 and 4; ties at the top in 1; the C-th rank "
                    "inside a run of ties in 2; 20 finite values in 5",
            "tolerance": {"tokens": "exact", "why": "integer tokens; "
                          "both versions consume the same noise"},
            "tokens": out.tolist(),
            "max_abs_err": float(mismatch), "ms": time_ms(kernel, 50),
            "plain_ms": time_ms(plain, 20), "library_ms": None,
            "library_device_ms": None,
            **cold_warm(kernel, nbytes, 2.0 * b * v, H100_F32_FLOPS, 50),
            "bound_counts": "logits read once, noise and per-row "
                            "parameters read, tokens written"}


def sample_build_facts() -> dict:
    """What the sampling kernel compiled to (ptxas registers, spills,
    static shared memory) and what a launch at V 92544, C 64 gets: its
    dynamic shared memory, resident blocks per SM and the most clusters
    the card runs at once."""
    import ctypes

    from repro_torch.kernels import cuda_lib, sampling
    lib = cuda_lib.library()
    plan = sampling.sample_plan(8, 92544, 64)
    facts = {"cluster": plan.cluster, "slice_len": plan.slice_len,
             "dynamic_smem_bytes": plan.smem_bytes,
             "digit_bits": sampling.DIGIT_BITS}
    for label, code, mangled in (("f32", 0, "sample_kernelIfE"),
                                 ("bf16", 1, "sample_kernelI13__nv_")):
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        cuda_lib.check(lib.repro_sample_occupancy(
            code, plan.smem_bytes, ctypes.byref(blocks),
            ctypes.byref(clusters)), "repro_sample_occupancy")
        if blocks.value < 1 or clusters.value < 1:
            raise AssertionError(f"fused_sample {label}: {blocks.value} "
                                 f"blocks per SM, {clusters.value} clusters")
        ptxas = next((u for name, u in cuda_lib.BUILD_INFO["ptxas"].items()
                      if mangled in name), {})
        facts[label] = {"blocks_per_sm": blocks.value,
                        "max_active_clusters": clusters.value,
                        "registers": ptxas.get("registers", "not measured"),
                        "spill_bytes": ptxas.get("spill_stores", 0) +
                        ptxas.get("spill_loads", 0),
                        "static_smem_bytes": ptxas.get("static_smem_bytes",
                                                       0)}
    return facts


def sampling_plan_facts(vocab: int) -> dict:
    """The sampler's plan at B 8, C 64 for ``vocab`` and the resident
    blocks per SM its shared memory allows (bf16 logits)."""
    import ctypes

    from repro_torch.kernels import cuda_lib, sampling
    plan = sampling.sample_plan(8, vocab, 64)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().repro_sample_occupancy(
        1, plan.smem_bytes, ctypes.byref(blocks), ctypes.byref(clusters)),
        "repro_sample_occupancy")
    return {"slice_len": plan.slice_len, "dynamic_smem_bytes":
            plan.smem_bytes, "blocks_per_sm": blocks.value,
            "max_active_clusters": clusters.value,
            "max_slice": sampling.MAX_SLICE}


def check_sample(dev, gen, results):
    """f32 logits (the earlier slices' check) and bf16, as the LM head
    writes them on the serve path, and bf16 at the MoE path's vocab
    (OLMoE's 50304); the kernels line reports bf16 at V 92544."""
    lines = [sample_case(dev, gen, dtype)
             for dtype in (torch.float32, torch.bfloat16)]
    lines.append(sample_case(dev, gen, torch.bfloat16, v=50304))
    # Qwen2-VL's vocab (a slice of 19008 values a block) and StarCoder2's,
    # Falcon-Mamba's and Zamba2's
    lines.append(sample_case(dev, gen, torch.bfloat16, v=152064))
    lines.append(sample_case(dev, gen, torch.bfloat16, v=49152))
    lines.append(sample_case(dev, gen, torch.bfloat16, v=65024))
    lines.append(sample_case(dev, gen, torch.bfloat16, v=32000))
    for line in lines:
        emit(line)
    plan = sampling_plan_facts(152064)
    emit({"phase": "sample_build", **sample_build_facts(),
          "plan_v152064": plan})
    results["fused_sample"] = dict(
        lines[1], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/sampling.cu",
        replaces="src/repro/kernels/sampling.py:83")


# ---------------------------------------------------------------------------
# Phase 4: serve full-width InternLM2-1.8B
# ---------------------------------------------------------------------------


def own_prefill_logits(engine, tokens) -> torch.Tensor:
    """Last-token logits (V,) of ``tokens`` prefilled alone, in f32."""
    from repro_torch.models import prefill
    logits, _ = prefill(engine.cfg, engine.params,
                        torch.tensor([tokens], device=engine.device))
    return logits[0].float()


#: how far a prompt's last-token logits from a packed pass may lie from
#: its own prefill's, in bf16 ulps at the row's largest |logit|: the
#: bound the classify phase holds a request's logits to between its
#: served batch and a batch of its own (bf16 activations through 24
#: layers, products at other shapes)
PACKED_LOGIT_ULPS = 4


def packed_logit_drift(engine, prompts, group_size: int = 8) -> tuple:
    """The largest |logit| difference between each prompt's last-token
    logits from a packed pass (the prompts packed in groups of
    ``group_size``, the top batch bucket) and from its own prefill, and
    the largest in bf16 ulps of the row's largest |logit|; fails where
    one passes ``PACKED_LOGIT_ULPS``."""
    cfg = engine.cfg
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                        device=engine.device)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=engine.device)
    worst, worst_ulps = 0.0, 0.0
    for at in range(0, len(prompts), group_size):
        group = prompts[at:at + group_size]
        logits, _ = engine.prefill_packed_flat(group, [0] * len(group),
                                               no_kv, no_kv, no_ids, no_ids)
        for i, p in enumerate(group):
            got, own = logits[i].float(), own_prefill_logits(engine, p)
            d = float((got - own).abs().max())
            ulps = d / bf16_ulp(float(own.abs().max()))
            if not ulps <= PACKED_LOGIT_ULPS or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"packed prefill: prompt {at + i} ({len(p)} tokens) "
                    f"logits {d:.3g} ({ulps:.2f} bf16 ulps of the row's "
                    f"largest) from its own prefill's (limit "
                    f"{PACKED_LOGIT_ULPS})")
            worst, worst_ulps = max(worst, d), max(worst_ulps, ulps)
    return worst, worst_ulps


def draw_margins(logits, params, step: int, served: int):
    """How far the draw at ``step`` from ``logits`` (V,) lies from changing,
    and from giving the token ``served`` instead, both on the scale of a
    greedy top-2 gap (in logits / T for a sampled draw): twice the least
    move of every logit under which it can happen.

    Greedy: the top-2 gap, and the gap between the top logit and the
    served token's.  Sampled: the draw takes, among the kept ranks (top k,
    then the nucleus), the rank whose scaled value plus its Gumbel noise
    is largest; the noise belongs to the rank.  A move of every value by
    at most e moves each rank's value by at most e, so the winner changes
    only where (1) a token next to it in rank order comes within 2e and
    takes its rank, (2) another kept rank's value plus noise comes within
    2e of the winner's, or (3) the nucleus cut crosses the winner, or a
    rank that would then beat it: a rank's exclusive mass moves past
    top_p only where e reaches half the distance of their log-odds.  The
    served token is drawn only where it can take some rank q (half their
    value gap) that is kept and beats every other kept rank.  Where one
    event needs several conditions, its move is their largest, a lower
    bound: a divergence whose served gap is at or above the limit is one
    that no smaller move explains."""
    x = logits.double().cpu()
    if params.temperature <= 0:
        top = x.topk(2).values
        return float(top[0] - top[1]), float(top[0] - x[served])
    from repro_torch.runtime.sampling import (DEFAULT_SAMPLE_CANDIDATES,
                                              gumbel_noise)
    c = DEFAULT_SAMPLE_CANDIDATES
    seed = torch.tensor([params.seed], dtype=torch.int32)
    noise = gumbel_noise(seed, torch.full_like(seed, step), c)[0].double()
    # the sampler scales in f32 and orders ties by index
    scaled = (logits.float() / params.temperature).double().cpu()
    vals = torch.sort(scaled, descending=True, stable=True).values
    k = params.top_k if 0 < params.top_k <= c else c
    probs = torch.softmax(vals[:k], dim=-1)
    mass = torch.cumsum(probs, 0) - probs          # exclusive, rank order
    kept = [bool(m < params.top_p) for m in mass]
    pert = [float(v) for v in vals[:k] + noise[:k]]
    win = max((r for r in range(k) if kept[r]), key=lambda r: pert[r])
    logit_p = math.log(params.top_p / (1 - params.top_p)) \
        if params.top_p < 1 else None

    def cut(r: int) -> float:        # the nucleus crosses rank r
        m = float(mass[r])
        if logit_p is None or m <= 0:
            return math.inf
        m = min(m, 1 - 1e-12)
        return 0.5 * abs(math.log(m / (1 - m)) - logit_p)

    def beats(r: int) -> float:      # rank r's value + noise passes the rest
        rest = [pert[q] for q in range(k) if q != r and kept[q]]
        return max(0.0, (max(rest, default=-math.inf) - pert[r]) / 2)

    events = [(float(vals[win]) - float(vals[win + 1])) / 2, cut(win)]
    if win > 0:
        events.append((float(vals[win - 1]) - float(vals[win])) / 2)
    events += [max(0.0 if kept[r] else cut(r), (pert[win] - pert[r]) / 2)
               for r in range(k) if r != win]
    v_t = float(scaled[served])
    reach = [max(abs(float(vals[q]) - v_t) / 2, 0.0 if kept[q] else cut(q),
                 beats(q)) for q in range(k)]
    return 2 * min(events), 2 * min(reach)


def explain_divergence(engine, prompt, params, alone, served,
                       dlogit: float) -> dict:
    """Where a served stream leaves the request run alone: the first
    differing step, the alone run's margin there and the served token's
    gap (``draw_margins``), from a prefill of the prompt and the alone
    run's tokens before it.  ``within_rule``: the margin is below twice
    the packed pass's logit drift (the step is a near tie that rounding
    may flip), and so is the served token's gap (rounding of that size
    can give the token that was served)."""
    n = len(prompt)
    step = next(i for i, (a, b) in enumerate(zip(alone[n:], served[n:]))
                if a != b)
    logits = own_prefill_logits(engine, alone[:n + step])
    margin, served_gap = draw_margins(logits, params, step, served[n + step])
    limit = 2 * dlogit / (params.temperature if params.temperature > 0
                          else 1.0)
    return {"prompt_len": n, "sampled": params.temperature > 0,
            "first_differing_step": step, "alone_margin": margin,
            "served_token_gap": served_gap, "limit": limit,
            "within_rule": margin < limit and served_gap < limit}


def cell_kind(key) -> str:
    """The kind of a classify or prefill cell, from its key."""
    if isinstance(key[0], str):
        return {"sfx": "suffix", "pack": "packed"}[key[0]]
    return "classify" if len(key) == 2 else "per_group"


def cell_stats(engine, since: dict = None) -> dict:
    """The classify and prefill cells the engine holds (every key asked
    for is captured on the card): their number by kind, the seconds their
    first calls and captures took, the graph pool's and the static
    buffers' bytes; after ``since`` (an earlier result) also the keys
    captured since and their seconds."""
    tables = (engine.prefill_cells, engine.classify_cells)
    keys = [k for t in tables for k in t.keys()]
    kinds = {}
    for k in keys:
        kinds[cell_kind(k)] = kinds.get(cell_kind(k), 0) + 1
    out = {"cells_by_kind": kinds,
           "capture_s": sum(t.capture_seconds for t in tables),
           "graph_pool_bytes": engine.cell_arena.pool_bytes(),
           "static_buffer_bytes": engine.cell_arena.buffer_bytes(),
           "keys": [list(k) for k in keys]}
    if since is not None:
        seen = {tuple(k) for k in since["keys"]}
        out["captured_since"] = [list(k) for k in keys if k not in seen]
        out["capture_s_since"] = out["capture_s"] - since["capture_s"]
    return out


#: the serve phases' prompt lengths, in arrival order: the first 8
#: arrive together, the other 6 mid-decode
SERVE_PROMPT_LENS = (64, 960, 200, 512, 90, 700, 130, 333, 1000 - 64, 77,
                     480, 256, 150, 600)


def serve_specs(vocab: int, rng) -> list:
    """(prompt, params) of the serve phases' 14 requests: prompts of
    ``SERVE_PROMPT_LENS`` tokens, 32 to 64 new tokens each (within the
    1024 bucket), every third from the second sampled (5 of 14)."""
    from repro_torch.api import GenerationParams
    specs = []
    for i, n in enumerate(SERVE_PROMPT_LENS):
        new = int(rng.integers(32, 65))
        new = min(new, 1024 - n)
        sampled = i % 3 == 1
        params = GenerationParams(
            max_new_tokens=new, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 1.0,
            seed=1000 + i)
        prompt = [int(t) for t in rng.integers(1, vocab, n)]
        specs.append((prompt, params))
    return specs


def attention_layers(cfg) -> int:
    """The attention layers one pass of ``cfg`` runs: every layer of a
    transformer, the shared block's applications of a hybrid, none of an
    SSM model."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def norms_per_pass(cfg) -> int:
    """Norm launches of one pass: two a transformer layer, one a mamba
    layer and two a shared-block application, and the final norm."""
    if cfg.family in ("ssm", "hybrid"):
        return cfg.num_layers + 2 * attention_layers(cfg) + 1
    return 2 * cfg.num_layers + 1


def model_line(arch: str, cfg) -> str:
    """The serve line's description of the model at full width."""
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        shared = (f"; one shared attention + FFN block after every "
                  f"{cfg.attn_every} layers, H {cfg.num_heads} / KV "
                  f"{cfg.num_kv_heads} at dh {cfg.head_dim}"
                  if cfg.attn_every else "")
        return (f"{arch} (full width, {cfg.num_layers} {ssm.variant} "
                f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
                f"state {ssm.state_dim}, chunk {ssm.chunk_size}{shared}, "
                f"vocab {cfg.vocab_size}; bf16 weights from a seed, f32 "
                "conv window, scan state and KV)")
    return (f"{arch} (full width, {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, H {cfg.num_heads} / KV {cfg.num_kv_heads}, "
            f"{cfg.norm} + {cfg.act}, rope {cfg.rope}, vocab "
            f"{cfg.vocab_size}; bf16 weights from a seed, f32 KV)")


#: the SSM phases' slot count (and batch bucket): every admission of an
#: SSM model prefills at the batch bucket, padding rows included, through
#: the plain-torch scan (900 to 1450 prompt tokens a second a row at
#: full width, tools/ssm_cost.py), so the phases serve with 4 slots
SSM_SLOTS = 4


def serve(dev, card: str, layout: str = "paged",
          arch: str = "internlm2-1.8b", phase: str = None,
          slots: int = 8):
    """The generative path over the paged pool (phase 4) or the contiguous
    slot cache (phase 7, ``layout="contiguous"``), of InternLM2-1.8B or
    another model at full width (``arch``; the line's ``phase`` names
    it), with ``slots`` decode slots, the one batch bucket.  An SSM or
    hybrid model (contiguous only) also has its graph replays held to
    their eager bodies (``replay_audit``)."""
    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.kernels import cuda_lib
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    # one batch bucket, the slot count: generate() of one prompt then runs
    # the decode tick's matrix products at the serving batch's shape, so
    # its greedy stream can be held bit for bit against the served one
    # (cuBLAS may pick another kernel, and round otherwise, at batch 1).
    # The pool holds every slot at the top bucket, plus the trash block.
    # The contiguous slot cache starts at 1024 positions (warmup_aot
    # builds it there) and grows to the 2048 bucket when the long prompt
    # arrives mid-decode, dropping and re-capturing its tick's cell.
    if layout == "paged":
        buckets = (128, 256, 512, 1024)
        layout_kw = dict(num_blocks=8 * 1024 // 16 + 1)
    else:
        buckets = (128, 256, 512, 1024, 2048)
        layout_kw = dict(kv_layout="contiguous", max_len=1024)
    # from_arch warms up by default, as the reference's does: the client
    # runs warmup_aot before serving, which on the card captures the
    # prefill cells it walks and both decode-tick cells as CUDA graphs
    client = TurboClient.from_arch(
        arch, smoke=False, device=dev, seq_buckets=buckets,
        batch_buckets=(slots,), max_slots=slots, cap_new=64,
        init_seed=SEED, **layout_kw)
    engine = client.backend.engine
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = dict(client.warmup_stats)
    cells = client.backend.tick_cells
    warm_cells = cell_stats(engine)
    if len(cells) != 2 or warm["compile_count"] != \
            2 + engine.prefill_cells.captures:
        raise AssertionError(f"warmup_aot captured {warm} ({len(cells)} "
                             f"tick cells, {engine.prefill_cells.captures} "
                             "prefill cells); expected both tick cells and "
                             "the prefill cells it walked")
    captures0, warm_ticks0 = cells.captures, cells.warm_ticks
    warm_capture_s = cells.capture_seconds
    pool_after_warmup = cells.pool_bytes()
    vocab = engine.cfg.vocab_size
    specs = serve_specs(vocab, rng)
    if layout == "contiguous":
        # arrives mid-decode and needs the 2048 bucket: the slot cache
        # grows past its 1024 positions
        specs.append(([int(t) for t in rng.integers(1, vocab, 1200)],
                       GenerationParams(max_new_tokens=48, seed=1099)))
    first, later = specs[:8], specs[8:]

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    t_serve = time.perf_counter()
    handles = [client.submit(p, g) for p, g in first]
    client.pump(max_ticks=6)                  # prefills + a few decodes
    handles += [client.submit(p, g) for p, g in later]   # mid-decode
    results = [h.result() for h in handles]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = dict(cuda_lib.LAUNCHES)
    by_shape = {f"{n} {c}": v for (n, c), v in cuda_lib.LAUNCH_SHAPES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    ce = client.backend
    ticks, prefills = ce.decode_ticks, ce.prefill_dispatches
    packs = list(ce.pack_log) if layout == "paged" else []
    # cells captured while serving, and the eager ticks run to warm them
    captured = cells.captures - captures0
    warm_ticks = cells.warm_ticks - warm_ticks0
    served_cells = cell_stats(engine, warm_cells)
    if layout == "paged" and (captured or served_cells["captured_since"]):
        raise AssertionError(
            f"paged serving captured {captured} tick cells and prefill "
            f"cells {served_cells['captured_since']} after warmup_aot")
    # a grow re-makes the slot cache's tensors with a sequence axis (k/v,
    # the hybrid's shared KV), whose tick cells are then captured anew;
    # an SSM model's conv window and scan state stay as they are
    regrown = any(k in ce.state.cache for k in ("k", "shared_k"))
    if layout == "contiguous" and not (ce.max_len == 2048 and
                                       bool(captured) == regrown):
        raise AssertionError(f"contiguous serving: slot cache of "
                             f"{ce.max_len} positions, {captured} cells "
                             "captured while serving (expected a grow to "
                             "2048, and its re-capture where the cache "
                             "has a sequence axis)")

    # the paged layout admits through packed prefill (the default), the
    # contiguous one per group through the causal kernel
    cfg = engine.cfg
    n_attn = attention_layers(cfg)
    decode = "flash_decode_paged" if layout == "paged" else "flash_decode"
    attention = "flash_attention_packed" if layout == "paged" \
        else "flash_attention"
    for kname in ("norm", "sample") + ((attention, decode) if n_attn
                                       else ()):
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"kernel {kname} never launched on the "
                                 f"serving path: {launches}")
    if not n_attn and (launches.get(attention, 0) or
                       launches.get(decode, 0)):
        raise AssertionError(f"an attention-free model launched attention "
                             f"kernels: {launches}")
    group = f"g{max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)} " \
        f"dh{cfg.head_dim}"
    if n_attn and by_shape.get(f"{decode} {group}", 0) != launches[decode]:
        raise AssertionError(f"{decode}: {launches[decode]} launches, "
                             f"{by_shape.get(f'{decode} {group}', 0)} of "
                             f"them at {group}: {by_shape}")
    if (by_shape.get("norm layernorm", 0) == launches["norm"]) != \
            (cfg.norm == "layernorm"):
        raise AssertionError(f"norm: {by_shape.get('norm layernorm', 0)} "
                             f"of {launches['norm']} launches in LayerNorm "
                             f"mode for a {cfg.norm} model")
    if launches.get(attention, 0) != n_attn * prefills:
        raise AssertionError(
            f"{launches.get(attention, 0)} {attention} launches over "
            f"{prefills} prefills (expected {n_attn} per prefill)")
    other = "flash_attention" if layout == "paged" \
        else "flash_attention_packed"
    if launches.get(other, 0):
        raise AssertionError(f"{layout} serving launched {other}: "
                             f"{launches}")
    if layout == "paged" and not 0 < ce.pack_dispatches == prefills:
        raise AssertionError(f"paged serving: {ce.pack_dispatches} packed "
                             f"of {prefills} prefill dispatches")
    # one plan a pack, read by every layer's packed launch
    plans = launches.get("flash_attention_packed_plan", 0)
    if plans != (prefills if layout == "paged" else 0):
        raise AssertionError(f"{layout} serving: {plans} packed-plan "
                             f"launches over {prefills} prefill dispatches")
    # two norms a layer (one a mamba layer, two a shared-block
    # application) and the final one, in every decode tick (each replay
    # adds what its capture recorded), every eager tick that warmed a
    # capture, and every prefill
    norms_per_step = norms_per_pass(cfg)
    steps = ticks + warm_ticks + prefills
    if launches["norm"] != norms_per_step * steps:
        raise AssertionError(f"{launches['norm']} norm launches over {ticks} "
                             f"ticks, {warm_ticks} warm-up ticks and "
                             f"{prefills} prefills (expected "
                             f"{norms_per_step} each)")
    if layout == "contiguous":
        per_tick = n_attn
        if launches.get(decode, 0) != per_tick * (ticks + warm_ticks) or \
                launches.get("flash_decode_paged", 0):
            raise AssertionError(
                f"contiguous serving: {launches.get(decode, 0)} contiguous "
                f"decode "
                f"launches over {ticks} ticks and {warm_ticks} warm-up "
                f"ticks (expected {per_tick} per tick) and "
                f"{launches.get('flash_decode_paged', 0)} paged")
    elif ce.block_table.used_blocks != 0:
        raise AssertionError(f"{ce.block_table.used_blocks} KV blocks "
                             "leaked after drain")
    if engine.kv_slab.live_bytes != 0:
        raise AssertionError(f"{engine.kv_slab.live_bytes} slab bytes "
                             "leaked after drain")
    gen_tokens = 0
    for (prompt, params), res, h in zip(specs, results, handles):
        out = res[len(prompt):]
        gen_tokens += len(out)
        if res[:len(prompt)] != prompt or \
                len(out) != params.max_new_tokens:
            raise AssertionError(f"request {h.req_id}: bad result shape")
        if any(not 0 <= t < vocab for t in out):
            raise AssertionError(f"request {h.req_id}: token out of range")
    # packed prefill runs the products at other shapes than a prompt's own
    # prefill, so its logits may round otherwise: how far, on these prompts
    packed_dlogit, packed_ulps = packed_logit_drift(
        engine, [p for p, _ in specs]) if layout == "paged" else (0.0, 0.0)
    # greedy streams against generate() alone; sampled streams depend on
    # their own seed alone, so against the request served again alone
    greedy_checked, sampled_checked, divergences = 0, 0, []
    for (prompt, params), res in zip(specs, results):
        if params.temperature > 0:
            alone = client.submit(prompt, params).result()
        else:
            alone = engine.generate([prompt],
                                    max_new_tokens=params.max_new_tokens)[0]
        if alone != res:
            divergences.append(explain_divergence(
                engine, prompt, params, alone, res, packed_dlogit))
        if params.temperature > 0:
            sampled_checked += alone == res
        else:
            greedy_checked += alone == res
    ttft = sorted(h.ttft for h in handles)
    audit = replay_audit(client, specs) \
        if cfg.family in ("ssm", "hybrid") else None
    emit({"phase": phase or ("serve" if layout == "paged"
                             else "serve_contiguous"),
          "model": model_line(arch, cfg),
          "kv_layout": layout, "slots": slots,
          "card": card, "requests": len(handles),
          "sampled": sum(1 for _, p in specs if p.temperature > 0),
          "greedy_equal_to_generate_alone": greedy_checked,
          "sampled_equal_to_served_alone": sampled_checked,
          "divergences": divergences,
          "packed_vs_own_prefill_max_abs_dlogit": packed_dlogit,
          "packed_vs_own_prefill_bf16_ulps": {
              "max": packed_ulps, "limit": PACKED_LOGIT_ULPS},
          "pack_dispatches": len(packs),
          "packs": [{"segments": n, "flat": flat, "bucket": bucket,
                     "occupancy": flat / bucket}
                    for n, flat, bucket in packs],
          "generated_tokens": gen_tokens, "serve_s": serve_s,
          "tok_per_s": gen_tokens / serve_s,
          "ttft_p50_s": float(np.percentile(ttft, 50)),
          "ttft_p99_s": float(np.percentile(ttft, 99)),
          "peak_mem_gib": peak / 2 ** 30,
          "peak_mem_note": "the serve window's peak, the cells' pools and "
                           "static buffers included",
          "stack_build_s": build_s, "warmup_aot": warm,
          "prefill_cells": {
              "by_warmup_aot": warm_cells["cells_by_kind"],
              "capture_s_by_warmup_aot": warm_cells["capture_s"],
              "captured_while_serving": served_cells["captured_since"],
              "capture_s_while_serving": served_cells["capture_s_since"],
              "graph_pool_bytes": served_cells["graph_pool_bytes"],
              "static_buffer_bytes": served_cells["static_buffer_bytes"]},
          "tick_cells": {
              "capture_s_by_warmup_aot": warm_capture_s,
              "captured_while_serving": captured,
              "warm_up_ticks_while_serving": warm_ticks,
              "capture_s_all": cells.capture_seconds,
              "graph_pool_bytes_after_warmup": pool_after_warmup,
              "graph_pool_bytes": cells.pool_bytes(),
              "slot_cache_positions": ce.max_len},
          "decode_ticks": ticks, "prefill_dispatches": prefills,
          "norm_launches": {"decode": norms_per_step * ticks,
                            "prefill": norms_per_step * prefills},
          "kv_cache_gib": sum(t.numel() * t.element_size()
                              for k, t in ce.state.cache.items()
                              if k not in ("len", "pos_offset",
                                           "block_tables")) / 2 ** 30,
          "cache_leaves": {k: list(t.shape) for k, t in
                           ce.state.cache.items()},
          "replay_audit": audit,
          "launches": launches,
          "launches_by_shape": by_shape,
          "phase_s": time.perf_counter() - t0})
    beyond = [d for d in divergences if not d["within_rule"]]
    if beyond:
        raise AssertionError(f"{len(beyond)} served streams differ from the "
                             f"request alone beyond the margin rule: "
                             f"{beyond}")
    return client, launches


#: the replay audit's prompts: the serve mix's shortest, greedy
AUDIT_PROMPTS = 4
AUDIT_NEW_TOKENS = 16


def replay_audit(client, specs) -> dict:
    """Every decode tick's graph replay and every prefill cell call of a
    short re-serve held bit for bit to the eager bodies: each tick against
    ``decode_step_batch`` on a copy of the state (every cache leaf: the
    conv window, the scan state, the shared block's KV), each cell call
    against its body run eagerly on the same inputs.  The mix's
    ``AUDIT_PROMPTS`` shortest prompts, greedy, are served twice, so the
    second round's prefills are replays of cells the first captured or
    replayed; its streams must equal the first's."""
    from repro_torch.api import GenerationParams
    from repro_torch.runtime import graphs
    ce = client.backend
    engine = ce.engine
    counts = {"ticks_checked": 0, "cell_replays_checked": 0,
              "cell_first_calls_checked": 0}
    run_tick = ce.tick_cells.run
    run_cell = engine._run_cell

    def tick(state):
        want = engine.decode_step_batch(clone_state(state))
        captured = run_tick(state)
        bad = [k for k in state.cache
               if not torch.equal(state.cache[k], want.cache[k])]
        bad += [n for n in ("cur", "emitted", "counts", "done")
                if not torch.equal(getattr(state, n), getattr(want, n))]
        if bad:
            raise AssertionError(f"replay audit: tick "
                                 f"{counts['ticks_checked']}'s {bad} "
                                 "differ from the eager tick's")
        counts["ticks_checked"] += 1
        return captured

    def cell(table, key, body, inputs, outputs):
        before = None if table is None else table.captures
        outs = run_cell(table, key, body, inputs, outputs)
        if table is None:
            return outs
        eager = graphs.run_eager(body, inputs, outputs, engine.device)
        bad = [k for k in outs if not torch.equal(outs[k], eager[k])]
        if bad:
            raise AssertionError(f"replay audit: cell {key}'s {bad} "
                                 "differ from its eager body's")
        counts["cell_replays_checked" if table.captures == before
               else "cell_first_calls_checked"] += 1
        return outs

    prompts = sorted((p for p, _ in specs), key=len)[:AUDIT_PROMPTS]
    ce.tick_cells.run, engine._run_cell = tick, cell
    try:
        rounds = []
        for _ in range(2):
            handles = [client.submit(p, GenerationParams(
                max_new_tokens=AUDIT_NEW_TOKENS)) for p in prompts]
            rounds.append([h.result() for h in handles])
    finally:
        del ce.tick_cells.run, engine._run_cell
    if rounds[0] != rounds[1] or counts["cell_replays_checked"] < \
            len(prompts) or not counts["ticks_checked"]:
        raise AssertionError(f"replay audit: {counts}, the rounds' streams "
                             f"equal: {rounds[0] == rounds[1]}")
    return dict(counts, prompts=[len(p) for p in prompts],
                new_tokens=AUDIT_NEW_TOKENS)


# ---------------------------------------------------------------------------
# Phase 4b: the prefix cache and chunked prefill at full width
# ---------------------------------------------------------------------------

#: serve_prefix_chunked's chunk size: the tokens one chunk turn prefills
PREFIX_CHUNK_TOKENS = 256


def prefix_chunked_workload(vocab: int, rng) -> list:
    """(kind, prompt, params) of serve_prefix_chunked's 16 requests in
    arrival order: 10 share one 512-token system prompt (suffixes of 16
    to 400 tokens), 2 share a 520-token prefix that ends 8 tokens into a
    block (the second's hit copies that block), 4 are cold prompts of
    700 to 1000 tokens; every fourth request samples."""
    from repro_torch.api import GenerationParams

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    system, mid = toks(512), toks(520)
    kinds = [("system", 16), ("cold", 700), ("mid-block", 40),
             ("system", 400), ("system", 64), ("cold", 820),
             ("system", 250), ("mid-block", 150), ("system", 33),
             ("system", 180), ("cold", 1000), ("system", 300),
             ("system", 97), ("cold", 910), ("system", 128),
             ("system", 211)]
    out = []
    for i, (kind, n) in enumerate(kinds):
        prompt = system + toks(n) if kind == "system" else \
            mid + toks(n) if kind == "mid-block" else toks(n)
        sampled = i % 4 == 1
        params = GenerationParams(
            max_new_tokens=min(int(rng.integers(32, 65)), 1024 - len(prompt)),
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 1.0,
            seed=3000 + i)
        out.append((kind, prompt, params))
    return out


def suffix_logit_drift(engine, prompts, seams) -> tuple:
    """The largest |logit| difference between each prompt's last-token
    logits from a suffix pass after ``seams[i]`` tokens (over the prefix
    KV of its own prefill of those tokens, as a cache hit or a chunk
    seam gives it) and from its own prefill of the whole prompt, and the
    largest in bf16 ulps of the row's largest |logit|; fails where one
    passes ``PACKED_LOGIT_ULPS``."""
    from repro_torch.models import prefill, prefill_suffix
    cfg = engine.cfg
    worst, worst_ulps = 0.0, 0.0
    for p, c in zip(prompts, seams):
        t = torch.tensor([p], device=engine.device)
        _, pre = prefill(cfg, engine.params, t[:, :c])
        got, _ = prefill_suffix(cfg, engine.params, t[:, c:], pre["k"],
                                pre["v"], prefix_len=c)
        got, own = got[0].float(), own_prefill_logits(engine, p)
        d = float((got - own).abs().max())
        ulps = d / bf16_ulp(float(own.abs().max()))
        if not ulps <= PACKED_LOGIT_ULPS or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(
                f"suffix prefill: a {len(p)}-token prompt after {c} cached "
                f"tokens: logits {d:.3g} ({ulps:.2f} bf16 ulps of the row's "
                f"largest) from its own prefill's (limit "
                f"{PACKED_LOGIT_ULPS})")
        worst, worst_ulps = max(worst, d), max(worst_ulps, ulps)
    return worst, worst_ulps


def decode_shape_drift(engine, prompts) -> tuple:
    """The largest |logit| difference of one decode step of each of eight
    prompts decoded together (batch bucket 8, as the served slot cache
    decodes) and alone (batch bucket 1, as ``generate`` of one prompt
    does), from the same last token; and the largest in bf16 ulps."""
    from repro_torch.models import decode_step
    cfg = engine.cfg
    st = engine.own_pool(engine.prefill_batch(
        prompts, max_len=1024, max_new_tokens=1, prompt_kv_only=True), 1024)
    together, _ = decode_step(cfg, engine.params, st.cache, st.cur)
    worst, worst_ulps = 0.0, 0.0
    for i, p in enumerate(prompts):
        one = engine.own_pool(engine.prefill_batch(
            [p], max_len=1024, max_new_tokens=1, prompt_kv_only=True), 1024)
        alone, _ = decode_step(cfg, engine.params, one.cache,
                               st.cur[i:i + 1].clone())
        a, b = alone[0].float(), together[i].float()
        d = float((a - b).abs().max())
        worst = max(worst, d)
        worst_ulps = max(worst_ulps, d / bf16_ulp(float(a.abs().max())))
    return worst, worst_ulps


def serve_prefix_chunked(dev, card: str) -> dict:
    """Phase 4b: full-width InternLM2-1.8B with the prefix cache and
    chunked prefill (``PREFIX_CHUNK_TOKENS`` a chunk turn) at the JAX
    package's default batch buckets (1, 2, 4, 8), over the paged pool,
    once through the default packed admission (chunks and hits ride the
    packs as prefix keys) and once per group (``packed_prefill=False``:
    hits and chunks run the causal kernel in suffix alignment).  Checks:
    cache hits, copy-on-write copies and chunked prefills in both runs,
    a pack carrying a chunk, suffix-aligned causal launches, every
    kernel of each run, the pool after the drain (every block free or
    held by the cache alone), and every stream against the request alone
    under the margin rule, with the drift of a packed pass, a suffix
    pass and a decode step at batch 8 against batch 1 beside it.
    Returns the per-group run's launches."""
    from repro_torch.api import TurboClient
    from repro_torch.core import PipelineConfig
    from repro_torch.kernels import cuda_lib
    rng = np.random.default_rng(SEED + 5)
    out, alone_runs, drift = {}, {}, None
    for mode in ("packed", "per_group"):
        t0 = time.perf_counter()
        client = TurboClient.from_arch(
            "internlm2-1.8b", smoke=False, device=dev,
            seq_buckets=(128, 256, 512, 1024), batch_buckets=(1, 2, 4, 8),
            max_slots=8, cap_new=64, init_seed=SEED, prefix_cache=True,
            num_blocks=8 * 1024 // 16 + 1,
            packed_prefill=mode == "packed",
            config=PipelineConfig(chunked_prefill=True,
                                  prefill_chunk_tokens=PREFIX_CHUNK_TOKENS))
        ce, pipe = client.backend, client.pipeline
        engine = ce.engine
        cfg = engine.cfg
        tick_captures0 = ce.tick_cells.captures
        warm_cells = cell_stats(engine)
        if mode == "packed":
            specs = prefix_chunked_workload(cfg.vocab_size, rng)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.reset_launches()
        t_serve = time.perf_counter()
        handles = [client.submit(p, g) for _, p, g in specs[:4]]
        client.pump(max_ticks=6)                 # admissions, decodes
        handles += [client.submit(p, g) for _, p, g in specs[4:]]
        results = [h.result() for h in handles]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        launches = dict(cuda_lib.LAUNCHES)
        suffix_launches = cuda_lib.LAUNCH_SHAPES[("flash_attention",
                                                  "suffix")]
        peak = torch.cuda.max_memory_allocated(dev)
        stats, prefix = pipe.stats, ce.prefix_stats()
        ticks, prefills = ce.decode_ticks, ce.prefill_dispatches
        # ---- the path's counters --------------------------------------
        served_cells = cell_stats(engine, warm_cells)
        if len(ce.tick_cells) != 2 or \
                client.warmup_stats["compile_count"] != \
                2 + sum(warm_cells["cells_by_kind"].values()) or \
                ce.tick_cells.captures != tick_captures0:
            raise AssertionError(
                f"serve_prefix_chunked {mode}: warmup_aot "
                f"{client.warmup_stats}, "
                f"{ce.tick_cells.captures - tick_captures0} tick cells "
                "captured while serving")
        if not (prefix["hits"] > 0 and prefix["cow_blocks"] > 0 and
                stats.chunked_prefills > 0):
            raise AssertionError(f"serve_prefix_chunked {mode}: prefix "
                                 f"{prefix}, {stats.chunked_prefills} "
                                 "chunked prefills")
        attention = "flash_attention_packed" if mode == "packed" \
            else "flash_attention"
        other = "flash_attention" if mode == "packed" \
            else "flash_attention_packed"
        for kname in ("norm", attention, "flash_decode_paged", "sample"):
            if launches.get(kname, 0) <= 0:
                raise AssertionError(f"serve_prefix_chunked {mode}: kernel "
                                     f"{kname} never launched: {launches}")
        plans = launches.get("flash_attention_packed_plan", 0)
        if launches.get(other, 0) or \
                launches[attention] != cfg.num_layers * prefills or \
                plans != (prefills if mode == "packed" else 0):
            raise AssertionError(
                f"serve_prefix_chunked {mode}: {launches} over {prefills} "
                f"prefill passes (expected {cfg.num_layers} {attention} "
                f"launches each and one plan a pack, no {other})")
        norms_per_step = 2 * cfg.num_layers + 1
        if launches["norm"] != norms_per_step * (ticks + prefills) or \
                launches["flash_decode_paged"] != cfg.num_layers * ticks:
            raise AssertionError(
                f"serve_prefix_chunked {mode}: {launches} over {ticks} "
                f"ticks and {prefills} prefill passes")
        chunk_segments = ce.pack_segments - (stats.admitted -
                                             stats.chunked_prefills)
        packs = list(ce.pack_log)
        if mode == "packed" and (ce.pack_dispatches != prefills or
                                 chunk_segments <= 0):
            raise AssertionError(
                f"serve_prefix_chunked packed: {ce.pack_dispatches} packs "
                f"of {prefills} passes, {chunk_segments} chunk segments")
        if mode == "per_group" and suffix_launches <= 0:
            raise AssertionError("serve_prefix_chunked per_group: the "
                                 "causal kernel never ran with Sk > Sq")
        # ---- the pool after the drain ----------------------------------
        btm = ce.block_table
        if any(btm.has_request(h.req_id) for h in handles) or \
                btm.used_blocks != ce.prefix_cache.cached_blocks or \
                ce.prefix_cache.evictable_blocks() != btm.used_blocks or \
                ce._reserved or ce._chunk_slots or \
                engine.kv_slab.live_bytes:
            raise AssertionError(
                f"serve_prefix_chunked {mode}: after the drain the pool "
                f"holds {btm.used_blocks} blocks, the cache "
                f"{ce.prefix_cache.cached_blocks} "
                f"({ce.prefix_cache.evictable_blocks()} evictable)")
        for (_, prompt, params), res in zip(specs, results):
            if res[:len(prompt)] != prompt or \
                    len(res) - len(prompt) != params.max_new_tokens or \
                    any(not 0 <= t < cfg.vocab_size
                        for t in res[len(prompt):]):
                raise AssertionError(f"serve_prefix_chunked {mode}: bad "
                                     "result")
        # ---- streams against the request alone -------------------------
        prompts = [p for _, p, _ in specs]
        if drift is None:
            seams = [h.session.cached_tokens or PREFIX_CHUNK_TOKENS
                     for h in handles]
            drift = {"packed": packed_logit_drift(engine, prompts),
                     "suffix": suffix_logit_drift(engine, prompts, seams),
                     "decode_b8_vs_b1": decode_shape_drift(engine,
                                                           prompts[:8])}
        dlogit = max(d for d, _ in drift.values())
        greedy_eq, sampled_eq, divergences = 0, 0, []
        for i, ((kind, prompt, params), res) in enumerate(zip(specs,
                                                              results)):
            if i not in alone_runs:
                alone_runs[i] = client.submit(prompt, params).result() \
                    if params.temperature > 0 else engine.generate(
                        [prompt], max_new_tokens=params.max_new_tokens)[0]
            alone = alone_runs[i]
            if alone != res:
                divergences.append(dict(explain_divergence(
                    engine, prompt, params, alone, res, dlogit),
                    kind=kind, request=i))
            if params.temperature > 0:
                sampled_eq += alone == res
            else:
                greedy_eq += alone == res
        ttft = sorted(h.ttft for h in handles)
        gen_tokens = sum(len(r) - len(p) for r, p in zip(results, prompts))
        m = pipe.obs.metrics
        line = {"phase": "serve_prefix_chunked", "mode": mode, "card": card,
                "model": "internlm2-1.8b (full width, 24 layers, bf16 "
                         "weights from a seed, f32 KV)",
                "batch_buckets": [1, 2, 4, 8],
                "chunk_tokens": PREFIX_CHUNK_TOKENS,
                "requests": len(handles),
                "warmup_aot": client.warmup_stats,
                "kinds": {k: sum(1 for s in specs if s[0] == k)
                          for k in ("system", "mid-block", "cold")},
                "sampled": sum(1 for s in specs if s[2].temperature > 0),
                "greedy_equal_to_generate_alone": greedy_eq,
                "sampled_equal_to_served_alone": sampled_eq,
                "divergences": divergences,
                "drift_max_abs_dlogit_and_bf16_ulps": drift,
                "drift_limit_ulps": PACKED_LOGIT_ULPS,
                "prefix_stats": prefix,
                "cached_tokens": [h.session.cached_tokens for h in handles],
                "chunked_prefills": stats.chunked_prefills,
                "chunk_ticks": stats.chunk_ticks,
                "pack_wait_vetoes": m.counter("pipeline.veto.pack_wait").value,
                "capacity_vetoes": m.counter("pipeline.veto.capacity").value,
                "pack_dispatches": ce.pack_dispatches,
                "pack_chunk_segments": chunk_segments if mode == "packed"
                else None,
                "packs": [{"segments": n, "flat": flat, "bucket": bucket}
                          for n, flat, bucket in packs],
                "suffix_aligned_flash_launches": suffix_launches,
                "prefill_passes": prefills, "decode_ticks": ticks,
                "generated_tokens": gen_tokens, "serve_s": serve_s,
                "tok_per_s": gen_tokens / serve_s,
                "ttft_p50_s": float(np.percentile(ttft, 50)),
                "ttft_p99_s": float(np.percentile(ttft, 99)),
                "peak_mem_gib": peak / 2 ** 30,
                "peak_mem_note": "the serve window's peak, the gathered "
                                 "prefix KV (f32, every layer), the cells' "
                                 "pools and static buffers included",
                "prefill_cells": {
                    "by_warmup_aot": warm_cells["cells_by_kind"],
                    "capture_s_by_warmup_aot": warm_cells["capture_s"],
                    "captured_while_serving": served_cells[
                        "captured_since"],
                    "captured_while_serving_by_kind": {
                        kind: sum(1 for k in served_cells["captured_since"]
                                  if cell_kind(k) == kind)
                        for kind in ("suffix", "packed", "per_group")},
                    "capture_s_while_serving": served_cells[
                        "capture_s_since"],
                    "graph_pool_bytes": served_cells["graph_pool_bytes"],
                    "static_buffer_bytes": served_cells[
                        "static_buffer_bytes"]},
                "stack_build_s": build_s, "launches": launches,
                "cache_after_drain": {
                    "pool_blocks_held": btm.used_blocks,
                    "cached_blocks": ce.prefix_cache.cached_blocks,
                    "evictable": ce.prefix_cache.evictable_blocks()}}
        emit(line)
        beyond = [d for d in divergences if not d["within_rule"]]
        if beyond:
            raise AssertionError(
                f"serve_prefix_chunked {mode}: {len(beyond)} streams differ "
                f"from the request alone beyond the margin rule: {beyond}")
        out[mode] = launches
        del client, ce, pipe, engine, handles
        release_memory()
    return out["per_group"]


# ---------------------------------------------------------------------------
# Phase 6: the paper's one-shot classification service at full width
# ---------------------------------------------------------------------------

#: how far a request's last-token logits may move between its served batch
#: and a batch of its own, in bf16 ulps at the row's largest |logit|: the
#: activations are bf16 through 24 layers, and the two runs pad to other
#: shapes, so cuBLAS picks other kernels and rounds otherwise (five replays
#: on an H100 moved them by 2.5 to 2.75 such ulps)
CLASSIFY_LOGIT_ULPS = 4
#: requests whose class is held against their class alone: those whose
#: top-2 margin alone exceeds twice the tolerance (random weights give
#: many near ties, so the check walks the dp batches until it has these)
CLASSIFY_CLASSES_HELD = 16


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8-bit mantissa)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def replay(system, requests) -> float:
    """Submit each request at its Poisson arrival time (on the serving
    system's monotonic clock) and step the system whenever work is
    queued; returns the wall seconds from the first arrival slot to the
    last response."""
    from repro_torch.core import Request
    t0 = time.monotonic()
    i = 0
    while i < len(requests) or not system.pipeline.idle():
        while i < len(requests) and \
                t0 + requests[i].arrival_time <= time.monotonic():
            r = requests[i]
            system.submit(Request(r.req_id, r.seq_len, t0 + r.arrival_time,
                                  r.payload))
            i += 1
        if system.pipeline.idle():
            time.sleep(max(t0 + requests[i].arrival_time - time.monotonic(),
                           0.0))
            continue
        system.step()
    return time.monotonic() - t0


def classify_phase(dev, card: str, n_requests: int = 64):
    """launch/serve.py's first phase at full width: warm the cost table,
    then serve the same Poisson request list under each policy, and hold
    served batches against each request classified alone.  Returns the
    dp run's softmax launches, the bucketed cost model the warm-up
    measured, the requests, their rate and each policy's resp/s and p99
    latency (the simulator's comparison in serve_pool)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BucketedCostModel, ServingConfig,
                                  ServingSystem)
    from repro_torch.data import LengthDistribution, RequestGenerator
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    cfg = get_config("internlm2-1.8b")
    ladder = BucketLadder(seq_buckets=(32, 64, 128, 256, 512),
                          batch_buckets=(1, 2, 4, 8, 16, 32))
    engine = InferenceEngine(cfg, init_params(cfg, seed=SEED, device=dev),
                             ladder=ladder, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    table = engine.warmup(lengths=(32, 128, 512), batches=(1, 4, 16))
    warm_s = time.perf_counter() - t0
    warm_cells = cell_stats(engine)
    # every other cell a batch of at most 20 can reach, captured before
    # the policies run, so each policy serves from graphs alone
    t0 = time.perf_counter()
    for seq_b in ladder.seq_buckets:
        for batch_b in [b for b in ladder.batch_buckets if b < 20] + [20]:
            engine.classify([[1] * seq_b] * batch_b)
    fill_s = time.perf_counter() - t0
    ready_cells = cell_stats(engine, warm_cells)
    cost = BucketedCostModel(table, buckets=ladder.seq_buckets)
    rate = 200.0
    requests = RequestGenerator(
        rate=rate, lengths=LengthDistribution("uniform", 5, 500),
        vocab_size=cfg.vocab_size, seed=0).generate(
            2 * n_requests / rate)[:n_requests]
    if len(requests) != n_requests:
        raise AssertionError(f"the generator gave {len(requests)} requests")
    emit({"phase": "classify_cost_table", "card": card, "warmup_s": warm_s,
          "seconds_by_len_and_batch": [[ln, b, t] for (ln, b), t
                                       in sorted(table.table.items())],
          "cells_by_warmup": len(warm_cells["keys"]),
          "cells_captured_after_it": len(ready_cells["captured_since"]),
          "their_s": fill_s,
          "graph_pool_bytes": ready_cells["graph_pool_bytes"],
          "static_buffer_bytes": ready_cells["static_buffer_bytes"]})
    served, logs, softmax_launches, measured = {}, {}, {}, {}
    for policy in ("dp", "naive", "nobatch"):
        system = ServingSystem(execute=engine.execute_requests,
                               cost_model=cost,
                               config=ServingConfig(policy=policy,
                                                    max_batch_size=20))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.reset_launches()
        before = cell_stats(engine)
        wall = replay(system, requests)
        launches = dict(cuda_lib.LAUNCHES)
        batches = list(system.pipeline.batch_log)
        captured = cell_stats(engine, before)["captured_since"]
        if launches.get("softmax", 0) != cfg.num_layers * len(batches) or \
                launches.get("flash_attention", 0):
            raise AssertionError(
                f"classify ({policy}): {launches} over {len(batches)} "
                f"batches; expected {cfg.num_layers} softmax launches per "
                "batch and no flash attention")
        resp = system.responses
        if len(resp) != n_requests or any(r.result is None for r in resp):
            raise AssertionError(f"classify ({policy}): {len(resp)} "
                                 "responses, or one without a result")
        if any(not 0 <= r.result < cfg.vocab_size for r in resp):
            raise AssertionError(f"classify ({policy}): class out of range")
        lats = sorted(r.latency for r in resp)
        served[policy] = {r.req_id: r.result for r in resp}
        logs[policy] = batches
        softmax_launches[policy] = launches["softmax"]
        measured[policy] = {"resp_per_s": n_requests / wall,
                            "latency_p99_s": float(np.percentile(lats, 99))}
        emit({"phase": "classify", "policy": policy, "card": card,
              "requests": n_requests, "offered_rate_per_s": rate,
              "lengths": "uniform 5-500", "wall_s": wall,
              "resp_per_s": n_requests / wall,
              "latency_p50_s": float(np.percentile(lats, 50)),
              "latency_p99_s": float(np.percentile(lats, 99)),
              "batches": len(batches),
              "batch_sizes": [len(b) for b in batches],
              "padded_lens": sorted({r.padded_len for r in resp}),
              "cells_captured_while_serving": captured,
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
              "launches": launches})
    agree = {p: sum(served[p][i] == served["dp"][i] for i in served["dp"])
             for p in ("naive", "nobatch")}

    # the dp run's batches again, each as it was served (same members,
    # same buckets), against every member classified alone
    by_id = {r.req_id: r for r in requests}
    order = sorted(logs["dp"], key=len, reverse=True)
    checked, held, near_ties, worst, worst_ulps = 0, 0, 0, 0.0, 0.0
    for batch in order:
        logits = engine.classify_logits(
            [by_id[i].payload for i in batch]).float()
        preds = logits.argmax(dim=-1).tolist()
        if preds != [served["dp"][i] for i in batch]:
            raise AssertionError("classify: the served batch, run again, "
                                 "gives other predictions")
        for row, rid in zip(logits, batch):
            alone = engine.classify_logits([by_id[rid].payload])[0].float()
            diff = float((row - alone).abs().max())
            tol = CLASSIFY_LOGIT_ULPS * bf16_ulp(float(alone.abs().max()))
            worst = max(worst, diff)
            worst_ulps = max(worst_ulps, diff / (tol / CLASSIFY_LOGIT_ULPS))
            if diff > tol:
                raise AssertionError(
                    f"classify: request {rid}'s logits move by {diff:.4g} "
                    f"between its batch of {len(batch)} and a batch of its "
                    f"own (tolerance {tol:.4g})")
            # each logit may move by tol: the class is held where the top
            # two are further apart than two moves
            top2 = alone.topk(2).values
            if float(top2[0] - top2[1]) > 2 * tol:
                if int(row.argmax()) != int(alone.argmax()):
                    raise AssertionError(f"classify: request {rid}'s class "
                                         "differs from its class alone")
                held += 1
            else:
                near_ties += 1
            checked += 1
        # on through the dp batches until 16 classes have been held
        if held >= CLASSIFY_CLASSES_HELD:
            break
    if held < CLASSIFY_CLASSES_HELD:
        raise AssertionError(
            f"classify: only {held} of {checked} requests have a top-2 "
            f"margin clear of the tolerance; {CLASSIFY_CLASSES_HELD} are "
            "needed to hold the class")
    emit({"phase": "classify_batched_vs_alone", "card": card,
          "requests_checked": checked, "classes_held": held,
          "dp_batches_checked": order.index(batch) + 1,
          "largest_batch_checked": len(order[0]),
          "max_abs_logit_diff": worst,
          "max_diff_in_bf16_ulps_of_the_row_max": worst_ulps,
          "tolerance": {"bf16_ulps_of_the_row_max": CLASSIFY_LOGIT_ULPS,
                        "why": "bf16 activations; the batch and the request "
                        "alone pad to other shapes and round otherwise"},
          "near_ties_not_held_to_equal_class": near_ties,
          "near_tie": "top-2 margin of the row alone within twice the "
                      "tolerance",
          "predictions_equal_to_dp": agree})
    return {"softmax_launches": softmax_launches["dp"], "cost": cost,
            "requests": requests, "rate": rate, "measured": measured}


# ---------------------------------------------------------------------------
# Phase 6b: the paper's allocator (C2) over the classify forward
# ---------------------------------------------------------------------------

#: the reference benchmark's stream (benchmarks/bench_allocator.py:28-29):
#: 24 requests, lengths uniform in 5..500 from random.Random(0)
ALLOC_REQUESTS = 24
ALLOC_LENGTHS = (5, 500)
#: that benchmark's smallest record (its records_for_fn's min_size)
ALLOC_MIN_SIZE = 4096
#: timed forwards a length, after the one whose peak is read
ALLOC_TIMED = 3
#: the card's caching allocator rounds every block up to 512 bytes
CUDA_BLOCK_ROUND = 512


def allocator_lengths() -> list:
    import random
    rng = random.Random(0)
    return [rng.randint(*ALLOC_LENGTHS) for _ in range(ALLOC_REQUESTS)]


class AllocatorStream:
    """The paper's allocator and its two baselines over one stream of
    usage records, one inference at a time (Figs. 11-13): Algorithm 1 on
    every record and, apart, on the records ``dedup_repeated_structure``
    keeps (the paper's repeated-structure trick), the simulated caching
    allocator and per-inference GSOC.  ``validate_plan`` runs on every
    plan and raises on a violation."""

    def __init__(self, num_layers: int):
        from repro_torch.core import (CachingAllocator, GSOCAllocator,
                                      SequenceAwareAllocator)
        self.num_layers = num_layers
        self.turbo = SequenceAwareAllocator()
        self.turbo_dedup = SequenceAwareAllocator()
        self.caching = CachingAllocator()
        self.gsoc = GSOCAllocator()

    def step(self, records) -> dict:
        from repro_torch.core import (dedup_repeated_structure,
                                      peak_live_bytes, validate_plan)
        deduped = dedup_repeated_structure(records, self.num_layers)
        t0 = time.perf_counter()
        plan = self.turbo.plan(records)
        plan_ms = (time.perf_counter() - t0) * 1e3
        validate_plan(records, plan)
        t0 = time.perf_counter()
        plan_d = self.turbo_dedup.plan(deduped)
        plan_dedup_ms = (time.perf_counter() - t0) * 1e3
        validate_plan(deduped, plan_d)
        self.caching.run_inference(records)
        self.gsoc.run_inference(records)
        return {"records": len(records), "records_dedup": len(deduped),
                "records_peak_bytes": peak_live_bytes(records),
                "turbo_bytes": self.turbo.footprint,
                "turbo_chunks": len(plan.chunks),
                "caching_bytes": self.caching.footprint,
                "gsoc_bytes": self.gsoc.footprint,
                "plan_ms": plan_ms, "plan_dedup_ms": plan_dedup_ms}

    def traffic(self) -> dict:
        return {name: {"allocated_bytes": a.allocated_bytes,
                       "freed_bytes": a.freed_bytes,
                       "alloc_events": a.alloc_events,
                       "free_events": a.free_events}
                for name, a in (("turbo", self.turbo),
                                ("caching", self.caching),
                                ("gsoc", self.gsoc))}


def cuda_traffic(dev) -> dict:
    """The card's caching allocator's own device traffic so far
    (cudaMalloc / cudaFree bytes and segments)."""
    s = torch.cuda.memory_stats(dev)
    return {"allocated_bytes": s.get("reserved_bytes.all.allocated", 0),
            "freed_bytes": s.get("reserved_bytes.all.freed", 0),
            "alloc_events": s.get("segment.all.allocated", 0),
            "free_events": s.get("segment.all.freed", 0)}


def allocator_phase(dev, card: str) -> dict:
    """Trace the classify cell's forward (``forward_hidden(attn="naive")``
    then ``logits_at``, as ``InferenceEngine._classify_body``) at full
    width at each of the reference benchmark's 24 lengths, batch 1, into
    usage records; plan them with Algorithm 1 and its baselines; run the
    same forward eagerly and read the card's own activation peak, its
    caching allocator's reserve and the forward's time.  Fails where a
    plan is invalid, a forward's output is not finite, the records'
    peak is above the card's measured one (a storage counted twice), or
    the path launched other than one norm a norm call and one softmax a
    layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import records_for_fn
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.models.transformer import forward_hidden, logits_at
    cfg = get_config("internlm2-1.8b")
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def forward(tokens, last):
        h, _ = forward_hidden(cfg, params, tokens, attn="naive")
        return logits_at(cfg, params, h, last)

    def inputs(n: int):
        tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                               device=dev, dtype=torch.int32)
        return tokens, torch.tensor([n - 1], dtype=torch.int32, device=dev)

    lengths = allocator_lengths()
    # one warm call: cuBLAS's workspace and the kernels' first loads stay
    # outside every peak read below
    forward(*inputs(lengths[0]))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    traffic0 = cuda_traffic(dev)
    stream = AllocatorStream(cfg.num_layers)
    rows, forwards = [], 0
    cuda_lib.reset_launches()
    for n in lengths:
        tokens, last = inputs(n)
        t0 = time.perf_counter()
        records = records_for_fn(forward, tokens, last,
                                 min_size=ALLOC_MIN_SIZE)
        trace_ms = (time.perf_counter() - t0) * 1e3
        row = {"len": n, "trace_ms": trace_ms}
        row.update(stream.step(records))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        out = forward(tokens, last)
        torch.cuda.synchronize()
        row["eager_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - start
        if tuple(out.shape) != (1, cfg.vocab_size) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"allocator: the forward at length {n} "
                                 f"gave {tuple(out.shape)}, or a value "
                                 "that is not finite")
        del out
        times = []
        for _ in range(ALLOC_TIMED):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            forward(tokens, last)
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end))
        forwards += 1 + ALLOC_TIMED
        row["forward_ms"] = float(np.median(times))
        row["cuda_reserved_bytes"] = \
            torch.cuda.memory_reserved(dev) - reserved0
        row["records_over_eager_peak"] = \
            row["records_peak_bytes"] / row["eager_peak_bytes"]
        row["plan_share_of_forward"] = row["plan_ms"] / row["forward_ms"]
        row["plan_dedup_share_of_forward"] = \
            row["plan_dedup_ms"] / row["forward_ms"]
        slack = CUDA_BLOCK_ROUND * row["records"]
        if row["records_peak_bytes"] > row["eager_peak_bytes"] + slack:
            raise AssertionError(
                f"allocator: at length {n} the records' peak, "
                f"{row['records_peak_bytes']} bytes, is above the card's "
                f"measured activation peak {row['eager_peak_bytes']} plus "
                f"{slack} of rounding: a storage counted twice")
        rows.append(row)
        emit(dict({"phase": "allocator_len", "card": card}, **row))
    launches = dict(cuda_lib.LAUNCHES)
    want = {"norm": (2 * cfg.num_layers + 1) * forwards,
            "softmax": cfg.num_layers * forwards}
    if launches != want:
        raise AssertionError(f"allocator: launches {launches} over "
                             f"{forwards} forwards; expected {want} (none "
                             "while tracing)")
    traffic = stream.traffic()
    now = cuda_traffic(dev)
    traffic["cuda_caching"] = {k: now[k] - traffic0[k] for k in now}
    last_row = rows[-1]

    def mean(key):
        return float(np.mean([r[key] for r in rows]))

    summary = {
        "phase": "allocator", "card": card,
        "model": "internlm2-1.8b full width, bf16, classify forward "
                 "(attn naive), batch 1",
        "lengths": lengths, "min_size": ALLOC_MIN_SIZE,
        "fig11_peak_bytes": {
            k: max(r[k] for r in rows) for k in (
                "records_peak_bytes", "eager_peak_bytes", "turbo_bytes",
                "caching_bytes", "gsoc_bytes", "cuda_reserved_bytes")},
        "fig11_final_bytes": {
            k: last_row[k] for k in ("turbo_bytes", "caching_bytes",
                                     "gsoc_bytes", "cuda_reserved_bytes")},
        "fig12_traffic": traffic,
        "fig13_plan_share_of_forward_mean": {
            "full": mean("plan_share_of_forward"),
            "dedup": mean("plan_dedup_share_of_forward")},
        "plan_ms_mean": {"full": mean("plan_ms"),
                         "dedup": mean("plan_dedup_ms")},
        "trace_ms_mean": mean("trace_ms"),
        "forward_ms_mean": mean("forward_ms"),
        "records_over_eager_peak": {
            "min": min(r["records_over_eager_peak"] for r in rows),
            "max": max(r["records_over_eager_peak"] for r in rows)},
        "paper_orderings": {
            "turbo_final_footprint_at_most_caching":
                last_row["turbo_bytes"] <= last_row["caching_bytes"],
            "turbo_traffic_at_most_gsoc":
                traffic["turbo"]["allocated_bytes"] <=
                traffic["gsoc"]["allocated_bytes"] and
                traffic["turbo"]["freed_bytes"] <=
                traffic["gsoc"]["freed_bytes"]},
        "launches": launches, "forwards": forwards}
    emit(summary)
    return summary


# ---------------------------------------------------------------------------
# Phase 5: where a full-width decode tick spends its time
# ---------------------------------------------------------------------------


def kernel_family(name: str) -> str:
    if "repro" in name:
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "gemv",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    return "other PyTorch kernels"


#: the MoE phase's family of the PyTorch kernels that index, sort and
#: scan, by name: the router's sorts, the rank's scan, the dispatch's
#: gathers and the combine's (and, named alike, the KV write and the
#: embedding lookup)
MOE_DISPATCH_FAMILY = ("index, sort and scan (the MoE dispatch and "
                       "combine; also the KV write and embedding lookup)")


#: the SSM profile's family of the PyTorch elementwise kernels and
#: reductions, the SSM step's among them (softplus, exp, the state's
#: update, the conv window's shift and the in-place writes)
SSM_STEP_FAMILY = "elementwise and reductions (PyTorch; the SSM step's)"


def ssm_kernel_family(name: str) -> str:
    """``kernel_family``, with PyTorch's elementwise kernels and
    reductions (on an SSM tick, mostly the mamba step's) named as
    ``SSM_STEP_FAMILY``."""
    family = kernel_family(name)
    return SSM_STEP_FAMILY if family == "other PyTorch kernels" else family


def moe_kernel_family(name: str) -> str:
    """``kernel_family``, with the MoE's dispatch and combine kernels
    (``MOE_DISPATCH_FAMILY``) apart from the elementwise ones."""
    family = kernel_family(name)
    if family != "other PyTorch kernels":
        return family
    if any(k in name.lower() for k in ("sort", "scan", "index", "gather",
                                       "scatter", "cummax")):
        return MOE_DISPATCH_FAMILY
    return "elementwise and reductions (PyTorch)"


def split_profile(prof, family=kernel_family):
    """Device busy microseconds by kernel ``family``, the device kernels
    and the host ops (each as (us, count, name)) of a profiler run:
    device work from the trace's own events (not the device-side spans of
    ``record_function`` ranges, which cover kernels counted already),
    host ops from the averaged view's self times."""
    busy_us, by_name, host = {}, {}, []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                not evt.is_user_annotation:
            us = evt.time_range.elapsed_us()
            fam = family(evt.name)
            busy_us[fam] = busy_us.get(fam, 0.0) + us
            total, count = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (total + us, count + 1)
    for evt in prof.key_averages():
        if not is_kernel(evt) and evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total, evt.count, evt.key))
    kernels = [(us, count, name) for name, (us, count) in by_name.items()]
    return busy_us, kernels, host


#: each launch counter's kernel, by the parts of its name in a trace
PORT_KERNELS = {"norm": ("norm_kernel",),
                "flash_attention": ("flash_attention_bf16_kernel",),
                "flash_attention_packed": ("flash_attention_packed_kernel",),
                "flash_attention_packed_plan": ("flash_packed_plan_kernel",),
                "flash_decode_paged": ("decode_kernel", "PagedRows"),
                "flash_decode": ("decode_kernel", "StridedRows"),
                "sample": ("sample_kernel",), "softmax": ("softmax",)}


def cross_check(prof, kernels, launches: dict) -> dict:
    """The profiler's count of each of the port's kernels (in the trace's
    events, and in its averaged view) against the wrappers' launch
    counters over the same window: each counted launch is one kernel, so
    a shortfall in the trace means it lost events and its busy totals
    read low."""
    ranges = {evt.name for evt in prof.events() if evt.is_user_annotation}
    averaged = [(evt.count, evt.key) for evt in prof.key_averages()
                if is_kernel(evt) and evt.key not in ranges]
    by_kernel = {}
    for name, parts in PORT_KERNELS.items():
        # the port's kernels live in namespace repro (PyTorch's own
        # softmax_warp_forward, the MoE router's, is not the port's)
        parts = ("repro",) + parts
        seen = sum(count for _, count, key in kernels
                   if all(p in key for p in parts))
        if seen or launches.get(name, 0):
            by_kernel[name] = {
                "trace": seen, "counted": launches.get(name, 0),
                "averaged_view": sum(count for count, key in averaged
                                     if all(p in key for p in parts))}
    seen = sum(v["trace"] for v in by_kernel.values())
    counted = sum(launches.values())
    return {"profiler_port_kernels": seen, "launch_counters": counted,
            "by_kernel": by_kernel,
            "trace_complete": all(v["trace"] >= v["counted"]
                                  for v in by_kernel.values())}


def busy_or_not_measured(value, check: dict):
    """A busy total, or why it is not given."""
    if not check["trace_complete"]:
        return (f"not measured: the trace holds "
                f"{check['profiler_port_kernels']} of "
                f"{check['launch_counters']} counted port launches")
    return value if value else "not measured: the profiler saw no device time"


def in_trace(busy_us: dict, per: int, check: dict, wall_ms: float,
             flash_us: float = 0.0) -> dict:
    """Where the trace lost a port launch: the busy time, by kernel family
    and in all, of the kernels it does hold (per tick where ``per`` is the
    window's ticks), the idle share they leave (an upper bound: the lost
    kernels' time is not in it) and, given ``flash_us``, the flash
    kernel's share of their busy time, labelled as such; nothing where
    the trace is complete."""
    if check["trace_complete"]:
        return {}
    busy = sum(busy_us.values())
    out = {"all": busy / 1e3 / per,
           **{k: v / 1e3 / per for k, v in sorted(busy_us.items())},
           "idle_share_at_most": 1 - busy / 1e3 / wall_ms,
           "holds": f"{check['profiler_port_kernels']} of "
                    f"{check['launch_counters']} counted port launches"}
    if flash_us:
        out["flash_share"] = flash_us / busy
    return {"busy_ms_of_the_kernels_in_the_trace": out}


def gumbel_noise_cost(rows: int, cands: int, calls: int) -> dict:
    """What ``gumbel_noise`` alone launches for ``rows`` rows of ``cands``
    values: device kernels, device time and host self-time per call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.sampling import gumbel_noise
    seed = torch.arange(rows, dtype=torch.int32, device="cuda") + 1000
    step = torch.zeros_like(seed)
    gumbel_noise(seed, step, cands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            gumbel_noise(seed, step + i, cands)
        torch.cuda.synchronize()
    _, kernels, host = split_profile(prof)
    return {"kernels_per_call": sum(c for _, c, _ in kernels) / calls,
            "device_ms_per_call": sum(u for u, _, _ in kernels) / 1e3
            / calls,
            "host_self_ms_per_call": sum(u for u, _, _ in host) / 1e3 / calls}


def traced_window(run, family=kernel_family):
    """``run()`` under torch.profiler with the launch counters set to 0
    just before it.  Returns the profiler, the window's wall milliseconds,
    its launches, the split profile (by kernel ``family``), the
    cross-check and ``run``'s result."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda_lib
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_lib.LAUNCHES)
    split = split_profile(prof, family)
    check = cross_check(prof, split[1], launches)
    return prof, wall_ms, launches, split, check, result


#: the host's kernel and graph launch calls, by their names in a trace
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")


def host_launch_calls(prof) -> dict:
    """The window's kernel and graph launch API calls, by name."""
    calls = {}
    for evt in prof.key_averages():
        if evt.key in LAUNCH_APIS:
            calls[evt.key] = calls.get(evt.key, 0) + evt.count
    return calls


def decode_window(run, ticks: int, family=kernel_family) -> dict:
    """``run`` (``ticks`` decode ticks) once on the host clock alone and
    once under the profiler: wall time per tick both ways, host time per
    tick, the host's launch calls per tick, the device kernels per tick,
    the device's busy time (by kernel family) and idle share, the trace
    held against the launch counters."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    prof, wall_ms, launches, (busy_us, kernels, host), check, _ = \
        traced_window(run, family)
    busy_ms = sum(busy_us.values()) / 1e3
    complete = check["trace_complete"] and busy_ms > 0
    calls = host_launch_calls(prof)

    def top(rows, n):
        return [{"name": name[:80], "ms_per_tick": us / 1e3 / ticks,
                 "calls_per_tick": count / ticks}
                for us, count, name in sorted(rows, reverse=True)[:n]]
    return {"ticks": ticks, "tick_ms_unprofiled": plain_ms / ticks,
            "tick_ms": wall_ms / ticks,
            "host_launch_calls_per_tick": sum(calls.values()) / ticks,
            "host_launch_calls": calls,
            "launch_cross_check": check, "launches": launches,
            "device_busy_ms_per_tick": busy_or_not_measured(
                busy_ms / ticks, check),
            "device_idle_share": (1 - busy_ms / wall_ms) if complete
            else busy_or_not_measured(None, check),
            "kernel_launches_per_tick": sum(c for _, c, _ in kernels) / ticks,
            "host_ops_self_ms_per_tick": sum(u for u, _, _ in host) / 1e3
            / ticks,
            "busy_ms_per_tick_by_family": {
                k: v / 1e3 / ticks for k, v in sorted(busy_us.items())}
            if complete else busy_or_not_measured(None, check),
            **in_trace(busy_us, ticks, check, wall_ms),
            "top_device_kernels": top(kernels, 6),
            "top_host_ops_self_time": top(host, 10),
            "_sample_us": sum(us for us, _, name in kernels
                              if "sample_kernel" in name)}


def eager_ticks(engine, state, ticks: int):
    """The eager tick before graphs: ``ticks`` calls of
    ``decode_step_batch`` on ``state``, each followed by the host reads
    the engine makes after a tick of streamed rows (the stop flags, the
    counts and the tokens)."""
    for _ in range(ticks):
        state = engine.decode_step_batch(state)
        state.done.cpu()
        state.counts.cpu()
        state.emitted.cpu()
    return state


#: a graphed decode window's most host launch calls per tick
GRAPHED_LAUNCH_CALLS_PER_TICK = 10


def profile_decode(client, card: str, ticks: int = 10,
                   sampled: bool = False, phase: str = "profile_decode",
                   family=kernel_family, rows: int = 8) -> None:
    """``rows`` rows (eight by default) decoding at full width, greedy or
    (``sampled``) with
    temperature, top-k and top-p, in two windows of the same host: the
    engine's graphed tick (one replay of the captured cell a tick, through
    the client) and then the eager ``InferenceEngine.decode_step_batch``
    on a copy of the same eight rows.  Each window gives the host time per
    tick and its launch calls, and from torch.profiler the device kernels
    per tick, the device's busy time by kernel family and its idle share,
    cross-checked against the launch counters; a sampled window also
    gives the sample kernel's device time and what the Gumbel noise
    launches per tick."""
    from repro_torch.api import GenerationParams
    rng = np.random.default_rng(SEED + (3 if sampled else 1))
    vocab = client.backend.engine.cfg.vocab_size
    ce = client.backend
    engine = ce.engine
    if any(s is not None for s in ce.sessions):
        raise AssertionError("profile_decode: a slot is still live")
    # the engine's sampling flag is sticky for the life of its state (as
    # the reference's); with every slot free, clear it, so greedy rows run
    # the greedy tick and not the sampling one the serve phase left on
    ce.state.sampling = False
    params = [GenerationParams(max_new_tokens=64, temperature=0.8, top_k=50,
                               top_p=0.95, seed=2000 + i) if sampled
              else GenerationParams(max_new_tokens=64) for i in range(rows)]
    handles = [client.submit([int(t) for t in rng.integers(1, vocab, n)], p)
               for n, p in zip((100, 200, 300, 400, 500, 600, 700, 800),
                               params)]
    while client.pipeline.queue:                 # admit all eight
        client.pump(max_ticks=1)
    client.pump(max_ticks=2)                     # settle into decode
    name = phase + ("_sampled" if sampled else "")
    compiles = engine.compile_count
    graphed = decode_window(lambda: client.pump(max_ticks=ticks), ticks,
                            family)
    if engine.compile_count != compiles:
        raise AssertionError("profile_decode: the graphed window captured "
                             "a cell")
    if any(h.session.is_finished for h in handles):
        raise AssertionError(f"{name}: a row finished inside the window")
    copy = clone_state(ce.state)
    for h in handles:
        h.cancel()
    eager = decode_window(lambda: eager_ticks(engine, copy, ticks), ticks,
                          family)
    del copy
    for label, w in (("graphed", graphed), ("eager", eager)):
        if not sampled and w["launches"].get("sample", 0):
            raise AssertionError(f"{name}: {w['launches']} (a greedy "
                                 f"{label} window launched the sampler)")
        if sampled and w["launches"].get("sample", 0) != ticks:
            raise AssertionError(f"{name}: {label} window {w['launches']} "
                                 f"over {ticks} ticks (expected one sample "
                                 "launch per tick)")
        sample_us = w.pop("_sample_us")
        if sampled:
            w["sample_kernel_device_ms_per_tick"] = (
                sample_us / 1e3 / ticks if sample_us else "not measured")
    if graphed["launches"] != eager["launches"]:
        raise AssertionError(f"{name}: the graphed window counted "
                             f"{graphed['launches']}, the eager one "
                             f"{eager['launches']}")
    line = {"phase": name, "card": card, "rows": len(handles),
            "note": "tick_ms is taken under the profiler, which slows the "
                    "host, tick_ms_unprofiled on the host clock alone (the "
                    "same ticks' count, run just before); device times are "
                    "the kernels' own; the eager "
                    "window runs decode_step_batch on a copy of the same "
                    "rows, with the engine's host reads after each tick" +
                    ("" if sampled else "; the served mix runs the sampled "
                     "tick once a sampled request has been admitted (the "
                     "flag is sticky): this greedy tick is what an "
                     "all-greedy engine runs"),
            "graphed": graphed, "eager": eager,
            "tick_speedup": eager["tick_ms"] / graphed["tick_ms"],
            "tick_speedup_unprofiled": eager["tick_ms_unprofiled"] /
            graphed["tick_ms_unprofiled"]}
    if sampled:
        line["gumbel_noise_alone"] = gumbel_noise_cost(len(handles), 64,
                                                       ticks)
    emit(line)
    if graphed["host_launch_calls_per_tick"] > GRAPHED_LAUNCH_CALLS_PER_TICK:
        raise AssertionError(
            f"{name}: {graphed['host_launch_calls_per_tick']} host launch "
            f"calls a graphed tick (at most "
            f"{GRAPHED_LAUNCH_CALLS_PER_TICK}): {graphed['host_launch_calls']}")


#: profile_prefill's eight prompts (the 1024 bucket), packed too by
#: profile_prefill_packed
PROFILE_PREFILL_LENS = (1000, 1010, 990, 1023, 900, 1020, 1015, 1005)


#: profile_prefill_suffix: the prompt tokens served from the cache
PROFILE_SUFFIX_CACHED = 768

#: prefills a profile_prefill window runs
PREFILL_REPS = 3
#: a graphed prefill's most host launch calls (one graph launch, the
#: uploads' and the first token's small kernels, a gather)
GRAPHED_LAUNCH_CALLS_PER_PREFILL = 64


def prefill_window(run, reps: int, family=kernel_family) -> dict:
    """``run`` (one prefill) ``reps`` times on the host clock alone, then
    under the profiler: wall time per prefill both ways, the host's
    launch calls per prefill, the device kernels per prefill, the
    device's busy time (by kernel family) and idle share, the trace held
    against the launch counters."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    prof, wall_ms, launches, (busy_us, kernels, host), check, out = \
        traced_window(lambda: [run() for _ in range(reps)][-1], family)
    busy_ms = sum(busy_us.values()) / 1e3
    complete = check["trace_complete"] and busy_ms > 0
    calls = host_launch_calls(prof)
    return {"prefills": reps, "wall_ms_unprofiled": plain_ms / reps,
            "wall_ms": wall_ms / reps,
            "host_launch_calls_per_prefill": sum(calls.values()) / reps,
            "host_launch_calls": calls,
            "launch_cross_check": check, "launches": launches,
            "device_kernels_per_prefill": sum(c for _, c, _ in kernels)
            / reps,
            "device_busy_ms": busy_or_not_measured(busy_ms / reps, check),
            "device_idle_share": (1 - busy_ms / wall_ms) if complete
            else busy_or_not_measured(None, check),
            "busy_ms_by_family": {k: v / 1e3 / reps for k, v in
                                  sorted(busy_us.items())}
            if complete else busy_or_not_measured(None, check),
            **in_trace(busy_us, reps, check, wall_ms),
            "host_ops_self_ms": sum(u for u, _, _ in host) / 1e3 / reps,
            "top_device_kernels": [
                {"name": name[:80], "ms": us / 1e3 / reps,
                 "calls": count / reps}
                for us, count, name in sorted(kernels, reverse=True)[:8]],
            "_kernels": kernels, "_out": out}


def cell_outputs(engine, run) -> dict:
    """What ``run`` (one prefill) got from its cell call, copied."""
    seen = []
    real = engine._run_cell

    def spy(*args):
        outs = real(*args)
        seen.append({k: v.clone() for k, v in outs.items()})
        return outs

    engine._run_cell = spy
    try:
        run()
    finally:
        del engine._run_cell
    return seen[-1]


def profile_prefill(client, card: str, mode: str = "full",
                    phase: str = None, family=kernel_family) -> None:
    """One prefill of eight prompts at full width, in two windows of the
    same host: through the engine's cell (the graph replay the
    continuous engine runs, captured here at its first call where
    ``warmup_aot`` did not walk it) and through the public eager method,
    the same cell body on tensors of its own.  At the 1024 bucket, eight
    rows of it (``"full"``, the per-group path); the same prompts as one
    pack of 7963 tokens in the 8192 pack bucket (``"packed"``, the paged
    path's default); or (``"suffix"``) their first
    ``PROFILE_SUFFIX_CACHED`` tokens served from the cache: each prefill
    gathers that prefix KV from a paged pool (straight into the cell's
    inputs when graphed) and prefills the rest, eight rows at the 256
    bucket, the causal kernel in suffix alignment.  Each window gives
    the wall time per prefill, the host's launch calls, the device
    kernels, the device's busy time by kernel family and its idle share,
    the trace held against the launch counters; the graphed cell's
    logits and KV must equal the eager body's bit for bit, and a graphed
    prefill may make at most ``GRAPHED_LAUNCH_CALLS_PER_PREFILL`` host
    launch calls.  Then the flash kernel's device time, share and rate
    over its 24 launches a prefill."""
    from repro_torch.runtime.graphs import Fill
    engine = client.backend.engine
    cfg = engine.cfg
    cells = engine.prefill_cells
    rng = np.random.default_rng(SEED + 2)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in PROFILE_PREFILL_LENS]
    packed = mode == "packed"
    kname = "flash_attention_packed" if packed else "flash_attention"
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                        device=engine.device)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=engine.device)
    cached = PROFILE_SUFFIX_CACHED
    if mode == "suffix":
        # the prefixes' KV in a paged pool (their 1024 bucket's blocks
        # a row), read back through the first cached / 16 of each table
        pool = engine.own_pool(engine.prefill_batch(
            [p[:cached] for p in prompts], max_len=1024,
            max_new_tokens=1, prompt_kv_only=True), 1024).cache
        tables = pool["block_tables"][:, :cached // 16].long()
        flat = (cfg.num_layers, len(prompts), cached, cfg.num_kv_heads,
                cfg.head_dim)
        slots = ((tables * 16)[:, :, None] +
                 torch.arange(16, device=engine.device)).reshape(-1)

        def gather(key):
            src = pool[key].view((cfg.num_layers, -1) + pool[key].shape[3:])
            return Fill(flat, src.dtype, lambda t: torch.index_select(
                src, 1, slots, out=t.view((cfg.num_layers, -1) +
                                          src.shape[2:])))

    def prefill(graphed: bool):
        table = cells if graphed else None
        if packed:
            return engine._prefill_packed_flat(
                prompts, [0] * len(prompts), table, no_kv, no_kv, no_ids,
                no_ids)[0]
        if mode == "suffix":
            if graphed:
                pk, pv = gather("k"), gather("v")
            else:
                pk = pool["k"][:, tables].reshape(flat)
                pv = pool["v"][:, tables].reshape(flat)
            return engine._prefill_suffix_batch(
                prompts, table, prefix_k=pk, prefix_v=pv,
                prefix_len=cached, max_new_tokens=1).cur
        return engine._prefill_batch(prompts, table, max_len=1024,
                                     max_new_tokens=1,
                                     prompt_kv_only=True).cur

    captures0, seconds0 = cells.captures, cells.capture_seconds
    prefill(True)               # captures the cell where it is missing
    prefill(False)              # allocator pools for the eager body
    captured = cells.captures - captures0
    graphed_out = cell_outputs(engine, lambda: prefill(True))
    eager_out = cell_outputs(engine, lambda: prefill(False))
    unequal = [k for k in eager_out
               if not torch.equal(graphed_out[k], eager_out[k])]
    if unequal:
        raise AssertionError(f"profile_prefill {mode}: the graphed cell's "
                             f"{unequal} differ from the eager body's")
    del graphed_out, eager_out
    from repro_torch.kernels import cuda_lib
    windows = {}
    for label in ("graphed", "eager"):
        w = prefill_window(lambda: prefill(label == "graphed"),
                           PREFILL_REPS, family)
        suffix = cuda_lib.LAUNCH_SHAPES[("flash_attention", "suffix")]
        want = cfg.num_layers * PREFILL_REPS
        plans = w["launches"].get("flash_attention_packed_plan", 0)
        if w["launches"].get(kname, 0) != want or \
                suffix != (want if mode == "suffix" else 0) or \
                plans != (PREFILL_REPS if packed else 0):
            raise AssertionError(
                f"profile_prefill {mode} {label}: {w['launches']}, "
                f"{suffix} suffix-aligned (expected {cfg.num_layers} "
                f"{kname} launches a prefill, and one plan a pack)")
        out = w.pop("_out")
        first = out[:len(prompts)].argmax(dim=-1) if packed else \
            out[:len(prompts)]
        if bool(((first < 0) | (first >= cfg.vocab_size)).any()):
            raise AssertionError(f"profile_prefill {mode}: first token out "
                                 "of range")
        if packed and not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"profile_prefill {mode}: non-finite "
                                 "logits")
        windows[label] = w
    graphed, eager = windows["graphed"], windows["eager"]
    if graphed["launches"] != eager["launches"]:
        raise AssertionError(f"profile_prefill {mode}: the graphed window "
                             f"counted {graphed['launches']}, the eager "
                             f"one {eager['launches']}")
    kernels = graphed.pop("_kernels")
    eager.pop("_kernels")
    busy = graphed["device_busy_ms"]
    needle = PORT_KERNELS[kname][0]
    flash_us = sum(us for us, _, name in kernels if needle in name) \
        / PREFILL_REPS
    b, s, h, dh = 8, 1024, cfg.num_heads, cfg.head_dim
    flat_tokens = sum(PROFILE_PREFILL_LENS)
    if mode == "suffix":
        s = engine.ladder.seq_bucket(max(PROFILE_PREFILL_LENS) - cached)
    # the work the prompts need: each one's causal pairs (packed), or the
    # padded rows' (per group): s queries after ``cached`` keys
    pairs = sum(n * (n + 1) / 2 for n in PROFILE_PREFILL_LENS) if packed \
        else b * (s * (s + 1) / 2 + (s * cached if mode == "suffix" else 0))
    flops = cfg.num_layers * 4.0 * h * dh * pairs
    emit({"phase": phase or {"full": "profile_prefill",
                             "packed": "profile_prefill_packed",
                             "suffix": "profile_prefill_suffix"}[mode],
          "card": card, "rows": 1 if packed else b,
          "bucket": engine.ladder.pack_bucket(flat_tokens) if packed else s,
          "cached_tokens": cached if mode == "suffix" else 0,
          "flat_tokens": flat_tokens if packed else b * s,
          "prompt_lens": [len(p) for p in prompts],
          "cell": {"captured_here": captured,
                   "capture_s": cells.capture_seconds - seconds0,
                   "graphed_equal_to_eager": "logits and KV, bit for bit"},
          "note": "wall_ms is taken under the profiler, which slows the "
                  "host, wall_ms_unprofiled on the host clock alone (the "
                  "same prefills, run just before); device times are the "
                  "kernels' own; the eager window runs the public method "
                  "(the cell body on tensors of its own) on the same "
                  "prompts",
          "graphed": graphed, "eager": eager,
          "speedup_unprofiled": eager["wall_ms_unprofiled"] /
          graphed["wall_ms_unprofiled"],
          kname: {
              "launches_per_prefill": cfg.num_layers,
              "device_ms": flash_us / 1e3 if flash_us else "not measured",
              "ms_per_launch": flash_us / 1e3 / cfg.num_layers
              if flash_us else "not measured",
              "share_of_busy": flash_us / 1e3 / busy
              if flash_us and isinstance(busy, float) else "not measured",
              "tflops": flops / (flash_us * 1e-6) / 1e12
              if flash_us else "not measured"}})
    calls = graphed["host_launch_calls_per_prefill"]
    if calls > GRAPHED_LAUNCH_CALLS_PER_PREFILL:
        raise AssertionError(
            f"profile_prefill {mode}: {calls} host launch calls a graphed "
            f"prefill (at most {GRAPHED_LAUNCH_CALLS_PER_PREFILL}): "
            f"{graphed['host_launch_calls']}")


# ---------------------------------------------------------------------------
# Phase 8: serve full-width OLMoE-1B-7B (the MoE family)
# ---------------------------------------------------------------------------

#: the MoE phase's model
MOE_ARCH = "olmoe-1b-7b"


@contextlib.contextmanager
def moe_wrapped(name: str, make):
    """While open, ``repro_torch.models.moe``'s function ``name`` is
    ``make(real)``; ``apply_moe`` finds it there at every call of an eager
    pass (a graph replay runs none of it)."""
    from repro_torch.models import moe as M
    real = getattr(M, name)
    setattr(M, name, make(real))
    try:
        yield
    finally:
        setattr(M, name, real)


@contextlib.contextmanager
def moe_recorded():
    """While open, every dispatch of an eager pass (the reads sync the
    host) records its token count, the expert capacity, the largest
    expert load, the assignments dropped, which tokens lost one and the
    dropped (token, expert) pairs as a (T, E) mask, from the dispatch's
    own ``keep``; yields the list of calls, in layer order."""
    calls = []

    def make(real):
        def recorded(x2d, idx, weights, e, cap, dtype):
            out = real(x2d, idx, weights, e, cap, dtype)
            keep = out[4].reshape(idx.shape)
            drops = torch.zeros((idx.shape[0], e), dtype=torch.bool,
                                device=idx.device)
            drops.scatter_(1, idx, ~keep)
            load = torch.bincount(idx.reshape(-1), minlength=e)
            calls.append({"tokens": idx.shape[0], "cap": cap,
                          "max_load": int(load.max()),
                          "dropped": int((~keep).sum()),
                          "lost": (~keep).any(dim=1).cpu(),
                          "drops": drops.cpu()})
            return out
        return recorded

    with moe_wrapped("_dispatch_group", make):
        yield calls


def unbounded_capacity(real):
    """``expert_capacity`` that never binds: each token picks k distinct
    experts, so no expert gets more than T assignments."""
    return lambda cfg, t: max(8, -(-t // 8) * 8)


@contextlib.contextmanager
def moe_pinned_drops(pins):
    """While open, one eager pass drops exactly what ``pins`` says: no
    capacity binds, and layer l drops the (token, expert) pairs its
    (T, E) mask ``pins[l]`` marks, the rest kept: the pass repeats the
    drops of another pass, token for token."""
    layer = [0]

    def make(real):
        def pinned(x2d, idx, weights, e, cap, dtype):
            xin, slot, tok, w, keep = real(x2d, idx, weights, e, cap, dtype)
            pin = pins[layer[0]].gather(1, idx).reshape(-1)
            layer[0] += 1
            keep = keep & ~pin
            return xin, torch.where(keep, slot, e * cap), tok, w, keep
        return pinned

    with moe_wrapped("expert_capacity", unbounded_capacity), \
            moe_wrapped("_dispatch_group", make):
        yield
    if layer[0] != len(pins):
        raise AssertionError(f"serve_moe: a pinned pass ran {layer[0]} MoE "
                             f"layers, not {len(pins)}")


def pass_segments(key, inputs) -> list:
    """(prompt tokens, flat indices of those tokens in the pass) of each
    segment of a packed prefill or each row of a per-group one."""
    toks = np.asarray(inputs["tokens"])
    if key[0] == "pack":
        seg = np.asarray(inputs["seg_ids"])
        return [(tuple(toks[0, seg == i]), np.flatnonzero(seg == i))
                for i in np.unique(seg[seg >= 0])]
    lens = np.asarray(inputs["true_lengths"])
    width = toks.shape[1]
    return [(tuple(toks[r, :n]), r * width + np.arange(n))
            for r, n in enumerate(lens)]


def clone_state(state):
    from repro_torch.runtime.engine import GenState
    from repro_torch.runtime.graphs import CONTROL
    return GenState(cache={k: v.clone() for k, v in state.cache.items()},
                    **{n: getattr(state, n).clone() for n in CONTROL},
                    sampling=state.sampling)


class MoeAudit:
    """Spies on a continuous engine while installed: every decode tick's
    graph replay is held bit for bit against ``decode_step_batch`` on a
    copy of the state (the paged pool's trash block left out: free rows
    write there in no fixed order), and every prefill cell's replay
    against its body run eagerly on the same inputs; each eager run is
    recorded (``moe_recorded``), so every prefill pass's capacity,
    largest load and dropped assignments are known; a decode tick that
    drops fails.  The engine's public (eager) prefills are recorded too.

    ``mode`` labels the passes.  In "served" mode the (token, expert)
    pairs each prompt's pass dropped are kept, by prompt.  In "alone"
    mode (each request run again by itself) every prefill pass runs
    eagerly with those drops pinned (``moe_pinned_drops``) and its
    result is the one served: the alone run computes what the served
    pass computed for the request, the other requests of its pack
    apart."""

    def __init__(self, ce):
        self.ce, self.engine = ce, ce.engine
        self.mode = "served"
        self.passes = []
        self.drops = {}
        self.pinned = set()
        self.ticks_checked = 0
        self.cells_checked = 0

    def install(self) -> None:
        self.engine._run_cell = self._cell
        self.ce.tick_cells.run = self._tick

    def remove(self) -> None:
        del self.engine._run_cell
        del self.ce.tick_cells.run

    def _tick(self, state) -> bool:
        with moe_recorded() as calls:
            want = self.engine.decode_step_batch(clone_state(state))
        if any(c["dropped"] for c in calls):
            raise AssertionError(f"serve_moe: a decode tick of "
                                 f"{calls[0]['tokens']} rows dropped an "
                                 "assignment")
        captured = type(self.ce.tick_cells).run(self.ce.tick_cells, state)
        same = torch.equal(state.cache["len"], want.cache["len"]) and all(
            torch.equal(state.cache[k][:, 1:], want.cache[k][:, 1:])
            for k in ("k", "v")) and all(
            torch.equal(getattr(state, n), getattr(want, n))
            for n in ("cur", "emitted", "counts", "done"))
        if not same:
            raise AssertionError(f"serve_moe: tick replay "
                                 f"{self.ticks_checked} differs from the "
                                 "eager tick")
        self.ticks_checked += 1
        return captured

    def _pins(self, segments, tokens: int) -> list:
        """The (T, E) drop masks, one a layer, that put each segment's
        served drops on its tokens in this pass."""
        cfg = self.engine.cfg
        pins = [torch.zeros((tokens, cfg.moe.num_experts), dtype=torch.bool)
                for _ in range(cfg.num_layers)]
        for prompt, at in segments:
            if prompt not in self.drops:     # a padding row of a batch
                continue
            self.pinned.add(prompt)
            for pin, served in zip(pins, self.drops[prompt]):
                pin[torch.from_numpy(at)] = served
        return [pin.to(self.engine.device) for pin in pins]

    def _cell(self, table, key, body, inputs, outputs):
        from repro_torch.runtime import graphs
        real = type(self.engine)._run_cell
        dev = self.engine.device
        segments = pass_segments(key, inputs)
        if table is None:
            with moe_recorded() as calls:
                outs = real(self.engine, table, key, body, inputs, outputs)
        else:
            outs = real(self.engine, table, key, body, inputs, outputs)
            with moe_recorded() as calls:
                eager = graphs.run_eager(body, inputs, outputs, dev)
            bad = [k for k in outs if not torch.equal(outs[k], eager[k])]
            if bad:
                raise AssertionError(f"serve_moe: cell {key} replay's {bad} "
                                     "differ from its eager body's")
            self.cells_checked += 1
        lost = torch.stack([c["lost"] for c in calls]).any(dim=0).numpy()
        record = {
            "mode": self.mode, "kind": cell_kind(key),
            "tokens": calls[0]["tokens"], "capacity": calls[0]["cap"],
            "max_expert_load_layer0": calls[0]["max_load"],
            "dropped_assignments": sum(c["dropped"] for c in calls),
            "prompts_losing_an_assignment": sum(
                bool(lost[at].any()) for _, at in segments)}
        if self.mode == "served":
            for prompt, at in segments:
                at = torch.from_numpy(at)
                self.drops[prompt] = [c["drops"][at] for c in calls]
        else:
            with moe_pinned_drops(self._pins(segments,
                                             calls[0]["tokens"])), \
                    moe_recorded() as pinned:
                outs = graphs.run_eager(body, inputs, outputs, dev)
            record["pinned_dropped_assignments"] = sum(
                c["dropped"] for c in pinned)
        self.passes.append(record)
        return outs


#: how far a packed pass's logits may lie from each prompt's own prefill's,
#: at every position of every prompt, in bf16 ulps of the row's largest
#: |logit|, with no capacity binding.  Routing free: 20.5 in each of three
#: runs of the phase on an H100 80GB HBM3 at 700 W (the same seed), the
#: expert choices the change of shape flips included.  Routing pinned to
#: the own prefill's choices: rounding alone.  Both are wider than the
#: dense rule's ``PACKED_LOGIT_ULPS``, which holds the last position of
#: each prompt only: here every position of 14 prompts is held (about
#: 5500 rows), through 16 layers that each sum eight experts' outputs in
#: bf16
MOE_PACKED_LOGIT_ULPS = 24
MOE_ROUNDING_ULPS = 8


@contextlib.contextmanager
def moe_routes(pins=None):
    """While open, every ``route`` of an eager pass appends its (T, k)
    expert choices to the yielded list; with ``pins`` (a (T, k) choice a
    layer, -1 rows free) the choices are pinned and the gates are the
    pass's own router probabilities at the pinned experts, normalised
    as ``route`` normalises them."""
    chosen = []

    def make(real):
        def routed(cfg, p, x2d):
            w, idx, aux = real(cfg, p, x2d)
            if pins is not None:
                want = pins[len(chosen)]
                idx = torch.where(want >= 0, want, idx)
                probs = torch.softmax(
                    torch.matmul(x2d.float(), p["router"].float()), dim=-1)
                w = probs.gather(1, idx)
                w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
            chosen.append(idx)
            return w, idx, aux
        return routed

    with moe_wrapped("route", make):
        yield chosen


def moe_packed_drift(engine, prompts) -> dict:
    """The largest |logit| difference between a packed pass (the prompts
    in packs of 8, each pack at its pack bucket) and each prompt's own
    prefill, at every position of every prompt, in logits and in bf16
    ulps of the row's largest |logit|, with no capacity binding (so no
    assignment drops in either pass): twice, with each pass routing
    freely (rounding and the expert choices it flips) and with the
    packed pass's choices pinned to the own prefill's (rounding alone);
    and the choices the change of shape flips.  Fails where a drift
    passes its limit (``MOE_PACKED_LOGIT_ULPS``, ``MOE_ROUNDING_ULPS``)."""
    from repro_torch.models import forward_hidden, prefill_packed
    from repro_torch.models import layers as L
    from repro_torch.runtime.engine import segment_labels
    cfg, params, dev = engine.cfg, engine.params, engine.device
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                        device=dev)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=dev)
    worst = {"free": [0.0, 0.0], "pinned": [0.0, 0.0]}
    rows, flipped_rows, flipped_choices = 0, 0, 0
    with moe_wrapped("expert_capacity", unbounded_capacity), \
            moe_recorded() as calls:
        for at in range(0, len(prompts), 8):
            group = prompts[at:at + 8]
            lens = [len(p) for p in group]
            flat = sum(lens)
            width = engine.ladder.pack_bucket(flat)
            seg, pos = segment_labels(lens, [0] * len(lens), width)
            toks = torch.full((1, width), engine.pad_id, dtype=torch.long,
                              device=dev)
            toks[0, :flat] = torch.tensor([t for p in group for t in p],
                                          device=dev)
            own, own_idx = [], []
            for p in group:
                with moe_routes() as chosen:
                    h, _ = forward_hidden(cfg, params,
                                          torch.tensor([p], device=dev))
                own.append(L.lm_logits(cfg, params["embed"], h)[0].float())
                own_idx.append(chosen)
            pins = [torch.full((width, cfg.moe.top_k), -1, dtype=torch.long,
                               device=dev) for _ in range(cfg.num_layers)]
            for layer, pin in enumerate(pins):
                pin[:flat] = torch.cat([c[layer] for c in own_idx])

            def packed():
                return prefill_packed(
                    cfg, params, toks, torch.from_numpy(seg).to(dev),
                    torch.from_numpy(pos).to(dev),
                    torch.arange(flat, dtype=torch.int32, device=dev),
                    no_kv, no_kv, no_ids, no_ids)[0]
            with moe_routes() as free_idx:
                free = packed()
            with moe_routes(pins):
                pinned = packed()
            flips = torch.zeros((flat,), dtype=torch.bool, device=dev)
            for layer, pin in enumerate(pins):
                differ = (torch.sort(free_idx[layer][:flat]).values !=
                          torch.sort(pin[:flat]).values)
                flips |= differ.any(dim=1)
                flipped_choices += int(differ.sum())
            flipped_rows += int(flips.sum())
            for label, logits in (("free", free), ("pinned", pinned)):
                start = 0
                for p, want in zip(group, own):
                    got = logits[start:start + len(p)].float()
                    start += len(p)
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError("serve_moe: non-finite packed "
                                             "logits")
                    d = (got - want).abs().amax(dim=-1)
                    ulp = torch.exp2(torch.floor(torch.log2(
                        want.abs().amax(dim=-1).clamp_min(2.0 ** -126))) - 7)
                    w = worst[label]
                    w[0] = max(w[0], float(d.max()))
                    w[1] = max(w[1], float((d / ulp).max()))
            rows += flat
    if any(c["dropped"] for c in calls):
        raise AssertionError("serve_moe: a pass with unbounded capacity "
                             "dropped an assignment")
    out = {"max_abs_dlogit": worst["free"][0],
           "max_bf16_ulps": worst["free"][1],
           "limit_bf16_ulps": MOE_PACKED_LOGIT_ULPS,
           "routing_pinned": {"max_abs_dlogit": worst["pinned"][0],
                              "max_bf16_ulps": worst["pinned"][1],
                              "limit_bf16_ulps": MOE_ROUNDING_ULPS},
           "positions": rows, "positions_with_a_flipped_choice": flipped_rows,
           "flipped_choices": flipped_choices,
           "capacity": "unbounded"}
    if not worst["free"][1] <= MOE_PACKED_LOGIT_ULPS or \
            not worst["pinned"][1] <= MOE_ROUNDING_ULPS:
        raise AssertionError(f"serve_moe: packed pass against own prefill "
                             f"beyond its limit: {out}")
    return out


def moe_launches_check(cfg, launches: dict, ticks: int,
                       prefills: int) -> dict:
    """The launches a served window of ``ticks`` decode ticks (warm-up
    ticks included) and ``prefills`` packed prefills must count: two
    norms a layer, two qk-norms a layer where the model has them and the
    final norm in every tick and prefill; a packed flash launch a layer
    and one plan a prefill; a paged decode launch a layer a tick; the
    sampler; nothing of the per-group, contiguous or classify paths.
    Returns the expected counts; raises where they differ."""
    layers = cfg.num_layers
    norms_per_step = (4 if cfg.qk_norm else 2) * layers + 1
    want = {"norm": norms_per_step * (ticks + prefills),
            "flash_attention_packed": layers * prefills,
            "flash_attention_packed_plan": prefills,
            "flash_decode_paged": layers * ticks}
    got = {k: launches.get(k, 0) for k in want}
    if got != want or not launches.get("sample", 0) or any(
            launches.get(k, 0) for k in ("flash_attention", "flash_decode",
                                         "softmax")):
        raise AssertionError(f"serve_moe: launches {launches} over {ticks} "
                             f"ticks and {prefills} prefills (expected "
                             f"{want})")
    return want


def serve_moe(dev, card: str):
    """Full-width OLMoE-1B-7B through ``TurboClient.from_arch``: the
    serve phase's 14 requests served twice, first timed (tok/s, TTFT,
    peak memory, launches), then again with every graph replay held to
    its eager body and every prefill pass's routing read (capacity,
    largest load of its first layer, dropped assignments); each stream
    against the request alone (greedy: ``generate``; sampled: served
    again alone) with its prefill dropping exactly the assignments its
    served pass dropped (``MoeAudit``), where a difference must fall at
    a near tie of the drawn token (``draw_margins``, against twice the
    logit drift between a packed pass and each prompt's own prefill,
    ``moe_packed_drift``, held to ``MOE_PACKED_LOGIT_ULPS``).
    Returns the client, warm, for the profile windows."""
    from repro_torch.api import TurboClient
    from repro_torch.kernels import cuda_lib
    from repro_torch.runtime.engine import _leaves
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    client = TurboClient.from_arch(
        MOE_ARCH, smoke=False, device=dev, seq_buckets=(128, 256, 512, 1024),
        batch_buckets=(8,), max_slots=8, cap_new=64, init_seed=SEED,
        num_blocks=8 * 1024 // 16 + 1)
    ce = client.backend
    engine = ce.engine
    cfg = engine.cfg
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = dict(client.warmup_stats)
    warm_cells = cell_stats(engine)
    cells = ce.tick_cells
    if len(cells) != 2 or warm["compile_count"] != \
            2 + engine.prefill_cells.captures:
        raise AssertionError(f"serve_moe: warmup_aot captured {warm}")
    specs = serve_specs(cfg.vocab_size, rng)
    first, later = specs[:8], specs[8:]

    def serve_once():
        handles = [client.submit(p, g) for p, g in first]
        client.pump(max_ticks=6)
        handles += [client.submit(p, g) for p, g in later]
        return handles, [h.result() for h in handles]

    captures0, warm_ticks0 = cells.captures, cells.warm_ticks
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    t_serve = time.perf_counter()
    handles, results = serve_once()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    ticks, prefills = ce.decode_ticks, ce.prefill_dispatches
    warm_ticks = cells.warm_ticks - warm_ticks0
    served_cells = cell_stats(engine, warm_cells)
    if cells.captures != captures0 or served_cells["captured_since"]:
        raise AssertionError(f"serve_moe: cells captured while serving: "
                             f"{served_cells['captured_since']}")
    layers = cfg.num_layers
    want = moe_launches_check(cfg, launches, ticks + warm_ticks, prefills)
    if ce.block_table.used_blocks or engine.kv_slab.live_bytes:
        raise AssertionError("serve_moe: KV leaked after drain")
    vocab = cfg.vocab_size
    gen_tokens = 0
    for (prompt, params), res in zip(specs, results):
        out = res[len(prompt):]
        gen_tokens += len(out)
        if res[:len(prompt)] != prompt or len(out) != \
                params.max_new_tokens or any(not 0 <= t < vocab
                                             for t in out):
            raise AssertionError("serve_moe: bad result")
    ttft = sorted(h.ttft for h in handles)
    packs = list(ce.pack_log)

    # the same requests again, every replay checked and every pass read
    audit = MoeAudit(ce)
    audit.install()
    try:
        ce.state.sampling = False          # as the first serve found it
        _, checked = serve_once()
        audit.mode = "alone"
        alone = []
        for prompt, params in specs:
            if params.temperature > 0:
                alone.append(client.submit(prompt, params).result())
            else:
                alone.append(engine.generate(
                    [prompt], max_new_tokens=params.max_new_tokens)[0])
    finally:
        audit.remove()
    if audit.pinned != {tuple(p) for p, _ in specs}:
        raise AssertionError("serve_moe: an alone run's prefill was not "
                             "pinned to its served pass's drops")
    drift = moe_packed_drift(engine, [p for p, _ in specs])
    divergences = []
    for (prompt, params), res, own in zip(specs, checked, alone):
        if own == res:
            continue
        d = explain_divergence(engine, prompt, params, own, res,
                               drift["max_abs_dlogit"])
        rounding = 2 * drift["routing_pinned"]["max_abs_dlogit"] / (
            params.temperature if params.temperature > 0 else 1.0)
        d["within_rounding_alone"] = d["alone_margin"] < rounding and \
            d["served_token_gap"] < rounding
        divergences.append(d)
    served_passes = [p for p in audit.passes if p["mode"] == "served"]
    emit({"phase": "serve_moe",
          "model": f"{MOE_ARCH} (full width, {layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.num_experts} experts top "
          f"{cfg.moe.top_k}, bf16 weights from a seed, f32 KV)",
          "card": card, "kv_layout": "paged",
          "weights": {"params": cfg.param_count(),
                      "active_params": cfg.active_param_count(),
                      "bytes": sum(t.numel() * t.element_size()
                                   for t in _leaves(engine.params)),
                      "active_bytes_bf16": 2 * cfg.active_param_count()},
          "requests": len(handles),
          "sampled": sum(1 for _, p in specs if p.temperature > 0),
          "generated_tokens": gen_tokens, "serve_s": serve_s,
          "tok_per_s": gen_tokens / serve_s,
          "ttft_p50_s": float(np.percentile(ttft, 50)),
          "ttft_p99_s": float(np.percentile(ttft, 99)),
          "peak_mem_gib": peak / 2 ** 30, "stack_build_s": build_s,
          "warmup_aot": warm,
          "prefill_cells": {
              "by_warmup_aot": warm_cells["cells_by_kind"],
              "capture_s_by_warmup_aot": warm_cells["capture_s"],
              "graph_pool_bytes": served_cells["graph_pool_bytes"],
              "static_buffer_bytes": served_cells["static_buffer_bytes"]},
          "tick_cells": {"capture_s_all": cells.capture_seconds,
                         "graph_pool_bytes": cells.pool_bytes()},
          "decode_ticks": ticks, "prefill_dispatches": prefills,
          "packs": [{"segments": n, "flat": flat, "bucket": bucket}
                    for n, flat, bucket in packs],
          "launches": launches,
          "launches_expected": want,
          "kv_cache_gib": sum(ce.state.cache[k].numel() * 4
                              for k in ("k", "v")) / 2 ** 30,
          "checked_serve": {
              "tick_replays_bit_equal_to_eager": audit.ticks_checked,
              "cell_replays_bit_equal_to_eager": audit.cells_checked,
              "streams_equal_to_the_timed_serve": sum(
                  a == b for a, b in zip(results, checked))},
          "prefill_passes": [
              {k: p[k] for k in ("kind", "tokens", "capacity",
                                 "max_expert_load_layer0",
                                 "dropped_assignments",
                                 "prompts_losing_an_assignment")}
              for p in served_passes],
          "alone_passes": [
              {k: p[k] for k in ("kind", "tokens", "dropped_assignments",
                                 "pinned_dropped_assignments")}
              for p in audit.passes if p["mode"] == "alone"],
          "packed_vs_own_prefill": drift,
          "equal_to_alone": sum(a == b for a, b in zip(alone, checked)),
          "divergences": divergences,
          "divergences_at_a_near_tie": sum(d["within_rule"]
                                           for d in divergences),
          "divergences_within_rounding_alone": sum(
              d["within_rounding_alone"] for d in divergences)})
    beyond = [d for d in divergences if not d["within_rule"]]
    if beyond:
        raise AssertionError(f"serve_moe: {len(beyond)} streams differ from "
                             f"the request alone (its served drops pinned) "
                             f"beyond a near tie: {beyond}")
    return client


# ---------------------------------------------------------------------------
# Phases 8b-8d: the modality front ends and model I/O at full width
# ---------------------------------------------------------------------------

#: the kernels' plain versions stand in for these wrappers of
#: `repro_torch.kernels.ops` in a plain run (``plain_versions``)
PLAIN_WRAPPERS = ("fused_rmsnorm", "fused_layernorm", "fused_softmax",
                  "flash_attention", "flash_decode", "flash_decode_paged")


@contextlib.contextmanager
def plain_versions():
    """Route the model's norm, masked softmax, causal attention and
    decode calls to the kernels' plain versions (`repro_torch.kernels.ref`)
    on the card's own tensors, so one pass can be held against the same
    pass through the kernels; the launch counters stay as they were.  A
    training pass's gradient is then autograd's through the plain
    versions, where the kernels' is their Functions'
    (`repro_torch.kernels.autograd`)."""
    from repro_torch.kernels import ops, ref
    plain = {
        "fused_rmsnorm": lambda x, gamma, bias=None, residual=None, *,
        eps=1e-6, return_residual=False: ref.rmsnorm_ref(
            x, gamma, bias, residual, eps, return_residual),
        "fused_layernorm": lambda x, gamma, beta, bias=None, residual=None,
        *, eps=1e-6, return_residual=False: ref.layernorm_ref(
            x, gamma, beta, bias, residual, eps, return_residual),
        "fused_softmax": lambda x, lengths=None, *, scale=1.0:
        ref.softmax_ref(x, lengths, scale),
        "flash_attention": lambda q, k, v, lengths=None, *, causal=True,
        scale=None: ref.flash_attention_ref(q, k, v, lengths, causal, scale),
        "flash_decode": lambda q, k, v, lengths=None, *, scale=None:
        ref.flash_decode_ref(q, k, v, lengths, scale),
        "flash_decode_paged": lambda q, kp, vp, tables, lengths=None, *,
        scale=None: ref.flash_decode_paged_ref(q, kp, vp, tables, lengths,
                                               scale)}
    saved = {name: getattr(ops, name) for name in PLAIN_WRAPPERS}
    try:
        for name in PLAIN_WRAPPERS:
            setattr(ops, name, plain[name])
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def ulps_of_row(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of each row of (rows, V) logits in bf16
    ulps of that row's largest |want|, the worst row."""
    d = (got.float() - want.float()).abs().amax(dim=-1)
    top = want.float().abs().amax(dim=-1)
    return max(float(x) / bf16_ulp(float(t)) for x, t in zip(d, top))


def greedy_near_ties(kernel_logits, plain_logits) -> dict:
    """Rows whose greedy token through the kernels differs from the plain
    run's on the same inputs, each judged by ``draw_margins`` on the
    plain logits: the plain run's top-2 gap and the kernel token's gap
    there must both lie below twice that row's largest logit difference
    (a tie that the two runs' rounding can flip)."""
    from repro_torch.api import GenerationParams
    k, p = kernel_logits.float(), plain_logits.float()
    ka, pa = k.argmax(-1), p.argmax(-1)
    greedy = GenerationParams(max_new_tokens=1)
    out = {"rows": int(ka.numel()), "differ": 0, "beyond_rule": []}
    for i in torch.nonzero(ka != pa).flatten().tolist():
        margin, gap = draw_margins(p[i], greedy, 0, int(ka[i]))
        limit = 2 * float((k[i] - p[i]).abs().max())
        out["differ"] += 1
        if not (margin < limit and gap < limit):
            out["beyond_rule"].append({"row": i, "margin": margin,
                                       "kernel_token_gap": gap,
                                       "limit": limit})
    return out


#: how far the kernels' logits may lie from the plain versions' on the
#: same inputs, in bf16 ulps of the row's largest |logit|, through a full
#: model's depth in bf16 (each kernel rounds P or its output at other
#: points than its plain version; see the kernel checks' tolerances).
#: On an NVIDIA H100 80GB HBM3 at 700 W the checks read 3.19 (Qwen2-VL,
#: 28 layers) and 5.5 (MusicGen, 48 layers)
PLAIN_LOGIT_ULPS = 16
#: the VLM check: four prompts of about 1000 tokens at the 1024 bucket
#: behind an image of num_vision_patches(1024) = 121 patches (an 11 x 11
#: grid), then 32 greedy decode steps
VLM_IMAGE_LENS = (1000, 1010, 990, 1024)
VLM_IMAGE_STEPS = 32


def vlm_image_check(engine, card: str) -> dict:
    """Qwen2-VL with an image prefix through the model functions: a
    prefill of four ~1000-token prompts whose first 121 slots are patch
    embeddings (`repro_torch.models.frontend.vision_patch_embeds`) at
    M-RoPE's grid positions, then 32 greedy decode steps on the
    contiguous cache from ``len + pos_offset`` (pos_offset -(121 - 1)).
    Every step's logits through the kernels are held against the plain
    versions' on the same inputs (``PLAIN_LOGIT_ULPS``, ties by
    ``greedy_near_ties``), and the positions must differ from plain
    RoPE's at the patches."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import decode_step, frontend, prefill
    from repro_torch.models import layers as L
    cfg, params, dev = engine.cfg, engine.params, engine.device
    t0 = time.perf_counter()
    s = max(VLM_IMAGE_LENS)
    n_img = frontend.num_vision_patches(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    emb = frontend.vision_patch_embeds(cfg, gen, len(VLM_IMAGE_LENS), s)
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (len(VLM_IMAGE_LENS), s))).to(dev)
    lens = torch.tensor(VLM_IMAGE_LENS, dtype=torch.int32, device=dev)
    pos = L.positions_for(cfg, (1, s), n_img, device=dev)
    text = L.positions_for(cfg, (1, s), 0, device=dev)
    differ = int((pos[:, 0, :n_img] != text[:, 0, :n_img]).any(0).sum())
    if differ == 0 or not torch.equal(pos[0, 0, n_img:],
                                      torch.arange(1, s - n_img + 1,
                                                   device=dev,
                                                   dtype=torch.int32)):
        raise AssertionError(f"M-RoPE positions: {differ} patch slots "
                             "differ from plain RoPE's, or the text does "
                             "not continue from 1")
    max_len = s + VLM_IMAGE_STEPS
    # through the kernels, greedy; then the plain versions fed the same
    # tokens
    cuda_lib.reset_launches()
    logits, cache = prefill(cfg, params, toks, max_len=max_len,
                            embeds_override=emb, true_lengths=lens)
    kernel_steps, fed = [logits], []
    for _ in range(VLM_IMAGE_STEPS):
        cur = logits.argmax(-1).to(torch.int32)
        fed.append(cur)
        logits, cache = decode_step(cfg, params, cache, cur)
        kernel_steps.append(logits)
    kernel_launches = dict(cuda_lib.LAUNCHES)
    kernel_shapes = {f"{n} {c}": v for (n, c), v in
                     cuda_lib.LAUNCH_SHAPES.items()}
    offset = cache["pos_offset"].tolist()
    with plain_versions():
        logits, cache = prefill(cfg, params, toks, max_len=max_len,
                                embeds_override=emb, true_lengths=lens)
        plain_steps = [logits]
        for cur in fed:
            logits, cache = decode_step(cfg, params, cache, cur)
            plain_steps.append(logits)
    torch.cuda.synchronize()
    del cache
    if offset != [-(n_img - 1)] * len(VLM_IMAGE_LENS):
        raise AssertionError(f"pos_offset {offset}, expected "
                             f"{-(n_img - 1)} a row")
    worst, ties = 0.0, {"rows": 0, "differ": 0, "beyond_rule": []}
    for k, p in zip(kernel_steps, plain_steps):
        if not bool(torch.isfinite(k.float()).all()):
            raise AssertionError("VLM image prompts: non-finite logits")
        worst = max(worst, ulps_of_row(k, p))
        t = greedy_near_ties(k, p)
        ties["rows"] += t["rows"]
        ties["differ"] += t["differ"]
        ties["beyond_rule"] += t["beyond_rule"]
    line = {"phase": "serve_vlm_image", "card": card,
            "prompts": list(VLM_IMAGE_LENS), "image_patches": n_img,
            "grid": math.isqrt(n_img), "decode_steps": VLM_IMAGE_STEPS,
            "pos_offset": offset, "patch_slots_off_plain_rope": differ,
            "kernel_vs_plain_bf16_ulps": {"max": worst,
                                          "limit": PLAIN_LOGIT_ULPS},
            "greedy_tokens_differing_from_plain": ties,
            "launches": kernel_launches, "launches_by_shape": kernel_shapes,
            "phase_s": time.perf_counter() - t0}
    emit(line)
    if worst > PLAIN_LOGIT_ULPS or ties["beyond_rule"]:
        raise AssertionError(f"VLM image prompts: kernels {worst:.1f} bf16 "
                             f"ulps from the plain versions (limit "
                             f"{PLAIN_LOGIT_ULPS}), ties {ties}")
    return line


#: generate_musicgen: 8 prompts of 100 to 1000 tokens, 256 new frames
MUSICGEN_PROMPT_LENS = (100, 1000, 250, 640, 420, 880, 175, 999)
MUSICGEN_NEW = 256
#: the model-function check: delayed codes (B, 4, S), a prefill and 64
#: decode steps
MUSICGEN_CODES = dict(batch=8, seq=512, steps=64)


def generate_musicgen(dev, card: str) -> dict:
    """MusicGen-large at full width and depth (48 layers, d_model 2048,
    32 heads of dh 64, LayerNorm + GELU, 4 codebooks of 2048; bf16 weights
    from a seed, f32 KV) through ``InferenceEngine.generate``: 8 prompts
    of 100 to 1000 tokens, 256 new frames each, greedy (the first
    codebook emitted, every frame fed back with its four codes; every
    tick a replay of one CUDA graph, as the reference compiles it).  Frames
    per second, the prefill's seconds, peak memory and the launches
    (causal flash at dh 64, paged decode at group 1 dh 64, the norm in
    LayerNorm mode); the two longest prompts generated alone (the same
    buckets, so the same bits) must equal their batched streams.  Then
    the model functions on (B, 4, S) delayed codes from
    `repro_torch.models.io.synthetic_prompts`: a prefill and 64 greedy
    decode steps, every step's four codebooks' logits held against the
    plain versions' on the same inputs (``PLAIN_LOGIT_ULPS``, ties by
    ``greedy_near_ties`` for each codebook)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import decode_step, init_params, io, prefill
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    t0 = time.perf_counter()
    cfg = get_config("musicgen-large")
    params = init_params(cfg, seed=SEED, device=dev)
    engine = InferenceEngine(cfg, params, ladder=BucketLadder(
        seq_buckets=(128, 256, 512, 1024, 2048), batch_buckets=(8,)),
        device=dev)
    rng = np.random.default_rng(SEED + 11)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in MUSICGEN_PROMPT_LENS]
    engine.generate(prompts[:1], max_new_tokens=2)      # first calls
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    t_gen = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=MUSICGEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t_gen
    launches = dict(cuda_lib.LAUNCHES)
    by_shape = {f"{n} {c}": v for (n, c), v in
                cuda_lib.LAUNCH_SHAPES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    nl = cfg.num_layers
    # the ticks are replays of one graph, whose capture runs one eager
    # tick first
    ticks = MUSICGEN_NEW - 1 + 1
    want = {"flash_attention dh64": nl,
            "flash_decode_paged g1 dh64": nl * ticks,
            "norm layernorm": (2 * nl + 1) * (1 + ticks)}
    got = {k: by_shape.get(k, 0) for k in want}
    if got != want or launches.get("flash_attention") != nl or \
            launches.get("flash_decode_paged") != nl * ticks or \
            launches.get("norm") != want["norm layernorm"]:
        raise AssertionError(f"generate_musicgen launches {launches} "
                             f"{by_shape}; expected {want}")
    for p, res in zip(prompts, out):
        if res[:len(p)] != p or len(res) != len(p) + MUSICGEN_NEW or \
                any(not 0 <= t < cfg.vocab_size for t in res[len(p):]):
            raise AssertionError("generate_musicgen: bad result shape")
    # prefill alone: the first frame's latency of the batch
    t_pf = time.perf_counter()
    engine.prefill_batch(prompts, max_len=2048, max_new_tokens=1,
                         prompt_kv_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t_pf
    longest = sorted(range(len(prompts)),
                     key=lambda i: -len(prompts[i]))[:2]
    alone_equal = sum(
        engine.generate([prompts[i]], max_new_tokens=MUSICGEN_NEW)[0] ==
        out[i] for i in longest)

    # the model functions on delayed codes, kernels against plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    codes = io.synthetic_prompts(cfg, gen, MUSICGEN_CODES["batch"],
                                 MUSICGEN_CODES["seq"])["tokens"]
    n_steps = MUSICGEN_CODES["steps"]
    max_len = MUSICGEN_CODES["seq"] + n_steps
    kernel_steps, fed = [], []
    cuda_lib.reset_launches()
    logits, cache = prefill(cfg, params, codes, max_len=max_len)
    kernel_steps.append(logits)
    for _ in range(n_steps):
        cur = logits.argmax(-1).to(torch.int32)           # (B, 4)
        fed.append(cur)
        logits, cache = decode_step(cfg, params, cache, cur)
        kernel_steps.append(logits)
    fn_launches = dict(cuda_lib.LAUNCHES)
    fn_shapes = {f"{n} {c}": v for (n, c), v in
                 cuda_lib.LAUNCH_SHAPES.items()}
    with plain_versions():
        logits, cache = prefill(cfg, params, codes, max_len=max_len)
        plain_steps = [logits]
        for cur in fed:
            logits, cache = decode_step(cfg, params, cache, cur)
            plain_steps.append(logits)
    torch.cuda.synchronize()
    worst, ties = 0.0, {}
    for book in range(cfg.num_codebooks):
        t_all = {"rows": 0, "differ": 0, "beyond_rule": []}
        for k, p in zip(kernel_steps, plain_steps):
            if not bool(torch.isfinite(k.float()).all()):
                raise AssertionError("musicgen: non-finite logits")
            worst = max(worst, ulps_of_row(k[:, book], p[:, book]))
            t = greedy_near_ties(k[:, book], p[:, book])
            t_all["rows"] += t["rows"]
            t_all["differ"] += t["differ"]
            t_all["beyond_rule"] += t["beyond_rule"]
        ties[f"codebook {book}"] = t_all
    line = {"phase": "generate_musicgen", "card": card,
            "model": f"musicgen-large (full width, {nl} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads of dh {cfg.head_dim}, "
            f"{cfg.num_codebooks} codebooks of {cfg.vocab_size}, "
            f"{cfg.norm} + {cfg.act}; bf16 weights from a seed, f32 KV)",
            "prompts": list(MUSICGEN_PROMPT_LENS),
            "new_frames": MUSICGEN_NEW, "generate_s": gen_s,
            "frames_per_s": len(prompts) * MUSICGEN_NEW / gen_s,
            "prefill_s": prefill_s, "peak_mem_gib": peak / 2 ** 30,
            "weights_gib": sum(t.numel() * t.element_size()
                               for t in param_leaves(params)) / 2 ** 30,
            "launches": launches, "launches_by_shape": by_shape,
            "longest_two_alone_equal": alone_equal,
            "codes": {**MUSICGEN_CODES, "kernel_vs_plain_bf16_ulps": {
                "max": worst, "limit": PLAIN_LOGIT_ULPS},
                "greedy_codes_differing_from_plain": ties,
                "launches": fn_launches, "launches_by_shape": fn_shapes},
            "stack_build_s": build_s,
            "phase_s": time.perf_counter() - t0}
    emit(line)
    if alone_equal != len(longest):
        raise AssertionError(f"generate_musicgen: {alone_equal} of "
                             f"{len(longest)} streams equal alone")
    beyond = [t for t in ties.values() if t["beyond_rule"]]
    if worst > PLAIN_LOGIT_ULPS or beyond:
        raise AssertionError(f"musicgen codes: kernels {worst:.1f} bf16 "
                             f"ulps from the plain versions (limit "
                             f"{PLAIN_LOGIT_ULPS}), ties {ties}")
    return launches


def param_leaves(tree) -> list:
    """The tensors of a nested parameter dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Phase 9: the serving tier: a replica pool, background warm-up, the
# simulator on the card's costs, the serving CLI
# ---------------------------------------------------------------------------

#: decode slots of each pool replica: fewer than the requests a replica
#: gets, so some wait queued while others decode (the kill needs both)
POOL_SLOTS = 4
POOL_CLIENT = dict(smoke=False, seq_buckets=(128, 256, 512, 1024),
                   batch_buckets=(1, 2, 4), max_slots=POOL_SLOTS, cap_new=64,
                   init_seed=SEED, num_blocks=2 * POOL_SLOTS * 1024 // 16 + 1)
#: serve_pool's requests in arrival order: (kind, prompt tokens past the
#: cohort's 512-token prefix, or a cold prompt's length)
POOL_KINDS = (("cohort0", 40), ("cohort1", 64), ("cohort0", 16),
              ("cold", 700), ("cohort1", 120), ("cohort0", 300),
              ("cold", 820), ("cohort1", 33), ("cohort0", 210),
              ("cohort1", 250), ("cold", 910), ("cohort0", 97),
              ("cohort1", 180), ("cold", 960), ("cohort0", 150),
              ("cohort1", 8))
POOL_PHASE_LIMIT_S = 300


def pool_workload(vocab: int, rng) -> list:
    """(kind, prompt, params) of serve_pool's 16 requests: two cohorts of
    6 sharing a 512-token prefix each (16 to 300 tokens after it), 4 cold
    prompts of 700 to 960 tokens, 32 to 64 new tokens each, every fourth
    seeded-sampled.  The two cohort heads come first."""
    from repro_torch.api import GenerationParams

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]
    prefixes = {"cohort0": toks(512), "cohort1": toks(512)}
    out = []
    for i, (kind, n) in enumerate(POOL_KINDS):
        prompt = prefixes[kind] + toks(n) if kind in prefixes else toks(n)
        sampled = i % 4 == 1
        out.append((kind, prompt, GenerationParams(
            max_new_tokens=min(int(rng.integers(32, 65)),
                               1024 - len(prompt)),
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 1.0,
            seed=4000 + i)))
    return out


def check_ownership_now(pool) -> int:
    """``check_pool_ownership`` on a consistent snapshot of the pool: its
    lock, then every replica's, all held until every replica is read
    (each replica's lock passes to this thread after its current tick).
    Returns the live sessions."""
    from repro_torch.runtime import sanitizer
    with pool._cv:
        held = []
        try:
            owned = {}
            for i in range(pool.num_replicas):
                c = pool.replica(i)
                c._cv.acquire()
                held.append(c)
                p = c.pipeline
                owned[i] = [s.req_id for s in list(p.queue) +
                            list(p.chunking) + list(p.live)
                            if not s.is_finished]
            return len(sanitizer.check_pool_ownership(
                owned, set(pool.healthy_replicas())))
        finally:
            for c in held:
                c._cv.release()


def pool_ticks(pool) -> int:
    return sum(pool._tick_count(pool.replica(i))
               for i in range(pool.num_replicas))


def capture_seconds(clients) -> float:
    """Seconds the clients' engines spent in first calls and captures of
    their cells (prefill and tick), waits for the device gate included."""
    return sum(c.backend.tick_cells.capture_seconds +
               c.backend.engine.prefill_cells.capture_seconds
               for c in clients)


def run_pool(pool, specs, kill: bool, clients) -> dict:
    """Serve ``specs`` through ``pool`` (the cohort heads first, to the
    end, then the rest).  With ``kill``, kill the first head's replica
    while it decodes some sessions and holds others queued (the last
    seven requests are submitted with its lock held, so its share of
    them stays queued), then hold the pool's ownership invariant on a
    consistent snapshot between its ticks until every request has
    ended.  ``clients``: the pool's replicas, whose captures while
    serving are counted."""
    from repro_torch.cluster import ReplicaFailure
    from repro_torch.runtime.session import SessionState
    cap0 = capture_seconds(clients)
    compiles0 = sum(c.backend.engine.compile_count for c in clients)
    t0 = time.perf_counter()
    handles = [pool.submit(p, g) for _, p, g in specs[:2]]
    for h in handles:
        h.result(timeout=POOL_PHASE_LIMIT_S)
    if not kill:
        handles += [pool.submit(p, g) for _, p, g in specs[2:]]
        placed = [h.replica for h in handles]
    victim, at_kill, checks, ticks0 = None, None, 0, 0
    if kill:
        # half the rest, until the first head's replica decodes one; then
        # with its lock held (it ticks no more) the other half, whose
        # sessions there stay queued, and the kill
        ticks0 = pool_ticks(pool)
        victim = handles[0].replica
        handles += [pool.submit(p, g) for _, p, g in specs[2:9]]
        deadline = time.monotonic() + POOL_PHASE_LIMIT_S
        while not any(h.replica == victim and
                      h.session.state is SessionState.DECODE
                      for h in handles):
            if time.monotonic() > deadline:
                raise AssertionError(f"serve_pool: replica {victim} "
                                     "never decoded")
            time.sleep(0.0005)
        with pool._cv, pool.replica(victim)._cv:
            handles += [pool.submit(p, g) for _, p, g in specs[9:]]
            placed = [h.replica for h in handles]
            states = [h.session.state for h in handles
                      if h.replica == victim]
            at_kill = {st.value: states.count(st) for st in set(states)}
            if SessionState.DECODE not in states or \
                    SessionState.QUEUED not in states:
                raise AssertionError(
                    f"serve_pool: replica {victim} holds {at_kill}, not a "
                    "decoding and a queued session")
            pool.kill_replica(victim, reason="serve_pool kill")
        deadline = time.monotonic() + POOL_PHASE_LIMIT_S
        while not all(h.done for h in handles):
            check_ownership_now(pool)
            checks += 1
            if time.monotonic() > deadline:
                raise AssertionError("serve_pool: requests did not end")
            time.sleep(0.002)
    results, lost = [], []
    for i, h in enumerate(handles):
        try:
            results.append(h.result(timeout=POOL_PHASE_LIMIT_S))
        except ReplicaFailure as e:
            if e.replica != victim or placed[i] != victim:
                raise
            results.append(None)
            lost.append(i)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    done = [(h, r, p) for h, r, (_, p, _) in zip(handles, results, specs)
            if r is not None]
    gen = sum(len(r) - len(p) for _, r, p in done)
    ttft = sorted(h.ttft for h, _, _ in done)
    return {"results": results, "placed": placed,
            "cached_tokens": [h.session.cached_tokens for h in handles],
            "captured_while_serving": sum(
                c.backend.engine.compile_count for c in clients) - compiles0,
            "capture_s_while_serving": capture_seconds(clients) - cap0,
            "final": [h.replica for h in handles], "victim": victim,
            "at_kill": at_kill, "lost": lost, "ownership_checks": checks,
            "ticks_while_checked": pool_ticks(pool) - ticks0 if kill else 0,
            "serve_s": serve_s, "generated_tokens": gen,
            "tok_per_s": gen / serve_s,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99))}


def alone_streams(phase, engine, specs, results, dlogit, cache,
                  indices=None) -> dict:
    """Each finished stream against its request served alone (greedy:
    ``engine.generate``; sampled: a client of its own over ``engine``),
    under the margin rule of the other serve phases; ``cache`` keeps the
    alone runs by request index.  Fails beyond the rule."""
    from repro_torch.api import TurboClient
    from repro_torch.runtime.engine import ContinuousEngine
    indices = range(len(specs)) if indices is None else indices
    greedy_eq = sampled_eq = 0
    divergences, alone_client = [], None
    for i, res in zip(indices, results):
        if res is None:
            continue
        kind, prompt, params = specs[i]
        if i not in cache:
            if params.temperature > 0:
                if alone_client is None:
                    alone_client = TurboClient(ContinuousEngine(
                        engine, max_slots=POOL_SLOTS, cap_new=64,
                        num_blocks=POOL_SLOTS * 1024 // 16 + 1))
                cache[i] = alone_client.submit(prompt, params).result()
            else:
                cache[i] = engine.generate(
                    [prompt], max_new_tokens=params.max_new_tokens)[0]
        alone = cache[i]
        if alone != res:
            divergences.append(dict(explain_divergence(
                engine, prompt, params, alone, res, dlogit), kind=kind,
                request=i))
        if params.temperature > 0:
            sampled_eq += alone == res
        else:
            greedy_eq += alone == res
    if alone_client is not None:
        alone_client.close()
    beyond = [d for d in divergences if not d["within_rule"]]
    if beyond:
        raise AssertionError(f"{phase}: {len(beyond)} streams differ from "
                             f"the request alone beyond the margin rule: "
                             f"{beyond}")
    return {"greedy_equal_to_generate_alone": greedy_eq,
            "sampled_equal_to_served_alone": sampled_eq,
            "divergences": divergences}


def replica_cells(client) -> dict:
    ce = client.backend
    cells = cell_stats(ce.engine)
    return {"by_warmup_aot": (client.warmup_stats or {}).get(
                "compile_count"),
            "compile_count": ce.engine.compile_count,
            "tick_cells": ce.tick_cells.captures,
            "prefill_cells_by_kind": cells["cells_by_kind"],
            "capture_s": cells["capture_s"] + ce.tick_cells.capture_seconds}


def serve_pool(dev, card: str, classified: dict) -> dict:
    """Phase 9: the serving tier at full width.  (a) Two InternLM2-1.8B
    replicas on the card, ``TurboClient.from_arch(..., replicas=2,
    prefix_cache=True, auto_pump="thread")`` (weights drawn once and read
    by both; the sanitizer on): 16 requests in two cohorts sharing a
    512-token prefix and 4 cold ones, served once timed, once more on
    warm caches and once with the first cohort's replica killed while it
    holds decoding and queued sessions; the same requests through one
    replica, twice, for its tok/s.
    (b) One client warming up in the background with a pump thread,
    given 4 requests before its warm-up ends.  (c) The simulator under
    nobatch, naive and dp with the cost table the classify phase measured,
    on that phase's requests and on the simulator's own Poisson draw at
    its rate, beside the measured resp/s and p99.  (d) The serving CLI,
    ``python -m repro_torch.launch.serve --no-smoke --replicas 2``, in a
    subprocess.  Returns the launches of (a)'s timed run."""
    import os

    from repro_torch.api import TurboClient
    from repro_torch.cluster import ReplicaPool
    from repro_torch.kernels import cuda_lib
    from repro_torch.runtime import graphs
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    sanitize_was = os.environ.get("TURBO_SANITIZE")
    os.environ["TURBO_SANITIZE"] = "1"
    try:
        # ---- (a) the pool ---------------------------------------------
        gate0 = (graphs.DEVICE_GATE.captures_waited,
                 graphs.DEVICE_GATE.wait_seconds)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pool = TurboClient.from_arch("internlm2-1.8b", device=dev,
                                     replicas=2, prefix_cache=True,
                                     auto_pump="thread", **POOL_CLIENT)
        build_s = time.perf_counter() - t0
        engines = [pool.replica(i).backend.engine for i in range(2)]
        if engines[0].params["embed"]["tok"].data_ptr() != \
                engines[1].params["embed"]["tok"].data_ptr() or \
                engines[0].prefill_cells is engines[1].prefill_cells:
            raise AssertionError("serve_pool: the replicas must read one "
                                 "set of weights through engines of their "
                                 "own")
        warm = [replica_cells(pool.replica(i)) for i in range(2)]
        specs = pool_workload(engines[0].cfg.vocab_size, rng)
        del engines
        replicas = [pool.replica(i) for i in range(2)]
        cuda_lib.reset_launches()
        timed = run_pool(pool, specs, False, replicas)
        launches = dict(cuda_lib.LAUNCHES)
        for kname in ("norm", "flash_attention_packed",
                      "flash_attention_packed_plan", "flash_decode_paged",
                      "sample"):
            if launches.get(kname, 0) <= 0:
                raise AssertionError(f"serve_pool: kernel {kname} never "
                                     f"launched: {launches}")
        rerun = run_pool(pool, specs, False, replicas)
        timed_counters = pool.metrics()["counters"]
        killed = run_pool(pool, specs, True, replicas)
        c = pool.metrics()["counters"]
        served = [replica_cells(pool.replica(i)) for i in range(2)]
        prefix = [pool.replica(i).backend.prefix_stats() for i in range(2)]
        peak = torch.cuda.max_memory_allocated(dev)
        health = pool.health()
        pool.close()
        victim = killed["victim"]
        moved = [i for i, (a, b) in enumerate(zip(killed["placed"],
                                                  killed["final"]))
                 if a == victim and b != victim]
        resub = c["pool.failover_resubmitted"] - \
            timed_counters.get("pool.failover_resubmitted", 0)
        if not killed["lost"] or not moved or len(moved) != resub or \
                c["pool.failed_sessions"] != len(killed["lost"]) or \
                any(killed["results"][i] is None for i in moved) or \
                health[victim]["state"] != "dead":
            raise AssertionError(
                f"serve_pool: kill of replica {victim} (at {killed['at_kill']}"
                f"): {len(killed['lost'])} lost, failed over {moved}, "
                f"counters {c}, health {health}")
        for (_, prompt, params), res in zip(
                specs * 3, killed["results"] + timed["results"] +
                rerun["results"]):
            if res is not None and (
                    res[:len(prompt)] != prompt or
                    len(res) - len(prompt) != params.max_new_tokens):
                raise AssertionError("serve_pool: bad result")
        del pool, replicas
        release_memory()

        # ---- one replica on the same requests, and the alone runs ------
        single = TurboClient.from_arch("internlm2-1.8b", device=dev,
                                       prefix_cache=True,
                                       auto_pump="thread", **POOL_CLIENT)
        one = ReplicaPool([single])
        alone_timed = run_pool(one, specs, False, [single])
        alone_rerun = run_pool(one, specs, False, [single])
        one.close()
        engine = single.backend.engine
        prompts = [p for _, p, _ in specs]
        seams = [n or 512 for n in killed["cached_tokens"]]
        drift = {"packed": packed_logit_drift(engine, prompts, POOL_SLOTS),
                 "suffix": suffix_logit_drift(engine, prompts, seams),
                 "decode_b4_vs_b1": decode_shape_drift(engine, prompts[:4])}
        dlogit = max(d for d, _ in drift.values())
        cache = {}
        rule = {name: alone_streams(f"serve_pool {name}", engine, specs,
                                    run["results"], dlogit, cache)
                for name, run in (("timed", timed), ("rerun", rerun),
                                  ("killed", killed),
                                  ("one_replica", alone_timed),
                                  ("one_replica_rerun", alone_rerun))}

        def run_line(run):
            return {k: run[k] for k in (
                "placed", "final", "serve_s", "generated_tokens",
                "tok_per_s", "ttft_p50_s", "ttft_p99_s",
                "captured_while_serving", "capture_s_while_serving")}
        emit({"phase": "serve_pool", "card": card,
              "model": "internlm2-1.8b x 2 replicas on one card (full "
                       "width, 24 layers, bf16 weights from a seed read by "
                       "both, f32 KV, prefix cache, packed admission, "
                       "thread-pumped, sanitizer on)",
              "slots_per_replica": POOL_SLOTS,
              "requests": len(specs),
              "kinds": {k: sum(1 for s in specs if s[0] == k)
                        for k in ("cohort0", "cohort1", "cold")},
              "sampled": sum(1 for s in specs if s[2].temperature > 0),
              "stack_build_s": build_s,
              "timed": run_line(timed),
              "one_replica_same_requests": run_line(alone_timed),
              "pool_over_one_replica_tok_per_s":
                  timed["tok_per_s"] / alone_timed["tok_per_s"],
              "rerun_warm_caches": run_line(rerun),
              "one_replica_rerun_warm_caches": run_line(alone_rerun),
              "pool_over_one_replica_tok_per_s_rerun":
                  rerun["tok_per_s"] / alone_rerun["tok_per_s"],
              "killed": dict(run_line(killed), victim=victim,
                             victim_sessions_at_kill=killed["at_kill"],
                             lost_mid_decode=killed["lost"],
                             failed_over=moved,
                             ownership_checks=killed["ownership_checks"],
                             ticks_while_checked=killed[
                                 "ticks_while_checked"]),
              "pool_counters": {k: v for k, v in c.items()
                                if k.startswith("pool.")},
              "prefix_stats_by_replica": prefix,
              "cached_tokens_killed_run": killed["cached_tokens"],
              "cells_by_replica": {"after_warmup_aot": warm,
                                   "after_serving": served},
              "captures_that_waited_for_the_gate":
                  graphs.DEVICE_GATE.captures_waited - gate0[0],
              "their_gate_wait_s": graphs.DEVICE_GATE.wait_seconds - gate0[1],
              "drift_max_abs_dlogit_and_bf16_ulps": drift,
              "streams": rule,
              "peak_mem_gib": peak / 2 ** 30,
              "launches_timed_run": launches})
        del one, single, engine, timed, rerun, killed, alone_timed, \
            alone_rerun
        release_memory()

        # ---- (b) background warm-up while serving ----------------------
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        client = TurboClient.from_arch("internlm2-1.8b", device=dev,
                                       warmup="background",
                                       auto_pump="thread", **POOL_CLIENT)
        early = [3, 6, 0, 1]           # two cold, two cohort prompts
        handles, submit_s = [], []
        for i in early:                # a submit waits for a round's end
            t1 = time.perf_counter()
            handles.append(client.submit(specs[i][1], specs[i][2]))
            submit_s.append(time.perf_counter() - t1)
        submitted_during = not client.warmup_stats["done"]
        rounds_at_submit = client.warmup_stats.get("rounds_completed")
        results = [h.result(timeout=POOL_PHASE_LIMIT_S) for h in handles]
        first_tokens = [h.ttft for h in handles]
        stats = client.wait_warmup(timeout=POOL_PHASE_LIMIT_S)
        warm_s = time.perf_counter() - t0
        client.close()
        engine = client.backend.engine
        if not submitted_during or not stats.get("done") or \
                stats.get("error") is not None or \
                stats["rounds_completed"] != stats["rounds"]:
            raise AssertionError(f"serve_pool background warm-up: {stats}, "
                                 f"submitted during it: {submitted_during}")
        bg_rule = alone_streams("serve_pool background", engine, specs,
                                results, dlogit, cache, indices=early)
        emit({"phase": "serve_pool_background_warmup", "card": card,
              "requests_before_warmup_end": len(early),
              "warmup": {k: stats.get(k) for k in (
                  "rounds", "rounds_completed", "warmup_seconds",
                  "compile_count", "done", "error")},
              "build_to_warm_s": warm_s,
              "submit_call_s": submit_s,
              "ttft_s_from_the_handle": first_tokens,
              "rounds_done_after_the_submits": rounds_at_submit,
              "cells_captured_total": engine.compile_count,
              "cells_captured_outside_the_walk":
                  engine.compile_count - stats["compile_count"],
              "streams": bg_rule,
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
        del client, engine, handles, results
        release_memory()
    finally:
        if sanitize_was is None:
            os.environ.pop("TURBO_SANITIZE", None)
        else:
            os.environ["TURBO_SANITIZE"] = sanitize_was

    # ---- (c) the simulator on the card's cost table -------------------
    simulator_vs_card(card, classified)

    # ---- (d) the serving CLI --------------------------------------------
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--no-smoke",
           "--replicas", "2", "--num-requests", "16", "--gen-requests", "6",
           "--max-new-tokens", "16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=POOL_PHASE_LIMIT_S,
                          env=dict(os.environ, PYTHONPATH=str(root / "src")))
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    emit({"phase": "serve_pool_cli", "card": card, "command": " ".join(
              ["python -m repro_torch.launch.serve"] + cmd[3:]),
          "rc": proc.returncode, "seconds": cli_s, "stdout_tail": lines[-8:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    if proc.returncode != 0 or not any("6 finished / 0 failed" in ln
                                       for ln in lines):
        raise AssertionError(f"serve_pool: the CLI gave rc "
                             f"{proc.returncode}")
    emit({"phase": "serve_pool_seconds", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return launches


def simulator_vs_card(card: str, classified: dict) -> None:
    """(c): ``simulate`` under nobatch, naive and dp with the classify
    phase's cost table (measured on the card), on that phase's own
    requests (the same arrivals and lengths) and on the simulator's
    Poisson draw at the same rate and lengths, beside the phase's
    measured resp/s and p99 latency (the paper's §6.3 comparison)."""
    from repro_torch.core import SimConfig, Workload, simulate
    from repro_torch.runtime.session import Session
    reqs = classified["requests"]
    rate = classified["rate"]
    duration = len(reqs) / rate

    class Replayed(Workload):
        def generate_sessions(self):
            return [Session(req_id=r.req_id, seq_len=r.seq_len,
                            arrival_time=r.arrival_time) for r in reqs]

    out = {}
    for policy in ("nobatch", "naive", "dp"):
        row = {"measured_on_card": classified["measured"][policy]}
        for name, wl in (("same_requests", Replayed(
                rate=rate, duration=duration, len_min=5, len_max=500)),
                         ("poisson_draw", Workload(
                             rate=rate, duration=duration, len_min=5,
                             len_max=500, seed=0))):
            res = simulate(wl, classified["cost"],
                           SimConfig(policy=policy, max_batch_size=20))
            lats = [r.latency for r in res.responses]
            end = max(r.finish_time for r in res.responses)
            row[name] = {"requests": len(res.responses),
                         "resp_per_s": len(res.responses) / end,
                         "latency_p99_s": float(np.percentile(lats, 99)),
                         "batches": len(res.batch_log)}
        out[policy] = row
    emit({"phase": "serve_pool_simulator", "card": card,
          "cost_model": "BucketedCostModel over the classify phase's "
                        "warm-up table (lengths 32, 128, 512 x batches 1, "
                        "4, 16), measured on the card",
          "rate_per_s": rate, "lengths": "uniform 5-500",
          "max_batch": 20, "policies": out})


# ---------------------------------------------------------------------------
# Phase 10: training at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"
#: (a)'s microbatch, and (b)'s batch (two microbatches of 4 x 512)
TRAIN_GRAD_BATCH = (4, 512)
TRAIN_BATCH = (8, 512)
TRAIN_ACCUM = 2
TRAIN_STEPS = 6
#: (a): how close each gradient leaf through the kernels (bf16 compute)
#: must lie to the same leaf in f32 compute (through the plain
#: versions), as a multiple of the distance of the plain versions' bf16
#: gradient to it; and the loss's relative distance to the plain run's
TRAIN_GRAD_FLOOR_RATIO = 1.5
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_WHY = (
    "bf16 compute sets a floor: a bf16 gradient differs from the f32 one "
    "by rounding at every op of 24 layers, and the kernels round at other "
    "points than the plain versions, so their two bf16 gradients differ by "
    "about that floor (1e-2 to 2.5e-2 a leaf on an NVIDIA H100 80GB HBM3), "
    "which a fixed relative bound would mistake for an error; the kernels "
    "pass where their gradient is no further from the f32 one than 1.5 "
    "times the plain versions' bf16 gradient is")
#: the Functions alone: their gradients against autograd through the
#: plain versions on the same inputs
TRAIN_NORM_WHY = ("bf16 norm: the Function computes its gradient in f32 "
                  "from the inputs and rounds once, autograd through the "
                  "plain version rounds at its bf16 ops: within 2 bf16 ulps "
                  "of each leaf's largest gradient")
TRAIN_SOFTMAX_TOL = dict(atol=1e-5, rtol=1e-5)
#: (d): the crash and resume drill
RESUME_LAYERS = 2
RESUME_STEPS = 6
RESUME_EVERY = 2
RESUME_FAIL_AT = 4
#: the profiler ranges of a train step that (c) lists apart
TRAIN_RANGES = ("repro_torch.norm_backward", "repro_torch.softmax_backward",
                "repro_torch.optimizer")


def leaf_paths(tree, prefix: str = "") -> list:
    """The '/'-joined paths of a nested dict's leaves in sorted-key order
    (`repro_torch.training.optimizer.tree_leaves`' order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                    else k)]
    return [prefix]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    d = float(torch.linalg.vector_norm((got.float() - want.float())))
    return d / max(float(torch.linalg.vector_norm(want.float())), 1e-30)


def backward_ms(fn, leaves, ups, iters: int = 10) -> float:
    """Mean milliseconds of one backward of ``fn(*leaves)`` (CUDA events
    around ``iters`` backwards of one retained graph)."""
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * u).sum() for o, u in zip(outs, ups))
    torch.autograd.grad(loss, leaves, retain_graph=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        torch.autograd.grad(loss, leaves, retain_graph=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def function_grads(fn, leaves, ups):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * u).sum() for o, u in zip(outs, ups))
    return torch.autograd.grad(loss, leaves)


def train_function_checks(dev, gen, card: str) -> None:
    """Each kernel's Function alone at the train path's shapes, its
    gradient against autograd through the plain version on the same
    inputs and upstream gradient: the norm at a microbatch's rows (R
    2048 x C 2048, bf16, with a residual and the sum returned, norm2's
    call), the softmax at its scores (R 32768 = 4 x 16 heads x 512
    queries, C 512, f32, causal lengths, the 1/sqrt(128) scale)."""
    from repro_torch.kernels import cuda_lib, ops, ref
    r = c = 2048
    x, res = (torch.randn((r, c), generator=gen, device=dev).bfloat16()
              for _ in range(2))
    gamma = (torch.rand((c,), generator=gen, device=dev) + 0.5).bfloat16()
    ups = [torch.randn((r, c), generator=gen, device=dev) for _ in range(2)]
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, res)]
    kern = lambda x, g, rr: ops.fused_rmsnorm(  # noqa: E731
        x, g, None, rr, return_residual=True)
    plain = lambda x, g, rr: ref.rmsnorm_ref(  # noqa: E731
        x, g, None, rr, 1e-6, True)
    cuda_lib.reset_launches()
    got = function_grads(kern, leaves, ups)
    launched = cuda_lib.LAUNCHES["norm"]
    want = function_grads(plain, leaves, ups)
    errs = {name: float((a.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for name, a, w in zip(("x", "gamma", "residual"), got, want)}
    norm = {"shape": f"R {r} x C {c}, bf16, residual, sum returned",
            "launches": launched,
            "max_err_over_largest": errs, "tolerance": 2 * 2 ** -8,
            "why": TRAIN_NORM_WHY,
            "backward_ms": backward_ms(kern, leaves, ups),
            "plain_backward_ms": backward_ms(plain, leaves, ups)}
    rs, cs = 4 * 16 * 512, 512
    scores = torch.randn((rs, cs), generator=gen, device=dev) * 8
    lengths = (torch.arange(rs, device=dev, dtype=torch.int32) % cs) + 1
    sup = [torch.randn((rs, cs), generator=gen, device=dev)]
    sleaf = [scores.clone().requires_grad_(True)]
    scale = 1.0 / math.sqrt(128)
    skern = lambda t: ops.fused_softmax(t, lengths, scale=scale)  # noqa
    splain = lambda t: ref.softmax_ref(t, lengths, scale)  # noqa: E731
    cuda_lib.reset_launches()
    (sgot,) = function_grads(skern, sleaf, sup)
    slaunched = cuda_lib.LAUNCHES["softmax"]
    (swant,) = function_grads(splain, sleaf, sup)
    soft = {"shape": f"R {rs} x C {cs}, f32, causal lengths, scale "
                     f"{scale:.6f}", "launches": slaunched,
            "max_abs_err": float((sgot - swant).abs().max()),
            "tolerance": TRAIN_SOFTMAX_TOL,
            "backward_ms": backward_ms(skern, sleaf, sup),
            "plain_backward_ms": backward_ms(splain, sleaf, sup)}
    emit({"phase": "train_functions", "card": card, "norm": norm,
          "softmax": soft})
    if launched != 1 or slaunched != 1:
        raise AssertionError(f"train_functions: launches {launched} norm, "
                             f"{slaunched} softmax (1 each expected)")
    if max(errs.values()) > 2 * 2 ** -8:
        raise AssertionError(f"train_functions: norm gradients {errs}")
    torch.testing.assert_close(sgot, swant, **TRAIN_SOFTMAX_TOL)


def train_grad_check(dev, card: str) -> None:
    """(a) Full-width, full-depth InternLM2-1.8B (f32 master weights from
    a seed): one microbatch of 4 x 512 in bf16 compute through the kernels
    (their Functions' gradients), again under ``plain_versions``
    (autograd through the plain versions), and in f32 compute under
    ``plain_versions``, the yardstick.  Each leaf's gradient through the
    kernels must lie within ``TRAIN_GRAD_FLOOR_RATIO`` times the plain bf16
    gradient's distance of the f32 one, and the loss within
    ``TRAIN_LOSS_REL`` of the plain run's; the kernels' run must launch
    49 norms and 24 softmaxes."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.training import TrainConfig
    from repro_torch.training.train_loop import loss_and_grads
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig()
    params = init_params(cfg, seed=SEED, device=dev, param_dtype="float32")
    batch = TokenStream(cfg, *TRAIN_GRAD_BATCH, seed=SEED,
                        device=dev).batch(0)
    rt = ModelRuntime()
    loss_and_grads(cfg, tc, rt, params, batch)        # warm (cuBLAS, ...)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t1 = time.perf_counter()
    loss_k, _, grads_k = loss_and_grads(cfg, tc, rt, params, batch)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t1
    launches = dict(cuda_lib.LAUNCHES)
    with plain_versions():
        t1 = time.perf_counter()
        loss_p, _, grads_p = loss_and_grads(cfg, tc, rt, params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        loss_f, _, grads_f = loss_and_grads(
            cfg, TrainConfig(compute_dtype="float32"), rt, params, batch)
    paths = leaf_paths(params)
    errs = {p: {"kernels_to_plain": rel_err(k, pl),
                "kernels_to_f32": rel_err(k, f),
                "plain_to_f32": rel_err(pl, f)}
            for p, k, pl, f in zip(paths, grads_k, grads_p, grads_f)}
    ratio = {p: e["kernels_to_f32"] / e["plain_to_f32"]
             for p, e in errs.items()}
    worst = max(ratio, key=ratio.get)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    emit({"phase": "train_grad_check", "card": card,
          "model": model_line(TRAIN_ARCH, cfg).replace(
              "bf16 weights from a seed, f32 KV",
              "f32 master weights from a seed, bf16 compute"),
          "microbatch": list(TRAIN_GRAD_BATCH), "loss": float(loss_k),
          "plain_loss": float(loss_p), "f32_loss": float(loss_f),
          "loss_rel_err": loss_err, "loss_tolerance": TRAIN_LOSS_REL,
          "worst_ratio_to_the_plain_floor": {worst: ratio[worst]},
          "ratio_limit": TRAIN_GRAD_FLOOR_RATIO,
          "grad_rel_err_by_leaf": errs, "why": TRAIN_GRAD_WHY,
          "launches": launches, "fwd_bwd_s": kern_s,
          "plain_fwd_bwd_s": plain_s,
          "phase_s": time.perf_counter() - t0})
    want = {"norm": norms_per_pass(cfg), "softmax": cfg.num_layers}
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"train_grad_check: launches {launches}, "
                             f"expected {want}")
    if loss_err > TRAIN_LOSS_REL or ratio[worst] > TRAIN_GRAD_FLOOR_RATIO:
        raise AssertionError(f"train_grad_check: loss {loss_err}, {worst} "
                             f"{errs[worst]}")
    if any(not bool(torch.isfinite(g).all()) or not bool(g.any())
           for g in grads_k):
        raise AssertionError("train_grad_check: a gradient leaf is zero "
                             "or not finite")


def ranged_device_us(prof, ranges) -> dict:
    """The device time of the kernels that the ops inside each profiler
    range launched (an op's kernels are joined to it by the profiler's
    correlation ids; a kernel launched outside any PyTorch op, as the
    port's ``ctypes`` kernels are, joins none)."""
    out = dict.fromkeys(ranges, 0.0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or \
                not evt.kernels:
            continue
        node = evt
        while node is not None and node.name not in out:
            node = node.cpu_parent
        if node is not None:
            out[node.name] += sum(k.duration for k in evt.kernels)
    return out


def train_timed(dev, card: str) -> dict:
    """(b) ``Trainer`` at full width and depth, AdamW, batch 8 x 512 in
    two microbatches, ``TRAIN_STEPS`` steps: seconds a step (median of
    steps 2 to 6), tokens a second, peak memory, each step's loss and
    gradient norm, and the norm and softmax launches a microbatch (49 and
    24 with ``remat="none"``).  Then two steps on one batch (the second's
    loss must be lower) and (c) one more step profiled: its device busy
    time by kernel family, the backward's norm and softmax gradients and
    the optimizer apart, and its idle share.  Returns the timed run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      Trainer, make_train_step)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig(optimizer=OptimizerConfig(), grad_accum=TRAIN_ACCUM,
                     log_every=1)
    b, s = TRAIN_BATCH
    trainer = Trainer(cfg, tc, batch_size=b, seq_len=s, seed=SEED,
                      device=dev)
    stamps, log = [], []

    def on_metrics(step, m):          # float() of the metrics synchronises
        stamps.append(time.perf_counter())
        log.append({"step": step, "loss": m["loss"],
                    "grad_norm": m["grad_norm"]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    state = trainer.run(TRAIN_STEPS, on_metrics=on_metrics)
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_s = [b2 - a2 for a2, b2 in zip(stamps, stamps[1:])]
    med = float(np.median(step_s))
    micro = TRAIN_STEPS * TRAIN_ACCUM
    per_micro = {k: launches.get(k, 0) / micro for k in ("norm", "softmax")}
    # two steps on one batch: the second's loss (after one update) lower
    step = make_train_step(cfg, tc)
    batch = trainer.data_for_step(TRAIN_STEPS)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    repeat = [float(m1["loss"]), float(m2["loss"])]
    # (c) one step profiled
    prof, wall_ms, plaunch, (busy_us, kernels, _), check, _ = traced_window(
        lambda: step(state, batch))
    ranged = ranged_device_us(prof, TRAIN_RANGES)
    busy = sum(busy_us.values())
    ranged_ms = {k: v / 1e3 for k, v in ranged.items()}
    other = busy_us.get("other PyTorch kernels", 0.0) - sum(ranged.values())
    emit({"phase": "train", "card": card,
          "model": model_line(TRAIN_ARCH, cfg).replace(
              "bf16 weights from a seed, f32 KV",
              "f32 master weights, AdamW m and v, bf16 compute"),
          "batch": list(TRAIN_BATCH), "grad_accum": TRAIN_ACCUM,
          "steps": TRAIN_STEPS, "step_s": step_s,
          "step_s_median_2_to_6": med, "tokens_per_s": b * s / med,
          "peak_mem_gib": peak, "log": log,
          "launches": launches, "launches_per_microbatch": per_micro,
          "repeated_batch_losses": repeat,
          "profile_one_step": {
              "wall_ms": wall_ms, "busy_ms": busy_or_not_measured(
                  busy / 1e3, check),
              "busy_ms_by_family": {k: v / 1e3 for k, v in busy_us.items()},
              "of_which_ranges_ms": ranged_ms if sum(ranged.values())
              else "not measured: no kernel joined to a range",
              "other_pytorch_outside_the_ranges_ms": other / 1e3,
              "idle_share": busy_or_not_measured(1 - busy / 1e3 / wall_ms,
                                                 check),
              **in_trace(busy_us, 1, check, wall_ms),
              "launches": plaunch, "trace_check": check},
          "phase_s": time.perf_counter() - t0})
    want = {"norm": norms_per_pass(cfg), "softmax": cfg.num_layers}
    if any(per_micro[k] != v for k, v in want.items()):
        raise AssertionError(f"train: {per_micro} launches a microbatch, "
                             f"expected {want}")
    if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
               for x in log):
        raise AssertionError(f"train: {log}")
    if not repeat[1] < repeat[0]:
        raise AssertionError(f"train: a repeated batch's loss went "
                             f"{repeat[0]} -> {repeat[1]}")
    return launches


def train_resume(dev, card: str) -> None:
    """(d) The crash and resume drill at full width and 2 layers,
    Adafactor, batch 4 x 512: ``RESUME_STEPS`` steps with a checkpoint
    every ``RESUME_EVERY``, uninterrupted; again with a failure injected
    at step ``RESUME_FAIL_AT``, then resumed from its checkpoint.  The
    parameters and optimizer state must equal the uninterrupted run's bit
    for bit.  Prints a checkpoint's bytes and the seconds of a
    synchronous write.  Checkpoints go under ``build/`` in the checkout
    and are removed."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.training import OptimizerConfig, TrainConfig, Trainer
    from repro_torch.training.optimizer import tree_leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=RESUME_LAYERS)
    root = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, fail_at=None):
        tc = TrainConfig(optimizer=OptimizerConfig(name="adafactor"),
                         checkpoint_dir=str(root / name),
                         checkpoint_every=RESUME_EVERY, keep_last=1,
                         log_every=100)
        return Trainer(cfg, tc, batch_size=4, seq_len=512, seed=SEED,
                       fail_at_step=fail_at, device=dev)
    try:
        ref = trainer("uninterrupted").run(RESUME_STEPS)
        shutil.rmtree(root / "uninterrupted")
        try:
            trainer("crashed", RESUME_FAIL_AT).run(RESUME_STEPS)
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("train_resume: no failure was injected")
        deadline = time.time() + 120
        while time.time() < deadline and \
                ckpt.available_steps(str(root / "crashed")) != \
                [RESUME_FAIL_AT]:
            time.sleep(0.2)
        survived = ckpt.available_steps(str(root / "crashed"))
        t1 = time.perf_counter()
        resumed = trainer("crashed").run(RESUME_STEPS)
        resume_s = time.perf_counter() - t1
        a = tree_leaves({"params": ref["params"], "opt": ref["opt"]})
        b = tree_leaves({"params": resumed["params"],
                         "opt": resumed["opt"]})
        differ = [p for p, x, y in zip(
            leaf_paths({"params": ref["params"], "opt": ref["opt"]}), a, b)
            if not torch.equal(x, y)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = ckpt.save(str(root / "timed"), RESUME_STEPS, resumed)
        write_s = time.perf_counter() - t1
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        emit({"phase": "train_resume", "card": card,
              "model": f"{TRAIN_ARCH} at full width, {RESUME_LAYERS} "
                       "layers, Adafactor, batch 4 x 512",
              "steps": RESUME_STEPS, "checkpoint_every": RESUME_EVERY,
              "failure_at": RESUME_FAIL_AT,
              "checkpoints_after_the_crash": survived,
              "resumed_at_step": int(resumed["step"]),
              "leaves": len(a), "leaves_not_bit_equal": differ,
              "resume_run_s": resume_s, "checkpoint_bytes": nbytes,
              "checkpoint_write_s": write_s,
              "phase_s": time.perf_counter() - t0})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if survived != [RESUME_FAIL_AT] or int(resumed["step"]) != RESUME_STEPS:
        raise AssertionError(f"train_resume: checkpoints {survived}, "
                             f"resumed to {int(resumed['step'])}")
    if differ:
        raise AssertionError(f"train_resume: {len(differ)} leaves differ "
                             f"from the uninterrupted run: {differ[:5]}")


def train_cli(card: str) -> None:
    """(e) ``python -m repro_torch.launch.train`` at full width in a
    subprocess: rc 0 and its final line."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--steps", "2", "--batch", "2", "--seq", "128"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(root / "src")))
    lines = proc.stdout.strip().splitlines()
    emit({"phase": "train_cli", "card": card, "command": " ".join(
              ["python -m repro_torch.launch.train"] + cmd[3:]),
          "rc": proc.returncode, "seconds": time.perf_counter() - t0,
          "stdout_tail": lines[-4:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    if proc.returncode != 0 or not any(ln.startswith("done at step 2")
                                       for ln in lines):
        raise AssertionError(f"train_cli: rc {proc.returncode}")


def train_phase(dev, card: str) -> dict:
    """Phase 10 (after every serving phase, every client freed): the
    kernels' Functions alone, (a) the gradient check, (b) the timed
    trainer with (c) its profiled step, (d) the crash and resume drill,
    (e) the CLI.  Returns (b)'s launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    train_function_checks(dev, gen, card)
    release_memory()
    train_grad_check(dev, card)
    release_memory()
    launches = train_timed(dev, card)
    release_memory()
    train_resume(dev, card)
    release_memory()
    train_cli(card)
    emit({"phase": "train_seconds", "card": card,
          "seconds": time.perf_counter() - t0})
    return launches


#: the examples, each run in-process through ``main(argv)`` on the card:
#: its arguments, and the launch counters (of `cuda_lib.LAUNCHES`) that
#: its path reaches and that must each be above 0
EXAMPLES = (
    # classify (the masked softmax), generate (causal prefill, paged
    # decode): the reduced config's dh 16 has no attention kernel
    ("quickstart", ["--no-smoke"],
     ("norm", "softmax", "flash_attention", "flash_decode_paged")),
    # the reduced config: its train path runs only the norm and softmax
    # kernels, which take its widths; a full-width checkpoint is 22.7 GB
    ("train_small", [], ("norm", "softmax")),
    # classify, packed admission, paged decode, a sampled request
    ("serve_e2e", ["--no-smoke"],
     ("norm", "softmax", "flash_attention_packed",
      "flash_attention_packed_plan", "flash_decode_paged", "sample")),
    # a plain-PyTorch encoder traced in fake mode: no kernel of the port
    ("allocator_scheduler_demo", [], ()),
)


def example_module(root: Path, name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", root / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def example_result(name: str, out) -> dict:
    """What an example returned, checked: the facts its line prints."""
    if name == "quickstart":
        labels, gens, engine = out
        facts = {"labels": labels, "generated": gens,
                 "compile_count": engine.compile_count,
                 "kv_live_bytes": engine.kv_slab.live_bytes}
        ok = len(labels) == 3 and [len(g) for g in gens] == [11, 13] and \
            engine.kv_slab.live_bytes == 0
    elif name == "train_small":
        facts = {"bitwise_identical": out}
        ok = out is True
    elif name == "serve_e2e":
        facts = {"one_shot_answered": len(out["one_shot"]),
                 "one_shot_requests": out["one_shot_requests"],
                 "generative_lengths": {k: len(v) for k, v in
                                        out["generative"].items()},
                 "prefix": {k: out["prefix"][k] for k in ("hits", "cold",
                                                          "hot")},
                 "client": out["client"], "pool": out["pool"]}
        ok = len(out["one_shot"]) == out["one_shot_requests"] and \
            all(r is not None for r in out["one_shot"].values()) and \
            [len(out["generative"][i]) for i in (0, 1)] == [30, 11] and \
            out["pool"]["finished"] + out["pool"]["lost"] == \
            out["pool"]["submitted"]
    else:
        facts = {"footprints": out["footprints"],
                 "dp_ms": out["dp"][0] * 1e3, "naive_ms": out["naive"][0] * 1e3,
                 "nobatch_ms": out["nobatch"][0] * 1e3}
        turbo = [f[2] for f in out["footprints"]]
        ok = turbo[-1] < turbo[2] and \
            out["dp"][0] < min(out["naive"][0], out["nobatch"][0])
    return {"facts": facts, "ok": ok}


def examples_phase(dev, card: str) -> dict:
    """Each example of ``examples/torch`` through its ``main(argv)`` in
    this process, on the card (``--device`` defaults to cuda), with the
    launch counters set to 0 just before it: every kernel its path
    reaches must launch.  train_small's checkpoints are recorded (the
    trainer writes them in the background) to show one lands before the
    injected failure.  Returns the launches summed over the examples."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.runtime import checkpoint as ckpt
    root = Path(__file__).resolve().parent
    work = root / "build" / "examples"
    work.mkdir(parents=True, exist_ok=True)
    total: dict = {}
    t_phase = time.perf_counter()
    for name, argv, reach in EXAMPLES:
        mod = example_module(root, name)
        saved, save_async = [], ckpt.save_async

        def record_save(directory, step, *args, **kwargs):
            saved.append(step)
            return save_async(directory, step, *args, **kwargs)
        ckpt.save_async = record_save
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.chdir(work):
                out = mod.main(argv)
            torch.cuda.synchronize()
        finally:
            ckpt.save_async = save_async
        seconds = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        result = example_result(name, out)
        line = {"phase": "examples", "card": card, "example": name,
                "argv": argv, "seconds": seconds, "launches": launches,
                "reaches": list(reach), **result}
        if name == "train_small":
            line["checkpoints_written"] = saved
        emit(line)
        missing = [k for k in reach if not launches.get(k)]
        if missing or not result["ok"]:
            raise AssertionError(f"examples: {name}: kernels not launched "
                                 f"{missing}, result ok {result['ok']}")
        if name == "train_small" and not (saved and min(saved) < 100):
            raise AssertionError(f"examples: train_small wrote no "
                                 f"checkpoint before its failure: {saved}")
        del out, mod
        release_memory()
    emit({"phase": "examples_seconds", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return total


#: the dry run held against the card: the arch, and the card's own steps
#: (kind, S, B): a padded prefill (B 8 x 1024), the decode tick's 8 rows
#: over 1024 positions, the train step (8 x 512 in two microbatches)
DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_CHIP_SHAPES = (("prefill", 1024, 8), ("decode", 1024, 8),
                      ("train", 512, 8))
#: the dry run's FLOPs against FlopCounterMode's on the real step
DRYRUN_FLOPS_REL = 1e-3
#: timed repetitions of each step (CUDA events)
DRYRUN_REPS = {"prefill": 5, "decode": 50, "train": 3}
#: the kernels each step must launch
DRYRUN_KERNELS = {"prefill": ("norm", "flash_attention"),
                  "decode": ("norm", "flash_decode"),
                  "train": ("norm", "softmax")}
DRYRUN_WAIT_S = 600


def card_cell(kind: str, s: int, b: int):
    """The dry run's cell of one of the card's steps; the train step with
    the train phase's runtime (``ModelRuntime()``: no remat), as the
    card runs it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import ModelRuntime
    return dryrun.build_cell(DRYRUN_ARCH,
                             ShapeConfig(f"card_{kind}", kind, s, b),
                             rt=ModelRuntime() if kind == "train" else None)


def dryrun_dir() -> Path:
    return Path(__file__).resolve().parent / "build" / "dryrun_chip"


def dryrun_worker(out: str) -> int:
    """The dry run's CPU half, in a process of its own while the card's
    phases run: the arch's global shapes through the CLI, then a record
    of each of the card's shapes.  Fake tensors only: no card, no device
    memory.  Pinned to one CPU, so the card's phases keep the others."""
    import os

    from repro_torch.launch import dryrun
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    rc = dryrun.main(["--arch", DRYRUN_ARCH, "--shape", "all", "--out", out,
                      "--force"])
    rc = rc or dryrun.main(["--arch", DRYRUN_ARCH, "--shape", "all",
                            "--mesh", "single", "--out", out, "--force"])
    for kind, s, b in DRYRUN_CHIP_SHAPES:
        rec = dryrun.run_cell(card_cell(kind, s, b), ops_path=str(
            Path(out) / f"card_{kind}.ops.json.gz"))
        with open(Path(out) / f"card_{kind}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return rc


def start_dryrun_worker(root: Path):
    import os
    import shutil
    out = dryrun_dir()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    log = open(out / "worker.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.dryrun_worker(sys.argv[1]))", str(out)],
        cwd=root, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    log.close()
    return proc


def record_line(rec: dict) -> dict:
    m, r = rec["memory"], rec["roofline"]
    return {"params": rec["params"], "global_batch": rec["global_batch"],
            "seq_len": rec["seq_len"], "ops": rec["ops"],
            "trace_s": rec["trace_s"],
            "flops": rec["cost"]["flops_per_device"],
            "flops_by_class": rec["cost"]["flops_by_class"],
            "hbm_bytes": rec["cost"]["bytes_per_device"],
            "memory_gb": {k: v / 1e9 for k, v in m.items()},
            "fits_hbm80": rec["fits_hbm80"],
            "model_flops": r["model_flops"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "t_compute_ms": r["t_compute_s"] * 1e3,
            "t_memory_ms": r["t_memory_s"] * 1e3,
            "bound_ms": r["step_time_bound_s"] * 1e3,
            "dominant": r["dominant"],
            "roofline_fraction": r["roofline_fraction"]}


def mesh_record_line(rec: dict) -> dict:
    """A mesh record's line: one rank's numbers and its collectives."""
    line = record_line(rec)
    line.update({"chips": rec["chips"], "mesh_shape": rec["mesh_shape"],
                 "seq_shard": rec["seq_shard"],
                 "collective_bytes": rec["collectives"]["bytes_by_type"],
                 "collective_counts": rec["collectives"]["counts"],
                 "collective_bytes_by_dim":
                     rec["collectives"]["bytes_by_dim"],
                 "links": {a["dim"]: a["link"] for a in
                           rec["collective_axes"].values()},
                 "t_collective_ms":
                     rec["roofline"]["t_collective_s"] * 1e3})
    return line


def flops_by_op(table) -> dict:
    """An op table's flops by op (``aten.mm``, ``repro_torch.fused_norm``,
    as ``FlopCounterMode`` names them)."""
    from repro_torch.launch import graph_analysis as ga
    out: dict = {}
    for row in table:
        flops = ga.row_cost(row)[0]
        if flops:
            op = row["op"].rsplit(".", 1)[0]
            out[op] = out.get(op, 0) + flops
    return out


def dryrun_vs_card(dev, card: str, kind: str, s: int, b: int,
                   rec: dict) -> dict:
    """One of the card's steps, run eager with the weights from a seed,
    beside the dry run's record of it: FlopCounterMode's count (the
    kernels one node each, `kernels.traced`, their formulas registered)
    against the record's; the predicted peak (arguments + temporaries)
    against ``max_memory_allocated`` after a reset, less what was
    allocated before the arguments were made (what earlier phases and
    the libraries hold); and the record's bound against the measured
    device time (CUDA events over back-to-back steps, and the profiler's
    busy time of one step)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.traced import traced_kernels
    from repro_torch.launch import graph_analysis as ga
    cell = card_cell(kind, s, b)
    release_memory()
    floor = torch.cuda.memory_allocated(dev)
    args = cell.inputs(dev, SEED)
    cell.fn(*args)                          # warm (cuBLAS, first launches)
    torch.cuda.synchronize()
    release_memory()                        # the warm step's garbage
    ga.register_flop_formulas()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cuda_lib.reset_launches()
    with traced_kernels(), FlopCounterMode(display=False) as counter:
        cell.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = dict(cuda_lib.LAUNCHES)
    flops = counter.get_total_flops()
    card_by_op = {str(k): v for k, v in
                  counter.get_flop_counts()["Global"].items()}
    reps = DRYRUN_REPS[kind]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        cell.fn(*args)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    _, wall_ms, _, (busy_us, _, _), check, _ = traced_window(
        lambda: cell.fn(*args))
    busy_ms = sum(busy_us.values()) / 1e3
    want = rec["cost"]["flops_per_device"]
    bound_ms = rec["roofline"]["step_time_bound_s"] * 1e3
    line = {"phase": "dryrun_vs_card", "card": card, "step": kind,
            "shape": {"B": b, "S": s},
            "flops": {"dry_run": want, "flop_counter_mode": flops,
                      "rel_diff": abs(flops - want) / want,
                      "limit": DRYRUN_FLOPS_REL},
            "memory_bytes": {
                "predicted_peak": rec["memory"]["peak_bytes"],
                "max_memory_allocated": peak,
                "allocated_before_the_arguments": floor,
                "measured_peak": peak - floor,
                "predicted_arguments": rec["memory"]["argument_bytes"],
                "measured_arguments": base - floor,
                "predicted_temporaries": rec["memory"]["temp_bytes"],
                "measured_temporaries": peak - base},
            "time_ms": {"bound": bound_ms, "bound_by":
                        rec["roofline"]["dominant"],
                        "events_mean": event_ms, "reps": reps,
                        "profiled_wall": wall_ms,
                        "profiled_busy": busy_or_not_measured(busy_ms,
                                                              check),
                        **in_trace(busy_us, 1, check, wall_ms)},
            "roofline_fraction": {
                "of_event_time": bound_ms / event_ms,
                "of_busy_time": bound_ms / busy_ms if busy_ms and
                check["trace_complete"] else "not measured",
                "model_flops_over_peak_of_event_time":
                    rec["roofline"]["model_flops"] / 989e12 * 1e3 / event_ms},
            "launches": launches}
    if flops != want:
        import gzip
        with gzip.open(dryrun_dir() / f"card_{kind}.ops.json.gz", "rt") as f:
            dry_by_op = flops_by_op(json.load(f))
        line["flops"]["by_op_where_they_differ"] = {
            op: {"dry_run": dry_by_op.get(op, 0),
                 "flop_counter_mode": card_by_op.get(op, 0)}
            for op in sorted(set(dry_by_op) | set(card_by_op))
            if dry_by_op.get(op, 0) != card_by_op.get(op, 0)}
    emit(line)
    missing = [k for k in DRYRUN_KERNELS[kind] if not launches.get(k)]
    if missing:
        raise AssertionError(f"dryrun {kind}: kernels not launched {missing}")
    if line["flops"]["rel_diff"] > DRYRUN_FLOPS_REL:
        raise AssertionError(f"dryrun {kind}: FLOPs {flops} against the dry "
                             f"run's {want}")
    return line


def dryrun_phase(dev, card: str, worker) -> None:
    """The dry run: its records of the arch's three global shapes at full
    width (the CPU worker started with the script), then each of the
    card's shapes held against its record (`dryrun_vs_card`)."""
    t0 = time.perf_counter()
    rc = worker.wait(timeout=DRYRUN_WAIT_S)
    waited = time.perf_counter() - t0
    out = dryrun_dir()
    tail = (out / "worker.log").read_text().strip().splitlines()[-8:]
    if rc != 0:
        raise AssertionError(f"dryrun worker rc {rc}: {tail}")
    records, mesh_records = {}, {}
    for path in sorted(out.glob(f"{DRYRUN_ARCH}_*_card.json")):
        with open(path) as f:
            rec = json.load(f)
        records[rec["shape"]] = record_line(rec)
    for path in sorted(out.glob(f"{DRYRUN_ARCH}_*_pod16x16.json")):
        with open(path) as f:
            rec = json.load(f)
        mesh_records[rec["shape"]] = mesh_record_line(rec)
    emit({"phase": "dryrun", "card": card, "arch": DRYRUN_ARCH,
          "constants": "H100 SXM data sheet: 989 TFLOP/s bf16, 67 f32, "
                       "3.35 TB/s HBM, 900 GB/s NVLink, 80 GB",
          "records": records, "worker_log_tail": tail,
          "waited_for_the_worker_s": waited})
    emit({"phase": "dryrun_mesh", "card": card, "arch": DRYRUN_ARCH,
          "mesh": "pod16x16", "per_device": True,
          "constants": "collectives at the slowest link of their group: "
                       "NVLink 900 GB/s inside an 8-GPU node, NDR "
                       "InfiniBand 50 GB/s a GPU across nodes (DGX H100 "
                       "data sheet)",
          "records": mesh_records})
    if sorted(records) != ["decode_32k", "prefill_32k", "train_4k"] or \
            sorted(mesh_records) != sorted(records):
        raise AssertionError(f"dryrun: records {sorted(records)}, mesh "
                             f"records {sorted(mesh_records)}")
    for kind, s, b in DRYRUN_CHIP_SHAPES:
        with open(out / f"card_{kind}.json") as f:
            rec = json.load(f)
        emit({"phase": "dryrun_card_shape", "card": card, "step": kind,
              "record": record_line(rec)})
        dryrun_vs_card(dev, card, kind, s, b, rec)
        release_memory()
    emit({"phase": "dryrun_seconds", "card": card,
          "seconds": time.perf_counter() - t0})


DIST_ARCH = "internlm2-1.8b"
DIST_PREFILL = (8, 1024)
DIST_DECODE_STEPS = 16
DIST_TRAIN = (8, 512)
DIST_ACCUM = 2
#: tensor parallelism the shard-local calls emulate, and the (arch, H, KV)
#: head shapes they split: InternLM2's replicated kv heads at 16, Qwen3-32B's
#: head offsets (64 / 8: four query heads over one kv head at 16)
DIST_TP = (2, 4, 8, 16)
DIST_HEADS = (("internlm2-1.8b", 16, 8), ("qwen3-32b", 64, 8))
#: the shard-local calls' batch and length (decode: cache length)
DIST_LOCAL = (8, 1024)


def _dist_tree_equal(a, b, path="") -> list:
    """Paths where two trees of tensors differ in any bit."""
    if isinstance(a, dict):
        return [p for k in a for p in _dist_tree_equal(a[k], b[k],
                                                       f"{path}/{k}")]
    return [] if torch.equal(a, b) else [path]


def _dist_full(x):
    from repro_torch.distributed.sharding import is_dtensor
    if isinstance(x, dict):
        return {k: _dist_full(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_dist_full(v) for v in x)
    return x.full_tensor() if is_dtensor(x) else x


def _dist_timed(fn):
    """(result, wall ms, launches) of one eager call, the launch counters
    set to 0 just before it."""
    from repro_torch.kernels import cuda_lib
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, dict(cuda_lib.LAUNCHES)


def distributed_phase(dev, card: str) -> dict:
    """The model functions over a (1, 1) mesh of a one-rank NCCL group
    against the same calls without it (see the module docstring, 13),
    then the shard-local kernel calls.  Returns the mesh runs' launches
    (prefill, decode steps and train step together)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import plan as dplan
    from repro_torch.distributed.sharding import make_rules, sharding_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      init_state, make_train_step)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro_dist_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        rules = make_rules(mesh)
        cfg = get_config(DIST_ARCH)
        params = init_params(cfg, seed=SEED, device=dev)
        b, s = DIST_PREFILL
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        toks = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)
        width = s + DIST_DECODE_STEPS
        mismatch, lines, total = [], {}, {}

        def run(label, fn, mesh_fn):
            plain, ms, launches = _dist_timed(fn)
            with sharding_rules(rules):
                meshed, ms_mesh, launches_mesh = _dist_timed(mesh_fn)
            for k, v in launches_mesh.items():
                total[k] = total.get(k, 0) + v
            lines[label] = {"wall_ms": ms, "wall_ms_mesh": ms_mesh,
                            "host_cost_ms": ms_mesh - ms,
                            "launches": launches,
                            "launches_mesh": launches_mesh}
            if launches != launches_mesh:
                mismatch.append(f"{label}: launches {launches} against "
                                f"{launches_mesh}")
            return plain, meshed

        with sharding_rules(rules):
            pp = dplan.distribute(params, dplan.to_shardings(
                rules, dplan.param_specs(rules, params)))
            tt = dplan.distribute({"t": toks}, dplan.to_shardings(
                rules, dplan.batch_specs(rules, {"t": toks})))["t"]
        (lg, cache), (lg_m, cache_m) = run(
            "prefill",
            lambda: prefill(cfg, params, toks, max_len=width),
            lambda: prefill(cfg, pp, tt, max_len=width))
        with sharding_rules(rules):
            lg_m, cache_m = _dist_full((lg_m, cache_m))
        if not torch.equal(lg, lg_m):
            mismatch.append("prefill logits")
        mismatch += [f"prefill cache {p}" for p in
                     _dist_tree_equal(cache, cache_m)]
        with sharding_rules(rules):
            c_spec, t_spec = dplan.decode_specs(rules, cfg, cache_m,
                                                lg.argmax(-1).int())
            cc = dplan.distribute(cache_m, dplan.to_shardings(rules, c_spec))
        nxt = lg.argmax(-1).to(torch.int32)
        steps = []
        for i in range(DIST_DECODE_STEPS):
            with sharding_rules(rules):
                nt = dplan.distribute({"t": nxt}, dplan.to_shardings(
                    rules, {"t": t_spec}))["t"]
            (lo, cache), (lo_m, cc) = run(
                f"decode_{i}",
                lambda: decode_step(cfg, params, cache, nxt),
                lambda: decode_step(cfg, pp, cc, nt))
            with sharding_rules(rules):
                lo_m = _dist_full(lo_m)
            if not torch.equal(lo, lo_m):
                mismatch.append(f"decode step {i} logits")
            steps.append(lines.pop(f"decode_{i}"))
            nxt = lo.argmax(-1).to(torch.int32)
        with sharding_rules(rules):
            cc = _dist_full(cc)
        mismatch += [f"decode cache {p}" for p in _dist_tree_equal(
            {k: cache[k] for k in ("k", "v", "len")},
            {k: cc[k] for k in ("k", "v", "len")})]
        lines["decode"] = {
            "steps": DIST_DECODE_STEPS,
            "wall_ms": sum(x["wall_ms"] for x in steps),
            "wall_ms_mesh": sum(x["wall_ms_mesh"] for x in steps),
            "host_cost_ms_a_step": float(np.median(
                [x["host_cost_ms"] for x in steps])),
            "launches_a_step": steps[-1]["launches"],
            "launches_mesh_a_step": steps[-1]["launches_mesh"]}
        del params, pp, cache, cc, cache_m, lg, lg_m
        release_memory()
        # the train step: the mesh run first, its state to the host, then
        # the same step from the same seed without the mesh
        tc = TrainConfig(optimizer=OptimizerConfig(), grad_accum=DIST_ACCUM)
        step = make_train_step(cfg, tc)
        tb, ts = DIST_TRAIN
        tok = torch.randint(0, cfg.vocab_size, (tb, ts + 1), generator=gen,
                            device=dev, dtype=torch.int32)
        batch = {"tokens": tok[:, :-1].contiguous(),
                 "labels": tok[:, 1:].contiguous()}
        state = init_state(cfg, tc, SEED, device=dev)
        with sharding_rules(rules):
            specs = dplan.to_shardings(rules, dplan.state_specs(rules, state))
            st = dplan.distribute(state, specs)
            bt = dplan.distribute(batch, dplan.to_shardings(
                rules, dplan.batch_specs(rules, batch)))
            (st, m_mesh), ms_mesh, launches_mesh = _dist_timed(
                lambda: step(st, bt))
            loss_mesh = float(_dist_full(m_mesh["loss"]))
            host = {"state": _dist_tree_cpu(_dist_full(st))}
            # reshard: the trained state from the host onto the mesh, back
            flat = {}
            _dist_flat(specs, "", flat)
            placed = ckpt.reshard(host["state"], lambda path, _: flat[path])
            back = _dist_tree_cpu(_dist_full(placed))
        reshard_bad = _dist_tree_equal(back, host["state"])
        del st, state, placed, bt
        release_memory()
        state = init_state(cfg, tc, SEED, device=dev)
        (state, m), ms, launches = _dist_timed(lambda: step(state, batch))
        for k, v in launches_mesh.items():
            total[k] = total.get(k, 0) + v
        train_bad = _dist_tree_equal(_dist_tree_cpu(state), host["state"])
        lines["train"] = {"batch": list(DIST_TRAIN), "grad_accum": DIST_ACCUM,
                          "wall_ms": ms, "wall_ms_mesh": ms_mesh,
                          "host_cost_ms": ms_mesh - ms,
                          "loss": float(m["loss"]), "loss_mesh": loss_mesh,
                          "launches": launches,
                          "launches_mesh": launches_mesh}
        if launches != launches_mesh:
            mismatch.append(f"train: launches {launches} against "
                            f"{launches_mesh}")
        if float(m["loss"]) != loss_mesh:
            mismatch.append("train loss")
        mismatch += [f"train state {p}" for p in train_bad]
        mismatch += [f"reshard {p}" for p in reshard_bad]
        del state, host, back
        release_memory()
    finally:
        dist.destroy_process_group()
    local = dist_local_calls(dev)
    emit({"phase": "distributed", "card": card, "arch": DIST_ARCH,
          "mesh": {"shape": [1, 1], "dims": ["data", "model"],
                   "backend": "nccl", "world": 1},
          "calls": lines, "reshard_bit_equal": not reshard_bad,
          "bit_equal": not mismatch, "mismatches": mismatch[:20],
          "shard_local_calls": local,
          "seconds": time.perf_counter() - t_phase})
    if mismatch:
        raise AssertionError(f"distributed: {mismatch[:10]}")
    for kernel in ("norm", "flash_attention", "flash_decode", "softmax"):
        if not total.get(kernel):
            raise AssertionError(f"distributed: {kernel} not launched over "
                                 "the mesh")
    return total


def _dist_tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _dist_tree_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _dist_flat(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _dist_flat(v, key, out)
        else:
            out[key] = v


def dist_local_calls(dev) -> dict:
    """Each rank's local decode and causal-flash call as tensor
    parallelism of ``DIST_TP`` splits the heads of ``DIST_HEADS``: the
    rank's query heads and the kv heads they read (sharded with them
    where the kv heads divide, else sliced by
    `repro_torch.distributed.sharding.local_kv_heads`), the outputs concatenated
    over heads against the full call, bit for bit."""
    from repro_torch.distributed.sharding import local_kv_heads
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, s = DIST_LOCAL
    out = {}
    for arch, h, kv in DIST_HEADS:
        dh = 128
        q1 = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
        kc = torch.randn((b, kv, s, dh), generator=gen, device=dev)
        vc = torch.randn((b, kv, s, dh), generator=gen, device=dev)
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        qf = torch.randn((b, h, s, dh), generator=gen, device=dev).bfloat16()
        kf = torch.randn((b, kv, s, dh), generator=gen, device=dev).bfloat16()
        vf = torch.randn((b, kv, s, dh), generator=gen, device=dev).bfloat16()
        full_d = ops.flash_decode(q1, kc, vc, lens)
        full_f = ops.flash_attention(qf, kf, vf, causal=True)
        for tp in DIST_TP:
            hl = h // tp
            kv_sharded = kv % tp == 0
            parts_d, parts_f, groups = [], [], set()
            for r in range(tp):
                q_off = r * hl
                k_off = r * (kv // tp) if kv_sharded else 0
                k_n = kv // tp if kv_sharded else kv
                first, n = local_kv_heads("dist_local", q_off, hl,
                                              h // kv, k_off, k_n)
                ks = slice(k_off + first, k_off + first + n)
                groups.add(hl // n)
                parts_d.append(ops.flash_decode(
                    q1[:, q_off:q_off + hl].contiguous(),
                    kc[:, ks].contiguous(), vc[:, ks].contiguous(), lens))
                parts_f.append(ops.flash_attention(
                    qf[:, q_off:q_off + hl].contiguous(),
                    kf[:, ks].contiguous(), vf[:, ks].contiguous(),
                    causal=True))
            ok_d = torch.equal(torch.cat(parts_d, dim=1), full_d)
            ok_f = torch.equal(torch.cat(parts_f, dim=1), full_f)
            out[f"{arch} tp{tp}"] = {
                "heads_a_rank": hl, "kv_heads": "sharded" if kv_sharded
                else "replicated, sliced", "local_groups": sorted(groups),
                "decode_bit_equal": ok_d, "flash_bit_equal": ok_f}
            if not (ok_d and ok_f):
                raise AssertionError(f"distributed: {arch} tp {tp}: decode "
                                     f"{ok_d}, flash {ok_f}")
    return out


def release_memory() -> None:
    """Free what a finished phase left (its client holds reference
    cycles), so the next phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    # the dry run's CPU half runs beside the card's phases
    worker = start_dryrun_worker(root)
    try:
        return run_phases(worker, started)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()


def run_phases(worker, started: float) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": cuda_lib.BUILD_INFO.get("built"),
          "library": Path(str(cuda_lib.BUILD_INFO["path"])).name,
          "ptxas_registers_and_spill_bytes": {
              name: [u.get("registers"), u.get("spill_stores", 0) +
                     u.get("spill_loads", 0)]
              for name, u in cuda_lib.BUILD_INFO["ptxas"].items()}})

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    checks = {}
    check_norm(dev, gen, checks)
    check_flash_attention(dev, gen, checks)
    check_flash_attention_packed(dev, gen, checks)
    check_flash_attention_packed_plan(dev, gen, checks)
    check_paged_decode(dev, gen, checks)
    check_sample(dev, gen, checks)
    check_softmax(dev, gen, checks)
    check_contiguous_decode(dev, gen, checks)

    # each path runs with the launch counters set to 0 just before it,
    # and each kernel's launches are read from the path that runs it
    client, launches = serve(dev, card)
    profile_decode(client, card)
    profile_decode(client, card, sampled=True)
    profile_prefill(client, card)
    profile_prefill(client, card, mode="packed")
    profile_prefill(client, card, mode="suffix")
    del client
    release_memory()
    # the prefix cache and chunked prefill: packed, then per group
    serve_prefix_chunked(dev, card)
    release_memory()
    classified = classify_phase(dev, card)
    launches["softmax"] = classified["softmax_launches"]
    release_memory()
    # the paper's allocator over the classify forward (its launches are
    # checked there; the kernels line keeps classify's)
    allocator_phase(dev, card)
    release_memory()
    # the contiguous layout admits per group: the causal kernel's path
    client, launches_c = serve(dev, card, layout="contiguous")
    launches["flash_decode"] = launches_c["flash_decode"]
    launches["flash_attention"] = launches_c["flash_attention"]
    del client
    release_memory()
    # the MoE family at full width: its own launches are in its line
    client = serve_moe(dev, card)
    profile_decode(client, card, phase="profile_decode_moe",
                   family=moe_kernel_family)
    profile_decode(client, card, sampled=True, phase="profile_decode_moe",
                   family=moe_kernel_family)
    profile_prefill(client, card, mode="packed",
                    phase="profile_prefill_moe_packed",
                    family=moe_kernel_family)
    del client
    release_memory()
    # the modality front ends and the LayerNorm + GELU models: Qwen2-VL
    # (M-RoPE, group 7) on the serve mix and with an image prefix,
    # StarCoder2 (group 12) on the serve mix, MusicGen (dh 64, four
    # codebooks) through generate and the model functions
    client, vlm_launches = serve(dev, card, arch="qwen2-vl-7b",
                                 phase="serve_vlm")
    vlm_image_check(client.backend.engine, card)
    del client
    release_memory()
    client, sc2_launches = serve(dev, card, arch="starcoder2-15b",
                                 phase="serve_starcoder2")
    del client
    release_memory()
    musicgen_launches = generate_musicgen(dev, card)
    release_memory()
    # the SSM and hybrid families over the contiguous slot cache:
    # Falcon-Mamba (attention-free; its greedy decode window split by
    # kernel family) and Zamba2 (the shared block's causal and decode
    # kernels at dh 64)
    client, falcon_launches = serve(dev, card, layout="contiguous",
                                    arch="falcon-mamba-7b",
                                    phase="serve_falcon_mamba",
                                    slots=SSM_SLOTS)
    profile_decode(client, card, phase="profile_decode_falcon_mamba",
                   family=ssm_kernel_family, rows=SSM_SLOTS)
    del client
    release_memory()
    client, zamba_launches = serve(dev, card, layout="contiguous",
                                   arch="zamba2-1.2b", phase="serve_zamba2",
                                   slots=SSM_SLOTS)
    del client
    release_memory()
    # the serving tier: two replicas, background warm-up, the simulator
    # on the classify phase's cost table, the CLI
    pool_launches = serve_pool(dev, card, classified)
    release_memory()
    # training at full width: the norm and softmax kernels with their
    # gradients, the trainer, checkpoints and the CLI
    train_launches = train_phase(dev, card)
    release_memory()
    # the examples, in-process, then the dry run against the card
    example_launches = examples_phase(dev, card)
    release_memory()
    dryrun_phase(dev, card, worker)
    release_memory()
    # the model functions over a (1, 1) DeviceMesh, and the kernels on the
    # shards tensor parallelism would give each rank
    dist_launches = distributed_phase(dev, card)
    release_memory()
    names = {"fused_norm": "norm", "flash_attention": "flash_attention",
             "flash_attention_packed": "flash_attention_packed",
             "flash_attention_packed_plan": "flash_attention_packed_plan",
             "flash_decode_paged": "flash_decode_paged",
             "fused_sample": "sample", "fused_softmax": "softmax",
             "flash_decode": "flash_decode"}
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms")
    kernels = []
    for name, counter in names.items():
        c = checks[name]
        item = {"name": name, "launches": launches.get(counter, 0)}
        item.update({k: c[k] for k in keys})
        item["launches_in_serve_pool"] = pool_launches.get(counter, 0)
        item["launches_in_serve_vlm"] = vlm_launches.get(counter, 0)
        item["launches_in_serve_starcoder2"] = sc2_launches.get(counter, 0)
        item["launches_in_generate_musicgen"] = \
            musicgen_launches.get(counter, 0)
        item["launches_in_serve_falcon_mamba"] = \
            falcon_launches.get(counter, 0)
        item["launches_in_serve_zamba2"] = zamba_launches.get(counter, 0)
        item["launches_in_train"] = train_launches.get(counter, 0)
        item["launches_in_examples"] = example_launches.get(counter, 0)
        item["launches_in_distributed"] = dist_launches.get(counter, 0)
        kernels.append(item)
    for item in kernels:
        for k, val in item.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{item['name']}: {k} is {val}")
    emit({"phase": "total_seconds", "card": card,
          "seconds": time.perf_counter() - started})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
