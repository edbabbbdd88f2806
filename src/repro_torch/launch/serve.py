"""Serving CLI: the full TurboTransformers pipeline over the port's
engine.

Two phases, both built on the `repro_torch.api` streaming client:

1. one-shot classification replay (the paper's workload): Poisson
   request stream -> iteration-level serving pipeline -> batch scheduler
   (nobatch | naive | dp) -> InferenceEngine (bucketed, CUDA-graph cells
   on the card) -> responses, with the cached_cost table built by the
   engine's warm-up phase (paper §5);
2. generative streaming: `TurboClient.submit(prompt, GenerationParams)`
   handles with per-request budgets / temperatures / seeds, tokens
   consumed from `handle.stream()` as decode ticks land, plus one
   mid-decode `handle.cancel()`; with ``--replicas N`` a
   `repro_torch.cluster.ReplicaPool` instead, one replica killed mid-run.

A copy of the JAX package's serving CLI with the same flags and phases,
plus ``--device`` (``cuda`` by default; ``cpu`` to run without a card).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --policy dp --num-requests 64 --len-max 100 [--no-smoke] \
      [--temperature 0.8] [--replicas 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time

from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (BucketedCostModel, Request, ServingConfig,
                              ServingSystem)
from repro_torch.data import LengthDistribution, RequestGenerator
from repro_torch.models import init_params
from repro_torch.runtime import (BucketLadder, ContinuousEngine,
                                 InferenceEngine)
from repro_torch.runtime.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    # BooleanOptionalAction gives --smoke AND --no-smoke; the old
    # action="store_true", default=True made full scale unreachable
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-smoke for full)")
    ap.add_argument("--policy", default="dp",
                    choices=["nobatch", "naive", "dp"])
    ap.add_argument("--strategy", default="hungry",
                    choices=["hungry", "lazy"])
    ap.add_argument("--num-requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0)
    ap.add_argument("--len-min", type=int, default=5)
    ap.add_argument("--len-max", type=int, default=100)
    ap.add_argument("--max-batch", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    # generative streaming phase (repro_torch.api)
    ap.add_argument("--gen-requests", type=int, default=6,
                    help="streaming requests in the generative phase")
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with per-request seeds")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record the generative phase and export a "
                    "Chrome-trace JSON (Perfetto / chrome://tracing)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve the generative phase from a ReplicaPool "
                    "of N engine replicas (prefix-affinity routing; the "
                    "demo kills one replica mid-run to show failover)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default; raises "
                    "without a card) or cpu")
    return ap


def run_pool_phase(engine, cost, args, cfg) -> None:
    """Generative phase over a `repro_torch.cluster.ReplicaPool`: same-prefix
    cohorts land on one replica each, then one replica is killed mid-run
    and its queued sessions fail over to the siblings."""
    from repro_torch.cluster import ReplicaFailure, ReplicaPool
    print(f"\nreplica pool: {args.gen_requests} requests over "
          f"{args.replicas} replicas (prefix-affinity routing)")
    clients = [TurboClient(
        ContinuousEngine(engine, max_slots=8,
                         cap_new=max(args.max_new_tokens, 1),
                         prefix_cache=True),
        cost_model=cost, trace=args.trace is not None)
        for _ in range(args.replicas)]
    pool = ReplicaPool(clients, trace=args.trace is not None)
    gp = GenerationParams(max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature,
                          top_k=args.top_k, top_p=args.top_p)
    cohorts = max(2, args.replicas)
    preambles = [[(11 * g + j) % cfg.vocab_size for j in range(16)]
                 for g in range(cohorts)]
    handles = [pool.submit(preambles[i % cohorts] + [1 + i % cohorts, i],
                           gp) for i in range(args.gen_requests)]
    placed = {}
    for i, h in enumerate(handles):
        placed.setdefault(i % cohorts, []).append(h.replica)
    for g, reps in sorted(placed.items()):
        print(f"  cohort {g}: replicas {sorted(set(reps))}")
    victim = handles[0].replica
    pool.kill_replica(victim, reason="demo kill")
    print(f"  killed replica {victim} mid-run; queued sessions fail "
          f"over, mid-decode ones surface ReplicaFailure")
    ok = lost = 0
    for h in handles:
        try:
            h.result(timeout=300)
            ok += 1
        except ReplicaFailure as e:
            lost += 1
            print(f"  req {e.req_id}: lost mid-decode on replica "
                  f"{e.replica}")
    c = pool.metrics()["counters"]
    print(f"  {ok} finished / {lost} failed; routed={c['pool.routed']} "
          f"affinity_hits={c['pool.affinity_hits']} "
          f"failovers={c['pool.failovers']} "
          f"resubmitted={c['pool.failover_resubmitted']}; healthy now: "
          f"{pool.healthy_replicas()}")
    if args.trace is not None:
        doc = pool.save_trace(args.trace)
        print(f"  trace: {len(doc['traceEvents'])} events -> "
              f"{args.trace} (load in Perfetto / chrome://tracing)")
    pool.close()


def main() -> None:
    args = build_parser().parse_args()
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = init_params(cfg, seed=0, device=dev)
    ladder = BucketLadder(seq_buckets=(32, 64, 128, 256, 512),
                          batch_buckets=(1, 2, 4, 8, 16, 32))
    engine = InferenceEngine(cfg, params, ladder=ladder, device=dev)

    print("warming up cached_cost ...", flush=True)
    cost = engine.warmup(lengths=(32, 128, 512), batches=(1, 4, 16))
    cost = BucketedCostModel(cost, buckets=ladder.seq_buckets)

    gen = RequestGenerator(
        rate=args.rate,
        lengths=LengthDistribution("uniform", args.len_min, args.len_max),
        vocab_size=cfg.vocab_size, seed=args.seed)
    duration = args.num_requests / args.rate
    requests = gen.generate(duration)[:args.num_requests]
    print(f"replaying {len(requests)} requests "
          f"(lengths {args.len_min}-{args.len_max}) policy={args.policy}")

    system = ServingSystem(
        execute=engine.execute_requests, cost_model=cost,
        config=ServingConfig(policy=args.policy, strategy=args.strategy,
                             max_batch_size=args.max_batch))
    t0 = time.monotonic()
    for r in requests:
        # re-stamp arrivals onto the wall clock for latency accounting
        system.submit(Request(r.req_id, r.seq_len, time.monotonic(),
                              r.payload))
        system.step()
    system.drain()
    wall = time.monotonic() - t0
    lats = [resp.latency for resp in system.responses]
    print(f"served {len(system.responses)} responses in {wall:.2f}s "
          f"-> {len(system.responses)/wall:.1f} resp/s")
    print(f"latency avg={statistics.mean(lats)*1e3:.1f}ms "
          f"min={min(lats)*1e3:.1f}ms max={max(lats)*1e3:.1f}ms")
    print(f"batches executed with sizes: "
          f"{sorted(set(r.batch_size for r in system.responses))}; "
          f"engine captured {engine.compile_count} cells")

    # ---- generative streaming over the repro_torch.api client --------
    if args.replicas > 1:
        run_pool_phase(engine, cost, args, cfg)
        return
    print(f"\nstreaming: {args.gen_requests} generative requests through "
          f"TurboClient (temperature={args.temperature})")
    client = TurboClient(
        ContinuousEngine(engine, max_slots=8,
                         cap_new=max(args.max_new_tokens, 1)),
        cost_model=cost, trace=args.trace is not None)
    gp = [GenerationParams(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p, seed=i)
          for i in range(args.gen_requests)]
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(4 + i % 5)]
               for i in range(args.gen_requests)]
    handles = [client.submit(p, g) for p, g in zip(prompts, gp)]
    victim = handles.pop() if len(handles) > 1 else None
    if victim is not None:
        it = victim.stream()
        next(it, None)                    # let it reach mid-decode ...
        victim.cancel()                   # ... then tear it down
        print(f"  req {victim.req_id}: cancelled mid-decode after "
              f"{len(victim.tokens())} token(s) (blocks released)")
    for h in handles:
        toks = list(h.stream())
        print(f"  req {h.req_id}: streamed {len(toks)} tokens, "
              f"ttft={1e3*(h.ttft or 0):.1f}ms")
    itls = [d for h in handles for d in h.inter_token_latencies()]
    if itls:
        print(f"  client-side ITL p50={statistics.median(itls)*1e3:.1f}ms "
              f"max={max(itls)*1e3:.1f}ms")

    snap = client.metrics()
    ticks = snap["histograms"]["pipeline.tick_seconds"]
    print(f"  metrics: {snap['counters']['pipeline.decode_ticks']} decode "
          f"ticks, tick p50={ticks['p50']*1e3:.2f}ms "
          f"p99={ticks['p99']*1e3:.2f}ms")
    if args.trace is not None:
        doc = client.save_trace(args.trace)
        print(f"  trace: {len(doc['traceEvents'])} events -> "
              f"{args.trace} (load in Perfetto / chrome://tracing)")


if __name__ == "__main__":
    main()
