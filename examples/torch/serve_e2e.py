"""End-to-end serving on the PyTorch port: Poisson request stream
-> DP batch scheduler (Algorithm 2) -> shared iteration-level pipeline
-> InferenceEngine (the model on the card, or on the CPU with
``--device cpu``) -> responses, with the cached_cost table built by the
engine's warm-up phase (paper §5).

Runs these phases:
 1. one-shot classification serving (the paper's workload);
 2. generative continuous batching: a request arriving mid-decode joins
    the very next decode tick — no waiting for in-flight generations;
 3. prefix sharing over the radix prompt cache;
 4. the streaming client API; 5. its metrics and trace;
 6. a replica pool with a killed replica.

    PYTHONPATH=src python examples/torch/serve_e2e.py [--policy dp|naive|nobatch]
    PYTHONPATH=src python examples/torch/serve_e2e.py --device cpu

``--no-smoke`` serves the full-width model (bf16 weights from a seed); on
the card run it so: the reduced config's head dim of 16 has no attention
kernel there.
"""
import argparse
import statistics
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (BucketedCostModel, Request, ServingConfig,
                              ServingSystem)
from repro_torch.data import LengthDistribution, RequestGenerator
from repro_torch.models import init_params
from repro_torch.runtime import (BucketLadder, ContinuousEngine,
                                 InferenceEngine, Session, SessionState)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="dp",
                    choices=["dp", "naive", "nobatch"])
    ap.add_argument("--num-requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=300.0)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--replicas", type=int, default=2,
                    help="replica count for the pool phase (1 skips it)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-smoke for full)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    out = {}

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = init_params(cfg, seed=0, device=args.device)
    ladder = BucketLadder(seq_buckets=(32, 64, 128, 256),
                          batch_buckets=(1, 2, 4, 8, 16))
    engine = InferenceEngine(cfg, params, ladder=ladder, device=args.device)

    print("warm-up: building cached_cost from real engine timings ...")
    cost = BucketedCostModel(
        engine.warmup(lengths=(32, 128, 256), batches=(1, 4, 8),
                      repeats=2),
        buckets=ladder.seq_buckets)

    gen = RequestGenerator(rate=args.rate,
                           lengths=LengthDistribution("uniform", 4, 200),
                           vocab_size=cfg.vocab_size, seed=1)
    arrivals = gen.generate(args.num_requests / args.rate)
    arrivals = arrivals[:args.num_requests]

    system = ServingSystem(
        execute=engine.execute_requests, cost_model=cost,
        config=ServingConfig(policy=args.policy, strategy="hungry",
                             max_batch_size=16))
    t0 = time.monotonic()
    for req in arrivals:
        system.submit(Request(req.req_id, req.seq_len, time.monotonic(),
                              req.payload))
        system.step()           # hungry: flush whenever the engine idles
    system.drain()
    wall = time.monotonic() - t0

    lats = [r.latency * 1e3 for r in system.responses]
    batch_sizes = [r.batch_size for r in system.responses]
    print(f"policy={args.policy}: {len(system.responses)} responses "
          f"in {wall:.2f}s -> {len(system.responses)/wall:.1f} resp/s")
    print(f"latency ms: avg={statistics.mean(lats):.1f} "
          f"p50={statistics.median(lats):.1f} max={max(lats):.1f}")
    print(f"mean executed batch size: "
          f"{statistics.mean(batch_sizes):.2f}; "
          f"compiled cells: {engine.compile_count}")
    out["one_shot"] = {r.req_id: r.result for r in system.responses}
    out["one_shot_requests"] = len(arrivals)

    # ---- phase 2: generative continuous batching ---------------------
    print("\ncontinuous batching: a request arriving mid-decode joins "
          "the next tick")
    backend = ContinuousEngine(engine, max_slots=8, cap_new=32,
                               prefix_cache=True)
    system = ServingSystem(
        backend=backend, cost_model=cost,
        config=ServingConfig(policy=args.policy, strategy="hungry",
                             max_batch_size=8))
    first = Session(0, 6, time.monotonic(), prompt=[1, 2, 3, 4, 5, 6],
                    max_new_tokens=24)
    system.submit(first)
    system.step()                     # prefill (sizes the block pool)
    print(f"  KV layout: {backend.kv_layout} "
          f"(pool {backend.block_table.num_blocks - 1} x "
          f"{backend.block_size}-token blocks, prefix cache on)")
    for _ in range(4):
        system.step()                 # a few decode ticks
    late = Session(1, 3, time.monotonic(), prompt=[7, 8, 9],
                   max_new_tokens=8)
    system.submit(late)
    system.step()                     # admission: late joins NOW
    if late.state is not SessionState.DECODE or first.is_finished:
        raise RuntimeError("the late request must join while the first "
                           "one still decodes")
    print(f"  late request joined after {backend.decode_ticks} decode "
          f"ticks of request 0 (live KV tokens: {backend.live_tokens}, "
          f"blocks held: {backend.block_table.used_blocks})")
    system.drain()
    for resp in sorted(system.responses, key=lambda r: r.req_id):
        print(f"  req {resp.req_id}: {len(resp.result)} tokens, "
              f"latency {resp.latency*1e3:.0f}ms")
    print(f"  KV live after drain: {engine.kv_slab.live_bytes} bytes "
          f"(freed at EOS/budget, not batch end)")
    out["generative"] = {r.req_id: r.result for r in system.responses}

    # ---- phase 3: prefix reuse across requests -----------------------
    print("\nprefix sharing: repeat system-prompt traffic hits the radix "
          "prompt cache and prefills only the uncached suffix")
    system_prompt = list(range(5, 5 + 32))        # 32-token preamble
    pf_before = backend.prefill_tokens
    warm = Session(10, 33, time.monotonic(),
                   prompt=system_prompt + [40], max_new_tokens=4)
    system.submit(warm)
    system.drain()                                # cold: full prefill
    cold_cost = backend.prefill_tokens - pf_before
    followers = [Session(11 + i, 34, time.monotonic(),
                         prompt=system_prompt + [50 + i, 60 + i],
                         max_new_tokens=6) for i in range(3)]
    pf_before = backend.prefill_tokens
    for s in followers:
        system.submit(s)
    system.drain()
    hot_cost = backend.prefill_tokens - pf_before
    stats = backend.prefix_stats()
    print(f"  cold request prefilled {cold_cost} tokens; {len(followers)} "
          f"same-preamble followers prefilled {hot_cost} total")
    print(f"  cache: {stats['hits']} hits, {stats['reused_tokens']} "
          f"tokens served from shared blocks, "
          f"{stats['cached_blocks']} blocks warm, "
          f"{stats['cow_blocks']} copy-on-write copies")
    if stats["hits"] < len(followers) or \
            hot_cost >= cold_cost * len(followers):
        raise RuntimeError(f"prefix cache: {stats}, {hot_cost} tokens "
                           f"against {cold_cost} a cold request")
    out["prefix"] = {"hits": stats["hits"], "cold": cold_cost,
                     "hot": hot_cost,
                     "results": {s.req_id: list(s.generated)
                                 for s in [warm] + followers}}

    # ---- phase 4: "a few lines of code" (paper §5), via repro_torch.api
    print("\nstreaming client API: submit / stream / cancel in a few "
          "lines of repro_torch.api")
    from repro_torch.api import GenerationParams, TurboClient
    client = TurboClient.from_arch(args.arch, smoke=args.smoke,
                                   device=args.device,
                                   seq_buckets=(32, 64),
                                   batch_buckets=(1, 2, 4),
                                   trace=True)
    handle = client.submit([3, 1, 4, 1, 5], GenerationParams(
        max_new_tokens=8, temperature=0.7, top_p=0.95, seed=42))
    sampled = list(handle.stream())
    print("  sampled stream:", sampled)
    doomed = client.submit([2, 7, 1, 8], GenerationParams(
        max_new_tokens=32))
    doomed.cancel()
    greedy = client.submit([2, 7, 1, 8]).result()
    print(f"  cancelled second request in state {doomed.state}; "
          f"greedy result: {greedy}")
    out["client"] = {"sampled": sampled, "greedy": greedy}

    # ---- phase 5: observability — metrics snapshot + trace export ----
    print("\nobservability: every phase-4 request left a lifecycle span; "
          "the registry counted every tick")
    snap = client.metrics()
    c = snap["counters"]
    print(f"  registry: {c['pipeline.admitted']} admitted, "
          f"{c['pipeline.decode_ticks']} decode ticks, "
          f"{c['pipeline.cancelled']} cancelled, tick p50="
          f"{snap['histograms']['pipeline.tick_seconds']['p50']*1e3:.2f}ms")
    rec = client.obs.trace
    for rid in rec.request_ids():
        names = rec.request_names(rid)
        tally = {}
        for n in names:
            tally[n] = tally.get(n, 0) + 1
        span = " -> ".join(n if tally[n] == 1 else f"{n}x{tally[n]}"
                           for n in dict.fromkeys(names))
        print(f"  req {rid} span: {span}")
    doc = client.save_trace("serve_e2e_trace.json")
    print(f"  exported {len(doc['traceEvents'])} Chrome-trace events -> "
          "serve_e2e_trace.json (load in Perfetto / chrome://tracing)")
    client.close()

    # ---- phase 6: replica pool — same API, N engines, failover -------
    if args.replicas < 2:
        return out
    print(f"\nreplica pool: replicas={args.replicas} is just a "
          "constructor knob on the same client API")
    from repro_torch.cluster import ReplicaFailure
    pool = TurboClient.from_arch(args.arch, smoke=args.smoke,
                                 device=args.device, seq_buckets=(32, 64),
                                 batch_buckets=(1, 2, 4), warmup=False,
                                 prefix_cache=True,
                                 replicas=args.replicas)
    preamble = list(range(9, 9 + 16))             # shared system prompt
    hs = [pool.submit(preamble + [70 + i],
                      GenerationParams(max_new_tokens=6))
          for i in range(4)]
    hs += [pool.submit([90 + i] * 8, GenerationParams(max_new_tokens=6))
           for i in range(2)]
    print(f"  placements (same-preamble cohort sticks together): "
          f"{[h.replica for h in hs]}")
    victim = hs[0].replica
    pool.kill_replica(victim, reason="demo kill")
    done = lost = 0
    for h in hs:
        try:
            h.result(timeout=300)
            done += 1
        except ReplicaFailure:
            lost += 1
    c = pool.metrics()["counters"]
    print(f"  killed replica {victim}: {done} finished on siblings, "
          f"{lost} lost mid-decode; affinity_hits="
          f"{c['pool.affinity_hits']} failovers={c['pool.failovers']} "
          f"resubmitted={c['pool.failover_resubmitted']}")
    pool.close()
    out["pool"] = {"finished": done, "lost": lost,
                   "submitted": len(hs)}
    return out


if __name__ == "__main__":
    main()
