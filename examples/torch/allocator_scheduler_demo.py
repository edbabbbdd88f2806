"""The paper's two algorithms on the PyTorch port, standalone and
inspectable:

1. Algorithm 1 on a real computation graph: trace a 12-layer BERT-like
   encoder, extract tensor lifetimes from its op graph (``make_fx`` in
   fake mode: no data, no device memory), plan chunk offsets, and watch
   the footprint track the request length (vs a caching allocator that
   ratchets).
2. Algorithm 2 on the paper's Fig. 8 example: lengths 17/18/52/63/77,
   DP split beats one-big-batch and no-batching.

    PYTHONPATH=src python examples/torch/allocator_scheduler_demo.py
    PYTHONPATH=src python examples/torch/allocator_scheduler_demo.py --device cpu

The encoder is this file's own copy of the JAX package's benchmark
encoder (``bert_encoder``): plain PyTorch, no kernel of the port.
"""
import argparse
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core import (AnalyticCostModel, CachingAllocator,
                              SequenceAwareAllocator, dp_schedule,
                              naive_schedule, nobatch_schedule,
                              records_for_fn, validate_plan)

L = 12
H = 12
D = 768
FF = 3072
DH = D // H
VOCAB = 30522


def init_bert_params(seed: int = 0, device="cuda") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    layers = []
    for _ in range(L):
        layers.append({
            "wqkv": normal(D, 3 * D), "wo": normal(D, D),
            "w1": normal(D, FF), "w2": normal(FF, D),
            "g1": torch.ones((D,), device=device),
            "b1": torch.zeros((D,), device=device),
            "g2": torch.ones((D,), device=device),
            "b2": torch.zeros((D,), device=device),
        })
    return {"layers": layers, "embed": normal(VOCAB, D)}


def _ln(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = (x * x).mean(-1, keepdim=True) - m * m
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


def bert_encoder(params, tokens):
    """tokens: (B, S) -> (B, S, D). Unrolled 12-layer BERT encoder."""
    h = params["embed"][tokens]
    b, s, _ = h.shape
    for lyr in params["layers"]:
        qkv = h @ lyr["wqkv"]
        q, k, v = torch.split(qkv, D, dim=-1)
        q = q.reshape(b, s, H, DH)
        k = k.reshape(b, s, H, DH)
        v = v.reshape(b, s, H, DH)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (DH ** 0.5)
        w = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, D)
        h = _ln(h + attn @ lyr["wo"], lyr["g1"], lyr["b1"])
        ff = F.gelu(h @ lyr["w1"], approximate="tanh") @ lyr["w2"]
        h = _ln(h + ff, lyr["g2"], lyr["b2"])
    return h


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    params = init_bert_params(0, device=args.device)
    turbo = SequenceAwareAllocator()
    caching = CachingAllocator()
    out = {"footprints": []}

    print("== Algorithm 1: sequence-length-aware allocation ==")
    print(f"{'len':>5} {'records':>8} {'chunks':>7} {'turbo MB':>9} "
          f"{'caching MB':>11}")
    for seq in (64, 200, 480, 240, 64):
        recs = records_for_fn(
            lambda t: bert_encoder(params, t),
            torch.ones((1, seq), dtype=torch.long, device=args.device),
            min_size=4096)
        plan = turbo.plan(recs)
        validate_plan(recs, plan)
        caching.run_inference(recs)
        print(f"{seq:5d} {len(recs):8d} {len(plan.chunks):7d} "
              f"{turbo.footprint/1e6:9.2f} {caching.footprint/1e6:11.2f}")
        out["footprints"].append((seq, len(recs), turbo.footprint,
                                  caching.footprint))
    print("-> turbo releases chunks when requests shrink; "
          "the caching allocator never does.\n")

    print("== Algorithm 2: DP batch scheduling (paper Fig. 8) ==")
    cm = AnalyticCostModel(flops_per_token=2 * 110e6, bytes_per_token=2e4,
                           weight_bytes=2.2e8, overhead=1.2e-3,
                           peak_flops=6.5e12, hbm_bw=336e9)
    lengths = [17, 18, 52, 63, 77]
    for name, plan in [
            ("dp", dp_schedule(lengths, cm)),
            ("naive", naive_schedule(lengths, cm)),
            ("nobatch", nobatch_schedule(lengths, cm))]:
        batches = [[lengths[i] for i in b] for b in plan.batches]
        print(f"{name:8s} cost={plan.total_cost*1e3:7.2f} ms  "
              f"batches={batches}")
        out[name] = (plan.total_cost, batches)
    dp = dp_schedule(lengths, cm)
    nv = naive_schedule(lengths, cm)
    print(f"-> DP improves throughput by "
          f"{(nv.total_cost/dp.total_cost-1)*100:.0f}% over one padded "
          f"batch on this example.")
    return out


if __name__ == "__main__":
    main()
