"""Quickstart — the paper's §6.1 usability pitch on the PyTorch port.

A few lines take you from a model config to serving variable-length
requests through the TurboTransformers-style engine:

    PYTHONPATH=src python examples/torch/quickstart.py            # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

``--no-smoke`` serves the full-width model (bf16 weights from a seed);
the reduced config (the default) is f32 with a head dim of 16, which
the card's attention kernels are not built for, so on the card run it
with ``--no-smoke``.
"""
import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import init_params
from repro_torch.runtime import InferenceEngine

REQUESTS = [[101, 2023, 2003, 102],
            [101] + list(range(200, 260)) + [102],
            [101, 7592, 102]]
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5]]


def requests_for(cfg):
    return [[t % cfg.vocab_size for t in r] for r in REQUESTS]


def run(cfg, params, device):
    """Steps 2-4 on given weights: returns (labels, generations, engine)."""
    # 2. wrap it in the serving runtime (bucketing + CUDA-graph cells on
    #    the card + KV slab)
    engine = InferenceEngine(cfg, params, device=device)

    # 3. serve variable-length requests — no per-length preprocessing
    #    (ids past a reduced config's vocabulary fold into it: the port's
    #    embedding raises on them, where the JAX package's reads NaN rows)
    labels = engine.classify(requests_for(cfg))
    print("predicted classes:", labels)

    # 4. or generate continuations (greedy), ragged batch in one call
    outs = engine.generate(PROMPTS, max_new_tokens=8)
    for o in outs:
        print("generated:", o)
    print(f"compiled {engine.compile_count} executable cells; "
          f"KV slab footprint {engine.kv_slab.footprint/1e6:.1f} MB")
    return labels, outs, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-smoke for full)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    # 1. build a model (reduced InternLM2-family config; any of the ten
    #    assigned architectures works: --arch qwen3-32b, falcon-mamba-7b, ...)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    params = init_params(cfg, seed=0, device=args.device)
    return run(cfg, params, args.device)


if __name__ == "__main__":
    main()
