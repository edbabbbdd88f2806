"""The serve phases' stream rules in ``chip_smoke.py``, on the CPU.

``draw_margins`` gives, for a draw from some logits, the least change of
the logits (on the scale of a greedy top-2 gap) that can change the
drawn token, and the least under which a given other token is drawn.
Held here against the port's plain sampler: moves below the margin never
change the draw, and every token that a larger move draws has a gap
within that move.

The MoE phase runs each request alone with its prefill dropping exactly
what its served pass dropped (``MoeAudit``, ``moe_pinned_drops``), and
measures the drift of a packed pass with routing free and pinned
(``moe_routes``, ``moe_packed_drift``).  Held here on the OLMoE smoke
config with a capacity small enough to drop: a pinned pass repeats
another pass's rows, and a served stream equals its pinned alone run.
"""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.api import GenerationParams, TurboClient  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.runtime.bucketing import BucketLadder  # noqa: E402
from repro_torch.runtime.engine import (  # noqa: E402
    ContinuousEngine, InferenceEngine)
from repro_torch.runtime.sampling import (  # noqa: E402
    DEFAULT_SAMPLE_CANDIDATES, gumbel_noise)

VOCAB = 2000
ROWS = 6
MOVES = 20


def _logits(rng) -> torch.Tensor:
    # bf16 values, as the LM head writes them: many near ties
    return torch.from_numpy(rng.standard_normal(VOCAB).astype(np.float32)
                            ).bfloat16().float()


def _draw(logits, params, step) -> int:
    if params.temperature <= 0:
        return int(torch.argmax(logits))
    seed = torch.tensor([params.seed], dtype=torch.int32)
    noise = gumbel_noise(seed, torch.full_like(seed, step),
                         DEFAULT_SAMPLE_CANDIDATES)
    return int(ref.sample_ref(
        logits[None], torch.tensor([params.temperature]),
        torch.tensor([params.top_k], dtype=torch.int32),
        torch.tensor([params.top_p]), noise)[0])


@pytest.mark.parametrize("sampled", [False, True])
def test_draw_margins_bound_what_rounding_can_change(sampled):
    rng = np.random.default_rng(7 + sampled)
    scale = 0.8 if sampled else 1.0
    for row in range(ROWS):
        params = SimpleNamespace(
            temperature=0.8 if sampled else 0.0, top_k=50 if sampled else 0,
            top_p=0.95 if sampled else 1.0, seed=1000 + row)
        step = row % 4
        logits = _logits(rng)
        drawn = _draw(logits, params, step)
        margin, _ = chip_smoke.draw_margins(logits, params, step,
                                            (drawn + 1) % VOCAB)
        # the lowest logit is far from being drawn
        _, far = chip_smoke.draw_margins(logits, params, step,
                                         int(torch.argmin(logits)))
        assert far > 1.0
        # a move of every logit below half the margin keeps the draw
        small = margin / 2 * scale * 0.999
        for _ in range(MOVES):
            move = torch.from_numpy(rng.uniform(-small, small, VOCAB)
                                    .astype(np.float32))
            assert _draw(logits + move, params, step) == drawn
        # a token that a larger move draws lies within that move
        big = 0.3
        for _ in range(MOVES):
            move = torch.from_numpy(rng.uniform(-big, big, VOCAB)
                                    .astype(np.float32))
            other = _draw(logits + move, params, step)
            if other != drawn:
                m, gap = chip_smoke.draw_margins(logits, params, step, other)
                assert m <= 2 * big / scale + 1e-9
                assert gap <= 2 * big / scale + 1e-9


# ---------------------------------------------------------------------------
# The MoE phase's audit
# ---------------------------------------------------------------------------

#: f32 at the smoke config: a pinned pass and the pass it repeats run
#: the same rows through expert batches of other shapes
PIN_TOL = dict(rtol=1e-6, atol=1e-6)


def _dropping_olmoe(factor=0.5):
    cfg = get_smoke_config("olmoe-1b-7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _moe_layer(cfg):
    return layer_params(init_params(cfg, device="cpu", seed=3), 0)["moe"]


def test_pinned_drops_repeat_another_pass_rows():
    cfg = _dropping_olmoe()
    p = _moe_layer(cfg)
    n_a = 24
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32))
    with chip_smoke.moe_recorded() as calls:
        pack, _ = M.apply_moe(cfg, p, x)
    drops = calls[0]["drops"]
    assert calls[0]["dropped"] == int(drops.sum()) > 0
    # the last segment of the pack: earlier tokens win, so it loses some
    seg = slice(64 - n_a, 64)
    assert bool(drops[seg].any())
    with chip_smoke.moe_pinned_drops([drops[seg]]), \
            chip_smoke.moe_recorded() as pinned:
        alone, _ = M.apply_moe(cfg, p, x[:, seg])
    assert pinned[0]["dropped"] == int(drops[seg].sum())
    torch.testing.assert_close(alone, pack[:, seg], **PIN_TOL)
    # by itself the segment drops other assignments, or none
    free, _ = M.apply_moe(cfg, p, x[:, seg])
    assert not torch.allclose(free, pack[:, seg], **PIN_TOL)


def test_pinned_routing_takes_the_pinned_experts():
    cfg = get_smoke_config("olmoe-1b-7b")
    p = _moe_layer(cfg)
    x2d = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (10, cfg.d_model)).astype(np.float32))
    _, idx, _ = M.route(cfg, p, x2d)
    pins = torch.full_like(idx, -1)
    pins[:5] = idx[:5].flip(1) ^ 1           # other experts, other order
    with chip_smoke.moe_routes([pins]) as chosen:
        w, got, _ = M.route(cfg, p, x2d)
    assert torch.equal(chosen[0], got)
    assert torch.equal(got[:5], pins[:5]) and torch.equal(got[5:], idx[5:])
    probs = torch.softmax(x2d @ p["router"], dim=-1).gather(1, got)
    torch.testing.assert_close(w, probs / probs.sum(-1, keepdim=True))


def _served_and_alone(pinned: bool):
    cfg = _dropping_olmoe()
    engine = InferenceEngine(cfg, init_params(cfg, device="cpu", seed=0),
                             ladder=BucketLadder(seq_buckets=(32, 64),
                                                 batch_buckets=(1, 2, 4)),
                             device="cpu")
    ce = ContinuousEngine(engine, max_slots=4, cap_new=24)
    client = TurboClient(ce)
    rng = np.random.default_rng(0)
    specs = [([int(t) for t in rng.integers(1, cfg.vocab_size, n)],
              GenerationParams(max_new_tokens=8, seed=i,
                               temperature=0.8 if i % 3 == 1 else 0.0))
             for i, n in enumerate((9, 20, 13, 30, 7, 25))]

    def alone_run():
        return [client.submit(p, g).result() if g.temperature > 0 else
                engine.generate([p], max_new_tokens=g.max_new_tokens)[0]
                for p, g in specs]
    audit = chip_smoke.MoeAudit(ce)
    audit.install()
    try:
        served = [h.result() for h in [client.submit(p, g)
                                       for p, g in specs]]
        audit.mode = "alone"
        alone = alone_run() if pinned else None
    finally:
        audit.remove()
    if not pinned:
        alone = alone_run()
    return engine, specs, audit, served, alone


@pytest.mark.parametrize("pinned", [True, False])
def test_served_streams_equal_their_pinned_alone_runs(pinned):
    engine, specs, audit, served, alone = _served_and_alone(pinned)
    lost = sum(p["prompts_losing_an_assignment"] for p in audit.passes
               if p["mode"] == "served")
    # on the CPU the tick runs eagerly; the prefill cells run their bodies
    assert lost > 0 and audit.cells_checked > 0
    equal = sum(a == b for a, b in zip(served, alone))
    if pinned:
        assert audit.pinned == {tuple(p) for p, _ in specs}
        assert equal == len(specs)
    else:                        # the drops are what set them apart
        assert equal < len(specs)


def test_packed_drift_is_rounding_alone_at_f32():
    cfg = get_smoke_config("olmoe-1b-7b")
    engine = InferenceEngine(cfg, init_params(cfg, device="cpu", seed=0),
                             ladder=BucketLadder(seq_buckets=(32, 64),
                                                 batch_buckets=(1, 2, 4)),
                             device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (9, 20, 13, 30, 7, 25, 3, 11, 17)]
    drift = chip_smoke.moe_packed_drift(engine, prompts)
    assert drift["positions"] == sum(map(len, prompts))
    assert drift["positions_with_a_flipped_choice"] == 0
    assert drift["max_bf16_ulps"] < 0.01
    assert drift["routing_pinned"]["max_bf16_ulps"] < 0.01


def _count_norms(monkeypatch) -> dict:
    """Count the calls of the port's norm wrappers (every norm and
    qk-norm of the models goes through one of the two)."""
    from repro_torch.kernels import ops
    calls = {"norm": 0}
    for name in ("fused_rmsnorm", "fused_layernorm"):
        real = getattr(ops, name)

        def counted(*args, _real=real, **kw):
            calls["norm"] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-32b",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_norms_per_pass_counts_the_norm_calls(arch, step, monkeypatch):
    """``norms_per_pass`` (the serve phases' norm launches a step) equals
    the norm calls of one prefill and of one decode step on the CPU: a
    model without qk-norm, one with it, an SSM and a hybrid model."""
    from repro_torch.models import decode_step, prefill
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    if step == "prefill":
        calls = _count_norms(monkeypatch)
        prefill(cfg, params, tokens, max_len=16)
    else:
        logits, cache = prefill(cfg, params, tokens, max_len=16)
        calls = _count_norms(monkeypatch)
        decode_step(cfg, params, cache, logits.argmax(-1))
    assert calls["norm"] == chip_smoke.norms_per_pass(cfg)
    if cfg.qk_norm:
        assert calls["norm"] == 4 * cfg.num_layers + 1
