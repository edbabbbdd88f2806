"""The serve phase's stream rule in ``chip_smoke.py``, on the CPU.

``draw_margins`` gives, for a draw from some logits, the least change of
the logits (on the scale of a greedy top-2 gap) that can change the
drawn token, and the least under which a given other token is drawn.
Held here against the port's plain sampler: moves below the margin never
change the draw, and every token that a larger move draws has a gap
within that move.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
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
