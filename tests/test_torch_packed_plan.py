"""The packed attention's tile plan against the JAX package's mask.

The port's packed attention visits, for each 64-row query tile, only the
64-key tiles of the pack's plan (`kernels.ops.flash_attention_packed_plan`,
built once per `prefill_packed` and read by every layer and head).  The
plan's plain version (`kernels.ref.flash_attention_packed_plan_ref`) is
held here to the JAX package's visibility rule (`attention_packed`: key j
is visible to query i iff both carry one id and ``k_pos[j] <= q_pos[i]``,
or j is i's own key), rebuilt in numpy, on layouts drawn by Hypothesis:
unordered ids, one-token segments, boundaries inside tiles, prefix
regions, padding (negative ids), Sk > Sq, and ids and positions drawn at
random.  Padding rows are never read back, so the plan owes them nothing
but their own key.  The attention and `prefill_packed` with the plan
threaded through run on the CPU in f32 against the reference at the
tolerances tests/test_torch_packed.py states (2e-5 on one attention call,
1e-4 on logits and K/V through the model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill_packed as jax_prefill_packed
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import prefill_packed
from repro_torch.models.bridge import params_from_numpy

ARCH = "internlm2-1.8b"
T = ref.PACKED_TILE
F32 = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _visible(q_seg, k_seg, q_pos, k_pos):
    """(Sq, Sk) bool: the JAX package's mask (src/repro/models/layers.py,
    ``attention_packed``) in numpy."""
    sq, sk = len(q_seg), len(k_seg)
    same = q_seg[:, None] == k_seg[None, :]
    causal = k_pos[None, :] <= q_pos[:, None]
    self_key = (np.arange(sk)[None, :] - (sk - sq)) == np.arange(sq)[:, None]
    return (same & causal) | self_key


def _pack(fresh, prefix, ids, pad_fresh, pad_prefix, prefix_order):
    """Ids and positions of a pack: segment i (id ``ids[i]``) has
    ``prefix[i]`` cached keys (positions 0..) in the prefix region, in
    ``prefix_order``, and ``fresh[i]`` fresh tokens (positions
    ``prefix[i]..``) in the fresh one; each region ends in padding (id
    -1, position 0)."""
    def region(parts, pad):
        seg, pos = [], []
        for sid, n, off in parts:
            seg += [sid] * n
            pos += list(range(off, off + n))
        return (np.array(seg + [-1] * pad, np.int32),
                np.array(pos + [0] * pad, np.int32))
    q_seg, q_pos = region([(ids[i], n, prefix[i])
                           for i, n in enumerate(fresh)], pad_fresh)
    p_seg, p_pos = region([(ids[i], prefix[i], 0) for i in prefix_order
                           if prefix[i]], pad_prefix)
    return (q_seg, np.concatenate([p_seg, q_seg]), q_pos,
            np.concatenate([p_pos, q_pos]))


@st.composite
def packs(draw):
    n = draw(st.integers(1, 6))
    fresh = draw(st.lists(st.sampled_from([1, 2, 5, 31, 63, 64, 65, 100,
                                           128, 150]),
                          min_size=n, max_size=n))
    prefix = draw(st.lists(st.sampled_from([0, 0, 1, 16, 64, 70]),
                           min_size=n, max_size=n))
    ids = draw(st.lists(st.integers(0, 50), min_size=n, max_size=n,
                        unique=True))
    order = draw(st.permutations(range(n)))
    pad_fresh = draw(st.sampled_from([0, 1, 7, 64, 130]))
    pad_prefix = draw(st.sampled_from([0, 3, 64])) if any(prefix) else 0
    return _pack(fresh, prefix, ids, pad_fresh, pad_prefix, order)


@st.composite
def random_layouts(draw):
    """Ids and positions drawn one by one: no segment structure at all."""
    sq = draw(st.integers(1, 200))
    sk = sq + draw(st.integers(0, 150))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    q_seg = rng.integers(-2, 4, sq).astype(np.int32)
    q_pos = rng.integers(0, 60, sq).astype(np.int32)
    k_seg = rng.integers(-2, 4, sk).astype(np.int32)
    k_pos = rng.integers(0, 60, sk).astype(np.int32)
    k_seg[sk - sq:] = q_seg                  # the fresh keys are the queries'
    k_pos[sk - sq:] = q_pos
    return q_seg, k_seg, q_pos, k_pos


def _plan(q_seg, k_seg, q_pos, k_pos):
    return ops.flash_attention_packed_plan(
        *(torch.from_numpy(a) for a in (q_seg, k_seg, q_pos, k_pos))).numpy()


def _rows(plan):
    """Per query tile: (visited tiles, masked flags)."""
    out = []
    for row in plan:
        n = int(row[0])
        e = row[1:1 + n]
        out.append((e & (ref.PLAN_MASKED - 1), (e & ref.PLAN_MASKED) != 0))
    return out


def _check_plan(q_seg, k_seg, q_pos, k_pos):
    sq, sk = len(q_seg), len(k_seg)
    plan = _plan(q_seg, k_seg, q_pos, k_pos)
    n_qt, n_kt = -(-sq // T), -(-sk // T)
    assert plan.shape == (n_qt, ref.packed_plan_width(sk))
    vis = _visible(q_seg, k_seg, q_pos, k_pos)
    real = q_seg >= 0
    for r, (tiles, masked) in enumerate(_rows(plan)):
        n = len(tiles)
        assert (plan[r, 1 + n:] == -1).all()
        assert (np.diff(tiles) > 0).all() and ((tiles >= 0) &
                                               (tiles < n_kt)).all()
        assert set(np.unique(plan[r, 1:1 + n] >> 16)) <= {0, 1}
        rows = np.arange(r * T, min(r * T + T, sq))
        if not real[rows].any():
            assert n == 0, r                 # padding only: no key work
            continue
        need = set()                         # tiles a real row needs
        for i in rows[real[rows]]:
            need |= set(np.nonzero(vis[i])[0] // T)
        for i in rows:                       # and every row's own key
            need.add((sk - sq + i) // T)
        assert set(tiles.tolist()) == need, r
        for t, m in zip(tiles, masked):
            if m:
                continue
            keys = np.arange(t * T, t * T + T)
            assert len(rows) == T and keys[-1] < sk
            assert real[rows].all()
            assert vis[np.ix_(rows, keys)].all(), (r, t)
    return plan


@SETTINGS
@given(packs())
def test_plan_covers_exactly_the_visible_tiles_of_packs(layout):
    """Every pair visible by the reference's rule to a real row, and every
    row's own key, lies in a visited tile, and every visited tile holds
    one; an unmasked tile has all its pairs visible; tiles ascend."""
    _check_plan(*layout)


@SETTINGS
@given(random_layouts())
def test_plan_covers_exactly_the_visible_tiles_of_random_ids(layout):
    _check_plan(*layout)


@pytest.mark.parametrize("fresh,prefix", [
    ((128, 64, 192), (0, 0, 0)),
    ((64,) * 6, (0,) * 6),
    ((256, 128), (64, 128)),
])
def test_tile_aligned_segments_visit_exactly_their_causal_tiles(fresh,
                                                                prefix):
    """Segments on tile boundaries (case (a) of the card checks, narrow):
    query tile r of a segment visits the segment's prefix tiles and its
    own tiles up to r, unmasked below the diagonal and masked on it."""
    q_seg, k_seg, q_pos, k_pos = _pack(fresh, prefix, list(range(
        len(fresh))), 0, 0, range(len(fresh)))
    plan = _check_plan(q_seg, k_seg, q_pos, k_pos)
    pre = sum(prefix) // T
    pre_at = np.cumsum((0,) + prefix)[:-1] // T
    at = np.cumsum((0,) + fresh)[:-1] // T
    rows = _rows(plan)
    for s, (n, p) in enumerate(zip(fresh, prefix)):
        for r in range(at[s], at[s] + n // T):
            tiles, masked = rows[r]
            own = list(range(pre_at[s], pre_at[s] + p // T)) + \
                list(range(pre + at[s], pre + r + 1))
            assert tiles.tolist() == own, r
            assert masked.tolist() == [False] * (len(own) - 1) + [True]


@settings(max_examples=15, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(packs(), st.sampled_from([(4, 2), (2, 2), (6, 2)]))
def test_attention_through_the_plan_matches_reference(layout, heads):
    """The plain packed attention seeing only the plan's tiles: equal to
    itself without the plan on real rows (the plan drops no visible
    pair), within f32 of the reference's ``attention_packed`` there, and
    zero on query tiles of padding only, as the kernel writes them."""
    q_seg, k_seg, q_pos, k_pos = layout
    h, kv = heads
    sq, sk, dh = len(q_seg), len(k_seg), 8
    rng = np.random.default_rng(sq * 7 + sk)
    q = rng.standard_normal((1, sq, h, dh), np.float32)
    k = rng.standard_normal((1, sk, kv, dh), np.float32)
    v = rng.standard_normal((1, sk, kv, dh), np.float32)
    ids = [torch.from_numpy(a) for a in (q_seg, k_seg, q_pos, k_pos)]
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    plan = ops.flash_attention_packed_plan(*ids)
    got = ops.flash_attention_packed(qt, kt, vt, *ids, plan=plan)
    free = ops.flash_attention_packed(qt, kt, vt, *ids)
    want = np.asarray(JL.attention_packed(
        None, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_seg=jnp.asarray(q_seg), k_seg=jnp.asarray(k_seg),
        q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos)))
    real = torch.from_numpy(q_seg >= 0)
    assert torch.equal(got[:, :, real], free[:, :, real])
    np.testing.assert_allclose(got.transpose(1, 2).numpy()[:, q_seg >= 0],
                               want[:, q_seg >= 0], **F32)
    empty = plan[:, 0] == 0
    for r in torch.nonzero(empty).flatten().tolist():
        assert not bool(got[:, :, r * T:(r + 1) * T].any())


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


#: (fresh, prefix, pack width): a pack whose second query tile is padding
#: only, with prefix keys before two segments, their region padded; a
#: segment crossing the tile boundary with a one-token segment after it
PREFILL_PACKS = {
    "padding_tile_prefix": ((7, 1, 40, 3), (0, 5, 0, 9), 128),
    "boundary_one_token": ((70, 1, 20), (0, 0, 3), 128),
}


@pytest.mark.parametrize("case", sorted(PREFILL_PACKS))
def test_prefill_packed_with_the_plan_matches_reference(weights, case,
                                                       monkeypatch):
    """`prefill_packed` builds the plan once and threads it through every
    layer: logits at each segment's last token and the real slots' K/V
    agree with the reference's (padding slots are never scattered)."""
    jcfg, jparams, tparams = weights
    cfg = get_smoke_config(ARCH)
    fresh, prefix, width = PREFILL_PACKS[case]
    n = len(fresh)
    q_seg, k_seg, q_pos, k_pos = _pack(fresh, prefix, list(range(n)),
                                       width - sum(fresh), 4, range(n))
    n_pre = len(k_seg) - width
    rng = np.random.default_rng(width + n)
    toks = np.zeros((1, width), np.int32)
    toks[0, :sum(fresh)] = rng.integers(1, cfg.vocab_size, sum(fresh))
    last = (np.cumsum(fresh) - 1).astype(np.int32)
    shape = (cfg.num_layers, n_pre, cfg.num_kv_heads, cfg.head_dim)
    pk = rng.standard_normal(shape, np.float32)
    pv = rng.standard_normal(shape, np.float32)
    p_seg, p_pos = k_seg[:n_pre], k_pos[:n_pre]
    want_logits, want_kv = jax_prefill_packed(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(q_seg),
        jnp.asarray(q_pos), jnp.asarray(last), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(p_seg), jnp.asarray(p_pos),
        cache_dtype=jnp.float32)
    t = torch.from_numpy
    calls = []
    real_plan = ops.flash_attention_packed_plan

    def counted(*args):
        calls.append(1)
        return real_plan(*args)
    monkeypatch.setattr(ops, "flash_attention_packed_plan", counted)
    logits, kv = prefill_packed(cfg, tparams, t(toks).long(), t(q_seg),
                                t(q_pos), t(last), t(pk), t(pv), t(p_seg),
                                t(p_pos), cache_dtype=torch.float32)
    assert len(calls) == 1
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **MODEL_TOL)
    real = q_seg >= 0
    for key in ("k", "v"):
        np.testing.assert_allclose(kv[key].numpy()[:, real],
                                   np.asarray(want_kv[key])[:, real],
                                   **MODEL_TOL)
