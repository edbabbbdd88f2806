"""The port's dense decoder: init, prompt prefill and decode over a paged
or a contiguous KV cache.

Counterpart of `repro.models.transformer` for the dense family, with the
same parameter tree (per-layer tensors stacked on a leading ``L`` dim)
and the same two KV layouts: the paged pool ``(L, NB, BS, KV, dh)``
shared by every sequence, reached through per-row block tables whose
entry 0 is the trash block, and the contiguous slot cache
``(L, B, S, KV, dh)``, one ``S``-long stripe per row.  PyTorch runs
eagerly, so the layer loop is a Python loop; caches are updated in place
(the JAX package rebuilds them functionally and donates the old buffer),
which keeps one copy of the KV on the card.

Prefill attention takes one of two routes (``attn``): ``"naive"``, the
paper's attention through the fused softmax kernel
(`repro_torch.models.layers.attention_naive`, which the JAX package runs
below its chunked threshold), or ``"flash"``, the flash-attention
kernel.  :func:`prefill_packed` prefills many independent segments in
one flat row through the flash kernel's segment-masked mode.  Decode
attention is the paged or the contiguous split-K decode kernel where the
JAX package gathers the cache and runs the jnp ``attention_decode``.  Every norm goes through the fused norm kernel,
and ``h + attn_out -> norm2`` is one launch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.runtime.device import resolve_device

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.num_codebooks:
        raise ValueError(f"{cfg.name}: the port serves dense single-"
                         f"codebook decoders, not family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, seed: int = 0,
                param_dtype: Optional[str] = None) -> Params:
    """Random weights in ``cfg.dtype`` on ``device`` (default ``"cuda"``;
    raises without a card unless ``device="cpu"``).  Draws from
    ``generator`` (which must live on ``device``), or from a fresh one
    seeded with ``seed``; no global random state is touched."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = L.torch_dtype(param_dtype or cfg.dtype)
    params: Params = {"embed": L.init_embedding(cfg, gen, dtype, dev)}
    blocks = [{"norm1": L.init_norm(cfg, cfg.d_model, dtype, dev),
               "attn": L.init_attention(cfg, gen, dtype, dev),
               "norm2": L.init_norm(cfg, cfg.d_model, dtype, dev),
               "ffn": L.init_ffn(cfg, gen, dtype, dev)}
              for _ in range(cfg.num_layers)]
    params["layers"] = _stack(blocks)
    params["final_norm"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
    return params


def _stack(blocks):
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked tree (views, no copies)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, max_blocks: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """An empty paged decode cache.  K/V live in one pool of
    ``num_blocks`` blocks of ``block_size`` tokens shared by every row;
    ``block_tables`` (B, max_blocks) maps each row's logical blocks to
    pool blocks and defaults to 0, the trash block, so unassigned entries
    read masked garbage and absorb stray writes."""
    _check_family(cfg)
    dev = resolve_device(device)
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    pool = (cfg.num_layers, num_blocks, block_size, kv, dh)
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "pos_offset": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(pool, dtype=dtype, device=dev),
        "v": torch.zeros(pool, dtype=dtype, device=dev),
        "block_tables": torch.zeros((batch, max_blocks), dtype=torch.int32,
                                    device=dev),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """An empty contiguous decode cache: ``k``/``v`` (L, B, max_len, KV,
    dh), one stripe per row, plus ``len`` and ``pos_offset`` (B,)."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "pos_offset": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


#: prefill attention routes of `forward_hidden`
ATTN_ROUTES = ("flash", "naive")


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, collect_cache: bool = False,
                   cache_dtype: torch.dtype = torch.float32,
                   cache_len: Optional[int] = None, attn: str = "flash"):
    """Causal pass over right-padded prompts.  Returns ``(h_final,
    parts)``; with ``collect_cache`` parts holds every layer's k/v as
    (L, B, max(S, cache_len), KV, dh) in ``cache_dtype``, zero past S,
    else None.  ``attn`` picks the attention route: ``"flash"`` (the
    flash-attention kernel, the generative prefill's) or ``"naive"``
    (scores, the fused softmax kernel, weights times V: the
    classification path's, as the JAX package's ``_attn`` picks below
    its chunked threshold)."""
    _check_family(cfg)
    if attn not in ATTN_ROUTES:
        raise ValueError(f"attn={attn!r}: expected one of {ATTN_ROUTES}")
    b, s = tokens.shape
    h = L.embed_tokens(cfg, params["embed"], tokens)
    positions = L.positions_for(cfg, (b, s), device=tokens.device)
    parts = None
    if collect_cache:
        width = max(s, cache_len or 0)
        shape = (cfg.num_layers, b, width, cfg.num_kv_heads, cfg.head_dim)
        alloc = torch.zeros if width > s else torch.empty
        parts = {"k": alloc(shape, dtype=cache_dtype, device=tokens.device),
                 "v": alloc(shape, dtype=cache_dtype, device=tokens.device)}
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
        if attn == "naive":
            a = L.attention_naive(cfg, q, k, v, causal=True)
        else:
            a = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2),
                                    causal=True).transpose(1, 2)
        out = L.attention_output(blk["attn"], a)
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + L.apply_ffn(cfg, blk["ffn"], hn2)
        if parts is not None:
            parts["k"][i, :, :s] = k
            parts["v"][i, :, :s] = v
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, parts


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            true_lengths: Optional[torch.Tensor] = None,
            cache_dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt pass over right-padded ``tokens`` (B, S).  Returns the
    logits at each row's last real token (B, V) and a contiguous cache:
    ``k``/``v`` (L, B, max(S, max_len), KV, dh), zero past S, with
    ``len`` (each row's true length) and ``pos_offset`` (B,) int32.  The
    engine decodes it in place or splices it into a slot cache or a
    paged pool."""
    bsz, seq = tokens.shape
    h, cache = forward_hidden(cfg, params, tokens, collect_cache=True,
                              cache_dtype=cache_dtype, cache_len=max_len)
    if true_lengths is None:
        lens = torch.full((bsz,), seq, dtype=torch.int32,
                          device=tokens.device)
    else:
        lens = true_lengths.to(device=tokens.device, dtype=torch.int32)
    logits = logits_at(cfg, params, h, lens - 1)
    cache["len"] = lens
    cache["pos_offset"] = torch.zeros_like(lens)
    return logits, cache


def prefill_packed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   seg_ids: torch.Tensor, positions: torch.Tensor,
                   last_idx: torch.Tensor, prefix_k: torch.Tensor,
                   prefix_v: torch.Tensor, prefix_seg: torch.Tensor,
                   prefix_pos: torch.Tensor, *,
                   cache_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill many independent sequences in ONE pass.

    ``tokens`` (1, P) concatenates every segment's fresh (uncached)
    tokens back to back, right-padded to the pack bucket; ``seg_ids``
    (P,) int32 carries the owning segment per slot (negative = padding)
    and ``positions`` (P,) the absolute position within that segment (a
    segment resuming after ``off`` cached tokens contributes ``off..``).
    ``prefix_k`` / ``prefix_v`` (L, P_pre, KV, dh) concatenate every
    segment's cached prefix KV, labelled by ``prefix_seg`` / ``prefix_pos``
    (P_pre,) the same way, and go before the fresh keys of every layer;
    ``P_pre == 0`` is the all-cold case.  Attention is causal within
    segments (`repro_torch.models.layers.attention_packed`), so each
    segment computes what its own prefill would have.

    Returns ``(logits, {"k", "v"})``: logits (N, V) gathered at
    ``last_idx`` (N,), each segment's last fresh token (padding entries
    point anywhere harmless), and the suffix-only K/V (L, P, KV, dh) in
    ``cache_dtype`` for the caller to scatter into per-segment blocks."""
    _check_family(cfg)
    p = tokens.shape[1]
    h = L.embed_tokens(cfg, params["embed"], tokens)
    pos_in = positions[None]
    use_prefix = prefix_k.shape[1] > 0
    if use_prefix:
        k_seg = torch.cat([prefix_seg, seg_ids])
        k_pos = torch.cat([prefix_pos, positions])
    else:
        k_seg, k_pos = seg_ids, positions
    shape = (cfg.num_layers, p, cfg.num_kv_heads, cfg.head_dim)
    parts = {"k": torch.empty(shape, dtype=cache_dtype, device=h.device),
             "v": torch.empty(shape, dtype=cache_dtype, device=h.device)}
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, pos_in)
        if use_prefix:
            k_all = torch.cat([prefix_k[i][None].to(k.dtype), k], dim=1)
            v_all = torch.cat([prefix_v[i][None].to(v.dtype), v], dim=1)
        else:
            k_all, v_all = k, v
        a = L.attention_packed(cfg, q, k_all, v_all, q_seg=seg_ids,
                               k_seg=k_seg, q_pos=positions, k_pos=k_pos)
        out = L.attention_output(blk["attn"], a)
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + L.apply_ffn(cfg, blk["ffn"], hn2)
        parts["k"][i] = k[0]
        parts["v"][i] = v[0]
    h = L.apply_norm(cfg, params["final_norm"], h)
    h_last = h[:, last_idx.to(h.device).long()]
    return L.lm_logits(cfg, params["embed"], h_last)[0], parts


def logits_at(cfg: ModelConfig, params: Params, h: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Logits (B, V) at position ``idx[b]`` of each row of ``h`` (B, S,
    d): the rows are gathered first, so the vocabulary-wide head runs
    over B rows, not B * S."""
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, idx.to(h.device).long()][:, None]
    return L.lm_logits(cfg, params["embed"], h_last)[:, 0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params,
                cache: Dict[str, torch.Tensor], tokens_t: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over a paged cache (``block_tables`` present) or a
    contiguous one.  tokens_t: (B,).  Writes each row's new K/V at
    ``cache['len']`` IN PLACE and returns ``(logits (B, V), cache')``
    where ``cache'`` shares the K/V (and tables) and has ``len + 1``."""
    _check_family(cfg)
    h = L.embed_tokens(cfg, params["embed"], tokens_t[:, None])  # (B,1,d)
    pos = cache["len"] + cache["pos_offset"]
    if "block_tables" in cache:
        h = _decode_attn_paged(cfg, params, cache, h, pos[:, None])
    else:
        h = _decode_attn(cfg, params, cache, h, pos[:, None])
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.lm_logits(cfg, params["embed"], h)[:, 0]
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache


def _write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor, index) -> None:
    """Write one new token per row into one layer's contiguous cache, in
    place.  k_cache: (B, S, KV, dh); k: (B, 1, KV, dh); index: (rows,
    write positions) for advanced indexing."""
    k_cache[index] = k[:, 0].to(k_cache.dtype)
    v_cache[index] = v[:, 0].to(v_cache.dtype)


def _decode_attn(cfg, params, cache, h, positions):
    """Decode layers over the contiguous cache: each layer attends to
    ``len + 1`` keys through the contiguous decode kernel, which reads
    the layer's (B, S, KV, dh) slice as a strided (B, KV, S, dh) view."""
    lens = cache["len"]
    # each row writes at its length, clamped to S - 1 as the JAX
    # package's dynamic_update_slice clamps it
    rows = torch.arange(lens.shape[0], device=lens.device)
    index = (rows, torch.clamp(lens, 0, cache["k"].shape[2] - 1).long())
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        k_c, v_c = cache["k"][i], cache["v"][i]
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
        _write_kv(k_c, v_c, k, v, index)
        attn = ops.flash_decode(q[:, 0], k_c.transpose(1, 2),
                                v_c.transpose(1, 2), lens + 1)
        out = L.attention_output(blk["attn"], attn[:, None])
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + L.apply_ffn(cfg, blk["ffn"], hn2)
    return h


def _paged_write_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, tables: torch.Tensor,
                    pos: torch.Tensor) -> None:
    """Scatter one new token per row into one layer's pool, in place.

    k_pool: (NB, BS, KV, dh); k: (B, 1, KV, dh); tables: (B, MB); pos:
    (B,) logical write position.  Positions past the table (a finished
    row frozen at its final length) are clamped; such a row's table
    entry is the trash block by then, so the write touches no live
    sequence."""
    nb, bs = k_pool.shape[:2]
    mb = tables.shape[1]
    pos_c = torch.clamp(pos, max=mb * bs - 1).long()
    blk = torch.gather(tables.long(), 1, (pos_c // bs)[:, None])[:, 0]
    flat = blk * bs + pos_c % bs
    k_pool.view((nb * bs,) + k_pool.shape[2:])[flat] = \
        k[:, 0].to(k_pool.dtype)
    v_pool.view((nb * bs,) + v_pool.shape[2:])[flat] = \
        v[:, 0].to(v_pool.dtype)


def _decode_attn_paged(cfg, params, cache, h, positions):
    tables = cache["block_tables"]
    lens = cache["len"]
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
        _paged_write_kv(k_pool, v_pool, k, v, tables, lens)
        attn = ops.flash_decode_paged(q[:, 0], k_pool, v_pool, tables,
                                      lens + 1)
        out = L.attention_output(blk["attn"], attn[:, None])
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + L.apply_ffn(cfg, blk["ffn"], hn2)
    return h
