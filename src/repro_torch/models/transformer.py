"""The port's dense decoder: init, prompt prefill and paged decode.

Counterpart of `repro.models.transformer` for the dense family, with the
same parameter tree (per-layer tensors stacked on a leading ``L`` dim)
and the same paged KV layout: one pool ``(L, NB, BS, KV, dh)`` shared by
every sequence, reached through per-row block tables whose entry 0 is the
trash block.  PyTorch runs eagerly, so the layer loop is a Python loop;
the pool is updated in place (the JAX package rebuilds it functionally
and donates the old buffer), which keeps one copy of the KV on the card.

Where the JAX package's prefill takes ``attention_naive`` and its paged
decode gathers the pool (``_paged_gather`` + ``attention_decode``), the
port calls its flash-attention and paged-decode kernels; every norm goes
through the fused norm kernel, and ``h + attn_out -> norm2`` is one launch.
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


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, collect_cache: bool = False,
                   cache_dtype: torch.dtype = torch.float32):
    """Causal pass over right-padded prompts.  Returns ``(h_final,
    parts)``; with ``collect_cache`` parts holds every layer's k/v as
    (L, B, S, KV, dh) in ``cache_dtype``, else None."""
    _check_family(cfg)
    b, s = tokens.shape
    h = L.embed_tokens(cfg, params["embed"], tokens)
    positions = L.positions_for(cfg, (b, s), device=tokens.device)
    parts = None
    if collect_cache:
        shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)
        parts = {"k": torch.empty(shape, dtype=cache_dtype,
                                  device=tokens.device),
                 "v": torch.empty(shape, dtype=cache_dtype,
                                  device=tokens.device)}
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
        attn = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
        out = L.attention_output(blk["attn"], attn.transpose(1, 2))
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + L.apply_ffn(cfg, blk["ffn"], hn2)
        if parts is not None:
            parts["k"][i] = k
            parts["v"][i] = v
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, parts


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            true_lengths: Optional[torch.Tensor] = None,
            cache_dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt pass over right-padded ``tokens`` (B, S).  Returns the
    logits at each row's last real token (B, V) and the prompt KV parts
    ``{"k", "v"}`` (L, B, S, KV, dh) plus ``"len"`` (B,) int32, for the
    engine to scatter into paged blocks."""
    bsz, seq = tokens.shape
    h, parts = forward_hidden(cfg, params, tokens, collect_cache=True,
                              cache_dtype=cache_dtype)
    if true_lengths is None:
        lens = torch.full((bsz,), seq, dtype=torch.int32,
                          device=tokens.device)
    else:
        lens = true_lengths.to(device=tokens.device, dtype=torch.int32)
    idx = (lens - 1).long()
    h_last = h[torch.arange(bsz, device=tokens.device), idx][:, None]
    logits = L.lm_logits(cfg, params["embed"], h_last)[:, 0]
    parts["len"] = lens
    return logits, parts


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params,
                cache: Dict[str, torch.Tensor], tokens_t: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over a paged cache.  tokens_t: (B,).  Writes each
    row's new K/V at ``cache['len']`` into the pool IN PLACE and returns
    ``(logits (B, V), cache')`` where ``cache'`` shares the pool and
    tables and has ``len + 1``."""
    _check_family(cfg)
    if "block_tables" not in cache:
        raise ValueError("the port decodes the paged KV layout only")
    h = L.embed_tokens(cfg, params["embed"], tokens_t[:, None])  # (B,1,d)
    pos = cache["len"] + cache["pos_offset"]
    h = _decode_attn_paged(cfg, params, cache, h, pos[:, None])
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.lm_logits(cfg, params["embed"], h)[:, 0]
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache


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
