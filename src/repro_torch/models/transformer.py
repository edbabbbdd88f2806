"""The port's decoder: init, the training loss, prompt prefill and decode
over a paged or a contiguous KV cache.

Counterpart of `repro.models.transformer` for every family: the
transformer ones, dense, VLM, audio and MoE (``[norm -> GQA attn -> norm
-> FFN or MoE] x L``), the SSM (``[norm -> mamba] x L``) and the hybrid
(a mamba backbone and ONE weight-shared attention + FFN block after
every ``attn_every`` layers), with the
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
kernel.  :func:`prefill_suffix` resumes a prompt after cached tokens
(the prefix cache's hits and chunked prefill's chunks) through the
flash kernel's causal mode, the queries aligned as the last keys, and
:func:`prefill_packed` prefills many independent segments in one flat
row through the flash kernel's segment-masked mode.  Decode
attention is the paged or the contiguous split-K decode kernel where the
JAX package gathers the cache and runs the jnp ``attention_decode``.  Every norm goes through the fused norm kernel,
and ``h + attn_out -> norm2`` is one launch.

The VLM family takes precomputed patch embeddings in the first slots of
a prompt (:func:`embed_inputs`, ``embeds_override``) at M-RoPE's grid
positions, and its text continues from position 1 after the image
(``pos_offset``); the audio family (MusicGen) sums K codebook embeddings
a frame and predicts K codebooks, through :func:`prefill` and
:func:`decode_step` only, as in the JAX package.  So do the SSM and
hybrid families, over the contiguous layout only: their cache holds each
layer's conv window ``conv`` (L, B, k-1, d_inner) and f32 scan state
``state`` (`repro_torch.models.ssm`), and the hybrid's also the shared
block's KV, ``shared_k`` / ``shared_v`` (n_apps, B, S, KV, dh), one
stripe per application; a decode step writes all of them in place.

:func:`forward_train` is the training loss of every family under a
:class:`ModelRuntime` (attention route, remat policy, aux-loss weight),
the JAX package's: its attention is ``attention_naive`` or, blockwise,
``attention_chunked_train``, never a flash kernel (which has no
backward), and the MoE's aux loss is carried out of the layer loop.

Over a mesh (`repro_torch.distributed`: parameters, batches and caches
DTensors placed by `repro_torch.distributed.plan`, the calls under a
``sharding_rules`` context) the same functions run SPMD: the residual
stream is constrained after every block (over ``act_seq`` too where
``rt.seq_shard``), and the kernels run on each rank's shard.  A decode
step writes each rank's rows of its cache shard, and gathers a cache
sharded on the head dim or the sequence before the decode kernel, which
takes the batch and the kv heads sharded only.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import FAMILIES, SSM_FAMILIES, ModelConfig
from repro_torch.distributed.sharding import (constrain, from_local,
                                              is_dtensor)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.runtime.device import resolve_device

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the port serves the families "
                         f"{FAMILIES}, not {cfg.family!r}")


def _num_shared_apps(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every if cfg.attn_every else 0


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return bool(cfg.attn_every) and i % cfg.attn_every == cfg.attn_every - 1


def _no_codebooks(cfg: ModelConfig, what: str) -> None:
    """The JAX package's refusal of codebook models on the paged serving
    path's prefills."""
    if cfg.num_codebooks:
        raise ValueError(f"{what} does not support codebook models")


def _ffn_aux(cfg: ModelConfig, blk: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward and its aux loss: the MoE layer's
    load-balancing loss, or None for the dense FFN."""
    if cfg.family == "moe":
        return M.apply_moe(cfg, blk["moe"], x)
    return L.apply_ffn(cfg, blk["ffn"], x), None


def _ffn(cfg: ModelConfig, blk: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward, its aux loss dropped, as the JAX
    package's inference paths drop it."""
    return _ffn_aux(cfg, blk, x)[0]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, seed: int = 0,
                param_dtype: Optional[str] = None) -> Params:
    """Random weights in ``cfg.dtype`` (a MoE router in f32) on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``).  Draws from
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
    if cfg.family == "hybrid":
        # the shared block draws from a generator of its own, as the JAX
        # package draws it from a key of its own (the other families'
        # draws are left as they were)
        draw = torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev)
        # fake tensors (abstract_params) hold no value: any seed will do
        shared_seed = 0 if _is_fake(draw) else int(draw)
    blocks = []
    for _ in range(cfg.num_layers):
        if cfg.family in SSM_FAMILIES:
            blocks.append({"norm1": L.init_norm(cfg, cfg.d_model, dtype, dev),
                           "mamba": S.init_mamba(cfg, gen, dtype, dev)})
            continue
        blk = {"norm1": L.init_norm(cfg, cfg.d_model, dtype, dev),
               "attn": L.init_attention(cfg, gen, dtype, dev),
               "norm2": L.init_norm(cfg, cfg.d_model, dtype, dev)}
        if cfg.family == "moe":
            blk["moe"] = M.init_moe(cfg, gen, dtype, dev)
        else:
            blk["ffn"] = L.init_ffn(cfg, gen, dtype, dev)
        blocks.append(blk)
    params["layers"] = _stack(blocks)
    if cfg.family == "hybrid":
        sgen = torch.Generator(device=dev)
        sgen.manual_seed(shared_seed)
        params["shared"] = {
            "norm1": L.init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": L.init_attention(cfg, sgen, dtype, dev),
            "norm2": L.init_norm(cfg, cfg.d_model, dtype, dev),
            "ffn": L.init_ffn(cfg, sgen, dtype, dev),
        }
    params["final_norm"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
    return params


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def abstract_params(cfg: ModelConfig, param_dtype: Optional[str] = None
                    ) -> Params:
    """The parameter tree as fake tensors (shapes and dtypes, no memory):
    the JAX package's ``eval_shape`` of its ``init_params``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_params(cfg, device="cpu", param_dtype=param_dtype)


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
    read masked garbage and absorb stray writes.  Attention families
    only, as in the JAX package."""
    _check_family(cfg)
    if cfg.family in SSM_FAMILIES:
        raise ValueError("paged KV applies to attention-family caches "
                         "only (SSM state is O(1) per sequence)")
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


def state_specs(cfg: ModelConfig, batch: int, width: int,
                dtype: torch.dtype) -> Dict[str, Tuple[Tuple[int, ...],
                                                      torch.dtype]]:
    """(shape, dtype) of every per-row leaf of a contiguous cache of
    ``width`` positions (what a prefill collects): ``k``/``v`` (L, B,
    width, KV, dh) in ``dtype``; for the SSM families ``conv`` (L, B,
    k-1, d_inner) in ``dtype`` and ``state`` (L, B, ...) in f32, and for
    the hybrid ``shared_k``/``shared_v`` (n_apps, B, width, KV, dh)."""
    kv = (cfg.num_kv_heads, cfg.head_dim)
    if cfg.family not in SSM_FAMILIES:
        shape = (cfg.num_layers, batch, width) + kv
        return {"k": (shape, dtype), "v": (shape, dtype)}
    conv_s, state_s = S.ssm_state_shapes(cfg, batch)
    specs = {"conv": ((cfg.num_layers,) + conv_s, dtype),
             "state": ((cfg.num_layers,) + state_s, torch.float32)}
    if cfg.attn_every:
        shape = (_num_shared_apps(cfg), batch, width) + kv
        specs["shared_k"] = (shape, dtype)
        specs["shared_v"] = (shape, dtype)
    return specs


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """An empty contiguous decode cache: ``len`` and ``pos_offset`` (B,)
    and the leaves of :func:`state_specs` (``k``/``v`` (L, B, max_len,
    KV, dh), one stripe per row, or the SSM families' state), zeroed.
    On ``device="meta"`` it allocates nothing (:func:`cache_specs`)."""
    _check_family(cfg)
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    cache = {
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "pos_offset": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    for name, (shape, dt) in state_specs(cfg, batch, max_len,
                                         dtype).items():
        cache[name] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """:func:`make_cache`'s tensors on the ``meta`` device: shapes and
    dtypes, no memory (the JAX package's ``eval_shape`` of its
    ``make_cache``, bf16 by default as there)."""
    return make_cache(cfg, batch, max_len, dtype, device="meta")


#: prefill attention routes of `forward_hidden`
ATTN_ROUTES = ("flash", "naive")


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 embeds_override: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, d) of (B, S) tokens, or (B, K, S) codes;
    ``embeds_override`` (B, N, d), where given, takes the first N slots
    (the VLM stub front end's precomputed patch embeddings)."""
    h = L.embed_tokens(cfg, params["embed"], tokens)
    if embeds_override is not None:
        h = h.clone()
        h[:, :embeds_override.shape[1]] = embeds_override.to(h.dtype)
    return h


#: the contiguous cache's leaves with a sequence axis (axis 2): a prompt
#: pass fills their first S positions, the slot cache's grow pads them
SEQ_LEAVES = ("k", "v", "shared_k", "shared_v")


def _kv_parts(shape: Tuple[int, ...], dtype: torch.dtype,
              device: torch.device,
              kv_out: Optional[Dict[str, torch.Tensor]],
              zeros: bool = False) -> Dict[str, torch.Tensor]:
    """The k/v tensors a prefill writes its cache into (:func:`_parts`
    of two leaves of ``shape`` and ``dtype``)."""
    return _parts({key: (shape, dtype) for key in ("k", "v")}, device,
                  kv_out, zeros)


def _parts(specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
           device: torch.device, kv_out: Optional[Dict[str, torch.Tensor]],
           zeros: bool = False) -> Dict[str, torch.Tensor]:
    """The tensors a prefill writes its cache into: ``kv_out``'s of the
    names of ``specs`` where given (a graph's static outputs), which must
    have the shapes and dtypes there, else new ones (zeroed with
    ``zeros``)."""
    if kv_out is None:
        alloc = torch.zeros if zeros else torch.empty
        return {key: alloc(shape, dtype=dtype, device=device)
                for key, (shape, dtype) in specs.items()}
    for key, (shape, dtype) in specs.items():
        t = kv_out[key]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"kv_out[{key!r}] is {tuple(t.shape)} "
                             f"{t.dtype}; the cache is {tuple(shape)} "
                             f"{dtype}")
    return {key: kv_out[key] for key in specs}


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, rt: "ModelRuntime" = None, collect_cache: bool = False,
                   cache_dtype: torch.dtype = torch.float32,
                   cache_len: Optional[int] = None, attn: str = "flash",
                   kv_out: Optional[Dict[str, torch.Tensor]] = None,
                   embeds_override: Optional[torch.Tensor] = None,
                   num_prefix_patches: int = 0):
    """Causal pass over right-padded prompts, (B, S) tokens or (B, K, S)
    codes.  Returns ``(h_final,
    parts)``; with ``collect_cache`` parts holds every layer's k/v as
    (L, B, max(S, cache_len), KV, dh) in ``cache_dtype``, zero past S,
    written into ``kv_out``'s tensors where given, else None.  ``attn``
    picks the attention route: ``"flash"`` (the
    flash-attention kernel, the generative prefill's) or ``"naive"``
    (scores, the fused softmax kernel, weights times V: the
    classification path's, as the JAX package's ``_attn`` picks below
    its chunked threshold).  ``embeds_override`` as in
    :func:`embed_inputs`; ``num_prefix_patches`` lays out M-RoPE's image
    grid (`repro_torch.models.layers.positions_for`).  For the SSM
    families parts holds the state of :func:`state_specs` instead
    (:func:`_forward_hidden_ssm`).  ``rt`` (default
    :data:`DEFAULT_RUNTIME`) gives ``seq_shard``."""
    _check_family(cfg)
    rt = DEFAULT_RUNTIME if rt is None else rt
    if attn not in ATTN_ROUTES:
        raise ValueError(f"attn={attn!r}: expected one of {ATTN_ROUTES}")
    b, s = tokens.shape[0], tokens.shape[-1]
    h = embed_inputs(cfg, params, tokens, embeds_override)
    positions = _placed_like(L.positions_for(
        cfg, (b, s), num_prefix_patches, device=tokens.device), h)
    parts = None
    width = max(s, cache_len or 0)
    specs = state_specs(cfg, b, width, cache_dtype)
    if collect_cache and is_dtensor(h):
        if kv_out is not None:
            raise ValueError("kv_out (a graph's static buffers) takes plain "
                             "tensors; over a mesh the cache is DTensors")
        parts = {key: [] for key in specs}
    elif collect_cache:
        parts = _parts(specs, tokens.device, kv_out, zeros=width > s)
        if kv_out is not None and width > s:
            for key in SEQ_LEAVES:
                if key in parts:
                    parts[key][:, :, s:].zero_()
    attend = functools.partial(_prompt_attention, attn=attn, cfg=cfg)
    if cfg.family in SSM_FAMILIES:
        h, parts = _forward_hidden_ssm(cfg, params, h, positions, attend,
                                       parts, rt)
        return h, _stacked(parts, specs, s)
    for i in range(cfg.num_layers):
        h, _, k, v = _attn_layer(cfg, layer_params(params, i), h, positions,
                                 attend, rt)
        if parts is not None:
            _store(parts, "k", i, k)
            _store(parts, "v", i, v)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, _stacked(parts, specs, s)


def _placed_like(positions: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Position ids (B, S), or M-RoPE's (3, B, S), placed with ``h``'s
    batch shards where ``h`` is a DTensor (each rank slices its own rows,
    no communication), so no op meets a global-batch plain tensor that
    DTensor would answer by gathering the activations."""
    if not is_dtensor(h):
        return positions
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = h.device_mesh
    bdim = positions.dim() - 2
    want = [Shard(bdim) if p == Shard(0) else Replicate()
            for p in h.placements]
    full = DTensor.from_local(positions, mesh, [Replicate()] * mesh.ndim)
    return full.redistribute(mesh, want)


def _store(parts: Dict[str, Any], key: str, i: int,
           src: torch.Tensor) -> None:
    """Entry ``i`` of cache leaf ``key``: ``parts[key][i, :, :S] = src``
    (a prompt pass's (B, S, ...) part into the first S positions of a
    (B, width, ...) leaf), or, over a mesh, appended to the list that
    :func:`_stacked` stacks."""
    if isinstance(parts[key], list):
        parts[key].append(src)
    elif key in SEQ_LEAVES:
        parts[key][i, :, :src.shape[1]] = src
    else:
        parts[key][i] = src


def _stacked(parts: Optional[Dict[str, Any]], specs, s: int):
    """A mesh's cache parts (lists of DTensors) stacked into the leaves of
    ``specs``, cast and zero-padded past S like the single-device cache;
    plain parts pass."""
    if parts is None or not any(isinstance(v, list) for v in parts.values()):
        return parts
    out = {}
    for key, (shape, dtype) in specs.items():
        t = torch.stack(parts[key]).to(dtype)
        if key in SEQ_LEAVES and shape[2] > s:
            t = F.pad(t, (0, 0, 0, 0, 0, shape[2] - s))
        out[key] = t
    return out


def _residual_constrain(rt: "ModelRuntime", h: torch.Tensor
                        ) -> torch.Tensor:
    """The residual stream's placement after a block: the batch over DP,
    and with ``rt.seq_shard`` the sequence over ``model`` (Megatron's
    sequence parallelism)."""
    if rt.seq_shard:
        return constrain(h, "batch", "act_seq", "embed")
    return constrain(h, "batch", None, "embed")


def _attn_layer(cfg: ModelConfig, blk: Params, h: torch.Tensor,
                positions: torch.Tensor, attend, rt: "ModelRuntime"):
    """One layer of a transformer family over a whole sequence: norm ->
    qkv + rope -> ``attend(q, k, v)`` -> wo -> (+ h) norm -> FFN or MoE
    (+ h).  Returns ``(h, aux, k, v)``, aux the MoE's loss or None."""
    hn = L.apply_norm(cfg, blk["norm1"], h)
    q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
    out = L.attention_output(blk["attn"], attend(q, k, v))
    hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
    f, aux = _ffn_aux(cfg, blk, hn2)
    return _residual_constrain(rt, h + f), aux, k, v


def _prompt_attention(q, k, v, attn: str, cfg: ModelConfig):
    """Causal attention of a prompt pass by route (see
    :func:`forward_hidden`): (B,S,H,dh) q, (B,S,KV,dh) k/v."""
    if is_dtensor(q):
        return L.on_local_heads(functools.partial(
            _prompt_attention, attn=attn, cfg=cfg), q, k, v)
    if attn == "naive":
        return L.attention_naive(cfg, q, k, v, causal=True)
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)


def _norm_add(cfg: ModelConfig, p: Params, h: torch.Tensor,
              out: Optional[torch.Tensor]):
    """``(norm(h + out), h + out)`` in one norm launch, or ``(norm(h),
    h)`` where there is no block output to add yet: the mamba backbone
    adds each block's output to the residual stream in the next norm."""
    if out is None:
        return L.apply_norm(cfg, p, h), h
    return L.apply_norm(cfg, p, out, residual=h)


def _forward_hidden_ssm(cfg: ModelConfig, params: Params, h: torch.Tensor,
                        positions: torch.Tensor, attend,
                        parts: Optional[Dict[str, torch.Tensor]],
                        rt: "ModelRuntime"):
    """The mamba backbone over whole prompts (no padding: the state would
    roll through it); the hybrid runs its shared block (norm -> qkv +
    rope -> ``attend`` -> wo -> norm -> FFN) after every
    ``attn_every``-th layer.  Where ``parts`` is given, every layer's
    conv window and scan state go there, and each application's k/v
    into the first S positions of ``shared_k`` / ``shared_v``."""
    s = h.shape[1]
    out, app = None, 0
    for i in range(cfg.num_layers):
        h, out, conv, state, kv = _ssm_layer(
            cfg, layer_params(params, i), _shared_at(cfg, params, i), h,
            out, positions, attend, rt)
        if parts is not None:
            _store(parts, "conv", i, conv)
            _store(parts, "state", i, state)
        if kv is None:
            continue
        if parts is not None:
            _store(parts, "shared_k", app, kv[0])
            _store(parts, "shared_v", app, kv[1])
        app += 1
    h, _ = _norm_add(cfg, params["final_norm"], h, out)
    return h, parts


def _shared_at(cfg: ModelConfig, params: Params, i: int):
    """The hybrid's shared block where it runs after layer ``i``, else
    None."""
    return params["shared"] if _shared_after(cfg, i) else None


def _ssm_layer(cfg: ModelConfig, blk: Params, shared: Optional[Params],
               h: torch.Tensor, out: Optional[torch.Tensor],
               positions: torch.Tensor, attend, rt: "ModelRuntime"):
    """One mamba layer over a whole sequence, and after it the shared
    block where ``shared`` is given.  The residual stream ``h`` takes the
    previous block's ``out`` in this layer's norm.  Returns ``(h, out,
    conv, state, kv)``: the layer's conv window and scan state, and the
    shared block's ``(k, v)`` or None."""
    hn, h = _norm_add(cfg, blk["norm1"], h, out)
    h = _residual_constrain(rt, h)
    out, conv, state = S.apply_mamba_with_state(cfg, blk["mamba"], hn, None)
    if shared is None:
        return h, out, conv, state, None
    hn, h = _norm_add(cfg, shared["norm1"], h, out)
    q, k, v = L.qkv_project(cfg, shared["attn"], hn, positions)
    hn2, h = L.apply_norm(cfg, shared["norm2"],
                          L.attention_output(shared["attn"], attend(q, k, v)),
                          residual=h)
    return h, L.apply_ffn(cfg, shared["ffn"], hn2), conv, state, (k, v)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelRuntime:
    """Execution knobs independent of the architecture: the JAX package's
    fields and defaults.  The port reads them on its train path
    (:func:`forward_train`): ``attn_impl`` (naive | chunked |
    chunked_train | auto, chunked at or above ``chunked_threshold``
    tokens), ``q_block``, ``remat`` (none | full | dots) and
    ``aux_loss_weight``.  ``kv_block`` sizes the JAX package's online
    softmax, which the port does not run (its chunked route is
    ``attention_chunked_train``).  ``unroll_decode`` has no effect: the
    port's decode is always an unrolled Python loop writing each layer's
    cache in place, the JAX package's unrolled form.  ``seq_shard``
    shards the residual stream's sequence over ``model`` between blocks
    (sequence parallelism; a no-op off a mesh).  The serving callables
    take ``rt`` too and read ``seq_shard`` from it: their attention is
    the flash and decode kernels' whatever ``attn_impl`` says."""
    attn_impl: str = "auto"        # naive | chunked | chunked_train | auto
    q_block: int = 512
    kv_block: int = 1024
    remat: str = "none"            # none | full | dots
    chunked_threshold: int = 2048  # auto: chunked when S >= this
    aux_loss_weight: float = 0.01
    seq_shard: bool = False
    unroll_decode: bool = False


DEFAULT_RUNTIME = ModelRuntime()

#: the matrix products a ``remat="dots"`` checkpoint keeps: those without
#: batch dims (the JAX package's ``checkpoint_dots_with_no_batch_dims``);
#: the batched ones (attention scores, the experts, the scan's einsums)
#: are recomputed with everything else
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, rt: ModelRuntime):
    """``fn`` as the runtime's remat policy runs it: as is (``none``),
    recomputed in the backward (``full``: ``torch.utils.checkpoint``), or
    recomputed but for the matrix products of :data:`_SAVED_DOTS`
    (``dots``: a selective checkpoint)."""
    if rt.remat == "none":
        return fn
    if rt.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if rt.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat={rt.remat!r}: expected none, full or dots")


def _train_attention(cfg: ModelConfig, rt: ModelRuntime, q, k, v):
    """Causal attention of a training forward by ``rt.attn_impl``:
    ``naive`` through `repro_torch.models.layers.attention_naive` (the
    softmax kernel with its gradient); ``chunked_train``, and
    ``chunked`` or ``auto`` at or above ``chunked_threshold``, through
    ``attention_chunked_train``.  The JAX package's ``chunked`` is its
    online-softmax ``attention_chunked``, which computes the same
    function up to rounding; the port has no backward for a flash
    kernel, so it trains both chunked routes one way."""
    impl = rt.attn_impl
    if impl == "auto":
        impl = "chunked" if q.shape[1] >= rt.chunked_threshold else "naive"
    if impl in ("chunked", "chunked_train"):
        return L.attention_chunked_train(cfg, q, k, v, causal=True,
                                         q_block=rt.q_block)
    if impl == "naive":
        return L.attention_naive(cfg, q, k, v, causal=True)
    raise ValueError(f"attn_impl={impl!r}: expected naive, chunked, "
                     "chunked_train or auto")


def _unbind_layers(cfg: ModelConfig, params: Params) -> List[Params]:
    """Every layer's slice of the stacked tree as views, from one
    ``torch.unbind`` per leaf: its backward stacks the L gradients in one
    op, where L indexings (:func:`layer_params`) would each add a
    zero-filled gradient of the whole stack."""
    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items()}
        return tree.unbind(0)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    slices = unbind(params["layers"])
    return [pick(slices, i) for i in range(cfg.num_layers)]


def _hidden_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  rt: ModelRuntime,
                  embeds_override: Optional[torch.Tensor],
                  num_prefix_patches: int):
    """The training forward up to the final norm: ``(h, aux)``, aux the
    MoE layers' losses summed in layer order (0 for the other families,
    as in the JAX package).  Each layer (a mamba layer with the shared
    block that follows it) runs under the remat policy."""
    b, s = tokens.shape[0], tokens.shape[-1]
    h = embed_inputs(cfg, params, tokens, embeds_override)
    positions = _placed_like(L.positions_for(
        cfg, (b, s), num_prefix_patches, device=tokens.device), h)
    attend = functools.partial(_train_attention, cfg, rt)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = _unbind_layers(cfg, params)
    if cfg.family in SSM_FAMILIES:
        layer = _maybe_remat(
            lambda h, out, blk, shared: _ssm_layer(
                cfg, blk, shared, h, out, positions, attend, rt)[:2], rt)
        out = None
        for i, blk in enumerate(blocks):
            h, out = layer(h, out, blk, _shared_at(cfg, params, i))
        return _norm_add(cfg, params["final_norm"], h, out)[0], aux
    layer = _maybe_remat(
        lambda h, blk: _attn_layer(cfg, blk, h, positions, attend, rt)[:2],
        rt)
    for blk in blocks:
        h, aux_l = layer(h, blk)
        if aux_l is not None:
            aux = aux + aux_l
    return L.apply_norm(cfg, params["final_norm"], h), aux


def forward_train(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
                  *, rt: ModelRuntime = DEFAULT_RUNTIME):
    """batch: ``tokens`` (B,S) or (B,K,S) codes, ``labels`` of the same
    shape, and a VLM's ``embeds_override``.  Returns ``(loss +
    rt.aux_loss_weight * aux, {"loss", "aux_loss", "perplexity"})``: the
    mean next-token cross entropy in f32 over every position (and
    codebook), the MoE's load-balancing loss, and ``exp(min(loss,
    20))``.  Every family; the norms and the attention softmax go through
    the kernels with their gradients (`repro_torch.kernels.autograd`)."""
    _check_family(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    override = batch.get("embeds_override")
    n_img = 0 if override is None else override.shape[1]
    h, aux = _hidden_train(cfg, params, tokens, rt, override, n_img)
    logits = L.lm_logits(cfg, params["embed"], h).float()
    if is_dtensor(logits):
        loss = _cross_entropy_sharded(logits, labels)
    else:
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())
    total = loss + rt.aux_loss_weight * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0))}


def _cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`forward_train`'s mean cross entropy of DTensor logits: the
    vocabulary gathered, each rank's rows summed and divided by the
    global count, the sum over the batch shards completing the mean (a
    replicated scalar DTensor).  Unsharded rows take the plain mean."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    rows = [p if p == Shard(0) else Replicate() for p in logits.placements]
    lg = logits.redistribute(mesh, rows).to_local()
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    lb = labels.redistribute(mesh, rows).to_local()
    flat_lg = lg.reshape(-1, lg.shape[-1])
    flat_lb = lb.reshape(-1).long()
    if Shard(0) not in rows:
        local = F.cross_entropy(flat_lg, flat_lb)
        return from_local(local, mesh, rows, ())
    local = F.cross_entropy(flat_lg, flat_lb, reduction="sum") / \
        labels.numel()
    part = [Partial() if p == Shard(0) else p for p in rows]
    return from_local(local, mesh, part, ()).redistribute(
        mesh, [Replicate()] * mesh.ndim)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            rt: ModelRuntime = DEFAULT_RUNTIME,
            embeds_override: Optional[torch.Tensor] = None,
            true_lengths: Optional[torch.Tensor] = None,
            cache_dtype: torch.dtype = torch.float32,
            kv_out: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt pass over right-padded ``tokens`` (B, S), or (B, K, S)
    codes.  Returns the logits at each row's last real token, (B, V) or
    (B, K, V) for a codebook model, and a contiguous cache: ``k``/``v``
    (L, B, max(S, max_len), KV, dh), zero past S (written into
    ``kv_out``'s where given), with ``len`` (each row's true length) and
    ``pos_offset`` (B,) int32: with M-RoPE and an image prefix of N
    patches it is -(N - 1), so decoding continues the text positions.
    The engine decodes it in place or splices it into a slot cache or a
    paged pool.  ``embeds_override`` as in :func:`embed_inputs`.  An SSM
    or hybrid model's prompts are not padded (``true_lengths`` raises:
    its state would roll through the padding) and its cache holds the
    state of :func:`state_specs`."""
    bsz, seq = tokens.shape[0], tokens.shape[-1]
    if true_lengths is not None and cfg.family in SSM_FAMILIES:
        raise ValueError("ragged prefill unsupported for SSM state "
                         "(group requests by exact length instead)")
    n_img = 0 if embeds_override is None else embeds_override.shape[1]
    h, cache = forward_hidden(cfg, params, tokens, rt=rt, collect_cache=True,
                              cache_dtype=cache_dtype, cache_len=max_len,
                              kv_out=kv_out, embeds_override=embeds_override,
                              num_prefix_patches=n_img)
    if true_lengths is None:
        lens = torch.full((bsz,), seq, dtype=torch.int32,
                          device=tokens.device)
    else:
        lens = true_lengths.to(device=tokens.device, dtype=torch.int32)
    logits = logits_at(cfg, params, h, lens - 1)
    cache["len"] = lens
    cache["pos_offset"] = torch.zeros_like(lens)
    if cfg.rope == "mrope" and n_img:
        cache["pos_offset"] -= n_img - 1
    return logits, cache


def prefill_suffix(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor, *,
                   prefix_len: int, rt: ModelRuntime = DEFAULT_RUNTIME,
                   true_lengths: Optional[torch.Tensor] = None,
                   cache_dtype: torch.dtype = torch.float32,
                   kv_out: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Resume a prompt pass after ``prefix_len`` cached tokens (the
    prefix cache's suffix prefill, and the per-chunk pass of chunked
    prefill: each chunk resumes at the previous chunk's seam, with the
    prefix KV read back from the request's own paged blocks).

    ``tokens`` (B, S_suffix) holds the right-padded *uncached* remainder
    of each prompt; ``prefix_k`` / ``prefix_v`` (L, B, prefix_len, KV,
    dh) is the prefix KV gathered from the paged pool (f32 there, cast to
    the activations' dtype here).  Queries run at positions
    ``prefix_len ..`` and each layer attends over [prefix, suffix]
    through the flash kernel's causal mode with Sk = ``prefix_len`` +
    S_suffix: the kernel aligns the queries as the last Sq keys, which
    continues the causal mask across the seam.  Every row's padding keys
    sit after all of its real keys, so no per-row length is needed.
    ``prefix_len == 0`` (the first chunk of a cold prompt) is a plain
    prompt pass.

    Returns ``(last-token logits (B, V), {"k", "v"})`` where k/v are the
    *suffix-only* parts (L, B, S_suffix, KV, dh) in ``cache_dtype``
    (``kv_out``'s tensors where given): the caller scatters them into its
    own (copy-on-write) blocks, and the shared prefix blocks are never
    written."""
    _check_family(cfg)
    if cfg.family in SSM_FAMILIES:
        raise ValueError("suffix prefill resumes attention KV only; SSM "
                         "state cannot restart mid-sequence")
    _no_codebooks(cfg, "suffix prefill")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    bsz, seq = tokens.shape
    h = L.embed_tokens(cfg, params["embed"], tokens)
    positions = _placed_like(L.positions_for(
        cfg, (bsz, seq), 0, offset=prefix_len, device=tokens.device), h)
    shape = (cfg.num_layers, bsz, seq, cfg.num_kv_heads, cfg.head_dim)
    parts = _kv_parts(shape, cache_dtype, h.device, kv_out)
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn = L.apply_norm(cfg, blk["norm1"], h)
        q, k, v = L.qkv_project(cfg, blk["attn"], hn, positions)
        if prefix_len:
            k_all = torch.cat([prefix_k[i].to(k.dtype), k], dim=1)
            v_all = torch.cat([prefix_v[i].to(v.dtype), v], dim=1)
        else:
            k_all, v_all = k, v
        a = ops.flash_attention(q.transpose(1, 2), k_all.transpose(1, 2),
                                v_all.transpose(1, 2),
                                causal=True).transpose(1, 2)
        out = L.attention_output(blk["attn"], a)
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = _residual_constrain(rt, h + _ffn(cfg, blk, hn2))
        parts["k"][i] = k
        parts["v"][i] = v
    h = L.apply_norm(cfg, params["final_norm"], h)
    if true_lengths is None:
        last = torch.full((bsz,), seq - 1, dtype=torch.int32,
                          device=h.device)
    else:
        last = true_lengths.to(device=h.device, dtype=torch.int32) - 1
    return logits_at(cfg, params, h, last), parts


def prefill_packed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   seg_ids: torch.Tensor, positions: torch.Tensor,
                   last_idx: torch.Tensor, prefix_k: torch.Tensor,
                   prefix_v: torch.Tensor, prefix_seg: torch.Tensor,
                   prefix_pos: torch.Tensor, *,
                   rt: ModelRuntime = DEFAULT_RUNTIME,
                   cache_dtype: torch.dtype = torch.float32,
                   kv_out: Optional[Dict[str, torch.Tensor]] = None
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
    ``cache_dtype`` (``kv_out``'s tensors where given) for the caller to
    scatter into per-segment blocks."""
    _check_family(cfg)
    if cfg.family in SSM_FAMILIES:
        raise ValueError("packed prefill is attention-only; SSM state "
                         "rolls through padding and cannot pack")
    _no_codebooks(cfg, "packed prefill")
    p = tokens.shape[1]
    h = L.embed_tokens(cfg, params["embed"], tokens)
    pos_in = positions[None]
    if cfg.rope == "mrope":
        pos_in = pos_in[None].expand((3,) + pos_in.shape)
    use_prefix = prefix_k.shape[1] > 0
    if use_prefix:
        k_seg = torch.cat([prefix_seg, seg_ids])
        k_pos = torch.cat([prefix_pos, positions])
    else:
        k_seg, k_pos = seg_ids, positions
    shape = (cfg.num_layers, p, cfg.num_kv_heads, cfg.head_dim)
    parts = _kv_parts(shape, cache_dtype, h.device, kv_out)
    # which key tiles each query tile visits: one plan for every layer
    # and head, the ids and positions being the same for all
    plan = ops.flash_attention_packed_plan(seg_ids, k_seg, positions, k_pos)
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
                               k_seg=k_seg, q_pos=positions, k_pos=k_pos,
                               plan=plan)
        out = L.attention_output(blk["attn"], a)
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = _residual_constrain(rt, h + _ffn(cfg, blk, hn2))
        parts["k"][i] = k[0]
        parts["v"][i] = v[0]
    h = L.apply_norm(cfg, params["final_norm"], h)
    h_last = h[:, last_idx.to(h.device).long()]
    return L.lm_logits(cfg, params["embed"], h_last)[0], parts


def logits_at(cfg: ModelConfig, params: Params, h: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Logits (B, V), or (B, K, V) for a codebook model, at position
    ``idx[b]`` of each row of ``h`` (B, S, d): the rows are gathered
    first, so the vocabulary-wide head runs over B rows, not B * S."""
    if is_dtensor(h):
        h_last = _rows_at(h, idx)
    else:
        rows = torch.arange(h.shape[0], device=h.device)
        h_last = h[rows, idx.to(h.device).long()][:, None]
    return L.lm_logits(cfg, params["embed"], h_last)[..., 0, :]


def _rows_at(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[b, idx[b]]`` as (B, 1, d) of a (B, S, d) DTensor: each rank
    gathers its batch rows' positions (a sequence shard gathered
    first)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = h.device_mesh
    pl = [p if p == Shard(0) else Replicate() for p in h.placements]
    h = h.redistribute(mesh, pl)
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx.to(h.device), mesh,
                                 [Replicate()] * mesh.ndim)
    il = idx.redistribute(mesh, pl).to_local()
    hl = h.to_local()
    rows = torch.arange(hl.shape[0], device=hl.device)
    out = hl[rows, il.long()][:, None]
    return from_local(out, mesh, pl, (h.shape[0], 1, h.shape[2]))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params,
                cache: Dict[str, torch.Tensor], tokens_t: torch.Tensor, *,
                rt: ModelRuntime = DEFAULT_RUNTIME
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over a paged cache (``block_tables`` present) or a
    contiguous one.  tokens_t: (B,), or (B, K) for a codebook model.
    Writes each row's new K/V at ``cache['len']`` IN PLACE, at rope
    position ``len + pos_offset`` (an SSM model its conv window and scan
    state, a hybrid also the shared block's KV), and returns ``(logits,
    cache')``: logits (B, V) or (B, K, V), and ``cache'`` sharing the
    K/V (and tables, and state) with ``len + 1``.  Over a mesh the
    cache's leaves are DTensors placed by
    `repro_torch.distributed.plan.decode_specs` (the paged pool stays
    single-device, as the engines are); ``rt`` is read for its
    ``seq_shard``, which a one-token step has no use for."""
    _check_family(cfg)
    h = L.embed_tokens(cfg, params["embed"], tokens_t[..., None])  # (B,1,d)
    positions = (cache["len"] + cache["pos_offset"])[:, None]
    if cfg.rope == "mrope":
        positions = positions[None].expand((3,) + positions.shape)
    if cfg.family in SSM_FAMILIES:
        h = _decode_ssm(cfg, params, cache, h, positions)
    elif "block_tables" in cache:
        h = _decode_attn_paged(cfg, params, cache, h, positions)
        h = L.apply_norm(cfg, params["final_norm"], h)
    else:
        h = _decode_attn(cfg, params, cache, h, positions)
        h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.lm_logits(cfg, params["embed"], h)[..., 0, :]
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


def _write_index(lens: torch.Tensor, width: int):
    """Each row's write position in a contiguous cache of ``width``
    positions: its length, clamped to ``width - 1`` as the JAX package's
    dynamic_update_slice clamps it."""
    rows = torch.arange(lens.shape[0], device=lens.device)
    return rows, torch.clamp(lens, 0, width - 1).long()


def _attend_step(cfg: ModelConfig, p: Params, hn: torch.Tensor,
                 positions: torch.Tensor, k_c: torch.Tensor,
                 v_c: torch.Tensor, index, lens: torch.Tensor
                 ) -> torch.Tensor:
    """One decode step of attention over one contiguous (B, S, KV, dh)
    cache slice, written in place at ``index``: attends to ``len + 1``
    keys through the contiguous decode kernel, which reads the slice as a
    strided (B, KV, S, dh) view; -> the output projection (B, 1, d)."""
    q, k, v = L.qkv_project(cfg, p, hn, positions)
    if is_dtensor(k_c):
        k_c, v_c = _write_kv_sharded(k_c, v_c, k, v, lens)
    else:
        _write_kv(k_c, v_c, k, v, index)
    attn = ops.flash_decode(q[:, 0], k_c.transpose(1, 2),
                            v_c.transpose(1, 2), lens + 1)
    return L.attention_output(p, attn[:, None])


def _write_kv_sharded(k_c: torch.Tensor, v_c: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor):
    """The sharded cache's :func:`_write_kv`: each rank writes its rows,
    heads and head-dim slice of the new token into its shard of the
    (B, S, KV, dh) layer cache, at ``len`` (clamped) where that position
    lies in its sequence shard.  Returns the cache as the decode kernel
    takes it: a head-dim or sequence shard gathered (an all-gather of the
    layer's cache, the price of feeding the kernel whole heads and
    keys)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import shard_offset
    mesh, pl = k_c.device_mesh, tuple(k_c.placements)
    width = k_c.shape[1]
    row_pl = [p if p == Shard(0) else Replicate() for p in pl]
    if not is_dtensor(lens):
        lens = DTensor.from_local(lens, mesh, [Replicate()] * mesh.ndim)
    pos = torch.clamp(lens.redistribute(mesh, row_pl).to_local(), 0,
                      width - 1).long()
    s0 = shard_offset(k_c.shape, mesh, pl, 1)
    new_pl = [Replicate() if p == Shard(1) else p for p in pl]
    for cache, new in ((k_c, k), (v_c, v)):
        cl = cache.to_local()
        nl = new.redistribute(mesh, new_pl).to_local()[:, 0]
        local = pos - s0
        inside = (local >= 0) & (local < cl.shape[1])
        local = torch.clamp(local, 0, cl.shape[1] - 1)
        rows = torch.arange(cl.shape[0], device=cl.device)
        cur = cl[rows, local]
        cl[rows, local] = torch.where(inside[:, None, None],
                                      nl.to(cl.dtype), cur)
    att = tuple(Replicate() if p in (Shard(1), Shard(3)) else p for p in pl)
    if att == pl:
        return k_c, v_c
    return k_c.redistribute(mesh, att), v_c.redistribute(mesh, att)


def _decode_attn(cfg, params, cache, h, positions):
    """Decode layers over the contiguous cache."""
    lens = cache["len"]
    index = _write_index(lens, cache["k"].shape[2])
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn = L.apply_norm(cfg, blk["norm1"], h)
        out = _attend_step(cfg, blk["attn"], hn, positions, cache["k"][i],
                           cache["v"][i], index, lens)
        hn2, h = L.apply_norm(cfg, blk["norm2"], out, residual=h)
        h = h + _ffn(cfg, blk, hn2)
    return h


def _decode_ssm(cfg, params, cache, h, positions):
    """Decode layers of the SSM families, unrolled (the JAX package's
    ``_decode_ssm_unrolled``): each mamba block's step reads its layer's
    conv window and scan state and writes the new ones back IN PLACE;
    the hybrid's shared block writes its application's KV in place and
    attends through the contiguous decode kernel.  Returns the final
    norm's output (B, 1, d)."""
    shared = params.get("shared")
    lens = cache["len"]
    conv, state = cache["conv"], cache["state"]
    index = _write_index(lens, cache["shared_k"].shape[2]) \
        if cfg.attn_every else None
    out, app = None, 0
    for i in range(cfg.num_layers):
        blk = layer_params(params, i)
        hn, h = _norm_add(cfg, blk["norm1"], h, out)
        y, conv_l, state_l = S.apply_mamba_step(cfg, blk["mamba"], hn[:, 0],
                                                conv[i], state[i])
        conv[i].copy_(conv_l)
        state[i].copy_(state_l)
        out = y[:, None]
        if not _shared_after(cfg, i):
            continue
        hn, h = _norm_add(cfg, shared["norm1"], h, out)
        o = _attend_step(cfg, shared["attn"], hn, positions,
                         cache["shared_k"][app], cache["shared_v"][app],
                         index, lens)
        hn2, h = L.apply_norm(cfg, shared["norm2"], o, residual=h)
        out = L.apply_ffn(cfg, shared["ffn"], hn2)
        app += 1
    return _norm_add(cfg, params["final_norm"], h, out)[0]


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
        h = h + _ffn(cfg, blk, hn2)
    return h
