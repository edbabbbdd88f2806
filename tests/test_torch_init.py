"""`init_params` draws each layer straight into its slice of the stacked
leaves.  Held here, bit for bit, against the per-layer draw followed by a
``torch.stack`` (a copy of that code below) on every family's smoke
config, and against the fake-tensor tree of `abstract_params`."""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SSM_FAMILIES
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.transformer import abstract_params, init_params

ARCHS = ["internlm2-1.8b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-1.2b",
         "musicgen-large", "qwen3-32b"]


def _dense_init_cast(gen, shape, in_axis_size, dtype, device, out=None):
    """The draw as it was: f32 normal, scaled, then cast to a new
    tensor."""
    assert out is None
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def _stack(blocks):
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def _init_params_stacked(cfg, gen, param_dtype=None):
    """The per-layer draw, then a stack of each leaf (the two copies of
    the layers that the new init does without)."""
    dev = torch.device("cpu")
    dtype = L.torch_dtype(param_dtype or cfg.dtype)
    params = {"embed": L.init_embedding(cfg, gen, dtype, dev)}
    if cfg.family == "hybrid":
        shared_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                        device=dev))
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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


@pytest.mark.parametrize("param_dtype", [None, "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equals_the_per_layer_draw_stacked(arch, param_dtype,
                                                       monkeypatch):
    """Every leaf bit for bit, and the caller's generator left where the
    per-layer draw leaves it."""
    cfg = get_smoke_config(arch)
    gens = [torch.Generator(), torch.Generator()]
    for g in gens:
        g.manual_seed(3)
    new = dict(_leaves(init_params(cfg, gens[0], device="cpu",
                                   param_dtype=param_dtype)))
    for mod in (L, M, S):
        monkeypatch.setattr(mod, "dense_init", _dense_init_cast)
    old = dict(_leaves(_init_params_stacked(cfg, gens[1], param_dtype)))
    assert torch.equal(torch.randn(8, generator=gens[0]),
                       torch.randn(8, generator=gens[1]))
    assert list(new) == list(old)
    for name, ref in old.items():
        got = new[name]
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        assert got.is_contiguous(), name
        assert torch.equal(_bits(got), _bits(ref)), name


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "olmoe-1b-7b"])
def test_abstract_params_matches_the_real_tree(arch):
    cfg = get_smoke_config(arch)
    fake = dict(_leaves(abstract_params(cfg)))
    real = dict(_leaves(init_params(cfg, device="cpu")))
    assert list(fake) == list(real)
    for name, t in real.items():
        assert tuple(fake[name].shape) == tuple(t.shape), name
        assert fake[name].dtype == t.dtype, name
