"""The port's stub modality front ends, positions and model inputs against
the JAX package's, on the CPU.

The delay pattern and its inverse, the image-patch count, M-RoPE's
sections and the position ids (with and without an image prefix, at an
offset) are integers and are compared exactly; `apply_mrope` with three
equal streams is bit-equal to `apply_rope`, and with an image grid
within f32 rounding (1e-6) of the reference's.  The configs, their
analytic parameter counts and the four input shapes are the reference's,
and `repro_torch.models.io`'s meta-device specs carry the shapes and
dtypes of the reference's ``ShapeDtypeStruct``s for every transformer
arch and shape.  Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import frontend as JF
from repro.models import io as JIO
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.models import frontend as F
from repro_torch.models import io as IO
from repro_torch.models import layers as L

#: the reference's archs, every one of which the port registers
ARCHS = jconfigs.ARCH_IDS


def test_the_port_registers_every_transformer_arch():
    """Every arch of the reference, the SSM and hybrid ones among them,
    in the reference's order."""
    assert configs.ARCH_IDS == ARCHS
    assert {configs.get_config(a).family for a in ARCHS} >= {"ssm",
                                                             "hybrid"}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_are_the_reference_ones(arch):
    for get in ("get_config", "get_smoke_config"):
        port = getattr(configs, get)(arch)
        ref = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


def test_shapes_are_the_reference_ones():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(configs.SMOKE_SHAPE) == \
        dataclasses.asdict(jconfigs.SMOKE_SHAPE)
    for arch in ARCHS:
        assert [s.name for s in configs.shapes_for(configs.get_config(arch))] \
            == [s.name for s in jconfigs.shapes_for(
                jconfigs.get_config(arch))]


@pytest.mark.parametrize("k,s", [(4, 12), (4, 3), (2, 9), (1, 5)])
@pytest.mark.parametrize("pad_id", [0, 7])
def test_delay_pattern_and_its_inverse_are_exact(k, s, pad_id):
    toks = np.random.default_rng(k * 100 + s).integers(
        1, 2048, (3, k, s)).astype(np.int32)
    got = F.apply_delay_pattern(torch.from_numpy(toks), pad_id)
    want = np.asarray(JF.apply_delay_pattern(jnp.asarray(toks), pad_id))
    np.testing.assert_array_equal(got.numpy(), want)
    back = F.undelay_pattern(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JF.undelay_pattern(jnp.asarray(want))))


def test_num_vision_patches_is_the_reference_policy():
    for seq in list(range(0, 300)) + [1024, 4096, 32768]:
        assert F.num_vision_patches(seq) == JF.num_vision_patches(seq)


def test_front_end_draws_have_the_reference_shapes():
    cfg = configs.get_smoke_config("qwen2-vl-7b")
    gen = torch.Generator().manual_seed(0)
    emb = F.vision_patch_embeds(cfg, gen, 2, 100)
    want = JF.vision_patch_embeds(jconfigs.get_smoke_config("qwen2-vl-7b"),
                                  jax.random.key(0), 2, 100)
    assert tuple(emb.shape) == want.shape
    assert emb.dtype == torch.float32 and str(want.dtype) == "float32"
    mcfg = configs.get_smoke_config("musicgen-large")
    codes = F.encodec_tokens(mcfg, gen, 2, 10)
    assert tuple(codes.shape) == (2, mcfg.num_codebooks, 10)
    assert codes.dtype == torch.int32
    assert 0 <= codes.min() and codes.max() < mcfg.vocab_size
    # delayed: codebook k starts with k pad frames
    for k in range(mcfg.num_codebooks):
        assert (codes[:, k, :k] == 0).all()


@pytest.mark.parametrize("dh", [16, 64, 128])
def test_mrope_sections_are_the_reference_ones(dh):
    assert L.mrope_sections(dh) == JL.mrope_sections(dh)


@pytest.mark.parametrize("n_img,offset", [(0, 0), (0, 5), (9, 0), (16, 3),
                                          (4, -2)])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "starcoder2-15b"])
def test_positions_for_is_exact(arch, n_img, offset):
    """(3, B, S) for M-RoPE, the image grid at (t = 0, row, col) and the
    text continuing from 1; (B, S) for plain RoPE."""
    cfg = configs.get_smoke_config(arch)
    got = L.positions_for(cfg, (2, 24), n_img, offset)
    want = JL.positions_for(jconfigs.get_smoke_config(arch), (2, 24), n_img,
                            offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if cfg.rope == "mrope" and n_img:
        plain = L.positions_for(cfg, (2, 24), 0, offset)
        assert (got[:, :, :n_img] != plain[:, :, :n_img]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_streams_is_rope_bit_for_bit(dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 3, 16)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 500, (2, 7)).astype(np.int32))
    got = L.apply_mrope(x, pos[None].expand(3, 2, 7), 1e6)
    want = L.apply_rope(x, pos, 1e6)
    assert torch.equal(got, want)


def test_mrope_with_an_image_grid_matches_reference():
    cfg = configs.get_smoke_config("qwen2-vl-7b")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, 4, cfg.head_dim)).astype(np.float32)
    pos = L.positions_for(cfg, (2, 24), 16, 2)
    got = L.apply_mrope(torch.from_numpy(x), pos, cfg.rope_theta)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos.numpy()),
                          cfg.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every (arch x shape) cell's inputs: the same shapes and dtypes, on
    the meta device (no memory)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for shape in configs.shapes_for(cfg):
        got = IO.input_specs(cfg, shape)
        want = JIO.input_specs(jcfg, jconfigs.SHAPES[shape.name])
        assert _shapes(got) == _shapes(want), shape.name
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(got))


def test_io_refuses_the_families_not_ported_yet():
    """The SSM and hybrid families are ported: their specs at the smoke
    shape (a decode step's cache is their state) and synthetic prompts
    have the reference's shapes and dtypes."""
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        cfg, jcfg = configs.get_smoke_config(arch), \
            jconfigs.get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            shape = dataclasses.replace(configs.SMOKE_SHAPE, kind=kind)
            jshape = dataclasses.replace(jconfigs.SMOKE_SHAPE, kind=kind)
            assert _shapes(IO.input_specs(cfg, shape)) == \
                _shapes(JIO.input_specs(jcfg, jshape)), (arch, kind)
        got = IO.synthetic_prompts(cfg, torch.Generator().manual_seed(0), 2,
                                   8)
        want = JIO.synthetic_prompts(jcfg, jax.random.key(0), 2, 8)
        assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-large",
                                  "llama3-405b"])
def test_synthetic_batches_have_the_reference_structure(arch):
    """Shapes and dtypes as the reference's draws (the values come from
    another generator); labels are the tokens one step on."""
    cfg, jcfg = configs.get_smoke_config(arch), \
        jconfigs.get_smoke_config(arch)
    got = IO.synthetic_train_batch(cfg, torch.Generator().manual_seed(0), 2,
                                   32)
    want = JIO.synthetic_train_batch(jcfg, jax.random.key(0), 2, 32)
    assert _shapes(got) == _shapes(want)
    assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, -1))
    prompts = IO.synthetic_prompts(cfg, torch.Generator().manual_seed(0), 2,
                                   32)
    assert _shapes(prompts) == _shapes(JIO.synthetic_prompts(
        jcfg, jax.random.key(0), 2, 32))
