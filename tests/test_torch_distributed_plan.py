"""The port's sharding plan against the JAX package's, leaf by leaf.

For every architecture at its full config (abstract trees: the JAX
package's ``eval_shape``, the port's fake and meta tensors; no memory),
on the meshes (2, 4), (16, 16) and (2, 16, 16): ``param_specs``,
``state_specs`` of an AdamW and an Adafactor state, ``batch_specs`` of
the train inputs and ``decode_specs`` of a (128, 32768) and a (1, 524288)
cache.  The reference's meshes are ``AbstractMesh``es and the port's
``DeviceMesh``es with no process group: the plans read only the mesh's
shape and dim names.  A reference ``PartitionSpec`` is translated entry
for entry (a one-name tuple is its name) and padded with None to the
leaf's rank.  Also: ``make_rules``' pruning and overrides,
``ShardingRules.spec`` / ``physical`` / ``sharding``, ``constrain`` as a
no-op outside a context and on a plain tensor, its rank check,
``axis_size``, and uneven rules' head splits on every rank of a model
dim of 16.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.distributed import plan as jplan
from repro.distributed import sharding as jsharding
from repro.models import transformer as jmodels
from repro.models import io as jio
from repro.training import OptimizerConfig as JOpt
from repro.training import TrainConfig as JTrain
from repro.training import init_state as jinit_state
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import (ShardingRules, axis_size, constrain,
                                     current_rules, sharding_rules)
from repro_torch.distributed import plan
from repro_torch.distributed.sharding import DEFAULT_RULES, make_rules
from repro_torch.models import io as mio
from repro_torch.models.transformer import abstract_params, cache_specs
from repro_torch.training import OptimizerConfig, TrainConfig, init_state

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DECODES = ((128, 32768), (1, 524288))


def port_mesh(shape, names, rank=0):
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=rank)


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e or None)
    return e


def norm_ref(spec, ndim):
    parts = [_entry(e) for e in spec]
    return tuple(parts + [None] * (ndim - len(parts)))


def norm_port(spec, ndim):
    parts = [_entry(e) for e in spec]
    return tuple(parts + [None] * (ndim - len(parts)))


def flat_ref(spec_tree, abstract):
    specs = jax.tree.leaves(spec_tree,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    leaves = jax.tree_util.tree_leaves_with_path(abstract)
    out = {}
    for (path, leaf), s in zip(leaves, specs):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = norm_ref(s, len(leaf.shape))
    return out


def flat_port(spec_tree, abstract, prefix=""):
    out = {}
    if isinstance(abstract, dict):
        for k, v in abstract.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(flat_port(spec_tree[k], v, key))
        return out
    out[prefix] = norm_port(spec_tree, len(abstract.shape))
    return out


@functools.lru_cache(maxsize=None)
def ref_trees(arch):
    cfg = jconfigs.get_config(arch)
    params = jax.eval_shape(functools.partial(
        jmodels.init_params, cfg, jax.random.key(0), "bfloat16"))
    states = {name: jax.eval_shape(lambda n=name: jinit_state(
        cfg, JTrain(optimizer=JOpt(name=n)), 0))
        for name in ("adamw", "adafactor")}
    batch = jio.train_input_specs(cfg, jconfigs.SHAPES["train_4k"])
    caches = [jmodels.cache_specs(cfg, b, s) for b, s in DECODES]
    return cfg, params, states, batch, caches


@functools.lru_cache(maxsize=None)
def port_trees(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    params = abstract_params(cfg, "bfloat16")
    states = {}
    for name in ("adamw", "adafactor"):
        with FakeTensorMode():
            states[name] = init_state(
                cfg, TrainConfig(optimizer=OptimizerConfig(name=name)), 0,
                device="cpu")
    batch = mio.train_input_specs(cfg, SHAPES["train_4k"])
    caches = [cache_specs(cfg, b, s) for b, s in DECODES]
    return cfg, params, states, batch, caches


def _tok(cfg, b, torch_side):
    shape = (b, cfg.num_codebooks) if cfg.num_codebooks else (b,)
    if torch_side:
        return torch.empty(shape, dtype=torch.int32, device="meta")
    return jax.ShapeDtypeStruct(shape, jax.numpy.int32)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_equals_reference_leaf_by_leaf(arch, mesh):
    shape, names = MESHES[mesh]
    jrules = jsharding.make_rules(AbstractMesh(shape, names))
    prules = make_rules(port_mesh(shape, names))
    jcfg, jp, jstates, jbatch, jcaches = ref_trees(arch)
    cfg, pp, pstates, pbatch, pcaches = port_trees(arch)

    want = flat_ref(jplan.param_specs(jrules, jp), jp)
    got = flat_port(plan.param_specs(prules, pp), pp)
    assert got == want
    assert any(s != (None,) * len(s) for s in got.values())
    for name in ("adamw", "adafactor"):
        want = flat_ref(jplan.state_specs(jrules, jstates[name]),
                        jstates[name])
        got = flat_port(plan.state_specs(prules, pstates[name]),
                        pstates[name])
        assert got == want, name
    assert flat_port(plan.batch_specs(prules, pbatch), pbatch) == \
        flat_ref(jplan.batch_specs(jrules, jbatch), jbatch)
    for (b, _), jc, pc in zip(DECODES, jcaches, pcaches):
        jcs, jts = jplan.decode_specs(jrules, jcfg, jc, _tok(jcfg, b, False))
        pcs, pts = plan.decode_specs(prules, cfg, pc, _tok(cfg, b, True))
        assert flat_port(pcs, pc) == flat_ref(jcs, jc), b
        tok = _tok(cfg, b, True)
        assert norm_port(pts, tok.dim()) == norm_ref(jts, tok.dim())


def test_decode_specs_cover_every_cache_case():
    """The four cache cases of the plan on (16, 16): batch x kv heads
    (OLMoE, KV 16), the head dim (Qwen3-32B, KV 8), batch x sequence
    (no dh shard), and the sequence over every dim (batch 1)."""
    rules = make_rules(port_mesh((16, 16), ("data", "model")))
    cases = {}
    for arch in ("olmoe-1b-7b", "qwen3-32b"):
        cfg, _, _, _, (big, one) = port_trees(arch)
        cases[arch] = plan.decode_specs(rules, cfg, big,
                                        _tok(cfg, 128, True))[0]["k"]
        cases[arch + "/1"] = plan.decode_specs(rules, cfg, one,
                                               _tok(cfg, 1, True))[0]["k"]
    no_dh = make_rules(rules.mesh, {"kv_dh_shard": False})
    cfg, _, _, _, (big, _) = port_trees("qwen3-32b")
    cases["no_dh"] = plan.decode_specs(no_dh, cfg, big,
                                       _tok(cfg, 128, True))[0]["k"]
    assert cases["olmoe-1b-7b"] == (None, ("data",), None, "model", None)
    assert cases["qwen3-32b"] == (None, ("data",), None, None, "model")
    assert cases["no_dh"] == (None, ("data",), "model", None, None)
    assert cases["qwen3-32b/1"] == (None, None, ("data", "model"), None,
                                    None)


def test_rules_pruning_overrides_and_spec():
    mesh = port_mesh((2, 16, 16), ("pod", "data", "model"))
    rules = make_rules(mesh)
    jrules = jsharding.make_rules(AbstractMesh((2, 16, 16),
                                               ("pod", "data", "model")))
    assert rules.rules == jrules.rules
    assert set(rules.rules) == set(DEFAULT_RULES)
    small = make_rules(port_mesh((2, 4), ("data", "model")),
                       {"mlp": None}, uneven=True)
    jsmall = jsharding.make_rules(AbstractMesh((2, 4), ("data", "model")),
                                  {"mlp": None}, uneven=True)
    assert small.rules == jsmall.rules and small.uneven
    assert small.rules["batch"] == ("data",) and small.rules["mlp"] is None
    for axes in (("batch", None, "heads"), ("fsdp", "vocab"),
                 (("batch", "heads"), "mlp"), ("heads", "kv_heads"),
                 ("act_seq", "heads")):
        assert norm_port(rules.spec(*axes), len(axes)) == \
            norm_ref(jrules.spec(*axes), len(axes))
        assert norm_port(small.spec(*axes), len(axes)) == \
            norm_ref(jsmall.spec(*axes), len(axes))
    for ax in ("batch", "fsdp", "embed", ("batch", "heads"), None):
        assert rules.physical(ax) == jrules.physical(ax)
    m, pl = rules.sharding("batch", None, "heads")
    assert m is mesh
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert isinstance(rules, ShardingRules)


def test_constrain_and_axis_size():
    x = torch.ones(4, 6)
    assert current_rules() is None
    assert constrain(x, "batch", "bad-rank") is x   # no context: no check
    assert axis_size("batch") == 1
    rules = make_rules(port_mesh((2, 4), ("data", "model")))
    with sharding_rules(rules):
        assert current_rules() is rules
        assert constrain(x, "batch", "heads") is x  # a plain tensor
        with pytest.raises(ValueError, match="rank 2 != 3"):
            constrain(x, "batch", None, "heads")
        assert axis_size("batch") == 2
        assert axis_size("heads") == 4
        assert axis_size("embed") == 1
    assert current_rules() is None
    pl = plan.to_shardings(rules, {"a": ("data", None), "b": (None,)})
    assert pl["a"][1] == (Shard(0), Replicate())
    assert pl["b"][1] == (Replicate(), Replicate())


@pytest.mark.parametrize("heads,kv", [(28, 4), (32, 8), (16, 8), (64, 8)])
def test_uneven_heads_run_on_every_rank(heads, kv):
    """With ``uneven`` rules (the dry run's tuning gives them to
    Qwen2-VL-7B: 28 query heads, 4 kv heads) on a model dim of 16, the
    kv heads split only evenly, else stay whole, and every model rank's
    query heads read kv heads it holds in equal local groups; ranks left
    without query heads read none."""
    from repro_torch.distributed.sharding import (fit_activation,
                                                  local_kv_heads,
                                                  placements, shard_offset)
    n = 16
    rules = make_rules(port_mesh((16, n), ("data", "model")), uneven=True)
    q_shape, kv_shape = (32, 64, heads, 128), (32, 64, kv, 128)
    q_spec = fit_activation(rules, q_shape, "batch", None, "heads", None)
    kv_spec = fit_activation(rules, kv_shape, "batch", None, "kv_heads",
                             None)
    assert q_spec[2] == "model"
    assert kv_spec[2] == ("model" if kv % n == 0 else None)
    group, chunk = heads // kv, -(-heads // n)
    for m in range(n):
        mesh = port_mesh((16, n), ("data", "model"), rank=m)
        assert tuple(mesh.get_coordinate()) == (0, m)
        q_pl = placements(mesh, q_spec)
        kv_pl = placements(mesh, kv_spec)
        start = min(m * chunk, heads)
        q_n = min(start + chunk, heads) - start
        assert shard_offset(q_shape, mesh, q_pl, 2) == start
        k_off = shard_offset(kv_shape, mesh, kv_pl, 2)
        k_n = kv // n if kv_spec[2] else kv
        first, n_kv = local_kv_heads("t", start, q_n, group, k_off, k_n)
        for j in range(q_n):
            assert (start + j) // group == \
                k_off + first + j // (q_n // n_kv)
        assert (q_n == 0) == (n_kv == 0)
