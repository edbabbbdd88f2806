"""The port over DTensor meshes of gloo ranks on the CPU, held against the
JAX package's single-device results on the same weights and inputs.

Two worlds, each spawned once for the module (`tests/torch_world.py`:
one process a rank, one thread each, a ``FileStore`` under the test's
temporary directory, a timeout that fails the spawn instead of hanging);
each case reads its world's results (`tests/torch_world_cases.py`):

- 4 ranks, a (2, 2) ``("data", "model")`` mesh: the sharded train step
  (internlm2 smoke, f32, ``grad_accum`` 2) against the reference's
  ``jax.jit(step)``; an Adafactor step of the same model cut to 3
  layers (a stacked dim that ``data`` 2 does not divide) against the
  same step on one device and the reference's; ``seq_shard`` on and
  off through ``forward_train``; the grouped MoE (olmoe smoke, ``data``
  2: two dispatch groups with a capacity each, a capacity that drops)
  against the reference's
  ``apply_moe`` with two groups, and which assignments drop against its
  ``_dispatch_group``; the Mamba-1 family (falcon-mamba smoke, d_inner
  over ``model``): its loss, a prefill's logits and state and 4 decode
  steps; the hybrid (zamba2 smoke: Mamba-2's heads over ``model``, the
  shared attention block), in the scan and the SSD forms: a prefill and 4
  decode steps; each held against the port on one device (the same
  calls without the mesh) and against the reference; and a Mamba-2 split
  that cuts a head, on a (1, 4) mesh, raising.
- 8 ranks: sharded decode on (2, 4) (qwen3 smoke: its 2 kv heads do not
  divide ``model`` 4, so the cache is sharded on the head dim) against
  the reference's single-device ``decode_step``; and the elastic run:
  two steps on a (2, 2) mesh of ranks 0-3, a checkpoint the reference's
  ``load_latest`` reads, ``reshard`` onto (2, 4) and one more step,
  against a continuation on (2, 2) and the reference's three steps.

The JAX package's own sharded runs fail on the installed JAX (a gather
from the vocab-sharded table), so its single-device results are the
reference, as its tests hold its sharded step to them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import (ModelRuntime as JRuntime, decode_step as jdecode,
                          init_params as jinit, prefill as jprefill)
from repro.models import moe as jmoe
from repro.models.io import synthetic_prompts, synthetic_train_batch
from repro.models.transformer import forward_train as jforward
from repro.runtime import checkpoint as jckpt
from repro.training import OptimizerConfig as JOpt
from repro.training import TrainConfig as JTrain
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step as pdecode
from repro_torch.models import moe as pmoe
from repro_torch.models import prefill as pprefill
from repro_torch.models.bridge import params_from_numpy
from torch_world import start_world

TIMEOUT = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tc(accum):
    return JTrain(optimizer=JOpt(learning_rate=1e-3),
                  compute_dtype="float32", grad_accum=accum)


@functools.lru_cache(maxsize=None)
def train_inputs():
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    state = jinit_state(cfg, _tc(2), 0)
    batch = synthetic_train_batch(cfg, jax.random.key(1), 4, 32)
    return cfg, state, batch


def _tc_adafactor():
    return JTrain(optimizer=JOpt(name="adafactor", learning_rate=1e-3),
                  compute_dtype="float32", grad_accum=2)


@functools.lru_cache(maxsize=None)
def adafactor_inputs():
    cfg = dataclasses.replace(jconfigs.get_smoke_config("internlm2-1.8b"),
                              num_layers=3)
    state = jinit_state(cfg, _tc_adafactor(), 0)
    batch = synthetic_train_batch(cfg, jax.random.key(4), 4, 32)
    return cfg, state, batch


def moe_cfgs():
    """olmoe smoke with a capacity factor that drops assignments."""
    jcfg = jconfigs.get_smoke_config("olmoe-1b-7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    cfg = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def moe_inputs():
    jcfg, _ = moe_cfgs()
    params = jinit(jcfg, jax.random.key(0), "float32")
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, p, x


@functools.lru_cache(maxsize=None)
def ssm_inputs():
    cfg = jconfigs.get_smoke_config("falcon-mamba-7b")
    params = jinit(cfg, jax.random.key(0), "float32")
    batch = synthetic_train_batch(cfg, jax.random.key(3), 4, 16)
    return cfg, params, batch


#: decode steps of the SSM cases, each fed one of these tokens a row
SSM_STEPS = 4


def _steps(seed, b):
    return np.random.default_rng(seed).integers(
        1, 256, (SSM_STEPS, b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def hybrid_inputs():
    cfg = jconfigs.get_smoke_config("zamba2-1.2b")
    params = jinit(cfg, jax.random.key(6), "float32")
    toks = np.random.default_rng(7).integers(1, 256, (4, 20)).astype(
        np.int32)
    return cfg, params, toks, _steps(8, 4)


def _ssd(cfg, on):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, ssd_matmul=on))


@functools.lru_cache(maxsize=None)
def decode_inputs():
    cfg = jconfigs.get_smoke_config("qwen3-32b")
    params = jinit(cfg, jax.random.key(0))
    toks = synthetic_prompts(cfg, jax.random.key(2), 4, 16)["tokens"]
    logits, cache = jprefill(cfg, params, toks, max_len=32,
                             cache_dtype=jnp.float32)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    return cfg, params, toks, cache, nxt


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, one after the other (at most 8 rank processes beside
    the other test workers); their rank 0 results."""
    _, state, batch = train_inputs()
    _, cfg = moe_cfgs()
    _, mp, x = moe_inputs()
    _, sparams, sbatch = ssm_inputs()
    _, hparams, htoks, hsteps = hybrid_inputs()
    _, astate, abatch = adafactor_inputs()
    a = start_world(4, "torch_world_cases:world_a",
                    str(tmp_path_factory.mktemp("world_a")),
                    {"train_state": _np(state), "train_batch": _np(batch),
                     "moe_cfg": cfg, "moe_params": _np(mp), "moe_x": x,
                     "ssm_params": _np(sparams), "ssm_batch": _np(sbatch),
                     "ssm_steps": _steps(9, 4),
                     "hybrid_params": _np(hparams), "hybrid_tokens": htoks,
                     "hybrid_steps": hsteps, "ada_state": _np(astate),
                     "ada_batch": _np(abatch)},
                    timeout=TIMEOUT)
    out_a = a.wait()
    _, params, toks, _, nxt = decode_inputs()
    state1 = jinit_state(train_inputs()[0], _tc(1), 0)
    ckpt_dir = str(tmp_path_factory.mktemp("elastic_ckpt"))
    b = start_world(8, "torch_world_cases:world_b",
                    str(tmp_path_factory.mktemp("world_b")),
                    {"decode_params": _np(params),
                     "decode_tokens": np.asarray(toks),
                     "decode_next": np.asarray(nxt),
                     "train_state": _np(state1),
                     "elastic_batch": _np(batch), "ckpt_dir": ckpt_dir},
                    timeout=TIMEOUT)
    out_b = b.wait()
    out_b["ckpt_dir"] = ckpt_dir
    return out_a, out_b


@pytest.fixture
def world_a(worlds):
    return worlds[0]


@pytest.fixture
def world_b(worlds):
    return worlds[1]


def test_sharded_train_step_matches_reference(world_a):
    cfg, state, batch = train_inputs()
    s_ref, m_ref = jax.jit(jmake_step(cfg, _tc(2), JRuntime()))(state, batch)
    assert abs(world_a["train_loss"] - float(m_ref["loss"])) < 1e-4
    got = world_a["train_params"]
    want = params_from_numpy(_np(s_ref["params"]), device="cpu")
    flat_g = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    flat_w = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want))
    assert len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    # wq (L, d, H, dh): FSDP over data, heads over model
    assert world_a["train_placed"] == "(Shard(dim=1), Shard(dim=2))"


def test_adafactor_over_uneven_layers_matches_one_device_and_reference(
        world_a):
    cfg, state, batch = adafactor_inputs()
    s_ref, m_ref = jax.jit(jmake_step(cfg, _tc_adafactor(), JRuntime()))(
        state, batch)
    for loss in (world_a["ada_loss"], world_a["ada_one_loss"]):
        assert abs(loss - float(m_ref["loss"])) < 1e-4
    want = jax.tree.leaves(_np(s_ref["params"]))
    one = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                       world_a["ada_one_params"]))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                       world_a["ada_params"]))
    assert len(got) == len(one) == len(want)
    for g, o, w in zip(got, one, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(g, o, rtol=2e-4, atol=2e-4)
    # the row statistics of the stacked wq (L, d, H): 3 layers on both
    vr_ref = np.asarray(s_ref["opt"]["factored"]["layers"]["attn"]["wq"]
                        ["vr"])
    assert world_a["ada_vr"].shape == world_a["ada_one_vr"].shape == \
        vr_ref.shape
    np.testing.assert_allclose(world_a["ada_vr"].numpy(), vr_ref,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("on", [False, True])
def test_seq_shard_matches_reference(world_a, on):
    cfg, state, batch = train_inputs()
    want, _ = jforward(cfg, state["params"], batch, rt=JRuntime())
    assert abs(world_a[f"seq_shard_{on}"] - float(want)) < 1e-5
    assert abs(world_a["seq_shard_True"] -
               world_a["seq_shard_False"]) < 1e-6


def _ref_moe(monkeypatch, jcfg, p, x):
    monkeypatch.setattr(jmoe, "axis_size", lambda _: 2)
    return jmoe.apply_moe(jcfg, p, jnp.asarray(x))


def test_grouped_moe_matches_reference(world_a, monkeypatch):
    jcfg, p, x = moe_inputs()
    want, aux = _ref_moe(monkeypatch, jcfg, p, x)
    assert world_a["moe_groups"] == 2
    np.testing.assert_allclose(world_a["moe_out"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert abs(world_a["moe_aux"] - float(aux)) < 1e-5


def test_grouped_moe_drops_the_reference_assignments(monkeypatch):
    """Two groups of 32 tokens, each with its own capacity of 8: the
    same assignments drop in each package, and some do."""
    jcfg, p, x = moe_inputs()
    _, cfg = moe_cfgs()
    tp = params_from_numpy(_np(p), device="cpu")
    t = x.shape[0] * x.shape[1]
    x2 = x.reshape(t, -1)
    jw, ji, _ = jmoe.route(jcfg, p, jnp.asarray(x2))
    w, i, _ = pmoe.route(cfg, tp, torch.from_numpy(x2))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    tg = t // 2
    cap = pmoe.expert_capacity(cfg, tg)
    assert cap == jmoe.expert_capacity(jcfg, tg) == 8
    dropped = 0
    for g in range(2):
        sl = slice(g * tg, (g + 1) * tg)
        *_, jkeep = jmoe._dispatch_group(jnp.asarray(x2[sl]), ji[sl], jw[sl],
                                         jcfg.moe.num_experts, cap,
                                         jnp.float32)
        *_, keep = pmoe._dispatch_group(torch.from_numpy(x2[sl]), i[sl],
                                        w[sl], cfg.moe.num_experts, cap,
                                        torch.float32)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        dropped += int((~keep).sum())
    assert dropped > 0
    # one device, two groups: the port's own grouped path
    want, _ = _ref_moe(monkeypatch, jcfg, p, x)
    got = pmoe._dispatch_combine(
        cfg, torch.from_numpy(x2), i, w, 2,
        lambda xin: pmoe._experts(tp["w_gate"], tp["w_up"], tp["w_down"],
                                  xin))
    np.testing.assert_allclose(got.numpy().reshape(x.shape),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ssm_over_ssm_inner_matches_reference(world_a):
    cfg, params, batch = ssm_inputs()
    loss, _ = jforward(cfg, params, batch, rt=JRuntime())
    assert abs(world_a["ssm_loss"] - float(loss)) < 1e-5
    logits, cache = jprefill(cfg, params, batch["tokens"], max_len=16,
                             cache_dtype=jnp.float32)
    np.testing.assert_allclose(world_a["ssm_logits"].numpy(),
                               np.asarray(logits), rtol=1e-4, atol=1e-4)
    for k in ("conv", "state"):
        np.testing.assert_allclose(world_a["ssm_cache"][k].float().numpy(),
                                   np.asarray(cache[k], np.float32),
                                   rtol=1e-4, atol=1e-4)
    # in_proj (L, d, 2 di): FSDP over data, d_inner over model
    assert world_a["ssm_placed"] == "(Shard(dim=1), Shard(dim=2))"


def _one_device_and_reference(jcfg, jparams, toks, steps, max_len):
    """The same prefill and decode steps without the mesh, in the port and
    in the reference (f32 caches): each's logits a step and final cache."""
    cfg = get_smoke_config(jcfg.name)
    cfg = _ssd(cfg, jcfg.ssm.ssd_matmul)
    tp = params_from_numpy(_np(jparams), device="cpu")
    tl, tc = pprefill(cfg, tp, torch.from_numpy(toks), max_len=max_len,
                      cache_dtype=torch.float32)
    jl, jc = jprefill(jcfg, jparams, jnp.asarray(toks), max_len=max_len,
                      cache_dtype=jnp.float32)
    port = {"prefill_logits": tl, "decode_logits": [],
            "prefill_cache": {k: v.clone() for k, v in tc.items()}}
    ref = {"prefill_logits": jl, "decode_logits": []}
    for tok in steps:
        tl, tc = pdecode(cfg, tp, tc, torch.from_numpy(tok.copy()))
        jl, jc = jdecode(jcfg, jparams, jc, jnp.asarray(tok))
        port["decode_logits"].append(tl)
        ref["decode_logits"].append(jl)
    port["decode_cache"], ref["decode_cache"] = tc, jc
    return port, ref


#: the mesh against the port on one device: the products over the
#: channels are summed over two channel shards, in another order than one
#: device's, through 4 layers and the steps
MESH_TOL = dict(rtol=5e-5, atol=5e-5)


def _held(mesh, port, ref):
    """The mesh's logits and final cache leaves against the port's on one
    device (``MESH_TOL``) and the reference's (1e-4, as the one-device
    SSM tests)."""
    pairs = [(mesh["decode_logits"], port["decode_logits"],
              ref["decode_logits"])]
    if "prefill_logits" in mesh:
        pairs.append(([mesh["prefill_logits"]], [port["prefill_logits"]],
                      [ref["prefill_logits"]]))
    for got, one, want in pairs:
        assert len(got) == len(one) == len(want)
        for g, o, w in zip(got, one, want):
            np.testing.assert_allclose(g.numpy(), o.numpy(), **MESH_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    for k, w in ref["decode_cache"].items():
        g, o = mesh["decode_cache"][k], port["decode_cache"][k]
        assert g.dtype == o.dtype, k
        np.testing.assert_allclose(g.float().numpy(), o.float().numpy(),
                                   err_msg=k, **MESH_TOL)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k, o in port["prefill_cache"].items() if "prefill_cache" in mesh \
            else ():
        np.testing.assert_allclose(mesh["prefill_cache"][k].float().numpy(),
                                   o.float().numpy(), err_msg=k, **MESH_TOL)


def test_ssm_decode_over_ssm_inner_matches_single_device(world_a):
    """Falcon-Mamba's steps from the mesh prefill's cache (d_inner over
    ``model``, rows over ``data``): each rank steps its channels with its
    weight slices, the window and state written back in place."""
    cfg, params, batch = ssm_inputs()
    toks = np.asarray(batch["tokens"])
    port, ref = _one_device_and_reference(cfg, params, toks,
                                          _steps(9, 4), toks.shape[1])
    _held(world_a["ssm_decode"], port, ref)


@pytest.mark.parametrize("ssd", [False, True])
def test_hybrid_over_the_mesh_matches_single_device(world_a, ssd):
    """Zamba2's Mamba-2 blocks (8 heads of 16, 4 a rank) and its shared
    attention block over (2, 2): the prompt pass in either form and 4
    decode steps, the shared block decoding through the shard-local
    contiguous kernel path."""
    jcfg, params, toks, steps = hybrid_inputs()
    port, ref = _one_device_and_reference(_ssd(jcfg, ssd), params, toks,
                                          steps, toks.shape[1] + len(steps))
    run = world_a[f"hybrid_ssd_{ssd}"]
    _held(run, port, ref)
    # the scan state (L, B, H, dh, N): rows over data, heads over model
    assert run["state_placed"] == "(Shard(dim=1), Shard(dim=2))"


def test_mamba2_split_cutting_a_head_raises(world_a):
    msg = world_a["hybrid_cut_head"]
    assert msg is not None and "cut a head" in msg


def test_wrappers_refuse_placements_their_kernels_cannot_take(world_a):
    """No wrapper gathers quietly: each placement its kernel cannot take
    shard by shard raises, naming it."""
    refused = world_a["refusals"]
    assert len(refused) == 9
    for name, msg in refused.items():
        assert msg is not None, name
    assert "S(1)" in refused["norm over a split row"]
    assert "equal groups" in refused["decode of unequal local groups"]
    assert "plain tensor" in refused["a plain tensor beside DTensors"]


def test_sharded_decode_matches_reference(world_b):
    cfg, params, _, cache, nxt = decode_inputs()
    ref, new = jdecode(cfg, params, dict(cache), nxt)
    np.testing.assert_allclose(world_b["decode_logits"].numpy(),
                               np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert world_b["decode_cache_spec"] == (None, ("data",), None, None,
                                            "model")
    np.testing.assert_allclose(world_b["decode_cache_k"].numpy(),
                               np.asarray(new["k"]), rtol=2e-4, atol=2e-4)


def test_elastic_reshard_matches_reference(world_b):
    cfg, _, batch = train_inputs()
    assert abs(world_b["elastic_new_loss"] -
               world_b["elastic_ref_loss"]) < 1e-4
    step = jax.jit(jmake_step(cfg, _tc(1), JRuntime()))
    state = jinit_state(cfg, _tc(1), 0)
    for _ in range(3):
        state, m = step(state, batch)
    assert abs(world_b["elastic_new_loss"] - float(m["loss"])) < 1e-4
    assert world_b["elastic_placed"] == "(Shard(dim=1), Shard(dim=2))"
    # the reference reads the port's checkpoint of the (2, 2) run
    step_n, tree, _ = jckpt.load_latest(world_b["ckpt_dir"])
    assert step_n == 2 and int(np.asarray(tree["step"])) == 2
    assert set(tree["opt"]) == {"m", "v", "step"}
