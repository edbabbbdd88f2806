"""What each rank of `tests/test_torch_distributed.py`'s worlds runs.

``world_a`` (4 ranks): the sharded train step on (2, 2), the grouped MoE
on (2, 2) (two dispatch groups), ``seq_shard`` off and on through
``forward_train``, and the Mamba-1 family's loss and prefill.
``world_b`` (8 ranks): sharded decode on (2, 4) (the head-dim-sharded
cache), and the elastic run: two steps on a (2, 2) mesh of ranks 0-3, a
checkpoint, a continuation there, and one step after ``reshard`` onto
(2, 4).  Inputs are the JAX package's weights and batches as numpy
(bridged here); results are plain tensors and numbers, rank 0's
returned.
"""
import copy

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import plan as dplan
from repro_torch.distributed.sharding import make_rules, sharding_rules
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ModelRuntime, decode_step, prefill
from repro_torch.models import moe as pmoe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import forward_train
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  make_train_step)


def _tensors(tree):
    return params_from_numpy(tree, device="cpu")


def _place(rules, tree, specs):
    return dplan.distribute(tree, dplan.to_shardings(rules, specs))


def _batch(rules, batch):
    return _place(rules, batch, dplan.batch_specs(rules, batch))


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _train_tc(accum):
    return TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3),
                       compute_dtype="float32", grad_accum=accum)


def _run(rules, step, state, batch, n):
    """``n`` steps from a global state tree on ``rules``' mesh; the
    DTensor state and the last metrics."""
    with sharding_rules(rules):
        st = _place(rules, state, dplan.state_specs(rules, state))
        bt = _batch(rules, batch)
        m = None
        for _ in range(n):
            st, m = step(st, bt)
    return st, m


def world_a(rank, world, inputs):
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    rules = make_rules(mesh)
    out = {}
    # 1. the train step
    cfg = get_smoke_config("internlm2-1.8b")
    state = _tensors(inputs["train_state"])
    batch = _tensors(inputs["train_batch"])
    st, m = _run(rules, make_train_step(cfg, _train_tc(2), ModelRuntime()),
                 state, batch, 1)
    with sharding_rules(rules):
        out["train_loss"] = float(_full(m["loss"]))
        out["train_params"] = dplan.gather(st["params"])
        out["train_placed"] = str(st["params"]["layers"]["attn"]["wq"]
                                  .placements)
    # 2. seq_shard off and on through forward_train
    params = _tensors(inputs["train_state"]["params"])
    with sharding_rules(rules):
        pp = _place(rules, params, dplan.param_specs(rules, params))
        bb = _batch(rules, batch)
        for on in (False, True):
            loss, _ = forward_train(cfg, pp, bb,
                                    rt=ModelRuntime(seq_shard=on))
            out[f"seq_shard_{on}"] = float(_full(loss))
    # 3. the grouped MoE: x (B, S, d) over the batch, two groups
    mcfg = inputs["moe_cfg"]
    moe = _tensors({"moe": inputs["moe_params"]})
    x = torch.from_numpy(inputs["moe_x"])
    with sharding_rules(rules):
        out["moe_groups"] = pmoe.num_groups(x.shape[0] * x.shape[1])
        mp = _place(rules, moe, dplan.param_specs(rules, moe))
        xd = _batch(rules, {"x": x})["x"]
        y, aux = pmoe.apply_moe(mcfg, mp["moe"], xd)
        out["moe_out"] = _full(y)
        out["moe_aux"] = float(_full(aux))
    # 4. the Mamba-1 family: the loss, and a prefill's logits and state
    scfg = get_smoke_config("falcon-mamba-7b")
    sparams = _tensors(inputs["ssm_params"])
    sbatch = _tensors(inputs["ssm_batch"])
    with sharding_rules(rules):
        sp = _place(rules, sparams, dplan.param_specs(rules, sparams))
        loss, _ = forward_train(scfg, sp, _batch(rules, sbatch))
        out["ssm_loss"] = float(_full(loss))
        logits, cache = prefill(scfg, sp,
                                _batch(rules, {"t": sbatch["tokens"]})["t"])
        out["ssm_logits"] = _full(logits)
        out["ssm_cache"] = {k: _full(v) for k, v in cache.items()
                            if k in ("conv", "state")}
        out["ssm_placed"] = str(sp["layers"]["mamba"]["in_proj"].placements)
    out["refusals"] = refusals(mesh)
    return out


def refusals(mesh):
    """Each wrapper given a placement its kernel cannot take: the
    ``ValueError`` it raises (its message), or None where it did not."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)

    def dt(shape, *pl):
        return distribute_tensor(torch.randn(shape, generator=g), mesh,
                                 list(pl))

    rep = Replicate()
    q3, k4 = dt((2, 4, 8), rep, Shard(1)), dt((2, 2, 8, 8), rep, rep)
    cases = {
        "norm over a split row": lambda: ops.fused_rmsnorm(
            dt((4, 8), rep, Shard(1)), dt((8,), rep, rep)),
        "norm with a sharded scale": lambda: ops.fused_rmsnorm(
            dt((4, 8), Shard(0), rep), dt((8,), rep, Shard(0))),
        "softmax over a split row": lambda: ops.fused_softmax(
            dt((4, 8), rep, Shard(1))),
        "decode over a head-dim shard": lambda: ops.flash_decode(
            q3, dt((2, 2, 8, 8), rep, Shard(3)),
            dt((2, 2, 8, 8), rep, Shard(3))),
        "decode over a sequence shard": lambda: ops.flash_decode(
            q3, dt((2, 2, 8, 8), rep, Shard(2)),
            dt((2, 2, 8, 8), rep, Shard(2))),
        "decode with kv sharded, q not": lambda: ops.flash_decode(
            dt((2, 4, 8), rep, rep), dt((2, 2, 8, 8), rep, Shard(1)),
            dt((2, 2, 8, 8), rep, Shard(1))),
        "decode of unequal local groups": lambda: ops.flash_decode(
            dt((2, 6, 8), rep, Shard(1)), dt((2, 3, 8, 8), rep, rep),
            dt((2, 3, 8, 8), rep, rep)),
        "flash over a query shard": lambda: ops.flash_attention(
            dt((2, 4, 8, 8), rep, Shard(2)), k4, k4),
        "a plain tensor beside DTensors": lambda: ops.flash_decode(
            q3, torch.zeros(2, 2, 8, 8), k4),
    }
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def world_b(rank, world, inputs):
    out = {}
    # 1. decode on (2, 4) over the head-dim-sharded cache
    cfg = get_smoke_config("qwen3-32b")
    params = _tensors(inputs["decode_params"])
    toks = torch.from_numpy(inputs["decode_tokens"])
    _, cache = prefill(cfg, params, toks, max_len=32)
    nxt = torch.from_numpy(inputs["decode_next"])
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    rules = make_rules(mesh)
    with sharding_rules(rules):
        pp = _place(rules, params, dplan.param_specs(rules, params))
        c_spec, t_spec = dplan.decode_specs(rules, cfg, cache, nxt)
        got, new = decode_step(cfg, pp, _place(rules, cache, c_spec),
                               _place(rules, nxt, t_spec))
        out["decode_logits"] = _full(got)
        out["decode_cache_spec"] = c_spec["k"]
        out["decode_cache_k"] = _full(new["k"])
    # 2. elastic: (2, 2) on ranks 0-3, then (2, 4) on all eight
    tcfg = get_smoke_config("internlm2-1.8b")
    step = make_train_step(tcfg, _train_tc(1), ModelRuntime())
    state = _tensors(inputs["train_state"])
    batch = _tensors(inputs["elastic_batch"])
    small = make_rules(DeviceMesh("cpu", [[0, 1], [2, 3]],
                                  mesh_dim_names=("data", "model")))
    d = inputs["ckpt_dir"]
    if rank < 4:
        st, _ = _run(small, step, state, batch, 2)
        with sharding_rules(small):
            saved = dplan.gather(st)
        if rank == 0:
            ckpt.save(d, 2, saved)
        _, m_ref = _run(small, step, copy.deepcopy(saved), batch, 1)
        with sharding_rules(small):
            out["elastic_ref_loss"] = float(_full(m_ref["loss"]))
    torch.distributed.barrier()
    big = make_rules(mesh)
    _, loaded, _ = ckpt.load_latest(d)
    with sharding_rules(big):
        specs = dplan.to_shardings(big, dplan.state_specs(big, loaded))
        flat = {}

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                key = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    leaves(v, key)
                else:
                    flat[key] = v
        leaves(specs)
        placed = ckpt.reshard(loaded, lambda path, _: flat[path])
        bt = _batch(big, batch)
        placed, m_new = step(placed, bt)
        out["elastic_new_loss"] = float(_full(m_new["loss"]))
        out["elastic_placed"] = str(
            placed["params"]["layers"]["ffn"]["w_up"].placements)
    return out

