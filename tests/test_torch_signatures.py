"""The port's public signatures against the reference's.

Every public method that the port's `TurboClient`, `InferenceEngine`,
`ContinuousEngine`, `ReplicaPool` and `PrefixAffinityRouter` share by
name with the JAX package's, the model functions `prefill`,
`prefill_suffix`, `prefill_packed`, `decode_step` and `embed_inputs`,
the layer function `positions_for`, and the mamba block's
`apply_mamba`, `apply_mamba_with_state`, `apply_mamba_step` and
`ssm_state_shapes`, and the training API (`forward_train`,
`make_train_step`, `init_state`, `Trainer`, `TrainConfig`,
`OptimizerConfig`, `apply_optimizer`, `TokenStream`), keep the
reference's parameter names, order, kinds and defaults.  The reference's signatures are read through `inspect`, so a
change there shows here.  The planned differences are named in
`PORT_ONLY`, `REF_ONLY` and `PLANNED_DEFAULTS`, each with its reason;
any other difference fails.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import client as ref_client
from repro.cluster import pool as ref_pool
from repro.cluster import router as ref_router
from repro.data import pipeline as ref_data
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_models
from repro.runtime import engine as ref_engine
from repro.training import optimizer as ref_optimizer
from repro.training import train_loop as ref_train
from repro_torch.api import client as port_client
from repro_torch.cluster import pool as port_pool
from repro_torch.cluster import router as port_router
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as port_data
from repro_torch.models import init_params, prefill
from repro_torch.models import layers as port_layers
from repro_torch.models import ssm as port_ssm
from repro_torch.models import transformer as port_models
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime import engine as port_engine
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.training import optimizer as port_optimizer
from repro_torch.training import train_loop as port_train

ARCH = "internlm2-1.8b"

#: the port's parameters the reference lacks: ``device`` (the port's
#: entry points choose the card or the CPU) and ``kv_out`` (a CUDA-graph
#: cell writes its KV into static buffers); ``prompt_kv_only`` (a paged
#: per-group prefill keeps only the prompt's KV)
PORT_ONLY = {"device", "kv_out", "prompt_kv_only"}
#: the reference's parameters the port's serving callables lack: none
#: (the model runtime ``rt`` reaches the serving callables and engines as
#: it does the training ones)
REF_ONLY: set = set()
#: defaults that differ on purpose, (callable, parameter) -> (reference's,
#: port's), normalised as by `_default`: the port's ``prefill`` defaults
#: ``max_len`` to the prompt width (the KV defaults to bf16 in both, and
#: both packages' engines ask for f32)
PLANNED_DEFAULTS = {
    ("prefill", "max_len"): ("<required>", None),
}

MODEL_FUNCTIONS = ("prefill", "prefill_suffix", "prefill_packed",
                   "decode_step", "embed_inputs")
#: the layer functions held the same way
LAYER_FUNCTIONS = ("positions_for",)
#: and the mamba block's
SSM_FUNCTIONS = ("apply_mamba", "apply_mamba_with_state", "apply_mamba_step",
                 "ssm_state_shapes")


def _shared_methods(ref_cls, port_cls):
    names = sorted(n for n in set(vars(ref_cls)) & set(vars(port_cls))
                   if n == "__init__" or not n.startswith("_"))
    out = []
    for n in names:
        a = inspect.getattr_static(ref_cls, n)
        b = inspect.getattr_static(port_cls, n)
        a = a.__func__ if isinstance(a, (classmethod, staticmethod)) else a
        b = b.__func__ if isinstance(b, (classmethod, staticmethod)) else b
        if inspect.isfunction(a) and inspect.isfunction(b):
            out.append((f"{port_cls.__name__}.{n}", a, b))
    return out


PAIRS = (
    _shared_methods(ref_client.TurboClient, port_client.TurboClient)
    + _shared_methods(ref_engine.InferenceEngine,
                      port_engine.InferenceEngine)
    + _shared_methods(ref_engine.ContinuousEngine,
                      port_engine.ContinuousEngine)
    + _shared_methods(ref_pool.ReplicaPool, port_pool.ReplicaPool)
    + _shared_methods(ref_pool.PooledHandle, port_pool.PooledHandle)
    + _shared_methods(ref_router.PrefixAffinityRouter,
                      port_router.PrefixAffinityRouter)
    + [(n, getattr(ref_models, n), getattr(port_models, n))
       for n in MODEL_FUNCTIONS]
    + [(n, getattr(ref_layers, n), getattr(port_layers, n))
       for n in LAYER_FUNCTIONS]
    + [(n, getattr(ref_ssm, n), getattr(port_ssm, n))
       for n in SSM_FUNCTIONS])


#: the training API: every parameter the reference's has, ``rt``
#: included, plus the port's ``device``
TRAIN_PAIRS = (
    [("forward_train", ref_models.forward_train,
      port_models.forward_train)]
    + [(n, getattr(ref_train, n), getattr(port_train, n))
       for n in ("make_train_step", "init_state", "Trainer",
                 "TrainConfig")]
    + [(n, getattr(ref_optimizer, n), getattr(port_optimizer, n))
       for n in ("OptimizerConfig", "apply_optimizer")]
    + [("TokenStream", ref_data.TokenStream, port_data.TokenStream)])


def _default(value):
    """A default in a form both packages can be compared by: a dataclass
    instance by its class name and fields, a dtype by its name."""
    if value is inspect.Parameter.empty:
        return "<required>"
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value).__name__, dataclasses.asdict(value)
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    if isinstance(value, type):
        return value.__name__
    return value


def _params(fn, drop):
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


def test_the_pairs_cover_the_named_callables():
    names = {n for n, _, _ in PAIRS}
    assert {"TurboClient.__init__", "TurboClient.from_arch",
            "TurboClient.submit", "TurboClient.simulated",
            "TurboClient.wait_warmup", "InferenceEngine.__init__",
            "ContinuousEngine.__init__", "ContinuousEngine.warmup_aot",
            "ReplicaPool.__init__", "ReplicaPool.submit",
            "ReplicaPool.kill_replica", "ReplicaPool.pump",
            "PooledHandle.result", "PrefixAffinityRouter.__init__",
            "PrefixAffinityRouter.route", "InferenceEngine.generate",
            *MODEL_FUNCTIONS, *LAYER_FUNCTIONS, *SSM_FUNCTIONS} <= names
    # every public method of the pool and the router is held
    for ref_cls, port_cls in ((ref_pool.ReplicaPool, port_pool.ReplicaPool),
                              (ref_router.PrefixAffinityRouter,
                               port_router.PrefixAffinityRouter)):
        public = {n for n, v in vars(ref_cls).items()
                  if inspect.isfunction(v) and not n.startswith("_")}
        assert {f"{port_cls.__name__}.{n}" for n in public} <= names


@pytest.mark.parametrize("name,ref_fn,port_fn", PAIRS,
                         ids=[n for n, _, _ in PAIRS])
def test_signature_matches_reference(name, ref_fn, port_fn):
    short = name.split(".")[-1]
    ref = _params(ref_fn, REF_ONLY)
    port = _params(port_fn, PORT_ONLY)
    for i, (pname, kind, default) in enumerate(ref):
        planned = PLANNED_DEFAULTS.get((short, pname))
        if planned is None or i >= len(port) or port[i][0] != pname:
            continue
        assert (default, port[i][2]) == planned, (name, pname)
        ref[i] = port[i] = (pname, kind, None)
    assert port == ref, name


@pytest.mark.parametrize("name,ref_fn,port_fn", TRAIN_PAIRS,
                         ids=[n for n, _, _ in TRAIN_PAIRS])
def test_train_signature_matches_reference(name, ref_fn, port_fn):
    assert _params(port_fn, PORT_ONLY) == _params(ref_fn, set()), name


def test_planned_differences_are_still_differences():
    """Each name in the planned sets marks a real difference somewhere:
    a planned entry the two packages no longer need fails here."""
    ref_names = {p for _, f, _ in PAIRS
                 for p in inspect.signature(f).parameters}
    port_names = {p for _, _, f in PAIRS
                  for p in inspect.signature(f).parameters}
    assert REF_ONLY <= ref_names - port_names
    assert PORT_ONLY <= port_names - ref_names
    for short, pname in PLANNED_DEFAULTS:
        ref = inspect.signature(getattr(ref_models, short)).parameters
        port = inspect.signature(getattr(port_models, short)).parameters
        assert _default(ref[pname].default) != \
            _default(port[pname].default)


def test_background_warmup_is_refused_until_ported():
    """``warmup="background"`` is ported: the client accepts it (a
    backend without ``warmup_aot`` warms nothing, as in the reference)
    and, like the reference's, refuses any other warm-up mode by name."""
    client = port_client.TurboClient(object(), warmup="background",
                                     auto_pump=False)
    assert client.warmup_stats is None and client.wait_warmup() == {}
    for mode in ("eager", "later"):
        with pytest.raises(ValueError, match="background"):
            port_client.TurboClient(object(), warmup=mode)
        with pytest.raises(ValueError, match="background"):
            ref_client.TurboClient(object(), warmup=mode)


def test_from_arch_warms_up_by_default(monkeypatch):
    calls = []

    def fake_warmup(self, progress=None):
        calls.append(self)
        return {"compile_count": 0, "warmup_seconds": 0.0, "rounds": 0}
    monkeypatch.setattr(port_engine.ContinuousEngine, "warmup_aot",
                        fake_warmup)
    client = port_client.TurboClient.from_arch(ARCH, device="cpu",
                                               auto_pump=False)
    assert len(calls) == 1 and client.warmup_stats["rounds"] == 0
    port_client.TurboClient.from_arch(ARCH, device="cpu", auto_pump=False,
                                      warmup=False)
    assert len(calls) == 1


def test_warmup_progress_counts_every_round():
    cfg = get_smoke_config(ARCH)
    engine = port_engine.InferenceEngine(
        cfg, init_params(cfg, seed=0, device="cpu"),
        ladder=BucketLadder(seq_buckets=(16, 32), batch_buckets=(1, 2)),
        device="cpu")
    ce = port_engine.ContinuousEngine(engine, max_slots=2, cap_new=4)
    seen = []
    stats = ce.warmup_aot(progress=seen.append)
    assert seen == list(range(1, stats["rounds"] + 1))


def test_prefill_embeds_override_matches_reference():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    emb = (rng.standard_normal((2, 5, cfg.d_model)) * 0.1).astype(np.float32)
    want, _ = jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=12,
                          embeds_override=jnp.asarray(emb),
                          cache_dtype=jnp.float32)
    got, _ = prefill(cfg, tparams, torch.from_numpy(toks), max_len=12,
                     embeds_override=torch.from_numpy(emb))
    plain, _ = prefill(cfg, tparams, torch.from_numpy(toks), max_len=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert not torch.allclose(got, plain)
