"""The port's four examples (`examples/torch/`) on the CPU, each through
its ``main(argv)`` with small arguments and ``--device cpu``, held to the
JAX package:

- quickstart: its labels and generations equal the JAX package's
  `InferenceEngine` on the weights bridged from ``init_params(cfg,
  key(0))``, on the same requests;
- train_small: the resumed run (from a checkpoint written before the
  injected failure) is bitwise identical to an uninterrupted one;
- serve_e2e: every phase answers every request under each policy
  (dp, naive, nobatch), and its generative phases equal the JAX
  package's `ServingSystem` over its `ContinuousEngine` on bridged
  weights;
- allocator_scheduler_demo: Algorithm 2's plans equal the JAX package's
  on Fig. 8's lengths, Algorithm 1's plans are valid and release memory
  when requests shrink.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core import BucketedCostModel as JaxBucketedCostModel
from repro.core import ServingConfig as JaxServingConfig
from repro.core import ServingSystem as JaxServingSystem
from repro.core import TableCostModel as JaxTableCostModel
from repro.core import dp_schedule as jax_dp
from repro.core import naive_schedule as jax_naive
from repro.core import nobatch_schedule as jax_nobatch
from repro.models import init_params as jax_init_params
from repro.runtime import BucketLadder as JaxLadder
from repro.runtime import ContinuousEngine as JaxContinuousEngine
from repro.runtime import InferenceEngine as JaxInferenceEngine
from repro.runtime import Session as JaxSession
from repro_torch.configs import get_smoke_config
from repro_torch.core import (BucketedCostModel, ServingConfig,
                              ServingSystem, TableCostModel)
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime import (BucketLadder, ContinuousEngine,
                                 GenerationParams, InferenceEngine, Session)
from repro_torch.runtime import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"


def example(name: str):
    """Import ``examples/torch/<name>.py`` as a module (its ``main`` runs
    only when called)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def test_quickstart_main_runs_on_the_cpu(capsys):
    labels, outs, engine = example("quickstart").main(["--device", "cpu"])
    assert len(labels) == 3 and all(0 <= x < 256 for x in labels)
    assert [len(o) for o in outs] == [3 + 8, 5 + 8]
    assert engine.kv_slab.live_bytes == 0
    text = capsys.readouterr().out
    assert "predicted classes:" in text and "KV slab footprint" in text


def test_quickstart_equals_the_reference_engine(weights):
    jcfg, jparams, tparams = weights
    qs = example("quickstart")
    cfg = get_smoke_config(ARCH)
    labels, outs, _ = qs.run(cfg, tparams, "cpu")
    ref = JaxInferenceEngine(jcfg, jparams)
    assert labels == ref.classify(qs.requests_for(cfg))
    assert outs == ref.generate(qs.PROMPTS, max_new_tokens=8)


def test_train_small_resumes_bitwise_identical(monkeypatch, capsys):
    """The failure at step 52 comes after the checkpoint of step 50;
    checkpoints are written synchronously here so the resume finds it
    (the example writes them in the background, as the trainer does)."""
    from repro_torch.training import train_loop
    save_async, load_latest_of, loads = ckpt.save_async, \
        ckpt.load_latest, []

    def save_now(*args, **kwargs):
        thread = save_async(*args, **kwargs)
        thread.join()
        return thread

    def load_latest(directory):
        got = load_latest_of(directory)
        loads.append(None if got is None else got[0])
        return got
    monkeypatch.setattr(train_loop.ckpt, "save_async", save_now)
    monkeypatch.setattr(train_loop.ckpt, "load_latest", load_latest)
    same = example("train_small").main(
        ["--device", "cpu", "--steps", "104", "--batch", "2", "--seq",
         "16"])
    text = capsys.readouterr().out
    assert same is True
    assert "injected failure at step 52" in text
    assert "crash/resume trajectory bitwise identical: True" in text
    assert loads == [None, 50]       # the fresh run, then the resume


@pytest.mark.parametrize("policy", ["dp", "naive", "nobatch"])
def test_serve_e2e_answers_every_request(policy, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = example("serve_e2e").main(
        ["--device", "cpu", "--policy", policy, "--num-requests", "16",
         "--replicas", "2" if policy == "dp" else "1"])
    assert len(out["one_shot"]) == out["one_shot_requests"] > 0
    assert all(r is not None for r in out["one_shot"].values())
    gen = out["generative"]
    assert [len(gen[0]), len(gen[1])] == [6 + 24, 3 + 8]
    assert out["prefix"]["hits"] >= 3
    assert len(out["client"]["sampled"]) == 8
    assert len(out["client"]["greedy"]) == \
        4 + GenerationParams().max_new_tokens
    assert (tmp_path / "serve_e2e_trace.json").exists()
    if policy == "dp":
        assert out["pool"] == {"finished": 6, "lost": 0, "submitted": 6}
    else:
        assert "pool" not in out


def test_serve_e2e_generative_phase_equals_the_reference(weights):
    """The example's phases 2 and 3 on the port's `ServingSystem` over its
    `ContinuousEngine`, and on the JAX package's, with bridged weights and
    one cost table: equal results, and equal prefix-cache hits."""
    jcfg, jparams, tparams = weights
    ladder = dict(seq_buckets=(32, 64, 128, 256),
                  batch_buckets=(1, 2, 4, 8, 16))
    table = {(32, 1): 1e-3, (32, 8): 2e-3, (256, 1): 4e-3, (256, 8): 8e-3}

    def run(Engine, Continuous, Ladder, System, Config, Bucketed, Table,
            Sess, cfg, params, **kw):
        engine = Engine(cfg, params, ladder=Ladder(**ladder), **kw)
        backend = Continuous(engine, max_slots=8, cap_new=32,
                             prefix_cache=True)
        cost = Bucketed(Table(dict(table)), buckets=ladder["seq_buckets"])
        system = System(backend=backend, cost_model=cost,
                        config=Config(policy="dp", strategy="hungry",
                                      max_batch_size=8))
        first = Sess(0, 6, 0.0, prompt=[1, 2, 3, 4, 5, 6],
                     max_new_tokens=24)
        system.submit(first)
        for _ in range(5):
            system.step()
        system.submit(Sess(1, 3, 0.0, prompt=[7, 8, 9], max_new_tokens=8))
        system.drain()
        preamble = list(range(5, 37))
        system.submit(Sess(10, 33, 0.0, prompt=preamble + [40],
                           max_new_tokens=4))
        system.drain()
        for i in range(3):
            system.submit(Sess(11 + i, 34, 0.0,
                               prompt=preamble + [50 + i, 60 + i],
                               max_new_tokens=6))
        system.drain()
        results = {r.req_id: list(r.result) for r in system.responses}
        return results, backend.prefix_stats()["hits"]

    got = run(InferenceEngine, ContinuousEngine, BucketLadder,
              ServingSystem, ServingConfig, BucketedCostModel,
              TableCostModel, Session, get_smoke_config(ARCH), tparams,
              device="cpu")
    want = run(JaxInferenceEngine, JaxContinuousEngine, JaxLadder,
               JaxServingSystem, JaxServingConfig, JaxBucketedCostModel,
               JaxTableCostModel, JaxSession, jcfg, jparams)
    assert got == want
    assert sorted(got[0]) == [0, 1, 10, 11, 12, 13] and got[1] >= 3


def test_allocator_scheduler_demo():
    out = example("allocator_scheduler_demo").main(["--device", "cpu"])
    cm = JaxCostModel(flops_per_token=2 * 110e6, bytes_per_token=2e4,
                      weight_bytes=2.2e8, overhead=1.2e-3,
                      peak_flops=6.5e12, hbm_bw=336e9)
    lengths = [17, 18, 52, 63, 77]
    for name, sched in (("dp", jax_dp), ("naive", jax_naive),
                        ("nobatch", jax_nobatch)):
        plan = sched(lengths, cm)
        cost, batches = out[name]
        assert cost == pytest.approx(plan.total_cost, rel=1e-12)
        assert batches == [[lengths[i] for i in b] for b in plan.batches]
    assert out["dp"][0] < min(out["naive"][0], out["nobatch"][0])
    seqs = [f[0] for f in out["footprints"]]
    turbo = [f[2] for f in out["footprints"]]
    caching = [f[3] for f in out["footprints"]]
    assert seqs == [64, 200, 480, 240, 64]
    assert all(f[1] > 0 for f in out["footprints"])
    # Algorithm 1 gives memory back when requests shrink; the caching
    # allocator ratchets
    assert turbo[-1] == turbo[0] < turbo[2]
    assert caching == sorted(caching) and caching[-1] > turbo[-1]
