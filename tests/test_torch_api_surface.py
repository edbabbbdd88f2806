"""The port's host modules carry the JAX package's public surface.

An AST scan: every public module function and public class method of a
JAX-package module with a counterpart file in the port exists there,
but for the planned absences below, each with its reason.  The scan
found the serving system's generative mode (``backend=``, ``cancel``,
``cost``, ``should_flush``), ``Session.from_request`` / ``cache_key`` /
``budget_left``, ``GenerationParams.is_greedy``, the trace recorder's
``request_ids`` / ``request_events`` / ``request_names`` / ``save``,
``BucketLadder.padding_waste`` / ``num_cells``,
``CostModel.per_request``, ``AnalyticCostModel.for_model`` and
``configs.all_configs`` missing; each is held below to the JAX
package's on the same inputs.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core import ServingConfig as JaxServingConfig
from repro.core import ServingSystem as JaxServingSystem
from repro.core import TableCostModel as JaxTableCostModel
from repro.core.cost_model import AnalyticCostModel as JaxAnalytic
from repro.core.serving import Request as JaxRequest
from repro.models import init_params as jax_init_params
from repro.obs.trace import TraceRecorder as JaxTraceRecorder
from repro.runtime import BucketLadder as JaxLadder
from repro.runtime import ContinuousEngine as JaxContinuousEngine
from repro.runtime import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro.runtime.session import Session as JaxSession
from repro_torch import configs
from repro_torch.core import ServingConfig, ServingSystem, TableCostModel
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.serving import Request
from repro_torch.models.bridge import params_from_numpy
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime import (BucketLadder, ContinuousEngine,
                                 InferenceEngine)
from repro_torch.runtime.session import GenerationParams, Session

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: (module, class or "<module>", name): why the port has no counterpart
PLANNED = {
    ("core/usage_records.py", "<module>", "records_from_jaxpr"):
        "reads a jaxpr; the port reads its FX graph (records_from_graph)",
    ("kernels/flash_attention.py", "<module>", "flash_attention_pallas"):
        "the Pallas kernel; the port's is CUDA (flash_attention_cuda)",
    ("kernels/flash_decode.py", "<module>", "flash_decode_pallas"):
        "the Pallas kernel; the port's is CUDA",
    ("kernels/flash_decode.py", "<module>", "flash_decode_paged_pallas"):
        "the Pallas kernel; the port's is CUDA",
    ("kernels/layernorm.py", "<module>", "norm_pallas"):
        "the Pallas kernel; the port's is CUDA (norm_cuda)",
    ("kernels/sampling.py", "<module>", "sample_pallas"):
        "the Pallas kernel; the port's is CUDA (sample_cuda)",
    ("kernels/sampling.py", "<module>", "default_block_rows"):
        "a Pallas tile size; the CUDA kernel's plan is sample_plan",
    ("kernels/softmax.py", "<module>", "softmax_pallas"):
        "the Pallas kernel; the port's is CUDA",
    ("kernels/softmax.py", "<module>", "default_block_rows"):
        "a Pallas tile size",
    ("launch/dryrun.py", "<module>", "collective_stats"):
        "parses HLO text; the port counts collectives in its graph "
        "(graph_analysis)",
    ("models/layers.py", "<module>", "attention_chunked"):
        "jnp online-softmax attention; the port's serving attention is "
        "the flash kernels",
    ("models/layers.py", "<module>", "attention_decode"):
        "jnp decode attention; the port's is the decode kernels",
    ("models/layers.py", "<module>", "expand_kv"):
        "a jnp GQA helper of the two above",
}


def _surface(path: Path):
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            out[node.name] = {m.name for m in node.body
                              if isinstance(m, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                              and not m.name.startswith("_")}
        elif isinstance(node, ast.FunctionDef) and \
                not node.name.startswith("_"):
            out.setdefault("<module>", set()).add(node.name)
    return out


def test_port_carries_the_reference_public_surface():
    missing = set()
    for ref_path in sorted(REF.rglob("*.py")):
        rel = ref_path.relative_to(REF)
        port_path = PORT / rel
        if not port_path.exists():
            continue
        ref, port = _surface(ref_path), _surface(port_path)
        for owner, names in ref.items():
            for name in names - port.get(owner, set()):
                missing.add((rel.as_posix(), owner, name))
    assert missing == set(PLANNED), sorted(missing ^ set(PLANNED))


def test_session_helpers_equal_the_reference():
    kw = dict(req_id=3, seq_len=4, arrival_time=0.5, prompt=[1, 2, 3, 4],
              max_new_tokens=9, temperature=0.7, top_k=5, top_p=0.9,
              seed=11)
    port, ref = Session(**kw), JaxSession(**kw)
    assert port.cache_key() == ref.cache_key()
    port.generated, ref.generated = [5, 6], [5, 6]
    assert port.budget_left == ref.budget_left == 7
    for t in (0.0, 0.5):
        assert GenerationParams(temperature=t).is_greedy == \
            JaxParams(temperature=t).is_greedy
    req = (7, 3, 1.0, [4, 5, 6])
    a = Session.from_request(Request(*req), max_new_tokens=2)
    b = JaxSession.from_request(JaxRequest(*req), max_new_tokens=2)
    assert (a.req_id, a.seq_len, a.prompt, a.payload, a.max_new_tokens,
            a.cache_key()) == (b.req_id, b.seq_len, b.prompt, b.payload,
                               b.max_new_tokens, b.cache_key())


def test_ladder_cost_and_config_helpers_equal_the_reference():
    lad = dict(seq_buckets=(16, 64), batch_buckets=(1, 4))
    for lengths in ([], [3], [10, 60, 2]):
        assert BucketLadder(**lad).padding_waste(lengths) == \
            JaxLadder(**lad).padding_waste(lengths)
    assert BucketLadder(**lad).num_cells() == JaxLadder(**lad).num_cells()
    assert set(configs.all_configs()) == set(jax_configs.all_configs())
    for arch, cfg in configs.all_configs().items():
        assert cfg.param_count() == \
            jax_configs.all_configs()[arch].param_count()
        port = AnalyticCostModel.for_model(cfg, chips=2)
        ref = JaxAnalytic.for_model(jax_configs.get_config(arch), chips=2)
        assert (port.flops_per_token, port.bytes_per_token,
                port.weight_bytes, port.chips) == (
            ref.flops_per_token, ref.bytes_per_token, ref.weight_bytes,
            ref.chips)
        assert port.per_request(128, 4) == port.latency(128, 4) / 4
    table = {(32, 1): 1e-3, (32, 4): 3e-3}
    assert TableCostModel(dict(table)).per_request(32, 4) == \
        JaxTableCostModel(dict(table)).per_request(32, 4)


def test_trace_recorder_queries_equal_the_reference(tmp_path):
    recs = (TraceRecorder(), JaxTraceRecorder())
    for rec in recs:
        for rid in (4, 2):
            s = Session(rid, 3, 0.0)
            s.trace_id = rid + 100
            rec.req_event(s, "enqueue", 0.1)
            rec.tick("prefill", 0.2, 0.3, batch=1)
            rec.req_event(s, "admit", 0.2)
            rec.req_event(s, "finish", 0.4)
    port, ref = recs
    assert port.request_ids() == ref.request_ids() == [4, 2]
    assert port.request_names(2) == ref.request_names(2) == \
        ["enqueue", "admit", "finish"]
    assert port.request_events(4) == ref.request_events(4)
    assert port.save(str(tmp_path / "a.json")) == \
        ref.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()


@pytest.fixture(scope="module")
def systems():
    jcfg = jax_configs.get_smoke_config("internlm2-1.8b")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    table = {(32, 1): 1e-3, (32, 4): 3e-3}
    lad = dict(seq_buckets=(32,), batch_buckets=(1, 4))

    def make(Engine, Continuous, Ladder, System, Config, Table, c, p, **kw):
        engine = Engine(c, p, ladder=Ladder(**lad), **kw)
        return System(backend=Continuous(engine, max_slots=4, cap_new=16),
                      cost_model=Table(dict(table)),
                      config=Config(max_batch_size=4, enable_cache=True))
    return (make(InferenceEngine, ContinuousEngine, BucketLadder,
                 ServingSystem, ServingConfig, TableCostModel, cfg, tparams,
                 device="cpu"),
            make(JaxInferenceEngine, JaxContinuousEngine, JaxLadder,
                 JaxServingSystem, JaxServingConfig, JaxTableCostModel,
                 jcfg, jparams))


def test_serving_system_generative_mode_and_cancel(systems):
    """Sessions through ``ServingSystem(backend=...)``: a mid-decode
    cancel collects the partial response at once; a repeated request is
    a cache hit keyed on its full identity."""
    out = []
    for system, Sess in zip(systems, (Session, JaxSession)):
        assert system.cost is system.pipeline.cost
        a = Sess(1, 3, 0.0, prompt=[3, 4, 5], max_new_tokens=12)
        b = Sess(2, 2, 0.0, prompt=[6, 7], max_new_tokens=4)
        system.submit(a)
        system.submit(b)
        flush = system.should_flush()
        for _ in range(3):
            system.step()
        assert system.cancel(a)
        assert not system.cancel(a)
        system.drain()
        again = system.submit(Sess(3, 2, 0.0, prompt=[6, 7],
                                   max_new_tokens=4))
        out.append((flush, [(r.req_id, list(r.result), r.cached)
                            for r in system.responses],
                    again is not None and again.cached))
    assert out[0] == out[1]
    assert out[0][2] is True
