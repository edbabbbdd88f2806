"""The port's discrete-event simulator against the JAX package's.

`repro_torch.core.simulator` is host code copied from the reference: the
same `Workload` under the same `SimConfig` and one cost model spelled
out in full for both packages (the port's `AnalyticCostModel` defaults
are H100 peaks, the reference's v5e ones) must give a `SimResult` equal
field for field, exactly: responses, telemetry, the pipeline's
counters, the batch log and the trace.  Covered: the paper's one-shot
classification under each policy, generative workloads packed and per
group, chunked prefill (fused with decode and not), the prefix-cache
model, paged-KV capacity, stragglers with and without mitigation, the
drain admission and hold-to-batch-end KV, 1 and 3 replicas, a bucketed
cost table as the card's classify phase measures one, and the
throughput sweep with its critical point.
"""
import dataclasses

import pytest

from repro.core import simulator as ref_sim
from repro.core.cost_model import AnalyticCostModel as RefAnalytic
from repro.core.cost_model import BucketedCostModel as RefBucketed
from repro.core.cost_model import TableCostModel as RefTable
from repro_torch.core import simulator as port_sim
from repro_torch.core.cost_model import (AnalyticCostModel,
                                         BucketedCostModel, TableCostModel)

#: one cost model, spelled out in full for both packages
COST = dict(flops_per_token=1e6, bytes_per_token=1e3, weight_bytes=1e6,
            overhead=1e-4, peak_flops=197e12, hbm_bw=819e9)
#: a (length, batch) -> seconds table of the shape the card's classify
#: phase measures (lengths 32, 128, 512 x batches 1, 4, 16)
TABLE = {(32, 1): 2.1e-3, (32, 4): 2.6e-3, (32, 16): 4.4e-3,
         (128, 1): 2.9e-3, (128, 4): 5.0e-3, (128, 16): 1.31e-2,
         (512, 1): 6.2e-3, (512, 4): 1.72e-2, (512, 16): 6.05e-2}
BUCKETS = (32, 64, 128, 256, 512)


def _cost(pkg: str, kind: str):
    if kind == "analytic":
        return (RefAnalytic if pkg == "ref" else AnalyticCostModel)(**COST)
    table = (RefTable if pkg == "ref" else TableCostModel)(TABLE)
    return (RefBucketed if pkg == "ref" else BucketedCostModel)(
        table, buckets=BUCKETS)


#: (workload, config, cost kind, trace) per case
CASES = {
    "classify_nobatch": (dict(rate=150.0, duration=2.0),
                         dict(policy="nobatch"), "analytic", False),
    "classify_naive": (dict(rate=150.0, duration=2.0),
                       dict(policy="naive"), "analytic", False),
    "classify_dp": (dict(rate=150.0, duration=2.0), dict(policy="dp"),
                    "analytic", False),
    "classify_dp_card_table": (
        dict(rate=200.0, duration=1.0, len_min=5, len_max=500),
        dict(policy="dp", max_batch_size=20), "table", False),
    "classify_nobatch_card_table": (
        dict(rate=200.0, duration=1.0, len_min=5, len_max=500),
        dict(policy="nobatch", max_batch_size=20), "table", False),
    "generate_packed": (dict(rate=60.0, duration=2.0, gen_tokens=24,
                             gen_min=4),
                        dict(max_decode_slots=8), "analytic", False),
    "generate_per_group": (dict(rate=60.0, duration=2.0, gen_tokens=24,
                                gen_min=4),
                           dict(max_decode_slots=8, packed_prefill=False),
                           "analytic", False),
    "chunked_fused_packed": (
        dict(rate=40.0, duration=2.0, gen_tokens=32, gen_min=8,
             long_len=600, long_frac=0.25),
        dict(chunked_prefill=True, prefill_chunk_tokens=64,
             kv_block_size=16, num_kv_blocks=512, max_decode_slots=8),
        "analytic", False),
    "chunked_unfused_per_group": (
        dict(rate=40.0, duration=2.0, gen_tokens=32, gen_min=8,
             long_len=600, long_frac=0.25),
        dict(chunked_prefill=True, prefill_chunk_tokens=64,
             fused_chunk_decode=False, packed_prefill=False,
             kv_block_size=16, num_kv_blocks=512, max_decode_slots=8),
        "analytic", False),
    "prefix_cache": (dict(rate=50.0, duration=2.0, gen_tokens=16,
                          prefix_tokens=64, prefix_mix=0.6),
                     dict(prefix_cache=True, kv_block_size=16,
                          num_kv_blocks=400), "analytic", False),
    "stragglers": (dict(rate=100.0, duration=2.0),
                   dict(straggler_prob=0.2, seed=3), "analytic", False),
    "stragglers_mitigated": (dict(rate=100.0, duration=2.0),
                             dict(straggler_prob=0.2, seed=3,
                                  mitigate_stragglers=True),
                             "analytic", False),
    "drain_batch_kv": (dict(rate=60.0, duration=1.5, gen_tokens=12,
                            gen_min=2),
                       dict(admission="drain", kv_free="batch",
                            max_decode_slots=4), "analytic", False),
    "replicas_3": (dict(rate=300.0, duration=1.5, gen_tokens=8,
                        gen_min=2),
                   dict(num_replicas=3, max_decode_slots=4), "analytic",
                   False),
    "replicas_3_stragglers": (dict(rate=300.0, duration=1.0),
                              dict(num_replicas=3, straggler_prob=0.1,
                                   mitigate_stragglers=True, seed=5),
                              "analytic", False),
    "traced": (dict(rate=60.0, duration=1.0, gen_tokens=8, gen_min=2),
               dict(chunked_prefill=True, prefill_chunk_tokens=32),
               "analytic", True),
}


def _result(res) -> dict:
    """A `SimResult` as plain data, every field and derived statistic."""
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    out["responses"] = [dataclasses.asdict(r) for r in res.responses]
    out["stats"] = dict(vars(res.stats))
    out["derived"] = (res.throughput, res.unstable, res.latency_stats(),
                      res.peak_kv_tokens, res.mean_kv_tokens,
                      res.itl_percentile(0.99), res.ttft_percentile(0.5))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_equals_reference(case):
    wl, cfg, cost, trace = CASES[case]
    want = ref_sim.simulate(ref_sim.Workload(**wl), _cost("ref", cost),
                            ref_sim.SimConfig(**cfg), trace=trace)
    got = port_sim.simulate(port_sim.Workload(**wl), _cost("port", cost),
                            port_sim.SimConfig(**cfg), trace=trace)
    assert got.responses, case
    assert _result(got) == _result(want), case


def test_sessions_and_pipeline_config_equal_reference():
    """The workload's sessions (arrival, lengths, synthetic EOS, prefix
    cohort) and the pipeline configuration a SimConfig gives."""
    wl = dict(rate=80.0, duration=1.0, gen_tokens=20, gen_min=3,
              prefix_tokens=32, prefix_mix=0.5, long_len=300,
              long_frac=0.2, seed=7)

    def fields(s):
        return (s.req_id, s.seq_len, s.arrival_time, s.max_new_tokens,
                s.eos_at, s.prefix_group, s.shared_prefix_len)
    want = [fields(s) for s in ref_sim.Workload(**wl).generate_sessions()]
    got = [fields(s) for s in port_sim.Workload(**wl).generate_sessions()]
    assert got == want and any(f[4] is not None for f in got)
    cfg = dict(policy="naive", chunked_prefill=True, packed_prefill=False)
    assert dataclasses.asdict(port_sim.SimConfig(**cfg).pipeline_config()) \
        == dataclasses.asdict(ref_sim.SimConfig(**cfg).pipeline_config())


def test_throughput_curve_and_critical_point_equal_reference():
    rates = (50.0, 200.0, 800.0, 3200.0)
    kw = dict(duration=1.0, len_min=5, len_max=500)
    for policy in ("nobatch", "dp"):
        want = ref_sim.throughput_curve(rates, _cost("ref", "table"),
                                        ref_sim.SimConfig(policy=policy),
                                        **kw)
        got = port_sim.throughput_curve(rates, _cost("port", "table"),
                                        port_sim.SimConfig(policy=policy),
                                        **kw)
        assert got == want
        assert port_sim.critical_point(
            rates, _cost("port", "table"), port_sim.SimConfig(policy=policy),
            **kw) == ref_sim.critical_point(
                rates, _cost("ref", "table"),
                ref_sim.SimConfig(policy=policy), **kw)
