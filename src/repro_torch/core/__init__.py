"""The paper's contributions the port carries, as in the JAX package:

C2 — ``allocator`` (Algorithm 1) + ``usage_records`` (lifetimes read from
     the port's op graph) + ``allocator_baselines`` (caching/GSOC
     comparisons), copied from the JAX package but for the graph reader;
C3 — the scheduling core: cost models, the DP batch scheduler and its
     baselines, the iteration-level serving pipeline, the one-shot
     serving system and the discrete-event simulator (Poisson arrivals
     over virtual-clock replicas; copied from the JAX package).
"""
from repro_torch.core.allocator import (AllocationPlan, Chunk,
                                        SequenceAwareAllocator,
                                        TensorUsageRecord,
                                        find_gap_from_chunk, validate_plan)
from repro_torch.core.allocator_baselines import (CachingAllocator,
                                                  GSOCAllocator)
from repro_torch.core.cost_model import (AnalyticCostModel,
                                         BucketedCostModel, CostModel,
                                         TableCostModel)
from repro_torch.core.pipeline import (PipelineBackend, PipelineConfig,
                                       PipelineStats, ServingPipeline,
                                       plan_for_policy)
from repro_torch.core.scheduler import (BatchPlan, brute_force_schedule,
                                        dp_schedule, naive_schedule,
                                        nobatch_schedule)
from repro_torch.core.serving import (Request, Response, ResponseCache,
                                      ServingConfig, ServingSystem)
from repro_torch.core.simulator import (SimConfig, SimResult,
                                        VirtualBackend, VirtualClock,
                                        Workload, critical_point, simulate,
                                        throughput_curve)
from repro_torch.core.usage_records import (dedup_repeated_structure,
                                            peak_live_bytes, records_for_fn,
                                            records_from_graph)

__all__ = ["AllocationPlan", "AnalyticCostModel", "BatchPlan",
           "BucketedCostModel", "CachingAllocator", "Chunk", "CostModel",
           "GSOCAllocator", "PipelineBackend", "PipelineConfig",
           "PipelineStats", "Request", "Response", "ResponseCache",
           "SequenceAwareAllocator", "ServingConfig", "ServingPipeline",
           "ServingSystem", "SimConfig", "SimResult", "TableCostModel",
           "TensorUsageRecord", "VirtualBackend", "VirtualClock",
           "Workload", "brute_force_schedule", "critical_point",
           "dedup_repeated_structure", "dp_schedule", "find_gap_from_chunk",
           "naive_schedule", "nobatch_schedule", "peak_live_bytes",
           "plan_for_policy", "records_for_fn", "records_from_graph",
           "simulate", "throughput_curve", "validate_plan"]
