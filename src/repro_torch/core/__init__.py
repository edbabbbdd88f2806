"""The paper's contributions the port carries, as in the JAX package:

C2 — ``allocator`` (Algorithm 1) + ``usage_records`` (lifetimes read from
     the port's op graph) + ``allocator_baselines`` (caching/GSOC
     comparisons), copied from the JAX package but for the graph reader;
C3 — the scheduling core: cost models, the DP batch scheduler and its
     baselines, the iteration-level serving pipeline and the one-shot
     serving system (copied from the JAX package).
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
                                       ServingPipeline, plan_for_policy)
from repro_torch.core.scheduler import (BatchPlan, brute_force_schedule,
                                        dp_schedule, naive_schedule,
                                        nobatch_schedule)
from repro_torch.core.serving import (Request, Response, ResponseCache,
                                      ServingConfig, ServingSystem)
from repro_torch.core.usage_records import (dedup_repeated_structure,
                                            peak_live_bytes, records_for_fn,
                                            records_from_graph)

__all__ = ["AllocationPlan", "AnalyticCostModel", "BatchPlan",
           "BucketedCostModel", "CachingAllocator", "Chunk", "CostModel",
           "GSOCAllocator", "PipelineBackend", "PipelineConfig", "Request",
           "Response", "ResponseCache", "SequenceAwareAllocator",
           "ServingConfig", "ServingPipeline", "ServingSystem",
           "TableCostModel", "TensorUsageRecord", "brute_force_schedule",
           "dedup_repeated_structure", "dp_schedule", "find_gap_from_chunk",
           "naive_schedule", "nobatch_schedule", "peak_live_bytes",
           "plan_for_policy", "records_for_fn", "records_from_graph",
           "validate_plan"]
