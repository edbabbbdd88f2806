"""Scheduling core of the port: cost models, the DP batch scheduler and
its baselines, the iteration-level serving pipeline and the one-shot
serving system (copied from the JAX package)."""
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

__all__ = ["AnalyticCostModel", "BatchPlan", "BucketedCostModel",
           "CostModel", "PipelineBackend", "PipelineConfig", "Request",
           "Response", "ResponseCache", "ServingConfig", "ServingPipeline",
           "ServingSystem", "TableCostModel", "brute_force_schedule",
           "dp_schedule", "naive_schedule", "nobatch_schedule",
           "plan_for_policy"]
