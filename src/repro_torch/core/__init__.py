"""Scheduling core of the port: cost model, DP batch scheduler and the
iteration-level serving pipeline (copied from the JAX package)."""
from repro_torch.core.cost_model import AnalyticCostModel, CostModel
from repro_torch.core.pipeline import (PipelineBackend, PipelineConfig,
                                       ServingPipeline)
from repro_torch.core.scheduler import BatchPlan, dp_schedule

__all__ = ["AnalyticCostModel", "BatchPlan", "CostModel", "PipelineBackend",
           "PipelineConfig", "ServingPipeline", "dp_schedule"]
