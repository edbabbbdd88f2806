from repro_torch.distributed.sharding import (ShardingRules, axis_size,
                                              constrain, current_rules,
                                              sharding_rules)

__all__ = ["constrain", "sharding_rules", "current_rules", "axis_size",
           "ShardingRules"]
