"""The port's decoder (`repro_torch.models.transformer`, dense or MoE),
its layers, the MoE layer (`repro_torch.models.moe`) and the weight
bridge from the JAX package."""
from repro_torch.models.transformer import (decode_step, forward_hidden,
                                            init_params, logits_at,
                                            make_cache, make_paged_cache,
                                            prefill, prefill_packed,
                                            prefill_suffix)

__all__ = ["decode_step", "forward_hidden", "init_params", "logits_at",
           "make_cache", "make_paged_cache", "prefill", "prefill_packed",
           "prefill_suffix"]
