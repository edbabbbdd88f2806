"""The port's dense decoder (`repro_torch.models.transformer`), its layers
and the weight bridge from the JAX package."""
from repro_torch.models.transformer import (decode_step, forward_hidden,
                                            init_params, logits_at,
                                            make_cache, make_paged_cache,
                                            prefill, prefill_packed)

__all__ = ["decode_step", "forward_hidden", "init_params", "logits_at",
           "make_cache", "make_paged_cache", "prefill", "prefill_packed"]
