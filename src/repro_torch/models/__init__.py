"""The port's decoder (`repro_torch.models.transformer`: dense, VLM,
audio, MoE, SSM or hybrid), its layers, the MoE layer
(`repro_torch.models.moe`), the mamba blocks (`repro_torch.models.ssm`), the
stub modality front ends (`repro_torch.models.frontend`), the model
inputs (`repro_torch.models.io`) and the weight bridge from the JAX
package."""
from repro_torch.models.transformer import (DEFAULT_RUNTIME, ModelRuntime,
                                            cache_specs, decode_step,
                                            embed_inputs, forward_hidden,
                                            forward_train, init_params,
                                            logits_at, make_cache,
                                            make_paged_cache, prefill,
                                            prefill_packed, prefill_suffix)

__all__ = ["DEFAULT_RUNTIME", "ModelRuntime", "cache_specs", "decode_step",
           "embed_inputs", "forward_hidden", "forward_train", "init_params",
           "logits_at", "make_cache", "make_paged_cache", "prefill",
           "prefill_packed", "prefill_suffix"]
