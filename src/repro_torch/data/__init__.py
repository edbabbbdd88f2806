"""Training batches and request streams (the JAX package's
`repro.data`)."""
from repro_torch.data.pipeline import (LengthDistribution, RequestGenerator,
                                       TokenStream)

__all__ = ["LengthDistribution", "RequestGenerator", "TokenStream"]
