"""Request streams for the serving paths (the serving part of the JAX
package's `repro.data`)."""
from repro_torch.data.pipeline import LengthDistribution, RequestGenerator

__all__ = ["LengthDistribution", "RequestGenerator"]
