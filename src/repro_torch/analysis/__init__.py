"""repro_torch.analysis — the port's static checks (turbolint).

`python -m repro_torch.analysis.lint` runs the JAX package's four AST
rules (host-sync, recompile-hazard, lock-discipline, kernel-parity; see
`repro_torch.analysis.rules`) over the port's hot paths, configured by
`turbolint_torch.toml` at the repo root.  The runtime sanitizer, the
other half of the JAX package's `repro.analysis`, is the port's
`repro_torch.runtime.sanitizer`.
"""
from repro_torch.analysis.config import LintConfig, load_config
from repro_torch.analysis.rules import Finding

__all__ = ["Finding", "LintConfig", "load_config"]
