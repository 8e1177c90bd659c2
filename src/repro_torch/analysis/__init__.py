"""Static analysis of the port (counterpart of ``repro.analysis``).

- ``python -m repro_torch.analysis.lint src/repro_torch``: the RPT0xx
  rules, JAX's lint rules that have a PyTorch meaning (cached device
  tensors, static graph buffers read after a replay, host-only plan
  descriptors, blocking calls in async serving code, fault-hook placement,
  dead config fields, import-time device state).  ``# noqa: RPT0xx``
  suppresses a finding on its line; an unused pragma is itself a finding
  (RPT008).
- ``python -m repro_torch.analysis.contracts``: the contract verifier,
  which runs the model's steps on fake tensors (``FakeTensorMode``, no
  allocation, no launch) for every backend on a grid of configs, the
  ``"cuda"`` backend through its kernel wrappers' abstract rules.
"""
from repro_torch.analysis.lint import LintEngine, lint_paths
from repro_torch.analysis.rules import ALL_RULES, Finding, Rule

__all__ = ["ALL_RULES", "Finding", "LintEngine", "Rule", "lint_paths"]
