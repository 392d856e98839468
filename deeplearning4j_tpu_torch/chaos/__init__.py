"""Deterministic fault injection (see ``chaos/plan.py``).

This package is import-light by design: ``chaos.hook.chaos_site`` is
the only symbol hot paths may touch (graftlint's ``chaos-hygiene``
rule enforces it), and everything else — FaultPlan, parse_plan,
arm/disarm — is re-exported lazily so ``import deeplearning4j_tpu_torch.
chaos`` in a disarmed process never loads the plan machinery.
"""

from deeplearning4j_tpu_torch.chaos.hook import chaos_site  # noqa: F401

_LAZY = ("FaultPlan", "FaultSpec", "Injection", "ChaosError",
         "parse_plan", "arm", "disarm", "active_plan", "site",
         "KILL_EXIT_CODE")

__all__ = ("chaos_site",) + _LAZY


def __getattr__(name):
    if name in _LAZY:
        from deeplearning4j_tpu_torch.chaos import plan as _plan
        return getattr(_plan, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
