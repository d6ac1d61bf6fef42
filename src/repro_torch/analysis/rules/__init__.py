"""Rule battery of the port's kernel conformance analyzer (port of
``repro.analysis.rules``).

Three rule kinds (``base.py``):

* ``SourceRule``  — AST checks over ``.py`` files (state-dtype, host-sync,
  lru-static-key, deprecated-alias); they run anywhere.
* ``KernelRule``  — checks over one built kernel instance: its ptxas
  report (smem-budget, local-memory, registers), its PTX (smem-barrier),
  and a run of it against its plain version (tier-order).
* ``TargetRule``  — checks over an entry point run on the card
  (kernel-census).

``ALL_RULES`` is the canonical battery; pass ``--rules`` to the CLI to run
a subset. Each rule's findings carry its name, so a mutation canary is
"caught" precisely when the expected rule reports an ERROR.
"""
from repro_torch.analysis.rules.base import (
    ALL_RULES,
    KernelRule,
    Rule,
    SourceRule,
    TargetRule,
    get_rules,
    kernel_rules,
    source_rules,
    target_rules,
)

__all__ = [
    "ALL_RULES",
    "KernelRule",
    "Rule",
    "SourceRule",
    "TargetRule",
    "get_rules",
    "kernel_rules",
    "source_rules",
    "target_rules",
]
