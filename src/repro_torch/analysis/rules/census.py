"""Rule: kernel-census — each entry point launches the kernels it should,
as many times as it should (the counterpart of ``pallas-count``: there a
trace had to hold a fixed number of ``pallas_call``s; here the wrappers'
launch counters are read around one run on the card).

``skipper_match`` on the canonical schedule launches exactly one
window-tier and one global-tier kernel; ``flash_attention`` one flash
kernel; the serving decode step none (the models' attention is the plain
chunked form, as in the JAX package). A refactor that drops a kernel from
its path, or adds launches, fails here rather than passing unseen.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import TargetRule


class KernelCensus(TargetRule):
    name = "kernel-census"

    def check_target(self, target) -> List[Finding]:
        counts = target.run(torch.device("cuda"))
        bad = {k: (counts.get(k, 0), n) for k, n in target.expect.items()
               if counts.get(k, 0) != n}
        if bad:
            return [self.finding(
                Severity.ERROR, target.name,
                "launches differ from the expected: " + ", ".join(
                    f"{k} {got} (expected {n})"
                    for k, (got, n) in sorted(bad.items())),
                data={"launches": counts, "expected": target.expect})]
        return [self.finding(
            Severity.INFO, target.name,
            "launches " + ", ".join(f"{k} {counts.get(k, 0)}"
                                   for k in sorted(target.expect)),
            data={"launches": counts})]
