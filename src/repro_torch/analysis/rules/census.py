"""Rule: kernel-census — each entry point launches the kernels it should,
as many times as it should (the counterpart of ``pallas-count``: there a
trace had to hold a fixed number of ``pallas_call``s; here the wrappers'
launch counters are read around one run on the card).

``skipper_match`` on the canonical schedule launches exactly one
window-tier and one global-tier kernel; ``skipper`` on the canonical
graph the asynchronous global tier once and nothing else;
``flash_attention``, called in
bf16 and in f32, the bf16 tensor-core kernel once and the three-term TF32
kernel and its pre-pass once each, and the CUDA-core kernel never; the
serving decode step none (the models' attention is the plain chunked
form, as in the JAX package); ``distributed_skipper`` on one rank the
global tier twice a round (its local pass and its replay) and, on the
locality-sharded schedule, the window tier once. A refactor that drops a kernel from
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
