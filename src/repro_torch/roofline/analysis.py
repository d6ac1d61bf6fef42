"""Model flops and matcher state traffic (port of the parts of
``repro.roofline.analysis`` that read no XLA).

``model_flops`` is the reference's ``6 * N * tokens`` (training) and
``2 * N * tokens`` (inference), with N the active parameters.
``state_traffic_bytes`` turns a matcher run's ``Counters`` into bytes
under a ``StateSpec`` and their time at the card's memory rate
(``h100.HBM_BYTES_PER_S``). The reference's ``analyze`` and
``roofline/hlo_parse.py`` read a compiled XLA executable's HLO and cost
analysis; the port compiles no HLO, and its dry-run
(``launch.dryrun``) reckons the same terms from the specs and the model's
shapes on ``meta`` instead.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.roofline import h100


def state_traffic_bytes(counters, spec=None) -> Dict[str, float]:
    """State-array traffic of a matcher run in bytes under a state spec:
    ``Counters`` count state accesses (loads and stores of ``state[]``),
    each moving the spec's state width; every edge read moves its two
    int32 endpoint ids. Returns ``{"state_bytes", "edge_bytes",
    "total_bytes", "memory_s"}``, ``memory_s`` these bytes at the card's
    memory rate."""
    from repro_torch.core.statespec import resolve

    spec = resolve(spec)
    accesses = int(counters.state_loads) + int(counters.state_stores)
    state_b = float(accesses * spec.vmem_bytes)
    edge_b = float(int(counters.edge_reads) * 8)  # 2 x i32 endpoints
    total = state_b + edge_b
    return {"state_bytes": state_b, "edge_bytes": edge_b,
            "total_bytes": total, "memory_s": total / h100.HBM_BYTES_PER_S}


def model_flops(cfg, shape, n_params_active: int, n_params_total: int
                ) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*tokens for inference."""
    del cfg, n_params_total
    if shape.kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    # decode: one token a sequence
    return 2.0 * n_params_active * shape.global_batch
