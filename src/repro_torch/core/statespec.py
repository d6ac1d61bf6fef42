"""StateSpec — the single source of truth for vertex-state width.

Port of ``repro.core.statespec``. One dtype name per tier:

====================  =====================================================
field                 governs
====================  =====================================================
``at_rest``           returned vertex-state arrays (``MatchResult.state``)
``vmem``              kernel-tier working state: the window tier's
                      shared-memory row, the global tier's
                      ``[num_windows, window]`` device state, and the plain
                      versions' state
``wire``              distributed state-assembly payload (the O(V)
                      cross-device combine of the locality-sharded
                      matcher, :meth:`StateSpec.combine_rows`)
``counter``           per-edge matched/conflicts output arrays
``accum``             index math — always ``int32``
``combine``           that combine's policy: ``"max"`` (exact at any
                      width: rows are device-disjoint) or ``"psum"`` (the
                      legacy i32 graph)
====================  =====================================================

``StateSpec.u8()`` is the default (1 B/vertex in every tier);
``StateSpec.legacy_i32()`` is the all-int32 twin. Matchings are
bit-identical across the two. The spec holds dtype *names*, so it is
hashable and compares equal to the reference's spec field by field.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"uint8": torch.uint8, "int32": torch.int32}
_DTYPE_BYTES = {"uint8": 1, "int32": 4}
_DTYPE_MAX = {"uint8": 255, "int32": 2**31 - 1}
_COMBINES = ("max", "psum")


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Per-tier vertex-state widths (see the module docstring)."""

    at_rest: str = "uint8"
    vmem: str = "uint8"
    wire: str = "uint8"
    counter: str = "uint8"
    accum: str = "int32"
    combine: str = "max"

    def __post_init__(self):
        for field in ("at_rest", "vmem", "wire", "counter", "accum"):
            name = getattr(self, field)
            if name not in _DTYPES:
                raise ValueError(
                    f"StateSpec.{field}={name!r}: must be one of "
                    f"{sorted(_DTYPES)}")
        if self.combine not in _COMBINES:
            raise ValueError(
                f"StateSpec.combine={self.combine!r}: must be one of "
                f"{_COMBINES}")
        if self.accum != "int32":
            raise ValueError("StateSpec.accum must be 'int32'")

    # --- dtypes ----------------------------------------------------------
    @property
    def at_rest_dtype(self) -> torch.dtype:
        return _DTYPES[self.at_rest]

    @property
    def vmem_dtype(self) -> torch.dtype:
        return _DTYPES[self.vmem]

    @property
    def wire_dtype(self) -> torch.dtype:
        return _DTYPES[self.wire]

    @property
    def counter_dtype(self) -> torch.dtype:
        return _DTYPES[self.counter]

    @property
    def accum_dtype(self) -> torch.dtype:
        return _DTYPES[self.accum]

    # --- widths ----------------------------------------------------------
    @property
    def at_rest_bytes(self) -> int:
        return _DTYPE_BYTES[self.at_rest]

    @property
    def vmem_bytes(self) -> int:
        return _DTYPE_BYTES[self.vmem]

    @property
    def wire_bytes(self) -> int:
        return _DTYPE_BYTES[self.wire]

    @property
    def counter_bytes(self) -> int:
        return _DTYPE_BYTES[self.counter]

    # --- guards ----------------------------------------------------------
    def validate_rounds(self, vector_rounds: int) -> None:
        """Raise if the narrowed conflict counter cannot hold the bound:
        a conflict counter increments at most once per first-claim round,
        so ``conflicts <= vector_rounds``."""
        if vector_rounds > _DTYPE_MAX[self.counter]:
            raise ValueError(
                f"vector_rounds={vector_rounds} overflows the "
                f"{self.counter} conflict counter (max "
                f"{_DTYPE_MAX[self.counter]}); use a wider "
                f"StateSpec.counter")

    def validate_capacity(self, cap: int) -> bool:
        """True iff a used-count bounded by ``cap`` fits ``at_rest``."""
        return cap <= _DTYPE_MAX[self.at_rest]

    # --- distributed combine --------------------------------------------
    def combine_rows(self, rows: torch.Tensor, group=None) -> torch.Tensor:
        """Width-honest cross-device combine of the O(V) state assembly,
        in place on ``rows`` (``spec.wire`` width), which it returns.

        Each (row, slot) cell is written by exactly one device (the row
        owner) and is zero (ACC) everywhere else, so ``all_reduce(MAX)``
        over the disjoint contributions is exact at any width and is not
        widened: a u8 wire stays u8. Under ``combine == "psum"`` (the
        legacy i32 spec) it is ``all_reduce(SUM)``, equally exact on
        disjoint rows where ``D * max_state`` cannot wrap. ``group=None``
        with no initialised process group is one device: the identity."""
        import torch.distributed as dist

        if group is None and not (dist.is_available()
                                  and dist.is_initialized()):
            return rows
        op = (dist.ReduceOp.SUM if self.combine == "psum"
              else dist.ReduceOp.MAX)
        dist.all_reduce(rows, op=op, group=group)
        return rows

    # --- blessed specs ---------------------------------------------------
    @classmethod
    def u8(cls) -> "StateSpec":
        """Single-byte state in every tier (the default)."""
        return cls()

    @classmethod
    def legacy_i32(cls) -> "StateSpec":
        """All-int32 kernel state and counters; at-rest state stays uint8."""
        return cls(at_rest="uint8", vmem="int32", wire="int32",
                   counter="int32", combine="psum")


DEFAULT = StateSpec()


def resolve(spec: "StateSpec | None") -> StateSpec:
    """Normalize an optional spec argument (None -> DEFAULT)."""
    return DEFAULT if spec is None else spec
