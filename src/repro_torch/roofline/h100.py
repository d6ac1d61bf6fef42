"""NVIDIA H100 SXM constants and the port's kernel cost models.

Rates are NVIDIA's data sheet at the card's full 700 W (dense, without
sparsity); per-SM limits are the Hopper architecture's (compute
capability 9.0). A bound is the least time the card could take for a
kernel's work: the larger of the bytes it must move (each input read once,
each output written once) over the memory rate and its operations over the
peak rate of their type.
"""
from __future__ import annotations

from typing import Dict, Tuple

#: device-memory rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 tensor-core rate, FLOP/s
BF16_FLOPS_PER_S = 989e12
#: 32-bit registers of one SM, and the allocation unit of a warp's
#: registers
REGISTERS_PER_SM = 65_536
REGISTER_ALLOC_UNIT = 256
#: resident warps and blocks of one SM
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
#: shared memory of one SM that blocks may use (228 KB), and the 1 KB the
#: system reserves for each resident block
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024


def bytes_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def window_bytes(s, spec) -> int:
    """Bytes the window-tier kernel must move on schedule ``s``: the u/v
    ids in, each row's state in and out, matched and conflicts out."""
    slots = s.u_tiles.size
    state = s.num_rows * s.window * spec.vmem_bytes
    return 8 * slots + 2 * state + 2 * spec.counter_bytes * slots


def boundary_bytes(s, spec) -> int:
    """Bytes the global-tier kernel must move on schedule ``s``: the pair
    blocks and u/v ids in, the whole state in and out, matched and
    conflicts out."""
    slots = s.num_boundary_padded
    state = s.num_windows * s.window * spec.vmem_bytes
    return (8 * s.num_boundary_tiles + 8 * slots + 2 * state
            + 2 * spec.counter_bytes * slots)


def flash_bound_ms(b, hq, hkv, s, d, itemsize) -> Tuple[float, str]:
    """The larger of the causal flops (2*B*Hq*S^2*D: both products over half
    the square) at the bf16 tensor-core rate and the bytes of q, k, v and o
    at the memory rate."""
    flops = 2 * b * hq * s * s * d
    nbytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = bytes_ms(nbytes)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def occupancy(registers: int, threads: int, smem_bytes: int) -> Dict:
    """Blocks and warps one SM can hold for a kernel that uses
    ``registers`` a thread, ``threads`` a block and ``smem_bytes`` of
    shared memory a block, and which limit binds."""
    warps = -(-threads // 32)
    regs_per_warp = (-(-registers * 32 // REGISTER_ALLOC_UNIT)
                     * REGISTER_ALLOC_UNIT)
    limits = {
        "registers": REGISTERS_PER_SM // max(regs_per_warp * warps, 1),
        "warps": MAX_WARPS_PER_SM // warps,
        "blocks": MAX_BLOCKS_PER_SM,
        "shared_memory": SMEM_PER_SM // (smem_bytes
                                         + SMEM_RESERVED_PER_BLOCK),
    }
    blocks = min(limits.values())
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "occupancy": blocks * warps / MAX_WARPS_PER_SM,
            "limited_by": min(limits, key=limits.get)}
