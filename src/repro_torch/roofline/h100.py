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
#: float32 rate of the CUDA cores (outside the tensor cores), FLOP/s: the
#: "FP32 67 teraFLOPS" of NVIDIA's H100 SXM data sheet
F32_FLOPS_PER_S = 67e12
#: dense TF32 tensor-core rate, FLOP/s: the data sheet's "TF32 Tensor Core
#: 989 teraFLOPS" is with sparsity, half of it dense
TF32_FLOPS_PER_S = 494.7e12
#: TF32 products the three-term split issues for each product of the
#: function (a_hi b_hi + a_hi b_lo + a_lo b_hi)
TF32_TERMS = 3
#: the peak rate, the element size and the bound's name of each attention
#: dtype: bf16 on the tensor cores; f32 on the tensor cores in three TF32
#: terms (the least time for f32 at 2e-5 there: one TF32 product cannot
#: hold it)
FLASH_RATES = {"bfloat16": (BF16_FLOPS_PER_S, 2, "operations"),
               "float32": (TF32_FLOPS_PER_S / TF32_TERMS, 4,
                           "operations, 3xTF32")}
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


#: device memory of the H100 SXM: the data sheet's 80 GB of HBM3 (80 GiB
#: of DRAM). ``hbm_bytes()`` reads what the card itself reports where
#: there is one; this constant stands for it on the CPU
HBM_CAPACITY_BYTES = 80 * 2**30
#: NVLink 4 inside a node of 8 (an HGX H100 board): 900 GB/s a card over
#: both directions, 450 GB/s each way (NVIDIA's H100 SXM data sheet)
NVLINK_BYTES_PER_S = 450e9
#: cards a node joins by NVLink
NVLINK_DOMAIN = 8
#: InfiniBand between nodes: one ConnectX-7 NDR port of 400 Gb/s a card
#: (DGX H100), 50 GB/s each way
IB_BYTES_PER_S = 50e9


def hbm_bytes() -> int:
    """The card's device memory: ``torch.cuda.get_device_properties``'s
    ``total_memory`` on a card, :data:`HBM_CAPACITY_BYTES` elsewhere."""
    import torch

    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HBM_CAPACITY_BYTES


def link_bytes_per_s(group: int) -> float:
    """Each-way rate of a ring collective over ``group`` consecutive
    cards: NVLink when the group fits in one node, else the InfiniBand
    port that every hop out of a node crosses."""
    return NVLINK_BYTES_PER_S if group <= NVLINK_DOMAIN else IB_BYTES_PER_S


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


def stream_bytes(num_tiles: int, tile_size: int, num_vertices: int,
                 spec) -> int:
    """Bytes the raw-stream matcher (``core/skipper.py``: the global-tier
    kernel over one state row) must move: the u/v ids in (8 bytes an edge
    slot), the state row of ``num_vertices`` cells in and out, matched and
    conflicts out. The all-zero pair blocks the kernel also reads carry
    nothing the function needs and are not counted."""
    slots = num_tiles * tile_size
    return (8 * slots + 2 * num_vertices * spec.vmem_bytes
            + 2 * spec.counter_bytes * slots)


#: bytes of one device-memory sector: the least a read or a write of one
#: state cell moves
SECTOR_BYTES = 32


def slab_bytes(slots: int, sectors: int, num_vertices: int, spec) -> int:
    """Bytes one slab pass of the distributed matcher
    (``engine.stream_pass`` on the card: the global-tier kernel over one
    state row of ``num_vertices`` cells) must move: the u/v ids in (8 bytes
    a slot), matched and conflicts out, and only the state the slab's
    valid endpoints touch: ``sectors`` distinct sectors of
    :data:`SECTOR_BYTES`, counted from the run's data, each read and
    written once, capped at the row."""
    state = min(sectors * SECTOR_BYTES, num_vertices * spec.vmem_bytes)
    return 8 * slots + 2 * state + 2 * spec.counter_bytes * slots


def flash_bound_ms(b, hq, hkv, s, d, dtype: str) -> Tuple[float, str]:
    """The larger of the causal flops (2*B*Hq*S^2*D: both products over half
    the square) at ``dtype``'s rate (``"bfloat16"``: the bf16 tensor cores;
    ``"float32"``: three TF32 products each, ``"operations, 3xTF32"``) and
    the bytes of q, k, v and o at the memory rate."""
    rate, itemsize, name = FLASH_RATES[dtype]
    flops = 2 * b * hq * s * s * d
    nbytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_ops = flops / rate * 1e3
    t_bytes = bytes_ms(nbytes)
    return (t_ops, name) if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_cuda_core_bound_ms(b, hq, s, d) -> float:
    """The f32 causal flops at the CUDA cores' rate: the bound of the
    first f32 kernel, which ran there (kept beside the 3xTF32 bound)."""
    return 2 * b * hq * s * s * d / F32_FLOPS_PER_S * 1e3


def block_registers(registers: int, threads: int) -> int:
    """Registers a block of ``threads`` takes at ``registers`` a thread:
    each warp's allocation rounded up to the allocation unit."""
    warps = -(-threads // 32)
    return (-(-registers * 32 // REGISTER_ALLOC_UNIT) * REGISTER_ALLOC_UNIT
            * warps)


def occupancy(registers: int, threads: int, smem_bytes: int) -> Dict:
    """Blocks and warps one SM can hold for a kernel that uses
    ``registers`` a thread, ``threads`` a block and ``smem_bytes`` of
    shared memory a block, and which limit binds."""
    warps = -(-threads // 32)
    limits = {
        "registers": REGISTERS_PER_SM // max(
            block_registers(registers, threads), 1),
        "warps": MAX_WARPS_PER_SM // warps,
        "blocks": MAX_BLOCKS_PER_SM,
        "shared_memory": SMEM_PER_SM // (smem_bytes
                                         + SMEM_RESERVED_PER_BLOCK),
    }
    blocks = min(limits.values())
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "occupancy": blocks * warps / MAX_WARPS_PER_SM,
            "limited_by": min(limits, key=limits.get)}
