"""Rules: smem-budget, local-memory, registers — what ptxas reports for
each kernel instance, held to the card's limits (``smem-budget`` is the
counterpart of ``rules/vmem_budget.py``; ``local-memory`` guards what
``rules/mosaic_lowering.py`` guarded on the TPU: data-dependent indexing
the hardware cannot keep in its fast storage).

* ``smem-budget`` — a block's shared memory is ptxas's static ``smem``
  plus the dynamic bytes its launch wrapper requests at the canonical
  launch. ERROR above ``_build.MAX_SMEM_BYTES`` (232,448 B), and ERROR
  when the amount changes as the target is rescaled to 2x the vertices at
  the same window and tile (the claim that it is independent of V). INFO:
  the bytes and, for the window tier, the largest window each state width
  allows at this tile.
* ``local-memory`` — a stack frame, spill stores or spill loads in an
  entry function put per-thread data in local memory (device memory
  behind L1): an ERROR. A register array indexed at run time is the usual
  cause.
* ``registers`` — the counterpart of the reference's ``vmem-budget``
  ERROR for the register file. ERROR when ptxas's registers a thread (the
  launch-time count, allocated in units of 256 a warp), times the largest
  block the kernel's wrapper admits (``KernelTarget.max_threads``), exceed
  the SM's 65,536: such a launch is refused. For a kernel that moves
  registers between its warpgroups with ``setmaxnreg`` (the target's
  ``setmaxnreg``: each value and the warpgroups that set it), ERROR when
  the values in its PTX are not the target's, when its warpgroups are not
  the block's, and when the values times their threads sum above 65,536
  or above what the launch holds (``setmaxnreg.inc`` only takes what the
  block's other warpgroups gave back). Otherwise INFO: registers a thread
  and the occupancy they, the block size and the shared memory allow
  (``roofline/h100.occupancy``).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import KernelRule
from repro_torch.core.statespec import StateSpec
from repro_torch.roofline import h100

#: the full-scale configuration's window (chip_smoke.py phase 4)
FULL_SCALE_WINDOW = 65_536


def block_smem(artifact, scale: int = 1) -> int:
    return artifact.facts.smem_static + artifact.target.dynamic_smem(scale)


def largest_window(spec: StateSpec, tile: int, static: int,
                   ring: bool = False) -> int:
    """The largest window whose window-tier block fits: the state row
    (``window * vmem_bytes`` padded to 4) plus ``9 * tile``; with ``ring``
    (the asynchronous window tier), the row padded to 16 plus one ring
    stage."""
    from repro_torch.kernels._build import MAX_SMEM_BYTES
    from repro_torch.kernels.skipper_match import kernel

    if ring:
        room = (MAX_SMEM_BYTES - static
                - kernel.window_stage_bytes(tile)) // 16 * 16
    else:
        room = (MAX_SMEM_BYTES - static - 9 * tile) // 4 * 4
    return max(room, 0) // spec.vmem_bytes


class SmemBudget(KernelRule):
    name = "smem-budget"

    def check_kernel(self, artifact) -> List[Finding]:
        from repro_torch.kernels._build import MAX_SMEM_BYTES
        from repro_torch.kernels.skipper_match import kernel

        t = artifact.target
        used = block_smem(artifact)
        out: List[Finding] = []
        if used > MAX_SMEM_BYTES:
            out.append(self.finding(
                Severity.ERROR, t.name,
                f"{used} B of shared memory a block (static "
                f"{artifact.facts.smem_static} + dynamic "
                f"{t.dynamic_smem(1)}) exceeds the {MAX_SMEM_BYTES} B a "
                f"block may use", data={"bytes": used}))
        twice = block_smem(artifact, 2)
        if twice != used:
            out.append(self.finding(
                Severity.ERROR, t.name,
                f"shared memory depends on V: {used} B at the canonical "
                f"graph, {twice} B at twice its vertices (same window and "
                f"tile); claim: {t.smem_claim}",
                data={"bytes": used, "bytes_2x": twice}))
        data = {"bytes": used, "static": artifact.facts.smem_static,
                "limit": MAX_SMEM_BYTES}
        msg = f"{used} B a block ({t.smem_claim})"
        if t.role == "window":
            ring = t.kernel == kernel.WINDOW_ASYNC
            data["largest_window"] = {}
            data["bytes_at_full_scale_window"] = {}
            for name in ("uint8", "int32"):
                spec = StateSpec(vmem=name)
                data["largest_window"][name] = largest_window(
                    spec, t.threads, artifact.facts.smem_static, ring)
                dynamic = (kernel.window_async_smem_bytes if ring else
                           kernel.window_tier_smem_bytes)(
                               FULL_SCALE_WINDOW, t.threads, spec)
                data["bytes_at_full_scale_window"][name] = (
                    artifact.facts.smem_static + dynamic)
            msg += (f"; at tile {t.threads} the largest window is "
                    f"{data['largest_window']['uint8']} (uint8 state), "
                    f"{data['largest_window']['int32']} (int32); window "
                    f"{FULL_SCALE_WINDOW} needs "
                    f"{data['bytes_at_full_scale_window']['uint8']} B "
                    f"(uint8), {data['bytes_at_full_scale_window']['int32']}"
                    f" B (int32)")
            if ring:
                data["ring_stages_at_full_scale_window"] = {
                    name: kernel.window_ring_stages(
                        FULL_SCALE_WINDOW, t.threads, StateSpec(vmem=name))
                    for name in ("uint8", "int32")}
                msg += (f"; its ring takes "
                        f"{data['ring_stages_at_full_scale_window']} stages "
                        "there (0: the first window tier runs instead)")
        out.append(self.finding(Severity.INFO, t.name, msg, data=data))
        return out


class LocalMemory(KernelRule):
    name = "local-memory"

    def check_kernel(self, artifact) -> List[Finding]:
        f = artifact.facts
        data = {"stack_frame": f.stack_frame, "spill_stores": f.spill_stores,
                "spill_loads": f.spill_loads,
                "ptx_local_bytes": artifact.ptx.local_bytes}
        if f.stack_frame or f.spill_stores or f.spill_loads:
            return [self.finding(
                Severity.ERROR, artifact.name,
                f"{f.stack_frame} bytes stack frame, {f.spill_stores} bytes "
                f"spill stores, {f.spill_loads} bytes spill loads (PTX "
                f"declares {artifact.ptx.local_bytes} B of local memory): "
                f"per-thread data lives in local memory — a register array "
                f"indexed at run time, or too many live values",
                data=data)]
        return [self.finding(Severity.INFO, artifact.name,
                             "no stack frame, no spills", data=data)]


def setmaxnreg_values(entry) -> List[int]:
    """The register counts an entry's ``setmaxnreg`` instructions set,
    in PTX order, without repeats."""
    out: List[int] = []
    for b in entry.blocks:
        for ins in b.instrs:
            if ins.op.startswith("setmaxnreg") and ins.args:
                n = int(ins.args[0])
                if n not in out:
                    out.append(n)
    return out


class Registers(KernelRule):
    name = "registers"

    def check_kernel(self, artifact) -> List[Finding]:
        f, t = artifact.facts, artifact.target
        most = t.max_threads or t.threads
        held = h100.block_registers(f.registers, most)
        data = {"registers": f.registers, "barriers": f.barriers,
                "threads": t.threads, "max_threads": most,
                "block_registers": held, "limit": h100.REGISTERS_PER_SM}
        out: List[Finding] = []
        if held > h100.REGISTERS_PER_SM:
            out.append(self.finding(
                Severity.ERROR, t.name,
                f"{f.registers} registers a thread at the {most} threads "
                f"a block its wrapper admits take {held} registers, above "
                f"the SM's {h100.REGISTERS_PER_SM}: that launch is refused",
                data=data))
        found = setmaxnreg_values(artifact.ptx)
        stated = dict(t.setmaxnreg)
        if found or stated:
            shares = sum(r * 128 * n for r, n in stated.items())
            data.update(setmaxnreg=stated, setmaxnreg_in_ptx=found,
                        setmaxnreg_registers=shares)
            if sorted(found) != sorted(stated):
                out.append(self.finding(
                    Severity.ERROR, t.name,
                    f"setmaxnreg sets {found} in the PTX; the target "
                    f"states {sorted(stated)}", data=data))
            elif 128 * sum(stated.values()) != most:
                out.append(self.finding(
                    Severity.ERROR, t.name,
                    f"the setmaxnreg warpgroups {stated} are not the "
                    f"block's {most // 128}", data=data))
            elif shares > min(h100.REGISTERS_PER_SM, held):
                out.append(self.finding(
                    Severity.ERROR, t.name,
                    f"setmaxnreg shares {stated} take {shares} registers, "
                    f"above the SM's {h100.REGISTERS_PER_SM} or the "
                    f"{held} the launch holds", data=data))
        occ = h100.occupancy(f.registers, t.threads, block_smem(artifact))
        data.update(occ)
        out.append(self.finding(
            Severity.INFO, artifact.name,
            f"{f.registers} registers a thread, {f.barriers} barrier(s); "
            f"{held} of {h100.REGISTERS_PER_SM} at the largest block "
            f"({most} threads); at {t.threads} threads a block an SM holds "
            f"{occ['blocks_per_sm']} block(s), occupancy "
            f"{occ['occupancy']:.2f} (limited by {occ['limited_by']})",
            data=data))
        return out
