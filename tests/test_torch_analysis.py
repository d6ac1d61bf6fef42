"""The port's kernel conformance analyzer (``src/repro_torch/analysis/``)
held against the JAX package's (``src/repro/analysis/``) where the
reference runs on the CPU, and its CUDA-side parsers and rules on text:

1. **Source rules agree.** The port's ``state-dtype``, ``host-sync`` and
   ``lru-static-key`` on torch fixtures, and the reference's on jnp
   fixtures written line for line alike, flag the same
   ``(rule, severity, lineno)`` set; both ``hardcoded_state_dtype``
   canaries are caught at the same line; the mutation registries and the
   report's JSON keys are the reference's.
2. **Build artifacts parse.** The ``-Xptxas=-v`` parser and the demangler
   read text in the form nvcc prints (taken from a build of the port's
   sources); the PTX happens-before analysis flags RAW and WAR pairs
   without a barrier, through loop back-edges, and accepts ``bar.sync``
   and ``bar.red``; it flags a generic store read by the async proxy (a
   bulk store, a ``wgmma``) with no ``fence.proxy.async`` between; it tells
   apart regions carved from one aligned dynamic buffer at run-time
   offsets; and ``registers`` is an ERROR over the register file.
3. **Canaries stay faithful.** Each CUDA mutant's body differs from its
   production kernel's only in its ``// MUTATION:`` line group, and the
   ``tier-order`` fixture has teeth (its two tile orders give different
   matchings).
4. **The tree is clean** under the port's source rules, through the CLI.

Kernel rules need nvcc and a card: ``tests/test_torch_cuda.py`` runs
them (marked ``cuda``).
"""
import difflib
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import analyze_mutation as ref_analyze_mutation
from repro.analysis.mutations import MUTATION_NAMES as REF_MUTATION_NAMES
from repro.analysis.report import Finding as RefFinding
from repro.analysis.report import Report as RefReport
from repro.analysis.report import Severity as RefSeverity
from repro.analysis.rules.base import SourceFile as RefSourceFile
from repro.analysis.rules.host_sync import HostSync as RefHostSync
from repro.analysis.rules.host_sync import LruStaticKey as RefLruStaticKey
from repro.analysis.rules.state_dtype import StateDtype as RefStateDtype
from repro_torch.analysis import Finding, Report, Severity, analyze_mutation
from repro_torch.analysis import mutations
from repro_torch.analysis.build import (
    PtxasFacts,
    demangle,
    find_entry,
    parse_ptx,
    parse_ptxas_report,
)
from repro_torch.analysis.rules.barrier import SmemBarrier, hazards
from repro_torch.analysis.rules.base import SourceFile
from repro_torch.analysis.rules.host_sync import HostSync, LruStaticKey
from repro_torch.analysis.rules.order import fixture, run_plain
from repro_torch.analysis.rules.resources import Registers, largest_window
from repro_torch.analysis.rules.state_dtype import StateDtype
from repro_torch.analysis.runner import caught
from repro_torch.core.statespec import StateSpec
from repro_torch.kernels import _build
from repro_torch.kernels.skipper_match import kernel
from repro_torch.roofline import h100

ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------------------------ 1 -----

TORCH_FIXTURE = '''\
import functools
import numpy as np
import torch


def alloc(n, x, used):
    state = torch.zeros((n,), dtype=torch.int32)
    idx = torch.zeros((n,), dtype=torch.int32)
    flat = torch.full((n,), 0, dtype=torch.uint8)
    used_u = used.to(torch.uint8)
    rebuilt = np.zeros(n, np.uint8)  # state-dtype: ok
    states = np.full((n,), 0, np.int32)
    value = x.item()
    same = x.item()  # host-sync: ok
    host = x.cpu()
    return state, idx, flat, used_u, rebuilt, states, value, same, host


@functools.lru_cache(maxsize=None)
def builder(state, n=[]):
    return n


@functools.lru_cache(maxsize=None)
def fine(window: int, tile: int):
    return window * tile
'''

JAX_FIXTURE = '''\
import functools
import numpy as np
import jax.numpy as jnp


def alloc(n, x, used):
    state = jnp.zeros((n,), dtype=jnp.int32)
    idx = jnp.zeros((n,), dtype=jnp.int32)
    flat = jnp.full((n,), 0, dtype=jnp.uint8)
    used_u = used.astype(jnp.uint8)
    rebuilt = np.zeros(n, np.uint8)  # state-dtype: ok
    states = np.full((n,), 0, np.int32)
    value = x.item()
    same = x.item()  # host-sync: ok
    host = jax.device_get(x)
    return state, idx, flat, used_u, rebuilt, states, value, same, host


@functools.lru_cache(maxsize=None)
def builder(state, n=[]):
    return n


@functools.lru_cache(maxsize=None)
def fine(window: int, tile: int):
    return window * tile
'''


def _hits(findings):
    return {(f.rule, f.severity.value, f.lineno) for f in findings}


def test_fixtures_are_written_line_for_line_alike():
    t, j = TORCH_FIXTURE.splitlines(), JAX_FIXTURE.splitlines()
    assert len(t) == len(j)
    differ = [n for n, (a, b) in enumerate(zip(t, j), 1) if a != b]
    assert differ == [3, 7, 8, 9, 10, 15]


def test_source_rules_agree_with_reference():
    port_src = SourceFile.parse("src/repro_torch/fixture.py", TORCH_FIXTURE)
    ref_src = RefSourceFile.parse("src/repro/fixture.py", JAX_FIXTURE)
    port = [f for r in (StateDtype(), HostSync(), LruStaticKey())
            for f in r.check_file(port_src)]
    ref = [f for r in (RefStateDtype(), RefHostSync(), RefLruStaticKey())
           for f in r.check_file(ref_src)]
    assert _hits(port) == _hits(ref)
    assert _hits(port) == {
        ("state-dtype", "error", 7), ("state-dtype", "error", 9),
        ("state-dtype", "error", 10), ("state-dtype", "error", 12),
        ("host-sync", "error", 13), ("host-sync", "error", 15),
        ("lru-static-key", "error", 20), ("lru-static-key", "warning", 20),
    }


DEPRECATED_FIXTURE = (
    "def report(stats):\n"
    "    total = stats.gathered_bytes\n"
    "    words = stats.gathered_ints\n"
    "    same = stats.gathered_ints  # deprecated-alias: ok\n"
    "    return total, words, same\n")


@pytest.mark.parametrize("path,lines", [
    ("src/repro_torch/bench.py", {3}),
    ("examples/quickstart_torch.py", {3}),
    ("src/repro_torch/core/distributed.py", set()),   # the definition site
    ("tests/test_torch_distributed.py", set()),       # the pinning tests
])
def test_deprecated_alias_catches_its_fixture(path, lines):
    """``deprecated-alias`` flags an internal read of
    ``DistStats.gathered_ints`` (not ``gathered_bytes``, not a waived
    line), exempts the definition site and the tests, and agrees with the
    reference's rule on the same text."""
    from repro.analysis.rules.deprecated_alias import (
        DeprecatedAlias as RefDeprecatedAlias)
    from repro_torch.analysis.rules.deprecated_alias import DeprecatedAlias

    hits = DeprecatedAlias().check_file(
        SourceFile.parse(path, DEPRECATED_FIXTURE))
    assert {f.lineno for f in hits} == lines
    assert all(f.severity is Severity.ERROR and f.rule == "deprecated-alias"
               for f in hits)
    ref_path = path.replace("repro_torch", "repro")
    ref = RefDeprecatedAlias().check_file(
        RefSourceFile.parse(ref_path, DEPRECATED_FIXTURE))
    assert {f.lineno for f in ref} == lines
    # the port's tree is clean under the rule
    for py in (ROOT / "src" / "repro_torch").rglob("*.py"):
        rel = str(py.relative_to(ROOT))
        assert DeprecatedAlias().check_file(
            SourceFile.parse(rel, py.read_text())) == [], rel


def test_host_sync_scope_and_torch_expressions():
    """Outside src/repro_torch, or in a file that does not import torch,
    nothing is a host sync; inside, bool/int/float of a torch expression
    is, and of a host value is not."""
    text = (
        "import numpy as np\nimport torch\n\n\n"
        "def f(x: torch.Tensor, n: int, fallback: bool):\n"
        "    a, b = g(x)\n"
        "    c = np.zeros(3)\n"
        "    torch.cuda.synchronize()\n"
        "    return (bool(x.any()), int(b), int(n), int(fallback),\n"
        "            float(c.sum()), int(x.shape[0]), bool(a[0] > 1),\n"
        "            int(torch.cuda.device_count()))\n\n\n"
        "class C:\n"
        "    f = staticmethod(lambda x: x.item())\n")
    lines = {f.lineno for f in HostSync().check_file(
        SourceFile.parse("src/repro_torch/m.py", text))}
    assert lines == {8, 9, 10, 15}
    assert HostSync().check_file(SourceFile.parse("tests/m.py", text)) == []
    numpy_only = text.replace("import torch\n", "\n")
    assert HostSync().check_file(
        SourceFile.parse("src/repro_torch/m.py", numpy_only)) == []


def test_host_sync_finds_the_routers_per_round_syncs():
    """With its waivers stripped, the rule finds the capacitated fallback
    loop's per-round syncs (``bool(free_mask(...).any())``) and the
    b-matching's per-tile flag; in the tree each carries a waiver."""
    for rel, marker in (("core/engine.py", "free_mask(a, b, matched).any()"),
                        ("core/bipartite.py", "taken.append(bool(fb))")):
        path = ROOT / "src" / "repro_torch" / rel
        text = path.read_text()
        want = {n for n, line in enumerate(text.splitlines(), 1)
                if marker in line}
        assert want and all("# host-sync: ok" in text.splitlines()[n - 1]
                            for n in want)
        stripped = text.replace("# host-sync: ok", "#")
        got = {f.lineno for f in HostSync().check_file(
            SourceFile.parse(f"src/repro_torch/{rel}", stripped))}
        assert want <= got


def test_hardcoded_state_dtype_caught_at_the_same_line():
    port = analyze_mutation("hardcoded_state_dtype")
    ref = ref_analyze_mutation("hardcoded_state_dtype")
    assert {(f.rule, f.lineno) for f in port.errors} == \
        {(f.rule, f.lineno) for f in ref.errors} == {("state-dtype", 6)}
    assert caught("hardcoded_state_dtype", port)


def test_mutation_names_equal_reference():
    assert mutations.MUTATION_NAMES == REF_MUTATION_NAMES
    assert set(mutations.EXPECTED_RULE) == set(REF_MUTATION_NAMES)


def test_report_json_keys_equal_reference():
    def pair(finding_cls, report_cls, sev):
        f = finding_cls(rule="r", severity=sev, where="w", message="m",
                        lineno=3, data={"k": 1})
        rep = report_cls(findings=[f], targets_analyzed=["t"],
                         files_analyzed=1, rules_run=["r"])
        return f.to_dict(), rep.to_dict()

    pf, pr = pair(Finding, Report, Severity.ERROR)
    rf, rr = pair(RefFinding, RefReport, RefSeverity.ERROR)
    assert pf == rf
    assert set(pr) == set(rr) and pr["summary"] == rr["summary"]
    assert [s.value for s in Severity] == [s.value for s in RefSeverity]
    assert not Report(findings=[Finding("r", Severity.ERROR, "w", "m")]).clean


# ------------------------------------------------------------------ 2 -----

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d23skipper_boundary_kernelIiiEEvPKiS2_S2_S2_PT_PT0_S6_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d23skipper_boundary_kernelIiiEEvPKiS2_S2_S2_PT_PT0_S6_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers
ptxas info    : Compile time = 18.032 ms
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d26skipper_window_tier_kernelIhhEEvPKiS2_PKT_PS3_PT0_S8_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d26skipper_window_tier_kernelIhhEEvPKiS2_PKT_PS3_PT0_S8_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 27 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__86a856d4_18_flash_attention_cu_78bf9a6722flash_attention_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_iiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__86a856d4_18_flash_attention_cu_78bf9a6722flash_attention_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_iiiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__e764764c_10_mutants_cu_c7a7836d28mutant_dynamic_gather_kernelIhhEEvPKiS2_S2_S2_PT_PT0_S6_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__e764764c_10_mutants_cu_c7a7836d28mutant_dynamic_gather_kernelIhhEEvPKiS2_S2_S2_PT_PT0_S6_iiii
    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 39 registers, used 1 barriers, 256 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6staticPf' for 'sm_90a'
ptxas info    : Function properties for _Z6staticPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 32 registers, used 2 barriers, 1024 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_parses():
    rep = parse_ptxas_report(PTXAS_LOG)
    assert len(rep) == 5
    names = {demangle(k): v for k, v in rep.items()}
    b = names[demangle(next(iter(rep)))]
    assert (b.registers, b.barriers, b.smem_static, b.stack_frame,
            b.spill_stores, b.spill_loads) == (28, 1, 0, 0, 0, 0)
    flash = find_entry(rep, "flash_attention_kernel", ("__nv_bfloat16", "128"))
    assert rep[flash].registers == 127 and rep[flash].stack_frame == 0
    gather = find_entry(rep, "mutant_dynamic_gather_kernel",
                        ("unsigned char", "unsigned char"))
    assert rep[gather].stack_frame == 256 and rep[gather].registers == 39
    s = rep["_Z6staticPf"]
    assert (s.registers, s.barriers, s.smem_static, s.stack_frame,
            s.spill_stores, s.spill_loads) == (32, 2, 1024, 8, 4, 12)


@pytest.mark.parametrize("mangled,name,template", [
    ("_ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d23skipper_"
     "boundary_kernelIiiEEvPKiS2_S2_S2_PT_PT0_S6_iiii",
     "skipper_boundary_kernel", ("int", "int")),
    ("_ZN49_GLOBAL__N__04ce0cde_16_skipper_match_cu_c7a7836d26skipper_"
     "window_tier_kernelIhiEEvPKiS2_PKT_PS3_PT0_S8_iiii",
     "skipper_window_tier_kernel", ("unsigned char", "int")),
    ("_ZN51_GLOBAL__N__86a856d4_18_flash_attention_cu_78bf9a6722flash_"
     "attention_kernelIfLi64EEEvPKT_S3_S3_PS1_iiiiifii",
     "flash_attention_kernel", ("float", "64")),
    ("_Z6staticPf", "static", ()),
    ("_Z3fooILin3EEvv", "foo", ("-3",)),
])
def test_demangle(mangled, name, template):
    d = demangle(mangled)
    assert (d.name, d.template) == (name, template)


def _ptx(body: str, shared: str = ".extern .shared .align 16 .b8 smem[];"):
    return (f".version 8.8\n.target sm_90a\n{shared}\n\n"
            f".visible .entry k(\n\t.param .u32 k_param_0\n)\n{{\n"
            f"\t.reg .b32 %r<32>;\n{body}}}\n")


STORE = ("\tmov.u32 %r1, %tid.x;\n\tmov.u32 %r2, smem;\n"
         "\tshl.b32 %r3, %r1, 2;\n\tadd.s32 %r4, %r2, %r3;\n"
         "\tst.shared.u32 [%r4], %r1;\n")
LOAD = "\tld.shared.u32 %r5, [%r2+4];\n"


@pytest.mark.parametrize("between,kinds", [
    ("", {("RAW", False)}),
    ("\tbar.sync 0;\n", set()),
    ("\tbarrier.sync.aligned 0;\n", set()),
    ("\tbar.red.or.pred %p1, 0, %p2;\n", set()),
    ("\tbar.warp.sync -1;\n", {("RAW", True)}),
    ("\t@%p1 bar.sync 0;\n", {("RAW", False)}),
    ("\tbar.arrive 0, 64;\n", {("RAW", False)}),
])
def test_raw_needs_a_cta_barrier(between, kinds):
    entry = parse_ptx(_ptx(STORE + between + LOAD + "\tret;\n"))["k"]
    assert {(k, w) for _, _, k, w in hazards(entry)} == kinds


@pytest.mark.parametrize("mid,end,kinds", [
    ("", "", {"RAW", "WAR"}),
    ("", "\tbar.sync 0;\n", {"WAR"}),
    ("\tbar.sync 0;\n", "", {"RAW"}),
    ("\tbar.sync 0;\n", "\tbar.sync 0;\n", set()),
])
def test_war_and_the_loop_back_edge(mid, end, kinds):
    """A load at the top of a loop and a store below it: the store meets
    the next iteration's load through the back-edge (RAW) unless a barrier
    follows it, and the load meets the store (WAR) unless a barrier lies
    between them."""
    loop = ("\tmov.u32 %r2, smem;\n$L__BB0_1:\n" + LOAD + mid
            + "\tst.shared.u32 [%r2+4], %r5;\n" + end
            + "\tsetp.lt.s32 %p1, %r5, 9;\n\t@%p1 bra $L__BB0_1;\n\tret;\n")
    entry = parse_ptx(_ptx(loop))["k"]
    assert {k for _, _, k, _ in hazards(entry)} == kinds


def test_regions_and_generic_shared_addresses():
    """Arrays at a parameter-sized offset are another region; a generic
    access through ``cvta.shared`` is a shared access; a global one is
    not."""
    other = ("\tld.param.u32 %r6, [k_param_0];\n\tadd.s32 %r7, %r2, %r6;\n"
             "\tld.shared.u32 %r8, [%r7];\n")
    entry = parse_ptx(_ptx(STORE + other + "\tret;\n"))["k"]
    assert hazards(entry) == []
    generic = ("\tcvt.u64.u32 %rd1, %r2;\n\tcvta.shared.u64 %rd2, %rd1;\n"
               "\tld.u32 %r9, [%rd2];\n\tld.global.u32 %r10, [%rd2];\n")
    entry = parse_ptx(_ptx(STORE + generic + "\tret;\n").replace(
        ".reg .b32 %r<32>;", ".reg .b32 %r<32>;\n\t.reg .b64 %rd<4>;"))["k"]
    kinds = {(entry.accesses()[ln].instr.op, k)
             for _, ln, k, _ in hazards(entry)}
    assert kinds == {("ld.u32", "RAW")}


def _artifact(entry, kernel_name):
    return types.SimpleNamespace(
        ptx=entry, mangled=f"_Z{len(kernel_name)}{kernel_name}v",
        name=f"{kernel_name}[test]")


def test_warp_barrier_is_accepted_only_by_name():
    entry = parse_ptx(_ptx(STORE + "\tbar.warp.sync -1;\n" + LOAD
                           + "\tret;\n"))["k"]
    errors = [f for f in SmemBarrier().check_kernel(
        _artifact(entry, "skipper_boundary_kernel"))
        if f.severity is Severity.ERROR]
    assert len(errors) == 1 and "__syncwarp" in errors[0].message
    assert not [f for f in SmemBarrier().check_kernel(
        _artifact(entry, "flash_attention_kernel"))
        if f.severity is Severity.ERROR]


ATOMICS = ("\tmov.u32 %r1, %tid.x;\n\tmov.u32 %r2, smem;\n"
           "\tshl.b32 %r3, %r1, 2;\n\tadd.s32 %r4, %r2, %r3;\n"
           "\tatom.shared.min.u32 %r6, [%r4], %r1;\n"
           "\tatom.shared.exch.b32 %r7, [%r4+4], 0;\n")


@pytest.mark.parametrize("body,name,errors", [
    (ATOMICS, "skipper_boundary_async_kernel", 0),
    (ATOMICS, "skipper_boundary_kernel", 1),
    # a plain load before the atomics is checked in every kernel
    ("\tmov.u32 %r2, smem;\n" + LOAD + ATOMICS,
     "skipper_boundary_async_kernel", 1),
    (ATOMICS + LOAD, "skipper_boundary_async_kernel", 1),
])
def test_atomic_pairs_are_accepted_only_by_name(body, name, errors):
    """Two shared atomics with no barrier between them are a RAW pair,
    accepted only in a kernel of ``ATOMIC_ORDERED``; a plain load before or
    after them is an ERROR there too."""
    from repro_torch.analysis.rules.barrier import ATOMIC_ORDERED

    entry = parse_ptx(_ptx(body + "\tret;\n"))["k"]
    assert ("RAW", False) in {(k, w) for _, _, k, w in hazards(entry)}
    found = SmemBarrier().check_kernel(_artifact(entry, name))
    assert len([f for f in found if f.severity is Severity.ERROR]) == errors
    info = [f for f in found if f.severity is Severity.INFO][0]
    assert (info.data["atomic_pairs"] > 0) == (name in ATOMIC_ORDERED)


# Asynchronous copies: a ring stage filled by a bulk copy that completes on
# ``full``; ``empty`` is its release; ``other`` another barrier.
ASYNC_SHARED = (".extern .shared .align 16 .b8 smem[];\n"
                ".shared .align 8 .b8 full[64];\n"
                ".shared .align 8 .b8 empty[64];\n"
                ".shared .align 8 .b8 other[8];")
ASYNC_REGS = "\t.reg .b64 %rd<4>;\n\t.reg .pred %p<4>;\n"
STAGE = ("\tmov.u32 %r2, smem;\n\tmov.u32 %r10, full;\n"
         "\tmov.u32 %r11, empty;\n\tmov.u32 %r12, other;\n"
         "\tld.param.u64 %rd1, [k_param_0];\n")
FILL = ("\tcp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%r2], [%rd1], 256, [%r10];\n")
WAIT_FULL = "\tmbarrier.try_wait.parity.shared::cta.b64 %p1, [%r10], %r3;\n"
WAIT_OTHER = "\tmbarrier.try_wait.parity.shared::cta.b64 %p1, [%r12], %r3;\n"
RELEASE = "\tmbarrier.arrive.shared::cta.b64 _, [%r11];\n"


def _async_entry(body: str):
    text = _ptx(ASYNC_REGS + STAGE + body, shared=ASYNC_SHARED)
    return parse_ptx(text)["k"]


@pytest.mark.parametrize("between,kinds", [
    (WAIT_FULL, set()),                     # the stage's barrier waited
    ("", {"RAW"}),                          # read with no wait
    ("\tbar.sync 0;\n", {"RAW"}),           # a CTA barrier orders no copy
    (WAIT_OTHER, {"RAW"}),                  # a wait on another barrier
    ("\tbar.sync 0;\n" + WAIT_FULL, set()),
])
def test_async_fill_needs_a_wait_on_its_barrier(between, kinds):
    entry = _async_entry(FILL + between + LOAD + "\tret;\n")
    assert {k for _, _, k, _ in hazards(entry)} == kinds
    errors = [f for f in SmemBarrier().check_kernel(
        _artifact(entry, "skipper_boundary_async_kernel"))
        if f.severity is Severity.ERROR]
    assert bool(errors) == bool(kinds)


@pytest.mark.parametrize("release,kinds", [
    ("", {"WAR"}),                          # reused with no release
    (RELEASE, set()),                       # the consumer's arrive
    ("\tbar.sync 0;\n", set()),             # or a CTA barrier
])
def test_stage_reuse_needs_a_release(release, kinds):
    """A ring: wait, read the stage, (release,) refill it, loop. The read
    meets the next refill through the back-edge."""
    loop = ("$L__BB0_1:\n" + WAIT_FULL + LOAD + release + FILL
            + "\tsetp.lt.s32 %p2, %r5, 9;\n\t@%p2 bra $L__BB0_1;\n"
            "\tret;\n")
    entry = _async_entry(FILL + loop)
    assert {k for _, _, k, _ in hazards(entry)} == kinds


@pytest.mark.parametrize("body,kinds", [
    # plain cp.async attached to the stage's barrier, then waited
    ("\tcp.async.ca.shared.global [%r2], [%rd1], 4;\n"
     "\tcp.async.mbarrier.arrive.noinc.shared::cta.b64 [%r10];\n"
     + WAIT_FULL + LOAD, set()),
    # completed by a group wait: other lanes' copies need a CTA barrier
    ("\tcp.async.ca.shared.global [%r2], [%rd1], 4;\n"
     "\tcp.async.commit_group;\n\tcp.async.wait_group 0;\n" + LOAD,
     {"RAW"}),
    ("\tcp.async.ca.shared.global [%r2], [%rd1], 4;\n"
     "\tcp.async.commit_group;\n\tcp.async.wait_group 0;\n"
     "\tbar.sync 0;\n" + LOAD, set()),
    # a bulk store out of the region, then a generic store into it
    ("\tcp.async.bulk.global.shared::cta.bulk_group [%rd1], [%r2], 256;\n"
     "\tst.shared.u32 [%r2+4], %r1;\n", {"WAR"}),
    ("\tcp.async.bulk.global.shared::cta.bulk_group [%rd1], [%r2], 256;\n"
     "\tcp.async.bulk.commit_group;\n\tcp.async.bulk.wait_group 0;\n"
     "\tst.shared.u32 [%r2+4], %r1;\n", set()),
])
def test_cp_async_groups_and_bulk_stores(body, kinds):
    entry = _async_entry(body + "\tret;\n")
    assert {k for _, _, k, _ in hazards(entry)} == kinds


def test_entry_end_is_found_by_brace_depth():
    """Inline asm opens scopes of its own; a closing brace at the start of
    a line inside the body does not end the entry."""
    body = ("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%r10], %r3;\n}\n" + LOAD + "\tret;\n")
    entry = _async_entry(FILL + body)
    assert any(ins.op == "ld.shared.u32" for b in entry.blocks
               for ins in b.instrs)
    assert {k for _, _, k, _ in hazards(entry)} == set()


# The generic-to-async proxy fence: a generic store, then a bulk store out
# of the same region (the async proxy reads it).
BULK_OUT = ("\tcp.async.bulk.global.shared::cta.bulk_group [%rd1], [%r2], "
            "256;\n")
FENCE = "\tfence.proxy.async.shared::cta;\n"


@pytest.mark.parametrize("between,kinds", [
    ("\tbar.sync 0;\n", {"PROXY"}),              # a barrier is no fence
    (FENCE + "\tbar.sync 0;\n", set()),          # fence, then barrier
    ("\tfence.proxy.async.global;\n\tbar.sync 0;\n", {"PROXY"}),
    ("", {"PROXY", "RAW"}),                       # neither
])
def test_generic_store_then_bulk_store_needs_the_proxy_fence(between, kinds):
    entry = _async_entry("\tst.shared.u32 [%r2+4], %r1;\n" + between
                         + BULK_OUT + "\tret;\n")
    assert {k for _, _, k, _ in hazards(entry)} == kinds
    errors = [f for f in SmemBarrier().check_kernel(
        _artifact(entry, "skipper_boundary_async_kernel"))
        if f.severity is Severity.ERROR]
    assert bool(errors) == bool(kinds)
    if "PROXY" in kinds:
        assert any("fence.proxy.async" in f.message for f in errors)


def test_dropped_fence_is_caught_through_the_loop():
    """The staged global tier's shape: each tile writes the row with
    generic stores; a changed row is fenced, then written back by a bulk
    store. Without the fence, the stores of one tile meet the next tile's
    bulk store through the back-edge."""
    def loop(fence):
        return ("$L__BB0_1:\n" + fence + "\tbar.sync 0;\n" + BULK_OUT
                + "\tcp.async.bulk.commit_group;\n"
                "\tcp.async.bulk.wait_group 0;\n"
                "\tst.shared.u32 [%r2+4], %r1;\n\tbar.sync 0;\n"
                "\tsetp.lt.s32 %p2, %r5, 9;\n\t@%p2 bra $L__BB0_1;\n"
                "\tret;\n")
    assert hazards(_async_entry(loop(FENCE))) == []
    assert {k for _, _, k, _ in hazards(_async_entry(loop("")))} == {"PROXY"}


# Regions carved from one dynamic buffer: the base rounded up to 1024 (as
# the flash kernels align their swizzle atoms), plane A at the base, plane B
# and the two mbarriers at run-time offsets (kernel parameters).
CARVED = ("\tmov.u32 %r2, smem;\n\tadd.s32 %r3, %r2, 1023;\n"
          "\tand.b32 %r4, %r3, -1024;\n"
          "\tld.param.u32 %r6, [k_param_0];\n\tadd.s32 %r7, %r4, %r6;\n"
          "\tld.param.u32 %r8, [k_param_0+4];\n\tadd.s32 %r10, %r4, %r8;\n"
          "\tld.param.u32 %r9, [k_param_0+8];\n\tadd.s32 %r11, %r4, %r9;\n"
          "\tld.param.u64 %rd1, [k_param_1];\n")
FILL_A = ("\tcp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%r4], [%rd1], 256, [%r10];\n")
FILL_B = ("\tcp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%r7], [%rd1], 256, [%r11];\n")
WAIT_A = "\tmbarrier.try_wait.parity.shared::cta.b64 %p1, [%r10], %r3;\n"
WAIT_B = "\tmbarrier.try_wait.parity.shared::cta.b64 %p1, [%r11], %r3;\n"
LOAD_A = "\tld.shared.u32 %r20, [%r4+8];\n"
LOAD_B = "\tld.shared.u32 %r21, [%r7+8];\n"


def _carved(body: str):
    text = _ptx(ASYNC_REGS + CARVED + body)
    entry = parse_ptx(text)["k"]
    lines = {name: n for n, ln in enumerate(text.splitlines(), 1)
             for name, ins in (("fill_a", FILL_A), ("fill_b", FILL_B),
                               ("load_a", LOAD_A), ("load_b", LOAD_B))
             if ln.strip() == ins.strip()}
    return entry, lines


@pytest.mark.parametrize("waits,racing", [
    (WAIT_B, "a"),              # plane A read with only B's barrier waited
    (WAIT_A, "b"),
    (WAIT_A + WAIT_B, None),    # both ordered: no ERROR
])
def test_two_regions_carved_from_one_dynamic_buffer(waits, racing):
    """Each plane carved at a run-time offset from the aligned base is a
    region of its own, and so is each mbarrier: a race in one plane is
    caught while the other plane's reads are ordered by their wait, and
    two correctly ordered planes raise no ERROR."""
    entry, ln = _carved(FILL_A + FILL_B + waits + LOAD_A + LOAD_B
                        + "\tret;\n")
    acc = entry.accesses()
    regions = {acc[ln[k]].region for k in ("fill_a", "fill_b")}
    assert None not in regions and len(regions) == 2
    assert acc[ln["fill_a"]].region == acc[ln["load_a"]].region
    want = ([] if racing is None else
            [(ln[f"fill_{racing}"], ln[f"load_{racing}"], "RAW", False)])
    assert hazards(entry) == want
    errors = [f for f in SmemBarrier().check_kernel(
        _artifact(entry, "flash_attention_tf32x3_kernel"))
        if f.severity is Severity.ERROR]
    assert bool(errors) == (racing is not None)


# a row picked at run time: smem + slot * row_bytes, row_bytes a parameter
# (row 1 lies at smem + row_bytes); with a row pitch (row_bytes + 4) the
# product indexes one array and carves nothing
SLOT = ("\tld.global.u32 %r12, [%rd1];\n\tmul.lo.s32 %r13, %r12, %r6;\n"
        "\tadd.s32 %r14, %r2, %r13;\n")
PITCH = ("\tld.global.u32 %r12, [%rd1];\n\tadd.s32 %r15, %r6, 4;\n"
         "\tmul.lo.s32 %r13, %r12, %r15;\n\tadd.s32 %r14, %r2, %r13;\n")
ROW1_OUT = ("\tadd.s32 %r7, %r2, %r6;\n"
            "\tcp.async.bulk.global.shared::cta.bulk_group [%rd1], [%r7], "
            "256;\n")


@pytest.mark.parametrize("index,fence,kinds", [
    (SLOT, "", {"PROXY"}),
    (SLOT, FENCE, set()),
    (PITCH, "", set()),
])
def test_a_row_picked_at_run_time_lies_in_every_carved_row(index, fence,
                                                           kinds):
    """A generic store through ``smem + slot * row_bytes`` may land in row
    1 (``smem + row_bytes``), so row 1's bulk store needs the fence after
    it; a row pitch with a constant added carves no region."""
    body = ("\tmov.u32 %r2, smem;\n\tld.param.u32 %r6, [k_param_0];\n"
            "\tld.param.u64 %rd1, [k_param_1];\n" + index
            + "\tst.shared.u32 [%r14], %r1;\n" + fence + "\tbar.sync 0;\n"
            + ROW1_OUT + "\tret;\n")
    entry = parse_ptx(_ptx(ASYNC_REGS + body))["k"]
    assert {k for _, _, k, _ in hazards(entry)} == kinds


def _wgmma_body(store_plane: str, fence: str) -> str:
    """A store into a plane, then a tf32 wgmma whose A and B descriptors
    point into planes A (``%r7``) and B (``%r9``) of the aligned buffer."""
    desc = ""
    for src, rd in (("%r7", 3), ("%r9", 5)):
        desc += (f"\tand.b32 %r2{rd}, {src}, 262128;\n"
                 f"\tshr.u32 %r3{rd}, %r2{rd}, 4;\n"
                 f"\tcvt.u64.u32 %rd{rd - 1}, %r3{rd};\n"
                 f"\tor.b64 %rd{rd}, %rd{rd - 1}, 4611686293305360384;\n")
    return ("\tmov.u32 %r2, smem;\n\tadd.s32 %r3, %r2, 1023;\n"
            "\tand.b32 %r4, %r3, -1024;\n"
            "\tld.param.u32 %r6, [k_param_0];\n\tadd.s32 %r7, %r4, %r6;\n"
            "\tld.param.u32 %r8, [k_param_0+4];\n"
            "\tadd.s32 %r9, %r4, %r8;\n"
            "\tld.param.u32 %r10, [k_param_0+8];\n"
            "\tadd.s32 %r11, %r4, %r10;\n"
            f"\tst.shared.f32 [{store_plane}], %f1;\n" + fence
            + "\tbar.sync 0;\n" + desc + "\twgmma.fence.sync.aligned;\n"
            "\twgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
            "{%f2, %f3, %f4, %f5}, %rd3, %rd5, p, 1, 1;\n"
            "\twgmma.commit_group.sync.aligned;\n"
            "\twgmma.wait_group.sync.aligned 0;\n\tret;\n")


@pytest.mark.parametrize("plane,fence,kinds", [
    ("%r7", "", {"PROXY"}),      # A operand written, no fence
    ("%r9", "", {"PROXY"}),      # B operand written, no fence
    ("%r7", FENCE, set()),
    ("%r11", "", set()),         # a third plane: not an operand
])
def test_wgmma_operand_written_by_generic_stores_needs_the_fence(
        plane, fence, kinds):
    """A wgmma reads its operands through the async proxy: its
    descriptors, traced back through the and/shr/cvt/or that pack them,
    point into planes A and B; a generic store into either needs
    ``fence.proxy.async`` before the product."""
    entry = parse_ptx(_ptx(ASYNC_REGS + "\t.reg .f32 %f<8>;\n"
                           + _wgmma_body(plane, fence)))["k"]
    acc = entry.accesses()
    wg = [a for a in acc.values() if a.tag == "wgmma"]
    assert len(wg) == 1 and isinstance(wg[0].region, tuple)
    assert {k for _, _, k, _ in hazards(entry)} == kinds


SETMAXNREG = ("\tsetmaxnreg.dec.sync.aligned.u32 40;\n"
              "\tsetmaxnreg.inc.sync.aligned.u32 232;\n")


def _reg_artifact(registers, max_threads, threads=256, setmaxnreg=(),
                  body="\tret;\n"):
    target = types.SimpleNamespace(
        name="k[test]", threads=threads, max_threads=max_threads,
        setmaxnreg=setmaxnreg, dynamic_smem=lambda scale: 0)
    return types.SimpleNamespace(
        target=target, name="k[test]", ptx=parse_ptx(_ptx(body))["k"],
        facts=PtxasFacts(registers, 1, 0, 0, 0, 0))


@pytest.mark.parametrize("registers,max_threads,body,setmaxnreg,error", [
    (62, 1024, "", (), None),           # the window tier's build
    (95, 1024, "", (), "refused"),      # its first build: 97,280 registers
    (64, 1024, "", (), None),           # 65,536: the limit itself
    (67, 1024, "", (), "refused"),      # rounded to 72 a thread
    (127, 512, "", (), None),           # the CUDA-core flash kernel
    (168, 384, SETMAXNREG, ((40, 1), (232, 2)), None),
    (168, 384, SETMAXNREG, ((40, 1), (240, 2)), "states"),
    (168, 384, SETMAXNREG, ((40, 1), (232, 1)), "block's"),
    (120, 512, SETMAXNREG, ((40, 1), (232, 2)), "block's"),
    (160, 384, SETMAXNREG, ((40, 1), (232, 2)), "the launch holds"),
    (168, 384, SETMAXNREG.replace("232", "248"), ((40, 1), (248, 2)),
     "above the SM"),
])
def test_registers_over_the_register_file_are_an_error(
        registers, max_threads, body, setmaxnreg, error):
    """``registers`` is an ERROR when the launch-time count at the largest
    block the wrapper admits exceeds the SM's 65,536 registers, and when a
    kernel's setmaxnreg shares disagree with its target or exceed the
    register file or the launch's allocation; else INFO."""
    art = _reg_artifact(registers, max_threads, setmaxnreg=setmaxnreg,
                        body=body + "\tret;\n")
    findings = Registers().check_kernel(art)
    errors = [f for f in findings if f.severity is Severity.ERROR]
    if error is None:
        assert errors == []
    else:
        assert len(errors) == 1 and error in errors[0].message
    info = [f for f in findings if f.severity is Severity.INFO]
    assert len(info) == 1
    assert info[0].data["block_registers"] == h100.block_registers(
        registers, max_threads)


# ------------------------------------------------------------------ 3 -----

def _body(text: str, kernel_name: str):
    """Lines of ``kernel_name``'s body: from the line after its signature's
    opening brace to the matching closing brace."""
    lines = text.splitlines()
    start = next(n for n, ln in enumerate(lines)
                 if re.search(rf"__global__ void {kernel_name}\(", ln))
    while not lines[start].rstrip().endswith("{"):
        start += 1
    depth, end = 1, start + 1
    while depth:
        depth += lines[end].count("{") - lines[end].count("}")
        end += 1
    return [ln.strip() for ln in lines[start + 1:end - 1]]


@pytest.mark.parametrize("name", sorted(mutations.KERNEL_MUTATIONS))
def test_mutant_differs_from_production_only_in_its_mutation(name):
    m = mutations.KERNEL_MUTATIONS[name]
    prod = _body(kernel.SOURCE.read_text(), m.copy_of)
    mut = _body(mutations.SOURCE.read_text(), m.kernel)
    assert not any("MUTATION" in ln for ln in prod)
    ops = [op for op in difflib.SequenceMatcher(a=prod, b=mut,
                                                autojunk=False).get_opcodes()
           if op[0] != "equal"]
    assert len(ops) == 1, ops
    _, i1, i2, j1, j2 = ops[0]
    group = mut[j1:j2]
    assert group[0].startswith("// MUTATION:")
    assert sum("MUTATION" in ln for ln in mut) == 1
    assert i2 - i1 <= 1   # one production line changed or dropped


def test_mutant_source_includes_production_and_hashes_it():
    text = mutations.SOURCE.read_text()
    assert '#include "../../kernels/skipper_match/csrc/skipper_match.cu"' \
        in text
    assert (mutations.SOURCE.parent / "../../kernels/skipper_match/csrc/"
            "skipper_match.cu").resolve() == kernel.SOURCE
    lib = _build.library_path(mutations.SOURCE)
    assert lib.parent == ROOT / "build" / "repro_torch"
    assert lib.name.startswith("libmutants_")
    assert _build.ptx_path(mutations.SOURCE).suffix == ".ptx"


@pytest.mark.parametrize("role", ["window", "boundary", "row"])
@pytest.mark.parametrize("spec", ["u8", "legacy_i32"])
def test_tier_order_fixture_has_teeth(role, spec):
    sp = getattr(StateSpec, spec)()
    x = fixture(role, sp, torch.device("cpu"))
    fwd = run_plain(role, x, sp)
    rev = run_plain(role, x, sp, reverse=True)
    assert not torch.equal(fwd[1], rev[1])
    assert not torch.equal(fwd[0], rev[0])
    # the fixture is left as it was
    assert int(x["state"].to(torch.int64).sum()) == 0


def test_swapped_writeback_plain_is_the_reversed_order():
    sp = StateSpec.u8()
    x = fixture("boundary", sp, torch.device("cpu"))
    state = x["state"].clone()
    matched, conflicts = mutations.plain(
        "swapped_writeback", state, x["blk_u"], x["blk_v"], x["u"], x["v"])
    want = run_plain("boundary", x, sp, reverse=True)
    assert torch.equal(state, want[0]) and torch.equal(matched, want[1])
    assert torch.equal(conflicts, want[2])


# ------------------------------------------------------------------ 4 -----

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_sources_only_clean_and_source_canary():
    proc = _cli("--sources-only", "src/repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s)" in proc.stdout
    proc = _cli("--mutation", "hardcoded_state_dtype")
    assert proc.returncode == 1, proc.stdout + proc.stderr


def test_cli_refuses_kernel_rules_without_nvcc_or_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for args in ((), ("--mutation", "dynamic_gather")):
        proc = _cli(*args)
        assert proc.returncode == 2
        assert "need nvcc and a CUDA card" in proc.stderr


def test_shared_memory_limits_per_state_width():
    assert largest_window(StateSpec.u8(), 256, 0) == 230_144
    assert largest_window(StateSpec.legacy_i32(), 256, 0) == 57_536
    assert kernel.window_tier_smem_bytes(
        largest_window(StateSpec.u8(), 256, 0), 256) == _build.MAX_SMEM_BYTES
    assert kernel.boundary_smem_bytes(256) == 2304


def test_async_window_tier_shared_memory_limits():
    """With one ring stage of 16 tiles beside the row (padded to 16) the
    asynchronous window tier's largest window at tile 256 and no static
    memory: 199,680 u8 cells, 49,920 int32."""
    assert largest_window(StateSpec.u8(), 256, 0, ring=True) == 199_680
    assert largest_window(StateSpec.legacy_i32(), 256, 0,
                          ring=True) == 49_920
    assert kernel.window_async_smem_bytes(
        199_680, 256, StateSpec.u8(), 1) == _build.MAX_SMEM_BYTES


def test_targets_name_every_async_window_instance():
    """Every (state, counter) instance of ``skipper_window_async_kernel``
    is a kernel target launched through ``kernel.window_tier`` (the ring
    depth is a launch argument, so the shape rule adds no instance); the
    first window tier's targets launch ``window_tier_sync``; and
    ``skipper_match``'s census expects the new kernel once and the first
    one never."""
    from repro_torch.analysis import targets

    widths = [(s, c) for s in ("uint8", "int32") for c in ("uint8", "int32")]
    by_name = {t.name: t for t in targets.get_targets()}
    for s, c in widths:
        t = by_name[f"window_async[{s},{c}]"]
        assert t.kernel == kernel.WINDOW_ASYNC == "skipper_window_async_kernel"
        assert t.template == (targets.CPP_TYPES[s], targets.CPP_TYPES[c])
        assert t.role == "window" and t.launch.func is kernel.window_tier
        assert t.dynamic_smem(1) == t.dynamic_smem(2) == (
            kernel.window_async_smem_bytes(targets.WINDOW, targets.TILE,
                                           t.spec))
        first = by_name[f"window_tier[{s},{c}]"]
        assert first.kernel == kernel.WINDOW_TIER
        assert first.launch.func is kernel.window_tier_sync
    assert sum(getattr(t, "kernel", None) == kernel.WINDOW_ASYNC
               for t in by_name.values()) == 4
    assert len(by_name) == 46  # 40 kernel instances, 6 entry points
    census = by_name["skipper_match"].expect
    assert census[kernel.WINDOW_ASYNC] == 1
    assert census[kernel.WINDOW_TIER] == 0
    assert by_name["flash_attention"].expect[kernel.WINDOW_ASYNC] == 0
    # the largest block each matcher instance's wrapper admits, which
    # registers checks: 1,024 lanes, and 896 for the asynchronous global
    # tier (wider tiles take the first global tier)
    for t in by_name.values():
        if getattr(t, "role", None) in ("window", "boundary"):
            assert t.max_threads == (
                kernel.BOUNDARY_ASYNC_MAX_THREADS
                if t.kernel == kernel.BOUNDARY_ASYNC else kernel.MAX_THREADS)


@pytest.mark.parametrize("vmem", ["uint8", "int32"])
@pytest.mark.parametrize("counter", ["uint8", "int32"])
def test_targets_name_the_filtered_instance(vmem, counter):
    """The filtered instance of the asynchronous global tier
    (``kInstanceFiltered``, template argument 2) is a kernel target under
    each width pair, launched as the raw stream launches it: through
    ``boundary_tier(instance="filtered")`` over one state row (role "row",
    whose tier-order fixture is one row of (0, 0) tiles), in blocks of
    ``FILTERED_THREADS``."""
    from repro_torch.analysis import targets

    t = {t.name: t for t in targets.get_targets()}[
        f"boundary_async[{vmem},{counter},filtered]"]
    assert t.kernel == kernel.BOUNDARY_ASYNC
    assert t.template == (targets.CPP_TYPES[vmem], targets.CPP_TYPES[counter],
                          "2")
    assert t.role == "row"
    assert t.threads == t.max_threads == kernel.FILTERED_THREADS
    assert t.launch.func is kernel.boundary_tier
    assert t.launch.keywords["instance"] == kernel.FILTERED
    x = fixture("row", t.spec, torch.device("cpu"))
    assert x["state"].shape == (1, targets.WINDOW)
    assert not x["blk_u"].any() and not x["blk_v"].any()
    assert int(x["v"].max()) < targets.WINDOW


def test_targets_name_the_three_term_kernel_and_its_pre_pass():
    """The TF32 kernel and its pre-pass are targets at each (head dim,
    dtype) they take, each with its block, its setmaxnreg shares and its
    shared memory; the flash entry point's census expects both once and the
    CUDA-core kernel never."""
    from repro_torch.analysis import targets
    from repro_torch.kernels.flash_attention import kernel as flash

    by_name = {t.name: t for t in targets.get_targets()}
    for d, dtype in flash.TF32_INSTANCES:
        main = by_name[f"flash_tf32x3[{dtype},{d}]"]
        assert main.kernel == flash.FLASH_TF32
        assert main.template == (str(d), targets.CPP_TYPES[dtype])
        assert main.max_threads == 128 * (1 + flash.TF32_GEOMETRY[d][0])
        assert main.dynamic_smem(1) == main.dynamic_smem(2) == (
            flash.tf32_smem_bytes(d))
        assert sum(n for _, n in main.setmaxnreg) in (0, main.max_threads
                                                      // 128)
        split = by_name[f"flash_split_tf32[{dtype},{d}]"]
        assert split.kernel == flash.FLASH_SPLIT
        assert split.template == (targets.CPP_TYPES[dtype], str(d))
    assert by_name["flash_wgmma[bfloat16,64]"].setmaxnreg == ((40, 1),
                                                              (232, 2))
    census = by_name["flash_attention"].expect
    assert census[flash.FLASH_TF32] == census[flash.FLASH_SPLIT] == 1
    assert census[flash.FLASH] == 0


def test_roofline_models():
    occ = h100.occupancy(registers=27, threads=256, smem_bytes=2560)
    assert occ["blocks_per_sm"] == 8 and occ["occupancy"] == 1.0
    occ = h100.occupancy(registers=127, threads=512, smem_bytes=201_216)
    assert occ["blocks_per_sm"] == 1 and occ["occupancy"] == 0.25
    ms, by = h100.flash_bound_ms(1, 24, 8, 32768, 64, "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(2 * 24 * 32768**2 * 64 / 989e12 * 1e3)
    ms, by = h100.flash_bound_ms(1, 24, 8, 32768, 64, "float32")
    assert by == "operations, 3xTF32"
    assert ms == pytest.approx(3 * 2 * 24 * 32768**2 * 64 / 494.7e12 * 1e3)
    assert ms == pytest.approx(20.003, abs=1e-3)
    assert h100.flash_cuda_core_bound_ms(1, 24, 32768, 64) == pytest.approx(
        2 * 24 * 32768**2 * 64 / 67e12 * 1e3)
    s = types.SimpleNamespace(u_tiles=np.zeros((2, 512)), num_rows=2,
                              window=256, num_boundary_padded=1024,
                              num_windows=4, num_boundary_tiles=4)
    assert h100.window_bytes(s, StateSpec.u8()) == 8 * 1024 + 2 * 512 + 2048
    assert h100.boundary_bytes(s, StateSpec.legacy_i32()) == (
        32 + 8 * 1024 + 2 * 4096 + 8 * 1024)


def test_stream_bytes_model():
    """The raw-stream matcher's byte bound: 8 bytes of ids an edge slot,
    the state row in and out, matched and conflicts out, at each width;
    at rmat22's shape (131,072 tiles of 512, 2^22 vertices, u8) 704 MiB."""
    assert h100.stream_bytes(3, 32, 100, StateSpec.u8()) == (
        8 * 96 + 2 * 100 + 2 * 96)
    assert h100.stream_bytes(3, 32, 100, StateSpec.legacy_i32()) == (
        8 * 96 + 2 * 400 + 8 * 96)
    full = h100.stream_bytes(131_072, 512, 1 << 22, StateSpec.u8())
    assert full == 10 * (1 << 26) + (1 << 23)
    assert h100.bytes_ms(full) == pytest.approx(full / 3.35e12 * 1e3)
    assert h100.stream_bytes(0, 512, 0, StateSpec.u8()) == 0


@pytest.mark.parametrize("spec", ["u8", "legacy_i32"])
def test_slab_bytes_model(spec):
    """One slab pass's byte bound: 8 bytes of ids a slot, matched and
    conflicts out, and only the state sectors the slab touches, read and
    written once, capped at the whole row."""
    s = getattr(StateSpec, spec)()
    slot_out = 2 * s.counter_bytes
    assert h100.slab_bytes(8192, 100, 1 << 22, s) == (
        8 * 8192 + 2 * 100 * 32 + slot_out * 8192)
    # a slab that touches more sectors than the row holds moves the row
    assert h100.slab_bytes(64, 50, 100, s) == (
        8 * 64 + 2 * 100 * s.vmem_bytes + slot_out * 64)
    assert h100.slab_bytes(0, 0, 1 << 22, s) == 0
    assert h100.slab_bytes(8192, 16384, 1 << 22, s) < h100.stream_bytes(
        32, 256, 1 << 22, s)


def test_skipper_entry_target_expects_one_global_tier_launch():
    """The analyzer's ``skipper`` entry target: the asynchronous global
    tier once, every other kernel never; 46 targets in all, the two
    distributed entries among them."""
    from repro_torch.analysis import targets
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    t = targets.get_targets(["skipper"])[0]
    assert t.expect[kernel.BOUNDARY_ASYNC] == 1
    others = set(kernel.launch_counts()) | set(flash.launch_counts())
    assert {k for k, n in t.expect.items() if n == 0} == (
        others - {kernel.BOUNDARY_ASYNC})
    assert len(targets.target_names()) == 46


@pytest.mark.parametrize("fault", ["nvcc fails", "entry missing"])
def test_a_target_that_does_not_build_is_an_error(monkeypatch, tmp_path,
                                                  fault):
    """A kernel target whose source fails to build, or whose entry the
    build does not hold, is an ERROR of rule ``build``, never a clean
    report (nvcc is faked, so this runs without one)."""
    from repro_torch.analysis import runner, targets

    ptx = tmp_path / "k.ptx"
    ptx.write_text(_ptx("\tret;\n"))

    def fake_build(*sources, ptx_out=ptx, **kw):
        if fault == "nvcc fails":
            raise RuntimeError("nvcc failed: fake")
        return {str(s): {"path": str(ptx_out), "seconds": 0.0,
                         "log": PTXAS_LOG} for s in sources}

    monkeypatch.setattr(_build, "build", fake_build)
    t = [t for t in targets.get_targets() if t.name == "window_tier[uint8,"
         "uint8]"]
    report = runner._analyze_kernels(t, [SmemBarrier()])
    assert not report.clean
    assert [(f.rule, f.where) for f in report.errors] == [
        ("build", "window_tier[uint8,uint8]")]
