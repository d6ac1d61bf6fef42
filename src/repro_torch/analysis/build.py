"""Build artifacts of the port's CUDA kernels, read for the analyzer (the
counterpart of ``repro.analysis.trace``, which traced jaxprs: what a
Hopper kernel offers to read instead is what nvcc emits).

* :func:`parse_ptxas_report` reads the ``-Xptxas=-v`` report that
  ``kernels/_build.py`` keeps beside each library: per entry function its
  registers, barriers, static shared memory, stack frame and spills.
* :func:`demangle` reads an entry's mangled name into the function's name
  and its template arguments (the subset of the Itanium grammar that
  ``__global__`` templates use).
* :func:`parse_ptx` reads PTX into one :class:`PtxEntry` per entry
  function: basic blocks with their successors (labels, ``bra``,
  predicated branches, ``ret``/``exit``), and for each instruction the
  shared-memory accesses, barriers and asynchronous-copy events
  :mod:`rules.barrier` walks.
* :func:`build_artifacts` compiles the sources of a set of targets (the
  library and its PTX, one nvcc per source, in parallel) and pairs each
  target with its entry.

Shared-memory regions. An access is to shared memory when its state space
says so (``ld.shared``, ``st.shared``, ``atom.shared``, ...), or when it is
a generic ``ld``/``st`` whose address was made from a shared symbol. Its
address is read as a linear form over atoms: the shared symbol, kernel
parameters, ``%ntid``/``%ctaid``, ``%tid``, loaded values, loop induction
variables and opaque results. The *region* of an access is the part of
that form that is the same for every lane and every iteration — the
symbol, and the terms built from parameters or from other invariant
values, as a dynamic layout offsets its arrays (``tu`` lies
``align4(window * sizeof(S))`` bytes past the state row). Constants and
``%ntid`` multiples are strides and unrolled steps inside a region and
are left out. A base rounded up to an alignment (``and`` with ``-2^k``)
and an ``or`` with a small immediate keep their operand's region. An
address chosen by ``selp`` between two readable shared addresses lies in
either arm's region (a tuple of the two). Two accesses whose regions
differ are taken not to alias: each kernel indexes its arrays in bounds,
which the kernels' own checks and the plain-version comparisons hold. An
access whose address has no readable shared base falls in every region.

Regions carved from one dynamic buffer. A kernel carves its arrays out of
one ``extern`` buffer at run-time offsets (a parameter, or an offset built
from one), and each such array is a region of its own. An address that
adds a lane- or iteration-dependent multiple of a run-time offset (a
``mul`` of a varying value by an invariant one, as ``smem + slot *
row_bytes`` picks one of two carved rows) may land in any region carved at
a multiple of that offset from its base: it lies in each of them (a tuple,
as for ``selp``).

Asynchronous copies. A copy into shared memory (``cp.async``,
``cp.async.bulk``, ``cp.async.bulk.tensor``) is an *async write* of its
destination's region; a bulk copy or reduction out of shared memory is an
*async read* of its source's region. An async write carries the region of
the mbarrier it completes on (bulk copies name it; a plain ``cp.async`` is
attached to one by ``cp.async.mbarrier.arrive``, or completes at
``cp.async.wait_group``/``wait_all``). :meth:`PtxEntry.sync_event` reads
the instructions that order them: an mbarrier wait, an mbarrier arrive,
those attachments and group waits, and ``cp.async.bulk.wait_group``.

The async proxy. A ``wgmma.mma_async`` reads its shared operands through
the async proxy: it is an *async read* of the regions its descriptors
point into (a descriptor's address is traced back through the ``and``,
``shr``, ``cvt`` and ``or`` that pack it), completed by
``wgmma.wait_group 0``. A bulk copy out of shared memory is an async read
too. ``fence.proxy.async`` (on shared memory) makes a thread's generic
writes visible to the async proxy.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------- ptxas ----

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_BARRIERS = re.compile(r"used (\d+) barriers")
_SMEM = re.compile(r"(\d+) bytes smem")


@dataclasses.dataclass(frozen=True)
class PtxasFacts:
    """What ptxas reports for one entry function."""

    registers: int
    barriers: int
    smem_static: int
    stack_frame: int
    spill_stores: int
    spill_loads: int


def parse_ptxas_report(text: str) -> Dict[str, PtxasFacts]:
    """Mangled entry name -> :class:`PtxasFacts`, for every entry function
    the report compiled (device functions it did not inline are left
    out)."""
    entries, fields = [], {}
    current = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            entries.append(current)
            fields.setdefault(current, {})
            continue
        m = _PROPS.search(line)
        if m:
            current = m.group(1)
            fields.setdefault(current, {})
            continue
        if current is None:
            continue
        m = _FRAME.search(line)
        if m:
            fields[current].update(stack_frame=int(m.group(1)),
                                   spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            b = _BARRIERS.search(line)
            s = _SMEM.search(line)
            fields[current].update(registers=int(m.group(1)),
                                   barriers=int(b.group(1)) if b else 0,
                                   smem_static=int(s.group(1)) if s else 0)
    out = {}
    for name in entries:
        f = fields[name]
        out[name] = PtxasFacts(
            registers=f.get("registers", 0), barriers=f.get("barriers", 0),
            smem_static=f.get("smem_static", 0),
            stack_frame=f.get("stack_frame", 0),
            spill_stores=f.get("spill_stores", 0),
            spill_loads=f.get("spill_loads", 0))
    return out


# ------------------------------------------------------------ demangle ----

_BUILTIN = {
    "v": "void", "b": "bool", "c": "char", "a": "signed char",
    "h": "unsigned char", "s": "short", "t": "unsigned short", "i": "int",
    "j": "unsigned int", "l": "long", "m": "unsigned long",
    "x": "long long", "y": "unsigned long long", "f": "float",
    "d": "double",
}


@dataclasses.dataclass(frozen=True)
class Demangled:
    """A function's name (innermost, without namespaces) and its template
    arguments as C++ spells them."""

    name: str
    template: Tuple[str, ...]


def _source_name(s: str, i: int) -> Tuple[str, int]:
    m = re.match(r"\d+", s[i:])
    if not m:
        raise ValueError(f"expected a length at {i} in {s!r}")
    n, i = int(m.group()), i + len(m.group())
    return s[i:i + n], i + n


def _type(s: str, i: int) -> Tuple[str, int]:
    c = s[i]
    if c in _BUILTIN:
        return _BUILTIN[c], i + 1
    if c.isdigit():
        return _source_name(s, i)
    raise ValueError(f"unsupported type code {c!r} at {i} in {s!r}")


def demangle(mangled: str) -> Demangled:
    """Read ``_Z[N<names>[I<args>E]E|<name>[I<args>E]]...``: the innermost
    name and its template arguments (types and integer literals)."""
    if not mangled.startswith("_Z"):
        return Demangled(mangled, ())
    s, i = mangled, 2
    nested = s[i] == "N"
    i += nested
    name = ""
    while i < len(s) and s[i].isdigit():
        name, i = _source_name(s, i)
    if not name:
        raise ValueError(f"no name in {mangled!r}")
    args: List[str] = []
    if i < len(s) and s[i] == "I":
        i += 1
        while s[i] != "E":
            if s[i] == "L":
                _, j = _type(s, i + 1)
                end = s.index("E", j)
                value = s[j:end]
                args.append("-" + value[1:] if value.startswith("n")
                            else value)
                i = end + 1
            else:
                t, i = _type(s, i)
                args.append(t)
        i += 1
    if nested and s[i] != "E":
        raise ValueError(f"unsupported nested name in {mangled!r}")
    return Demangled(name, tuple(args))


# ----------------------------------------------------------------- PTX ----

_SPACES = ("global", "shared", "local", "param", "const", "tex")
#: an ``or`` with an immediate below this adds it (to an aligned value)
_SMALL_OR = 4096
#: how far back :meth:`_Forms.steps` and :meth:`_Forms.desc_region` look
_STEP_DEPTH = 8
_INVARIANT_KINDS = {"sym", "param", "ntid", "ctaid", "const", "inv"}
_KEY_KINDS = {"sym", "param", "ctaid", "inv"}


@dataclasses.dataclass
class Instr:
    line: int                 # 1-based line in the PTX text
    text: str
    pred: Optional[str]       # "%p3" or "!%p3"
    op: str
    args: List[str]


@dataclasses.dataclass
class Block:
    label: Optional[str]
    instrs: List[Instr]
    succs: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Access:
    """One shared-memory access: ``kind`` "ld", "st" or "rmw"; ``region``
    is None when the address has no readable shared base, and a tuple of
    regions when a ``selp`` picks it from readable ones. ``proxy`` is
    "generic" for a thread's own load or store and "async" for an
    asynchronous copy (kind "st" into shared memory, "ld" out of it);
    ``tag`` is an async write's completion: the region of its mbarrier,
    "group" for a ``cp.async`` not yet attached to one, None when the
    mbarrier's address is unreadable; "wgmma" for a ``wgmma.mma_async``'s
    read of its operands."""

    instr: Instr
    kind: str
    region: Optional[frozenset]
    proxy: str = "generic"
    tag: object = None


#: an mbarrier or copy-group event (see :meth:`PtxEntry.sync_event`)
SyncEvent = Tuple[str, Optional[frozenset]]


@dataclasses.dataclass
class PtxEntry:
    """One entry function of a PTX module."""

    name: str
    blocks: List[Block]
    shared_symbols: frozenset
    local_bytes: int
    _accesses: Optional[Dict[int, Access]] = None
    _forms_cache: Optional["_Forms"] = None

    def barrier(self, ins: Instr) -> Optional[str]:
        """"cta" for a block-wide barrier (``bar.sync``, ``barrier.sync``,
        ``bar.red``, ``barrier.red``), "warp" for ``bar.warp.sync``, else
        None. A predicated barrier orders nothing here (it may not run)."""
        if ins.pred is not None:
            return None
        op = ins.op
        if op.startswith("bar.warp.sync"):
            return "warp"
        if op.startswith(("bar.sync", "barrier.sync", "bar.red",
                          "barrier.red")):
            return "cta"
        return None

    def sync_event(self, ins: Instr) -> Optional[SyncEvent]:
        """``(event, barrier region)`` for an instruction that orders
        asynchronous copies, else None: "wait" (``mbarrier.try_wait`` or
        ``test_wait``: the phase of that barrier completed; read as the
        exit of the spin loop around it), "arrive" (``mbarrier.arrive``:
        this thread is done with what it read), "attach"
        (``cp.async.mbarrier.arrive``: the thread's pending ``cp.async``
        complete on that barrier), "group_wait" (``cp.async.wait_group`` /
        ``wait_all``), "bulk_wait" (``cp.async.bulk.wait_group``: the
        thread's bulk copies out of shared memory are done), "wgmma_wait"
        (``wgmma.wait_group 0``: the warpgroup's products have read their
        operands) and "proxy_fence" (``fence.proxy.async`` on shared
        memory: the thread's generic writes are visible to the async
        proxy). Predicated instructions order nothing."""
        if ins.pred is not None:
            return None
        op = ins.op
        if op.startswith(("mbarrier.try_wait", "mbarrier.test_wait")):
            return "wait", self._forms().barrier_region(ins)
        if op.startswith("mbarrier.arrive"):
            return "arrive", self._forms().barrier_region(ins)
        if op.startswith("cp.async.mbarrier.arrive"):
            return "attach", self._forms().barrier_region(ins)
        if op.startswith(("cp.async.wait_group", "cp.async.wait_all")):
            return "group_wait", None
        if op.startswith("cp.async.bulk.wait_group"):
            return "bulk_wait", None
        if op.startswith("wgmma.wait_group") and ins.args and \
                _imm(ins.args[0]) == 0:
            return "wgmma_wait", None
        if op in ("fence.proxy.async", "fence.proxy.async.shared::cta",
                  "fence.proxy.async.shared::cluster"):
            return "proxy_fence", None
        return None

    def _forms(self) -> "_Forms":
        if self._forms_cache is None:
            self._forms_cache = _Forms(self)
        return self._forms_cache

    def accesses(self) -> Dict[int, Access]:
        """Shared-memory accesses by instruction line, the asynchronous
        copies' among them."""
        if self._accesses is None:
            self._accesses = self._forms().accesses()
        return self._accesses


def _split_args(rest: str) -> List[str]:
    args, depth, cur = [], 0, ""
    for ch in rest:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        args.append(cur.strip())
    return args


_DECL_SHARED = re.compile(r"\.shared\s+(?:\.align\s+\d+\s+)?\.\w+\s+([\w$]+)")
_DECL_LOCAL = re.compile(r"\.local\s+(?:\.align\s+\d+\s+)?\.\w+\s+[\w$]+"
                         r"\[(\d+)\]")
_ENTRY_DECL = re.compile(r"\.entry\s+([\w$]+)\s*\(")


def parse_ptx(text: str) -> Dict[str, PtxEntry]:
    """Mangled entry name -> :class:`PtxEntry` for a PTX module."""
    lines = text.splitlines()
    module_shared = set()
    entries: Dict[str, PtxEntry] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        m = _ENTRY_DECL.search(line)
        if m is None:
            d = _DECL_SHARED.search(line)
            if d and not line.lstrip().startswith("//"):
                module_shared.add(d.group(1))
            i += 1
            continue
        name = m.group(1)
        while not lines[i].startswith("{"):
            i += 1
        body_start = i + 1
        # the body ends where its braces balance (inline asm opens scopes)
        depth = 1
        while depth:
            i += 1
            text = lines[i].split("//")[0].strip()
            depth += (text == "{") - (text == "}")
        entries[name] = _parse_body(name, lines, body_start, i)
        i += 1
    for e in entries.values():
        e.shared_symbols = frozenset(e.shared_symbols | module_shared)
    return entries


def _parse_body(name: str, lines: List[str], lo: int, hi: int) -> PtxEntry:
    shared, local = set(), 0
    blocks: List[Block] = [Block(None, [])]
    for n in range(lo, hi):
        raw = lines[n].split("//")[0].strip()
        if not raw or raw in ("{", "}"):
            continue
        if raw.startswith("."):
            d = _DECL_SHARED.search(raw)
            if d:
                shared.add(d.group(1))
            d = _DECL_LOCAL.search(raw)
            if d:
                local += int(d.group(1))
            continue
        if raw.endswith(":"):
            blocks.append(Block(raw[:-1], []))
            continue
        stmt = raw.rstrip(";").strip()
        pred = None
        if stmt.startswith("@"):
            pred, stmt = stmt[1:].split(None, 1)
        parts = stmt.split(None, 1)
        ins = Instr(n + 1, raw, pred, parts[0],
                    _split_args(parts[1]) if len(parts) > 1 else [])
        blocks[-1].instrs.append(ins)
        if ins.op.startswith(("bra", "ret", "exit", "trap")):
            blocks.append(Block(None, []))
    blocks = [b for b in blocks if b.instrs or b.label is not None]
    by_label = {b.label: k for k, b in enumerate(blocks) if b.label}
    for k, b in enumerate(blocks):
        last = b.instrs[-1] if b.instrs else None
        fall = [k + 1] if k + 1 < len(blocks) else []
        if last is None:
            b.succs = fall
        elif last.op.startswith("bra"):
            target = [by_label[last.args[-1]]]
            b.succs = target + fall if last.pred else target
        elif last.op.startswith(("ret", "exit", "trap")):
            b.succs = fall if last.pred else []
        else:
            b.succs = fall
    return PtxEntry(name, blocks, frozenset(shared), local)


def _imm(tok: str) -> Optional[int]:
    t = tok.strip()
    try:
        if re.fullmatch(r"-?0[xX][0-9a-fA-F]+", t):
            return int(t, 16)
        if re.fullmatch(r"-?\d+", t):
            return int(t)
    except ValueError:
        return None
    return None


def _align_mask(tok: str) -> bool:
    """An ``and`` mask ``-2^k`` (k >= 1; as a signed or a 32-bit
    unsigned immediate) that rounds down to an alignment."""
    v = _imm(tok)
    if v is None:
        return False
    m = -v if v < 0 else (1 << 32) - v if v >= 1 << 31 else 0
    return m >= 2 and m & (m - 1) == 0


def _multiple(region: frozenset, base: frozenset, step: frozenset) -> bool:
    """``region`` is ``base`` plus a nonzero integer multiple of
    ``step`` (key parts, as sets of ``(atom, coefficient)``)."""
    diff = _add(dict(region), dict(base), -1)
    st = dict(step)
    if not diff or set(diff) != set(st):
        return False
    ratios = {diff[k] / st[k] for k in st}
    return len(ratios) == 1 and float(next(iter(ratios))).is_integer()


def _union(regions):
    """One region for accesses that may lie in any of ``regions`` (each a
    region or a tuple of them): the region itself, a tuple of several, or
    None when the list is empty or one is unreadable."""
    found = set()
    for r in regions:
        if r is None:
            return None
        found |= set(r) if isinstance(r, tuple) else {r}
    if not found:
        return None
    return found.pop() if len(found) == 1 else tuple(sorted(found, key=str))


def _add(a: Dict, b: Dict, scale: int = 1) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + scale * v
        if out[k] == 0:
            del out[k]
    return out


def _scale(a: Dict, c: int) -> Dict:
    return {k: v * c for k, v in a.items()} if c else {}


class _Forms:
    """Linear forms of an entry's registers (see the module docstring)."""

    def __init__(self, entry: PtxEntry):
        self.entry = entry
        self.defs: Dict[str, List[Instr]] = {}
        for b in entry.blocks:
            for ins in b.instrs:
                dest = self._dest(ins)
                if dest:
                    self.defs.setdefault(dest, []).append(ins)
        self.memo: Dict[str, Dict] = {}
        self.busy: set = set()
        self.at_line: Dict[int, Instr] = {
            ins.line: ins for b in entry.blocks for ins in b.instrs}

    @staticmethod
    def _dest(ins: Instr) -> Optional[str]:
        if not ins.args or ins.op.startswith(
                ("st.", "st ", "red.", "bar", "barrier", "bra", "ret", "exit",
                 "membar", "fence", "prefetch", "trap", "setp", "cp.",
                 "stmatrix", "mbarrier")):
            return None
        d = ins.args[0].split("|")[0]
        return d if re.fullmatch(r"%[\w$]+", d) else None

    # -- forms ------------------------------------------------------------
    def operand(self, tok: str) -> Dict:
        tok = tok.strip()
        v = _imm(tok)
        if v is not None:
            return {("const",): v} if v else {}
        m = re.fullmatch(r"%(tid|ntid|ctaid|nctaid|laneid|warpid)\.?(\w*)",
                         tok)
        if m:
            kind = {"ntid": "ntid", "ctaid": "ctaid", "nctaid": "ctaid"}
            return {(kind.get(m.group(1), "var"), tok): 1}
        if tok.startswith("%"):
            return self.reg(tok)
        if re.fullmatch(r"[\w$]+", tok):
            return {("sym", tok): 1}
        return {("var", tok): 1}

    def reg(self, reg: str) -> Dict:
        if reg in self.memo:
            return self.memo[reg]
        if reg in self.busy:
            return {("cyc", reg): 1}
        defs = self.defs.get(reg, [])
        if not defs:
            return {("var", reg): 1}
        self.busy.add(reg)
        forms = [self.instr(d) for d in defs]
        self.busy.discard(reg)
        cyc = ("cyc", reg)
        if len(forms) == 1 and cyc not in forms[0]:
            out = forms[0]
        else:
            inits = [f for f in forms if cyc not in f]
            steps = [_add(f, {cyc: 1}, -1) for f in forms if cyc in f]
            ok = (inits and all(f == inits[0] for f in inits)
                  and all(f.get(cyc, 1) == 1 for f in forms if cyc in f)
                  and not any(self.key_part(s) for s in steps))
            out = (_add(inits[0], {("iv", reg): 1}) if ok
                   else {("var", reg): 1})
        self.memo[reg] = out
        return out

    def instr(self, ins: Instr) -> Dict:
        op, a = ins.op, ins.args
        base = op.split(".")[0]
        try:
            if base == "mov" or (base in ("cvt", "cvta") and len(a) == 2):
                return self.operand(a[1])
            if base == "add" and len(a) == 3:
                return _add(self.operand(a[1]), self.operand(a[2]))
            if base == "sub" and len(a) == 3:
                return _add(self.operand(a[1]), self.operand(a[2]), -1)
            if base == "neg":
                return _scale(self.operand(a[1]), -1)
            if base == "shl" and _imm(a[2]) is not None:
                return _scale(self.operand(a[1]), 1 << _imm(a[2]))
            if base == "and" and len(a) == 3 and _align_mask(a[2]):
                return self.operand(a[1])     # rounded to an alignment
            if base == "or" and len(a) == 3 and _imm(a[2]) is not None \
                    and 0 <= _imm(a[2]) < _SMALL_OR:
                return _add(self.operand(a[1]), {("const",): _imm(a[2])})
            if base in ("mul", "mad") and (".lo" in op or ".wide" in op):
                x, y = a[1], a[2]
                c = _imm(y) if _imm(y) is not None else _imm(x)
                prod = (_scale(self.operand(x if _imm(y) is not None else y),
                               c) if c is not None
                        else self.opaque(ins, a[1:3]))
                return _add(prod, self.operand(a[3])) if base == "mad" \
                    else prod
            if base == "ld" and ".param" in op:
                return {("param", a[1].strip("[]")): 1}
        except (IndexError, ValueError):
            pass
        if base in ("ld", "atom", "shfl", "tex", "suld", "ldmatrix",
                    "vote", "match", "activemask"):
            return {("var", f"@{ins.line}"): 1}
        return self.opaque(ins, a[1:])

    def opaque(self, ins: Instr, operands: Sequence[str]) -> Dict:
        inv = all(self.invariant(self.operand(o)) for o in operands
                  if not o.startswith("0f") and not o.startswith("0d"))
        return {("inv" if inv else "var", f"@{ins.line}"): 1}

    def resolve(self, form: Dict, depth: int = 0) -> Dict:
        out: Dict = {}
        for k, v in form.items():
            if k[0] == "cyc" and depth < 8:
                sub = self.memo.get(k[1], {("var", k[1]): 1})
                out = _add(out, self.resolve(sub, depth + 1), v)
            else:
                out = _add(out, {k: v})
        return out

    @staticmethod
    def invariant(form: Dict) -> bool:
        return all(k[0] in _INVARIANT_KINDS for k in form)

    @staticmethod
    def key_part(form: Dict) -> frozenset:
        return frozenset((k, v) for k, v in form.items()
                         if k[0] in _KEY_KINDS)

    # -- accesses ---------------------------------------------------------
    def address(self, arg: str) -> Optional[Dict]:
        m = re.fullmatch(r"\[\s*([^\]+\-]+?)\s*(?:([+-])\s*(\S+))?\s*\]",
                         arg.strip())
        if not m:
            return None
        form = self.operand(m.group(1))
        if m.group(3) is not None and _imm(m.group(3)) is not None:
            off = _imm(m.group(3)) * (-1 if m.group(2) == "-" else 1)
            form = _add(form, {("const",): off})
        return self.resolve(form)

    def region(self, addr_arg: Optional[str]) -> Optional[frozenset]:
        """The region of a shared address operand ``[...]``: the invariant
        part of its form when it has exactly one shared base, else None."""
        form = self.address(addr_arg) if addr_arg else None
        syms = [k for k in (form or {}) if k[0] == "sym"
                and k[1] in self.entry.shared_symbols]
        if form is None or len(syms) != 1 or form[syms[0]] != 1:
            return None
        return self.key_part(form)

    def selected(self, addr_arg: Optional[str]) -> Optional[tuple]:
        """The regions of ``[%r]`` when ``%r``'s one definition is a
        ``selp`` between two readable shared addresses, else None."""
        m = re.fullmatch(r"\[\s*(%[\w$]+)\s*\]", (addr_arg or "").strip())
        defs = self.defs.get(m.group(1), []) if m else []
        if len(defs) != 1 or not defs[0].op.startswith("selp"):
            return None
        arms = tuple(self.region(f"[{x}]") for x in defs[0].args[1:3])
        return arms if all(r is not None for r in arms) else None

    def steps(self, form: Dict, depth: int = 0) -> set:
        """Run-time offsets (key parts) of which ``form`` may add a
        varying multiple: the invariant factor of a ``mul`` behind one of
        its varying terms, through ``selp``, ``add`` and the like, when
        that factor is built from parameters with no constant added (an
        array's row pitch such as ``(block_k + 1) * 4`` is none)."""
        out: set = set()
        if depth > _STEP_DEPTH:
            return out
        for key in form:
            if key[0] != "var" or not str(key[1]).startswith("@"):
                continue
            ins = self.at_line.get(int(key[1][1:]))
            if ins is None:
                continue
            regs = [x for x in ins.args[1:] if x.startswith("%")
                    and not x.startswith("%p")]
            if ins.op.split(".")[0] in ("mul", "mad"):
                for x in regs[:2]:
                    f = self.resolve(self.operand(x))
                    # an offset plus a constant is a row pitch, not a carve
                    if self.invariant(f) and self.key_part(f) \
                            and ("const",) not in f:
                        out.add(self.key_part(f))
                continue
            if ins.op.split(".")[0] in ("selp", "add", "sub", "mov", "cvt",
                                        "min", "max", "shl"):
                for x in regs:
                    out |= self.steps(self.resolve(self.operand(x)),
                                      depth + 1)
        return out

    def desc_region(self, tok: str, depth: int = 0):
        """The region a wgmma descriptor register points into: the first
        register behind it, through the instructions that pack a
        descriptor, whose form has one shared base; a tuple when its
        definitions point into several, None when unreadable."""
        region = self.region(f"[{tok}]")
        if region is not None or depth > _STEP_DEPTH \
                or not tok.startswith("%"):
            return region
        found = []
        for ins in self.defs.get(tok, []):
            if ins.op.split(".")[0] not in ("and", "or", "shr", "shl", "cvt",
                                            "mov", "add", "xor", "bfi"):
                return None
            found += [self.desc_region(x, depth + 1) for x in ins.args[1:]
                      if x.startswith("%")]
        return _union(found)

    def barrier_region(self, ins: Instr) -> Optional[frozenset]:
        """The region of the mbarrier an instruction names (its bracketed
        shared address operand)."""
        return self.region(next((x for x in ins.args if x.startswith("[")),
                                None))

    def async_access(self, ins: Instr) -> Optional[Access]:
        """The shared-memory side of an asynchronous copy, or None. The
        first state space after the opcode is the destination's."""
        op = ins.op
        if op.startswith(("cp.async.commit_group", "cp.async.wait",
                          "cp.async.mbarrier", "cp.async.bulk.commit_group",
                          "cp.async.bulk.wait_group",
                          "cp.async.bulk.prefetch")):
            return None
        spaces = [p.split("::")[0] for p in op.split(".")
                  if p.split("::")[0] in ("shared", "global")]
        bracketed = [x for x in ins.args if x.startswith("[")]
        if len(spaces) < 2 or len(bracketed) < 2:
            return None
        if spaces[0] == "shared":
            tag = (self.region(bracketed[-1]) if "mbarrier" in op
                   else "group")
            return Access(ins, "st", self.region(bracketed[0]), "async", tag)
        if spaces[1] == "shared":
            return Access(ins, "ld", self.region(bracketed[1]), "async")
        return None

    def accesses(self) -> Dict[int, Access]:
        out: Dict[int, Access] = {}
        shared = self.entry.shared_symbols
        carved: Dict[int, Tuple[frozenset, set]] = {}
        for b in self.entry.blocks:
            for ins in b.instrs:
                if ins.op.startswith(("cp.async", "cp.reduce.async")):
                    a = self.async_access(ins)
                    if a is not None:
                        out[ins.line] = a
                        addrs = [x for x in ins.args if x.startswith("[")]
                        self._carve(carved, ins, a,
                                    addrs[0 if a.kind == "st" else 1])
                    continue
                if ins.op.startswith("wgmma.mma_async"):
                    out[ins.line] = Access(ins, "ld", self.operands(ins),
                                           "async", "wgmma")
                    continue
                parts = ins.op.split(".")
                base = parts[0]
                if base not in ("ld", "st", "atom", "red", "ldu"):
                    continue
                if ".param" in ins.op:
                    continue
                addr_arg = next((x for x in ins.args if x.startswith("[")),
                                None)
                form = self.address(addr_arg) if addr_arg else None
                syms = [k for k in (form or {}) if k[0] == "sym"
                        and k[1] in shared]
                space = next((s for s in _SPACES if s in parts), None)
                if space != "shared" and (space is not None or not syms):
                    continue
                kind = {"ld": "ld", "ldu": "ld", "st": "st"}.get(base, "rmw")
                region = (self.key_part(form)
                          if form is not None and len(syms) == 1
                          and form[syms[0]] == 1 else self.selected(addr_arg))
                out[ins.line] = Access(ins, kind, region)
                self._carve(carved, ins, out[ins.line], addr_arg)
        regions = {a.region for a in out.values()
                   if isinstance(a.region, frozenset)}
        for line, (base, steps) in carved.items():
            more = tuple(r for r in sorted(regions, key=str) if r != base
                         and any(_multiple(r, base, s) for s in steps))
            if more:
                out[line] = dataclasses.replace(out[line],
                                                region=(base,) + more)
        return out

    def operands(self, ins: Instr):
        """The regions a ``wgmma.mma_async`` reads: its A descriptor's
        (unless A is in registers) and its B descriptor's; None when one
        is unreadable."""
        descs = ins.args[2:3] if ins.args[1].startswith("{") else \
            ins.args[1:3]
        return _union([self.desc_region(x) for x in descs])

    def _carve(self, carved, ins: Instr, a: Access, addr_arg) -> None:
        """Note an access whose address adds a varying multiple of a
        run-time offset (module docstring)."""
        if not isinstance(a.region, frozenset) or addr_arg is None:
            return
        steps = self.steps(self.address(addr_arg) or {})
        if steps:
            carved[ins.line] = (a.region, steps)


# -------------------------------------------------------------- build ----

@dataclasses.dataclass
class KernelArtifact:
    """One built kernel instance: its target, mangled name, ptxas facts and
    PTX entry."""

    target: object
    mangled: str
    facts: PtxasFacts
    ptx: PtxEntry

    @property
    def name(self) -> str:
        return self.target.name


def find_entry(names, kernel: str, template: Tuple[str, ...]
               ) -> Optional[str]:
    """The mangled name among ``names`` of ``kernel<template...>``."""
    for mangled in names:
        try:
            d = demangle(mangled)
        except ValueError:
            continue
        if d.name == kernel and d.template == tuple(template):
            return mangled
    return None


def build_artifacts(targets) -> Tuple[Dict[str, KernelArtifact],
                                      Dict[str, str]]:
    """Build every source the kernel targets name (library and PTX, one
    nvcc per source, all at once) and pair each target with its entry.
    Returns ``(artifacts by target name, failures by target name)``; a
    target whose source failed to build or whose entry is missing lands in
    ``failures`` with the reason."""
    from repro_torch.kernels import _build

    sources = sorted({Path(t.source) for t in targets}, key=str)
    artifacts: Dict[str, KernelArtifact] = {}
    failures: Dict[str, str] = {}
    parsed = {}
    try:
        libs = _build.build(*sources)
        ptxs = _build.build(*sources, ptx=True)
    except RuntimeError:
        # one source at a time, to name the ones that fail
        libs, ptxs = {}, {}
        for src in sources:
            try:
                libs.update(_build.build(src))
                ptxs.update(_build.build(src, ptx=True))
            except RuntimeError as exc:
                parsed[src] = exc
    for src in sources:
        if src in parsed:
            continue
        lib, ptx = libs[str(src)], ptxs[str(src)]
        parsed[src] = (parse_ptxas_report(str(lib["log"])),
                       parse_ptx(Path(str(ptx["path"])).read_text()))
    for t in targets:
        got = parsed[Path(t.source)]
        if isinstance(got, Exception):
            failures[t.name] = f"{Path(t.source).name} failed to build: {got}"
            continue
        report, ptx = got
        mangled = find_entry(report, t.kernel, t.template)
        if mangled is None or mangled not in ptx:
            failures[t.name] = (
                f"no entry {t.kernel}<{', '.join(t.template)}> in "
                f"{Path(t.source).name}'s ptxas report and PTX")
            continue
        artifacts[t.name] = KernelArtifact(t, mangled, report[mangled],
                                           ptx[mangled])
    return artifacts, failures
