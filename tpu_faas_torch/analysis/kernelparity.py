"""Kernel-binding parity: the CUDA kernels' ``ctypes`` bindings proven
synchronized with their ``extern "C"`` signatures and the state registry,
at rest.

JAX's checker holds the Pallas kernel's ``in_specs`` / ``out_shape`` /
``input_output_aliases`` to the ``_ResidentState`` registry. The port's
kernels are bound through ``ctypes`` instead: a wrapper sets each
symbol's ``argtypes`` from hand-kept counts (``_N_PTR``, ``_N_INT``,
``_TENANCY_TYPES`` ...) and launches it with a list of ``data_ptr()``
arguments (``st.sizes.data_ptr(), ...``), against a C parameter list that
ends in a macro (``LANE_PARAMS``). A leaf added on one side, or two leaves
swapped, still compiles and still launches; the kernel then reads the
wrong buffer, and no CPU test sees it, because the CPU runs the plain
version and never calls the library. This pass reads the ``.cu`` sources
as text (the ``csrc`` directory beside or above the scanned module, with
every object-like ``#define`` expanded in the parameter lists) and judges
the Python side against them.

Three rules:

- ``kernelparity.state-leaf-drift`` — at a launch of a bound symbol the
  argument list (with ``*ten`` / ``*spec`` expanded through the lane
  helper that built the tuple, whose returns must all have one length)
  is as long as the C parameter list, passes a ``data_ptr()`` only where
  C takes a pointer, and lists the registry's leaves in declaration order
  within each run (the direct arguments, each expanded tuple); the
  launches of a run together pass every leaf of the registry; each
  symbol's ``argtypes`` has the C signature's runs of pointers, ``int``,
  ``unsigned`` and ``float`` (the argument kinds position by position),
  and its ``restype`` the C return type. C parameter names differ from the
  leaves (``free_cnt`` for ``free``), so positions and types decide, never
  names. JAX's registry rules stay too: a sequence reading half the
  registry off one base lists every leaf in order, and a positional
  registry construction has the registry's arity.
- ``kernelparity.state-dtype-drift`` — the C pointer type at a leaf's
  position matches the registry's dtype comment (``float*`` and ``f32``,
  ``int32_t*`` and ``i32``, ``uint8_t*`` and ``bool``), and so does every
  ``check_arg`` dtype spelled for a leaf (``("sizes", torch.float32, T)``
  rows, ``check_arg(st.refresh, "refresh", torch.bool, ...)``); at any
  other ``data_ptr()`` argument whose dtype the wrapper spells (its
  ``check_arg`` or its ``torch.empty(..., dtype=...)``), the C pointer
  type matches that.
- ``kernelparity.twin-signature-drift`` — each kernel wrapper and its
  plain version accept the same keywords: where one function passes one
  ``**splat`` to a kernel entry (a method of a class that launches a bound
  symbol, through its module-level instance: ``KERNEL(...)``,
  ``KERNEL.auction(...)``) and to a ``*_impl`` plain version, the entry's
  keywords are keywords of the plain version and the plain version's
  required keywords are the entry's; a wrapper that forwards its own
  parameters positionally to an entry or a plain version
  (``bid_top2`` to ``BidTop2Kernel.__call__`` and
  ``bid_top2_stream_impl``) has their parameter names. JAX's ``_impl``
  call checks stay: a call passes only keywords the definition accepts and
  covers its required parameters.

Like every checker here this is a pure function of source text: nothing
is imported, built or executed.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from tpu_faas_torch.analysis.core import Checker, Finding, Module, dotted_name

#: dtype tokens accepted in registry field comments
_DTYPE_COMMENT_RE = re.compile(r"\b(f32|f64|bf16|f16|i32|i64|u32|u64|u8|bool)\b")
#: canonical short spelling per torch dtype attribute
_DTYPE_CANON = {
    "float32": "f32", "float": "f32", "float64": "f64", "double": "f64",
    "bfloat16": "bf16", "float16": "f16", "half": "f16", "int32": "i32",
    "int": "i32", "int64": "i64", "long": "i64", "uint32": "u32",
    "uint64": "u64", "uint8": "u8", "bool": "bool",
}
#: element types of C pointers, canonical
_C_ELEM = {
    "float": "f32", "double": "f64", "int32_t": "i32", "int": "i32",
    "uint32_t": "u32", "unsigned int": "u32", "unsigned": "u32",
    "uint8_t": "u8", "unsigned char": "u8", "bool": "u8", "char": "u8",
    "int64_t": "i64", "long long": "i64", "uint64_t": "u64",
    "unsigned long long": "u64", "void": None,
}
#: scalar C types as ctypes kinds
_C_SCALAR = {
    "int": "int", "int32_t": "int", "unsigned int": "unsigned",
    "unsigned": "unsigned", "uint32_t": "unsigned", "float": "float",
    "double": "double", "long long": "long long", "int64_t": "long long",
    "unsigned long long": "unsigned long long",
    "uint64_t": "unsigned long long", "size_t": "unsigned long long",
    "void": "void",
}
#: ctypes type names as kinds
_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_int": "int",
    "c_int32": "int", "c_uint": "unsigned", "c_uint32": "unsigned",
    "c_float": "float", "c_double": "double", "c_longlong": "long long",
    "c_int64": "long long", "c_ulonglong": "unsigned long long",
    "c_uint64": "unsigned long long", "c_size_t": "unsigned long long",
}
_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b([A-Za-z_]\w*)\s*\(([^)]*)\)'
    r"\s*\{",
    re.S,
)
_DEFINE_RE = re.compile(
    r"^[ \t]*#[ \t]*define[ \t]+([A-Za-z_]\w*)\b(?!\()[ \t]*((?:[^\n]*\\\n)*"
    r"[^\n]*)",
    re.M,
)


def _last_segment(node: ast.AST) -> str | None:
    name = dotted_name(node)
    return name.rsplit(".", 1)[-1] if name else None


def _strip_c_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                  text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


# -- the C side --------------------------------------------------------------


@dataclass
class _CParam:
    ctype: str  # normalized type text, e.g. "const float *" -> "float"
    pointer: bool
    name: str

    @property
    def kind(self) -> str:
        if self.pointer:
            return "pointer"
        return _C_SCALAR.get(self.ctype, self.ctype)

    @property
    def elem(self) -> str | None:
        return _C_ELEM.get(self.ctype) if self.pointer else None

    def __str__(self) -> str:
        return f"{self.ctype}{'*' if self.pointer else ''} {self.name}"


@dataclass
class _CSig:
    path: str
    line: int
    name: str
    ret: str
    params: list[_CParam]


def _parse_param(text: str) -> _CParam | None:
    text = " ".join(text.replace("*", " * ").split())
    if not text or text == "void":
        return None
    toks = text.split(" ")
    name = toks[-1]
    pointer = "*" in toks
    base = [t for t in toks[:-1] if t not in ("*", "const", "volatile",
                                              "__restrict__", "restrict")]
    return _CParam(" ".join(base), pointer, name)


def _runs(kinds: list[str]) -> str:
    """``['pointer', 'pointer', 'int']`` -> ``2 pointer, 1 int``."""
    out: list[list] = []
    for k in kinds:
        if out and out[-1][1] == k:
            out[-1][0] += 1
        else:
            out.append([1, k])
    return ", ".join(f"{n} {k}" for n, k in out)


def parse_cuda_signatures(paths: Iterable[Path]) -> dict[str, _CSig]:
    """Every ``extern "C"`` function of these sources, with the sources'
    object-like macros expanded in its parameter list."""
    texts = {}
    for p in paths:
        try:
            texts[p] = _strip_c_comments(p.read_text(encoding="utf-8"))
        except OSError:
            continue
    macros: dict[str, str] = {}
    for text in texts.values():
        for m in _DEFINE_RE.finditer(text):
            macros[m.group(1)] = m.group(2).replace("\\\n", " ").strip()
    sigs: dict[str, _CSig] = {}
    for p, text in texts.items():
        if p.suffix != ".cu":
            continue
        for m in _EXTERN_RE.finditer(text):
            raw = m.group(3)
            for _ in range(8):
                expanded = re.sub(
                    r"\b([A-Za-z_]\w*)\b",
                    lambda t: macros.get(t.group(1), t.group(1)),
                    raw,
                )
                if expanded == raw:
                    break
                raw = expanded
            params = [
                q for q in (_parse_param(x) for x in raw.split(","))
                if q is not None
            ]
            ret = " ".join(m.group(1).split())
            sigs[m.group(2)] = _CSig(
                p.name, text[: m.start()].count("\n") + 1, m.group(2),
                _C_SCALAR.get(ret, ret), params,
            )
    return sigs


def _cuda_sources(start: Path) -> list[Path]:
    """The CUDA sources a wrapper module binds: ``*.cu``/``*.cuh`` in its
    own directory and in a ``csrc`` directory beside it or above it
    (bounded, so an isolated fixture directory finds only its own)."""
    out: list[Path] = []
    for d in [start, *list(start.parents)[:3]]:
        for where in (d, d / "csrc"):
            if where.is_dir():
                out.extend(sorted(where.glob("*.cu")))
                out.extend(sorted(where.glob("*.cuh")))
        if out:
            break
    return out


# -- the Python side ---------------------------------------------------------


def _comment_dtype(module: Module, lineno: int) -> str | None:
    """The dtype a registry field's doc comment declares: the trailing
    comment on the field's own line, else the nearest preceding line of
    the contiguous ``#`` block above it."""
    lines = module.source.splitlines()
    if not 1 <= lineno <= len(lines):
        return None
    _, _, trailing = lines[lineno - 1].partition("#")
    m = _DTYPE_COMMENT_RE.search(trailing)
    if m:
        return m.group(1)
    i = lineno - 2
    while i >= 0 and lines[i].strip().startswith("#"):
        m = _DTYPE_COMMENT_RE.search(lines[i])
        if m:
            return m.group(1)
        i -= 1
    return None


def _same_dtype(a: str | None, b: str | None) -> bool:
    """Whether two canonical dtypes name one element type (``bool`` and
    ``u8`` are both one byte: the kernels take bool leaves as uint8_t)."""
    if a is None or b is None:
        return True
    norm = {"bool": "u8"}
    return norm.get(a, a) == norm.get(b, b)


@dataclass
class _Registry:
    name: str
    module: Module
    node: ast.ClassDef
    leaves: list[str]
    dtypes: dict[str, str | None]


@dataclass
class _Sig:
    module: Module
    node: ast.FunctionDef | ast.AsyncFunctionDef
    pos: list[str]
    n_pos_required: int
    kwonly: set[str]
    kwonly_required: set[str]
    has_vararg: bool
    has_kwarg: bool

    @property
    def params(self) -> set[str]:
        return set(self.pos) | self.kwonly

    @property
    def required(self) -> set[str]:
        return set(self.pos[: self.n_pos_required]) | self.kwonly_required

    @classmethod
    def of(cls, module, node, method: bool = False) -> "_Sig":
        a = node.args
        pos = [arg.arg for arg in list(a.posonlyargs) + list(a.args)]
        n_req = len(pos) - len(a.defaults)
        if method and pos and pos[0] in ("self", "cls"):
            pos, n_req = pos[1:], n_req - 1
        kwonly = [arg.arg for arg in a.kwonlyargs]
        return cls(
            module=module, node=node, pos=pos, n_pos_required=n_req,
            kwonly=set(kwonly),
            kwonly_required={
                arg for arg, d in zip(kwonly, a.kw_defaults) if d is None
            },
            has_vararg=a.vararg is not None, has_kwarg=a.kwarg is not None,
        )


@dataclass
class _Call:
    """A call to an ``*_impl`` function or a kernel entry."""

    module: Module
    node: ast.Call
    callee: str  # "name" for an impl, "Class.method" for an entry
    n_pos: int
    has_star: bool
    kwargs: set[str]
    splat: str | None  # the **name, when it is a bare name
    open_kwargs: bool
    caller: ast.FunctionDef | ast.AsyncFunctionDef | None


@dataclass
class _Launch:
    module: Module
    node: ast.Call
    symbol: str
    #: one entry per argument after expansion: (segment id, the argument)
    args: list[tuple[int, ast.AST]] | None
    #: a message when the expansion found lane helpers that disagree
    lane_error: str | None = None


@dataclass
class _Binding:
    module: Module
    node: ast.AST
    symbol: str
    what: str  # "argtypes" | "restype"
    kinds: list[str] | None


@dataclass
class _ModState:
    module: Module
    sigs: dict[str, _CSig]
    aliases: dict[str, set[str]] = field(default_factory=dict)
    symbols: dict[str, str] = field(default_factory=dict)


class KernelParityChecker(Checker):
    """Cross-module pass: collect the registry, the C signatures, every
    binding, launch, ``check_arg`` spelling and wrapper/plain call in
    :meth:`check`; judge them against each other in :meth:`finalize`."""

    name = "kernelparity"

    def __init__(self) -> None:
        self.registries: list[_Registry] = []
        self.c_sigs: dict[str, _CSig] = {}
        self.launches: list[_Launch] = []
        self.bindings: list[_Binding] = []
        self._groups: list[tuple[Module, ast.AST, str, list[str]]] = []
        self._ctors: list[
            tuple[Module, ast.Call, str, list[str | None], set[str], bool]
        ] = []
        #: (module, node, leaf, dtype) spelled by a check_arg row or call
        self._leaf_dtypes: list[tuple[Module, ast.AST, str, str]] = []
        #: (module, launch node, position) -> the wrapper's dtype spelling
        self._arg_dtypes: dict[tuple[int, int], str] = {}
        self._impl_defs: dict[str, list[_Sig]] = {}
        self._entry_defs: dict[str, _Sig] = {}
        self._kernel_classes: set[str] = set()
        #: (id of module, NAME) -> class of a module-level NAME = Class()
        self._instances: dict[tuple[int, str], str] = {}
        self._calls: list[_Call] = []
        self._forwards: list[tuple[Module, ast.Call, _Sig, str]] = []
        self._sources_seen: dict[Path, dict[str, _CSig]] = {}

    # -- collection --------------------------------------------------------

    def check(self, module: Module) -> Iterable[Finding]:
        # only a module that loads a library binds or launches its symbols
        binds = "CDLL" in module.source
        ms = _ModState(module, self._sigs_for(module) if binds else {})
        if binds:
            self._collect_aliases(ms)
        aliases = self._dtype_aliases(module)
        consts = self._int_consts(module)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                self._collect_registry(module, node)
                self._collect_class(ms, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.endswith("_impl"):
                    self._impl_defs.setdefault(node.name, []).append(
                        _Sig.of(module, node)
                    )
            elif isinstance(node, ast.Tuple):
                self._collect_group(module, node, node.elts)
                self._collect_leaf_row(module, node, aliases)
            elif isinstance(node, ast.Call):
                if not (_last_segment(node.func) or "").endswith("State"):
                    self._collect_group(module, node, node.args)
                self._collect_ctor(module, node)
                self._collect_check_arg(module, node, aliases)
        if binds:
            for fn in ast.walk(module.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._collect_bindings(ms, fn, consts)
            self._collect_bindings(ms, module.tree, consts)
            self._collect_launches(ms, aliases)
        self._collect_calls(ms)
        return ()

    def _sigs_for(self, module: Module) -> dict[str, _CSig]:
        srcs = tuple(_cuda_sources(module.path.parent))
        if not srcs:
            return {}
        key = srcs[0].parent
        if key not in self._sources_seen:
            self._sources_seen[key] = parse_cuda_signatures(srcs)
            self.c_sigs.update(self._sources_seen[key])
        return self._sources_seen[key]

    def _collect_registry(self, module: Module, node: ast.ClassDef) -> None:
        if not node.name.endswith("State"):
            return
        if not any(_last_segment(b) == "NamedTuple" for b in node.bases):
            return
        leaves: list[str] = []
        dtypes: dict[str, str | None] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                leaves.append(stmt.target.id)
                dtypes[stmt.target.id] = _comment_dtype(module, stmt.lineno)
        if leaves:
            self.registries.append(
                _Registry(node.name, module, node, leaves, dtypes)
            )

    @staticmethod
    def _dtype_aliases(module: Module) -> dict[str, str]:
        """Module-level dtype shorthands: ``_I32 = torch.int32``."""
        out: dict[str, str] = {}
        for stmt in module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Attribute)
                and stmt.value.attr in _DTYPE_CANON
            ):
                out[stmt.targets[0].id] = _DTYPE_CANON[stmt.value.attr]
        return out

    @staticmethod
    def _int_consts(module: Module) -> dict[str, int]:
        out: dict[str, int] = {}
        for stmt in module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Constant)
                and type(stmt.value.value) is int
            ):
                out[stmt.targets[0].id] = stmt.value.value
        return out

    @staticmethod
    def _dtype_of(node: ast.AST, aliases: dict[str, str]) -> str | None:
        if isinstance(node, ast.Attribute) and dotted_name(node.value) in (
            "torch", "np", "numpy"
        ):
            return _DTYPE_CANON.get(node.attr)
        if isinstance(node, ast.Name):
            return aliases.get(node.id)
        return None

    def _collect_leaf_row(self, module, node: ast.Tuple, aliases) -> None:
        """``("sizes", torch.float32, T)``: a leaf's dtype as a
        ``check_arg`` loop spells it."""
        if len(node.elts) < 2:
            return
        first = node.elts[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            dt = self._dtype_of(node.elts[1], aliases)
            if dt is not None:
                self._leaf_dtypes.append((module, node, first.value, dt))

    def _collect_check_arg(self, module, node: ast.Call, aliases) -> None:
        if _last_segment(node.func) != "check_arg" or len(node.args) < 3:
            return
        dt = self._dtype_of(node.args[2], aliases)
        if dt is None:
            return
        leaf = None
        if isinstance(node.args[1], ast.Constant) and isinstance(
            node.args[1].value, str
        ):
            leaf = node.args[1].value
        target = node.args[0]
        while isinstance(target, ast.Call) and isinstance(
            target.func, ast.Attribute
        ):
            target = target.func.value
        if isinstance(target, ast.Attribute):
            leaf = target.attr
        if leaf is not None:
            self._leaf_dtypes.append((module, node, leaf, dt))

    def _collect_group(self, module, anchor, elements) -> None:
        by_base: dict[str, list[str]] = {}
        for el in elements:
            node = el
            depth = 0
            while isinstance(node, ast.Call) and node.args and depth < 3:
                node = node.args[0]
                depth += 1
            if isinstance(node, ast.Attribute):
                base = dotted_name(node.value)
                if base is not None:
                    by_base.setdefault(base, []).append(node.attr)
        for base, attrs in by_base.items():
            if len(attrs) >= 3:
                self._groups.append((module, anchor, base, attrs))

    def _collect_ctor(self, module, node: ast.Call) -> None:
        fname = _last_segment(node.func)
        if not fname or not fname.endswith("State"):
            return
        tokens: list[str | None] = []
        has_star = False
        for a in node.args:
            if isinstance(a, ast.Starred):
                has_star = True
                tokens.append(None)
            elif isinstance(a, ast.Name):
                tokens.append(a.id)
            elif isinstance(a, ast.Attribute):
                tokens.append(a.attr)
            else:
                tokens.append(None)
        if not any(kw.arg is None for kw in node.keywords):
            self._ctors.append((
                module, node, fname, tokens,
                {kw.arg for kw in node.keywords if kw.arg is not None},
                has_star,
            ))

    def _collect_class(self, ms: _ModState, node: ast.ClassDef) -> None:
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._entry_defs[f"{node.name}.{stmt.name}"] = _Sig.of(
                    ms.module, stmt, method=True
                )

    # -- symbols and their aliases -----------------------------------------

    def _collect_aliases(self, ms: _ModState) -> None:
        """``fn = lib.sym`` / ``ctypes.CDLL(p).sym``, and every plain
        name-to-name assignment (``self._fn = fn``, tuple forms too), so a
        launch through ``self._fn`` resolves to its symbol."""
        libs: set[str] = set()
        pairs: list[tuple[str, ast.AST]] = []
        for node in ast.walk(ms.module.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Tuple) and isinstance(
                    node.value, ast.Tuple
                ) and len(t.elts) == len(node.value.elts):
                    pairs.extend(
                        (dotted_name(a), b)
                        for a, b in zip(t.elts, node.value.elts)
                        if dotted_name(a)
                    )
                elif dotted_name(t):
                    pairs.append((dotted_name(t), node.value))
        for name, value in pairs:
            if isinstance(value, ast.Call) and _last_segment(
                value.func
            ) == "CDLL":
                libs.add(name)
        for name, value in pairs:
            if isinstance(value, ast.Attribute):
                base = value.value
                if (
                    isinstance(base, ast.Call)
                    and _last_segment(base.func) == "CDLL"
                ) or dotted_name(base) in libs:
                    ms.symbols[name] = value.attr
                    continue
            src = dotted_name(value)
            if src is not None:
                ms.aliases.setdefault(name, set()).add(src)

    def _symbol(self, ms: _ModState, name: str | None) -> str | None:
        seen: set[str] = set()
        todo = [name] if name else []
        while todo:
            n = todo.pop()
            if n in seen:
                continue
            seen.add(n)
            if n in ms.symbols:
                return ms.symbols[n]
            todo.extend(ms.aliases.get(n, ()))
        return None

    def _ctypes_kinds(self, node, ms, consts, lists, depth=0):
        """An ``argtypes`` expression as kinds, or None."""
        if depth > 8:
            return None
        if isinstance(node, (ast.List, ast.Tuple)):
            out = []
            for e in node.elts:
                k = self._ctypes_kind(e, lists)
                if k is None:
                    return None
                out.append(k)
            return out
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a = self._ctypes_kinds(node.left, ms, consts, lists, depth + 1)
            b = self._ctypes_kinds(node.right, ms, consts, lists, depth + 1)
            return a + b if a is not None and b is not None else None
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for seq, n in ((node.left, node.right), (node.right, node.left)):
                count = (
                    n.value if isinstance(n, ast.Constant)
                    and type(n.value) is int
                    else consts.get(n.id) if isinstance(n, ast.Name)
                    else None
                )
                if count is not None:
                    part = self._ctypes_kinds(seq, ms, consts, lists,
                                              depth + 1)
                    return part * count if part is not None else None
            return None
        if isinstance(node, ast.Name) and node.id in lists:
            return self._ctypes_kinds(lists[node.id], ms, consts, lists,
                                      depth + 1)
        return None

    @staticmethod
    def _ctypes_kind(node, lists) -> str | None:
        d = dotted_name(node)
        if d is None:
            return None
        last = d.rsplit(".", 1)[-1]
        if last in _CTYPES_KIND:
            return _CTYPES_KIND[last]
        value = lists.get(d)
        if value is not None:
            return KernelParityChecker._ctypes_kind(value, {})
        return None

    def _collect_bindings(self, ms: _ModState, scope, consts) -> None:
        # names bound to ctypes types or lists of them, module-wide, then
        # this scope's own (a local ``P = ctypes.c_void_p``)
        lists: dict[str, ast.AST] = {}
        for body in (ms.module.tree.body, getattr(scope, "body", [])):
            for stmt in body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                ):
                    lists[stmt.targets[0].id] = stmt.value
        self._bind_in(ms, scope.body, {}, consts, lists)

    def _bind_in(self, ms, body, loops, consts, lists) -> None:
        """The ``argtypes``/``restype`` assignments of these statements,
        not inside nested defs; ``for f in (a, b): f.argtypes = ...``
        binds each of ``a`` and ``b``."""
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            inner = loops
            if isinstance(node, ast.For) and isinstance(
                node.target, ast.Name
            ) and isinstance(node.iter, (ast.Tuple, ast.List)):
                inner = dict(loops)
                inner[node.target.id] = [
                    d for d in map(dotted_name, node.iter.elts) if d
                ]
            for sub in ("body", "orelse", "finalbody", "handlers"):
                self._bind_in(ms, getattr(node, sub, []) or [], inner,
                              consts, lists)
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr in ("argtypes", "restype")
            ):
                continue
            t = node.targets[0]
            base = dotted_name(t.value)
            for n in loops.get(base, [base]) if base else []:
                sym = self._symbol(ms, n)
                if sym is None:
                    continue
                if t.attr == "argtypes":
                    kinds = self._ctypes_kinds(node.value, ms, consts, lists)
                else:
                    k = self._ctypes_kind(node.value, lists)
                    kinds = [k] if k is not None else None
                self.bindings.append(
                    _Binding(ms.module, node, sym, t.attr, kinds)
                )

    # -- launches ----------------------------------------------------------

    def _collect_launches(self, ms: _ModState, aliases) -> None:
        classes = {
            id(fn): cls
            for cls in ast.walk(ms.module.tree)
            if isinstance(cls, ast.ClassDef)
            for fn in cls.body
        }
        for fn in ast.walk(ms.module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls = classes.get(id(fn))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                sym = self._symbol(ms, dotted_name(node.func))
                if sym is None or not any(
                    _is_data_ptr(a) for a in node.args
                ):
                    continue
                if cls is not None:
                    self._kernel_classes.add(cls.name)
                args, err = self._expand(fn, cls, node)
                launch = _Launch(ms.module, node, sym, args, err)
                self.launches.append(launch)
                if args is not None:
                    dts = self._local_dtypes(fn, cls, aliases)
                    for i, (_seg, a) in enumerate(args):
                        if _is_data_ptr(a):
                            base = dotted_name(a.func.value)
                            if base in dts:
                                self._arg_dtypes[(id(node), i)] = dts[base]

    def _expand(self, fn, cls, call: ast.Call):
        """The launch's arguments with each ``*name`` replaced by the tuple
        the lane helper that bound ``name`` returns (the returned tuple
        with the most ``data_ptr()`` calls: the lane switched on)."""
        out: list[tuple[int, ast.AST]] = []
        seg = 0
        for a in call.args:
            if not isinstance(a, ast.Starred):
                out.append((0, a))
                continue
            seg += 1
            if not isinstance(a.value, ast.Name):
                return None, None
            variants = self._star_variants(fn, cls, a.value.id)
            if not variants:
                return None, None
            lengths = {len(v) for v in variants}
            if len(lengths) > 1:
                return None, (
                    f"'*{a.value.id}' comes from returns of different "
                    f"lengths {sorted(lengths)}: the lane off and the lane "
                    f"on must pass the same number of arguments"
                )
            best = max(variants, key=lambda v: sum(map(_is_data_ptr, v)))
            out.extend((seg, e) for e in best)
        return out, None

    def _star_variants(self, fn, cls, name: str) -> list[list[ast.AST]]:
        """Tuples ``name`` may hold: a local tuple literal, or an element
        of the tuples a method of the class returns."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t, v = node.targets[0], node.value
            index = None
            if isinstance(t, ast.Name) and t.id == name:
                index = -1
            elif isinstance(t, ast.Tuple):
                for i, e in enumerate(t.elts):
                    if isinstance(e, ast.Name) and e.id == name:
                        index = i
            if index is None:
                continue
            if isinstance(v, ast.Tuple) and index == -1:
                return [list(v.elts)]
            if not (isinstance(v, ast.Call) and cls is not None):
                return []
            meth = _last_segment(v.func)
            helper = next(
                (
                    s for s in cls.body
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and s.name == meth
                ),
                None,
            )
            if helper is None:
                return []
            out = []
            for r in ast.walk(helper):
                if not isinstance(r, ast.Return) or r.value is None:
                    continue
                val = r.value
                if index >= 0:
                    if not (
                        isinstance(val, ast.Tuple) and len(val.elts) > index
                    ):
                        return []
                    val = val.elts[index]
                if not isinstance(val, ast.Tuple):
                    return []
                out.append(list(val.elts))
            return out
        return []

    def _local_dtypes(self, fn, cls, aliases) -> dict[str, str]:
        """Names whose dtype the wrapper spells: ``X = torch.empty(...,
        dtype=D)`` in the launching function, ``check_arg(X, _, D, ...)``
        in its class (a loop over ``(name, X)`` pairs included)."""
        out: dict[str, str] = {}
        scopes = [fn] + ([cls] if cls is not None else [])
        for scope in scopes:
            for node in ast.walk(scope):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                ):
                    for kw in node.value.keywords:
                        if kw.arg == "dtype":
                            dt = self._dtype_of(kw.value, aliases)
                            if dt is not None:
                                out.setdefault(node.targets[0].id, dt)
                if (
                    isinstance(node, ast.Call)
                    and _last_segment(node.func) == "check_arg"
                    and len(node.args) >= 3
                    and isinstance(node.args[0], ast.Name)
                ):
                    dt = self._dtype_of(node.args[2], aliases)
                    if dt is not None:
                        out.setdefault(node.args[0].id, dt)
                if (
                    isinstance(node, ast.For)
                    and isinstance(node.target, ast.Tuple)
                    and isinstance(node.iter, (ast.Tuple, ast.List))
                ):
                    self._loop_dtypes(node, aliases, out)
        return out

    def _loop_dtypes(self, loop: ast.For, aliases, out) -> None:
        names = [
            e.id if isinstance(e, ast.Name) else None
            for e in loop.target.elts
        ]
        for call in ast.walk(loop):
            if not (
                isinstance(call, ast.Call)
                and _last_segment(call.func) == "check_arg"
                and len(call.args) >= 3
                and isinstance(call.args[0], ast.Name)
                and call.args[0].id in names
            ):
                continue
            dt = self._dtype_of(call.args[2], aliases)
            pos = names.index(call.args[0].id)
            for row in loop.iter.elts:
                if (
                    dt is not None
                    and isinstance(row, ast.Tuple)
                    and len(row.elts) > pos
                    and isinstance(row.elts[pos], ast.Name)
                ):
                    out.setdefault(row.elts[pos].id, dt)

    # -- wrapper and plain-version calls -----------------------------------

    def _collect_calls(self, ms: _ModState) -> None:
        for stmt in ms.module.tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Name)
            ):
                self._instances[(id(ms.module), stmt.targets[0].id)] = (
                    stmt.value.func.id
                )
        for fn in ast.walk(ms.module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [
                a.arg for a in (*fn.args.posonlyargs, *fn.args.args)
            ]
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = self._callee(node)
                if callee is None or (
                    callee.startswith("@")
                    and (id(ms.module), callee[1:].split(".", 1)[0])
                    not in self._instances
                ):
                    continue
                kwargs: set[str] = set()
                splat = None
                open_kwargs = False
                for kw in node.keywords:
                    if kw.arg is not None:
                        kwargs.add(kw.arg)
                    else:
                        open_kwargs = True
                        if isinstance(kw.value, ast.Name):
                            splat = kw.value.id
                n_pos = sum(1 for a in node.args
                            if not isinstance(a, ast.Starred))
                self._calls.append(_Call(
                    ms.module, node, callee, n_pos,
                    any(isinstance(a, ast.Starred) for a in node.args),
                    kwargs, splat, open_kwargs, fn,
                ))
                forwarded = [
                    a.id if isinstance(a, ast.Name) else None
                    for a in node.args
                ]
                if (
                    params
                    and forwarded == params
                    and not node.keywords
                    and not fn.args.kwonlyargs
                ):
                    self._forwards.append(
                        (ms.module, node, _Sig.of(ms.module, fn), callee)
                    )

    def _callee(self, node: ast.Call) -> str | None:
        """``name`` for an ``*_impl`` call, ``Class.method`` for a call
        through a module-level instance (judged once the kernel classes
        are known), else None."""
        func = node.func
        last = _last_segment(func)
        if last and last.endswith("_impl"):
            return last
        if isinstance(func, ast.Name):
            return f"@{func.id}.__call__"
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            return f"@{func.value.id}.{func.attr}"
        return None

    def _entry(self, module: Module, callee: str) -> tuple[str, _Sig] | None:
        """A kernel entry's qualified name and signature, for an
        ``@instance.method`` callee in ``module``."""
        if not callee.startswith("@"):
            return None
        inst, meth = callee[1:].split(".", 1)
        cls = self._instances.get((id(module), inst))
        if cls is None or cls not in self._kernel_classes:
            return None
        sig = self._entry_defs.get(f"{cls}.{meth}")
        return (f"{cls}.{meth}", sig) if sig is not None else None

    # -- judgement ---------------------------------------------------------

    def finalize(self) -> Iterable[Finding]:
        findings: list[Finding] = []
        for reg in self.registries:
            findings.extend(self._judge_registry(reg))
        findings.extend(self._judge_bindings())
        findings.extend(self._judge_launches())
        findings.extend(self._judge_twins())
        return findings

    def _registry_for(self, leaves: list[str]) -> _Registry | None:
        best, hits = None, 0
        for reg in self.registries:
            n = len(set(leaves) & set(reg.leaves))
            if n > hits:
                best, hits = reg, n
        return best

    def _judge_registry(self, reg: _Registry) -> Iterable[Finding]:
        leaves = reg.leaves
        index = {leaf: i for i, leaf in enumerate(leaves)}
        need = max(4, (len(leaves) + 1) // 2)
        for module, anchor, base, attrs in self._groups:
            hits = [a for a in attrs if a in index]
            if len(set(hits)) < need or hits == leaves:
                continue
            missing = [x for x in leaves if x not in hits]
            extra = sorted(set(hits) - set(leaves))
            detail = (
                f"missing {missing}" if missing
                else "out of declaration order"
                + (f"; repeated/foreign {extra}" if extra else "")
            )
            yield self.finding(
                module, anchor, "state-leaf-drift", "error",
                f"consumer of {reg.name} reads leaves off '{base}' as "
                f"{hits} but the registry declares {leaves} "
                f"({reg.module.relpath}:{reg.node.lineno}): {detail} — "
                f"every consumer must take every leaf in declaration order",
            )
        for module, node, fname, tokens, kwargs, has_star in self._ctors:
            if fname != reg.name or has_star:
                continue
            unknown = kwargs - set(leaves)
            if unknown:
                yield self.finding(
                    module, node, "state-leaf-drift", "error",
                    f"{reg.name}(...) passes keyword(s) {sorted(unknown)} "
                    f"that are not registry leaves",
                )
                continue
            if len(tokens) + len(kwargs) != len(leaves):
                yield self.finding(
                    module, node, "state-leaf-drift", "error",
                    f"{reg.name}(...) constructs "
                    f"{len(tokens) + len(kwargs)} leaves but the registry "
                    f"declares {len(leaves)} "
                    f"({reg.module.relpath}:{reg.node.lineno}) — a leaf "
                    f"was added or dropped on one side only",
                )
                continue
            for i, token in enumerate(tokens):
                if token in index and token != leaves[i]:
                    yield self.finding(
                        module, node, "state-leaf-drift", "error",
                        f"{reg.name}(...) passes leaf '{token}' at position "
                        f"{i} where the registry declares '{leaves[i]}' — "
                        f"positional construction must follow declaration "
                        f"order",
                    )
        for module, node, leaf, dt in self._leaf_dtypes:
            declared = reg.dtypes.get(leaf)
            if leaf in index and declared and not _same_dtype(declared, dt):
                yield self.finding(
                    module, node, "state-dtype-drift", "error",
                    f"check_arg spells leaf '{leaf}' as {dt} but the "
                    f"registry comment declares {declared} "
                    f"({reg.module.relpath}:{reg.node.lineno}) — dtype "
                    f"migrations land in the registry and every binding "
                    f"together",
                )

    def _judge_bindings(self) -> Iterable[Finding]:
        for b in self.bindings:
            sig = self.c_sigs.get(b.symbol)
            if sig is None or b.kinds is None:
                continue
            if b.what == "restype":
                if b.kinds[0] != sig.ret:
                    yield self.finding(
                        b.module, b.node, "state-leaf-drift", "error",
                        f"{b.symbol}.restype is {b.kinds[0]} but "
                        f"{sig.path}:{sig.line} returns {sig.ret}",
                    )
                continue
            want = [p.kind for p in sig.params]
            if b.kinds != want:
                at = next(
                    (i for i, (x, y) in enumerate(zip(b.kinds, want))
                     if x != y),
                    min(len(b.kinds), len(want)),
                )
                yield self.finding(
                    b.module, b.node, "state-leaf-drift", "error",
                    f"{b.symbol}.argtypes holds {len(b.kinds)} "
                    f"({_runs(b.kinds)}) but {sig.path}:{sig.line} takes "
                    f"{len(want)} ({_runs(want)}); they first differ at "
                    f"argument {at}"
                    + (f" ({sig.params[at]})" if at < len(want) else "")
                    + " — a count or a type was changed on one side only",
                )

    def _judge_launches(self) -> Iterable[Finding]:
        consumed: dict[int, set[str]] = {}
        anchors: dict[int, _Launch] = {}
        for launch in self.launches:
            sig = self.c_sigs.get(launch.symbol)
            if launch.lane_error:
                yield self.finding(
                    launch.module, launch.node, "state-leaf-drift", "error",
                    f"launch of {launch.symbol}: {launch.lane_error}",
                )
            if launch.args is None:
                continue
            leaves = [
                (i, seg, a.func.value.attr)
                for i, (seg, a) in enumerate(launch.args)
                if _is_data_ptr(a) and isinstance(a.func.value, ast.Attribute)
            ]
            reg = self._registry_for([x[2] for x in leaves])
            if sig is not None and len(launch.args) != len(sig.params):
                yield self.finding(
                    launch.module, launch.node, "state-leaf-drift", "error",
                    f"launch of {launch.symbol} passes {len(launch.args)} "
                    f"arguments but {sig.path}:{sig.line} takes "
                    f"{len(sig.params)} — an argument was added or dropped "
                    f"on one side only",
                )
            if sig is not None:
                for i, (_seg, a) in enumerate(launch.args):
                    if i >= len(sig.params) or not _is_data_ptr(a):
                        continue
                    param = sig.params[i]
                    if not param.pointer:
                        yield self.finding(
                            launch.module, launch.node, "state-leaf-drift",
                            "error",
                            f"launch of {launch.symbol} passes a pointer "
                            f"({ast.unparse(a)}) at argument {i}, where "
                            f"{sig.path}:{sig.line} takes '{param}'",
                        )
                        continue
                    spelled = self._arg_dtypes.get((id(launch.node), i))
                    leaf = (
                        a.func.value.attr
                        if isinstance(a.func.value, ast.Attribute) else None
                    )
                    if reg is not None and leaf in reg.dtypes:
                        spelled, whence = reg.dtypes[leaf], (
                            f"the registry declares {reg.dtypes[leaf]} "
                            f"({reg.module.relpath}:{reg.node.lineno})"
                        )
                    else:
                        whence = f"the wrapper spells {spelled}"
                    if not _same_dtype(param.elem, spelled):
                        yield self.finding(
                            launch.module, launch.node, "state-dtype-drift",
                            "error",
                            f"launch of {launch.symbol} passes "
                            f"{ast.unparse(a)} at argument {i}: "
                            f"{sig.path}:{sig.line} takes '{param}' but "
                            f"{whence}",
                        )
            if reg is None:
                continue
            index = {leaf: k for k, leaf in enumerate(reg.leaves)}
            by_seg: dict[int, list[str]] = {}
            for _i, seg, leaf in leaves:
                if leaf in index:
                    by_seg.setdefault(seg, []).append(leaf)
            for seg, run in by_seg.items():
                order = [index[x] for x in run]
                if order != sorted(set(order)):
                    yield self.finding(
                        launch.module, launch.node, "state-leaf-drift",
                        "error",
                        f"launch of {launch.symbol} passes "
                        f"{reg.name} leaves {run} "
                        f"{'directly' if seg == 0 else 'in a lane tuple'}, "
                        f"out of declaration order {reg.leaves} "
                        f"({reg.module.relpath}:{reg.node.lineno})",
                    )
            consumed.setdefault(id(reg), set()).update(
                x for x in (y[2] for y in leaves) if x in index
            )
            anchors.setdefault(id(reg), launch)
        for reg in self.registries:
            got = consumed.get(id(reg))
            if got is None:
                continue
            missing = [x for x in reg.leaves if x not in got]
            if missing:
                yield self.finding(
                    reg.module, reg.node, "state-leaf-drift", "error",
                    f"{reg.name} leaves {missing} reach no kernel launch "
                    f"(the launches of {sorted({l.symbol for l in self.launches})} "
                    f"pass the others) — a leaf was added to the registry "
                    f"only",
                )

    def _judge_twins(self) -> Iterable[Finding]:
        resolved: list[tuple[_Call, str, list[_Sig]]] = []
        for call in self._calls:
            entry = self._entry(call.module, call.callee)
            if entry is not None:
                resolved.append((call, entry[0], [entry[1]]))
            elif call.callee in self._impl_defs:
                resolved.append(
                    (call, call.callee, self._impl_defs[call.callee])
                )
        for call, name, sigs in resolved:
            unknown = {
                kw for kw in call.kwargs
                if all(kw not in s.params and not s.has_kwarg for s in sigs)
            }
            if unknown:
                yield self.finding(
                    call.module, call.node, "twin-signature-drift", "error",
                    f"call passes keyword(s) {sorted(unknown)} that no "
                    f"definition of {name} accepts — a parameter was added "
                    f"on the caller side only",
                )
                continue
            if call.has_star or call.open_kwargs:
                continue
            missing_per_sig = []
            for s in sigs:
                if call.n_pos > len(s.pos) and not s.has_vararg:
                    missing_per_sig.append(
                        [f"<{call.n_pos - len(s.pos)} extra positionals>"]
                    )
                    continue
                required = (
                    set(s.pos[call.n_pos : s.n_pos_required])
                    | s.kwonly_required
                )
                missing_per_sig.append(sorted(required - call.kwargs))
            if missing_per_sig and all(missing_per_sig):
                yield self.finding(
                    call.module, call.node, "twin-signature-drift", "error",
                    f"call does not cover required parameter(s) "
                    f"{missing_per_sig[0]} of {name} "
                    f"({sigs[0].module.relpath}:{sigs[0].node.lineno}) — a "
                    f"parameter was added on the definition's side only",
                )
        # one **splat handed to a kernel entry and to plain versions
        for call, name, (sig,) in [
            r for r in resolved if r[1] not in self._impl_defs
        ]:
            if call.splat is None:
                continue
            plains = [
                (c, s)
                for c, n, ss in resolved
                if n in self._impl_defs and c.caller is call.caller
                and c.splat == call.splat
                for s in ss
            ]
            if not plains:
                continue
            keys = _keyword_params(sig, call)
            verdicts = []
            for c, s in plains:
                pkeys = _keyword_params(s, c)
                preq = (s.required - set(s.pos[: c.n_pos])) - c.kwargs
                extra = keys - pkeys - c.kwargs
                lack = preq - keys - call.kwargs
                verdicts.append((extra, lack, s))
            if any(not e and not lk for e, lk, _ in verdicts):
                continue
            extra, lack, s = verdicts[0]
            detail = []
            if extra:
                detail.append(f"takes {sorted(extra)}, which "
                              f"{s.node.name} does not accept")
            if lack:
                detail.append(f"lacks {sorted(lack)}, which "
                              f"{s.node.name} requires")
            yield self.finding(
                call.module, call.node, "twin-signature-drift", "error",
                f"kernel entry {name} and its plain version "
                f"{s.node.name} ({s.module.relpath}:{s.node.lineno}) "
                f"share '**{call.splat}' but {name} "
                + " and ".join(detail)
                + " — a keyword was added to one side only",
            )
        for module, node, wsig, callee in self._forwards:
            entry = self._entry(module, callee)
            targets = (
                [entry[1]] if entry is not None
                else self._impl_defs.get(callee, [])
            )
            label = entry[0] if entry is not None else callee
            for s in targets:
                # names only: the call check above judges the coverage
                if s.pos[: len(wsig.pos)] != wsig.pos:
                    yield self.finding(
                        module, node, "twin-signature-drift", "error",
                        f"{wsig.node.name}({', '.join(wsig.pos)}) forwards "
                        f"its parameters to {label}"
                        f"({', '.join(s.pos)}) "
                        f"({s.module.relpath}:{s.node.lineno}) — a wrapper "
                        f"and its kernel or plain version must accept the "
                        f"same keywords",
                    )


def _keyword_params(sig: _Sig, call: _Call) -> set[str]:
    """The parameters a ``**splat`` may reach: those after the call's
    positionals, minus the keywords it passes by name."""
    return (set(sig.pos[call.n_pos:]) | sig.kwonly) - call.kwargs


def _is_data_ptr(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "data_ptr"
        and not node.args
    )
