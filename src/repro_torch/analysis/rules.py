"""drlint rule registry for the port: what a CUDA-graph capture needs.

On the card a day is captured once and replayed (`core/daygraph.py`):
the Python that builds it runs only during the capture, so code a
capture reaches must neither wait for the device nor copy from the
host, or the capture raises (or, worse, bakes one day's host values into
every replay). The JAX package's drlint encodes its jit invariants; the
port keeps the ones that mean something in PyTorch:

  * ``host-sync-in-capture`` — no ``.item()``, ``.cpu()``,
                               ``.numpy()``, ``.tolist()``,
                               ``float()``/``int()``/``bool()`` of a
                               tensor, ``torch.cuda.synchronize`` or
                               ``obs.span`` in capture-reachable code.
  * ``host-copy-in-capture`` — no ``torch.tensor(...)``, no
                               ``torch.as_tensor(...)`` of host values
                               (literals, sequences, numpy) and no
                               ``np.*`` value computation there
                               (fill on the device: ``torch.full``).
  * ``tuple-seed``           — ``default_rng((seed, ...))`` tuple
                               seeding, never ``seed + idx`` arithmetic.
  * ``deprecated-shim``      — internal code must not call the legacy
                               ``solve_cr{1,2,3}_fleet`` shims
                               (`core/fleet_solver.py` keeps them).

Rules with no meaning in the port are left out: ``donation-twin``
(no jit twins; `SolveContext.donate` aliases a graph's buffers),
``check-rep-justification`` and ``adhoc-partition-spec`` (no
shard_map or PartitionSpec: a fleet mesh is a `torch.distributed`
``DeviceMesh``), and the
JAX-specific halves of ``jit-host-leak`` and ``np-on-traced`` (a Python
branch on a tensor is legal eager code; where a capture reaches it,
the ``bool()`` it implies is what fires).

Suppression: append ``# drlint: disable=<rule>[,<rule>] -- <rationale>``
to the flagged line, or put it on its own line directly above. The
rationale after ``--`` is mandatory: a suppression without one is itself
a violation (``suppression-rationale``).

Rules are module-local: the checker parses one file at a time and never
imports the code under analysis. What a capture reaches is computed in
each module from `api._day_impl` and from `EXTRA_CAPTURE_ROOTS`, the
short table of functions the day calls across modules. The capture on
the card stays the final judge.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Callable, Iterable

__all__ = ["EXTRA_CAPTURE_ROOTS", "Module", "RULES", "Violation",
           "lint_source"]


# ---------------------------------------------------------------------------
# Infrastructure: violations, modules, suppressions, registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule hit at a source location."""
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: frozenset[str]
    rationale: str


_SUPPRESS_RE = re.compile(
    r"#\s*drlint:\s*disable=([\w\-, ]+?)\s*(?:--\s*(.*\S))?\s*$")


@dataclasses.dataclass
class Module:
    """One parsed source file plus everything the rules need."""
    path: str
    source: str
    tree: ast.Module
    comments: dict[int, str]            # line -> comment text
    suppressions: dict[int, Suppression]  # line the suppression sits on

    @classmethod
    def parse(cls, path: str, source: str) -> "Module":
        tree = ast.parse(source, filename=path)
        comments: dict[int, str] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        sups = {}
        for line, text in comments.items():
            m = _SUPPRESS_RE.search(text)
            if m:
                names = frozenset(
                    s.strip() for s in m.group(1).split(",") if s.strip())
                sups[line] = Suppression(line, names, m.group(2) or "")
        return cls(path, source, tree, comments, sups)

    def suppressed(self, rule: str, line: int) -> bool:
        """A suppression covers its own line and the line below it."""
        for at in (line, line - 1):
            s = self.suppressions.get(at)
            if s is not None and rule in s.rules:
                return True
        return False


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    summary: str
    check: Callable[[Module], list[Violation]]


RULES: dict[str, Rule] = {}


def rule(name: str, summary: str):
    def deco(fn):
        RULES[name] = Rule(name, summary, fn)
        return fn
    return deco


def lint_source(path: str, source: str) -> list[Violation]:
    """Run every registered rule over one file; apply suppressions."""
    mod = Module.parse(path, source)
    out: list[Violation] = []
    for r in RULES.values():
        for v in r.check(mod):
            if not mod.suppressed(v.rule, v.line):
                out.append(v)
    # A suppression that hides a rule must say why (a rule of the pass
    # itself, so it cannot be suppressed).
    for s in mod.suppressions.values():
        if not s.rationale:
            out.append(Violation(
                "suppression-rationale", path, s.line, 0,
                "suppression without rationale — append '-- <why>'"))
    return sorted(out, key=lambda v: (v.line, v.col, v.rule))


# ---------------------------------------------------------------------------
# What a capture reaches
# ---------------------------------------------------------------------------
def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute chains / Names; '' else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


#: path suffix -> functions a day capture runs, named in their module.
#: `api._day_impl` is the capture's own function; the rest are what it
#: calls across modules (methods by their name).
EXTRA_CAPTURE_ROOTS: dict[str, frozenset[str]] = {
    "core/api.py": frozenset({"_day_impl", "_cr1_impl", "_cr2_impl"}),
    "core/engine.py": frozenset({"al_minimize", "shifted"}),
    "core/fleet_solver.py": frozenset(
        {"fleet_penalties", "cr2_reference_tensor", "_enter_tick",
         "_bounds", "_projection"}),
    "core/regional.py": frozenset({"region_sum", "cr1_norms",
                                   "cr2_norms"}),
    # make_fused_inner and the fused_inner closure it returns.
    "kernels/al_step/ops.py": frozenset({"make_fused_inner", "al_step",
                                         "pack_rows"}),
    "kernels/dr_features/ops.py": frozenset({"dr_features"}),
}


def _function_index(tree: ast.Module) -> dict[str, list[ast.AST]]:
    """Module-level functions and class methods, by name (nested defs are
    reached through the function that holds them)."""
    idx: dict[str, list[ast.AST]] = {}
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        members = node.body if isinstance(node, ast.ClassDef) else [node]
        for fn in members:
            if isinstance(fn, defs):
                idx.setdefault(fn.name, []).append(fn)
    return idx


def capture_reachable(mod: Module) -> list[ast.AST]:
    """FunctionDefs a day capture reaches in this module: the roots of
    `EXTRA_CAPTURE_ROOTS`, every function whose name a reachable body
    mentions (calls and functions passed as values alike, a deliberate
    over-approximation), and the defs nested in reachable ones."""
    idx = _function_index(mod.tree)
    norm = mod.path.replace("\\", "/")
    roots: set[str] = set()
    for suffix, names in EXTRA_CAPTURE_ROOTS.items():
        if norm.endswith(suffix):
            roots |= names
    seen: set[int] = set()
    out: list[ast.AST] = []
    work = [fn for name in roots for fn in idx.get(name, [])]
    while work:
        fn = work.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn and id(node) not in seen:
                work.append(node)
            if isinstance(node, ast.Name) and node.id in idx:
                work.extend(f for f in idx[node.id] if id(f) not in seen)
    return out


def _own_statements(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk `fn` without nested function bodies (reported as their own
    reachable functions, so nothing counts twice)."""
    work: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while work:
        node = work.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            work.extend(ast.iter_child_nodes(node))


_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device", "numel", "dim"}


def _is_static_expr(node: ast.AST) -> bool:
    """Heuristic: a value known on the host even when built from a
    tensor: literals, shape and metadata queries, `len`."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if isinstance(sub, ast.Call) and _dotted(sub.func) == "len":
            return True
    return False


# ---------------------------------------------------------------------------
# Rule: host-sync-in-capture
# ---------------------------------------------------------------------------
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_SYNC_CALLS = {"torch.cuda.synchronize", "obs.span", "span"}


@rule("host-sync-in-capture",
      ".item()/.cpu()/.numpy()/.tolist()/float()/int()/bool() of a "
      "tensor, torch.cuda.synchronize or obs.span in capture-reachable "
      "code")
def _check_host_sync(mod: Module) -> list[Violation]:
    out = []
    for fn in capture_reachable(mod):
        for node in _own_statements(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            what = None
            if name in ("float", "int", "bool") and node.args \
                    and not _is_static_expr(node.args[0]):
                what = f"`{name}()` of a (potentially device) value"
            elif name in _SYNC_CALLS:
                what = f"`{name}(...)`"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS:
                what = f"`.{node.func.attr}()`"
            if what:
                out.append(Violation(
                    "host-sync-in-capture", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} in capture-reachable `{fn.name}` — it waits "
                    f"for the device, which a CUDA-graph capture forbids "
                    f"(and a replay would never rerun); keep device "
                    f"values on the device and host reads after the "
                    f"replay"))
    return out


# ---------------------------------------------------------------------------
# Rule: host-copy-in-capture
# ---------------------------------------------------------------------------
#: np.* calls that only read static metadata.
_NP_METADATA_OK = frozenset(
    {"ndim", "shape", "dtype", "result_type", "issubdtype",
     "broadcast_shapes", "size"})


def _host_value(node: ast.AST) -> bool:
    """A literal, a sequence display or a numpy expression: data that
    lives on the host."""
    if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.ListComp,
                         ast.GeneratorExp)):
        return True
    return any(_dotted(sub).startswith(("np.", "numpy."))
               for sub in ast.walk(node)
               if isinstance(sub, (ast.Attribute, ast.Name)))


@rule("host-copy-in-capture",
      "torch.tensor / torch.as_tensor of host values, or np.* values, in "
      "capture-reachable code")
def _check_host_copy(mod: Module) -> list[Violation]:
    out = []
    for fn in capture_reachable(mod):
        for node in _own_statements(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            what = None
            if name == "torch.tensor":
                what = "`torch.tensor(...)` copies host data"
            elif name == "torch.as_tensor" and node.args \
                    and _host_value(node.args[0]):
                what = "`torch.as_tensor(...)` of a host value"
            elif name.startswith("np.") \
                    and not name.startswith("np.random.") \
                    and name.split(".", 1)[1] not in _NP_METADATA_OK:
                what = f"`{name}(...)` computes on the host"
            if what:
                out.append(Violation(
                    "host-copy-in-capture", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} in capture-reachable `{fn.name}` — a capture "
                    f"bakes the host value of the capturing day into "
                    f"every replay (or raises); fill on the device "
                    f"(`torch.full`, `torch.zeros`) or pass the value in "
                    f"as an input tensor"))
    return out


# ---------------------------------------------------------------------------
# Rule: tuple-seed
# ---------------------------------------------------------------------------
_ARITH = (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod, ast.BitXor,
          ast.LShift, ast.RShift)


def _has_tuple_operand(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Tuple) for sub in ast.walk(node))


@rule("tuple-seed",
      "RNG seeds must be tuples, never seed arithmetic")
def _check_tuple_seed(mod: Module) -> list[Violation]:
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = _dotted(node.func)
        if not (name.endswith("default_rng") or name.endswith("PRNGKey")
                or name.endswith("manual_seed")):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.BinOp) \
                and isinstance(arg.op, _ARITH) \
                and not _has_tuple_operand(arg):
            out.append(Violation(
                "tuple-seed", mod.path, node.lineno, node.col_offset,
                f"seed arithmetic in `{name}(...)` — streams collide "
                f"when index products overlap; seed with a tuple: "
                f"`default_rng((seed, idx, ...))`"))
    return out


# ---------------------------------------------------------------------------
# Rule: deprecated-shim
# ---------------------------------------------------------------------------
_SHIMS = frozenset({"solve_cr1_fleet", "solve_cr1_fleet_sweep",
                    "solve_cr2_fleet", "solve_cr3_fleet"})


@rule("deprecated-shim",
      "internal code must not call the legacy solve_cr*_fleet shims")
def _check_deprecated_shim(mod: Module) -> list[Violation]:
    if mod.path.replace("\\", "/").endswith("core/fleet_solver.py"):
        return []   # the shims' own home
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            base = _dotted(node.func).rsplit(".", 1)[-1]
            if base in _SHIMS:
                out.append(Violation(
                    "deprecated-shim", mod.path, node.lineno,
                    node.col_offset,
                    f"`{base}` is a deprecated shim — call "
                    f"`api.solve(problem, policy, ctx=...)` instead"))
    return out
