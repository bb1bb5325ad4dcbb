"""Repo-specific AST lint of the port: the static third of the invariant
checker.

Counterpart of ``repro.analysis.lint`` with its rule numbers, scoping,
suppression comment and CLI.  Rules (each guards an invariant the serving
hot loop depends on):

RPL001  (run time) No host coercion of a device value inside the hot
        path.  The reference's AST rule is about traced ``jnp`` values,
        which a torch port has none of; its torch meaning (``.item()``,
        ``bool()``, a copy to the host inside an iteration) is checked at
        run time by the sentinel (``analysis.sentinel``, and on a card
        ``torch.cuda.set_sync_debug_mode``) and by the dispatch audit
        (``analysis.dispatch_audit``).  No AST check.
RPL002  (run time) No Python control flow on a device value: the same
        run-time checks (a Python ``if`` on a tensor reads it on the
        host).  No AST check.
RPL003  Hardware constants are single-sourced in ``repro_torch.configs.hw``
        / ``repro_torch.configs.base``: a numeric literal >= 1e9 (bandwidth
        / flops magnitude) anywhere else is a drift-prone fork of the
        rates the bounds and the ledger price with.
RPL004  Null-object hot-loop guard: tracer/profiler annotation calls
        (``.instant`` / ``.complete`` / ``.observe_iter``) must sit under
        an ``enabled`` check.
RPL005  Routable tables mutate only through the staged-commit API
        (``commit`` / ``commit_layers``): direct assignment to ``.tables``
        / ``.rsets`` outside the managers desynchronizes serving from the
        migration protocol.
RPL006  Byte accounting stays integral: migration budgets, slab sizes and
        transfer counters are exact ``int`` end to end; a float creeping
        in (literal, true division, ``float()``) rounds a commit boundary.
        Analytic roofline estimates are exempt (``obs/ledger.py``).
RPL007  ``time.time()`` only in clock/bandwidth modules: interval
        measurements elsewhere use the injected engine clock or
        ``time.perf_counter()``.

Paths are scoped relative to the ``repro_torch`` package root; files
outside it (``chip_smoke.py``, ``tools/``) take every rule unscoped.
Escape hatch: append ``# repro-lint: disable=RPL00x`` (comma-separated
for several rules) to the offending line; suppressed findings are still
collected and reported separately, and carry a justification in the
surrounding comment.

CLI: ``python -m repro_torch.analysis.lint <paths> [--json]
[--show-suppressed]`` exits non-zero iff unsuppressed findings remain.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

RULES: Dict[str, str] = {
    "RPL001": "host coercion of a device value in hot-path code (run time)",
    "RPL002": "Python control flow on a device value (run time)",
    "RPL003": "hardware-magnitude literal outside repro_torch.configs",
    "RPL004": "tracer/profiler annotation without an `enabled` guard",
    "RPL005": "routable-table mutation outside the staged-commit API",
    "RPL006": "non-integral byte accounting",
    "RPL007": "time.time() outside clock/bandwidth modules",
}

#: the rules the AST visitor checks (RPL001/RPL002 are run-time checks)
AST_RULES = ("RPL003", "RPL004", "RPL005", "RPL006", "RPL007")
#: path suffixes (posix, relative) where a rule never fires
_RULE_SKIP: Dict[str, Tuple[str, ...]] = {
    # the single-source-of-truth modules themselves
    "RPL003": ("configs/hw.py", "configs/base.py"),
    # the null-object definitions (and their tests of themselves)
    "RPL004": ("obs/trace.py", "obs/profiler.py"),
    # the staged-commit API implementations
    "RPL005": ("placement/manager.py", "replication/manager.py"),
    # analytic roofline accounting prices FP4 at 4.25 bits/weight
    "RPL006": ("obs/ledger.py",),
    # the virtual/wall clock seam and the bandwidth EWMA wall-timer
    "RPL007": ("obs/trace.py", "placement/migrate.py"),
}

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9,\s]+)")
_BYTEISH_RE = re.compile(r"(^|_)n?bytes?($|_)")
_PROFILERISH_RE = re.compile(r"prof|trac|trc|telemetry", re.I)
# hardware magnitudes (bandwidths, flop rates) live in [1e9, 1e15);
# larger literals are numeric sentinels (1e30 attention masks), smaller
# ones are ordinary sizes.  These two define the rule's band, not a
# hardware constant:
_HW_LITERAL_MIN = 1e9   # repro-lint: disable=RPL003
_HW_LITERAL_MAX = 1e15  # repro-lint: disable=RPL003


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}{mark}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _name_chain(node: ast.AST) -> str:
    """Dotted source-ish text of a Name/Attribute chain ('' otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _test_mentions_enabled(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "enabled":
            return True
        if isinstance(n, ast.Name) and n.id == "enabled":
            return True
    return False


def _target_names(node: ast.AST) -> Iterable[str]:
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute):
        yield node.attr
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _target_names(elt)


def _value_is_floaty(node: ast.AST) -> Optional[str]:
    """Why a value expression breaks integral byte accounting (or None)."""
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div):
            return "true division (use // for byte counts)"
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "float":
            return "float() coercion"
        if isinstance(n, ast.Constant) and isinstance(n.value, float):
            return f"float literal {n.value!r}"
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rules: Sequence[str], findings: List[Finding],
                 path: str):
        self.rules = set(rules)
        self.findings = findings
        self.path = path
        self._if_stack: List[ast.AST] = []

    def _emit(self, rule: str, node: ast.AST, message: str):
        if rule in self.rules:
            self.findings.append(Finding(
                self.path, getattr(node, "lineno", 0),
                getattr(node, "col_offset", 0), rule, message))

    # -- guard-context tracking (RPL004) --------------------------------
    def visit_If(self, node: ast.If):
        self._if_stack.append(node.test)
        for child in node.body:
            self.visit(child)
        self._if_stack.pop()
        for child in node.orelse:
            self.visit(child)

    def _under_enabled_guard(self) -> bool:
        return any(_test_mentions_enabled(t) for t in self._if_stack)

    # -- assignments (RPL005, RPL006) -----------------------------------
    def _check_assign(self, node: ast.AST, targets: Sequence[ast.AST],
                      value: Optional[ast.AST]):
        for tgt in targets:
            if isinstance(tgt, ast.Attribute) \
                    and tgt.attr in ("tables", "rsets", "table", "rset"):
                self._emit("RPL005", node,
                           f"{RULES['RPL005']}: assign to `.{tgt.attr}` — "
                           "route mutations through manager.commit/"
                           "commit_layers")
            if value is not None:
                for name in _target_names(tgt):
                    if _BYTEISH_RE.search(name):
                        why = _value_is_floaty(value)
                        if why:
                            self._emit("RPL006", node,
                                       f"{RULES['RPL006']}: `{name}` "
                                       f"assigned from {why}")

    def visit_Assign(self, node: ast.Assign):
        self._check_assign(node, node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._check_assign(node, [node.target], node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_assign(node, [node.target], node.value)
        self.generic_visit(node)

    # -- calls (RPL004, RPL007) ----------------------------------------
    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            chain = _name_chain(func)
            # RPL007: wall clock
            if chain == "time.time":
                self._emit("RPL007", node,
                           f"{RULES['RPL007']}: use the injected engine "
                           "clock or time.perf_counter()")
            # RPL004: unguarded annotation work
            annot = func.attr in ("instant", "complete") or (
                func.attr == "observe_iter"
                and _PROFILERISH_RE.search(chain.rsplit(".", 1)[0]))
            if annot and not self._under_enabled_guard():
                self._emit("RPL004", node,
                           f"{RULES['RPL004']}: `{chain}()` runs "
                           "argument packing every iteration — wrap in "
                           "`if <tracer/profiler>.enabled:`")
        self.generic_visit(node)

    # -- RPL003: hardware literals --------------------------------------
    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool) \
                and _HW_LITERAL_MIN <= abs(node.value) < _HW_LITERAL_MAX:
            self._emit("RPL003", node,
                       f"{RULES['RPL003']}: literal {node.value!r} — "
                       "import it from repro_torch.configs.hw / "
                       "configs.base")
        self.generic_visit(node)


def _relpath(path: str) -> str:
    """Path relative to the `repro_torch` package root (posix), for
    scoping."""
    p = Path(path).as_posix()
    marker = "repro_torch/"
    i = p.rfind(marker)
    return p[i + len(marker):] if i >= 0 else p


def _active_rules(path: str) -> List[str]:
    rel = _relpath(path)
    return [rule for rule in AST_RULES
            if not any(rel.endswith(x) for x in _RULE_SKIP.get(rule, ()))]


def _apply_suppressions(findings: List[Finding], source: str) -> None:
    lines = source.splitlines()
    for f in findings:
        if 1 <= f.line <= len(lines):
            m = _DISABLE_RE.search(lines[f.line - 1])
            if m and f.rule in {r.strip() for r in m.group(1).split(",")}:
                f.suppressed = True


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one module's source; ``rules`` overrides path-based scoping."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        findings.append(Finding(path, e.lineno or 0, e.offset or 0,
                                "RPL000", f"syntax error: {e.msg}"))
        return findings
    active = list(rules) if rules is not None else _active_rules(path)
    _Visitor(active, findings, path).visit(tree)
    _apply_suppressions(findings, source)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint files and directory trees (``*.py``, recursively)."""
    findings: List[Finding] = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def summarize(findings: List[Finding]) -> Dict:
    """JSON-ready summary (the shape embedded in the invariant report)."""
    unsup = [f for f in findings if not f.suppressed]
    sup = [f for f in findings if f.suppressed]
    by_rule: Dict[str, int] = {}
    for f in unsup:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "files_ok": not unsup,
        "n_findings": len(unsup),
        "n_suppressed": len(sup),
        "by_rule": dict(sorted(by_rule.items())),
        "findings": [f.to_json() for f in unsup],
        "suppressed": [f.to_json() for f in sup],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's AST lint (rules RPL003-RPL007; RPL001 and "
                    "RPL002 are checked at run time)")
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON summary instead of text lines")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    unsup = [f for f in findings if not f.suppressed]
    if args.json:
        print(json.dumps(summarize(findings), indent=2))
    else:
        shown = findings if args.show_suppressed else unsup
        for f in shown:
            print(f.format())
        n_sup = len(findings) - len(unsup)
        print(f"{len(unsup)} finding(s), {n_sup} suppressed")
    return 1 if unsup else 0


if __name__ == "__main__":
    sys.exit(main())
