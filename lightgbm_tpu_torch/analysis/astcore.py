"""The AST machinery conlint stands on: per-file context, findings,
suppression comments and the baseline helpers.

The port's own copy of what ``lightgbm_tpu/analysis/concurrency.py``
imports from ``lightgbm_tpu/analysis/jaxlint.py`` (``FileContext``,
``Finding``, ``FuncInfo``, ``iter_py_files``, ``load_baseline_records``)
and from ``lightgbm_tpu/analysis/rules.py`` (``callee_chain``). The jit
scope resolution and the JL001-JL005 rules are the JAX package's and
are not copied: they audit traced JAX code, of which the port has none.

Suppression: ``# conlint: disable=CL002[,CL003]`` (or ``disable=all``) on
the flagged line, in the comment block directly above it, on the first
line of the enclosing statement or on the enclosing ``def`` line. The
``jaxlint:`` tag works too: one regex serves both, so a suppression reads
the same in both packages.

Findings fingerprint on (file, rule, scope qualname, normalized source
line, occurrence), so a baseline survives unrelated line drift.

Pure stdlib.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

# capture only the comma-separated rule list so a plain-word reason after
# it ("# conlint: disable=CL002 deliberate") can't swallow the token
_SUPPRESS_RE = re.compile(
    r"#\s*(?:jax|con)lint:\s*disable="
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")


def callee_chain(func: ast.AST) -> str:
    """Dotted name of a call target ("np.asarray", "torch.cuda.synchronize",
    "float"); empty string when the target is not a plain name/attribute
    chain."""
    parts = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        # rooted at a call/subscript (e.g. get_timer().section): keep the
        # attribute tail so attr-based rules still see it
        parts.append("")
    return ".".join(reversed(parts))


@dataclass
class FuncInfo:
    node: ast.AST                 # FunctionDef / AsyncFunctionDef / Lambda
    qualname: str
    def_line: int
    is_lambda: bool = False


@dataclass
class Finding:
    rule: str
    path: str                     # repo-relative posix path
    line: int
    col: int
    scope: str
    message: str
    line_text: str
    occ: int = 0                  # disambiguates identical lines in a scope

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.path, self.rule, self.scope,
                        self.line_text.strip(), str(self.occ)))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}")


class FileContext:
    """Everything the rule visitors need about one source file: its
    functions by qualified name, each node's parent, the suppression
    comments, and the occurrence counts behind stable fingerprints."""

    def __init__(self, rel: str, src: str, tree: ast.Module):
        self.rel = rel
        self.src = src
        self.tree = tree
        self.lines = src.splitlines()
        self.suppressions = _collect_suppressions(self.lines)
        self.all_funcs: List[FuncInfo] = []
        self._by_name: Dict[str, List[FuncInfo]] = {}
        self._func_of_node: Dict[int, FuncInfo] = {}
        self._parents: Dict[int, ast.AST] = {}
        self._collect_funcs()
        self._occ_seen: Dict[Tuple, int] = {}

    def _collect_funcs(self) -> None:
        def walk(node, qual):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    name = getattr(child, "name", "<lambda>")
                    q = f"{qual}.{name}" if qual else name
                    fi = FuncInfo(
                        node=child, qualname=q, def_line=child.lineno,
                        is_lambda=isinstance(child, ast.Lambda))
                    self.all_funcs.append(fi)
                    self._by_name.setdefault(name, []).append(fi)
                    self._func_of_node[id(child)] = fi
                    walk(child, q)
                elif isinstance(child, ast.ClassDef):
                    q = f"{qual}.{child.name}" if qual else child.name
                    walk(child, q)
                else:
                    walk(child, qual)
        walk(self.tree, "")

    def enclosing(self, node: ast.AST) -> Optional[FuncInfo]:
        cur = node
        while cur is not None:
            fi = self._func_of_node.get(id(cur))
            if fi is not None:
                return fi
            cur = self._parents.get(id(cur))
        return None

    def _comment_only(self, line: int) -> bool:
        return (0 < line <= len(self.lines) and
                self.lines[line - 1].lstrip().startswith("#"))

    def _suppressed(self, rule: str, anchor: int) -> bool:
        """Disable comment on the anchor line, or in the contiguous
        comment block directly above it."""
        def hit(line: int) -> bool:
            sup = self.suppressions.get(line)
            return bool(sup and ("all" in sup or rule in sup))

        if hit(anchor):
            return True
        ln = anchor - 1
        while ln > 0 and self._comment_only(ln):
            if hit(ln):
                return True
            ln -= 1
        return False

    def finding(self, rule: str, node: ast.AST, fi: Optional[FuncInfo],
                message: str) -> Optional[Finding]:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        # suppression anchors: the flagged line, the first line of the
        # enclosing statement (multi-line calls), and the enclosing def
        # line (whole-function suppression); each anchor also honors a
        # comment block directly above it
        stmt = node
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = self._parents.get(id(stmt))
        anchors = {line}
        if stmt is not None:
            anchors.add(stmt.lineno)
        if fi is not None:
            anchors.add(fi.def_line)
        text = (self.lines[line - 1] if 0 < line <= len(self.lines)
                else "")
        scope = fi.qualname if fi else "<module>"
        # count the occurrence BEFORE the suppression check: suppressing
        # one of two identical flagged lines must not re-key the
        # survivor's occ (baseline fingerprints stay stable)
        key = (rule, scope, text.strip())
        occ = self._occ_seen.get(key, 0)
        self._occ_seen[key] = occ + 1
        for anchor in anchors:
            if self._suppressed(rule, anchor):
                return None
        return Finding(rule=rule, path=self.rel, line=line, col=col,
                       scope=scope, message=message, line_text=text,
                       occ=occ)


def _collect_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, ln in enumerate(lines, 1):
        m = _SUPPRESS_RE.search(ln)
        if m:
            out[i] = {tok.strip().upper() if tok.strip().lower() != "all"
                      else "all"
                      for tok in m.group(1).split(",") if tok.strip()}
    return out


def iter_py_files(paths) -> List[str]:
    files = []
    for p in paths:
        if os.path.isdir(p):
            for base, _dirs, fns in os.walk(p):
                if "__pycache__" in base:
                    continue
                for fn in sorted(fns):
                    if fn.endswith(".py"):
                        files.append(os.path.join(base, fn))
        elif p.endswith(".py"):
            files.append(p)
    return files


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline_records(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("findings", ()))


def diff_against_baseline(findings: List[Finding], baseline: Set[str]
                          ) -> Tuple[List[Finding], List[Finding]]:
    """-> (new, known)"""
    new, known = [], []
    for f in findings:
        (known if f.fingerprint in baseline else new).append(f)
    return new, known
