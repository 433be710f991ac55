"""AST lint enforcing the spec-driven GEMM API contract across the port's
source — the port of ``repro.analysis.lint``, with the same codes and the
same waivers.

The spec-driven GEMM API has one load-bearing social contract: NOBODY
outside ``kernels/`` re-grows the pre-redesign call style.  These rules
make that machine-checked:

  SHIM_CALL      no ``masked_matmul`` / ``grouped_masked_matmul`` call
                 sites anywhere — the deprecated orchestrators are gone;
                 only the frozen-reference comparisons
                 (``ref.masked_matmul``, the plain oracle) stay allowed.
  LOOSE_KWARG    no caller outside ``kernels/`` threads the old loose
                 kwargs (``compact=``, ``queue_builder=``,
                 ``fuse_epilogue=``) through a call — schedule/queue/
                 epilogue selection belongs to ``SparsityPolicy`` /
                 ``GemmSpec`` construction only.
  CONV_FALLBACK  a dense conv (``torch.nn.functional.conv2d``,
                 ``F.conv2d``, ``torch.conv2d``, ``torch.convolution``, the
                 counterparts of ``lax.conv_general_dilated``) may appear
                 only in a function that also counts it
                 (``stats.record("conv:dense_fallback")``) — the
                 engine-escape hatch must stay auditable.
  STATS_KEY      literal ``stats.record`` keys must parse into the known
                 families; ``gemm:`` keys must be the normalized
                 ``gemm:<schedule>:<g>`` launch form.

``lint_source`` lints one source string (the mutation self-tests plant
violations through it); ``lint_paths`` walks directories.

A sanctioned exception is waived IN PLACE with ``# repro-lint: allow(CODE)``
on the flagged line or the line above it — e.g. a benchmark's dense
``F.conv2d`` reference oracle.  Waivers are rule-specific so a
waived line stays covered by every other rule.
"""
from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Sequence

from .report import Violation

SHIM_NAMES = {"masked_matmul", "grouped_masked_matmul"}
# Attribute bases under which a shim-spelled call is the REFERENCE oracle,
# not the deprecated orchestrator (kernels/ref.py's plain comparators).
REF_BASES = {"ref", "kref"}
LOOSE_KWARGS = {"compact", "queue_builder", "fuse_epilogue"}
# Call targets that legitimately take the "loose" names as constructor /
# replace fields: policy and spec construction IS the sanctioned home.
SPEC_CALLEES = {"SparsityPolicy", "GemmSpec", "with_", "replace",
                "gemm_spec", "dataclasses.replace"}
# Dense convs: (callee base, name) pairs, the port's lax.conv_general_dilated.
CONV_CALLS = {("F", "conv2d"), ("functional", "conv2d"), ("torch", "conv2d"),
              ("torch", "convolution")}
KNOWN_KEY_HEADS = {"encode", "scan", "scan_pallas", "emit", "queue", "gemm",
                   "conv",
                   # runtime guard layer (runtime/guards.py):
                   "guard", "registry", "fallback",
                   # data-parallel collectives (sharding/collectives.py):
                   "collective",
                   # legacy heads normalized by stats._KEY_ALIASES:
                   "mm", "gmm", "grouped_mm"}
FALLBACK_KEY = "conv:dense_fallback"
_ALLOW_RE = re.compile(r"repro-lint:\s*allow\(([A-Z_, ]+)\)")


def _waivers(code: str):
    """{(rule, lineno)} suppressed by ``# repro-lint: allow(RULE)`` markers
    (a marker covers its own line and the one below it)."""
    out = set()
    for lineno, line in enumerate(code.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            for rule in m.group(1).replace(",", " ").split():
                out.add((rule, lineno))
                out.add((rule, lineno + 1))
    return out


def _callee_parts(func: ast.expr) -> List[str]:
    """Dotted name parts of a call target, innermost last; [] if dynamic."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _record_key(call: ast.Call) -> Optional[str]:
    """The literal key of a ``stats.record(...)`` call, else None."""
    parts = _callee_parts(call.func)
    if not parts or parts[-1] != "record":
        return None
    if len(parts) >= 2 and parts[-2] not in ("stats",):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


class _FunctionIndex(ast.NodeVisitor):
    """Maps every node to its innermost enclosing function def."""

    def __init__(self):
        self.owner = {}
        self._stack: List[ast.AST] = []

    def generic_visit(self, node):
        if self._stack:
            self.owner[node] = self._stack[-1]
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        if is_fn:
            self._stack.append(node)
        super().generic_visit(node)
        if is_fn:
            self._stack.pop()


def lint_source(code: str, path: str = "<string>",
                in_kernels: Optional[bool] = None) -> List[Violation]:
    """Lint one source file's text.  ``in_kernels`` overrides the
    kernels/-exemption detection (derived from ``path`` by default)."""
    if in_kernels is None:
        norm = path.replace(os.sep, "/")
        in_kernels = "/kernels/" in norm or norm.startswith("kernels/")
    try:
        tree = ast.parse(code)
    except SyntaxError as e:
        return [Violation("lint", "SYNTAX", f"{path}:{e.lineno}", str(e))]

    idx = _FunctionIndex()
    idx.visit(tree)
    waived = _waivers(code)

    # Pre-index: per enclosing function, the literal stats.record keys.
    fn_keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            key = _record_key(node)
            if key is not None:
                fn_keys.setdefault(idx.owner.get(node), set()).add(key)

    out: List[Violation] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        where = f"{path}:{node.lineno}"
        parts = _callee_parts(node.func)
        name = parts[-1] if parts else ""
        base = parts[-2] if len(parts) >= 2 else ""

        # SHIM_CALL — deleted-orchestrator call site (no kernels/ allowance:
        # the shims are gone, so such a call breaks at runtime anywhere)
        if name in SHIM_NAMES and base not in REF_BASES \
                and ("SHIM_CALL", node.lineno) not in waived:
            out.append(Violation(
                "lint", "SHIM_CALL", where,
                f"call to removed kernels.ops.{name}; build a GemmSpec "
                f"and call sparse_gemm"))

        # LOOSE_KWARG — pre-redesign kwargs threaded outside kernels/
        if not in_kernels and name not in SPEC_CALLEES \
                and ("LOOSE_KWARG", node.lineno) not in waived:
            loose = sorted(kw.arg for kw in node.keywords
                           if kw.arg in LOOSE_KWARGS)
            if loose:
                out.append(Violation(
                    "lint", "LOOSE_KWARG", where,
                    f"{', '.join(loose)} passed to {name or '<dynamic>'}(); "
                    f"schedule/queue/epilogue selection belongs to "
                    f"SparsityPolicy/GemmSpec"))

        # CONV_FALLBACK — dense conv without the counted escape hatch
        if (base, name) in CONV_CALLS \
                and ("CONV_FALLBACK", node.lineno) not in waived:
            keys = fn_keys.get(idx.owner.get(node), set())
            if FALLBACK_KEY not in keys:
                out.append(Violation(
                    "lint", "CONV_FALLBACK", where,
                    f"{'.'.join(parts)} outside the counted fallback "
                    f"(enclosing function never records {FALLBACK_KEY!r})"))

        # STATS_KEY — literal counter keys must be well-formed
        key = _record_key(node)
        if key is not None \
                and ("STATS_KEY", node.lineno) not in waived:
            head, _, tail = key.partition(":")
            bad = head not in KNOWN_KEY_HEADS
            if not bad and head == "gemm":
                sched, _, g = tail.partition(":")
                bad = sched not in ("predicated", "compact", "dense") \
                    or not g.isdigit()
            if bad:
                out.append(Violation(
                    "lint", "STATS_KEY", where,
                    f"stats.record key {key!r} not in the normalized "
                    f"families (kernels/stats.py docstring)"))
    return out


def lint_paths(paths: Sequence[str],
               exclude: Sequence[str] = ()) -> List[Violation]:
    """Lint every ``*.py`` under the given files/directories."""
    out: List[Violation] = []
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, _dirs, names in os.walk(p):
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    for f in sorted(files):
        norm = f.replace(os.sep, "/")
        if any(e in norm for e in exclude):
            continue
        with open(f, encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), f))
    return out
