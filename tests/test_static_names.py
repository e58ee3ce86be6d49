"""Static undefined-global guard (mini-pyflakes; the environment ships no
linter).  Regression guard for the class of bug where a module-level name
is referenced on a rarely-traced branch without being imported — e.g.
parallel/sharded.py's vote branch once used ``graphvote`` without
importing it, so every MappingConfig.vote_mode != 'off' crashed at trace
time on the sharded path only (fixed in 44bf3d4).

Scope-blind by design: it collects ALL bindings anywhere in a module
(imports, defs, params, assignments, lambda args, except names) and
flags Name loads bound nowhere.  That misses shadowing mistakes but has
zero false positives on this codebase, which is the right trade for a
hard test gate.
"""

import ast
import builtins
from pathlib import Path

BUILTINS = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__builtins__", "__loader__",
}

REPO = Path(__file__).resolve().parent.parent


def _bindings(tree):
    bound = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                bound.add((a.asname or a.name).split(".")[0])
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            bound.add(node.name)
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            ar = node.args
            for p in (
                ar.posonlyargs + ar.args + ar.kwonlyargs
                + ([ar.vararg] if ar.vararg else [])
                + ([ar.kwarg] if ar.kwarg else [])
            ):
                bound.add(p.arg)
        if isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
        if isinstance(node, ast.Name) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            bound.add(node.id)
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            bound.update(node.names)
    return bound


def _undefined_in(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    bound = _bindings(tree) | BUILTINS
    return [
        f"{path.relative_to(REPO)}:{n.lineno}: undefined name '{n.id}'"
        for n in ast.walk(tree)
        if isinstance(n, ast.Name)
        and isinstance(n.ctx, ast.Load)
        and n.id not in bound
    ]


def test_no_undefined_globals():
    findings = []
    roots = [REPO / "light_loam_tpu", REPO / "tests"]
    files = [
        p
        for root in roots
        for p in sorted(root.rglob("*.py"))
        if "__pycache__" not in p.parts
    ]
    files += [
        REPO / n
        for n in ("bench.py", "bench_accuracy.py", "bench_scaling.py",
                  "chip_smoke.py", "__graft_entry__.py", "setup.py",
                  "scripts/ab_backends.py")
    ]
    for f in files:
        findings += _undefined_in(f)
    assert not findings, "\n".join(findings)
