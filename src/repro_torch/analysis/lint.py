"""drlint CLI — run the port's capture invariants over source trees.

Usage::

    python -m repro_torch.analysis.lint [paths ...] [--fail-on-violation]
    python -m repro_torch.analysis.lint --list-rules

With no paths, lints the `repro_torch` package source tree (the
`src/repro_torch` this module was imported from). Output is one
``path:line:col: rule message`` line per violation — the format
editors and pre-commit hooks parse — and the exit code is nonzero
when any unsuppressed violation is found (``--fail-on-violation`` is
accepted for explicitness in CI scripts; the behavior is the default).

Runs on the AST only: it imports nothing of the code it checks. See
`repro_torch.analysis.rules` for the rule registry and the
suppression-comment syntax.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Iterable, Sequence

from repro_torch.analysis.rules import RULES, Violation, lint_source


def iter_python_files(paths: Iterable[str]) -> list[pathlib.Path]:
    files: list[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
        else:
            raise FileNotFoundError(f"not a python file or directory: {p}")
    return files


def lint_paths(paths: Iterable[str]) -> list[Violation]:
    """Lint every .py file under `paths`; returns unsuppressed violations."""
    out: list[Violation] = []
    for f in iter_python_files(paths):
        out.extend(lint_source(str(f), f.read_text()))
    return out


def _default_paths() -> list[str]:
    return [str(pathlib.Path(__file__).resolve().parents[1])]


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="drlint: the port's CUDA-graph capture invariants "
                    "as an AST pass")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "repro_torch package tree)")
    ap.add_argument("--fail-on-violation", action="store_true",
                    help="exit 1 on violations (the default; the flag "
                         "documents intent in CI scripts)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        width = max(len(n) for n in RULES)
        for name in sorted(RULES):
            print(f"{name:<{width}}  {RULES[name].summary}")
        return 0
    violations = lint_paths(args.paths or _default_paths())
    for v in violations:
        print(v.format())
    n = len(violations)
    print(f"drlint: {n} violation{'s' if n != 1 else ''} "
          f"({len(RULES)} rules)", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
