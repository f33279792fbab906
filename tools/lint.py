#!/usr/bin/env python
"""Zero-dependency linter — the scalastyle analog (reference:
scalastyle-config.xml:1, project/plugins.sbt:3).

This image ships no ruff/flake8 and installs are off-limits, so the rules
a CI ruff run would enforce (config lives in pyproject.toml
[tool.ruff] for environments that have it) are checked here with ast +
text scans:

  E999  syntax error
  E501  line longer than 88 columns (``# noqa: E501`` exempts a line)
  W291  trailing whitespace
  W191  tab in indentation
  F401  imported name never used (module files only; __init__.py
        re-export surfaces are exempt, as under ruff's
        ignore-init-module-imports)

Exit 0 = clean.  Usage: python tools/lint.py [paths...]
"""

from __future__ import annotations

import ast
import os
import re
import sys

LINE_LIMIT = 88
DEFAULT_TARGETS = ["apsim", "tests", "tools", "bench.py",
                   "__graft_entry__.py"]


def iter_py(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def unused_imports(tree: ast.AST, text: str) -> list:
    """F401, conservatively: a bound import name that never appears as a
    word anywhere else in the file (so names used in strings/docstrings
    or re-exported via __all__ strings don't false-positive)."""
    out = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                names.append((a.asname or a.name.split(".")[0], a.name))
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "*":
                    continue
                names.append((a.asname or a.name, a.name))
        for bound, orig in names:
            uses = len(re.findall(rf"\b{re.escape(bound)}\b", text))
            if uses <= 1:  # the import statement itself
                out.append((node.lineno, f"F401 unused import {orig!r}"))
    return out


def lint_file(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    errs = []
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [(e.lineno or 0, f"E999 syntax error: {e.msg}")]
    for i, line in enumerate(text.splitlines(), 1):
        if len(line) > LINE_LIMIT and "# noqa: E501" not in line:
            errs.append((i, f"E501 line too long ({len(line)} > "
                            f"{LINE_LIMIT})"))
        if line != line.rstrip():
            errs.append((i, "W291 trailing whitespace"))
        indent = line[: len(line) - len(line.lstrip())]
        if "\t" in indent:
            errs.append((i, "W191 tab in indentation"))
    if os.path.basename(path) != "__init__.py":
        errs.extend(unused_imports(tree, text))
    return sorted(errs)


def main(argv) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    targets = argv[1:] or [os.path.join(here, t) for t in DEFAULT_TARGETS]
    n_files = 0
    n_errs = 0
    for path in iter_py(targets):
        n_files += 1
        for lineno, msg in lint_file(path):
            rel = os.path.relpath(path, here)
            print(f"{rel}:{lineno}: {msg}")
            n_errs += 1
    print(f"lint: {n_files} files, {n_errs} findings", file=sys.stderr)
    return 1 if n_errs else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
