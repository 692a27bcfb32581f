"""The lint entry point: all three passes over the port's specs and source.

1. PTG/JDF dataflow verification (PTG1xx) over every module-level
   ``*_JDF`` string constant in the target files, cycle enumeration
   included (:mod:`.ptg_check`, :mod:`.dagenum`).
2. The body lint (BDY2xx) over the same specs' ``BODY [type=cuda]``
   code (:mod:`.body_check`).
3. The concurrency lint (LCK3xx) over modules declaring a
   ``_GUARDED_BY`` map (:mod:`.lock_check`).

Default targets: the specs of ``parsec_tpu_torch/ops`` and
``parsec_tpu_torch/collections``, and the whole ``parsec_tpu_torch/``
tree for the concurrency pass. ``--strict`` exits non-zero on any
error/warn finding::

    python -m parsec_tpu_torch.analysis --strict
    python -m parsec_tpu_torch.analysis path/to/specs.py --no-cycles
"""
from __future__ import annotations

import argparse
import ast as pyast
import os
import string
from typing import Any, Dict, List, Optional, Tuple

from . import Finding, body_check, gate, lock_check, ptg_check

#: the package root (parsec_tpu_torch/) and the repository root above it
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(PACKAGE_DIR)
#: default spec targets, relative to the package
SPEC_DIRS = ("ops", "collections")


def find_jdf_specs(path: str) -> List[Tuple[str, int, str]]:
    """Module-level ``NAME_JDF = \"...\"`` string constants in a .py
    file: [(spec_name, assign_lineno, text)]."""
    with open(path) as fh:
        src = fh.read()
    try:
        tree = pyast.parse(src)
    except SyntaxError:
        return []
    out = []
    for node in tree.body:
        if not isinstance(node, pyast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, pyast.Name) and t.id.endswith("_JDF")):
            continue
        if isinstance(node.value, pyast.Constant) and \
                isinstance(node.value.value, str):
            out.append((t.id, node.value.lineno, node.value.value))
    return out


def lint_spec_text(text: str, name: str,
                   enum_env: Optional[Dict[str, Any]] = None,
                   cycles: bool = True) -> List[Finding]:
    """All spec passes over one JDF text, parsed once."""
    from ..dsl.ptg.parser import JDFParseError, parse_jdf
    try:
        jdf = parse_jdf(text, name=name)
    except (JDFParseError, SyntaxError):
        # unparseable: verify_jdf_text re-parses only to classify the
        # failure into a PTG100/PTG101 finding
        return ptg_check.verify_jdf_text(text, name=name,
                                         enum_env=enum_env, cycles=cycles)
    findings = ptg_check.verify_jdf_text(text, name=name, enum_env=enum_env,
                                         cycles=cycles, jdf=jdf)
    findings.extend(body_check.check_jdf_bodies(jdf, name=name))
    return findings


def _rendered(text: str) -> str:
    """A spec kept as a ``str.format`` template (``{{``/``}}`` escapes
    around its bodies, a ``{dt}`` dtype field) is linted as its module
    instantiates it, every field bound to "float32"."""
    if "{{" not in text:
        return text
    fields = {f for _, f, _, _ in string.Formatter().parse(text) if f}
    return text.format(**{f: "float32" for f in fields})


def lint_spec_file(path: str, cycles: bool = True) -> List[Finding]:
    findings: List[Finding] = []
    rel = os.path.relpath(path, _ROOT)
    for _spec_name, lineno, text in find_jdf_specs(path):
        text = _rendered(text)
        # pad so Expr origins ("file:line task.flow") carry TRUE file
        # line numbers: string line k sits at file line (lineno - 1 + k)
        padded = "\n" * (lineno - 1) + text
        findings.extend(lint_spec_text(padded, name=rel, cycles=cycles))
    return findings


def default_spec_files() -> List[str]:
    files: List[str] = []
    for d in SPEC_DIRS:
        full = os.path.join(PACKAGE_DIR, d)
        files.extend(os.path.join(full, fn) for fn in sorted(os.listdir(full))
                     if fn.endswith(".py"))
    return files


def collect_targets(paths: List[str]) -> Tuple[List[str], List[str]]:
    """Resolve CLI targets into ``(spec_files, lock_targets)``; no
    ``paths`` means the defaults."""
    if not paths:
        return default_spec_files(), [PACKAGE_DIR]
    spec_files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                spec_files.extend(os.path.join(dirpath, f)
                                  for f in sorted(filenames)
                                  if f.endswith(".py"))
        else:
            spec_files.append(p)
    return spec_files, list(paths)


def run(paths: List[str], cycles: bool = True,
        locks: bool = True) -> List[Finding]:
    findings: List[Finding] = []
    spec_files, lock_targets = collect_targets(paths)
    for f in spec_files:
        findings.extend(lint_spec_file(f, cycles=cycles))
    if locks:
        for t in lock_targets:
            if os.path.isdir(t):
                findings.extend(lock_check.lint_tree(t))
            elif t.endswith(".py"):
                findings.extend(lock_check.lint_file(t))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parsec_tpu_torch.analysis",
        description="static analysis over the port's JDF specs and "
                    "parsec_tpu_torch/ source")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the specs of "
                         "parsec_tpu_torch/ops and collections, and "
                         "parsec_tpu_torch/)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any error/warn finding")
    ap.add_argument("--no-cycles", action="store_true",
                    help="skip the (slower) cycle-enumeration pass")
    ap.add_argument("--no-locks", action="store_true",
                    help="skip the concurrency lint")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary")
    args = ap.parse_args(argv)
    findings = run(args.paths, cycles=not args.no_cycles,
                   locks=not args.no_locks)
    for f in findings:
        print(f)
    gating = gate(findings)
    if not args.quiet:
        notes = len(findings) - len(gating)
        print(f"parsec_tpu_torch.analysis: {len(gating)} finding(s)"
              + (f", {notes} note(s)" if notes else "")
              + (" [strict]" if args.strict else ""))
    return 1 if (args.strict and gating) else 0
