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
error/warn finding; ``--lower-report`` prints the stage compiler's
verdicts instead (stagec/: per class, per stage, per chain boundary)
and exits 0::

    python -m parsec_tpu_torch.analysis --strict
    python -m parsec_tpu_torch.analysis path/to/specs.py --no-cycles
    python -m parsec_tpu_torch.analysis --lower-report
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


def _toy_taskpool(text: str, name: str, shared_colls: Dict[str, Any]):
    """A small concrete instantiation of one spec for per-stage
    planning (the cycle pass's enumeration env): int globals bind to the
    tile count, collection globals bind to dummy 4x4 holders SHARED by
    name across the file's specs — the chain planner proves dataflow
    by collection IDENTITY, exactly as sequential pools share real
    collections (dpotrf's descA is dtrsm's descL)."""
    from ..dsl import ptg
    from .dagenum import _DummyCollection
    factory = ptg.compile_jdf(text, name=name)
    env = ptg_check.default_enum_env(factory.jdf)
    for g in factory.jdf.globals:
        if g.properties.get("type") == "collection":
            env[g.name] = shared_colls.setdefault(
                g.name, _DummyCollection(4, 4))
    return factory.new(**env)


def _prepared_toy_plan(tp):
    """plan_stages + layouts for the chain verdicts (the runtime's
    prepared_plan without its cache: toy pools are throwaway)."""
    from ..stagec.lower import build_layout
    from ..stagec.plan import plan_stages
    plan = plan_stages(tp)
    for stage in plan.stages:
        plan.prepared.append((stage, build_layout(tp, plan, stage), 0))
    return plan


def lower_report_main(paths: List[str], quiet: bool = False) -> int:
    """``--lower-report``: the stage compiler's verdicts (stagec/plan —
    the SAME passes the runtime partitions with, so what this prints is
    what ``stage_compile`` will and won't fuse) over every ``*_JDF``
    spec in the targets:

    - per-CLASS lowerability (compilable / fallback + the reason);
    - per-STAGE partition of a small concrete instantiation (stage
      sizes, level spans, class mix, residue split + pre-planned
      residue groups);
    - for files holding several specs, the CHAIN verdict of each
      consecutive pair — fusable, or the reason two pools fail to fuse
      (stagec/chain.boundary_verdict).

    Exit 0 always: the report is informational — residue classes run
    interpreted, unchained pools hand tiles over between pools; neither
    is an error."""
    from ..dsl.ptg.parser import JDFParseError, parse_jdf
    from ..stagec.chain import _stage_verdict, boundary_verdict
    from ..stagec.plan import lower_report, stage_report

    files, _lock_targets = collect_targets(paths)
    n_specs = 0
    for path in files:
        rel = os.path.relpath(path, _ROOT) if path.startswith(_ROOT) \
            else path
        shared_colls: Dict[str, Any] = {}
        planned = []   # [(spec_name, tp, StagePlan)] for chain verdicts
        for spec_name, _lineno, text in find_jdf_specs(path):
            n_specs += 1
            text = _rendered(text)
            try:
                jdf = parse_jdf(text, name=f"{rel}:{spec_name}")
            except (JDFParseError, SyntaxError) as exc:
                print(f"{rel}:{spec_name}: unparseable ({exc})")
                continue
            for line in lower_report(jdf):
                print(line)
            try:
                tp = _toy_taskpool(text, spec_name, shared_colls)
                plan = _prepared_toy_plan(tp)
                for line in stage_report(tp, plan=plan):
                    print(line)
                planned.append((spec_name, tp, plan))
            except Exception as exc:  # noqa: BLE001 - informational
                print(f"  (stage partition not enumerable: "
                      f"{type(exc).__name__}: {exc})")
        # chain verdicts over consecutive specs of the same file (the
        # declared-sequence analog: dtrsm.py's FWD ; BWD), walking the
        # SAME cumulative segments declare_chain builds — a boundary is
        # proven against every pool already fused into the segment, so
        # the report cannot claim a cascade the runtime would reject
        seg = []   # [(tp, plan, fused member-key set)], host first
        for (na, tpa, pa), (nb_, tpb, pb) in zip(planned, planned[1:]):
            if not seg:
                if pa is None or not pa.stages:
                    print(f"  chain {na} -> {nb_}: rejected — no "
                          f"compilable final stage in the earlier pool")
                    continue
                seg = [(tpa, pa, set(pa.stages[-1].member_keys))]
            reason = boundary_verdict(seg, tpb, pb)
            if reason is not None:
                print(f"  chain {na} -> {nb_}: rejected — {reason}")
                seg = []
                continue
            # walk the fusable stage PREFIX exactly like declare_chain:
            # stage 0 memory-fed, later stages bound to already-fused
            # producers
            fused_b, eavail_b = set(), set()
            n_fused = 0
            for (stage_k, layout_k, _prio) in pb.prepared:
                if n_fused:
                    v = _stage_verdict(seg, tpb, pb, stage_k, layout_k,
                                       fused_b, eavail_b)
                    if isinstance(v, str):
                        break
                n_fused += 1
                fused_b |= stage_k.member_keys
                eavail_b.update(layout_k.edge_outs)
            print(f"  chain {na} -> {nb_}: fusable ({n_fused}/"
                  f"{len(pb.stages)} stage(s) in-program)")
            if n_fused == len(pb.stages):
                seg.append((tpb, pb, fused_b))
            else:
                seg = []   # segment ends; the next pool hosts anew
    if not quiet:
        print(f"parsec_tpu_torch.analysis --lower-report: {n_specs} "
              f"spec(s)")
    return 0


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
    ap.add_argument("--lower-report", action="store_true",
                    help="stage-compile lowerability report (stagec/): "
                         "per class compilable / fallback + the "
                         "BDY2xx/PTG1xx/STG3xx reason, the per-stage "
                         "partition of a toy instance, and the chain "
                         "verdict of consecutive specs; exits 0")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary")
    args = ap.parse_args(argv)
    if args.lower_report:
        return lower_report_main(args.paths, quiet=args.quiet)
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
