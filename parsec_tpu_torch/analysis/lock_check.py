"""Runtime concurrency lint: declared lock discipline over parsec_tpu_torch/.

A module opts in by declaring a ``_GUARDED_BY`` map at module level
(the clang ``GUARDED_BY`` annotation, as data):

    _GUARDED_BY = {
        "Data._copies": "_lock",      # Class.field -> lock attr on the
        "_Peer.ctrl":   "cond",       # same receiver object
    }

Rules enforced (LCK3xx):

- ``LCK301`` unguarded-field: an attribute access ``<recv>.<field>``
  where ``field`` is registered must be lexically inside
  ``with <recv>.<lock>:`` (same receiver expression).  ``Class.field``
  keys bind ``self.field`` accesses inside that class; accesses through
  any other simple receiver name match by field name.
- ``LCK302`` blocking-while-locked: no blocking call (``time.sleep``,
  socket send/recv/accept/connect, ``select``, thread ``join``,
  ``wait``/``wait_for`` on anything but the held condition) while a
  declared lock is held.  ``Condition.wait`` on the *held* condition is
  exempt — it releases the lock.
- ``LCK303`` unregistered-lock: in a module that declares a
  ``_GUARDED_BY`` map (even an empty one), every
  ``threading.Lock/RLock/Condition/Semaphore`` construction must be
  registered as some field's lock in the map.  This is what makes an
  empty map a *contract* rather than a no-op: adding a lock to an
  audited-lock-free module fails the gate until its fields are
  declared.

Holding is established by (a) an enclosing ``with <recv>.<lock>:``,
(b) a ``<recv>.<lock>.acquire(...)`` call earlier in the same function
(the try/finally-release manager pattern), or (c) a ``# holds:
<recv>.<lock>`` annotation on the ``def`` line — the clang
``REQUIRES()`` analog for helpers documented as called-with-lock-held.

Escapes, used sparingly and always with a reason:

- ``__init__`` / ``__new__`` / ``__del__`` / ``_destruct`` bodies are
  exempt (single-owner construction/teardown).
- a trailing ``# lock: <reason>`` comment waives one line (the TSan
  benign-race annotation analog);
- a ``# lock: exempt(<reason>)`` comment on a ``def`` line waives the
  whole function (teardown paths quiesced by protocol).

Modules without a ``_GUARDED_BY`` map are skipped — the lint is a
contract checker, not a race detector.
"""
from __future__ import annotations

import ast as pyast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding

_EXEMPT_FUNCS = {"__init__", "__new__", "__del__", "_destruct"}
_BLOCKING_SOCKET = {"sendall", "sendmsg", "recv", "recv_into", "accept",
                    "connect", "sendto", "recvfrom"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _attr_chain(node: pyast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, pyast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, pyast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _find_guarded_by(tree: pyast.Module) -> Optional[Dict[str, str]]:
    for node in tree.body:
        if isinstance(node, pyast.Assign):
            for t in node.targets:
                if isinstance(t, pyast.Name) and t.id == "_GUARDED_BY":
                    try:
                        val = pyast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return None
                    return val if isinstance(val, dict) else None
        elif isinstance(node, pyast.AnnAssign) and \
                isinstance(node.target, pyast.Name) and \
                node.target.id == "_GUARDED_BY" and node.value is not None:
            try:
                val = pyast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
            return val if isinstance(val, dict) else None
    return None


class _FieldRules:
    """field name -> [(class or None, lock attr)]"""

    def __init__(self, guarded_by: Dict[str, str]) -> None:
        self.by_field: Dict[str, List[Tuple[Optional[str], str]]] = {}
        self.lock_names: Set[str] = set(guarded_by.values())
        for key, lock in guarded_by.items():
            cls, _, fld = key.rpartition(".")
            self.by_field.setdefault(fld, []).append((cls or None, lock))

    def lock_for(self, field: str, recv: str,
                 enclosing_class: Optional[str]) -> Optional[str]:
        """The lock attr required for this access, or None if the field
        is not governed for this receiver."""
        rules = self.by_field.get(field)
        if not rules:
            return None
        if recv == "self":
            for cls, lock in rules:
                if cls is None or cls == enclosing_class:
                    return lock
            return None
        # non-self receiver: class unknown statically — any rule for the
        # field name applies (module-scoped maps keep this unambiguous)
        return rules[0][1]


class _FuncLinter(pyast.NodeVisitor):
    """Lint one function body with lexical lock tracking."""

    def __init__(self, rules: _FieldRules, lines: Sequence[str],
                 where_prefix: str, enclosing_class: Optional[str],
                 base_held: Set[str], findings: List[Finding]) -> None:
        self.rules = rules
        self.lines = lines
        self.where = where_prefix
        self.cls = enclosing_class
        self.held: Set[str] = set(base_held)
        self.findings = findings

    # -- helpers -------------------------------------------------------
    def _line_comment(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            idx = line.find("#")
            if idx >= 0:
                return line[idx:]
        return ""

    def _waived(self, node: pyast.AST) -> bool:
        return "# lock:" in self._line_comment(getattr(node, "lineno", 0))

    def _lock_expr(self, node: pyast.AST) -> Optional[str]:
        """Normalize a with-context / acquire receiver to 'recv.attr'."""
        chain = _attr_chain(node)
        if len(chain) >= 2:
            return ".".join(chain)
        return None

    # -- lock tracking -------------------------------------------------
    def visit_With(self, node: pyast.With) -> None:
        added: Set[str] = set()
        for item in node.items:
            lk = self._lock_expr(item.context_expr)
            if lk is not None and lk not in self.held:
                added.add(lk)
        self.held |= added
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    # nested defs/lambdas run later, without the current locks
    def visit_FunctionDef(self, node) -> None:
        _lint_function(node, self.rules, self.lines, self.where, self.cls,
                       self.findings)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: pyast.Lambda) -> None:
        pass

    # -- the two rules -------------------------------------------------
    def _held_lock_names(self) -> Set[str]:
        return {h.rpartition(".")[2] for h in self.held}

    def visit_Call(self, node: pyast.Call) -> None:
        # acquire() heuristic: held for the remainder of the function
        # (the try/finally-release manager pattern)
        chain = _attr_chain(node.func)
        if chain and chain[-1] == "acquire" and len(chain) >= 3:
            self.held.add(".".join(chain[:-1]))
        elif chain and chain[-1] == "release" and len(chain) >= 3:
            self.held.discard(".".join(chain[:-1]))
        elif chain and not self._waived(node) and \
                self._held_lock_names() & self.rules.lock_names:
            self._check_blocking(node, chain)
        self.generic_visit(node)

    def _check_blocking(self, node: pyast.Call, chain: List[str]) -> None:
        last = chain[-1]
        blocking = None
        if chain in (["time", "sleep"], ["sleep"]):
            blocking = "sleep"
        elif chain == ["select", "select"]:
            blocking = "select"
        elif last in _BLOCKING_SOCKET:
            blocking = f"socket .{last}()"
        elif last == "join" and len(chain) >= 2:
            blocking = ".join()"
        elif last in ("wait", "wait_for") and len(chain) >= 2:
            recv = ".".join(chain[:-1])
            if recv not in self.held:
                blocking = f".{last}() on a lock/event not held here"
        if blocking is not None:
            held = ", ".join(sorted(
                h for h in self.held
                if h.rpartition(".")[2] in self.rules.lock_names))
            self.findings.append(Finding(
                "LCK302",
                f"blocking call ({blocking}: {'.'.join(chain)}) while "
                f"holding {held}",
                f"{self.where}:{node.lineno}"))

    def visit_Attribute(self, node: pyast.Attribute) -> None:
        if isinstance(node.ctx, (pyast.Load, pyast.Store, pyast.Del)):
            recv_chain = _attr_chain(node.value)
            if len(recv_chain) == 1:
                recv = recv_chain[0]
                lock = self.rules.lock_for(node.attr, recv, self.cls)
                if lock is not None:
                    need = f"{recv}.{lock}"
                    if need not in self.held and not self._waived(node):
                        self.findings.append(Finding(
                            "LCK301",
                            f"{recv}.{node.attr} is guarded by {need} "
                            f"(_GUARDED_BY) but accessed without it",
                            f"{self.where}:{node.lineno}"))
        self.generic_visit(node)


def _def_annotations(node, lines: Sequence[str]) -> Tuple[Set[str], bool]:
    """(# holds: locks, whole-function waiver) from the def line(s)."""
    held: Set[str] = set()
    exempt = False
    end = getattr(node.body[0], "lineno", node.lineno) if node.body \
        else node.lineno
    for ln in range(node.lineno, end + 1):
        if not (1 <= ln <= len(lines)):
            continue
        line = lines[ln - 1]
        idx = line.find("#")
        if idx < 0:
            continue
        comment = line[idx:]
        if "# lock: exempt" in comment:
            exempt = True
        hidx = comment.find("# holds:")
        if hidx >= 0:
            spec = comment[hidx + len("# holds:"):].strip()
            for part in spec.split(","):
                part = part.strip()
                if part:
                    held.add(part)
    return held, exempt


def _lint_function(node, rules: _FieldRules, lines: Sequence[str],
                   where_prefix: str, enclosing_class: Optional[str],
                   findings: List[Finding]) -> None:
    if node.name in _EXEMPT_FUNCS:
        return
    base_held, exempt = _def_annotations(node, lines)
    if exempt:
        return
    linter = _FuncLinter(rules, lines, where_prefix, enclosing_class,
                         base_held, findings)
    for stmt in node.body:
        linter.visit(stmt)


def _line_waived(lines: Sequence[str], lineno: int) -> bool:
    if 1 <= lineno <= len(lines):
        idx = lines[lineno - 1].find("#")
        if idx >= 0:
            return "# lock:" in lines[lineno - 1][idx:]
    return False


def _scan_unregistered_locks(tree: pyast.Module, rules: _FieldRules,
                             lines: Sequence[str], filename: str,
                             findings: List[Finding]) -> None:
    """LCK303: every lock constructed in an opted-in module must be some
    field's registered lock — this is what keeps an EMPTY map a contract
    (a future lock in an audited-lock-free module fails the gate until
    its fields are declared)."""
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, pyast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, pyast.Call):
            continue
        chain = _attr_chain(value.func)
        if not chain or chain[-1] not in _LOCK_CTORS:
            continue
        for t in targets:
            name = t.attr if isinstance(t, pyast.Attribute) else (
                t.id if isinstance(t, pyast.Name) else None)
            if name is None or name in rules.lock_names:
                continue
            if _line_waived(lines, node.lineno):
                continue
            findings.append(Finding(
                "LCK303",
                f"lock {name} ({'.'.join(chain)}) is not registered as "
                f"any field's guard in this module's _GUARDED_BY map",
                f"{filename}:{node.lineno}"))


def lint_source(source: str, filename: str = "<module>") -> List[Finding]:
    """Lint one module's source.  No ``_GUARDED_BY`` map: no findings."""
    try:
        tree = pyast.parse(source)
    except SyntaxError as exc:
        return [Finding("LCK300", f"cannot parse: {exc}", filename)]
    guarded = _find_guarded_by(tree)
    if guarded is None:
        return []
    rules = _FieldRules(guarded)
    lines = source.splitlines()
    findings: List[Finding] = []
    _scan_unregistered_locks(tree, rules, lines, filename, findings)

    def walk_body(body, cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (pyast.FunctionDef,
                                 pyast.AsyncFunctionDef)):
                _lint_function(node, rules, lines, filename, cls, findings)
            elif isinstance(node, pyast.ClassDef):
                walk_body(node.body, node.name)
            elif isinstance(node, (pyast.If, pyast.Try, pyast.With)):
                # module-level control flow: keep walking
                for sub in pyast.iter_child_nodes(node):
                    if isinstance(sub, (pyast.FunctionDef, pyast.ClassDef)):
                        walk_body([sub], cls)
    walk_body(tree.body, None)
    return findings


def lint_file(path: str) -> List[Finding]:
    with open(path) as fh:
        return lint_source(fh.read(), path)


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (modules without a
    ``_GUARDED_BY`` map contribute nothing)."""
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, fn)))
    return findings
