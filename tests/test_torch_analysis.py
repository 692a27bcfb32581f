"""The port's static analysis (parsec_tpu_torch/analysis/, run as
``python -m parsec_tpu_torch.analysis``).

Mirrors the JAX package's ``tests/test_analysis.py`` against the port's
own front end, specs and source tree: each deliberately broken golden
spec is caught with the expected finding code (device bodies are
``BODY [type=cuda]`` here); the port's shipped specs and its runtime
source produce ZERO gating findings (the self-lint gate). On every
golden spec the two packages' verifiers return the same code set.
"""
import os
import subprocess
import sys

import pytest

from parsec_tpu_torch.analysis import (Finding, body_check, gate, lock_check,
                                       ptg_check)
from parsec_tpu_torch.analysis import dagenum, lint
from parsec_tpu_torch.dsl import ptg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def codes(findings):
    return {f.code for f in findings}


def verify(text, **kw):
    kw.setdefault("cycles", False)
    return ptg_check.verify_jdf_text(text, name="golden", **kw)


# --------------------------------------------------------------------- #
# golden broken specs — the PTG dataflow verifier                        #
# --------------------------------------------------------------------- #
GOLDEN_DANGLING = """
NB [ type="int" ]
A(k)
k = 0 .. NB
RW X <- NEW  [ shape=1 ]
     -> X Nowhere( k )
BODY
pass
END
"""


def test_golden_dangling_endpoint():
    fs = verify(GOLDEN_DANGLING)
    assert "PTG101" in codes(fs), fs


GOLDEN_NONRECIPROCAL = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> X B( k )
BODY
pass
END

B(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY
pass
END
"""


def test_golden_non_reciprocal_dep():
    fs = verify(GOLDEN_NONRECIPROCAL)
    assert "PTG105" in codes(fs), fs
    # the finding names both endpoints of the one-sided edge
    msg = next(f.message for f in fs if f.code == "PTG105")
    assert "A.X" in msg and "B.X" in msg


GOLDEN_CTL_CYCLE = """
A(k)
k = 0 .. 1
CTL ctl <- ctl B( k )
        -> ctl B( k )
BODY
pass
END

B(k)
k = 0 .. 1
CTL ctl <- ctl A( k )
        -> ctl A( k )
BODY
pass
END
"""


def test_golden_ctl_cycle():
    fs = ptg_check.verify_jdf_text(GOLDEN_CTL_CYCLE, name="golden",
                                   cycles=True)
    assert "PTG109" in codes(fs), fs


GOLDEN_UNUSED_LOCAL = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
j = k + 1
: c( k )
RW X <- c( k )
     -> c( k )
BODY
pass
END
"""


def test_golden_unused_local():
    fs = verify(GOLDEN_UNUSED_LOCAL)
    assert "PTG107" in codes(fs), fs
    assert any("'j'" in f.message for f in fs if f.code == "PTG107")


GOLDEN_WRITE_FEEDS_WRITE = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> S B( k )
BODY
pass
END

B(k)
k = 0 .. NB
: c( k )
WRITE S <- X A( k )
        -> c( k )
BODY
pass
END
"""


def test_golden_write_feeds_write():
    fs = verify(GOLDEN_WRITE_FEEDS_WRITE)
    assert "PTG103" in codes(fs), fs


GOLDEN_ARITY = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> X B( k, 0 )
BODY
pass
END

B(k)
k = 0 .. NB
: c( k )
RW X <- X A( k )
     -> c( k )
BODY
pass
END
"""


def test_golden_arity_mismatch():
    fs = verify(GOLDEN_ARITY)
    assert "PTG104" in codes(fs), fs


GOLDEN_UNSAT_GUARD = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- (k != k) ? c( k ) : NEW  [ shape=1 ]
     -> c( k )
BODY
pass
END
"""


def test_golden_unsatisfiable_guard():
    fs = verify(GOLDEN_UNSAT_GUARD)
    assert "PTG108" in codes(fs), fs


GOLDEN_CTL_DATA_MISMATCH = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> ctl B( k )
BODY
pass
END

B(k)
k = 0 .. NB
: c( k )
RW Y <- c( k )
     -> c( k )
CTL ctl <- X A( k )
BODY
pass
END
"""


def test_golden_ctl_data_mismatch():
    fs = verify(GOLDEN_CTL_DATA_MISMATCH)
    assert "PTG102" in codes(fs), fs


GOLDEN_UNUSED_GLOBAL = """
c [ type="collection" ]
NB [ type="int" ]
SPARE [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY
pass
END
"""


def test_golden_unused_global():
    fs = verify(GOLDEN_UNUSED_GLOBAL)
    assert "PTG106" in codes(fs), fs
    assert any("SPARE" in f.message for f in fs if f.code == "PTG106")


# --------------------------------------------------------------------- #
# golden broken bodies — the batch/donation-safety linter                #
# --------------------------------------------------------------------- #
GOLDEN_THIS_TASK = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY [type=cuda]
X = X + this_task.priority
END
"""


def test_golden_this_task_body():
    jdf = ptg.compile_jdf(GOLDEN_THIS_TASK, name="golden").jdf
    fs = body_check.check_jdf_bodies(jdf)
    assert "BDY201" in codes(fs), fs
    assert any("NEVER batches" in f.message for f in fs)


GOLDEN_UNTRACEABLE = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY [type=cuda]
X = np.asarray(X) * 2
print(X)
if X > 0:
    X = X - 1
X = X * X.sum().item() + torch.as_tensor(X.cpu())
END
"""


def test_golden_untraceable_body():
    """BDY202 on the port names a host sync: a numpy call on a flow,
    print, an if on a payload, .item(), .cpu() — each stalls the stream
    and breaks whole-graph capture (no trace downgrade here)."""
    jdf = ptg.compile_jdf(GOLDEN_UNTRACEABLE, name="golden").jdf
    fs = body_check.check_jdf_bodies(jdf)
    assert "BDY202" in codes(fs)
    msgs = " | ".join(f.message for f in fs if f.code == "BDY202")
    assert "np.asarray" in msgs and "print()" in msgs and "if" in msgs
    assert ".item()" in msgs and ".cpu()" in msgs
    assert "CaptureError" in msgs and "per-task" not in msgs
    # a numpy call on constants is no host sync
    quiet = ptg.compile_jdf(GOLDEN_UNTRACEABLE.replace(
        """X = np.asarray(X) * 2
print(X)
if X > 0:
    X = X - 1
X = X * X.sum().item() + torch.as_tensor(X.cpu())""",
        "X = X * np.float32(2.0)"), name="golden").jdf
    assert body_check.check_jdf_bodies(quiet) == []


GOLDEN_NONDET = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY [type=cuda]
X = X * np.random.rand()
END
"""


def test_golden_nondeterministic_body():
    jdf = ptg.compile_jdf(GOLDEN_NONDET, name="golden").jdf
    fs = body_check.check_jdf_bodies(jdf)
    assert "BDY203" in codes(fs), fs


GOLDEN_ALIASED = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
READ U <- c( k, k )
RW   X <- c( k, k )
       -> c( k, k )
BODY [type=cuda]
X = X + U
END
"""


def test_golden_aliased_tiles():
    """Donation raises in this package, so BDY204 is a note: it never
    fails a strict gate."""
    jdf = ptg.compile_jdf(GOLDEN_ALIASED, name="golden").jdf
    fs = body_check.check_jdf_bodies(jdf)
    assert "BDY204" in codes(fs), fs
    assert any("donation" in f.message for f in fs if f.code == "BDY204")
    assert all(f.severity == "note" for f in fs if f.code == "BDY204")
    assert gate(fs) == []


GOLDEN_MISSING_WRITE = """
c [ type="collection" ]
NB [ type="int" ]
A(k)
k = 0 .. NB
: c( k )
RW X <- c( k )
     -> c( k )
BODY [type=cuda]
Y = X * 2
END
"""


def test_golden_missing_write():
    jdf = ptg.compile_jdf(GOLDEN_MISSING_WRITE, name="golden").jdf
    fs = body_check.check_jdf_bodies(jdf)
    assert "BDY205" in codes(fs), fs


def test_check_function_dtd():
    def bad_kernel(a, b):
        import time
        if a > 0:           # traced-value branch
            a = a - b
        return a * time.time()

    fs = body_check.check_function(bad_kernel)
    assert "BDY202" in codes(fs) and "BDY203" in codes(fs)

    def good_kernel(a, b):
        return a @ b

    assert body_check.check_function(good_kernel) == []


def test_at_least_five_distinct_codes_catchable():
    """Acceptance: the golden set exercises >= 5 distinct finding codes."""
    seen = set()
    for spec in (GOLDEN_DANGLING, GOLDEN_NONRECIPROCAL,
                 GOLDEN_UNUSED_LOCAL, GOLDEN_WRITE_FEEDS_WRITE,
                 GOLDEN_ARITY, GOLDEN_UNSAT_GUARD,
                 GOLDEN_CTL_DATA_MISMATCH, GOLDEN_UNUSED_GLOBAL):
        seen |= codes(verify(spec))
    for spec in (GOLDEN_THIS_TASK, GOLDEN_NONDET, GOLDEN_ALIASED):
        jdf = ptg.compile_jdf(spec, name="golden").jdf
        seen |= codes(body_check.check_jdf_bodies(jdf))
    seen |= codes(ptg_check.verify_jdf_text(GOLDEN_CTL_CYCLE,
                                            name="golden", cycles=True))
    assert len(seen) >= 5, seen


# --------------------------------------------------------------------- #
# zero false positives over everything the port ships                    #
# --------------------------------------------------------------------- #
def test_shipped_specs_are_clean():
    """Every ``*_JDF`` spec of parsec_tpu_torch/ops and collections
    (dpotrf, dtrsm, dgetrf, dgeqrf, pdgemm, the collection ops, the
    redistribution reshuffle) lints clean."""
    files = lint.default_spec_files()
    names = {os.path.basename(f) for f in files}
    assert {"dpotrf.py", "dtrsm.py", "dgetrf.py", "dgeqrf.py", "pdgemm.py",
            "ops.py", "redistribute.py"} <= names
    findings = []
    n_specs = 0
    for path in files:
        n_specs += len(lint.find_jdf_specs(path))
        findings.extend(lint.lint_spec_file(path, cycles=False))
    assert n_specs >= 10
    assert gate(findings) == [], [str(f) for f in gate(findings)]


def test_shipped_specs_enumerate_acyclic():
    """The cycle pass instantiates every shipped spec without a PTG109
    (and without an enumeration-failed note)."""
    findings = []
    for path in lint.default_spec_files():
        findings.extend(lint.lint_spec_file(path, cycles=True))
    assert not [f for f in findings if f.code in ("PTG109", "PTG180")], \
        [str(f) for f in findings]


def test_runtime_source_lock_lint_clean():
    fs = lock_check.lint_tree(os.path.join(ROOT, "parsec_tpu_torch"))
    assert fs == [], [str(f) for f in fs]


def test_self_lint_gate():
    """The self-lint gate: ``python -m parsec_tpu_torch.analysis
    --strict`` over the port's specs and source exits 0."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.analysis", "--strict"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


# --------------------------------------------------------------------- #
# the concurrency lint itself                                           #
# --------------------------------------------------------------------- #
LOCK_SRC = '''
import threading, time

_GUARDED_BY = {"Box._items": "_lock", "Peer.q": "cond"}

class Box:
    def __init__(self):
        self._items = []
        self._lock = threading.Lock()

    def good(self):
        with self._lock:
            return len(self._items)

    def bad(self):
        return len(self._items)

    def bad_block(self, sock):
        with self._lock:
            time.sleep(0.1)
            sock.sendall(b"x")

    def mgr(self):
        if not self._lock.acquire(blocking=False):
            return
        try:
            self._items.append(2)
        finally:
            self._lock.release()

    def helper(self):  # holds: self._lock
        self._items.pop()

    def waived(self):
        return self._items[:]            # lock: benign snapshot

class Peer:
    def touch(self, p):
        p.q.append(1)
        with p.cond:
            p.q.append(2)
            p.cond.wait(0.1)
'''


def test_lock_lint_catches_and_respects_annotations():
    fs = lock_check.lint_source(LOCK_SRC, "synthetic.py")
    by_line = {int(f.where.rsplit(":", 1)[1]): f.code for f in fs}
    assert sorted(by_line.items()) == [
        (16, "LCK301"),   # Box.bad: unguarded read
        (20, "LCK302"),   # sleep while holding _lock
        (21, "LCK302"),   # sendall while holding _lock
        (39, "LCK301"),   # Peer.touch: p.q before taking p.cond
    ]


def test_lock_lint_ignores_unregistered_modules():
    assert lock_check.lint_source("x = 1\n", "m.py") == []


LOCK_SRC_UNREGISTERED = '''
import threading

_GUARDED_BY = {}

class S:
    def setup(self):
        self._lock = threading.Lock()
        self._scratch = threading.Lock()   # lock: single-owner scratch
'''


def test_lock_lint_unregistered_lock():
    """LCK303: an EMPTY _GUARDED_BY map is a contract, not a no-op — a
    lock constructed in an opted-in module must be some field's guard;
    a trailing # lock: comment waives one construction."""
    fs = lock_check.lint_source(LOCK_SRC_UNREGISTERED, "synthetic.py")
    assert [f.code for f in fs] == ["LCK303"]
    assert "_lock" in fs[0].message and fs[0].where.endswith(":8")


# --------------------------------------------------------------------- #
# dagenum as an importable library (cycle-pass substrate)               #
# --------------------------------------------------------------------- #
def test_dagenum_enumerate_text():
    tp, order = dagenum.enumerate_text("""
c [ type="collection" ]
NB [ type="int" ]
T(k)
k = 0 .. NB-1
: c( k )
RW A <- (k == 0) ? c( k ) : A T( k-1 )
     -> (k < NB-1) ? A T( k+1 ) : c( k )
BODY
pass
END
""", {"NB": 5}, name="chain")
    assert len(order) == 5
    keys = [inst.key for inst in order]
    assert keys == sorted(keys, key=lambda k: k[1])
    assert order[-1].preds == [("T", (3,))]


def test_dagenum_cycle_raises():
    from parsec_tpu_torch.dsl.ptg.capture import CaptureError
    with pytest.raises(CaptureError, match="cycle"):
        dagenum.enumerate_text(GOLDEN_CTL_CYCLE, {}, name="cycle")


# --------------------------------------------------------------------- #
# diagnostics: Expr origins (file:line task.flow)                        #
# --------------------------------------------------------------------- #
def test_expr_origin_in_syntax_error():
    with pytest.raises(SyntaxError, match=r"myspec:6 A\.X"):
        ptg.compile_jdf("""
NB [ type="int" ]
A(k)
k = 0 .. NB
RW X <- NEW  [ shape=1 ]
     -> (k @@ 1) ? X A( k+1 )
BODY
pass
END
""", name="myspec")


def test_expr_origin_in_runtime_name_error():
    jdf = ptg.compile_jdf("""
NB [ type="int" ]
A(k)
k = 0 .. NB
RW X <- NEW  [ shape=1 ]
     -> (k < MISSING) ? X A( k+1 )
BODY
pass
END
""", name="myspec").jdf
    guard = jdf.task_classes[0].flows[0].deps[1].guard
    assert guard.origin == "myspec:6 A.X"
    with pytest.raises(NameError, match=r"myspec:6 A\.X"):
        guard({"k": 0})


def test_block_comment_preserves_line_numbers():
    """Multi-line /* */ comments must not shift diagnostic line
    numbers."""
    jdf = ptg.compile_jdf("""
NB [ type="int" ]
/* a
   multi-line
   comment */
A(k)
k = 0 .. NB
RW X <- NEW  [ shape=1 ]
     -> (k < MISSING) ? X A( k+1 )
BODY
pass
END
""", name="cmt").jdf
    guard = jdf.task_classes[0].flows[0].deps[1].guard
    assert guard.origin == "cmt:9 A.X"


def test_helper_name_error_keeps_traceback():
    """A NameError raised INSIDE a function the expression calls is not
    rewrapped with the JDF origin — the real traceback survives."""
    import traceback
    from parsec_tpu_torch.dsl.ptg.ast import Expr

    def helper(k):
        return undefined_thing  # noqa: F821

    e = Expr("helper(k)", origin="spec:6 A.X")
    with pytest.raises(NameError) as ei:
        e({"k": 0, "helper": helper})
    assert "spec:6" not in str(ei.value)
    frames = [t.name for t in traceback.extract_tb(ei.value.__traceback__)]
    assert "helper" in frames


def test_finding_str_format():
    f = Finding("PTG105", "msg", "spec:3 A.X")
    assert str(f) == "PTG105 [error] spec:3 A.X: msg"
    assert gate([f, Finding("PTG180", "m", severity="note")]) == [f]


# --------------------------------------------------------------------- #
# the two packages' verifiers agree                                     #
# --------------------------------------------------------------------- #
GOLDENS = {
    "dangling": GOLDEN_DANGLING, "nonreciprocal": GOLDEN_NONRECIPROCAL,
    "ctl_cycle": GOLDEN_CTL_CYCLE, "unused_local": GOLDEN_UNUSED_LOCAL,
    "write_feeds_write": GOLDEN_WRITE_FEEDS_WRITE, "arity": GOLDEN_ARITY,
    "unsat_guard": GOLDEN_UNSAT_GUARD,
    "ctl_data_mismatch": GOLDEN_CTL_DATA_MISMATCH,
    "unused_global": GOLDEN_UNUSED_GLOBAL, "this_task": GOLDEN_THIS_TASK,
    "untraceable": GOLDEN_UNTRACEABLE, "nondet": GOLDEN_NONDET,
    "aliased": GOLDEN_ALIASED, "missing_write": GOLDEN_MISSING_WRITE,
}


def _all_codes(ptg_mod, body_mod, parse, text):
    found = codes(ptg_mod.verify_jdf_text(text, name="golden", cycles=True))
    try:
        jdf = parse(text, name="golden")
    except Exception:  # noqa: BLE001 - the verifier reported it
        return found
    return found | codes(body_mod.check_jdf_bodies(jdf))


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_verifiers_agree_with_jax_package(golden):
    """The same golden spec gives the same finding-code set in both
    packages (the JAX package's device bodies are ``type=tpu``)."""
    from parsec_tpu.analysis import body_check as jax_body_check
    from parsec_tpu.analysis import ptg_check as jax_ptg_check
    from parsec_tpu.dsl.ptg.parser import parse_jdf as jax_parse
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    text = GOLDENS[golden]
    ours = _all_codes(ptg_check, body_check, parse_jdf, text)
    theirs = _all_codes(jax_ptg_check, jax_body_check, jax_parse,
                        text.replace("BODY [type=cuda]", "BODY [type=tpu]"))
    assert ours == theirs
    assert ours, f"golden {golden} found nothing"
