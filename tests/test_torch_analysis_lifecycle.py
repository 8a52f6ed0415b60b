"""Fixture + repo tests for the exception-flow / resource-lifecycle
pass: seeded-bad vs clean-twin pairs for every rule family
(future-leak, future-double-resolve, future-close-leak,
thread-undisciplined, handle-leak, error taxonomy), the two
historical-bug regression fixtures (the fleet close
future-leak and the reaper-vs-apply double-resolution), and
the live-repo clean-modulo-waivers contract.
"""

import os

import pytest

from tuplewise_tpu_torch.analysis import lifecycle
from tuplewise_tpu_torch.analysis.core import ModuleSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms_of(src: str, path: str = "tuplewise_tpu_torch/serving/fixture.py",
          texts=None, **extra) -> ModuleSet:
    return ModuleSet.from_sources({path: src, **extra}, texts=texts)


def rules(findings):
    return sorted({f.rule for f in findings})


def by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


# --------------------------------------------------------------------- #
# future-leak                                                            #
# --------------------------------------------------------------------- #

LEAK_BAD = '''
from concurrent.futures import Future


class _Req:
    def __init__(self):
        self.future = Future()


class Engine:
    def _dispatch(self, batch):
        for r in batch:
            self._apply(r)

    def _apply(self, r):
        out = compute(r)
        r.future.set_result(out)


def compute(r):
    return r
'''

LEAK_CLEAN = '''
from concurrent.futures import Future


class _Req:
    def __init__(self):
        self.future = Future()


class Engine:
    def _dispatch(self, batch):
        try:
            for r in batch:
                self._apply(r)
        except Exception as e:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def _apply(self, r):
        out = compute(r)
        if not r.future.done():
            r.future.set_result(out)


def compute(r):
    return r
'''


def test_future_leak_flagged():
    fs = lifecycle.run(ms_of(LEAK_BAD))
    leaks = by_rule(fs, "future-leak")
    assert len(leaks) == 1
    assert leaks[0].symbol == "Engine._apply::set_result"
    assert "fleet-close" in leaks[0].message


def test_future_leak_caller_umbrella_clean():
    fs = lifecycle.run(ms_of(LEAK_CLEAN))
    assert by_rule(fs, "future-leak") == []
    assert by_rule(fs, "future-double-resolve") == []


def test_future_leak_local_try_clean():
    src = LEAK_BAD.replace(
        """        out = compute(r)
        r.future.set_result(out)""",
        """        try:
            out = compute(r)
            if not r.future.done():
                r.future.set_result(out)
        except Exception as e:
            if not r.future.done():
                r.future.set_exception(e)""")
    fs = lifecycle.run(ms_of(src))
    assert by_rule(fs, "future-leak") == []


# --------------------------------------------------------------------- #
# future-double-resolve — the reaper-vs-apply regression                  #
# --------------------------------------------------------------------- #

PRE_PR11_BAD = '''
from concurrent.futures import Future


class _Req:
    def __init__(self):
        self.future = Future()


class Engine:
    def _dispatch(self, run):
        try:
            vals = compute(run)
            for r in run:
                r.future.set_result(vals)
        except Exception as e:
            for r in run:
                r.future.set_exception(e)

    def _reap_expired(self, queued):
        for r in queued:
            r.future.set_exception(TimeoutError("expired in queue"))


def compute(run):
    return run
'''

PRE_PR11_FIXED = '''
from concurrent.futures import Future


class _Req:
    def __init__(self):
        self.future = Future()


class Engine:
    def _dispatch(self, run):
        try:
            vals = compute(run)
            for r in run:
                if not r.future.done():
                    r.future.set_result(vals)
        except Exception as e:
            for r in run:
                if not r.future.done():
                    r.future.set_exception(e)

    def _reap_expired(self, queued):
        for r in queued:
            if r.future.done():
                continue
            try:
                r.future.set_exception(TimeoutError("expired"))
            except Exception:
                continue


def compute(run):
    return run
'''


def test_redetects_reaper_vs_apply_double_resolution():
    """The reaper-vs-apply hole: the deadline reaper and the apply path both
    resolve the same futures from different threads, neither arbitrated
    — the loser raised InvalidStateError on its thread."""
    fs = lifecycle.run(ms_of(PRE_PR11_BAD))
    dbl = by_rule(fs, "future-double-resolve")
    syms = {f.symbol for f in dbl}
    assert "Engine._reap_expired::set_exception" in syms
    assert "Engine._dispatch::set_result" in syms
    assert any("reaper-vs-apply" in f.message for f in dbl)


def test_reaper_vs_apply_fixed_clean():
    fs = lifecycle.run(ms_of(PRE_PR11_FIXED))
    assert by_rule(fs, "future-double-resolve") == []
    assert by_rule(fs, "future-leak") == []


def test_single_resolver_class_not_flagged():
    """One resolving method = no cross-thread race surface: the guard
    requirement only binds multi-resolver classes."""
    src = '''
from concurrent.futures import Future


class Engine:
    def _apply(self, run):
        try:
            for r in run:
                r.future.set_result(1)
        except Exception as e:
            raise
'''
    fs = lifecycle.run(ms_of(src))
    assert by_rule(fs, "future-double-resolve") == []


# --------------------------------------------------------------------- #
# future-close-leak — the fleet close regression                           #
# --------------------------------------------------------------------- #

PRE_PR8_BAD = '''
import queue
import threading
from concurrent.futures import Future


class _Req:
    def __init__(self):
        self.future = Future()


class Engine:
    def __init__(self):
        self._q = queue.Queue(maxsize=8)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._closed = False

    def submit(self):
        r = _Req()
        self._q.put(r)
        return r.future

    def _run(self):
        while not self._closed:
            r = self._q.get()
            try:
                if not r.future.done():
                    r.future.set_result(1)
            except Exception as e:
                if not r.future.done():
                    r.future.set_exception(e)

    def close(self):
        self._closed = True
        self._worker.join(timeout=1.0)
'''

PRE_PR8_FIXED = PRE_PR8_BAD.replace(
    '''    def close(self):
        self._closed = True
        self._worker.join(timeout=1.0)''',
    '''    def close(self):
        self._closed = True
        self._worker.join(timeout=1.0)
        self._fail_queued()

    def _fail_queued(self):
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if not r.future.done():
                r.future.set_exception(RuntimeError("engine closed"))''')


def test_redetects_fleet_close_future_leak():
    """The fleet-close hole: close() joined the worker but never drained
    the queue — every queued future (and every 'block'-policy producer
    waiting on capacity) hung forever."""
    fs = lifecycle.run(ms_of(PRE_PR8_BAD))
    leaks = by_rule(fs, "future-close-leak")
    assert len(leaks) == 1
    assert leaks[0].symbol == "Engine.close"
    assert "fleet-close" in leaks[0].message


def test_fleet_close_drain_clean():
    fs = lifecycle.run(ms_of(PRE_PR8_FIXED))
    assert by_rule(fs, "future-close-leak") == []


def test_close_missing_entirely_flagged():
    src = PRE_PR8_BAD.replace('''    def close(self):
        self._closed = True
        self._worker.join(timeout=1.0)''', "")
    fs = lifecycle.run(ms_of(src))
    leaks = by_rule(fs, "future-close-leak")
    assert len(leaks) == 1
    assert "no close()/shutdown() at all" in leaks[0].message


# --------------------------------------------------------------------- #
# thread-undisciplined                                                   #
# --------------------------------------------------------------------- #

def test_thread_not_daemon_not_joined_flagged():
    src = '''
import threading


class Owner:
    def start(self):
        self._t = threading.Thread(target=self._run)
        self._t.start()

    def _run(self):
        pass
'''
    fs = lifecycle.run(ms_of(src))
    (f,) = by_rule(fs, "thread-undisciplined")
    assert "Thread" in f.symbol


def test_thread_daemon_clean():
    src = '''
import threading


class Owner:
    def start(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        pass
'''
    assert by_rule(lifecycle.run(ms_of(src)),
                   "thread-undisciplined") == []


def test_thread_joined_in_close_clean():
    src = '''
import threading


class Owner:
    def start(self):
        self._t = threading.Thread(target=self._run)
        self._t.start()

    def _run(self):
        pass

    def close(self):
        self._t.join(timeout=5.0)
'''
    assert by_rule(lifecycle.run(ms_of(src)),
                   "thread-undisciplined") == []


def test_timer_cancelled_clean_uncancelled_flagged():
    src = '''
import threading


class Owner:
    def arm(self):
        self._timer = threading.Timer(1.0, self._fire)
        self._timer.start()

    def _fire(self):
        pass
'''
    (f,) = by_rule(lifecycle.run(ms_of(src)), "thread-undisciplined")
    assert "Timer" in f.symbol
    cancelled = src + '''
    def close(self):
        self._timer.cancel()
'''
    assert by_rule(lifecycle.run(ms_of(cancelled)),
                   "thread-undisciplined") == []


# --------------------------------------------------------------------- #
# handle-leak                                                            #
# --------------------------------------------------------------------- #

def test_local_open_without_finally_flagged():
    src = '''
def write_wal(path, rec):
    f = open(path, "a")
    f.write(rec)
    f.close()
'''
    (f,) = by_rule(lifecycle.run(ms_of(src)), "handle-leak")
    assert f.symbol == "write_wal::open"


def test_local_open_with_finally_clean():
    src = '''
def write_wal(path, rec):
    f = open(path, "a")
    try:
        f.write(rec)
    finally:
        f.close()
'''
    assert by_rule(lifecycle.run(ms_of(src)), "handle-leak") == []


def test_with_open_clean():
    src = '''
def write_wal(path, rec):
    with open(path, "a") as f:
        f.write(rec)
'''
    assert by_rule(lifecycle.run(ms_of(src)), "handle-leak") == []


def test_attr_open_with_owner_close_clean():
    src = '''
class Log:
    def __init__(self, path):
        self._f = open(path, "a")

    def close(self):
        self._f.close()
'''
    assert by_rule(lifecycle.run(ms_of(src)), "handle-leak") == []


def test_attr_open_without_owner_close_flagged():
    src = '''
class Log:
    def __init__(self, path):
        self._f = open(path, "a")
'''
    (f,) = by_rule(lifecycle.run(ms_of(src)), "handle-leak")
    assert f.symbol == "Log.__init__::open"


def test_ownership_transfer_via_return_clean():
    src = '''
def open_wal(path):
    f = open(path, "a")
    return f
'''
    assert by_rule(lifecycle.run(ms_of(src)), "handle-leak") == []


# --------------------------------------------------------------------- #
# error taxonomy                                                         #
# --------------------------------------------------------------------- #

ERR_MOD = '''
class DemoError(RuntimeError):
    """typed serving error."""


def admit(x):
    if x is None:
        raise DemoError("no payload")
    return x
'''

HANDLER_MOD = '''
def serve_loop(req):
    from tuplewise_tpu_torch.serving.fixture import DemoError, admit

    try:
        return {"ok": True, "value": admit(req)}
    except DemoError as e:
        return {"ok": False, "error": f"demo: {e}"}
'''


def test_error_taxonomy_all_three_gaps_flagged():
    fs = lifecycle.run(ms_of(ERR_MOD))
    assert "error-unhandled-protocol" in rules(fs)
    assert "error-not-doctor-visible" in rules(fs)
    assert "error-undocumented" in rules(fs)
    assert all(f.symbol == "DemoError" for f in fs
               if f.rule.startswith("error-"))


def test_error_taxonomy_fully_wired_clean():
    fs = lifecycle.run(ms_of(
        ERR_MOD,
        texts={"README.md": "raises `DemoError` when ..."},
        **{"tuplewise_tpu_torch/harness/fixture_cli.py": HANDLER_MOD,
           "tuplewise_tpu_torch/obs/report.py":
               "# consumes DemoError counts\n"}))
    assert [f for f in fs if f.rule.startswith("error-")] == []


def test_error_unraised_class_not_in_scope():
    src = '''
class NeverRaisedError(RuntimeError):
    pass
'''
    fs = lifecycle.run(ms_of(src))
    assert [f for f in fs if f.rule.startswith("error-")] == []


# --------------------------------------------------------------------- #
# the live repo                                                          #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def repo_findings():
    return lifecycle.run(ModuleSet.from_repo(REPO))


def test_repo_clean_modulo_documented_waivers(repo_findings):
    """The live repo's only lifecycle findings are the two
    ControllerSpecError entries carried (with written justifications)
    in waivers.toml: a config-time error has no wire/doctor surface
    by construction. Everything else was FIXED in this PR: the fleet
    query-wave future leak + unguarded resolution (tenancy._dispatch
    umbrella), the drop_oldest-vs-reaper double resolution
    (engine.submit done() guard), and the stat_check handle leak."""
    leftovers = [f for f in repo_findings
                 if f.symbol != "ControllerSpecError"]
    assert leftovers == [], [
        (f.rule, f.file, f.symbol) for f in leftovers]
    waived = {(f.rule, f.symbol) for f in repo_findings}
    assert waived == {
        ("error-unhandled-protocol", "ControllerSpecError"),
        ("error-not-doctor-visible", "ControllerSpecError"),
    }


def test_repo_serving_error_taxonomy_is_protocol_handled(
        repo_findings):
    """Every request-path typed error stays wire-handled: the rules
    that would fire on a regression are active (fixture tests above)
    and silent on the live tree."""
    assert by_rule(repo_findings, "error-undocumented") == []
    assert [f for f in by_rule(repo_findings,
                               "error-unhandled-protocol")
            if f.symbol != "ControllerSpecError"] == []


def test_repo_futures_and_threads_disciplined(repo_findings):
    assert by_rule(repo_findings, "future-leak") == []
    assert by_rule(repo_findings, "future-double-resolve") == []
    assert by_rule(repo_findings, "future-close-leak") == []
    assert by_rule(repo_findings, "thread-undisciplined") == []
    assert by_rule(repo_findings, "handle-leak") == []
