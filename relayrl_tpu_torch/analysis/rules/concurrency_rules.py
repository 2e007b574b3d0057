"""Concurrency rules for the runtime/transport layers.

The server is a lock-coordinated thread fleet (ingest, staging, learner,
publish); the transports park threads in blocking socket calls. The two
hazards below are the ones that turn that design into stalls or
unkillable processes.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from relayrl_tpu_torch.analysis.engine import (
    ModuleInfo,
    Rule,
    qualname,
    walk_skip_nested_functions,
)

_LOCK_NAME_RE = re.compile(r"(lock|mutex)", re.IGNORECASE)

# Attribute calls that park the calling thread regardless of receiver
# (socket/zmq receive & connect surfaces). `join`/`result` are NOT here:
# bare attribute names would also match `", ".join(...)` and
# `os.path.join(...)` — they only count on a receiver that looks like a
# thread/process/future (below).
_BLOCKING_ATTRS = frozenset({
    "recv", "recv_multipart", "recv_string", "recv_json", "recv_pyobj",
    "recv_into", "accept", "connect", "sendall",
})

# .join()/.result()/.wait_for() block only on these receiver shapes.
_BLOCKING_RECEIVER_ATTRS = frozenset({"join", "result"})
_BLOCKING_RECEIVER_RE = re.compile(
    r"(thread|proc|process|worker|listener|future|fut\b|task|call|pool)",
    re.IGNORECASE)

_BLOCKING_CALLS = frozenset({
    "time.sleep",
    "socket.create_connection",
    "urllib.request.urlopen",
    "subprocess.run", "subprocess.call", "subprocess.check_output",
    "subprocess.check_call",
})


class BlockingUnderLock(Rule):
    """A sleep or blocking I/O call inside ``with <lock>:`` holds every
    other thread hostage for the duration — the publish/ingest stall mode
    where one slow agent serializes the whole fleet."""

    code = "CONC01"
    name = "blocking-under-lock"
    description = ("time.sleep or blocking I/O while holding a "
                   "threading lock")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_name = self._held_lock(node)
            if lock_name is None:
                continue
            for stmt in node.body:
                for inner in self._walk_stmt(stmt):
                    if not isinstance(inner, ast.Call):
                        continue
                    label = self._blocking_label(module, inner)
                    if label:
                        yield inner, (
                            f"`{label}` while holding `{lock_name}` — "
                            f"every thread contending for the lock stalls "
                            f"for the full blocking duration; move the "
                            f"blocking call outside the critical section "
                            f"or switch to a Condition wait")

    @staticmethod
    def _walk_stmt(stmt: ast.stmt) -> Iterator[ast.AST]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # defined under the lock, not executed under it
        yield stmt
        yield from walk_skip_nested_functions(stmt)

    @staticmethod
    def _held_lock(node: ast.With | ast.AsyncWith) -> str | None:
        for item in node.items:
            name = qualname(item.context_expr)
            if name and _LOCK_NAME_RE.search(name.split(".")[-1]):
                return name
        return None

    @staticmethod
    def _blocking_label(module: ModuleInfo, call: ast.Call) -> str | None:
        resolved = module.resolved_call(call)
        if resolved in _BLOCKING_CALLS:
            return resolved
        if resolved and resolved.startswith("requests."):
            return resolved
        if not isinstance(call.func, ast.Attribute):
            return None
        if isinstance(call.func.value, ast.Constant):
            return None  # ", ".join(...) and friends
        if call.func.attr in _BLOCKING_ATTRS:
            return f".{call.func.attr}()"
        if call.func.attr in _BLOCKING_RECEIVER_ATTRS:
            receiver = qualname(call.func.value) or ""
            if _BLOCKING_RECEIVER_RE.search(receiver):
                return f"{receiver}.{call.func.attr}()"
        return None


class BareExcept(Rule):
    """``except:`` also swallows KeyboardInterrupt and SystemExit — in a
    server accept/ingest loop that turns Ctrl-C into an unkillable
    process (the shutdown path the signal tests pin)."""

    code = "CONC02"
    name = "bare-except"
    description = "bare except: swallows KeyboardInterrupt/SystemExit"

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield node, (
                    "bare `except:` catches KeyboardInterrupt/SystemExit "
                    "and makes loops unkillable; catch `Exception` (or "
                    "narrower) instead")


RULES = [BlockingUnderLock, BareExcept]
