"""Status/error model for cylon_tpu_torch (a copy of cylon_tpu.status).

Mirrors the reference's return-value error propagation (reference:
cpp/src/cylon/status.hpp:21-63, cpp/src/cylon/code.cpp) but exposes it
Python-idiomatically: every public op raises :class:`CylonError` carrying a
:class:`Code`, and a :class:`Status` object is available for call sites that
prefer the reference's non-throwing style.

Error taxonomy (docs/resilience.md): the resilience layer needs
retryability to be a PROPERTY of the error, not a guess made at the
catch site, so :class:`CylonError` grew four operational subclasses —

* :class:`CylonTransientError`   — a stage that may succeed on retry
  (preempted ICI collective, transient runtime failure). The ONLY
  retryable class; ``resilience.retry`` keys off ``retryable``.
* :class:`CylonResourceExhausted` — HBM/compile memory exhausted, or a
  query shed by the admission controller. Not retryable as-is: the
  same attempt would exhaust the same memory — degrade or shrink.
* :class:`CylonPlanError`        — the plan/query itself is invalid
  (unknown lowering, bad fault-plan grammar). Never retryable.
* :class:`CylonDataError`        — malformed input data (truncated
  parquet, garbage CSV). Never retryable; re-reading won't fix bytes.
* :class:`CylonTimeoutError`     — the per-query deadline
  (``CYLON_QUERY_DEADLINE_S``) expired. Never retryable — the budget
  is spent.

``classify()`` maps raw backend exceptions (XLA RESOURCE_EXHAUSTED,
preemption/unavailable collectives) onto this taxonomy at the
resilience layer's catch sites, so retry policy is decided by type,
never by string-matching in operator code.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Code(enum.IntEnum):
    """Error codes (reference: cpp/src/cylon/code.cpp)."""

    OK = 0
    OutOfMemory = 1
    KeyError = 2
    TypeError = 3
    Invalid = 4
    IOError = 5
    CapacityError = 6
    IndexError = 7
    UnknownError = 8
    NotImplemented = 9
    SerializationError = 10
    RError = 11
    CodeGenError = 12
    ExpressionValidationError = 13
    ExecutionError = 14
    AlreadyExists = 15


@dataclass(frozen=True)
class Status:
    """Reference: cpp/src/cylon/status.hpp:21-63 (`Status::OK/is_ok/get_code/get_msg`)."""

    code: Code = Code.OK
    msg: str = ""

    @staticmethod
    def OK() -> "Status":
        return Status(Code.OK, "")

    def is_ok(self) -> bool:
        return self.code == Code.OK

    def get_code(self) -> Code:
        return self.code

    def get_msg(self) -> str:
        return self.msg

    def raise_if_error(self) -> None:
        if not self.is_ok():
            raise CylonError(self.code, self.msg)


class CylonError(Exception):
    """Exception carrying a :class:`Code`; the Python-native face of Status.

    ``retryable`` is the class-level contract the resilience layer's
    retry policy reads: only :class:`CylonTransientError` sets it."""

    retryable = False

    def __init__(self, code: Code, msg: str):
        super().__init__(f"[{code.name}] {msg}")
        self.code = code
        self.msg = msg

    def status(self) -> Status:
        return Status(self.code, self.msg)


class CylonTransientError(CylonError):
    """A stage failure that may succeed on retry (preempted collective,
    transient runtime error, injected chaos fault). The only retryable
    error class."""

    retryable = True

    def __init__(self, msg: str, code: Code = Code.ExecutionError):
        super().__init__(code, msg)


class CylonResourceExhausted(CylonError):
    """HBM/compile memory exhausted, or a query shed by the admission
    controller. Retrying the identical attempt exhausts the identical
    memory — the recovery is degrade (blocked/chunked execution) or
    shrink, never blind retry."""

    def __init__(self, msg: str, code: Code = Code.OutOfMemory):
        super().__init__(code, msg)


class CylonPlanError(CylonError):
    """The plan/query itself is invalid (no lowering for a node, bad
    fault-plan grammar, malformed configuration). Never retryable."""

    def __init__(self, msg: str, code: Code = Code.Invalid):
        super().__init__(code, msg)


class CylonDataError(CylonError):
    """Malformed input data (truncated parquet footer, garbage CSV,
    invalid UTF-8). Never retryable — re-reading won't fix the bytes."""

    def __init__(self, msg: str, code: Code = Code.SerializationError):
        super().__init__(code, msg)


class CylonTimeoutError(CylonError):
    """The per-query deadline (``CYLON_QUERY_DEADLINE_S``) expired.
    Never retryable — the time budget is spent; the flight recorder
    dumps the in-flight span stack for the post-mortem."""

    def __init__(self, msg: str, code: Code = Code.ExecutionError):
        super().__init__(code, msg)


def is_retryable(exc: BaseException) -> bool:
    """True when retrying the failed stage could succeed: a typed
    transient error, or a raw backend error ``classify()`` maps to
    one."""
    if isinstance(exc, CylonError):
        return exc.retryable
    mapped = classify(exc)
    return mapped is not None and mapped.retryable


# substrings (lowercased) in raw backend error text that identify the
# failure class when the exception TYPE carries no information (XLA
# surfaces everything as XlaRuntimeError / RuntimeError)
_TRANSIENT_MARKERS = ("preempt", "unavailable", "aborted",
                      "connection reset", "transient", "cancelled",
                      "socket closed")
_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory", "failed to allocate")


def classify(exc: BaseException) -> Optional[CylonError]:
    """Map a raw (non-Cylon) exception onto the typed taxonomy, or None
    when it carries no recognizable operational signature. Typed errors
    pass through unchanged — classification never re-wraps."""
    if isinstance(exc, CylonError):
        return exc
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m in text for m in _OOM_MARKERS):
        return CylonResourceExhausted(
            f"backend out of memory: {exc}")
    if any(m in text for m in _TRANSIENT_MARKERS):
        return CylonTransientError(
            f"transient backend failure: {exc}")
    return None


def not_ported(what: str) -> CylonError:
    """The typed error for a feature the JAX package has and this port
    does not carry yet (ROADMAP.md lists the queue)."""
    return CylonError(Code.NotImplemented,
                      f"{what} is not yet ported to cylon_tpu_torch")
