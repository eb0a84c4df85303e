"""cylon_tpu_torch.analysis — pluggable static-analysis suite
(counterpart of cylon_tpu.analysis, pointed at cylon_tpu_torch; it
imports neither jax nor cylon_tpu, and ``import cylon_tpu_torch`` does
not import it).

Ten checker families guard the invariants the paper's *local kernel +
shuffle + local kernel* decomposition rests on (SURVEY §1), each
registered in `core.CHECKERS` and runnable from one entry point:

* ``layering``      — declarative per-subsystem import contracts;
* ``hostsync``      — the host-sync discipline of eager torch: a kernel
                      wrapper only launches (``hostsync/in-launch``),
                      and every host transfer in ``parallel/`` sits in a
                      function that declares it to
                      ``record_host_sync`` (``hostsync/undeclared``);
* ``collectives``   — runs the public operators of ``parallel/`` on a
                      virtual world under a recording comm and a torch
                      dispatch mode: the comm seam, the shard-major
                      all-to-all shapes, no implicit float64 promotion;
* ``witness``       — optimizer-independent re-derivation of
                      partitioning witnesses over optimized plans
                      (wraps plan/verify.py): every shuffle elision
                      must be justified or the plan is rejected;
* ``span-coverage`` — every public ``distributed_*`` op and every
                      executor lowering must run under a telemetry
                      span;
* ``ledger-coverage`` — every materializing ``distributed_*`` op and
                      executor lowering must register its output with
                      the telemetry ledger;
* ``errors``        — no silent swallowing: bare ``except:`` and
                      broad ``except Exception`` handlers that
                      neither re-raise nor report are findings;
* ``concurrency``   — thread-domain race detector over the service
                      tier: lock discipline, no blocking call under a
                      lock, contextvars re-stamped on thread entry, and
                      GC finalizers that never touch non-reentrant
                      locks or ``torch.cuda``;
* ``envknobs``      — every ``CYLON_*`` environment read routes
                      through the declared knob registry
                      (telemetry/knobs.py) and every declared knob
                      appears in docs/telemetry.md;
* ``specialization`` — every ``counted_cache`` factory cache-key
                      argument is classified (structural / schema-bound
                      / bucketed / data-dependent / unbounded); in the
                      port the one factory builds a kernel library with
                      nvcc, one build per source.

Run ``python -m cylon_tpu_torch.analysis`` (see ``--help``). The rule
catalog is the family modules' docstrings and ``--list-rules``; the
suppression syntax is core's.
"""
from __future__ import annotations

from .core import (AnalysisContext, CHECKERS, Finding, RunResult,
                   SARIF_VERSION, SCHEMA_VERSION, register, run_checkers,
                   to_json_text, to_sarif, to_sarif_text)

# importing the checker modules registers them
from . import layering as _layering          # noqa: F401,E402
from . import hostsync as _hostsync          # noqa: F401,E402
from . import collectives as _collectives    # noqa: F401,E402
from . import witness as _witness            # noqa: F401,E402
from . import spancov as _spancov            # noqa: F401,E402
from . import ledgercov as _ledgercov        # noqa: F401,E402
from . import errors as _errors              # noqa: F401,E402
from . import concurrency as _concurrency    # noqa: F401,E402
from . import envknobs as _envknobs          # noqa: F401,E402
from . import specialization as _specialization  # noqa: F401,E402

__all__ = ["AnalysisContext", "CHECKERS", "Finding", "RunResult",
           "SARIF_VERSION", "SCHEMA_VERSION", "register", "run_checkers",
           "to_json_text", "to_sarif", "to_sarif_text"]
