"""Build and run the C binding (csrc/host/cylon_cbind.c): a C program that
embeds the interpreter and drives ``cylon_tpu_torch.table_api`` by string
ids only — read_csv, join_tables (inner, on column 0), row_count,
write_csv — the second-language surface of the reference's JNI layer.

``build()`` compiles it with ``gcc`` (``$CC`` if set) into
``cylon_tpu_torch/_build/cylon_cbind-<hash>``; ``run(left, right, out,
device=None)`` runs it (on the card unless ``device="cpu"``) and returns
the joined row count. The compile and link flags come from ``sysconfig``
(the include directory, the shared ``libpython``, its directory and the
libraries it needs), not from ``python3-config``, which a machine may
lack. Where no ``libpython`` can be linked, ``build()`` raises with the
reason; nothing falls back.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from typing import List, Optional

from .status import Code, CylonError

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "host", "cylon_cbind.c")
BUILD_DIR = os.path.join(_HERE, "_build")
_ROOT = os.path.dirname(_HERE)


def flags() -> List[str]:
    """gcc's compile and link flags for embedding this interpreter: its
    include directory and its shared ``libpython``, from ``sysconfig``.
    Raises where there is none to link (a statically linked
    interpreter)."""
    cv = sysconfig.get_config_var
    if not cv("Py_ENABLE_SHARED"):
        raise CylonError(Code.ExecutionError,
                         "C binding: this interpreter is linked statically; "
                         "there is no libpython to embed")
    inc, libdir = cv("INCLUDEPY"), cv("LIBDIR")
    for path in (os.path.join(inc, "Python.h"),
                 os.path.join(libdir, cv("LDLIBRARY"))):
        if not os.path.exists(path):
            raise CylonError(Code.ExecutionError,
                             f"C binding: {path} is missing: cannot embed "
                             f"Python")
    libs = (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    return ["-I", inc, "-L", libdir,
            f"-lpython{cv('LDVERSION') or cv('VERSION')}",
            f"-Wl,-rpath,{libdir}", *libs]


def binary_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags()).encode()
                              ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"cylon_cbind-{digest}")


def build() -> str:
    """Compile the program if it is not built yet; its path."""
    path = binary_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cc = os.environ.get("CC") or "gcc"
    try:
        r = subprocess.run([cc, "-O2", SOURCE, "-o", tmp, *flags()],
                           capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise CylonError(Code.ExecutionError, f"C binding: {cc}: {e}")
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise CylonError(Code.ExecutionError,
                         f"C binding: {cc} failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def _env() -> dict:
    """The child's environment: this interpreter's home and module path,
    with the repository first, so the embedded interpreter imports what
    this one does."""
    paths = [_ROOT] + [p for p in sys.path if p and os.path.isdir(p)]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths),
                PYTHONHOME=os.pathsep.join([sys.base_prefix,
                                            sys.base_exec_prefix]))


def execute(left: str, right: str, out: str, device: Optional[str] = None,
            timeout: float = 600) -> str:
    """Run the program on two CSVs; its standard output. Raises with its
    output when it exits non-zero or prints no ``CBIND OK``."""
    r = subprocess.run([build(), left, right, out, device or "cuda"],
                       env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0 or "CBIND OK" not in r.stdout:
        raise CylonError(Code.ExecutionError,
                         f"C binding exited {r.returncode}:\n"
                         f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def run(left: str, right: str, out: str, device: Optional[str] = None
        ) -> int:
    """The inner join of two CSVs on column 0, written to ``out`` by the C
    program: the row count it printed."""
    stdout = execute(left, right, out, device)
    return int(stdout.split("rows=")[1].split()[0])
