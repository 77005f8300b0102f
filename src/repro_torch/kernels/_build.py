"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

Every ``csrc/*.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``). The file name carries a hash of the flags, the source
and the shared headers ``csrc/*.cuh``, so an edited source or header
builds anew and an unchanged one is reused. The
build runs on first use, never at import: nothing here needs ``nvcc``
until a CUDA tensor reaches a kernel. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together; the
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from source on first use"
    )


def sources() -> Dict[str, Path]:
    """Kernel name → ``.cu`` source, for every file in ``csrc/``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _library_path(src: Path) -> Path:
    """``BUILD_DIR/<name>-<hash>.so``: the hash covers the flags, the
    source and every header (``*.cuh``) beside it, so an edit to a
    shared header builds every library anew."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns name → library path; raises
    with the compiler's output if any build fails."""
    with _lock:
        return _build_missing()


def _build_missing() -> Dict[str, Path]:
    libs = {name: _library_path(src) for name, src in sources().items()}
    todo = [n for n, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        libs[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) of the last build of
    ``name``, or an empty string if it was not built here."""
    log = _library_path(sources()[name]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build_missing()[name]))
            _loaded[name] = lib
        return lib
