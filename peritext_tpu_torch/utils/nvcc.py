"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``peritext_tpu_torch/_build/<name>-<hash>.so``, a library with a plain C
interface that :func:`load_library` opens with ``ctypes``.  The hash covers
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is reused.  Nothing is
built when a module is imported: the first call of a kernel wrapper builds
(the tests import every module on machines with no CUDA toolkit).  Each
``nvcc`` run and each library load logs one record on the
``peritext_tpu_torch.kernels`` logger, which ``obs.RecompileSentinel``
counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

from .capture import captured

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

class KernelBuildError(RuntimeError):
    """A CUDA source failed to build, or its library failed to load.  A
    fault of the installation, not of a device round: callers that contain
    round failures (the guarded session) let it through."""


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: build and load records (obs/sentinel.py counts them)
_log = logging.getLogger("peritext_tpu_torch.kernels")
_launch_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    header in ``csrc/`` (an edited shared header must not load a stale
    library) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, Path]:
    """Build every named source that has no current library, one ``nvcc``
    per source, all started together.  Returns each library's path; the
    compiler's report (``-Xptxas -v``) lands beside it as ``.log``.
    Raises :class:`KernelBuildError` with the compiler's output if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    jobs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        _log.info("Building %s with nvcc into %s", name, out.name)
        jobs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in jobs.items():
        report, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, paths[name])  # atomic: a concurrent build sees all or nothing
    if failed:
        raise KernelBuildError("CUDA build failed: " + "\n".join(failed))
    return paths


@captured
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Raises :class:`KernelBuildError` if it cannot be built or loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_libraries([name])[name]
            _log.info("Loading %s from %s", name, path.name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path.name}: {exc}") from exc
            _loaded[name] = lib
        return lib


#: per thread, the launch tally of a CUDA-graph capture in progress
#: (utils/graphs.py): a captured launch does not run, so it is tallied for
#: the graph, whose replays add it to the wrapper's count
_capturing = threading.local()


@captured
def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count a kernel wrapper
    keeps, under a lock: an editor's change queue launches from its timer
    thread while the caller's thread may launch too.  A launch made while
    this thread captures a CUDA graph goes to the capture's tally instead
    (:func:`launch_tally`)."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    add_launches(wrapper, 1)


def add_launches(wrapper, n: int) -> None:
    """Add ``n`` launches to ``wrapper.launches`` (a graph replay adds the
    launches its capture tallied)."""
    with _launch_lock:
        wrapper.launches += n


class launch_tally:
    """Context manager: while it is open, this thread's kernel launches are
    tallied in the ``dict`` it yields (wrapper -> launches) and not
    counted on the wrappers."""

    def __enter__(self) -> dict:
        self._prev = getattr(_capturing, "tally", None)
        _capturing.tally = {}
        return _capturing.tally

    def __exit__(self, *exc_info) -> None:
        _capturing.tally = self._prev
