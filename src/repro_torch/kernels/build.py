"""Build and bind the port's CUDA kernels.

Each ``csrc/<source>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``: seconds per
source, where a source that includes PyTorch's headers takes minutes. A
source may export several kernels (``frontier_select.cu`` exports two). The build goes
into ``build/repro_torch/`` at the root of the checkout, keyed by a hash of
the source and the flags, so a changed source is never served a stale
library. Nothing is compiled when a module is imported: the first launch
builds its kernel, and :func:`build_all` builds every kernel at once, one
``nvcc`` per source, all started together.

Several processes may reach a kernel's first launch at once (the crawl
group's ranks, one a card, in one checkout). A library is built under an
exclusive ``fcntl`` lock on ``<library>.lock`` beside it: the first process
compiles, the others wait on the lock, find the library and load it. The
operating system releases the lock when its holder exits, so a build cut
off midway leaves no lock held.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on the PATH, then the
    toolkit's usual place. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from csrc/ at first use and need the CUDA "
                       "toolkit (set CUDA_HOME)")


class Kernel:
    """One hand-written kernel: its source, its library, and the count of
    its launches (``launches``, a plain integer the caller may reset).
    ``csrc/<source>.cu`` exports ``<name>_launch`` and ``<source>_error``;
    several kernels may share one source, and so one library."""

    def __init__(self, name: str, n_ptr: int, n_int: int, *,
                 source: Optional[str] = None):
        self.name = name
        self.stem = source or name
        self.source = CSRC / f"{self.stem}.cu"
        self._argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_void_p])            # + the stream
        self._fn = None
        self._err = None
        self.launches = 0
        self.build_log = ""

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional["_Build"]:
        """Start ``nvcc`` for this kernel unless its library exists. Waits
        for the library's lock first: a process that finds the library
        built by another returns None."""
        library = self.library
        if library.exists():
            return None
        library.parent.mkdir(parents=True, exist_ok=True)
        lock = open(library.with_name(library.name + ".lock"), "w")
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if library.exists():
                lock.close()
                return None
            tmp = library.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except BaseException:
            lock.close()
            raise
        return _Build(proc, tmp, library, lock)

    def finish_build(self, build: Optional["_Build"]) -> None:
        """Wait for ``nvcc``, move its library into place and release the
        lock; raises when it failed."""
        if build is None:
            return
        try:
            out, _ = build.proc.communicate()
            self.build_log = out
            if build.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
            os.replace(build.tmp, build.library)
        finally:
            build.lock.close()

    def _load(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.stem}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry on the current stream, raise on a CUDA error,
        and count the launch."""
        import torch
        fn = self._load()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc} ({self._err(rc).decode()})")
        self.launches += 1


class _Build(NamedTuple):
    """One running ``nvcc``: its process, the file it writes, the library
    that file becomes, and the held lock."""
    proc: subprocess.Popen
    tmp: Path
    library: Path
    lock: object


def build_all(kernels: Iterable[Kernel]) -> Dict[str, float]:
    """Build every library in parallel, one ``nvcc`` per source; returns
    {kernel name: seconds} (0 for a library that already existed)."""
    t0 = time.time()
    kernels = list(kernels)
    by_library = {}
    for k in kernels:
        by_library.setdefault(k.library, k)
    procs = [(k, k.start_build()) for k in by_library.values()]
    secs = {}
    for k, p in procs:
        k.finish_build(p)
        secs[k.library] = 0.0 if p is None else time.time() - t0
    for k in kernels:
        k.build_log = by_library[k.library].build_log
    return {k.name: secs[k.library] for k in kernels}


def build_sources(texts: Dict[str, str],
                  out: Path) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Build each source of ``texts`` ({name: CUDA C++ text}, such as a
    kernel's design variants) into ``out`` with the kernels' flags, one
    ``nvcc`` per source, all started together; returns {name: (the loaded
    library, nvcc's output)}. Raises if one does not build."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), log)
    return libs
