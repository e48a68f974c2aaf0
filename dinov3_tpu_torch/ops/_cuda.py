"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each kernel is a ``.cu`` file with a plain C interface. ``nvcc`` compiles
it for Hopper (``sm_90a``) into a shared library under ``build/kernels/``
at the repository root, named by the hash of its source, of every header
it includes with quotes (``csrc/hopper.cuh``), and of the flags, so an
edited source or header never loads a stale build, and ``ctypes`` loads
it. Nothing is
built when this module is imported: a kernel is built at its first
launch, or all of them at once, in parallel, by ``build_kernels``.

Each ``CudaKernel`` keeps ``launches``, the number of launches its wrapper
made, so a run can show which kernels its path went through. A second C
entry point of the same source names the first as ``built_by`` and loads
its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -split-compile=0: the optimizer and ptxas work on a source's kernels in
# parallel, one thread a CPU; the longest build, flash_fwd.cu's, shortens,
# and the kernels keep their registers and times (PERF.md §6)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list[Path]:
    """The source and every header it includes with quotes, transitively,
    each once, in the order first met (quoted includes resolve beside the
    file that names them)."""
    found, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


class CudaKernel:
    """One kernel: its source, its built library and its launch count."""

    def __init__(self, name: str, source: str, argtypes: list,
                 built_by: CudaKernel | None = None):
        self.name = name
        self.source = _CSRC / source
        self.argtypes = argtypes
        self.built_by = built_by
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None

    @property
    def library(self) -> Path:
        if self.built_by is not None:
            return self.built_by.library
        digest = hashlib.sha1(
            b"".join(p.read_bytes() for p in source_files(self.source))
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def _tmp_library(self) -> Path:
        # per-process name, renamed into place: concurrent builds never
        # load a half-written library
        return self.library.with_suffix(f".{os.getpid()}.tmp")

    def _start_build(self) -> subprocess.Popen | None:
        if self.built_by is not None or self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp_library()),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{out}")
        os.replace(self._tmp_library(), self.library)

    def fn(self):
        """The loaded C entry point (built first if needed)."""
        if self._fn is None:
            build_kernels([self.built_by or self])
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, f"dinov3_{self.name}")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"dinov3_{self.name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch was refused."""
        code = self.fn()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name} launch failed: {self._err(code).decode()} "
                f"(cudaError {code})")
        self.launches += 1


def build_kernels(kernels: list[CudaKernel]) -> list[str]:
    """Build every kernel not yet built, one ``nvcc`` each, all started
    together. Returns the names of those built now."""
    started = [(k, proc) for k in kernels
               if (proc := k._start_build()) is not None]
    errors = []
    for k, proc in started:
        try:
            k._finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [k.name for k, _ in started]


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
