"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>-<hash>.so``
with a plain C interface: no PyTorch headers, so a build takes seconds, not
minutes.  The hash covers every source and header under ``csrc/`` and the
compiler flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source, all at once, and waits
for them together; ``library(name)`` builds on first use and caches the
loaded handle for the process.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
SOURCES = ("support", "peel", "intersect", "kcore")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong

#: C signatures: (argtypes, restype) of every exported function
_SIGNATURES = {
    "support": {
        "support_accumulate_launch": ([_VOID] * 9 + [_INT, _INT, _INT,
                                                     _VOID], _INT),
        "support_error_string": ([_INT], ctypes.c_char_p),
    },
    "peel": {
        "peel_decrement_fold_launch": ([_VOID] * 15 + [_INT, _VOID], _INT),
        "sparse_update_launch": ([_VOID] * 15 + [_INT, _INT, _VOID], _INT),
        "dense_update_launch": ([_VOID] * 12 + [_INT, _INT, _VOID], _INT),
        "peel_loop_launch": ([_VOID] * 16 + [_INT, _INT, _INT, _VOID], _INT),
        "peel_loop_grid": ([_VOID, _VOID], _INT),
        "peel_error_string": ([_INT], ctypes.c_char_p),
    },
    "intersect": {
        "intersect_i32_launch": ([_VOID] * 6 + [_LL, _INT, _INT, _INT, _VOID],
                                 _INT),
        "intersect_i16_launch": ([_VOID] * 6 + [_LL, _INT, _INT, _INT, _VOID],
                                 _INT),
        "intersect_error_string": ([_INT], ctypes.c_char_p),
    },
    "kcore": {
        "kcore_launch": ([_VOID] * 8 + [_INT, _VOID], _INT),
        "kcore_error_string": ([_INT], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_loaded: dict = {}


class KernelError(RuntimeError):
    """A kernel of the port did not build, load or launch.

    Not a transient fault: the serving layer never retries it or demotes
    past it (``serve.resilience.PERMANENT_ERRORS``), so a request whose
    tensors are on the card fails instead of giving way to the plain
    versions or the host.
    """


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no current library, in parallel.

    Returns ``{name: compiler output}`` for the sources it compiled (the
    ``-Xptxas -v`` register and spill report); raises :class:`KernelError`
    with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernels: {e}") \
                    from e
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise :class:`KernelError` on a non-zero ``cudaGetLastError``."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise KernelError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


class LaunchCounts:
    """How often a kernel module ran its CUDA kernel and its plain version.

    Each thread counts on its own: ``launched`` (called only where the
    wrapper launches the hand-written kernel) and ``ran_plain`` (a call of
    the plain PyTorch version) add to the calling thread's counts, which
    ``mine`` reads; ``kernel`` and ``plain`` are the sums over every thread.
    A run resets them and reads them afterwards to prove which path it
    took.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads: list[list[int]] = []   # [kernel, plain] per thread

    def _counts(self) -> list[int]:
        c = self._local.__dict__.get("c")
        if c is None:
            c = self._local.c = [0, 0]
            with self._lock:
                self._threads.append(c)
        return c

    def launched(self) -> None:
        """Count one launch of the kernel on the calling thread."""
        self._counts()[0] += 1

    def ran_plain(self) -> None:
        """Count one call of the plain version on the calling thread."""
        self._counts()[1] += 1

    @property
    def kernel(self) -> int:
        """Kernel launches, over every thread."""
        with self._lock:
            return sum(c[0] for c in self._threads)

    @property
    def plain(self) -> int:
        """Plain-version calls, over every thread."""
        with self._lock:
            return sum(c[1] for c in self._threads)

    def mine(self) -> dict:
        """``{"kernel": n, "plain": n}`` of the calling thread."""
        c = self._counts()
        return {"kernel": c[0], "plain": c[1]}

    def reset(self) -> None:
        """Set every thread's counts to 0."""
        with self._lock:
            for c in self._threads:
                c[0] = c[1] = 0

    def as_dict(self) -> dict:
        """``{"kernel": n, "plain": n}``, over every thread."""
        return {"kernel": self.kernel, "plain": self.plain}


def check_int32(name: str, t, device, shape=None) -> None:
    """Validate one kernel operand: device, int32, contiguous, shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check_mask(name: str, t, device, shape) -> None:
    """Validate a byte mask operand (bool or uint8, contiguous, shape)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} must be bool or uint8, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
