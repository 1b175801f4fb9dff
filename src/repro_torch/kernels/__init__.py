"""Hand-written CUDA kernels of the port, built at first use.

Each kernel is one CUDA C++ source under ``src/repro_torch/csrc/`` with a
plain C entry point that takes raw pointers, sizes and a stream and returns
``cudaGetLastError()``. :class:`CudaKernel` compiles that source with
``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the repo
root (keyed by a hash of the source and the flags, so an edited source
rebuilds), loads it with :mod:`ctypes`, and counts launches.

Dispatch is by the device of the tensors a wrapper is given, never by
``try``/``except``: a CPU tensor goes to the kernel's plain PyTorch version,
a CUDA tensor to the kernel. A failed build or launch raises.

Every kernel package registers its :class:`CudaKernel` in :data:`KERNELS`
when it is imported; :func:`build_all` builds the registered kernels with
one ``nvcc`` each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: name -> kernel, filled as the kernel packages are imported.
KERNELS: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


class CudaKernel:
    """One CUDA source, its shared library, its C entry point and its
    launch count.

    The source exports ``int <name>_launch(...)``, which returns the CUDA
    error code, with ``argtypes`` its ``ctypes`` argument types
    (``c_void_p`` for pointers and the stream), and
    ``const char* <name>_error_string(int)``.
    """

    def __init__(self, name: str, source: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes)
        self.launches = 0
        self.route_launches: Dict[str, int] = {}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        KERNELS[name] = self

    @property
    def source_path(self) -> pathlib.Path:
        return _CSRC / self.source

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source_path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return _BUILD_ROOT / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, pathlib.Path, pathlib.Path]]:
        out = self.library_path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _finish_build(self, job) -> None:
        proc, tmp, out = job
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source}:\n{log}")
        os.replace(tmp, out)

    def build(self) -> None:
        job = self._start_build()
        if job is not None:
            self._finish_build(job)

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, *args) -> None:
        """Call the C entry point; raise on a CUDA error. Counts nothing."""
        lib = self.lib
        rc = getattr(lib, f"{self.name}_launch")(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")

    def launch(self, *args, route: Optional[str] = None) -> None:
        """Call the C entry point; raise on a CUDA error, else count it (and
        its ``route``, for a kernel with more than one design)."""
        self.call(*args)
        self.launches += 1
        if route is not None:
            self.route_launches[route] = self.route_launches.get(route, 0) + 1


def build_all() -> List[str]:
    """Build every registered kernel, one ``nvcc`` each, started together.

    Returns the names built (those already cached are skipped)."""
    jobs = []
    for kernel in KERNELS.values():
        job = kernel._start_build()
        if job is not None:
            jobs.append((kernel, job))
    for kernel, job in jobs:
        kernel._finish_build(job)
    return [kernel.name for kernel, _ in jobs]


def launch_counts() -> Dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def reset_launch_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.route_launches = {}


def check_cuda_tensor(t, name: str, dtypes, ndim: int, device) -> None:
    """Validate a kernel argument before its pointer is handed to CUDA."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


from repro_torch.kernels import bsr_spmm, embedding_bag, flash_attention, frontier  # noqa: E402  (registers KERNELS)

__all__ = [
    "CudaKernel", "KERNELS", "NVCC_FLAGS", "build_all", "bsr_spmm", "check_cuda_tensor",
    "embedding_bag", "flash_attention", "frontier", "launch_counts", "reset_launch_counts",
]
