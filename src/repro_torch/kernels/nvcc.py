"""Build the port's CUDA C++ kernels with nvcc and bind them with ctypes.

Each source `kernels/csrc/<name>.cu` has a plain C interface and is
compiled for `sm_90a` into its own shared library under the ignored
`kernels/build/`, named by a hash of the source, the headers of `csrc/` and
the flags, so an unchanged source is built once. `CudaLibrary.load()` runs nvcc if the
library is not built yet, loads it and sets its argument types; loads of
different libraries from different threads build in parallel. Nothing here
runs at import: the CPU tests import the kernel modules on machines with no
nvcc and no card.

Each `CudaLibrary` counts what it does: `builds` (nvcc runs) and `loads`
(0 or 1: the shared library is loaded once a process). `LIBRARIES` maps
each library's name to its `CudaLibrary`, process-wide, so a check can
read what the process has built and loaded without knowing the kernel
modules (`chip_smoke.py`'s launch phase holds that nvcc did not run while
the launcher served).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

__all__ = ["BUILD_DIR", "CSRC", "LIBRARIES", "NVCC_FLAGS", "CudaLibrary", "sm_count"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_sm_count: Dict[int, int] = {}  # device index -> SMs, for Hopper devices only
LIBRARIES: Dict[str, "CudaLibrary"] = {}  # name -> the process's one CudaLibrary of it


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels cannot be built"
    )


def sm_count(device: torch.device, kernel: str) -> int:
    """SMs of `device`; raise unless it is a Hopper card (sm_90)."""
    n = _sm_count.get(device.index)
    if n is None:
        if torch.cuda.get_device_capability(device) != (9, 0):
            raise RuntimeError(
                f"the {kernel} kernel is built for sm_90a (Hopper); "
                f"{torch.cuda.get_device_name(device)} is not one"
            )
        n = _sm_count[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


class CudaLibrary:
    """`csrc/<name>.cu`, built at first use; `bind(lib)` sets argtypes.

    The source exports `<name>_error_string(int)`, which `check` uses to
    name the CUDA error a launch function returned.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        LIBRARIES[name] = self
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.info: dict = {}  # path, seconds, cached, ptxas log of the build
        self.lib: Optional[ctypes.CDLL] = None
        self.builds = 0  # nvcc runs in this process
        self.loads = 0  # times the shared library was loaded: 0 or 1
        self._bind = bind
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """The loaded library; builds it first if needed (raises if nvcc fails)."""
        with self._lock:
            if self.lib is not None:
                return self.lib
            headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
            digest = hashlib.sha256(
                self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            out = BUILD_DIR / f"{self.name}_{digest}.so"
            t0, log, cached = time.perf_counter(), "", out.exists()
            if not cached:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                self.builds += 1
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                log = proc.stdout
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.source.name} ({proc.returncode}):\n{log}"
                    )
                os.replace(tmp, out)  # atomic: no reader sees half a file
            lib = ctypes.CDLL(str(out))
            getattr(lib, f"{self.name}_error_string").argtypes = [ctypes.c_int]
            getattr(lib, f"{self.name}_error_string").restype = ctypes.c_char_p
            self._bind(lib)
            self.info.update(path=str(out), seconds=time.perf_counter() - t0,
                             cached=cached, log=log)
            self.lib = lib
            self.loads += 1
            return lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error."""
        if rc != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
