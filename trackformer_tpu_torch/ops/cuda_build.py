"""Build and load the port's CUDA kernels.

Each kernel is one source under `csrc/` with a plain C interface. At first
use it is compiled with nvcc for `sm_90a` into `_build/` beside this
package, under a name keyed by a hash of the source, of the `csrc/` headers
it includes and of the flags, and loaded with ctypes. Nothing builds at import. `build_all` starts one nvcc
per source that is not built yet, all at once, and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# device helpers shared by the MSDA kernels
MSDA_COMMON = "msda_common.cuh"

# ctypes signature of one C entry point: (restype, argtypes)
Signature = Tuple[type, Sequence[type]]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


class CudaLib:
    """One `csrc/` source, the `csrc/` headers it includes, its build and
    its loaded library."""

    def __init__(self, source: str, signatures: Dict[str, Signature],
                 headers: Sequence[str] = ()):
        self.source = CSRC_DIR / source
        self.headers = [CSRC_DIR / h for h in headers]
        self.signatures = signatures
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def so_path(self) -> Path:
        # a header that changes without its source changing is another
        # library, so the headers are in the key
        key = hashlib.sha256(
            b"".join(f.read_bytes() for f in [self.source, *self.headers])
            + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.source.stem}_{key[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self.lib is None:
            build_all([self])
        return self.lib

    def _open(self, so: Path, seconds: float) -> None:
        lib = ctypes.CDLL(str(so))
        for name, (restype, argtypes) in self.signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        self.lib, self.path, self.build_seconds = lib, so, seconds

    def info(self) -> dict:
        """Where the library is, how long its build took (seconds, None
        before the first load), and what ptxas reported."""
        return {"source": os.path.relpath(self.source, _PKG.parent),
                "path": None if self.path is None else str(self.path),
                "seconds": self.build_seconds, "log": self.build_log}


def build_all(libs: Sequence[CudaLib]) -> None:
    """Build every library of `libs` not loaded yet, with one nvcc process
    per source running at the same time, then load them. Raises if any
    build fails."""
    t0 = time.perf_counter()
    running = []
    for lib in libs:
        if lib.lib is not None:
            continue
        so = lib.so_path()
        if so.exists():
            lib._open(so, time.perf_counter() - t0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I",
                                     str(CSRC_DIR), "-o", str(tmp),
                                     str(lib.source)], stdout=fh,
                                    stderr=subprocess.STDOUT)
        running.append((lib, so, tmp, log, proc))
    failed = []
    try:
        while running:
            time.sleep(0.05)
            for item in [r for r in running if r[4].poll() is not None]:
                running.remove(item)
                lib, so, tmp, log, proc = item
                lib.build_log = log.read_text().strip()
                log.unlink()
                if proc.returncode != 0:
                    failed.append(f"{lib.source.name} (nvcc "
                                  f"{proc.returncode}):\n{lib.build_log}")
                    continue
                os.replace(tmp, so)
                lib._open(so, time.perf_counter() - t0)
    finally:
        for *_, proc in running:  # only after an interruption
            proc.kill()
            proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
