"""Device policy and the CUDA build helper.

Device policy: every public entry point runs on ``cuda`` unless the caller
passes ``device="cpu"``. When CUDA is absent and the caller did not ask for
the CPU, ``resolve_device`` raises; nothing ever slips onto the CPU.

Build: the hand-written kernels live as CUDA C++ sources under
``core/csrc/``. They are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a plain shared library with a C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``build/lightgbm_tpu_torch/`` at the root of the checkout, keyed by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
is reused. A failed build raises with ``nvcc``'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "core" / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lightgbm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lightgbm_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % (device,))
    return dev


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc was not found (set CUDA_HOME); the CUDA "
                           "kernels of lightgbm_tpu_torch cannot be built")
    return found


def _library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s-%s" % (name, h.hexdigest()[:16])) / ("lib%s.so" % name)


class BuildRecord:
    """What one build did: the library, its seconds, and nvcc's report."""

    def __init__(self, name: str, path: Path, seconds: float, log: str):
        self.name, self.path, self.seconds, self.log = name, path, seconds, log


_LOADED: Dict[str, ctypes.CDLL] = {}


def build_libraries(specs: Dict[str, List[str]]) -> Dict[str, BuildRecord]:
    """Build every library of ``specs`` ({name: [source file names under
    core/csrc]}) that is not built yet, one ``nvcc`` per library, all
    started together. Returns the build records of this call."""
    pending = {}
    for name, files in specs.items():
        sources = [CSRC_DIR / f for f in files]
        path = _library_path(name, sources)
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".so.%d.tmp" % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, path, time.perf_counter())
    done = {}
    for name, (proc, tmp, path, t0) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed to build %s (exit %d):\n%s"
                               % (name, proc.returncode, out))
        os.replace(tmp, path)
        done[name] = BuildRecord(
            name, path, time.perf_counter() - t0, out)
    return done


def load_library(name: str, files: List[str]) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``files`` on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_libraries({name: files})
        lib = ctypes.CDLL(str(_library_path(name, [CSRC_DIR / f
                                                   for f in files])))
        _LOADED[name] = lib
    return lib


def current_stream(device: Optional[torch.device] = None) -> int:
    """PyTorch's current CUDA stream as the integer a C launcher takes."""
    return torch.cuda.current_stream(device).cuda_stream
