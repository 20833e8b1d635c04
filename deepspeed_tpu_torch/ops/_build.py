"""Build the port's kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface, so ``nvcc``
builds it into a shared library in seconds (no PyTorch headers). The library
goes to ``build/kernels/`` beside the package, named by a hash of its source
and of the shared headers (``csrc/*.cuh``) so that an edited source never loads
a stale build. Building needs ``nvcc``
(on ``PATH``, under ``$CUDA_HOME`` or ``/usr/local/cuda``); nothing here runs
at import time.

Host sources, ``csrc/<name>.cpp`` (the ZeRO-Offload CPU Adam), are built by
``g++ -O3 -march=native -fopenmp -fno-math-errno`` into the same directory
(``load_host``).
Their key adds the CPU's architecture and feature flags to the source: a
``-march=native`` library built on one host is never loaded on a host with
other instructions. A failed build raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Build:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build of the same source was found
    log: str            # nvcc's output, with ptxas's registers and spills


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict:
    """Compile each named source that has no current build, all ``nvcc``
    processes at once. Returns name -> ``Build``; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started, done = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if so.exists():
            done[name] = Build(name, so, 0.0, "")
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, tmp, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)       # atomic: a concurrent loader sees all or nothing
        done[name] = Build(name, so, time.perf_counter() - t0, log)
    return done


_LIBS = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name].path))
        _LIBS[name] = lib
    return lib


# -fno-math-errno: sqrtf's errno branch keeps gcc from vectorizing a loop that
# calls it; without errno it emits the IEEE vector square root, the same bits
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fno-math-errno", "-std=c++17",
              "-shared", "-fPIC")


def _cpu_flags() -> bytes:
    """The host's architecture and the feature-flags line of /proc/cpuinfo."""
    key = platform.machine().encode()
    with open("/proc/cpuinfo", "rb") as f:
        for line in f:
            if line.startswith((b"flags", b"Features")):
                return key + line
    return key


def host_target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes() + _cpu_flags()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-host-{digest}.so"


def build_host(name: str) -> Build:
    """Compile ``csrc/<name>.cpp`` with g++ for this host unless a build for
    the same source and CPU exists; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = host_target(name)
    if so.exists():
        return Build(name, so, 0.0, "")
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: csrc/{name}.cpp is built at first use")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {name}.cpp (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return Build(name, so, time.perf_counter() - t0, proc.stdout + proc.stderr)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cpp``, built first if needed."""
    key = f"host:{name}"
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build_host(name).path))
        _LIBS[key] = lib
    return lib
