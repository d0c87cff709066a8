"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with plain ``nvcc`` into a shared library with a C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

A source may include the shared headers ``csrc/*.cuh``.  The library file
is named after a hash of the source, the headers and the flags, so a
changed source or header is rebuilt and a stale library is never loaded.
The build directory is git-ignored.  A build failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ctypes signature of each library's entry points: name -> (argtypes, restype)
_P = ctypes.c_void_p
_I = ctypes.c_int
_PLAN = ctypes.POINTER(ctypes.c_int)  # a host int[]: a plan's as_c()
SIGNATURES = {
    "conv_fused": {
        "dpai_fused_conv3x3": (
            # x, w, mul, off, pre_mul, pre_add, out, part, n, h, w, c, f,
            # relu, is_bf16, plan (int[6]), stream
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _PLAN, _P], _I),
    },
    "stage_fused": {
        "dpai_fused_up_stage": (
            # y, skip, ka, mula, offa, kb, mulb, offb, a, out, part, n, hh,
            # wh, c, cs, f, relu, is_bf16, plan_a, plan_b, stream
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _I, _PLAN, _PLAN, _P], _I),
    },
    "bilateral": {
        "dpai_bilateral_message": (
            # q, img, out, h, w, L, l0, nl, r, a, cc, plan (int[3]:
            # BilateralPlan.as_c), stream
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             ctypes.c_float, _PLAN, _P], _I),
    },
}

#: ptxas resource report (registers, shared memory, spills) of each build
build_logs: dict = {}
#: seconds each build took
build_seconds: dict = {}

#: guards every launch count's read-modify-write: kernels launch from
#: tile mode's flusher threads beside the thread that runs the forwards
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel's
    wrapper; safe from any number of threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of digipathai_tpu_torch cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(repr(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        t0 = time.monotonic()
        r = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.monotonic() - t0
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {r.returncode}):\n"
                f"{r.stdout}\n{r.stderr}")
        build_logs[name] = r.stdout + r.stderr
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> dict:
    """Compile every source in ``SIGNATURES``, one ``nvcc`` each, all started
    together; returns ``{name: library path}`` and raises on any failure."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SIGNATURES)) as ex:
        return dict(zip(SIGNATURES, ex.map(build, SIGNATURES)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, load, and declare the entry points' signatures."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib
