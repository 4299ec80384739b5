"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import), into ``build/surtr_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so a source
change rebuilds. A failing ``nvcc`` raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "surtr_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No FMA contraction: the clip fold's cut points must stay bitwise
    # sign-symmetric, and the other kernels then round like the plain
    # PyTorch versions (one rounding per multiply and per add).
    "-fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the last build in this process
build_log = ""         # nvcc output of the last build (ptxas register use)


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as fh:
                h.update(os.path.basename(s).encode())
                h.update(fh.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libsurtr_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            cmds, objs = [], []
            for src in (s for s in srcs if s.endswith(".cu")):
                obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
                cmds.append([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src])
                objs.append(obj)
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            rcs = [p.returncode for p in procs]
            if not any(rcs):
                link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-o", tmp, *objs]
                proc = subprocess.run(link, capture_output=True, text=True)
                cmds.append(link)
                logs.append(proc.stdout + proc.stderr)
                rcs.append(proc.returncode)
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(" ".join(c) + "\n" + log for c, log in zip(cmds, logs))
            with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as fh:
                fh.write(build_log)
            if any(rcs):
                raise RuntimeError(f"nvcc failed ({rcs}):\n{build_log}")
            os.replace(tmp, so)
        else:
            build_seconds = 0.0
        _lib = ctypes.CDLL(so)
        return _lib


def bind(name: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``name`` with its ctypes signature set."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
