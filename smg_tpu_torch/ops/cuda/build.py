"""Build the port's CUDA kernels from the repository's own sources.

One shared library with a plain C interface, compiled by ``nvcc`` for Hopper
(``sm_90a``) at first use and loaded with ``ctypes`` — a few seconds of
build, where an extension that includes PyTorch's headers takes minutes.
The library lands in ``smg_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  A build counts in the process capture counter
(``analysis/runtime_guards.py``): steady-state decode must build nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from smg_tpu_torch.analysis.runtime_guards import note_capture

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("decode_attention.cu", "prefill_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "smg_tpu_torch CUDA kernels are compiled from source at first use"
        )
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, src: Path, obj: Path, verbose: bool) -> subprocess.Popen:
    cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj), f"-I{CSRC}"]
    if verbose:
        cmd += ["-Xptxas", "-v"]  # registers, shared memory and spills per kernel
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build(verbose: bool = False) -> Path:
    """Compile every source (one ``nvcc`` per file, all started together),
    link them into ``libsmg_kernels_<hash>.so`` and return its path.  A
    library already built from the same sources is reused.  ``verbose``
    prints the compiler's per-kernel resource report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libsmg_kernels_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [_compile(nvcc, CSRC / s, o, verbose) for s, o in zip(SOURCES, objs)]
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            if verbose and out:
                print(out)
        staged = Path(tmp) / lib_path.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                *map(str, objs), "-o", str(staged)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(staged, lib_path)  # atomic: a concurrent build sees whole files
    note_capture()
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers and the stream are c_void_p: passed as plain ints they would be
    # cut to 32 bits
    lib.smg_decode_attention.argtypes = (
        [p] * 10 + [i] * 12 + [f, f, i, p]
    )
    lib.smg_decode_attention.restype = i
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.smg_decode_scratch.argtypes = [i] * 6 + [ll, ll]
    lib.smg_decode_scratch.restype = i
    lib.smg_prefill_attention.argtypes = (
        [p] * 9 + [i] * 11 + [f, f, p]
    )
    lib.smg_prefill_attention.restype = i


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib
