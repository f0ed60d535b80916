"""ctypes binding for the native C++ radix index — the port's copy of
``smg_tpu/kv_index/native.py``, over its own copy of the sources
(``smg_tpu_torch/csrc/radix_index.cpp``, ``smg_native.h``).

Reference analogue: the Rust ``crates/kv_index`` backing the gateway's
routing hot path.  The library is built at first use with the flags of the
repository's ``csrc/Makefile`` (``g++ -O2 -std=c++17 -fPIC -Wall
-shared``) into ``smg_tpu_torch/_build/`` (git-ignored), named by a hash of
the sources and flags; a file lock and an atomic rename let concurrent
processes (test workers, a gateway beside its workers) build it once and
never load a half-written file.  The reference's ``csrc/libsmg_native.so``
is never loaded.  Same interface as the Python tree, so the cache_aware
policy swaps implementations; ``SMG_NATIVE_RADIX=0`` forces Python, and
without a toolchain the factory falls back to the Python tree with the
reference's warning.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from smg_tpu_torch.utils import get_logger

logger = get_logger("kv_index.native")

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("radix_index.cpp",)
HEADERS = ("smg_native.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """``libsmg_radix_<hash>.so``: a hash of the flags and the sources."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsmg_radix_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the index unless a library of the same sources exists;
    returns its path.  Raises when no compiler is found or it fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libsmg_radix.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build across processes
        if path.exists():  # another process built it while this one waited
            return path
        fd, staged = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.part")
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", staged, *(str(CSRC / s) for s in SOURCES)],
                           check=True, capture_output=True, timeout=120)
            os.replace(staged, path)  # atomic: a loader sees a whole file or none
        finally:
            if os.path.exists(staged):
                os.unlink(staged)
    return path


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if os.environ.get("SMG_NATIVE_RADIX") == "0":
            return None
        try:
            path = build()
        except Exception as e:
            logger.warning("native radix build failed (%s); using Python tree", e)
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native radix load failed (%s); using Python tree", e)
            return None
        lib.rt_new.restype = ctypes.c_void_p
        lib.rt_new.argtypes = [ctypes.c_size_t]
        lib.rt_free.argtypes = [ctypes.c_void_p]
        lib.rt_insert.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
            ctypes.c_uint32,
        ]
        lib.rt_match.restype = ctypes.c_size_t
        lib.rt_match.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
        ]
        lib.rt_remove_worker.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rt_size.restype = ctypes.c_size_t
        lib.rt_size.argtypes = [ctypes.c_void_p]
        _lib = lib
        logger.info("native radix index loaded (%s)", path)
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeRadixTree:
    """Same interface as ``kv_index.RadixTree`` — str/token sequences in,
    per-worker matched lengths out — backed by the C++ tree."""

    MAX_WORKERS = 1024

    def __init__(self, max_size: int = 2**20):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native radix library unavailable")
        self._lib = lib
        self.max_size = max_size  # the element budget handed to the C++ tree
        self._tree = lib.rt_new(max_size)
        self._worker_ids: dict[str, int] = {}
        self._worker_names: dict[int, str] = {}
        self._lock = threading.Lock()
        # reused output buffers (per-call ctypes allocation measured hot)
        self._out_w = (ctypes.c_uint32 * self.MAX_WORKERS)()
        self._out_l = (ctypes.c_uint32 * self.MAX_WORKERS)()

    def __del__(self):
        tree = getattr(self, "_tree", None)
        if tree:
            self._lib.rt_free(tree)
            self._tree = None

    def _wid(self, worker: str) -> int:
        with self._lock:
            wid = self._worker_ids.get(worker)
            if wid is None:
                wid = len(self._worker_ids) + 1
                self._worker_ids[worker] = wid
                self._worker_names[wid] = worker
            return wid

    @staticmethod
    def _encode(seq):
        """Marshal a str/int sequence to a C uint32 pointer (numpy-backed:
        per-element ctypes construction dominated the call cost)."""
        import numpy as np

        if isinstance(seq, str):
            arr = np.frombuffer(seq.encode("utf-32-le"), dtype=np.uint32)
        elif isinstance(seq, np.ndarray):
            arr = np.ascontiguousarray(seq, dtype=np.uint32)
        else:
            arr = np.fromiter(seq, dtype=np.uint32, count=len(seq))
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(arr), arr

    def insert(self, seq, worker_id: str) -> None:
        ptr, n, _keepalive = self._encode(seq)
        self._lib.rt_insert(self._tree, ptr, n, self._wid(worker_id))

    def prefix_match(self, seq) -> dict[str, int]:
        ptr, n, _keepalive = self._encode(seq)
        with self._lock:
            count = self._lib.rt_match(
                self._tree, ptr, n, self._out_w, self._out_l, self.MAX_WORKERS
            )
            result = {}
            for i in range(count):
                name = self._worker_names.get(self._out_w[i])
                if name is not None:
                    result[name] = self._out_l[i]
        return result

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            wid = self._worker_ids.get(worker_id)
        if wid is not None:
            self._lib.rt_remove_worker(self._tree, wid)

    @property
    def size(self) -> int:
        return self._lib.rt_size(self._tree)

    def stats(self) -> dict:
        """Python-tree-compatible stats; the C++ tree exposes element count
        only (node/eviction counters stay None — collectors skip them)."""
        return {
            "elements": self.size,
            "nodes": None,
            "evicted_elements": None,
            "max_size": None,
        }


def make_radix_tree(max_size: int = 2**20):
    """Factory: native tree when available, Python tree otherwise."""
    if native_available():
        try:
            return NativeRadixTree(max_size)
        except RuntimeError:
            pass
    from smg_tpu_torch.kv_index.radix_tree import RadixTree

    return RadixTree(max_size)
