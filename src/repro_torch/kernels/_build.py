"""Build and load the port's CUDA kernels.

On first use, every ``csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source started together, and the
objects are linked into one shared library with a plain C interface.
The library is named by a hash of the sources and flags, so an unchanged
tree reuses it and a changed one rebuilds.  It is loaded with ``ctypes``:
pointers and the stream travel as ``c_void_p``, and each C function
returns ``cudaGetLastError()`` after its launch, which :func:`launch`
turns into an exception.

The build lands in ``kernels/build/`` beside this file (listed in
``.gitignore``), with nvcc's ``-Xptxas -v`` report (registers, spills)
beside the library; nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C signature of every kernel entry point (all return an int error code)
SIGNATURES: Dict[str, tuple] = {
    "lsh_hash": (_P, _P, _P, _F, _I, _I, _I, _P, _P),
    # x, eta, mixers, inv_cell, n, d, t, directory (updated in place), cap,
    # updates (consumed), n_updates, out, stream: the engine's hash pass,
    # keys and directory probes in one cooperative launch
    "lsh_hash_resolve": (_P, _P, _P, _F, _I, _I, _I, _P, _I, _P, _I, _P, _P),
    "slot_counts": (_P, _LL, _I, _P, _P),
    "bucket_core_stats": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # slots, n, t, sizes (updated in place), nb, k, out, stream: the
    # engine's insert pass, both bucket kernels in one cooperative launch
    "bucket_insert_pass": (_P, _I, _I, _P, _I, _I, _P, _P),
    # slots, row mask (u8), n, t, sizes, core sizes (both updated in
    # place), nb, k, out, stream: the sampled-core engine's insert pass
    "bucket_insert_pass_masked": (_P, _P, _I, _I, _P, _P, _I, _I, _P, _P),
    # x, n, d, thr, scratch, out, then pairwise_dist.plan: whole, kc,
    # n_tiles, pairs, grid, smem bytes; stream
    "eps_neighbor_counts": (_P, _I, _I, _F, _P, _P, _I, _I, _I, _LL, _I,
                            _I, _P),
    # q, k, v, out, b, hq, hkv, sq, skv, dh, causal, has_window, window,
    # q_offset, scale, stream: the f32 route (CUDA cores) ...
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _P),
    # ... and the bf16 route (wgmma and TMA)
    "flash_attention_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _F, _P),
}
#: entry points that are a route of other kernels, counted under each of
#: them: one fused insert pass (either route) is a launch of both bucket
#: kernels, one hash-and-resolve pass a launch of ``lsh_hash``
ROUTE_OF: Dict[str, Tuple[str, ...]] = {
    "lsh_hash_resolve": ("lsh_hash",),
    "flash_attention_sm90": ("flash_attention",),
    "bucket_insert_pass": ("slot_counts", "bucket_core_stats"),
    "bucket_insert_pass_masked": ("slot_counts", "bucket_core_stats"),
}
#: the kernels, each counted once whichever entry point launched it
KERNELS = tuple(name for name in SIGNATURES if name not in ROUTE_OF)

#: launches per kernel since the last reset — incremented by
#: :func:`launch` and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: launches per C entry point (which route of a kernel ran)
ENTRY_LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: each kernel's ``<name>_launch`` entry point, resolved once by :func:`load`
_entry: Dict[str, Any] = {}
#: wall seconds the last build took (0.0 when an existing library was
#: reused)
build_seconds = 0.0


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / name)] if home else []
    cands += [shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on "
                       "PATH); the CUDA kernels cannot be built")


def _sources() -> list:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build_log() -> str:
    """nvcc's output for the current library (``-Xptxas -v``: registers,
    shared memory and spills of every kernel), kept beside it."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = cuda_tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for src, _obj, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            logs.append(f"== {src.name}\n{log}")
            if p.returncode:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        out.with_suffix(".log").write_text("\n".join(logs))
        part = Path(tmp) / out.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared",
                        *[str(o) for _s, o, _p in procs], "-o", str(part)],
                       check=True, capture_output=True)
        os.replace(part, out)  # atomic: a concurrent loader sees all or none


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use; raises if it cannot be
    built or loaded."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            t0 = time.perf_counter()
            _compile(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name + "_launch")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entry[name] = fn
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point and count the launch; raises
    if the launch was refused."""
    fn = _entry.get(name)
    if fn is None:  # first launch: build and load (under the lock)
        load()
        fn = _entry[name]
    err = fn(*args)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err}")
    for kernel in ROUTE_OF.get(name, (name,)):
        LAUNCHES[kernel] += 1
    ENTRY_LAUNCHES[name] += 1


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES):
        for name in counts:
            counts[name] = 0
