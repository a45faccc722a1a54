"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

The ``.cu`` files under ``effectivediffusivityfvm_tpu_torch/csrc/`` expose a
plain C interface (no PyTorch headers, so a build takes seconds).  They are
compiled for ``sm_90a`` into ``<checkout>/build/kernels/`` the first time a
wrapper needs them, one ``nvcc -c`` per source, all started together, then
linked into one shared library; the library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "SOURCE_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: the kernels round every multiply and add as the plain
# PyTorch versions' separate elementwise ops do, so the two agree bit for
# bit outside the (double) reductions.  With contraction on, the V-cycle on
# a contrast-1e6 medium moved by 4e-4 of max|z| in fp32; the passes are
# bandwidth-bound, so the lost FMAs cost no time.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# C entry points and their argument types; every pointer (and the stream)
# goes as c_void_p so ctypes never narrows it to a 32-bit int.
_ENTRIES = {
    "deff_cycle_scratch_elems": ([_I, _P, _P], ctypes.c_longlong),
    "deff_cycle_resident_from": ([_I, _P, _P, _I], _I),
    "deff_cg_scratch_elems": ([_I, _P, _P, _I], ctypes.c_longlong),
    "deff_cg_tiled_scratch_elems": ([_I, _P, _P, _I], ctypes.c_longlong),
    "deff_cycle_tiled_scratch_elems": ([_I, _P, _P], ctypes.c_longlong),
    "deff_window_iter_count": ([], ctypes.c_longlong),
    "deff_launch_count": ([], ctypes.c_longlong),
    "deff_cycle_count": ([], ctypes.c_longlong),
    "deff_image_cycle_count": ([], ctypes.c_longlong),
    "deff_cycle3_count": ([], ctypes.c_longlong),
    "deff_cycle3_scratch_elems": ([_I, _P, _P, _P], ctypes.c_longlong),
    "deff_cycle3_resident_from": ([_I, _P, _P, _P, _I], _I),
    "deff_cg3d_scratch_elems": ([_I, _P, _P, _P, _I], ctypes.c_longlong),
    "deff_march3_seg_len": ([_I, _I, _I, _I, _I], _I),
    "deff_march3_level_seg_len": ([_I, _I, _I, _I], _I),
    "deff_march3_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
    "deff_shard_tiles": ([_I, _I], _I),
    "deff_shard_row_max": ([], _I),
    # K9's window ring (csrc/cgstep_sharded.cu)
    "deff_shard_ring_new": ([], _P),
    "deff_shard_ring_free": ([_P], None),
    "deff_shard_ring_flag": ([_P, _I], _P),
    "deff_shard_ring_mark": ([_P, _I, _P], _I),
    "deff_shard_ring_live": ([_P, _I], _I),
}
for _t in ("f32", "f64"):
    # K8's row entries take per shard a table of pointers and one of image
    # strides (ops/kernels/vcycle_sharded.py, ShardRow)
    _ENTRIES[f"deff_shard_row_t1_{_t}"] = (
        [_I, _I, _I, _I,            # shards, B, ny_local, nx
         _P, _P,                    # pointer table, stride table
         _P, _I, _P], _I)           # ws[], nu, stream
    _ENTRIES[f"deff_shard_row_t2_{_t}"] = (
        [_I, _I, _I, _I,            # shards, B, ny_local, nx
         _P, _P,                    # pointer table, stride table
         _P, _I, _D, _P], _I)       # ws[], nu, over, stream
    _ENTRIES[f"deff_shard_abs_parts_{_t}"] = (
        [_I, _I, _I, _P, _P,        # B, ny_local, nx, r, partials
         _I, _I, _P], _I)           # partials per image, offset, stream
    _ENTRIES[f"deff_shard_fin_{_t}"] = (
        [_I, _I, _P, _I,            # kind, B, state[], partials per image
         _P, _P, _P], _I)           # active (init only), window flag, stream
    _ENTRIES[f"deff_shard_select_{_t}"] = (
        [_I, _I,                    # B, cells a plane
         _P, _P, _P,                # r (out), r buffers 0 and 1
         _P, _P, _P,                # p (out), p buffers 0 and 1
         _P, _P], _I)               # parity per image, stream
    # K9's passes take per shard of a launch a table of pointers and one of
    # image strides (ops/kernels/cgstep_sharded.py, ShardWorkspace), and
    # each shard's place in the row
    _ENTRIES[f"deff_shard_p_{_t}"] = (
        [_I, _I, _I, _I, _I,        # shards, shards of the row, B, ny_l, nx
         _P, _P, _P,                # pointer table, stride table, places
         _P, _P], _I)               # state[], stream
    _ENTRIES[f"deff_shard_x_{_t}"] = (
        [_I, _I, _I, _I, _I,        # shards, shards of the row, B, ny_l, nx
         _P, _P, _P,                # pointer table, stride table, places
         _P, _P, _I, _P], _I)       # state[], ws[], nu, stream
    _ENTRIES[f"deff_shard_z_{_t}"] = (
        [_I, _I, _I, _I, _I,        # shards, shards of the row, B, ny_l, nx
         _P, _P, _P,                # pointer table, stride table, places
         _P, _P, _I, _D, _P], _I)   # state[], ws[], nu, over, stream
    _ENTRIES[f"deff_v_cycle_{_t}"] = (
        [_I, _I, _P, _P,            # B, L, ny[], nx[]
         _P, _P, _P,                # aw[], an[], dinv[] (pointer arrays)
         _P, _P, _P,                # r, z, scratch
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P, _P], _I)               # flag (int32 per image, or null), stream
    _ENTRIES[f"deff_v_cycle_tiled_{_t}"] = (
        [_I, _I, _P, _P,            # B, L, ny[], nx[]
         _P, _P, _P,                # aw[], an[], dinv[] (pointer arrays)
         _P, _P, _P,                # r, z, scratch
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P], _I)                   # stream
    _ENTRIES[f"deff_cg_steps_tiled_{_t}"] = (
        [_I, _I, _P, _P,            # B, L, ny[], nx[]
         _P, _P, _P,                # aw[], an[], dinv[] (pointer arrays)
         _P, _D, _D, _D, _I,        # D (or null), fx, fy, bcf, nxr
         _P, _P, _P, _P,            # x, r, p, rz
         _P, _P, _P, _I, _P,        # active, stop, hi, k, k_done
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P, _P, _P], _I)           # scratch, int scratch, stream
    _ENTRIES[f"deff_cg_steps_{_t}"] = (
        [_I, _I, _P, _P,            # B, L, ny[], nx[]
         _P, _P, _P, _P,            # aw[], an[], dinv[], b
         _P, _P, _P, _P,            # x, r, p, rz
         _P, _P, _P, _I,            # active, stop, hi, k
         _P, _P,                    # k_done, sum|r_true|
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P, _P, _P], _I)           # scratch, int scratch, stream
    _ENTRIES[f"deff_v_cycle3d_{_t}"] = (
        [_I, _I, _P, _P, _P,        # B, L, nz[], ny[], nx[]
         _P, _P, _P, _P,            # aw[], an[], au[], dinv[] (pointer arrays)
         _P, _P, _P,                # r, z, scratch
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P], _I)                   # stream
    _ENTRIES[f"deff_t1_3d_{_t}"] = (
        [_I, _I, _I, _I,            # B, nz, ny, nx
         _I, _I, _I,                # nz1, ny1, nx1 (levels[1])
         _P, _P, _P, _P,            # aw, an, au, dinv (level 0)
         _P, _P, _P,                # r, e, coarse residual
         _P, _I, _P], _I)           # ws[], nu, stream
    _ENTRIES[f"deff_t2_3d_{_t}"] = (
        [_I, _I, _I, _I,            # B, nz, ny, nx
         _I, _I, _I,                # nz1, ny1, nx1 (levels[1])
         _P, _P, _P, _P,            # aw, an, au, dinv (level 0)
         _P, _P, _P, _P,            # e, e_c, r, z
         _P, _I, _D, _P], _I)       # ws[], nu, over, stream
    _ENTRIES[f"deff_cg_steps3d_{_t}"] = (
        [_I, _I, _P, _P, _P,        # B, L, nz[], ny[], nx[]
         _P, _P, _P, _P,            # aw[], an[], au[], dinv[] (pointer arrays)
         _P, _D, _D, _D, _D, _I,    # D (or null), fx, fy, fz, bcf, nxr
         _P, _P, _P, _P,            # x, r, p, rz
         _P, _P, _P, _I, _P,        # active, stop, hi, k, k_done
         _P, _I, _I, _D,            # ws[], nu, coarse_iters, over
         _P, _P, _P], _I)           # scratch, int scratch, stream
    _ENTRIES[f"deff_jacobi_sweeps_{_t}"] = (
        [_I, _I, _I,                # B, ny, nx
         _P, _P, _P, _P,            # aw, an, dinv, b
         _P, _P, _P,                # x, out, scratch
         _P, _I, _D,                # active (int32 or null), k, omega
         _P], _I)                   # stream
    _ENTRIES[f"deff_jacobi_resident_{_t}"] = (
        [_I, _I, _I, _I,            # B, ny, nx, CTAs a cluster
         _P, _P, _P, _P,            # aw, an, dinv, b
         _P, _P,                    # x, out
         _P, _I, _D,                # active (int32 or null), k, omega
         _P], _I)                   # stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put nvcc on PATH or set CUDA_HOME)")


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


_INFO = {}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib_path = BUILD_DIR / f"libdeff_kernels_{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.tmp{os.getpid()}"
        objs, procs = [], []
        for src in (s for s in srcs if s.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [p.returncode for p in procs if p.returncode != 0]
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
        if not failed:
            link = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode != 0 else []
        log_path.write_text("".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            # the failing compiles' diagnostics, without ptxas's reports
            bad = [log for p, log in zip(procs, logs) if p.returncode] or logs
            text = "\n".join(ln for log in bad for ln in log.splitlines()
                              if not ln.lstrip().startswith("ptxas info")
                              and "bytes stack frame" not in ln
                              and "Function properties" not in ln)
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{text[:8000]}")
        os.replace(tmp, lib_path)
    _INFO["seconds"] = time.perf_counter() - t0
    _INFO["path"] = str(lib_path)
    _INFO["log"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_info() -> dict:
    """Seconds the last :func:`load_library` took (build included), the
    library path, and nvcc's output (``-Xptxas -v`` register/spill lines)."""
    load_library()
    return dict(_INFO)


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
