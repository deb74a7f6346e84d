"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use, one
``nvcc -c`` per source runs in parallel for ``sm_90a`` (Hopper), the
objects are linked into one shared library under ``build/`` beside this
file (listed in ``.gitignore``), and the library is loaded with
``ctypes``: every pointer and the stream go as ``c_void_p``, every size as
``c_int``.  The file name carries a digest of the sources and flags, so an
edited source is never served from a stale library; concurrent builders
publish with an atomic rename.

A failed build raises.  There is no fallback: a CUDA tensor either runs
the kernel or the call fails.
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

__all__ = ["load", "check", "current_stream", "build_info"]

_CSRC = Path(__file__).with_name("csrc")
_BUILD = Path(__file__).with_name("build")
_SOURCES = ("assign.cu", "assign_ws.cu", "bubble_cd.cu", "bubble_cd_ws.cu", "bubble_cd_walk.cu", "dist_panel.cu",
            "dynamic.cu", "flat_scatter.cu", "grid.cu", "grid_assign.cu", "grid_cd.cu", "grid_round.cu", "hierarchy.cu", "hierarchy_extract.cu", "hierarchy_par.cu", "mutual_reach.cu", "knn.cu", "knn_ws.cu", "pairwise.cu", "flash_attention.cu", "flash_attention_mma.cu",
            "flash_attention_wgmma.cu",
            "flash_attention_panel.cu", "flash_attention_bwd.cu", "flash_attention_bwd_mma.cu", "strip_minima.cu", "strip_tiles.cu", "errors.cu")
_HEADERS = ("common.cuh", "dist_tile.cuh", "grid_tiles.cuh", "grid_ws.cuh", "warp_select.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NVCC_TIMEOUT_S = 900

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # guarded by _lock
_info: dict = {}  # guarded by _lock: path, seconds (0 when cached), log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> tuple[float, str]:
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = []
        for src in _SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, p in procs:
            try:
                text, _ = p.communicate(timeout=_NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                failed.append(src)
            log.append(f"--- {src}\n{text}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {sorted(set(failed))}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(lib_tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=_NVCC_TIMEOUT_S,
        )
        log.append(f"--- link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + "\n".join(log))
        os.replace(lib_tmp, out)
    return time.perf_counter() - t0, "\n".join(log)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_assign_f32.argtypes = [P, P, I, I, I, P, P, P]
    lib.repro_assign_ws_f32.argtypes = [P, P, I, I, I, I, P, P, P, P]
    lib.repro_assign_ws_plan.argtypes = [I, P, P]
    lib.repro_bubble_cd_walk_f32.argtypes = [P, P, I, I, I, P, P, I, I, P, P]
    lib.repro_bubble_cd_f32.argtypes = [P, P, P, I, I, I, I, P, P]
    lib.repro_bubble_cd_ws_f32.argtypes = [P, P, P, I, I, I, I, I, I, P, P]
    lib.repro_dist_panel_plan.argtypes = [I, P]
    lib.repro_mutual_reach_panel_f32.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P, P, P]
    lib.repro_mutual_reach_tile_f32.argtypes = [P, P, P, P, I, I, I, I, I, P, P]
    lib.repro_knn_f32.argtypes = [P, P, I, I, I, I, P, P, P]
    lib.repro_knn_ws_f32.argtypes = [P, P, I, I, I, I, P, P, P]
    lib.repro_pairwise_panel_f32.argtypes = [P, P, I, I, I, I, I, P, P, P]
    lib.repro_pairwise_tile_f32.argtypes = [P, P, I, I, I, P, P]
    flash_args = [I, P, P, P, P, P, P] + [I] * 6 + [LL] * 12 + [I, I, I, ctypes.c_float, P]
    lib.repro_flash_attention.argtypes = flash_args
    lib.repro_flash_attention_mma.argtypes = flash_args[:7] + [P] + flash_args[7:]  # + the lse pointer
    lib.repro_flash_attention_wgmma.argtypes = lib.repro_flash_attention_mma.argtypes
    lib.repro_flash_attention_panel.argtypes = lib.repro_flash_attention_mma.argtypes
    lib.repro_flash_attention_bwd.argtypes = [I] + [P] * 12 + [I] * 6 + [LL] * 24 + [I, I, I, ctypes.c_float, P]
    lib.repro_flash_attention_bwd_mma.argtypes = lib.repro_flash_attention_bwd.argtypes
    lib.repro_flash_attention_panel_plan.argtypes = [I, I, P, P]
    lib.repro_single_linkage_f32.argtypes = [P, P, P, P, I, I, P, P, P, P, P, P, P]
    lib.repro_condense_f32.argtypes = [P, P, P, P, I, ctypes.c_float, I, P, P, P, P, P, P, P, P]
    lib.repro_single_linkage_par_f32.argtypes = lib.repro_single_linkage_f32.argtypes
    lib.repro_condense_par_f32.argtypes = lib.repro_condense_f32.argtypes
    lib.repro_eom_f32.argtypes = [P, P, P, I, I, P, P, P, P]
    lib.repro_extract_f32.argtypes = [P] * 7 + [I] * 4 + [P] * 6
    lib.repro_extract_scratch_bytes.argtypes = [I, I]
    lib.repro_extract_scratch_bytes.restype = ctypes.c_size_t
    lib.repro_flat_scatter_f32.argtypes = [P] * 9 + [I, I, I, ctypes.c_float, I, P, P]
    lib.repro_grid_assign_f32.argtypes = [P, I, P, P, P, I, I, I, P, P, I, P, P, P, P]
    lib.repro_grid_assign_tiles_f32.argtypes = [P, I, P, P, P, I, I, I, P, P, I, I, P, P, P, P]
    lib.repro_grid_core_distances_f32.argtypes = [P, P, P, I, I, I, P, P, I, P, P, I, I, I, I, I, P, P, P]
    lib.repro_grid_cd_tiles_f32.argtypes = [P, P, P, I, I, I, P, P, I, P, P, I, I, I, I, I, I, P, P, P]
    lib.repro_grid_round_minima_f32.argtypes = [P, P, P, I, I, I, P, P, I, P, P, P, I, I, P, P, P, P]
    lib.repro_grid_round_tiles_f32.argtypes = [P, P, P, I, I, I, P, P, I, P, P, P, I, I, I, P, P, P, P]
    lib.repro_strip_dists_f32.argtypes = [P, I, P, I, I, P, P]
    lib.repro_strip_topk_f32.argtypes = [P, I, I, P, P, P, I, P, P, P]
    lib.repro_strip_dists_tiles_f32.argtypes = lib.repro_strip_dists_f32.argtypes
    lib.repro_strip_topk_tiles_f32.argtypes = lib.repro_strip_topk_f32.argtypes
    lib.repro_strip_round_minima_f32.argtypes = [P, P, P, P, I, I, I, P, P, P, P, P, P, P]
    lib.repro_strip_minima_plan.argtypes = [I, I, P, P]
    lib.repro_strip_round_minima_from_dists_f32.argtypes = [P] * 6 + [I] * 4 + [P] * 8
    for fn in (lib.repro_assign_f32, lib.repro_assign_ws_f32, lib.repro_assign_ws_plan, lib.repro_bubble_cd_f32,
               lib.repro_bubble_cd_ws_f32, lib.repro_bubble_cd_walk_f32,
               lib.repro_dist_panel_plan, lib.repro_mutual_reach_panel_f32, lib.repro_mutual_reach_tile_f32,
               lib.repro_knn_f32, lib.repro_knn_ws_f32, lib.repro_pairwise_panel_f32, lib.repro_pairwise_tile_f32,
               lib.repro_flash_attention, lib.repro_flash_attention_mma, lib.repro_flash_attention_wgmma,
               lib.repro_flash_attention_panel,
               lib.repro_flash_attention_bwd, lib.repro_flash_attention_bwd_mma,
               lib.repro_flash_attention_panel_plan, lib.repro_single_linkage_f32, lib.repro_condense_f32,
               lib.repro_single_linkage_par_f32, lib.repro_condense_par_f32,
               lib.repro_eom_f32, lib.repro_extract_f32, lib.repro_flat_scatter_f32, lib.repro_grid_assign_f32,
               lib.repro_grid_core_distances_f32, lib.repro_grid_round_minima_f32, lib.repro_strip_dists_f32,
               lib.repro_strip_topk_f32, lib.repro_strip_round_minima_f32, lib.repro_strip_minima_plan,
               lib.repro_strip_round_minima_from_dists_f32, lib.repro_strip_dists_tiles_f32,
               lib.repro_strip_topk_tiles_f32, lib.repro_grid_round_tiles_f32, lib.repro_grid_assign_tiles_f32,
               lib.repro_grid_cd_tiles_f32):
        fn.restype = I
    lib.repro_error_string.argtypes = [I]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            out = _BUILD / f"librepro_torch_kernels-{_digest()}.so"
            seconds, log = (0.0, "cached") if out.exists() else _build(out)
            _lib = _bind(ctypes.CDLL(str(out)))
            _info.update(path=str(out), seconds=seconds, log=log)
        return _lib


def build_info() -> dict:
    """Where the library came from and what the build printed."""
    with _lock:
        return dict(_info)


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = load().repro_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError {code})")


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
