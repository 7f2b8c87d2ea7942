"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

Each source is compiled for Hopper (sm_90a) by its own nvcc, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes.  The library goes to
`_build/` beside this file, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached build.  No
`--use_fast_math`: the comb, onset, noise-floor and dynamics kernels rely
on IEEE division (and the dynamics kernel on the CUDA math library's
logf, powf and sqrtf, as PyTorch calls them), and every kernel but K1
keeps denormals (each matches its plain version, or K11 its numpy
transcription, bitwise).

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills on stderr, which build() returns.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu: pointers and the stream as void*, sizes as int.
_SIGNATURES = {
    # frames, frame stride (outer, inner), frames per outer row, window or
    # NULL, split table, cols_pad, out, n, width, band, splits, workspace
    # or NULL, stream
    "aat_stft_mag": (_P, ctypes.c_longlong, ctypes.c_longlong, _I, _P, _P, _I,
                     _P, _I, _I, _I, _I, _P, _P),
    # pm, frac, fund, score, longest_run, total_harms, n, kc, half, max_bin,
    # stream
    "aat_comb": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # mags and its row stride, floor and its row stride, freq, score,
    # valid, n, kc, half, min_bin, max_bin, bin width, min and max freq,
    # stream
    "aat_extract": (_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P, _P,
                    _I, _I, _I, _I, _I) + (ctypes.c_float,) * 3 + (_P,),
    # raw freq/score/valid, onsets, state in (6), stable freq/score/valid,
    # state out (6), streams, frames, stream
    "aat_tracker_select": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # mags, global floor, tick, hold, state in (6), the 8 per-frame
    # outputs, state out (6), streams, frames, bins, stream
    "aat_onset_scan": (_P,) * 24 + (_I, _I, _I, _P),
    # bins, out: resident blocks a SM
    "aat_onset_blocks_per_sm": (_I, _P),
    # mags and its stream and frame strides, global floor, state in (4),
    # effective floor, state out (4), streams, frames, band, state width,
    # mags width, stream
    "aat_noise_floor_scan": (_P, ctypes.c_longlong, ctypes.c_longlong)
    + (_P,) * 10 + (_I, _I, _I, _I, _I, _P),
    # the same, and each stream's first frame at full width before the
    # sizes
    "aat_noise_floor_scan_first": (_P, ctypes.c_longlong, ctypes.c_longlong)
    + (_P,) * 11 + (_I, _I, _I, _I, _I, _P),
    # x, y, state in [B, 9], hold in, state out, hold out, streams,
    # samples, gate only, the two biquads' b0 b1 b2 a1 a2, release,
    # 1 - release, hold samples, stream
    "aat_reducer_scan": (_P,) * 6 + (_I, _I, _I) + (ctypes.c_float,) * 12
    + (_I, _P),
    # slots, state in (9), the 6 outputs, gained, state out (9), streams,
    # slots a stream, slot length, exact, 1/length, smoothing alpha,
    # silence alpha, stream
    "aat_dynamics_scan": (_P,) * 26 + (_I, _I, _I, _I)
    + (ctypes.c_float,) * 3 + (_P,),
    # frames, frame stride (outer, inner), frames per outer row, window,
    # twiddle table, out, n, log2 width, band, float2 loads, stream
    "aat_rfft_mag": (_P, ctypes.c_longlong, ctypes.c_longlong, _I, _P, _P,
                     _P, _I, _I, _I, _I, _P),
    # the same, and each outer row's first frame at full width after out
    "aat_rfft_mag_first": (_P, ctypes.c_longlong, ctypes.c_longlong, _I, _P,
                           _P, _P, _P, _I, _I, _I, _I, _P),
    # x, idx, out, rows, columns, stream
    "aat_lane_gather": (_P, _P, _P, _I, _I, _P),
    "aat_comb_gather12": (_P, _P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """The library's path, named by a hash of the flags, the sources and
    the headers they include (an edited header rebuilds too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaat_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu if the hashed library is missing: one nvcc a
    source, run in parallel, then one link.  Returns the library path and
    nvcc's stderr (empty when nothing was built).  Raises RuntimeError with
    nvcc's stderr on a failed build."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return path, "".join(logs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            loaded = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.aat_error_string.argtypes = (ctypes.c_int,)
            loaded.aat_error_string.restype = ctypes.c_char_p
            _lib = loaded
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().aat_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an integer."""
    return torch.cuda.current_stream(t.device).cuda_stream
