"""ctypes bindings for the native C++ host runtime (runtime/audio_runtime.cpp).

The reference runs its realtime fabric (SlotPool + SPSC rings + reducer/AGC
thread) natively in Rust; this binds the C++ equivalent.  Builds the shared
library on first use (g++ is in the image; no pip deps).  All entry points
degrade gracefully: `available()` is False when the toolchain or build is
missing and callers fall back to the pure-Python host path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_RUNTIME_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runtime")
_LIB_PATH = os.path.join(_RUNTIME_DIR, "libaudio_runtime.so")

_lib = None
_build_failed = False


class DynamicsOutStruct(ctypes.Structure):
    _fields_ = [("level", ctypes.c_int32),
                ("rms_db", ctypes.c_float),
                ("gain_db", ctypes.c_float),
                ("session_median_db", ctypes.c_float),
                ("noise_floor_db", ctypes.c_float)]


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _RUNTIME_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB_PATH) and not _build():
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # Stale/corrupt .so (interrupted build, arch mismatch): the
        # documented contract is graceful fallback, not a crash.  One
        # rebuild attempt, then give up.
        try:
            os.unlink(_LIB_PATH)
        except OSError:
            pass
        if not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
    c = ctypes
    lib.ring_create.restype = c.c_void_p
    lib.ring_create.argtypes = [c.c_size_t]
    lib.ring_destroy.argtypes = [c.c_void_p]
    lib.ring_push.restype = c.c_int
    lib.ring_push.argtypes = [c.c_void_p, c.c_uint64]
    lib.ring_pop.restype = c.c_int
    lib.ring_pop.argtypes = [c.c_void_p, c.POINTER(c.c_uint64)]
    lib.ring_len.restype = c.c_size_t
    lib.ring_len.argtypes = [c.c_void_p]
    lib.pool_create.restype = c.c_void_p
    lib.pool_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.pool_destroy.argtypes = [c.c_void_p]
    lib.pool_slot_ptr.restype = c.POINTER(c.c_float)
    lib.pool_slot_ptr.argtypes = [c.c_void_p, c.c_size_t]
    lib.pool_acquire.argtypes = [c.c_void_p, c.c_size_t, c.c_uint32]
    lib.pool_release.restype = c.c_int
    lib.pool_release.argtypes = [c.c_void_p, c.c_size_t]
    lib.reducer_create.restype = c.c_void_p
    lib.reducer_create.argtypes = [c.c_float, c.c_size_t]
    lib.reducer_destroy.argtypes = [c.c_void_p]
    lib.reducer_state_floats.restype = c.c_size_t
    lib.reducer_state_ints.restype = c.c_size_t
    lib.reducer_save_state.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                       c.POINTER(c.c_int32)]
    lib.reducer_load_state.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                       c.POINTER(c.c_int32)]
    lib.reducer_process.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                    c.c_size_t, c.POINTER(DynamicsOutStruct)]
    lib.pipeline_create.restype = c.c_void_p
    lib.pipeline_create.argtypes = [c.c_float, c.c_size_t, c.c_size_t]
    lib.pipeline_destroy.argtypes = [c.c_void_p]
    lib.pipeline_push_input.restype = c.c_int
    lib.pipeline_push_input.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                        c.c_size_t]
    lib.pipeline_pull_slot.restype = c.c_int
    lib.pipeline_pull_slot.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                       c.POINTER(DynamicsOutStruct)]
    lib.pipeline_pending.restype = c.c_size_t
    lib.pipeline_pending.argtypes = [c.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# ── universal decode (runtime/audio_decode.cpp, the symphonia analog) ──────

_DECODE_PATH = os.path.join(_RUNTIME_DIR, "libaudio_decode.so")
_decode_lib = None
_decode_failed = False


def _load_decode() -> Optional[ctypes.CDLL]:
    global _decode_lib, _decode_failed
    if _decode_lib is not None:
        return _decode_lib
    if _decode_failed:
        return None
    if not os.path.exists(_DECODE_PATH) and not _build():
        _decode_failed = True
        return None
    if not os.path.exists(_DECODE_PATH):  # built, but no FFmpeg dev libs
        _decode_failed = True
        return None
    try:
        lib = ctypes.CDLL(_DECODE_PATH)
    except OSError:
        _decode_failed = True
        return None
    c = ctypes
    lib.decode_audio_file.restype = c.POINTER(c.c_float)
    lib.decode_audio_file.argtypes = [c.c_char_p, c.POINTER(c.c_longlong),
                                      c.POINTER(c.c_int), c.c_char_p, c.c_int]
    lib.decode_free.argtypes = [c.POINTER(c.c_float)]
    lib.encode_audio_file.restype = c.c_int
    lib.encode_audio_file.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                      c.c_longlong, c.c_int, c.c_char_p,
                                      c.c_int]
    lib.encode_supported.restype = c.c_int
    lib.encode_supported.argtypes = [c.c_char_p]
    _decode_lib = lib
    return lib


def decode_available() -> bool:
    return _load_decode() is not None


def encode_supported(path: str) -> bool:
    """True when `path`'s extension maps to an encodable audio container."""
    lib = _load_decode()
    return bool(lib) and bool(lib.encode_supported(path.encode()))


def decode_file(path: str) -> Tuple[np.ndarray, float]:
    """Decode any container/codec to (mono float32, native sample rate).

    The reference decodes with symphonia (ref generators/player.rs:170-260);
    this uses the system FFmpeg libraries through runtime/audio_decode.cpp.
    """
    lib = _load_decode()
    if lib is None:
        raise RuntimeError("native decode unavailable (FFmpeg libs missing)")
    n = ctypes.c_longlong(0)
    rate = ctypes.c_int(0)
    err = ctypes.create_string_buffer(256)
    buf = lib.decode_audio_file(path.encode(), ctypes.byref(n),
                                ctypes.byref(rate), err, len(err))
    if not buf:
        raise ValueError(f"decode failed for {path!r}: "
                         f"{err.value.decode(errors='replace')}")
    try:
        samples = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.decode_free(buf)
    return samples, float(rate.value)


def encode_file(path: str, samples: np.ndarray, sample_rate: float) -> None:
    """Encode mono float32 to `path`; container/codec from the extension."""
    lib = _load_decode()
    if lib is None:
        raise RuntimeError("native encode unavailable (FFmpeg libs missing)")
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    err = ctypes.create_string_buffer(256)
    rc = lib.encode_audio_file(
        path.encode(), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), int(sample_rate), err, len(err))
    if rc != 0:
        raise ValueError(f"encode failed for {path!r}: "
                         f"{err.value.decode(errors='replace')}")


class NativeReducer:
    """Streaming conditioning + AGC in C++ (drop-in for HostReducer+AGC)."""

    def __init__(self, sample_rate: float, slot_len: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ptr = lib.reducer_create(ctypes.c_float(sample_rate),
                                       ctypes.c_size_t(slot_len))
        self.slot_len = slot_len

    def process_slot(self, slot: np.ndarray) -> Tuple[np.ndarray, dict]:
        """Condition + AGC one slot; returns (conditioned, dynamics dict)."""
        buf = np.ascontiguousarray(slot, dtype=np.float32).copy()
        dyn = DynamicsOutStruct()
        self._lib.reducer_process(
            self._ptr, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_size_t(len(buf)), ctypes.byref(dyn))
        return buf, {"level": int(dyn.level), "rms_db": float(dyn.rms_db),
                     "gain_db": float(dyn.gain_db),
                     "session_median_db": float(dyn.session_median_db),
                     "noise_floor_db": float(dyn.noise_floor_db),
                     "slot": buf}

    def save_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot the full reducer+AGC carried state (checkpoint.py)."""
        nf = int(self._lib.reducer_state_floats())
        ni = int(self._lib.reducer_state_ints())
        f = np.zeros(nf, np.float32)
        i = np.zeros(ni, np.int32)
        self._lib.reducer_save_state(
            self._ptr, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return f, i

    def load_state(self, floats: np.ndarray, ints: np.ndarray) -> None:
        f = np.ascontiguousarray(floats, np.float32)
        i = np.ascontiguousarray(ints, np.int32)
        if (len(f) != int(self._lib.reducer_state_floats())
                or len(i) != int(self._lib.reducer_state_ints())):
            raise ValueError("reducer state size mismatch")
        self._lib.reducer_load_state(
            self._ptr, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.reducer_destroy(self._ptr)
            self._ptr = None


class NativePipeline:
    """Threaded native pipeline: input ring → reducer thread → consumer ring
    (the reference's thread topology, ref mod.rs:336-511)."""

    def __init__(self, sample_rate: float, pool_size: int = 1024,
                 slot_len: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ptr = lib.pipeline_create(ctypes.c_float(sample_rate),
                                        ctypes.c_size_t(pool_size),
                                        ctypes.c_size_t(slot_len))
        self.slot_len = slot_len

    def push(self, slot: np.ndarray) -> bool:
        buf = np.ascontiguousarray(slot, dtype=np.float32)
        return bool(self._lib.pipeline_push_input(
            self._ptr, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_size_t(len(buf))))

    def pull(self) -> Optional[Tuple[np.ndarray, dict]]:
        out = np.empty(self.slot_len, dtype=np.float32)
        dyn = DynamicsOutStruct()
        ok = self._lib.pipeline_pull_slot(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(dyn))
        if not ok:
            return None
        return out, {"level": int(dyn.level), "rms_db": float(dyn.rms_db),
                     "gain_db": float(dyn.gain_db),
                     "session_median_db": float(dyn.session_median_db),
                     "noise_floor_db": float(dyn.noise_floor_db)}

    def pending(self) -> int:
        return int(self._lib.pipeline_pending(self._ptr))

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.pipeline_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
