"""K5's chain bound at S = 1 (port_tools/k5_chain.cu): the floor recurrence
of csrc/noisefloor.cu alone, one warp of 32 bins a block, its frames in
shared memory, in cycles a frame.  A measurement, not part of the port:
chip_smoke.py phase 3 and port_tools/kernel_turns.py --kernel k5 import it.

    handle = start_build()        # nvcc in the background
    lib = finish_build(handle)    # waits; raises on a failed build
    cycles = chain_cycles(lib, mags, gf, band)

The library goes to `_proof/k5_chain/` (git-ignored), built with the
port's nvcc flags.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).with_name("k5_chain.cu")
OUT_DIR = REPO / "_proof" / "k5_chain"
INIT_SCALE = 5.0                  # the first-frame rule's


def start_build() -> tuple[subprocess.Popen, Path]:
    """Start nvcc on the chain's source → (the process, the library)."""
    from audio_analyzer_rs_tpu_torch import _build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / "libk5_chain.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), lib


def finish_build(handle) -> ctypes.CDLL:
    proc, path = handle
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{err}")
    lib = ctypes.CDLL(str(path))
    lib.k5_floor_chain.argtypes = (
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    lib.k5_floor_chain.restype = ctypes.c_int
    return lib


def chain_cycles(lib, mags, gf, band: int) -> list:
    """mags [N, >= band] and gf [N] on the card (one stream): frames 1 ..
    N-1 from the floor the first-frame rule leaves → each warp's clock64
    cycles a frame, of the second of two runs."""
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    floor = torch.maximum(mags[0, :band], gf[0] * INIT_SCALE).contiguous()
    out = torch.empty(band, device=mags.device)
    cycles = torch.zeros((band + 31) // 32, dtype=torch.int64,
                         device=mags.device)
    n = mags.shape[0] - 1
    for _ in range(2):
        code = lib.k5_floor_chain(
            mags[1:].data_ptr(), mags.stride(0), floor.data_ptr(),
            out.data_ptr(), cycles.data_ptr(), n, band,
            ctypes.c_void_p(_build.stream_ptr(mags)))
        if code != 0:
            raise RuntimeError(f"k5_floor_chain: CUDA error {code}")
        torch.cuda.synchronize()
    return [c / n for c in cycles.tolist()]
