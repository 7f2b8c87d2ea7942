"""K1 — the windowed, banded rDFT magnitude as a Hopper kernel (csrc/stft.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_stft.py `_stft_kernel` (launched
by `windowed_mags_pallas`), and with it the XLA GEMM the JAX pitch path
used in its place (ops/fft.py `rfft_mag(backend="dft", band=...)`).

What bounds it on an H100: tensor-core arithmetic.  At the main-path shape
(8192 frames of 2048 samples into 465 bins, 930 table columns) the FP32
product is 2 * 8192 * 2048 * 930 ≈ 31.2 GFLOP against ~40 MB of unique
audio, table and output.  On the CUDA cores (67 TFLOP/s) that is 0.47 ms
at best; one TF32 pass on the tensor cores fails the 1e-6 spectral gate.
So the kernel computes it as 3xTF32 — each operand split into two TF32
parts, x = hi + lo, and lo·hi + hi·lo + hi·hi summed in FP32 — which keeps
FP32-class accuracy at three tensor-core products: 93.6 GFLOP at 495
TFLOP/s, a bound of 0.19 ms.

Design: `wgmma` with A (the windowed frames, split in registers) from
registers and B (the split table) from shared memory, fed by TMA through a
four-stage mbarrier ring; 128 frames x 160 columns a block; frames read in
place through the view's strides.  The tensor cores truncate as they
accumulate, so each 32-sample slice's products are summed there and the
slices' partial sums are added in FP32, rounded to nearest, on the CUDA
cores.  Each output sums in one fixed order, so a frame's magnitudes are
bitwise the same in any batch.

At the latency shapes (a live slot's 2 frames, a pool wave's 66) that grid
is 6 blocks banded, 13 at full width, on 132 SMs.  There the wrapper
splits the 64 slices of the sample depth over `split_count` blocks a tile:
each block writes its slices' fresh partials to a workspace [64, n,
cols_pad], and a second kernel sums them in slice order, as the unsplit
block does in registers, so the magnitudes are bitwise the same.

The table's split is built here, once per table and device (`split_table`,
cached): hi = rna_tf32(x), lo = rna_tf32(x - hi), stored transposed as
[hi; lo] rows of [cols_pad, W] (TF32 `wgmma` takes B only K-major), with
the columns padded with zeros to a multiple of 160 and the samples of each
32-sample slice in the kernel's fragment order (`K_ORDER`).

`dft_mag` is the wrapper: the plain version for CPU tensors, the kernel for
CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import _build

LAUNCHES = 0
COL_TILE = 160   # table columns a block (csrc/stft.cu BN)
K_TILE = 32      # samples a pipeline stage (csrc/stft.cu BK)
# The sample depth is split while the unsplit grid has at most this many
# blocks.  Measured on an H100 (port_tools/k1_k10_probe.py, PERF.md
# section 6): the split was faster at 12 and 13 blocks (banded n = 256,
# full width n = 128), slower at 18 and 26; both crossovers fell where the
# workspace reached ~87 MB.
SPLIT_MAX_BLOCKS = 16
# Slot c = 8s + j of a 32-sample slice (k-step s, fragment column j) holds
# sample 8(j % 4) + 2s + j // 4, so thread q's A fragments of the slice are
# its samples 8q .. 8q+7.
K_ORDER = np.array([8 * (c % 4) + 2 * (c // 8) + (c % 8) // 4
                    for c in range(K_TILE)])


def dft_mag_plain(frames: torch.Tensor, trig: torch.Tensor,
                  window: torch.Tensor | None = None) -> torch.Tensor:
    """frames [..., W] (× window [W]) @ trig [W, 2B] (interleaved cos/-sin
    columns) → magnitudes [..., B].

    A frame's bits must not depend on how many frames share the call (the
    engine pool's lanes against solo engines, K1's own contract): a
    one-row product would be a matrix-vector product, which the CPU's BLAS
    sums in another order than its GEMM, so one frame runs as a two-row
    GEMM.  (The CPU's GEMM keeps a row's bits for 2 to ~130 rows with one
    thread, not beyond.)"""
    x = frames if window is None else frames * window
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        re_im = torch.matmul(torch.cat([rows, rows]), trig)[:1]
    else:
        re_im = torch.matmul(rows, trig)
    re_im = re_im.reshape(x.shape[:-1] + (trig.shape[1] // 2, 2))
    return torch.sqrt(re_im[..., 0] ** 2 + re_im[..., 1] ** 2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → float32 rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: the PTX `cvt.rna.tf32.f32` on finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_table(trig: torch.Tensor) -> tuple[torch.Tensor, int]:
    """trig [W, C] → (table [2 * cols_pad, W], cols_pad): rows [0, cols_pad)
    are hi = tf32_round(trig.T), rows [cols_pad, 2 * cols_pad) are
    lo = tf32_round(trig.T - hi), columns past C are zero, and each
    32-sample slice of W is in `K_ORDER`."""
    width, cols = trig.shape
    cols_pad = -(-cols // COL_TILE) * COL_TILE
    order = torch.from_numpy(
        (np.arange(0, width, K_TILE)[:, None] + K_ORDER).reshape(-1))
    t = torch.zeros((cols_pad, width), dtype=torch.float32,
                    device=trig.device)
    t[:cols] = trig.float().T[:, order.to(trig.device)]
    hi = tf32_round(t)
    return torch.cat([hi, tf32_round(t - hi)]).contiguous(), cols_pad


# (id(base), version, view geometry) → (weakref to base, split table)
_TABLES: dict = {}


def _cached_split(trig: torch.Tensor) -> tuple[torch.Tensor, int]:
    """`split_table(trig)`, built once per table: keyed by the tensor that
    owns trig's storage, its version counter (an in-place edit rebuilds) and
    the view's offset, shape and strides."""
    base = trig if trig._base is None else trig._base
    key = (id(base), base._version, trig.storage_offset(),
           tuple(trig.shape), tuple(trig.stride()))
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is base:
        return hit[1]
    for k in [k for k, (ref, _) in _TABLES.items() if ref() is None]:
        del _TABLES[k]
    table = split_table(trig)
    _TABLES[key] = (weakref.ref(base), table)
    return table


def split_count(n: int, cols_pad: int, width: int, sms: int) -> int:
    """Blocks a tile along the sample depth for n frames: 1 (the unsplit
    launch) when its grid of 128-frame x 160-column tiles has more than
    SPLIT_MAX_BLOCKS blocks, else `fill_splits`."""
    blocks = -(-n // 128) * (cols_pad // COL_TILE)
    return (1 if blocks > SPLIT_MAX_BLOCKS
            else fill_splits(n, cols_pad, width, sms))


def fill_splits(n: int, cols_pad: int, width: int, sms: int) -> int:
    """The split that fills `sms` SMs once: each block takes
    ceil(slices / splits) of the width / 32 slices of its tile.  Frame
    tiles are 64 high at n <= 64 (one warpgroup), else 128."""
    slices = width // K_TILE
    tiles = (cols_pad // COL_TILE) * -(-n // (64 if n <= 64 else 128))
    per = -(-slices * tiles // sms)
    return -(-slices // per)


def dft_mag(frames: torch.Tensor, trig: torch.Tensor,
            window: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitudes [..., B] of (frames × window) through the rDFT table
    `trig` [W, 2B].  `frames` is [N, W] or [S, F, W] with unit stride along
    W (other strides are free: an unfold view is read in place).  On CUDA
    the frames' base and strides must be 16-byte aligned and W a multiple
    of 32."""
    return _dft_mag(frames, trig, window)


def _dft_mag(frames: torch.Tensor, trig: torch.Tensor,
             window: torch.Tensor | None = None,
             splits: int | None = None) -> torch.Tensor:
    """`dft_mag`; `splits` forces the split over the sample depth (1: the
    unsplit launch) for the card tests, else `split_count` decides."""
    if frames.device.type == "cpu":
        return dft_mag_plain(frames, trig, window)
    if frames.device.type != "cuda":
        raise ValueError(f"dft_mag: unsupported device {frames.device}")
    if frames.dtype != torch.float32 or trig.dtype != torch.float32:
        raise TypeError("dft_mag: frames and trig must be float32")
    if frames.dim() not in (2, 3):
        raise ValueError(f"dft_mag: frames must be [N, W] or [S, F, W], "
                         f"got {tuple(frames.shape)}")
    width = frames.shape[-1]
    if trig.dim() != 2 or trig.shape[0] != width or trig.shape[1] % 2:
        raise ValueError(f"dft_mag: trig {tuple(trig.shape)} does not fit "
                         f"window {width}")
    if frames.stride(-1) != 1:
        raise ValueError("dft_mag: frames need unit stride along W")
    if width % K_TILE:
        raise ValueError(f"dft_mag: window {width} is not a multiple of "
                         f"{K_TILE}")
    if window is not None:
        if (window.shape != (width,) or window.dtype != torch.float32
                or not window.is_contiguous() or window.data_ptr() % 16):
            raise ValueError("dft_mag: window must be contiguous, 16-byte "
                             "aligned float32 [W]")
    for t in (trig, window):
        if t is not None and t.device != frames.device:
            raise ValueError("dft_mag: all tensors must share one device")
    band = trig.shape[1] // 2
    lead = frames.shape[:-1]
    if frames.dim() == 3:
        per_row = frames.shape[1]
        s_out, s_in = frames.stride(0), frames.stride(1)
        strides = ((s_out, frames.shape[0]), (s_in, frames.shape[1]))
    else:
        per_row = max(frames.shape[0], 1)
        s_out, s_in = 0, frames.stride(0)
        strides = ((s_in, frames.shape[0]),)
    # The kernel reads each frame as float4s: 16-byte base and strides.
    if frames.data_ptr() % 16 or any(s % 4 for s, size in strides
                                     if size > 1):
        raise ValueError(
            f"dft_mag: frames must be 16-byte aligned (base offset "
            f"{frames.data_ptr() % 16} B, strides {frames.stride()[:-1]} "
            f"floats; strides must be multiples of 4)")
    n = frames.numel() // width if width else 0
    out = torch.empty(lead + (band,), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    table, cols_pad = _cached_split(trig)
    if splits is None:
        sms = torch.cuda.get_device_properties(
            frames.device).multi_processor_count
        splits = split_count(n, cols_pad, width, sms)
    ws = (torch.empty((width // K_TILE, n, cols_pad), dtype=torch.float32,
                      device=frames.device) if splits > 1 else None)
    code = _build.lib().aat_stft_mag(
        frames.data_ptr(), s_out, s_in, per_row,
        None if window is None else window.data_ptr(),
        table.data_ptr(), cols_pad, out.data_ptr(), n, width, band, splits,
        None if ws is None else ws.data_ptr(),
        ctypes.c_void_p(_build.stream_ptr(frames)))
    _build.check(code, "aat_stft_mag")
    global LAUNCHES
    LAUNCHES += 1
    return out
