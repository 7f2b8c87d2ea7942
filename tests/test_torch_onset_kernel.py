"""Kernel K4's division-free steps (csrc/onset.cu), transcribed to numpy and
held bitwise to what the plain onset scan computes with float32 division.

- `burst_limit_np` is the kernel's burst test: a bin bursts when its
  divisor den < RU(m * RN(1 / c)) in float32, c = 2.5 + 2^-23, with the
  double constant read from the kernel's source.  Held to RN(m / den) >
  2.5f on divisors and magnitudes a few ulps around the threshold, zeros
  and random pairs.
- `keep_larger_np` is the kernel's exact ratio comparison (the products as
  float and fma error pairs); its tournament over a warp's 32 bins is held
  to the largest RN(m / den), and to NaN where a bin's divisor is NaN (the
  kernel stores a NaN divisor for a NaN magnitude), as torch.amax keeps it.
- `tree32_np` is the kernel's 32-value sum order, held to `onset.tree_sum`.
- A block's shared bytes at each bin width, from the structs and constants
  of the source, held to what the launch bounds of the instantiation that
  takes it ask (two blocks a SM up to 160 bins, so at the full step's 129).

The card test (tests/test_torch_kernels_cuda.py) holds the kernel itself to
`onset_scan_plain`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.ops import onset

torch.set_num_threads(1)

F32 = np.float32
SOURCE = (Path(onset.__file__).resolve().parent.parent / "csrc"
          / "onset.cu")


def _inverse_c() -> float:
    """burst_limit's double constant, as the kernel spells it."""
    m = re.search(r"static_cast<double>\(m\) \* (0x[0-9a-f.]+p[-+]\d+)\)",
                  SOURCE.read_text())
    return float.fromhex(m.group(1))


INV_C = _inverse_c()


def fma_np(a, b, c):
    """a*b + c rounded once to float32: the exact float64 product, the sum
    made round-to-odd in float64 by TwoSum."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = s.view(np.int64) & 1
    s = np.where((err != 0) & (odd == 0),
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


def burst_limit_np(m):
    """__double2float_ru(double(m) * INV_C)."""
    q = np.asarray(m, F32).astype(np.float64) * INV_C
    t = q.astype(F32)
    return np.where(t.astype(np.float64) < q, np.nextafter(t, F32(np.inf)),
                    t).astype(F32)


def keep_larger_np(ma, da, mb, db):
    """The kernel's keep_larger: (m, d) of the larger ratio, a on ties, b
    where its divisor is NaN."""
    p1, p2 = (ma * db).astype(F32), (mb * da).astype(F32)
    e1, e2 = fma_np(ma, db, -p1), fma_np(mb, da, -p2)
    b = (p2 > p1) | ((p2 == p1) & (e2 > e1)) | np.isnan(db)
    return np.where(b, mb, ma), np.where(b, db, da)


def div_guarded_np(n, d):
    """The kernel's division: IEEE, with 1 in place of a zero numerator and
    the zero put back unless the divisor is NaN."""
    q = (np.where(n == 0, F32(1), n) / d).astype(F32)
    return np.where((n == 0) & ~np.isnan(d), n, q).astype(F32)


def tournament_np(m, den):
    """A warp's 32 bins [rows, 32] → the kernel's largest ratio a row."""
    wm, wd = keep_larger_np(m[:, :16], den[:, :16], m[:, 16:], den[:, 16:])
    for k in (8, 4, 2, 1):
        wm, wd = keep_larger_np(wm[:, :k], wd[:, :k], wm[:, k:2 * k],
                                wd[:, k:2 * k])
    return div_guarded_np(wm[:, 0], wd[:, 0])


def tree32_np(x):
    v = x[..., :16] + x[..., 16:]
    for k in (8, 4, 2, 1):
        v = v[..., :k] + v[..., k:2 * k]
    return v[..., 0]


def test_inverse_constant_is_rn_of_one_over_c():
    from fractions import Fraction
    c = Fraction(5, 2) + Fraction(1, 2 ** 23)
    assert INV_C == float(1 / c)
    assert abs(Fraction(INV_C) - 1 / c) <= (1 / c) / 2 ** 53


@pytest.mark.parametrize("scale", [2.0 ** -20, 0.01, 1.0, 37.0, 2.0 ** 20])
def test_burst_limit_matches_division(scale):
    rng = np.random.default_rng(int(scale * 1000) % 997)
    n = 400_000
    den = (rng.uniform(1.0, 2.0, n) * scale).astype(F32)
    den = np.maximum(den, F32(0.01))
    near = (den.astype(np.float64) * 2.5).astype(F32)
    m = (near.view(np.int32)
         + rng.integers(-6, 7, n).astype(np.int32)).view(F32)
    m[::11] = 0.0
    m[::13] = (rng.random(len(m[::13])) * 3.0 * scale).astype(F32)
    want = (m / den) > F32(2.5)
    np.testing.assert_array_equal(den < burst_limit_np(m), want)
    assert want.any() and not want.all()


def test_tournament_finds_the_largest_rounded_ratio():
    """A warp's 32 bins: ratios that tie in float32, differ by an ulp, or
    are zero; the tournament's pair gives the largest RN(m / den)."""
    rng = np.random.default_rng(4)
    rows = 20_000
    den = (rng.uniform(0.01, 30.0, (rows, 32))).astype(F32)
    base = rng.uniform(0.0, 8.0, (rows, 1))
    jitter = 1.0 + rng.integers(-2, 3, (rows, 32)) * 2.0 ** -24
    m = (base * jitter * den).astype(F32)
    m[rng.random((rows, 32)) < 0.2] = 0.0
    got = tournament_np(m, den)
    want = (m / den).astype(F32).max(1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tournament_keeps_a_nan_ratio():
    """Rows with a NaN divisor in any of the 32 bins, at any place and next
    to zero magnitudes, give NaN; the other rows their largest ratio."""
    rng = np.random.default_rng(6)
    rows = 4_000
    den = rng.uniform(0.01, 30.0, (rows, 32)).astype(F32)
    m = (rng.uniform(0.0, 8.0, (rows, 32)) * den).astype(F32)
    m[rng.random((rows, 32)) < 0.3] = 0.0
    nan_rows = rng.random(rows) < 0.3
    den[nan_rows, rng.integers(0, 32, rows)[nan_rows]] = np.nan
    den[:40, :] = np.nan
    m[:20, :] = 0.0
    got = tournament_np(m, den)
    want = (m / den).astype(F32).max(1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).sum() == nan_rows[40:].sum() + 40
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))


def test_tree32_is_tree_sums_order():
    rng = np.random.default_rng(5)
    x = (rng.random((500, 32)) * rng.choice([1e-3, 1.0, 1e3], (500, 32))
         ).astype(F32)
    want = onset.tree_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tree32_np(x).view(np.uint32),
                                  want.view(np.uint32))


# The H100's shared memory: a block's most, and what the SM keeps a block.
SM_SHARED = 232_448
BLOCK_RESERVED = 1_024
SIZES = {"float": 4, "int": 4, "float4": 16}


def source_constants(text: str) -> dict:
    """`constexpr int NAME = <expr>;` of the source, each evaluated over the
    ones before it."""
    names = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.M):
        names[name] = eval(expr, {"__builtins__": {}}, dict(names))
    return names


def struct_bytes(text: str, struct: str, names: dict) -> int:
    """sizeof a struct of float / int / float4 arrays (16-byte aligned, no
    padding between such members)."""
    body = re.search(r"struct __align__\(16\) " + struct + r" \{(.*?)\n\};",
                     text, re.S).group(1)
    total = 0
    for kind, dims in re.findall(r"^\s*(float4|float|int) \w+((?:\[\w+\])+);",
                                 body, re.M):
        n = SIZES[kind]
        for d in re.findall(r"\[(\w+)\]", dims):
            n *= names[d] if d in names else int(d)
        total += n
    assert total % 16 == 0
    return total


def layouts(text: str) -> dict:
    """Instantiation name → (NBUF, BLOCKS, bin warps) of its Layout."""
    c = source_constants(text)
    return {name: (int(nbuf), int(blocks), c.get(warps) or int(warps))
            for name, nbuf, blocks, warps in re.findall(
                r"using (\w+) = Layout<(\d+), (\d+), (\w+)>;", text)}


def instantiation(text: str, h: int) -> str:
    """The instantiation a block of H bins takes: Packed where its bin warps
    are at most PACKED_WARPS, else Wide (the C entry's `packed`)."""
    warps = source_constants(text)["PACKED_WARPS"]
    return "Packed" if (h + 31) // 32 <= warps else "Wide"


def shared_bytes(text: str, nbuf: int, h: int) -> int:
    """The C entry's `smem_bytes` for a layout of NBUF tiles at H bins."""
    c = source_constants(text)
    nw = (h + 31) // 32
    ms = nw * 32 + 4
    return (struct_bytes(text, "Partials", {**c, "NBUF": nbuf})
            + struct_bytes(text, "Chain", c)
            + (nbuf * c["TF"] * ms + nw * 2 * c["TF"] * c["SCRATCH_STRIDE"])
            * 4)


@pytest.mark.parametrize("name,h,want", [
    ("Packed", onset.HALF, 97_536), ("Packed", 2, 27_904),
    ("Wide", onset.HALF, 139_776), ("Wide", 256, 216_576)])
def test_shared_bytes(name, h, want):
    """A block's shared bytes from the source's structs and constants (Wide
    at 129 bins: its four-tile ring, too large for two blocks a SM)."""
    text = SOURCE.read_text()
    assert shared_bytes(text, layouts(text)[name][0], h) == want


@pytest.mark.parametrize("h", [2, 32, 33, onset.HALF, 160, 161, 256])
def test_each_width_fits_its_launch_bounds(h):
    """At every width the block (its bin warps and the chain warp) fits the
    threads of its instantiation's launch bounds, and its shared bytes fit
    as many blocks to a SM as those bounds name; up to 160 bins that is at
    least two."""
    text = SOURCE.read_text()
    name = instantiation(text, h)
    assert name == ("Packed" if h <= 160 else "Wide")
    nbuf, blocks, warps = layouts(text)[name]
    assert (h + 31) // 32 <= warps
    assert shared_bytes(text, nbuf, h) <= SM_SHARED / blocks - BLOCK_RESERVED
    assert blocks >= (2 if h <= 160 else 1)


def test_packed_layout_fits_two_blocks_at_129_bins():
    """At the full step's 129 bins the packed instantiation's bounds name at
    least two blocks a SM and its shared bytes fit them; the four-tile ring
    of the wide one would not fit two."""
    text = SOURCE.read_text()
    found = layouts(text)
    assert set(found) == {"Packed", "Wide"}
    nbuf, blocks, _ = found["Packed"]
    assert instantiation(text, onset.HALF) == "Packed"
    assert blocks >= 2
    assert shared_bytes(text, nbuf, onset.HALF) <= \
        SM_SHARED / blocks - BLOCK_RESERVED
    nbuf, blocks, _ = found["Wide"]
    assert blocks == 1
    assert shared_bytes(text, nbuf, onset.HALF) > \
        SM_SHARED / 2 - BLOCK_RESERVED
