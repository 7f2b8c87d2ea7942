"""The plain versions of kernels K8 and K9 (ops/gather.py, which the
wrappers in ops/hopper_gather.py run on the CPU) against the Mosaic
probe's own Pallas kernels, tools/mosaic_probe.py `gather_kernel` and
`kern`, run by `pl.pallas_call(..., interpret=True)` with the probe's VMEM
block specs, and against `np.take_along_axis`.

`gather_kernel` is imported from the probe by path; `kern` is a closure
inside the probe's `main()`, so its text is taken from the file and
rebuilt here with its free variable `p2` bound to the row width.

Every comparison is bitwise (float32 bit patterns: -0.0 and +0.0 differ,
NaNs by their bits): the functions are copies and adds.
"""

import ast
import importlib.util
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PROBE = REPO / "tools" / "mosaic_probe.py"
F, P, P2 = 8, 1024, 7296


def _probe_module():
    spec = importlib.util.spec_from_file_location("mosaic_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_kern(p2: int):
    """The probe's `kern`, rebuilt from its text in `main()`."""
    text = PROBE.read_text()
    main = next(node for node in ast.parse(text).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    kern = next(node for node in ast.walk(main)
                if isinstance(node, ast.FunctionDef) and node.name == "kern")
    scope = {"jnp": jnp, "p2": p2}
    exec(textwrap.dedent(ast.get_source_segment(text, kern)), scope)
    return scope["kern"]


def _pallas(kernel, x, idx):
    f, p = x.shape
    out = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((f, p), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(idx))
    return np.asarray(out)


def jax_lane_gather(x, idx):
    return _pallas(_probe_module().gather_kernel, x, idx)


def jax_comb_gather12(x, idx):
    return _pallas(_probe_kern(x.shape[1]), x, idx)


def port(fn, x, idx):
    return fn(torch.from_numpy(x), torch.from_numpy(idx)).numpy()


def assert_bits(got, want):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def probe_case(tag):
    """The probe's inputs for one of its index patterns: x = arange, as
    `run_gather` makes it."""
    if tag == "intile":
        base = (np.arange(P) // 128) * 128
        row = base + (np.arange(P) * 7) % 128
    elif tag == "crosstile":
        row = (np.arange(P) * 3) % P
    elif tag == "random":
        idx = np.random.default_rng(0).integers(0, P, size=(F, P))
        return (np.arange(F * P, dtype=np.float32).reshape(F, P),
                idx.astype(np.int32))
    else:
        assert tag == "7296"
        row = (np.arange(P2) * 13) % P2
    p = len(row)
    return (np.arange(F * p, dtype=np.float32).reshape(F, p),
            np.broadcast_to(row.astype(np.int32), (F, p)).copy())


TAGS = ["intile", "crosstile", "random", "7296"]


@pytest.mark.parametrize("tag", TAGS)
def test_lane_gather_matches_the_probe(tag):
    """K8's function on the probe's four lane_gather cases."""
    x, idx = probe_case(tag)
    want = jax_lane_gather(x, idx)
    assert_bits(want, np.take_along_axis(x, idx, axis=1))
    assert_bits(port(gather.lane_gather, x, idx), want)
    assert_bits(port(hopper_gather.lane_gather, x, idx), want)


@pytest.mark.parametrize("tag", TAGS)
def test_comb_gather12_matches_the_probe(tag):
    """K9's function at the probe's index patterns, on x = arange and on
    random values with both signs (the probe times it on zeros)."""
    x, idx = probe_case(tag)
    noisy = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    for values in (x, noisy):
        want = jax_comb_gather12(values, idx)
        ref = np.zeros_like(values)
        for n in range(12):
            ref = ref + np.take_along_axis(values, (idx + n) % values.shape[1],
                                           axis=1)
        assert_bits(want, ref)
        assert_bits(port(gather.comb_gather12, values, idx), want)
        assert_bits(port(hopper_gather.comb_gather12, values, idx), want)


def test_comb_gather12_on_the_probes_timing_input():
    """The probe's timed call: zeros over [8, 7296] at stride 13."""
    x, idx = probe_case("7296")
    zeros = np.zeros_like(x)
    want = jax_comb_gather12(zeros, idx)
    assert_bits(port(gather.comb_gather12, zeros, idx), want)
    assert not np.signbit(want).any()


def test_lane_gather_negative_and_out_of_range_indices():
    """JAX's semantics: [-P, 0) wraps once, outside [-P, P) is NaN (its
    bits those of jnp's fill), in every row."""
    p = 10
    x = np.arange(3 * p, dtype=np.float32).reshape(3, p)
    row = [-1, -p, -p - 1, p, p - 1, 0, 5, 2 ** 31 - 1, -2 ** 31, 3]
    idx = np.array([row, row[::-1], row[3:] + row[:3]], np.int32)
    want = jax_lane_gather(x, idx)
    assert np.isnan(want).sum() == 12
    assert want[0, 0] == x[0, p - 1] and want[0, 1] == x[0, 0]
    assert_bits(port(gather.lane_gather, x, idx), want)


def test_comb_gather12_floor_mod_and_int32_wrap():
    """(idx + n) % P is the floor-mod (-3 % 7 == 4), and idx + n wraps as
    int32 near the ends of its range."""
    p = 7
    x = np.random.default_rng(2).standard_normal((2, p)).astype(np.float32)
    row = [-3, -1, -p, -2 ** 31, 2 ** 31 - 1, 2 ** 31 - 6, 1000]
    idx = np.array([row, row[::-1]], np.int32)
    want = jax_comb_gather12(x, idx)
    assert_bits(port(gather.comb_gather12, x, idx), want)
    first = sum(np.float32(x[0, (-3 + n) % p]) for n in range(12))
    np.testing.assert_allclose(want[0, 0], first, rtol=1e-6)


class _Ref:
    """A stand-in for a Pallas ref: `r[:]` reads, `r[:] = v` writes."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, key):
        return self.value[key]

    def __setitem__(self, key, value):
        self.value = value


def jax_comb_gather12_eager(x, idx):
    """The probe's `kern` body run op by op (no jit): each jnp add rounds
    as IEEE float32 does."""
    out = _Ref()
    _probe_kern(x.shape[1])(_Ref(jnp.asarray(x)), _Ref(jnp.asarray(idx)),
                            out)
    return np.asarray(out.value)


def test_negative_zero_inputs():
    """K9's sum starts at +0.0: twelve -0.0 reads sum to +0.0, as the
    probe's `kern` body gives op by op.  Under jit, which interpret mode
    uses, XLA's algebraic simplifier folds `zeros + v` to `v` and the sum
    keeps -0.0 (the one difference from the IEEE sum: a sum differs only
    when all twelve reads are -0.0).  K8 copies -0.0 as it is."""
    x = np.full((3, 5), -0.0, np.float32)
    x[2, 1] = 0.0
    idx = np.tile(np.arange(5, dtype=np.int32), (3, 1))
    eager = jax_comb_gather12_eager(x, idx)
    assert not np.signbit(eager).any()
    got = port(gather.comb_gather12, x, idx)
    assert_bits(got, eager)
    folded = jax_comb_gather12(x, idx)
    np.testing.assert_array_equal(np.signbit(folded), [[True] * 5] * 2
                                  + [[False] * 5])
    assert_bits(got, np.abs(folded))
    lane = jax_lane_gather(x, idx)
    assert np.signbit(lane).sum() == 14
    assert_bits(port(gather.lane_gather, x, idx), lane)


def test_comb_gather12_eager_matches_interpret_off_negative_zero():
    """Away from all -0.0 sums, the probe's body op by op and under
    interpret mode agree bit for bit with the port."""
    x, idx = probe_case("7296")
    x = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    got = port(gather.comb_gather12, x, idx)
    assert_bits(got, jax_comb_gather12_eager(x, idx))
    assert_bits(got, jax_comb_gather12(x, idx))


def test_nan_and_inf_inputs():
    x = np.random.default_rng(3).standard_normal((4, 33)).astype(np.float32)
    x[0, 5] = np.nan
    x[1, 7] = np.inf
    x[2, 9] = -np.inf
    x[3, 11] = np.inf
    x[3, 12] = -np.inf
    idx = np.random.default_rng(4).integers(-33, 33, (4, 33)).astype(np.int32)
    for fn, jfn in ((gather.lane_gather, jax_lane_gather),
                    (gather.comb_gather12, jax_comb_gather12)):
        want = jfn(x, idx)
        got = port(fn, x, idx)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert_bits(np.where(np.isnan(got), 0, got),
                    np.where(np.isnan(want), 0, want).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 1), (5, 1), (1, 7), (3, 129),
                                   (2, 7297)])
def test_one_lane_and_odd_widths(shape):
    f, p = shape
    rng = np.random.default_rng(f * 1000 + p)
    x = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(-2 * p, 2 * p, shape).astype(np.int32)
    assert_bits(port(gather.lane_gather, x, idx), jax_lane_gather(x, idx))
    assert_bits(port(gather.comb_gather12, x, idx),
                jax_comb_gather12(x, idx))


def test_empty_rows():
    x = torch.zeros((0, 16))
    idx = torch.zeros((0, 16), dtype=torch.int32)
    assert hopper_gather.lane_gather(x, idx).shape == (0, 16)
    assert hopper_gather.comb_gather12(x, idx).shape == (0, 16)


def _bad_args():
    x = torch.zeros((4, 8))
    i = torch.zeros((4, 8), dtype=torch.int32)
    return {
        "x float64": (x.double(), i, TypeError),
        "idx int64": (x, i.long(), TypeError),
        "shapes differ": (x, i[:, :4].contiguous(), ValueError),
        "one axis": (x.reshape(-1), i.reshape(-1), ValueError),
        "x not contiguous": (torch.zeros((8, 4)).T, i, ValueError),
        "idx not contiguous": (x, torch.zeros((8, 4), dtype=torch.int32).T,
                               ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
@pytest.mark.parametrize("fn", ["lane_gather", "comb_gather12"])
def test_wrappers_check_arguments(fn, case):
    x, idx, err = _bad_args()[case]
    with pytest.raises(err, match=fn):
        getattr(hopper_gather, fn)(x, idx)


def test_wrappers_take_wide_rows():
    """Both kernels read x in place through the cache: any row width."""
    x = torch.zeros((1, 70000))
    idx = torch.full(x.shape, -1, dtype=torch.int32)
    assert hopper_gather.lane_gather(x, idx).shape == x.shape
    assert hopper_gather.comb_gather12(x, idx).shape == x.shape
