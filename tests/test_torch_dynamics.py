"""The port's device AGC (ops/dynamics.py `dynamics_scan`, kernel K7's plain
version on the CPU) against the JAX package's, and K7's algorithm
(csrc/dynamics.cu) transcribed to numpy against the plain version.

Tolerances against JAX (both modes, fresh and carried states): levels,
ring positions and flags, and histogram counts equal; rms_db, the session
median and the floor within 2e-5 dB (the sums run in the port's fixed
order, XLA's is its own, and torch's CPU log differs from XLA's by an ulp:
~1e-7 relative); gains and the effective gain within 1e-6 relative; the
gained slots within 1e-6 of the slot's peak.  The transcription is
bitwise.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.ops import dynamics as jdyn
from audio_analyzer_rs_tpu.ops import reducer as jred
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import dynamics as tdyn
from audio_analyzer_rs_tpu_torch.ops import hopper_dynamics
from test_torch_kernels_cuda import carried_dynamics_state
from test_torch_noisefloor_kernel import fma_np

torch.set_num_threads(1)

SR = 48000.0
L = 1024
F32 = np.float32
SOURCE = (Path(tdyn.__file__).resolve().parent.parent / "csrc"
          / "dynamics.cu")


def dynamics_slots(b: int, s: int, seed: int = 0) -> np.ndarray:
    """[b, s, 1024] float32 slots of conditioned audio: JAX-reduced mixed
    scenes over a swelling harmonic tone, with a silent stretch (9,000
    samples) and a quiet one (-60 dB); every third stream has a NaN sample
    in slot s/2."""
    rows = []
    n = s * L
    for i in range(b):
        x = gen.mixed_scene(n / SR + 0.05, SR, seed=seed + i)[:n].copy()
        swell = (0.05 + 0.4 * np.abs(np.sin(np.arange(n) / SR * (2 + i))))
        x += (swell * gen.tone_with_harmonics(
            196.0 * (1 + i), n / SR + 0.05, SR, amplitude=1.0)[:n]).astype(F32)
        x[n // 5:n // 5 + 9000] = 0.0
        x[n // 2 + 6000:n // 2 + 26000] *= F32(1e-3)
        _, y = jred.reduce_signal(jred.reducer_init(), jnp.asarray(x), SR)
        y = np.asarray(y).copy()
        if i % 3 == 2:
            y[(s // 2) * L + 100] = np.nan
        rows.append(y.reshape(s, L))
    return np.stack(rows).astype(F32)


def jax_state(st: tdyn.DynamicsState, i: int):
    return jdyn.DynamicsState(*(jnp.asarray(t[i].numpy()) for t in st))


def kernel_constants() -> dict:
    pat = re.compile(r"constexpr float (\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;")
    return {name: F32(float.fromhex(v))
            for name, v in pat.findall(SOURCE.read_text())}


def test_kernel_constants_are_the_plain_versions():
    k = kernel_constants()
    want = {
        "EPS": tdyn._EPS, "DB_PER_LOG": tdyn.DB_PER_LOG,
        "BUCKETS_PER_DB": tdyn.BUCKETS_PER_DB,
        "DB_PER_BUCKET": tdyn.DB_PER_BUCKET,
        "HIST_LO_DB": tdyn._HIST_LO_DB, "NEG_HIST_LO_DB": -tdyn._HIST_LO_DB,
        "TWENTIETH": tdyn._TWENTIETH, "TENTH": 0.1, "P95": 0.95,
        "MEAN_SQ_MIN": 1e-18, "KURT_LO": 2.75, "KURT_HI": 3.8,
        "KURT_DEFAULT": 3.0, "BROADBAND_DB": -45.0,
        "ACTIVE_SNR_DB": tdyn.ACTIVE_SNR_DB,
        "BOOTSTRAP_FLOOR_DB": tdyn.BOOTSTRAP_FLOOR_DB,
        "TARGET_DB": tdyn.TARGET_DB, "MAX_BOOST_DB": tdyn.MAX_BOOST_DB,
        "PEAK_HEADROOM": tdyn.PEAK_HEADROOM, "TEN": 10.0,
        "LEVEL_0": -15.0, "LEVEL_1": -9.0, "LEVEL_2": -4.5, "LEVEL_3": -1.5,
        "LEVEL_4": 1.5, "LEVEL_5": 4.5, "LEVEL_6": 9.0,
    }
    assert k == {name: F32(v) for name, v in want.items()}


def test_rounding_forms_match_jax_bits():
    """XLA:CPU's forms of the JAX step, from its bits: 20*log10(x) is
    log(x) times DB_PER_LOG; the bucket's (db + 180)/186*1024 is
    fma(log(x), DB_PER_LOG, 180) * BUCKETS_PER_DB; the AGC target's
    -18 - p95_db is fma(-log(p95), DB_PER_LOG, -18); the gain's smoothing
    and the level's rms_db - median_db are not fused.  (Each probe has the
    shape of its expression in the step: LLVM's contraction depends on
    it, e.g. g + a*(t - g) alone is fused, inside the step's select not.)"""
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(-25, 2, 20000)).astype(F32)
    lg = np.asarray(jax.jit(lambda v: jnp.log(jnp.maximum(v, 1e-9)))(x))
    kd = F32(tdyn.DB_PER_LOG)
    db = np.asarray(jax.jit(jdyn._lin_to_db)(x))
    np.testing.assert_array_equal(db.view(np.uint32),
                                  (lg * kd).view(np.uint32))
    bucket = np.asarray(jax.jit(jdyn._bucket_of)(x))
    want = np.clip((fma_np(lg, kd, F32(180)) * F32(tdyn.BUCKETS_PER_DB))
                   .astype(np.int64), 0, 1023)
    np.testing.assert_array_equal(bucket, want)
    got = np.asarray(jax.jit(lambda v: jnp.clip(-18.0 - v * kd, 0.0, 100.0))(
        lg))
    np.testing.assert_array_equal(got, np.clip(fma_np(-lg, kd, F32(-18)),
                                               0, 100))
    g = rng.uniform(0, 3, 20000).astype(F32)
    t = rng.uniform(0, 50, 20000).astype(F32)
    p = rng.random(20000) < 0.5
    sa, si = F32(8.888494e-05), F32(0.0021310593)
    got = np.asarray(jax.jit(lambda g, t, p: jnp.where(
        p, g + sa * (t - g), g + si * (1.0 - g)))(g, t, p))
    np.testing.assert_array_equal(got, np.where(p, g + sa * (t - g),
                                                g + si * (F32(1) - g)))
    m = (lg + rng.uniform(-16, 10, 20000)).astype(F32)
    got = np.asarray(jax.jit(lambda u, v, h: u * kd - jnp.where(
        h, v * kd, u * kd))(lg, m, p))
    np.testing.assert_array_equal(got, lg * kd - np.where(p, m * kd,
                                                          lg * kd))


def _compare_with_jax(st, out, gained, jst, jout, jgained, tag):
    for f in ("level",):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jout, f)), tag)
    for f in ("rms_db", "session_median_db", "noise_floor_db", "gain_db"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=0,
                                   atol=2e-5, err_msg=f"{tag} {f}")
    np.testing.assert_allclose(out.effective_gain.numpy(),
                               np.asarray(jout.effective_gain), rtol=1e-6,
                               err_msg=f"{tag} effective gain")
    g, jg = gained.numpy(), np.asarray(jgained)
    nan = np.isnan(jg)
    np.testing.assert_array_equal(np.isnan(g), nan, f"{tag} gained NaNs")
    jg, g = np.where(nan, 0, jg), np.where(nan, 0, g)
    scale = np.abs(jg).max(-1, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(g - jg) / scale, 1e-6 + 1e-30,
                                 f"{tag} gained")
    for f in ("long_pos", "long_filled", "play_pos", "play_filled",
              "long_counts", "play_counts"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      f"{tag} {f}")
    for f in ("long_hist", "play_hist"):
        a, b = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(np.where(np.isinf(a), 0, a),
                                   np.where(np.isinf(b), 0, b), rtol=1e-6,
                                   equal_nan=True)
    np.testing.assert_allclose(st.gain_linear.numpy(),
                               np.asarray(jst.gain_linear), rtol=1e-6)


@pytest.fixture(scope="module")
def slots():
    return dynamics_slots(3, 72, seed=7)


@pytest.mark.parametrize("mode", ["hist", "exact"])
def test_dynamics_matches_jax(slots, mode):
    """Three streams in one batched call against JAX's scan of each: from
    fresh states over 40 slots, then from JAX's state there (carried across
    by `interop.dynamics_state`) over 32 more, and from a carried-over
    session state (rings wrapped, histograms full)."""
    b = slots.shape[0]
    st0 = tdyn.init_state("cpu", (b,))
    st1, out1, g1 = tdyn.dynamics_scan(st0, torch.from_numpy(slots[:, :40]),
                                       SR, L, mode)
    assert int((out1.level >= 0).sum()) > 20
    assert float(out1.noise_floor_db.max() - out1.noise_floor_db.min()) > 6
    for i in range(b):
        jst, jout, jg = jdyn.dynamics_scan(jdyn.init_state(),
                                           jnp.asarray(slots[i, :40]), SR,
                                           L, mode)
        one = tdyn.DynamicsState(*(t[i] for t in st1))
        _compare_with_jax(one, tdyn.DynamicsOut(*(o[i] for o in out1)),
                          g1[i], jst, jout, jg, f"stream {i} fresh")
        carried = interop.dynamics_state(jst, "cpu")
        st2, out2, g2 = tdyn.dynamics_scan(
            carried, torch.from_numpy(slots[i, 40:].copy()), SR, L, mode)
        jst2, jout2, jg2 = jdyn.dynamics_scan(jst, jnp.asarray(slots[i, 40:]),
                                              SR, L, mode)
        _compare_with_jax(st2, out2, g2, jst2, jout2, jg2,
                          f"stream {i} carried")
    session = carried_dynamics_state(b, seed=3)
    st3, out3, g3 = tdyn.dynamics_scan(session, torch.from_numpy(
        slots[:, 40:56].copy()), SR, L, mode)
    for i in range(b):
        jst3, jout3, jg3 = jdyn.dynamics_scan(jax_state(session, i),
                                              jnp.asarray(slots[i, 40:56]),
                                              SR, L, mode)
        _compare_with_jax(tdyn.DynamicsState(*(t[i] for t in st3)),
                          tdyn.DynamicsOut(*(o[i] for o in out3)), g3[i],
                          jst3, jout3, jg3, f"stream {i} session")


def test_dynamics_hist_mode_tracks_exact():
    """JAX's bounds (tests/test_reducer_dynamics.py): alternating quiet and
    tonal slots; hist's median and gain within 0.5 dB of exact's, levels
    within one step."""
    rng = np.random.default_rng(0)
    t = np.arange(L) / SR
    slots = np.zeros((60, L), F32)
    for i in range(60):
        slots[i] = (rng.standard_normal(L) * 1e-5 if i % 3 == 0 else
                    0.05 * np.sin(2 * np.pi * 440 * t)).astype(F32)
    x = torch.from_numpy(slots)
    _, exact, _ = tdyn.dynamics_scan(tdyn.init_state("cpu"), x, SR, L,
                                     "exact")
    _, hist, _ = tdyn.dynamics_scan(tdyn.init_state("cpu"), x, SR, L, "hist")
    active = exact.level.numpy() >= 0
    assert active.any()
    np.testing.assert_allclose(hist.session_median_db.numpy()[active],
                               exact.session_median_db.numpy()[active],
                               atol=0.5)
    np.testing.assert_allclose(hist.gain_db.numpy(), exact.gain_db.numpy(),
                               atol=0.5)
    assert np.all(np.abs(hist.level.numpy() - exact.level.numpy()) <= 1)


# ── K7's algorithm in numpy ──────────────────────────────────────────────

def _log(v):
    """torch's CPU log of one float32 (the plain step's function)."""
    return F32(torch.log(torch.tensor([v], dtype=torch.float32))[0].item())


def _pow10(v):
    return F32(torch.pow(10.0, torch.tensor([v], dtype=torch.float32))[0]
               .item())


def _tree(v):
    """The warp shuffles' order: halves inside each group of 32, then
    across the 32 groups."""
    v = np.pad(v.astype(F32), (0, 1024 - len(v))).reshape(32, 32)
    for _ in range(2):
        k = 16
        while k:
            v = (v[..., :k] + v[..., k:2 * k]).astype(F32)
            k //= 2
        v = v[..., 0]
    return F32(v)


class HistNp:
    """One histogram as K7's chain warp holds it: `pre` the counts'
    inclusive prefix within each 32-bucket group ([32, 32], lane j owning
    column j), `tot` each group's total and `cum` the totals' inclusive
    prefix (a lane each)."""

    def __init__(self, counts):
        self.pre = np.cumsum(counts.astype(np.int64).reshape(32, 32), 1)
        self.tot = self.pre[:, 31].copy()
        self.cum = np.cumsum(self.tot)

    def add(self, k, d):
        if k < 0:
            return
        g = k >> 5
        self.cum[g:] += d
        self.tot[g] += d
        self.pre[g, k & 31:] += d

    def kth(self, k, inc, dec):
        """The first bucket whose count so far exceeds k (0 if none does),
        as if one were added at `inc` and taken at `dec` (-1: none): a
        ballot over the adjusted group prefixes, then over the group's
        adjusted bucket prefixes."""
        lanes = np.arange(32)
        gi = inc >> 5 if inc >= 0 else 32
        gd = dec >> 5 if dec >= 0 else 32
        c = self.cum + (lanes >= gi) - (lanes >= gd)
        hit = np.flatnonzero(c > k)
        if not len(hit):
            return 0
        w = int(hit[0])
        before = c[w] - self.tot[w] - (w == gi) + (w == gd)
        p = (self.pre[w] + ((w == gi) & (lanes >= (inc & 31)))
             - ((w == gd) & (lanes >= (dec & 31))))
        return w * 32 + int(np.flatnonzero(before + p > k)[0])

    def counts(self):
        return np.diff(self.pre, prepend=0, axis=1).reshape(-1)


def _key(v):
    if np.isnan(v):
        return 0xFFFFFFFF
    u = int(np.array(v, F32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _select_np(ring, k):
    """Four 8-bit radix passes over the order-preserving keys."""
    keys = np.array([_key(v) for v in ring], np.uint64)
    prefix, mask, kk = 0, 0, k
    for shift in (24, 16, 8, 0):
        live = keys[(keys & mask) == prefix]
        hist = np.bincount(((live >> shift) & 255).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist)
        digit = int(np.flatnonzero(cum > kk)[0])
        kk -= int(cum[digit] - hist[digit])
        prefix |= digit << shift
        mask |= 255 << shift
    if prefix == 0xFFFFFFFF:
        return F32(np.nan)
    bits = (prefix & 0x7FFFFFFF) if prefix & 0x80000000 else (~prefix
                                                             & 0xFFFFFFFF)
    return np.array(bits, np.uint32).view(F32)[()]


def sums_np(slots, k):
    """Phase (A), a warp a slot: the tree sums, the peak and what follows
    from them alone → per slot (rms, rms_db, PEAK_HEADROOM / peak, bucket,
    rms finite, broadband shape)."""
    inv = F32(1.0 / slots.shape[-1])
    staged = []
    for x in slots:
        sq = (x * x).astype(F32)
        sum_sq, sum_q = _tree(sq), _tree((sq * sq).astype(F32))
        peak = F32(np.nan) if np.isnan(x).any() else F32(np.max(np.abs(x)))
        rms = F32(np.sqrt(F32(sum_sq * inv)))
        rms_db = _db(rms, k)
        mean_sq = F32(rms * rms)
        mean_quad = F32(sum_q * inv)
        kurt = (F32(mean_quad / F32(mean_sq * mean_sq))
                if mean_sq > k["MEAN_SQ_MIN"] else k["KURT_DEFAULT"])
        broad = bool(kurt >= k["KURT_LO"] and kurt <= k["KURT_HI"]
                     and rms_db < k["BROADBAND_DB"])
        staged.append((rms, rms_db, F32(k["PEAK_HEADROOM"]
                                        / _mx(peak, k["EPS"])),
                       _bucket_of(rms, k), bool(np.isfinite(rms)), broad))
    return staged


def _mx(a, b):
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else F32(max(a, b))


def _mn(a, b):
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else F32(min(a, b))


def _db(v, k):
    return F32(_log(_mx(v, k["EPS"])) * k["DB_PER_LOG"])


def _lin(d, k):
    return _pow10(F32(d * k["TWENTIETH"]))


def _bucket_of(v, k):
    w = F32(fma_np(_log(_mx(v, k["EPS"])), k["DB_PER_LOG"],
                   k["NEG_HIST_LO_DB"]) * k["BUCKETS_PER_DB"])
    w = 0 if np.isnan(w) else int(np.clip(np.trunc(w), -2 ** 31, 2 ** 31 - 1))
    return min(max(w, 0), 1023)


def _bucket_value(b, k):
    return _lin(F32(F32(F32(F32(b) + F32(0.5)) * k["DB_PER_BUCKET"])
                    + k["HIST_LO_DB"]), k)


def _raw_gain_db(p95, k):
    return _mn(_mx(fma_np(-_log(_mx(p95, k["EPS"])), k["DB_PER_LOG"],
                          k["TARGET_DB"]), F32(0)), k["MAX_BOOST_DB"])


def chain_np(staged, st: dict, mode: str, k):
    """Phase (B), the scalar chain of one stream over its slots in order:
    in "hist" mode the histograms as `HistNp`, the rings as buckets (-1:
    not finite), and the dB and gain target of every bucket as tables; in
    "exact" mode the radix select.  st (numpy leaves) changes in place →
    outs [S] x 6."""
    rate = SR / L
    sa = F32(1.0 - np.exp(-1.0 / (tdyn.SMOOTH_SECS * rate)))
    si = F32(1.0 - np.exp(-1.0 / (tdyn.SILENCE_DECAY_SECS * rate)))
    db_of = [_db(_bucket_value(j, k), k) for j in range(1024)]
    target_of = [_lin(_raw_gain_db(_bucket_value(j, k), k), k)
                 for j in range(1024)]
    ring_bucket = [
        np.array([_bucket_of(v, k) if np.isfinite(v) else -1
                  for v in st[f]]) for f in ("long_hist", "play_hist")]
    hl, hp = HistNp(st["long_counts"]), HistNp(st["play_counts"])
    outs = [[] for _ in range(6)]
    for rms, rms_db, hr, bucket, finite, broad in staged:
        lp, lf = int(st["long_pos"]), bool(st["long_filled"])
        pp, pf = int(st["play_pos"]), bool(st["play_filled"])
        long_n = tdyn.LONG_LEN if lf else max(lp, 1)
        p10_idx = int(F32(F32(long_n - 1) * k["TENTH"]))
        if mode == "exact":
            p10 = F32(0) if lp == 0 and not lf else _select_np(
                st["long_hist"], p10_idx)
            floor_db = _db(p10, k)
        else:
            floor_db = (_db(F32(0), k) if lp == 0 and not lf
                        else db_of[hl.kth(p10_idx, -1, -1)])
        long_count = tdyn.LONG_LEN if lf else lp
        gate_db = floor_db if long_count >= 32 else k["BOOTSTRAP_FLOOR_DB"]
        active = bool(rms_db > F32(gate_db + k["ACTIVE_SNR_DB"]))
        playing = active and not broad
        upd_long = not active or broad
        old_play = ring_bucket[1][pp]
        if upd_long:
            if mode == "hist":
                hl.add(bucket, 1)
                hl.add(int(ring_bucket[0][lp]), -1)
                ring_bucket[0][lp] = bucket if finite else -1
            st["long_hist"][lp] = rms
            st["long_pos"] = (lp + 1) % tdyn.LONG_LEN
            st["long_filled"] = lf or st["long_pos"] == 0
        npp = (pp + 1) % tdyn.PLAY_LEN if playing else pp
        npf = pf or (playing and npp == 0)
        play_n = tdyn.PLAY_LEN if npf else npp
        p50_idx = (play_n - 1) // 2 if play_n > 0 else 0
        p95_idx = max(int(F32(F32(play_n - 1) * k["P95"])), 0)
        if mode == "exact":
            ring = st["play_hist"].copy()
            if playing:
                ring[pp] = rms
            p50, p95 = _select_np(ring, p50_idx), _select_np(ring, p95_idx)
            median_db = _db(p50, k) if play_n > 0 else rms_db
            target = _lin(_raw_gain_db(p95, k) if play_n > 0 else F32(0), k)
        else:
            inc = bucket if playing else -1
            dec = int(old_play) if playing else -1
            median_db = (db_of[hp.kth(p50_idx, inc, dec)] if play_n > 0
                         else rms_db)
            target = (target_of[hp.kth(p95_idx, inc, dec)] if play_n > 0
                      else _lin(F32(0), k))
            if playing:
                hp.add(inc, 1)
                hp.add(dec, -1)
                ring_bucket[1][pp] = bucket if finite else -1
        g = F32(st["gain_linear"])
        g = (F32(g + F32(sa * F32(target - g))) if playing
             else F32(g + F32(si * F32(F32(1) - g))))
        st["gain_linear"] = g
        eff = _mn(g, hr)
        if playing:
            st["play_hist"][pp] = rms
        st["play_pos"], st["play_filled"] = npp, npf
        rel = F32(rms_db - median_db)
        bounds = [k[f"LEVEL_{i}"] for i in range(7)]
        level = next((i for i, bd in enumerate(bounds) if rel < bd), 7)
        for o, v in zip(outs, (level if playing else -1, rms_db,
                               _db(eff, k), median_db, floor_db, eff)):
            o.append(v)
    if mode == "hist":
        st["long_counts"][:] = hl.counts()
        st["play_counts"][:] = hp.counts()
    return [np.array(o, np.int32 if i == 0 else F32)
            for i, o in enumerate(outs)]


def kernel_np(slots, st: dict, mode: str):
    """K7's three phases for one stream, in numpy float32: the slot sums
    (A), the scalar chain (B), the gained slots (C).  st holds the
    stream's leaves (numpy) and changes in place; → (outs [S] x 6,
    gained [S, L])."""
    k = kernel_constants()
    outs = chain_np(sums_np(slots, k), st, mode, k)
    gained = (slots * outs[5][:, None]).astype(F32)
    return outs, gained


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_kth_prefix_search_matches_cumsum(seed):
    """K7's percentile search over prefix counts (`HistNp.kth`, with a
    pending increment and decrement) against the plain version's
    first-bucket-whose-cumulative-count-exceeds-k over the adjusted counts,
    for every k up to the total and past it, and after `add` updates."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, 1024) * (rng.random(1024) < 0.2)
    h = HistNp(counts)
    for _ in range(40):
        inc = int(rng.integers(-1, 1024))
        dec = int(rng.choice(np.flatnonzero(counts))) if rng.random() < 0.8 \
            else -1
        adj = counts.astype(np.int64).copy()
        if inc >= 0:
            adj[inc] += 1
        if dec >= 0:
            adj[dec] -= 1
        total = int(adj.sum())
        for k in sorted({0, 1, total // 2, total - 1, total,
                         *rng.integers(0, total + 2, 6).tolist()}):
            want = tdyn._hist_kth(torch.from_numpy(adj), torch.tensor(k))
            got = _bucket_value(h.kth(k, inc, dec), kernel_constants())
            assert got == F32(want), (seed, k, inc, dec)
        h.add(inc, 1)
        h.add(dec, -1)
        counts = adj
        np.testing.assert_array_equal(h.counts(), counts)


@pytest.mark.parametrize("length", [1024, 480, 1])
def test_sums_np_matches_tree_sum(slots, length):
    """Phase (A)'s transcription (a lane a group of 32 halved, then the 32
    partials) against the plain step's `tree_sum`, for full, short and
    one-sample slots (the zero padding past L)."""
    x = slots[0, :6].reshape(-1)[:6 * length].reshape(6, length)
    k = kernel_constants()
    staged = sums_np(x, k)
    sq = torch.from_numpy(x) * torch.from_numpy(x)
    inv = float(F32(1.0 / length))
    rms = torch.sqrt(tdyn.tree_sum(sq) * inv)
    for i, (r, r_db, hr, bucket, finite, _) in enumerate(staged):
        assert np.float32(rms[i]).view(np.uint32) == r.view(np.uint32)
        assert bucket == int(tdyn._bucket_of(rms[i:i + 1])[0])
        assert finite == bool(torch.isfinite(rms[i]))


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        a = np.where(np.isnan(a), np.float32(np.nan), a)
        return a.view(np.uint32)
    return a


@pytest.mark.parametrize("mode", ["hist", "exact"])
def test_kernel_np_matches_plain_bitwise(slots, mode):
    """K7's transcription against the plain scan: two streams (one with a
    NaN sample) from fresh states, and from a carried session state (the
    rings wrapped, the histograms full)."""
    x = slots[1:3, 30:42]
    for st in (tdyn.init_state("cpu", (2,)), carried_dynamics_state(2, seed=9)):
        got_st, got, got_g = tdyn.dynamics_scan_plain(
            st, torch.from_numpy(x.copy()), SR, L, mode)
        for i in range(2):
            leaves = {f: getattr(st, f)[i].numpy().copy()
                      for f in tdyn.DynamicsState._fields}
            want, want_g = kernel_np(x[i], leaves, mode)
            for name, a, b in zip(tdyn.DynamicsOut._fields, got, want):
                np.testing.assert_array_equal(_bits(a[i].numpy()), _bits(b),
                                              f"{mode} stream {i} {name}")
            np.testing.assert_array_equal(_bits(got_g[i].numpy()),
                                          _bits(want_g))
            for f in tdyn.DynamicsState._fields:
                np.testing.assert_array_equal(
                    _bits(getattr(got_st, f)[i].numpy()),
                    _bits(np.asarray(leaves[f]).astype(
                        getattr(got_st, f).numpy().dtype)), f"{mode} {f}")


def test_wrapper_checks():
    st = tdyn.init_state("cpu", (2,))
    x = torch.zeros((2, 3, L))
    hopper_dynamics.check_args(st, x)
    with pytest.raises(ValueError, match=r"\[B, S, L\]"):
        hopper_dynamics.check_args(st, x[0])
    with pytest.raises(ValueError, match="slot length"):
        hopper_dynamics.check_args(st, torch.zeros((2, 3, 2048)))
    with pytest.raises(ValueError, match="long_hist"):
        hopper_dynamics.check_args(tdyn.init_state("cpu", (3,)), x)
    with pytest.raises(ValueError, match="mode"):
        tdyn.dynamics_scan(st, x, SR, L, "sorted")
