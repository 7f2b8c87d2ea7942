"""Kernel K3's algorithm (csrc/tracker.cu), transcribed to numpy, against
the plain tracker, bitwise (floats compared as their bit patterns, so -0.0
and +0.0 differ).

- `select_np` is the kernel's epilogue: a thread a frame ranks the 24 slots
  by (key, slot), key = seq for a stable slot and INT_MAX otherwise, and
  emits the stable slot of rank p at output p as v + 0.0f.  It is held to
  `select_stable` on random states and on edge rows.
- `rel_bound_np` is the kernel's division-free match test: |f - r| <
  RU(m * max(|f|, 1e-30)) with m the midpoint of 0.03f and its predecessor.
  It is held to the plain |f - r| / max(|f|, 1e-30) < 0.03f.
- `kernel_np` is the kernel's tile loop for each stream: tiles of 64
  frames, the rank-space rounds for states the scan produces, or the
  generic warp-min rounds for a state handed in that breaks their
  invariant; spawn, decay, the carried rank positions (with gaps, closed
  when fewer than 8 are left), and the epilogue a tile at a time.  It is
  held to `tracker_scan_plain` + `select_stable`, for N that is not a
  multiple of the tile, N = 0, a state carried across calls, -0.0 raws and
  states handed in from outside.

The card test (tests/test_torch_kernels_cuda.py) holds the kernel itself to
the same plain functions.
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.ops import tracker as ttr

torch.set_num_threads(1)

T, R, OUT, TILE = ttr.MAX_TRACKS, 8, 8, 64
INT_MAX = ttr.INT_MAX
C = np.float32(ttr.TOLERANCE)
REL_MID = np.float64(C) - 2.0 ** -30      # the kernel's REL_MID


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_bits(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _np_state(st):
    return ttr.TrackerState(*(np.array(a.numpy()) for a in st))


def _torch_state(st):
    return ttr.TrackerState(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in st))


def rel_bound_np(f):
    """The kernel's bound: __double2float_ru(REL_MID * max(|f|, 1e-30))."""
    d = np.maximum(np.abs(f), np.float32(1e-30)).astype(np.float64)
    t = REL_MID * d                        # exact: 25 + 24 significant bits
    with np.errstate(over="ignore"):
        u = t.astype(np.float32)
    return np.where(u.astype(np.float64) < t,
                    np.nextafter(u, np.float32(np.inf)), u)


def select_np(freq, score, stable, key):
    """The epilogue on [F, 24] rows → (freq, score, valid) [F, 8]."""
    nf = key.shape[0]
    rank = np.zeros((nf, T), np.int64)
    for i in range(1, T):
        for k in range(i):
            k_first = key[:, k] <= key[:, i]     # k < i breaks a tie
            rank[:, i] += k_first
            rank[:, k] += ~k_first
    sel = np.full((nf, OUT), -1)
    for i in range(T):
        for p in range(OUT):
            sel[:, p] = np.where(stable[:, i] & (rank[:, i] == p), i,
                                 sel[:, p])
    hit = sel >= 0
    at = np.where(hit, sel, 0)
    zero = np.float32(0.0)
    fo = np.where(hit, np.take_along_axis(freq, at, 1) + zero, zero)
    so = np.where(hit, np.take_along_axis(score, at, 1) + zero, zero)
    return fo.astype(np.float32), so.astype(np.float32), hit


def _popc(x):
    return bin(int(x)).count("1")


def _scan_stream(st, rf, rs, rv, on, tile):
    """One stream through the kernel's tile loop: st is a numpy state of
    one stream ([24] leaves, next_seq a 0-d array); raws [N, 8], onsets
    [N] → (state, (freq, score, valid) [N, 8], ordered)."""
    freq, score = st.freq.copy(), st.score.copy()
    life, valid, seq = st.life.copy(), st.valid.copy(), st.seq.copy()
    nseq = int(st.next_seq)
    n = len(on)
    lanes = np.arange(T)
    off = valid & ((seq.astype(np.int64) >= nseq) | (life < 1))
    ordered = not off.any() and nseq + R * n <= INT_MAX
    rbit = np.zeros(T, np.int64)
    vmask = npos = 0
    if ordered:
        for lane in lanes[valid]:
            r = sum(1 for k in lanes[valid]
                    if seq[k] < seq[lane] or (seq[k] == seq[lane]
                                              and k < lane))
            rbit[lane] = 1 << r
        npos = int(valid.sum())
        vmask = (1 << npos) - 1
    out_f = np.zeros((n, OUT), np.float32)
    out_s = np.zeros((n, OUT), np.float32)
    out_v = np.zeros((n, OUT), bool)
    for t0 in range(0, n, tile):
        nt = min(tile, n - t0)
        ef = np.zeros((nt, T), np.float32)
        es = np.zeros((nt, T), np.float32)
        ek = np.zeros((nt, T), np.int32)
        em = np.zeros((nt, T), bool)
        for i in range(nt):
            rfv, rsv, rvm = rf[t0 + i], rs[t0 + i], rv[t0 + i]
            onset = bool(on[t0 + i])
            # Phase 1 on the entry state.
            f_entry = freq.copy()
            life_inc = np.minimum(life + 1, ttr.MAX_LIFE).astype(np.int32)
            ok = (np.abs(f_entry[None, :] - rfv[:, None])
                  < rel_bound_np(f_entry)[None, :])            # [8, 24]
            is_free = ~valid
            frank = np.cumsum(is_free) - is_free
            mraw = np.full(T, -1)
            any_mask = np.zeros(R, bool)
            taken = 0
            if ordered:
                cr = [int(np.bitwise_or.reduce(np.where(ok[j], rbit, 0)))
                      for j in range(R)]
                life1 = int(np.bitwise_or.reduce(np.where(life <= 1, rbit,
                                                          0)))
                pb = [0] * R
                for j in range(R):
                    c = cr[j] & ~taken
                    pb[j] = (c & -c) if rvm[j] else 0
                    taken |= pb[j]
                for j in range(R):
                    any_mask[j] = pb[j] != 0
                    if pb[j]:
                        mraw[rbit == pb[j]] = j
            else:
                m = np.zeros(T, bool)
                for j in range(R):
                    cand = valid & ~m & ok[j]
                    key = np.where(cand, seq, INT_MAX)
                    am = bool(cand.any() and rvm[j])
                    any_mask[j] = am
                    if am:
                        pick = np.flatnonzero(key == key.min())[0]
                        mraw[pick] = j
                        m[pick] = True
            matched = mraw >= 0
            at = np.maximum(mraw, 0)
            ema = (f_entry * np.float32(ttr.EMA_OLD)
                   + rfv[at] * np.float32(ttr.EMA_NEW))
            freq = np.where(matched, rfv[at] if onset else ema, freq)
            score = np.where(matched, rsv[at], score)
            life = np.where(matched, life_inc, life)
            # Phase 2: the r-th unmatched raw spawns into the r-th free slot.
            um = rvm & ~any_mask
            n_um = int(um.sum())
            spawned = is_free & (frank < n_um)
            if n_um:
                pick = np.flatnonzero(um)[np.minimum(frank, n_um - 1)]
                freq = np.where(spawned, rfv[pick] + np.float32(0), freq)
                score = np.where(spawned, rsv[pick] + np.float32(0), score)
            life = np.where(spawned, 1, life).astype(np.int32)
            seq = np.where(spawned, (nseq + frank).astype(np.int32), seq)
            valid = valid | spawned
            n_spawn = min(n_um, int(is_free.sum()))
            nseq = int(np.array(nseq + n_spawn, np.int64).astype(np.int32))
            # Phase 3: misses decay, or are reaped on an onset.
            miss = valid & ~matched & ~spawned
            life = np.where(miss, 0 if onset else life - 1,
                            life).astype(np.int32)
            valid = valid & (life > 0)
            seq = np.where(valid, seq, INT_MAX).astype(np.int32)
            stable = valid & (life >= ttr.DISPLAY_THRESHOLD)
            ef[i], es[i], em[i] = freq, score, stable
            ek[i] = np.where(stable, seq, INT_MAX)
            if ordered:
                # Survivors keep their positions, spawns take the next
                # ones; the gaps close when fewer than 8 are left.
                died = (vmask if onset else life1) & ~taken
                surv = vmask & ~died
                rbit = np.array([
                    int(b) if int(b) & surv
                    else 1 << (npos + int(fr)) if sp else 0
                    for b, sp, fr in zip(rbit, spawned, frank)], np.int64)
                vmask = surv | (((1 << n_spawn) - 1) << npos)
                npos += n_spawn
                if npos > T:
                    rbit = np.array([1 << _popc(vmask & (int(b) - 1))
                                     if b else 0 for b in rbit], np.int64)
                    npos = _popc(vmask)
                    vmask = (1 << npos) - 1
                # The positions are the (seq, slot) order of the tracks.
                assert ((rbit != 0) == valid).all()
                assert int(np.bitwise_or.reduce(rbit)) == vmask
                assert vmask < 1 << 32 and npos <= 32 - R
                order = sorted(lanes[valid], key=lambda k: (seq[k], k))
                pos = [int(rbit[k]).bit_length() for k in order]
                assert pos == sorted(pos)
        out_f[t0:t0 + nt], out_s[t0:t0 + nt], out_v[t0:t0 + nt] = select_np(
            ef, es, em, ek)
    st = ttr.TrackerState(freq.astype(np.float32), score.astype(np.float32),
                          life.astype(np.int32), valid, seq.astype(np.int32),
                          np.array(nseq, np.int32))
    return st, (out_f, out_s, out_v), ordered


def kernel_np(state, rf, rs, rv, on, tile=TILE):
    """The kernel on numpy inputs: state leaves [S, 24] / [S], raws
    [S, N, 8], onsets [S, N] → (state, (freq, score, valid) [S, N, 8],
    [ordered] a stream)."""
    sts, outs, paths = [], [], []
    for s in range(on.shape[0]):
        st, out, ordered = _scan_stream(
            ttr.TrackerState(*(a[s] for a in state)), rf[s], rs[s], rv[s],
            on[s], tile)
        sts.append(st)
        outs.append(out)
        paths.append(ordered)
    if not sts:
        empty = np.zeros((0, on.shape[1], OUT), np.float32)
        return state, (empty, empty.copy(), empty.astype(bool)), paths
    return (ttr.TrackerState(*(np.stack(x) for x in zip(*sts))),
            tuple(np.stack(x) for x in zip(*outs)), paths)


def _random_raws(rng, s, n, neg_zero=False):
    rf = rng.uniform(50.0, 2000.0, (s, n, R)).astype(np.float32)
    for i in range(1, n):
        keep = rng.random((s, R)) < 0.7
        rf[:, i] = np.where(keep, rf[:, i - 1] * (1 + rng.normal(
            0, 0.01, (s, R)).astype(np.float32)), rf[:, i])
    rs = rng.uniform(0.1, 5.0, (s, n, R)).astype(np.float32)
    rv = rng.random((s, n, R)) < 0.6
    on = rng.random((s, n)) < 0.08
    if neg_zero:
        rf[rng.random((s, n, R)) < 0.05] = np.float32(-0.0)
        rs[rng.random((s, n, R)) < 0.1] = np.float32(-0.0)
    return rf, rs, rv, on


def _plain(state_np, raws):
    st, emits = ttr.tracker_scan_plain(
        _torch_state(state_np), *(torch.from_numpy(a) for a in raws))
    return _np_state(st), tuple(x.numpy() for x in ttr.select_stable(*emits))


def _assert_kernel_matches_plain(state_np, raws):
    st_k, out_k, paths = kernel_np(state_np, *raws)
    st_p, out_p = _plain(state_np, raws)
    for name, g, w in zip(("freq", "score", "valid"), out_k, out_p):
        assert_same_bits(g, w, name)
    for name in ttr.TrackerState._fields:
        assert_same_bits(getattr(st_k, name), getattr(st_p, name), name)
    return out_k, paths


def _init(s):
    return _np_state(ttr.init_state("cpu", (s,)))


# ---- the epilogue --------------------------------------------------------

def _select_rows(case, rng):
    """freq, score, stable, seq [12, 24] for one edge case."""
    f = rng.uniform(50.0, 2000.0, (12, T)).astype(np.float32)
    sc = rng.uniform(0.1, 5.0, (12, T)).astype(np.float32)
    seq = rng.permutation(np.arange(12 * T, dtype=np.int32)).reshape(12, T)
    stable = rng.random((12, T)) < 0.4
    if case == "random":
        seq = rng.integers(0, 40, (12, T)).astype(np.int32)   # duplicates
        seq[rng.random((12, T)) < 0.2] = INT_MAX
        f[rng.random((12, T)) < 0.1] = np.float32(-0.0)
    elif case == "none_stable":
        stable[:] = False
    elif case == "eight_stable":
        stable[:] = False
        for r in range(12):
            stable[r, rng.choice(T, 8, replace=False)] = True
    elif case == "over_eight_stable":
        stable = rng.random((12, T)) < 0.8
        stable[0] = True
    elif case == "int_max_ties":
        # Stable slots whose seq is INT_MAX tie with every unstable slot.
        seq[rng.random((12, T)) < 0.5] = INT_MAX
        seq[:, :3] = INT_MAX
        stable[:, 1] = True
    elif case == "negative_zero":
        f[rng.random((12, T)) < 0.5] = np.float32(-0.0)
        sc[rng.random((12, T)) < 0.5] = np.float32(-0.0)
        stable[:, :10] = True
    return f, sc, stable, seq


@pytest.mark.parametrize("case", ["random", "none_stable", "eight_stable",
                                  "over_eight_stable", "int_max_ties",
                                  "negative_zero"])
def test_epilogue_matches_select_stable(case):
    f, sc, stable, seq = _select_rows(case, np.random.default_rng(7))
    key = np.where(stable, seq, INT_MAX).astype(np.int32)
    got = select_np(f, sc, stable, key)
    want = ttr.select_stable(*(torch.from_numpy(a) for a in (f, sc, stable,
                                                             seq)))
    for name, g, w in zip(("freq", "score", "valid"), got, want):
        assert_same_bits(g, w.numpy(), name)
    # Rows whose stable seqs are below INT_MAX fill min(stable, 8) outputs.
    plain_rows = ~(stable & (seq == INT_MAX)).any(1)
    np.testing.assert_array_equal(got[2].sum(1)[plain_rows],
                                  np.minimum(stable.sum(1), OUT)[plain_rows])
    if case == "negative_zero":
        assert (_bits(got[0]) != _bits(np.float32(-0.0))).all()


# ---- the match test ------------------------------------------------------

@np.errstate(over="ignore", invalid="ignore")
def test_division_free_match_test_is_exact():
    rng = np.random.default_rng(3)
    f = np.concatenate([
        rng.uniform(50.0, 2000.0, 4000),
        10.0 ** rng.uniform(-45, 38, 4000),
        [0.0, 1e-30, 1e-31, 1.5e-45, 3.4e38, -0.0, -440.0]]).astype(np.float32)
    f[::3] *= -1
    f = np.repeat(f, 9)
    # Raws at the 3% edge, a few ulps either side, and far away.
    edge = f * np.float32(1.03)
    r = np.concatenate([
        edge, f * np.float32(0.97), f - np.abs(f) * np.float32(0.03),
        f + np.abs(f) * np.float32(0.03), np.zeros_like(f)]).astype(np.float32)
    f = np.tile(f, 5)
    steps = rng.integers(-4, 5, len(r))
    for k in range(4):
        up = steps > k
        down = steps < -k
        r = np.where(up, np.nextafter(r, np.float32(np.inf)), r)
        r = np.where(down, np.nextafter(r, np.float32(-np.inf)), r)
    a = np.abs(f - r)
    plain = (a / np.maximum(np.abs(f), np.float32(1e-30))) < C
    kern = a < rel_bound_np(f)
    np.testing.assert_array_equal(kern, plain)
    assert plain.any() and (~plain).any()
    # m is the midpoint of 0.03f and its predecessor, exactly.
    assert REL_MID == (np.float64(C)
                       + np.float64(np.nextafter(C, np.float32(0)))) / 2


# ---- the tile loop -------------------------------------------------------

@pytest.mark.parametrize("s,n", [(3, 150), (2, 64), (4, 1), (3, 0)])
def test_tile_loop_matches_plain(s, n):
    """Random raws from the initial state: 150 frames is 2 full tiles and
    22 frames, 64 exactly one tile, 0 frames no tile."""
    raws = _random_raws(np.random.default_rng(20 + n), s, n)
    out, paths = _assert_kernel_matches_plain(_init(s), raws)
    assert all(paths)                    # the rank-space rounds ran
    if n >= 64:
        assert out[2].sum() > 0


def test_tile_loop_state_carry():
    """A state carried between two calls gives the bits of one call."""
    s, n1, n2 = 3, 70, 45
    rf, rs, rv, on = _random_raws(np.random.default_rng(4), s, n1 + n2)
    st_a, out_a, _ = kernel_np(_init(s), rf[:, :n1], rs[:, :n1], rv[:, :n1],
                               on[:, :n1])
    st_b, out_b, _ = kernel_np(st_a, rf[:, n1:], rs[:, n1:], rv[:, n1:],
                               on[:, n1:])
    st_f, out_f, _ = kernel_np(_init(s), rf, rs, rv, on)
    for a, b, f in zip(out_a, out_b, out_f):
        assert_same_bits(np.concatenate([a, b], 1), f)
    for b, f in zip(st_b, st_f):
        assert_same_bits(b, f)
    _assert_kernel_matches_plain(st_a, (rf[:, n1:], rs[:, n1:], rv[:, n1:],
                                        on[:, n1:]))


def test_tile_loop_negative_zero_raws():
    """-0.0 raw freqs and scores: spawned and selected values are +0.0 as
    the plain masked sums give them; a snapped match keeps -0.0."""
    raws = _random_raws(np.random.default_rng(9), 3, 90, neg_zero=True)
    _assert_kernel_matches_plain(_init(3), raws)
    # Frame by frame, so a spawned -0.0 is seen before a later spawn
    # overwrites its slot.
    st = _init(3)
    for i in range(40):
        frame = tuple(np.ascontiguousarray(a[:, i:i + 1]) for a in raws)
        _assert_kernel_matches_plain(st, frame)
        st, _, _ = kernel_np(st, *frame)


def _outside_state(rng, s):
    """States handed in from outside that break the rank-space invariant:
    duplicate seqs, seqs at or above next_seq, valid slots with life 0 or
    below or with seq INT_MAX, and a next_seq near overflow."""
    freq = rng.uniform(50.0, 2000.0, (s, T)).astype(np.float32)
    score = rng.uniform(0.1, 5.0, (s, T)).astype(np.float32)
    life = rng.integers(-1, 4, (s, T)).astype(np.int32)
    valid = rng.random((s, T)) < 0.6
    seq = rng.integers(0, 12, (s, T)).astype(np.int32)
    nseq = np.full(s, 8, np.int32)
    seq[1, :4] = INT_MAX
    valid[1, :4] = True
    nseq[2] = INT_MAX - 5
    life[3] = np.maximum(life[3], 1)              # only seq >= next_seq
    return ttr.TrackerState(freq, score, life, valid, seq, nseq)


def test_tile_loop_state_from_outside():
    """A state handed in that breaks the invariant takes the generic rounds
    and still matches the plain scan, ties and all."""
    rng = np.random.default_rng(13)
    st = _outside_state(rng, 4)
    raws = _random_raws(rng, 4, 80)
    # Raws near the handed-in tracks, so the odd slots are matched.
    raws[0][:, :3, :T // 3] = st.freq[:, None, :R]
    _, paths = _assert_kernel_matches_plain(st, raws)
    assert not any(paths)

