"""The port's batched full step (parallel/sharding.py
`make_batched_full_step` with mesh=None, on the CPU: every kernel's plain
version) against the JAX package's on a one-device mesh, and the composed
chain against JAX's exact NumPy oracle `full_chain_np`.

Tolerances: stable valid flags, fired onsets, dynamic levels and the
onset count equal; stable frequencies within 5e-5 relative and onset
velocities within 1e-6 absolute; the fleet's mean floor within 1e-5 dB.
The reducer and the AGC's conditioned output are bitwise to JAX's (the
AGC's floats within ~1e-7); what differs is the "fft" STFT: torch's FFT
and XLA's round differently (~1.5% of the magnitudes are bitwise equal).
So the step is held to JAX's twice: with JAX's FFT magnitudes substituted
(every decision equal, floats as above), and with its own (decisions
equal but for FFT straddles, at most 1% of the stable slots; velocities
within 1e-5: measured 1.5e-6).  The composed-chain gates are JAX's
(tests/test_fullchain_divergence.py): hist against exact AGC >= 99.9% of
pitch frames with identical fired onsets, against the oracle >= 98% of
pitch frames and >= 99.9% of onset frames.
"""

import jax
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as jgen
from audio_analyzer_rs_tpu.parallel import sharding as jsh
from audio_analyzer_rs_tpu.parallel.mesh import make_mesh
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models.analyzer import (OnsetAnalyzer,
                                                         PitchAnalyzer)
from audio_analyzer_rs_tpu_torch.ops import dynamics, reducer
from audio_analyzer_rs_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

SR = 48000.0
B, T = 4, 8192


def port_step(mode="hist"):
    return tsh.make_batched_full_step(None, SR, dyn_mode=mode, device="cpu")


def assert_outs(got: tsh.FullStepOut, want, tag):
    for f in ("stable_valid", "onset_fired", "dyn_level",
              "global_onset_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      f"{tag} {f}")
    np.testing.assert_allclose(got.stable_freqs.numpy(),
                               np.asarray(want.stable_freqs), rtol=5e-5,
                               err_msg=f"{tag} stable_freqs")
    np.testing.assert_allclose(got.onset_velocity.numpy(),
                               np.asarray(want.onset_velocity), rtol=0,
                               atol=1e-6, err_msg=f"{tag} velocity")
    np.testing.assert_allclose(float(got.global_noise_floor_db),
                               float(want.global_noise_floor_db), rtol=0,
                               atol=1e-5, err_msg=f"{tag} global floor")


@pytest.fixture(scope="module")
def audio():
    """[4, 2T]: mixed scenes over harmonic tones, one stream quiet in its
    second chunk, one silent in its first."""
    rows = []
    for i in range(B):
        x = gen.mixed_scene(2 * T / SR + 0.05, SR, seed=20 + i)[:2 * T]
        x = x + gen.tone_with_harmonics(220.0 * (i + 1), 2 * T / SR + 0.05,
                                        SR, amplitude=0.2)[:2 * T]
        rows.append(x.astype(np.float32))
    out = np.stack(rows)
    out[1, T:] *= np.float32(1e-3)
    out[2, :T] = 0.0
    return out


def _jax_fft_mags(frames, window, backend="fft", band=None):
    """The JAX package's "fft" magnitudes of the same frames, for the port's
    step: the STFT equalized, as tests/test_divergence_proof.py does."""
    from audio_analyzer_rs_tpu.ops.stft import windowed_mags
    return torch.from_numpy(np.array(windowed_mags(
        jax.numpy.asarray(frames.numpy()), window)))


def _run_both(audio, mode, monkeypatch=None):
    jstep = jsh.make_batched_full_step(make_mesh(jax.devices()[:1]), SR,
                                       dyn_mode=mode)
    if monkeypatch is not None:
        monkeypatch.setattr(tsh, "windowed_mags", _jax_fft_mags)
    step = port_step(mode)
    jst, st = jsh.init_stream_states(B), tsh.init_stream_states(B,
                                                                device="cpu")
    runs = []
    for k in range(2):
        chunk = audio[:, k * T:(k + 1) * T]
        jst_prev = jst
        jst, jout = jstep(jst, chunk)
        st, out = step(st, chunk)
        runs.append((out, jout))
    carried = interop.stream_states(jax.tree.map(np.asarray, jst_prev),
                                    "cpu")
    _, out2 = step(carried, audio[:, T:])
    runs.append((out2, jout))
    return runs


@pytest.mark.parametrize("mode", ["hist", "exact"])
def test_full_step_matches_jax_with_its_fft(audio, mode, monkeypatch):
    """With the STFT equalized (the JAX package's FFT magnitudes in the
    port's step), two chained steps, and a second step from JAX's states
    carried across by `interop.stream_states`, equal JAX's step on a
    one-device mesh: every decision, and the floats within the tolerances
    above."""
    for k, (out, jout) in enumerate(_run_both(audio, mode, monkeypatch)):
        assert out.stable_freqs.shape == (B, 13, 8)
        assert out.onset_fired.shape == (B, 125)
        assert out.dyn_level.shape == (B, 8)
        assert_outs(out, jout, f"{mode} run {k}")
        assert int(out.global_onset_count) == int(out.onset_fired.sum())
    assert bool(out.stable_valid.any()) and bool(out.onset_fired.any())


@pytest.mark.parametrize("mode", ["hist", "exact"])
def test_full_step_matches_jax(audio, mode):
    """The port's own step (torch's FFT) against JAX's: the reducer and AGC
    outputs agree (levels equal), onsets identical, and the stable slots
    equal but for straddles of torch's and XLA's FFT rounding, which the
    equalized test above removes: measured 0 flips in hist mode and 3 of
    416 stable slots in exact mode (stream 0, the 660 Hz partial)."""
    for k, (out, jout) in enumerate(_run_both(audio, mode)):
        for f in ("onset_fired", "dyn_level", "global_onset_count"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(jout, f)))
        valid, jvalid = out.stable_valid.numpy(), np.asarray(
            jout.stable_valid)
        flips = valid != jvalid
        assert flips.sum() <= 0.01 * valid.size, np.argwhere(flips)
        same = ~flips.any(-1, keepdims=True) & valid
        np.testing.assert_allclose(
            np.where(same, out.stable_freqs.numpy(), 0),
            np.where(same, np.asarray(jout.stable_freqs), 0), rtol=5e-5)
        np.testing.assert_allclose(out.onset_velocity.numpy(),
                                   np.asarray(jout.onset_velocity), rtol=0,
                                   atol=1e-5)


def test_mesh_and_modes_are_checked():
    with pytest.raises(TypeError, match="mesh"):
        tsh.make_batched_full_step(object(), SR, device="cpu")
    with pytest.raises(ValueError, match="dyn_mode"):
        tsh.make_batched_full_step(None, SR, dyn_mode="sorted")
    step = port_step()
    with pytest.raises(ValueError, match="no slot"):
        step(tsh.init_stream_states(1, device="cpu"), np.zeros((1, 1500)))


def test_floor_causality_matches_streaming_path():
    """The twin of JAX's test_batched_step_floor_causality_matches_
    streaming_path: each pitch and onset frame of the full step reads the
    AGC floor of the slot holding its last sample, as the sequential
    analyzers fed slot by slot with each slot's own floor do.  Scene: quiet
    first half, loud second half (32 slots)."""
    slot_len, n_slots = 1024, 32
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.standard_normal(n_slots // 2 * slot_len) * 1e-3,
                        rng.standard_normal(n_slots // 2 * slot_len) * 0.2]
                       ).astype(np.float32)
    _, (sf, sv, fired, vel, _, _) = tsh._batched_stream_step(
        tsh.init_stream_states(1, device="cpu"), torch.from_numpy(x)[None],
        SR, slot_len, 512, 64, "hist")
    _, y = reducer.reduce_signal(reducer.reducer_init("cpu"),
                                 torch.from_numpy(x), SR)
    _, douts, gained = dynamics.dynamics_scan(
        dynamics.init_state("cpu"), y.reshape(n_slots, slot_len), SR,
        slot_len, "hist")
    floors = douts.noise_floor_db.numpy()
    assert floors.max() - floors.min() > 6.0, "the scene must move the floor"
    pa, oa = PitchAnalyzer(SR, device="cpu"), OnsetAnalyzer(SR, device="cpu")
    p_outs, o_outs = [], []
    for k in range(n_slots):
        po = pa.process(gained[k].numpy(), global_floor_db=float(floors[k]))
        if po is not None:
            p_outs.append((po.stable_freqs, po.stable_valid))
        oo = oa.process(gained[k].numpy(), global_floor_db=float(floors[k]))
        if oo is not None:
            o_outs.append((oo.fired, oo.velocity))
    sf_seq = np.concatenate([f for f, _ in p_outs])
    sv_seq = np.concatenate([v for _, v in p_outs])
    assert sf_seq.shape == sf[0].shape
    np.testing.assert_array_equal(sv[0].numpy(), sv_seq)
    np.testing.assert_allclose(sf[0].numpy(), sf_seq, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fired[0].numpy(),
                                  np.concatenate([f for f, _ in o_outs]))
    np.testing.assert_allclose(vel[0].numpy(),
                               np.concatenate([v for _, v in o_outs]),
                               rtol=1e-5, atol=1e-5)


def test_streams_detect_their_own_tones():
    """The twin of JAX's test_batched_streams_detect_their_own_tones: eight
    streams of eight tones, two steps; each stream's last frame holds its
    own tone."""
    tones = [220.0, 261.63, 329.63, 392.0, 440.0, 523.25, 587.33, 659.26]
    chunk = 6 * 1024
    audio = np.stack([gen.tone_with_harmonics(f, chunk / SR, SR, harmonics=6,
                                              amplitude=0.3)[:chunk]
                      for f in tones])
    step = port_step()
    st = tsh.init_stream_states(len(tones), device="cpu")
    st, out = step(st, audio)
    st, out = step(st, audio)
    sf, sv = out.stable_freqs.numpy(), out.stable_valid.numpy()
    for b, f in enumerate(tones):
        got = sf[b, -1][sv[b, -1]]
        assert any(abs(g - f) / f < 0.02 for g in got), (b, f, got)


def frame_sets(sf, sv):
    return [sorted(int(round(float(f) * 10)) for f in sf[i][sv[i]])
            for i in range(sf.shape[0])]


def test_composed_chain_gates():
    """JAX's composed-chain gates on 3 s of the canonical mixed scene (its
    seconds 10-13: the scene opens with a 10 s silent section, then
    melody): the port's chain in hist against exact AGC, and against JAX's
    exact NumPy oracle."""
    x = jgen.mixed_scene(13.0, SR, seed=3)[int(10 * SR):]
    x = x[:(len(x) // 1024) * 1024]
    states = tsh.init_stream_states(1, device="cpu")
    outs = {}
    for mode in ("hist", "exact"):
        _, (sf, sv, fired, vel, _, _) = tsh._batched_stream_step(
            states, torch.from_numpy(x)[None], SR, 1024, 512, 64, mode)
        outs[mode] = (sf[0].numpy(), sv[0].numpy(), fired[0].numpy())
    sets_h, sets_e = (frame_sets(*outs[m][:2]) for m in ("hist", "exact"))
    assert np.mean([a == b for a, b in zip(sets_h, sets_e)]) >= 0.999
    np.testing.assert_array_equal(outs["hist"][2], outs["exact"][2])
    oracle = jsh.full_chain_np(x, SR)
    sets_o = [sorted(int(round(float(f) * 10)) for f, _ in fr)
              for fr in oracle["stable"]]
    assert len(sets_o) == len(sets_h)
    assert np.mean([a == b for a, b in zip(sets_h, sets_o)]) >= 0.98
    fired_h = outs["hist"][2]
    assert (fired_h == oracle["onset_fired"][:len(fired_h)]).mean() >= 0.999
    assert fired_h.any() and any(sets_h)
