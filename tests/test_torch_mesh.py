"""The mesh (parallel/mesh.py) on the CPU: 4 gloo ranks against `mesh=None`
and against the JAX package's 8-device virtual mesh.

The ranks are spawned once for the module (the `world` fixture, through
`parallel.dryrun.run_world`: a FileStore under tmp_path, one thread a rank,
a join timeout); each runs every case of `_rank_cases` and returns its
outputs, and the tests compare them.  The cases port JAX's
tests/test_parallel.py (sharded against one device: stable frequencies and
the fleet floor within rtol 1e-5, fired onsets equal; each stream detects
its own tone; the pooled wave bitwise over 3 chained waves; the floor
causality), tests/test_segmented.py:205 (the segmented pitch path on a
mesh, bitwise; here also the onset path and the floor warmup) and
tests/test_batch_segmented.py:137 (3 recordings x 4 segments; here also
3 x 3 rows padded to 12).

The segmented geometries keep every plain K1 product at <= 128 rows with
and without the mesh: the CPU's GEMM changes a row's bits from ~130 rows
(ROADMAP Queue 3, CPU only), which the card's K1 does not.
"""

import threading

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models import segmented as tseg
from audio_analyzer_rs_tpu_torch.models.analyzer import (OnsetAnalyzer,
                                                         PitchAnalyzer)
from audio_analyzer_rs_tpu_torch.ops import dynamics, reducer
from audio_analyzer_rs_tpu_torch.parallel import dryrun
from audio_analyzer_rs_tpu_torch.parallel import mesh as tmesh
from audio_analyzer_rs_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

WORLD = 4
SR48, SR = 48000.0, 44100.0
TONES = [220.0, 261.63, 329.63, 392.0, 440.0, 523.25, 587.33, 659.26]
SLOT, CAUSAL_SLOTS = 1024, 32
PITCH_KW = dict(segments=4, warmup_frames=64, chunk_frames=16)
FLOOR_KW = dict(segments=4, warmup_frames=48, chunk_frames=16,
                warmup_mode="floor")
ONSET_KW = dict(segments=4, warmup_frames=256, chunk_frames=1024)
BATCH_KW = dict(segments_per_recording=4, warmup_frames=64, chunk_frames=8)
OBATCH_KW = dict(segments_per_recording=3, warmup_frames=128,
                 chunk_frames=512)


def full_audio():
    """JAX test_sharded_matches_single_device's input: [8, 4096]."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((8, 4096)) * 0.05).astype(np.float32)


def tone_audio():
    chunk = 6 * 1024
    return np.stack([gen.tone_with_harmonics(f, chunk / SR48, SR48,
                                             harmonics=6,
                                             amplitude=0.3)[:chunk]
                     for f in TONES]).astype(np.float32)


def causal_scene():
    """Quiet first half, loud second half (the floor-causality scene)."""
    rng = np.random.default_rng(7)
    half = CAUSAL_SLOTS // 2 * SLOT
    return np.concatenate([rng.standard_normal(half) * 1e-3,
                           rng.standard_normal(half) * 0.2]).astype(
                               np.float32)


def scene():
    return gen.mixed_scene(8.0, SR, seed=2)


def takes():
    return [gen.mixed_scene(t, SR, seed=s)
            for t, s in ((4.0, 1), (3.0, 2), (2.5, 3))]


def _full_steps(mesh, audio, steps=1):
    sh = tmesh.batch_sharding(mesh) if mesh is not None else None
    step = tsh.make_batched_full_step(mesh, SR48, device="cpu")
    st = tsh.init_stream_states(audio.shape[0], device="cpu")
    x = torch.from_numpy(audio)
    if sh is not None:
        st, x = sh.shard((st, x))
    for _ in range(steps):
        st, out = step(st, x)
    return out


def _segmented(mesh):
    x, xs = scene(), takes()
    return {
        "pitch": tseg.segmented_pitch_analysis(x, SR, mesh=mesh,
                                               device="cpu", **PITCH_KW),
        "floor": tseg.segmented_pitch_analysis(x, SR, mesh=mesh,
                                               device="cpu", **FLOOR_KW),
        "pipelined": tseg.segmented_pitch_analysis(
            x, SR, mesh=mesh, device="cpu", transfer="pipelined",
            **PITCH_KW),
        "onset": tseg.segmented_onset_analysis(x, SR, mesh=mesh,
                                               device="cpu", **ONSET_KW),
        "batch": tseg.segmented_pitch_analysis_batch(xs, SR, mesh=mesh,
                                                     device="cpu",
                                                     **BATCH_KW),
        "onset_batch": tseg.segmented_onset_analysis_batch(
            xs, SR, mesh=mesh, device="cpu", **OBATCH_KW),
    }


def _rank_cases(rank, world):
    """Every case on one rank; returns its outputs."""
    mesh = tmesh.make_mesh("cpu")
    out = {"size": mesh.size(), "coordinate": tuple(mesh.get_coordinate())}
    out["full"] = _full_steps(mesh, full_audio())
    out["tones"] = _full_steps(mesh, tone_audio(), steps=2)
    causal = np.stack([causal_scene()] * world)
    out["causal"] = _full_steps(mesh, causal)
    out["pool"] = dryrun.pooled_wave_check(mesh, 2 * world, 3, seed=3)
    out["segmented"] = _segmented(mesh)
    sub = tmesh.make_mesh("cpu", world=2)
    coord = sub.get_coordinate()
    out["sub"] = (sub.size(), coord if coord is None else tuple(coord))
    try:
        tmesh.check_mesh(sub, "cpu")
        out["sub_check"] = None
    except ValueError as e:
        out["sub_check"] = str(e)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4 ranks' outputs; while they run, this process computes the
    references (mesh=None)."""
    box = {}

    def spawn():
        try:
            box["ranks"] = dryrun.run_world(
                _rank_cases, WORLD,
                workdir=str(tmp_path_factory.mktemp("mesh")), timeout=300.0)
        except BaseException as e:       # re-raised below
            box["error"] = e
    t = threading.Thread(target=spawn)
    t.start()
    ref = {"full": _full_steps(None, full_audio()),
           "tones": _full_steps(None, tone_audio(), steps=2),
           "segmented": _segmented(None)}
    t.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], ref


def _cat(ranks, key):
    return tsh.FullStepOut(*(
        torch.cat([r[key][i] for r in ranks]) if r0.dim() else r0
        for i, r0 in enumerate(ranks[0][key])))


def test_mesh_spans_the_ranks(world):
    ranks, _ = world
    assert [r["size"] for r in ranks] == [WORLD] * WORLD
    assert [r["coordinate"] for r in ranks] == [(k,) for k in range(WORLD)]


def test_sub_mesh_leaves_out_the_other_ranks(world):
    ranks, _ = world
    assert [r["sub"] for r in ranks] == [(2, (0,)), (2, (1,)), (2, None),
                                         (2, None)]
    assert [r["sub_check"] is None for r in ranks] == [True, True, False,
                                                       False]
    assert "not in the mesh" in ranks[2]["sub_check"]


def test_sharded_full_step_matches_one_card(world):
    """JAX's test_sharded_matches_single_device: stable frequencies and the
    fleet floor within rtol 1e-5, fired onsets equal; every rank sees the
    same fleet statistics."""
    ranks, ref = world
    got, want = _cat(ranks, "full"), ref["full"]
    assert got.stable_freqs.shape == want.stable_freqs.shape
    np.testing.assert_allclose(got.stable_freqs.numpy(),
                               want.stable_freqs.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got.onset_fired.numpy(),
                                  want.onset_fired.numpy())
    for r in ranks:
        np.testing.assert_allclose(float(r["full"].global_noise_floor_db),
                                   float(want.global_noise_floor_db),
                                   rtol=1e-5)
        assert int(r["full"].global_onset_count) == \
            int(want.global_onset_count)


def test_sharded_streams_detect_their_own_tones(world):
    """JAX's test_batched_streams_detect_their_own_tones: 8 streams, 2 a
    rank, two steps; each stream's last frame holds its own tone, and the
    shares equal the one-card step's rows."""
    ranks, ref = world
    got = _cat(ranks, "tones")
    sf, sv = got.stable_freqs.numpy(), got.stable_valid.numpy()
    for b, f in enumerate(TONES):
        found = sf[b, -1][sv[b, -1]]
        assert any(abs(g - f) / f < 0.02 for g in found), (b, f, found)
    np.testing.assert_array_equal(sv, ref["tones"].stable_valid.numpy())
    np.testing.assert_allclose(sf, ref["tones"].stable_freqs.numpy(),
                               rtol=1e-5)


def test_sharded_step_floor_causality_matches_streaming_path(world):
    """JAX's test_batched_step_floor_causality_matches_streaming_path on the
    mesh: every rank's stream (the quiet-then-loud scene) equals the
    sequential analyzers fed slot by slot with each slot's own floor."""
    ranks, _ = world
    x = causal_scene()
    _, y = reducer.reduce_signal(reducer.reducer_init("cpu"),
                                 torch.from_numpy(x), SR48)
    _, douts, gained = dynamics.dynamics_scan(
        dynamics.init_state("cpu"), y.reshape(CAUSAL_SLOTS, SLOT), SR48,
        SLOT, "hist")
    floors = douts.noise_floor_db.numpy()
    assert floors.max() - floors.min() > 6.0, "the scene must move the floor"
    pa, oa = PitchAnalyzer(SR48, device="cpu"), OnsetAnalyzer(SR48,
                                                              device="cpu")
    p_outs, o_outs = [], []
    for k in range(CAUSAL_SLOTS):
        po = pa.process(gained[k].numpy(), global_floor_db=float(floors[k]))
        if po is not None:
            p_outs.append((po.stable_freqs, po.stable_valid))
        oo = oa.process(gained[k].numpy(), global_floor_db=float(floors[k]))
        if oo is not None:
            o_outs.append((oo.fired, oo.velocity))
    sf_seq = np.concatenate([f for f, _ in p_outs])
    sv_seq = np.concatenate([v for _, v in p_outs])
    fired_seq = np.concatenate([f for f, _ in o_outs])
    vel_seq = np.concatenate([v for _, v in o_outs])
    for r in ranks:
        out = r["causal"]
        assert out.stable_freqs.shape[0] == 1
        np.testing.assert_array_equal(out.stable_valid[0].numpy(), sv_seq)
        np.testing.assert_allclose(out.stable_freqs[0].numpy(), sf_seq,
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(out.onset_fired[0].numpy(), fired_seq)
        np.testing.assert_allclose(out.onset_velocity[0].numpy(), vel_seq,
                                   rtol=1e-5, atol=1e-5)


def test_pooled_wave_sharded_matches_one_card(world):
    """JAX's test_pooled_wave_sharded_matches_single_device: 8 lanes, 2 a
    rank, 3 chained waves, every lane's packed outputs and carries bitwise
    those of the one-card pool step (`pooled_wave_check` raises on a
    difference)."""
    ranks, _ = world
    assert [r["pool"] for r in ranks] == [{"lanes": 2, "waves": 3}] * WORLD


@pytest.mark.parametrize("name", ["pitch", "floor", "onset", "pipelined"])
def test_segmented_on_the_mesh_is_bitwise(world, name):
    """One recording's segments shared over the mesh: every rank returns
    the mesh-free result bit for bit (JAX's tests/test_segmented.py:205
    for the pitch path); with transfer="pipelined" each rank stages only
    its own rows, and the result is the resident mesh-free one."""
    ranks, ref = world
    want = ref["segmented"][name]
    if name == "pipelined":
        for a, b in zip(want, ref["segmented"]["pitch"]):
            np.testing.assert_array_equal(a, b)
    assert want[0].shape[0] > 600
    for r in ranks:
        for a, b in zip(r["segmented"][name], want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["batch", "onset_batch"])
def test_batch_on_the_mesh_is_bitwise(world, name):
    """JAX's tests/test_batch_segmented.py:137: 3 recordings x 4 segments
    (12 rows, 3 a rank) for pitch; 3 x 3 = 9 rows padded to 12 for onsets;
    every rank returns the mesh-free batch bit for bit."""
    ranks, ref = world
    want = ref["segmented"][name]
    assert len(want) == 3
    for r in ranks:
        for got_take, want_take in zip(r["segmented"][name], want):
            for a, b in zip(got_take, want_take):
                np.testing.assert_array_equal(a, b)


class _Size:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


@pytest.mark.parametrize("segments,size,want", [
    (128, 1, 128), (128, 4, 128), (10, 4, 8), (3, 4, 4), (7, 8, 8),
    (17, 8, 16)])
def test_snap_to_mesh(segments, size, want):
    """JAX `_snap_to_mesh`: down to a multiple of the mesh, at least one
    segment a rank."""
    from audio_analyzer_rs_tpu.models.segmented import _snap_to_mesh

    class JaxMesh:
        pass
    jm = JaxMesh()
    jm.size = size
    assert tseg._snap_to_mesh(segments, _Size(size)) == want
    assert _snap_to_mesh(segments, jm) == want
    assert tseg._snap_to_mesh(segments, None) == segments


def test_pack_batch_pads_rows_to_the_mesh():
    plan = tseg._plan_streams(400, 3, 64, 16, 2048, 512)
    hosts = [np.zeros(1000, np.float32)] * 3
    _, starts = tseg._pack_batch(hosts, plan, 512)
    _, padded = tseg._pack_batch(hosts, plan, 512, _Size(4))
    assert len(starts) == 9 and len(padded) == 12
    np.testing.assert_array_equal(padded[:9], starts)
    assert not padded[9:].any()


def test_mesh_arguments_are_checked():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsh.make_batched_full_step(object(), SR48, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tseg.segmented_onset_analysis_batch([np.zeros(4096, np.float32)], SR,
                                            mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh("cpu")


def test_dryrun_multichip(capsys):
    """The port's twin of `__graft_entry__.dryrun_multichip`, at 4 ranks."""
    dryrun.dryrun_multichip(WORLD)
    printed = capsys.readouterr().out
    assert "full-step OK: 4 ranks" in printed
    assert "pool OK: 8 live sessions" in printed


def test_full_step_matches_jax_8_device_mesh(world):
    """The 4-rank step against the JAX package's own step on its 8-device
    virtual mesh (tests/conftest.py), batch 8, chunk 4096, at
    tests/test_torch_full_step.py's tolerances for torch's own FFT: fired
    onsets, levels and the onset count equal, stable slots equal but for
    FFT straddles (<= 1%), frequencies within 5e-5 where they agree,
    velocities within 1e-5, the fleet floor within 1e-5 dB."""
    import jax

    from audio_analyzer_rs_tpu.parallel import sharding as jsh
    from audio_analyzer_rs_tpu.parallel.mesh import (batch_sharding,
                                                     make_mesh)
    ranks, _ = world
    got = _cat(ranks, "full")
    jmesh = make_mesh()
    assert jmesh.size == 8
    sh = batch_sharding(jmesh)
    jst = jsh.init_stream_states(8)
    jst = jax.device_put(jst, jax.tree.map(lambda _: sh, jst))
    _, jout = jsh.make_batched_full_step(jmesh, SR48)(
        jst, jax.device_put(full_audio(), sh))
    for f in ("onset_fired", "dyn_level", "global_onset_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)
    valid, jvalid = got.stable_valid.numpy(), np.asarray(jout.stable_valid)
    flips = valid != jvalid
    assert flips.sum() <= 0.01 * valid.size, np.argwhere(flips)
    same = ~flips.any(-1, keepdims=True) & valid
    np.testing.assert_allclose(
        np.where(same, got.stable_freqs.numpy(), 0),
        np.where(same, np.asarray(jout.stable_freqs), 0), rtol=5e-5)
    np.testing.assert_allclose(got.onset_velocity.numpy(),
                               np.asarray(jout.onset_velocity), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.global_noise_floor_db),
                               float(jout.global_noise_floor_db), rtol=0,
                               atol=1e-5)
