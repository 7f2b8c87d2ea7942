"""audio_analyzer_rs_tpu_torch — the PyTorch/CUDA port of audio_analyzer_rs_tpu.

The JAX package beside it is the reference this port is held against; this
package imports `torch` and never `jax`.  Plain tensor code is PyTorch, and
each TPU (Pallas) kernel on the ported path is a hand-written Hopper kernel
under `csrc/`, built with nvcc at first use (`_build.py`) and bound through
ctypes.  Every kernel wrapper runs its plain PyTorch version for tensors on
the CPU and launches its kernel (or raises) for tensors on a CUDA device.

Layer map (mirrors the JAX package):
  analysis           analyze_buffer (sequential) and analyze_buffer_segmented
                     (bulk): per-frame features, pitches and onsets
  utils/framing      hop-strided framing (Tensor.unfold)
  ops/fft, ops/stft  Hann × rDFT magnitude; the "dft" backend is kernel K1
                     (ops/hopper_stft.py, csrc/stft.cu), the "fft" backend
                     kernel K11 (ops/hopper_rfft.py, csrc/rfft_mag.cu);
                     rfft_complex/irfft (cuFFT)
  ops/noisefloor     per-bin noise-floor recurrence (kernel K5:
                     ops/hopper_noisefloor.py, csrc/noisefloor.cu)
  ops/reducer        input conditioning, HPF -> LPF -> noise gate: the
                     device scan `reduce_signal` (kernel K6:
                     ops/hopper_reducer.py, csrc/reducer.cu) and the host
                     (numpy) reducer the engine runs per slot
  ops/dynamics       AGC and dynamics: the device scan `dynamics_scan`
                     (kernel K7: ops/hopper_dynamics.py, csrc/dynamics.cu)
                     and the host (numpy) tracker the engine runs per slot
  ops/rounding       fma32: a*b + c rounded once, as the kernels' fmaf
  ops/pitch          peaks, interpolation, the harmonic comb, gates,
                     top-K, dedup: on the card one kernel, K10
                     (ops/hopper_extract.py, csrc/extract.cu), whose comb
                     is K2's (csrc/comb.cuh; K2's own entry ops/hopper_comb.py)
  ops/tracker        the 24-slot PitchTracker scan and its stable top-8
                     (kernel K3: ops/hopper_tracker.py, csrc/tracker.cu)
  ops/onset          the spectral-flux onset recurrence (kernel K4:
                     ops/hopper_onset.py, csrc/onset.cu)
  ops/features       RMS, energy, centroid, rolloff, flux (plain torch)
  ops/yin            YIN f0 from an FFT autocorrelation (plain torch)
  models/analyzer    PitchAnalyzer and OnsetAnalyzer (sequential streaming);
                     fused_slot_step, the live engine's per-slot program
                     (both flows, carries on the device) for one engine or
                     K lanes; fused_slot_agg_step (A slots chained),
                     fused_slot_pool_step (an engine pool's wave) and
                     fused_slot_pool_step_stacked (the wave over stacked
                     carries, the form the mesh shards)
  models/segmented   segment-parallel and batched offline pitch and onset
                     analysis, on one card or shared over a mesh
  api/engine         AudioEngine, the uniffi-shaped live engine: virtual
                     audio device, host reducer and AGC, tuner, onset
                     detection with loopback calibration, practice
                     sessions, JSON polling
  api/pool           EnginePool: K live engines in lockstep, each slot wave
                     one batched slot program, deferred readback,
                     speculative calibration, capacity padding
  api/rpc            RpcServer: the line-delimited JSON-RPC surface, with
                     sessions and pool.join
  checkpoint         save/load of analyzer, transport and engine state
                     (the JAX package's file format)
  api/device         the virtual audio device and its input sources
  runtime            the C++ host reducer, built when possible
  parallel/mesh      make_mesh (a 1-D torch DeviceMesh named "data"),
                     batch_sharding, replicated: data parallelism over
                     torch.distributed ranks
  parallel/sharding  make_batched_full_step: reducer -> AGC -> pitch ->
                     onset over a batch of B streams, on one card or each
                     rank its share with the fleet statistics all-reduced;
                     make_pooled_wave_step: an engine pool's lanes shared
                     over a mesh
  parallel/dryrun    dryrun_multichip(n): the mesh over n gloo processes
                     on the CPU, held to one process
  spans              host spans inside the full step (off by default;
                     enable/disable/drain), on the host clock
  ops/gather         the Mosaic probe's lane gathers (kernels K8 and K9:
                     ops/hopper_gather.py, csrc/gather.cu; their path is
                     port_tools/gather_probe.py)
  models/{sources,calibration,metronome,synth,player,tuner}, practice/,
  theory, transport, tracing, utils/{midi,wav}
                     host modules, copies of the JAX package's
  interop            JAX-package states (the full step's too) and fused
                     carries (as numpy) <-> this package's
  devtools           the debug recorders (per-frame spectrum, floor,
                     pitch and onset decision records; JSONL stream and
                     its terminal view), a copy of the JAX package's
  cli                the command-line harness (python -m
                     audio_analyzer_rs_tpu_torch.cli ... --device cuda|cpu)

Every entry point takes `device` (default "cuda"); nothing picks the CPU on
its own.
"""

import torch

# Full-precision float32 products everywhere: reduced-precision GEMMs fail
# the 1e-6 spectral fidelity gate.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

_EXPORTS = {
    "analysis": ("analyze_buffer", "analyze_buffer_segmented",
                 "AnalysisResult", "AnalysisArrays", "FrameFeatures"),
    "models.segmented": ("segmented_pitch_analysis",
                         "segmented_onset_analysis",
                         "segmented_pitch_analysis_batch",
                         "segmented_onset_analysis_batch"),
    "models.analyzer": ("PitchAnalyzer", "OnsetAnalyzer"),
    "ops.reducer": ("reduce_signal",),
    "ops.dynamics": ("dynamics_scan",),
    "parallel.sharding": ("make_batched_full_step", "init_stream_states",
                          "make_pooled_wave_step"),
    "parallel.mesh": ("make_mesh",),
    "api.engine": ("AudioEngine",),
    "api.pool": ("EnginePool",),
    "transport": ("MusicalTransport",),
    "runtime": ("decode_file", "encode_file", "decode_available"),
}


def __getattr__(name):
    # Lazy re-exports of the public surface, as the JAX package has them.
    import importlib
    for module, names in _EXPORTS.items():
        if name in names:
            return getattr(importlib.import_module(f".{module}", __name__),
                           name)
    raise AttributeError(name)
