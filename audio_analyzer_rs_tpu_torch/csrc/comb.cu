// K2: the 13-harmonic comb (ref src/audio_io/stft.rs:499-545).  Replaces
// the Pallas kernel audio_analyzer_rs_tpu/ops/pallas_comb.py `_comb_kernel`
// (launched by `comb_pallas`), which never compiled on the TPU because
// Mosaic rejects stride-n lane slices.
//
// What bounds it on an H100: bytes.  At the main-path shape (8192 frames x
// kc = 464 candidates) it reads pm, frac and fund and writes score,
// longest_run and total_harms: 6 x 15.2 MB = 91.2 MB, 27 us at 3.35 TB/s.
// The useful work is small: a harmonic's search window [floor(e-1),
// ceil(e+1)] holds at most 4 bins, and pm is zero at and above max_bin, so
// only ~1,050 of a frame's 6,032 (candidate, harmonic) pairs can find a
// peak.
//
// Design: one warp per frame, WARPS frames a block.  The warp stages its
// frame's kc values of pm in shared memory (float4 loads when the rows are
// 16-byte aligned) and each lane walks candidates k = lane, lane + 32, ...
// For harmonic n a candidate scans only positions in
//   [max(floor(e-1), last+1, n*k-n-1, 0), min(ceil(e+1), n*k+n+1, max_bin-1)]
// ascending with a strict `>`, so the first maximum wins as in the
// reference's scan over offsets -n-1..n+1.  Outside that range every value
// the reference sees is 0 (pm is 0 at and above max_bin, positions below 0
// are padding, and max_bin - 1 < half - 1), and 0 never beats best = 0, so
// the clipped scan is output-identical.  An empty range is a miss (run
// reset) with no shared-memory read.  The window holds at most 4 bins
// (ceil(e+1) - floor(e-1) <= 3), so the scan is a fixed 4-step loop with a
// guard; nvcc 12.9 miscompiled the same scan written as a loop from lo to
// hi (its trip count came out wrong and the reads left the window).
// A candidate stops at the first harmonic n with
// - e >= half: it and all later harmonics are identities (e = frac*n only
//   grows with n when e > 0, and e >= half > 0 implies frac > 0); or
// - n*(k-1) > max_bin: its window and all later ones start past max_bin,
//   so all that is left are misses, and they only fold the current run
//   into the longest one, as the end of the loop does anyway.
// A miss adds nothing to the score; the reference adds +0.0, the same bits
// for the non-negative magnitudes that `fund` holds.
//
// ptxas (CUDA 12.9, sm_90a): 40 registers.  Its time on an H100 is in
// PERF.md; past the bytes, what limits it is the per-candidate chain of ~40
// instructions a live harmonic, ~1,070 live (candidate, harmonic) pairs a
// frame.
//
// Bit-exact to the plain torch `_comb` (a transcription of the JAX
// `_comb_xla`): frac*n, e-1 and e+1 are formed with __fmul_rn / __fadd_rn
// (a contracted fmaf(frac, n, -1) could move the floor at a boundary), and
// the score adds the matched magnitudes in the reference's order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "comb.cuh"

namespace {

constexpr int WARPS = 8;                 // frames a block

__global__ void __launch_bounds__(WARPS * 32)
comb_kernel(const float* __restrict__ pm, const float* __restrict__ frac,
            const float* __restrict__ fund, float* __restrict__ score_out,
            int* __restrict__ run_out, int* __restrict__ tot_out, int n,
            int kc, int half, int max_bin) {
  extern __shared__ float rows[];        // [WARPS][kc]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long f = (long long)blockIdx.x * WARPS + warp;
  if (f >= n) return;
  float* row = rows + warp * kc;
  const float* pm_f = pm + f * kc;
  if ((kc & 3) == 0 && (reinterpret_cast<uintptr_t>(pm) & 15) == 0) {
    for (int i = lane; i < kc / 4; i += 32) {
      reinterpret_cast<float4*>(row)[i] =
          __ldg(reinterpret_cast<const float4*>(pm_f) + i);
    }
  } else {
    for (int i = lane; i < kc; i += 32) row[i] = __ldg(pm_f + i);
  }
  __syncwarp();

  for (int k = lane; k < kc; k += 32) {
    const CombOut c = comb_candidate(row, __ldg(frac + f * kc + k),
                                     __ldg(fund + f * kc + k), k, half,
                                     max_bin);
    score_out[f * kc + k] = c.score;
    run_out[f * kc + k] = c.longest_run;
    tot_out[f * kc + k] = c.total_harms;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  Requires
// 0 < max_bin <= kc < half and pm zero at and above max_bin.
int aat_comb(const float* pm, const float* frac, const float* fund,
             float* score, int* longest_run, int* total_harms, int n, int kc,
             int half, int max_bin, void* stream) {
  if (n <= 0 || kc <= 0) return static_cast<int>(cudaGetLastError());
  if (max_bin <= 0 || max_bin > kc || kc >= half) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(WARPS) * kc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        comb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  comb_kernel<<<blocks, WARPS * 32, smem,
                static_cast<cudaStream_t>(stream)>>>(
      pm, frac, fund, score, longest_run, total_harms, n, kc, half, max_bin);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
