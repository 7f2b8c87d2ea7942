// K2: the 13-harmonic comb (ref src/audio_io/stft.rs:499-545).  Replaces
// the Pallas kernel audio_analyzer_rs_tpu/ops/pallas_comb.py `_comb_kernel`
// (launched by `comb_pallas`), which never compiled on the TPU because
// Mosaic rejects stride-n lane slices.
//
// One block per frame.  The frame's peak-masked row pm is staged once in
// shared memory, zero-padded in front (FRONT slots, for offsets down to
// -n-1) and behind (up to MAX_H*kc + FRONT), so every harmonic read is an
// unguarded shared-memory load at any stride.  One thread per candidate
// bin k walks n = 2..14 and, for each, the offsets c = -n-1..n+1 in
// ascending order with a strict `>`, so the first maximum wins exactly as
// in the reference's ascending scan.
//
// Bit-exact to the plain torch `_comb` (a transcription of the JAX
// `_comb_xla`): frac*n, e-1 and e+1 are formed with __fmul_rn / __fadd_rn
// (a contracted fmaf(frac, n, -1) could move the floor at a boundary), and
// the score adds the matched magnitudes in the reference's order.  The
// kernel computes every candidate for every harmonic: the JAX bounds (a)
// and (b) only skip work whose result is the identity (harmonic beyond
// half) or a miss (a window above the last peak bin, all zeros here too).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_H = 14;
constexpr int FRONT = MAX_H + 2;

__global__ void comb_kernel(const float* __restrict__ pm,
                            const float* __restrict__ frac,
                            const float* __restrict__ fund,
                            float* __restrict__ score_out,
                            int* __restrict__ run_out,
                            int* __restrict__ tot_out, int kc, int half,
                            int row_len) {
  extern __shared__ float row[];          // [row_len], pm at [FRONT, FRONT+kc)
  const long long f = blockIdx.x;
  const float* pm_f = pm + f * kc;
  for (int i = threadIdx.x; i < row_len; i += blockDim.x) {
    const int k = i - FRONT;
    row[i] = (k >= 0 && k < kc) ? pm_f[k] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kc; k += blockDim.x) {
    const float fr = frac[f * kc + k];
    float score = fund[f * kc + k];
    int last = k;
    int longest = 0, current = 0, total = 0;
    for (int n = 2; n <= MAX_H; ++n) {
      const float e = __fmul_rn(fr, static_cast<float>(n));
      const bool valid_n = e < static_cast<float>(half);
      const int start = max(static_cast<int>(floorf(__fadd_rn(e, -1.0f))),
                            last + 1);
      const int end = min(static_cast<int>(ceilf(__fadd_rn(e, 1.0f))),
                          half - 1);
      const int nk = n * k;
      float best = 0.f;
      int best_pos = 0;
      for (int c = -n - 1; c <= n + 1; ++c) {
        const int pos = nk + c;
        const float v = (pos >= start && pos <= end) ? row[FRONT + pos] : 0.f;
        if (v > best) {                   // strict: the first maximum wins
          best = v;
          best_pos = pos;
        }
      }
      const bool found = best > 0.f;
      const bool fe = found && valid_n;
      const bool miss = !found && valid_n;
      score = __fadd_rn(score, fe ? best : 0.f);
      if (fe) last = best_pos;
      if (miss) longest = max(longest, current);
      current = fe ? current + 1 : (miss ? 0 : current);
      total += fe ? 1 : 0;
    }
    longest = max(longest, current);
    score_out[f * kc + k] = score;
    run_out[f * kc + k] = longest;
    tot_out[f * kc + k] = total;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int aat_comb(const float* pm, const float* frac, const float* fund,
             float* score, int* longest_run, int* total_harms, int n, int kc,
             int half, void* stream) {
  if (n <= 0 || kc <= 0) return static_cast<int>(cudaGetLastError());
  const int row_len = FRONT + MAX_H * kc + FRONT;
  const size_t smem = static_cast<size_t>(row_len) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        comb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = kc >= 512 ? 512 : ((kc + 31) / 32) * 32;
  comb_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pm, frac, fund, score, longest_run, total_harms, kc, half, row_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
