// K10: the pitch extraction of a frame in one launch (ref
// src/audio_io/stft.rs:443-620): peaks above the floor and their
// log-parabolic interpolation, the 13-harmonic comb, the fundamental and
// structure gates, the score, the 50% cutoff, top-32 by score, ghost
// suppression, the greedy 2-bin dedup and the first 8 kept, in the 24 Hz -
// 10 kHz range.  No Pallas twin: on the TPU, XLA fused these ops (JAX
// audio_analyzer_rs_tpu/ops/pitch.py `_pre_comb` :259, `_extract_single`
// :294).  The plain version is ops/pitch.py `_extract`, plain torch
// throughout, its comb included.
//
// What bounds it on an H100: bytes.  It reads a frame's kc + 1 magnitudes
// and kc floors (465 and 464 at 44.1 kHz) and writes three [8] outputs: at
// the main path's 8,192 frames a call 30.4 MB, 9.1 us at 3.35 TB/s; at the
// full step's 119,424 frames 0.135 ms.
//
// Design: one warp a frame, WARPS frames a block, the frame in shared
// memory.
// - The warp stages the magnitudes, then marks the peaks (a lane a bin),
//   writes the comb's row pm (zero off the peaks) and compacts the peaks in
//   bin order (`__ballot_sync` / `__popc`).
// - A lane a peak: the logs of the peak and its two neighbours and the
//   interpolation, the gates and K2's comb (`comb_candidate`, comb.cuh, so
//   the comb is K2's bit for bit), only for the peaks: a non-peak's
//   fractional bin and score are never read.
// - The frame's max score by shuffles (a NaN max leaves no candidate, as
//   torch's amax), the cutoff, the candidates compacted in bin order.
// - Each candidate's place in the stable descending sort is counted:
//   rank = #(greater score) + #(equal score at a lower bin); ranks < 32 are
//   the top 32, one a lane.
// - Ghosts: lane i tests its entry against the 31 others by shuffles;
//   the dedup is 32 warp-wide `__any_sync` steps in score order; `__popc`
//   gives the kept entries' slots.
// Every rounding is the plain version's: products, sums and differences
// are `__fmul_rn` / `__fadd_rn` / `__fsub_rn` (nvcc would contract them),
// the divisions IEEE (`__fdiv_rn`), logf the CUDA math library's as torch
// calls it, log2 the product of logf by float32(1/ln 2) and the division by
// 15 a product by float32(1/15) (XLA's forms, which the plain version
// spells), torch.round `rintf` (half to even).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "comb.cuh"

namespace {

constexpr int WARPS = 8;                 // frames a block
constexpr int TOP_K = 32;
constexpr int MAX_NOTES = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2_E = 0x1.715476p+0f;  // float32(1 / float32(ln 2))
constexpr float RECIP_15 = 0x1.111112p-4f;  // float32(1) / float32(15)
constexpr float TINY = 1e-30f;

// Shared memory a warp, in floats: magnitudes [kc + 1], pm, peaks' bins,
// scores and fractional bins [kc] each (the candidates' scores and
// fractional bins reuse the magnitudes and pm), the top 32's scores and
// fractional bins.
__host__ __device__ constexpr int warp_floats(int kc) {
  return ((5 * (kc + 1) + 2 * TOP_K) + 3) & ~3;
}

__global__ void __launch_bounds__(WARPS * 32)
extract_kernel(const float* __restrict__ mags, long long mag_stride,
               const float* __restrict__ floors, long long floor_stride,
               float* __restrict__ out_freq, float* __restrict__ out_score,
               bool* __restrict__ out_valid, int n, int kc, int half,
               int min_bin, int max_bin, float bin_width, float min_freq,
               float max_freq) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long f = (long long)blockIdx.x * WARPS + warp;
  if (f >= n) return;
  float* m = smem + warp * warp_floats(kc);   // [kc + 1]
  float* pm = m + (kc + 1);                   // [kc]
  int* pk = reinterpret_cast<int*>(pm + (kc + 1));  // peaks' bins
  float* ps = reinterpret_cast<float*>(pk + (kc + 1));  // peaks' scores
  float* pf = ps + (kc + 1);                  // peaks' fractional bins
  float* ts = pf + (kc + 1);                  // top 32: scores
  float* tf = ts + TOP_K;                     //         fractional bins
  float* cs = m;                              // candidates: scores
  float* cf = pm;                             //             fractional bins
  const float* mrow = mags + f * mag_stride;
  const float* frow = floors + f * floor_stride;
  const unsigned lower = (1u << lane) - 1u;

  for (int i = lane; i <= kc; i += 32) m[i] = __ldg(mrow + i);
  __syncwarp();

  // Peaks (stft.rs:461-469), compacted in bin order.
  int npk = 0;
  for (int base = 0; base < kc; base += 32) {
    const int k = base + lane;
    bool peak = false;
    if (k < kc) {
      const float mc = m[k];
      peak = k >= min_bin + 1 && k < max_bin && mc > __ldg(frow + k) &&
             mc >= m[k > 0 ? k - 1 : 0] && mc >= m[k + 1];
      pm[k] = peak ? mc : 0.f;
    }
    const unsigned ballot = __ballot_sync(FULL, peak);
    if (peak) pk[npk + __popc(ballot & lower)] = k;
    npk += __popc(ballot);
  }
  __syncwarp();

  // A lane a peak: interpolation (stft.rs:484-497), comb, gates and score
  // (:499-545); the frame's max score, NaN kept.
  float mx = 0.f;
  bool nan_seen = false;
  for (int p = lane; p < npk; p += 32) {
    const int k = pk[p];
    const float yl = logf(m[k - 1]), yc = logf(m[k]), yr = logf(m[k + 1]);
    const float denom = __fadd_rn(__fsub_rn(yl, __fmul_rn(2.f, yc)), yr);
    const float q = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(yl, yr)), denom);
    const float clamped = isnan(q) ? q : fminf(fmaxf(q, -1.f), 1.f);
    float delta = fabsf(denom) < TINY ? 0.f : clamped;
    const bool degenerate = !isfinite(delta);
    if (degenerate) delta = 0.f;
    const float fr = __fadd_rn(static_cast<float>(k), delta);
    const float fund = m[k];
    const float nf = __ldg(frow + k);
    float s = 0.f;
    if (!(fund < __fmul_rn(nf, 5.f)) && !degenerate) {
      const CombOut c = comb_candidate(pm, fr, fund, k, half, max_bin);
      if (!(c.longest_run < 3 && fund < __fmul_rn(15.f, nf))) {
        const float log_score =
            __fmul_rn(logf(__fadd_rn(0.5f, c.score)), LOG2_E);
        const float struct_mult = __fmul_rn(
            __fadd_rn(__fadd_rn(1.f, static_cast<float>(c.longest_run)),
                      __fmul_rn(static_cast<float>(c.total_harms), 0.5f)),
            RECIP_15);
        s = __fmul_rn(log_score, struct_mult);
      }
    }
    ps[p] = s;
    pf[p] = fr;
    if (isnan(s)) {
      nan_seen = true;
    } else {
      mx = fmaxf(mx, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  }
  const float max_score = __any_sync(FULL, nan_seen) ? __int_as_float(
      0x7fffffff) : mx;
  const float cutoff = __fmul_rn(max_score, 0.5f);
  const bool any = max_score > 0.f;
  __syncwarp();

  // Candidates (stft.rs:547-562), compacted in bin order.
  int nc = 0;
  for (int base = 0; base < npk; base += 32) {
    const int p = base + lane;
    float s = 0.f, fr = 0.f;
    bool cand = false;
    if (p < npk) {
      s = ps[p];
      fr = pf[p];
      cand = any && s >= cutoff;
    }
    const unsigned ballot = __ballot_sync(FULL, cand);
    if (cand) {
      const int c = nc + __popc(ballot & lower);
      cs[c] = s;
      cf[c] = fr;
    }
    nc += __popc(ballot);
  }
  __syncwarp();

  // Top 32 by score, ties to the lower bin: each candidate's rank in the
  // stable descending sort.
  for (int c = lane; c < nc; c += 32) {
    const float s = cs[c];
    int rank = 0;
    for (int j = 0; j < nc; ++j) {
      const float sj = cs[j];
      rank += sj > s || (sj == s && j < c);
    }
    if (rank < TOP_K) {
      ts[rank] = s;
      tf[rank] = cf[c];
    }
  }
  __syncwarp();

  const int ntop = min(nc, TOP_K);
  const bool valid = lane < ntop;
  const float score = valid ? ts[lane] : 0.f;
  const float cfrac = valid ? tf[lane] : 0.f;
  const float cfreq = __fmul_rn(cfrac, bin_width);

  // Harmonic ghosts (stft.rs:564-589).
  bool ghost = false;
  for (int j = 0; j < ntop; ++j) {
    const float fj = __shfl_sync(FULL, cfreq, j);
    const float sj = __shfl_sync(FULL, score, j);
    if (valid && j != lane) {
      const float ratio = __fdiv_rn(cfreq, fmaxf(fj, TINY));
      const float nearest = rintf(ratio);
      if (nearest >= 2.f && nearest <= 5.f &&
          fabsf(__fsub_rn(__fdiv_rn(ratio, fmaxf(nearest, TINY)), 1.f)) <
              0.03f &&
          score < __fmul_rn(sj, 1.05f)) {
        ghost = true;
      }
    }
  }
  const bool cvalid = valid && !ghost;

  // Greedy dedup by 2-bin separation in score order (stft.rs:594-605).
  bool kept = false;
  for (int i = 0; i < ntop; ++i) {
    const float fi = __shfl_sync(FULL, cfrac, i);
    const bool conflict =
        __any_sync(FULL, kept && fabsf(__fsub_rn(cfrac, fi)) < 2.f);
    if (lane == i) kept = cvalid && !conflict;
  }

  // The first MAX_NOTES kept, in score order (stft.rs:606-619), and the
  // frequency range.
  const unsigned kept_mask = __ballot_sync(FULL, kept);
  const int slot = __popc(kept_mask & lower);
  const int nkept = min(__popc(kept_mask), MAX_NOTES);
  const long long o = f * MAX_NOTES;
  if (kept && slot < MAX_NOTES) {
    out_freq[o + slot] = cfreq;
    out_score[o + slot] = score;
    out_valid[o + slot] = cfreq >= min_freq && cfreq <= max_freq;
  }
  if (lane >= nkept && lane < MAX_NOTES) {
    out_freq[o + lane] = 0.f;
    out_score[o + lane] = 0.f;
    out_valid[o + lane] = false;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  mags rows
// hold >= kc + 1 magnitudes, floor rows >= kc floors, each with unit
// stride; requires 0 < max_bin <= kc < half.
int aat_extract(const float* mags, long long mag_stride, const float* floors,
                long long floor_stride, float* freq, float* score,
                bool* valid, int n, int kc, int half, int min_bin,
                int max_bin, float bin_width, float min_freq, float max_freq,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (max_bin <= 0 || max_bin > kc || kc >= half) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(WARPS) * warp_floats(kc) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  extract_kernel<<<blocks, WARPS * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      mags, mag_stride, floors, floor_stride, freq, score, valid, n, kc,
      half, min_bin, max_bin, bin_width, min_freq, max_freq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
