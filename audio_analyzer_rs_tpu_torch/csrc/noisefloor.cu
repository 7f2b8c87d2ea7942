// K5: the variance-aware per-bin noise-floor recurrence over S streams (ref
// src/audio_io/stft.rs:326-367).  Replaces the `lax.scan` of
// audio_analyzer_rs_tpu/ops/noisefloor.py `noise_floor_scan` (:98 full
// width, :107 banded; the step is `_step`, :42-64), which XLA compiles to
// one device loop; it has no Pallas twin.  Bitwise equal to
// `noise_floor_scan_plain` (ops/noisefloor.py).
//
// What bounds it on an H100: bytes.  At the segmented step (S = 128 streams
// x N = 64 frames x B = 464 bins) it reads 15.2 MB of magnitudes and writes
// 15.2 MB of effective floors, ~9.5 us at 3.35 TB/s; per frame and bin it
// does ~30 operations, two of them IEEE divisions.  Every bin is its own
// recurrence, so the design is a thread a (stream, bin):
//  - the four state values stay in registers for all N frames;
//  - consecutive threads are consecutive bins of one frame row, so each
//    frame's loads and stores are coalesced;
//  - the next AHEAD frames' magnitudes and global floors are loaded while
//    this AHEAD's recurrence runs (they do not depend on it), so the chain
//    does not wait on device memory;
//  - the effective floor is stored as each frame finishes.
// The sequential analyzer (S = 1, N <= 4,096) is bound by the per-frame
// chain instead: two divisions, two fmaf and a few selects a frame.
//
// Rounding, as the plain version does it: XLA:CPU contracts the alpha blend
// and the floor update into fused multiply-adds (fmaf here, rounded once);
// it does not contract the volatility EMA, so that line spells out
// __fmul_rn/__fadd_rn (nvcc would otherwise contract it); the two divisions
// are IEEE (__fdiv_rn, with a zero numerator kept off its slow path:
// `div_guarded`).  Every constant is the float32 value the plain
// version uses, as a hex float (tests/test_torch_noisefloor_kernel.py reads
// them from this file): float literals, never double ones, so that no
// compare is promoted to double.
//
// NaN, as the plain version does it: torch.maximum, torch.minimum and
// torch.clamp keep a NaN operand, where fmaxf and fminf drop it, so the
// kernel takes its max and min through max_nan / min_nan; a comparison
// with a NaN is false on both sides; and div_guarded divides whenever the
// divisor is NaN (0 / NaN is NaN).  The NaN's bits may differ from the
// plain version's; where a NaN stands is the same.  A NaN magnitude makes
// its bin's floor NaN from then on, in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;           // bins a block
constexpr int AHEAD = 8;             // frames loaded ahead of the recurrence

// The float32 constants of ops/noisefloor.py.
constexpr float VOL_MEMORY = 0x1.8p-1f;              // 0.75
constexpr float VOL_NEW = 0x1p-2f;                   // 1 - 0.75
constexpr float FLOOR_EPS = 0x1.47ae14p-7f;          // 0.01
constexpr float MAG_EPS = 0x1.99999ap-5f;            // 0.05
constexpr float NOTE_RATIO = 0x1.8p+0f;              // 1.5
constexpr float NOTE_VOL_MAX = 0x1.333334p-3f;       // 0.15
constexpr float BASE_ALPHA = 0x1.47ae14p-5f;         // 0.04
constexpr float FAST_MINUS_BASE = 0x1.3d70a4p-2f;    // float32(0.35 - 0.04)
constexpr float RELEASE = 0x1.47ae14p-6f;            // 0.02
constexpr float INIT_SCALE = 0x1.4p+2f;              // 5.0
constexpr float EFFECTIVE_SCALE = 0x1.4p+1f;         // 2.5

// n / d, IEEE, for d >= 0.01 or NaN: the slow path of the division's
// check (FCHK) takes n == 0, which digital silence gives on ~40% of the
// scene's frames; 0 / d is n itself for such a d, so the division sees 1
// there instead (and 1 / NaN is the NaN that 0 / NaN is).
__device__ __forceinline__ float div_guarded(float n, float d) {
  const float q = __fdiv_rn(n == 0.0f ? 1.0f : n, d);
  return n == 0.0f && d == d ? n : q;
}

// The larger / smaller of a and b, NaN if either is NaN (torch.maximum,
// torch.minimum): PTX max.NaN / min.NaN (sm_80 and later), one instruction
// each like fmaxf / fminf; the NaN they give is the canonical one.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(BLOCK)
noise_floor_kernel(const float* __restrict__ mags, long long ms_s,
                   long long ms_n, const float* __restrict__ gf,
                   const float* __restrict__ floor0,
                   const float* __restrict__ prev0,
                   const float* __restrict__ vol0,
                   const uint8_t* __restrict__ init0,
                   float* __restrict__ eff, float* __restrict__ floor1,
                   float* __restrict__ prev1, float* __restrict__ vol1,
                   uint8_t* __restrict__ init1, int N, int B, int H) {
  const int s = blockIdx.x;
  const int b = blockIdx.y * BLOCK + threadIdx.x;
  if (b == 0) init1[s] = 1;          // the wrapper launches only for N > 0
  if (b >= B) return;
  const long long st_in = (long long)s * H + b;
  float floor = floor0[st_in], prev = prev0[st_in], vol = vol0[st_in];
  bool init = init0[s] != 0;
  const float* m_in = mags + s * ms_s + b;
  const float* g_in = gf + (long long)s * N;
  float* e_out = eff + (long long)s * N * B + b;

  float m_cur[AHEAD], g_cur[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    m_cur[u] = u < N ? m_in[u * ms_n] : 0.0f;
    g_cur[u] = u < N ? g_in[u] : 0.0f;
  }
  for (int f0 = 0; f0 < N; f0 += AHEAD) {
    float m_nxt[AHEAD], g_nxt[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int f = f0 + AHEAD + u;
      m_nxt[u] = f < N ? m_in[f * ms_n] : 0.0f;
      g_nxt[u] = f < N ? g_in[f] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (f0 + u < N) {
        const float m = m_cur[u], g = g_cur[u];
        const float delta = fabsf(__fsub_rn(m, prev));
        const float v = __fadd_rn(__fmul_rn(vol, VOL_MEMORY),
                                  __fmul_rn(delta, VOL_NEW));
        const float above = div_guarded(m, max_nan(floor, FLOOR_EPS));
        const float vn = min_nan(
            max_nan(div_guarded(v, max_nan(m, MAG_EPS)), 0.0f), 1.0f);
        const bool sustained = above > NOTE_RATIO && vn < NOTE_VOL_MAX;
        const float alpha =
            m > floor ? fmaf(vn, FAST_MINUS_BASE, BASE_ALPHA) : RELEASE;
        const float updated =
            sustained ? floor : fmaf(alpha, __fsub_rn(m, floor), floor);
        floor = init ? updated : max_nan(m, __fmul_rn(g, INIT_SCALE));
        vol = init ? v : vol;
        prev = m;
        init = true;
        e_out[(long long)(f0 + u) * B] =
            min_nan(floor, __fmul_rn(g, EFFECTIVE_SCALE));
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      m_cur[u] = m_nxt[u];
      g_cur[u] = g_nxt[u];
    }
  }
  const long long st_out = (long long)s * B + b;
  floor1[st_out] = floor;
  prev1[st_out] = prev;
  vol1[st_out] = vol;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  mags [S, N,
// >= B] with unit stride along the bins and strides ms_s, ms_n (in floats);
// gf [S, N] and eff [S, N, B] contiguous; the state leaves in [S, H]
// (H >= B) contiguous, of which the kernel reads the first B columns, the
// state leaves out [S, B] contiguous, and init [S].  N >= 1.
int aat_noise_floor_scan(const float* mags, long long ms_s, long long ms_n,
                         const float* gf, const float* floor0,
                         const float* prev0, const float* vol0,
                         const uint8_t* init0, float* eff, float* floor1,
                         float* prev1, float* vol1, uint8_t* init1, int S,
                         int N, int B, int H, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (N < 1 || B < 1 || H < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, (B + BLOCK - 1) / BLOCK);
  noise_floor_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      mags, ms_s, ms_n, gf, floor0, prev0, vol0, init0, eff, floor1, prev1,
      vol1, init1, N, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
