// K5: the variance-aware per-bin noise-floor recurrence over S streams (ref
// src/audio_io/stft.rs:326-367).  Replaces the `lax.scan` of
// audio_analyzer_rs_tpu/ops/noisefloor.py `noise_floor_scan` (:98 full
// width, :107 banded; the step is `_step`, :42-64), which XLA compiles to
// one device loop; it has no Pallas twin.  Bitwise equal to
// `noise_floor_scan_plain` (ops/noisefloor.py), tail included.
//
// What bounds it on an H100: bytes wherever S is large.  At the full step's
// call (S = 128 streams x N = 933 frames, band B = 426 of 1,025-float rows)
// it reads 203.5 MB of magnitudes and writes 203.5 MB of effective floors,
// ~0.123 ms at 3.35 TB/s; at the segmented step (S = 128 x N = 64 x B =
// 464) 15.2 MB each way, ~9.5 us.  The sequential analyzer (S = 1, N <=
// 4,096) is bound by each bin's per-frame chain instead.  Every bin is its
// own recurrence, so the design is a lane a (stream, bin):
//  - Warps of 32 bins, ceil(B / 32) a stream, flattened over the streams
//    and packed WARPS to a block: B = 426, 464 and 1,025 leave 22, 16 and
//    31 lanes of a stream idle.
//  - The four state values stay in registers for all N frames; the loads
//    of the next AHEAD frames are issued before this AHEAD's recurrence
//    (a second register group), AHEAD chosen from the warps an SM:
//    deep where few warps must keep the memory busy (the sequential
//    analyzer), shallow where many do (deep_ahead).  A frame's global
//    floor is one lane's load, shuffled to the warp.  Whole groups test
//    no frame against N, and the loads and stores walk pointers: at the
//    segmented step ~3.6 warps share a scheduler, so the instructions a
//    frame (~50 from one frame's shuffle to the next) set its pace.
//  - No division for `above` (the residual m - 1.5 d rounded once decides
//    it, exactly), and vn's only where it is read (floor_step below): on
//    the steps whose magnitude is above the floor, 6-10% of a scene's.
//    The subnormal volatilities of near silence (16-23% of a scene's),
//    which would take the division's slow path, fall on the others.
//  - Lanes past B run bin B - 1's frames from bin B - 1's state, so they
//    branch as lane B - 1 does and add no divergence; they store nothing.
//  - The state above the band is written by the kernel (copied, or seeded
//    from a full-width first frame: the magnitudes' own, or a stream's
//    first frame handed in beside banded magnitudes), so the wrapper runs
//    no torch op after the launch.
//
// Rounding, as the plain version does it: XLA:CPU contracts the alpha blend
// and the floor update into fused multiply-adds (fmaf here, rounded once);
// it does not contract the volatility EMA, so that line spells out
// __fmul_rn/__fadd_rn (nvcc would otherwise contract it); every quotient
// still computed is IEEE (__fdiv_rn).  Every constant is the float32 value
// the plain version uses, or a bound derived from them, as a hex float
// (tests/test_torch_noisefloor_kernel.py reads them from this file): float
// literals, never double ones, so that no compare is promoted to double.
//
// NaN, as the plain version does it: torch.maximum, torch.minimum and
// torch.clamp keep a NaN operand, where fmaxf and fminf drop it, so the
// kernel takes its max and min through max_nan / min_nan; a comparison
// with a NaN is false on both sides.  The NaN's bits may differ from the
// plain version's; where a NaN stands is the same.  A NaN magnitude makes
// its bin's floor NaN from then on, in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int TAIL = 4;              // columns above the band a lane takes

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
// What decides `above` without its quotient (floor_step).
constexpr float RATIO_MIDPOINT = 0x1p-24f;           // 1.5 + this: a midpoint

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

// One frame of an initialized bin: the plain `_step` with
//   above = m / max(floor, 0.01),  vn = clamp(v / max(m, 0.05), 0, 1),
//   sustained = above > 1.5 && vn < 0.15,
//   alpha = m > floor ? fmaf(vn, 0.31, 0.04) : 0.02,
//   floor = sustained ? floor : fmaf(alpha, m - floor, floor),
// with no division for `above` and vn's only where it is read.  Exact for
// every float32 input (NaN, +-inf, +-0, subnormals, negative floors;
// tests/test_torch_noisefloor_kernel.py holds each case):
//  1. m > floor false (a NaN m or floor included): alpha is 0.02, and
//     above > 1.5 is false (m <= floor gives m / floor <= 1 for floor >=
//     0.01, m / 0.01 < 1 below it, a negative quotient below 0, and a NaN
//     operand a NaN quotient), so `sustained` is false; neither quotient is
//     read.  Digital silence (m = 0 over a floor decayed to the least
//     subnormal) takes this path, with its subnormal volatilities.
//  2. m > floor, so m and floor are not NaN and d = max(floor, 0.01) is
//     finite and >= 0.01, 2^E <= d < 2^(E+1).  RN(m / d) > 1.5 exactly
//     when m / d > 1.5 + 2^-24 (the midpoint above 1.5; a tie rounds to
//     the even 1.5), that is when m - 1.5 d > d 2^-24 (d 2^-24 is exact).
//     fmaf(-1.5, d, m) is m - 1.5 d rounded once, and exact wherever
//     |m - 1.5 d| <= d / 2: there m and 1.5 d are multiples of 2^(E-24)
//     and so is their difference, below 2^E in size, so within 24 bits.
//     Further out the rounded difference keeps its side of d 2^-24 (it is
//     >= d / 2 or <= -d / 2; RN is monotone); +inf - 1.5 d is +inf, and a
//     difference below -FLT_MAX rounds to -inf, both on the right side.
// The state is (floor, prev, vol); vol takes v and prev takes m.
__device__ __forceinline__ void floor_step(float m, float& floor,
                                           float& prev, float& vol) {
  const float delta = fabsf(__fsub_rn(m, prev));
  const float v = __fadd_rn(__fmul_rn(vol, VOL_MEMORY),
                            __fmul_rn(delta, VOL_NEW));
  const bool rising = m > floor;
  const float d = max_nan(floor, FLOOR_EPS);
  const bool above =
      fmaf(-NOTE_RATIO, d, m) > __fmul_rn(d, RATIO_MIDPOINT);
  float q = 0.0f;
  if (rising) q = __fdiv_rn(v, max_nan(m, MAG_EPS));
  const float vn = min_nan(max_nan(q, 0.0f), 1.0f);
  const bool sustained = rising && above && vn < NOTE_VOL_MAX;
  const float alpha =
      rising ? fmaf(vn, FAST_MINUS_BASE, BASE_ALPHA) : RELEASE;
  if (!sustained) floor = fmaf(alpha, __fsub_rn(m, floor), floor);
  vol = v;
  prev = m;
}

// The magnitudes of frames f0 .. f0 + AHEAD - 1 of this lane's bin (m_f0
// points at frame f0's; only frames below N are read when !WHOLE), and
// lane u's global floor of frame f0 + u.
template <int AHEAD, bool WHOLE>
__device__ __forceinline__ void load_group(float (&m)[AHEAD], float& g,
                                           const float* __restrict__ m_f0,
                                           long long ms_n,
                                           const float* __restrict__ g_in,
                                           int f0, int N, int lane) {
#pragma unroll
  for (int u = 0; u < AHEAD; ++u)
    m[u] = WHOLE || f0 + u < N ? m_f0[u * ms_n] : 0.0f;
  g = lane < AHEAD && f0 + lane < N ? g_in[f0 + lane] : 0.0f;
}

// Frames f0 .. f0 + AHEAD - 1 (those below N when !WHOLE): the recurrence
// and the effective floors (e_f0 points at frame f0's).  `fresh`: frame f0
// is a fresh stream's first, which takes the first-frame rule (its vol
// stays).  `fresh` and `f0 + u < N` are the same on every lane.
template <int AHEAD, bool WHOLE>
__device__ __forceinline__ void run_group(const float (&m)[AHEAD],
                                          float g_lane, int f0, int N,
                                          bool fresh, bool live,
                                          float& floor, float& prev,
                                          float& vol, float* e_f0, int B) {
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    const float g = __shfl_sync(FULL, g_lane, u);
    if (WHOLE || f0 + u < N) {
      if (u == 0 && fresh) {
        floor = max_nan(m[0], __fmul_rn(g, INIT_SCALE));
        prev = m[0];
      } else {
        floor_step(m[u], floor, prev, vol);
      }
      if (live) e_f0[u * B] = min_nan(floor, __fmul_rn(g, EFFECTIVE_SCALE));
    }
  }
}

template <int AHEAD>
__global__ void __launch_bounds__(WARPS * 32)
noise_floor_kernel(const float* __restrict__ mags, long long ms_s,
                   long long ms_n, const float* __restrict__ gf,
                   const float* __restrict__ floor0,
                   const float* __restrict__ prev0,
                   const float* __restrict__ vol0,
                   const uint8_t* __restrict__ init0,
                   float* __restrict__ eff, float* __restrict__ floor1,
                   float* __restrict__ prev1, float* __restrict__ vol1,
                   uint8_t* __restrict__ init1,
                   const float* __restrict__ first_in, int S, int N, int B,
                   int H, int width, int W) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= S * W) return;           // whole warps
  const int s = gw / W, w = gw - s * W;
  const int b = w * 32 + lane;
  const bool live = b < B;
  const int bin = min(b, B - 1);     // lanes past B mirror bin B - 1
  const float* m_row = mags + s * ms_s;
  const float* m_col = m_row + bin;
  const float* g_in = gf + (long long)s * N;
  float* e_col = eff + (long long)s * N * B + b;
  const long long st = (long long)s * H;

  // Every load that waits on no other goes out first: the stream's flag,
  // the band's state and the first AHEAD frames.
  const bool fresh = init0[s] == 0;
  float floor = floor0[st + bin], prev = prev0[st + bin],
        vol = vol0[st + bin];
  float cur[AHEAD], nxt[AHEAD], g_cur, g_nxt;
  if (AHEAD <= N)
    load_group<AHEAD, true>(cur, g_cur, m_col, ms_n, g_in, 0, N, lane);
  else
    load_group<AHEAD, false>(cur, g_cur, m_col, ms_n, g_in, 0, N, lane);

  // The state above the band, spread over the stream's warps: frozen, or
  // with a full-width first frame (the magnitudes' frame 0, or first_in's
  // row: `noisefloor.with_tail`) on a fresh stream seeded by the
  // first-frame rule; its volatility stays.
  // TAIL columns a lane at once, so that their loads go out together.
  const bool full = width >= H || first_in != nullptr;
  const float* first_row = first_in != nullptr ? first_in + st : m_row;
  const bool seed = fresh && full;
  const int lanes = W * 32;
  for (int c0 = B + w * 32 + lane; c0 < H; c0 += TAIL * lanes) {
    float f_in[TAIL], p_in[TAIL], v_in[TAIL], first[TAIL];
#pragma unroll
    for (int k = 0; k < TAIL; ++k) {
      const int c = c0 + k * lanes;
      if (c < H) {
        f_in[k] = floor0[st + c];
        p_in[k] = prev0[st + c];
        v_in[k] = vol0[st + c];
        first[k] = full ? first_row[c] : 0.0f;
      }
    }
    const float g0 = g_in[0];
#pragma unroll
    for (int k = 0; k < TAIL; ++k) {
      const int c = c0 + k * lanes;
      if (c < H) {
        floor1[st + c] =
            seed ? max_nan(first[k], __fmul_rn(g0, INIT_SCALE)) : f_in[k];
        prev1[st + c] = seed ? first[k] : p_in[k];
        vol1[st + c] = v_in[k];
      }
    }
  }
  if (w == 0 && lane == 0) init1[s] = 1;   // the wrapper launches for N > 0

  // The band: the next AHEAD frames' loads go out before this AHEAD's
  // recurrence.  All lanes take part in the global floors' shuffles.
  // Whole groups (all AHEAD frames below N) test no frame against N.
  const long long group_stride = AHEAD * ms_n;
  const float* m_next = m_col + group_stride;
  float* e_f0 = e_col;
  for (int f0 = 0; f0 < N; f0 += AHEAD) {
    const int f1 = f0 + AHEAD;
    if (f1 + AHEAD <= N)
      load_group<AHEAD, true>(nxt, g_nxt, m_next, ms_n, g_in, f1, N, lane);
    else if (f1 < N)
      load_group<AHEAD, false>(nxt, g_nxt, m_next, ms_n, g_in, f1, N,
                               lane);
    if (f1 <= N)
      run_group<AHEAD, true>(cur, g_cur, f0, N, fresh && f0 == 0, live,
                             floor, prev, vol, e_f0, B);
    else
      run_group<AHEAD, false>(cur, g_cur, f0, N, fresh && f0 == 0, live,
                              floor, prev, vol, e_f0, B);
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) cur[u] = nxt[u];
    g_cur = g_nxt;
    m_next += group_stride;
    e_f0 += AHEAD * B;
  }
  if (live) {
    floor1[st + b] = floor;
    prev1[st + b] = prev;
    vol1[st + b] = vol;
  }
}

// Frames loaded ahead: 32 where few warps share an SM (each must keep many
// loads in flight to cover the memory's latency), 8 where many do (and for
// a few frames).  Measured on an H100 80GB HBM3 at 700 W
// (port_tools/kernel_turns.py, AHEAD fixed by its ahead8 / ahead32
// probes): at S = 1 x N = 4,096, 126 cycles a frame at 32 against 156 at
// 8; at the full step's call 0.216 ms at 8 against 0.277 at 32.
bool deep_ahead(long long warps, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return N > 8 && warps <= 4LL * sms;
}

int launch_scan(const float* mags, long long ms_s, long long ms_n,
                const float* gf, const float* floor0, const float* prev0,
                const float* vol0, const uint8_t* init0, float* eff,
                float* floor1, float* prev1, float* vol1, uint8_t* init1,
                const float* first, int S, int N, int B, int H, int width,
                void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (N < 1 || B < 1 || H < B || width < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (B + 31) / 32;
  const long long warps = (long long)S * W;
  const dim3 grid(static_cast<unsigned>((warps + WARPS - 1) / WARPS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_LAUNCH(A)                                                        \
  noise_floor_kernel<A><<<grid, WARPS * 32, 0, st>>>(                       \
      mags, ms_s, ms_n, gf, floor0, prev0, vol0, init0, eff, floor1, prev1, \
      vol1, init1, first, S, N, B, H, width, W)
  if (deep_ahead(warps, N))
    K5_LAUNCH(32);
  else
    K5_LAUNCH(8);
#undef K5_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  mags [S, N,
// width] (width >= B) with unit stride along the bins and strides ms_s,
// ms_n (in floats); gf [S, N] and eff [S, N, B] contiguous; the state
// leaves in and out [S, H] (H >= B) contiguous, init in and out [S].  The
// kernel scans columns [0, B) and writes columns [B, H) of the state out
// (the plain version's `with_tail`).  N >= 1.
int aat_noise_floor_scan(const float* mags, long long ms_s, long long ms_n,
                         const float* gf, const float* floor0,
                         const float* prev0, const float* vol0,
                         const uint8_t* init0, float* eff, float* floor1,
                         float* prev1, float* vol1, uint8_t* init1, int S,
                         int N, int B, int H, int width, void* stream) {
  return launch_scan(mags, ms_s, ms_n, gf, floor0, prev0, vol0, init0, eff,
                     floor1, prev1, vol1, init1, nullptr, S, N, B, H, width,
                     stream);
}

// aat_noise_floor_scan with each stream's first frame at full width,
// first [S, H] contiguous, beside magnitudes of any width >= B: a fresh
// stream's state above the band is seeded from it, as from full-width
// magnitudes' frame 0.
int aat_noise_floor_scan_first(const float* mags, long long ms_s,
                               long long ms_n, const float* gf,
                               const float* floor0, const float* prev0,
                               const float* vol0, const uint8_t* init0,
                               float* eff, float* floor1, float* prev1,
                               float* vol1, uint8_t* init1,
                               const float* first, int S, int N, int B,
                               int H, int width, void* stream) {
  if (first == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_scan(mags, ms_s, ms_n, gf, floor0, prev0, vol0, init0, eff,
                     floor1, prev1, vol1, init1, first, S, N, B, H, width,
                     stream);
}

}  // extern "C"
