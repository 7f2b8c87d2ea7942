// K11: the windowed real-FFT magnitude, |rfft(frames x window)| for the
// first `band` bins of frames of W = 64 .. 4,096 samples (a power of two).
//
// Replaces no TPU kernel.  The JAX package computes these magnitudes with
// `jnp.abs(jnp.fft.rfft(...))` (audio_analyzer_rs_tpu/ops/fft.py:77), left
// to XLA; the port computed them with cuFFT (`torch.fft.rfft(frames *
// hann).abs()`).  K11 was added for two reasons: cuFFT's 2,048-point bits
// change with the number of frames in the call, so a stream's results
// depended on the batch, the mesh and the pool; and the window product,
// the complex spectrum and the magnitude were three passes over device
// memory, 5.1 of the full step's 11.75 card ms.
//
// What bounds it on an H100: bytes.  The full step's pitch call reads
// 128 x 479,232 samples (245.4 MB; its 933 frames a stream overlap 4x and
// each sample is read once at best) and writes 119,424 x 1,025 magnitudes
// (489.6 MB): 0.219 ms at 3.35 TB/s.  Its onset call (958,080 frames of
// 256 into 129 bins) writes 494.4 MB over the same input: 0.221 ms.  A
// real FFT done as a half-length complex FFT is ~2.5 W log2 W flops a
// frame: 7.3 and 5.3 GFLOP, 0.11 and 0.08 ms at 67 TFLOP/s.
//
// One fixed order a frame (ops/hopper_rfft.py's docstring states it, and
// `rfft_mag_fixed_np` transcribes it in numpy, bit for bit):
//   1. z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1];
//   2. the M = W/2-point complex FFT by log2 M radix-2 Stockham stages,
//      each butterfly a + b T, a - b T with b T = (br Tr - bi Ti,
//      br Ti + bi Tr), T from the wrapper's float32 table;
//   3. the real spectrum's bins from Z[k] and Z[M - k], doubled;
//   4. the magnitude sqrt(re^2 + im^2) / 2, scaled by a power of two
//      where re and im would under- or overflow when squared.
// Every product and sum is spelled __fmul_rn / __fadd_rn / __fsub_rn (no
// FMA contraction; _build.py does not pass --fmad=false), the square root
// is __fsqrt_rn, denormals are kept (no fast math), and no atomics: the
// operations of a frame do not depend on N, the batch, the frame's place
// or the grid, so its bits are the same in any call.
//
// Design (a first, simple one; wgmma, TMA and persistence across calls are
// for later):
// - a thread holds 32 complex values in registers; a frame takes M / 32
//   threads (1 at W = 64, 4 at 256, 32 at 2,048, 64 at 4,096), a block of
//   256 threads takes 256 / (M / 32) frames (8 at 2,048, 64 at 256) and
//   walks over tiles of that many frames (grid: the blocks that fit on the
//   card at once).  Where those tiles would not give every SM a block (a
//   live slot's 16 onset frames, a pool wave's 528), a thread holds 16
//   values and a tile is half as many frames: each tile's latency, which
//   is all such a call costs, falls (measured on an H100, PERF.md: a pool
//   wave 14.6 -> 10.0 us; at the full step's calls the 16-value form was
//   0.96-1.07 against 0.79 ms);
// - the stages run five (four) at a time in registers.  A pass starting at stage
//   s0 with R = 2^r values a group gives group j (in [0, M/R)) the values
//   z[j + q M/R]: those close under r consecutive stages, and after them
//   value q sits at (j >> s0) Ns0 R + (j mod Ns0) + Ns0 bitrev_r(q), Ns0 =
//   2^s0.  Between passes the frame goes through shared memory (padded by
//   one float2 every 32, so the passes' strided writes hit distinct
//   banks), and each stage's factors lie in a row of the table of their
//   own, so the lanes of a pass read consecutive factors;
// - the frames are read in place through the unfold view's strides, the
//   window applied on load (neither frames x window nor the complex
//   spectrum reaches device memory); the block's magnitudes, consecutive
//   rows of the output, are written as one contiguous run.
//
// Frame m lives at frames + (m / per_row) * stride_outer
//                        + (m % per_row) * stride_inner.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x >> 1) : 0;
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// a, b <- a + b T, a - b T
__device__ __forceinline__ void butterfly(float& ar, float& ai, float& br,
                                          float& bi, float2 w) {
  const float tr = __fsub_rn(__fmul_rn(br, w.x), __fmul_rn(bi, w.y));
  const float ti = __fadd_rn(__fmul_rn(br, w.y), __fmul_rn(bi, w.x));
  br = __fsub_rn(ar, tr);
  bi = __fsub_rn(ai, ti);
  ar = __fadd_rn(ar, tr);
  ai = __fadd_rn(ai, ti);
}

// Stages S .. RL - 1 of a pass starting at stage s0 (Ns0 = NS0) on one
// group's R values, registers [gbase, gbase + R): stage S pairs registers
// HALF = R / 2^(S+1) apart, and the 2^S blocks of such pairs take the
// factor of k = c + Ns0 bitrev_S(blk), c = j mod Ns0.
template <int RR, int R, int NS0, int S, int RL>
__device__ __forceinline__ void stages(float (&vr)[RR], float (&vi)[RR],
                                       int gbase, int c,
                                       const float2* stage_tw) {
  if constexpr (S < RL) {
    constexpr int HALF = R >> (S + 1);
    constexpr int NS = NS0 << S;
#pragma unroll
    for (int blk = 0; blk < (1 << S); ++blk) {
      const float2 w = stage_tw[NS - 1 + c + NS0 * bitrev(blk, S)];
#pragma unroll
      for (int q0 = 0; q0 < HALF; ++q0) {
        const int q = gbase + blk * 2 * HALF + q0;
        butterfly(vr[q], vi[q], vr[q + HALF], vi[q + HALF], w);
      }
    }
    stages<RR, R, NS0, S + 1, RL>(vr, vi, gbase, c, stage_tw);
  }
}

// The passes from stage S0 on, RR values a thread: RL = log2(RR) stages
// (fewer in the last pass) on each of the thread's RR / R groups (group
// g: registers [g R, g R + R), j = t + g TPF), the result to the frame's
// buffer fb, then the next pass.
template <int RR, int L, int S0>
__device__ __forceinline__ void fft_passes(float (&vr)[RR], float (&vi)[RR],
                                           float2* fb, int t,
                                           const float2* stage_tw) {
  constexpr int M = 1 << L;
  constexpr int TPF = M / RR;
  constexpr int RL = (L - S0 < log2i(RR)) ? L - S0 : log2i(RR);
  constexpr int R = 1 << RL;
  constexpr int G = RR / R;
  constexpr int NS0 = 1 << S0;
  if constexpr (S0 > 0) {
    __syncthreads();             // the last pass's writes are visible
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = t + g * TPF;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 v = fb[pad(j + q * (M / R))];
        vr[g * R + q] = v.x;
        vi[g * R + q] = v.y;
      }
    }
    __syncthreads();             // every read is done before any write
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    stages<RR, R, NS0, 0, RL>(vr, vi, g * R, (t + g * TPF) & (NS0 - 1),
                              stage_tw);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = t + g * TPF;
    const int base = ((j >> S0) << (S0 + RL)) + (j & (NS0 - 1));
#pragma unroll
    for (int q = 0; q < R; ++q) {
      fb[pad(base + (bitrev(q, RL) << S0))] =
          make_float2(vr[g * R + q], vi[g * R + q]);
    }
  }
  if constexpr (S0 + RL < L) {
    fft_passes<RR, L, S0 + RL>(vr, vi, fb, t, stage_tw);
  }
}

// Bin k's magnitude from zk = Z[k mod M], zm = Z[(M - k) mod M] and
// w = e^{-2 pi i k / W}.
__device__ __forceinline__ float magnitude(float2 zk, float2 zm, float2 w) {
  const float er = __fadd_rn(zk.x, zm.x);
  const float ei = __fsub_rn(zk.y, zm.y);
  const float o_r = __fadd_rn(zk.y, zm.y);
  const float o_i = __fsub_rn(zm.x, zk.x);
  const float xr =
      __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, o_r), __fmul_rn(w.y, o_i)));
  const float xi =
      __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, o_i), __fmul_rn(w.y, o_r)));
  const float big = fmaxf(fabsf(xr), fabsf(xi));
  float up = 1.0f, back = 0.5f;
  if (big < 0x1p-60f) {
    up = 0x1p100f;
    back = 0x1p-101f;
  } else if (big > 0x1p60f) {
    up = 0x1p-100f;
    back = 0x1p99f;
  }
  const float sr = __fmul_rn(xr, up);
  const float si = __fmul_rn(xi, up);
  return __fmul_rn(
      __fsqrt_rn(__fadd_rn(__fmul_rn(sr, sr), __fmul_rn(si, si))), back);
}

template <int L, int RR>
constexpr int smem_bytes() {
  constexpr int M = 1 << L;
  constexpr int FPB = THREADS / (M / RR);
  // frame buffers, stage factors (M), post factors (M + 1), window (2M)
  return (FPB * (M + (M >> 5)) + 2 * M + 1) * 8 + 2 * M * 4;
}

// RR = 32 values a thread at 2 blocks an SM (<= 128 registers), or 16 at
// 4 (<= 64).
template <int L, int RR>
__global__ void __launch_bounds__(THREADS, 64 / RR)
rfft_mag_kernel(const float* __restrict__ x, long long stride_outer,
                long long stride_inner, int per_row,
                const float* __restrict__ window,
                const float2* __restrict__ table, float* __restrict__ out,
                int n, int band, int vec2) {
  constexpr int M = 1 << L;
  constexpr int TPF = M / RR;
  constexpr int FPB = THREADS / TPF;
  constexpr int MP = M + (M >> 5);
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* stage_tw = buf + FPB * MP;
  float2* post_tw = stage_tw + M;
  float* win = reinterpret_cast<float*>(post_tw + M + 1);
  for (int i = threadIdx.x; i < 2 * M + 1; i += THREADS) {
    stage_tw[i] = table[i];
  }
  for (int i = threadIdx.x; i < 2 * M; i += THREADS) win[i] = window[i];
  __syncthreads();
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int f = threadIdx.x / TPF;
  const int t = threadIdx.x % TPF;
  float2* fb = buf + f * MP;
  const int tiles = (n + FPB - 1) / FPB;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int frame = tile * FPB + f;
    float vr[RR], vi[RR];
    if (frame < n) {
      const float* src = x + (long long)(frame / per_row) * stride_outer +
                         (long long)(frame % per_row) * stride_inner;
      if (vec2) {
#pragma unroll
        for (int q = 0; q < RR; ++q) {
          const int m = t + q * TPF;
          const float2 v = *reinterpret_cast<const float2*>(src + 2 * m);
          const float2 u = win2[m];
          vr[q] = __fmul_rn(v.x, u.x);
          vi[q] = __fmul_rn(v.y, u.y);
        }
      } else {
#pragma unroll
        for (int q = 0; q < RR; ++q) {
          const int m = t + q * TPF;
          const float2 u = win2[m];
          vr[q] = __fmul_rn(src[2 * m], u.x);
          vi[q] = __fmul_rn(src[2 * m + 1], u.y);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < RR; ++q) vr[q] = vi[q] = 0.0f;
    }
    fft_passes<RR, L, 0>(vr, vi, fb, t, stage_tw);
    __syncthreads();
    // The tile's rows of the output are one contiguous run.
    const int rows = min(FPB, n - tile * FPB);
    const int count = rows * band;
    float* dst = out + (long long)tile * FPB * band;
    int ff = threadIdx.x / band;
    int k = threadIdx.x - ff * band;
    for (int idx = threadIdx.x; idx < count; idx += THREADS) {
      const float2* z = buf + ff * MP;
      dst[idx] = magnitude(z[pad(k & (M - 1))], z[pad((M - k) & (M - 1))],
                           post_tw[k]);
      k += THREADS;
      while (k >= band) {
        k -= band;
        ++ff;
      }
    }
    __syncthreads();             // the buffers are read before the next tile
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <int L, int RR>
cudaError_t launch_rr(const float* x, long long stride_outer,
                      long long stride_inner, int per_row,
                      const float* window, const float* table, float* out,
                      int n, int band, int vec2, int sms,
                      cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<L, RR>();
  static int blocks_per_sm = -1;
  if (blocks_per_sm < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        rfft_mag_kernel<L, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rfft_mag_kernel<L, RR>, THREADS, SMEM);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = occ;
  }
  constexpr int FPB = THREADS / ((1 << L) / RR);
  const int tiles = (n + FPB - 1) / FPB;
  const int grid = tiles < blocks_per_sm * sms ? tiles : blocks_per_sm * sms;
  rfft_mag_kernel<L, RR><<<grid, THREADS, SMEM, stream>>>(
      x, stride_outer, stride_inner, per_row, window,
      reinterpret_cast<const float2*>(table), out, n, band, vec2);
  return cudaGetLastError();
}

// 32 values a thread where the 32-value tiles give every SM a block, else
// 16: half the frames a tile and half the work a thread, so the tile's
// latency, all that a live slot's or a pool wave's few tiles cost, falls.
// Both forms run the same operations on a frame.
template <int L>
cudaError_t launch(const float* x, long long stride_outer,
                   long long stride_inner, int per_row, const float* window,
                   const float* table, float* out, int n, int band, int vec2,
                   cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    const cudaError_t err = static_cast<cudaError_t>(sm_count(&sms));
    if (err != cudaSuccess) return err;
  }
  constexpr int FPB32 = THREADS / ((1 << L) / 32);
  if ((n + FPB32 - 1) / FPB32 >= sms) {
    return launch_rr<L, 32>(x, stride_outer, stride_inner, per_row, window,
                            table, out, n, band, vec2, sms, stream);
  }
  return launch_rr<L, 16>(x, stride_outer, stride_inner, per_row, window,
                          table, out, n, band, vec2, sms, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  width =
// 2^log2_width in [64, 4096]; `window` [width] float32 (the wrapper passes
// ones for a rectangular window); `table` the wrapper's [2 * (width / 2) +
// 1] float2 factors; out [n, band] contiguous, 1 <= band <= width / 2 + 1;
// vec2: every frame starts on an 8-byte boundary.
int aat_rfft_mag(const float* x, long long stride_outer,
                 long long stride_inner, int per_row, const float* window,
                 const float* table, float* out, int n, int log2_width,
                 int band, int vec2, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2_width) {
    case 6: return launch<5>(x, stride_outer, stride_inner, per_row, window,
                             table, out, n, band, vec2, s);
    case 7: return launch<6>(x, stride_outer, stride_inner, per_row, window,
                             table, out, n, band, vec2, s);
    case 8: return launch<7>(x, stride_outer, stride_inner, per_row, window,
                             table, out, n, band, vec2, s);
    case 9: return launch<8>(x, stride_outer, stride_inner, per_row, window,
                             table, out, n, band, vec2, s);
    case 10: return launch<9>(x, stride_outer, stride_inner, per_row,
                              window, table, out, n, band, vec2, s);
    case 11: return launch<10>(x, stride_outer, stride_inner, per_row,
                               window, table, out, n, band, vec2, s);
    case 12: return launch<11>(x, stride_outer, stride_inner, per_row,
                               window, table, out, n, band, vec2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
