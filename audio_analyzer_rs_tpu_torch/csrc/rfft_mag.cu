// K11: the windowed real-FFT magnitude, |rfft(frames x window)| for the
// first `band` bins of frames of W = 64 .. 4,096 samples (a power of two),
// and optionally each outer row's first frame at full width (W/2 + 1 bins)
// beside them.
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
// What bounds it on an H100.  Bytes: the full step's pitch call reads 128 x
// 479,232 samples (245.4 MB; its 933 frames a stream overlap 4x and each
// sample is read once at best) and writes the 427 bins the extraction
// reads (204.0 MB) and each stream's first frame at full width (0.5 MB):
// 0.134 ms at 3.35 TB/s.  Its onset call (958,080 frames of 256 into 129
// bins) writes 494.4 MB over the same input: 0.221 ms.  And issue: the
// fixed order below is one float32 instruction a product or sum (no FMA),
// about 66k a banded 2,048-point frame, ~0.24 ms for the pitch call at 128
// lanes an SM a clock; chip_smoke.py phase 3 prints both floors.
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
// operations of a frame do not depend on N, the band, the batch, the
// frame's place or the grid, so its bits are the same in any call.
//
// Design:
// - a thread holds RR = 32 complex values in registers (or 16, below);
//   a frame takes TPF = M / RR threads (1 at W = 64, 4 at 256, 32 at
//   2,048, 64 at 4,096).  A group of G = max(32, TPF) threads owns FPG =
//   G / TPF frames at a time (a warp 32 frames at 64, 8 at 256, one at
//   2,048; two warps one frame at 4,096) and its own padded buffer in
//   shared memory, and walks over its frame batches (grid-stride over the
//   groups) on its own timeline: between passes it syncs with
//   `__syncwarp()` (G = 32) or a named barrier of its G threads (`bar.sync
//   id, G`).  The block's one `__syncthreads` follows the one-time load of
//   the table and the window, held once an SM: one persistent block an SM
//   (the grid the SMs, the groups a block set by the call's size);
// - the stages run five (four) at a time in registers.  A pass starting
//   at stage s0 with R = 2^r values a group of registers gives register
//   group j (in [0, M/R)) the values z[j + q M/R]: those close under r
//   consecutive stages, and after them value q sits at (j >> s0) Ns0 R +
//   (j mod Ns0) + Ns0 bitrev_r(q), Ns0 = 2^s0.  Between passes the frame
//   goes through the group's buffer (padded by one float2 every 32, so the
//   passes' strided writes hit distinct banks), and each stage's factors
//   lie in a row of the table of their own, so the lanes of a pass read
//   consecutive factors;
// - the epilogue: thread tg of a group writes elements tg + G i of its
//   batch's rows, one contiguous run of rows x band floats; its (row,
//   bin) start and its step are worked out once a launch, so the loop has
//   no division.  Once the last pass's spectrum is in the buffer the
//   registers are free: the group issues its next batch's raw loads into
//   them first, runs the epilogue from shared memory while they are in
//   flight, and applies the window after it;
// - the frames are read in place through the unfold view's strides
//   (neither frames x window nor the complex spectrum reaches device
//   memory);
// - 16 values a thread where the 32-value groups would leave SMs short
//   of warps (a live slot's 16 onset frames, a pool wave's 528): half the
//   work a thread, so the latency of a call of a few batches, which is
//   all it costs, falls; and there a group takes as few frames a batch as
//   let one wave take the call (one at those shapes), so its epilogue
//   has fewer rows;
// - in that form the table and the window go to shared memory 8 loads a
//   thread in flight, so a block of one warp waits a few load latencies
//   for them, not one a copy.
//
// Frame m lives at frames + (m / per_row) * stride_outer
//                        + (m % per_row) * stride_inner.

#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x >> 1) : 0;
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// The shape of the work at width 2^(L+1), RR values a thread.
template <int L, int RR>
struct Geo {
  static constexpr int M = 1 << L;
  static constexpr int TPF = M / RR;                 // threads a frame
  static constexpr int G = TPF > 32 ? TPF : 32;      // threads a group
  static constexpr int FPG = G / TPF;                // frames a group
  static constexpr int MP = M + (M >> 5);            // a padded frame
  // The largest block: 128 registers a thread (RR = 32) or 64 (RR = 16)
  // fill the SM's 65,536; named barriers 1 .. 15 for groups of 2+ warps.
  static constexpr int MAXT = RR == 32 ? 512 : 1024;
  static constexpr int GPB = (G > 32 && MAXT / G > 15) ? 15 : MAXT / G;
};

// Shared memory of a block of `gpb` groups: stage factors (M), post factors
// (M + 1), window (2M), then the groups' frame buffers.
template <int L, int RR>
constexpr int smem_bytes(int gpb) {
  using Q = Geo<L, RR>;
  return (2 * Q::M + 1) * 8 + 2 * Q::M * 4 + gpb * Q::FPG * Q::MP * 8;
}

// The group's threads meet: its warp, or its G / 32 warps at barrier id.
template <int G>
__device__ __forceinline__ void group_sync(int id) {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(G) : "memory");
  }
}

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
// (fewer in the last pass) on each of the thread's RR / R register groups
// (group g: registers [g R, g R + R), j = t + g TPF), the result to the
// frame's buffer fb, then the next pass.  The group of G threads syncs
// before a pass reads (the last pass's writes are visible) and before it
// writes (every read of the buffer is done: this pass's, or the last
// batch's epilogue's).
template <int RR, int L, int S0, int G>
__device__ __forceinline__ void fft_passes(float (&vr)[RR], float (&vi)[RR],
                                           float2* fb, int t,
                                           const float2* stage_tw, int bar) {
  constexpr int M = 1 << L;
  constexpr int TPF = M / RR;
  constexpr int RL = (L - S0 < log2i(RR)) ? L - S0 : log2i(RR);
  constexpr int R = 1 << RL;
  constexpr int NG = RR / R;
  constexpr int NS0 = 1 << S0;
  if constexpr (S0 > 0) {
    group_sync<G>(bar);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int j = t + g * TPF;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 v = fb[pad(j + q * (M / R))];
        vr[g * R + q] = v.x;
        vi[g * R + q] = v.y;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    stages<RR, R, NS0, 0, RL>(vr, vi, g * R, (t + g * TPF) & (NS0 - 1),
                              stage_tw);
  }
  group_sync<G>(bar);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int j = t + g * TPF;
    const int base = ((j >> S0) << (S0 + RL)) + (j & (NS0 - 1));
#pragma unroll
    for (int q = 0; q < R; ++q) {
      fb[pad(base + (bitrev(q, RL) << S0))] =
          make_float2(vr[g * R + q], vi[g * R + q]);
    }
  }
  if constexpr (S0 + RL < L) {
    fft_passes<RR, L, S0 + RL, G>(vr, vi, fb, t, stage_tw, bar);
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

// Bin k of the spectrum in frame buffer z.
template <int M>
__device__ __forceinline__ float bin_of(const float2* z, int k,
                                        const float2* post_tw) {
  return magnitude(z[pad(k & (M - 1))], z[pad((M - k) & (M - 1))],
                   post_tw[k]);
}

// n elements from global src to shared dst, UNROLL loads a thread in
// flight before their stores (a small call's block of one warp copies its
// table in a few load latencies, not one a copy).
template <typename T>
__device__ __forceinline__ void to_shared(T* dst, const T* __restrict__ src,
                                          int n) {
  constexpr int UNROLL = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += UNROLL * blockDim.x) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// (row r, bin k) of element idx of a batch's run -> that of idx + G, with
// G = qb band + rb and rb < band.
__device__ __forceinline__ void step_bin(int& r, int& k, int qb, int rb,
                                         int band) {
  k += rb;
  r += qb;
  if (k >= band) {
    k -= band;
    ++r;
  }
}

// Frame `frame`'s samples t + q TPF (q < RR) as they are, complex pairs
// (x[2m], x[2m + 1]) into (vr, vi); zeros past n.
template <int RR, int TPF>
__device__ __forceinline__ void load_raw(float (&vr)[RR], float (&vi)[RR],
                                         const float* __restrict__ x,
                                         long long stride_outer,
                                         long long stride_inner, int per_row,
                                         int frame, int n, int t, int vec2) {
  if (frame < n) {
    const float* src = x + (long long)(frame / per_row) * stride_outer +
                       (long long)(frame % per_row) * stride_inner;
    if (vec2) {
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        const float2 v =
            *reinterpret_cast<const float2*>(src + 2 * (t + q * TPF));
        vr[q] = v.x;
        vi[q] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        vr[q] = src[2 * (t + q * TPF)];
        vi[q] = src[2 * (t + q * TPF) + 1];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < RR; ++q) vr[q] = vi[q] = 0.0f;
  }
}

// RR = 32 values a thread (<= 128 registers at 512 threads) or 16 (<= 64
// at 1,024).  blockDim.x = gpb * G.  A group takes fpw <= FPG frames a
// batch (its frame slots from fpw on run zeros and write nothing).
template <int L, int RR>
__global__ void __launch_bounds__(Geo<L, RR>::MAXT, 1)
rfft_mag_kernel(const float* __restrict__ x, long long stride_outer,
                long long stride_inner, int per_row,
                const float* __restrict__ window,
                const float2* __restrict__ table, float* __restrict__ out,
                float* __restrict__ first, int n, int band, int vec2,
                int fpw) {
  using Q = Geo<L, RR>;
  constexpr int M = Q::M, TPF = Q::TPF, G = Q::G, FPG = Q::FPG, MP = Q::MP;
  if constexpr (RR == 32) fpw = FPG;   // the host's value, as a constant
  extern __shared__ float2 smem[];
  float2* stage_tw = smem;
  float2* post_tw = stage_tw + M;
  float* win = reinterpret_cast<float*>(post_tw + M + 1);
  float2* buf = reinterpret_cast<float2*>(win + 2 * M);
  if constexpr (RR == 16) {
    to_shared(stage_tw, table, 2 * M + 1);
    to_shared(win, window, 2 * M);
  } else {
    // Plain loops here: measured on an H100, nvcc schedules the frame
    // loop of this form worse behind to_shared (1-2% at the full step).
    for (int i = threadIdx.x; i < 2 * M + 1; i += blockDim.x) {
      stage_tw[i] = table[i];
    }
    for (int i = threadIdx.x; i < 2 * M; i += blockDim.x) win[i] = window[i];
  }
  __syncthreads();               // the block's only barrier
  const float2* win2 = reinterpret_cast<const float2*>(win);
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int tg = threadIdx.x % G;
  const int t = tg % TPF;
  const int slot = tg / TPF;     // the thread's frame slot, < fpw if used
  const int bar = 1 + grp;       // unused by one-warp groups
  float2* gbuf = buf + grp * (FPG * MP);
  float2* fb = gbuf + slot * MP;
  const int batches = (n + fpw - 1) / fpw;
  const int stride = gridDim.x * gpb;
  // The epilogue's (row, bin) of element tg of a batch's run, and of each
  // step of G elements: G = qb band + rb.
  const int r0 = tg / band, k0 = tg - r0 * band;
  const int qb = G / band, rb = G - qb * band;
  int batch = blockIdx.x * gpb + grp;
  float vr[RR], vi[RR];
  if (batch < batches) {
    load_raw<RR, TPF>(vr, vi, x, stride_outer, stride_inner, per_row,
                      slot < fpw ? batch * fpw + slot : n, n, t, vec2);
  }
  for (; batch < batches; batch += stride) {
#pragma unroll
    for (int q = 0; q < RR; ++q) {
      const float2 u = win2[t + q * TPF];
      vr[q] = __fmul_rn(vr[q], u.x);
      vi[q] = __fmul_rn(vi[q], u.y);
    }
    fft_passes<RR, L, 0, G>(vr, vi, fb, t, stage_tw, bar);
    group_sync<G>(bar);          // the spectra are in the group's buffer
    const int next = batch + stride;
    if (next < batches) {
      load_raw<RR, TPF>(vr, vi, x, stride_outer, stride_inner, per_row,
                        slot < fpw ? next * fpw + slot : n, n, t, vec2);
    }
    const int f0 = batch * fpw;
    const int rows = min(fpw, n - f0);
    const int count = rows * band;
    float* dst = out + (long long)f0 * band;
    int r = r0, k = k0;
    if constexpr (RR == 16) {
      // Few warps share an SM in this form's calls: unrolled, a warp's
      // bins overlap their latencies (measured on an H100: at the 32-value
      // form's calls nvcc's own unrolling was faster than 4 or 1).
#pragma unroll 4
      for (int idx = tg; idx < count; idx += G) {
        dst[idx] = bin_of<M>(gbuf + r * MP, k, post_tw);
        step_bin(r, k, qb, rb, band);
      }
    } else {
      for (int idx = tg; idx < count; idx += G) {
        dst[idx] = bin_of<M>(gbuf + r * MP, k, post_tw);
        step_bin(r, k, qb, rb, band);
      }
    }
    if (first != nullptr) {
      // The batch's frames that start an outer row, at full width.
      for (int m = (f0 + per_row - 1) / per_row * per_row; m < f0 + rows;
           m += per_row) {
        float* row = first + (long long)(m / per_row) * (M + 1);
        for (int kk = tg; kk <= M; kk += G) {
          row[kk] = bin_of<M>(gbuf + (m - f0) * MP, kk, post_tw);
        }
      }
    }
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// One persistent block an SM (as many as fit at the largest block): the
// largest blocks where the call's groups fill them, else the groups
// spread over the SMs, ceil(groups / grid) a block.
template <int L, int RR>
cudaError_t launch_rr(const float* x, long long stride_outer,
                      long long stride_inner, int per_row,
                      const float* window, const float* table, float* out,
                      float* first, int n, int band, int vec2, int sms,
                      cudaStream_t stream) {
  using Q = Geo<L, RR>;
  static int blocks_per_sm = -1;
  if (blocks_per_sm < 0) {
    constexpr int SMEM = smem_bytes<L, RR>(Q::GPB);
    cudaError_t err = cudaFuncSetAttribute(
        rfft_mag_kernel<L, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rfft_mag_kernel<L, RR>, Q::GPB * Q::G, SMEM);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = occ;
  }
  const long long slots = (long long)sms * blocks_per_sm;
  // Frames a group takes a batch: all FPG, but in the 16-value form (a
  // call too small to fill the card) as few as let one wave of groups
  // take the call, so each warp's epilogue has fewer rows.
  int fpw = Q::FPG;
  if (RR == 16) {
    fpw = 1;
    while (fpw < Q::FPG && (n + fpw - 1) / fpw > slots * Q::GPB) fpw *= 2;
  }
  const long long groups = (n + fpw - 1) / fpw;
  int grid = static_cast<int>(slots), gpb = Q::GPB;
  if (groups < slots * Q::GPB) {
    grid = static_cast<int>(groups < slots ? groups : slots);
    gpb = static_cast<int>((groups + grid - 1) / grid);
  }
  const int smem = smem_bytes<L, RR>(gpb);
  rfft_mag_kernel<L, RR><<<grid, gpb * Q::G, smem, stream>>>(
      x, stride_outer, stride_inner, per_row, window,
      reinterpret_cast<const float2*>(table), out, first, n, band, vec2,
      fpw);
  return cudaGetLastError();
}

// 32 values a thread where its groups give every SM at least 8 warps (half
// the largest block), else 16: half the work a thread, so the latency of
// the call's few batches falls (measured on an H100 with the earlier
// design's block tiles at the same threshold: a pool wave 14.6 -> 10.0 us;
// at the full step's calls the 16-value form was 0.96-1.07 against 0.79
// ms).  Both forms run the same operations on a frame.
template <int L>
cudaError_t launch(const float* x, long long stride_outer,
                   long long stride_inner, int per_row, const float* window,
                   const float* table, float* out, float* first, int n,
                   int band, int vec2, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    const cudaError_t err = static_cast<cudaError_t>(sm_count(&sms));
    if (err != cudaSuccess) return err;
  }
  using Q32 = Geo<L, 32>;
  const long long warps32 =
      (long long)((n + Q32::FPG - 1) / Q32::FPG) * (Q32::G / 32);
  if (warps32 >= 8LL * sms) {
    return launch_rr<L, 32>(x, stride_outer, stride_inner, per_row, window,
                            table, out, first, n, band, vec2, sms, stream);
  }
  return launch_rr<L, 16>(x, stride_outer, stride_inner, per_row, window,
                          table, out, first, n, band, vec2, sms, stream);
}

int dispatch(const float* x, long long stride_outer, long long stride_inner,
             int per_row, const float* window, const float* table,
             float* out, float* first, int n, int log2_width, int band,
             int vec2, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K11_WIDTH(LOG2W)                                                   \
  case LOG2W:                                                              \
    return launch<LOG2W - 1>(x, stride_outer, stride_inner, per_row,       \
                             window, table, out, first, n, band, vec2, s)
  switch (log2_width) {
    K11_WIDTH(6);
    K11_WIDTH(7);
    K11_WIDTH(8);
    K11_WIDTH(9);
    K11_WIDTH(10);
    K11_WIDTH(11);
    K11_WIDTH(12);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K11_WIDTH
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
  return dispatch(x, stride_outer, stride_inner, per_row, window, table, out,
                  nullptr, n, log2_width, band, vec2, stream);
}

// aat_rfft_mag, and each outer row's first frame (frame r * per_row) at
// full width into first [n / per_row, width / 2 + 1] contiguous: the same
// operations on a bin as `out`'s.
int aat_rfft_mag_first(const float* x, long long stride_outer,
                       long long stride_inner, int per_row,
                       const float* window, const float* table, float* out,
                       float* first, int n, int log2_width, int band,
                       int vec2, void* stream) {
  if (first == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, stride_outer, stride_inner, per_row, window, table, out,
                  first, n, log2_width, band, vec2, stream);
}

}  // extern "C"
