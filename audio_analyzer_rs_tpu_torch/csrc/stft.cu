// K1: windowed, banded rDFT magnitude — frames x Hann, times the
// interleaved cos/-sin table, then sqrt(re^2 + im^2) for the first `band`
// bins.  Replaces the Pallas kernel audio_analyzer_rs_tpu/ops/pallas_stft.py
// `_stft_kernel` (and the XLA GEMM of ops/fft.py `rfft_mag(backend="dft")`).
//
// A tiled FP32 product on the CUDA cores (FFMA, never TF32): each block
// computes a tile of BM frames x BB bins; the K loop walks the window in
// BK-sample slices staged through shared memory.  The window multiply is
// fused into the frame-tile load and the magnitude into the epilogue, so
// neither the windowed frames nor the complex spectrum ever reach device
// memory.
//
// Every output accumulates its re and im sums in one register each, over
// the samples t = 0..W-1 in ascending order, with fmaf.  That order depends
// on neither the number of frames nor the tiling, so a frame's magnitudes
// are bitwise the same whatever batch it is computed in.
//
// Frames are read through two strides (outer row, frame within the row):
// frame m lives at frames + (m / per_row) * stride_outer
//                         + (m % per_row) * stride_inner,
// so a [S, F, W] view made by unfold over [S, T] audio streams (inner stride
// = hop) is read in place, with no [S*F, W] copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // frames per block
constexpr int BB = 64;    // bins per block (2*BB interleaved table columns)
constexpr int BK = 16;    // window samples per shared-memory slice
constexpr int TM = 4;     // frames per thread
constexpr int TB = 4;     // bins per thread
constexpr int THREADS = (BM / TM) * (BB / TB);   // 256

__global__ void __launch_bounds__(THREADS)
stft_mag_kernel(const float* __restrict__ frames, long long stride_outer,
                long long stride_inner, int per_row,
                const float* __restrict__ window,
                const float* __restrict__ trig, int trig_ld,
                float* __restrict__ out, int n, int width, int band) {
  __shared__ float As[BK][BM + 4];          // windowed frames, k-major
  __shared__ __align__(16) float Ts[BK][2 * BB];   // interleaved cos/-sin

  const int tid = threadIdx.x;
  const int tx = tid % (BB / TB);           // bin lane: bins tx + 16*j
  const int ty = tid / (BB / TB);           // frame lane: frames ty*4 + i
  const int m0 = blockIdx.y * BM;
  const int b0 = blockIdx.x * BB;
  const int cols = 2 * band;                // valid table columns

  // The frame rows this thread loads: element e = tid + r*THREADS of the
  // BM x BK tile is row e / BK, column e % BK.
  const float* rowp[(BM * BK) / THREADS];
  int rowk[(BM * BK) / THREADS];
  int rowm[(BM * BK) / THREADS];
#pragma unroll
  for (int r = 0; r < (BM * BK) / THREADS; ++r) {
    const int e = tid + r * THREADS;
    const int m = m0 + e / BK;
    rowm[r] = e / BK;
    rowk[r] = e % BK;
    rowp[r] = nullptr;
    if (m < n) {
      rowp[r] = frames + (long long)(m / per_row) * stride_outer
                + (long long)(m % per_row) * stride_inner;
    }
  }

  float re[TM][TB], im[TM][TB];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) { re[i][j] = 0.f; im[i][j] = 0.f; }

  for (int k0 = 0; k0 < width; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int k = k0 + rowk[r];
      float v = 0.f;
      if (rowp[r] != nullptr) {
        v = rowp[r][k];
        if (window != nullptr) v = __fmul_rn(v, window[k]);
      }
      As[rowk[r]][rowm[r]] = v;
    }
#pragma unroll
    for (int r = 0; r < (BK * 2 * BB) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / (2 * BB);
      const int c = e % (2 * BB);
      const int col = 2 * b0 + c;
      Ts[kk][c] = col < cols ? trig[(long long)(k0 + kk) * trig_ld + col]
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const float2 t = *reinterpret_cast<const float2*>(
            &Ts[kk][2 * (tx + j * (BB / TB))]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          re[i][j] = fmaf(a[i], t.x, re[i][j]);
          im[i][j] = fmaf(a[i], t.y, im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= n) continue;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int b = b0 + tx + j * (BB / TB);
      if (b < band) {
        out[(long long)m * band + b] = sqrtf(
            __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                      __fmul_rn(im[i][j], im[i][j])));
      }
    }
  }
}

}  // namespace

extern "C" {

const char* aat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success).  Requires
// width % BK == 0.
int aat_stft_mag(const float* frames, long long stride_outer,
                 long long stride_inner, int per_row, const float* window,
                 const float* trig, int trig_ld, float* out, int n, int width,
                 int band, void* stream) {
  if (n <= 0 || band <= 0) return static_cast<int>(cudaGetLastError());
  if (width % BK != 0 || per_row <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((band + BB - 1) / BB, (n + BM - 1) / BM);
  stft_mag_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, stride_outer, stride_inner, per_row, window, trig, trig_ld,
      out, n, width, band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
