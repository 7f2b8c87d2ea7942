// K5's chain bound at S = 1, a measurement (port_tools/k5_chain.py): the
// floor recurrence of csrc/noisefloor.cu's floor_step alone, with vn held
// at 0 (so a rising step's alpha is 0.04 and `vn < 0.15` holds):
//   d = max(floor, 0.01), above = fmaf(-1.5, d, m) > d 2^-24,
//   floor = m > floor && above ? floor : fmaf(alpha, m - floor, floor),
//   alpha = m > floor ? 0.04 : 0.02.
// That is the part of a frame that waits on the frame before it: the
// volatility EMA, vn's division, the effective floor and every load are
// left out.  One warp a block, block j running bins [32 j, 32 j + 32) of
// one stream over its N frames from shared memory, CHAIN_TILE frames at a
// time, clock64 around each tile's frame loop, so that only the chain's
// own latency and issue are timed.  The rounding and the constants are
// floor_step's (tests/test_torch_noisefloor_kernel.py compares them).

#include <cuda_runtime.h>

namespace {

constexpr float FLOOR_EPS = 0x1.47ae14p-7f;          // 0.01
constexpr float NOTE_RATIO = 0x1.8p+0f;              // 1.5
constexpr float BASE_ALPHA = 0x1.47ae14p-5f;         // 0.04
constexpr float RELEASE = 0x1.47ae14p-6f;            // 0.02
constexpr float RATIO_MIDPOINT = 0x1p-24f;
constexpr int CHAIN_TILE = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(32)
floor_chain_kernel(const float* __restrict__ mags, long long ms_n,
                   const float* __restrict__ floor0,
                   float* __restrict__ floor1, long long* __restrict__ cycles,
                   int N, int B) {
  __shared__ float sm[CHAIN_TILE][32];
  const int lane = threadIdx.x;
  const int b = min(blockIdx.x * 32 + lane, B - 1);
  float floor = floor0[b];
  long long total = 0;
  for (int t0 = 0; t0 < N; t0 += CHAIN_TILE) {
    const int n = min(CHAIN_TILE, N - t0);
    for (int f = 0; f < n; ++f) sm[f][lane] = mags[(t0 + f) * ms_n + b];
    __syncwarp();
    const long long c0 = clock64();
#pragma unroll 8
    for (int f = 0; f < n; ++f) {
      const float m = sm[f][lane];
      const bool rising = m > floor;
      const float d = max_nan(floor, FLOOR_EPS);
      const bool above =
          fmaf(-NOTE_RATIO, d, m) > __fmul_rn(d, RATIO_MIDPOINT);
      const float alpha = rising ? BASE_ALPHA : RELEASE;
      if (!(rising && above)) floor = fmaf(alpha, __fsub_rn(m, floor), floor);
    }
    __syncwarp();
    total += clock64() - c0;
  }
  if (blockIdx.x * 32 + lane < B) floor1[b] = floor;
  if (lane == 0) cycles[blockIdx.x] = total;
}

}  // namespace

extern "C" {

// mags [N, >= B] at row stride ms_n, floor0 and floor1 [B], cycles
// [ceil(B / 32)] (each warp's clock64 cycles over the N frames).  Returns
// cudaGetLastError() after the launch.
int k5_floor_chain(const float* mags, long long ms_n, const float* floor0,
                   float* floor1, long long* cycles, int N, int B,
                   void* stream) {
  floor_chain_kernel<<<(B + 31) / 32, 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mags, ms_n, floor0, floor1, cycles, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
