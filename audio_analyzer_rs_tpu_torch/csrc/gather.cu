// K8 and K9: the lane gathers of the Mosaic probe.  Replace the two Pallas
// kernels of tools/mosaic_probe.py: `gather_kernel` (:24, launched :31),
// `jnp.take_along_axis(x, idx, axis=1)` over [F, P] float32 rows with
// [F, P] int32 indices, and `kern` (:83, launched :90), twelve such gathers
// at (idx + n) mod P summed, the comb's harmonic read.  Bitwise equal to
// the plain versions in ops/gather.py.
//
// What bounds them on an H100: bytes, and at the probe's shapes the launch.
// At [8, 7296] each reads x and idx and writes out once, 3 x 233 KB =
// 0.70 MB, 0.21 us at 3.35 TB/s; K9's 12 adds an output are 0.70 M
// operations, far below the FP32 rate.  The TPU question the probe asked
// (does Mosaic lower a lane gather across 128-lane tiles?) does not arise
// here: a thread can read any address.
//
// K8, `lane_gather_kernel`: a thread an output, consecutive threads on
// consecutive columns of one row, so the index loads and the stores are
// coalesced; each thread reads its one value of x through the read-only
// cache.  A row is read once on average, so staging it in shared memory
// would only add its copy.  JAX's index semantics: an index in [-P, 0)
// wraps, one outside [-P, P) gives NaN (jnp's "fill" mode, whose NaN is
// 0x7fc00000).
//
// K9, `comb_gather12_kernel`: the same layout, a thread an output; its 12
// reads of the row go through the read-only cache, where the row (7,296 x
// 4 B = 29 KB) stays after the first reads of it.  The 12 loads do not
// depend on the sum, so they are all in flight before the first add.
// Staging the row in shared memory once a block of 1,024 columns (the
// first design) was slower at [8, 7296]: 4.24 against 3.12 us a call in
// turns on an H100 (port_tools/gather_probe.py --turns; PERF.md): each
// block copied the whole row and waited at a barrier for 4 outputs a
// thread.  The index arithmetic is JAX's: (idx + n) wraps as int32
// (unsigned arithmetic here, where a signed overflow is undefined), then
// the floor-mod by P.  Where idx + 11 cannot overflow, the column is
// floor-mod(idx, P) stepped by one with a wrap at P, the same column.  The
// sum starts at +0.0 and adds n = 0..11 in order with __fadd_rn (no
// contraction can arise from adds alone; the spelling keeps the order and
// the +0.0 seed explicit: 0.0 + -0.0 is +0.0).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMB_GATHERS = 12;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int f, int p) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= p) return;
  for (int r = blockIdx.y; r < f; r += gridDim.y) {
    const long long base = static_cast<long long>(r) * p;
    const int i = __ldg(idx + base + c);
    float v = __int_as_float(0x7fc00000);
    if (i >= -p && i < p) v = __ldg(x + base + (i < 0 ? i + p : i));
    out[base + c] = v;
  }
}

__device__ __forceinline__ int floor_mod(int v, int p) {
  const int j = v % p;
  return j < 0 ? j + p : j;
}

__global__ void __launch_bounds__(THREADS)
comb_gather12_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     float* __restrict__ out, int f, int p) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= p) return;
  for (int r = blockIdx.y; r < f; r += gridDim.y) {
    const long long base = static_cast<long long>(r) * p;
    const float* xr = x + base;
    const int i = __ldg(idx + base + c);
    float acc = 0.0f;
    if (i <= INT_MAX - (COMB_GATHERS - 1)) {
      int j = floor_mod(i, p);
#pragma unroll
      for (int n = 0; n < COMB_GATHERS; ++n) {
        acc = __fadd_rn(acc, __ldg(xr + j));
        j = j + 1 == p ? 0 : j + 1;
      }
    } else {
      for (int n = 0; n < COMB_GATHERS; ++n) {
        const int v = static_cast<int>(static_cast<unsigned>(i) +
                                       static_cast<unsigned>(n));
        acc = __fadd_rn(acc, __ldg(xr + floor_mod(v, p)));
      }
    }
    out[base + c] = acc;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  x, idx and
// out are [f, p] row-major.
int aat_lane_gather(const float* x, const int* idx, float* out, int f, int p,
                    void* stream) {
  if (f <= 0 || p <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((p + THREADS - 1) / THREADS, f < MAX_GRID_Y ? f : MAX_GRID_Y);
  lane_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, f, p);
  return static_cast<int>(cudaGetLastError());
}

// As aat_lane_gather.
int aat_comb_gather12(const float* x, const int* idx, float* out, int f,
                      int p, void* stream) {
  if (f <= 0 || p <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((p + THREADS - 1) / THREADS, f < MAX_GRID_Y ? f : MAX_GRID_Y);
  comb_gather12_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, idx, out, f,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
