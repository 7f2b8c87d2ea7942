// K1: windowed, banded rDFT magnitude — frames x Hann, times the
// interleaved cos/-sin table, then sqrt(re^2 + im^2) for the first `band`
// bins.  Replaces the Pallas kernel audio_analyzer_rs_tpu/ops/pallas_stft.py
// `_stft_kernel` (and the XLA GEMM of ops/fft.py `rfft_mag(backend="dft")`).
//
// What bounds it on an H100: tensor-core arithmetic.  At the main-path
// shape (8192 frames x 2048 samples x 930 table columns) the FP32 product
// is 31.2 GFLOP, whose floor on the CUDA cores (67 TFLOP/s) is 0.47 ms.
// The 1e-6 spectral gate rules out one TF32 pass, so the product runs as
// 3xTF32 on the tensor cores: x = hi + lo for both operands (hi and lo
// each rounded to TF32), and lo*hi + hi*lo + hi*hi accumulated in FP32:
// 93.6 GFLOP at 495 TFLOP/s, 0.19 ms.  The bytes (17.6 MB of audio, the
// 15.7 MB split table, 15.2 MB out) take ~15 us at 3.35 TB/s.
//
// Design:
// - `wgmma.m64n160k8` TF32, A from registers, B from shared memory.  A
//   block is 128 frames x 160 table columns (80 bins): two warpgroups of
//   64 frames share each B tile.  8192 x 930 gives 64 x 6 = 384 blocks,
//   2.9 waves on 132 SMs at one block an SM (registers bind it).
// - B, the split table, is built once per table and device by the wrapper
//   as [hi; lo] rows of [cols_pad, W] (K-major: TF32 wgmma takes no
//   transposed operand).  Thread 0 streams its 32-sample K slices by TMA
//   (128-byte swizzle) into a ring of STAGES stages with full/empty
//   mbarriers, refilling a stage once all 8 warps have finished with it.
//   There is no producer warp: a third warpgroup would cost the consumers
//   registers, and they need ~220.
// - A, the frames, are read in place from the strided unfold view straight
//   into registers (two float4 loads per row and slice), multiplied by the
//   window (staged in shared memory) with __fmul_rn, and split in registers
//   with cvt.rna.tf32.  The next slice's loads are in flight while this
//   slice's 12 wgmmas run.  Within each slice the table's K order is
//   permuted (the wrapper's `K_ORDER`) so that a thread's four A fragments
//   come from 8 contiguous samples.
// - The tensor cores truncate as they accumulate: summed over all 768
//   products of a frame, the bias reached 2e-5 of the largest magnitude.
//   So each slice sums its 12 products (lo*hi, hi*lo, hi*hi for k-steps
//   0..3) in a fresh tensor-core partial, and the 64 partials are added in
//   order with __fadd_rn in registers.  The instruction sequence of a frame
//   does not depend on its tile, its row in the tile or the batch, so a
//   frame's magnitudes are bitwise the same in any batch.
// - Split over the sample depth at the latency shapes.  With a handful of
//   frames (a live slot's 2, a pool wave's 66) the grid above is 6 blocks
//   banded, 13 at full width, on 132 SMs, each streaming 2.6 MB of table
//   through one SM's ring.  The wrapper then asks for `splits` blocks a
//   tile along a third grid dimension (`hopper_stft.split_count`), one
//   warpgroup when n <= 64.  Each block writes its slices' fresh partials,
//   unsummed, to a workspace [64, n, cols_pad] (0.5 MB at 2 frames banded,
//   in L2), and a second kernel adds the 64 partials of each output in
//   slice order from +0.0 with __fadd_rn, then applies the same epilogue.
//   Same partials, same order of the sum: bitwise the unsplit launch.
// - The epilogue takes (re, im) from adjacent accumulator columns of one
//   thread and writes sqrt(re*re + im*im) with __fmul_rn / __fadd_rn;
//   rows past n are read as zeros and never written.
// ptxas (CUDA 12.9, sm_90a): 228 registers a thread unsplit, 154 split
// (no accumulators), no spills; 64 B of static shared memory and, at W =
// 2048, 173,056 B of dynamic (the ring of four 40,960 B stages, the 8 KB
// window, 1 KB for alignment).
// Measured on an H100 80GB HBM3 at 700 W: 0.28 ms a launch at the
// main-path shape (10 back-to-back), 67% of the 0.19 ms bound, 0.41x the
// time of cuBLAS's FP32 GEMM for the same product; split, 11.8 us at [1, 2]
// frames against 89 us unsplit (PERF.md).
//
// Frames are read through two strides (outer row, frame within the row):
// frame m lives at frames + (m / per_row) * stride_outer
//                         + (m % per_row) * stride_inner,
// so a [S, F, W] view made by unfold over [S, T] audio streams (inner stride
// = hop) is read in place, with no [S*F, W] copy.  The base and both strides
// must be 16-byte aligned (the wrapper checks).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 160;                  // table columns per block
constexpr int BK = 32;                   // samples per stage (128 B rows)
constexpr int STAGES = 4;
constexpr int ACC = BN / 2;              // f32 accumulators a thread
constexpr int TILE_BYTES = BN * BK * 4;  // one of hi / lo: 20,480 B
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// Stage s: the hi and lo tiles of K slice t, table rows col0 .. +BN.
__device__ __forceinline__ void load_stage(uint8_t* ring, uint64_t* full,
                                           const CUtensorMap* map, int s,
                                           int t, int col0, int cols_pad) {
  uint8_t* hi = ring + s * STAGE_BYTES;
  mbar_expect_tx(&full[s], STAGE_BYTES);
  tma_load(hi, map, &full[s], t * BK, col0);
  tma_load(hi + TILE_BYTES, map, &full[s], t * BK, cols_pad + col0);
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D8(i) D4(i), D4(i + 4)
#define D40(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24), D8(i + 32)

// d[64 x 160] (= if accumulate) += a[64 x 8] (registers, TF32) *
// b[8 x 160] (shared, TF32).
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n"
      "}\n"
      : D40(0), D40(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// Orders register reads of d after the wgmma.wait_group before it.
__device__ __forceinline__ void fence_operands(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#undef D40
#undef D8
#undef D4

// One thread's frame samples 8q .. 8q+7 of a 32-sample slice, both rows.
struct Slice {
  float4 r0a, r0b, r1a, r1b;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return p ? __ldg(reinterpret_cast<const float4*>(p))
           : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ Slice load_slice(const float* p0, const float* p1,
                                            int off) {
  Slice s;
  s.r0a = load4(p0 ? p0 + off : nullptr);
  s.r0b = load4(p0 ? p0 + off + 4 : nullptr);
  s.r1a = load4(p1 ? p1 + off : nullptr);
  s.r1b = load4(p1 ? p1 + off + 4 : nullptr);
  return s;
}

__device__ __forceinline__ void split(float x, float w, uint32_t& hi,
                                      uint32_t& lo) {
  const float v = __fmul_rn(x, w);
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ const float* frame_ptr(
    const float* frames, long long stride_outer, long long stride_inner,
    int per_row, int r, int n) {
  return r < n ? frames + (long long)(r / per_row) * stride_outer
                     + (long long)(r % per_row) * stride_inner
               : nullptr;
}

// WG warpgroups of 64 frames a block (BM = 64 WG frames), slices
// [t0, t1) of the sample depth, t0 = blockIdx.z * slices_per.  Unsplit
// (SPLIT false, slices_per = width / BK) a block sums all 64 partials and
// writes magnitudes; split, it writes each slice's partial, unsummed, to
// ws[t][frame][column] and `split_sum_kernel` sums them in slice order.
template <int WG, bool SPLIT>
__global__ void __launch_bounds__(128 * WG, 1)
stft_mag_kernel(const __grid_constant__ CUtensorMap table_map,
                const float* __restrict__ frames, long long stride_outer,
                long long stride_inner, int per_row,
                const float* __restrict__ window, float* __restrict__ out,
                float* __restrict__ ws, int n, int width, int band,
                int cols_pad, int slices_per) {
  constexpr int THREADS = 128 * WG;
  constexpr int BM = 64 * WG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* win = reinterpret_cast<float*>(ring + RING_BYTES);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int t0 = blockIdx.z * slices_per;
  const int nt = min(slices_per, width / BK - t0);   // slices of this block

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < STAGES && i < nt; ++i) {
      load_stage(ring, full, &table_map, i, t0 + i, col0, cols_pad);
    }
  }
  for (int i = t0 * BK + tid; i < (t0 + nt) * BK; i += THREADS) {
    win[i] = window != nullptr ? window[i] : 1.f;
  }
  __syncthreads();

  // Warp w owns frames m0 + 16w .. +15 (warpgroup w / 4 the 64 rows of
  // its wgmma); lane (g, q) its rows g and g + 8 and, in each 32-sample
  // slice, samples 8q .. 8q+7.
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = m0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const float* p0 = frame_ptr(frames, stride_outer, stride_inner, per_row,
                              r0, n);
  const float* p1 = frame_ptr(frames, stride_outer, stride_inner, per_row,
                              r1, n);

  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;

  Slice cur = load_slice(p0, p1, t0 * BK + 8 * q);
  for (int i = 0; i < nt; ++i) {
    const int t = t0 + i;
    const int s = i % STAGES;
    // k-step ks reads samples 2ks (fragment column q) and 2ks+1 (column
    // q+4): a0 = row g, a1 = row g+8, a2 / a3 the same at 2ks+1.
    const float4 wa = *reinterpret_cast<const float4*>(win + t * BK + 8 * q);
    const float4 wb =
        *reinterpret_cast<const float4*>(win + t * BK + 8 * q + 4);
    const float x0[8] = {cur.r0a.x, cur.r0a.y, cur.r0a.z, cur.r0a.w,
                         cur.r0b.x, cur.r0b.y, cur.r0b.z, cur.r0b.w};
    const float x1[8] = {cur.r1a.x, cur.r1a.y, cur.r1a.z, cur.r1a.w,
                         cur.r1b.x, cur.r1b.y, cur.r1b.z, cur.r1b.w};
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split(x0[2 * ks], w[2 * ks], ahi[ks][0], alo[ks][0]);
      split(x1[2 * ks], w[2 * ks], ahi[ks][1], alo[ks][1]);
      split(x0[2 * ks + 1], w[2 * ks + 1], ahi[ks][2], alo[ks][2]);
      split(x1[2 * ks + 1], w[2 * ks + 1], ahi[ks][3], alo[ks][3]);
    }
    if (i + 1 < nt) cur = load_slice(p0, p1, (t + 1) * BK + 8 * q);
    // Refill the stage that slice i - 1 used once all warps are done
    // with it.
    if (tid == 0 && i >= 1 && i - 1 + STAGES < nt) {
      const int sp = (i - 1) % STAGES;
      mbar_wait(&empty[sp], ((i - 1) / STAGES) & 1);
      load_stage(ring, full, &table_map, sp, t - 1 + STAGES, col0,
                 cols_pad);
    }

    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* tile = ring + s * STAGE_BYTES;
    const uint64_t bhi = sw128_desc(tile);
    const uint64_t blo = sw128_desc(tile + TILE_BYTES);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // +32 B along the swizzled 128-B row per k-step of 8 samples; the
      // slice's first product starts the partial sum afresh.
      wgmma_tf32(part, alo[ks], bhi + 2 * ks, ks > 0);
      wgmma_tf32(part, ahi[ks], blo + 2 * ks, 1);
      wgmma_tf32(part, ahi[ks], bhi + 2 * ks, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (SPLIT) {
      // Accumulator j of n8 group k: row g (j < 2) or g + 8, columns
      // col0 + 8k + 2q + {0, 1}.
      float* slab = ws + (long long)t * n * cols_pad + col0 + 2 * q;
#pragma unroll
      for (int k = 0; k < ACC / 4; ++k) {
        if (r0 < n) {
          *reinterpret_cast<float2*>(slab + (long long)r0 * cols_pad
                                     + 8 * k) =
              make_float2(part[4 * k], part[4 * k + 1]);
        }
        if (r1 < n) {
          *reinterpret_cast<float2*>(slab + (long long)r1 * cols_pad
                                     + 8 * k) =
              make_float2(part[4 * k + 2], part[4 * k + 3]);
        }
      }
    } else {
      // The tensor cores truncate as they accumulate; summing each
      // slice's 12 products there and the 64 slices here, rounded to
      // nearest, keeps the error at FP32's level.
#pragma unroll
      for (int k = 0; k < ACC; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
    }
  }
  if constexpr (!SPLIT) {
    // Accumulator j of n8 group i: row g (j < 2) or g + 8, column 8i + 2q
    // + (j & 1): (re, im) of bin col0/2 + 4i + q.
#pragma unroll
    for (int i = 0; i < ACC / 4; ++i) {
      const int b = col0 / 2 + 4 * i + q;
      if (b < band) {
        if (r0 < n) {
          out[(long long)r0 * band + b] = sqrtf(__fadd_rn(
              __fmul_rn(acc[4 * i], acc[4 * i]),
              __fmul_rn(acc[4 * i + 1], acc[4 * i + 1])));
        }
        if (r1 < n) {
          out[(long long)r1 * band + b] = sqrtf(__fadd_rn(
              __fmul_rn(acc[4 * i + 2], acc[4 * i + 2]),
              __fmul_rn(acc[4 * i + 3], acc[4 * i + 3])));
        }
      }
    }
  }
}

// The split form's second pass: a thread a (frame, bin) adds the 64
// partials of (re, im) in slice order from +0.0 with __fadd_rn, as the
// unsplit block's register loop does, then the same epilogue.
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 int n, int band, int cols_pad, int ktiles) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * band) return;
  const int r = static_cast<int>(idx / band);
  const int b = static_cast<int>(idx % band);
  const float* p = ws + (long long)r * cols_pad + 2 * b;
  const long long slab = (long long)n * cols_pad;
  float re = 0.f, im = 0.f;
#pragma unroll 16
  for (int t = 0; t < ktiles; ++t) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p + t * slab));
    re = __fadd_rn(re, v.x);
    im = __fadd_rn(im, v.y);
  }
  out[idx] = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

template <int WG, bool SPLIT>
cudaError_t launch(const CUtensorMap& map, const float* frames,
                   long long stride_outer, long long stride_inner,
                   int per_row, const float* window, float* out, float* ws,
                   int n, int width, int band, int cols_pad, int slices_per,
                   cudaStream_t stream) {
  const int smem = RING_BYTES + width * 4 + 1024;  // + 1 KB alignment
  cudaError_t err = cudaFuncSetAttribute(
      stft_mag_kernel<WG, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ktiles = width / BK;
  dim3 grid(cols_pad / BN, (n + 64 * WG - 1) / (64 * WG),
            (ktiles + slices_per - 1) / slices_per);
  stft_mag_kernel<WG, SPLIT><<<grid, 128 * WG, smem, stream>>>(
      map, frames, stride_outer, stride_inner, per_row, window, out, ws, n,
      width, band, cols_pad, slices_per);
  return cudaGetLastError();
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

}  // namespace

extern "C" {

const char* aat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success).  `table` is
// the wrapper's split table: [2 * cols_pad, width] float32, hi rows then lo
// rows, 16-byte aligned.  Requires width % 32 == 0, cols_pad % 160 == 0 and
// 2 * band <= cols_pad.  `splits` > 1 spreads the width / 32 slices over
// that many blocks a tile (ceil(slices / splits) slices each) and needs
// `ws`, a [width / 32, n, cols_pad] float32 workspace; the magnitudes are
// bitwise those of splits = 1.
int aat_stft_mag(const float* frames, long long stride_outer,
                 long long stride_inner, int per_row, const float* window,
                 const float* table, int cols_pad, float* out, int n,
                 int width, int band, int splits, float* ws, void* stream) {
  if (n <= 0 || band <= 0) return static_cast<int>(cudaGetLastError());
  if (width % BK != 0 || cols_pad % BN != 0 || 2 * band > cols_pad ||
      per_row <= 0 || splits <= 0 || (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(2 * cols_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 4};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(table), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ktiles = width / BK;
  if (splits == 1) {
    return static_cast<int>(launch<2, false>(
        map, frames, stride_outer, stride_inner, per_row, window, out,
        nullptr, n, width, band, cols_pad, ktiles, st));
  }
  const int slices_per = (ktiles + splits - 1) / splits;
  cudaError_t err =
      n <= 64 ? launch<1, true>(map, frames, stride_outer, stride_inner,
                                per_row, window, out, ws, n, width, band,
                                cols_pad, slices_per, st)
              : launch<2, true>(map, frames, stride_outer, stride_inner,
                                per_row, window, out, ws, n, width, band,
                                cols_pad, slices_per, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outs = static_cast<long long>(n) * band;
  split_sum_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                     st>>>(ws, out, n, band, cols_pad, ktiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
