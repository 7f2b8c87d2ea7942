// K4: the onset recurrence over S streams (ref src/analysis/onset.rs:
// 244-543).  Replaces the `lax.scan` of audio_analyzer_rs_tpu/ops/onset.py
// `onset_scan` (:145), which XLA compiles to one device loop; it has no
// Pallas twin.  Bitwise equal to `onset_scan_plain` (ops/onset.py).
//
// What bounds it on an H100: at the segmented step (S = 128 streams x N =
// 4,096 frames x 129 bins) the magnitudes are 270 MB, ~0.081 ms of HBM
// time; each stream is a serial recurrence over its N frames, so at small S
// (the sequential analyzer, S = 1) the per-frame chain is the floor.  The
// design keeps the chain short and off device memory:
//  - A block a stream.  The bins are on the threads of NW = ceil(H / 32)
//    bin warps (five for 129 bins; lanes past H are pads); each bin's floor
//    and previous magnitude stay in registers for all N frames.
//  - The bin threads stage the next 32-frame tile of magnitudes (and the
//    global floors) into shared memory by cp.async while they work on this
//    one, so a frame's reads, its neighbours' included, hit shared memory.
//  - Per frame, each bin warp reduces its flux, energy, burst count and
//    largest excess with shuffles and writes one partial a warp.  Nothing
//    in the bin work waits for the scalar recurrence: a tile is one block
//    barrier, not one a frame.
//  - One chain warp runs the tile behind: lane f combines frame f's partials
//    across the warps and computes what depends on that frame alone (the
//    silence gate, velocity, the burst trigger); then all lanes run the
//    32-frame scalar recurrence (energy EMA, FluxTracker threshold, gates,
//    refractory counter) in step, a frame's inputs broadcast by shuffle,
//    and lane f keeps frame f's decisions and writes its outputs.
//
// Rounding, as the plain version does it: the flux and energy sums are
// `onset.tree_sum`'s tree (the bins padded with +0.0 to 256: shuffle-down
// halving inside a warp, then across the 8 warp slots, absent warps +0.0);
// fmaf exactly where XLA:CPU contracts (the bin weight, the floor blend,
// the energy EMA, the threshold); the constant divisions (/ 3 in the
// smoothing, / 50 in the velocity) as products with the float32
// reciprocal, as XLA computes them; every other operation rounds on its
// own (__fadd_rn and friends; `r` is IEEE division).  The max and the
// burst count do not depend on the order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TF = 32;                // frames a tile: one chain lane each
constexpr int MAX_WARPS = 8;          // bin warps: at most 256 bins
constexpr int SLOTS = 8;              // the tree's cross-warp width
constexpr unsigned FULL = 0xffffffffu;
constexpr int REFRACTORY = 3;

struct __align__(16) Partials {
  float flux[2][TF][SLOTS];           // per frame, per bin warp
  float energy[2][TF][SLOTS];
  float excess[2][TF][SLOTS];
  int bursts[2][TF][SLOTS];
  float gfloor[2][TF];                // the tile's global floors
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The whole block; the bin warps and the chain warp reach it from their own
// branches, once a tile each.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// Bin threads: copy frames [f0, f0 + nt) of the stream (f0 counts from the
// start of mags) and their global floors into buffer b.
__device__ void stage_tile(float* mt, Partials& p, int b, long long f0,
                           int nt, int H, int nb,
                           const float* __restrict__ mags,
                           const float* __restrict__ gf) {
  float* dst = mt + b * TF * H;
  const float* src = mags + f0 * H;
  for (int k = threadIdx.x; k < nt * H; k += nb) cp_async4(dst + k, src + k);
  for (int k = threadIdx.x; k < nt; k += nb)
    cp_async4(&p.gfloor[b][k], gf + f0 + k);
}

// The chain warp: frames [t0, t0 + nt) of the tile in buffer b.
__device__ void chain_tile(const Partials& p, int b, long long f0, int nt,
                           int nw, const uint8_t* __restrict__ ts,
                           const uint8_t* __restrict__ hold, float& thr,
                           float& ema, int& since,
                           uint8_t* __restrict__ o_fired,
                           uint8_t* __restrict__ o_det,
                           float* __restrict__ o_vel,
                           float* __restrict__ o_flux,
                           float* __restrict__ o_energy,
                           int* __restrict__ o_bursts,
                           uint8_t* __restrict__ o_rising,
                           int* __restrict__ o_since) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < nt;
  float flux = 0.0f, energy = 0.0f, excess = -INFINITY;
  int bursts = 0;
  unsigned flags = 0u;                // bit 0 burst trigger, 1 tick, 2 hold
  if (live) {
    const float* pf = p.flux[b][lane];
    const float* pe = p.energy[b][lane];
    flux = __fadd_rn(
        __fadd_rn(__fadd_rn(pf[0], pf[4]), __fadd_rn(pf[2], pf[6])),
        __fadd_rn(__fadd_rn(pf[1], pf[5]), __fadd_rn(pf[3], pf[7])));
    energy = __fadd_rn(
        __fadd_rn(__fadd_rn(pe[0], pe[4]), __fadd_rn(pe[2], pe[6])),
        __fadd_rn(__fadd_rn(pe[1], pe[5]), __fadd_rn(pe[3], pe[7])));
    for (int w = 0; w < nw; ++w) {
      excess = fmaxf(excess, p.excess[b][lane][w]);
      bursts += p.bursts[b][lane][w];
    }
    flags |= ts[f0 + lane] != 0 ? 2u : 0u;
    flags |= hold[f0 + lane] != 0 ? 4u : 0u;
  }
  flux = bursts < 2 ? 0.0f : flux;                       // silence gate
  const float velocity = fminf(
      fmaxf(__fmul_rn(fmaxf(flux, __fmul_rn(excess, 5.0f)), 1.0f / 50.0f),
            0.0f),
      1.0f);
  flags |= (excess > 3.0f && bursts >= 3) ? 1u : 0u;

  bool my_det = false, my_rising = false, my_fired = false;
  int my_since = 0;
  for (int k = 0; k < nt; ++k) {                         // uniform
    const float fk = __shfl_sync(FULL, flux, k);
    const float ek = __shfl_sync(FULL, energy, k);
    const unsigned gk = __shfl_sync(FULL, flags, k);
    const float em = ek > ema ? 0.84f : 0.95f;
    ema = fmaf(ema, em, __fmul_rn(ek, __fsub_rn(1.0f, em)));
    const bool is_onset = fk > thr;
    const float mem = is_onset ? 0.84f : 0.89f;
    thr = fmaxf(fmaf(thr, mem, __fmul_rn(fk, __fsub_rn(1.0f, mem))), 0.9f);
    const bool det =
        is_onset && fk > __fmul_rn(thr, 1.5f) && (gk & 1u) != 0u;
    const bool rising = ek > __fmul_rn(ema, 1.5f);
    const bool fired = det && (gk & 2u) == 0u && rising && since >= REFRACTORY;
    if (lane == k) {
      my_det = det;
      my_rising = rising;
      my_fired = fired;
      my_since = since;
    }
    since = ((fired && (gk & 4u) == 0u) || (det && since < REFRACTORY))
                ? 0
                : since + 1;
  }
  if (live) {
    const long long o = f0 + lane;
    o_fired[o] = my_fired ? 1 : 0;
    o_det[o] = my_det ? 1 : 0;
    o_vel[o] = velocity;
    o_flux[o] = flux;
    o_energy[o] = energy;
    o_bursts[o] = bursts;
    o_rising[o] = my_rising ? 1 : 0;
    o_since[o] = my_since;
  }
}

__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 1)
onset_kernel(const float* __restrict__ mags, const float* __restrict__ gf,
             const uint8_t* __restrict__ ts, const uint8_t* __restrict__ hold,
             const float* __restrict__ prev0,
             const float* __restrict__ floor0,
             const uint8_t* __restrict__ init0,
             const float* __restrict__ thr0, const float* __restrict__ ema0,
             const int* __restrict__ since0, uint8_t* __restrict__ o_fired,
             uint8_t* __restrict__ o_det, float* __restrict__ o_vel,
             float* __restrict__ o_flux, float* __restrict__ o_energy,
             int* __restrict__ o_bursts, uint8_t* __restrict__ o_rising,
             int* __restrict__ o_since, float* __restrict__ prev1,
             float* __restrict__ floor1, uint8_t* __restrict__ init1,
             float* __restrict__ thr1, float* __restrict__ ema1,
             int* __restrict__ since1, int N, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Partials& p = *reinterpret_cast<Partials*>(smem_raw);
  float* mt = reinterpret_cast<float*>(&p + 1);   // [2][TF * H] magnitudes
  const int nw = (H + 31) / 32;
  const int nb = nw * 32;                         // bin threads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x;                       // the block's stream
  const long long row = (long long)s * N;         // its first frame
  const int ntiles = (N + TF - 1) / TF;

  // Warp slots no bin warp writes stay +0.0: the tree's pads.
  for (int k = threadIdx.x; k < 2 * TF * SLOTS; k += blockDim.x) {
    (&p.flux[0][0][0])[k] = 0.0f;
    (&p.energy[0][0][0])[k] = 0.0f;
  }

  if (warp < nw) {                                // bin warps
    const int i = threadIdx.x;                    // the bin
    const bool real = i < H;
    const float weight =
        real ? fmaf(-static_cast<float>(i), __frcp_rn(static_cast<float>(H)),
                    1.0f)
             : 0.0f;
    float prev = real ? prev0[(long long)s * H + i] : 0.0f;
    float floor = real ? floor0[(long long)s * H + i] : 0.0f;
    bool init = init0[s] != 0;
    if (ntiles > 0) stage_tile(mt, p, 0, row, min(TF, N), H, nb, mags, gf);
    cp_async_wait_all();
    block_sync();
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      const int nt = min(TF, N - t * TF);
      if (t + 1 < ntiles)
        stage_tile(mt, p, b ^ 1, row + (t + 1) * TF,
                   min(TF, N - (t + 1) * TF), H, nb, mags, gf);
      const float* tile = mt + b * TF * H;
#pragma unroll 4
      for (int f = 0; f < nt; ++f) {
        const float* mf = tile + f * H;
        float m = 0.0f, contrib = 0.0f, excess = -INFINITY;
        bool burst = false;
        if (real) {
          const float g = p.gfloor[b][f];
          m = mf[i];
          const float sm =
              (i > 0 && i < H - 1)
                  ? __fmul_rn(__fadd_rn(__fadd_rn(mf[i - 1], m), mf[i + 1]),
                              1.0f / 3.0f)
                  : m;
          const float diff = __fsub_rn(sm, prev);
          contrib = diff > 0.0f ? __fmul_rn(diff, weight) : 0.0f;
          const float f0 = init ? floor : fmaxf(m, g);
          excess = __fdiv_rn(m, fmaxf(f0, fmaxf(g, 0.01f)));
          burst = excess > 2.5f;
          const float d = __fsub_rn(m, f0);
          floor = burst ? __fmul_rn(m, 1.3f)
                        : fmaf(m > f0 ? 0.1f : 0.04f, d, f0);
          prev = m;
        }
        init = true;
        float fl = contrib, en = m, mx = excess;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          fl = __fadd_rn(fl, __shfl_down_sync(FULL, fl, off));
          en = __fadd_rn(en, __shfl_down_sync(FULL, en, off));
          mx = fmaxf(mx, __shfl_down_sync(FULL, mx, off));
        }
        const int cnt = __popc(__ballot_sync(FULL, burst));
        if (lane == 0) {
          p.flux[b][f][warp] = fl;
          p.energy[b][f][warp] = en;
          p.excess[b][f][warp] = mx;
          p.bursts[b][f][warp] = cnt;
        }
      }
      cp_async_wait_all();
      block_sync();
    }
    if (real) {
      prev1[(long long)s * H + i] = prev;
      floor1[(long long)s * H + i] = floor;
    }
    if (threadIdx.x == 0) init1[s] = init ? 1 : 0;
    return;
  }

  // The chain warp.
  float thr = thr0[s], ema = ema0[s];
  int since = since0[s];
  block_sync();
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0)
      chain_tile(p, (t - 1) & 1, row + (t - 1) * TF, TF, nw, ts, hold, thr,
                 ema, since, o_fired, o_det, o_vel, o_flux, o_energy,
                 o_bursts, o_rising, o_since);
    block_sync();
  }
  if (ntiles > 0)
    chain_tile(p, (ntiles - 1) & 1, row + (ntiles - 1) * TF,
               N - (ntiles - 1) * TF, nw, ts, hold, thr, ema, since, o_fired,
               o_det, o_vel, o_flux, o_energy, o_bursts, o_rising, o_since);
  if (lane == 0) {
    thr1[s] = thr;
    ema1[s] = ema;
    since1[s] = since;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  mags
// [S, N, H] (2 <= H <= 256), per-frame inputs and outputs [S, N], state
// leaves [S, H] / [S]; everything contiguous.
int aat_onset_scan(const float* mags, const float* gf, const uint8_t* ts,
                   const uint8_t* hold, const float* prev0,
                   const float* floor0, const uint8_t* init0,
                   const float* thr0, const float* ema0, const int* since0,
                   uint8_t* o_fired, uint8_t* o_det, float* o_vel,
                   float* o_flux, float* o_energy, int* o_bursts,
                   uint8_t* o_rising, int* o_since, float* prev1,
                   float* floor1, uint8_t* init1, float* thr1, float* ema1,
                   int* since1, int S, int N, int H, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (H < 2 || H > 32 * MAX_WARPS || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (H + 31) / 32;
  const int smem = static_cast<int>(sizeof(Partials)) +
                   2 * TF * H * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      onset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  onset_kernel<<<S, 32 * (nw + 1), smem, static_cast<cudaStream_t>(stream)>>>(
      mags, gf, ts, hold, prev0, floor0, init0, thr0, ema0, since0, o_fired,
      o_det, o_vel, o_flux, o_energy, o_bursts, o_rising, o_since, prev1,
      floor1, init1, thr1, ema1, since1, N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
