// K4: the onset recurrence over S streams (ref src/analysis/onset.rs:
// 244-543).  Replaces the `lax.scan` of audio_analyzer_rs_tpu/ops/onset.py
// `onset_scan` (:145), which XLA compiles to one device loop; it has no
// Pallas twin.  Bitwise equal to `onset_scan_plain` (ops/onset.py).
//
// What bounds it on an H100: each stream is a serial recurrence over its N
// frames, ~226 cycles a frame, and a block runs one stream.  Where the S
// blocks fit the card at once they run in one wave, and the chain of one
// stream is the time (the full step's [128, 7,485, 129] call: ~0.87 ms,
// against ~0.15 ms of bytes at 3.35 TB/s).  Where S is larger the time is
// the rounds of resident blocks, ceil(S / (SMs x blocks a SM)), each one
// chain long, a little longer where blocks share a SM's schedulers (at
// [2048, 7,485, 129] one block a SM made 16 rounds, two make 8; the 7.9 GB
// of magnitudes are ~2.4 ms, a floor below both).  So a block is kept
// small enough for two a SM wherever its bins allow (see Layout); every
// sum, tournament and recurrence runs in the same order at any width:
//  - Packed (H <= 160): two magnitude tiles in shared memory, one in
//    flight behind the one being worked (a tile is ~7,000 cycles of bin
//    work, a load well under 1,000), 97,536 B at H = 129; launch bounds
//    of 192 threads and two blocks a SM.
//  - Wide (H > 160): four tiles, three in flight, one block a SM.
// The design keeps every per-frame step off any cross-thread wait, so
// that the chains set the pace:
//  - A block a stream.  The bins are on the threads of NW = ceil(H / 32)
//    bin warps (five for 129 bins; lanes past H are pads); each bin's floor
//    and previous magnitude stay in registers for all N frames.
//  - The bin threads stage 32-frame tiles of magnitudes (and the global
//    floors) into shared memory by cp.async, NBUF - 1 tiles ahead of the
//    one they work on, so a frame's reads, its neighbours' included, hit
//    shared memory and the loads' latency hides behind the tiles' work.
//  - A tile is two phases a bin warp, with no shuffle in either.  First
//    each lane runs its bin over the tile's 32 frames: the floor
//    recurrence, the one chain, with no division on it (the burst test is
//    `den < burst_limit(m)`, exact, and the limit depends on the magnitude
//    alone), and the flux contribution, from magnitudes loaded 8 frames at
//    a time ahead of their use.  Both leave their values in the warp's
//    shared scratch (the divisor negated where the bin bursts).  Then,
//    after a __syncwarp, lane f reduces frame f over the warp's 32 bins in
//    registers from 16-byte shared loads: flux and energy as the tree
//    below, the burst count, and the largest burst ratio by a tournament
//    of exact comparisons (`keep_larger`) and one IEEE division.  Reducing
//    each frame as it comes (shuffle trees, a ballot and a division a bin)
//    would put all of that on one dependent chain a frame.
//  - The division's check sends a zero numerator to its slow path, and
//    digital silence makes ~40% of a recording's magnitudes zero: the
//    numerator is kept off it (`div_guarded`).
//  - One chain warp runs the tile behind: lane f combines frame f's partials
//    across the warps and computes what depends on that frame alone (the
//    silence gate, velocity, the burst trigger, the recurrence's products
//    that do not depend on it); then all lanes run the 32-frame scalar
//    recurrence (energy EMA, FluxTracker threshold, gates, refractory
//    counter) in step, unrolled over a full tile so that one frame's gates
//    overlap the next frame's EMA and threshold, keeping the decisions as
//    bit masks for lane f to write out.  The tick and hold flags are read
//    a tile ahead.  A tile is one block barrier, not one a frame.
//
// Rounding, as the plain version does it: the flux and energy sums are
// `onset.tree_sum`'s tree (the bins padded with +0.0 to 256: inside each
// group of 32 bins x[j] + x[j + k] for k = 16, 8, 4, 2, 1, then across the
// 8 group slots, absent warps +0.0); fmaf exactly where XLA:CPU contracts
// (the bin weight, the floor blend, the energy EMA, the threshold); the
// constant divisions (/ 3 in the smoothing, / 50 in the velocity) as
// products with the float32 reciprocal, as XLA computes them; every other
// operation rounds on its own (__fadd_rn and friends; `r` is IEEE
// division).  The max and the burst count do not depend on the order.
// The kernel is exact for magnitudes that are 0 or in [2^-60, 2^60] (see
// keep_larger); an audio spectrum's are.
//
// NaN, as the plain version does it (live audio can hold one): the max
// and the clamps of the floor, divisor and velocity keep a NaN (max_nan /
// min_nan, as torch.maximum and torch.clamp), where fmaxf and fminf drop
// it; a bin whose magnitude or divisor is NaN stores its divisor as NaN,
// which wins the ratio tournament, so the frame's largest ratio is NaN as
// torch.amax makes it; comparisons with a NaN are false on both sides.
// The flux is never NaN (a NaN difference adds +0.0), so the threshold's
// clamp stays fmaxf.  The NaN's bits may differ from the plain version's;
// where a NaN stands is the same.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TF = 32;                // frames a tile: one chain lane each
constexpr int CHUNK = 8;              // frames a bin lane loads at once
constexpr int MAX_WARPS = 8;          // bin warps: at most 256 bins
constexpr int SLOTS = 8;              // the tree's cross-warp width
constexpr int REFRACTORY = 3;
constexpr int SCRATCH_STRIDE = TF + 4;  // a warp's scratch row: 16-byte
                                        // loads by frame lanes, no conflict

// An instantiation of a layout: NBUF magnitude tiles in shared memory
// (NBUF - 1 staged ahead of the bin work), and its launch bounds: blocks of
// at most WARPS bin warps and the chain warp, BLOCKS of them a SM.
template <int NBUF_, int BLOCKS_, int WARPS>
struct Layout {
  static constexpr int NBUF = NBUF_;
  static constexpr int AHEAD = NBUF_ - 1;
  static constexpr int BLOCKS = BLOCKS_;
  static constexpr int THREADS = 32 * (WARPS + 1);
};
// At H = 129 a block is 192 threads of ~168 registers (ptxas), so two fit
// the register file.  Past 160 bins two blocks would need a register cap,
// and a cap spills (bounds of 288 threads and two blocks gave 96 registers
// and a 12% longer chain), so wider blocks keep one a SM and the deeper
// ring.
constexpr int PACKED_WARPS = 5;
using Packed = Layout<2, 2, PACKED_WARPS>;   // H <= 160: two blocks a SM
using Wide = Layout<4, 1, MAX_WARPS>;        // H > 160: one block a SM

template <int NBUF>
struct __align__(16) Partials {
  float flux[2][TF][SLOTS];           // per frame, per bin warp
  float energy[2][TF][SLOTS];
  float excess[2][TF][SLOTS];
  int bursts[2][TF][SLOTS];
  float gfloor[NBUF][TF];             // the tiles' global floors
};

// The chain warp's tile: per frame (by lane), the recurrence's inputs that
// do not depend on it.
struct __align__(16) Chain {
  // flux, energy, flux * (1 - 0.84), flux * (1 - 0.89)
  float4 flux[TF];
  // energy * (1 - 0.84), energy * (1 - 0.95), the flags' bits (bit 0 burst
  // trigger, 1 tick, 2 hold), unused
  float4 ema[TF];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest AHEAD - 1 committed groups have landed.
template <int AHEAD>
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
}

// The whole block; the bin warps and the chain warp reach it from their own
// branches, once a tile each.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// n / d, IEEE, for d >= 0.01: the slow path of the division's check
// (FCHK) takes n == 0, which digital silence gives on ~40% of the scene's
// frames; 0 / d is n itself, so the division sees 1 there instead.
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

// The burst test without a division.  For den > 0, RN(m / den) > 2.5f
// exactly when m / den > 2.5 + 2^-23 (that midpoint rounds to 2.5, whose
// last bit is even), that is when den < m / c with c = 2.5 + 2^-23, that
// is when den < RU(m / c): for m != 0, m / c is never a float (c's
// significand is odd and 25 bits wide) and lies at least ~2^-48 (relative)
// from every float, so RU of the double m * RN(1 / c), within 2^-52 of it,
// is RU(m / c).  For m = 0 the limit is 0, which no den passes.
// tests/test_torch_onset_kernel.py checks this against float division.
__device__ __forceinline__ float burst_limit(float m) {
  return __double2float_ru(static_cast<double>(m) * 0x1.99999851eb862p-2);
}

// Keeps in (ma, da) whichever of ma / da and mb / db is larger, compared
// exactly and without a division: mb * da against ma * db, each product as
// its float and the fma's exact rounding error (exact while the products
// neither underflow nor overflow: magnitudes 0 or in [2^-60, 2^60], floors
// in [0.01, 2^60]).  Ties keep a; RN is monotone, so the kept pair's
// rounded ratio is the largest rounded ratio.  A NaN divisor (a NaN ratio)
// wins, and once kept stays: its products are NaN and compare false.
__device__ __forceinline__ void keep_larger(float& ma, float& da, float mb,
                                            float db) {
  const float p1 = __fmul_rn(ma, db), p2 = __fmul_rn(mb, da);
  const float e1 = fmaf(ma, db, -p1), e2 = fmaf(mb, da, -p2);
  if (p2 > p1 || (p2 == p1 && e2 > e1) || db != db) {
    ma = mb;
    da = db;
  }
}

// Bin threads: copy frames [f0, f0 + nt) of the stream (f0 counts from the
// start of mags) and their global floors into buffer b.  Thread i copies
// bin i of each frame (coalesced along the bins) into a row of stride ms.
template <int NBUF>
__device__ void stage_tile(float* mt, Partials<NBUF>& p, int b, long long f0,
                           int nt, int H, int ms, int nb,
                           const float* __restrict__ mags,
                           const float* __restrict__ gf) {
  const int i = threadIdx.x;
  float* dst = mt + b * TF * ms + i;
  const float* src = mags + f0 * H + i;
  if (i < H)
    for (int f = 0; f < nt; ++f) cp_async4(dst + f * ms, src + f * H);
  for (int k = i; k < nt; k += nb)
    cp_async4(&p.gfloor[b][k], gf + f0 + k);
}

// v[j] += v[j + K] for j < K: one level of the tree, unrolled.
template <int K>
__device__ __forceinline__ void halve(float* v) {
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __fadd_rn(v[j], v[j + K]);
}

// One level of the ratio tournament: pair j keeps the larger of j, j + K.
template <int K>
__device__ __forceinline__ void halve_ratio(float* m, float* d) {
#pragma unroll
  for (int j = 0; j < K; ++j) keep_larger(m[j], d[j], m[j + K], d[j + K]);
}

// Lane f of a bin warp: the tree of 32 values (x[j] + x[j + k] for k = 16,
// 8, 4, 2, 1) read from 16-byte aligned shared memory.
__device__ __forceinline__ float tree32(const float* x) {
  float v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 lo = reinterpret_cast<const float4*>(x)[q];
    const float4 hi = reinterpret_cast<const float4*>(x + 16)[q];
    v[4 * q] = __fadd_rn(lo.x, hi.x);
    v[4 * q + 1] = __fadd_rn(lo.y, hi.y);
    v[4 * q + 2] = __fadd_rn(lo.z, hi.z);
    v[4 * q + 3] = __fadd_rn(lo.w, hi.w);
  }
  halve<8>(v);
  halve<4>(v);
  halve<2>(v);
  halve<1>(v);
  return v[0];
}

// The chain warp: frames [f0, f0 + nt) of the tile in buffer b.  `flags`
// holds each lane's frame's tick and hold bits (bits 1 and 2), loaded a tile
// ahead.  Lane f first combines frame f's partials and computes what
// depends on that frame alone into c; then the scalar recurrence runs over
// the tile (every lane in step, the decisions kept as bit masks), its
// inputs read from c as broadcasts that do not wait on the recurrence.
template <int NBUF>
__device__ void chain_tile(const Partials<NBUF>& p, Chain& c, int b,
                           long long f0, int nt, int nw, unsigned flags,
                           float& thr, float& ema, int& since,
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
  if (live) {
    const float* pf = p.flux[b][lane];
    const float* pe = p.energy[b][lane];
    flux = __fadd_rn(
        __fadd_rn(__fadd_rn(pf[0], pf[4]), __fadd_rn(pf[2], pf[6])),
        __fadd_rn(__fadd_rn(pf[1], pf[5]), __fadd_rn(pf[3], pf[7])));
    energy = __fadd_rn(
        __fadd_rn(__fadd_rn(pe[0], pe[4]), __fadd_rn(pe[2], pe[6])),
        __fadd_rn(__fadd_rn(pe[1], pe[5]), __fadd_rn(pe[3], pe[7])));
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) {
      if (w < nw) {
        excess = max_nan(excess, p.excess[b][lane][w]);
        bursts += p.bursts[b][lane][w];
      }
    }
  }
  flux = bursts < 2 ? 0.0f : flux;                       // silence gate
  const float velocity = min_nan(
      max_nan(
          __fmul_rn(max_nan(flux, __fmul_rn(excess, 5.0f)), 1.0f / 50.0f),
          0.0f),
      1.0f);
  flags |= (excess > 3.0f && bursts >= 3) ? 1u : 0u;
  c.flux[lane] = make_float4(flux, energy,
                             __fmul_rn(flux, __fsub_rn(1.0f, 0.84f)),
                             __fmul_rn(flux, __fsub_rn(1.0f, 0.89f)));
  c.ema[lane] = make_float4(__fmul_rn(energy, __fsub_rn(1.0f, 0.84f)),
                            __fmul_rn(energy, __fsub_rn(1.0f, 0.95f)),
                            __uint_as_float(flags), 0.0f);
  __syncwarp();

  // The decisions stay in registers as bit masks (bit k: frame k), so no
  // store comes between one frame's loads and the next.  The counter is
  // rebuilt from the reset mask: frame f's counter is f - j - 1 after the
  // last reset j < f, or the tile's first counter + f.
  const int since_tile = since;
  unsigned det_bits = 0u, rising_bits = 0u, fired_bits = 0u, reset_bits = 0u;
  auto frame = [&](int k) {
    const float4 fx = c.flux[k], em = c.ema[k];
    const float fk = fx.x, ek = fx.y;
    const unsigned gk = __float_as_uint(em.z);
    const bool e_up = ek > ema;
    ema = fmaf(ema, e_up ? 0.84f : 0.95f, e_up ? em.x : em.y);
    const bool is_onset = fk > thr;
    thr = fmaxf(fmaf(thr, is_onset ? 0.84f : 0.89f, is_onset ? fx.z : fx.w),
                0.9f);
    const bool det =
        is_onset && fk > __fmul_rn(thr, 1.5f) && (gk & 1u) != 0u;
    const bool rising = ek > __fmul_rn(ema, 1.5f);
    const bool fired = det && (gk & 2u) == 0u && rising && since >= REFRACTORY;
    const bool reset =
        (fired && (gk & 4u) == 0u) || (det && since < REFRACTORY);
    const unsigned bit = 1u << k;
    det_bits |= det ? bit : 0u;
    rising_bits |= rising ? bit : 0u;
    fired_bits |= fired ? bit : 0u;
    reset_bits |= reset ? bit : 0u;
    since = reset ? 0 : since + 1;
  };
  // A full tile is unrolled, so the compiler overlaps one frame's gates
  // with the next frame's EMA and threshold.
  if (nt == TF) {
#pragma unroll
    for (int k = 0; k < TF; ++k) frame(k);
  } else {
    for (int k = 0; k < nt; ++k) frame(k);
  }
  const unsigned before = reset_bits & ((1u << lane) - 1u);
  const int my_since =
      before ? lane - (31 - __clz(before)) - 1 : since_tile + lane;
  if (live) {
    const long long o = f0 + lane;
    o_fired[o] = (fired_bits >> lane) & 1u;
    o_det[o] = (det_bits >> lane) & 1u;
    o_vel[o] = velocity;
    o_flux[o] = flux;
    o_energy[o] = energy;
    o_bursts[o] = bursts;
    o_rising[o] = (rising_bits >> lane) & 1u;
    o_since[o] = my_since;
  }
}

// The chain warp's tick and hold bits for frames [f0, f0 + nt), by lane.
__device__ __forceinline__ unsigned tick_hold(const uint8_t* __restrict__ ts,
                                              const uint8_t* __restrict__ hold,
                                              long long f0, int nt) {
  const int lane = threadIdx.x & 31;
  if (lane >= nt) return 0u;
  return (ts[f0 + lane] != 0 ? 2u : 0u) | (hold[f0 + lane] != 0 ? 4u : 0u);
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, L::BLOCKS)
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
  constexpr int NBUF = L::NBUF, AHEAD = L::AHEAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Partials<NBUF>& p = *reinterpret_cast<Partials<NBUF>*>(smem_raw);
  const int nw = (H + 31) / 32;
  const int nb = nw * 32;                         // bin threads
  const int ms = nb + 4;                          // a tile row's stride
  float* mt = reinterpret_cast<float*>(&p + 1);   // [NBUF][TF][ms] mags
  float* scratch = mt + NBUF * TF * ms;           // [nw][2][TF][stride]
                                                  // then the chain's tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x;                       // the block's stream
  const long long row = (long long)s * N;         // its first frame
  const int ntiles = (N + TF - 1) / TF;

  // Warp slots no bin warp writes stay +0.0, and so do the tile rows' pad
  // bins (no staging writes them): the tree's pads.
  for (int k = threadIdx.x; k < 2 * TF * SLOTS; k += blockDim.x) {
    (&p.flux[0][0][0])[k] = 0.0f;
    (&p.energy[0][0][0])[k] = 0.0f;
  }
  for (int r = warp; r < NBUF * TF; r += nw + 1)
    for (int c = H + lane; c < ms; c += 32) mt[r * ms + c] = 0.0f;

  if (warp < nw) {                                // bin warps
    const int i = threadIdx.x;                    // the bin
    const bool real = i < H;
    const bool smoothed = i > 0 && i < H - 1;      // not an edge bin
    const float weight =
        real ? fmaf(-static_cast<float>(i), __frcp_rn(static_cast<float>(H)),
                    1.0f)
             : 0.0f;
    float prev = real ? prev0[(long long)s * H + i] : 0.0f;
    float floor = real ? floor0[(long long)s * H + i] : 0.0f;
    bool init = init0[s] != 0;
    float* contribs = scratch + warp * 2 * TF * SCRATCH_STRIDE;
    float* dens = contribs + TF * SCRATCH_STRIDE;  // -den where a burst
    if (!real)
      for (int f = 0; f < TF; ++f) {              // pads: no flux, ratio 0
        contribs[f * SCRATCH_STRIDE + lane] = 0.0f;
        dens[f * SCRATCH_STRIDE + lane] = 1.0f;
      }
    // AHEAD tiles in flight; one commit group a tile (empty past the end).
    for (int k = 0; k < AHEAD; ++k) {
      if (k < ntiles)
        stage_tile(mt, p, k, row + k * TF, min(TF, N - k * TF), H, ms, nb,
                   mags, gf);
      cp_async_commit();
    }
    cp_async_wait_ahead<AHEAD>();
    block_sync();
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1, buf = t % NBUF;
      const int nt = min(TF, N - t * TF);
      if (t + AHEAD < ntiles)
        stage_tile(mt, p, (t + AHEAD) % NBUF, row + (t + AHEAD) * TF,
                   min(TF, N - (t + AHEAD) * TF), H, ms, nb, mags, gf);
      cp_async_commit();
      const float* tile = mt + buf * TF * ms;
      if (real) {
        // Phase 1: for each frame, the floor recurrence (the one chain,
        // with no division on it: burst_limit does not depend on it),
        // keeping the divisor for the ratios (negated where the bin
        // bursts), and the flux contribution.
        const int li = smoothed ? i - 1 : i, ri = smoothed ? i + 1 : i;
        auto bin_frame = [&](int f, float m, float l, float r, float g) {
          const float limit = burst_limit(m);
          const float f0 = init ? floor : max_nan(m, g);
          const float den = max_nan(f0, max_nan(g, 0.01f));
          const bool burst = den < limit;
          const float d = __fsub_rn(m, f0);
          floor = burst ? __fmul_rn(m, 1.3f)
                        : fmaf(m > f0 ? 0.1f : 0.04f, d, f0);
          init = true;
          dens[f * SCRATCH_STRIDE + lane] =
              m != m ? m : (burst ? -den : den);
          const float sm =
              smoothed ? __fmul_rn(__fadd_rn(__fadd_rn(l, m), r), 1.0f / 3.0f)
                       : m;
          const float diff = __fsub_rn(sm, prev);
          contribs[f * SCRATCH_STRIDE + lane] =
              diff > 0.0f ? __fmul_rn(diff, weight) : 0.0f;
          prev = m;
        };
        if (nt == TF) {
          // A full tile in chunks of CHUNK frames, each chunk's loads
          // issued before the previous chunk's work: the compiler does
          // not move a shared-memory load above a shared-memory store, so
          // loads issued frame by frame would each wait out their latency.
          float cm[CHUNK], cl[CHUNK], cr[CHUNK], cg[CHUNK];
          auto load = [&](int f0, float* m, float* l, float* r, float* g) {
#pragma unroll
            for (int u = 0; u < CHUNK; ++u) {
              const float* mf = tile + (f0 + u) * ms;
              m[u] = mf[i];
              l[u] = mf[li];
              r[u] = mf[ri];
              g[u] = p.gfloor[buf][f0 + u];
            }
          };
          load(0, cm, cl, cr, cg);
#pragma unroll
          for (int c0 = 0; c0 < TF; c0 += CHUNK) {
            float nm[CHUNK], nl[CHUNK], nr[CHUNK], ng[CHUNK];
            if (c0 + CHUNK < TF) load(c0 + CHUNK, nm, nl, nr, ng);
#pragma unroll
            for (int u = 0; u < CHUNK; ++u)
              bin_frame(c0 + u, cm[u], cl[u], cr[u], cg[u]);
#pragma unroll
            for (int u = 0; u < CHUNK; ++u) {
              cm[u] = nm[u];
              cl[u] = nl[u];
              cr[u] = nr[u];
              cg[u] = ng[u];
            }
          }
        } else {
          for (int f = 0; f < nt; ++f) {
            const float* mf = tile + f * ms;
            bin_frame(f, mf[i], mf[li], mf[ri], p.gfloor[buf][f]);
          }
        }
      }
      __syncwarp();
      // Phase 2: lane f reduces frame f over the warp's 32 bins: the
      // flux and energy trees, the burst count, and the largest ratio, as
      // a tournament of exact comparisons and one division.
      if (lane < nt) {
        const float4* m4 =
            reinterpret_cast<const float4*>(tile + lane * ms + warp * 32);
        const float4* d4 =
            reinterpret_cast<const float4*>(dens + lane * SCRATCH_STRIDE);
        float wm[16], wd[16];
        int cnt = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 ma = m4[q], mb = m4[q + 4];
          const float4 da = d4[q], db = d4[q + 4];
          cnt += (da.x < 0.0f) + (da.y < 0.0f) + (da.z < 0.0f) +
                 (da.w < 0.0f) + (db.x < 0.0f) + (db.y < 0.0f) +
                 (db.z < 0.0f) + (db.w < 0.0f);
          wm[4 * q] = ma.x;
          wm[4 * q + 1] = ma.y;
          wm[4 * q + 2] = ma.z;
          wm[4 * q + 3] = ma.w;
          wd[4 * q] = fabsf(da.x);
          wd[4 * q + 1] = fabsf(da.y);
          wd[4 * q + 2] = fabsf(da.z);
          wd[4 * q + 3] = fabsf(da.w);
          keep_larger(wm[4 * q], wd[4 * q], mb.x, fabsf(db.x));
          keep_larger(wm[4 * q + 1], wd[4 * q + 1], mb.y, fabsf(db.y));
          keep_larger(wm[4 * q + 2], wd[4 * q + 2], mb.z, fabsf(db.z));
          keep_larger(wm[4 * q + 3], wd[4 * q + 3], mb.w, fabsf(db.w));
        }
        halve_ratio<8>(wm, wd);
        halve_ratio<4>(wm, wd);
        halve_ratio<2>(wm, wd);
        halve_ratio<1>(wm, wd);
        p.flux[b][lane][warp] = tree32(contribs + lane * SCRATCH_STRIDE);
        p.energy[b][lane][warp] = tree32(tile + lane * ms + warp * 32);
        p.excess[b][lane][warp] = div_guarded(wm[0], wd[0]);
        p.bursts[b][lane][warp] = cnt;
      }
      cp_async_wait_ahead<AHEAD>();
      block_sync();
    }
    if (real) {
      prev1[(long long)s * H + i] = prev;
      floor1[(long long)s * H + i] = floor;
    }
    if (threadIdx.x == 0) init1[s] = init ? 1 : 0;
    return;
  }

  // The chain warp, a tile behind the bin warps.
  Chain& c =
      *reinterpret_cast<Chain*>(scratch + nw * 2 * TF * SCRATCH_STRIDE);
  float thr = thr0[s], ema = ema0[s];
  int since = since0[s];
  unsigned flags = tick_hold(ts, hold, row, min(TF, N));
  block_sync();
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0) {
      const unsigned next = tick_hold(ts, hold, row + t * TF,
                                      min(TF, N - t * TF));
      chain_tile(p, c, (t - 1) & 1, row + (t - 1) * TF, TF, nw, flags, thr,
                 ema, since, o_fired, o_det, o_vel, o_flux, o_energy,
                 o_bursts, o_rising, o_since);
      flags = next;
    }
    block_sync();
  }
  if (ntiles > 0)
    chain_tile(p, c, (ntiles - 1) & 1, row + (ntiles - 1) * TF,
               N - (ntiles - 1) * TF, nw, flags, thr, ema, since, o_fired,
               o_det, o_vel, o_flux, o_energy, o_bursts, o_rising, o_since);
  if (lane == 0) {
    thr1[s] = thr;
    ema1[s] = ema;
    since1[s] = since;
  }
}

// A block's dynamic shared memory: the partials, the chain's tile, NBUF
// magnitude tiles of rows ms = nb + 4 floats, and the bin warps' scratch
// (97,536 B for Packed at H = 129; 216,576 B for Wide at H = 256).
template <class L>
int smem_bytes(int H) {
  const int nw = (H + 31) / 32;
  const int ms = nw * 32 + 4;
  return static_cast<int>(sizeof(Partials<L::NBUF>) + sizeof(Chain)) +
         (L::NBUF * TF * ms + nw * 2 * TF * SCRATCH_STRIDE) *
             static_cast<int>(sizeof(float));
}

template <class L>
cudaError_t set_smem(int H) {
  return cudaFuncSetAttribute(onset_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<L>(H));
}

template <class L>
cudaError_t launch(const float* mags, const float* gf, const uint8_t* ts,
                   const uint8_t* hold, const float* prev0,
                   const float* floor0, const uint8_t* init0,
                   const float* thr0, const float* ema0, const int* since0,
                   uint8_t* o_fired, uint8_t* o_det, float* o_vel,
                   float* o_flux, float* o_energy, int* o_bursts,
                   uint8_t* o_rising, int* o_since, float* prev1,
                   float* floor1, uint8_t* init1, float* thr1, float* ema1,
                   int* since1, int S, int N, int H, cudaStream_t stream) {
  const cudaError_t e = set_smem<L>(H);
  if (e != cudaSuccess) return e;
  onset_kernel<L><<<S, 32 * ((H + 31) / 32 + 1), smem_bytes<L>(H), stream>>>(
      mags, gf, ts, hold, prev0, floor0, init0, thr0, ema0, since0, o_fired,
      o_det, o_vel, o_flux, o_energy, o_bursts, o_rising, o_since, prev1,
      floor1, init1, thr1, ema1, since1, N, H);
  return cudaGetLastError();
}

template <class L>
cudaError_t blocks_per_sm(int H, int* blocks) {
  const cudaError_t e = set_smem<L>(H);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, onset_kernel<L>, 32 * ((H + 31) / 32 + 1), smem_bytes<L>(H));
}

// The instantiation that takes a block of H bins.
bool packed(int H) { return (H + 31) / 32 <= PACKED_WARPS; }

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
  const auto go = packed(H) ? &launch<Packed> : &launch<Wide>;
  return static_cast<int>(go(
      mags, gf, ts, hold, prev0, floor0, init0, thr0, ema0, since0, o_fired,
      o_det, o_vel, o_flux, o_energy, o_bursts, o_rising, o_since, prev1,
      floor1, init1, thr1, ema1, since1, S, N, H,
      static_cast<cudaStream_t>(stream)));
}

// The blocks of H bins that stay resident on one SM, as the occupancy
// calculator reports them for the block and shared bytes that H takes,
// into *blocks; returns the CUDA error code (0 on success).
int aat_onset_blocks_per_sm(int H, int* blocks) {
  if (H < 2 || H > 32 * MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(packed(H) ? blocks_per_sm<Packed>(H, blocks)
                                    : blocks_per_sm<Wide>(H, blocks));
}

}  // extern "C"
