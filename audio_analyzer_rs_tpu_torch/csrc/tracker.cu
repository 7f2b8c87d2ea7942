// K3: the batched PitchTracker scan with its stable top-8 fused in
// (ref src/audio_io/stft.rs:20-117).  Replaces the Pallas kernel
// audio_analyzer_rs_tpu/ops/pallas_tracker.py `_kernel` (launched by
// `tracker_scan_pallas`) and the `select_stable` the JAX path runs on its
// per-slot emissions.
//
// What bounds it on an H100: the dependent chain, not bytes or operations.
// A stream is a serial recurrence over N frames, each 8 greedy match rounds
// over 24 track slots; at S = 128 x N = 64 the launch moves ~1.3 MB (under
// 0.4 us of HBM time).  So the design takes everything it can off the chain:
//  - A block a stream, so no two chains share an SM's issue slots: one
//    chain warp, one track slot a lane, the state in registers for all N
//    frames, and HELPERS helper warps.  The helpers stage the stream's
//    raws and onsets, a tile of 64 frames at a time, into shared memory
//    (cp.async for the floats), double-buffered: the next tile arrives
//    while the chain runs on this one, and the chain never waits on device
//    memory.
//  - The chain writes each frame's 24 slot freq, score and key to shared
//    memory.  While it runs a tile, the helpers run `select_stable` on the
//    tile before it, a thread a frame, and write [tile, 8] freq, score and
//    valid; the per-slot emissions never reach device memory.
//  - The match test |f - r| / max(|f|, 1e-30) < 0.03f is decided exactly
//    without the division (REL_MID below): one product in double a slot,
//    then 8 float compares.
//  - The 8 greedy rounds run on warp-uniform bitmasks in "rank space": each
//    live track holds a bit at its rank in creation order (seq, slot).  One
//    OR-reduction a raw, all 8 independent, gives the raw's candidates in
//    that order; a round is then "lowest set bit of candidates & ~taken",
//    four integer operations and no warp collective.  The ranks carry from
//    frame to frame with no sort: survivors keep their bit positions (gaps
//    are closed only when fewer than 8 positions are left) and spawns (seq =
//    next_seq + rank) take the next ones.  That holds for every state the
//    scan produces.  A state handed in with a valid seq >= next_seq, a
//    valid life < 1, or a next_seq that could overflow in this call takes
//    the generic rounds instead: a warp min over the candidates' seq and a
//    ballot for the lowest slot among the minima, the plain argmin exactly.
//
// Bit-exact to `tracker_scan_plain` followed by `select_stable`: the EMA is
// __fmul_rn/__fadd_rn (no FMA contraction), and spawned and selected values
// are written as v + 0.0f, as the plain masked sums give them (-0.0 ->
// +0.0).  Loops over raws and slots have fixed trip counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 24;                 // track slots per stream
constexpr int R = 8;                  // raw pitches per frame
constexpr int OUT = 8;                // stable pitches emitted per frame
constexpr int INT_MAX32 = 0x7fffffff;
constexpr int MAX_LIFE = 3;
constexpr int DISPLAY_THRESHOLD = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SLOT_MASK = (1u << T) - 1u;
constexpr int TILE = 64;              // frames a tile
constexpr int HELPERS = 3;            // helper warps a block
constexpr int KP = T + 1;             // emission row, padded: a thread a
                                      // frame reads its row conflict-free
// rel_ok <=> RN(a / d) < c, c = 0.03f <=> a / d < m, where m = c - 2^-30 is
// the midpoint of c and its float predecessor (c's ulp is 2^-29; a / d never
// equals m, which has 25 significant bits).  m * d is exact in double (25 +
// 24 bits), and for a float a, a < m * d <=> a < (m * d rounded up to a
// float).  NaN and infinity compare false on both sides.
constexpr double REL_MID = static_cast<double>(0.03f) - 0x1p-30;

struct __align__(16) ChainSmem {
  float rf[2][TILE * R];              // raw freqs, two tiles
  float rs[2][TILE * R];              // raw scores
  unsigned rw[2][TILE];               // bits 0-7 raw valid, bit 8 onset
  float ef[2][TILE * KP];             // emissions: slot freq
  float es[2][TILE * KP];             // slot score
  int ek[2][TILE * KP];               // slot key: seq if stable, else INT_MAX
  unsigned em[2][TILE];               // the frame's stable slots
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The whole block; the chain warps and the helpers reach it from their own
// branches, once a tile each.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// The match bound of a track at freq f: rel_ok <=> |f - r| < rel_bound(f).
__device__ __forceinline__ float rel_bound(float f) {
  return __double2float_ru(REL_MID *
                           static_cast<double>(fmaxf(fabsf(f), 1e-30f)));
}

__device__ __forceinline__ unsigned ld_shared(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// v[b2 b1 b0]: a 3-level select tree (no index arithmetic, no local memory).
__device__ __forceinline__ float pick8(const float (&v)[R], bool b0, bool b1,
                                       bool b2) {
  const float a0 = b0 ? v[1] : v[0], a1 = b0 ? v[3] : v[2];
  const float a2 = b0 ? v[5] : v[4], a3 = b0 ? v[7] : v[6];
  const float c0 = b1 ? a1 : a0, c1 = b1 ? a3 : a2;
  return b2 ? c1 : c0;
}

// Helpers: copy frames [t0, t0 + nt) of stream s into buffer b.
__device__ void stage_tile(ChainSmem& sm, int b, int t0, int nt, int s,
                           int N, int h, const float* __restrict__ rf,
                           const float* __restrict__ rs,
                           const uint8_t* __restrict__ rv,
                           const uint8_t* __restrict__ on) {
  constexpr int NH = HELPERS * 32;
  const long long base = (long long)s * N + t0;
  for (int k = h; k < nt * 2; k += NH) {         // 16 B chunks, 2 a frame
    cp_async16(&sm.rf[b][k * 4], rf + base * R + k * 4);
    cp_async16(&sm.rs[b][k * 4], rs + base * R + k * 4);
  }
  for (int k = h; k < nt; k += NH) {
    const uint2 v = *reinterpret_cast<const uint2*>(rv + (base + k) * R);
    unsigned w = on[base + k] != 0 ? 1u << R : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w |= ((v.x >> (8 * j)) & 0xffu) != 0 ? 1u << j : 0u;
      w |= ((v.y >> (8 * j)) & 0xffu) != 0 ? 1u << (4 + j) : 0u;
    }
    sm.rw[b][k] = w;
  }
}

// Helpers: select_stable over frames [t0, t0 + nt) from emission buffer b, a
// thread a frame: rank each slot by (key, slot), emit the stable slot of
// rank p at output p (p < 8), 0 / false where there is none.
__device__ void select_tile(const ChainSmem& sm, int b, int t0, int nt, int s,
                            int N, int h, float* __restrict__ of,
                            float* __restrict__ os, uint8_t* __restrict__ ov) {
  constexpr int NH = HELPERS * 32;
  for (int f = h; f < nt; f += NH) {
    const int* krow = &sm.ek[b][f * KP];
    int key[T], rank[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      key[i] = krow[i];
      rank[i] = 0;
    }
#pragma unroll
    for (int i = 1; i < T; ++i) {
#pragma unroll
      for (int k = 0; k < i; ++k) {
        const bool k_first = key[k] <= key[i];   // k < i breaks a tie
        rank[i] += k_first ? 1 : 0;
        rank[k] += k_first ? 0 : 1;
      }
    }
    const unsigned stable = sm.em[b][f];
    int sel[OUT];
#pragma unroll
    for (int p = 0; p < OUT; ++p) sel[p] = -1;
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int p = 0; p < OUT; ++p)
        if (((stable >> i) & 1u) && rank[i] == p) sel[p] = i;
    }
    float fo[OUT], so[OUT];
    unsigned vo[2] = {0u, 0u};
#pragma unroll
    for (int p = 0; p < OUT; ++p) {
      const bool hit = sel[p] >= 0;
      const int at = f * KP + (hit ? sel[p] : 0);
      fo[p] = hit ? sm.ef[b][at] + 0.0f : 0.0f;
      so[p] = hit ? sm.es[b][at] + 0.0f : 0.0f;
      vo[p / 4] |= (hit ? 1u : 0u) << (8 * (p % 4));
    }
    const long long o = ((long long)s * N + t0 + f) * OUT;
    float4* fd = reinterpret_cast<float4*>(of + o);
    float4* sd = reinterpret_cast<float4*>(os + o);
    fd[0] = make_float4(fo[0], fo[1], fo[2], fo[3]);
    fd[1] = make_float4(fo[4], fo[5], fo[6], fo[7]);
    sd[0] = make_float4(so[0], so[1], so[2], so[3]);
    sd[1] = make_float4(so[4], so[5], so[6], so[7]);
    *reinterpret_cast<uint2*>(ov + o) = make_uint2(vo[0], vo[1]);
  }
}

__global__ void __launch_bounds__((1 + HELPERS) * 32, 1)
tracker_select_kernel(const float* __restrict__ rf,
                      const float* __restrict__ rs,
                      const uint8_t* __restrict__ rv,
                      const uint8_t* __restrict__ on,
                      const float* __restrict__ f0,
                      const float* __restrict__ s0_,
                      const int* __restrict__ l0,
                      const uint8_t* __restrict__ v0,
                      const int* __restrict__ q0, const int* __restrict__ n0,
                      float* __restrict__ of, float* __restrict__ os,
                      uint8_t* __restrict__ ov, float* __restrict__ f1,
                      float* __restrict__ s1, int* __restrict__ l1,
                      uint8_t* __restrict__ v1, int* __restrict__ q1,
                      int* __restrict__ n1, int S, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem& my = *reinterpret_cast<ChainSmem*>(smem_raw);
  // spawn_at[u]: nibble r holds the position of the r-th set bit of the
  // 8-bit mask u, and 8 past its last set bit.
  unsigned* spawn_at = reinterpret_cast<unsigned*>(&my + 1);
  // Its shared-window address, kept in a register across the frame loop.
  unsigned spawn_at_s =
      static_cast<unsigned>(__cvta_generic_to_shared(spawn_at));
  asm volatile("" : "+r"(spawn_at_s));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x;                      // the block's stream
  const int ntiles = (N + TILE - 1) / TILE;

  if (warp > 0) {                                // helper warps
    const int h = threadIdx.x - 32;
    for (int u = h; u < 256; u += HELPERS * 32) {
      unsigned w = 0x88888888u;
      int r = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if ((u >> j) & 1) {
          const unsigned at = 4 * r++;
          w = (w & ~(0xfu << at)) | (static_cast<unsigned>(j) << at);
        }
      }
      spawn_at[u] = w;
    }
    if (ntiles > 0)
      stage_tile(my, 0, 0, min(TILE, N), s, N, h, rf, rs, rv, on);
    cp_async_wait_all();
    block_sync();
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles)
        stage_tile(my, (t + 1) & 1, (t + 1) * TILE,
                   min(TILE, N - (t + 1) * TILE), s, N, h, rf, rs, rv, on);
      if (t > 0)
        select_tile(my, (t - 1) & 1, (t - 1) * TILE, TILE, s, N, h, of, os,
                    ov);
      cp_async_wait_all();
      block_sync();
    }
    if (ntiles > 0)
      select_tile(my, (ntiles - 1) & 1, (ntiles - 1) * TILE,
                  N - (ntiles - 1) * TILE, s, N, h, of, os, ov);
    return;
  }

  // The chain warp.  The grid has one block a stream, so `live` is always
  // true; the chain stays inside it because nvcc 12.9 schedules the frame
  // loop better so (86 registers, not 91, and ~15% less time a frame on an
  // H100, measured against the same kernel without the branch).
  const bool live = s < S;                       // uniform across the warp
  const bool slot = lane < T;
  const unsigned below = (1u << lane) - 1u;      // lanes under this one
  const long long st = (long long)s * T + lane;

  float freq = 0.f, score = 0.f;
  int life = 0, seq = INT_MAX32, nseq = 0;
  bool valid = false, ordered = false;
  // Rank space (ordered streams only): a live track holds the bit `rbit` at
  // its position in creation order (seq, slot); `vmask` holds the live
  // tracks' bits.  Positions may have gaps, left by tracks that ended; new
  // tracks take the positions from `npos` up, and the gaps are closed when
  // fewer than 8 positions are left.
  unsigned rbit = 0u, vmask = 0u;
  int npos = 0;
  if (live) {
    if (slot) {
      freq = f0[st];
      score = s0_[st];
      life = l0[st];
      valid = v0[st] != 0;
      seq = q0[st];
    }
    nseq = n0[s];
    const bool off = slot && valid && (seq >= nseq || life < 1);
    ordered = !__any_sync(FULL, off) &&
              (long long)nseq + (long long)R * N <= INT_MAX32;
    if (ordered) {
      int r = 0;
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const int sk = __shfl_sync(FULL, seq, k);
        const bool vk = __shfl_sync(FULL, valid ? 1 : 0, k) != 0;
        r += (vk && (sk < seq || (sk == seq && k < lane))) ? 1 : 0;
      }
      rbit = (slot && valid) ? 1u << r : 0u;
      npos = __popc(__ballot_sync(FULL, slot && valid));
      vmask = (1u << npos) - 1u;
    }
  }
  float bound = rel_bound(freq);                 // the entry freq's, carried
  block_sync();

  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    const int nt = min(TILE, N - t * TILE);
    if (live) {
      float4 nf0 = *reinterpret_cast<const float4*>(&my.rf[b][0]);
      float4 nf1 = *reinterpret_cast<const float4*>(&my.rf[b][4]);
      float4 ns0 = *reinterpret_cast<const float4*>(&my.rs[b][0]);
      float4 ns1 = *reinterpret_cast<const float4*>(&my.rs[b][4]);
      unsigned nw = my.rw[b][0];
      for (int i = 0; i < nt; ++i) {
        const float rfv[R] = {nf0.x, nf0.y, nf0.z, nf0.w,
                              nf1.x, nf1.y, nf1.z, nf1.w};
        const float rsv[R] = {ns0.x, ns0.y, ns0.z, ns0.w,
                              ns1.x, ns1.y, ns1.z, ns1.w};
        const unsigned rvm = nw & 0xffu;
        const bool onset = ((nw >> R) & 1u) != 0;
        if (i + 1 < nt) {                        // the next frame, early
          const int nx = (i + 1) * R;
          nf0 = *reinterpret_cast<const float4*>(&my.rf[b][nx]);
          nf1 = *reinterpret_cast<const float4*>(&my.rf[b][nx + 4]);
          ns0 = *reinterpret_cast<const float4*>(&my.rs[b][nx]);
          ns1 = *reinterpret_cast<const float4*>(&my.rs[b][nx + 4]);
          nw = my.rw[b][i + 1];
        }

        // Phase 1: greedy matching on the entry state.
        const float f_entry = freq;
        const int life_inc = min(life + 1, MAX_LIFE);
        bool ok[R];
#pragma unroll
        for (int j = 0; j < R; ++j) ok[j] = fabsf(f_entry - rfv[j]) < bound;
        const bool is_free = slot && !valid;
        const unsigned free_mask = __ballot_sync(FULL, is_free);
        const int frank = __popc(free_mask & below);
        bool hit[R];                             // this track took raw j
        unsigned any_mask = 0u, taken = 0u, life1 = 0u;
        if (ordered) {
          unsigned cr[R], pb[R];
#pragma unroll
          for (int j = 0; j < R; ++j)
            cr[j] = __reduce_or_sync(FULL, ok[j] ? rbit : 0u);
          life1 = __reduce_or_sync(FULL, life <= 1 ? rbit : 0u);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const unsigned c = cr[j] & ~taken;
            pb[j] = ((rvm >> j) & 1u) ? (c & (0u - c)) : 0u;
            taken |= pb[j];
          }
#pragma unroll
          for (int j = 0; j < R; ++j) {
            any_mask |= pb[j] != 0u ? 1u << j : 0u;
            hit[j] = rbit != 0u && pb[j] == rbit;
          }
        } else {
          bool m = false;
          int mraw = -1;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const bool cand = slot && valid && !m && ok[j];
            const int key = cand ? seq : INT_MAX32;
            const int first = __reduce_min_sync(FULL, key);
            const bool am = __any_sync(FULL, cand) && ((rvm >> j) & 1u);
            const unsigned win = __ballot_sync(FULL, slot && key == first);
            any_mask |= am ? 1u << j : 0u;
            if (am && lane == __ffs(win) - 1) {
              mraw = j;
              m = true;
            }
          }
#pragma unroll
          for (int j = 0; j < R; ++j) hit[j] = mraw == j;
        }
        const bool matched = hit[0] || hit[1] || hit[2] || hit[3] || hit[4] ||
                             hit[5] || hit[6] || hit[7];

        // Phase 2: the r-th unmatched raw spawns into the r-th free slot.
        const unsigned um = rvm & ~any_mask;
        const unsigned at = frank < R ? (ld_shared(spawn_at_s + 4 * um) >>
                                         (4 * frank)) & 0xfu
                                      : 8u;
        const bool spawned = is_free && at < 8u;
        // The raw this slot takes: its spawn, else its match.
        const bool b0 = spawned ? (at & 1u) != 0
                                : hit[1] || hit[3] || hit[5] || hit[7];
        const bool b1 = spawned ? (at & 2u) != 0
                                : hit[2] || hit[3] || hit[6] || hit[7];
        const bool b2 = spawned ? (at & 4u) != 0
                                : hit[4] || hit[5] || hit[6] || hit[7];
        const float r_f = pick8(rfv, b0, b1, b2);
        const float r_s = pick8(rsv, b0, b1, b2);
        freq = spawned   ? r_f + 0.0f
               : !matched ? freq
               : onset    ? r_f
                          : __fadd_rn(__fmul_rn(f_entry, 0.6f),
                                      __fmul_rn(r_f, 0.4f));
        score = spawned ? r_s + 0.0f : matched ? r_s : score;
        const int n_spawn = min(__popc(um), __popc(free_mask));

        // Phase 3: misses decay, or are reaped on an onset.
        life = spawned   ? 1
               : matched ? life_inc
               : valid   ? (onset ? 0 : life - 1)
                         : life;
        seq = spawned ? nseq + frank : seq;
        nseq += n_spawn;
        valid = (valid || spawned) && life > 0;
        if (!valid) seq = INT_MAX32;
        bound = rel_bound(freq);
        const bool stable = valid && life >= DISPLAY_THRESHOLD;
        if (slot) {
          my.ef[b][i * KP + lane] = freq;
          my.es[b][i * KP + lane] = score;
          my.ek[b][i * KP + lane] = stable ? seq : INT_MAX32;
        }
        const unsigned smask = __ballot_sync(FULL, stable) & SLOT_MASK;
        if (lane == 0) my.em[b][i] = smask;

        // Rank space for the next frame: survivors keep their positions,
        // spawns take the next ones in rank order.
        if (ordered) {
          const unsigned died = (onset ? vmask : life1) & ~taken;
          const unsigned surv = vmask & ~died;
          rbit = (rbit & surv) != 0u ? rbit
                 : spawned           ? 1u << ((npos + frank) & 31)
                                     : 0u;
          vmask = surv | (((1u << n_spawn) - 1u) << npos);
          npos += n_spawn;
          if (npos > T) {                        // close the gaps
            rbit = rbit != 0u ? 1u << __popc(vmask & (rbit - 1u)) : 0u;
            npos = __popc(vmask);
            vmask = (1u << npos) - 1u;
          }
        }
      }
    }
    block_sync();
  }

  if (!live) return;
  if (slot) {
    f1[st] = freq;
    s1[st] = score;
    l1[st] = life;
    v1[st] = valid ? 1 : 0;
    q1[st] = seq;
  }
  if (lane == 0) n1[s] = nseq;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  Raws
// [S, N, 8] (freq and score 16-byte aligned, valid 8-byte aligned), onsets
// [S, N]; outputs [S, N, 8] (16-byte aligned).
int aat_tracker_select(const float* rf, const float* rs, const uint8_t* rv,
                       const uint8_t* on, const float* f0, const float* s0,
                       const int* l0, const uint8_t* v0, const int* q0,
                       const int* n0, float* of, float* os, uint8_t* ov,
                       float* f1, float* s1, int* l1, uint8_t* v1, int* q1,
                       int* n1, int S, int N, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const int smem =
      static_cast<int>(sizeof(ChainSmem)) + 256 * sizeof(unsigned);
  const cudaError_t e = cudaFuncSetAttribute(
      tracker_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tracker_select_kernel<<<S, (1 + HELPERS) * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      rf, rs, rv, on, f0, s0, l0, v0, q0, n0, of, os, ov, f1, s1, l1, v1, q1,
      n1, S, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
