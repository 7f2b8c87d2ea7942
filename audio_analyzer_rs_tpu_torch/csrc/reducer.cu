// K6: the reducer scan over B streams (ref src/audio_io/mod.rs:336-511):
// HPF 40 Hz -> LPF 14 kHz (RBJ biquads, direct form I) -> envelope-follower
// noise gate, sample by sample.  Replaces the `lax.scan`s of
// audio_analyzer_rs_tpu/ops/reducer.py `reduce_signal` (:215, the exact
// mode) and `noise_gate` (:153, the fast mode's gate: the gate-only entry
// here), which XLA compiles to device loops; they have no Pallas twin.
// Bitwise equal to `reduce_exact_plain` / `gate_plain` (ops/reducer.py).
//
// What bounds it on an H100: the chain.  A stream is T dependent steps;
// each stage carries its own cycle: a biquad's two feedback FMAs (y1 ->
// fma -> fma -> y1), the envelope's compare and select (the longest, ~10
// cycles a sample).  The bytes (2 x B x T x 4) are small beside the chain
// at any B the full step uses.  So a block is ROWS streams, a lane a
// stream, and a warp a stage, the stages running as a pipeline over tiles
// of TILE samples in a ring of NSLOTS slots in shared memory:
//  - the producer warp brings each tile in by TMA (one elected thread, a
//    2-D box of ROWS streams x 32 samples at a time from a tensor map over
//    x [B, T], completion on the slot's "full" mbarrier) and, once the
//    hold's warp has gated it, sends it back by TMA stores;
//  - the HPF's and the LPF's warps filter the slot in place, each keeping
//    its biquad's state in registers;
//  - the gate runs on three warps: the envelope's (its chain alone, into
//    a second ring), the low warp's (the gain below the threshold,
//    (((env*env)*env)*env) * GAIN_SCALE, into a third), and the hold's
//    (the hold and the gated samples, into the slot);
//  - each warp waits only on its producers' mbarriers and arrives on its
//    own: there is no block barrier in the loop, so a stage runs ahead of
//    the next by up to the ring's depth and a sample costs about the
//    slowest stage's issue, not the sum of the stages.
// Each warp runs a pass of CHUNK samples in a loop that is not unrolled:
// the six warps' loop bodies together stay within the instruction cache
// (unrolled over the 128-sample tile, the kernel ran about twice as
// slowly), and a pass reads its row before it writes (the slot is updated
// in place, and a read after a write to it would wait for the write).  16
// streams a block: 32 would not fit the rings of 128-sample tiles in
// shared memory, and 8 ran as fast.
// The slots hold each box as TMA's 128-byte swizzle lays it out: stream r's
// 16-byte chunk c at chunk c ^ (r % 8) of its 128-byte row, so a warp's
// 16-byte reads of one chunk of its rows hit distinct bank groups in each
// 8-lane phase.  TMA fills rows past B and samples past T with zeros and
// leaves them out of the stores, so partial tiles and blocks need no code
// of their own.  A tensor map needs 16-byte row strides: where T % 4 != 0
// (or x or y is not 16-byte aligned) the producer copies the tiles in and
// out with plain loads and stores, into and from the same layout.  The
// tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint.
//
// The hold counter, as a count: the plain gate's hold is set to
// hold_samples at an attack and loses one for each sample below the
// threshold while it is positive.  Here the hold's warp counts the samples
// below the threshold (z, rebased to 0 at each tile) and keeps the count
// at which the hold runs out (lim = z + hold_samples at an attack, or the
// carried hold at the start); a sample is held while z < lim.  Within a
// tile both run as exact floats: z's carried chain is one add of a 0 or 1
// chosen off it, lim's one select; the compare that gates the sample is
// off them.  The hold out is max(lim - z, 0) (a carried hold below 0 holds
// nothing and comes out as 0, as in the plain gate).
//
// Rounding, as the plain version (and XLA:CPU's JAX scan) does it: each
// biquad is fma(-a2, y2, fma(-a1, y1, fma(b2, x2, fma(b0, x, b1*x1)))); the
// release blend is fma(rel, env, (1 - rel)*|l|); the gain below the
// threshold is (((env*env)*env)*env) * GAIN_SCALE, the float32 constant
// XLA folds (1/threshold)^4 into.  The products that are not fused spell
// __fmul_rn (nvcc would contract them otherwise).  The coefficients,
// which depend on the sample rate, come in as float32 values; the two
// constants that do not are hex floats (tests/test_torch_reducer.py reads
// them from this file).
//
// NaN, as the plain version does it: a NaN sample makes the biquads' state
// NaN from then on; the gate's compares with a NaN are false, so its
// envelope stays NaN and its gain is 1 inside the hold, NaN after it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                       // samples a tile
constexpr int BOX = 32;                         // a TMA box's samples
constexpr int CHUNK = 32;                       // samples a row pass
constexpr int ROWS = 16;                        // streams a block (and box)
constexpr int NSLOTS = 10;                      // the sample ring's slots
constexpr int NGATE = 4;                        // the envelope ring's slots
constexpr int THREADS = 6 * 32;
constexpr int SLOT_FLOATS = ROWS * TILE;        // TILE / BOX boxes
constexpr float THRESHOLD = 0x1.0624dep-10f;    // float32(10^(-60/20))
constexpr float GAIN_SCALE = 0x1.d1a942p+39f;   // float32 (1/threshold)^4

// The warps' roles.
// Warp w issues from scheduler w % 4: the envelope's warp (the longest
// chain) and the hold's have a scheduler each; the producer, which mostly
// waits, shares one with the HPF, and the low warp one with the LPF.
constexpr int HPF_WARP = 0, LPF_WARP = 1, HOLD_WARP = 2, ENV_WARP = 3,
              LOAD_WARP = 4, LOW_WARP = 5;

struct Params {
  float hb0, hb1, hb2, ha1, ha2;     // the HPF's coefficients
  float lb0, lb1, lb2, la1, la2;     // the LPF's
  float rel, c1;                     // release coefficient, 1 - rel
  int hold_samples;
};

// Dynamic shared memory, from a 1,024-byte aligned base (TMA's 128-byte
// swizzle repeats every 1,024 bytes): the rings, then the mbarriers.
struct Shared {
  float data[NSLOTS][SLOT_FLOATS];   // samples in, filtered in place, out
  float env[NGATE][SLOT_FLOATS];     // the envelope: ENV -> LOW, HOLD
  float low[NGATE][SLOT_FLOATS];     // its gain below the threshold
  uint64_t full[NSLOTS];             // producer -> HPF
  uint64_t hpf_done[NSLOTS];         // HPF -> LPF
  uint64_t lpf_done[NSLOTS];         // LPF -> the gate's warps
  uint64_t gated[NSLOTS];            // the hold's warp -> producer
  uint64_t env_full[NGATE];          // ENV -> LOW and HOLD
  uint64_t low_full[NGATE];          // LOW -> HOLD
  uint64_t env_empty[NGATE];         // HOLD -> ENV and LOW
};
constexpr size_t SMEM_BYTES = sizeof(Shared) + 1024;

struct Biquad {
  float x1, x2, y1, y2;
};

// The float offset in a slot of row r's samples 4q..4q+3: box q / 8, the
// row's 16-byte chunk (q % 8) ^ (r % 8).
__device__ __forceinline__ int chunk(int r, int q) {
  return (q >> 3) * (ROWS * BOX) + r * BOX + (((q & 7) ^ (r & 7)) << 2);
}

__device__ __forceinline__ int elem(int r, int j) {
  return chunk(r, j >> 2) + (j & 3);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem(bar)) : "memory");
}

// Arrive and expect `bytes` more from TMA.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Whether the barrier's phase of parity `parity` has completed (no wait).
__device__ __forceinline__ bool bar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n"
               " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}"
               : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  return done != 0;
}

// The box at (sample c0, stream c1) of `map` into shared memory, counted
// on `bar`'s transactions.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem(bar)) : "memory");
}

// A box from shared memory to (sample c0, stream c1) of `map`, in this
// thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, const float* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem(src)) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until none of this thread's bulk groups still reads shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// This thread's shared-memory writes, before an async-proxy (TMA) read.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Row r's samples [4 q0, 4 q0 + 4 Q) of a slot into v (the chunks below n).
template <int Q, bool FULL>
__device__ __forceinline__ void load_row(const float* slot, int r, int q0,
                                         int n, float* v) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (FULL || 4 * (q0 + q) < n) {
      const float4 t = ld4(slot + chunk(r, q0 + q));
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

template <int Q, bool FULL>
__device__ __forceinline__ void store_row(float* slot, int r, int q0, int n,
                                          const float* v) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (FULL || 4 * (q0 + q) < n) st4(slot + chunk(r, q0 + q), v + 4 * q);
  }
}

// HPF_WARP and LPF_WARP: a biquad over row r of a slot, in place:
// fma(-a2, y2, fma(-a1, y1, f)) with f = fma(b2, x2, fma(b0, x, b1*x1)).
// CHUNK samples at a time (the chunk loop is not unrolled: each warp's
// loop body stays small enough for the instruction cache, which the five
// warps' bodies share): the feed-forward f of every sample first (no
// carried chain; last sample first, so that each x is read before f
// overwrites it), then the feedback, whose two FMAs a sample then issue
// back to back.
template <bool FULL>
__device__ __forceinline__ void biquad_row(float* slot, int r, int n,
                                           Biquad& bq, float b0, float b1,
                                           float b2, float a1, float a2) {
#pragma unroll 1
  for (int c0 = 0; c0 < (FULL ? TILE : n); c0 += CHUNK) {
    float v[CHUNK];
    load_row<CHUNK / 4, FULL>(slot, r, c0 / 4, n, v);
    float x1 = bq.x1, x2 = bq.x1;          // the new carried inputs
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      if (FULL || c0 + j < n) {
        const float x = v[j];
        if (FULL ? j == CHUNK - 1 : c0 + j == min(n, c0 + CHUNK) - 1) x1 = x;
        if (FULL ? j == CHUNK - 2 : c0 + j == min(n, c0 + CHUNK) - 2) x2 = x;
        const float xm1 = j >= 1 ? v[j - 1] : bq.x1;
        const float xm2 = j >= 2 ? v[j - 2] : j == 1 ? bq.x1 : bq.x2;
        v[j] = fmaf(b2, xm2, fmaf(b0, x, __fmul_rn(b1, xm1)));
      }
    }
    bq.x1 = x1;
    bq.x2 = x2;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (FULL || c0 + j < n) {
        const float y = fmaf(-a2, bq.y2, fmaf(-a1, bq.y1, v[j]));
        bq.y2 = bq.y1;
        bq.y1 = y;
        v[j] = y;
      }
    }
    store_row<CHUNK / 4, FULL>(slot, r, c0 / 4, n, v);
  }
}

// ENV_WARP: the envelope over row r (l, after the biquads) into env.
template <bool FULL>
__device__ __forceinline__ void envelope_row(const float* slot, float* env,
                                             int r, int n, float& e,
                                             float rel, float c1) {
#pragma unroll 1
  for (int c0 = 0; c0 < (FULL ? TILE : n); c0 += CHUNK) {
    float l[CHUNK];
    load_row<CHUNK / 4, FULL>(slot, r, c0 / 4, n, l);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (FULL || c0 + j < n) {
        const float a = fabsf(l[j]);
        const bool attack = a > e;
        const float blend = fmaf(rel, e, __fmul_rn(c1, a));
        e = attack ? a : blend;
      }
      l[j] = e;
    }
    store_row<CHUNK / 4, FULL>(env, r, c0 / 4, n, l);
  }
}

// LOW_WARP: the gain below the threshold, (((e*e)*e)*e) * GAIN_SCALE, of
// each envelope value of row r, into low.
template <bool FULL>
__device__ __forceinline__ void low_row(const float* env, float* low, int r,
                                        int n) {
#pragma unroll 1
  for (int c0 = 0; c0 < (FULL ? TILE : n); c0 += CHUNK) {
    float v[CHUNK];
    load_row<CHUNK / 4, FULL>(env, r, c0 / 4, n, v);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      v[j] = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(v[j], v[j]), v[j]),
                                 v[j]), GAIN_SCALE);
    store_row<CHUNK / 4, FULL>(low, r, c0 / 4, n, v);
  }
}

// HOLD_WARP: the hold and the gated samples over row r, in place.  env_prev:
// the envelope before the row's first sample; z, lim: the hold's count
// (see the note at the top), here as floats (the counts are below 2^24,
// so exact): z's chain is one FADD of a 0 or 1 chosen off it, lim's one
// select.
template <bool FULL>
__device__ __forceinline__ void hold_row(float* slot, const float* env,
                                         const float* low, int r, int n,
                                         float& env_prev, float& z,
                                         float& lim, float hold_samples) {
#pragma unroll 1
  for (int c0 = 0; c0 < (FULL ? TILE : n); c0 += CHUNK) {
    float v[CHUNK], e[CHUNK], g[CHUNK];
    load_row<CHUNK / 4, FULL>(slot, r, c0 / 4, n, v);
    load_row<CHUNK / 4, FULL>(env, r, c0 / 4, n, e);
    load_row<CHUNK / 4, FULL>(low, r, c0 / 4, n, g);
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (FULL || c0 + k < n) {
        const bool attack = fabsf(v[k]) > env_prev;
        const bool above = e[k] >= THRESHOLD;
        lim = attack ? __fadd_rn(z, hold_samples) : lim;
        const bool keep = above || z < lim;
        v[k] = __fmul_rn(v[k], keep ? 1.0f : g[k]);
        z = __fadd_rn(z, above ? 0.0f : 1.0f);
        env_prev = e[k];
      }
    }
    store_row<CHUNK / 4, FULL>(slot, r, c0 / 4, n, v);
  }
}

// A block: ROWS streams, six warps (see the note at the top).  GATE_ONLY:
// the biquads' warps pass the samples through.  BULK: x and y move by TMA.
template <bool GATE_ONLY, bool BULK>
__global__ void __launch_bounds__(THREADS)
reducer_kernel(const float* __restrict__ x, float* __restrict__ y,
               const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap ymap,
               const float* __restrict__ st_in,
               const int32_t* __restrict__ hold_in,
               float* __restrict__ st_out, int32_t* __restrict__ hold_out,
               int B, int T, Params p) {
  extern __shared__ unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(
      smem_raw + ((1024 - (smem(smem_raw) & 1023)) & 1023));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * ROWS;        // the block's first stream
  const int b = b0 + lane;                 // this lane's stream
  const int rows = min(ROWS, B - b0);
  const bool row_lane = lane < ROWS;       // the lanes past ROWS idle
  const bool live = row_lane && b < B;
  const int tiles = (T + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSLOTS; ++i) {
      bar_init(&sh.full[i], BULK ? 1 : 32);
      bar_init(&sh.hpf_done[i], 32);
      bar_init(&sh.lpf_done[i], 32);
      bar_init(&sh.gated[i], 32);
    }
    for (int i = 0; i < NGATE; ++i) {
      bar_init(&sh.env_full[i], 32);
      bar_init(&sh.low_full[i], 32);
      bar_init(&sh.env_empty[i], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const float* s_in = st_in + (long long)b * 9;
  float* s_out = st_out + (long long)b * 9;
  if (warp == LOAD_WARP) {
    // Tile t's store, once the hold's warp has gated it (by TMA from lane
    // 0, or plain stores from the warp).
    auto store = [&](int t) {
      const int i = t % NSLOTS;
      bar_wait(&sh.gated[i], (t / NSLOTS) & 1);
      const int t0 = t * TILE;
      const int n = min(TILE, T - t0);
      const float* slot = sh.data[i];
      if (BULK) {
        if (lane == 0) {
          for (int h = 0; h * BOX < n; ++h)
            tma_store(&ymap, t0 + h * BOX, b0, slot + h * ROWS * BOX);
          bulk_commit();
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          float* dst = y + (long long)(b0 + r) * T + t0;
          for (int j = lane; j < n; j += 32) dst[j] = slot[elem(r, j)];
        }
      }
    };
    int stored = 0;
    for (int k = 0; k < tiles; ++k) {
      // Store what is gated, then free the slot of tile k - NSLOTS.
      while (stored < k
             && __shfl_sync(0xffffffffu, bar_test(&sh.gated[stored % NSLOTS],
                                                  (stored / NSLOTS) & 1), 0))
        store(stored++);
      while (stored <= k - NSLOTS) store(stored++);
      if (BULK && k >= NSLOTS && lane == 0) bulk_wait_read();
      __syncwarp();
      const int i = k % NSLOTS;
      const int t0 = k * TILE;
      const int n = min(TILE, T - t0);
      float* slot = sh.data[i];
      if (BULK) {
        if (lane == 0) {
          const int boxes = (n + BOX - 1) / BOX;
          bar_arrive_tx(&sh.full[i], boxes * ROWS * BOX * 4);
          for (int h = 0; h < boxes; ++h)
            tma_load(slot + h * ROWS * BOX, &xmap, t0 + h * BOX, b0,
                     &sh.full[i]);
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          const float* src = x + (long long)(b0 + r) * T + t0;
          for (int j = lane; j < n; j += 32) slot[elem(r, j)] = src[j];
        }
        bar_arrive(&sh.full[i]);
      }
    }
    while (stored < tiles) store(stored++);
    if (BULK && lane == 0) bulk_wait_all();
  } else if (warp == HPF_WARP || warp == LPF_WARP) {
    const int q = warp == HPF_WARP ? 0 : 4;
    const float cb0 = q ? p.lb0 : p.hb0, cb1 = q ? p.lb1 : p.hb1;
    const float cb2 = q ? p.lb2 : p.hb2, ca1 = q ? p.la1 : p.ha1;
    const float ca2 = q ? p.la2 : p.ha2;
    Biquad bq{0, 0, 0, 0};
    if (live) bq = Biquad{s_in[q], s_in[q + 1], s_in[q + 2], s_in[q + 3]};
    uint64_t* wait_on = warp == HPF_WARP ? sh.full : sh.hpf_done;
    uint64_t* done = warp == HPF_WARP ? sh.hpf_done : sh.lpf_done;
    for (int k = 0; k < tiles; ++k) {
      const int i = k % NSLOTS;
      bar_wait(&wait_on[i], (k / NSLOTS) & 1);
      const int n = min(TILE, T - k * TILE);
      if (!GATE_ONLY && row_lane) {
        if (n == TILE) biquad_row<true>(sh.data[i], lane, n, bq, cb0, cb1,
                                        cb2, ca1, ca2);
        else biquad_row<false>(sh.data[i], lane, n, bq, cb0, cb1, cb2, ca1,
                               ca2);
      }
      bar_arrive(&done[i]);
    }
    if (live) {
      s_out[q] = bq.x1;
      s_out[q + 1] = bq.x2;
      s_out[q + 2] = bq.y1;
      s_out[q + 3] = bq.y2;
    }
  } else if (warp == ENV_WARP) {
    float e = live ? s_in[8] : 0.0f;
    for (int k = 0; k < tiles; ++k) {
      const int i = k % NSLOTS, g = k % NGATE;
      bar_wait(&sh.lpf_done[i], (k / NSLOTS) & 1);
      bar_wait(&sh.env_empty[g], ((k / NGATE) & 1) ^ 1);
      const int n = min(TILE, T - k * TILE);
      if (row_lane) {
        if (n == TILE) envelope_row<true>(sh.data[i], sh.env[g], lane, n, e,
                                          p.rel, p.c1);
        else envelope_row<false>(sh.data[i], sh.env[g], lane, n, e, p.rel,
                                 p.c1);
      }
      bar_arrive(&sh.env_full[g]);
    }
    if (live) s_out[8] = e;
  } else if (warp == LOW_WARP) {
    for (int k = 0; k < tiles; ++k) {
      const int g = k % NGATE;
      bar_wait(&sh.env_full[g], (k / NGATE) & 1);
      const int n = min(TILE, T - k * TILE);
      if (row_lane) {
        if (n == TILE) low_row<true>(sh.env[g], sh.low[g], lane, n);
        else low_row<false>(sh.env[g], sh.low[g], lane, n);
      }
      bar_arrive(&sh.low_full[g]);
    }
  } else if (warp == HOLD_WARP) {
    float env_prev = live ? s_in[8] : 0.0f;
    // lim as an int between tiles; within a tile z and lim count from
    // the tile's start, as floats (a lim above 2^23 cannot run out within
    // a tile, so it enters as 2^23 and comes back unchanged unless an
    // attack sets it, to below 2^22 + TILE).
    int lim = live ? hold_in[b] : 0, z = 0;
    const float hs = static_cast<float>(p.hold_samples);
    for (int k = 0; k < tiles; ++k) {
      const int i = k % NSLOTS, g = k % NGATE;
      bar_wait(&sh.low_full[g], (k / NGATE) & 1);
      bar_wait(&sh.env_full[g], (k / NGATE) & 1);
      bar_wait(&sh.lpf_done[i], (k / NSLOTS) & 1);
      const int n = min(TILE, T - k * TILE);
      lim = max(lim - z, -1);
      const float lim0 = static_cast<float>(min(lim, 1 << 23));
      float zf = 0.0f, limf = lim0;
      if (row_lane) {
        if (n == TILE) hold_row<true>(sh.data[i], sh.env[g], sh.low[g], lane,
                                      n, env_prev, zf, limf, hs);
        else hold_row<false>(sh.data[i], sh.env[g], sh.low[g], lane, n,
                             env_prev, zf, limf, hs);
      }
      z = static_cast<int>(zf);
      if (limf != lim0) lim = static_cast<int>(limf);
      bar_arrive(&sh.env_empty[g]);
      if (BULK) fence_async();
      bar_arrive(&sh.gated[i]);
    }
    if (live) hold_out[b] = max(lim - z, 0);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// A tensor map over a [B, T] float32 array, 32 x 32 boxes, 128-byte
// swizzle; T % 4 == 0 and a 16-byte aligned base.
cudaError_t tensor_map(CUtensorMap* map, const float* base, int B, int T) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(T) * 4};
  const cuuint32_t box[2] = {BOX, ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool GATE_ONLY, bool BULK>
cudaError_t launch(const float* x, float* y, const float* st_in,
                   const int32_t* hold_in, float* st_out, int32_t* hold_out,
                   int B, int T, const Params& p, cudaStream_t s) {
  CUtensorMap xmap{}, ymap{};
  if (BULK) {
    cudaError_t e = tensor_map(&xmap, x, B, T);
    if (e == cudaSuccess) e = tensor_map(&ymap, y, B, T);
    if (e != cudaSuccess) return e;
  }
  auto kernel = reducer_kernel<GATE_ONLY, BULK>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kernel<<<(B + ROWS - 1) / ROWS, THREADS, SMEM_BYTES, s>>>(
      x, y, xmap, ymap, st_in, hold_in, st_out, hold_out, B, T, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  x, y [B, T]
// contiguous; st_in, st_out [B, 9] (hp x1 x2 y1 y2, lp x1 x2 y1 y2,
// envelope); hold_in, hold_out [B].  gate_only: the gate alone (the biquad
// state passes through).  T >= 1; 0 <= hold_samples < 2^22 (the hold's
// counts run as exact floats).
int aat_reducer_scan(const float* x, float* y, const float* st_in,
                     const int32_t* hold_in, float* st_out,
                     int32_t* hold_out, int B, int T, int gate_only,
                     float hb0, float hb1, float hb2, float ha1, float ha2,
                     float lb0, float lb1, float lb2, float la1, float la2,
                     float rel, float c1, int hold_samples, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || hold_samples < 0 || hold_samples >= 1 << 22)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{hb0, hb1, hb2, ha1, ha2, lb0, lb1, lb2, la1, la2,
                 rel, c1, hold_samples};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bulk = T % 4 == 0
      && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y))
          & 15) == 0;
  cudaError_t e;
  if (gate_only) {
    e = bulk ? launch<true, true>(x, y, st_in, hold_in, st_out, hold_out, B,
                                  T, p, s)
             : launch<true, false>(x, y, st_in, hold_in, st_out, hold_out, B,
                                   T, p, s);
  } else {
    e = bulk ? launch<false, true>(x, y, st_in, hold_in, st_out, hold_out, B,
                                   T, p, s)
             : launch<false, false>(x, y, st_in, hold_in, st_out, hold_out,
                                    B, T, p, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
