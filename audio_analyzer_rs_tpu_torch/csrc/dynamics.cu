// K7: the dynamics (AGC) scan over B streams (ref
// src/audio_io/dynamics.rs:1-374): per slot the RMS, the p10 of a 256-slot
// quiet history (the noise floor), a kurtosis broadband detector, the p50
// and p95 of a 5,000-slot play history (session median and AGC target),
// the smoothed gain with its 0.97 peak-headroom clamp, the ppp-fff level
// and the gained slot.  Replaces the `lax.scan` of
// audio_analyzer_rs_tpu/ops/dynamics.py `dynamics_scan` (:253; the step is
// `_step`, :123), which XLA compiles to one device loop; it has no Pallas
// twin.  Bitwise equal to `dynamics_scan_plain` (ops/dynamics.py).
//
// What bounds it on an H100: the per-slot chain.  The bytes are the slots
// in and the gained slots out (2 x B x S x L x 4) plus the rings and
// histograms in and out; of the per-slot work only the scalar chain is
// carried from slot to slot (floor -> classification -> ring and histogram
// update -> percentiles -> gain).  So the work is split by what is carried:
//  (A) `dynamics_sums_kernel`, a warp a slot over all B x S slots in
//      parallel: the sums of squares and fourth powers in
//      `dynamics.tree_sum`'s order (a lane a group of 32 samples, halved
//      in registers, then the 32 partials by stride-halving shuffles), the
//      NaN-keeping peak, and what follows from them alone: rms, rms_db,
//      the histogram bucket, the broadband test's kurtosis half and
//      PEAK_HEADROOM / peak;
//  (B) the scalar chain over the S slots of a stream in order:
//      - "hist" (`dynamics_hist_kernel`): a block a stream, whose warp 0
//        runs the chain.  The histograms live in shared memory as prefix
//        counts within each 32-bucket group, lane j owning column j, and
//        in registers as each lane's group total and the prefix of the
//        totals, so a percentile is one ballot over the lanes, one
//        shuffle, one shared load and one ballot, with the slot's pending
//        increment and decrement folded in on the fly.  The rings keep
//        only their buckets on chip (the float entries are written
//        straight to the output state); the dB of every bucket centre and
//        the gain target of every bucket are tables built once a launch;
//        each transcendental is computed once, not once a warp.  Lane l of
//        the warp holds slot l of each batch of 32 slots' inputs and
//        outputs, read and written coalesced;
//      - "exact" (`dynamics_exact_kernel`): a block of 1,024 threads a
//        stream, the rings in shared memory, the sorted-order picks by a
//        radix select (four 8-bit passes over order-preserving keys, NaN
//        last as in a sort), the p50 and the p95 in one select of two
//        ranks;
//  (C) gained = x * eff over [B, S, L], elementwise: in "hist" mode by the
//      other warps of (B)'s block, a batch of 32 slots as soon as the
//      chain hands over its effs (a double buffer guarded by mbarriers),
//      so that the bytes move while the chain runs; in "exact" mode by
//      `dynamics_gain_kernel`, after (B).
// (A) stages its per-slot values in the output arrays that (B) overwrites
// (rms in gain_db, PEAK_HEADROOM / peak in eff, the bucket and flags in
// level); rms_db is final after (A).
//
// Rounding, as the plain version (and XLA:CPU's JAX step) does it: XLA
// computes 20*log10(x) as log(x) * DB_PER_LOG, divides by constants as
// products with float32 reciprocals, and contracts the bucket's
// log(x)*DB_PER_LOG + 180 and the target's -18 - log(p95)*DB_PER_LOG into
// fused multiply-adds (fmaf here); every other product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc
// would contract them otherwise).  log, pow and sqrt are the CUDA math
// library's logf, powf and sqrtf, which PyTorch's CUDA log, pow and sqrt
// call, so the kernel and the plain scan on the card agree bit for bit.
// Constants are float32 hex floats (tests/test_torch_dynamics.py reads
// them from this file).
//
// NaN, as the plain version does it: jnp.maximum / jnp.minimum (and
// torch's) keep a NaN, so every max and min here is PTX max.NaN / min.NaN;
// a compare with a NaN is false; a NaN's bucket is 0 (the float -> int
// conversion gives 0 for NaN and saturates otherwise).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LONG_LEN = 256;
constexpr int PLAY_LEN = 5000;
constexpr int BINS = 1024;
constexpr int GROUPS = BINS / 32;        // 32-bucket groups, a lane each
constexpr int EXACT_THREADS = 1024;
constexpr int SETUP_THREADS = 256;       // the hist chain's block
constexpr int SUMS_THREADS = 256;
constexpr int GAIN_THREADS = 256;

constexpr float EPS = 0x1.12e0bep-30f;              // 1e-9
constexpr float DB_PER_LOG = 0x1.15f2dp+3f;         // XLA's 20 / ln(10)
constexpr float BUCKETS_PER_DB = 0x1.605816p+2f;    // float32(1/186) * 1024
constexpr float DB_PER_BUCKET = 0x1.74p-3f;         // 186 / 1024
constexpr float HIST_LO_DB = -0x1.68p+7f;           // -180
constexpr float NEG_HIST_LO_DB = 0x1.68p+7f;        // 180
constexpr float TWENTIETH = 0x1.99999ap-5f;         // float32(0.05)
constexpr float TENTH = 0x1.99999ap-4f;             // float32(0.10)
constexpr float P95 = 0x1.e66666p-1f;               // float32(0.95)
constexpr float MEAN_SQ_MIN = 0x1.2725dep-60f;      // 1e-18
constexpr float KURT_LO = 0x1.6p+1f;                // 2.75
constexpr float KURT_HI = 0x1.e66666p+1f;           // 3.8
constexpr float KURT_DEFAULT = 0x1.8p+1f;           // 3
constexpr float BROADBAND_DB = -0x1.68p+5f;         // -45
constexpr float ACTIVE_SNR_DB = 0x1.4p+4f;          // 20
constexpr float BOOTSTRAP_FLOOR_DB = -0x1.b8p+5f;   // -55
constexpr float TARGET_DB = -0x1.2p+4f;             // -18
constexpr float MAX_BOOST_DB = 0x1.9p+6f;           // 100
constexpr float PEAK_HEADROOM = 0x1.f0a3d8p-1f;     // 0.97
constexpr float TEN = 0x1.4p+3f;                    // 10
// The level bounds on rel = rms_db - median_db: below LEVEL_i is level i,
// ppp (0) to ff (6); fff (7) above.
constexpr float LEVEL_0 = -0x1.ep+3f;               // -15
constexpr float LEVEL_1 = -0x1.2p+3f;               // -9
constexpr float LEVEL_2 = -0x1.2p+2f;               // -4.5
constexpr float LEVEL_3 = -0x1.8p+0f;               // -1.5
constexpr float LEVEL_4 = 0x1.8p+0f;                // 1.5
constexpr float LEVEL_5 = 0x1.2p+2f;                // 4.5
constexpr float LEVEL_6 = 0x1.2p+3f;                // 9

// (A)'s per-slot flags beside the bucket (bits 0-9) in the staged int.
constexpr int FINITE_BIT = 1 << 10;     // rms is finite
constexpr int BROADBAND_BIT = 1 << 11;  // kurtosis in range, rms_db < -45

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

__device__ __forceinline__ float lin_to_db(float x) {
  return __fmul_rn(logf(max_nan(x, EPS)), DB_PER_LOG);
}

__device__ __forceinline__ float db_to_lin(float db) {
  return powf(TEN, __fmul_rn(db, TWENTIETH));
}

__device__ __forceinline__ int bucket_of(float rms) {
  const float b = __fmul_rn(fmaf(logf(max_nan(rms, EPS)), DB_PER_LOG,
                                 NEG_HIST_LO_DB), BUCKETS_PER_DB);
  return min(max(__float2int_rz(b), 0), BINS - 1);
}

__device__ __forceinline__ float bucket_value(int bucket) {
  const float db = __fadd_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(bucket), 0.5f), DB_PER_BUCKET),
      HIST_LO_DB);
  return db_to_lin(db);
}

// The AGC's raw gain in dB from the play history's p95.
__device__ __forceinline__ float raw_gain_db(float p95) {
  return min_nan(max_nan(fmaf(-logf(max_nan(p95, EPS)), DB_PER_LOG,
                              TARGET_DB), 0.0f), MAX_BOOST_DB);
}

__device__ __forceinline__ int level_of(float rel) {
  return rel < LEVEL_0 ? 0 : rel < LEVEL_1 ? 1 : rel < LEVEL_2 ? 2
         : rel < LEVEL_3 ? 3 : rel < LEVEL_4 ? 4 : rel < LEVEL_5 ? 5
         : rel < LEVEL_6 ? 6 : 7;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The stride-halving tree of `dynamics.tree_sum` over a warp's 32 values:
// lane 0 ends with the sum.
__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max_nan(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
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

struct State {
  const float* long_hist; const int32_t* long_pos;
  const uint8_t* long_filled; const float* play_hist;
  const int32_t* play_pos; const uint8_t* play_filled;
  const float* gain; const int32_t* long_counts;
  const int32_t* play_counts;
};

struct StateOut {
  float* long_hist; int32_t* long_pos; uint8_t* long_filled;
  float* play_hist; int32_t* play_pos; uint8_t* play_filled;
  float* gain; int32_t* long_counts; int32_t* play_counts;
};

struct Outs {
  int32_t* level; float* rms_db; float* gain_db; float* median_db;
  float* floor_db; float* eff;
};

// ── (A) the slot sums ──────────────────────────────────────────────────

// One level of `tree_sum`'s halving in registers: a[j] += a[j + K].
template <int K>
__device__ __forceinline__ void halve(float* a, float* b) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a[j] = __fadd_rn(a[j], a[j + K]);
    b[j] = __fadd_rn(b[j], b[j + K]);
  }
}

// A warp a slot: lane g loads samples 32g..32g+31 (zero past L) and halves
// them in registers, as `tree_sum` does inside a group; the 32 partials
// then go through the shuffle tree.  Lane 0 stages the slot's values.
__global__ void __launch_bounds__(SUMS_THREADS)
dynamics_sums_kernel(const float* __restrict__ slots, Outs out, int n_slots,
                     int L, float inv_len) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (SUMS_THREADS / 32);
  const bool vec = (L & 3) == 0
                   && (reinterpret_cast<uintptr_t>(slots) & 15) == 0;
  for (int slot = blockIdx.x * (SUMS_THREADS / 32) + (threadIdx.x >> 5);
       slot < n_slots; slot += warps) {
    const float* xs = slots + (long long)slot * L + lane * 32;
    const int n = min(max(L - lane * 32, 0), 32);
    float v[32];
    if (vec && n == 32) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(xs + j));
        v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = j < n ? __ldg(xs + j) : 0.0f;
    }
    float sq[32], qd[32];
    float peak = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sq[j] = __fmul_rn(v[j], v[j]);
      qd[j] = __fmul_rn(sq[j], sq[j]);
      peak = max_nan(peak, fabsf(v[j]));
    }
    halve<16>(sq, qd);
    halve<8>(sq, qd);
    halve<4>(sq, qd);
    halve<2>(sq, qd);
    halve<1>(sq, qd);
    const float sum_sq = warp_tree_sum(sq[0]);
    const float sum_q = warp_tree_sum(qd[0]);
    peak = warp_max(peak);
    if (lane == 0) {
      const float rms = sqrtf(__fmul_rn(sum_sq, inv_len));
      const float rms_db = lin_to_db(rms);
      const float mean_sq = __fmul_rn(rms, rms);
      const float mean_quad = __fmul_rn(sum_q, inv_len);
      const float kurtosis = mean_sq > MEAN_SQ_MIN
          ? __fdiv_rn(mean_quad, __fmul_rn(mean_sq, mean_sq)) : KURT_DEFAULT;
      const bool broadband = kurtosis >= KURT_LO && kurtosis <= KURT_HI
                             && rms_db < BROADBAND_DB;
      out.rms_db[slot] = rms_db;
      out.gain_db[slot] = rms;
      out.eff[slot] = __fdiv_rn(PEAK_HEADROOM, max_nan(peak, EPS));
      out.level[slot] = bucket_of(rms) | (isfinite(rms) ? FINITE_BIT : 0)
                        | (broadband ? BROADBAND_BIT : 0);
    }
  }
}

// ── (C) the gained slots ───────────────────────────────────────────────

// A block a slot at a time: its samples times the slot's eff.
__global__ void __launch_bounds__(GAIN_THREADS)
dynamics_gain_kernel(const float* __restrict__ slots,
                     const float* __restrict__ eff,
                     float* __restrict__ gained, int n_slots, int L) {
  const bool vec = (L & 3) == 0
      && ((reinterpret_cast<uintptr_t>(slots)
           | reinterpret_cast<uintptr_t>(gained)) & 15) == 0;
  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const float e = __ldg(eff + slot);
    const long long base = (long long)slot * L;
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(slots + base);
      float4* dst = reinterpret_cast<float4*>(gained + base);
      for (int i = threadIdx.x; i < L / 4; i += GAIN_THREADS) {
        float4 q = __ldg(src + i);
        q.x = __fmul_rn(q.x, e); q.y = __fmul_rn(q.y, e);
        q.z = __fmul_rn(q.z, e); q.w = __fmul_rn(q.w, e);
        dst[i] = q;
      }
    } else {
      for (int i = threadIdx.x; i < L; i += GAIN_THREADS)
        gained[base + i] = __fmul_rn(__ldg(slots + base + i), e);
    }
  }
}

// ── (B) the scalar chain, "hist" ────────────────────────────────────────

// One histogram as the chain warp holds it: pre[] (shared) the counts'
// inclusive prefix within each 32-bucket group (lane j reads and writes
// column j only); cum and tot (lane g's registers) the inclusive prefix
// of the group totals up to group g, and group g's total.
struct Hist {
  int* pre;
  int cum, tot;

  // Add d to bucket k (k < 0: nothing).
  __device__ __forceinline__ void add(int k, int d, int lane) {
    if (k < 0) return;
    const int g = k >> 5;
    cum += lane >= g ? d : 0;
    tot += lane == g ? d : 0;
    if (lane >= (k & 31)) pre[(g << 5) + lane] += d;
  }

  // The first bucket whose count so far exceeds k (0 if none does), as if
  // one were added at `inc` and taken at `dec` (-1: none).  Every lane
  // returns it.
  __device__ __forceinline__ int kth(int k, int inc, int dec,
                                     int lane) const {
    const int gi = inc >= 0 ? inc >> 5 : GROUPS;
    const int gd = dec >= 0 ? dec >> 5 : GROUPS;
    const int c = cum + (lane >= gi) - (lane >= gd);
    const unsigned hit = __ballot_sync(0xffffffffu, c > k);
    if (hit == 0u) return 0;
    const int w = __ffs(hit) - 1;
    const int before = __shfl_sync(0xffffffffu, c - tot - (lane == gi)
                                   + (lane == gd), w);
    const int p = pre[(w << 5) + lane]
                  + (w == gi && lane >= (inc & 31))
                  - (w == gd && lane >= (dec & 31));
    const unsigned hit2 = __ballot_sync(0xffffffffu, before + p > k);
    return (w << 5) + __ffs(hit2) - 1;
  }
};

// The histogram from counts[BINS] (global) into pre[] by the whole block,
// the group totals into tot[GROUPS].
__device__ __forceinline__ void hist_setup(const int32_t* counts, int* pre,
                                           int* tot) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < GROUPS; g += SETUP_THREADS / 32) {
    const int p = warp_inclusive_scan(counts[(g << 5) + lane], lane);
    pre[(g << 5) + lane] = p;
    if (lane == 31) tot[g] = p;
  }
}

// The bucket ring of a float ring: bucket_of(v), or -1 where v is not
// finite (its entry is not in the histogram).
__device__ __forceinline__ short ring_bucket(float v) {
  return isfinite(v) ? static_cast<short>(bucket_of(v)) : short(-1);
}

// A block a stream: all its warps set up (rings, histograms, tables), then
// warp 0 runs the chain and the other WORKERS warps write the gained slots
// (phase (C)) of each batch of 32 slots as the chain hands over its effs,
// through a double buffer guarded by mbarriers.
__global__ void __launch_bounds__(SETUP_THREADS)
dynamics_hist_kernel(const float* __restrict__ slots,
                     float* __restrict__ gained, State in, Outs out,
                     StateOut st, int S, int L, float smooth_alpha,
                     float silence_alpha) {
  constexpr int WORKERS = SETUP_THREADS / 32 - 1;
  __shared__ float eff_buf[2][32];
  __shared__ uint64_t eff_full[2], eff_empty[2];
  __shared__ int pre_long[BINS], pre_play[BINS];
  __shared__ int tot_long[GROUPS], tot_play[GROUPS];
  __shared__ short bkt_long[LONG_LEN], bkt_play[PLAY_LEN];
  __shared__ float db_of[BINS];       // lin_to_db(bucket_value(k))
  __shared__ float target_of[BINS];   // db_to_lin(raw_gain_db(value(k)))

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long row = (long long)b * S;
  if (t == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&eff_full[i], 32);
      bar_init(&eff_empty[i], 32 * WORKERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = t; i < LONG_LEN; i += SETUP_THREADS) {
    const float v = in.long_hist[b * LONG_LEN + i];
    st.long_hist[b * LONG_LEN + i] = v;
    bkt_long[i] = ring_bucket(v);
  }
  for (int i = t; i < PLAY_LEN; i += SETUP_THREADS) {
    const float v = in.play_hist[(long long)b * PLAY_LEN + i];
    st.play_hist[(long long)b * PLAY_LEN + i] = v;
    bkt_play[i] = ring_bucket(v);
  }
  hist_setup(in.long_counts + b * BINS, pre_long, tot_long);
  hist_setup(in.play_counts + b * BINS, pre_play, tot_play);
  for (int k = t; k < BINS; k += SETUP_THREADS) {
    const float v = bucket_value(k);
    db_of[k] = lin_to_db(v);
    target_of[k] = db_to_lin(raw_gain_db(v));
  }
  __syncthreads();
  if (t >= 32) {
    // (C): worker w takes slots w, w + WORKERS, ... of each batch.
    const int w = (t >> 5) - 1;
    const bool vec = (L & 3) == 0
        && ((reinterpret_cast<uintptr_t>(slots)
             | reinterpret_cast<uintptr_t>(gained)) & 15) == 0;
    for (int kb = 0; kb * 32 < S; ++kb) {
      const int buf = kb & 1;
      bar_wait(&eff_full[buf], (kb >> 1) & 1);
      const int s0 = kb * 32;
      const int n = min(32, S - s0);
      for (int j = w; j < n; j += WORKERS) {
        const float e = eff_buf[buf][j];
        const long long base = (row + s0 + j) * L;
        if (vec) {
          const float4* src = reinterpret_cast<const float4*>(slots + base);
          float4* dst = reinterpret_cast<float4*>(gained + base);
          for (int i = lane; i < L / 4; i += 32) {
            float4 q = __ldg(src + i);
            q.x = __fmul_rn(q.x, e); q.y = __fmul_rn(q.y, e);
            q.z = __fmul_rn(q.z, e); q.w = __fmul_rn(q.w, e);
            dst[i] = q;
          }
        } else {
          for (int i = lane; i < L; i += 32)
            gained[base + i] = __fmul_rn(__ldg(slots + base + i), e);
        }
      }
      bar_arrive(&eff_empty[buf]);
    }
    return;
  }

  Hist hl{pre_long, 0, tot_long[lane]}, hp{pre_play, 0, tot_play[lane]};
  hl.cum = warp_inclusive_scan(hl.tot, lane);
  hp.cum = warp_inclusive_scan(hp.tot, lane);
  int long_pos = in.long_pos[b], play_pos = in.play_pos[b];
  bool long_filled = in.long_filled[b] != 0;
  bool play_filled = in.play_filled[b] != 0;
  float gain = in.gain[b];
  const float db_of_zero = lin_to_db(0.0f);
  const float target_of_none = db_to_lin(0.0f);

  // Lane l holds slot s0 + l of the batch: (A)'s staged values in, the
  // slot's results out; the next batch's values load a batch ahead.
  auto load = [&](int s0, float& rms, float& rms_db, float& hr, int& info) {
    const int s = s0 + lane;
    if (s < S) {
      rms = out.gain_db[row + s];
      rms_db = out.rms_db[row + s];
      hr = out.eff[row + s];
      info = out.level[row + s];
    }
  };
  float n_rms = 0.0f, n_db = 0.0f, n_hr = 0.0f;
  int n_info = 0;
  load(0, n_rms, n_db, n_hr, n_info);
  for (int s0 = 0; s0 < S; s0 += 32) {
    const float b_rms = n_rms, b_db = n_db, b_hr = n_hr;
    const int b_info = n_info;
    if (s0 + 32 < S) load(s0 + 32, n_rms, n_db, n_hr, n_info);
    float o_eff = 0.0f, o_med = 0.0f, o_floor = 0.0f;
    bool o_play = false;
    const int n = min(32, S - s0);
    for (int j = 0; j < n; ++j) {
      const float rms = __shfl_sync(0xffffffffu, b_rms, j);
      const float rms_db = __shfl_sync(0xffffffffu, b_db, j);
      const float hr = __shfl_sync(0xffffffffu, b_hr, j);
      const int info = __shfl_sync(0xffffffffu, b_info, j);
      const int bucket = info & (BINS - 1);
      const short old_play = bkt_play[play_pos];

      // The noise floor: p10 of the quiet history.
      const int long_n = long_filled ? LONG_LEN : max(long_pos, 1);
      const int p10_idx = __float2int_rz(
          __fmul_rn(static_cast<float>(long_n - 1), TENTH));
      const int k10 = hl.kth(p10_idx, -1, -1, lane);
      const float noise_floor_db = long_pos == 0 && !long_filled
                                   ? db_of_zero : db_of[k10];
      const int long_count = long_filled ? LONG_LEN : long_pos;
      const float floor_db = long_count >= 32 ? noise_floor_db
                                              : BOOTSTRAP_FLOOR_DB;
      const bool is_active = rms_db > __fadd_rn(floor_db, ACTIVE_SNR_DB);
      const bool broadband = (info & BROADBAND_BIT) != 0;
      const bool is_playing = is_active && !broadband;
      const bool upd_long = !is_active || broadband;

      // The quiet history moves on (its next read is the next slot's).
      if (upd_long) {
        hl.add(bucket, 1, lane);
        hl.add(bkt_long[long_pos], -1, lane);
        bkt_long[long_pos] = info & FINITE_BIT ? bucket : -1;
        if (lane == 0) st.long_hist[b * LONG_LEN + long_pos] = rms;
        long_pos = long_pos + 1 == LONG_LEN ? 0 : long_pos + 1;
        long_filled = long_filled || long_pos == 0;
      }

      // Session stats: p50 and p95 of the play history with this slot's
      // entry in it.
      const int inc = is_playing ? bucket : -1;
      const int dec = is_playing ? old_play : -1;
      const int new_play_pos = is_playing
          ? (play_pos + 1 == PLAY_LEN ? 0 : play_pos + 1) : play_pos;
      const bool new_play_filled = play_filled
                                   || (is_playing && new_play_pos == 0);
      const int play_n = new_play_filled ? PLAY_LEN : new_play_pos;
      const int p50_idx = play_n > 0 ? (play_n - 1) / 2 : 0;
      const int p95_idx = max(__float2int_rz(
          __fmul_rn(static_cast<float>(play_n - 1), P95)), 0);
      const int k50 = hp.kth(p50_idx, inc, dec, lane);
      const int k95 = hp.kth(p95_idx, inc, dec, lane);
      const bool has_play = play_n > 0;
      const float median_db = has_play ? db_of[k50] : rms_db;
      const float target = has_play ? target_of[k95] : target_of_none;
      gain = is_playing
          ? __fadd_rn(gain, __fmul_rn(smooth_alpha, __fsub_rn(target, gain)))
          : __fadd_rn(gain, __fmul_rn(silence_alpha, __fsub_rn(1.0f, gain)));
      const float eff = min_nan(gain, hr);
      if (is_playing) {
        hp.add(inc, 1, lane);
        hp.add(dec, -1, lane);
        bkt_play[play_pos] = info & FINITE_BIT ? bucket : -1;
        if (lane == 0) st.play_hist[(long long)b * PLAY_LEN + play_pos] = rms;
      }
      play_pos = new_play_pos;
      play_filled = new_play_filled;
      if (lane == j) {
        o_eff = eff;
        o_med = median_db;
        o_floor = noise_floor_db;
        o_play = is_playing;
      }
    }
    // The batch's effs to the workers (the buffer's last batch read).
    const int kb = s0 >> 5;
    bar_wait(&eff_empty[kb & 1], ((kb >> 1) & 1) ^ 1);
    eff_buf[kb & 1][lane] = o_eff;
    bar_arrive(&eff_full[kb & 1]);
    if (lane < n) {
      const long long o = row + s0 + lane;
      out.level[o] = o_play ? level_of(__fsub_rn(b_db, o_med)) : -1;
      out.gain_db[o] = lin_to_db(o_eff);
      out.median_db[o] = o_med;
      out.floor_db[o] = o_floor;
      out.eff[o] = o_eff;
    }
  }
  // The counts back from the prefixes, column by column.
  for (int g = 0; g < GROUPS; ++g) {
    const int p = hl.pre[(g << 5) + lane];
    const int q = hp.pre[(g << 5) + lane];
    const int pl = __shfl_up_sync(0xffffffffu, p, 1);
    const int ql = __shfl_up_sync(0xffffffffu, q, 1);
    st.long_counts[b * BINS + (g << 5) + lane] = lane ? p - pl : p;
    st.play_counts[b * BINS + (g << 5) + lane] = lane ? q - ql : q;
  }
  if (lane == 0) {
    st.long_pos[b] = long_pos;
    st.long_filled[b] = long_filled;
    st.play_pos[b] = play_pos;
    st.play_filled[b] = play_filled;
    st.gain[b] = gain;
  }
}

// ── (B) the scalar chain, "exact" ───────────────────────────────────────

// Order-preserving keys: NaN last (as a sort puts it), then +inf.
__device__ __forceinline__ unsigned key_of(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  if (key == 0xffffffffu) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The digit of a radix pass: every warp alike, lane l sums bins 8l..8l+7,
// a scan finds the lane whose bins hold rank kk, then its bins are walked.
// Returns the digit and takes the keys below it off kk.
__device__ __forceinline__ unsigned pass_digit(const unsigned* hist, int& kk,
                                               int lane) {
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += static_cast<int>(hist[lane * 8 + j]);
  const int cum = warp_inclusive_scan(sum, lane);
  const unsigned hit = __ballot_sync(0xffffffffu, cum > kk);
  const int l = __ffs(hit) - 1;
  int run = __shfl_sync(0xffffffffu, cum - sum, l);
  int digit = l * 8;
  for (int j = 0; j < 8; ++j) {
    const int c = static_cast<int>(hist[l * 8 + j]);
    if (run + c > kk) { digit = l * 8 + j; break; }
    run += c;
  }
  kk -= run;
  return static_cast<unsigned>(digit);
}

// The ranks k[0..R) of ring[0..n) with ring[rep] taken as rep_val (rep < 0:
// none), by four 8-bit radix passes, the R selects sharing each pass's
// barriers.  Called by every thread of the block; hist[R][256] is scratch.
template <int R>
__device__ void block_select(const float* ring, int n, const int* k, int rep,
                             float rep_val, unsigned (*hist)[256], int lane,
                             float* value) {
  unsigned prefix[R], mask = 0u;
  int kk[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { prefix[r] = 0u; kk[r] = k[r]; }
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (threadIdx.x < R * 256) hist[threadIdx.x >> 8][threadIdx.x & 255] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += EXACT_THREADS) {
      const unsigned key = key_of(i == rep ? rep_val : ring[i]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((key & mask) == prefix[r])
          atomicAdd(&hist[r][(key >> shift) & 255u], 1u);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
      prefix[r] |= pass_digit(hist[r], kk[r], lane) << shift;
    mask |= 255u << shift;
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) value[r] = value_of(prefix[r]);
}

// A block of 1,024 threads a stream, the rings in shared memory; every
// thread computes the slot's scalars alike, thread 0 writes.  The
// histograms pass through.
__global__ void __launch_bounds__(EXACT_THREADS)
dynamics_exact_kernel(State in, Outs out, StateOut st, int S,
                      float smooth_alpha, float silence_alpha) {
  __shared__ float long_hist[LONG_LEN];
  __shared__ float play_hist[PLAY_LEN];
  __shared__ unsigned radix[2][256];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int i = t; i < LONG_LEN; i += EXACT_THREADS)
    long_hist[i] = in.long_hist[b * LONG_LEN + i];
  for (int i = t; i < PLAY_LEN; i += EXACT_THREADS)
    play_hist[i] = in.play_hist[(long long)b * PLAY_LEN + i];
  st.long_counts[b * BINS + t] = in.long_counts[b * BINS + t];
  st.play_counts[b * BINS + t] = in.play_counts[b * BINS + t];
  int long_pos = in.long_pos[b], play_pos = in.play_pos[b];
  bool long_filled = in.long_filled[b] != 0;
  bool play_filled = in.play_filled[b] != 0;
  float gain = in.gain[b];
  const long long row = (long long)b * S;
  float n_rms = out.gain_db[row], n_db = out.rms_db[row];
  float n_hr = out.eff[row];
  int n_info = out.level[row];
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float rms = n_rms, rms_db = n_db, hr = n_hr;
    const int info = n_info;
    if (s + 1 < S) {
      n_rms = out.gain_db[row + s + 1];
      n_db = out.rms_db[row + s + 1];
      n_hr = out.eff[row + s + 1];
      n_info = out.level[row + s + 1];
    }
    const int long_n = long_filled ? LONG_LEN : max(long_pos, 1);
    const int p10_idx = __float2int_rz(
        __fmul_rn(static_cast<float>(long_n - 1), TENTH));
    float p10;
    block_select<1>(long_hist, LONG_LEN, &p10_idx, -1, 0.0f, radix, lane,
                    &p10);
    if (long_pos == 0 && !long_filled) p10 = 0.0f;
    const float noise_floor_db = lin_to_db(p10);
    const int long_count = long_filled ? LONG_LEN : long_pos;
    const float floor_db = long_count >= 32 ? noise_floor_db
                                            : BOOTSTRAP_FLOOR_DB;
    const bool is_active = rms_db > __fadd_rn(floor_db, ACTIVE_SNR_DB);
    const bool broadband = (info & BROADBAND_BIT) != 0;
    const bool is_playing = is_active && !broadband;
    const bool upd_long = !is_active || broadband;

    const int new_play_pos = is_playing
        ? (play_pos + 1 == PLAY_LEN ? 0 : play_pos + 1) : play_pos;
    const bool new_play_filled = play_filled
                                 || (is_playing && new_play_pos == 0);
    const int play_n = new_play_filled ? PLAY_LEN : new_play_pos;
    const int idx[2] = {play_n > 0 ? (play_n - 1) / 2 : 0,
                        max(__float2int_rz(__fmul_rn(
                            static_cast<float>(play_n - 1), P95)), 0)};
    float pct[2];
    block_select<2>(play_hist, PLAY_LEN, idx, is_playing ? play_pos : -1,
                    rms, radix, lane, pct);
    const bool has_play = play_n > 0;
    const float median_db = has_play ? lin_to_db(pct[0]) : rms_db;
    const float raw = has_play ? raw_gain_db(pct[1]) : 0.0f;
    gain = is_playing
        ? __fadd_rn(gain, __fmul_rn(smooth_alpha,
                                    __fsub_rn(db_to_lin(raw), gain)))
        : __fadd_rn(gain, __fmul_rn(silence_alpha, __fsub_rn(1.0f, gain)));
    const float eff = min_nan(gain, hr);

    // The selects end on a barrier, so no thread reads the rings until the
    // next slot's first barrier: thread 0 moves them on here.
    if (t == 0) {
      const long long o = row + s;
      out.level[o] = is_playing ? level_of(__fsub_rn(rms_db, median_db))
                                : -1;
      out.gain_db[o] = lin_to_db(eff);
      out.median_db[o] = median_db;
      out.floor_db[o] = noise_floor_db;
      out.eff[o] = eff;
      if (upd_long) long_hist[long_pos] = rms;
      if (is_playing) play_hist[play_pos] = rms;
    }
    if (upd_long) {
      long_pos = long_pos + 1 == LONG_LEN ? 0 : long_pos + 1;
      long_filled = long_filled || long_pos == 0;
    }
    play_pos = new_play_pos;
    play_filled = new_play_filled;
  }
  __syncthreads();
  for (int i = t; i < LONG_LEN; i += EXACT_THREADS)
    st.long_hist[b * LONG_LEN + i] = long_hist[i];
  for (int i = t; i < PLAY_LEN; i += EXACT_THREADS)
    st.play_hist[(long long)b * PLAY_LEN + i] = play_hist[i];
  if (t == 0) {
    st.long_pos[b] = long_pos;
    st.long_filled[b] = long_filled;
    st.play_pos[b] = play_pos;
    st.play_filled[b] = play_filled;
    st.gain[b] = gain;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 on success).  slots and
// gained [B, S, L] contiguous, 1 <= L <= 1024; the state in and out as
// DynamicsState's leaves in field order, [B, ...] contiguous (the flags
// one byte each); the outputs [B, S].  exact: sorted-order percentiles
// (the histograms pass through), else the histograms'.  S >= 1.
int aat_dynamics_scan(const float* slots, const float* long_hist,
                      const int32_t* long_pos, const uint8_t* long_filled,
                      const float* play_hist, const int32_t* play_pos,
                      const uint8_t* play_filled, const float* gain,
                      const int32_t* long_counts, const int32_t* play_counts,
                      int32_t* level, float* rms_db, float* gain_db,
                      float* median_db, float* floor_db, float* eff,
                      float* gained, float* long_hist1, int32_t* long_pos1,
                      uint8_t* long_filled1, float* play_hist1,
                      int32_t* play_pos1, uint8_t* play_filled1,
                      float* gain1, int32_t* long_counts1,
                      int32_t* play_counts1, int B, int S, int L, int exact,
                      float inv_len, float smooth_alpha, float silence_alpha,
                      void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (S < 1 || L < 1 || L > BINS)
    return static_cast<int>(cudaErrorInvalidValue);
  const State in{long_hist, long_pos, long_filled, play_hist, play_pos,
                 play_filled, gain, long_counts, play_counts};
  const StateOut st{long_hist1, long_pos1, long_filled1, play_hist1,
                    play_pos1, play_filled1, gain1, long_counts1,
                    play_counts1};
  const Outs out{level, rms_db, gain_db, median_db, floor_db, eff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slots = B * S;
  const int warps = SUMS_THREADS / 32;
  dynamics_sums_kernel<<<min((n_slots + warps - 1) / warps, 132 * 16),
                         SUMS_THREADS, 0, s>>>(slots, out, n_slots, L,
                                               inv_len);
  if (exact) {
    dynamics_exact_kernel<<<B, EXACT_THREADS, 0, s>>>(
        in, out, st, S, smooth_alpha, silence_alpha);
    dynamics_gain_kernel<<<min(n_slots, 132 * 16), GAIN_THREADS, 0, s>>>(
        slots, eff, gained, n_slots, L);
  } else {
    dynamics_hist_kernel<<<B, SETUP_THREADS, 0, s>>>(
        slots, gained, in, out, st, S, L, smooth_alpha, silence_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
