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
// histograms in and out; everything else is a dependent chain a slot:
// the sums, the percentiles, the gain, then the gained slot.  The design
// is a block of 1,024 threads a stream, a sample a thread:
//  - the rings (256 + 5,000 floats) live in shared memory for the whole
//    call; in "hist" mode each thread keeps bucket t of both histograms in
//    registers and puts them in shared memory once a slot for the others
//    to read;
//  - the sums of squares and fourth powers run in `dynamics.tree_sum`'s
//    order: stride-halving shuffles inside each warp of 32 samples, then
//    the same across the 32 warps' partials;
//  - every warp computes the slot's scalars alike (the percentiles by a
//    ballot search over the per-warp bucket totals, then over the 32
//    buckets of the warp that holds the crossing), so nothing is broadcast
//    through shared memory: a "hist" slot costs two block barriers, the
//    first after the partials and bucket copies are written, the second
//    before the rings and histograms change;
//  - the next slot's sample is loaded while this slot's chain runs.
// "exact" mode picks the sorted-order elements by a radix select (four
// 8-bit passes over the ring's order-preserving keys, NaN last as in a
// sort), with the play ring's new entry put in its place: ~40 barriers a
// slot.
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

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int LONG_LEN = 256;
constexpr int PLAY_LEN = 5000;
constexpr int BINS = 1024;

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

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The first bucket whose count so far exceeds k (0 if none does), over
// counts[] (per-warp totals wsum[]) with one added at `inc` and one taken at
// `dec` (-1: none).  Every lane of the calling warp returns it.
__device__ int hist_kth(const int* wsum, const int* counts, int k, int inc,
                        int dec, int lane) {
  const int tot = wsum[lane] + (inc >= 0 && (inc >> 5) == lane)
                  - (dec >= 0 && (dec >> 5) == lane);
  const int cum = warp_inclusive_scan(tot, lane);
  const unsigned hit = __ballot_sync(0xffffffffu, cum > k);
  if (hit == 0u) return 0;
  const int w = __ffs(hit) - 1;
  const int before = __shfl_sync(0xffffffffu, cum - tot, w);
  const int j = w * 32 + lane;
  const int c = counts[j] + (j == inc) - (j == dec);
  const int cum2 = before + warp_inclusive_scan(c, lane);
  const unsigned hit2 = __ballot_sync(0xffffffffu, cum2 > k);
  return w * 32 + __ffs(hit2) - 1;
}

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

// The k-th smallest of ring[0..n) with ring[rep] taken as rep_val (rep < 0:
// none), by four 8-bit radix passes.  Called by every thread of the block;
// hist[256] is scratch.
__device__ float block_select(const float* ring, int n, int k, int rep,
                              float rep_val, unsigned* hist, int lane) {
  unsigned prefix = 0u, mask = 0u;
  int kk = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (threadIdx.x < 256) hist[threadIdx.x] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const unsigned key = key_of(i == rep ? rep_val : ring[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    // Every warp alike: lane l sums bins 8l..8l+7, a scan finds the lane
    // whose bins hold the k-th key, then its bins are walked.
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
    prefix |= static_cast<unsigned>(digit) << shift;
    mask |= 255u << shift;
    kk -= run;
    __syncthreads();
  }
  return value_of(prefix);
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

__device__ __forceinline__ int warp_int_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
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

template <bool EXACT>
__global__ void __launch_bounds__(THREADS)
dynamics_kernel(const float* __restrict__ slots, State in, Outs out,
                float* __restrict__ gained, StateOut st, int S, int L,
                float inv_len, float smooth_alpha, float silence_alpha) {
  __shared__ float long_hist[LONG_LEN];
  __shared__ float play_hist[PLAY_LEN];
  __shared__ int cnt_long[BINS], cnt_play[BINS];
  __shared__ int wsum_long[WARPS], wsum_play[WARPS];
  __shared__ float part_sq[WARPS], part_q[WARPS], part_max[WARPS];
  __shared__ unsigned radix[256];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int i = t; i < LONG_LEN; i += THREADS)
    long_hist[i] = in.long_hist[b * LONG_LEN + i];
  for (int i = t; i < PLAY_LEN; i += THREADS)
    play_hist[i] = in.play_hist[(long long)b * PLAY_LEN + i];
  int my_long = in.long_counts[b * BINS + t];
  int my_play = in.play_counts[b * BINS + t];
  int long_pos = in.long_pos[b], play_pos = in.play_pos[b];
  bool long_filled = in.long_filled[b] != 0;
  bool play_filled = in.play_filled[b] != 0;
  float gain = in.gain[b];
  const float* xs = slots + (long long)b * S * L;
  float* gs = gained + (long long)b * S * L;
  float x_next = t < L ? xs[t] : 0.0f;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const float x = x_next;
    if (s + 1 < S) x_next = t < L ? xs[(long long)(s + 1) * L + t] : 0.0f;
    const float sq = __fmul_rn(x, x);
    const float sum_sq_w = warp_tree_sum(sq);
    const float sum_q_w = warp_tree_sum(__fmul_rn(sq, sq));
    const float max_w = warp_max(fabsf(x));
    if (lane == 0) {
      part_sq[warp] = sum_sq_w;
      part_q[warp] = sum_q_w;
      part_max[warp] = max_w;
    }
    if (!EXACT) {
      cnt_long[t] = my_long;
      cnt_play[t] = my_play;
      const int wl = warp_int_sum(my_long), wp = warp_int_sum(my_play);
      if (lane == 0) {
        wsum_long[warp] = wl;
        wsum_play[warp] = wp;
      }
    }
    __syncthreads();

    // The slot's scalars, in every warp alike.
    const float sum_sq = __shfl_sync(0xffffffffu,
                                     warp_tree_sum(part_sq[lane]), 0);
    const float sum_q = __shfl_sync(0xffffffffu,
                                    warp_tree_sum(part_q[lane]), 0);
    const float peak_raw = __shfl_sync(0xffffffffu, warp_max(part_max[lane]),
                                       0);
    const float rms = sqrtf(__fmul_rn(sum_sq, inv_len));
    const float rms_db = lin_to_db(rms);

    const int long_n = long_filled ? LONG_LEN : max(long_pos, 1);
    const int p10_idx = __float2int_rz(
        __fmul_rn(static_cast<float>(long_n - 1), TENTH));
    float p10 = EXACT
        ? block_select(long_hist, LONG_LEN, p10_idx, -1, 0.0f, radix, lane)
        : bucket_value(hist_kth(wsum_long, cnt_long, p10_idx, -1, -1, lane));
    if (long_pos == 0 && !long_filled) p10 = 0.0f;
    const float noise_floor_db = lin_to_db(p10);

    const int long_count = long_filled ? LONG_LEN : long_pos;
    const float floor_db = long_count >= 32 ? noise_floor_db
                                            : BOOTSTRAP_FLOOR_DB;
    const bool is_active = rms_db > __fadd_rn(floor_db, ACTIVE_SNR_DB);
    const float mean_sq = __fmul_rn(rms, rms);
    const float mean_quad = __fmul_rn(sum_q, inv_len);
    const float kurtosis = mean_sq > MEAN_SQ_MIN
        ? __fdiv_rn(mean_quad, __fmul_rn(mean_sq, mean_sq)) : KURT_DEFAULT;
    const bool is_broadband = is_active && kurtosis >= KURT_LO
                              && kurtosis <= KURT_HI && rms_db < BROADBAND_DB;
    const bool is_playing = is_active && !is_broadband;
    const bool upd_long = !is_active || is_broadband;

    const float old_long = long_hist[long_pos];
    const float old_play = play_hist[play_pos];
    const int inc_play = !EXACT && is_playing ? bucket_of(rms) : -1;
    const int dec_play = !EXACT && is_playing && isfinite(old_play)
                         ? bucket_of(old_play) : -1;
    const int new_play_pos = is_playing ? (play_pos + 1) % PLAY_LEN
                                        : play_pos;
    const bool new_play_filled = play_filled
                                 || (is_playing && new_play_pos == 0);
    const int play_n = new_play_filled ? PLAY_LEN : new_play_pos;
    const int p50_idx = play_n > 0 ? (play_n - 1) / 2 : 0;
    const int p95_idx = max(__float2int_rz(
        __fmul_rn(static_cast<float>(play_n - 1), P95)), 0);
    float p50, p95;
    if (EXACT) {
      const int rep = is_playing ? play_pos : -1;
      p50 = block_select(play_hist, PLAY_LEN, p50_idx, rep, rms, radix, lane);
      p95 = block_select(play_hist, PLAY_LEN, p95_idx, rep, rms, radix, lane);
    } else {
      p50 = bucket_value(hist_kth(wsum_play, cnt_play, p50_idx, inc_play,
                                  dec_play, lane));
      p95 = bucket_value(hist_kth(wsum_play, cnt_play, p95_idx, inc_play,
                                  dec_play, lane));
    }
    const bool has_play = play_n > 0;
    const float median_db = has_play ? lin_to_db(p50) : rms_db;
    const float raw_gain_db = has_play
        ? min_nan(max_nan(fmaf(-logf(max_nan(p95, EPS)), DB_PER_LOG,
                               TARGET_DB), 0.0f), MAX_BOOST_DB)
        : 0.0f;
    gain = is_playing
        ? __fadd_rn(gain, __fmul_rn(smooth_alpha,
                                    __fsub_rn(db_to_lin(raw_gain_db), gain)))
        : __fadd_rn(gain, __fmul_rn(silence_alpha, __fsub_rn(1.0f, gain)));
    const float peak = max_nan(peak_raw, EPS);
    const float eff = min_nan(gain, __fdiv_rn(PEAK_HEADROOM, peak));

    if (t < L) gs[(long long)s * L + t] = __fmul_rn(x, eff);
    if (t == 0) {
      const float rel = __fsub_rn(rms_db, median_db);
      const int level = rel < LEVEL_0 ? 0 : rel < LEVEL_1 ? 1
                        : rel < LEVEL_2 ? 2 : rel < LEVEL_3 ? 3
                        : rel < LEVEL_4 ? 4 : rel < LEVEL_5 ? 5
                        : rel < LEVEL_6 ? 6 : 7;
      const long long o = (long long)b * S + s;
      out.level[o] = is_playing ? level : -1;
      out.rms_db[o] = rms_db;
      out.gain_db[o] = lin_to_db(eff);
      out.median_db[o] = median_db;
      out.floor_db[o] = noise_floor_db;
      out.eff[o] = eff;
    }
    __syncthreads();

    // The rings and histograms move on.
    if (t == 0) {
      if (upd_long) long_hist[long_pos] = rms;
      if (is_playing) play_hist[play_pos] = rms;
    }
    if (!EXACT) {
      const int inc_long = upd_long ? bucket_of(rms) : -1;
      const int dec_long = upd_long && isfinite(old_long)
                           ? bucket_of(old_long) : -1;
      my_long += (t == inc_long) - (t == dec_long);
      my_play += (t == inc_play) - (t == dec_play);
    }
    if (upd_long) long_pos = (long_pos + 1) % LONG_LEN;
    long_filled = long_filled || (upd_long && long_pos == 0);
    play_pos = new_play_pos;
    play_filled = new_play_filled;
  }
  __syncthreads();
  for (int i = t; i < LONG_LEN; i += THREADS)
    st.long_hist[b * LONG_LEN + i] = long_hist[i];
  for (int i = t; i < PLAY_LEN; i += THREADS)
    st.play_hist[(long long)b * PLAY_LEN + i] = play_hist[i];
  st.long_counts[b * BINS + t] = my_long;
  st.play_counts[b * BINS + t] = my_play;
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

// Returns cudaGetLastError() after the launch (0 on success).  slots and
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
  if (S < 1 || L < 1 || L > THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const State in{long_hist, long_pos, long_filled, play_hist, play_pos,
                 play_filled, gain, long_counts, play_counts};
  const StateOut st{long_hist1, long_pos1, long_filled1, play_hist1,
                    play_pos1, play_filled1, gain1, long_counts1,
                    play_counts1};
  const Outs out{level, rms_db, gain_db, median_db, floor_db, eff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    dynamics_kernel<true><<<B, THREADS, 0, s>>>(
        slots, in, out, gained, st, S, L, inv_len, smooth_alpha,
        silence_alpha);
  } else {
    dynamics_kernel<false><<<B, THREADS, 0, s>>>(
        slots, in, out, gained, st, S, L, inv_len, smooth_alpha,
        silence_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
