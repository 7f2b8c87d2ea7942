// K3: the batched PitchTracker scan (ref src/audio_io/stft.rs:20-117).
// Replaces the Pallas kernel audio_analyzer_rs_tpu/ops/pallas_tracker.py
// `_kernel` (launched by `tracker_scan_pallas`).
//
// One warp per stream, one track slot per lane (24 slots on lanes 0..23;
// lanes 24..31 hold no track).  The stream's state stays in registers for
// all N frames; each frame the warp reads the 8 raw pitches, runs the
// 8 greedy match rounds (a warp-wide min over the candidates' creation
// seq picks the first track in creation order), spawns the unmatched raws
// into free slots by rank (ballot + popc), then decays or reaps the
// unmatched tracks.  It writes each frame's freq, score, stable and seq,
// and at the end the final state.
//
// Bit-exact to the plain torch `_step`: the match test is the same IEEE
// division and compare, and the EMA is __fmul_rn/__fadd_rn, so nvcc cannot
// contract it into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 24;                 // track slots per stream
constexpr int R = 8;                  // raw pitches per frame
constexpr int INT_MAX32 = 0x7fffffff;
constexpr int MAX_LIFE = 3;
constexpr int DISPLAY_THRESHOLD = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // streams per block

__global__ void __launch_bounds__(WARPS * 32)
tracker_kernel(const float* __restrict__ rf, const float* __restrict__ rs,
               const uint8_t* __restrict__ rv, const uint8_t* __restrict__ on,
               const float* __restrict__ f0, const float* __restrict__ s0,
               const int* __restrict__ l0, const uint8_t* __restrict__ v0,
               const int* __restrict__ q0, const int* __restrict__ n0,
               float* __restrict__ of, float* __restrict__ os,
               uint8_t* __restrict__ ot, int* __restrict__ oq,
               float* __restrict__ f1, float* __restrict__ s1,
               int* __restrict__ l1, uint8_t* __restrict__ v1,
               int* __restrict__ q1, int* __restrict__ n1, int S, int N) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  if (s >= S) return;                 // uniform across the warp
  const bool slot = lane < T;
  const long long st = (long long)s * T + lane;

  float freq = 0.f, score = 0.f;
  int life = 0, seq = INT_MAX32;
  bool valid = false;
  if (slot) {
    freq = f0[st];
    score = s0[st];
    life = l0[st];
    valid = v0[st] != 0;
    seq = q0[st];
  }
  int nseq = n0[s];

  for (int i = 0; i < N; ++i) {
    const long long fr = (long long)s * N + i;
    const bool onset = on[fr] != 0;
    float rfv[R], rsv[R];
    unsigned rvm = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rfv[j] = rf[fr * R + j];
      rsv[j] = rs[fr * R + j];
      rvm |= (rv[fr * R + j] != 0 ? 1u : 0u) << j;
    }

    // Phase 1: greedy matching on the entry state.
    const float f_entry = freq;
    const float denom = fmaxf(fabsf(f_entry), 1e-30f);
    const int life_inc = min(life + 1, MAX_LIFE);
    bool matched = false;
    unsigned any_mask = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool rel_ok = fabsf(f_entry - rfv[j]) / denom < 0.03f;
      const bool cand = slot && valid && !matched && rel_ok;
      const int key = cand ? seq : INT_MAX32;
      const int first = __reduce_min_sync(FULL, key);
      const bool any_match = first < INT_MAX32 && ((rvm >> j) & 1u);
      if (any_match) any_mask |= 1u << j;
      if (any_match && cand && key == first) {
        freq = onset ? rfv[j]
                     : __fadd_rn(__fmul_rn(f_entry, 0.6f),
                                 __fmul_rn(rfv[j], 0.4f));
        score = rsv[j];
        life = life_inc;
        matched = true;
      }
    }

    // Phase 2: the r-th unmatched raw spawns into the r-th free slot.
    const unsigned um = rvm & ~any_mask;
    const bool is_free = slot && !valid;
    const unsigned free_mask = __ballot_sync(FULL, is_free);
    const int n_um = __popc(um);
    const int rank = __popc(free_mask & ((1u << lane) - 1u));
    if (is_free && rank < n_um) {
      unsigned m = um;
      for (int r = 0; r < rank; ++r) m &= m - 1u;   // drop the lower ranks
      const int pick = __ffs(m) - 1;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j == pick) {
          freq = rfv[j];
          score = rsv[j];
        }
      }
      life = 1;
      seq = nseq + rank;
      matched = true;
      valid = true;
    }
    nseq += min(n_um, __popc(free_mask));

    // Phase 3: misses decay, or are reaped on an onset.
    if (valid && !matched) life = onset ? 0 : life - 1;
    valid = valid && life > 0;
    if (!valid) seq = INT_MAX32;
    if (slot) {
      const long long o = fr * T + lane;
      of[o] = freq;
      os[o] = score;
      ot[o] = (valid && life >= DISPLAY_THRESHOLD) ? 1 : 0;
      oq[o] = seq;
    }
  }

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

// Returns cudaGetLastError() after the launch (0 on success).
int aat_tracker_scan(const float* rf, const float* rs, const uint8_t* rv,
                     const uint8_t* on, const float* f0, const float* s0,
                     const int* l0, const uint8_t* v0, const int* q0,
                     const int* n0, float* of, float* os, uint8_t* ot,
                     int* oq, float* f1, float* s1, int* l1, uint8_t* v1,
                     int* q1, int* n1, int S, int N, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (S + WARPS - 1) / WARPS;
  tracker_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rf, rs, rv, on, f0, s0, l0, v0, q0, n0, of, os, ot, oq, f1, s1, l1, v1,
      q1, n1, S, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
