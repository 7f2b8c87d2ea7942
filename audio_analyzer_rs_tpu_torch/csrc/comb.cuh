// The 13-harmonic comb of one candidate (ref src/audio_io/stft.rs:499-545),
// shared by K2 (comb.cu) and K10 (extract.cu), so that both give the same
// bits.  See comb.cu for the derivation of the clipped window.
//
// `row` is the frame's peak-masked magnitudes pm[0, kc) (zero at and above
// max_bin), `fr` and `fund` the candidate's fractional bin and magnitude.
// For harmonic n a candidate scans only positions in
//   [max(floor(e-1), last+1, n*k-n-1, 0), min(ceil(e+1), n*k+n+1, max_bin-1)]
// ascending with a strict `>`, as the reference's scan over offsets
// -n-1..n+1 does (the first maximum wins).  The window holds at most 4 bins,
// so the scan is a fixed 4-step loop with a guard (nvcc 12.9 miscompiled
// the same scan written as a loop from lo to hi).  The candidate stops at
// the first harmonic with e >= half (it and all later harmonics are
// identities) or with n*(k-1) > max_bin (all later ones are misses).  frac*n,
// e-1 and e+1 are IEEE-rounded (`__fmul_rn` / `__fadd_rn`: a contracted
// fmaf(frac, n, -1) could move the floor at a boundary), and the score adds
// the matched magnitudes in the reference's order.

#pragma once

namespace {

constexpr int COMB_MAX_H = 14;

struct CombOut {
  float score;
  int longest_run;
  int total_harms;
};

__device__ __forceinline__ CombOut comb_candidate(const float* row, float fr,
                                                  float fund, int k,
                                                  int half, int max_bin) {
  float score = fund;
  int last = k;
  int longest = 0, current = 0, total = 0;
  for (int h = 2; h <= COMB_MAX_H; ++h) {
    const float e = __fmul_rn(fr, static_cast<float>(h));
    if (!(e < static_cast<float>(half)) || h * (k - 1) > max_bin) break;
    const int hk = h * k;
    const int lo = max(max(static_cast<int>(floorf(__fadd_rn(e, -1.0f))),
                           last + 1),
                       max(hk - h - 1, 0));
    const int hi = min(min(static_cast<int>(ceilf(__fadd_rn(e, 1.0f))),
                           hk + h + 1),
                       max_bin - 1);
    float best = 0.f;
    int best_pos = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {         // the window holds <= 4 bins
      const int p = lo + j;
      if (p <= hi) {
        const float v = row[p];
        if (v > best) {                   // strict: the first maximum wins
          best = v;
          best_pos = p;
        }
      }
    }
    if (best > 0.f) {
      score = __fadd_rn(score, best);
      last = best_pos;
      ++current;
      ++total;
    } else {
      longest = max(longest, current);
      current = 0;
    }
  }
  return CombOut{score, max(longest, current), total};
}

}  // namespace
