// K10: the pitch extraction of a frame in one launch (ref
// src/audio_io/stft.rs:443-620): peaks above the floor and their
// log-parabolic interpolation, the 13-harmonic comb, the fundamental and
// structure gates, the score, the 50% cutoff, top-32 by score, ghost
// suppression, the greedy 2-bin dedup and the first 8 kept, in the 24 Hz -
// 10 kHz range.  No Pallas twin: on the TPU, XLA fused these ops (JAX
// audio_analyzer_rs_tpu/ops/pitch.py `_pre_comb` :259, `_extract_single`
// :294).  The plain version is ops/pitch.py `_extract`, plain torch
// throughout, its comb included.
//
// What bounds it on an H100: bytes, in the count the bound takes.  It reads
// a frame's kc + 1 magnitudes and kc floors (465 and 464 at 44.1 kHz) and
// writes three [8] outputs: at the main path's 8,192 frames a call 30.4 MB,
// 9.3 us at 3.35 TB/s; at the full step's 119,424 frames 0.124 ms.  What
// holds it back below the bytes is issue and latency: the per-peak comb
// chains, the peak scan and the per-frame tail (PERF.md).
//
// Design: persistent blocks of one warp, as many as the card holds at once
// (about 30 an SM), each streaming its frames through shared memory.
// - Frames: block b takes frames b, b + grid, b + 2 * grid, ...  Sections
//   of a call (a noise bed, silence) are consecutive frames, so each block
//   gets a mix of them.
// - Staging: the next frame's magnitude and floor rows go into the frame
//   buffer by `cp.async` as soon as the candidates' ranks are counted (the
//   ghosts, the dedup and the outputs run on registers), behind the frame's
//   tail; the other warps of the SM hide the rest of the latency.  A row
//   starts in its slot at its global address's 16-byte phase (strides such
//   as 465 or 1,025 floats keep rows off alignment): 4-byte copies to the
//   first 16-byte boundary and after the last, 16-byte copies between; each
//   input byte is read from device memory once.
// - Peaks (a lane a bin, branch-free): the comb's row pm (zero off the
//   peaks) and the peaks in bin order (16-bit bins, `__ballot_sync`).
// - A lane a peak: the gate at 5x the floor (a peak under it scores 0, so
//   its logs are skipped), the logs and the interpolation, K2's comb
//   (`comb_candidate`, comb.cuh, so the comb is K2's bit for bit) and the
//   score, written over the peak's floor, which nothing reads again.
// - The frame's max score by shuffles (a NaN max leaves no candidate, as
//   torch's amax), the cutoff and the candidates in bin order, compacted in
//   place (scores over the floors; fractional bins, computed again by the
//   same instructions on the same inputs, over the magnitudes); each
//   candidate's place in the stable descending sort counted (rank =
//   #(greater score) + #(equal score at a lower bin)); ranks < 32 are the
//   top 32, one a lane; ghosts by shuffles (a pair whose product bounds
//   keep the ratio outside (1.9, 5.2) skips the IEEE divisions, which could
//   only pass in (1.94, 5.15)); the dedup as 32 warp-wide `__any_sync`
//   steps in score order; `__popc` gives the kept entries' slots.
// Shared memory a warp at kc = 464: the frame buffer 3.7 KB, pm, the peak
// list and the top 32 3.0 KB.
// Every rounding is the plain version's: products, sums and differences
// are `__fmul_rn` / `__fadd_rn` / `__fsub_rn` (nvcc would contract them),
// the divisions IEEE (`__fdiv_rn`), logf the CUDA math library's as torch
// calls it, log2 the product of logf by float32(1/ln 2) and the division by
// 15 a product by float32(1/15) (XLA's forms, which the plain version
// spells), torch.round `rintf` (half to even).
//
// A probe build (-DK10_PHASE_CYCLES, port_tools/k1_k10_probe.py) stamps
// clock64 between the phases and sums each phase's cycles over the frames:
// `aat_extract_phase_cycles`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "comb.cuh"

namespace {

constexpr int THREADS = 32;               // a block is one warp
constexpr int TOP_K = 32;
constexpr int MAX_NOTES = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2_E = 0x1.715476p+0f;  // float32(1 / float32(ln 2))
constexpr float RECIP_15 = 0x1.111112p-4f;  // float32(1) / float32(15)
constexpr float TINY = 1e-30f;

// Shared memory, in 4-byte words: the frame buffer (the magnitude slot,
// then the floor slot, each a row's length plus 3 words so that the row can
// start at its global address's 16-byte phase), pm [kc], the top 32's
// scores and fractional bins [2 * TOP_K], the peak list [kc] (16-bit bins).
struct Layout {
  int kc, mslot, pm, tops, list, total;
  __host__ __device__ explicit Layout(int kc_)
      : kc(kc_), mslot((kc_ + 4 + 3) & ~3),
        pm(mslot + ((kc_ + 3 + 3) & ~3)), tops(pm + kc_),
        list(tops + 2 * TOP_K), total(list + (kc_ + 1) / 2) {}
};

#ifdef K10_PHASE_CYCLES
// staging wait, peaks, per peak, staging issue, tail; the frames; the
// grid; the sum and the max of the blocks' cycles; the first block's start
// and the last block's end (global timer, ns); the most peaks and
// candidates a frame, the candidates.
__device__ unsigned long long phase_cycles[15];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A row's 16-byte phase in words: where it starts in its slot.
__device__ __forceinline__ int phase_of(const float* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

// The warp copies row[0, len) to dst (dst and row share their 16-byte
// phase): 4-byte copies up to the first 16-byte boundary and after the
// last, 16-byte copies between.
__device__ __forceinline__ void copy_row(float* dst, const float* row,
                                         int len, int lane) {
  const int head = min(len, (4 - phase_of(row)) & 3);
  const int chunks = (len - head) >> 2;
  const int tail = head + 4 * chunks;
  if (lane < head) cp_async4(dst + lane, row + lane);
  for (int c = lane; c < chunks; c += 32) {
    cp_async16(dst + head + 4 * c, row + head + 4 * c);
  }
  if (lane < len - tail) cp_async4(dst + tail + lane, row + tail + lane);
}

// The copies of a frame's rows into the frame buffer.
__device__ __forceinline__ void stage(float* buf, const Layout& lay,
                                      const float* mrow, const float* frow,
                                      int lane) {
  copy_row(buf + phase_of(mrow), mrow, lay.kc + 1, lane);
  copy_row(buf + lay.mslot + phase_of(frow), frow, lay.kc, lane);
  cp_async_commit();
}

struct Interp {
  float fr;
  bool degenerate;
};

// The peak's fractional bin (stft.rs:484-497); a peak beside an exactly
// zero bin gives a non-finite delta and is degenerate.
__device__ __forceinline__ Interp interpolate(const float* m, int k) {
  const float yl = logf(m[k - 1]), yc = logf(m[k]), yr = logf(m[k + 1]);
  const float denom = __fadd_rn(__fsub_rn(yl, __fmul_rn(2.f, yc)), yr);
  const float q = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(yl, yr)), denom);
  const float clamped = isnan(q) ? q : fminf(fmaxf(q, -1.f), 1.f);
  float delta = fabsf(denom) < TINY ? 0.f : clamped;
  const bool degenerate = !isfinite(delta);
  if (degenerate) delta = 0.f;
  return Interp{__fadd_rn(static_cast<float>(k), delta), degenerate};
}

__global__ void __launch_bounds__(THREADS)
extract_kernel(const float* __restrict__ mags, long long mag_stride,
               const float* __restrict__ floors, long long floor_stride,
               float* __restrict__ out_freq, float* __restrict__ out_score,
               bool* __restrict__ out_valid, int n, int kc, int half,
               int min_bin, int max_bin, float bin_width, float min_freq,
               float max_freq) {
  extern __shared__ float smem[];
  const Layout lay(kc);
  const int lane = threadIdx.x;
  const unsigned lower = (1u << lane) - 1u;
  float* pm = smem + lay.pm;                  // [kc]: m at the peaks, else 0
  float* ts = smem + lay.tops;                // top 32: scores
  float* tf = ts + TOP_K;                     //         fractional bins
  uint16_t* pk = reinterpret_cast<uint16_t*>(smem + lay.list);
#ifdef K10_PHASE_CYCLES
  unsigned long long spent[5] = {0, 0, 0, 0, 0};
  int frames_seen = 0;
  const long long entry = clock64();
  if (lane == 0) atomicMin(&phase_cycles[9], global_ns());
#endif

  int f = blockIdx.x;
  if (f < n) {
    stage(smem, lay, mags + static_cast<long long>(f) * mag_stride,
          floors + static_cast<long long>(f) * floor_stride, lane);
  }
  for (; f < n; f += gridDim.x) {
#ifdef K10_PHASE_CYCLES
    const long long c0 = clock64();
#endif
    // This frame's copies have landed (each lane waits for its own, the
    // barrier for all).
    cp_async_wait_all();
    __syncwarp();
#ifdef K10_PHASE_CYCLES
    const long long c1 = clock64();
#endif
    const float* mrow = mags + static_cast<long long>(f) * mag_stride;
    const float* frow = floors + static_cast<long long>(f) * floor_stride;
    float* m = smem + phase_of(mrow);                 // [kc + 1]
    float* fl = smem + lay.mslot + phase_of(frow);    // [kc]: floor, score

    // Peaks (stft.rs:461-469), branch-free: the four reads at once
    // (clamped into the row), the tests joined with & (k < max_bin <= kc
    // keeps the clamp's reads out); pm, and the peaks in bin order.
    int npk = 0;
#pragma unroll 3
    for (int base = 0; base < kc; base += 32) {
      const int k = base + lane;
      const int kk = min(k, kc - 1);
      const float mc = m[kk], ml = m[max(kk - 1, 0)], mr = m[kk + 1];
      const float nf = fl[kk];
      const bool peak = (k >= min_bin + 1) & (k < max_bin) & (mc > nf) &
                        (mc >= ml) & (mc >= mr);
      if (k < kc) pm[k] = peak ? mc : 0.f;
      const unsigned ballot = __ballot_sync(FULL, peak);
      if (peak) pk[npk + __popc(ballot & lower)] = static_cast<uint16_t>(k);
      npk += __popc(ballot);
    }
    __syncwarp();
#ifdef K10_PHASE_CYCLES
    const long long c2 = clock64();
#endif

    // A lane a peak: interpolation (stft.rs:484-497), comb, gates and
    // score (:499-545), the score written over the peak's floor.
    for (int p = lane; p < npk; p += 32) {
      const int k = pk[p];
      const float fund = m[k];
      const float nf = fl[k];
      float s = 0.f;
      // A peak under 5x its floor scores 0 whatever its logs.
      const Interp in = fund < __fmul_rn(nf, 5.f) ? Interp{0.f, true}
                                                  : interpolate(m, k);
      if (!in.degenerate) {
        const CombOut c = comb_candidate(pm, in.fr, fund, k, half, max_bin);
        if (!(c.longest_run < 3 && fund < __fmul_rn(15.f, nf))) {
          const float log_score =
              __fmul_rn(logf(__fadd_rn(0.5f, c.score)), LOG2_E);
          const float struct_mult = __fmul_rn(
              __fadd_rn(__fadd_rn(1.f, static_cast<float>(c.longest_run)),
                        __fmul_rn(static_cast<float>(c.total_harms), 0.5f)),
              RECIP_15);
          s = __fmul_rn(log_score, struct_mult);
        }
      }
      fl[k] = s;
    }
    __syncwarp();
#ifdef K10_PHASE_CYCLES
    const long long c3 = clock64();
#endif

    // The frame's max score, NaN kept.
    float mx = 0.f;
    bool nan_seen = false;
    for (int p = lane; p < npk; p += 32) {
      const float s = fl[pk[p]];
      if (isnan(s)) {
        nan_seen = true;
      } else {
        mx = fmaxf(mx, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    }
    const float max_score =
        __any_sync(FULL, nan_seen) ? __int_as_float(0x7fffffff) : mx;
    const float cutoff = __fmul_rn(max_score, 0.5f);
    const bool any = max_score > 0.f;

    // Candidates (stft.rs:547-562), compacted in bin order: scores to
    // fl[c], fractional bins to m[c].  Candidate c is peak p >= c at bin
    // k >= p + 2, so a write lands below every bin a later chunk reads; a
    // chunk reads before it writes.
    float* cs = fl;
    float* cf = m;
    int nc = 0;
    for (int base = 0; base < npk; base += 32) {
      const int p = base + lane;
      float s = 0.f, fr = 0.f;
      bool cand = false;
      if (p < npk) {
        const int k = pk[p];
        s = fl[k];
        cand = any && s >= cutoff;
        if (cand) fr = interpolate(m, k).fr;
      }
      const unsigned ballot = __ballot_sync(FULL, cand);
      __syncwarp();
      if (cand) {
        const int c = nc + __popc(ballot & lower);
        cs[c] = s;
        cf[c] = fr;
      }
      nc += __popc(ballot);
    }
    __syncwarp();

    // Top 32 by score, ties to the lower bin: each candidate's rank in the
    // stable descending sort.
    for (int c = lane; c < nc; c += 32) {
      const float s = cs[c];
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < nc; ++j) {
        const float sj = cs[j];
        rank += sj > s || (sj == s && j < c);
      }
      if (rank < TOP_K) {
        ts[rank] = s;
        tf[rank] = cf[c];
      }
    }
    __syncwarp();
#ifdef K10_PHASE_CYCLES
    const long long c3t = clock64();
#endif
    // The frame buffer is read no more: the next frame's copies, behind
    // this frame's ghosts, dedup and outputs.
    const int next = f + gridDim.x;
    if (next < n) {
      stage(smem, lay, mags + static_cast<long long>(next) * mag_stride,
            floors + static_cast<long long>(next) * floor_stride, lane);
    }
#ifdef K10_PHASE_CYCLES
    const long long c3s = clock64();
    if (lane == 0) {
      atomicMax(&phase_cycles[12], static_cast<unsigned long long>(npk));
      atomicMax(&phase_cycles[13], static_cast<unsigned long long>(nc));
      atomicAdd(&phase_cycles[14], static_cast<unsigned long long>(nc));
    }
#endif

    const int ntop = min(nc, TOP_K);
    const bool valid = lane < ntop;
    const float score = valid ? ts[lane] : 0.f;
    const float cfrac = valid ? tf[lane] : 0.f;
    const float cfreq = __fmul_rn(cfrac, bin_width);

    // Harmonic ghosts (stft.rs:564-589).  The test needs the IEEE ratio in
    // (1.94, 5.15) (nearest in [2, 5], within 3% of it): a pair whose
    // product bounds put it outside (1.9, 5.2) skips the divisions.
    bool ghost = false;
#pragma unroll 4
    for (int j = 0; j < ntop; ++j) {
      const float fj = __shfl_sync(FULL, cfreq, j);
      const float sj = __shfl_sync(FULL, score, j);
      const float den = fmaxf(fj, TINY);
      if (valid && j != lane && score < __fmul_rn(sj, 1.05f) &&
          cfreq > __fmul_rn(den, 1.9f) && cfreq < __fmul_rn(den, 5.2f)) {
        const float ratio = __fdiv_rn(cfreq, den);
        const float nearest = rintf(ratio);
        if (nearest >= 2.f && nearest <= 5.f &&
            fabsf(__fsub_rn(__fdiv_rn(ratio, fmaxf(nearest, TINY)), 1.f)) <
                0.03f) {
          ghost = true;
        }
      }
    }
    const bool cvalid = valid && !ghost;

    // Greedy dedup by 2-bin separation in score order (stft.rs:594-605).
    bool kept = false;
    for (int i = 0; i < ntop; ++i) {
      const float fi = __shfl_sync(FULL, cfrac, i);
      const bool conflict =
          __any_sync(FULL, kept && fabsf(__fsub_rn(cfrac, fi)) < 2.f);
      if (lane == i) kept = cvalid && !conflict;
    }

    // The first MAX_NOTES kept, in score order (stft.rs:606-619), and the
    // frequency range.
    const unsigned kept_mask = __ballot_sync(FULL, kept);
    const int slot = __popc(kept_mask & lower);
    const int nkept = min(__popc(kept_mask), MAX_NOTES);
    const long long o = static_cast<long long>(f) * MAX_NOTES;
    if (kept && slot < MAX_NOTES) {
      out_freq[o + slot] = cfreq;
      out_score[o + slot] = score;
      out_valid[o + slot] = cfreq >= min_freq && cfreq <= max_freq;
    }
    if (lane >= nkept && lane < MAX_NOTES) {
      out_freq[o + lane] = 0.f;
      out_score[o + lane] = 0.f;
      out_valid[o + lane] = false;
    }
#ifdef K10_PHASE_CYCLES
    __syncwarp();
    const long long c4 = clock64();
    spent[0] += c1 - c0;
    spent[1] += c2 - c1;
    spent[2] += c3 - c2;
    spent[3] += c3s - c3t;
    spent[4] += (c3t - c3) + (c4 - c3s);
    ++frames_seen;
#endif
  }
#ifdef K10_PHASE_CYCLES
  if (lane == 0) {
    for (int j = 0; j < 5; ++j) atomicAdd(&phase_cycles[j], spent[j]);
    atomicAdd(&phase_cycles[5],
              static_cast<unsigned long long>(frames_seen));
    atomicMax(&phase_cycles[6], static_cast<unsigned long long>(gridDim.x));
    const unsigned long long block = clock64() - entry;
    atomicAdd(&phase_cycles[7], block);
    atomicMax(&phase_cycles[8], block);
    atomicMax(&phase_cycles[10], global_ns());
  }
#endif
}

// The grid: as many blocks as the card holds at once, cached for the last
// (device, shared memory) pair.
cudaError_t grid_cap(size_t smem, int* cap) {
  static std::mutex mu;
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  static int cached_cap = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != cached_dev || smem != cached_smem) {
    // All the SM's unified memory as shared memory: without it the driver
    // may carve out room for fewer blocks than the grid is sized for.
    err = cudaFuncSetAttribute(extract_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(extract_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                        extract_kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_cap = per_sm * sms;
  }
  *cap = cached_cap;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  mags rows
// hold >= kc + 1 magnitudes, floor rows >= kc floors, each with unit
// stride; requires 0 < max_bin <= kc < half.
int aat_extract(const float* mags, long long mag_stride, const float* floors,
                long long floor_stride, float* freq, float* score,
                bool* valid, int n, int kc, int half, int min_bin,
                int max_bin, float bin_width, float min_freq, float max_freq,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (max_bin <= 0 || max_bin > kc || kc >= half || kc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(Layout(kc).total) * sizeof(float);
  int cap = 0;
  const cudaError_t err = grid_cap(smem, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  extract_kernel<<<min(n, cap), THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      mags, mag_stride, floors, floor_stride, freq, score, valid, n, kc,
      half, min_bin, max_bin, bin_width, min_freq, max_freq);
  return static_cast<int>(cudaGetLastError());
}

#ifdef K10_PHASE_CYCLES
// Copies the sums to out[15] (see `phase_cycles`) and, with reset, zeroes
// them (the first start to the largest value).
int aat_extract_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[15] = {};
    zero[9] = ~0ull;
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

}  // extern "C"
