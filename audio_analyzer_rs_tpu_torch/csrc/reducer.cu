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
// fma -> fma -> y1), the envelope's compare-select-FMA.  The bytes (2 x B
// x T x 4) are small beside the chain at any B the full step uses, but
// with B / 32 blocks the loads must be deep in flight to stay off it.  So
// the design is a thread a stream and stage:
//  - each stage's state (a biquad's x1 x2 y1 y2; the envelope and the hold
//    counter) stays in registers for all T samples;
//  - a block is 32 streams; their samples pass through shared memory as
//    32 x 32 tiles, read and written along the samples so that the global
//    loads and stores coalesce (row pitch 33 floats: a lane walking its
//    row hits a bank of its own);
//  - the block's three warps are a pipeline, one stage each (HPF, LPF,
//    gate), a block barrier a tile: a sample costs about the longest
//    stage's chain, not the sum of the three;
//  - the input tiles come in by cp.async, DEPTH - 1 tiles ahead of the
//    HPF warp, so device memory's latency is paid once, not once a tile.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                        // samples a tile
constexpr int PITCH = TILE + 1;                 // a row's floats in shared
constexpr int DEPTH = 6;                        // input tiles in flight
constexpr float THRESHOLD = 0x1.0624dep-10f;    // float32(10^(-60/20))
constexpr float GAIN_SCALE = 0x1.d1a942p+39f;   // float32 (1/threshold)^4

struct Params {
  float hb0, hb1, hb2, ha1, ha2;     // the HPF's coefficients
  float lb0, lb1, lb2, la1, la2;     // the LPF's
  float rel, c1;                     // release coefficient, 1 - rel
  int hold_samples;
};

struct Biquad {
  float x1, x2, y1, y2;
  __device__ __forceinline__ float step(float x, float b0, float b1,
                                        float b2, float a1, float a2) {
    const float y = fmaf(-a2, y2, fmaf(-a1, y1,
        fmaf(b2, x2, fmaf(b0, x, __fmul_rn(b1, x1)))));
    x2 = x1;
    x1 = x;
    y2 = y1;
    y1 = y;
    return y;
  }
};

// Copy 4 bytes from global to shared memory asynchronously (cp.async).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;");
}

// Wait until at most DEPTH - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(DEPTH - 1));
}

// The gate on one sample l (after the biquads); returns the gated sample.
__device__ __forceinline__ float gate(float l, float& env, int& hold,
                                      float rel, float c1, int hold_samples) {
  const float a = fabsf(l);
  const bool attack = a > env;
  const float blend = fmaf(rel, env, __fmul_rn(c1, a));
  env = attack ? a : blend;
  hold = attack ? hold_samples : hold;
  const bool above = env >= THRESHOLD;
  const bool in_hold = !above && hold > 0;
  const float e4 = __fmul_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(env, env), env), env), GAIN_SCALE);
  const float gain = above || in_hold ? 1.0f : e4;
  hold = in_hold ? hold - 1 : hold;
  return __fmul_rn(l, gain);
}

// f over a lane's row of n samples, from `in` to `out`: a whole tile in
// registers and unrolled, with no per-sample guard; the last, partial tile
// sample by sample.
template <class F>
__device__ __forceinline__ void run_row(const float* in, float* out, int n,
                                        F f) {
  if (n == TILE) {
    float v[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) v[j] = in[j];
#pragma unroll
    for (int j = 0; j < TILE; ++j) v[j] = f(v[j]);
#pragma unroll
    for (int j = 0; j < TILE; ++j) out[j] = v[j];
  } else {
    for (int j = 0; j < n; ++j) out[j] = f(in[j]);
  }
}

// A block is three warps over the same 32 streams, one stage each: warp 0
// the HPF, warp 1 the LPF, warp 2 the gate and the store.  In step k warp 0
// runs tile k, warp 1 tile k-1, warp 2 tile k-2, each over its lane's row
// of a 32 x 32 tile in shared memory (double-buffered between the stages),
// and one block barrier ends the step.  A stage's chain is its own
// recurrence only (two feedback FMAs, or the envelope's FMA and select),
// so a sample costs about the longest of the three, not their sum.
// GATE_ONLY: warps 0 and 1 pass the samples through.
template <bool GATE_ONLY>
__global__ void __launch_bounds__(3 * TILE)
reducer_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ st_in,
               const int32_t* __restrict__ hold_in,
               float* __restrict__ st_out, int32_t* __restrict__ hold_out,
               int B, int T, Params p) {
  __shared__ float xt[DEPTH][TILE * PITCH];  // warp 0's input ring
  __shared__ float ht[2][TILE * PITCH];      // HPF out, LPF in
  __shared__ float lt[2][TILE * PITCH];      // LPF out, gate in
  const int lane = threadIdx.x & 31;
  const int stage = threadIdx.x >> 5;
  const int b0 = blockIdx.x * TILE;        // the block's first stream
  const int b = b0 + lane;                 // this lane's stream
  const int rows = min(TILE, B - b0);
  const bool live = b < B;
  const int tiles = (T + TILE - 1) / TILE;

  // This warp's constants in registers: its biquad's coefficients, or the
  // gate's.
  const float cb0 = stage == 0 ? p.hb0 : p.lb0;
  const float cb1 = stage == 0 ? p.hb1 : p.lb1;
  const float cb2 = stage == 0 ? p.hb2 : p.lb2;
  const float ca1 = stage == 0 ? p.ha1 : p.la1;
  const float ca2 = stage == 0 ? p.ha2 : p.la2;
  const float rel = p.rel, c1 = p.c1;
  const int hold_samples = p.hold_samples;
  Biquad bq{0, 0, 0, 0};
  float env = 0.0f;
  int hold = 0;
  if (live) {
    const float* s = st_in + (long long)b * 9;
    if (stage < 2) bq = Biquad{s[4 * stage], s[4 * stage + 1],
                               s[4 * stage + 2], s[4 * stage + 3]};
    env = s[8];
    hold = hold_in[b];
  }

  // Warp 0 keeps DEPTH - 1 input tiles in flight: tile t's copies are
  // one commit group, issued DEPTH - 1 steps before tile t runs.
  auto issue = [&](int t) {
    if (t < tiles) {
      float* dst = xt[t % DEPTH];
      const int col = t * TILE + lane;
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        if (r < rows && col < T) {
          copy_async(dst + r * PITCH + lane, x + (long long)(b0 + r) * T + col);
        } else {
          dst[r * PITCH + lane] = 0.0f;
        }
      }
    }
    copy_commit();
  };
  if (stage == 0) {
    for (int t = 0; t < DEPTH - 1; ++t) issue(t);
  }
  for (int k = 0; k < tiles + 2; ++k) {
    const int tk = k - stage;              // the tile this stage runs
    if (tk >= 0 && tk < tiles) {
      const int t0 = tk * TILE;
      const int n = min(TILE, T - t0);
      const int buf = tk & 1;
      float* in = stage == 0 ? xt[tk % DEPTH] : stage == 1 ? ht[buf]
                                                           : lt[buf];
      float* out = stage == 0 ? ht[buf] : lt[buf];
      if (stage == 0) {
        issue(tk + DEPTH - 1);
        copy_wait();
        __syncwarp();
      }
      // The lane's row through this warp's stage.
      const float* row_in = in + lane * PITCH;
      float* row_out = out + lane * PITCH;
      if (stage < 2 && !GATE_ONLY) {
        run_row(row_in, row_out, n, [&](float v) {
          return bq.step(v, cb0, cb1, cb2, ca1, ca2);
        });
      } else if (stage < 2) {
        run_row(row_in, row_out, n, [](float v) { return v; });
      } else {
        run_row(row_in, row_out, n, [&](float v) {
          return gate(v, env, hold, rel, c1, hold_samples);
        });
      }
      if (stage == 2) {
        __syncwarp();
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          if (r < rows && t0 + lane < T) {
            y[(long long)(b0 + r) * T + t0 + lane] = out[r * PITCH + lane];
          }
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    float* s = st_out + (long long)b * 9;
    if (stage < 2) {
      s[4 * stage] = bq.x1;
      s[4 * stage + 1] = bq.x2;
      s[4 * stage + 2] = bq.y1;
      s[4 * stage + 3] = bq.y2;
    } else {
      s[8] = env;
      hold_out[b] = hold;
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).  x, y [B, T]
// contiguous; st_in, st_out [B, 9] (hp x1 x2 y1 y2, lp x1 x2 y1 y2,
// envelope); hold_in, hold_out [B].  gate_only: the gate alone (the biquad
// state passes through).  T >= 1.
int aat_reducer_scan(const float* x, float* y, const float* st_in,
                     const int32_t* hold_in, float* st_out,
                     int32_t* hold_out, int B, int T, int gate_only,
                     float hb0, float hb1, float hb2, float ha1, float ha2,
                     float lb0, float lb1, float lb2, float la1, float la2,
                     float rel, float c1, int hold_samples, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{hb0, hb1, hb2, ha1, ha2, lb0, lb1, lb2, la1, la2,
                 rel, c1, hold_samples};
  const dim3 grid((B + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate_only) {
    reducer_kernel<true><<<grid, 3 * TILE, 0, s>>>(
        x, y, st_in, hold_in, st_out, hold_out, B, T, p);
  } else {
    reducer_kernel<false><<<grid, 3 * TILE, 0, s>>>(
        x, y, st_in, hold_in, st_out, hold_out, B, T, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
