// Two-tier k-select (kernel K3), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel of scripts/probe_cond.py (`kernel`, launched by
// pl.pallas_call at :50), the TPU probe of the two-tier k-select pattern. It
// computes what npore_tpu_torch/ops/tier_select.py::tier_select_plain
// computes, bit for bit, for x (W, Qx, LANES) f32 and the first Q rows:
//
//   acc = 0; run = run0 (zeros in the probe)
//   for i in 0..N-1:
//     k   = run % 23 + i % 7                       (floor modulo)
//     cv  = x[w, (k-1) % Q, lane] if 1 <= k <= 12 else 1e9
//     acc = acc + (cv < 1e9 ? cv : 0)               (float32, in i order)
//     run = run + 1
//   out[w, lane] = acc
//
// Per step the TPU kernel took a scalar predicate `any(4 < k <= 12)` over
// its whole (W, 128) tile (`lax.cond`, probe_cond.py:42-43) and ran either
// a 12-rung or a 4-rung `where` ladder over its VMEM score tile. Here:
//   * one thread per element of the (W, LANES) output, in row-major order,
//     in CTAs of 128 threads (one warp per scheduler of an SM); a warp may
//     span two rows w where LANES is not a multiple of 32. At the probe's
//     shape that is 32 CTAs of 4 warps, each warp on its own scheduler, so
//     a step costs one warp's latency, not an SM's issue rate;
//   * each thread loads the 12 rungs of its own column once, straight from
//     device memory into registers (consecutive threads read consecutive
//     addresses, so each rung is one coalesced load); a thread never reads
//     another's column, so shared memory would only add a copy;
//   * the tier predicate is a warp vote, `__any_sync`, the warp-uniform
//     counterpart of the TPU's scalar `lax.cond`; the step runs the
//     template-unrolled ladder<12> or ladder<4> of register selects with no
//     divergence, and no block-wide barrier in the N steps; acc and run
//     stay in registers; acc is written once.
// The per-warp predicate is exact although the TPU's was tile-wide:
// ladder<4> is taken only when no element of the warp has k in 5..12, and
// on every other k the two ladders agree (a rung value for 1..4, the
// sentinel past 12 or below 1). Threads past the last element vote false
// and store nothing, so every lane of a warp reaches every vote.
//
// What bounds it: at the probe's shape (32, 16, 128), N = 256, the function
// moves about 0.2 MB, well under a microsecond at 3.35 TB/s, and does about
// 2 float ops per element and step; the launch and the warp's 256 dependent
// steps set its time. Build without fast-math and without FMA contraction:
// the adds stay float32 adds in i order (`__fadd_rn`), so the result is
// bit-equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUNGS = 12;     // the full ladder
constexpr int LOW = 4;        // the low tier
constexpr float SENT = 1e9f;  // sentinel of an empty select
constexpr int BLOCK = 128;    // threads a CTA

template <int K>
__device__ __forceinline__ float ladder(int k, const float (&rung)[RUNGS]) {
  float cv = SENT;
#pragma unroll
  for (int kk = 1; kk <= K; ++kk) cv = (k == kk) ? rung[kk - 1] : cv;
  return cv;
}

__global__ void __launch_bounds__(BLOCK)
tier_select_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ run0, float* __restrict__ out,
                   int W, int Qx, int Q, int lanes, int n_steps) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = g < W * lanes;
  float rung[RUNGS];
  int run = 0;
  if (live) {
    const int w = g / lanes, lane = g % lanes;
    const float* col = x + (size_t)w * Qx * lanes + lane;
#pragma unroll
    for (int kk = 1; kk <= RUNGS; ++kk)
      rung[kk - 1] = __ldg(col + (size_t)((kk - 1) % Q) * lanes);
    if (run0) run = run0[g];
  } else {
#pragma unroll
    for (int kk = 0; kk < RUNGS; ++kk) rung[kk] = 0.0f;
  }
  float acc = 0.0f;
#pragma unroll 4      // the votes and ladders of 4 steps overlap
  for (int i = 0; i < n_steps; ++i) {
    int m = run % 23;
    if (m < 0) m += 23;
    const int k = m + i % 7;
    const bool need = __any_sync(0xffffffffu, live && k > LOW && k <= RUNGS);
    const float cv = need ? ladder<RUNGS>(k, rung) : ladder<LOW>(k, rung);
    acc = __fadd_rn(acc, cv < SENT ? cv : 0.0f);
    ++run;
  }
  if (live) out[g] = acc;
}

}  // namespace

extern "C" int npore_tier_select(const void* x, const void* run0, void* out,
                                 int W, int Qx, int Q, int lanes,
                                 int n_steps, void* stream) {
  if (W <= 0 || lanes <= 0) return 0;
  const int n = W * lanes;
  tier_select_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)run0, (float*)out, W, Qx, Q, lanes,
      n_steps);
  return (int)cudaGetLastError();
}
