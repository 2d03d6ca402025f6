// Traceback over the packed MAT planes (kernel K2), CUDA C++ for sm_90a.
//
// Replaces npore_tpu/ops/pallas_dp.py::tb_kernel (get_tb_call), the TPU
// backward traceback (reference: src/aln.pyx:670-742). It computes what
// npore_tpu_torch/ops/traceback.py::traceback computes, byte for byte: from
// (n_ins, n_del) it reads typ | run << 3 at (t = arow + acol,
// lane = inss[t] - arow + r); INS/LEN runs emit 'I', DEL/SHR runs 'D', MAT
// runs '='/'X' from the bases. A window bails on t outside [0, R), a lane
// outside the band, run < 1, an unknown type, an I/D run longer than
// arow/acol, or a MAT run that reaches row 0 or column 0 before the other;
// the bailing step emits nothing, the bytes before it stay. A MAT run that
// reaches (0, 0) stops there without a bail. The TPU kernel emitted 4-bit
// (op | count << 2) slots for its slow device-to-host link; this one writes
// the CIGAR bytes right-aligned at column n_ins + n_del of the window's row,
// plus (length, bail) in a header of the same buffer.
//
// What bounds it: the walk is a chain of dependent steps (the next cell's
// address depends on this cell's type and run), a few hundred to a few
// thousand a window, so latency, not bytes, sets its time: the path cells
// it needs are ~2.4 MB of the 368.8 MB of planes a 1024 x 1407 group holds.
// Each device-memory load on the chain would cost a step hundreds of cycles.
//
// This design takes device memory off the chain and pays in bandwidth:
//   * one warp a window, all lanes in lockstep on the same (arow, acol, t),
//     so each shared-memory read of the chain is a broadcast and no branch
//     diverges; launch_plan (ops/tb_cuda.py) puts up to 8 windows in a CTA
//     so that a 1024-window group runs in one wave on 132 SMs;
//   * t only decreases, and the rows [t0 - T, t0) of a window's planes are
//     one contiguous run of T x 256 bytes (its inss rows likewise), so the
//     warp streams them backward, from row n_ins + n_del down to 0, in tiles
//     of T rows through a private ring of STAGES tiles in shared memory,
//     STAGES - 1 tiles ahead of the walk. A step reads inss[8 + t] and the
//     cell from shared memory; its only wait is on a tile that has not
//     landed, requested tiles earlier. Rows the walk skips are streamed all
//     the same: the card has bandwidth to spare, and the walk cannot know
//     ahead which rows it needs;
//   * a tile's plane rows come by one TMA 1-D bulk copy (cp.async.bulk,
//     issued by lane 0, completing on the slot's mbarrier), its inss rows by
//     cp.async of 4 bytes a lane (one commit group a tile). A window's inss
//     row starts at 4 * (w * (R + 8) + 8) bytes, not 16-byte aligned as a
//     bulk copy needs. The planes too can come by cp.async, 16 bytes a
//     lane, with no mbarrier to keep; on the H100 that streamed as fast at
//     8 windows an SM, but at one window an SM the warp's own requests (T / 2
//     a lane a tile) kept too few bytes in flight, and a 20,000-row window
//     streamed several times slower than by bulk copies. The warp is its
//     own producer and consumer and takes tiles in the order it asked for
//     them, so a slot's phase is (tile / STAGES) & 1;
//   * emission is off the chain: a run's bytes are written by the lanes
//     together, 32 a store, MAT bytes first as a placeholder; after the walk
//     the warp rewrites the placeholders to '='/'X' in one backward pass,
//     32 positions a lane-step and four steps' base loads in flight at once,
//     with each position's (arow, acol) recovered from the ops after it by
//     ballot and popcount.
// Nothing assumes a window fits in shared memory: at max_b_rows = 20000 a
// window's planes are 5.12 MB, and the ring holds STAGES tiles of T rows
// whatever R is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LW = 64;
constexpr int PADL = 80;
constexpr int INS = 1, LEN = 2, DEL = 3, SHR = 4;   // MAT = 0
constexpr int STAGES = 4;               // tiles in a warp's ring
constexpr int MAX_WARPS = 8;            // windows a CTA at most
constexpr int ROW_BYTES = LW * 4 + 4;   // a plane row and its inss count
constexpr int PLANE_ROW = LW * 4;       // bytes of a plane row
constexpr int FIX_STEPS = 4;            // 32-byte steps of the pass in flight
constexpr uint8_t OP_M = 'M';           // placeholder of a MAT byte
constexpr unsigned FULL = 0xffffffffu;

// a warp's ring: STAGES tiles of plane rows, their inss rows, and one
// mbarrier a tile
__host__ __device__ constexpr size_t smem_bytes(int tile_rows, int warps) {
  return (size_t)warps * STAGES * ((size_t)tile_rows * ROW_BYTES + 8);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int ld_buf(const int8_t* buf, int A, int x) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)buf[p] : 0;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

struct Ring {
  int32_t* rows;      // STAGES x T plane rows
  int32_t* ins;       // STAGES x T inss counts
  uint64_t* bar;      // STAGES mbarriers, one a slot
};

// Tile k of a walk that starts at row h - 1 holds rows
// [max(h - (k + 1) T, 0), h - k T), in ring slot k % STAGES. Every call
// commits one cp.async group, empty past the last tile, so the wait counts
// hold; the slot's mbarrier completes a phase only for a tile that exists.
__device__ __forceinline__ void issue_tile(int k, int h, int T,
                                           const Ring& ring,
                                           const int32_t* pk,
                                           const int32_t* inss, int lane) {
  const int hi = h - k * T;
  if (hi > 0) {
    const int lo = max(hi - T, 0);
    const int slot = k % STAGES;
    if (lane == 0) {
      const unsigned bytes = (hi - lo) * PLANE_ROW;
      const unsigned bar = smem_addr(ring.bar + slot);
      // the slot's last reads (generic proxy) before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(ring.rows + (size_t)slot * T * LW)),
          "l"(pk + (size_t)lo * LW), "r"(bytes), "r"(bar)
          : "memory");
    }
    int32_t* idst = ring.ins + slot * T;
    for (int i = lane; i < hi - lo; i += 32)
      cp_async4(idst + i, inss + 8 + lo + i);
  }
  cp_commit();
}

// Waits until tile k has landed, in every lane.
__device__ __forceinline__ void tile_wait(int k, const Ring& ring) {
  cp_wait<STAGES - 1>();
  bar_wait(ring.bar + k % STAGES, (k / STAGES) & 1);
  __syncwarp();
}

__global__ void __launch_bounds__(32 * MAX_WARPS)
traceback_kernel(const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ inss_all,
                 const int8_t* __restrict__ seqbuf,
                 const int8_t* __restrict__ refbuf,
                 const int32_t* __restrict__ n_ins_a,
                 const int32_t* __restrict__ n_del_a,
                 int32_t* __restrict__ meta, uint8_t* __restrict__ cig_all,
                 int B, int R, int A, int L, int r, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + wid;
  if (w >= B) return;          // the whole warp; no block barrier follows
  Ring ring;
  ring.rows = (int32_t*)(smem + smem_bytes(T, wid));
  ring.ins = ring.rows + STAGES * T * LW;
  ring.bar = (uint64_t*)(ring.ins + STAGES * T);
  const int32_t* pk = packed + (size_t)w * R * LW;
  const int32_t* inss = inss_all + (size_t)w * (R + 8);
  uint8_t* cig = cig_all + (size_t)w * L;
  const int n_ins = n_ins_a[w], n_del = n_del_a[w];
  int arow = n_ins, acol = n_del;
  const int end = arow + acol;
  const int h = (end >= 0 && end < R) ? end + 1 : 0;   // rows [0, h)

  if (lane == 0) {
    for (int k = 0; k < STAGES; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(ring.bar + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < STAGES; ++k) issue_tile(k, h, T, ring, pk, inss, lane);
  int c = 0;                   // the tile the walk is in
  int lo = max(h - T, 0);      // its first row
  int base = -lo;               // ring row of walk row t: base + t
  if (h > 0) tile_wait(0, ring);

  int pos = end, bail = 0;
  while (arow > 0 || acol > 0) {
    const int t = arow + acol;
    if ((unsigned)t >= (unsigned)R) { bail = 1; break; }
    while (t < lo) {           // left tile c: its slot takes tile c + STAGES
      __syncwarp();
      issue_tile(c + STAGES, h, T, ring, pk, inss, lane);
      ++c;
      lo = max(h - (c + 1) * T, 0);
      base = (c % STAGES) * T - lo;
      tile_wait(c, ring);
    }
    const int row = base + t;
    const int ln = ring.ins[row] - arow + r;
    if ((unsigned)ln >= (unsigned)LW) { bail = 1; break; }
    const int v = ring.rows[row * LW + ln];
    const int typ = v & 7, run = v >> 3;
    if (run < 1 || typ > SHR) { bail = 1; break; }
    int n = run;
    uint8_t op;
    if (typ == INS || typ == LEN) {
      if (run > arow) { bail = 1; break; }
      op = 'I';
      arow -= run;
    } else if (typ == DEL || typ == SHR) {
      if (run > acol) { bail = 1; break; }
      op = 'D';
      acol -= run;
    } else {                   // MAT: stops at (0, 0), bails at one edge
      const int m = min(arow, acol);
      n = max(min(run, m), 0);
      bail = run > m && arow != acol;
      op = OP_M;
      arow -= n;
      acol -= n;
    }
    for (int k = lane; k < n; k += 32) cig[pos - n + k] = op;
    pos -= n;
    if (bail) break;
  }

  // MAT placeholders -> '='/'X', backward from the end: the byte at p
  // consumes seq[a - 1] and ref[c - 1], where (a, c) = (n_ins, n_del) less
  // the rows and columns of the ops after p.
  __syncwarp();
  const int8_t* seq = seqbuf + (size_t)w * A;
  const int8_t* ref = refbuf + (size_t)w * A;
  const unsigned below = (1u << lane) - 1;
  int a = n_ins, cc = n_del;
  for (int hi = end; hi > pos; hi -= 32 * FIX_STEPS) {
    int p[FIX_STEPS], op[FIX_STEPS], sa[FIX_STEPS], sc[FIX_STEPS];
#pragma unroll
    for (int u = 0; u < FIX_STEPS; ++u) {
      p[u] = hi - 1 - 32 * u - lane;
      op[u] = p[u] >= pos ? cig[p[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < FIX_STEPS; ++u) {
      const unsigned rows = __ballot_sync(FULL, op[u] && op[u] != 'D');
      const unsigned cols = __ballot_sync(FULL, op[u] && op[u] != 'I');
      sa[u] = a - __popc(rows & below) - 1;
      sc[u] = cc - __popc(cols & below) - 1;
      a -= __popc(rows);
      cc -= __popc(cols);
    }
#pragma unroll
    for (int u = 0; u < FIX_STEPS; ++u)
      if (op[u] == OP_M)
        cig[p[u]] = ld_buf(seq, A, sa[u]) == ld_buf(ref, A, sc[u]) ? '=' : 'X';
  }
  if (lane == 0) {
    meta[2 * w] = end - pos;
    meta[2 * w + 1] = bail;
  }
  // the copies still in flight land before the warp leaves
  for (int k = c + 1; k < c + STAGES && h - k * T > 0; ++k)
    bar_wait(ring.bar + k % STAGES, (k / STAGES) & 1);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// tile_rows: rows a ring tile holds; windows_per_cta: warps a CTA (each its
// own window); both from npore_tpu_torch/ops/tb_cuda.py::launch_plan. The
// dynamic shared memory is windows_per_cta x STAGES x (tile_rows x 260 + 8)
// bytes.
extern "C" int npore_traceback(const void* packed, const void* inss,
                               const void* seqbuf, const void* refbuf,
                               const void* n_ins, const void* n_del,
                               void* meta, void* cig, int B, int R, int A,
                               int L, int r, int tile_rows,
                               int windows_per_cta, void* stream) {
  if (B <= 0) return 0;
  if (tile_rows < 1 || windows_per_cta < 1 || windows_per_cta > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tile_rows, windows_per_cta);
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (B + windows_per_cta - 1) / windows_per_cta;
  traceback_kernel<<<ctas, 32 * windows_per_cta, smem,
                     (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const int32_t*)inss, (const int8_t*)seqbuf,
      (const int8_t*)refbuf, (const int32_t*)n_ins, (const int32_t*)n_del,
      (int32_t*)meta, (uint8_t*)cig, B, R, A, L, r, tile_rows);
  return (int)cudaGetLastError();
}

// CTAs of the kernel resident on one SM at this launch plan, or minus the
// CUDA error.
extern "C" int npore_traceback_occupancy(int tile_rows, int windows_per_cta) {
  const size_t smem = smem_bytes(tile_rows, windows_per_cta);
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, traceback_kernel, 32 * windows_per_cta, smem);
  return err == cudaSuccess ? n : -(int)err;
}
