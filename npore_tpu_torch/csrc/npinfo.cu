// n-polymer scan (kernel K4), CUDA C++ for sm_90a.
//
// Replaces the JAX engine's device scan npore_tpu/ops/npinfo_device.py::
// np_info_device (an XLA composite of cummin and segmented associative
// scans, run from engine/prepass.py ahead of the DP kernel). It computes
// what npore_tpu_torch/ops/npinfo_device.py::np_info_device computes, and
// writes it as the group buffer's int8 planes l_seq/lidx_seq/l_ref/lidx_ref
// (B, A, max_n), position-major, periods minor, byte for byte what the
// host packer engine/windows.py::pack_group writes from the C++ np_info:
//
//   for each period n = 1..max_n, in order (qualification at n reads the
//   finished, clamped L of every shorter period at the same start):
//     raw[p]  = t/n + 1 if t/n > 0 else 0, t the run of seq[q] == seq[q+n]
//               from p (q + n inside the row);
//     qual[p] = raw > 2 and seq[p] != N and raw*n > L[p][n2]*n2, all n2 < n;
//     p - n links to p when raw[p - n] > 0 (its run spans n more); the
//     links cut each residue class mod n into chains, and a start covers
//     its chain from itself to the chain's end;
//     the winner w of p is the last qualifying chain predecessor with
//     raw > max_l, else the first qualifying one;
//     L = min(raw[w], max_l), L_IDX = (p - w) / n; 0 and 0 if none.
//
// A row's length is its window's slice, as the reference scans it:
// min(n_ins + 1, seq_guard) bases of seq, min(n_del + 1, ref_guard) of ref
// (the +1 lookahead clipped at the read's end). The buffer's zero padding
// alone would not do: an N (0) inside the row matches it.
//
// Design, one CTA per (window, side) row, grid (B, 2):
//   * the row's length comes from the window's scalars; the row goes to
//     shared memory, and the planes are zero outside it;
//   * each thread owns a contiguous chunk of positions;
//   * run lengths: each thread finds its chunk's first mismatch, a block
//     suffix-min gives the first mismatch after the chunk, and a backward
//     pass over the chunk writes raw[] (uint16) to shared memory;
//   * winners: for each residue class r, each thread folds its chunk's
//     positions of class r into a (first, last-big, no-reset) triple; a
//     block exclusive segmented scan of the triples gives each chunk its
//     incoming state, and a second pass over the chunk writes
//     L | L_IDX << 8 per position to shared memory;
//   * the period's bytes then go out with neighbouring threads on
//     neighbouring positions (stride max_n), and each position keeps
//     max(L * n) over finished periods in shared memory for qualification.
// Shared memory: 7 bytes a position (row, raw, max L*n, output), about
// 141 KB at a whole-contig window of 20,121 positions.
// What bounds it: the function reads 2 bytes and writes 4 * max_n bytes a
// position (12 us at a 1024-window x 1407-row group, 3.35 TB/s); this first
// design pays a chain of block barriers, 3 a residue class, and byte
// stores at stride max_n. It is kept simple and right; its time is in
// PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PADL = 80;            // left zero-padding of per-window rows
constexpr int MAXN = 8;             // periods the kernel handles
constexpr int MAXP = 65535;         // positions a row may hold (uint16 raw)
constexpr unsigned FULL = 0xffffffffu;

// A chunk's fold of one residue class: the first qualifying start and the
// last qualifying start with raw > max_l since the last chain break, and
// whether the chunk holds no break (keep).
struct St {
  int f, l, keep;
};

__device__ __forceinline__ St combine(St a, St b) {   // a precedes b
  if (!b.keep) return b;
  return {min(a.f, b.f), max(a.l, b.l), a.keep};
}

__device__ __forceinline__ St shfl_up(St v, int d) {
  return {__shfl_up_sync(FULL, v.f, d), __shfl_up_sync(FULL, v.l, d),
          __shfl_up_sync(FULL, v.keep, d)};
}

// Exclusive segmented scan of one St per thread over the block, in thread
// order. ``tot`` holds 32 St of shared memory.
__device__ St block_exclusive(St v, St* tot, St id) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  St inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const St o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  if (lane == 31) tot[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    St w = lane < nw ? tot[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const St o = shfl_up(w, d);
      if (lane >= d) w = combine(o, w);
    }
    St ex = shfl_up(w, 1);
    if (lane == 0) ex = id;
    if (lane < nw) tot[lane] = ex;      // the warps' exclusive prefixes
  }
  __syncthreads();
  St ex = shfl_up(inc, 1);
  if (lane == 0) ex = id;
  const St out = combine(tot[wid], ex);
  __syncthreads();                      // tot is reused by the next scan
  return out;
}

// Minimum of ``v`` over the threads after this one (``none`` if none).
__device__ int block_suffix_min_excl(int v, int* wmin, int none) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(FULL, inc, d);
    if (lane + d < 32) inc = min(inc, o);
  }
  if (lane == 0) wmin[wid] = inc;
  __syncthreads();
  int ex = __shfl_down_sync(FULL, inc, 1);
  if (lane == 31) ex = none;
  for (int j = wid + 1; j < nw; ++j) ex = min(ex, wmin[j]);
  __syncthreads();                      // wmin is reused by the next call
  return ex;
}

__host__ __device__ inline size_t row_bytes(int A) {
  return (size_t)((A - PADL + 15) & ~15);
}

__host__ __device__ inline size_t smem_bytes(int A) {
  return 7 * row_bytes(A) + 32 * sizeof(St);
}

__global__ void npinfo_kernel(const int8_t* __restrict__ seqbuf,
                              const int8_t* __restrict__ refbuf,
                              int8_t* __restrict__ lseq,
                              int8_t* __restrict__ lidxseq,
                              int8_t* __restrict__ lref,
                              int8_t* __restrict__ lidxref,
                              const int* __restrict__ n_ins,
                              const int* __restrict__ seq_guard,
                              const int* __restrict__ n_del,
                              const int* __restrict__ ref_guard, int A,
                              int max_n, int max_l) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wmin[32];
  const int P = A - PADL;
  const size_t Pa = row_bytes(A);
  int8_t* sq = (int8_t*)smem;
  uint16_t* raw = (uint16_t*)(smem + Pa);
  uint16_t* lw = (uint16_t*)(smem + 3 * Pa);   // max L * n2 of finished n2
  uint16_t* o = (uint16_t*)(smem + 5 * Pa);    // L | L_IDX << 8 of period n
  St* tot = (St*)(smem + 7 * Pa);

  const int w = blockIdx.x, side = blockIdx.y;
  const int T = blockDim.x, tid = threadIdx.x;
  const int8_t* row = (side ? refbuf : seqbuf) + (size_t)w * A + PADL;
  const size_t plane = (size_t)w * A * max_n;
  int8_t* outl = (side ? lref : lseq) + plane;
  int8_t* outi = (side ? lidxref : lidxseq) + plane;

  const int len = max(0, min(P, side ? min(n_del[w] + 1, ref_guard[w])
                                      : min(n_ins[w] + 1, seq_guard[w])));
  for (int p = tid; p < len; p += T) {
    sq[p] = row[p];
    lw[p] = 0;
  }
  __syncthreads();

  // zeros outside the row
  const int zlo = PADL * max_n, zhi = (PADL + len) * max_n, ztot = A * max_n;
  for (int i = tid; i < zlo; i += T) {
    outl[i] = 0;
    outi[i] = 0;
  }
  for (int i = zhi + tid; i < ztot; i += T) {
    outl[i] = 0;
    outi[i] = 0;
  }

  const int c = (len + T - 1) / T;
  const int lo = min(tid * c, len), hi = min(lo + c, len);
  const int NONE = len;                 // no start: above every position
  const St id = {NONE, -1, 1};

  for (int n = 1; n <= max_n; ++n) {
    // --- run lengths: the first mismatch at or after each position ---
    int ff = NONE;
    for (int p = lo; p < hi; ++p) {
      if (!(p + n < len && sq[p] == sq[p + n])) {
        ff = p;
        break;
      }
    }
    int nf = block_suffix_min_excl(ff, wmin, NONE);
    for (int p = hi - 1; p >= lo; --p) {
      if (!(p + n < len && sq[p] == sq[p + n])) nf = p;
      const int u = (nf - p) / n;
      raw[p] = (uint16_t)(u > 0 ? u + 1 : 0);
    }
    __syncthreads();

    // --- winners, one residue class at a time ---
    for (int r = 0; r < n; ++r) {
      const int p0 = lo + ((r - lo % n) + n) % n;
      St s = id;
      for (int pass = 0; pass < 2; ++pass) {
        for (int p = p0; p < hi; p += n) {
          if (!(p >= n && raw[p - n] > 0)) s = {NONE, -1, 0};
          const int rw = raw[p];
          if (rw > 2 && sq[p] != 0 && rw * n > (int)lw[p]) {
            s.f = min(s.f, p);
            if (rw > max_l) s.l = p;
          }
          if (pass == 1) {
            int v = 0;
            if (s.f != NONE) {
              const int win = s.l >= 0 ? s.l : s.f;
              v = min((int)raw[win], max_l) | ((((p - win) / n) & 0xff) << 8);
            }
            o[p] = (uint16_t)v;
          }
        }
        if (pass == 0) s = block_exclusive(s, tot, id);
      }
    }
    __syncthreads();

    // --- the period's bytes out; finished L for the next qualification ---
    for (int p = tid; p < len; p += T) {
      const int v = o[p], L = v & 0xff;
      const size_t at = (size_t)(PADL + p) * max_n + (n - 1);
      outl[at] = (int8_t)L;
      outi[at] = (int8_t)(v >> 8);
      lw[p] = (uint16_t)max((int)lw[p], L * n);
    }
    __syncthreads();
  }
}

}  // namespace

// Write the n-polymer planes of B windows' rows (A bytes each), whose
// lengths follow from the windows' int32 scalars, on ``stream`` with
// ``threads`` threads a row. Returns a cudaError_t.
extern "C" int npore_npinfo(const void* seqbuf, const void* refbuf,
                            void* l_seq, void* lidx_seq, void* l_ref,
                            void* lidx_ref, const void* n_ins,
                            const void* seq_guard, const void* n_del,
                            const void* ref_guard, int B, int A, int max_n,
                            int max_l, int threads, void* stream) {
  if (B <= 0) return 0;
  if (A <= PADL || A - PADL > MAXP || max_n < 1 || max_n > MAXN ||
      max_l < 1 || max_l > 127 || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(A);
  cudaError_t err = cudaFuncSetAttribute(
      npinfo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  npinfo_kernel<<<dim3(B, 2), threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)seqbuf, (const int8_t*)refbuf, (int8_t*)l_seq,
      (int8_t*)lidx_seq, (int8_t*)l_ref, (int8_t*)lidx_ref,
      (const int*)n_ins, (const int*)seq_guard, (const int*)n_del,
      (const int*)ref_guard, A, max_n, max_l);
  return (int)cudaGetLastError();
}
