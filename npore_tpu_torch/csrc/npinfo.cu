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
//   * each period runs a body templated on its period N (period<N>, by a
//     switch on n), so the fold state of the N residue classes is an array
//     St s[N] indexed only by constants;
//   * each thread owns a contiguous chunk of positions, a multiple of N
//     long, so its chunk starts in class 0 and position base + j is in
//     class j;
//   * run lengths: each thread finds its chunk's first mismatch, a block
//     suffix-min gives the first mismatch after the chunk, and a backward
//     pass over the chunk writes one byte a position (see ``code``): the
//     run clamped at 128 if the position qualifies, else whether it links;
//   * winners: one forward walk folds the chunk into a (first, last-big,
//     no-reset) triple per class, ONE block exclusive segmented scan of
//     the N-vector gives each chunk its incoming states, and a second
//     forward walk writes L | L_IDX << 8 per position to shared memory;
//   * staged (STAGED, where it fits): the second walk writes L and L_IDX
//     into shared-memory copies of the window's two planes, and once the
//     last period is done each plane goes out as 16-byte stores of its
//     contiguous A * max_n bytes (the unaligned head and tail singly);
//     qualification recomputes max(L * n2) of the finished periods from
//     the staged L bytes;
//   * unstaged (rows whose staging does not fit): after each period its
//     bytes go out with neighbouring threads on neighbouring positions
//     (stride max_n), and each position keeps max(L * n2) over finished
//     periods in shared memory for qualification.
// Barriers a period: 2 in the suffix-min, 1 after the codes, 2 in the
// scan, and unstaged 1 before the stores (about 93 a row at max_n 6
// before, 30 or 36 now).
// Shared memory: the row and a code byte a position, 32 * max_n triples
// for the scan and 32 ints for the suffix-min; staged the two planes
// (2 * max_n bytes a position and the padding), unstaged 4 bytes a
// position (max L * n2 and the period's output).
// What bounds it: the function reads 2 bytes and writes 4 * max_n bytes a
// position (12 us at a 1024-window x 1407-row group, 3.35 TB/s); this
// design pays a chain of block barriers. Its time is in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PADL = 80;            // left zero-padding of per-window rows
constexpr int MAXN = 8;             // periods the kernel handles
constexpr int MAXP = 65535;         // positions a row may hold
constexpr int MAXT = 1024;          // threads a row at most
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

// Exclusive segmented scan, in thread order, of N triples per thread (one
// per residue class) at once. ``tot`` holds 32 * N St of shared memory.
// The next write to ``tot`` comes a period later, behind that period's
// first barrier, so no barrier is needed after the reads.
template <int N>
__device__ __forceinline__ void block_exclusive(St (&s)[N], St* tot, St id) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const St o = shfl_up(s[j], d);
      if (lane >= d) s[j] = combine(o, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (lane == 31) tot[wid * N + j] = s[j];
    s[j] = shfl_up(s[j], 1);           // the warp's exclusive prefix
    if (lane == 0) s[j] = id;
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      St w = lane < nw ? tot[lane * N + j] : id;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const St o = shfl_up(w, d);
        if (lane >= d) w = combine(o, w);
      }
      St ex = shfl_up(w, 1);
      if (lane == 0) ex = id;
      if (lane < nw) tot[lane * N + j] = ex;   // the warps' prefixes
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = combine(tot[wid * N + j], s[j]);
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

// A staged plane: A * max_n bytes placed at the plane's own offset mod 16
// from a 16-byte boundary, so that 16-byte stores line up on both sides.
__host__ __device__ inline size_t stage_bytes(int A, int max_n) {
  return ((size_t)A * max_n + 30) & ~(size_t)15;
}

__host__ __device__ inline size_t smem_bytes(int A, int max_n, bool staged) {
  return (staged ? 2 * row_bytes(A) + 2 * stage_bytes(A, max_n)
                 : 6 * row_bytes(A)) +
         32 * max_n * sizeof(St) + 32 * sizeof(int);
}

// A row's state in shared memory and its outputs.
struct Row {
  const int8_t* sq;   // the row's bases
  uint8_t* code;      // a position's byte of the current period
  uint16_t* lw;       // unstaged: max L * n2 of the finished periods n2
  uint16_t* o;        // unstaged: L | L_IDX << 8 of the current period
  uint8_t* stl;       // staged: the planes, byte i of each at [i]
  uint8_t* sti;
  St* tot;            // the scan's warp totals
  int* wmin;          // the suffix-min's warp minima
  int8_t* outl;       // the window's planes
  int8_t* outi;
  int len, max_n, max_l;
};

// Fold position p (of class j, state s) into its class's chain state.
template <int N>
__device__ __forceinline__ void fold(St& s, int p, const uint8_t* code,
                                     int none, int max_l) {
  if (!(p >= N && code[p - N] > 0)) s = {none, -1, 0};
  const int c = code[p];
  if (c > 2) {
    s.f = min(s.f, p);
    if (c > max_l) s.l = p;
  }
}

// max(L * n2) over the finished periods n2 < N at position p.
template <int N, bool STAGED>
__device__ __forceinline__ int finished(const Row& r, int p) {
  if (!STAGED) return r.lw[p];
  const uint8_t* lp = r.stl + (size_t)(PADL + p) * r.max_n;
  int lw = 0;
#pragma unroll
  for (int n2 = 1; n2 < N; ++n2) lw = max(lw, lp[n2 - 1] * n2);
  return lw;
}

template <int N, bool STAGED>
__device__ __forceinline__ void period(const Row& r) {
  const int T = blockDim.x, tid = threadIdx.x, len = r.len;
  const int c = ((len + T - 1) / T + N - 1) / N * N;   // a multiple of N
  const int lo = min(tid * c, len), hi = min(lo + c, len);
  const int NONE = len;                 // no start: above every position
  const St id = {NONE, -1, 1};
  const int8_t* sq = r.sq;
  uint8_t* code = r.code;

  // --- run lengths: the first mismatch at or after each position ---
  int ff = NONE;
  for (int p = lo; p < hi; ++p) {
    if (!(p + N < len && sq[p] == sq[p + N])) {
      ff = p;
      break;
    }
  }
  int nf = block_suffix_min_excl(ff, r.wmin, NONE);
  // code[p]: min(raw, 128) if p qualifies (judged on the full raw), else
  // 1 if its run links p to p + N (raw > 0), else 0. raw is never 1 and a
  // qualifying raw is > 2, so code > 2 exactly when p qualifies and
  // code > 0 exactly when raw > 0; as max_l <= 127, the clamp at 128 is
  // exact: code > max_l exactly when raw > max_l, and min(code, max_l) =
  // min(raw, max_l).
  for (int p = hi - 1; p >= lo; --p) {
    if (!(p + N < len && sq[p] == sq[p + N])) nf = p;
    const int u = (nf - p) / N;
    const int raw = u > 0 ? u + 1 : 0;
    const bool qual =
        raw > 2 && sq[p] != 0 && raw * N > finished<N, STAGED>(r, p);
    code[p] = (uint8_t)(qual ? min(raw, 128) : raw > 0);
  }
  __syncthreads();

  // --- winners: every residue class in one walk and one scan ---
  St s[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = id;
  for (int base = lo; base < hi; base += N) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (base + j < hi) fold<N>(s[j], base + j, code, NONE, r.max_l);
  }
  block_exclusive<N>(s, r.tot, id);
  for (int base = lo; base < hi; base += N) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int p = base + j;
      if (p < hi) {
        fold<N>(s[j], p, code, NONE, r.max_l);
        int L = 0, I = 0;
        if (s[j].f != NONE) {
          const int win = s[j].l >= 0 ? s[j].l : s[j].f;
          L = min((int)code[win], r.max_l);
          I = ((p - win) / N) & 0xff;
        }
        if (STAGED) {
          const size_t at = (size_t)(PADL + p) * r.max_n + (N - 1);
          r.stl[at] = (uint8_t)L;
          r.sti[at] = (uint8_t)I;
        } else {
          r.o[p] = (uint16_t)(L | I << 8);
        }
      }
    }
  }
  if (STAGED) return;   // the next write of code or stl follows a barrier
  __syncthreads();

  // --- the period's bytes out; finished L for the next qualification ---
  for (int p = tid; p < len; p += T) {
    const int v = r.o[p], L = v & 0xff;
    const size_t at = (size_t)(PADL + p) * r.max_n + (N - 1);
    r.outl[at] = (int8_t)L;
    r.outi[at] = (int8_t)(v >> 8);
    r.lw[p] = (uint16_t)max((int)r.lw[p], L * N);
  }
}

// Plane ``g`` (``total`` bytes) from its staged copy ``st``: the head up to
// g's first 16-byte boundary and the tail singly, the rest 16 bytes a
// store.
__device__ __forceinline__ void store_plane(int8_t* g, const uint8_t* st,
                                            int total) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int head = min(total, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int nv = (total - head) >> 4;
  for (int i = tid; i < head; i += T) g[i] = (int8_t)st[i];
  uint4* gv = (uint4*)(g + head);
  const uint4* sv = (const uint4*)(st + head);
  for (int k = tid; k < nv; k += T) gv[k] = sv[k];
  for (int i = head + 16 * nv + tid; i < total; i += T) g[i] = (int8_t)st[i];
}

template <bool STAGED>
__global__ void __launch_bounds__(MAXT)
npinfo_kernel(const int8_t* __restrict__ seqbuf,
              const int8_t* __restrict__ refbuf, int8_t* __restrict__ lseq,
              int8_t* __restrict__ lidxseq, int8_t* __restrict__ lref,
              int8_t* __restrict__ lidxref, const int* __restrict__ n_ins,
              const int* __restrict__ seq_guard,
              const int* __restrict__ n_del,
              const int* __restrict__ ref_guard, int A, int max_n,
              int max_l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = A - PADL;
  const size_t Pa = row_bytes(A);
  const int w = blockIdx.x, side = blockIdx.y;
  const int T = blockDim.x, tid = threadIdx.x;
  const size_t plane = (size_t)w * A * max_n;
  const size_t Sp = stage_bytes(A, max_n);
  Row r;
  r.sq = (const int8_t*)smem;
  r.code = smem + Pa;
  r.outl = (side ? lref : lseq) + plane;
  r.outi = (side ? lidxref : lidxseq) + plane;
  r.lw = (uint16_t*)(smem + 2 * Pa);
  r.o = (uint16_t*)(smem + 4 * Pa);
  r.stl = smem + 2 * Pa + ((uintptr_t)r.outl & 15);
  r.sti = smem + 2 * Pa + Sp + ((uintptr_t)r.outi & 15);
  r.tot = (St*)(smem + (STAGED ? 2 * Pa + 2 * Sp : 6 * Pa));
  r.wmin = (int*)(r.tot + 32 * max_n);
  r.len = max(0, min(P, side ? min(n_del[w] + 1, ref_guard[w])
                             : min(n_ins[w] + 1, seq_guard[w])));
  r.max_n = max_n;
  r.max_l = max_l;
  const int len = r.len;

  const int8_t* row = (side ? refbuf : seqbuf) + (size_t)w * A + PADL;
  for (int p = tid; p < len; p += T) {
    ((int8_t*)smem)[p] = row[p];
    if (!STAGED) r.lw[p] = 0;
  }
  const int zlo = PADL * max_n, zhi = (PADL + len) * max_n, ztot = A * max_n;
  if (STAGED) {         // zero planes, the row's bytes overwritten later
    uint4* z = (uint4*)(smem + 2 * Pa);
    for (size_t k = tid; k < 2 * Sp / 16; k += T) z[k] = make_uint4(0, 0, 0, 0);
  } else {              // zeros outside the row
    for (int i = tid; i < zlo; i += T) {
      r.outl[i] = 0;
      r.outi[i] = 0;
    }
    for (int i = zhi + tid; i < ztot; i += T) {
      r.outl[i] = 0;
      r.outi[i] = 0;
    }
  }
  __syncthreads();

  for (int n = 1; n <= max_n; ++n) {
    switch (n) {
      case 1: period<1, STAGED>(r); break;
      case 2: period<2, STAGED>(r); break;
      case 3: period<3, STAGED>(r); break;
      case 4: period<4, STAGED>(r); break;
      case 5: period<5, STAGED>(r); break;
      case 6: period<6, STAGED>(r); break;
      case 7: period<7, STAGED>(r); break;
      case 8: period<8, STAGED>(r); break;
    }
  }
  if (STAGED) {
    __syncthreads();
    store_plane(r.outl, r.stl, ztot);
    store_plane(r.outi, r.sti, ztot);
  }
}

template <bool STAGED>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const int8_t* seqbuf, const int8_t* refbuf, int8_t* lseq,
                   int8_t* lidxseq, int8_t* lref, int8_t* lidxref,
                   const int* n_ins, const int* seq_guard, const int* n_del,
                   const int* ref_guard, int A, int max_n, int max_l) {
  cudaError_t err = cudaFuncSetAttribute(
      npinfo_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  npinfo_kernel<STAGED><<<grid, threads, smem, stream>>>(
      seqbuf, refbuf, lseq, lidxseq, lref, lidxref, n_ins, seq_guard, n_del,
      ref_guard, A, max_n, max_l);
  return cudaGetLastError();
}

template <bool STAGED>
int occupancy(int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      npinfo_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, npinfo_kernel<STAGED>, threads, smem);
  return err == cudaSuccess ? ctas : -(int)err;
}

}  // namespace

// Write the n-polymer planes of B windows' rows (A bytes each), whose
// lengths follow from the windows' int32 scalars, on ``stream`` with
// ``threads`` threads a row, staged or not. Returns a cudaError_t.
extern "C" int npore_npinfo(const void* seqbuf, const void* refbuf,
                            void* l_seq, void* lidx_seq, void* l_ref,
                            void* lidx_ref, const void* n_ins,
                            const void* seq_guard, const void* n_del,
                            const void* ref_guard, int B, int A, int max_n,
                            int max_l, int threads, int staged,
                            void* stream) {
  if (B <= 0) return 0;
  if (A <= PADL || A - PADL > MAXP || max_n < 1 || max_n > MAXN ||
      max_l < 1 || max_l > 127 || threads < 32 || threads > MAXT ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(A, max_n, staged);
  auto go = staged ? launch<true> : launch<false>;
  return (int)go(dim3(B, 2), threads, smem, (cudaStream_t)stream,
                 (const int8_t*)seqbuf, (const int8_t*)refbuf,
                 (int8_t*)l_seq, (int8_t*)lidx_seq, (int8_t*)l_ref,
                 (int8_t*)lidx_ref, (const int*)n_ins, (const int*)seq_guard,
                 (const int*)n_del, (const int*)ref_guard, A, max_n, max_l);
}

// CTAs of a launch that one SM holds at once (minus a cudaError_t on an
// error).
extern "C" int npore_npinfo_occupancy(int A, int max_n, int threads,
                                      int staged) {
  const size_t smem = smem_bytes(A, max_n, staged);
  return staged ? occupancy<true>(threads, smem)
                : occupancy<false>(threads, smem);
}
