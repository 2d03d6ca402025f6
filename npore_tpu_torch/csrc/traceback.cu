// Traceback over the packed MAT planes (kernel K2), CUDA C++ for sm_90a.
//
// Replaces npore_tpu/ops/pallas_dp.py::tb_kernel (get_tb_call), the TPU
// backward traceback (reference: src/aln.pyx:670-742). It computes what
// npore_tpu_torch/ops/traceback.py::traceback computes: from (n_ins, n_del)
// it reads typ | run << 3 at (t = arow + acol, lane = inss[t] - arow + r);
// INS/LEN runs emit 'I', DEL/SHR runs 'D', MAT runs '='/'X' from the bases.
// A window bails on a lane outside the band, run < 1, an unknown type, or
// a step past row or column 0; the bailing step emits nothing.
//
// The TPU kernel emitted 4-bit (op | count << 2) slots so the result fit
// its slow device-to-host link; here the kernel writes the extended CIGAR
// bytes directly, right-aligned at column n_ins + n_del of the window's
// row, plus (length, bail) in a small header of the same buffer.
//
// What bounds it: the serial walk of each window (one dependent load of the
// planes per run, about 1k-3k steps a window). The design exposes
// parallelism only across windows: one thread each, 32-thread CTAs so the
// grid spreads over the SMs. Later work can split the walk or fuse it into
// the DP kernel's last rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LW = 64;
constexpr int PADL = 80;
constexpr int MAT = 0, INS = 1, LEN = 2, DEL = 3, SHR = 4;

__device__ __forceinline__ int ld_buf(const int8_t* buf, int A, int x) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)buf[p] : 0;
}

__global__ void traceback_kernel(const int32_t* __restrict__ packed,
                                 const int32_t* __restrict__ inss_all,
                                 const int8_t* __restrict__ seqbuf,
                                 const int8_t* __restrict__ refbuf,
                                 const int32_t* __restrict__ n_ins_a,
                                 const int32_t* __restrict__ n_del_a,
                                 int32_t* __restrict__ meta,
                                 uint8_t* __restrict__ cig_all, int B, int R,
                                 int A, int L, int r) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const int32_t* pk = packed + (size_t)w * R * LW;
  const int32_t* inss = inss_all + (size_t)w * (R + 8);
  const int8_t* seq = seqbuf + (size_t)w * A;
  const int8_t* ref = refbuf + (size_t)w * A;
  uint8_t* cig = cig_all + (size_t)w * L;
  int arow = n_ins_a[w], acol = n_del_a[w];
  const int end = arow + acol;
  int pos = end;
  int bail = 0;
  while (arow > 0 || acol > 0) {
    const int t = arow + acol;
    const int lane = t < R ? inss[8 + t] - arow + r : -1;
    if (lane < 0 || lane >= LW) { bail = 1; break; }
    const int v = pk[(size_t)t * LW + lane];
    const int typ = v & 7, run = v >> 3;
    if (run < 1 || typ > SHR) { bail = 1; break; }
    if (typ == INS || typ == LEN) {
      if (run > arow) { bail = 1; break; }
      for (int k = 0; k < run; ++k) cig[--pos] = 'I';
      arow -= run;
    } else if (typ == DEL || typ == SHR) {
      if (run > acol) { bail = 1; break; }
      for (int k = 0; k < run; ++k) cig[--pos] = 'D';
      acol -= run;
    } else {                               // MAT: one row per base pair
      for (int k = 0; k < run; ++k) {
        if (arow < 1 || acol < 1) { bail = 1; break; }
        const bool eq = ld_buf(seq, A, arow - 1) == ld_buf(ref, A, acol - 1);
        cig[--pos] = eq ? '=' : 'X';
        --arow;
        --acol;
        if (arow == 0 && acol == 0) break;
      }
      if (bail) break;
    }
  }
  meta[2 * w] = end - pos;
  meta[2 * w + 1] = bail;
}

}  // namespace

extern "C" int npore_traceback(const void* packed, const void* inss,
                               const void* seqbuf, const void* refbuf,
                               const void* n_ins, const void* n_del,
                               void* meta, void* cig, int B, int R, int A,
                               int L, int r, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;
  traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const int32_t*)inss, (const int8_t*)seqbuf,
      (const int8_t*)refbuf, (const int32_t*)n_ins, (const int32_t*)n_del,
      (int32_t*)meta, (uint8_t*)cig, B, R, A, L, r);
  return (int)cudaGetLastError();
}
