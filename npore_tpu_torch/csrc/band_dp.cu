// Banded 5-state n-polymer DP (kernel K1), CUDA C++ for sm_90a.
//
// Replaces npore_tpu/ops/pallas_dp.py::dp_kernel (get_dp_call), the TPU
// forward pass of the reference align() kernel (src/aln.pyx:379-667). It
// computes exactly what npore_tpu_torch/ops/band_dp.py::window_dp (and the
// JAX make_window_dp) computes, bit for bit: float32 adds, strict `<`
// selects in the state order MAT, INS, LEN, DEL, SHR, zero-filled reads
// outside a window's buffers, and a clipped flat continuation lookup with k
// clamped at 127. The clamp is exact (the np scores saturate), so unlike
// the TPU kernel this one has no k-ladder, no SAT/LB planes and never bails.
//
// What bounds it: per-row latency. Each window is a serial loop over its
// anti-diagonal rows (about 1k-3k for nanopore reads), and every row
// depends on the previous six. The design exposes parallelism only across
// windows (one CTA each) and band lanes (one thread each):
//   * a CTA of 64 threads per window, thread j = band lane j; lanes past
//     2r+1 compute like the plain version (their values feed neighbours);
//   * the last 8 rows of every carried state live in a shared-memory ring
//     (rows t-1 .. t-max_n are read, row t is written, one barrier a row);
//   * sequences, n-polymer planes and the prefix-I counts are read from
//     device memory at the band's offsets (L1-resident across rows);
//   * the (2, max_n, 101, 128) f32 continuation table is read through the
//     read-only cache and stays L2-resident;
//   * output: packed[w, t, j] = typ | run << 3 (int32), zeros past b_rows.
// Later work can pipeline rows, pack several windows per CTA, or stage the
// per-row sequence windows in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LW = 64;       // lane width (2r+1 <= 64)
constexpr int PADL = 80;     // left zero-padding of per-window buffers
constexpr int KDIM = 128;    // continuation-table k dimension
constexpr int NL = 101;      // continuation-table l dimension
constexpr int RING = 8;      // rows of carried state kept (max_n <= 7)
#define kInf __int_as_float(0x7f800000)
constexpr int MAT = 0, INS = 1, LEN = 2, DEL = 3, SHR = 4;

struct Ring {
  float matv[RING][LW], lenav[RING][LW], shrav[RING][LW];
  float insv[RING][LW], delv[RING][LW];
  int matt[RING][LW], matr[RING][LW];
  int lenr[RING][LW], lenac[RING][LW], lenaa[RING][LW];
  int shrr[RING][LW], shrac[RING][LW], shraa[RING][LW];
  int insr[RING][LW], delr[RING][LW];
};

__device__ __forceinline__ int ld_buf(const int8_t* buf, int A, int x) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)__ldg(buf + p) : 0;
}

__device__ __forceinline__ int ld_plane(const int8_t* buf, int A, int x,
                                        int ni, int max_n) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)__ldg(buf + (size_t)p * max_n + ni) : 0;
}

__device__ __forceinline__ float cont_at(const float* cont, int ncont,
                                         int side, int ni, int l, int k,
                                         int max_n) {
  int flat = ((side * max_n + ni) * NL + l) * KDIM + k;
  flat = flat < 0 ? 0 : (flat > ncont - 1 ? ncont - 1 : flat);
  return __ldg(cont + flat);
}

__global__ void __launch_bounds__(LW)
band_dp_kernel(const int8_t* __restrict__ seqbuf,
               const int8_t* __restrict__ refbuf,
               const int8_t* __restrict__ l_seq,
               const int8_t* __restrict__ lidx_seq,
               const int8_t* __restrict__ l_ref,
               const int8_t* __restrict__ lidx_ref,
               const int32_t* __restrict__ inss_all,
               const int32_t* __restrict__ b_rows_a,
               const int32_t* __restrict__ n_ins_a,
               const int32_t* __restrict__ n_del_a,
               const int32_t* __restrict__ ref_guard_a,
               const int32_t* __restrict__ seq_guard_a,
               const float* __restrict__ sub,
               const float* __restrict__ cont,
               int32_t* __restrict__ packed,
               int R, int A, int r, int max_n, float inf, float istart,
               float iext) {
  __shared__ Ring s;
  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const int ncont = 2 * max_n * NL * KDIM;

  const int8_t* seq = seqbuf + (size_t)w * A;
  const int8_t* ref = refbuf + (size_t)w * A;
  const size_t poff = (size_t)w * A * max_n;
  const int8_t* lseq = l_seq + poff;
  const int8_t* lidxseq = lidx_seq + poff;
  const int8_t* lref = l_ref + poff;
  const int8_t* lidxref = lidx_ref + poff;
  const int32_t* inss = inss_all + (size_t)w * (R + 8);
  int32_t* out = packed + (size_t)w * R * LW;
  const int b_rows = b_rows_a[w];
  const int n_ins = n_ins_a[w];
  const int n_del = n_del_a[w];
  const int ref_guard = ref_guard_a[w];
  const int seq_guard = seq_guard_a[w];

  for (int q = 0; q < RING; ++q) {
    s.matv[q][j] = 0.f; s.lenav[q][j] = 0.f; s.shrav[q][j] = 0.f;
    s.insv[q][j] = 0.f; s.delv[q][j] = 0.f;
    s.matt[q][j] = 0; s.matr[q][j] = 0;
    s.lenr[q][j] = 0; s.lenac[q][j] = 0; s.lenaa[q][j] = 0;
    s.shrr[q][j] = 0; s.shrac[q][j] = 0; s.shraa[q][j] = 0;
    s.insr[q][j] = 0; s.delr[q][j] = 0;
  }
  __syncthreads();

  const bool wall = (j == 0) || (j == 2 * r);
  const int rows = b_rows < R ? b_rows : R;
  for (int t = 0; t < rows; ++t) {
    const int ii = inss[8 + t];
    const int arow = ii + r - j;
    const int acol = (t - ii) - r + j;
    const bool in_range = arow >= 0 && acol >= 0 && arow <= n_ins &&
                          acol <= n_del;            // t <= b_rows - 1 here
    const bool live = in_range && !wall && j < 2 * r + 1;
    const bool first_row = arow == 0;
    const bool first_col = acol == 0;
    const bool ref_zero = acol >= ref_guard;

    // --- INS (src/aln.pyx:524-543): row t-1, lane + 1 - step1 ---
    const int sp = (t - 1) & (RING - 1);
    const int step1 = ii - inss[7 + t];
    int jj = j + 1 - step1;
    bool ok = jj >= 0 && jj < LW;
    float v1 = (ok ? s.matv[sp][jj] : 0.f) + istart;
    float v2 = (ok ? s.insv[sp][jj] : 0.f) + iext;
    bool use2 = v2 < v1;
    int run2 = (arow == 1) ? 1 : (ok ? s.insr[sp][jj] : 0) + 1;
    float ins_v = use2 ? v2 : v1;
    int ins_r = use2 ? run2 : 1;
    if (first_row) { ins_v = (float)(acol + 1) * inf; ins_r = acol; }

    // --- DEL (src/aln.pyx:546-565): row t-1, lane - step1 ---
    jj = j - step1;
    ok = jj >= 0 && jj < LW;
    v1 = (ok ? s.matv[sp][jj] : 0.f) + istart;
    v2 = (ok ? s.delv[sp][jj] : 0.f) + iext;
    use2 = v2 < v1;
    run2 = (acol == 1) ? 1 : (ok ? s.delr[sp][jj] : 0) + 1;
    float del_v = use2 ? v2 : v1;
    int del_r = use2 ? run2 : 1;
    if (first_col) { del_v = (float)(arow + 1) * inf; del_r = arow; }

    // --- LEN / SHR (gather form of src/aln.pyx:601-667) ---
    float len_v = (float)(arow + acol) * inf;
    int len_r = 0, len_ac = 0, len_aa = 0;
    float len_av = 0.f;
    float shr_v = len_v;
    int shr_r = 0, shr_ac = 0, shr_aa = 0;
    float shr_av = 0.f;
    for (int n = max_n; n >= 1; --n) {
      const int ni = n - 1;
      const int sn = (t - n) & (RING - 1);
      const int dI = ii - inss[8 + t - n];

      // LEN source: (arow - n, acol), row t-n, lane + (n - dI)
      const int src_lane = j + n - dI;
      ok = src_lane >= 0 && src_lane < LW;
      const float matv_src = ok ? s.matv[sn][src_lane] : 0.f;
      const int lenr_src = ok ? s.lenr[sn][src_lane] : 0;
      const float lenav_src = ok ? s.lenav[sn][src_lane] : 0.f;
      const int lenac_src = ok ? s.lenac[sn][src_lane] : 0;
      const int lenaa_src = ok ? s.lenaa[sn][src_lane] : 0;
      const bool src_ok = arow - n >= 0 && src_lane >= 1 &&
                          src_lane <= 2 * r - 1 && t >= n;
      const int l_n = ref_zero ? 0 : ld_plane(lref, A, acol, ni, max_n);
      const int lidx_n = ref_zero ? 0 : ld_plane(lidxref, A, acol, ni, max_n);
      const bool sg = arow - n >= seq_guard;
      const int lseq_src = sg ? 0 : ld_plane(lseq, A, arow - n, ni, max_n);
      const int lidxseq_src =
          sg ? 0 : ld_plane(lidxseq, A, arow - n, ni, max_n);
      if (src_ok && l_n > 0 && lseq_src > 0 && lidx_n == 0 && j > 0) {
        // match(seq[siS+1 : +n], ref[riT+1 : +n]) with the reference's
        // slice truncation (src/aln.pyx:362-372, 604-607)
        int lenA = n_ins + 1 - (arow - n);
        lenA = lenA < 0 ? 0 : (lenA > n ? n : lenA);
        int lenB = n_del + 1 - acol;
        lenB = lenB < 0 ? 0 : (lenB > n ? n : lenB);
        bool mok = lenA == lenB;
        for (int k = 0; k < n && mok; ++k)
          mok = k >= lenA ||
                ld_buf(seq, A, arow - n + k) == ld_buf(ref, A, acol + k);
        if (mok) {
          float cand;
          int new_r, new_ac, new_aa;
          float new_av;
          if (lidxseq_src == 0) {                     // start a run
            cand = matv_src + cont_at(cont, ncont, 0, ni, l_n, 1, max_n);
            new_r = n; new_av = matv_src; new_ac = src_lane;
            new_aa = arow - n;
          } else {                                    // continue a run
            int k_c = lenr_src / n + 1;
            k_c = k_c < KDIM - 1 ? k_c : KDIM - 1;
            const bool cont_ok = lenr_src > 0 && lenaa_src >= 0 &&
                                 lenac_src < 2 * r;
            cand = cont_ok ? lenav_src +
                             cont_at(cont, ncont, 0, ni, l_n, k_c, max_n)
                           : kInf;
            new_r = lenr_src + n; new_av = lenav_src; new_ac = lenac_src;
            new_aa = lenaa_src;
          }
          if (cand < len_v) {
            len_v = cand; len_r = new_r; len_av = new_av; len_ac = new_ac;
            len_aa = new_aa;
          }
        }
      }

      // SHR source: (arow, acol - n), row t-n, lane - dI
      const int src_lane2 = j - dI;
      ok = src_lane2 >= 0 && src_lane2 < LW;
      const bool src_ok2 = acol - n >= 0 && src_lane2 >= 1 &&
                           src_lane2 <= 2 * r - 1 && t >= n;
      const bool rzs = acol - n >= ref_guard;
      const int l_n2 = rzs ? 0 : ld_plane(lref, A, acol - n, ni, max_n);
      if (src_ok2 && l_n2 > 0 && j < 2 * r) {
        const int lidx_n2 = rzs ? 0 : ld_plane(lidxref, A, acol - n, ni,
                                               max_n);
        const float matv_src2 = ok ? s.matv[sn][src_lane2] : 0.f;
        const int shrr_src = ok ? s.shrr[sn][src_lane2] : 0;
        const float shrav_src = ok ? s.shrav[sn][src_lane2] : 0.f;
        const int shrac_src = ok ? s.shrac[sn][src_lane2] : 0;
        const int shraa_src = ok ? s.shraa[sn][src_lane2] : 0;
        float cand;
        int new_r, new_ac, new_aa;
        float new_av;
        if (lidx_n2 == 0) {
          cand = matv_src2 + cont_at(cont, ncont, 1, ni, l_n2, 1, max_n);
          new_r = n; new_av = matv_src2; new_ac = src_lane2;
          new_aa = acol - n;
        } else {
          int k_c = shrr_src / n + 1;
          k_c = k_c < KDIM - 1 ? k_c : KDIM - 1;
          const bool cont_ok = shrr_src > 0 && shraa_src >= 0 &&
                               shrac_src > 0;
          cand = cont_ok ? shrav_src +
                           cont_at(cont, ncont, 1, ni, l_n2, k_c, max_n)
                         : kInf;
          new_r = shrr_src + n; new_av = shrav_src; new_ac = shrac_src;
          new_aa = shraa_src;
        }
        if (cand < shr_v) {
          shr_v = cand; shr_r = new_r; shr_av = new_av; shr_ac = new_ac;
          shr_aa = new_aa;
        }
      }
    }

    // --- MAT (src/aln.pyx:568-592): row t-2, lane + 1 - dI2 ---
    const int sd = (t - 2) & (RING - 1);
    jj = j + 1 - (ii - inss[6 + t]);
    ok = jj >= 0 && jj < LW;
    const float matv_diag = ok ? s.matv[sd][jj] : 0.f;
    const int matt_diag = ok ? s.matt[sd][jj] : 0;
    const int matr_diag = ok ? s.matr[sd][jj] : 0;
    int si = ld_buf(seq, A, arow - 1) * 5 + ld_buf(ref, A, acol - 1);
    si = si < 0 ? 0 : (si > 24 ? 24 : si);
    const bool can_diag = arow > 0 && acol > 0;
    const float md = matv_diag + __ldg(sub + si);
    float vb = can_diag ? md : del_v + inf;
    float mat_v = can_diag ? md : 0.f;
    int mat_t = MAT;
    int mat_r = can_diag ? (matt_diag == MAT ? matr_diag + 1 : 1) : 0;
    if (ins_v < vb) { vb = ins_v; mat_v = ins_v; mat_t = INS; mat_r = ins_r; }
    if (len_v < vb) { vb = len_v; mat_v = len_v; mat_t = LEN; mat_r = len_r; }
    if (del_v < vb) { vb = del_v; mat_v = del_v; mat_t = DEL; mat_r = del_r; }
    if (shr_v < vb) { vb = shr_v; mat_v = shr_v; mat_t = SHR; mat_r = shr_r; }

    // --- post overwrites: first-row LEN / first-col SHR, after the MAT
    // reduce (src/aln.pyx:596-599, 637-640) ---
    if (first_row) len_r = acol;
    if (first_col) shr_r = arow;

    // --- walls and out-of-range cells (src/aln.pyx:497-507) ---
    const bool keep = in_range && !wall;
    const float wall_v = (float)(t + 1) * inf;
    if (!in_range) {
      mat_v = 0.f; ins_v = 0.f; del_v = 0.f;
    } else if (wall) {
      mat_v = wall_v; ins_v = wall_v; del_v = wall_v;
    }
    if (!keep) {
      mat_t = MAT; mat_r = 0; len_r = 0; shr_r = 0; ins_r = 0; del_r = 0;
    }
    if (!live) {
      len_av = 0.f; len_ac = 0; len_aa = 0;
      shr_av = 0.f; shr_ac = 0; shr_aa = 0;
    }

    const int sw = t & (RING - 1);
    s.matv[sw][j] = mat_v; s.matt[sw][j] = mat_t; s.matr[sw][j] = mat_r;
    s.lenr[sw][j] = len_r; s.lenav[sw][j] = len_av;
    s.lenac[sw][j] = len_ac; s.lenaa[sw][j] = len_aa;
    s.shrr[sw][j] = shr_r; s.shrav[sw][j] = shr_av;
    s.shrac[sw][j] = shr_ac; s.shraa[sw][j] = shr_aa;
    s.insv[sw][j] = ins_v; s.insr[sw][j] = ins_r;
    s.delv[sw][j] = del_v; s.delr[sw][j] = del_r;
    out[(size_t)t * LW + j] = mat_t | (mat_r << 3);
    __syncthreads();
  }
  for (int t = rows; t < R; ++t) out[(size_t)t * LW + j] = 0;
}

}  // namespace

extern "C" int npore_band_dp(const void* seqbuf, const void* refbuf,
                             const void* l_seq, const void* lidx_seq,
                             const void* l_ref, const void* lidx_ref,
                             const void* inss, const void* b_rows,
                             const void* n_ins, const void* n_del,
                             const void* ref_guard, const void* seq_guard,
                             const void* sub, const void* cont, void* packed,
                             int B, int R, int A, int r, int max_n, float inf,
                             float istart, float iext, void* stream) {
  if (B <= 0) return 0;
  band_dp_kernel<<<B, LW, 0, (cudaStream_t)stream>>>(
      (const int8_t*)seqbuf, (const int8_t*)refbuf, (const int8_t*)l_seq,
      (const int8_t*)lidx_seq, (const int8_t*)l_ref, (const int8_t*)lidx_ref,
      (const int32_t*)inss, (const int32_t*)b_rows, (const int32_t*)n_ins,
      (const int32_t*)n_del, (const int32_t*)ref_guard,
      (const int32_t*)seq_guard, (const float*)sub, (const float*)cont,
      (int32_t*)packed, R, A, r, max_n, inf, istart, iext);
  return (int)cudaGetLastError();
}
