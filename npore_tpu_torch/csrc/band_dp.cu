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
// depends on the previous max_n. Parallelism exists only across windows
// (one CTA of 64 threads each) and band lanes (thread j = lane j; lanes
// past 2r+1 compute like the plain version, their values feed neighbours).
//
// The first design of this kernel lost twice over (H100 SXM, 700 W: 7.62 ms
// per 1024-window x 1407-row group, 1.6% of its bytes bound):
//   * two waves: a ring of 15 arrays x 8 rows took 30,720 B of shared
//     memory a CTA, so 7 CTAs fit an SM and 924 of a group's 1024 windows
//     ran before the last 100;
//   * serial loads on the row chain: a row began with a global load of its
//     prefix-I count, on which every address depended, then read n-polymer
//     plane bytes and compared bases in an early-exit loop, up to 21
//     dependent load pairs a row before the first select.
// This design:
//   * sizes each state ring by how far back it is read: the 7 arrays read
//     at t-n keep 8 rows (max_n <= 7; anchor lane and coordinate share one
//     int), INS and DEL 2, the MAT word (typ | run << 3, the word written
//     out) 4;
//   * stages, by tiles of up to 64 rows, what the rows read of the window's
//     buffers: the tile's prefix-I counts (one coalesced load by the CTA)
//     and, for every sequence and reference position the tile's cells touch,
//     one 64-bit record each of the bases around it and of the n-polymer
//     plane bytes its LEN and SHR candidates need (zero-fill and guards
//     applied once, at staging). A tile's positions span 64 plus its count
//     of I (or of D) steps, so 128 positions always hold a 64-row tile of a
//     path whose prefix-I count steps by 0 or 1; any other path gets
//     shorter tiles, never a wrong read;
//   * shared memory: 22,952 B a CTA (9 CTAs an SM); __launch_bounds__(64, 8)
//     holds registers to 128 a thread; so 8 or more CTAs fit an SM and a
//     1024-window group is one wave on 132 SMs (npore_band_dp_occupancy
//     reports the resident CTAs);
//   * software-pipelines the state-free inputs of each row into registers
//     one row ahead (struct Pre): the prefix-I differences, the candidate
//     flags (plane bytes and the branch-free base match of all n bases at
//     once, with the reference's slice truncation), sub[si] and the
//     start-case lookups cont(side, n, l, 1);
//   * leaves on the per-row chain only the shared-memory reads of rows
//     t-1..t-max_n, the continue-case lookups (all of a row issued,
//     predicated, before the first select), the selects, the writes and one
//     barrier. The winner of each n-polymer chain is selected on its value;
//     its run, anchor value, lane and coordinate are then read once from the
//     ring. An n whose candidates no lane of the warp has is skipped as a
//     whole (a warp-uniform test): n-polymer candidates are sparse;
//   * makes max_n a template parameter (1..7), so the per-n arrays are
//     registers.
// What bounds this design: with one CTA an SM, a row waits mostly on its
// warp's own dependent instructions (some 700 a row); with the 8 CTAs of
// a full group, the 16 warps share the SM's 4 schedulers, so a row takes
// about twice as long (chip_smoke.py's wave sweep measures both). Fewer
// instructions a row is the next lever; waves and serial loads are not.
// Output: packed[w, t, j] = typ | run << 3 (int32), zeros past b_rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LW = 64;        // lane width (2r+1 <= 64)
constexpr int PADL = 80;      // left zero-padding of per-window buffers
constexpr int KDIM = 128;     // continuation-table k dimension
constexpr int NL = 101;       // continuation-table l dimension
constexpr int RING = 8;       // rows of the states read at t-n (max_n <= 7)
constexpr int RING_ID = 2;    // rows of INS and DEL (read at t-1)
constexpr int RING_M = 4;     // rows of the MAT word (read at t-2)
constexpr int TILE = 64;      // rows staged at a time (at most)
constexpr int IW = TILE + 16; // prefix-I counts staged per tile
constexpr int NPOS = 128;     // positions staged per tile, each side
constexpr int MIN_CTAS = 8;   // CTAs an SM must hold: 1024 windows / 132 SMs
constexpr unsigned FULL = 0xffffffffu;
#define kInf __int_as_float(0x7f800000)
constexpr int MAT = 0, INS = 1, LEN = 2, DEL = 3, SHR = 4;

struct Smem {
  // carried states; lenx/shrx = anchor coordinate << 6 | anchor lane
  float matv[RING][LW], lenav[RING][LW], shrav[RING][LW];
  int lenr[RING][LW], lenx[RING][LW], shrr[RING][LW], shrx[RING][LW];
  float insv[RING_ID][LW], delv[RING_ID][LW];
  int insr[RING_ID][LW], delr[RING_ID][LW];
  int matw[RING_M][LW];
  // the tile: iw[k] = inss[t0 + k]; records of sequence positions
  // lo_s + i and reference positions lo_r + i (see stage())
  int iw[IW];
  uint64_t sw[NPOS], sd[NPOS], rw[NPOS], rr[NPOS], rd[NPOS];
  float sub[25];
};

// One window's inputs.
struct Win {
  const int8_t *seq, *ref, *lseq, *lidxseq, *lref, *lidxref;
  const float* cont;
  int A, r, n_ins, n_del, ref_guard, seq_guard;
};

// What row t needs that does not depend on the DP state.
template <int N>
struct Pre {
  int ii, step1, dI2;
  int dI[N];          // ii - inss[8 + t - n] at n - 1
  unsigned flags;     // at n - 1: bit 0+ LEN candidate, 8+ LEN starts a run,
                      // 16+ SHR candidate, 24+ SHR starts a run
  unsigned wflags;    // OR of flags over the warp
  uint64_t rr, rd;    // byte n - 1: l (low 7 bits) of the LEN / SHR source
  float cs[N], cs2[N];  // start-case lookups cont(side, n, l, 1)
  float sub;          // sub[seq[arow - 1] * 5 + ref[acol - 1]]
};

__device__ __forceinline__ int ld_buf(const int8_t* buf, int A, int x) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)__ldg(buf + p) : 0;
}

template <int N>
__device__ __forceinline__ int ld_plane(const int8_t* buf, int A, int x,
                                        int ni) {
  const int p = PADL + x;
  return (p >= 0 && p < A) ? (int)__ldg(buf + (size_t)p * N + ni) : 0;
}

template <int N>
__device__ __forceinline__ float cont_at(const float* cont, int side, int ni,
                                         int l, int k) {
  constexpr int ncont = 2 * N * NL * KDIM;
  int flat = ((side * N + ni) * NL + l) * KDIM + k;
  flat = flat < 0 ? 0 : (flat > ncont - 1 ? ncont - 1 : flat);
  return __ldg(cont + flat);
}

__device__ __forceinline__ int byte_at(uint64_t v, int i) {
  return (int)((v >> (8 * i)) & 0xff);
}

// A reference plane record: l if l > 0 (l <= 100 < 128), bit 7 if
// l_idx == 0; l = l_idx = 0 past ref_guard (src/aln.pyx ref_zero / rzs).
template <int N>
__device__ __forceinline__ uint64_t ref_rec(const Win& w, int y, int ni) {
  if (y >= w.ref_guard) return 0x80;
  const int l = ld_plane<N>(w.lref, w.A, y, ni);
  const int li = ld_plane<N>(w.lidxref, w.A, y, ni);
  return (uint64_t)((l > 0 ? l : 0) | (li == 0) << 7);
}

// Records of sequence position lo_s + i and reference position lo_r + i,
// for i = j, j + 64, ... < NPOS:
//   sw  byte k = seq[x - 7 + k]           (k < 7; seq[x - 1] is byte 6)
//   sd  byte n-1 = bit 0: l_seq > 0, bit 1: l_idx_seq == 0, at x - n
//       (l_seq = l_idx_seq = 0 past seq_guard)
//   rw  byte 0 = ref[y - 1], byte k + 1 = ref[y + k]   (k < 7)
//   rr  byte n-1 = ref_rec(y), the LEN source column's planes
//   rd  byte n-1 = ref_rec(y - n), the SHR source column's planes
template <int N>
__device__ __forceinline__ void stage(Smem& s, const Win& w, int lo_s,
                                      int lo_r, int j) {
  for (int i = j; i < NPOS; i += LW) {
    const int x = lo_s + i;
    uint64_t sw = 0, sd = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      sw |= (uint64_t)(uint8_t)ld_buf(w.seq, w.A, x - 7 + k) << (8 * k);
#pragma unroll
    for (int ni = 0; ni < N; ++ni) {
      const int q = x - ni - 1;
      const bool sg = q >= w.seq_guard;
      const int ls = sg ? 0 : ld_plane<N>(w.lseq, w.A, q, ni);
      const int lis = sg ? 0 : ld_plane<N>(w.lidxseq, w.A, q, ni);
      sd |= (uint64_t)((ls > 0) | (lis == 0) << 1) << (8 * ni);
    }
    s.sw[i] = sw;
    s.sd[i] = sd;

    const int y = lo_r + i;
    uint64_t rw = 0, rr = 0, rd = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      rw |= (uint64_t)(uint8_t)ld_buf(w.ref, w.A, y - 1 + k) << (8 * k);
#pragma unroll
    for (int ni = 0; ni < N; ++ni) {
      rr |= ref_rec<N>(w, y, ni) << (8 * ni);
      rd |= ref_rec<N>(w, y - ni - 1, ni) << (8 * ni);
    }
    s.rw[i] = rw;
    s.rr[i] = rr;
    s.rd[i] = rd;
  }
}

template <int N>
__device__ __forceinline__ void prefetch(Pre<N>& p, const Smem& s,
                                         const Win& w, int t, int t0,
                                         int lo_s, int lo_r, int j) {
  const int* iw = s.iw - t0;        // iw[i] = inss[i]
  const int ii = iw[8 + t];
  p.ii = ii;
  p.step1 = ii - iw[7 + t];
  p.dI2 = ii - iw[6 + t];
  const int r = w.r;
  const int arow = ii + r - j;
  const int acol = (t - ii) - r + j;
  const uint64_t SW = s.sw[arow - lo_s], SD = s.sd[arow - lo_s];
  const uint64_t RW = s.rw[acol - lo_r];
  const uint64_t RR = s.rr[acol - lo_r], RD = s.rd[acol - lo_r];
  p.rr = RR;
  p.rd = RD;
  int si = (int)(int8_t)byte_at(SW, 6) * 5 + (int)(int8_t)byte_at(RW, 0);
  si = si < 0 ? 0 : (si > 24 ? 24 : si);
  p.sub = s.sub[si];

  // an n can have candidates only where some lane has l > 0 at its source
  uint64_t any = RR | RD;
  any = __reduce_or_sync(FULL, (unsigned)any) |
        (uint64_t)__reduce_or_sync(FULL, (unsigned)(any >> 32)) << 32;
  int lenB = w.n_del + 1 - acol;
  unsigned flags = 0;
#pragma unroll
  for (int n = 1; n <= N; ++n) {
    const int ni = n - 1;
    const int dI = ii - iw[8 + t - n];
    p.dI[ni] = dI;
    p.cs[ni] = 0.f;
    p.cs2[ni] = 0.f;
    if (!((any >> (8 * ni)) & 0x7f)) continue;        // warp-uniform

    // LEN source: (arow - n, acol), row t-n, lane + (n - dI)
    const int src_lane = j + n - dI;
    const bool src_ok = arow - n >= 0 && src_lane >= 1 &&
                        src_lane <= 2 * r - 1 && t >= n;
    const int rrb = byte_at(RR, ni), sdb = byte_at(SD, ni);
    const int l_n = rrb & 0x7f;
    // match(seq[siS+1 : +n], ref[riT+1 : +n]) with the reference's slice
    // truncation (src/aln.pyx:362-372, 604-607), all n bases at once:
    // seq[arow - n + k] is byte 7 - n + k of SW, ref[acol + k] byte k + 1
    // of RW
    int lenA = w.n_ins + 1 - (arow - n);
    lenA = lenA < 0 ? 0 : (lenA > n ? n : lenA);
    const int lenBn = lenB < 0 ? 0 : (lenB > n ? n : lenB);
    const uint64_t diff = (SW >> (8 * (7 - n))) ^ (RW >> 8);
    const uint64_t mask = (1ull << (8 * lenA)) - 1;   // lenA <= 7
    const bool mok = (lenA == lenBn) & ((diff & mask) == 0);
    const bool len_c = src_ok & (l_n > 0) & (sdb & 1) & (rrb >> 7) & mok &
                       (j > 0);
    const bool len_s = (sdb >> 1) & 1;
    p.cs[ni] = (len_c & len_s) ? cont_at<N>(w.cont, 0, ni, l_n, 1) : 0.f;

    // SHR source: (arow, acol - n), row t-n, lane - dI
    const int src_lane2 = j - dI;
    const bool src_ok2 = acol - n >= 0 && src_lane2 >= 1 &&
                         src_lane2 <= 2 * r - 1 && t >= n;
    const int rdb = byte_at(RD, ni);
    const int l_n2 = rdb & 0x7f;
    const bool shr_c = src_ok2 & (l_n2 > 0) & (j < 2 * r);
    const bool shr_s = rdb >> 7;
    p.cs2[ni] = (shr_c & shr_s) ? cont_at<N>(w.cont, 1, ni, l_n2, 1) : 0.f;

    flags |= (unsigned)len_c << ni | (unsigned)len_s << (8 + ni) |
             (unsigned)shr_c << (16 + ni) | (unsigned)shr_s << (24 + ni);
  }
  p.flags = flags;
  p.wflags = __reduce_or_sync(FULL, flags);
}

template <int N>
__global__ void __launch_bounds__(LW, MIN_CTAS)
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
               int R, int A, int r, float inf, float istart, float iext) {
  __shared__ Smem s;
  const int wi = blockIdx.x;
  const int j = threadIdx.x;

  Win w;
  const size_t poff = (size_t)wi * A * N;
  w.seq = seqbuf + (size_t)wi * A;
  w.ref = refbuf + (size_t)wi * A;
  w.lseq = l_seq + poff;
  w.lidxseq = lidx_seq + poff;
  w.lref = l_ref + poff;
  w.lidxref = lidx_ref + poff;
  w.cont = cont;
  w.A = A;
  w.r = r;
  w.n_ins = n_ins_a[wi];
  w.n_del = n_del_a[wi];
  w.ref_guard = ref_guard_a[wi];
  w.seq_guard = seq_guard_a[wi];
  const int32_t* inss = inss_all + (size_t)wi * (R + 8);
  int32_t* out = packed + (size_t)wi * R * LW;
  const int b_rows = b_rows_a[wi];
  const int n_ins = w.n_ins, n_del = w.n_del;

  for (int q = 0; q < RING; ++q) {
    s.matv[q][j] = 0.f; s.lenav[q][j] = 0.f; s.shrav[q][j] = 0.f;
    s.lenr[q][j] = 0; s.lenx[q][j] = 0; s.shrr[q][j] = 0; s.shrx[q][j] = 0;
  }
  for (int q = 0; q < RING_ID; ++q) {
    s.insv[q][j] = 0.f; s.delv[q][j] = 0.f;
    s.insr[q][j] = 0; s.delr[q][j] = 0;
  }
  for (int q = 0; q < RING_M; ++q) s.matw[q][j] = 0;
  if (j < 25) s.sub[j] = __ldg(sub + j);

  const bool wall = (j == 0) || (j == 2 * r);
  const int rows = b_rows < R ? b_rows : R;
  for (int t0 = 0; t0 < rows;) {
    // --- stage the tile: its prefix-I counts, then as many rows (<= TILE)
    // as NPOS positions a side can hold, then those positions' records ---
    __syncthreads();                 // the last tile's rows are done
    for (int k = j; k < IW; k += LW)
      s.iw[k] = t0 + k < R + 8 ? inss[t0 + k] : 0;
    __syncthreads();
    const int tmax = rows - t0 < TILE ? rows - t0 : TILE;
    int mn_i = s.iw[8], mx_i = mn_i, mn_d = t0 - mn_i, mx_d = mn_d;
    int T = 1;
    for (; T < tmax; ++T) {
      const int ii = s.iw[8 + T], d = t0 + T - ii;
      const int a = min(mn_i, ii), b = max(mx_i, ii);
      const int c = min(mn_d, d), e = max(mx_d, d);
      if (b - a + LW > NPOS || e - c + LW > NPOS) break;
      mn_i = a; mx_i = b; mn_d = c; mx_d = e;
    }
    const int lo_s = mn_i + r - (LW - 1);   // arow = ii + r - j
    const int lo_r = mn_d - r;              // acol = (t - ii) - r + j
    stage<N>(s, w, lo_s, lo_r, j);
    __syncthreads();

    Pre<N> cur;
    prefetch<N>(cur, s, w, t0, t0, lo_s, lo_r, j);
    for (int t = t0; t < t0 + T; ++t) {
      const int ii = cur.ii;
      const int arow = ii + r - j;
      const int acol = (t - ii) - r + j;
      const bool in_range = arow >= 0 && acol >= 0 && arow <= n_ins &&
                            acol <= n_del;          // t <= b_rows - 1 here
      const bool live = in_range && !wall && j < 2 * r + 1;
      const bool first_row = arow == 0;
      const bool first_col = acol == 0;

      // --- LEN / SHR sources (gather form of src/aln.pyx:601-667): the
      // state reads and every continue-case lookup, before any select ---
      float lop[N], lcv[N], sop[N], scv[N];   // candidate = op + cv
      unsigned use = 0;    // bit n-1: LEN candidate stands; 8+n-1: SHR
#pragma unroll
      for (int n = 1; n <= N; ++n) {
        const int ni = n - 1;
        const int sn = (t - n) & (RING - 1);
        const int dI = cur.dI[ni];
        lop[ni] = lcv[ni] = sop[ni] = scv[ni] = 0.f;
        // a standing candidate's lane is in [1, 2r-1]; the mask only keeps
        // the others' reads inside the ring
        if ((cur.wflags >> ni) & 1) {                   // warp-uniform
          const int sl = (j + n - dI) & (LW - 1);
          const bool len_c = (cur.flags >> ni) & 1;
          const bool len_s = (cur.flags >> (8 + ni)) & 1;
          const int lenr_src = s.lenr[sn][sl];
          const int lenx_src = s.lenx[sn][sl];
          lop[ni] = len_s ? s.matv[sn][sl] : s.lenav[sn][sl];
          int k_c = lenr_src / n + 1;
          k_c = k_c < KDIM - 1 ? k_c : KDIM - 1;
          const bool cont_ok = lenr_src > 0 && (lenx_src >> 6) >= 0 &&
                               (lenx_src & (LW - 1)) < 2 * r;
          lcv[ni] = len_s ? cur.cs[ni]
                          : ((len_c & cont_ok)
                                 ? cont_at<N>(cont, 0, ni,
                                              byte_at(cur.rr, ni) & 0x7f, k_c)
                                 : 0.f);
          use |= (unsigned)(len_c & (len_s | cont_ok)) << ni;
        }
        if ((cur.wflags >> (16 + ni)) & 1) {
          const int sl2 = (j - dI) & (LW - 1);
          const bool shr_c = (cur.flags >> (16 + ni)) & 1;
          const bool shr_s = (cur.flags >> (24 + ni)) & 1;
          const int shrr_src = s.shrr[sn][sl2];
          const int shrx_src = s.shrx[sn][sl2];
          sop[ni] = shr_s ? s.matv[sn][sl2] : s.shrav[sn][sl2];
          int k_c2 = shrr_src / n + 1;
          k_c2 = k_c2 < KDIM - 1 ? k_c2 : KDIM - 1;
          const bool cont_ok2 = shrr_src > 0 && (shrx_src >> 6) >= 0 &&
                                (shrx_src & (LW - 1)) > 0;
          scv[ni] = shr_s ? cur.cs2[ni]
                          : ((shr_c & cont_ok2)
                                 ? cont_at<N>(cont, 1, ni,
                                              byte_at(cur.rd, ni) & 0x7f, k_c2)
                                 : 0.f);
          use |= (unsigned)(shr_c & (shr_s | cont_ok2)) << (8 + ni);
        }
      }

      // the next row's state-free inputs, while the lookups are in flight
      // (the last row of a tile recomputes its own: the next tile is not
      // staged yet)
      Pre<N> nxt;
      prefetch<N>(nxt, s, w, t + 1 < t0 + T ? t + 1 : t, t0, lo_s, lo_r, j);

      // --- INS (src/aln.pyx:524-543): row t-1, lane + 1 - step1 ---
      const int sp = (t - 1) & (RING - 1);
      const int sp1 = (t - 1) & (RING_ID - 1);
      int jj = j + 1 - cur.step1;
      bool ok = jj >= 0 && jj < LW;
      float v1 = (ok ? s.matv[sp][jj] : 0.f) + istart;
      float v2 = (ok ? s.insv[sp1][jj] : 0.f) + iext;
      bool use2 = v2 < v1;
      int run2 = (arow == 1) ? 1 : (ok ? s.insr[sp1][jj] : 0) + 1;
      float ins_v = use2 ? v2 : v1;
      int ins_r = use2 ? run2 : 1;
      if (first_row) { ins_v = (float)(acol + 1) * inf; ins_r = acol; }

      // --- DEL (src/aln.pyx:546-565): row t-1, lane - step1 ---
      jj = j - cur.step1;
      ok = jj >= 0 && jj < LW;
      v1 = (ok ? s.matv[sp][jj] : 0.f) + istart;
      v2 = (ok ? s.delv[sp1][jj] : 0.f) + iext;
      use2 = v2 < v1;
      run2 = (acol == 1) ? 1 : (ok ? s.delr[sp1][jj] : 0) + 1;
      float del_v = use2 ? v2 : v1;
      int del_r = use2 ? run2 : 1;
      if (first_col) { del_v = (float)(arow + 1) * inf; del_r = arow; }

      // --- the LEN and SHR selects, n = max_n .. 1 ---
      float len_v = (float)(arow + acol) * inf;
      float shr_v = len_v;
      int len_n = 0, len_lane = 0, shr_n = 0, shr_lane = 0;
#pragma unroll
      for (int n = N; n >= 1; --n) {
        const int ni = n - 1;
        const float c = lop[ni] + lcv[ni];
        if (((use >> ni) & 1) && c < len_v) {
          len_v = c; len_n = n; len_lane = j + n - cur.dI[ni];
        }
        const float c2 = sop[ni] + scv[ni];
        if (((use >> (8 + ni)) & 1) && c2 < shr_v) {
          shr_v = c2; shr_n = n; shr_lane = j - cur.dI[ni];
        }
      }
      // the winners' run, anchor value and anchor (coordinate << 6 | lane)
      int len_r = 0, len_x = 0;
      float len_av = 0.f;
      if (len_n) {
        const int sn = (t - len_n) & (RING - 1);
        if ((cur.flags >> (7 + len_n)) & 1) {            // start a run
          len_r = len_n; len_av = s.matv[sn][len_lane];
          len_x = (arow - len_n) << 6 | len_lane;
        } else {                                         // continue a run
          len_r = s.lenr[sn][len_lane] + len_n;
          len_av = s.lenav[sn][len_lane];
          len_x = s.lenx[sn][len_lane];
        }
      }
      int shr_r = 0, shr_x = 0;
      float shr_av = 0.f;
      if (shr_n) {
        const int sn = (t - shr_n) & (RING - 1);
        if ((cur.flags >> (23 + shr_n)) & 1) {
          shr_r = shr_n; shr_av = s.matv[sn][shr_lane];
          shr_x = (acol - shr_n) << 6 | shr_lane;
        } else {
          shr_r = s.shrr[sn][shr_lane] + shr_n;
          shr_av = s.shrav[sn][shr_lane];
          shr_x = s.shrx[sn][shr_lane];
        }
      }

      // --- MAT (src/aln.pyx:568-592): row t-2, lane + 1 - dI2 ---
      const int sd = (t - 2) & (RING - 1);
      jj = j + 1 - cur.dI2;
      ok = jj >= 0 && jj < LW;
      const float matv_diag = ok ? s.matv[sd][jj] : 0.f;
      const int matw_diag = ok ? s.matw[(t - 2) & (RING_M - 1)][jj] : 0;
      const bool can_diag = arow > 0 && acol > 0;
      const float md = matv_diag + cur.sub;
      float vb = can_diag ? md : del_v + inf;
      float mat_v = can_diag ? md : 0.f;
      int mat_t = MAT;
      int mat_r = can_diag ? ((matw_diag & 7) == MAT ? (matw_diag >> 3) + 1
                                                     : 1)
                           : 0;
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
        len_av = 0.f; len_x = 0;
        shr_av = 0.f; shr_x = 0;
      }

      const int word = mat_t | (mat_r << 3);
      const int sw = t & (RING - 1);
      const int sw1 = t & (RING_ID - 1);
      s.matv[sw][j] = mat_v; s.matw[t & (RING_M - 1)][j] = word;
      s.lenr[sw][j] = len_r; s.lenav[sw][j] = len_av; s.lenx[sw][j] = len_x;
      s.shrr[sw][j] = shr_r; s.shrav[sw][j] = shr_av; s.shrx[sw][j] = shr_x;
      s.insv[sw1][j] = ins_v; s.insr[sw1][j] = ins_r;
      s.delv[sw1][j] = del_v; s.delr[sw1][j] = del_r;
      out[(size_t)t * LW + j] = word;
      __syncthreads();
      cur = nxt;
    }
    t0 += T;
  }
  for (int t = rows; t < R; ++t) out[(size_t)t * LW + j] = 0;
}

template <int N>
int launch(const void* seqbuf, const void* refbuf, const void* l_seq,
           const void* lidx_seq, const void* l_ref, const void* lidx_ref,
           const void* inss, const void* b_rows, const void* n_ins,
           const void* n_del, const void* ref_guard, const void* seq_guard,
           const void* sub, const void* cont, void* packed, int B, int R,
           int A, int r, float inf, float istart, float iext,
           cudaStream_t stream) {
  band_dp_kernel<N><<<B, LW, 0, stream>>>(
      (const int8_t*)seqbuf, (const int8_t*)refbuf, (const int8_t*)l_seq,
      (const int8_t*)lidx_seq, (const int8_t*)l_ref, (const int8_t*)lidx_ref,
      (const int32_t*)inss, (const int32_t*)b_rows, (const int32_t*)n_ins,
      (const int32_t*)n_del, (const int32_t*)ref_guard,
      (const int32_t*)seq_guard, (const float*)sub, (const float*)cont,
      (int32_t*)packed, R, A, r, inf, istart, iext);
  return (int)cudaGetLastError();
}

template <int N>
int occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, band_dp_kernel<N>, LW, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

#define NPORE_MAX_N_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7)

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
  switch (max_n) {
#define NPORE_LAUNCH(n)                                                     \
  case n:                                                                   \
    return launch<n>(seqbuf, refbuf, l_seq, lidx_seq, l_ref, lidx_ref, inss, \
                     b_rows, n_ins, n_del, ref_guard, seq_guard, sub, cont,  \
                     packed, B, R, A, r, inf, istart, iext,                  \
                     (cudaStream_t)stream);
    NPORE_MAX_N_CASES(NPORE_LAUNCH)
#undef NPORE_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the kernel for this max_n resident on one SM at its launch shape
// (64 threads, static shared memory only), or minus the CUDA error.
extern "C" int npore_band_dp_occupancy(int max_n) {
  switch (max_n) {
#define NPORE_OCC(n) \
  case n:            \
    return occupancy<n>();
    NPORE_MAX_N_CASES(NPORE_OCC)
#undef NPORE_OCC
    default:
      return -(int)cudaErrorInvalidValue;
  }
}
