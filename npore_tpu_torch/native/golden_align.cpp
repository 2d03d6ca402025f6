// Banded 5-state n-polymer alignment DP -- native port of the golden
// executable spec (golden/align.py; reference: src/aln.pyx:379-787).
//
// Used as the fast exact fallback when the Pallas engine bails (k
// continuation outside the covered planes, traceback diagnostics, ...).
// All value arithmetic is float (SSE single precision), bit-matching the
// reference's C float math.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

extern "C" void np_info(const uint8_t* seq, int64_t slen, int32_t max_n,
                        int32_t max_l, int32_t* out);

namespace {

enum { MAT = 0, INS = 1, LEN = 2, DEL = 3, SHR = 4, TYPES = 5 };

struct Plane {
    // (TYPES, rows, cols) value/type/run
    std::vector<float> val;
    std::vector<int32_t> typ;
    std::vector<int64_t> run;
    int64_t rows, cols;
    void init(int64_t rws, int64_t cls) {
        rows = rws; cols = cls;
        val.assign((size_t)TYPES * rws * cls, 0.f);
        typ.assign((size_t)TYPES * rws * cls, 0);
        run.assign((size_t)TYPES * rws * cls, 0);
    }
    void clear() {
        std::fill(val.begin(), val.end(), 0.f);
        std::fill(typ.begin(), typ.end(), 0);
        std::fill(run.begin(), run.end(), 0);
    }
    inline size_t at(int t, int64_t r_, int64_t c) const {
        return ((size_t)t * rows + r_) * cols + c;
    }
};

inline float np_score(int n, int64_t ref_np_len, int64_t indel_len,
                      const float* np_scores, int32_t max_l_as_max_n,
                      int32_t table_l) {
    // reference quirk: max_l is passed as `max_n` (src/aln.pyx:615 etc.)
    if (ref_np_len <= 0) return 100.f;
    if (ref_np_len + indel_len < 0) return 100.f;
    if (n < 1 || n > max_l_as_max_n) return 100.f;
    int64_t call = ref_np_len + indel_len;
    if (ref_np_len > max_l_as_max_n - 1) ref_np_len = max_l_as_max_n - 1;
    if (call > max_l_as_max_n - 1) call = max_l_as_max_n - 1;
    return np_scores[((size_t)(n - 1) * (table_l + 1) + ref_np_len)
                     * (table_l + 1) + call];
}

}  // namespace

extern "C" {

// cigar: 'I'/'D' expanded path bytes (len = nref + nseq).
// out: caller buffer of capacity >= nref + nseq; returns the output length
// (extended CIGAR over '=XID'), or -1 on internal traceback error (the
// partial alignment is still written, mirroring the reference's truncation).
int64_t golden_align(const uint8_t* full_ref, int64_t nref,
                     const uint8_t* full_seq, int64_t nseq,
                     const uint8_t* cigar,
                     const float* sub_scores, const float* np_scores,
                     int32_t max_n, int32_t max_l, int32_t r,
                     int64_t max_b_rows, float indel_start,
                     float indel_extend, char* out) {
    const int64_t path_len = nref + nseq;
    const int64_t asize = path_len + 1;
    std::vector<int64_t> inss(asize), dels(asize);
    inss[0] = dels[0] = 0;
    for (int64_t i = 0; i < path_len; i++) {
        inss[i + 1] = inss[i] + (cigar[i] == 'I');
        dels[i + 1] = dels[i] + (cigar[i] == 'D');
    }

    // chunk breaks (src/aln.pyx:344-358)
    // buf_len = 1 + ceil((asize-1)/(chunk-1))  (src/aln.pyx:344-349)
    int64_t nb = 1 + (asize - 1 + max_b_rows - 2) / (max_b_rows - 1);
    std::vector<int64_t> breaks(nb);
    for (int64_t i = 0; i < nb - 1; i++) {
        int64_t b = i * (max_b_rows - 1);
        if (i > 0 && inss[b + 1] == inss[b] + 1 && dels[b] == dels[b - 1] + 1)
            b -= 1;
        breaks[i] = b;
    }
    breaks[nb - 1] = asize - 1;

    const int64_t a_rows = nseq + 1, a_cols = nref + 1;
    const int64_t b_cols = 2 * r + 1;
    const int INF = 100;
    Plane P;
    P.init(max_b_rows + 1, b_cols);

    std::string result;
    result.reserve(path_len);
    bool error = false;

    std::vector<int32_t> npi_ref, npi_seq;

    for (int64_t bi = 0; bi < nb - 1 && !error; bi++) {
        const int64_t brk = breaks[bi], nxt = breaks[bi + 1];
        const int64_t b_rows = nxt - brk + 1;
        P.clear();
        const int64_t ins_brk = inss[brk], del_brk = dels[brk];
        const int64_t ins_next = inss[nxt], del_next = dels[nxt];
        const uint8_t* ref = full_ref + del_brk;
        const uint8_t* seq = full_seq + ins_brk;
        const int64_t ref_len = del_next - del_brk + 1 <= nref - del_brk
                                ? del_next - del_brk + 1 : nref - del_brk;
        const int64_t seq_len = ins_next - ins_brk + 1 <= nseq - ins_brk
                                ? ins_next - ins_brk + 1 : nseq - ins_brk;
        npi_ref.assign((size_t)(ref_len > 0 ? ref_len : 0) * 2 * max_n, 0);
        npi_seq.assign((size_t)(seq_len > 0 ? seq_len : 0) * 2 * max_n, 0);
        if (ref_len > 0) np_info(ref, ref_len, max_n, max_l, npi_ref.data());
        if (seq_len > 0) np_info(seq, seq_len, max_n, max_l, npi_seq.data());
        auto LREF = [&](int64_t p, int ni) -> int32_t {
            return p < ref_len ? npi_ref[(p * 2 + 0) * max_n + ni] : 0;
        };
        auto LIDXREF = [&](int64_t p, int ni) -> int32_t {
            return p < ref_len ? npi_ref[(p * 2 + 1) * max_n + ni] : 0;
        };
        auto LSEQ = [&](int64_t p, int ni) -> int32_t {
            return p < seq_len ? npi_seq[(p * 2 + 0) * max_n + ni] : 0;
        };
        auto LIDXSEQ = [&](int64_t p, int ni) -> int32_t {
            return p < seq_len ? npi_seq[(p * 2 + 1) * max_n + ni] : 0;
        };
        auto a2b_col = [&](int64_t a_row, int64_t a_col) -> int64_t {
            return inss[a_row + a_col] - a_row + r;
        };

        // LEN/SHR distance-penalty init (src/aln.pyx:465-478)
        for (int64_t b_row = 0; b_row < b_rows; b_row++) {
            int64_t g = b_row + brk;
            for (int64_t b_col = 0; b_col < b_cols; b_col++) {
                int64_t a_row = inss[g] + r - b_col;
                int64_t a_col = dels[g] - r + b_col;
                if (a_row < ins_brk || a_col < del_brk || a_row > ins_next ||
                    a_col > del_next || b_col == 0 || b_col == 2 * r)
                    continue;
                float v = (float)(INF * (a_row - ins_brk + a_col - del_brk));
                for (int t : {LEN, SHR}) {
                    P.val[P.at(t, b_row, b_col)] = v;
                    P.typ[P.at(t, b_row, b_col)] = MAT;
                    P.run[P.at(t, b_row, b_col)] = 0;
                }
            }
        }

        for (int64_t b_row = 0; b_row < b_rows; b_row++) {
            int64_t g = b_row + brk;
            for (int64_t b_col = 0; b_col < b_cols; b_col++) {
                int64_t a_row = inss[g] + r - b_col;
                int64_t a_col = dels[g] - r + b_col;
                if (a_row < ins_brk || a_col < del_brk || a_row > ins_next ||
                    a_col > del_next)
                    continue;
                if (b_col == 0 || b_col == 2 * r) {
                    for (int t = 0; t < TYPES; t++) {
                        P.val[P.at(t, b_row, b_col)] =
                            (float)(INF * (b_row + 1));
                        P.typ[P.at(t, b_row, b_col)] = MAT;
                        P.run[P.at(t, b_row, b_col)] = 0;
                    }
                    continue;
                }
                int64_t b_top_row = (a_row - 1) + a_col - brk;
                int64_t b_top_col = a2b_col(a_row - 1, a_col);
                int64_t b_left_row = a_row + (a_col - 1) - brk;
                int64_t b_left_col = a2b_col(a_row, a_col - 1);
                int64_t b_diag_row = (a_row - 1) + (a_col - 1) - brk;
                int64_t b_diag_col = a2b_col(a_row - 1, a_col - 1);
                int64_t ref_idx = a_col - del_brk - 1;
                int64_t seq_idx = a_row - ins_brk - 1;

                // INS
                if (a_row == ins_brk) {
                    P.val[P.at(INS, b_row, b_col)] =
                        (float)(INF * (a_col - del_brk + 1));
                    P.typ[P.at(INS, b_row, b_col)] = DEL;
                    P.run[P.at(INS, b_row, b_col)] = a_col - del_brk;
                } else {
                    float v1 = P.val[P.at(MAT, b_top_row, b_top_col)] +
                               indel_start;
                    P.val[P.at(INS, b_row, b_col)] = v1;
                    P.typ[P.at(INS, b_row, b_col)] = INS;
                    P.run[P.at(INS, b_row, b_col)] = 1;
                    float v2 = P.val[P.at(INS, b_top_row, b_top_col)] +
                               indel_extend;
                    if (v2 < v1) {
                        int64_t rn = (a_row == ins_brk + 1)
                            ? 1 : P.run[P.at(INS, b_top_row, b_top_col)] + 1;
                        P.val[P.at(INS, b_row, b_col)] = v2;
                        P.typ[P.at(INS, b_row, b_col)] = INS;
                        P.run[P.at(INS, b_row, b_col)] = rn;
                    }
                }

                // DEL
                if (a_col == del_brk) {
                    P.val[P.at(DEL, b_row, b_col)] =
                        (float)(INF * (a_row - ins_brk + 1));
                    P.typ[P.at(DEL, b_row, b_col)] = INS;
                    P.run[P.at(DEL, b_row, b_col)] = a_row - ins_brk;
                } else {
                    float v1 = P.val[P.at(MAT, b_left_row, b_left_col)] +
                               indel_start;
                    P.val[P.at(DEL, b_row, b_col)] = v1;
                    P.typ[P.at(DEL, b_row, b_col)] = DEL;
                    P.run[P.at(DEL, b_row, b_col)] = 1;
                    float v2 = P.val[P.at(DEL, b_left_row, b_left_col)] +
                               indel_extend;
                    if (v2 < v1) {
                        int64_t rn = (a_col == del_brk + 1)
                            ? 1 : P.run[P.at(DEL, b_left_row, b_left_col)] + 1;
                        P.val[P.at(DEL, b_row, b_col)] = v2;
                        P.typ[P.at(DEL, b_row, b_col)] = DEL;
                        P.run[P.at(DEL, b_row, b_col)] = rn;
                    }
                }

                // MAT
                float v1;
                if (a_row > ins_brk && a_col > del_brk) {
                    int64_t rn =
                        (P.typ[P.at(MAT, b_diag_row, b_diag_col)] == MAT)
                        ? P.run[P.at(MAT, b_diag_row, b_diag_col)] + 1 : 1;
                    v1 = P.val[P.at(MAT, b_diag_row, b_diag_col)] +
                         sub_scores[(size_t)seq[seq_idx] * 5 + ref[ref_idx]];
                    P.val[P.at(MAT, b_row, b_col)] = v1;
                    P.typ[P.at(MAT, b_row, b_col)] = MAT;
                    P.run[P.at(MAT, b_row, b_col)] = rn;
                } else {
                    v1 = P.val[P.at(DEL, b_row, b_col)] + (float)INF;
                }
                for (int t : {INS, LEN, DEL, SHR}) {
                    float v2 = P.val[P.at(t, b_row, b_col)];
                    if (v2 < v1) {
                        v1 = v2;
                        P.val[P.at(MAT, b_row, b_col)] = v2;
                        P.typ[P.at(MAT, b_row, b_col)] = t;
                        P.run[P.at(MAT, b_row, b_col)] =
                            P.run[P.at(t, b_row, b_col)];
                    }
                }

                // n-polymer info at the next ref/seq base
                int32_t l[8], l_idx[8], l_s[8], l_idx_s[8];
                for (int ni = 0; ni < max_n; ni++) {
                    if (a_col >= a_cols - 1) { l[ni] = 0; l_idx[ni] = 0; }
                    else { l[ni] = LREF(ref_idx + 1, ni);
                           l_idx[ni] = LIDXREF(ref_idx + 1, ni); }
                    if (a_row >= a_rows - 1) { l_s[ni] = 0; l_idx_s[ni] = 0; }
                    else { l_s[ni] = LSEQ(seq_idx + 1, ni);
                           l_idx_s[ni] = LIDXSEQ(seq_idx + 1, ni); }
                }

                // LEN first-row override
                if (a_row == ins_brk) {
                    P.val[P.at(LEN, b_row, b_col)] =
                        (float)(INF * (a_col - del_brk));
                    P.typ[P.at(LEN, b_row, b_col)] = DEL;
                    P.run[P.at(LEN, b_row, b_col)] = a_col - del_brk;
                }
                for (int n = 1; n <= max_n; n++) {
                    int ni = n - 1;
                    if (l[ni] == 0 || l_s[ni] == 0 || l_idx[ni] != 0) continue;
                    // match(seq[seq_idx+1:+n], ref[ref_idx+1:+n]) with slice
                    // truncation semantics
                    int64_t lenA = seq_len - (seq_idx + 1);
                    if (lenA > n) lenA = n;
                    if (lenA < 0) lenA = 0;
                    int64_t lenB = ref_len - (ref_idx + 1);
                    if (lenB > n) lenB = n;
                    if (lenB < 0) lenB = 0;
                    if (lenA != lenB) continue;
                    bool ok = true;
                    for (int64_t k = 0; k < lenA && ok; k++)
                        ok = seq[seq_idx + 1 + k] == ref[ref_idx + 1 + k];
                    if (!ok) continue;
                    if (a_row + n <= ins_next) {
                        int64_t nd_row = (a_row + n) + a_col - brk;
                        int64_t nd_col = a2b_col(a_row + n, a_col);
                        if (nd_col > 0) {
                            if (l_idx_s[ni] == 0) {
                                float v = P.val[P.at(MAT, b_row, b_col)] +
                                    np_score(n, l[ni], 1, np_scores, max_l,
                                             max_l);
                                if (v < P.val[P.at(LEN, nd_row, nd_col)]) {
                                    P.val[P.at(LEN, nd_row, nd_col)] = v;
                                    P.typ[P.at(LEN, nd_row, nd_col)] = LEN;
                                    P.run[P.at(LEN, nd_row, nd_col)] = n;
                                }
                            } else {
                                int64_t rn = P.run[P.at(LEN, b_row, b_col)];
                                if (rn > 0 && a_row - rn >= ins_brk) {
                                    int64_t ru_row = (a_row - rn) + a_col - brk;
                                    int64_t ru_col = a2b_col(a_row - rn, a_col);
                                    if (ru_col < 2 * r) {
                                        float v =
                                            P.val[P.at(MAT, ru_row, ru_col)] +
                                            np_score(n, l[ni], rn / n + 1,
                                                     np_scores, max_l, max_l);
                                        if (v <
                                            P.val[P.at(LEN, nd_row, nd_col)]) {
                                            P.val[P.at(LEN, nd_row, nd_col)] = v;
                                            P.typ[P.at(LEN, nd_row, nd_col)] =
                                                LEN;
                                            P.run[P.at(LEN, nd_row, nd_col)] =
                                                rn + n;
                                        }
                                    }
                                }
                            }
                        }
                    }
                }

                // SHR first-col override
                if (a_col == del_brk) {
                    P.val[P.at(SHR, b_row, b_col)] =
                        (float)(INF * (a_row - ins_brk));
                    P.typ[P.at(SHR, b_row, b_col)] = INS;
                    P.run[P.at(SHR, b_row, b_col)] = a_row - ins_brk;
                }
                for (int n = 1; n <= max_n; n++) {
                    int ni = n - 1;
                    if (l[ni] == 0) continue;
                    if (a_col + n <= del_next) {
                        int64_t nr_row = a_row + (a_col + n) - brk;
                        int64_t nr_col = a2b_col(a_row, a_col + n);
                        if (nr_col < 2 * r) {
                            if (l_idx[ni] == 0) {
                                float v = P.val[P.at(MAT, b_row, b_col)] +
                                    np_score(n, l[ni], -1, np_scores, max_l,
                                             max_l);
                                if (v < P.val[P.at(SHR, nr_row, nr_col)]) {
                                    P.val[P.at(SHR, nr_row, nr_col)] = v;
                                    P.typ[P.at(SHR, nr_row, nr_col)] = SHR;
                                    P.run[P.at(SHR, nr_row, nr_col)] = n;
                                }
                            } else {
                                int64_t rn = P.run[P.at(SHR, b_row, b_col)];
                                if (rn > 0 && a_col - rn >= del_brk) {
                                    int64_t rl_row = a_row + (a_col - rn) - brk;
                                    int64_t rl_col = a2b_col(a_row, a_col - rn);
                                    if (rl_col > 0) {
                                        float v =
                                            P.val[P.at(MAT, rl_row, rl_col)] +
                                            np_score(n, l[ni], -(rn / n) - 1,
                                                     np_scores, max_l, max_l);
                                        if (v <
                                            P.val[P.at(SHR, nr_row, nr_col)]) {
                                            P.val[P.at(SHR, nr_row, nr_col)] = v;
                                            P.typ[P.at(SHR, nr_row, nr_col)] =
                                                SHR;
                                            P.run[P.at(SHR, nr_row, nr_col)] =
                                                rn + n;
                                        }
                                    }
                                }
                            }
                        }
                    }
                }
            }
        }

        // backtrack (src/aln.pyx:670-742)
        int64_t a_row = ins_next, a_col = del_next;
        std::string aln;
        while (a_row > ins_brk || a_col > del_brk) {
            int64_t b_row = a_row + a_col - brk;
            int64_t b_col = a2b_col(a_row, a_col);
            int t = P.typ[P.at(MAT, b_row, b_col)];
            int64_t rn = P.run[P.at(MAT, b_row, b_col)];
            if (a_row < 0 || a_col < 0 || rn < 1) { error = true; break; }
            if (t == LEN || t == INS) {
                aln.append(rn, 'I');
                a_row -= rn;
            } else if (t == SHR || t == DEL) {
                aln.append(rn, 'D');
                a_col -= rn;
            } else if (t == MAT) {
                for (int64_t k = 0; k < rn; k++) {
                    a_row--; a_col--;
                    aln.push_back(
                        full_ref[a_col] == full_seq[a_row] ? '=' : 'X');
                }
            } else { error = true; break; }
        }
        result.append(aln.rbegin(), aln.rend());
    }

    std::memcpy(out, result.data(), result.size());
    return error ? -(int64_t)result.size() - 1 : (int64_t)result.size();
}

}  // extern "C"
