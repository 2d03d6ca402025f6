// n-polymer scanner, native implementation.
//
// Bit-identical to golden/npinfo.py (reference: src/aln.pyx:179-251) via the
// run-length formulation of ops/npinfo_host.py (equality-tested against the
// golden sequential spec). Layout of `out`: (slen, 2, max_n) int32, [p][0][ni]
// = L (clamped to max_l), [p][1][ni] = L_IDX.
//
// Built as a shared library and bound with ctypes (no pybind11 in the image).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

void np_info(const uint8_t* seq, int64_t slen, int32_t max_n, int32_t max_l,
             int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * (size_t)slen * 2 * max_n);
    if (slen <= 1) return;
    std::vector<int64_t> t(slen), raw(slen);
    std::vector<uint8_t> qual(slen);

    auto L = [&](int64_t p, int32_t ni) -> int32_t& {
        return out[(p * 2 + 0) * max_n + ni];
    };
    auto LIDX = [&](int64_t p, int32_t ni) -> int32_t& {
        return out[(p * 2 + 1) * max_n + ni];
    };

    for (int32_t n = 1; n <= max_n; n++) {
        int64_t mlen = slen - n;
        if (mlen <= 0) continue;
        // t[s] = length of the run of self-similarity matches starting at s
        int64_t next_false = mlen;
        for (int64_t s = mlen - 1; s >= 0; s--) {
            if (seq[s] != seq[s + n]) next_false = s;
            t[s] = next_false - s;
            if (t[s] < 0) t[s] = 0;
        }
        for (int64_t s = 0; s < mlen; s++) {
            int64_t units = t[s] / n;
            raw[s] = units > 0 ? units + 1 : 0;
            bool q = raw[s] > 2 && seq[s] != 0;
            for (int32_t n2 = 1; q && n2 < n; n2++)
                q = raw[s] * n > (int64_t)L(s, n2 - 1) * n2;
            qual[s] = q;
        }
        for (int64_t s = 0; s < mlen; s++) {
            if (!qual[s]) continue;
            int64_t l = raw[s];
            int32_t lc = (int32_t)(l < max_l ? l : max_l);
            int32_t widx = 0;
            for (int64_t i = 0; i < l; i++) {
                int64_t pos = s + i * n;
                if (l > L(pos, n - 1)) {
                    L(pos, n - 1) = lc;
                    LIDX(pos, n - 1) = widx++;
                }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CIGAR left-normalization (reference: src/cig.pyx:102-192, src/bam.pyx:64-78)
// Op codes follow 'MIDNSHP=XB': M=0 I=1 D=2 E('=')=7 X=8.
// ---------------------------------------------------------------------------

static const uint8_t OPM = 0, OPI = 1, OPD = 2, OPE = 7, OPX = 8;

static void push_indels_left_c(uint8_t* cig, int64_t n, const int8_t* seq,
                               uint8_t push_op) {
    int64_t cig_ptr = 0, seq_ptr = 0;
    std::vector<uint8_t> moved;
    while (cig_ptr < n) {
        uint8_t op = cig[cig_ptr];
        if (op != push_op) {
            cig_ptr++;
            if (op == OPM || op == OPX || op == OPE) seq_ptr++;
            continue;
        }
        int64_t indel_len = 1;
        while (cig_ptr + indel_len < n && cig[cig_ptr + indel_len] == push_op)
            indel_len++;

        int64_t nshifts = 0;
        while (cig_ptr - nshifts > 0 && seq_ptr - nshifts > 0 &&
               seq[seq_ptr - nshifts - 1] ==
                   seq[seq_ptr - nshifts - 1 + indel_len] &&
               (cig[cig_ptr - nshifts - 1] == OPE ||
                cig[cig_ptr - nshifts - 1] == OPM))
            nshifts++;

        if (nshifts) {
            moved.assign(cig + cig_ptr - nshifts, cig + cig_ptr);
            for (int64_t i = 0; i < indel_len; i++)
                cig[cig_ptr - nshifts + i] = cig[cig_ptr + i];
            for (int64_t i = 0; i < nshifts; i++)
                cig[cig_ptr - nshifts + indel_len + i] = moved[i];
        }
        cig_ptr += indel_len;
        // reference quirk: seq_ptr advances as if by the pre-loop op
        if (op == OPM || op == OPX || op == OPE) seq_ptr++;
        else if (op == push_op) seq_ptr += indel_len;
    }
}

static void push_inss_thru_dels_c(uint8_t* cig, int64_t n) {
    for (int64_t i = 0; i + 1 < n; i++) {
        if (cig[i] == OPD && cig[i + 1] == OPI) {
            int64_t del_idx = i - 1;
            while (del_idx >= 0 && cig[del_idx] == OPD) del_idx--;
            int64_t dels = i - del_idx;
            int64_t ins_idx = i + 1;
            while (ins_idx < n && cig[ins_idx] == OPI) ins_idx++;
            int64_t inss = ins_idx - i - 1;
            for (int64_t k = 0; k < inss; k++) cig[del_idx + 1 + k] = OPI;
            for (int64_t k = 0; k < dels; k++)
                cig[del_idx + 1 + inss + k] = OPD;
        }
    }
}

extern "C" {

// In-place fixpoint normalization; returns the number of passes.
int32_t normalize_cigar(uint8_t* cig, int64_t n, const int8_t* ref,
                        const int8_t* seq) {
    std::vector<uint8_t> prev(n);
    int32_t iters = 0;
    while (true) {
        std::memcpy(prev.data(), cig, n);
        push_indels_left_c(cig, n, ref, OPD);
        push_inss_thru_dels_c(cig, n);
        push_indels_left_c(cig, n, seq, OPI);
        push_inss_thru_dels_c(cig, n);
        iters++;
        if (std::memcmp(prev.data(), cig, n) == 0) break;
    }
    return iters;
}

// Full realigner CIGAR finalization (reference: src/bam.pyx:64-83):
// extended chars ('MIDX=') -> int ops with X/= folded into M, fixpoint
// left-normalization, 'ID' pair fusion to 'M' (left-to-right,
// non-overlapping, = str.replace semantics), run-length encode into
// `out` ("12M3I..."). Returns the output byte length, or -1 on an
// invalid op char. `out` must hold >= 12*n + 16 bytes.
int64_t finalize_cigar(const uint8_t* ext, int64_t n, const int8_t* ref,
                       const int8_t* seq, uint8_t* out) {
    if (n == 0) return 0;
    std::vector<uint8_t> cig(n);
    for (int64_t i = 0; i < n; i++) {
        switch (ext[i]) {
            case 'M': case 'X': case '=': cig[i] = OPM; break;
            case 'I': cig[i] = OPI; break;
            case 'D': cig[i] = OPD; break;
            default: return -1;
        }
    }
    normalize_cigar(cig.data(), n, ref, seq);
    // fuse 'ID' -> 'M' in place (pairs cannot overlap: a pair's D never
    // starts another pair)
    int64_t w = 0;
    for (int64_t i = 0; i < n; ) {
        if (cig[i] == OPI && i + 1 < n && cig[i + 1] == OPD) {
            cig[w++] = OPM;
            i += 2;
        } else {
            cig[w++] = cig[i++];
        }
    }
    static const char kOps[3] = {'M', 'I', 'D'};
    int64_t o = 0;
    for (int64_t i = 0; i < w; ) {
        int64_t j = i;
        while (j < w && cig[j] == cig[i]) j++;
        int64_t cnt = j - i;
        char buf[24];
        int len = std::snprintf(buf, sizeof(buf), "%lld",
                                static_cast<long long>(cnt));
        std::memcpy(out + o, buf, len);
        o += len;
        out[o++] = kOps[cig[i]];
        i = j;
    }
    return o;
}

// Prefix-I counts along the reparameterized path (reference:
// src/aln.pyx:279-292 after the :386 M->DI rewrite): each M/X/=
// contributes a D step then an I step, I/D one step. Writes the
// (n_steps+1)-long prefix array (out[0] = 0) and returns its length,
// or -1 on an invalid op char. `out` must hold >= 2n+2 entries.
int64_t path_inss(const uint8_t* cig, int64_t n, int64_t* out) {
    int64_t k = 0, acc = 0;
    out[k++] = 0;
    for (int64_t i = 0; i < n; i++) {
        switch (cig[i]) {
            case 'M': case 'X': case '=':
                out[k++] = acc;
                out[k++] = ++acc;
                break;
            case 'I': out[k++] = ++acc; break;
            case 'D': out[k++] = acc; break;
            default: return -1;
        }
    }
    return k;
}

// Batched finalization: m reads in ONE FFI call. The per-read ctypes
// glue (frombuffer/ascontiguousarray/arg marshalling) costs 30-50us of
// GIL-bound Python per read on the realigner's hot emit path; here the
// host passes pointer/length arrays once and slices results out of one
// buffer. Compact cigars are written back-to-back into `out` with
// per-read offsets in `out_offs` (m+1 entries). Returns total bytes,
// or -(i+1) when read i has an invalid op char (the caller re-runs that
// read through the per-read path for the exact error), or
// -1000000 - i when `out` would overflow at read i.
int64_t finalize_cigar_batch(int64_t m, const uint64_t* ext_ptrs,
                             const int64_t* ext_lens,
                             const uint64_t* ref_ptrs,
                             const uint64_t* seq_ptrs,
                             uint8_t* out, int64_t out_cap,
                             int64_t* out_offs) {
    int64_t off = 0;
    for (int64_t i = 0; i < m; i++) {
        int64_t worst = 12 * (ext_lens[i] > 0 ? ext_lens[i] : 1) + 16;
        if (off + worst > out_cap) return -1000000 - i;
        int64_t n = finalize_cigar(
            reinterpret_cast<const uint8_t*>(ext_ptrs[i]), ext_lens[i],
            reinterpret_cast<const int8_t*>(ref_ptrs[i]),
            reinterpret_cast<const int8_t*>(seq_ptrs[i]), out + off);
        if (n < 0) return -(i + 1);
        out_offs[i] = off;
        off += n;
    }
    out_offs[m] = off;
    return off;
}

}  // extern "C"
