// Streaming BGZF + BAM decoder with MD-tag reference reconstruction.
//
// Replaces the whole-file pure-Python decode path (io/bam.py) on the hot
// realignment host path, the way the reference leans on htslib streaming
// (reference: src/bam.pyx:18-47).  Design:
//
//  * BGZF blocks are inflated one at a time (raw deflate, BSIZE from the
//    BC extra subfield), so memory stays bounded by one sliding window and
//    every record has a virtual offset (coffset<<16 | uoffset) for seeks.
//  * Records are decoded in batches into caller-provided flat buffers:
//    a fixed int64 table per record plus one byte pool holding qname,
//    text CIGAR, seq, qual, SAM-rendered tags and (optionally) the
//    realignment prep arrays: int-coded aligned reference (from MD),
//    int-coded aligned query, and the expanded clip-stripped CIGAR.
//  * A sparse (ref_id, pos) -> voffset index is built while scanning; for
//    coordinate-sorted BAMs, fetch() seeks instead of rescanning.
//
// C ABI only (ctypes binding in npore_tpu/native/__init__.py).
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNF = 26;  // int64 fields per record, see bamio_next_batch

// base codes: N=0 A=1 C=2 G=3 T=4 (npore_tpu/constants.py, src/cfg.py:11-25)
int8_t nib_code[16];   // BAM 4-bit nibble -> base code
int8_t nib_char[16];   // BAM 4-bit nibble -> ASCII
int8_t base_code[256]; // ASCII -> base code
const char kCigChar[] = "MIDNSHP=XB";

struct Init {
  Init() {
    const char* nib = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; i++) {
      nib_char[i] = nib[i];
      nib_code[i] = 0;
    }
    nib_code[1] = 1; nib_code[2] = 2; nib_code[4] = 3; nib_code[8] = 4;
    memset(base_code, 0, sizeof(base_code));
    base_code['A'] = base_code['a'] = 1;
    base_code['C'] = base_code['c'] = 2;
    base_code['G'] = base_code['g'] = 3;
    base_code['T'] = base_code['t'] = 4;
    base_code['-'] = 5;
  }
} init_;

struct IndexEntry {
  int32_t ref_id;
  int64_t pos;
  uint64_t voff;
};

struct BamIO {
  FILE* fp = nullptr;
  // decompressed sliding window
  std::vector<uint8_t> buf;
  size_t consume = 0;              // parse offset into buf
  // virtual-offset bookkeeping: block boundaries inside buf
  struct Blk { size_t buf_off; uint64_t coffset; };
  std::vector<Blk> blocks;
  uint64_t next_coffset = 0;       // file offset of the next unread block
  bool eof = false;

  std::string header_text;
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  uint64_t first_rec_voff = 0;

  // filters
  int32_t flt_ref = -2;            // -2: no region filter
  int64_t flt_start = -1, flt_stop = -1;
  int32_t excl_flags = 0;
  bool prep = false;               // emit aref/aseq/ecig

  // sparse index over scanned records + sortedness tracking
  std::vector<IndexEntry> index;
  int64_t n_scanned = 0;
  int32_t last_ref = -1;
  int64_t last_pos = -1;
  bool sorted_ok = true;

  std::string err;
};

// Inflate the next BGZF block into h->buf.  Returns false on EOF/error.
bool read_block(BamIO* h) {
  if (h->eof) return false;
  uint8_t hdr[18];
  uint64_t coff = h->next_coffset;
  size_t got = fread(hdr, 1, 18, h->fp);
  if (got == 0) { h->eof = true; return false; }
  if (got < 18 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
    h->err = "bad BGZF block header";
    h->eof = true;
    return false;
  }
  // find BC subfield inside the extra area
  uint16_t xlen = hdr[10] | (hdr[11] << 8);
  std::vector<uint8_t> extra(xlen);
  if (xlen >= 6) {
    // hdr already consumed 6 bytes of extra (offsets 12..17)
    memcpy(extra.data(), hdr + 12, 6);
    if (xlen > 6 && fread(extra.data() + 6, 1, xlen - 6, h->fp) != xlen - 6u) {
      h->err = "truncated BGZF extra";
      h->eof = true;
      return false;
    }
  } else {
    h->err = "BGZF block without BC field";
    h->eof = true;
    return false;
  }
  int bsize = -1;
  for (size_t i = 0; i + 4 <= extra.size();) {
    uint8_t si1 = extra[i], si2 = extra[i + 1];
    uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2 && i + 6 <= extra.size()) {
      bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
      break;
    }
    i += 4 + slen;
  }
  if (bsize < 0) {
    h->err = "BGZF block without BSIZE";
    h->eof = true;
    return false;
  }
  size_t remaining = bsize - 12 - xlen;  // compressed data + crc + isize
  std::vector<uint8_t> comp(remaining);
  if (fread(comp.data(), 1, remaining, h->fp) != remaining) {
    h->err = "truncated BGZF block";
    h->eof = true;
    return false;
  }
  if (remaining < 8) { h->eof = true; return false; }
  uint32_t isize;
  memcpy(&isize, comp.data() + remaining - 4, 4);
  size_t old = h->buf.size();
  if (isize > 0) {
    h->buf.resize(old + isize);
    z_stream s;
    memset(&s, 0, sizeof(s));
    if (inflateInit2(&s, -15) != Z_OK) {
      h->err = "inflateInit2 failed";
      h->eof = true;
      return false;
    }
    s.next_in = comp.data();
    s.avail_in = (uInt)(remaining - 8);
    s.next_out = h->buf.data() + old;
    s.avail_out = isize;
    int rc = inflate(&s, Z_FINISH);
    inflateEnd(&s);
    if (rc != Z_STREAM_END) {
      h->err = "inflate failed";
      h->buf.resize(old);
      h->eof = true;
      return false;
    }
  }
  h->blocks.push_back({old, coff});
  h->next_coffset = coff + bsize;
  return isize > 0 || !h->eof;  // zero-length (EOF marker) blocks continue
}

// ensure at least n unconsumed bytes in buf (or EOF)
bool ensure(BamIO* h, size_t n) {
  while (h->buf.size() - h->consume < n) {
    if (!read_block(h)) return false;
  }
  return true;
}

// drop consumed prefix, keeping block bookkeeping consistent
void compact(BamIO* h) {
  if (h->consume < (1u << 20)) return;
  size_t cut = h->consume;
  // keep the newest block whose buf_off <= cut as the base
  size_t keep = 0;
  for (size_t i = 0; i < h->blocks.size(); i++) {
    if (h->blocks[i].buf_off <= cut) keep = i;
  }
  h->blocks.erase(h->blocks.begin(), h->blocks.begin() + keep);
  size_t base = h->blocks.empty() ? cut : h->blocks[0].buf_off;
  if (base > 0) {
    h->buf.erase(h->buf.begin(), h->buf.begin() + base);
    h->consume -= base;
    for (auto& b : h->blocks) b.buf_off -= base;
  }
}

// virtual offset of the unconsumed parse position
uint64_t cur_voff(BamIO* h) {
  // newest block starting at or before consume
  const BamIO::Blk* best = nullptr;
  for (auto& b : h->blocks)
    if (b.buf_off <= h->consume) best = &b;
  if (!best) return 0;
  return (best->coffset << 16) | (uint64_t)(h->consume - best->buf_off);
}

bool seek_voff(BamIO* h, uint64_t voff) {
  uint64_t coff = voff >> 16;
  size_t uoff = voff & 0xffff;
  if (fseek(h->fp, (long)coff, SEEK_SET) != 0) return false;
  h->buf.clear();
  h->blocks.clear();
  h->consume = 0;
  h->next_coffset = coff;
  h->eof = false;
  if (!ensure(h, uoff)) return false;
  h->consume = uoff;
  return true;
}

int64_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

struct Pool {
  char* base;
  int64_t cap;
  int64_t used = 0;
  bool overflow = false;
  int64_t alloc(int64_t n) {
    if (used + n > cap) {
      overflow = true;
      return -1;
    }
    int64_t off = used;
    used += n;
    return off;
  }
};

// append SAM text rendering of one tag; returns false on unknown type
bool render_tag(const uint8_t* p, size_t len, size_t& i, std::string& out) {
  if (i + 3 > len) return false;
  char t0 = p[i], t1 = p[i + 1], typ = p[i + 2];
  i += 3;
  char tmp[64];
  out.push_back(t0);
  out.push_back(t1);
  auto fixed_int = [&](int64_t v) {
    snprintf(tmp, sizeof(tmp), ":i:%lld", (long long)v);
    out += tmp;
  };
  switch (typ) {
    case 'A':
      if (i + 1 > len) return false;
      out += ":A:";
      out.push_back((char)p[i]);
      i += 1;
      return true;
    case 'c': { if (i + 1 > len) return false; fixed_int((int8_t)p[i]); i += 1; return true; }
    case 'C': { if (i + 1 > len) return false; fixed_int(p[i]); i += 1; return true; }
    case 's': { if (i + 2 > len) return false; int16_t v; memcpy(&v, p + i, 2); fixed_int(v); i += 2; return true; }
    case 'S': { if (i + 2 > len) return false; uint16_t v; memcpy(&v, p + i, 2); fixed_int(v); i += 2; return true; }
    case 'i': { if (i + 4 > len) return false; int32_t v; memcpy(&v, p + i, 4); fixed_int(v); i += 4; return true; }
    case 'I': { if (i + 4 > len) return false; uint32_t v; memcpy(&v, p + i, 4); fixed_int(v); i += 4; return true; }
    case 'f': {
      if (i + 4 > len) return false;
      float v;
      memcpy(&v, p + i, 4);
      i += 4;
      snprintf(tmp, sizeof(tmp), ":f:%g", v);
      out += tmp;
      return true;
    }
    case 'Z':
    case 'H': {
      size_t e = i;
      while (e < len && p[e] != 0) e++;
      if (e >= len) return false;
      out += (typ == 'Z') ? ":Z:" : ":H:";
      out.append((const char*)p + i, e - i);
      i = e + 1;
      return true;
    }
    case 'B': {
      if (i + 5 > len) return false;
      char sub = p[i];
      uint32_t cnt = rd_u32(p + i + 1);
      i += 5;
      out += ":B:";
      out.push_back(sub);
      int sz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
      if (i + (size_t)sz * cnt > len) return false;
      for (uint32_t k = 0; k < cnt; k++) {
        int64_t v = 0;
        float fv = 0;
        switch (sub) {
          case 'c': v = (int8_t)p[i]; break;
          case 'C': v = p[i]; break;
          case 's': { int16_t x; memcpy(&x, p + i, 2); v = x; } break;
          case 'S': { uint16_t x; memcpy(&x, p + i, 2); v = x; } break;
          case 'i': { int32_t x; memcpy(&x, p + i, 4); v = x; } break;
          case 'I': { uint32_t x; memcpy(&x, p + i, 4); v = x; } break;
          case 'f': memcpy(&fv, p + i, 4); break;
          default: return false;
        }
        i += sz;
        if (sub == 'f')
          snprintf(tmp, sizeof(tmp), ",%g", fv);
        else
          snprintf(tmp, sizeof(tmp), ",%lld", (long long)v);
        out += tmp;
      }
      return true;
    }
    default:
      return false;
  }
}

// MD-tag walk: reconstruct aligned reference codes.  Mirrors
// io/sam.py:get_reference_sequence (pysam parity: src/bam.pyx:45).
// Returns false on MD/CIGAR mismatch.
bool md_to_ref(const char* md, const uint32_t* cig, int n_cig,
               const int8_t* aseq, std::vector<int8_t>& out) {
  struct Op { char kind; int64_t num; const char* s; int slen; };
  std::vector<Op> ops;
  for (const char* p = md; *p;) {
    if (*p >= '0' && *p <= '9') {
      int64_t v = 0;
      while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      ops.push_back({'=', v, nullptr, 0});
    } else if (*p == '^') {
      const char* s = ++p;
      while ((*p >= 'A' && *p <= 'Z') || (*p >= 'a' && *p <= 'z')) p++;
      ops.push_back({'D', 0, s, (int)(p - s)});
    } else if ((*p >= 'A' && *p <= 'Z') || (*p >= 'a' && *p <= 'z')) {
      ops.push_back({'X', 0, p, 1});
      p++;
    } else {
      p++;  // unexpected char: skip (defensive)
    }
  }
  size_t mi = 0;
  int64_t md_rem = 0;
  int64_t q = 0;
  for (int c = 0; c < n_cig; c++) {
    int64_t n = cig[c] >> 4;
    char op = kCigChar[cig[c] & 0xf];
    if (op == 'S' || op == 'H') continue;
    if (op == 'M' || op == '=' || op == 'X') {
      int64_t left = n;
      while (left) {
        if (md_rem == 0) {
          if (mi >= ops.size()) return false;
          Op o = ops[mi++];
          if (o.kind == '=') {
            md_rem = o.num;
            if (md_rem == 0) continue;
          } else if (o.kind == 'X') {
            out.push_back(base_code[(uint8_t)o.s[0]]);
            q++;
            left--;
            continue;
          } else {
            return false;  // deletion inside match run
          }
        }
        int64_t take = left < md_rem ? left : md_rem;
        for (int64_t k = 0; k < take; k++) out.push_back(aseq[q + k]);
        q += take;
        md_rem -= take;
        left -= take;
      }
    } else if (op == 'D') {
      while (md_rem == 0 && mi < ops.size() && ops[mi].kind == '=' &&
             ops[mi].num == 0)
        mi++;
      if (md_rem != 0 || mi >= ops.size() || ops[mi].kind != 'D') return false;
      Op o = ops[mi++];
      if (o.slen != n) return false;
      for (int k = 0; k < o.slen; k++)
        out.push_back(base_code[(uint8_t)o.s[k]]);
    } else if (op == 'I') {
      q += n;
    }
    // N consumes neither MD nor query here (matches io/sam.py); P/B ignored
  }
  return true;
}

}  // namespace

extern "C" {

void* bamio_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  BamIO* h = new BamIO();
  h->fp = fp;
  // header
  if (!ensure(h, 8)) { delete h; return nullptr; }
  if (memcmp(h->buf.data(), "BAM\x01", 4) != 0) { delete h; return nullptr; }
  int64_t l_text = rd_i32(h->buf.data() + 4);
  if (!ensure(h, 8 + l_text + 4)) { delete h; return nullptr; }
  h->header_text.assign((const char*)h->buf.data() + 8, l_text);
  size_t off = 8 + l_text;
  int64_t n_ref = rd_i32(h->buf.data() + off);
  off += 4;
  for (int64_t i = 0; i < n_ref; i++) {
    if (!ensure(h, off + 4)) { delete h; return nullptr; }
    int64_t l_name = rd_i32(h->buf.data() + off);
    off += 4;
    if (!ensure(h, off + l_name + 4)) { delete h; return nullptr; }
    h->ref_names.emplace_back((const char*)h->buf.data() + off, l_name - 1);
    off += l_name;
    h->ref_lens.push_back(rd_i32(h->buf.data() + off));
    off += 4;
  }
  h->consume = off;
  h->first_rec_voff = cur_voff(h);
  return h;
}

void bamio_close(void* hv) {
  BamIO* h = (BamIO*)hv;
  if (h->fp) fclose(h->fp);
  delete h;
}

long long bamio_header_len(void* hv) { return ((BamIO*)hv)->header_text.size(); }
void bamio_header_text(void* hv, char* out) {
  BamIO* h = (BamIO*)hv;
  memcpy(out, h->header_text.data(), h->header_text.size());
}
int bamio_n_refs(void* hv) { return (int)((BamIO*)hv)->ref_names.size(); }
int bamio_ref_name_len(void* hv, int i) {
  return (int)((BamIO*)hv)->ref_names[i].size();
}
void bamio_ref_name(void* hv, int i, char* out) {
  BamIO* h = (BamIO*)hv;
  memcpy(out, h->ref_names[i].data(), h->ref_names[i].size());
}
long long bamio_ref_len(void* hv, int i) { return ((BamIO*)hv)->ref_lens[i]; }

void bamio_set_filter(void* hv, int excl_flags, int prep) {
  BamIO* h = (BamIO*)hv;
  h->excl_flags = excl_flags;
  h->prep = prep != 0;
}

// region filter: ref_id -2 disables; stop -1 = unbounded
void bamio_set_region(void* hv, int ref_id, long long start, long long stop) {
  BamIO* h = (BamIO*)hv;
  h->flt_ref = ref_id;
  h->flt_start = start;
  h->flt_stop = stop;
}

int bamio_rewind(void* hv) {
  BamIO* h = (BamIO*)hv;
  h->err.clear();
  return seek_voff(h, h->first_rec_voff) ? 0 : -1;
}

// Seek to the best sparse-index point at or before (ref_id, pos); falls
// back to rewind.  Only valid when the scan so far looked sorted.
int bamio_seek_before(void* hv, int ref_id, long long pos) {
  BamIO* h = (BamIO*)hv;
  h->err.clear();
  if (!h->sorted_ok) return bamio_rewind(hv);
  uint64_t best = h->first_rec_voff;
  for (auto& e : h->index) {
    if (e.ref_id < ref_id || (e.ref_id == ref_id && e.pos <= pos))
      best = e.voff;
    else
      break;
  }
  return seek_voff(h, best) ? 0 : -1;
}

int bamio_sorted(void* hv) { return ((BamIO*)hv)->sorted_ok ? 1 : 0; }

long long bamio_error_len(void* hv) { return ((BamIO*)hv)->err.size(); }
void bamio_error(void* hv, char* out) {
  BamIO* h = (BamIO*)hv;
  memcpy(out, h->err.data(), h->err.size());
}

// Decode up to max_recs records.  fixed: int64[max_recs*kNF]; pool: bytes.
// Per-record fixed fields:
//   0 flag  1 ref_id  2 pos  3 mapq  4 next_ref_id  5 next_pos  6 tlen
//   7 l_seq  8 qname_off  9 qname_len  10 cigar_off  11 cigar_len
//   12 seq_off (text; len = l_seq)  13 qual_off (-1 if absent)
//   14 tags_off  15 tags_len  (SAM text, '\t'-joined)
//   16 aref_off  17 aref_len  18 aseq_off  19 aseq_len
//   20 ecig_off  21 ecig_len  22 prep_err (1: MD missing/mismatch)
//   23 ref_span  24 lead_clip  25 tail_clip
// Returns #records (0 = EOF); -1 on stream error; if the pool fills, the
// batch ends early (the unparsed record is re-read next call).
long long bamio_next_batch(void* hv, long long max_recs, long long* fixed,
                           char* pool_base, long long pool_cap) {
  BamIO* h = (BamIO*)hv;
  Pool pool{pool_base, pool_cap};
  long long nrec = 0;
  std::string tags_text;
  std::vector<int8_t> aref;
  std::vector<int8_t> aseq;

  while (nrec < max_recs) {
    compact(h);
    size_t save_consume = h->consume;
    std::vector<uint8_t> save_hack;  // (unused; consume rollback suffices)
    if (!ensure(h, 4)) break;
    uint64_t rec_voff = cur_voff(h);
    int64_t block_size = rd_i32(h->buf.data() + h->consume);
    if (!ensure(h, 4 + block_size)) {
      h->err = "truncated record";
      break;
    }
    const uint8_t* rec = h->buf.data() + h->consume + 4;
    int32_t ref_id = (int32_t)rd_i32(rec);
    int64_t pos = rd_i32(rec + 4);
    uint8_t l_read_name = rec[8];
    uint8_t mapq = rec[9];
    uint16_t n_cigar = rec[12] | (rec[13] << 8);
    uint16_t flag = rec[14] | (rec[15] << 8);
    int64_t l_seq = rd_i32(rec + 16);
    int32_t next_ref_id = (int32_t)rd_i32(rec + 20);
    int64_t next_pos = rd_i32(rec + 24);
    int64_t tlen = rd_i32(rec + 28);
    const uint8_t* qname = rec + 32;
    const uint32_t* cig = (const uint32_t*)(qname + l_read_name);
    const uint8_t* seqp = (const uint8_t*)(cig + n_cigar);
    const uint8_t* qualp = seqp + (l_seq + 1) / 2;
    const uint8_t* tagp = qualp + l_seq;
    const uint8_t* rec_end = rec + block_size;

    // sortedness + sparse index bookkeeping (primary coordinates only)
    if (ref_id >= 0) {
      if (h->last_ref >= 0 &&
          (ref_id < h->last_ref ||
           (ref_id == h->last_ref && pos < h->last_pos)))
        h->sorted_ok = false;
      h->last_ref = ref_id;
      h->last_pos = pos;
      if ((h->n_scanned & 63) == 0 &&
          (h->index.empty() || h->index.back().voff < rec_voff))
        h->index.push_back({ref_id, pos, rec_voff});
    }
    h->n_scanned++;

    // cheap filters before any text materialization
    int64_t ref_span = 0;
    int64_t lead_clip = 0, tail_clip = 0;
    for (int c = 0; c < n_cigar; c++) {
      uint32_t op = cig[c] & 0xf;
      int64_t n = cig[c] >> 4;
      // M D N = X consume reference
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_span += n;
    }
    for (int c = 0; c < n_cigar; c++) {
      uint32_t op = cig[c] & 0xf;
      if (op == 4) { lead_clip += cig[c] >> 4; continue; }
      if (op == 5) continue;
      break;
    }
    for (int c = n_cigar - 1; c >= 0; c--) {
      uint32_t op = cig[c] & 0xf;
      if (op == 4) { tail_clip += cig[c] >> 4; continue; }
      if (op == 5) continue;
      break;
    }
    bool keep = true;
    if (flag & h->excl_flags) keep = false;
    if (keep && h->flt_ref != -2) {
      if (flag & 0x4) {
        keep = false;  // unmapped never match a region
      } else if (ref_id != h->flt_ref) {
        keep = false;
        // sorted scan past the region's contig can stop early
        if (h->sorted_ok && ref_id > h->flt_ref) {
          // leave record unconsumed so a later fetch can resume here
          h->consume = save_consume;
          return nrec;
        }
      } else {
        if (h->flt_start >= 0 && pos + ref_span <= h->flt_start) keep = false;
        if (h->flt_stop >= 0 && pos > h->flt_stop) {
          keep = false;
          if (h->sorted_ok) {
            h->consume = save_consume;
            return nrec;
          }
        }
      }
    }
    if (!keep) {
      h->consume += 4 + block_size;
      continue;
    }

    // --- materialize into the pool ---
    tags_text.clear();
    size_t ti = 0;
    size_t tlen_bytes = rec_end - tagp;
    bool tag_ok = true;
    while (ti < tlen_bytes) {
      if (!tags_text.empty()) tags_text.push_back('\t');
      else tags_text.clear();
      std::string one;
      if (!render_tag(tagp, tlen_bytes, ti, one)) {
        tag_ok = false;
        break;
      }
      if (tags_text.empty())
        tags_text = one;
      else
        tags_text += one;
    }
    if (!tag_ok) tags_text.clear();

    // expanded CIGAR text + clip-stripped expanded cigar lengths
    int64_t cig_text_len = 0;
    {
      char tmp[16];
      for (int c = 0; c < n_cigar; c++)
        cig_text_len += snprintf(tmp, sizeof(tmp), "%u", cig[c] >> 4) + 1;
      if (n_cigar == 0) cig_text_len = 1;
    }
    int64_t ecig_len = 0;
    if (h->prep) {
      for (int c = 0; c < n_cigar; c++) {
        uint32_t op = cig[c] & 0xf;
        if (op == 4 || op == 5) continue;
        ecig_len += cig[c] >> 4;
      }
    }
    int64_t aseq_len = l_seq - lead_clip - tail_clip;
    if (aseq_len < 0) aseq_len = 0;

    int64_t need = l_read_name - 1 + cig_text_len + l_seq + l_seq +
                   (int64_t)tags_text.size() + 16;
    if (h->prep) need += aseq_len + ref_span + 64 + ecig_len;
    if (pool.used + need > pool.cap) {
      if (nrec == 0) return -2;  // pool too small for even one record
      h->consume = save_consume;
      return nrec;
    }

    long long* f = fixed + nrec * kNF;
    f[0] = flag;
    f[1] = ref_id;
    f[2] = pos;
    f[3] = mapq;
    f[4] = next_ref_id;
    f[5] = next_pos;
    f[6] = tlen;
    f[7] = l_seq;
    // qname
    int64_t qn_off = pool.alloc(l_read_name - 1);
    memcpy(pool.base + qn_off, qname, l_read_name - 1);
    f[8] = qn_off;
    f[9] = l_read_name - 1;
    // cigar text
    int64_t cg_off = pool.used;
    if (n_cigar == 0) {
      pool.alloc(1);
      pool.base[cg_off] = '*';
      f[10] = cg_off;
      f[11] = 1;
    } else {
      char tmp[16];
      for (int c = 0; c < n_cigar; c++) {
        int w = snprintf(tmp, sizeof(tmp), "%u%c", cig[c] >> 4,
                         kCigChar[cig[c] & 0xf]);
        int64_t o = pool.alloc(w);
        memcpy(pool.base + o, tmp, w);
      }
      f[10] = cg_off;
      f[11] = pool.used - cg_off;
    }
    // seq text
    int64_t sq_off = pool.alloc(l_seq);
    for (int64_t i = 0; i < l_seq; i++) {
      uint8_t nb = (i & 1) ? (seqp[i >> 1] & 0xf) : (seqp[i >> 1] >> 4);
      pool.base[sq_off + i] = nib_char[nb];
    }
    f[12] = sq_off;
    // qual text
    if (l_seq > 0 && qualp[0] != 0xff) {
      int64_t q_off = pool.alloc(l_seq);
      for (int64_t i = 0; i < l_seq; i++)
        pool.base[q_off + i] = (char)(33 + qualp[i]);
      f[13] = q_off;
    } else {
      f[13] = -1;
    }
    // tags text
    int64_t tg_off = pool.alloc((int64_t)tags_text.size());
    memcpy(pool.base + tg_off, tags_text.data(), tags_text.size());
    f[14] = tg_off;
    f[15] = (int64_t)tags_text.size();

    f[16] = f[17] = f[18] = f[19] = f[20] = f[21] = 0;
    f[22] = 0;
    f[23] = ref_span;
    f[24] = lead_clip;
    f[25] = tail_clip;

    if (h->prep) {
      // aligned query codes (clip-stripped)
      aseq.clear();
      aseq.reserve(aseq_len);
      for (int64_t i = lead_clip; i < l_seq - tail_clip; i++) {
        uint8_t nb = (i & 1) ? (seqp[i >> 1] & 0xf) : (seqp[i >> 1] >> 4);
        aseq.push_back(nib_code[nb]);
      }
      int64_t as_off = pool.alloc((int64_t)aseq.size());
      memcpy(pool.base + as_off, aseq.data(), aseq.size());
      f[18] = as_off;
      f[19] = (int64_t)aseq.size();
      // MD -> aligned reference codes
      const char* md = nullptr;
      {
        size_t i2 = 0;
        while (i2 + 3 <= tlen_bytes) {
          char t0 = tagp[i2], t1 = tagp[i2 + 1], typ = tagp[i2 + 2];
          if (t0 == 'M' && t1 == 'D' && typ == 'Z') {
            md = (const char*)tagp + i2 + 3;
            break;
          }
          // skip value
          std::string scratch;
          size_t j = i2;
          if (!render_tag(tagp, tlen_bytes, j, scratch)) break;
          i2 = j;
        }
      }
      aref.clear();
      if (md == nullptr ||
          !md_to_ref(md, cig, n_cigar, aseq.data(), aref)) {
        f[22] = 1;
      } else {
        int64_t ar_off = pool.alloc((int64_t)aref.size());
        memcpy(pool.base + ar_off, aref.data(), aref.size());
        f[16] = ar_off;
        f[17] = (int64_t)aref.size();
      }
      // expanded, clip-stripped cigar
      int64_t ec_off = pool.alloc(ecig_len);
      char* ec = pool.base + ec_off;
      for (int c = 0; c < n_cigar; c++) {
        uint32_t op = cig[c] & 0xf;
        if (op == 4 || op == 5) continue;
        int64_t n = cig[c] >> 4;
        memset(ec, kCigChar[op], n);
        ec += n;
      }
      f[20] = ec_off;
      f[21] = ecig_len;
    }

    h->consume += 4 + block_size;
    nrec++;
  }
  if (!h->err.empty() && nrec == 0) return -1;
  return nrec;
}

}  // extern "C"
