// Native BAM scanner: parallel BGZF inflate + columnar record extraction.
//
// The reference delegates all BAM decode to htslib/samtools (SURVEY.md §2.2
// 'samtools/bcftools', 'htsbox'); this is the engine's native data-loader
// equivalent — it feeds read batches to the host pipeline without the
// per-record Python cost of io/bam.py (which stays as the general,
// tag-aware fallback).
//
// Layout returned to Python (all buffers malloc'd, freed by bam_scan_free):
//   fixed per-record columns: flag/ref_id/pos/mapq/l_seq/next_* as int32/i64
//   variable columns as (blob, offsets[n+1]): qname (NUL-stripped), cigar
//   (raw BAM uint32 op-words), seq (ASCII, 4-bit nibbles decoded here).
// Tags and qual are intentionally skipped — callers needing them use the
// Python reader.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct Block {
  size_t comp_off;   // offset of deflate payload within file buffer
  size_t comp_len;   // deflate payload length
  size_t out_off;    // offset within decompressed stream
  uint32_t isize;    // uncompressed size
};

bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst,
                   uint32_t dst_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = dst_len;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == dst_len;
}

const char SEQ_NT[17] = "=ACMGRSVTWYHKDBN";

}  // namespace

extern "C" {

struct BamScanResult {
  int64_t n_records;
  int32_t* flag;
  int32_t* ref_id;
  int64_t* pos;
  int32_t* mapq;
  int32_t* next_ref_id;
  int64_t* next_pos;
  int64_t* name_off;   // n+1
  char* names;
  int64_t* cig_off;    // n+1 (counts of uint32 words)
  uint32_t* cigs;
  int64_t* seq_off;    // n+1
  char* seqs;
  // header
  int32_t n_refs;
  int64_t* ref_name_off;  // n_refs+1
  char* ref_names;
  int64_t* ref_len;
  char* header_text;
  int64_t header_len;
  const char* error;   // static string, not freed
};

void bam_scan_free(BamScanResult* r) {
  if (!r) return;
  free(r->flag); free(r->ref_id); free(r->pos); free(r->mapq);
  free(r->next_ref_id); free(r->next_pos);
  free(r->name_off); free(r->names);
  free(r->cig_off); free(r->cigs);
  free(r->seq_off); free(r->seqs);
  free(r->ref_name_off); free(r->ref_names); free(r->ref_len);
  free(r->header_text);
  free(r);
}

static BamScanResult* fail(BamScanResult* r, const char* msg) {
  r->error = msg;
  return r;
}

BamScanResult* bam_scan(const char* path, int n_threads) {
  auto* r = static_cast<BamScanResult*>(calloc(1, sizeof(BamScanResult)));
  FILE* fh = fopen(path, "rb");
  if (!fh) return fail(r, "open failed");
  fseek(fh, 0, SEEK_END);
  long fsize = ftell(fh);
  fseek(fh, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  size_t got = fread(buf.data(), 1, buf.size(), fh);
  fclose(fh);
  if (got != buf.size()) return fail(r, "short read");

  // --- enumerate BGZF blocks (gzip members with a BC extra subfield) ---
  std::vector<Block> blocks;
  size_t off = 0, out_total = 0;
  while (off + 28 <= buf.size()) {
    const uint8_t* p = buf.data() + off;
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4))
      return fail(r, "not BGZF");
    uint16_t xlen;
    std::memcpy(&xlen, p + 10, 2);
    size_t xoff = off + 12, xend = xoff + xlen;
    if (xend > buf.size()) return fail(r, "truncated extra field");
    uint32_t bsize = 0;
    bool found = false;
    while (xoff + 4 <= xend) {
      uint8_t s1 = buf[xoff], s2 = buf[xoff + 1];
      uint16_t slen;
      std::memcpy(&slen, buf.data() + xoff + 2, 2);
      if (s1 == 'B' && s2 == 'C' && slen == 2) {
        uint16_t bs;
        std::memcpy(&bs, buf.data() + xoff + 4, 2);
        bsize = static_cast<uint32_t>(bs) + 1;
        found = true;
      }
      xoff += 4 + slen;
    }
    if (!found || off + bsize > buf.size()) return fail(r, "bad BSIZE");
    size_t payload_off = off + 12 + xlen;
    size_t payload_len = bsize - 12 - xlen - 8;
    uint32_t isize;
    std::memcpy(&isize, buf.data() + off + bsize - 4, 4);
    if (isize) blocks.push_back({payload_off, payload_len, out_total, isize});
    out_total += isize;
    off += bsize;
    if (isize == 0 && off >= buf.size()) break;  // EOF marker
  }

  // --- parallel inflate ---
  std::vector<uint8_t> out(out_total);
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > static_cast<int>(blocks.size())) nt = static_cast<int>(blocks.size());
  std::vector<std::thread> ths;
  volatile bool ok = true;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      for (size_t b = t; b < blocks.size(); b += nt) {
        const Block& bl = blocks[b];
        if (!inflate_block(buf.data() + bl.comp_off, bl.comp_len,
                           out.data() + bl.out_off, bl.isize))
          ok = false;
      }
    });
  }
  for (auto& th : ths) th.join();
  if (!ok) return fail(r, "inflate failed");
  buf.clear();
  buf.shrink_to_fit();

  // --- parse header ---
  const uint8_t* d = out.data();
  size_t n = out.size(), o = 0;
  if (n < 12 || std::memcmp(d, "BAM\1", 4) != 0) return fail(r, "bad magic");
  int32_t l_text;
  std::memcpy(&l_text, d + 4, 4);
  o = 8;
  if (o + l_text + 4 > n) return fail(r, "truncated header");
  r->header_text = static_cast<char*>(malloc(l_text ? l_text : 1));
  std::memcpy(r->header_text, d + o, l_text);
  r->header_len = l_text;
  o += l_text;
  int32_t n_ref;
  std::memcpy(&n_ref, d + o, 4);
  o += 4;
  r->n_refs = n_ref;
  r->ref_name_off = static_cast<int64_t*>(malloc(sizeof(int64_t) * (n_ref + 1)));
  r->ref_len = static_cast<int64_t*>(malloc(sizeof(int64_t) * (n_ref ? n_ref : 1)));
  std::string rn;
  r->ref_name_off[0] = 0;
  for (int32_t i = 0; i < n_ref; ++i) {
    int32_t l_name;
    if (o + 4 > n) return fail(r, "truncated refs");
    std::memcpy(&l_name, d + o, 4);
    o += 4;
    if (o + l_name + 4 > n) return fail(r, "truncated refs");
    rn.append(reinterpret_cast<const char*>(d + o), l_name - 1);
    r->ref_name_off[i + 1] = static_cast<int64_t>(rn.size());
    o += l_name;
    int32_t l_ref;
    std::memcpy(&l_ref, d + o, 4);
    o += 4;
    r->ref_len[i] = l_ref;
  }
  r->ref_names = static_cast<char*>(malloc(rn.size() ? rn.size() : 1));
  std::memcpy(r->ref_names, rn.data(), rn.size());

  // --- first pass: count records + blob sizes ---
  size_t rec_start = o;
  int64_t nrec = 0, names_len = 0, cig_words = 0, seq_len = 0;
  while (o + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, d + o, 4);
    if (o + 4 + bs > n || bs < 32) break;
    const uint8_t* p = d + o + 4;
    uint8_t l_rn = p[8];
    uint16_t n_cig;
    std::memcpy(&n_cig, p + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, p + 16, 4);
    ++nrec;
    names_len += l_rn - 1;
    cig_words += n_cig;
    seq_len += l_seq;
    o += 4 + bs;
  }

  r->n_records = nrec;
  r->flag = static_cast<int32_t*>(malloc(sizeof(int32_t) * (nrec ? nrec : 1)));
  r->ref_id = static_cast<int32_t*>(malloc(sizeof(int32_t) * (nrec ? nrec : 1)));
  r->pos = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nrec ? nrec : 1)));
  r->mapq = static_cast<int32_t*>(malloc(sizeof(int32_t) * (nrec ? nrec : 1)));
  r->next_ref_id =
      static_cast<int32_t*>(malloc(sizeof(int32_t) * (nrec ? nrec : 1)));
  r->next_pos = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nrec ? nrec : 1)));
  r->name_off = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nrec + 1)));
  r->names = static_cast<char*>(malloc(names_len ? names_len : 1));
  r->cig_off = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nrec + 1)));
  r->cigs = static_cast<uint32_t*>(malloc(sizeof(uint32_t) * (cig_words ? cig_words : 1)));
  r->seq_off = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nrec + 1)));
  r->seqs = static_cast<char*>(malloc(seq_len ? seq_len : 1));
  r->name_off[0] = r->cig_off[0] = r->seq_off[0] = 0;

  // --- second pass: fill columns ---
  o = rec_start;
  int64_t i = 0, np_ = 0, cp = 0, sp = 0;
  while (o + 4 <= n && i < nrec) {
    uint32_t bs;
    std::memcpy(&bs, d + o, 4);
    if (o + 4 + bs > n || bs < 32) break;
    const uint8_t* p = d + o + 4;
    int32_t ref_id, posi, l_seq, nref, npos;
    std::memcpy(&ref_id, p, 4);
    std::memcpy(&posi, p + 4, 4);
    uint8_t l_rn = p[8];
    uint8_t mapq = p[9];
    uint16_t n_cig, flag;
    std::memcpy(&n_cig, p + 12, 2);
    std::memcpy(&flag, p + 14, 2);
    std::memcpy(&l_seq, p + 16, 4);
    std::memcpy(&nref, p + 20, 4);
    std::memcpy(&npos, p + 24, 4);
    r->flag[i] = flag;
    r->ref_id[i] = ref_id;
    r->pos[i] = posi;
    r->mapq[i] = mapq;
    r->next_ref_id[i] = nref;
    r->next_pos[i] = npos;
    const uint8_t* q = p + 32;
    std::memcpy(r->names + np_, q, l_rn - 1);
    np_ += l_rn - 1;
    r->name_off[i + 1] = np_;
    q += l_rn;
    std::memcpy(r->cigs + cp, q, 4ull * n_cig);
    cp += n_cig;
    r->cig_off[i + 1] = cp;
    q += 4ull * n_cig;
    const uint8_t* s4 = q;
    for (int32_t k = 0; k < l_seq; ++k) {
      uint8_t nib = (k & 1) ? (s4[k >> 1] & 0xF) : (s4[k >> 1] >> 4);
      r->seqs[sp + k] = SEQ_NT[nib];
    }
    sp += l_seq;
    r->seq_off[i + 1] = sp;
    ++i;
    o += 4 + bs;
  }
  r->n_records = i;
  return r;
}

}  // extern "C"
