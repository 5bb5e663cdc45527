// Native .frg fragment-store reconstruction (random access).
//
// The FRG store (reference: seq_db.rs:814-874, bincode-2 layout) keeps
// fragments in deflate-compressed groups of `chunk` entries; an "A"
// (AlnSegments) fragment delta-encodes its bases against an "I"
// (Internal) base fragment that may live in ANY group.  Reconstructing
// a sequence range in Python costs ~3 us per fragment (bincode parse +
// segment apply per call); these entry points do the whole
// decompress -> parse -> delta-apply -> reverse-complement pipeline in
// C++ with a per-call group cache.
//
// The port's copy of pgrtk_tpu/native/src/frg.cc: core/frag_io.py's
// FragFileStorage reads whole sequences, offsets and long sub-ranges
// through it, and raises where it fails (the JAX reader falls back to
// its Python path there).
//
// Varint encoding mirrors core/bincodec.py (bincode-2 compact ints):
// one byte < 0xFB inline, 0xFB +u16le, 0xFC +u32le, 0xFD +u64le.
//
// Hardening: every read is bounds-checked against the inflated group
// length (a VALID deflate stream can still carry a malicious bincode
// payload — huge counts, truncated fragments).  Counts are bounded by
// remaining bytes before any reserve/loop (each fragment/segment needs
// >= 1 byte), so crafted input fails with a clean -1/nullptr, never an
// allocation throw or OOB read across the extern-C boundary.
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// Fragment enum tags (seq_db.rs:31-100)
constexpr uint64_t FRAG_ALN = 0, FRAG_PREFIX = 1, FRAG_INTERNAL = 2,
                   FRAG_SUFFIX = 3;
constexpr uint64_t SEG_FULL = 0, SEG_MATCH = 1, SEG_INS = 2;

// Bounds-checked varint read.  Requires pos in [0, len) to read the tag
// byte; the 16 zero guard bytes appended after every inflated group keep
// the (at most 8-byte) payload memcpy inside owned memory even when the
// varint is truncated at end-of-buffer — the pos > len check after the
// advance then rejects it.  Returns false on malformed/truncated input.
inline bool read_varint_ck(const uint8_t *p, int64_t len, int64_t &pos,
                           uint64_t &out) {
  if (pos < 0 || pos >= len) return false;
  uint8_t b = p[pos++];
  if (b < 0xFB) {
    out = b;
    return true;
  }
  int w = (b == 0xFB) ? 2 : (b == 0xFC) ? 4 : 8;
  uint64_t v = 0;
  std::memcpy(&v, p + pos, (size_t)w);  // guard bytes make this safe
  pos += w;
  if (pos > len) return false;
  out = v;
  return true;
}

// advance past one fragment starting at pos; false on malformed input
inline bool skip_fragment(const uint8_t *p, int64_t len, int64_t &pos) {
  uint64_t tag;
  if (!read_varint_ck(p, len, pos, tag)) return false;
  if (tag == FRAG_ALN) {
    uint64_t tmp;
    if (!read_varint_ck(p, len, pos, tmp)) return false;  // base frag id
    pos += 1;                                             // reversed bool
    if (pos > len) return false;
    if (!read_varint_ck(p, len, pos, tmp)) return false;  // length
    uint64_t n;
    if (!read_varint_ck(p, len, pos, n)) return false;
    // each segment occupies >= 1 byte: bound the count by remaining bytes
    if (n > (uint64_t)(len - pos)) return false;
    for (uint64_t i = 0; i < n; ++i) {
      uint64_t st;
      if (!read_varint_ck(p, len, pos, st)) return false;
      if (st == SEG_MATCH) {
        if (!read_varint_ck(p, len, pos, tmp)) return false;
        if (!read_varint_ck(p, len, pos, tmp)) return false;
      } else if (st == SEG_INS) {
        pos += 1;
        if (pos > len) return false;
      } else if (st != SEG_FULL) {
        return false;
      }
    }
    return true;
  }
  if (tag == FRAG_PREFIX || tag == FRAG_INTERNAL || tag == FRAG_SUFFIX) {
    uint64_t n;
    if (!read_varint_ck(p, len, pos, n)) return false;
    if (n > (uint64_t)(len - pos)) return false;  // also blocks pos overflow
    pos += (int64_t)n;
    return true;
  }
  return false;
}

struct Group {
  std::vector<uint8_t> data;
  std::vector<int64_t> frag_off;  // offset of each fragment's tag byte
};

struct Ctx {
  const uint8_t *frg;
  int64_t frg_len;
  const int64_t *grp_off;
  const int64_t *grp_size;
  int64_t n_groups;
  int64_t chunk;
  std::unordered_map<int64_t, Group> cache;

  const Group *group(int64_t gid) {
    auto it = cache.find(gid);
    if (it != cache.end()) return &it->second;
    if (gid < 0 || gid >= n_groups) return nullptr;
    int64_t off = grp_off[gid], sz = grp_size[gid];
    // subtraction form: off+sz wraps int64 on crafted .sdx entries
    // (offset=1, size=2^63-1 passed the old sum check and let inflate
    // read past the frg buffer); also bound the uInt avail_in cast
    if (off < 0 || sz < 0 || off > frg_len || sz > frg_len - off ||
        sz > 0x7FFFFFFF)
      return nullptr;
    Group g;
    // raw deflate (zlib.decompress(raw, -15) on the Python side)
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return nullptr;
    g.data.resize((size_t)sz * 4 + 1024);
    zs.next_in = const_cast<uint8_t *>(frg + off);
    zs.avail_in = (uInt)sz;
    zs.next_out = g.data.data();
    zs.avail_out = (uInt)g.data.size();
    int rc;
    while ((rc = inflate(&zs, Z_NO_FLUSH)) == Z_OK) {
      if (zs.avail_out == 0) {
        size_t used = g.data.size();
        g.data.resize(g.data.size() * 2);
        zs.next_out = g.data.data() + used;
        zs.avail_out = (uInt)(g.data.size() - used);
      } else if (zs.avail_in == 0) {
        break;  // need more input: malformed
      }
    }
    bool ok = (rc == Z_STREAM_END);
    size_t total = zs.total_out;
    inflateEnd(&zs);
    if (!ok) return nullptr;
    // 16 zero guard bytes: read_varint_ck can touch up to 8 bytes past
    // its tag byte; the guard keeps that overread inside owned memory on
    // truncated input while the pos>len check rejects it
    g.data.resize(total + 16, 0);
    g.data.resize(total);
    // index fragment offsets (count-prefixed list)
    const uint8_t *p = g.data.data();
    int64_t dlen = (int64_t)g.data.size();
    int64_t pos = 0;
    uint64_t n;
    if (!read_varint_ck(p, dlen, pos, n)) return nullptr;
    // each fragment occupies >= 1 byte: a count beyond the remaining
    // bytes is crafted input — reject BEFORE reserve (a huge n would
    // throw std::length_error across the extern-C boundary)
    if (n > (uint64_t)(dlen - pos)) return nullptr;
    g.frag_off.reserve((size_t)n);
    for (uint64_t i = 0; i < n; ++i) {
      g.frag_off.push_back(pos);
      if (!skip_fragment(p, dlen, pos)) return nullptr;
    }
    auto ins = cache.emplace(gid, std::move(g));
    return &ins.first->second;
  }

  // locate fragment fid: group data pointer + tag-byte offset
  bool locate(int64_t fid, const uint8_t *&p, int64_t &pos, int64_t &dlen) {
    if (fid < 0 || chunk <= 0) return false;
    const Group *g = group(fid / chunk);
    if (g == nullptr) return false;
    int64_t j = fid % chunk;
    if (j >= (int64_t)g->frag_off.size()) return false;
    p = g->data.data();
    dlen = (int64_t)g->data.size();
    pos = g->frag_off[(size_t)j];
    return true;
  }
};

// complement table: ACGTacgtNn -> TGCAtgcaNn, others pass through
// (mirrors core/fasta.py COMPLEMENT / fasta_io.rs:26-44)
struct CompTable {
  uint8_t t[256];
  CompTable() {
    for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
    const char *a = "ACGTacgtNn", *b = "TGCAtgcaNn";
    for (int i = 0; a[i]; ++i) t[(uint8_t)a[i]] = (uint8_t)b[i];
  }
};
const CompTable kComp;

// materialize one fragment's stored bases into out (cap-checked).
// Returns stored length, or -1 on error / overflow.
int64_t materialize(Ctx &ctx, int64_t fid, uint8_t *out, int64_t cap) {
  const uint8_t *p;
  int64_t pos, dlen;
  if (!ctx.locate(fid, p, pos, dlen)) return -1;
  uint64_t tag;
  if (!read_varint_ck(p, dlen, pos, tag)) return -1;
  if (tag != FRAG_ALN) {
    uint64_t n;
    if (!read_varint_ck(p, dlen, pos, n)) return -1;
    if (n > (uint64_t)cap || n > (uint64_t)(dlen - pos)) return -1;
    std::memcpy(out, p + pos, n);
    return (int64_t)n;
  }
  uint64_t base_id;
  if (!read_varint_ck(p, dlen, pos, base_id)) return -1;
  if (pos >= dlen) return -1;
  uint8_t reversed = p[pos++];
  uint64_t length;
  if (!read_varint_ck(p, dlen, pos, length)) return -1;
  if (length > (uint64_t)cap) return -1;
  // base fragment must be Internal; fetch its payload pointer
  const uint8_t *bp;
  int64_t bpos, bdlen;
  if (!ctx.locate((int64_t)base_id, bp, bpos, bdlen)) return -1;
  uint64_t btag;
  if (!read_varint_ck(bp, bdlen, bpos, btag) || btag != FRAG_INTERNAL)
    return -1;
  uint64_t blen;
  if (!read_varint_ck(bp, bdlen, bpos, blen)) return -1;
  if (blen > (uint64_t)(bdlen - bpos)) return -1;
  const uint8_t *base = bp + bpos;

  uint64_t n;
  if (!read_varint_ck(p, dlen, pos, n)) return -1;
  if (n > (uint64_t)(dlen - pos)) return -1;  // each segment >= 1 byte
  int64_t w = 0;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t st;
    if (!read_varint_ck(p, dlen, pos, st)) return -1;
    if (st == SEG_FULL) {
      if (w + (int64_t)blen > (int64_t)length) return -1;
      std::memcpy(out + w, base, blen);
      w += (int64_t)blen;
    } else if (st == SEG_MATCH) {
      uint64_t x1, x2;
      if (!read_varint_ck(p, dlen, pos, x1)) return -1;
      if (!read_varint_ck(p, dlen, pos, x2)) return -1;
      if (x2 < x1 || x2 > blen) return -1;
      if (w + (int64_t)(x2 - x1) > (int64_t)length) return -1;
      std::memcpy(out + w, base + x1, x2 - x1);
      w += (int64_t)(x2 - x1);
    } else if (st == SEG_INS) {
      if (w + 1 > (int64_t)length || pos >= dlen) return -1;
      out[w++] = p[pos++];
    } else {
      return -1;
    }
  }
  if (w != (int64_t)length) return -1;
  if (reversed) {
    for (int64_t i = 0, j = w - 1; i < j; ++i, --j) {
      uint8_t a = kComp.t[out[i]], b = kComp.t[out[j]];
      out[i] = b;
      out[j] = a;
    }
    if (w & 1) out[w / 2] = kComp.t[out[w / 2]];
  }
  return w;
}

// stored (materialized) length of a fragment, from its header alone.
// Returns -1 on malformed input (also rejects lengths beyond the i64
// positive range so callers can treat the result as a byte count).
int64_t stored_len(Ctx &ctx, int64_t fid, uint64_t &tag_out) {
  const uint8_t *p;
  int64_t pos, dlen;
  if (!ctx.locate(fid, p, pos, dlen)) return -1;
  uint64_t tag, v;
  if (!read_varint_ck(p, dlen, pos, tag)) return -1;
  tag_out = tag;
  if (tag == FRAG_ALN) {
    if (!read_varint_ck(p, dlen, pos, v)) return -1;
    pos += 1;
    if (pos > dlen) return -1;
    if (!read_varint_ck(p, dlen, pos, v)) return -1;
  } else {
    if (!read_varint_ck(p, dlen, pos, v)) return -1;
  }
  if (v > (uint64_t)INT64_MAX) return -1;
  return (int64_t)v;
}

}  // namespace

extern "C" {

// Per-fragment CONTRIBUTED lengths (A/I strip the k-base overlap;
// P/S full) for frag ids [fid_bgn, fid_end) — header parse only, no
// group decompression of delta bases.  Returns 0 ok, -1 error.
int64_t pgr_frg_base_lens(const uint8_t *frg, int64_t frg_len,
                          const int64_t *grp_off, const int64_t *grp_size,
                          int64_t n_groups, int64_t chunk, int64_t k,
                          int64_t fid_bgn, int64_t fid_end,
                          int64_t *out_lens) {
  Ctx ctx{frg, frg_len, grp_off, grp_size, n_groups, chunk, {}};
  for (int64_t fid = fid_bgn; fid < fid_end; ++fid) {
    uint64_t tag;
    int64_t n = stored_len(ctx, fid, tag);
    if (n < 0) return -1;
    out_lens[fid - fid_bgn] =
        n - ((tag == FRAG_ALN || tag == FRAG_INTERNAL) ? k : 0);
  }
  return 0;
}

// Concatenated CONTRIBUTED bases of frag ids [fid_bgn, fid_end) (the
// Python _frag_bases join).  Returns bytes written, or -1 on error /
// out_cap overflow.
int64_t pgr_frg_sub_bases(const uint8_t *frg, int64_t frg_len,
                          const int64_t *grp_off, const int64_t *grp_size,
                          int64_t n_groups, int64_t chunk, int64_t k,
                          int64_t fid_bgn, int64_t fid_end, uint8_t *out,
                          int64_t out_cap) {
  Ctx ctx{frg, frg_len, grp_off, grp_size, n_groups, chunk, {}};
  std::vector<uint8_t> tmp;
  int64_t w = 0;
  for (int64_t fid = fid_bgn; fid < fid_end; ++fid) {
    uint64_t tag;
    int64_t need = stored_len(ctx, fid, tag);
    if (need < 0) return -1;
    int64_t strip = (tag == FRAG_ALN || tag == FRAG_INTERNAL) ? k : 0;
    if ((int64_t)tmp.size() < need) tmp.resize((size_t)need);
    int64_t got = materialize(ctx, fid, tmp.data(), need);
    if (got != need || got < strip) return -1;
    if (w + (got - strip) > out_cap) return -1;
    std::memcpy(out + w, tmp.data() + strip, (size_t)(got - strip));
    w += got - strip;
  }
  return w;
}

}  // extern "C"
