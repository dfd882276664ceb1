// The port's PNG decoder, self-contained: it includes no PNG or zlib
// header and links no library, so it builds wherever g++ runs. The same C
// interface and arithmetic as section 1 of the JAX package's native runtime
// (nerf_tpu/runtime/runtime.cpp), so one file decodes to the same floats bit
// for bit.
//
// Each PNG is decoded to RGBA8: chunks framed and CRC-checked, the IDAT
// stream inflated (RFC 1950 / 1951, written out below), unfiltered, Adam7
// de-interlaced, and expanded as that runtime asks its decoder to: 16-bit
// samples keep their high byte, grey at 1/2/4 bits is scaled to 8, a palette
// becomes RGB with alpha from tRNS, a tRNS key on grey or RGB (compared at
// the file's own depth) gives alpha 0, grey becomes RGB, and a missing alpha
// is 0xFF. No gamma is applied; ancillary chunks are skipped. Then each image
// is resized bilinearly to the requested size and, where asked, composited
// onto a white background (rgb * a + (1 - a)); the images are shared among
// threads. A file that breaks the format (a bad CRC on a critical chunk, an
// unknown critical chunk, an invalid deflate stream or Adler-32, a filter
// byte above 4, a size of 0 or above 1,000,000, a truncation, more or less
// image data than the header implies) fails; nothing is guessed.
//
// A library of its own (libnerf_png), beside the ray producer (runtime.cpp).
// A plain C ABI bound with ctypes (nerf_tpu_torch/runtime/__init__.py),
// built there with g++ -O3 -fPIC -std=c++17 -pthread -shared -ffp-contract=off.
// Nothing static is mutable: the images are decoded on several threads.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMaxSide = 1000000;   // the largest width or height accepted

// ---- checksums ----------------------------------------------------------

struct CrcTable {
  uint32_t v[256];
  constexpr CrcTable() : v() {
    for (uint32_t n = 0; n < 256; n++) {
      uint32_t c = n;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      v[n] = c;
    }
  }
};
constexpr CrcTable kCrc;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = kCrc.v[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;        // the most sums that fit 32 bits
    n -= k;
    while (k--) { a += *p++; b += a; }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

uint32_t be16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }

// ---- inflate (RFC 1950 zlib wrapper around RFC 1951 deflate) -------------

// Bits of the stream, least significant first. Past the end it shifts in
// zero bytes; ok() tells whether any bit taken so far was one of them.
class Bits {
 public:
  Bits(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  void fill() {
    while (cnt_ <= 56) {
      buf_ |= uint64_t(pos_ < n_ ? p_[pos_] : 0) << cnt_;
      pos_++;
      cnt_ += 8;
    }
  }
  uint32_t peek(int k) const { return uint32_t(buf_ & ((uint64_t(1) << k) - 1)); }
  void drop(int k) { buf_ >>= k; cnt_ -= k; }
  uint32_t take(int k) {
    if (cnt_ < k) fill();
    uint32_t v = peek(k);
    drop(k);
    return v;
  }
  bool ok() const { return consumed() <= 8 * uint64_t(n_); }
  // to the next byte boundary; returns the offset of that byte
  size_t align() {
    drop(cnt_ & 7);
    return size_t(consumed() / 8);
  }
  // restart at byte `pos` (after align and a stored block's copy)
  void seek(size_t pos) { pos_ = pos; buf_ = 0; cnt_ = 0; }
  const uint8_t* data() const { return p_; }
  size_t size() const { return n_; }

 private:
  uint64_t consumed() const { return 8 * uint64_t(pos_) - cnt_; }
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  uint64_t buf_ = 0;
  int cnt_ = 0;
};

constexpr int kFast = 10;          // codes up to this long decode by one lookup

// A canonical Huffman code: a lookup of the next kFast bits for the short
// codes, and the count / symbol lists that decode every code bit by bit.
struct Huffman {
  uint16_t fast[1 << kFast];       // (length << 9) | symbol; 0: longer, or no code
  uint16_t count[16];              // codes of each length
  uint16_t symbol[288];            // symbols in canonical order
};

enum class CodeKind { kCodeLengths, kLiterals, kDistances };

// Builds the code of lens[0..n). An over-subscribed set fails. So does an
// incomplete one, except a single code of one bit for literals or distances,
// and no code at all for distances (a block without matches); the missing
// codes then fail where they are read.
bool build(Huffman* h, const uint8_t* lens, int n, CodeKind kind) {
  memset(h->fast, 0, sizeof h->fast);
  memset(h->count, 0, sizeof h->count);
  for (int i = 0; i < n; i++) h->count[lens[i]]++;
  h->count[0] = 0;
  int max = 0;
  for (int len = 15; len >= 1 && !max; len--)
    if (h->count[len]) max = len;
  int left = 1;
  for (int len = 1; len <= 15; len++) {
    left = (left << 1) - h->count[len];
    if (left < 0) return false;
  }
  if (max == 0) return kind == CodeKind::kDistances;
  if (left > 0 && (kind == CodeKind::kCodeLengths || max != 1)) return false;
  uint16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + h->count[len];
  for (int i = 0; i < n; i++)
    if (lens[i]) h->symbol[offs[lens[i]]++] = uint16_t(i);
  uint32_t code = 0;
  int index = 0;
  for (int len = 1; len <= kFast; len++) {
    for (int k = 0; k < h->count[len]; k++, code++, index++) {
      uint32_t rev = 0;
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (uint32_t r = rev; r < (1u << kFast); r += 1u << len)
        h->fast[r] = uint16_t(len << 9 | h->symbol[index]);
    }
    code <<= 1;
  }
  return true;
}

// The next symbol, or -1 where the bits are no code.
int decode(Bits* b, const Huffman& h) {
  b->fill();
  uint32_t e = h.fast[b->peek(kFast)];
  if (e) {
    b->drop(int(e >> 9));
    return int(e & 511);
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 15; len++) {
    code |= int(b->take(1));
    int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -1;
}

constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                   31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385,
                                    24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t kCodeLengthOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                          11, 4,  12, 3, 13, 2, 14, 1, 15};

// Inflates one zlib stream into out[0..n), which it must fill exactly.
class Inflater {
 public:
  Inflater(Bits* bits, uint8_t* out, size_t n, size_t window)
      : b_(bits), out_(out), n_(n), window_(window) {}

  bool run() {
    for (;;) {
      int final_block = int(b_->take(1));
      int type = int(b_->take(2));
      bool ok = type == 0 ? stored() : type == 1 ? fixed() : type == 2 ? dynamic() : false;
      if (!ok || !b_->ok()) return false;
      if (final_block) return o_ == n_;
    }
  }

 private:
  bool stored() {
    size_t at = b_->align();
    if (at + 4 > b_->size()) return false;
    const uint8_t* p = b_->data() + at;
    uint32_t len = p[0] | uint32_t(p[1]) << 8, nlen = p[2] | uint32_t(p[3]) << 8;
    if (len != (~nlen & 0xFFFF) || at + 4 + len > b_->size() || len > n_ - o_) return false;
    memcpy(out_ + o_, p + 4, len);
    o_ += len;
    b_->seek(at + 4 + len);
    return true;
  }

  bool fixed() {
    uint8_t lens[288 + 32];
    for (int i = 0; i < 288; i++) lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    for (int i = 0; i < 32; i++) lens[288 + i] = 5;
    return build(&lit_, lens, 288, CodeKind::kLiterals) &&
           build(&dist_, lens + 288, 32, CodeKind::kDistances) && codes();
  }

  bool dynamic() {
    int nlen = int(b_->take(5)) + 257, ndist = int(b_->take(5)) + 1;
    int ncode = int(b_->take(4)) + 4;
    if (nlen > 286 || ndist > 30) return false;
    uint8_t lens[286 + 30] = {0};
    for (int i = 0; i < ncode; i++) lens[kCodeLengthOrder[i]] = uint8_t(b_->take(3));
    if (!build(&lit_, lens, 19, CodeKind::kCodeLengths)) return false;
    memset(lens, 0, sizeof lens);
    for (int i = 0; i < nlen + ndist;) {
      int sym = decode(b_, lit_);
      if (sym < 0 || !b_->ok()) return false;
      if (sym < 16) {
        lens[i++] = uint8_t(sym);
        continue;
      }
      int rep;
      uint8_t val = 0;
      if (sym == 16) {
        if (i == 0) return false;
        val = lens[i - 1];
        rep = 3 + int(b_->take(2));
      } else {
        rep = sym == 17 ? 3 + int(b_->take(3)) : 11 + int(b_->take(7));
      }
      if (i + rep > nlen + ndist) return false;
      while (rep--) lens[i++] = val;
    }
    if (lens[256] == 0) return false;           // no end-of-block code
    return build(&lit_, lens, nlen, CodeKind::kLiterals) &&
           build(&dist_, lens + nlen, ndist, CodeKind::kDistances) && codes();
  }

  // The symbols of a Huffman-coded block, to its end-of-block code.
  bool codes() {
    for (;;) {
      int sym = decode(b_, lit_);
      if (sym < 256) {
        if (sym < 0 || o_ == n_) return false;
        out_[o_++] = uint8_t(sym);
      } else if (sym == 256) {
        return true;
      } else {
        sym -= 257;
        if (sym >= 29) return false;             // 286, 287
        size_t len = kLenBase[sym] + b_->take(kLenExtra[sym]);
        int ds = decode(b_, dist_);
        if (ds < 0 || ds >= 30) return false;     // no code, or 30, 31
        size_t d = kDistBase[ds] + b_->take(kDistExtra[ds]);
        if (d > o_ || d > window_ || len > n_ - o_) return false;
        uint8_t* q = out_ + o_;
        const uint8_t* from = q - d;            // may overlap q: byte by byte
        for (size_t k = 0; k < len; k++) q[k] = from[k];
        o_ += len;
      }
      if (!b_->ok()) return false;
    }
  }

  Bits* b_;
  uint8_t* out_;
  size_t n_;
  size_t o_ = 0;
  size_t window_;
  Huffman lit_, dist_;
};

// The zlib stream in[0..n) inflated into out[0..expected), Adler-32 checked.
bool inflate_zlib(const uint8_t* in, size_t n, uint8_t* out, size_t expected) {
  if (n < 2) return false;
  uint32_t cmf = in[0], flg = in[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 || (flg & 0x20))
    return false;                               // method, window, check bits, no dictionary
  Bits bits(in + 2, n - 2);
  Inflater inf(&bits, out, expected, size_t(1) << ((cmf >> 4) + 8));
  if (!inf.run()) return false;
  size_t at = 2 + bits.align();
  return at + 4 <= n && be32(in + at) == adler32(out, expected);
}

// ---- PNG ----------------------------------------------------------------

struct Image {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0, channels = 0;
  uint8_t palette[256 * 3] = {0};              // entries past the PLTE's are black
  int n_palette = 0;
  uint8_t trns_alpha[256];
  int n_trns = 0;                               // palette alphas from tRNS
  bool has_key = false;                         // a tRNS key on grey or RGB
  uint32_t key[3] = {0, 0, 0};
};

int channels_of(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

uint32_t sample(const uint8_t* row, size_t i, int depth) {
  switch (depth) {
    case 8: return row[i];
    case 16: return be16(row + 2 * i);
    default: {
      size_t bit = i * depth;
      return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
    }
  }
}

// n unfiltered pixels of `row` to RGBA8 at dst, dst + step, ...
void expand_row(const Image& im, const uint8_t* row, uint32_t n, uint8_t* dst, size_t step) {
  const int d = im.depth;
  auto to8 = [d](uint32_t v) -> uint8_t {
    return uint8_t(d == 16 ? v >> 8 : d == 8 ? v : v * (255u / ((1u << d) - 1)));
  };
  for (uint32_t i = 0; i < n; i++, dst += step) {
    switch (im.color) {
      case 0: {
        uint32_t v = sample(row, i, d);
        dst[0] = dst[1] = dst[2] = to8(v);
        dst[3] = im.has_key && v == im.key[0] ? 0 : 255;
        break;
      }
      case 2: {
        uint32_t r = sample(row, 3 * size_t(i), d), g = sample(row, 3 * size_t(i) + 1, d),
                 b = sample(row, 3 * size_t(i) + 2, d);
        dst[0] = to8(r);
        dst[1] = to8(g);
        dst[2] = to8(b);
        dst[3] = im.has_key && r == im.key[0] && g == im.key[1] && b == im.key[2] ? 0 : 255;
        break;
      }
      case 3: {
        uint32_t k = sample(row, i, d);
        memcpy(dst, im.palette + 3 * k, 3);
        dst[3] = int(k) < im.n_trns ? im.trns_alpha[k] : 255;
        break;
      }
      case 4:
        dst[0] = dst[1] = dst[2] = to8(sample(row, 2 * size_t(i), d));
        dst[3] = to8(sample(row, 2 * size_t(i) + 1, d));
        break;
      default:
        for (int c = 0; c < 4; c++) dst[c] = to8(sample(row, 4 * size_t(i) + c, d));
    }
  }
}

// Undoes one row's filter in place; prev is the pass's previous row, or null.
bool unfilter(uint8_t* row, const uint8_t* prev, size_t n, size_t bpp, int type) {
  switch (type) {
    case 0: return true;
    case 1:
      for (size_t i = bpp; i < n; i++) row[i] = uint8_t(row[i] + row[i - bpp]);
      return true;
    case 2:
      if (prev)
        for (size_t i = 0; i < n; i++) row[i] = uint8_t(row[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; i++) {
        uint32_t a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
        row[i] = uint8_t(row[i] + ((a + b) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; i++) {
        int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0,
            c = i >= bpp && prev ? prev[i - bpp] : 0;
        int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
            pc = p > c ? p - c : c - p;
        row[i] = uint8_t(row[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c));
      }
      return true;
    default:
      return false;
  }
}

struct Pass { uint32_t x0, y0, dx, dy; };
constexpr Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                            {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
constexpr Pass kWhole = {0, 0, 1, 1};

// Chunks of the file: the header, palette and tRNS, and the IDAT stream.
// Returns false on a broken file.
bool read_chunks(const std::vector<uint8_t>& f, Image* im, std::vector<uint8_t>* idat) {
  static constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (f.size() < 8 || memcmp(f.data(), kSignature, 8) != 0) return false;
  size_t pos = 8;
  bool have_header = false, have_palette = false, have_trns = false;
  int idat_state = 0;                             // 0: none yet, 1: in the run, 2: after it
  for (;;) {
    if (f.size() - pos < 12) return false;        // truncated, or no IEND
    const uint8_t* c = f.data() + pos;
    uint32_t len = be32(c);
    if (len > 0x7FFFFFFFu || f.size() - pos - 12 < len) return false;
    for (int k = 4; k < 8; k++)
      if (!((c[k] >= 'A' && c[k] <= 'Z') || (c[k] >= 'a' && c[k] <= 'z'))) return false;
    const uint8_t* d = c + 8;
    const bool crc_ok = crc32(c + 4, size_t(len) + 4) == be32(d + len);
    const bool critical = !(c[4] & 0x20);
    auto is = [c](const char* t) { return memcmp(c + 4, t, 4) == 0; };
    pos += 12 + size_t(len);
    if (!have_header && !is("IHDR")) return false;
    if (critical && !crc_ok) return false;
    if (is("IDAT")) {
      if (idat_state == 2) return false;          // IDATs are one run
      if (idat_state == 0 && im->color == 3 && !have_palette) return false;
      idat_state = 1;
      idat->insert(idat->end(), d, d + len);
      continue;
    }
    if (idat_state == 1) idat_state = 2;
    if (is("IEND")) break;
    if (is("IHDR")) {
      if (have_header || len != 13) return false;
      im->w = be32(d);
      im->h = be32(d + 4);
      im->depth = d[8];
      im->color = d[9];
      im->interlace = d[12];
      if (im->w == 0 || im->h == 0 || im->w > kMaxSide || im->h > kMaxSide ||
          !valid_depth(im->color, im->depth) || d[10] != 0 || d[11] != 0 || d[12] > 1)
        return false;
      im->channels = channels_of(im->color);
      have_header = true;
    } else if (is("PLTE")) {
      if (have_palette || idat_state) return false;
      if (im->color == 0 || im->color == 4) continue;     // ignored in grey images
      if (len == 0 || len % 3 || len > 768) {
        if (im->color == 3) return false;
        continue;                                  // a suggested palette, unused
      }
      int n = int(len / 3);
      if (im->color == 3 && n > (1 << im->depth)) n = 1 << im->depth;
      memcpy(im->palette, d, size_t(n) * 3);
      im->n_palette = n;
      have_palette = true;
    } else if (is("tRNS")) {
      // an invalid tRNS is dropped, and the image read without it
      if (!crc_ok || have_trns || idat_state) continue;
      if (im->color == 3) {
        if (!have_palette || len == 0 || int(len) > im->n_palette) continue;
        memcpy(im->trns_alpha, d, len);
        im->n_trns = int(len);
      } else if (im->color == 0 || im->color == 2) {
        if (len != (im->color == 0 ? 2u : 6u)) continue;
        uint32_t mask = im->depth == 16 ? 0xFFFF : (1u << im->depth) - 1;
        for (uint32_t k = 0; k < len / 2; k++) im->key[k] = be16(d + 2 * k) & mask;
        im->has_key = true;
      } else {
        continue;                                  // the image has its own alpha
      }
      have_trns = true;
    } else if (critical) {
      return false;                                // an unknown critical chunk
    }
  }
  return have_header && idat_state != 0;
}

// Decodes one PNG to RGBA8. Returns 0 on success.
int decode_png_rgba(const char* path, std::vector<uint8_t>* out, uint32_t* w, uint32_t* h) {
  std::vector<uint8_t> file;
  {
    FILE* fp = fopen(path, "rb");
    if (!fp) return 1;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof buf, fp)) > 0) file.insert(file.end(), buf, buf + got);
    bool failed = ferror(fp) != 0;
    fclose(fp);
    if (failed) return 1;
  }
  Image im;
  std::vector<uint8_t> idat;
  if (!read_chunks(file, &im, &idat)) return 2;
  file.clear();
  file.shrink_to_fit();

  const Pass* passes = im.interlace ? kAdam7 : &kWhole;
  const int n_passes = im.interlace ? 7 : 1;
  const uint64_t bits_pp = uint64_t(im.channels) * im.depth;
  const size_t bpp = bits_pp >= 8 ? size_t(bits_pp / 8) : 1;
  uint64_t expected = 0;
  for (int p = 0; p < n_passes; p++) {
    const Pass& s = passes[p];
    uint64_t pw = im.w > s.x0 ? (im.w - s.x0 + s.dx - 1) / s.dx : 0;
    uint64_t ph = im.h > s.y0 ? (im.h - s.y0 + s.dy - 1) / s.dy : 0;
    if (pw && ph) expected += ph * (1 + (pw * bits_pp + 7) / 8);
  }
  // deflate yields at most 258 bytes for two bits: more image than that
  // could ever come from the stream is a truncated file, refused before
  // anything of its size is allocated
  if (expected > 1032 * uint64_t(idat.size()) + 1032) return 3;
  try {
    std::vector<uint8_t> raw(expected);
    if (!inflate_zlib(idat.data(), idat.size(), raw.data(), raw.size())) return 4;
    idat.clear();
    idat.shrink_to_fit();
    out->assign(size_t(im.w) * im.h * 4, 0);
    uint8_t* q = raw.data();
    for (int p = 0; p < n_passes; p++) {
      const Pass& s = passes[p];
      uint32_t pw = im.w > s.x0 ? (im.w - s.x0 + s.dx - 1) / s.dx : 0;
      uint32_t ph = im.h > s.y0 ? (im.h - s.y0 + s.dy - 1) / s.dy : 0;
      if (!pw || !ph) continue;                   // an empty pass has no filter bytes
      const size_t rowbytes = size_t((pw * bits_pp + 7) / 8);
      const uint8_t* prev = nullptr;
      for (uint32_t r = 0; r < ph; r++, q += 1 + rowbytes) {
        if (!unfilter(q + 1, prev, rowbytes, bpp, q[0])) return 5;
        uint8_t* dst = out->data() + ((size_t(s.y0) + size_t(r) * s.dy) * im.w + s.x0) * 4;
        expand_row(im, q + 1, pw, dst, size_t(s.dx) * 4);
        prev = q + 1;
      }
    }
  } catch (const std::bad_alloc&) {
    return 6;
  }
  *w = im.w;
  *h = im.h;
  return 0;
}

// Bilinear resize RGBA8 [sh, sw] -> float RGB [dh, dw] with white-background
// compositing (rgb * a + (1 - a)) when white_bkgd. At the source's own size
// every weight is 0, so a pixel is its bytes / 255 (then composited).
void resize_composite(const uint8_t* src, uint32_t sw, uint32_t sh,
                      float* dst, uint32_t dw, uint32_t dh,
                      int white_bkgd) {
  const float sx = dw > 1 ? float(sw - 1) / float(dw - 1) : 0.f;
  const float sy = dh > 1 ? float(sh - 1) / float(dh - 1) : 0.f;
  for (uint32_t y = 0; y < dh; y++) {
    float fy = y * sy;
    uint32_t y0 = (uint32_t)fy;
    uint32_t y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (uint32_t x = 0; x < dw; x++) {
      float fx = x * sx;
      uint32_t x0 = (uint32_t)fx;
      uint32_t x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      float px[4];
      for (int c = 0; c < 4; c++) {
        float v00 = src[(size_t(y0) * sw + x0) * 4 + c];
        float v01 = src[(size_t(y0) * sw + x1) * 4 + c];
        float v10 = src[(size_t(y1) * sw + x0) * 4 + c];
        float v11 = src[(size_t(y1) * sw + x1) * 4 + c];
        px[c] = ((v00 * (1 - wx) + v01 * wx) * (1 - wy) +
                 (v10 * (1 - wx) + v11 * wx) * wy) / 255.f;
      }
      float a = px[3];
      float* o = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; c++)
        o[c] = white_bkgd ? px[c] * a + (1.f - a) : px[c];
    }
  }
}

}  // namespace

extern "C" {

// Decode n PNGs (newline-joined paths) into out [n, dh, dw, 3] float32.
// Threaded across images (n_threads <= 0: one per hardware thread). Returns
// the number of failures; a failed image's slot is left as it was.
int nerf_decode_png_batch(const char* joined_paths, int n_paths,
                          float* out, uint32_t dw, uint32_t dh,
                          int white_bkgd, int n_threads) {
  std::vector<std::string> paths;
  {
    const char* p = joined_paths;
    for (int i = 0; i < n_paths; i++) {
      const char* e = strchr(p, '\n');
      if (!e) e = p + strlen(p);
      paths.emplace_back(p, e - p);
      p = (*e ? e + 1 : e);
    }
  }
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_paths) return;
      std::vector<uint8_t> rgba;
      uint32_t w = 0, h = 0;
      if (decode_png_rgba(paths[i].c_str(), &rgba, &w, &h) != 0) {
        failures.fetch_add(1);
        continue;
      }
      resize_composite(rgba.data(), w, h,
                       out + size_t(i) * dw * dh * 3, dw, dh, white_bkgd);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return failures.load();
}

}  // extern "C"
