// Native OpenEXR scanline codec, the port's copy of the JAX package's
// hdrvae/io/native/exr_codec.cpp: below this header the two files are the
// same, so both packages write the same bytes.
//
// A self-contained implementation of the scanline format: RGB images,
// HALF/FLOAT pixels, NONE/RLE/ZIPS/ZIP/PIZ/PXR24 compression.
// Mirrors hdrvae_torch/io/exr.py's numpy codec byte-for-byte (tests assert
// file equality); PIZ is written here only.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread exr_codec.cpp -lz
// (hdrvae_torch/io/native_build.py); bound from Python via ctypes
// (hdrvae_torch/io/exr.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x01312F76;
constexpr int kVersion = 2;

enum Compression { NONE = 0, RLE = 1, ZIPS = 2, ZIP = 3, PIZ = 4, PXR24 = 5 };
enum PixelType { UINT = 0, HALF = 1, FLOAT = 2 };

int lines_per_chunk(int comp) {
  switch (comp) {
    case ZIP: case PXR24: return 16;
    case PIZ: return 32;
    default: return 1;
  }
}

int pixel_size(int ptype) { return ptype == HALF ? 2 : 4; }

// ---------------------------------------------------------------------------
// half <-> float (round-to-nearest-even, matching numpy astype(float16))
// ---------------------------------------------------------------------------

uint16_t float_to_half(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (((x >> 23) & 0xFF) == 0xFF) {  // inf / nan
    if (!mant) return static_cast<uint16_t>(sign | 0x7C00u);
    // NaN: truncate the payload like numpy's float->half cast (the
    // byte-identity contract with the exr_py writer, which uses
    // astype('<f2')); only force a bit when truncation would turn the
    // NaN into an inf
    uint32_t h = 0x7C00u | (mant >> 13);
    if (h == 0x7C00u) h |= 1u;
    return static_cast<uint16_t>(sign | h);
  }
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // overflow
  if (exp <= 0) {  // subnormal or zero
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t val = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (val & 1))) val++;
    return static_cast<uint16_t>(sign | val);
  }
  uint32_t val = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (val & 1))) val++;  // may carry
  return static_cast<uint16_t>(sign | val);
}

float half_to_float(uint16_t h) {
  uint32_t sign = (static_cast<uint32_t>(h) & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int e = -1;
      uint32_t m = mant;
      do { m <<= 1; e++; } while (!(m & 0x400u));
      bits = sign | ((127 - 15 - e) << 23) | ((m & 0x3FFu) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// ---------------------------------------------------------------------------
// ZIP/RLE pre-filter: reorder into two halves, then delta predictor
// ---------------------------------------------------------------------------

void filter_encode(const uint8_t* src, size_t n, uint8_t* dst) {
  size_t half = (n + 1) / 2;
  for (size_t i = 0, j = 0; i < n; i += 2, ++j) dst[j] = src[i];
  for (size_t i = 1, j = half; i < n; i += 2, ++j) dst[j] = src[i];
  int prev = dst[0];
  for (size_t i = 1; i < n; ++i) {
    int cur = dst[i];
    dst[i] = static_cast<uint8_t>(cur - prev + (128 + 256));
    prev = cur;
  }
}

void filter_decode(uint8_t* buf, size_t n, uint8_t* out) {
  // undo predictor in place
  for (size_t i = 1; i < n; ++i)
    buf[i] = static_cast<uint8_t>(buf[i] + buf[i - 1] - 128 - 256);
  size_t half = (n + 1) / 2;
  for (size_t i = 0, j = 0; i < n; i += 2, ++j) out[i] = buf[j];
  for (size_t i = 1, j = half; i < n; i += 2, ++j) out[i] = buf[j];
}

// ---------------------------------------------------------------------------
// RLE (OpenEXR flavor)
// ---------------------------------------------------------------------------

constexpr int kMinRun = 3, kMaxRun = 127;

size_t rle_encode(const uint8_t* d, size_t n, uint8_t* out) {
  size_t o = 0, i = 0;
  while (i < n) {
    size_t run = 1;
    while (i + run < n && d[i + run] == d[i] &&
           run < static_cast<size_t>(kMaxRun))
      run++;
    if (run >= kMinRun) {
      out[o++] = static_cast<uint8_t>(run - 1);
      out[o++] = d[i];
      i += run;
    } else {
      size_t start = i;
      i++;
      while (i < n && (i - start) < static_cast<size_t>(kMaxRun) &&
             !(i + 2 < n && d[i] == d[i + 1] && d[i + 1] == d[i + 2]))
        i++;
      size_t count = i - start;
      out[o++] = static_cast<uint8_t>(256 - count);
      std::memcpy(out + o, d + start, count);
      o += count;
    }
  }
  return o;
}

size_t rle_decode(const uint8_t* d, size_t n, uint8_t* out, size_t cap) {
  size_t o = 0, i = 0;
  while (i < n && o < cap) {
    int8_t count = static_cast<int8_t>(d[i++]);
    if (i >= n) break;  // count byte at end of input: nothing to copy
    if (count < 0) {
      size_t len = static_cast<size_t>(-count);
      if (len > cap - o) len = cap - o;
      if (len > n - i) len = n - i;  // truncated literal: clamp the read
      std::memcpy(out + o, d + i, len);
      i += static_cast<size_t>(-count);
      o += len;
    } else {
      size_t len = static_cast<size_t>(count) + 1;
      if (len > cap - o) len = cap - o;
      std::memset(out + o, d[i], len);
      i += 1;
      o += len;
    }
  }
  return o;
}

// ---------------------------------------------------------------------------
// PXR24
// ---------------------------------------------------------------------------

uint32_t float_to_float24(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t s = x & 0x80000000u;
  uint32_t e = x & 0x7F800000u;
  uint32_t m = x & 0x007FFFFFu;
  uint32_t out24;
  if (e == 0x7F800000u) {  // inf / nan
    uint32_t m15 = m >> 8;
    out24 = (e >> 8) | m15 | ((m != 0 && m15 == 0) ? 1u : 0u);
  } else {
    uint32_t rounded = ((e | m) + 0x80u) >> 8;
    if (((rounded << 8) & 0x7F800000u) == 0x7F800000u)
      rounded = (e | m) >> 8;  // avoid overflow to inf: truncate
    out24 = rounded;
  }
  return (s >> 8) | out24;
}

float float24_to_float(uint32_t i24) {
  uint32_t bits = i24 << 8;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// ---------------------------------------------------------------------------
// PIZ: bitmap/LUT compaction + 2D integer wavelet + canonical Huffman.
//
// Implemented from the OpenEXR file-format specification of the PIZ scheme.
// Payload layout: u16 minNonZero, u16 maxNonZero, bitmap bytes
// [minNonZero..maxNonZero], i32 huffman length, huffman data.  Huffman
// block: u32 im, u32 iM, u32 tableLength, u32 nBits, u32 reserved, packed
// 6-bit code-length table, MSB-first bitstream.  The run-length
// pseudo-symbol is index iM; code lengths are capped at 58 bits.
// ---------------------------------------------------------------------------

namespace piz {

constexpr int kBitmapSize = 65536 / 8;
constexpr int kUShortRange = 65536;
constexpr int kHufEncSize = 65537;
constexpr int kMaxCodeLen = 58;
constexpr int kShortZerocodeRun = 59;
constexpr int kLongZerocodeRun = 63;
constexpr int kShortestLongRun = 2 + kLongZerocodeRun - kShortZerocodeRun;
constexpr int kLongestLongRun = 255 + kShortestLongRun;

// ---- wavelet ----

inline void wenc14(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int16_t as = static_cast<int16_t>(a), bs = static_cast<int16_t>(b);
  int16_t ms = static_cast<int16_t>((as + bs) >> 1);
  int16_t ds = static_cast<int16_t>(as - bs);
  l = static_cast<uint16_t>(ms);
  h = static_cast<uint16_t>(ds);
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = static_cast<int16_t>(l), hs = static_cast<int16_t>(h);
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = static_cast<int16_t>(ai);
  int16_t bs = static_cast<int16_t>(ai - hi);
  a = static_cast<uint16_t>(as);
  b = static_cast<uint16_t>(bs);
}

constexpr int kNBits = 16;
constexpr int kAOffset = 1 << (kNBits - 1);
constexpr int kMOffset = 1 << (kNBits - 1);
constexpr int kModMask = (1 << kNBits) - 1;

inline void wenc16(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int ao = (a + kAOffset) & kModMask;
  int m = (ao + b) >> 1;
  int d = ao - b;
  if (d < 0) m = (m + kMOffset) & kModMask;
  d &= kModMask;
  l = static_cast<uint16_t>(m);
  h = static_cast<uint16_t>(d);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & kModMask;
  int aa = (d + bb - kAOffset) & kModMask;
  b = static_cast<uint16_t>(bb);
  a = static_cast<uint16_t>(aa);
}

void wav2Encode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1, p2 = 2;
  while (p2 <= n) {
    uint16_t* py = in;
    uint16_t* ey = in + oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        uint16_t i00, i01, i10, i11;
        if (w14) {
          wenc14(*px, *p01, i00, i01);
          wenc14(*p10, *p11, i10, i11);
          wenc14(i00, i10, *px, *p10);
          wenc14(i01, i11, *p01, *p11);
        } else {
          wenc16(*px, *p01, i00, i01);
          wenc16(*p10, *p11, i10, i11);
          wenc16(i00, i10, *px, *p10);
          wenc16(i01, i11, *p01, *p11);
        }
      }
      if (nx & p) {  // odd leftover column
        uint16_t* p10 = px + oy1;
        uint16_t i00;
        if (w14) wenc14(*px, *p10, i00, *p10);
        else wenc16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {  // leftover row
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t i00;
        if (w14) wenc14(*px, *p01, i00, *p01);
        else wenc16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p = p2;
    p2 <<= 1;
  }
}

void wav2Decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1, p2;
  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        uint16_t i00, i01, i10, i11;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        uint16_t i00;
        if (w14) wdec14(*px, *p10, i00, *p10);
        else wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t i00;
        if (w14) wdec14(*px, *p01, i00, *p01);
        else wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// ---- bitmap / LUT ----

uint16_t forwardLutFromBitmap(const uint8_t bitmap[kBitmapSize],
                              uint16_t lut[kUShortRange]) {
  int k = 0;
  for (int i = 0; i < kUShortRange; ++i) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7))))
      lut[i] = static_cast<uint16_t>(k++);
    else
      lut[i] = 0;
  }
  return static_cast<uint16_t>(k - 1);
}

uint16_t reverseLutFromBitmap(const uint8_t bitmap[kBitmapSize],
                              uint16_t lut[kUShortRange]) {
  int k = 0;
  for (int i = 0; i < kUShortRange; ++i) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7))))
      lut[k++] = static_cast<uint16_t>(i);
  }
  int n = k - 1;
  while (k < kUShortRange) lut[k++] = 0;
  return static_cast<uint16_t>(n);
}

// ---- bit IO ----

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t c = 0;
  int lc = 0;
  void writeBits(int n, uint64_t val) {
    c = (c << n) | (val & ((1ull << n) - 1));
    lc += n;
    while (lc >= 8) {
      lc -= 8;
      out->push_back(static_cast<uint8_t>(c >> lc));
    }
  }
  void flush() {
    if (lc > 0) {
      out->push_back(static_cast<uint8_t>(c << (8 - lc)));
      lc = 0;
    }
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint64_t c = 0;
  int lc = 0;
  bool readBits(int n, uint64_t* val) {
    while (lc < n) {
      if (pos >= size) return false;
      c = (c << 8) | data[pos++];
      lc += 8;
    }
    lc -= n;
    *val = (c >> lc) & ((1ull << n) - 1);
    return true;
  }
};

// ---- Huffman ----

// code entry: (canonical code << 6) | length
inline int hufLength(uint64_t code) { return static_cast<int>(code & 63); }
inline uint64_t hufCode(uint64_t code) { return code >> 6; }

void hufCanonicalCodeTable(uint64_t hcode[kHufEncSize]) {
  uint64_t n[59] = {0};
  for (int i = 0; i < kHufEncSize; ++i) n[hcode[i]] += 1;
  // n[0] irrelevant; compute first canonical code per length, longest first
  uint64_t c = 0;
  for (int i = kMaxCodeLen; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < kHufEncSize; ++i) {
    int l = static_cast<int>(hcode[i]);
    if (l > 0) hcode[i] = static_cast<uint64_t>(l) | (n[l]++ << 6);
  }
}

// Build code lengths (into frq, replaced by packed codes) for symbols with
// nonzero frequency; appends the run-length pseudo-symbol at *iM.
void hufBuildEncTable(uint64_t* frq, int* im, int* iM) {
  std::vector<int> hlink(kHufEncSize);
  std::vector<uint64_t*> fheap;
  fheap.reserve(kHufEncSize);

  *im = 0;
  while (*im < kHufEncSize - 1 && !frq[*im]) (*im)++;
  *iM = *im;
  for (int i = *im; i < kHufEncSize; ++i) {
    hlink[i] = i;
    if (frq[i]) {
      fheap.push_back(&frq[i]);
      *iM = i;
    }
  }
  // run-length pseudo-symbol
  (*iM)++;
  frq[*iM] = 1;
  fheap.push_back(&frq[*iM]);
  hlink[*iM] = *iM;

  auto cmp = [](uint64_t* a, uint64_t* b) { return *a > *b; };  // min-heap
  std::make_heap(fheap.begin(), fheap.end(), cmp);

  std::vector<uint64_t> scode(kHufEncSize, 0);
  size_t nf = fheap.size();
  while (nf > 1) {
    std::pop_heap(fheap.begin(), fheap.begin() + nf, cmp);
    int mm = static_cast<int>(fheap[--nf] - frq);
    std::pop_heap(fheap.begin(), fheap.begin() + nf, cmp);
    int m = static_cast<int>(fheap[--nf] - frq);
    frq[m] += frq[mm];
    fheap[nf++] = &frq[m];
    std::push_heap(fheap.begin(), fheap.begin() + nf, cmp);
    for (int j = m;; j = hlink[j]) {
      scode[j]++;
      if (hlink[j] == j) {
        hlink[j] = mm;
        break;
      }
    }
    for (int j = mm;; j = hlink[j]) {
      scode[j]++;
      if (hlink[j] == j) break;
    }
  }
  // cap pathological lengths (never expected with real data)
  for (int i = 0; i < kHufEncSize; ++i)
    if (scode[i] > kMaxCodeLen) scode[i] = kMaxCodeLen;

  hufCanonicalCodeTable(scode.data());
  std::memcpy(frq, scode.data(), sizeof(uint64_t) * kHufEncSize);
}

void hufPackEncTable(const uint64_t* hcode, int im, int iM,
                     std::vector<uint8_t>* out) {
  BitWriter w{out};
  for (int i = im; i <= iM; ++i) {
    int l = hufLength(hcode[i]);
    if (l == 0) {
      int zerun = 1;
      while (i < iM && zerun < kLongestLongRun) {
        if (hufLength(hcode[i + 1]) > 0) break;
        i++;
        zerun++;
      }
      if (zerun >= 2) {
        if (zerun >= kShortestLongRun) {
          w.writeBits(6, kLongZerocodeRun);
          w.writeBits(8, zerun - kShortestLongRun);
        } else {
          w.writeBits(6, kShortZerocodeRun + zerun - 2);
        }
        continue;
      }
    }
    w.writeBits(6, l);
  }
  w.flush();
}

bool hufUnpackEncTable(BitReader* r, int im, int iM,
                       uint64_t hcode[kHufEncSize]) {
  std::memset(hcode, 0, sizeof(uint64_t) * kHufEncSize);
  for (int i = im; i <= iM;) {
    uint64_t l;
    if (!r->readBits(6, &l)) return false;
    if (l == kLongZerocodeRun) {
      uint64_t n;
      if (!r->readBits(8, &n)) return false;
      int zerun = static_cast<int>(n) + kShortestLongRun;
      if (i + zerun > iM + 1) return false;
      for (int k = 0; k < zerun; ++k) hcode[i++] = 0;
    } else if (l >= kShortZerocodeRun) {
      int zerun = static_cast<int>(l) - kShortZerocodeRun + 2;
      if (i + zerun > iM + 1) return false;
      for (int k = 0; k < zerun; ++k) hcode[i++] = 0;
    } else {
      hcode[i++] = l;
    }
  }
  hufCanonicalCodeTable(hcode);
  return true;
}

uint64_t hufEncode(const uint64_t* hcode, const uint16_t* in, size_t ni,
                   int rlc, std::vector<uint8_t>* out) {
  BitWriter w{out};
  uint64_t nbits = 0;
  auto outputCode = [&](uint64_t entry) {
    w.writeBits(hufLength(entry), hufCode(entry));
    nbits += hufLength(entry);
  };
  auto sendCode = [&](uint64_t sCode, int runCount, uint64_t runCode) {
    if (hufLength(sCode) + hufLength(runCode) + 8 <
        hufLength(sCode) * (runCount + 1)) {
      outputCode(sCode);
      outputCode(runCode);
      w.writeBits(8, runCount);
      nbits += 8;
    } else {
      for (int i = 0; i <= runCount; ++i) outputCode(sCode);
    }
  };
  uint16_t s = in[0];
  int cs = 0;
  for (size_t i = 1; i < ni; ++i) {
    if (in[i] == s && cs < 255) {
      cs++;
    } else {
      sendCode(hcode[s], cs, hcode[rlc]);
      s = in[i];
      cs = 0;
    }
  }
  sendCode(hcode[s], cs, hcode[rlc]);
  w.flush();
  return nbits;
}

// Canonical decode tables: per length, first code / count / symbol list.
struct HufDecoder {
  uint64_t firstCode[kMaxCodeLen + 1] = {0};
  uint32_t count[kMaxCodeLen + 1] = {0};
  uint32_t offset[kMaxCodeLen + 1] = {0};
  std::vector<uint32_t> symbols;  // sorted by (length, symbol index)

  void build(const uint64_t* hcode, int im, int iM) {
    for (int i = im; i <= iM; ++i) count[hufLength(hcode[i])]++;
    count[0] = 0;
    uint32_t total = 0;
    for (int l = 1; l <= kMaxCodeLen; ++l) {
      offset[l] = total;
      total += count[l];
    }
    symbols.resize(total);
    std::vector<uint32_t> fill(kMaxCodeLen + 1, 0);
    for (int i = im; i <= iM; ++i) {
      int l = hufLength(hcode[i]);
      if (l > 0) {
        if (fill[l] == 0) firstCode[l] = hufCode(hcode[i]);
        symbols[offset[l] + fill[l]++] = static_cast<uint32_t>(i);
      }
    }
  }

  // Decode ni symbols; returns false on malformed stream.
  bool decode(BitReader* r, uint64_t nbits, int rlc, uint16_t* out,
              size_t ni) const {
    size_t produced = 0;
    uint64_t consumed = 0;
    uint64_t code = 0;
    int len = 0;
    int prev = -1;
    while (produced < ni && consumed < nbits) {
      uint64_t bit;
      if (!r->readBits(1, &bit)) return false;
      consumed++;
      code = (code << 1) | bit;
      len++;
      if (len > kMaxCodeLen) return false;
      if (count[len] && code >= firstCode[len] &&
          code - firstCode[len] < count[len]) {
        uint32_t sym =
            symbols[offset[len] + static_cast<uint32_t>(code -
                                                        firstCode[len])];
        if (static_cast<int>(sym) == rlc) {
          uint64_t n;
          if (!r->readBits(8, &n)) return false;
          consumed += 8;
          if (prev < 0 || produced + n > ni) return false;
          for (uint64_t k = 0; k < n; ++k)
            out[produced++] = static_cast<uint16_t>(prev);
        } else {
          if (produced >= ni) return false;
          out[produced++] = static_cast<uint16_t>(sym);
          prev = sym;
        }
        code = 0;
        len = 0;
      }
    }
    return produced == ni;
  }
};

void put_u32(std::vector<uint8_t>* b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xFF);
}

// Full huf block: header + packed table + bitstream.
void hufCompress(const uint16_t* raw, size_t n, std::vector<uint8_t>* out) {
  std::vector<uint64_t> freq(kHufEncSize, 0);
  for (size_t i = 0; i < n; ++i) freq[raw[i]]++;
  int im = 0, iM = 0;
  hufBuildEncTable(freq.data(), &im, &iM);

  std::vector<uint8_t> table;
  hufPackEncTable(freq.data(), im, iM, &table);

  std::vector<uint8_t> bits;
  uint64_t nbits = hufEncode(freq.data(), raw, n, iM, &bits);

  put_u32(out, static_cast<uint32_t>(im));
  put_u32(out, static_cast<uint32_t>(iM));
  put_u32(out, static_cast<uint32_t>(table.size()));
  put_u32(out, static_cast<uint32_t>(nbits));
  put_u32(out, 0);
  out->insert(out->end(), table.begin(), table.end());
  out->insert(out->end(), bits.begin(), bits.end());
}

bool hufUncompress(const uint8_t* data, size_t size, uint16_t* out,
                   size_t n_out) {
  if (size < 20) return false;
  auto rd_u32 = [&](size_t o) {
    uint32_t v;
    std::memcpy(&v, data + o, 4);
    return v;
  };
  uint32_t im = rd_u32(0), iM = rd_u32(4), tlen = rd_u32(8),
           nbits = rd_u32(12);
  if (im >= kHufEncSize || iM >= kHufEncSize || im > iM) return false;
  // 64-bit comparison: `20 + tlen` in 32-bit arithmetic wraps for
  // tlen >= 2^32-20 and would bypass the bound (size >= 20 was checked)
  if (tlen > size - 20) return false;

  std::vector<uint64_t> hcode(kHufEncSize);
  BitReader tr{data + 20, tlen};
  if (!hufUnpackEncTable(&tr, static_cast<int>(im), static_cast<int>(iM),
                         hcode.data()))
    return false;

  HufDecoder dec;
  dec.build(hcode.data(), static_cast<int>(im), static_cast<int>(iM));
  BitReader br{data + 20 + tlen, size - 20 - tlen};
  return dec.decode(&br, nbits, static_cast<int>(iM), out, n_out);
}

}  // namespace piz

// ---------------------------------------------------------------------------
// zlib helpers
// ---------------------------------------------------------------------------

bool zlib_deflate(const uint8_t* src, size_t n, std::vector<uint8_t>* out,
                  int level = Z_DEFAULT_COMPRESSION) {
  uLongf cap = compressBound(static_cast<uLong>(n));
  out->resize(cap);
  if (compress2(out->data(), &cap, src, static_cast<uLong>(n), level) != Z_OK)
    return false;
  out->resize(cap);
  return true;
}

bool zlib_inflate(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  // exact-length contract: a valid zlib stream that inflates to fewer
  // bytes than expected would leave a stale-buffer tail that
  // filter_decode happily processes — corrupt chunks must fail here,
  // matching the RLE branch's `!= raw_size` check.
  uLongf len = static_cast<uLongf>(cap);
  return uncompress(dst, &len, src, static_cast<uLong>(n)) == Z_OK &&
         len == static_cast<uLongf>(cap);
}

// ---------------------------------------------------------------------------
// Header
// ---------------------------------------------------------------------------

void put_i32(std::vector<uint8_t>* b, int32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xFF);
}
void put_u64(std::vector<uint8_t>* b, uint64_t v) {
  for (int i = 0; i < 8; ++i) b->push_back((v >> (8 * i)) & 0xFF);
}
void put_f32(std::vector<uint8_t>* b, float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  put_i32(b, static_cast<int32_t>(x));
}
void put_str(std::vector<uint8_t>* b, const char* s) {
  while (*s) b->push_back(static_cast<uint8_t>(*s++));
  b->push_back(0);
}

void put_attr(std::vector<uint8_t>* b, const char* name, const char* type,
              const std::vector<uint8_t>& payload) {
  put_str(b, name);
  put_str(b, type);
  put_i32(b, static_cast<int32_t>(payload.size()));
  b->insert(b->end(), payload.begin(), payload.end());
}

std::vector<std::string> channel_names(int channels) {
  if (channels == 3) return {"B", "G", "R"};  // alphabetical storage order
  if (channels == 1) return {"Y"};
  // zero-padded so the spec's alphabetical chlist order IS numeric order
  // ("channel10" would otherwise sort before "channel2" and permute the
  // round trip for images with >= 11 channels)
  int width = static_cast<int>(std::to_string(channels - 1).size());
  std::vector<std::string> names;
  char buf[32];
  for (int i = 0; i < channels; ++i) {
    std::snprintf(buf, sizeof(buf), "channel%0*d", width, i);
    names.emplace_back(buf);
  }
  return names;
}

// map storage (alphabetical) channel index -> interleaved RGB index
std::vector<int> channel_source_index(int channels) {
  if (channels == 3) return {2, 1, 0};  // B,G,R <- rgb[2],rgb[1],rgb[0]
  std::vector<int> idx(channels);
  for (int i = 0; i < channels; ++i) idx[i] = i;
  return idx;
}

// Source-sample accessors: the writer is templated over the input element
// type so float16 frames (e.g. a reduced-precision device fetch) are packed
// with a straight 16-bit copy instead of a per-pixel float->half conversion.
inline uint16_t as_half(float v) { return float_to_half(v); }
inline uint16_t as_half(uint16_t v) { return v; }
inline float as_float(float v) { return v; }
inline float as_float(uint16_t v) { return half_to_float(v); }

// ---------------------------------------------------------------------------
// Streaming writer: header + zeroed offset table up front, chunks appended
// band by band (chunk payloads compressed on a small thread pool — EXR
// chunks are independent, so the output is byte-identical to a serial
// whole-image write), offset table patched at the end.  exr_write(_half)
// runs the whole image as one band through the same machinery; the
// exr_begin/exr_write_rows/exr_end C API is the band-streamed form used by
// the pipelined single-frame exporter (hdrvae/io/pipeline.py), which
// encodes band k while band k+1 is still in flight from the device.
// ---------------------------------------------------------------------------

std::vector<uint8_t> build_exr_header(int height, int width,
                                      const std::vector<std::string>& names,
                                      int pixel_type, int compression_id) {
  std::vector<uint8_t> head;
  head.reserve(512);
  put_i32(&head, static_cast<int32_t>(kMagic));
  put_i32(&head, kVersion);
  {
    std::vector<uint8_t> chl;
    for (const auto& nm : names) {
      put_str(&chl, nm.c_str());
      put_i32(&chl, pixel_type);
      put_i32(&chl, 0);  // pLinear + reserved
      put_i32(&chl, 1);
      put_i32(&chl, 1);
    }
    chl.push_back(0);
    put_attr(&head, "channels", "chlist", chl);
  }
  put_attr(&head, "compression", "compression",
           {static_cast<uint8_t>(compression_id)});
  {
    std::vector<uint8_t> box;
    put_i32(&box, 0); put_i32(&box, 0);
    put_i32(&box, width - 1); put_i32(&box, height - 1);
    put_attr(&head, "dataWindow", "box2i", box);
    put_attr(&head, "displayWindow", "box2i", box);
  }
  put_attr(&head, "lineOrder", "lineOrder", {0});
  {
    std::vector<uint8_t> f; put_f32(&f, 1.0f);
    put_attr(&head, "pixelAspectRatio", "float", f);
  }
  {
    std::vector<uint8_t> v; put_f32(&v, 0.0f); put_f32(&v, 0.0f);
    put_attr(&head, "screenWindowCenter", "v2f", v);
  }
  {
    std::vector<uint8_t> f; put_f32(&f, 1.0f);
    put_attr(&head, "screenWindowWidth", "float", f);
  }
  head.push_back(0);  // end of header
  return head;
}

struct ExrWriter {
  FILE* f = nullptr;
  int height = 0, width = 0, channels = 0;
  int pixel_type = HALF, compression_id = ZIP, zip_level = 4;
  int lines = 1, workers = 0, next_row = 0, n_chunks = 0;
  std::vector<int> src_idx;
  size_t row_bytes = 0;
  uint64_t head_size = 0, pos = 0;
  std::vector<uint64_t> offsets;
};

// Encode one chunk (global rows [y0, y1)) from a band whose first row is
// global row band_y0.  Returns false on a compression error.
template <typename T>
bool encode_one_chunk(const ExrWriter& wr, const T* band, int band_y0,
                      int y0, int y1, std::vector<uint8_t>* chunk) {
  const int width = wr.width, channels = wr.channels;
  const int pixel_type = wr.pixel_type, compression_id = wr.compression_id;
  const int psz = pixel_size(pixel_type);
  const int nrows = y1 - y0;
  const size_t raw_size = static_cast<size_t>(nrows) * wr.row_bytes;
  std::vector<uint8_t> raw(raw_size), tmp, enc;
  const auto& src_idx = wr.src_idx;
  auto band_row = [&](int y, int ci) -> const T* {
    return band + (static_cast<size_t>(y - band_y0) * width * channels)
               + src_idx[ci];
  };

  // pack scanlines: per row, per channel (alphabetical), w pixels
  size_t off = 0;
  for (int y = y0; y < y1; ++y) {
    for (int ci = 0; ci < channels; ++ci) {
      const T* row = band_row(y, ci);
      if (pixel_type == HALF) {
        uint16_t* dst = reinterpret_cast<uint16_t*>(raw.data() + off);
        for (int x = 0; x < width; ++x)
          dst[x] = as_half(row[static_cast<size_t>(x) * channels]);
        off += static_cast<size_t>(width) * 2;
      } else {
        float* dst = reinterpret_cast<float*>(raw.data() + off);
        for (int x = 0; x < width; ++x)
          dst[x] = as_float(row[static_cast<size_t>(x) * channels]);
        off += static_cast<size_t>(width) * 4;
      }
    }
  }

  std::vector<uint8_t> payload;
  if (compression_id == NONE) {
    payload = raw;
  } else if (compression_id == PIZ) {
    // un-interleave scanlines into channel-major short planes
    const int psize = psz / 2;  // shorts per pixel
    const size_t plane_shorts =
        static_cast<size_t>(nrows) * width * psize;
    std::vector<uint16_t> shorts(plane_shorts * channels);
    {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(raw.data());
      size_t spos = 0;
      for (int r = 0; r < nrows; ++r) {
        for (int ci = 0; ci < channels; ++ci) {
          uint16_t* plane = shorts.data() + plane_shorts * ci +
                            static_cast<size_t>(r) * width * psize;
          std::memcpy(plane, src + spos,
                      static_cast<size_t>(width) * psize * 2);
          spos += static_cast<size_t>(width) * psize;
        }
      }
    }
    // bitmap + forward LUT
    std::vector<uint8_t> bitmap(piz::kBitmapSize, 0);
    for (uint16_t v : shorts) bitmap[v >> 3] |= 1 << (v & 7);
    bitmap[0] &= ~1u;  // zero is not stored
    std::vector<uint16_t> lut(piz::kUShortRange);
    uint16_t max_value = piz::forwardLutFromBitmap(bitmap.data(),
                                                   lut.data());
    for (uint16_t& v : shorts) v = lut[v];
    // wavelet per channel per short-plane
    for (int ci = 0; ci < channels; ++ci) {
      for (int j = 0; j < psize; ++j) {
        piz::wav2Encode(shorts.data() + plane_shorts * ci + j, width,
                        psize, nrows, width * psize, max_value);
      }
    }
    // payload: bitmap range + bitmap + huffman
    int min_nz = piz::kBitmapSize, max_nz = -1;
    for (int i = 0; i < piz::kBitmapSize; ++i) {
      if (bitmap[i]) {
        if (i < min_nz) min_nz = i;
        max_nz = i;
      }
    }
    if (max_nz < 0) { min_nz = 1; max_nz = 0; }  // empty bitmap signal
    payload.push_back(min_nz & 0xFF);
    payload.push_back((min_nz >> 8) & 0xFF);
    payload.push_back(max_nz & 0xFF);
    payload.push_back((max_nz >> 8) & 0xFF);
    for (int i = min_nz; i <= max_nz; ++i) payload.push_back(bitmap[i]);
    std::vector<uint8_t> huf;
    piz::hufCompress(shorts.data(), shorts.size(), &huf);
    int32_t hlen = static_cast<int32_t>(huf.size());
    for (int i = 0; i < 4; ++i)
      payload.push_back((hlen >> (8 * i)) & 0xFF);
    payload.insert(payload.end(), huf.begin(), huf.end());
  } else if (compression_id == ZIPS || compression_id == ZIP) {
    tmp.resize(raw_size);
    filter_encode(raw.data(), raw_size, tmp.data());
    if (!zlib_deflate(tmp.data(), raw_size, &payload, wr.zip_level))
      return false;
  } else if (compression_id == RLE) {
    tmp.resize(raw_size);
    filter_encode(raw.data(), raw_size, tmp.data());
    enc.resize(raw_size * 2 + 16);
    size_t n = rle_encode(tmp.data(), raw_size, enc.data());
    payload.assign(enc.begin(), enc.begin() + n);
  } else {  // PXR24
    // plane-pack deltas per channel-row from the float source
    tmp.clear();
    tmp.reserve(raw_size);
    for (int y = y0; y < y1; ++y) {
      for (int ci = 0; ci < channels; ++ci) {
        const T* row = band_row(y, ci);
        if (pixel_type == FLOAT) {
          std::vector<uint8_t> hi(width), mid(width), lo(width);
          uint32_t prev = 0;
          for (int x = 0; x < width; ++x) {
            uint32_t p = float_to_float24(
                as_float(row[static_cast<size_t>(x) * channels]));
            uint32_t diff = (p - prev) & 0xFFFFFFu;
            prev = p;
            hi[x] = (diff >> 16) & 0xFF;
            mid[x] = (diff >> 8) & 0xFF;
            lo[x] = diff & 0xFF;
          }
          tmp.insert(tmp.end(), hi.begin(), hi.end());
          tmp.insert(tmp.end(), mid.begin(), mid.end());
          tmp.insert(tmp.end(), lo.begin(), lo.end());
        } else {  // HALF
          std::vector<uint8_t> hi(width), lo(width);
          uint32_t prev = 0;
          for (int x = 0; x < width; ++x) {
            uint32_t p = as_half(
                row[static_cast<size_t>(x) * channels]);
            uint32_t diff = (p - prev) & 0xFFFFu;
            prev = p;
            hi[x] = (diff >> 8) & 0xFF;
            lo[x] = diff & 0xFF;
          }
          tmp.insert(tmp.end(), hi.begin(), hi.end());
          tmp.insert(tmp.end(), lo.begin(), lo.end());
        }
      }
    }
    if (!zlib_deflate(tmp.data(), tmp.size(), &payload, wr.zip_level))
      return false;
  }
  if (payload.size() >= raw_size) payload = raw;  // store raw

  chunk->clear();
  put_i32(chunk, y0);
  put_i32(chunk, static_cast<int32_t>(payload.size()));
  chunk->insert(chunk->end(), payload.begin(), payload.end());
  return true;
}

ExrWriter* exr_begin_impl(const char* path, int height, int width,
                          int channels, int pixel_type, int compression_id,
                          int zip_level, int workers, int* rc) {
  *rc = 0;
  if (pixel_type != HALF && pixel_type != FLOAT) { *rc = -2; return nullptr; }
  if (compression_id < 0 || compression_id > 5) { *rc = -3; return nullptr; }
  if (height <= 0 || width <= 0 || channels <= 0) { *rc = -2; return nullptr; }

  auto wr = new ExrWriter();
  wr->height = height; wr->width = width; wr->channels = channels;
  wr->pixel_type = pixel_type; wr->compression_id = compression_id;
  wr->zip_level = zip_level;
  wr->lines = lines_per_chunk(compression_id);
  wr->workers = workers;
  wr->src_idx = channel_source_index(channels);
  wr->row_bytes = static_cast<size_t>(width) * pixel_size(pixel_type)
                  * channels;
  wr->n_chunks = (height + wr->lines - 1) / wr->lines;

  const auto names = channel_names(channels);
  const auto head = build_exr_header(height, width, names, pixel_type,
                                     compression_id);
  wr->head_size = head.size();
  wr->pos = head.size() + 8ull * wr->n_chunks;
  wr->offsets.reserve(wr->n_chunks);

  wr->f = std::fopen(path, "wb");
  if (!wr->f) { *rc = -1; delete wr; return nullptr; }
  const std::vector<uint8_t> zeros(8ull * wr->n_chunks, 0);
  if (std::fwrite(head.data(), 1, head.size(), wr->f) != head.size() ||
      std::fwrite(zeros.data(), 1, zeros.size(), wr->f) != zeros.size()) {
    std::fclose(wr->f); delete wr; *rc = -5; return nullptr;
  }
  return wr;
}

template <typename T>
int write_rows_impl(ExrWriter* wr, const T* band, int nrows) {
  if (!wr || !wr->f) return -1;
  const int y0_band = wr->next_row;
  if (nrows <= 0 || y0_band + nrows > wr->height) return -6;
  if (nrows % wr->lines != 0 && y0_band + nrows != wr->height)
    return -6;  // bands must cover whole chunks (except the final band)

  const int lines = wr->lines;
  std::vector<std::pair<int, int>> spans;
  for (int y0 = y0_band; y0 < y0_band + nrows; y0 += lines) {
    spans.emplace_back(y0, std::min(y0 + lines, y0_band + nrows));
  }
  const int n = static_cast<int>(spans.size());
  std::vector<std::vector<uint8_t>> out(n);

  int nthreads = wr->workers;
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 1;
    if (nthreads > 8) nthreads = 8;
  }
  nthreads = std::min(nthreads, n);

  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n && !failed.load()) {
      if (!encode_one_chunk(*wr, band, y0_band, spans[i].first,
                            spans[i].second, &out[i]))
        failed.store(true);
    }
  };
  if (nthreads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  if (failed.load()) return -4;

  for (int i = 0; i < n; ++i) {
    wr->offsets.push_back(wr->pos);
    if (std::fwrite(out[i].data(), 1, out[i].size(), wr->f)
        != out[i].size())
      return -5;
    wr->pos += out[i].size();
  }
  wr->next_row = y0_band + nrows;
  return 0;
}

int exr_end_impl(ExrWriter* wr) {
  if (!wr) return -1;
  int rc = 0;
  if (!wr->f) {
    rc = -1;
  } else if (wr->next_row != wr->height) {
    rc = -6;
  } else {
    std::vector<uint8_t> table;
    table.reserve(8 * wr->offsets.size());
    for (uint64_t o : wr->offsets) put_u64(&table, o);
    if (std::fseek(wr->f, static_cast<long>(wr->head_size), SEEK_SET) != 0 ||
        std::fwrite(table.data(), 1, table.size(), wr->f) != table.size())
      rc = -5;
  }
  if (wr->f) std::fclose(wr->f);
  delete wr;
  return rc;
}

void exr_abort_impl(ExrWriter* wr) {
  if (!wr) return;
  if (wr->f) std::fclose(wr->f);
  delete wr;
}

// Write an interleaved image (height x width x channels, RGB order for
// 3-channel); T = float (float32 input) or uint16_t (IEEE half input).
// pixel_type: 1=half 2=float; compression_id: OpenEXR id
// (0 none, 1 rle, 2 zips, 3 zip, 5 pxr24); zip_level: zlib level 1-9 for
// ZIP/ZIPS (modern OpenEXR defaults to 4 — near-identical size to 6 on
// delta-filtered pixel data, ~2x faster deflate).  Returns 0 on success.
template <typename T>
int exr_write_impl(const char* path, const T* data, int height, int width,
                   int channels, int pixel_type, int compression_id,
                   int zip_level) {
  int rc = 0;
  ExrWriter* wr = exr_begin_impl(path, height, width, channels, pixel_type,
                                 compression_id, zip_level, /*workers=*/0,
                                 &rc);
  if (!wr) return rc;
  rc = write_rows_impl(wr, data, height);
  if (rc != 0) { exr_abort_impl(wr); return rc; }
  return exr_end_impl(wr);
}

}  // namespace

extern "C" {

int exr_write(const char* path, const float* data, int height, int width,
              int channels, int pixel_type, int compression_id,
              int zip_level) {
  return exr_write_impl(path, data, height, width, channels, pixel_type,
                        compression_id, zip_level);
}

// ---- streaming (banded) writer API ----------------------------------------
// exr_begin -> N x exr_write_rows[_half] -> exr_end.  Bands must cover a
// whole number of scanline chunks (lines = exr_lines_per_chunk(comp)),
// except the final band.  The produced file is byte-identical to
// exr_write on the same pixels.  workers: chunk-compression threads
// (0 = auto).  On any non-zero rc from exr_write_rows, call exr_abort.

int exr_lines_per_chunk(int compression_id) {
  return lines_per_chunk(compression_id);
}

void* exr_begin(const char* path, int height, int width, int channels,
                int pixel_type, int compression_id, int zip_level,
                int workers) {
  int rc = 0;
  return exr_begin_impl(path, height, width, channels, pixel_type,
                        compression_id, zip_level, workers, &rc);
}

int exr_write_rows(void* handle, const float* band, int nrows) {
  return write_rows_impl(static_cast<ExrWriter*>(handle), band, nrows);
}

int exr_write_rows_half(void* handle, const uint16_t* band, int nrows) {
  return write_rows_impl(static_cast<ExrWriter*>(handle), band, nrows);
}

int exr_end(void* handle) {
  return exr_end_impl(static_cast<ExrWriter*>(handle));
}

void exr_abort(void* handle) {
  exr_abort_impl(static_cast<ExrWriter*>(handle));
}

// Half-precision input (IEEE 754 binary16 as uint16, e.g. numpy float16):
// with pixel_type=half the scanline pack is a pure 16-bit gather — no
// per-pixel float->half conversion on the hot export path.
int exr_write_half(const char* path, const uint16_t* data, int height,
                   int width, int channels, int pixel_type,
                   int compression_id, int zip_level) {
  return exr_write_impl(path, data, height, width, channels, pixel_type,
                        compression_id, zip_level);
}

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

namespace {

struct ChannelInfo {
  std::string name;
  int ptype;
};

struct Parsed {
  int width = 0, height = 0, comp = 0, y_min = 0;
  std::vector<ChannelInfo> channels;
  size_t offsets_pos = 0;  // file position of the offset table
};

bool read_cstr(const std::vector<uint8_t>& b, size_t* pos, std::string* out) {
  out->clear();
  while (*pos < b.size() && b[*pos] != 0) out->push_back(b[(*pos)++]);
  if (*pos >= b.size()) return false;
  (*pos)++;
  return true;
}

int32_t get_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

bool parse_header(const std::vector<uint8_t>& buf, Parsed* out) {
  if (buf.size() < 8 ||
      static_cast<uint32_t>(get_i32(buf.data())) != kMagic)
    return false;
  // version/flags word: this is a SCANLINE single-part reader.  Tiled
  // (0x200), deep (0x800), and multipart (0x1000) layouts store
  // different chunk headers — parsing them as scanline can look
  // self-consistent enough to decode garbage, so refuse them here
  // (the pure-Python reader raises NotImplementedError the same way).
  {
    const uint32_t version = static_cast<uint32_t>(get_i32(buf.data() + 4));
    if (version & (0x200u | 0x800u | 0x1000u)) return false;
  }
  size_t pos = 8;
  while (pos < buf.size()) {
    if (buf[pos] == 0) { pos++; break; }
    std::string name, type;
    if (!read_cstr(buf, &pos, &name) || !read_cstr(buf, &pos, &type))
      return false;
    // the attribute size field is file data: bound it before ANY use
    if (pos + 4 > buf.size()) return false;
    int32_t size = get_i32(buf.data() + pos);
    pos += 4;
    if (size < 0 || pos + static_cast<size_t>(size) > buf.size())
      return false;
    const uint8_t* payload = buf.data() + pos;
    if (name == "channels") {
      size_t cpos = 0;
      std::vector<uint8_t> pay(payload, payload + size);
      while (cpos < pay.size() && pay[cpos] != 0) {
        std::string cname;
        if (!read_cstr(pay, &cpos, &cname)) return false;
        if (cpos + 16 > pay.size()) return false;
        int32_t pt = get_i32(pay.data() + cpos);
        cpos += 16;  // type + pLinear/reserved + sampling
        // HALF/FLOAT only: the decode paths reinterpret 4-byte pixels
        // as IEEE float, which is WRONG for UINT (and undefined for
        // unknown type ids) — refuse here so the pure-Python reader,
        // which converts UINT correctly, handles the file instead.
        if (pt != HALF && pt != FLOAT) return false;
        out->channels.push_back({cname, pt});
      }
    } else if (name == "compression") {
      if (size < 1) return false;
      out->comp = payload[0];
    } else if (name == "dataWindow") {
      if (size < 16) return false;
      int32_t x0 = get_i32(payload), y0 = get_i32(payload + 4);
      int32_t x1 = get_i32(payload + 8), y1 = get_i32(payload + 12);
      // compute in 64-bit: extreme corrupted corners overflow int32
      int64_t wid = static_cast<int64_t>(x1) - x0 + 1;
      int64_t hei = static_cast<int64_t>(y1) - y0 + 1;
      if (wid < 1 || hei < 1 || wid > (1 << 20) || hei > (1 << 20))
        return false;
      out->width = static_cast<int>(wid);
      out->height = static_cast<int>(hei);
      out->y_min = y0;
    }
    pos += size;
  }
  out->offsets_pos = pos;
  // sanity bounds: corrupted dataWindow/chlist fields must not drive
  // multi-GB allocations (std::length_error aborts) or index overflow
  return out->width > 0 && out->height > 0 && !out->channels.empty() &&
         out->width <= (1 << 20) && out->height <= (1 << 20) &&
         out->channels.size() <= 1024 &&
         static_cast<int64_t>(out->width) * out->height *
             static_cast<int64_t>(out->channels.size()) <= (1ll << 31);
}

bool load_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(size);
  bool ok = std::fread(buf->data(), 1, size, f) == static_cast<size_t>(size);
  std::fclose(f);
  return ok;
}

}  // namespace

// Returns 0 on success and fills width/height/channels.
int exr_read_header(const char* path, int* width, int* height,
                    int* channels) {
  try {
    std::vector<uint8_t> buf;
    if (!load_file(path, &buf)) return -1;
    Parsed p;
    if (!parse_header(buf, &p)) return -2;
    *width = p.width;
    *height = p.height;
    *channels = static_cast<int>(p.channels.size());
    return 0;
  } catch (...) {
    // corrupted input must surface as an error code across the ctypes
    // boundary, never a C++ exception aborting the host process
    return -99;
  }
}

// Reads pixel data as float32 into out (height*width*channels), channels in
// RGB(A) order when R/G/B are present, else storage order.
int exr_read(const char* path, float* out) {
  try {
  std::vector<uint8_t> buf;
  if (!load_file(path, &buf)) return -1;
  Parsed p;
  if (!parse_header(buf, &p)) return -2;
  if (p.comp > PXR24) return -3;

  const int lines = lines_per_chunk(p.comp);
  const int c = static_cast<int>(p.channels.size());
  const int n_chunks = (p.height + lines - 1) / lines;
  size_t row_bytes = 0;
  for (const auto& ch : p.channels)
    row_bytes += static_cast<size_t>(p.width) * pixel_size(ch.ptype);

  // destination channel order: RGB(A) first if present
  std::vector<int> dst_idx(c);
  {
    bool rgb = false;
    int ri = -1, gi = -1, bi = -1;
    for (int i = 0; i < c; ++i) {
      if (p.channels[i].name == "R") ri = i;
      if (p.channels[i].name == "G") gi = i;
      if (p.channels[i].name == "B") bi = i;
    }
    rgb = ri >= 0 && gi >= 0 && bi >= 0;
    int extra = 3;
    for (int i = 0; i < c; ++i) {
      if (rgb && i == ri) dst_idx[i] = 0;
      else if (rgb && i == gi) dst_idx[i] = 1;
      else if (rgb && i == bi) dst_idx[i] = 2;
      else dst_idx[i] = rgb ? extra++ : i;
    }
    // generic channelN names: order output planes numerically so a
    // legacy unpadded writer's alphabetical header order (channel10
    // before channel2) still round-trips in channel-index order
    if (!rgb && c > 1) {
      std::vector<long> nums(c);
      bool generic = true;
      for (int i = 0; i < c && generic; ++i) {
        const std::string& nm = p.channels[i].name;
        if (nm.rfind("channel", 0) == 0 && nm.size() > 7 &&
            nm.find_first_not_of("0123456789", 7) == std::string::npos)
          nums[i] = std::stol(nm.substr(7));
        else
          generic = false;
      }
      if (generic) {
        for (int i = 0; i < c; ++i) {
          int rank = 0;
          for (int j = 0; j < c; ++j)
            if (nums[j] < nums[i]) ++rank;
          dst_idx[i] = rank;
        }
      }
    }
  }

  std::vector<uint8_t> raw(static_cast<size_t>(lines) * row_bytes);
  std::vector<uint8_t> tmp(raw.size());

  // the offset TABLE itself is file data: bound it before reading
  if (p.offsets_pos + 8ull * n_chunks > buf.size()) return -4;
  const uint8_t* table = buf.data() + p.offsets_pos;
  for (int ci = 0; ci < n_chunks; ++ci) {
    uint64_t off;
    std::memcpy(&off, table + 8ull * ci, 8);
    // non-wrapping form: `off + 8` overflows for off >= 2^64-8
    if (off > buf.size() || buf.size() - off < 8) return -4;
    int32_t y = get_i32(buf.data() + off) - p.y_min;
    if (y < 0 || y >= p.height) return -4;   // lying scanline base
    int32_t size = get_i32(buf.data() + off + 4);
    // file-supplied size: validate against the buffer before any decode
    // touches data (a truncated/corrupt file must return an error code
    // for the pure-Python fallback, not read out of bounds)
    if (size < 0 ||
        off + 8 + static_cast<uint64_t>(size) > buf.size())
      return -4;
    const uint8_t* data = buf.data() + off + 8;
    int y1 = y + lines < p.height ? y + lines : p.height;
    int nrows = y1 - y;
    size_t raw_size = static_cast<size_t>(nrows) * row_bytes;

    const uint8_t* rows = nullptr;
    if (static_cast<size_t>(size) >= raw_size) {
      rows = data;   // stored raw (NONE, or compression did not shrink)
    } else if (p.comp == NONE) {
      // a NONE chunk smaller than its row payload is truncation: the
      // unpack loop reads raw_size bytes, and only off+8+size was
      // bounds-checked — reading past `size` would leave the buffer
      return -5;
    } else if (p.comp == PIZ) {
      // parse payload
      if (size < 4) return -5;
      int min_nz = data[0] | (data[1] << 8);
      int max_nz = data[2] | (data[3] << 8);
      std::vector<uint8_t> bitmap(piz::kBitmapSize, 0);
      size_t pos = 4;
      if (min_nz <= max_nz) {
        if (max_nz >= piz::kBitmapSize ||
            pos + (max_nz - min_nz + 1) > static_cast<size_t>(size))
          return -5;
        std::memcpy(bitmap.data() + min_nz, data + pos,
                    max_nz - min_nz + 1);
        pos += max_nz - min_nz + 1;
      }
      if (pos + 4 > static_cast<size_t>(size)) return -5;
      int32_t hlen;
      std::memcpy(&hlen, data + pos, 4);
      pos += 4;
      if (hlen < 0 || pos + hlen > static_cast<size_t>(size)) return -5;

      const size_t total_shorts = raw_size / 2;
      std::vector<uint16_t> shorts(total_shorts);
      if (!piz::hufUncompress(data + pos, hlen, shorts.data(),
                              total_shorts))
        return -5;

      std::vector<uint16_t> rlut(piz::kUShortRange);
      uint16_t max_value = piz::reverseLutFromBitmap(bitmap.data(),
                                                     rlut.data());
      // wavelet decode per channel plane, then reverse LUT
      size_t plane_off = 0;
      for (int k = 0; k < c; ++k) {
        const int psize = pixel_size(p.channels[k].ptype) / 2;
        for (int j = 0; j < psize; ++j) {
          piz::wav2Decode(shorts.data() + plane_off + j, p.width, psize,
                          nrows, p.width * psize, max_value);
        }
        plane_off += static_cast<size_t>(nrows) * p.width * psize;
      }
      for (uint16_t& v : shorts) v = rlut[v];
      // re-interleave channel-major planes into scanline order
      raw.resize(raw_size);
      uint16_t* dst = reinterpret_cast<uint16_t*>(raw.data());
      size_t dpos = 0;
      std::vector<size_t> plane_base(c);
      {
        size_t off = 0;
        for (int k = 0; k < c; ++k) {
          plane_base[k] = off;
          off += static_cast<size_t>(nrows) * p.width *
                 (pixel_size(p.channels[k].ptype) / 2);
        }
      }
      for (int r = 0; r < nrows; ++r) {
        for (int k = 0; k < c; ++k) {
          const int psize = pixel_size(p.channels[k].ptype) / 2;
          const uint16_t* src = shorts.data() + plane_base[k] +
                                static_cast<size_t>(r) * p.width * psize;
          std::memcpy(dst + dpos, src,
                      static_cast<size_t>(p.width) * psize * 2);
          dpos += static_cast<size_t>(p.width) * psize;
        }
      }
      rows = raw.data();
    } else if (p.comp == ZIPS || p.comp == ZIP) {
      if (!zlib_inflate(data, size, tmp.data(), raw_size)) return -5;
      filter_decode(tmp.data(), raw_size, raw.data());
      rows = raw.data();
    } else if (p.comp == RLE) {
      std::vector<uint8_t> rle(raw_size);
      if (rle_decode(data, size, rle.data(), raw_size) != raw_size)
        return -5;
      std::memcpy(tmp.data(), rle.data(), raw_size);
      filter_decode(tmp.data(), raw_size, raw.data());
      rows = raw.data();
    } else {  // PXR24
      // inflate then unpack plane deltas straight to out
      std::vector<uint8_t> planes;
      planes.resize(raw_size);  // upper bound: 3 bytes/px <= 4 bytes/px
      size_t expect = 0;        // exact packed size: 3 B/px FLOAT, 2 HALF
      for (int k = 0; k < c; ++k)
        expect += static_cast<size_t>(p.width) *
                  (p.channels[k].ptype == FLOAT ? 3 : 2);
      expect *= static_cast<size_t>(nrows);
      uLongf plen = planes.size();
      if (uncompress(planes.data(), &plen, data, size) != Z_OK ||
          plen != static_cast<uLongf>(expect))
        return -5;
      size_t pos = 0;
      for (int yy = y; yy < y1; ++yy) {
        for (int k = 0; k < c; ++k) {
          float* drow = out +
              (static_cast<size_t>(yy) * p.width + 0) * c + dst_idx[k];
          if (p.channels[k].ptype == FLOAT) {
            const uint8_t* hi = planes.data() + pos;
            const uint8_t* mid = hi + p.width;
            const uint8_t* lo = mid + p.width;
            pos += static_cast<size_t>(p.width) * 3;
            uint32_t pix = 0;
            for (int x = 0; x < p.width; ++x) {
              uint32_t diff = (static_cast<uint32_t>(hi[x]) << 16) |
                              (static_cast<uint32_t>(mid[x]) << 8) | lo[x];
              pix = (pix + diff) & 0xFFFFFFu;
              drow[static_cast<size_t>(x) * c] = float24_to_float(pix);
            }
          } else {  // HALF
            const uint8_t* hi = planes.data() + pos;
            const uint8_t* lo = hi + p.width;
            pos += static_cast<size_t>(p.width) * 2;
            uint32_t pix = 0;
            for (int x = 0; x < p.width; ++x) {
              uint32_t diff = (static_cast<uint32_t>(hi[x]) << 8) | lo[x];
              pix = (pix + diff) & 0xFFFFu;
              drow[static_cast<size_t>(x) * c] =
                  half_to_float(static_cast<uint16_t>(pix));
            }
          }
        }
      }
      continue;
    }

    // unpack plain rows
    size_t pos2 = 0;
    for (int yy = y; yy < y1; ++yy) {
      for (int k = 0; k < c; ++k) {
        float* drow = out + (static_cast<size_t>(yy) * p.width) * c +
                      dst_idx[k];
        if (p.channels[k].ptype == HALF) {
          const uint16_t* src =
              reinterpret_cast<const uint16_t*>(rows + pos2);
          for (int x = 0; x < p.width; ++x)
            drow[static_cast<size_t>(x) * c] = half_to_float(src[x]);
          pos2 += static_cast<size_t>(p.width) * 2;
        } else {
          const float* src = reinterpret_cast<const float*>(rows + pos2);
          for (int x = 0; x < p.width; ++x)
            drow[static_cast<size_t>(x) * c] = src[x];
          pos2 += static_cast<size_t>(p.width) * 4;
        }
      }
    }
  }
  return 0;
  } catch (...) {
    return -99;   // corrupted input: error code, never a C++ abort
  }
}

}  // extern "C"
