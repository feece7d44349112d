// Host library of the PyTorch port: the PNG decoder, a threaded batch
// decoder, marching tetrahedra and a baseline JPEG encoder.
//
// The port's own copy of what the loaders and the mesh export need from the
// JAX package's native/trinerflet_native.cpp (tn_decode_png_file :111, the
// scanline unfiltering :82-98, the batch loader :132 and tn_marching_tets),
// so the port reads its scenes with no image library installed. It runs on
// the host; it is not a device kernel. Built with g++ at first use into
// build/native/ (trinerflet_tpu_torch/native/__init__.py) and bound with
// ctypes through a plain C interface.
//
// Differences from the JAX package's library: the batch decoder returns the
// images' 8-bit values (the caller converts and resizes them as cv2 would,
// data/images.py), the metrics are not copied (the port has its own,
// train/metrics.py), and the JPEG encoder is the port's own (the JAX
// package's viewer encodes its frames with cv2, which the card's host may
// lack).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

// Decode an in-memory 8-bit, non-interlaced grey / grey-alpha / RGB / RGBA
// PNG into out (capacity out_cap bytes), row-major with the file's channels.
// Returns 0 or a negative code: -1 not a PNG, -2 truncated, -3 bit depth or
// interlace not supported, -4 palette or unknown colour type, -5 inflate
// failed, -6 out too small, -7 unknown filter.
int decode_png(const uint8_t* data, size_t len, int* w, int* h, int* channels, uint8_t* out,
               size_t out_cap) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(data, sig, 8) != 0) return -1;
  size_t pos = 8;
  int width = 0, height = 0, colortype = -1;
  std::vector<uint8_t> idat;
  while (pos + 8 <= len) {
    const uint32_t clen = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + (size_t)clen > len) return -2;
    if (!memcmp(type, "IHDR", 4)) {
      width = (int)be32(body);
      height = (int)be32(body + 4);
      colortype = body[9];
      if (body[8] != 8 || body[12] != 0) return -3;
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + clen);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + (size_t)clen;
  }
  int ch;
  switch (colortype) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return -4;
  }
  const size_t stride = (size_t)width * ch;
  const size_t raw_len = (stride + 1) * height;
  std::vector<uint8_t> raw(raw_len);
  uLongf dst_len = raw_len;
  if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK || dst_len != raw_len)
    return -5;
  if (out_cap < stride * height) return -6;
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < height; y++) {
    const uint8_t* src = raw.data() + (size_t)y * (stride + 1);
    const uint8_t filter = src[0];
    uint8_t* dst = out + (size_t)y * stride;
    for (size_t x = 0; x < stride; x++) {
      const int a = x >= (size_t)ch ? dst[x - ch] : 0;
      const int b = prev[x];
      const int c = x >= (size_t)ch ? prev[x - ch] : 0;
      int v = src[1 + x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -7;
      }
      dst[x] = (uint8_t)v;
    }
    memcpy(prev.data(), dst, stride);
  }
  *w = width;
  *h = height;
  *channels = ch;
  return 0;
}

}  // namespace

extern "C" {

// One PNG file -> out. -10: the file cannot be opened, -11: read failed;
// otherwise decode_png's codes.
int tn_decode_png_file(const char* path, int* w, int* h, int* channels, uint8_t* out,
                       long out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  const long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz > 0 ? sz : 0);
  if (sz <= 0 || fread(buf.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    return -11;
  }
  fclose(f);
  return decode_png(buf.data(), (size_t)sz, w, h, channels, out, (size_t)out_cap);
}

// Decode num PNGs of one shape (H, W, ch) in parallel into out (num, H, W,
// ch) uint8. paths: NUL-separated strings. Returns 0, or the first failing
// file's code (-20: another shape or channel count) with its index in
// *bad.
int tn_decode_png_batch(const char* paths, int num, int H, int W, int ch, uint8_t* out,
                        int* bad) {
  std::vector<const char*> ptrs(num);
  const char* p = paths;
  for (int i = 0; i < num; i++) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  const size_t per = (size_t)H * W * ch;
  std::vector<int> codes(num, 0);
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < num; i++) {
    int w = 0, h = 0, c = 0;
    int rc = tn_decode_png_file(ptrs[i], &w, &h, &c, out + i * per, (long)per);
    if (rc == -6 || (rc == 0 && (w != W || h != H || c != ch))) rc = -20;
    codes[i] = rc;
  }
  for (int i = 0; i < num; i++)
    if (codes[i] != 0) {
      *bad = i;
      return codes[i];
    }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Marching tetrahedra (OpenMP): the 6-tet Kuhn decomposition of each cube
// and the case table of the JAX package's ops/meshing.py, so both give the
// same triangle soup up to order.
// ---------------------------------------------------------------------------

namespace mt {

// cube vertex id bits -> (x, y, z) offsets
const int kCubeOff[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                            {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};
const int kTets[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
                         {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};
// tet edge ids: 0:(0,1) 1:(0,2) 2:(0,3) 3:(1,2) 4:(1,3) 5:(2,3)
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

struct CaseTable {
  int ntris[16];
  int tris[16][2][3];  // up to 2 triangles of tet-edge ids
  CaseTable() {
    auto eid = [](int a, int b) {
      if (a > b) {
        const int t = a;
        a = b;
        b = t;
      }
      for (int i = 0; i < 6; i++)
        if (kTetEdges[i][0] == a && kTetEdges[i][1] == b) return i;
      return -1;
    };
    for (int m = 0; m < 16; m++) {
      int in[4], out[4], ni = 0, no = 0;
      for (int v = 0; v < 4; v++) (m >> v & 1) ? in[ni++] = v : out[no++] = v;
      ntris[m] = 0;
      if (ni == 1) {
        const int i = in[0];
        int* t = tris[m][0];
        t[0] = eid(i, out[0]);
        t[1] = eid(i, out[1]);
        t[2] = eid(i, out[2]);
        ntris[m] = 1;
      } else if (ni == 3) {
        const int o = out[0];
        int* t = tris[m][0];
        t[0] = eid(o, in[0]);
        t[1] = eid(o, in[2]);
        t[2] = eid(o, in[1]);
        ntris[m] = 1;
      } else if (ni == 2) {
        const int i = in[0], j = in[1], k = out[0], l = out[1];
        const int q0 = eid(i, k), q1 = eid(i, l), q2 = eid(j, l), q3 = eid(j, k);
        tris[m][0][0] = q0;
        tris[m][0][1] = q1;
        tris[m][0][2] = q2;
        tris[m][1][0] = q0;
        tris[m][1][1] = q2;
        tris[m][1][2] = q3;
        ntris[m] = 2;
      }
    }
  }
};
const CaseTable kCases;

// The triangles of one cube: writes up to 12 (9 floats each) into out when
// out != nullptr. Returns the triangle count.
inline int do_cube(const float* grid, int Y, int Z, int x, int y, int z, float thresh,
                   float* out) {
  float v[8], px[8], py[8], pz[8];
  for (int c = 0; c < 8; c++) {
    const int cx = x + kCubeOff[c][0], cy = y + kCubeOff[c][1], cz = z + kCubeOff[c][2];
    v[c] = grid[((long)cx * Y + cy) * Z + cz];
    px[c] = (float)cx;
    py[c] = (float)cy;
    pz[c] = (float)cz;
  }
  int n = 0;
  for (int t = 0; t < 6; t++) {
    const int* tet = kTets[t];
    int mask = 0;
    for (int c = 0; c < 4; c++) mask |= (v[tet[c]] > thresh) << c;
    const int nt = kCases.ntris[mask];
    if (out)
      for (int k = 0; k < nt; k++)
        for (int e = 0; e < 3; e++) {
          const int a = tet[kTetEdges[kCases.tris[mask][k][e]][0]];
          const int b = tet[kTetEdges[kCases.tris[mask][k][e]][1]];
          const float da = v[a], db = v[b];
          float denom = db - da;
          if (std::fabs(denom) < 1e-12f) denom = 1e-12f;
          float tt = (thresh - da) / denom;
          tt = tt < 0.f ? 0.f : (tt > 1.f ? 1.f : tt);
          float* o = out + (long)(n + k) * 9 + e * 3;
          o[0] = px[a] * (1 - tt) + px[b] * tt;
          o[1] = py[a] * (1 - tt) + py[b] * tt;
          o[2] = pz[a] * (1 - tt) + pz[b] * tt;
        }
    n += nt;
  }
  return n;
}

}  // namespace mt

// Marching tetrahedra over an (X, Y, Z) float grid. out == nullptr: returns
// the triangle count. Otherwise writes up to cap_tris triangles (n, 3
// vertices, 3 floats) at origin + grid index * spacing and returns the
// number written.
extern "C" long tn_marching_tets(const float* grid, int X, int Y, int Z, float thresh, float ox,
                                 float oy, float oz, float spacing, float* out, long cap_tris) {
  const int cx = X - 1, cy = Y - 1, cz = Z - 1;
  if (cx <= 0 || cy <= 0 || cz <= 0) return 0;
  std::vector<long> slab_counts(cx, 0);
#pragma omp parallel for schedule(dynamic, 1)
  for (int x = 0; x < cx; x++) {
    long c = 0;
    for (int y = 0; y < cy; y++)
      for (int z = 0; z < cz; z++) c += mt::do_cube(grid, Y, Z, x, y, z, thresh, nullptr);
    slab_counts[x] = c;
  }
  std::vector<long> offsets(cx + 1, 0);
  for (int x = 0; x < cx; x++) offsets[x + 1] = offsets[x] + slab_counts[x];
  const long total = offsets[cx];
  if (!out) return total;
#pragma omp parallel for schedule(dynamic, 1)
  for (int x = 0; x < cx; x++) {
    long w = offsets[x];
    float scratch[12 * 9];  // a cube emits at most 12 triangles
    for (int y = 0; y < cy; y++)
      for (int z = 0; z < cz; z++) {
        if (w >= cap_tris) break;
        const long room = cap_tris - w;
        const int n = mt::do_cube(grid, Y, Z, x, y, z, thresh, scratch);
        const long take = n < room ? n : room;
        std::memcpy(out + w * 9, scratch, (size_t)take * 9 * sizeof(float));
        w += take;
      }
  }
  const long written = total < cap_tris ? total : cap_tris;
#pragma omp parallel for
  for (long i = 0; i < written * 3; i++) {
    out[i * 3 + 0] = ox + out[i * 3 + 0] * spacing;
    out[i * 3 + 1] = oy + out[i * 3 + 1] * spacing;
    out[i * 3 + 2] = oz + out[i * 3 + 2] * spacing;
  }
  return written;
}

// ---------------------------------------------------------------------------
// Baseline JPEG encoder (the HTTP viewer's frames, utils/gui.py): JFIF,
// YCbCr 4:2:0 (one MCU = four 8x8 Y blocks, one Cb, one Cr over 16x16
// pixels), the ITU-T T.81 Annex K quantisation tables scaled to the quality
// the IJG way (scale 5000 / q below 50, else 200 - 2q; entries
// (base * scale + 50) / 100 clamped to [1, 255]), a separable float DCT,
// quantisation rounded half away from zero, and the Annex K Huffman tables.
// Edges are padded by repeating the last row and column; chroma is the mean
// of each 2x2 block. The bytes differ from libjpeg's (which uses an integer
// DCT and other rounding); a decoder reads both.
// ---------------------------------------------------------------------------

namespace jpg {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 and K.2, natural (row-major) order
const uint8_t kLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                           14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                           18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChrQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                           24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                           99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                           99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts by length (1..16), then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
  uint16_t code[256];
  uint8_t size[256];
};

// Annex C: canonical codes from the counts by length
void build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  std::memset(h, 0, sizeof(Huff));
  int k = 0;
  uint16_t code = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < bits[len - 1]; i++, k++) {
      h->code[vals[k]] = code++;
      h->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int n = 0;  // bits held in acc
  void put(uint32_t bits, int len) {
    acc = (acc << len) | (bits & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      const uint8_t b = (uint8_t)(acc >> (n - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0x00);  // byte stuffing
      n -= 8;
    }
  }
  void flush() {  // pad the last byte with ones
    if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
  }
};

int category(int v) {
  int a = v < 0 ? -v : v, c = 0;
  while (a) {
    c++;
    a >>= 1;
  }
  return c;
}

struct Encoder {
  float cosv[8][8];  // C(u) / 2 * cos((2x + 1) u pi / 16)
  int q[2][64];       // natural order
  Huff dc[2], ac[2];

  explicit Encoder(int quality) {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        cosv[u][x] = (float)((u == 0 ? std::sqrt(0.5) : 1.0) * 0.5 *
                             std::cos((2 * x + 1) * u * M_PI / 16.0));
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    const long scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    for (int i = 0; i < 64; i++) {
      long a = (kLumQ[i] * scale + 50) / 100, b = (kChrQ[i] * scale + 50) / 100;
      q[0][i] = (int)(a < 1 ? 1 : a > 255 ? 255 : a);
      q[1][i] = (int)(b < 1 ? 1 : b > 255 ? 255 : b);
    }
    build_huff(kDcLumBits, kDcVals, &dc[0]);
    build_huff(kDcChrBits, kDcVals, &dc[1]);
    build_huff(kAcLumBits, kAcLumVals, &ac[0]);
    build_huff(kAcChrBits, kAcChrVals, &ac[1]);
  }

  // One level-shifted 8x8 block (row-major) -> its quantised coefficients
  // in zigzag order.
  void quantise(const float* px, int t, int* coef) const {
    float tmp[8][8];
    for (int y = 0; y < 8; y++)  // rows first
      for (int u = 0; u < 8; u++) {
        float s = 0.0f;
        for (int x = 0; x < 8; x++) s += cosv[u][x] * px[y * 8 + x];
        tmp[y][u] = s;
      }
    int nat[64];
    for (int v = 0; v < 8; v++)
      for (int u = 0; u < 8; u++) {
        float s = 0.0f;
        for (int y = 0; y < 8; y++) s += cosv[v][y] * tmp[y][u];
        const float r = s / (float)q[t][v * 8 + u];
        nat[v * 8 + u] = (int)(r < 0 ? -std::floor(-r + 0.5f) : std::floor(r + 0.5f));
      }
    for (int i = 0; i < 64; i++) coef[i] = nat[kZigzag[i]];
  }

  // One block's coefficients -> entropy-coded bits; returns its DC for the
  // next block's difference.
  int code(const int* coef, int t, int prev_dc, BitWriter* bw) const {
    int diff = coef[0] - prev_dc;
    if (diff > 2047) diff = 2047;
    if (diff < -2047) diff = -2047;
    int c = category(diff);
    bw->put(dc[t].code[c], dc[t].size[c]);
    if (c) bw->put(diff < 0 ? diff + (1 << c) - 1 : diff, c);
    int run = 0;
    for (int i = 1; i < 64; i++) {
      int v = coef[i];
      if (v > 1023) v = 1023;
      if (v < -1023) v = -1023;
      if (v == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        bw->put(ac[t].code[0xF0], ac[t].size[0xF0]);
        run -= 16;
      }
      c = category(v);
      const int sym = (run << 4) | c;
      bw->put(ac[t].code[sym], ac[t].size[sym]);
      bw->put(v < 0 ? v + (1 << c) - 1 : v, c);
      run = 0;
    }
    if (run) bw->put(ac[t].code[0x00], ac[t].size[0x00]);
    return prev_dc + diff;
  }
};

void u16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  u16(o, 2 + 1 + 16 + n);
  o.push_back((uint8_t)cls_id);
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

}  // namespace jpg

// Encode an (H, W, 3) uint8 RGB image as a baseline JPEG at ``quality``
// into out (capacity cap bytes). Returns the size, or minus the size when
// cap is too small (nothing is written then), or -1 for a bad shape.
extern "C" long tn_encode_jpeg(const uint8_t* rgb, int H, int W, int quality, uint8_t* out,
                               long cap) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535) return -1;
  const jpg::Encoder enc(quality);
  std::vector<uint8_t> o;
  o.reserve((size_t)H * W / 2 + 1024);
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                              0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
  for (int t = 0; t < 2; t++) {  // DQT, zigzag order
    o.push_back(0xFF);
    o.push_back(0xDB);
    jpg::u16(o, 67);
    o.push_back((uint8_t)t);
    for (int i = 0; i < 64; i++) o.push_back((uint8_t)enc.q[t][jpg::kZigzag[i]]);
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 17, 8, (uint8_t)(H >> 8), (uint8_t)(H & 0xFF),
                         (uint8_t)(W >> 8), (uint8_t)(W & 0xFF), 3, 1, 0x22, 0, 2, 0x11, 1,
                         3, 0x11, 1};
  o.insert(o.end(), sof, sof + sizeof(sof));
  jpg::dht(o, 0x00, jpg::kDcLumBits, jpg::kDcVals);
  jpg::dht(o, 0x10, jpg::kAcLumBits, jpg::kAcLumVals);
  jpg::dht(o, 0x01, jpg::kDcChrBits, jpg::kDcVals);
  jpg::dht(o, 0x11, jpg::kAcChrBits, jpg::kAcChrVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof(sos));

  // the DCT and quantisation of every MCU in parallel (six blocks each:
  // Y00, Y01, Y10, Y11, Cb, Cr), then the entropy coding in order
  const int mh = (H + 15) / 16, mw = (W + 15) / 16;
  std::vector<int> coefs((size_t)mh * mw * 6 * 64);
#pragma omp parallel for schedule(static)
  for (int m = 0; m < mh * mw; m++) {
    const int my = (m / mw) * 16, mx = (m % mw) * 16;
    float Y[4][64], Cb[64], Cr[64], cb[16][16], cr[16][16];
    for (int dy = 0; dy < 16; dy++)
      for (int dx = 0; dx < 16; dx++) {
        const int y = my + dy < H ? my + dy : H - 1, x = mx + dx < W ? mx + dx : W - 1;
        const uint8_t* p = rgb + ((size_t)y * W + x) * 3;
        const float r = p[0], g = p[1], b = p[2];
        Y[(dy >> 3) * 2 + (dx >> 3)][(dy & 7) * 8 + (dx & 7)] =
            0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
        cb[dy][dx] = -0.168736f * r - 0.331264f * g + 0.5f * b;
        cr[dy][dx] = 0.5f * r - 0.418688f * g - 0.081312f * b;
      }
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) {
        Cb[y * 8 + x] = 0.25f * (cb[2 * y][2 * x] + cb[2 * y][2 * x + 1] + cb[2 * y + 1][2 * x] +
                                 cb[2 * y + 1][2 * x + 1]);
        Cr[y * 8 + x] = 0.25f * (cr[2 * y][2 * x] + cr[2 * y][2 * x + 1] + cr[2 * y + 1][2 * x] +
                                 cr[2 * y + 1][2 * x + 1]);
      }
    int* c = coefs.data() + (size_t)m * 6 * 64;
    for (int b = 0; b < 4; b++) enc.quantise(Y[b], 0, c + b * 64);
    enc.quantise(Cb, 1, c + 4 * 64);
    enc.quantise(Cr, 1, c + 5 * 64);
  }
  jpg::BitWriter bw;
  bw.out = &o;
  int pred[3] = {0, 0, 0};
  for (int m = 0; m < mh * mw; m++) {
    const int* c = coefs.data() + (size_t)m * 6 * 64;
    for (int b = 0; b < 4; b++) pred[0] = enc.code(c + b * 64, 0, pred[0], &bw);
    pred[1] = enc.code(c + 4 * 64, 1, pred[1], &bw);
    pred[2] = enc.code(c + 5 * 64, 1, pred[2], &bw);
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  const long n = (long)o.size();
  if (n > cap) return -n;
  std::memcpy(out, o.data(), (size_t)n);
  return n;
}
