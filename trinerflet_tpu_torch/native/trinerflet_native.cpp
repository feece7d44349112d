// Host library of the PyTorch port: the PNG decoder, a threaded batch
// decoder and marching tetrahedra.
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
// data/images.py), and the metrics are not copied (the port has its own,
// train/metrics.py).

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
