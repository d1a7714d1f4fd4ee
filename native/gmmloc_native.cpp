// Native runtime support library for gmmloc.
//
// Mirrors the native roles of the reference's C++ runtime that sit outside
// the device compute path (SURVEY.md §2): the varint-framed protobuf GMM map
// parser (ref: gmmloc/src/utils/protobuf_utils.cpp + gmm_utils.cpp
// loadGMMModel) and portable popcount Hamming kernels used as host-side
// fallbacks for the dataloader/bootstrap paths.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: g++ -O3 -march=native -shared -fPIC -o libgmmloc_native.so gmmloc_native.cpp

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// varint protobuf parsing (proto2 wire format, schema GMM.proto:5-21)
// ---------------------------------------------------------------------------

static int read_varint(const uint8_t* buf, size_t len, size_t* pos,
                       uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = buf[(*pos)++];
    result |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return 0;
    }
    shift += 7;
    if (shift > 63) return -1;
  }
  return -1;
}

// Parse a .gmm stream: varint count, then per component a varint-length
// message with fields {1: bool deg, 2: bool salient, 3: packed double
// mean[3], 4: packed double cov[9]}.
// Returns number of components parsed, or -1 on error.
int64_t gmm_parse(const uint8_t* buf, size_t len, double* means /* K*3 */,
                  double* covs /* K*9 */, uint8_t* deg, uint8_t* sal,
                  int64_t max_k) {
  size_t pos = 0;
  uint64_t count;
  if (read_varint(buf, len, &pos, &count)) return -1;
  if ((int64_t)count > max_k) return -1;

  for (uint64_t i = 0; i < count; i++) {
    uint64_t msg_len;
    if (read_varint(buf, len, &pos, &msg_len)) return -1;
    size_t end = pos + msg_len;
    if (end > len) return -1;
    deg[i] = 0;
    sal[i] = 0;
    while (pos < end) {
      uint64_t key;
      if (read_varint(buf, end, &pos, &key)) return -1;
      uint32_t field = key >> 3, wire = key & 7;
      if (field == 1 && wire == 0) {
        uint64_t v;
        if (read_varint(buf, end, &pos, &v)) return -1;
        deg[i] = (uint8_t)(v != 0);
      } else if (field == 2 && wire == 0) {
        uint64_t v;
        if (read_varint(buf, end, &pos, &v)) return -1;
        sal[i] = (uint8_t)(v != 0);
      } else if ((field == 3 || field == 4) && wire == 2) {
        uint64_t blen;
        if (read_varint(buf, end, &pos, &blen)) return -1;
        size_t n = blen / 8;
        double* dst = (field == 3) ? means + i * 3 : covs + i * 9;
        size_t cap = (field == 3) ? 3 : 9;
        if (n > cap || pos + blen > end) return -1;
        memcpy(dst, buf + pos, n * 8);
        pos += blen;
      } else {
        // skip unknown
        if (wire == 0) {
          uint64_t v;
          if (read_varint(buf, end, &pos, &v)) return -1;
        } else if (wire == 1) {
          pos += 8;
        } else if (wire == 2) {
          uint64_t blen;
          if (read_varint(buf, end, &pos, &blen)) return -1;
          pos += blen;
        } else if (wire == 5) {
          pos += 4;
        } else {
          return -1;
        }
      }
    }
  }
  return (int64_t)count;
}

static int write_varint_buf(uint8_t* buf, size_t cap, size_t* pos, uint64_t v) {
  while (true) {
    if (*pos >= cap) return -1;
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      buf[(*pos)++] = b | 0x80;
    } else {
      buf[(*pos)++] = b;
      return 0;
    }
  }
}

// Serialize components into the same stream format. Returns bytes written
// or -1 if the buffer is too small.
int64_t gmm_serialize(const double* means, const double* covs,
                      const uint8_t* deg, const uint8_t* sal, int64_t k,
                      uint8_t* out, size_t cap) {
  size_t pos = 0;
  if (write_varint_buf(out, cap, &pos, (uint64_t)k)) return -1;
  for (int64_t i = 0; i < k; i++) {
    // body: 2 bools (2*2 bytes max) + mean (2 + 1 + 24) + cov (2 + 1 + 72)
    uint8_t body[128];
    size_t bp = 0;
    write_varint_buf(body, sizeof body, &bp, (1 << 3) | 0);
    write_varint_buf(body, sizeof body, &bp, deg[i] ? 1 : 0);
    write_varint_buf(body, sizeof body, &bp, (2 << 3) | 0);
    write_varint_buf(body, sizeof body, &bp, sal[i] ? 1 : 0);
    write_varint_buf(body, sizeof body, &bp, (3 << 3) | 2);
    write_varint_buf(body, sizeof body, &bp, 24);
    memcpy(body + bp, means + i * 3, 24);
    bp += 24;
    write_varint_buf(body, sizeof body, &bp, (4 << 3) | 2);
    write_varint_buf(body, sizeof body, &bp, 72);
    memcpy(body + bp, covs + i * 9, 72);
    bp += 72;
    if (write_varint_buf(out, cap, &pos, bp)) return -1;
    if (pos + bp > cap) return -1;
    memcpy(out + pos, body, bp);
    pos += bp;
  }
  return (int64_t)pos;
}

// ---------------------------------------------------------------------------
// Hamming kernels (host fallback; ref: orb_matcher.cpp:580-594)
// ---------------------------------------------------------------------------

int hamming_32(const uint8_t* a, const uint8_t* b) {
  const uint64_t* pa = (const uint64_t*)a;
  const uint64_t* pb = (const uint64_t*)b;
  int d = 0;
  for (int i = 0; i < 4; i++) d += __builtin_popcountll(pa[i] ^ pb[i]);
  return d;
}

// (N,32) x (M,32) -> (N,M) int32 distances.
void hamming_matrix(const uint8_t* a, int64_t n, const uint8_t* b, int64_t m,
                    int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* ai = a + i * 32;
    int32_t* row = out + i * m;
    for (int64_t j = 0; j < m; j++) row[j] = hamming_32(ai, b + j * 32);
  }
}

}  // extern "C"
