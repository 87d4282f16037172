// Shared protobuf wire-format parsing primitives for the flat (shred.cc)
// and nested (shred_nested.cc) batch shredders.  ONE definition for the
// security-sensitive pieces — varint bounds handling and strict UTF-8
// validation (overlong / surrogate / out-of-range rejection, proto3 string
// semantics) — so the two decode paths can never diverge on the same input.
#ifndef KPW_WIRE_COMMON_H_
#define KPW_WIRE_COMMON_H_

#include <cstdint>

namespace kpw_wire {

inline bool read_varint(const uint8_t*& p, const uint8_t* end,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;  // truncated or > 10 bytes
}

inline bool utf8_ok(const uint8_t* s, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) {
      i++;
      continue;
    }
    int extra;
    uint32_t cp;
    if ((c & 0xe0) == 0xc0) {
      extra = 1;
      cp = c & 0x1f;
    } else if ((c & 0xf0) == 0xe0) {
      extra = 2;
      cp = c & 0x0f;
    } else if ((c & 0xf8) == 0xf0) {
      extra = 3;
      cp = c & 0x07;
    } else {
      return false;
    }
    if (i + extra >= n) return false;
    for (int k = 1; k <= extra; k++) {
      uint8_t cc = s[i + k];
      if ((cc & 0xc0) != 0x80) return false;
      cp = (cp << 6) | (cc & 0x3f);
    }
    // overlong / surrogate / out-of-range rejection
    if (extra == 1 && cp < 0x80) return false;
    if (extra == 2 && (cp < 0x800 || (cp >= 0xd800 && cp <= 0xdfff)))
      return false;
    if (extra == 3 && (cp < 0x10000 || cp > 0x10ffff)) return false;
    i += 1 + extra;
  }
  return true;
}

}  // namespace kpw_wire

#endif  // KPW_WIRE_COMMON_H_
