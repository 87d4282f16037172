// Batch protobuf wire-format shredder for FLAT schemas (top-level scalar
// leaves only) — the C++ counterpart of the Python per-record proto parse +
// columnarize the reference funnels every record through
// (KafkaProtoParquetWriter.java:270 parser.parseFrom + ParquetFile.java:59-62
// ProtoWriteSupport shredding).  One call decodes a whole poll batch of
// serialized messages straight into columnar buffers, skipping Python
// message objects entirely.
//
// Scope: flat messages (no repeated / message / group / enum fields); the
// Python planner (kpw_tpu_torch/models/proto_bridge.py) only engages this path
// when the schema qualifies and falls back to the exact Python semantics
// otherwise, including per-record error policy — any record this decoder
// cannot prove clean (wire-type mismatch, truncated varint, missing proto2
// required field, invalid UTF-8 in a validated string) is reported by index
// and the batch is re-parsed in Python.
//
// Wire-format reference: the public protobuf encoding spec
// (varint / fixed64 / length-delimited / fixed32 tags, last-value-wins
// scalar merge, unknown-field skipping).

#include <cstdint>
#include <cstring>
#include <vector>

#include "wire_common.h"

namespace {

// field kinds (mirrored in kpw_tpu_torch/models/proto_bridge.py _WIRE_KINDS)
enum Kind : uint8_t {
  K_VARINT64 = 0,   // int64 / uint64 -> int64 slot (raw two's complement)
  K_VARINT32 = 1,   // int32 / uint32 -> int32 slot (low 32 bits)
  K_SINT64 = 2,     // zigzag -> int64
  K_SINT32 = 3,     // zigzag -> int32
  K_FIXED64 = 4,    // fixed64 / sfixed64 / double -> 8-byte slot
  K_FIXED32 = 5,    // fixed32 / sfixed32 / float -> 4-byte slot
  K_BOOL = 6,       // varint != 0 -> uint8 slot
  K_SPAN = 7,       // bytes / string: (pos, len) into the payload buffer
  K_SPAN_UTF8 = 8,  // string with UTF-8 validation (proto3 semantics)
};

enum Flags : uint8_t {
  F_REQUIRED = 1,  // proto2 required: absence is a record parse error
};

using kpw_wire::read_varint;
using kpw_wire::utf8_ok;

// record sources for the shared decode core: one contiguous buffer with an
// offsets table (the ctypes join path), or an iovec of per-record pointers
// (the zero-copy C-extension path, native/src/pyshred.cc — payload bytes
// objects are read in place, no join).  Span positions are relative to the
// source's per-record base so each path's gather knows how to resolve them.
struct ContigSrc {
  const uint8_t* buf;
  const int64_t* offs;
  inline void rec(int64_t r, const uint8_t** p, const uint8_t** end,
                  const uint8_t** base) const {
    *p = buf + offs[r];
    *end = buf + offs[r + 1];
    *base = buf;  // global positions, resolved by kpw_gather_spans
  }
};

struct IovSrc {
  const uint8_t* const* ptrs;
  const int64_t* lens;
  inline void rec(int64_t r, const uint8_t** p, const uint8_t** end,
                  const uint8_t** base) const {
    *p = ptrs[r];
    *end = ptrs[r] + lens[r];
    *base = ptrs[r];  // in-record positions, resolved with the record index
  }
};

// Decode n_rec serialized messages into per-field columnar outputs.
//
//   out_vals[f]: fixed-width target (n_rec slots of 1/4/8 bytes per Kind),
//                pre-zeroed by the caller (absent no-presence fields keep
//                proto defaults); NULL for span kinds.
//   out_pos[f]/out_len[f]: span targets (pos pre-filled with 0, len with 0 —
//                absent spans read back as empty); NULL for fixed kinds.
//   out_pres[f]: presence byte per record (pre-zeroed) or NULL when the
//                caller does not need presence (proto3 no-presence fields).
//
// Returns -1 on success, or the index of the first record that must take
// the Python fallback path (parse error / semantics this decoder does not
// model).  Outputs for preceding records are valid; the caller discards the
// batch on any error and re-parses in Python (errors are rare: poison
// pills).
template <typename Src>
int64_t shred_impl(const Src& src, int64_t n_rec, int32_t n_fields,
                   const uint32_t* fnum, const uint8_t* kind,
                   const uint8_t* flags, void* const* out_vals,
                   int64_t* const* out_pos, int32_t* const* out_len,
                   uint8_t* const* out_pres) {
  // direct-address field-number -> plan index table
  uint32_t max_fn = 0;
  for (int32_t f = 0; f < n_fields; f++)
    if (fnum[f] > max_fn) max_fn = fnum[f];
  if (max_fn > 65535) return -2;  // planner bug; never emitted for sane protos
  std::vector<int16_t> table(max_fn + 1, -1);
  for (int32_t f = 0; f < n_fields; f++) table[fnum[f]] = int16_t(f);

  bool any_required = false;
  for (int32_t f = 0; f < n_fields; f++)
    if (flags[f] & F_REQUIRED) any_required = true;
  std::vector<uint8_t> seen(any_required ? n_fields : 0);

  for (int64_t r = 0; r < n_rec; r++) {
    const uint8_t* p;
    const uint8_t* end;
    const uint8_t* base;
    src.rec(r, &p, &end, &base);
    if (any_required) std::memset(seen.data(), 0, seen.size());
    while (p < end) {
      uint64_t tag;
      if (!read_varint(p, end, &tag)) return r;
      uint32_t field = uint32_t(tag >> 3);
      uint32_t wire = uint32_t(tag & 7);
      if (field == 0) return r;  // invalid field number
      int16_t f = (field <= max_fn) ? table[field] : -1;
      if (f < 0) {
        // unknown field: skip by wire type (groups -> fallback)
        uint64_t v;
        switch (wire) {
          case 0:
            if (!read_varint(p, end, &v)) return r;
            break;
          case 1:
            if (end - p < 8) return r;
            p += 8;
            break;
          case 2:
            if (!read_varint(p, end, &v) || uint64_t(end - p) < v) return r;
            p += v;
            break;
          case 5:
            if (end - p < 4) return r;
            p += 4;
            break;
          default:
            return r;  // groups / reserved wire types
        }
        continue;
      }
      uint8_t k = kind[f];
      uint64_t v;
      switch (k) {
        case K_VARINT64:
        case K_VARINT32:
        case K_SINT64:
        case K_SINT32:
        case K_BOOL: {
          if (wire != 0) return r;  // mismatch: Python models the semantics
          if (!read_varint(p, end, &v)) return r;
          if (k == K_SINT64)
            reinterpret_cast<int64_t*>(out_vals[f])[r] =
                int64_t(v >> 1) ^ -int64_t(v & 1);
          else if (k == K_SINT32) {
            uint32_t u = uint32_t(v);
            reinterpret_cast<int32_t*>(out_vals[f])[r] =
                int32_t(u >> 1) ^ -int32_t(u & 1);
          } else if (k == K_VARINT64)
            reinterpret_cast<int64_t*>(out_vals[f])[r] = int64_t(v);
          else if (k == K_VARINT32)
            reinterpret_cast<int32_t*>(out_vals[f])[r] = int32_t(uint32_t(v));
          else
            reinterpret_cast<uint8_t*>(out_vals[f])[r] = v ? 1 : 0;
          break;
        }
        case K_FIXED64: {
          if (wire != 1 || end - p < 8) return r;
          std::memcpy(reinterpret_cast<uint8_t*>(out_vals[f]) + r * 8, p, 8);
          p += 8;
          break;
        }
        case K_FIXED32: {
          if (wire != 5 || end - p < 4) return r;
          std::memcpy(reinterpret_cast<uint8_t*>(out_vals[f]) + r * 4, p, 4);
          p += 4;
          break;
        }
        case K_SPAN:
        case K_SPAN_UTF8: {
          if (wire != 2) return r;
          if (!read_varint(p, end, &v) || uint64_t(end - p) < v) return r;
          if (k == K_SPAN_UTF8 && !utf8_ok(p, int64_t(v))) return r;
          out_pos[f][r] = p - base;
          out_len[f][r] = int32_t(v);
          p += v;
          break;
        }
        default:
          return r;
      }
      if (out_pres[f]) out_pres[f][r] = 1;
      if (any_required) seen[f] = 1;
    }
    if (any_required)
      for (int32_t f = 0; f < n_fields; f++)
        if ((flags[f] & F_REQUIRED) && !seen[f]) return r;  // missing required
  }
  return -1;
}

}  // namespace

extern "C" {

int64_t kpw_proto_shred(const uint8_t* buf, const int64_t* offs,
                        int64_t n_rec, int32_t n_fields,
                        const uint32_t* fnum, const uint8_t* kind,
                        const uint8_t* flags, void* const* out_vals,
                        int64_t* const* out_pos, int32_t* const* out_len,
                        uint8_t* const* out_pres) {
  return shred_impl(ContigSrc{buf, offs}, n_rec, n_fields, fnum, kind, flags,
                    out_vals, out_pos, out_len, out_pres);
}

// iovec variant: record r lives at [ptrs[r], ptrs[r] + lens[r]); span
// positions come back RELATIVE TO THE RECORD (resolve with
// kpw_gather_spans_iov).  The zero-copy entry used by the C extension.
int64_t kpw_proto_shred_iov(const uint8_t* const* ptrs, const int64_t* lens,
                            int64_t n_rec, int32_t n_fields,
                            const uint32_t* fnum, const uint8_t* kind,
                            const uint8_t* flags, void* const* out_vals,
                            int64_t* const* out_pos, int32_t* const* out_len,
                            uint8_t* const* out_pres) {
  return shred_impl(IovSrc{ptrs, lens}, n_rec, n_fields, fnum, kind, flags,
                    out_vals, out_pos, out_len, out_pres);
}

// Gather n spans (pos[i], len[i]) out of `src` back to back into `out`
// (caller sizes `out` as sum(len)).  The string-column assembly step after
// kpw_proto_shred.
void kpw_gather_spans(const uint8_t* src, const int64_t* pos,
                      const int32_t* len, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    std::memcpy(out, src + pos[i], size_t(len[i]));
    out += len[i];
  }
}

// iovec gather: span i is (pos[i], len[i]) within record rec_idx[i].
void kpw_gather_spans_iov(const uint8_t* const* ptrs, const int32_t* rec_idx,
                          const int64_t* pos, const int32_t* len, int64_t n,
                          uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    std::memcpy(out, ptrs[rec_idx[i]] + pos[i], size_t(len[i]));
    out += len[i];
  }
}

}  // extern "C"
