// CPython extension: nogil batch page assembly from a lowered plan.
//
// EncodedChunk.parts is the writev-style interface between the encoder and
// the sink.  This module takes the per-page assembly loop in
// CpuChunkEncoder.encode, which is bound by the interpreter lock when run
// from several assembly threads, behind a nogil boundary.  The Python side
// lowers a chunk's fully resolved page plan into flat int64 tables (pages +
// ops) over a tuple of buffers; this entry point then, with the GIL RELEASED:
//
//   * gathers each page's body parts (RAW ops) and/or RLE/bit-pack
//     encodes value-index and level streams in place (RLE ops,
//     kpw_rle_hybrid_u32 from encode.cc — the same object code the
//     ctypes path runs, so the streams cannot drift),
//   * optionally compresses the body (snappy / zstd via codecs.cc — the
//     same dispatch the ctypes scratch path uses, so frames are
//     byte-identical per host),
//   * optionally CRCs the on-wire body (standard CRC-32, gzip polynomial
//     0xEDB88320, PARQUET-1539 — bit-for-bit zlib.crc32),
//   * emits each page header from Python-provided thrift fragments
//     (prefix .. [uncompressed varint] 0x15 [compressed varint]
//     [0x15 [crc varint]] .. suffix),
//   * computes per-page min/max stats for fixed-width value slices (the
//     page-index pass that anti-scaled under the GIL: many ~20 us numpy
//     reductions thrash the GIL handoff at 2 threads).
//
// One call per column chunk returns the finished chunk buffer; the shared
// assembly pool (core/pages.py) runs one call per column, so columns
// finally shard across real cores.
//
// Contract (enforced before the GIL is released):
// malformed tables — out-of-range buffer indices, non-ascending or
// out-of-bounds ranges, bad widths/modes/kinds/flags — raise ValueError.
// The nogil loop never reads outside a validated range.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
// encode.cc (compiled into this .so — same source as the ctypes library)
size_t kpw_rle_hybrid_cap(size_t n, int width);
int kpw_rle_hybrid_u32(const uint32_t* v, size_t n, int width, uint8_t* out,
                       size_t* out_len);
int kpw_rle_hybrid_from_runs_u32(const uint32_t* run_vals,
                                 const int32_t* run_lens, size_t n_runs,
                                 int width, uint8_t* out, size_t* out_len);
int kpw_byte_stream_split(const uint8_t* in, size_t n, size_t width,
                          uint8_t* out);
// codecs.cc
size_t kpw_snappy_max_compressed_length(size_t n);
int kpw_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                        size_t* out_len);
#ifndef KPW_NO_ZSTD
size_t kpw_zstd_max_compressed_length(size_t n);
int kpw_zstd_compress(const uint8_t* in, size_t n, uint8_t* out,
                      size_t out_cap, size_t* out_len, int level);
#endif
}

namespace {

// -- table layout (mirrored by the core/pages.py lowering) -------------------
constexpr int kPageStride = 7;  // op_start, op_end, prefix, suffix, flags, va, vb
constexpr int kOpStride = 5;    // kind, buf, a, b, aux
constexpr int64_t kOpRaw = 0;   // bytes buffers[buf][a:b)
constexpr int64_t kOpRle = 1;   // u32 elements [a:b); aux = width | mode << 8
// RLE/bit-pack replay from a PRECOMPUTED run table (the device level
// planner's compact output, ops/levels.py): run values u32 in
// buffers[buf][a:b), run lengths i32 in buffers[aux >> 16][a:b);
// aux = width | mode << 8 | lens_buf << 16.  Byte-identical to
// core.encodings.rle_hybrid_from_runs (kpw_rle_hybrid_from_runs_u32,
// encode.cc) — the O(runs) host Python replay, moved behind the nogil
// boundary.
constexpr int64_t kOpRleRuns = 2;
// BYTE_ARRAY PLAIN assembly straight from the packed ByteColumn
// representation: values are elements [a:b) of the int64 offset table in
// buffers[aux >> 16] (absolute into the data buffer buffers[buf]); each
// emits a 4-byte LE length + the raw bytes — byte-identical to
// core.encodings.byte_array_plain_encode.  Offset CONTENT is snapshotted
// and bounds-checked at execution (it lives in a caller-mutable numpy
// array); a bad table raises ValueError, never an OOB read.
constexpr int64_t kOpBytesPlain = 3;
// BYTE_STREAM_SPLIT straight from the contiguous value buffer:
// elements [a:b) of buffers[buf], aux = value width in bytes (4 or 8),
// transposed into their byte planes inside the nogil call — byte-identical
// to core.encodings.byte_stream_split_encode via kpw_byte_stream_split
// (encode.cc, the same object code the ctypes path runs).
constexpr int64_t kOpBss = 4;
constexpr int64_t kModeBare = 0;
constexpr int64_t kModeWidthByte = 1;  // 1-byte bit width prefix (dict bodies)
constexpr int64_t kModeLen32 = 2;      // u32 LE length prefix (v1 level streams)
constexpr int64_t kFlagCrc = 1;
// stats dtype codes (0 = no native stats for this chunk)
enum StatsDtype { kStatsNone = 0, kStatsI32, kStatsI64, kStatsU32, kStatsU64,
                  kStatsF32, kStatsF64, kStatsU8 };
// out_mask values
constexpr uint8_t kStatUndefined = 0;   // empty page / all-NaN
constexpr uint8_t kStatDefined = 1;
constexpr uint8_t kStatAmbiguousZero = 2;  // +-0.0 tie: caller re-derives

// -- CRC-32 (gzip polynomial, reflected — zlib.crc32 semantics) -------------
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

inline uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32Table table;
  crc = ~crc;
  for (size_t i = 0; i < n; i++)
    crc = table.t[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// -- thrift compact varints -------------------------------------------------
inline void emit_varint(std::vector<uint8_t>& out, uint32_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

inline void emit_zigzag_i32(std::vector<uint8_t>& out, int32_t v) {
  emit_varint(out, (static_cast<uint32_t>(v) << 1)
                       ^ static_cast<uint32_t>(v >> 31));
}

// -- per-page min/max over a fixed-width value slice ------------------------
template <typename T>
uint8_t stats_int(const uint8_t* base, int64_t va, int64_t vb, uint8_t* lo_out,
                  uint8_t* hi_out) {
  if (vb <= va) return kStatUndefined;
  const T* v = reinterpret_cast<const T*>(base);
  T lo = v[va], hi = v[va];
  for (int64_t i = va + 1; i < vb; i++) {
    T x = v[i];
    if (x < lo) lo = x;
    if (x > hi) hi = x;
  }
  std::memcpy(lo_out, &lo, sizeof(T));
  std::memcpy(hi_out, &hi, sizeof(T));
  return kStatDefined;
}

template <typename T>
uint8_t stats_float(const uint8_t* base, int64_t va, int64_t vb,
                    uint8_t* lo_out, uint8_t* hi_out) {
  const T* v = reinterpret_cast<const T*>(base);
  bool any = false, zero_pos = false, zero_neg = false;
  T lo = T(0), hi = T(0);
  for (int64_t i = va; i < vb; i++) {
    T x = v[i];
    if (x != x) continue;  // NaN: the oracle masks them out
    if (x == T(0)) {
      // record both signed zeros: if min or max lands on 0.0 with both
      // signs present, numpy's SIMD lane order decides which sign wins —
      // report ambiguous and let the caller run the numpy oracle
      uint8_t top;
      std::memcpy(&top, reinterpret_cast<const uint8_t*>(&x) + sizeof(T) - 1,
                  1);
      (top & 0x80 ? zero_neg : zero_pos) = true;
    }
    if (!any) {
      lo = hi = x;
      any = true;
    } else {
      if (x < lo) lo = x;
      if (x > hi) hi = x;
    }
  }
  if (!any) return kStatUndefined;
  if ((lo == T(0) || hi == T(0)) && zero_pos && zero_neg)
    return kStatAmbiguousZero;
  std::memcpy(lo_out, &lo, sizeof(T));
  std::memcpy(hi_out, &hi, sizeof(T));
  return kStatDefined;
}

struct BufferSet {
  std::vector<Py_buffer> views;
  ~BufferSet() {
    for (auto& v : views) PyBuffer_Release(&v);
  }
  bool get(PyObject* obj, int flags = PyBUF_SIMPLE) {
    Py_buffer v;
    if (PyObject_GetBuffer(obj, &v, flags) != 0) return false;
    views.push_back(v);
    return true;
  }
};

bool fail_value(const char* msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return false;
}

// assemble_pages(buffers: tuple, page_tab, op_tab, codec, level,
//                values_or_None, stats_dtype, out_meta, out_stats_or_None,
//                out_mask_or_None) -> bytes
//
// page_tab: int64 (n_pages, 7); op_tab: int64 (n_ops, 5);
// out_meta: writable int64 (n_pages, 3) — [uncompressed_body_len,
// compressed_body_len, header_len] per page; out_stats: writable
// (n_pages, 2) of the values dtype; out_mask: writable uint8 (n_pages,).
PyObject* py_assemble_pages(PyObject*, PyObject* args) {
  PyObject *bufs_t, *pages_o, *ops_o, *values_o, *meta_o, *stats_o, *mask_o;
  int codec, level, sdt;
  if (!PyArg_ParseTuple(args, "O!OOiiOiOOO", &PyTuple_Type, &bufs_t, &pages_o,
                        &ops_o, &codec, &level, &values_o, &sdt, &meta_o,
                        &stats_o, &mask_o))
    return nullptr;

  const Py_ssize_t n_bufs = PyTuple_GET_SIZE(bufs_t);
  BufferSet bufs;
  for (Py_ssize_t i = 0; i < n_bufs; i++)
    if (!bufs.get(PyTuple_GET_ITEM(bufs_t, i))) return nullptr;

  BufferSet tabs;
  if (!tabs.get(pages_o) || !tabs.get(ops_o)) return nullptr;
  const Py_buffer& pv = tabs.views[0];
  const Py_buffer& ov = tabs.views[1];
  if (pv.len % (8 * kPageStride) != 0 || ov.len % (8 * kOpStride) != 0)
    return fail_value("page/op tables must be int64 with full rows"), nullptr;
  const int64_t* pages = static_cast<const int64_t*>(pv.buf);
  const int64_t* ops = static_cast<const int64_t*>(ov.buf);
  const int64_t n_pages = pv.len / (8 * kPageStride);
  const int64_t n_ops = ov.len / (8 * kOpStride);

  // Snapshot both tables BEFORE validation: the GIL is released during
  // assembly, so a concurrent Python thread could mutate the caller's
  // numpy arrays between the bounds checks and their use — validate and
  // execute against this immutable copy so "never reads outside a
  // validated range" holds unconditionally.  (Buffer CONTENT mutation
  // can still corrupt output bytes, but never memory safety: every
  // bound comes from the snapshot and Py_buffer pins the allocations.)
  std::vector<int64_t> page_snap, op_snap;
  try {
    page_snap.assign(pages, pages + n_pages * kPageStride);
    op_snap.assign(ops, ops + n_ops * kOpStride);
  } catch (const std::bad_alloc&) {
    return PyErr_NoMemory();
  }
  pages = page_snap.data();
  ops = op_snap.data();

#ifndef KPW_NO_ZSTD
  const bool zstd_ok = true;
#else
  const bool zstd_ok = false;
#endif
  if (!(codec == 0 || codec == 1 || (codec == 6 && zstd_ok)))
    return fail_value("unsupported codec for native assembly"), nullptr;

  // values buffer for native stats
  const uint8_t* vbase = nullptr;
  int64_t n_values = 0;
  size_t vsize = 0;
  switch (sdt) {
    case kStatsNone: break;
    case kStatsI32: case kStatsU32: case kStatsF32: vsize = 4; break;
    case kStatsI64: case kStatsU64: case kStatsF64: vsize = 8; break;
    case kStatsU8: vsize = 1; break;
    default: return fail_value("unknown stats dtype code"), nullptr;
  }
  BufferSet vbufs;
  if (sdt != kStatsNone) {
    if (values_o == Py_None)
      return fail_value("stats dtype set but values buffer is None"), nullptr;
    if (!vbufs.get(values_o)) return nullptr;
    vbase = static_cast<const uint8_t*>(vbufs.views[0].buf);
    n_values = vbufs.views[0].len / static_cast<int64_t>(vsize);
  }

  // writable outputs
  BufferSet outs;
  if (!outs.get(meta_o, PyBUF_WRITABLE)) return nullptr;
  if (outs.views[0].len != n_pages * 3 * 8)
    return fail_value("out_meta must be int64 (n_pages, 3)"), nullptr;
  int64_t* out_meta = static_cast<int64_t*>(outs.views[0].buf);
  uint8_t* out_stats = nullptr;
  uint8_t* out_mask = nullptr;
  if (sdt != kStatsNone) {
    if (stats_o == Py_None || mask_o == Py_None)
      return fail_value("stats dtype set but out_stats/out_mask is None"),
             nullptr;
    if (!outs.get(stats_o, PyBUF_WRITABLE) ||
        !outs.get(mask_o, PyBUF_WRITABLE))
      return nullptr;
    if (outs.views[1].len != n_pages * 2 * static_cast<int64_t>(vsize))
      return fail_value("out_stats must be (n_pages, 2) of the values dtype"),
             nullptr;
    if (outs.views[2].len != n_pages)
      return fail_value("out_mask must be uint8 (n_pages,)"), nullptr;
    out_stats = static_cast<uint8_t*>(outs.views[1].buf);
    out_mask = static_cast<uint8_t*>(outs.views[2].buf);
  }

  // -- validate every table entry BEFORE the GIL is released ---------------
  size_t cap = 0;  // worst-case output size (reserve hint only)
  for (int64_t p = 0; p < n_pages; p++) {
    const int64_t* pg = pages + p * kPageStride;
    const int64_t op_start = pg[0], op_end = pg[1];
    const int64_t prefix = pg[2], suffix = pg[3];
    const int64_t flags = pg[4], va = pg[5], vb = pg[6];
    if (op_start < 0 || op_end < op_start || op_end > n_ops)
      return fail_value("page op range out of bounds"), nullptr;
    if (prefix < 0 || prefix >= n_bufs || suffix < 0 || suffix >= n_bufs)
      return fail_value("page prefix/suffix buffer index out of range"),
             nullptr;
    if (flags & ~kFlagCrc)
      return fail_value("unknown page flags"), nullptr;
    if (sdt != kStatsNone && (va < 0 || vb < va || vb > n_values))
      return fail_value("page stats range out of values bounds"), nullptr;
    size_t body_cap = 0;
    for (int64_t o = op_start; o < op_end; o++) {
      const int64_t* op = ops + o * kOpStride;
      const int64_t kind = op[0], b_idx = op[1], a = op[2], b = op[3];
      const int64_t aux = op[4];
      if (b_idx < 0 || b_idx >= n_bufs)
        return fail_value("op buffer index out of range"), nullptr;
      const Py_buffer& view = bufs.views[b_idx];
      if (kind == kOpRaw) {
        if (a < 0 || b < a || b > view.len)
          return fail_value("raw op range out of buffer bounds"), nullptr;
        body_cap += static_cast<size_t>(b - a);
      } else if (kind == kOpRle) {
        const int64_t elems = view.len / 4;
        const int64_t width = aux & 0xFF, mode = (aux >> 8) & 0xFF;
        if (a < 0 || b < a || b > elems)
          return fail_value("rle op range out of buffer bounds"), nullptr;
        if (width < 0 || width > 32)
          return fail_value("rle width out of range"), nullptr;
        if (mode != kModeBare && mode != kModeWidthByte && mode != kModeLen32)
          return fail_value("unknown rle mode"), nullptr;
        if (aux >> 16)
          return fail_value("rle aux bits out of range"), nullptr;
        body_cap += kpw_rle_hybrid_cap(static_cast<size_t>(b - a),
                                       static_cast<int>(width)) + 5;
      } else if (kind == kOpRleRuns) {
        const int64_t elems = view.len / 4;
        const int64_t width = aux & 0xFF, mode = (aux >> 8) & 0xFF;
        const int64_t lens_buf = aux >> 16;
        if (a < 0 || b < a || b > elems)
          return fail_value("runs op range out of vals buffer bounds"),
                 nullptr;
        if (width < 1 || width > 32)
          return fail_value("runs width out of range"), nullptr;
        if (mode != kModeBare && mode != kModeWidthByte && mode != kModeLen32)
          return fail_value("unknown rle mode"), nullptr;
        if (lens_buf < 0 || lens_buf >= n_bufs)
          return fail_value("runs lens buffer index out of range"), nullptr;
        if (b > bufs.views[lens_buf].len / 4)
          return fail_value("runs op range out of lens buffer bounds"),
                 nullptr;
        // body size depends on run CONTENT (summed at execution from a
        // snapshot); contributes only the prefix bound here — the
        // emitted body is re-checked against the thrift i32 ceiling
        // after assembly
        body_cap += 5;
      } else if (kind == kOpBytesPlain) {
        const int64_t offs_buf = aux >> 16;
        if (aux & 0xFFFF)
          return fail_value("bytes-plain aux low bits must be zero"),
                 nullptr;
        if (offs_buf < 0 || offs_buf >= n_bufs)
          return fail_value("bytes-plain offsets buffer index out of range"),
                 nullptr;
        const int64_t offs_elems = bufs.views[offs_buf].len / 8;
        if (a < 0 || b < a || b + 1 > offs_elems)
          return fail_value("bytes-plain range out of offsets bounds"),
                 nullptr;
        // payload size depends on offset CONTENT (snapshotted + bounds-
        // checked at execution); length prefixes are bounded here
        body_cap += static_cast<size_t>(b - a) * 4;
      } else if (kind == kOpBss) {
        const int64_t width = aux;
        if (width != 4 && width != 8)
          return fail_value("bss op width must be 4 or 8"), nullptr;
        if (a < 0 || b < a || b > view.len / width)
          return fail_value("bss op range out of buffer bounds"), nullptr;
        body_cap += static_cast<size_t>(b - a) * width;
      } else {
        return fail_value("unknown op kind"), nullptr;
      }
    }
    if (body_cap > (1ull << 30))
      return fail_value("page body too large for a thrift i32 header"),
             nullptr;
    size_t comp_cap = body_cap;
    if (codec == 1) comp_cap = kpw_snappy_max_compressed_length(body_cap);
#ifndef KPW_NO_ZSTD
    if (codec == 6) comp_cap = kpw_zstd_max_compressed_length(body_cap);
#endif
    cap += static_cast<size_t>(bufs.views[prefix].len)
           + static_cast<size_t>(bufs.views[suffix].len) + 16
           + (comp_cap > body_cap ? comp_cap : body_cap);
  }

  std::vector<uint8_t> out;
  std::vector<uint8_t> body;      // per-page body scratch
  std::vector<uint8_t> comp;      // per-page compression scratch
  std::vector<uint8_t> rle;       // per-op rle scratch
  std::vector<uint32_t> run_vals; // per-op run-table snapshots (content is
  std::vector<int32_t> run_lens;  // caller-mutable while the GIL is down)
  std::vector<int64_t> offs_snap;
  bool oom = false;
  int codec_rc = 0;
  const char* op_err = nullptr;

  Py_BEGIN_ALLOW_THREADS try {
    out.reserve(cap);
    for (int64_t p = 0; p < n_pages && op_err == nullptr; p++) {
      const int64_t* pg = pages + p * kPageStride;
      const int64_t op_start = pg[0], op_end = pg[1];
      const Py_buffer& prefix = bufs.views[pg[2]];
      const Py_buffer& suffix = bufs.views[pg[3]];
      const bool want_crc = (pg[4] & kFlagCrc) != 0;

      // 1. body: gather RAW parts / RLE-encode streams into scratch
      body.clear();
      for (int64_t o = op_start; o < op_end && op_err == nullptr; o++) {
        const int64_t* op = ops + o * kOpStride;
        const Py_buffer& view = bufs.views[op[1]];
        const int64_t a = op[2], b = op[3];
        if (op[0] == kOpRaw) {
          const uint8_t* src = static_cast<const uint8_t*>(view.buf) + a;
          body.insert(body.end(), src, src + (b - a));
        } else if (op[0] == kOpRle) {
          const uint32_t* v = static_cast<const uint32_t*>(view.buf) + a;
          const size_t n = static_cast<size_t>(b - a);
          const int width = static_cast<int>(op[4] & 0xFF);
          const int64_t mode = (op[4] >> 8) & 0xFF;
          rle.resize(kpw_rle_hybrid_cap(n, width));
          size_t rle_len = 0;
          kpw_rle_hybrid_u32(v, n, width, rle.data(), &rle_len);
          if (mode == kModeWidthByte) {
            body.push_back(static_cast<uint8_t>(width));
          } else if (mode == kModeLen32) {
            uint32_t ln = static_cast<uint32_t>(rle_len);
            uint8_t le[4];
            std::memcpy(le, &ln, 4);
            body.insert(body.end(), le, le + 4);
          }
          body.insert(body.end(), rle.data(), rle.data() + rle_len);
        } else if (op[0] == kOpRleRuns) {
          // snapshot the run table first: the scratch is sized from the
          // summed lengths, and the caller's arrays are mutable while
          // the GIL is down — size and encode must see the same content
          const size_t n = static_cast<size_t>(b - a);
          const int width = static_cast<int>(op[4] & 0xFF);
          const int64_t mode = (op[4] >> 8) & 0xFF;
          const Py_buffer& lview = bufs.views[op[4] >> 16];
          const uint32_t* v = static_cast<const uint32_t*>(view.buf) + a;
          const int32_t* l = static_cast<const int32_t*>(lview.buf) + a;
          run_vals.assign(v, v + n);
          run_lens.resize(n);
          uint64_t total = 0;
          for (size_t i = 0; i < n; i++) {
            const int32_t rl = l[i] > 0 ? l[i] : 0;
            run_lens[i] = rl;
            total += static_cast<uint64_t>(rl);
          }
          // bound the SCRATCH, not just the emitted body: a hostile run
          // table summing just under 2^30 values at width 32 would
          // otherwise drive a ~4.3 GiB transient allocation before the
          // post-encode body check could reject the page
          if (total > (1ull << 30) ||
              kpw_rle_hybrid_cap(static_cast<size_t>(total), width) >
                  (1ull << 30)) {
            op_err = "runs op total length too large";
            break;
          }
          rle.resize(kpw_rle_hybrid_cap(static_cast<size_t>(total), width));
          size_t rle_len = 0;
          kpw_rle_hybrid_from_runs_u32(run_vals.data(), run_lens.data(), n,
                                       width, rle.data(), &rle_len);
          if (mode == kModeWidthByte) {
            body.push_back(static_cast<uint8_t>(width));
          } else if (mode == kModeLen32) {
            uint32_t ln = static_cast<uint32_t>(rle_len);
            uint8_t le[4];
            std::memcpy(le, &ln, 4);
            body.insert(body.end(), le, le + 4);
          }
          body.insert(body.end(), rle.data(), rle.data() + rle_len);
        } else if (op[0] == kOpBss) {
          const size_t n = static_cast<size_t>(b - a);
          const size_t width = static_cast<size_t>(op[4]);
          const size_t at = body.size();
          body.resize(at + n * width);
          kpw_byte_stream_split(
              static_cast<const uint8_t*>(view.buf) + a * width, n, width,
              body.data() + at);
        } else {  // kOpBytesPlain
          const size_t n = static_cast<size_t>(b - a);
          const Py_buffer& oview = bufs.views[op[4] >> 16];
          const int64_t* table = static_cast<const int64_t*>(oview.buf) + a;
          offs_snap.assign(table, table + n + 1);
          const int64_t data_len = view.len;
          for (size_t i = 0; i < n; i++) {
            const int64_t s = offs_snap[i], e = offs_snap[i + 1];
            if (s < 0 || e < s || e > data_len ||
                e - s > int64_t(0x7FFFFFFF)) {
              op_err = "bytes-plain offset table out of data bounds";
              break;
            }
            const uint32_t ln = static_cast<uint32_t>(e - s);
            uint8_t le[4];
            std::memcpy(le, &ln, 4);
            body.insert(body.end(), le, le + 4);
            const uint8_t* src = static_cast<const uint8_t*>(view.buf) + s;
            body.insert(body.end(), src, src + (e - s));
          }
        }
      }
      if (op_err != nullptr) break;
      if (body.size() > (1ull << 30)) {
        // content-sized ops (runs / bytes-plain) can only be bounded
        // here; the RAW/RLE ops were already bounded at validation
        op_err = "page body too large for a thrift i32 header";
        break;
      }
      const size_t body_len = body.size();

      // 2. compression (page body only; headers are never compressed)
      const uint8_t* wire = body.data();
      size_t wire_len = body_len;
      if (codec == 1) {
        comp.resize(kpw_snappy_max_compressed_length(body_len));
        size_t n = 0;
        codec_rc = kpw_snappy_compress(body.data(), body_len, comp.data(), &n);
        if (codec_rc != 0) break;
        wire = comp.data();
        wire_len = n;
      }
#ifndef KPW_NO_ZSTD
      else if (codec == 6) {
        comp.resize(kpw_zstd_max_compressed_length(body_len));
        size_t n = 0;
        codec_rc = kpw_zstd_compress(body.data(), body_len, comp.data(),
                                     comp.size(), &n, level);
        if (codec_rc != 0) break;
        wire = comp.data();
        wire_len = n;
      }
#endif

      // 3. header: prefix + uncomp varint + 0x15 + comp varint
      //    [+ 0x15 + crc varint] + suffix
      const size_t header_at = out.size();
      const uint8_t* pre = static_cast<const uint8_t*>(prefix.buf);
      out.insert(out.end(), pre, pre + prefix.len);
      emit_zigzag_i32(out, static_cast<int32_t>(body_len));
      out.push_back(0x15);
      emit_zigzag_i32(out, static_cast<int32_t>(wire_len));
      if (want_crc) {
        const uint32_t crc = crc32_update(0, wire, wire_len);
        out.push_back(0x15);
        emit_zigzag_i32(out, static_cast<int32_t>(crc));
      }
      const uint8_t* suf = static_cast<const uint8_t*>(suffix.buf);
      out.insert(out.end(), suf, suf + suffix.len);
      const size_t header_len = out.size() - header_at;

      // 4. body bytes onto the wire
      out.insert(out.end(), wire, wire + wire_len);

      int64_t* meta = out_meta + p * 3;
      meta[0] = static_cast<int64_t>(body_len);
      meta[1] = static_cast<int64_t>(wire_len);
      meta[2] = static_cast<int64_t>(header_len);

      // 5. per-page value stats
      if (sdt != kStatsNone) {
        const int64_t va = pg[5], vb = pg[6];
        uint8_t* lo = out_stats + p * 2 * vsize;
        uint8_t* hi = lo + vsize;
        uint8_t m = kStatUndefined;
        switch (sdt) {
          case kStatsI32: m = stats_int<int32_t>(vbase, va, vb, lo, hi); break;
          case kStatsI64: m = stats_int<int64_t>(vbase, va, vb, lo, hi); break;
          case kStatsU32: m = stats_int<uint32_t>(vbase, va, vb, lo, hi); break;
          case kStatsU64: m = stats_int<uint64_t>(vbase, va, vb, lo, hi); break;
          case kStatsU8: m = stats_int<uint8_t>(vbase, va, vb, lo, hi); break;
          case kStatsF32: m = stats_float<float>(vbase, va, vb, lo, hi); break;
          case kStatsF64: m = stats_float<double>(vbase, va, vb, lo, hi); break;
        }
        out_mask[p] = m;
      }
    }
  } catch (const std::bad_alloc&) {
    oom = true;
  }
  Py_END_ALLOW_THREADS

  if (oom) return PyErr_NoMemory();
  if (op_err != nullptr) return fail_value(op_err), nullptr;
  if (codec_rc != 0) {
    PyErr_Format(PyExc_RuntimeError, "native page compression failed rc=%d",
                 codec_rc);
    return nullptr;
  }
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef methods[] = {
    {"assemble_pages", py_assemble_pages, METH_VARARGS,
     "Gather/encode/compress/CRC a chunk's pages from a lowered plan, "
     "GIL released; returns the finished chunk bytes."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_kpw_torch_assemble",
                         "nogil batch page assembly", -1, methods,
                         nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__kpw_torch_assemble(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (m == nullptr) return nullptr;
#ifndef KPW_NO_ZSTD
  PyModule_AddIntConstant(m, "HAS_ZSTD", 1);
#else
  PyModule_AddIntConstant(m, "HAS_ZSTD", 0);
#endif
  // op-kind generation: 4 = RAW/RLE + the nested-pipeline additions
  // (RLE-from-runs, bytes-plain); 5 adds BYTE_STREAM_SPLIT (kOpBss).
  // The Python lowering getattr-gates on this, so a stale cached .so
  // silently keeps the old lowering instead of emitting ops it cannot
  // execute.
  PyModule_AddIntConstant(m, "OP_KINDS", 5);
  return m;
}
