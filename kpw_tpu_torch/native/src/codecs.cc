// kpw_tpu_torch native host library: page codecs + byte-assembly hot paths
// (a copy of the JAX package's codecs.cc; the port builds its own).
//
// The reference system's only native code is the codec layer reached through
// parquet-mr (snappy-java JNI, zlib, libhadoop CRC).  This file is the rebuild's equivalent:
//   * Snappy block-format compressor/decompressor.  The wire format follows
//     the public format description; the compressor's internal heuristics
//     (the 0x1e35a7bd hash multiplier, the skip>>5 match-skipping schedule,
//     the emit_literal/emit_copy decomposition) follow the algorithm of
//     upstream google/snappy (BSD-licensed) — credit where due; output is
//     cross-validated against libsnappy in the tests,
//   * ZSTD via the system libzstd (zstd.h),
//   * CRC32C (Castagnoli, table-driven), parquet page checksum polynomial,
//   * BYTE_ARRAY PLAIN assembly (length-prefix interleaving) for the string
//     hot path.
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>

#ifndef KPW_NO_ZSTD
#include <zstd.h>
#endif
#include <dlfcn.h>  // snappy + zstd runtime dispatch (glibc>=2.34: in libc)
#include <mutex>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// varint32
// ---------------------------------------------------------------------------

inline size_t varint_encode(uint32_t v, uint8_t* out) {
  size_t i = 0;
  while (v >= 0x80) {
    out[i++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  out[i++] = static_cast<uint8_t>(v);
  return i;
}

inline int varint_decode(const uint8_t* in, size_t n, uint32_t* v) {
  uint32_t result = 0;
  int shift = 0;
  for (size_t i = 0; i < n && i < 5; i++) {
    result |= static_cast<uint32_t>(in[i] & 0x7F) << shift;
    if (!(in[i] & 0x80)) {
      *v = result;
      return static_cast<int>(i) + 1;
    }
    shift += 7;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Snappy block format
// ---------------------------------------------------------------------------

constexpr size_t kBlockSize = 1 << 16;  // compress in 64 KiB fragments
constexpr int kHashBits = 14;
constexpr size_t kHashSize = 1 << kHashBits;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

// Emit a literal run [lit, lit+len)
inline uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, size_t len) {
  if (len == 0) return op;
  size_t n = len - 1;
  if (n < 60) {
    *op++ = static_cast<uint8_t>(n << 2);
  } else if (n < (1u << 8)) {
    *op++ = 60 << 2;
    *op++ = static_cast<uint8_t>(n);
  } else if (n < (1u << 16)) {
    *op++ = 61 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
  } else if (n < (1u << 24)) {
    *op++ = 62 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
    *op++ = static_cast<uint8_t>(n >> 16);
  } else {
    *op++ = 63 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
    *op++ = static_cast<uint8_t>(n >> 16);
    *op++ = static_cast<uint8_t>(n >> 24);
  }
  std::memcpy(op, lit, len);
  return op + len;
}

// Emit one copy element (len <= 64, offset < 65536)
inline uint8_t* emit_copy_upto64(uint8_t* op, size_t offset, size_t len) {
  if (len < 12 && offset < 2048) {
    // copy with 1-byte offset: tag 01
    *op++ = static_cast<uint8_t>(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *op++ = static_cast<uint8_t>(offset);
  } else {
    // copy with 2-byte offset: tag 10
    *op++ = static_cast<uint8_t>(((len - 1) << 2) | 2);
    *op++ = static_cast<uint8_t>(offset);
    *op++ = static_cast<uint8_t>(offset >> 8);
  }
  return op;
}

inline uint8_t* emit_copy(uint8_t* op, size_t offset, size_t len) {
  // Long matches: emit 64-byte copies, keep remainder >= 4
  while (len >= 68) {
    op = emit_copy_upto64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, offset, len);
}

// Compress one fragment (<= 64 KiB); offsets are fragment-relative.
uint8_t* compress_fragment(const uint8_t* input, size_t n, uint8_t* op,
                           uint16_t* table) {
  std::memset(table, 0, kHashSize * sizeof(uint16_t));
  const uint8_t* ip = input;
  const uint8_t* ip_end = input + n;
  const uint8_t* next_emit = input;
  if (n >= 15) {
    const uint8_t* ip_limit = input + n - 15;
    ip++;  // first byte can never be a match target
    while (ip < ip_limit) {
      // find a match, skipping ahead faster the longer we go without one
      uint32_t skip = 32;
      const uint8_t* next_ip = ip;
      const uint8_t* candidate;
      do {
        ip = next_ip;
        uint32_t h = hash4(load32(ip));
        next_ip = ip + (skip++ >> 5);
        if (next_ip > ip_limit) goto emit_remainder;
        candidate = input + table[h];
        table[h] = static_cast<uint16_t>(ip - input);
      } while (load32(candidate) != load32(ip) || candidate >= ip);

      op = emit_literal(op, next_emit, ip - next_emit);

      // extend the match and emit copies; chain adjacent matches
      do {
        const uint8_t* base = ip;
        size_t matched = 4;
        ip += 4;
        candidate += 4;
        while (ip + 8 <= ip_end && load64(candidate) == load64(ip)) {
          ip += 8;
          candidate += 8;
          matched += 8;
        }
        while (ip < ip_end && *candidate == *ip) {
          ip++;
          candidate++;
          matched++;
        }
        op = emit_copy(op, base - (candidate - matched), matched);
        next_emit = ip;
        if (ip >= ip_limit) goto emit_remainder;
        // refresh hash entries around the match end
        uint32_t cur = load32(ip);
        table[hash4(load32(ip - 1))] = static_cast<uint16_t>(ip - 1 - input);
        uint32_t h = hash4(cur);
        candidate = input + table[h];
        table[h] = static_cast<uint16_t>(ip - input);
        if (load32(candidate) != cur || candidate >= ip) break;
      } while (true);
      ip++;
    }
  }
emit_remainder:
  if (next_emit < ip_end) {
    op = emit_literal(op, next_emit, ip_end - next_emit);
  }
  return op;
}

}  // namespace

// Runtime dispatch to the system libsnappy when present (same pattern as
// zdl:: for zstd): its compressor is about twice as fast as the
// from-scratch one on page data, and both emit valid snappy
// streams.  The dispatch lives INSIDE kpw_snappy_compress so every caller
// (native encoder, cpu oracle path via core.compression) picks the same
// implementation — backend byte-identity holds per host.  Opt out with
// KPW_SNAPPY_LIB="" (empty) or point KPW_SNAPPY_LIB at a specific .so;
// decompression and the internal compressor remain available either way
// (tests cross-validate the two).
namespace sdl {
typedef int (*raw_compress_t)(const char*, size_t, char*, size_t*);
typedef size_t (*max_len_t)(size_t);

struct Api {
  raw_compress_t compress = nullptr;  // null = internal compressor
  max_len_t max_len = nullptr;
};

static Api g_api;
static std::once_flag g_once;

static void init_api() {
  const char* path = getenv("KPW_SNAPPY_LIB");
  if (path != nullptr && path[0] == '\0') return;  // explicit opt-out
  void* h = dlopen(path != nullptr ? path : "libsnappy.so.1",
                   RTLD_LAZY | RTLD_LOCAL);
  if (h == nullptr) return;
  Api a;
  a.compress = (raw_compress_t)dlsym(h, "snappy_compress");
  a.max_len = (max_len_t)dlsym(h, "snappy_max_compressed_length");
  if (a.compress != nullptr && a.max_len != nullptr)
    g_api = a;
  else
    dlclose(h);
}

static const Api& api() {
  std::call_once(g_once, init_api);
  return g_api;
}
}  // namespace sdl

extern "C" {

size_t kpw_snappy_max_compressed_length(size_t n) {
  const sdl::Api& s = sdl::api();
  if (s.max_len != nullptr) {
    size_t m = s.max_len(n);
    size_t ours = 32 + n + n / 6;
    return m > ours ? m : ours;
  }
  return 32 + n + n / 6;
}

int kpw_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                        size_t* out_len) {
  if (n > 0xFFFFFFFFull) return -1;
  const sdl::Api& s = sdl::api();
  if (s.compress != nullptr) {
    *out_len = kpw_snappy_max_compressed_length(n);
    return s.compress(reinterpret_cast<const char*>(in), n,
                      reinterpret_cast<char*>(out), out_len) == 0 ? 0 : -3;
  }
  uint8_t* op = out;
  op += varint_encode(static_cast<uint32_t>(n), op);
  uint16_t* table =
      static_cast<uint16_t*>(std::malloc(kHashSize * sizeof(uint16_t)));
  if (!table) return -2;
  for (size_t pos = 0; pos < n; pos += kBlockSize) {
    size_t frag = n - pos < kBlockSize ? n - pos : kBlockSize;
    op = compress_fragment(in + pos, frag, op, table);
  }
  if (n == 0) {
    // nothing beyond the length varint
  }
  std::free(table);
  *out_len = static_cast<size_t>(op - out);
  return 0;
}

// Parts-based snappy page compression (mirrors kpw_zstd_compress_parts):
// the page body's discontiguous parts are concatenated in C into
// thread-local scratch (snappy's one-shot API needs contiguous input) and
// compressed straight into the caller's scratch — no Python-side join, no
// zeroed bounce buffers, no compressed-bytes copy.
int kpw_snappy_compress_parts(const void* const* parts, const size_t* lens,
                              int n_parts, uint8_t* out, size_t out_cap,
                              size_t* out_len) {
  size_t total = 0;
  for (int i = 0; i < n_parts; i++) total += lens[i];
  static thread_local std::vector<uint8_t> scratch;
  if (scratch.size() < total) scratch.resize(total);
  uint8_t* p = scratch.data();
  for (int i = 0; i < n_parts; i++) {
    std::memcpy(p, parts[i], lens[i]);
    p += lens[i];
  }
  if (out_cap < kpw_snappy_max_compressed_length(total)) return -4;
  *out_len = out_cap;
  return kpw_snappy_compress(scratch.data(), total, out, out_len);
}

int kpw_snappy_uncompressed_length(const uint8_t* in, size_t n,
                                   size_t* result) {
  uint32_t v;
  int used = varint_decode(in, n, &v);
  if (used < 0) return -1;
  *result = v;
  return 0;
}

int kpw_snappy_uncompress(const uint8_t* in, size_t n, uint8_t* out,
                          size_t out_cap, size_t* out_len) {
  uint32_t total;
  int used = varint_decode(in, n, &total);
  if (used < 0 || total > out_cap) return -1;
  const uint8_t* ip = in + used;
  const uint8_t* ip_end = in + n;
  uint8_t* op = out;
  uint8_t* op_end = out + total;
  while (ip < ip_end && op < op_end) {
    uint8_t tag = *ip++;
    uint32_t entry = tag >> 2;
    switch (tag & 3) {
      case 0: {  // literal
        size_t len;
        if (entry < 60) {
          len = entry + 1;
        } else {
          size_t extra = entry - 59;  // 1..4 bytes
          if (ip + extra > ip_end) return -2;
          uint32_t l = 0;
          for (size_t i = 0; i < extra; i++) l |= static_cast<uint32_t>(ip[i]) << (8 * i);
          ip += extra;
          len = static_cast<size_t>(l) + 1;
        }
        if (ip + len > ip_end || op + len > op_end) return -3;
        std::memcpy(op, ip, len);
        ip += len;
        op += len;
        break;
      }
      case 1: {  // copy, 1-byte offset
        if (ip >= ip_end) return -4;
        size_t len = ((entry >> 0) & 0x7) + 4;
        size_t offset = ((entry >> 3) << 8) | *ip++;
        if (offset == 0 || offset > static_cast<size_t>(op - out) ||
            op + len > op_end)
          return -5;
        const uint8_t* src = op - offset;
        for (size_t i = 0; i < len; i++) op[i] = src[i];
        op += len;
        break;
      }
      case 2: {  // copy, 2-byte offset
        if (ip + 2 > ip_end) return -6;
        size_t len = entry + 1;
        size_t offset = ip[0] | (static_cast<size_t>(ip[1]) << 8);
        ip += 2;
        if (offset == 0 || offset > static_cast<size_t>(op - out) ||
            op + len > op_end)
          return -7;
        const uint8_t* src = op - offset;
        for (size_t i = 0; i < len; i++) op[i] = src[i];
        op += len;
        break;
      }
      case 3: {  // copy, 4-byte offset
        if (ip + 4 > ip_end) return -8;
        size_t len = entry + 1;
        size_t offset = ip[0] | (static_cast<size_t>(ip[1]) << 8) |
                        (static_cast<size_t>(ip[2]) << 16) |
                        (static_cast<size_t>(ip[3]) << 24);
        ip += 4;
        if (offset == 0 || offset > static_cast<size_t>(op - out) ||
            op + len > op_end)
          return -9;
        const uint8_t* src = op - offset;
        for (size_t i = 0; i < len; i++) op[i] = src[i];
        op += len;
        break;
      }
    }
  }
  if (op != op_end) return -10;
  *out_len = total;
  return 0;
}

// ---------------------------------------------------------------------------
// ZSTD via system libzstd
// ---------------------------------------------------------------------------

#ifndef KPW_NO_ZSTD
// ---------------------------------------------------------------------------
// Runtime zstd dispatch: the public ZSTD_* API is version-stable, and the
// Python environment often ships a newer, faster libzstd inside the
// `zstandard` extension than the distro's (1.5.7 vs 1.5.4 here, ~1.5x
// compression throughput).  When KPW_ZSTD_LIB names a loadable library that
// exports the needed symbols, use it; otherwise fall back to the libzstd we
// linked against.  RTLD_LAZY: the donor .so may be a Python extension whose
// *other* symbols only resolve inside the interpreter.
// ---------------------------------------------------------------------------
namespace zdl {
typedef size_t (*compressBound_t)(size_t);
typedef ZSTD_CCtx* (*createCCtx_t)(void);
typedef size_t (*freeCCtx_t)(ZSTD_CCtx*);
typedef size_t (*cctxReset_t)(ZSTD_CCtx*, ZSTD_ResetDirective);
typedef size_t (*cctxSetParameter_t)(ZSTD_CCtx*, ZSTD_cParameter, int);
typedef size_t (*cctxSetPledged_t)(ZSTD_CCtx*, unsigned long long);
typedef size_t (*compressStream2_t)(ZSTD_CCtx*, ZSTD_outBuffer*, ZSTD_inBuffer*, ZSTD_EndDirective);
typedef unsigned (*isError_t)(size_t);
typedef unsigned long long (*getFrameContentSize_t)(const void*, size_t);
typedef size_t (*decompress_t)(void*, size_t, const void*, size_t);
typedef size_t (*oneshot_t)(void*, size_t, const void*, size_t, int);

struct Api {
  oneshot_t oneshot = ZSTD_compress;
  compressBound_t compressBound = ZSTD_compressBound;
  createCCtx_t createCCtx = ZSTD_createCCtx;
  freeCCtx_t freeCCtx = ZSTD_freeCCtx;
  cctxReset_t cctxReset = ZSTD_CCtx_reset;
  cctxSetParameter_t cctxSetParameter = ZSTD_CCtx_setParameter;
  cctxSetPledged_t cctxSetPledged = ZSTD_CCtx_setPledgedSrcSize;
  compressStream2_t compressStream2 = ZSTD_compressStream2;
  isError_t isError = ZSTD_isError;
  getFrameContentSize_t getFrameContentSize = ZSTD_getFrameContentSize;
  decompress_t decompress = ZSTD_decompress;
};

static Api g_api;
static std::once_flag g_once;

static void init_api() {
  const char* path = getenv("KPW_ZSTD_LIB");
  if (path == nullptr || path[0] == '\0') return;
  void* h = dlopen(path, RTLD_LAZY | RTLD_LOCAL);
  if (h == nullptr) return;
  Api a;
  bool ok = true;
  auto resolve = [&](const char* name) -> void* {
    void* p = dlsym(h, name);
    if (p == nullptr) ok = false;
    return p;
  };
  a.compressBound = (compressBound_t)resolve("ZSTD_compressBound");
  a.createCCtx = (createCCtx_t)resolve("ZSTD_createCCtx");
  a.freeCCtx = (freeCCtx_t)resolve("ZSTD_freeCCtx");
  a.cctxReset = (cctxReset_t)resolve("ZSTD_CCtx_reset");
  a.cctxSetParameter = (cctxSetParameter_t)resolve("ZSTD_CCtx_setParameter");
  a.cctxSetPledged = (cctxSetPledged_t)resolve("ZSTD_CCtx_setPledgedSrcSize");
  a.compressStream2 = (compressStream2_t)resolve("ZSTD_compressStream2");
  a.isError = (isError_t)resolve("ZSTD_isError");
  a.getFrameContentSize = (getFrameContentSize_t)resolve("ZSTD_getFrameContentSize");
  a.decompress = (decompress_t)resolve("ZSTD_decompress");
  a.oneshot = (oneshot_t)resolve("ZSTD_compress");
  if (ok) g_api = a; else dlclose(h);
}

static const Api& api() {
  std::call_once(g_once, init_api);
  return g_api;
}
}  // namespace zdl

size_t kpw_zstd_max_compressed_length(size_t n) { return zdl::api().compressBound(n); }

int kpw_zstd_compress_parts(const uint8_t* const* parts, const size_t* lens,
                            int n_parts, uint8_t* out, size_t out_cap,
                            size_t* out_len, int level);

int kpw_zstd_compress(const uint8_t* in, size_t n, uint8_t* out,
                      size_t out_cap, size_t* out_len, int level) {
  // one implementation: the streaming parts path with a single part (same
  // frame bytes — pledged content size keeps headers identical) and one
  // shared thread-local context per thread.
  return kpw_zstd_compress_parts(&in, &n, 1, out, out_cap, out_len, level);
}

// Compress several discontiguous input parts as ONE zstd frame (streaming
// API) — the page-assembly hot path hands [levels blob, delta header,
// string payload] without pre-concatenating them into a scratch buffer.
// Byte-compatibility note: the frame differs from ZSTD_compress output only
// in header flags (no content-size field); parquet stores the uncompressed
// size in the page header, and every decompressor (ours included) streams.
int kpw_zstd_compress_parts(const uint8_t* const* parts, const size_t* lens,
                            int n_parts, uint8_t* out, size_t out_cap,
                            size_t* out_len, int level) {
  const zdl::Api& z = zdl::api();
  struct CtxHolder {
    ZSTD_CCtx* ctx = zdl::api().createCCtx();
    ~CtxHolder() { zdl::api().freeCCtx(ctx); }
  };
  static thread_local CtxHolder holder;
  if (holder.ctx == nullptr) holder.ctx = z.createCCtx();  // retry after OOM
  if (holder.ctx == nullptr) {
    // stateless fallback: concatenate (if needed) and one-shot compress —
    // survivable degraded mode instead of poisoning the file
    unsigned long long total = 0;
    for (int i = 0; i < n_parts; i++) total += lens[i];
    const uint8_t* src = n_parts == 1 ? parts[0] : nullptr;
    uint8_t* tmp = nullptr;
    if (src == nullptr) {
      tmp = static_cast<uint8_t*>(std::malloc(total ? total : 1));
      if (tmp == nullptr) return -2;
      size_t off = 0;
      for (int i = 0; i < n_parts; i++) {
        std::memcpy(tmp + off, parts[i], lens[i]);
        off += lens[i];
      }
      src = tmp;
    }
    size_t rc = z.oneshot(out, out_cap, src, total, level);
    std::free(tmp);
    if (z.isError(rc)) return -1;
    *out_len = rc;
    return 0;
  }
  ZSTD_CCtx* c = holder.ctx;
  z.cctxReset(c, ZSTD_reset_session_only);
  if (z.isError(z.cctxSetParameter(c, ZSTD_c_compressionLevel, level)))
    return -3;
  unsigned long long total = 0;
  for (int i = 0; i < n_parts; i++) total += lens[i];
  // keep the frame identical to the one-shot API: record the content size
  z.cctxSetPledged(c, total);
  ZSTD_outBuffer ob{out, out_cap, 0};
  for (int i = 0; i < n_parts; i++) {
    ZSTD_inBuffer ib{parts[i], lens[i], 0};
    ZSTD_EndDirective mode = (i == n_parts - 1) ? ZSTD_e_end : ZSTD_e_continue;
    while (true) {
      size_t rc = z.compressStream2(c, &ob, &ib, mode);
      if (z.isError(rc)) return -1;
      if (mode == ZSTD_e_end ? rc == 0 : ib.pos == ib.size) break;
      if (ob.pos == ob.size) return -4;  // out_cap too small (caller bug)
    }
  }
  *out_len = ob.pos;
  return 0;
}

int kpw_zstd_uncompressed_length(const uint8_t* in, size_t n, size_t* result) {
  unsigned long long sz = zdl::api().getFrameContentSize(in, n);
  if (sz == ZSTD_CONTENTSIZE_ERROR || sz == ZSTD_CONTENTSIZE_UNKNOWN) return -1;
  *result = static_cast<size_t>(sz);
  return 0;
}

int kpw_zstd_uncompress(const uint8_t* in, size_t n, uint8_t* out,
                        size_t out_cap, size_t* out_len) {
  const zdl::Api& z = zdl::api();
  size_t rc = z.decompress(out, out_cap, in, n);
  if (z.isError(rc)) return -1;
  *out_len = rc;
  return 0;
}
#endif

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), bit-reflected, table-driven
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
  const uint32_t poly = 0x82F63B78u;  // reflected 0x1EDC6F41
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc32c_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      crc32c_table[s][i] =
          (crc32c_table[s - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[s - 1][i] & 0xFF];
  crc32c_init_done = true;
}

uint32_t kpw_crc32c(const uint8_t* data, size_t n, uint32_t crc) {
  if (!crc32c_init_done) crc32c_init();
  crc = ~crc;
  while (n >= 8) {
    crc ^= load32(data);
    uint32_t hi = load32(data + 4);
    crc = crc32c_table[7][crc & 0xFF] ^ crc32c_table[6][(crc >> 8) & 0xFF] ^
          crc32c_table[5][(crc >> 16) & 0xFF] ^ crc32c_table[4][crc >> 24] ^
          crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
          crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *data++) & 0xFF];
  return ~crc;
}

// ---------------------------------------------------------------------------
// BYTE_ARRAY PLAIN assembly: interleave 4-byte LE lengths with value bytes.
// data: concatenated values; offsets: count+1 int64 prefix offsets.
// out must have (offsets[count]-offsets[0]) + 4*count bytes.
// ---------------------------------------------------------------------------

void kpw_byte_array_plain(const uint8_t* data, const int64_t* offsets,
                          size_t count, uint8_t* out) {
  size_t pos = 0;
  for (size_t i = 0; i < count; i++) {
    uint32_t len = static_cast<uint32_t>(offsets[i + 1] - offsets[i]);
    std::memcpy(out + pos, &len, 4);
    pos += 4;
    std::memcpy(out + pos, data + offsets[i], len);
    pos += len;
  }
}

// Gather variable-length dictionary entries by index (host-side string
// dictionary materialization for the TPU path).
void kpw_byte_array_gather(const uint8_t* dict_data, const int64_t* dict_offsets,
                           const int32_t* indices, size_t count, uint8_t* out) {
  size_t pos = 0;
  for (size_t i = 0; i < count; i++) {
    int32_t idx = indices[i];
    int64_t start = dict_offsets[idx];
    uint32_t len = static_cast<uint32_t>(dict_offsets[idx + 1] - start);
    std::memcpy(out + pos, &len, 4);
    pos += 4;
    std::memcpy(out + pos, dict_data + start, len);
    pos += len;
  }
}

}  // extern "C"
