// Parquet encoding primitives: dictionary build + RLE/bit-pack hybrid.
//
// Native host-side counterparts of core/encodings.py — the hot CPU
// encode path (the reference's equivalent hot path is parquet-mr's
// ColumnWriter/ValuesWriter stack reached from ParquetFile.java:59-62).
// Byte-for-byte identical to the numpy oracle: dictionary order is ascending
// *bit pattern* (floats/ints viewed unsigned), and the hybrid stream applies
// the same long-run mass heuristic and run segmentation.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <type_traits>
#include <vector>

#if defined(__AVX512BW__) || defined(__AVX512DQ__)
#include <immintrin.h>
#endif

namespace {

// Fused column stats for the affine dictionary planner: min, max, and the
// gcd of value differences in ONE memory pass.  gcd of pairwise
// differences is invariant to the base point (min and v[0] are both in
// the set), so gcd accumulates against v[0] without knowing min yet;
// once the gcd collapses to 1 the reduction is skipped for the rest of
// the scan.  gcd_out = gcd{v - min} (0 for a constant column).
// Widen to uint64 via sign-extension for signed T: modular uint64
// subtraction then yields the exact absolute difference (|diff| < 2^64).
template <typename T>
inline uint64_t stats_widen(T x) {
  if (std::is_signed<T>::value)
    return static_cast<uint64_t>(static_cast<int64_t>(x));
  return static_cast<uint64_t>(x);
}

template <typename T>
void int_stats(const T* v, size_t n, T* mn_out, T* mx_out,
               uint64_t* gcd_out) {
  T mn = v[0], mx = v[0];
  uint64_t g = 0;
  const T base = v[0];
  const uint64_t ub = stats_widen(base);
  // The gcd stabilizes after a few elements; from then on each element
  // only needs a divisibility CHECK, done divisionless (Granlund-
  // Montgomery): with g = g_odd << s, d % g == 0 iff the low s bits of d
  // are zero and (d >> s) * inv(g_odd) <= ~0 / g_odd.  A per-element
  // std::gcd (one 64-bit modulo) measured 4.5x slower than numpy's
  // reduction; this check is a multiply + compare.
  uint64_t inv = 0, lim = 0, low_mask = 0;
  int s = 0;
  auto set_magic = [&]() {
    uint64_t go = g;
    s = 0;
    while ((go & 1) == 0) {
      go >>= 1;
      ++s;
    }
    uint64_t x = go;  // Newton: inverse mod 2^64 of odd go (5 rounds)
    for (int it = 0; it < 5; ++it) x *= 2 - go * x;
    inv = x;
    lim = ~0ull / go;
    low_mask = (s == 0) ? 0 : ((1ull << s) - 1);
  };
  for (size_t i = 0; i < n; ++i) {
    const T x = v[i];
    if (x < mn) mn = x;
    if (x > mx) mx = x;
    if (g == 1) continue;
    const uint64_t ux = stats_widen(x);
    const uint64_t d = x >= base ? ux - ub : ub - ux;
    if (g == 0) {
      if (d != 0) {
        g = d;
        set_magic();
      }
      continue;
    }
    if ((d & low_mask) == 0 && (d >> s) * inv <= lim)
      continue;  // divisible: gcd unchanged
    g = std::gcd(g, d);
    if (g > 1) set_magic();
  }
  *mn_out = mn;
  *mx_out = mx;
  *gcd_out = g;
}

inline size_t varint(uint64_t v, uint8_t* out) {
  size_t i = 0;
  while (v >= 0x80) {
    out[i++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  out[i++] = static_cast<uint8_t>(v);
  return i;
}

// LSB-first parquet bit layout: bit j of value i lands at overall bit
// position i*width + j.  width <= 32, so acc never exceeds 7+32 bits.
inline uint8_t* bitpack_stream(const uint32_t* v, size_t n, int width,
                               uint8_t* op) {
  if (width <= 16 && n >= 8) {
    // Branchless whole-group path: an 8-value group is exactly `width`
    // bytes; 8*width <= 128 bits fits one accumulator, stored via a 16-byte
    // overwrite (successive groups overwrite the slack).  The combine is a
    // TREE, not a serial fold: the old 8-deep (acc << w) | p[i] chain left
    // the core idle on the carry dependency (~3 cycles/value); pairs ->
    // quads -> halves is depth 3 with 4-way ILP, and the quad combines
    // stay in uint64 (4 * 16 = 64 bits), entering __int128 only once.
    const size_t groups = n / 8;
    for (size_t g = 0; g < groups; ++g) {
      const uint32_t* p = v + g * 8;
      const uint64_t a01 = p[0] | (static_cast<uint64_t>(p[1]) << width);
      const uint64_t a23 = p[2] | (static_cast<uint64_t>(p[3]) << width);
      const uint64_t a45 = p[4] | (static_cast<uint64_t>(p[5]) << width);
      const uint64_t a67 = p[6] | (static_cast<uint64_t>(p[7]) << width);
      const uint64_t a03 = a01 | (a23 << (2 * width));
      const uint64_t a47 = a45 | (a67 << (2 * width));
      const unsigned __int128 acc =
          a03 | (static_cast<unsigned __int128>(a47) << (4 * width));
      std::memcpy(op, &acc, 16);
      op += width;
    }
    v += groups * 8;
    n -= groups * 8;
  }
  uint64_t acc = 0;
  int nbits = 0;
  for (size_t i = 0; i < n; ++i) {
    acc |= static_cast<uint64_t>(v[i]) << nbits;
    nbits += width;
    while (nbits >= 8) {
      *op++ = static_cast<uint8_t>(acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits) *op++ = static_cast<uint8_t>(acc);
  return op;
}

inline uint64_t mix(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  return h;
}

// Bounded-range path: when max-min is small, a direct rank table beats the
// hash (no probing, no sort; ranks fall out of the prefix sum — same trick
// as the sort-free device build in ops/dictionary.py).
template <typename K>
int dict_build_range(const K* vals, size_t n, K* dict_out, uint32_t* idx_out,
                     uint32_t max_k, uint32_t* k_out) {
  // NOTE (measured, do not "fuse" these passes): the separate min/max
  // loop auto-vectorizes to AVX-512 min/max and runs at memory bandwidth;
  // a fused minmax+bitmap-fill single pass measured ~2x SLOWER — the
  // early-exit branch blocks vectorization, and on low-cardinality
  // columns every presence |= is a serial RMW chain on one hot word.
  K lo = vals[0], hi = vals[0];
  for (size_t i = 1; i < n; ++i) {
    const K v = vals[i];
    if (v < lo) lo = v;
    if (v > hi) hi = v;
  }
  uint64_t limit = 4 * static_cast<uint64_t>(n);
  if (limit > (1u << 22)) limit = 1u << 22;
  // Compare the span before +1: hi-lo can be UINT64_MAX (e.g. int64 keys 0
  // and -1), where +1 would wrap range to 0 and pass the guard.
  const uint64_t span = static_cast<uint64_t>(hi - lo);
  if (span >= limit) return -1;  // not range-suitable; caller tries hash
  const uint64_t range = span + 1;
  std::vector<uint32_t> table(range, 0);
  for (size_t i = 0; i < n; ++i) table[static_cast<uint64_t>(vals[i] - lo)] = 1;
  uint32_t k = 0;
  for (uint64_t d = 0; d < range; ++d) {
    const uint32_t present = table[d];
    table[d] = k;
    if (present) {
      if (k >= max_k) return 1;  // dictionary infeasible: abort early
      dict_out[k++] = lo + static_cast<K>(d);
    }
  }
  for (size_t i = 0; i < n; ++i)
    idx_out[i] = table[static_cast<uint64_t>(vals[i] - lo)];
  *k_out = k;
  return 0;
}

// Quantized-decimal double path: when every 64-bit key, VIEWED as a
// double, is a finite non-negative multiple of 1/scale for some scale in
// {1, 10, 100, 1000, 10000} — verified by BITWISE reconstruction of every
// element — the dictionary builds on the small integer quotients via a
// range table instead of the hash (fare/tip/distance columns quantized to
// cents or hundredths are the float-heavy case in taxi-like data; the
// hash pays an L2 miss per probe, the quotient table is L1-resident).
// Sound for ANY input: passing the bitwise check proves the keys are bit
// patterns of non-negative doubles, and for those uint64 ascending ==
// double ascending, so the output order contract (ascending bit pattern)
// is unchanged; quotients are distinct iff the doubles are (l/scale
// reproduces each v bitwise, so the map is a verified bijection).
// Returns -1 when no scale fits (caller falls back to the hash).
int dict_build_f64_scaled(const uint64_t* vals, size_t n, uint64_t* dict_out,
                          uint32_t* idx_out, uint32_t max_k, uint32_t* k_out) {
  const double* dv = reinterpret_cast<const double*>(vals);
  uint64_t limit = 4 * static_cast<uint64_t>(n);
  if (limit > (1u << 22)) limit = 1u << 22;
  static const double kScales[] = {1.0, 10.0, 100.0, 1000.0, 10000.0};
  std::vector<uint32_t> q(n);  // verified quotients, reused across scales
  for (const double scale : kScales) {
    uint32_t lo = UINT32_MAX, hi = 0;
    bool ok = true;
    // Chunked with a branch-free body so a wrong scale wastes at most one
    // chunk; the SIMD form below does 8 doubles per iteration (the scalar
    // early-exit loop cost nearly as much as the hash it replaces).
    // Rounding nuance: the lanes use round-to-nearest where the scalar
    // tail truncates d+0.5 — safe, because acceptance is per element and
    // EVERY accepted element independently passes the bitwise
    // reconstruction check; any verified scale yields the identical
    // dictionary (the sorted unique bit patterns).
    constexpr size_t CH = 4096;
#ifdef __AVX512DQ__
    const __m512d vscale = _mm512_set1_pd(scale);
    const __m512d vzero = _mm512_set1_pd(0.0);
    const __m512d vlim = _mm512_set1_pd(2147483648.0);
#endif
    for (size_t base = 0; base < n; base += CH) {
      const size_t m = std::min(CH, n - base);
      uint64_t bad = 0;
      uint32_t clo = UINT32_MAX, chi = 0;
      size_t i = 0;
#ifdef __AVX512DQ__
      __m512i vlo = _mm512_set1_epi64(INT64_MAX);
      __m512i vhi = _mm512_setzero_si512();
      for (; i + 8 <= m; i += 8) {
        const __m512d v = _mm512_loadu_pd(dv + base + i);
        const __m512d d = _mm512_mul_pd(v, vscale);
        const __mmask8 in =
            _mm512_cmp_pd_mask(d, vzero, _CMP_GE_OQ) &
            _mm512_cmp_pd_mask(d, vlim, _CMP_LT_OQ);
        // out-of-range lanes clamp to 0 so the convert stays defined
        const __m512d ds = _mm512_maskz_mov_pd(in, d);
        const __m512i l = _mm512_cvtpd_epi64(ds);  // round-to-nearest
        const __m512d r = _mm512_div_pd(_mm512_cvtepi64_pd(l), vscale);
        const __mmask8 neq = _mm512_cmpneq_epu64_mask(
            _mm512_castpd_si512(r),
            _mm512_loadu_si512(reinterpret_cast<const void*>(vals + base + i)));
        bad |= static_cast<uint64_t>(neq) |
               static_cast<uint64_t>(static_cast<uint8_t>(~in));
        if (bad) break;
        vlo = _mm512_min_epi64(vlo, l);
        vhi = _mm512_max_epi64(vhi, l);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(q.data() + base + i),
                            _mm512_cvtepi64_epi32(l));
      }
      if (!bad) {
        alignas(64) int64_t tmp[8];
        _mm512_store_si512(reinterpret_cast<void*>(tmp), vlo);
        for (int t = 0; t < 8; ++t)
          if (tmp[t] < static_cast<int64_t>(clo))
            clo = static_cast<uint32_t>(tmp[t]);
        _mm512_store_si512(reinterpret_cast<void*>(tmp), vhi);
        for (int t = 0; t < 8; ++t)
          if (tmp[t] > static_cast<int64_t>(chi))
            chi = static_cast<uint32_t>(tmp[t]);
      }
#endif
      for (; i < m && !bad; ++i) {
        const double d = dv[base + i] * scale;
        // quotients beyond 2^31 can't pass the span guard anyway; the
        // clamp keeps the int cast defined for out-of-range inputs
        const bool in = (d >= 0.0) & (d < 2147483648.0);
        const double ds = in ? d : 0.0;
        const int64_t l = static_cast<int64_t>(ds + 0.5);
        const double r = static_cast<double>(l) / scale;
        uint64_t rb;
        std::memcpy(&rb, &r, 8);
        bad |= static_cast<uint64_t>(rb != vals[base + i]) | !in;
        const uint32_t lu = static_cast<uint32_t>(l);
        q[base + i] = lu;
        clo = lu < clo ? lu : clo;
        chi = lu > chi ? lu : chi;
      }
      if (bad) {
        ok = false;
        break;
      }
      lo = clo < lo ? clo : lo;
      hi = chi > hi ? chi : hi;
    }
    if (!ok) continue;
    const uint64_t span = static_cast<uint64_t>(hi - lo);
    if (span >= limit) return -1;  // verified but too wide for a table
    const uint64_t range = span + 1;
    std::vector<uint32_t> table(range, 0);
    for (size_t i = 0; i < n; ++i) table[q[i] - lo] = 1;
    uint32_t k = 0;
    for (uint64_t d = 0; d < range; ++d) {
      const uint32_t present = table[d];
      table[d] = k;
      if (present) {
        if (k >= max_k) return 1;  // dictionary infeasible: abort early
        const double u =
            static_cast<double>(lo + static_cast<uint32_t>(d)) / scale;
        std::memcpy(&dict_out[k++], &u, 8);
      }
    }
    for (size_t i = 0; i < n; ++i) idx_out[i] = table[q[i] - lo];
    *k_out = k;
    return 0;
  }
  return -1;
}

inline int scaled_probe(const uint32_t*, size_t, uint32_t*, uint32_t*,
                        uint32_t, uint32_t*) {
  return -1;  // 32-bit keys: no double interpretation
}
inline int scaled_probe(const uint64_t* vals, size_t n, uint64_t* dict_out,
                        uint32_t* idx_out, uint32_t max_k, uint32_t* k_out) {
  return dict_build_f64_scaled(vals, n, dict_out, idx_out, max_k, k_out);
}

template <typename K>
int dict_build(const K* vals, size_t n, K* dict_out, uint32_t* idx_out,
               uint32_t max_k, uint32_t* k_out) {
  if (n) {
    int rc = dict_build_range(vals, n, dict_out, idx_out, max_k, k_out);
    if (rc >= 0) return rc;
    rc = scaled_probe(vals, n, dict_out, idx_out, max_k, k_out);
    if (rc >= 0) return rc;
  }
  // Adaptive open addressing: start small (low-cardinality columns never
  // touch a big table) and rehash at 50% load; rehashing only moves the
  // unique set, so total cost stays O(n + k).
  size_t cap = 1024;
  if (n >= 8192) {
    // Strided-sample cardinality probe — purely a table SIZING hint
    // (insertion order, output, and the max_k abort point are unchanged,
    // so backend byte-identity holds).  Near-unique columns are the
    // expensive case: they either abort at max_k or complete at large k,
    // and either way the 1024-start rehash cascade moves every survivor
    // log2(k/1024) times.  8192-slot fingerprint set on the stack; rare
    // fingerprint collisions only under-size, which the grow path absorbs.
    constexpr size_t kSample = 4096;
    const size_t stride = n / kSample;
    uint64_t fp[2 * kSample];
    std::memset(fp, 0, sizeof(fp));
    size_t sample_k = 0;
    for (size_t i = 0; i < kSample; ++i) {
      const uint64_t h =
          mix(static_cast<uint64_t>(vals[i * stride])) | 1;
      size_t s = h & (2 * kSample - 1);
      while (fp[s] && fp[s] != h) s = (s + 1) & (2 * kSample - 1);
      if (!fp[s]) {
        fp[s] = h;
        ++sample_k;
      }
    }
    size_t want = cap;
    if (sample_k > kSample * 9 / 10) {
      // near-unique: size past the abort bound so no grow ever fires
      want = 2 * (static_cast<size_t>(max_k) + 2);
    } else if (sample_k > 256) {
      // mid-cardinality: the sample floor is a lower bound on k
      want = 8 * sample_k;
    }
    if (want > (1u << 26)) want = 1u << 26;
    while (cap < want) cap <<= 1;
  }
  // One entry array, not parallel key/id arrays: a probe touches ONE cache
  // line instead of two (the second line was a guaranteed extra miss on
  // the 64-bit float-bit-pattern columns, the hash path's main customer).
  struct Entry {
    K key;
    uint32_t id;
  };
  const Entry kEmpty{K(), UINT32_MAX};
  std::vector<Entry> tab(cap, kEmpty);
  std::vector<K> uniq;
  uniq.reserve(1024);
  size_t mask = cap - 1;
  auto grow = [&]() {
    cap <<= 1;
    mask = cap - 1;
    tab.assign(cap, kEmpty);
    for (uint32_t id = 0; id < uniq.size(); ++id) {
      size_t s = static_cast<size_t>(mix(static_cast<uint64_t>(uniq[id]))) & mask;
      while (tab[s].id != UINT32_MAX) s = (s + 1) & mask;
      tab[s] = Entry{uniq[id], id};
    }
  };
  uint32_t gen = 0;  // bumped by grow(); invalidates precomputed slots
  auto grow_gen = [&]() {
    grow();
    ++gen;
  };
  // resolve one value starting at slot s; returns 1 iff dictionary
  // infeasible.  Output is independent of processing order: the final
  // dictionary is the SORTED unique set and indices are remapped through
  // the rank permutation below, so discovery ids never leak out.
  auto resolve = [&](const K val, size_t s, size_t i) -> int {
    for (;;) {
      const Entry e = tab[s];
      if (e.id == UINT32_MAX) {
        tab[s] = Entry{val, static_cast<uint32_t>(uniq.size())};
        idx_out[i] = static_cast<uint32_t>(uniq.size());
        uniq.push_back(val);
        if (uniq.size() > max_k) return 1;  // dictionary infeasible
        if (2 * uniq.size() >= cap) grow_gen();
        return 0;
      }
      if (e.key == val) {
        idx_out[i] = e.id;
        return 0;
      }
      s = (s + 1) & mask;
    }
  };
  // 4-way interleaved probing: hash four values up front and prefetch
  // their slots so the mix() latency and the dependent table loads of
  // consecutive values overlap instead of serializing (~2x on
  // medium-cardinality 64-bit keys, e.g. float bit patterns).
  size_t i = 0;
  for (; i + 4 <= n; i += 4) {
    const uint32_t g0 = gen;
    size_t s0 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i]))) & mask;
    size_t s1 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 1]))) & mask;
    size_t s2 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 2]))) & mask;
    size_t s3 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 3]))) & mask;
    __builtin_prefetch(&tab[s0]);
    __builtin_prefetch(&tab[s1]);
    __builtin_prefetch(&tab[s2]);
    __builtin_prefetch(&tab[s3]);
    // a grow() mid-block stales the remaining precomputed slots (mask
    // changed) — recompute those from the value
    if (resolve(vals[i], s0, i)) return 1;
    if (gen != g0)
      s1 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 1]))) & mask;
    if (resolve(vals[i + 1], s1, i + 1)) return 1;
    if (gen != g0)
      s2 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 2]))) & mask;
    if (resolve(vals[i + 2], s2, i + 2)) return 1;
    if (gen != g0)
      s3 = static_cast<size_t>(mix(static_cast<uint64_t>(vals[i + 3]))) & mask;
    if (resolve(vals[i + 3], s3, i + 3)) return 1;
  }
  for (; i < n; ++i) {
    const size_t s =
        static_cast<size_t>(mix(static_cast<uint64_t>(vals[i]))) & mask;
    if (resolve(vals[i], s, i)) return 1;
  }
  // Canonical ascending order: sort the (small) unique set, then remap the
  // discovery-order ids through the rank permutation in one linear pass.
  const size_t k = uniq.size();
  std::vector<uint32_t> order(k);
  for (uint32_t x = 0; x < k; ++x) order[x] = x;
  std::sort(order.begin(), order.end(),
            [&](uint32_t a, uint32_t b) { return uniq[a] < uniq[b]; });
  std::vector<uint32_t> rank(k);
  for (uint32_t r = 0; r < k; ++r) {
    rank[order[r]] = r;
    dict_out[r] = uniq[order[r]];
  }
  for (size_t i = 0; i < n; ++i) idx_out[i] = rank[idx_out[i]];
  *k_out = static_cast<uint32_t>(k);
  return 0;
}

// 64-bit-wide variant of bitpack_stream for delta miniblocks (widths up to
// 64); acc holds at most 7+64 bits.
inline uint8_t* bitpack_stream64(const uint64_t* v, size_t n, int width,
                                 uint8_t* op) {
  unsigned __int128 acc = 0;
  int nbits = 0;
  for (size_t i = 0; i < n; ++i) {
    acc |= static_cast<unsigned __int128>(v[i]) << nbits;
    nbits += width;
    while (nbits >= 8) {
      *op++ = static_cast<uint8_t>(acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits) *op++ = static_cast<uint8_t>(acc);
  return op;
}

inline uint64_t zigzag64(int64_t x) {
  return (static_cast<uint64_t>(x) << 1) ^ static_cast<uint64_t>(x >> 63);
}

// DELTA_BINARY_PACKED (core.encodings.delta_binary_packed_encode oracle):
// block 128, 4 miniblocks of 32; ring arithmetic in the value width (I).
template <typename I, typename U>
int delta_bp(const I* v, size_t n, uint8_t* out, size_t* out_len) {
  constexpr int kBlock = 128, kMini = 4, kMB = 32;
  uint8_t* op = out;
  op += varint(kBlock, op);
  op += varint(kMini, op);
  op += varint(n, op);
  if (n == 0) {
    op += varint(0, op);
    *out_len = static_cast<size_t>(op - out);
    return 0;
  }
  op += varint(zigzag64(static_cast<int64_t>(v[0])), op);
  if (n == 1) {
    *out_len = static_cast<size_t>(op - out);
    return 0;
  }
  const size_t nd = n - 1;
  std::vector<I> deltas(nd);
  for (size_t i = 0; i < nd; ++i)
    deltas[i] = static_cast<I>(static_cast<U>(v[i + 1]) - static_cast<U>(v[i]));
  uint64_t rel[kBlock];
  for (size_t pos = 0; pos < nd; pos += kBlock) {
    const size_t m = std::min(static_cast<size_t>(kBlock), nd - pos);
    I min_delta = deltas[pos];
    for (size_t i = 1; i < m; ++i)
      if (deltas[pos + i] < min_delta) min_delta = deltas[pos + i];
    op += varint(zigzag64(static_cast<int64_t>(min_delta)), op);
    for (size_t i = 0; i < m; ++i)
      rel[i] = static_cast<U>(static_cast<U>(deltas[pos + i]) -
                              static_cast<U>(min_delta));
    for (size_t i = m; i < kBlock; ++i) rel[i] = 0;
    uint8_t* widths = op;
    op += kMini;
    for (int mb = 0; mb < kMini; ++mb) {
      const size_t a = static_cast<size_t>(mb) * kMB;
      if (a >= m) {  // miniblock entirely past the data: width 0, no bytes
        widths[mb] = 0;
        continue;
      }
      uint64_t mx = 0;
      for (size_t i = a; i < a + kMB; ++i)
        if (rel[i] > mx) mx = rel[i];
      const int w = mx ? 64 - __builtin_clzll(mx) : 0;
      widths[mb] = static_cast<uint8_t>(w);
      if (w) op = bitpack_stream64(rel + a, kMB, w, op);
    }
  }
  *out_len = static_cast<size_t>(op - out);
  return 0;
}

// Byte-array (string) dictionary: open-addressing over (offset, len) views
// into the caller's concatenated buffer, then a lexicographic sort of the
// unique set — the same order as python bytes comparison (memcmp on the
// common prefix, shorter-is-smaller tie-break), so output matches the
// numpy/python oracle (core.encodings.dictionary_build) byte for byte.
struct BytesView {
  const uint8_t* p;
  int64_t len;
};

inline bool view_eq(const BytesView& a, const BytesView& b) {
  return a.len == b.len && std::memcmp(a.p, b.p, static_cast<size_t>(a.len)) == 0;
}

inline bool view_lt(const BytesView& a, const BytesView& b) {
  const size_t m = static_cast<size_t>(a.len < b.len ? a.len : b.len);
  const int c = std::memcmp(a.p, b.p, m);
  if (c) return c < 0;
  return a.len < b.len;
}

inline uint64_t hash_bytes(const uint8_t* p, int64_t len,
                           const uint8_t* hard_end) {
  // Word-at-a-time FNV-style fold: one multiply per 8 bytes instead of
  // per byte (typical string-column values are 4-40 B, so this is the
  // dict_build_bytes hot spot).  The tail reads a full (unaligned) word
  // and masks — a fixed-size load the compiler inlines, unlike a
  // variable-length memcpy (measured 2x slower) — except within the last
  // 8 bytes before ``hard_end`` (the packed column buffer's end), where a
  // byte loop avoids the over-read.  Only the table layout depends on the
  // hash; the emitted dictionary/indices are sorted + rank-remapped, so
  // changing it cannot change output bytes.
  uint64_t h = 0xCBF29CE484222325ull ^ static_cast<uint64_t>(len);
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    h = (h ^ w) * 0x100000001B3ull;
    h = (h << 31) | (h >> 33);
    p += 8;
    len -= 8;
  }
  if (len > 0) {
    uint64_t w;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    // the mask keeps the value's own (low-address) bytes only on
    // little-endian; big-endian takes the bytewise path so equal strings
    // hash equally regardless of where they sit in the buffer
    if (p + 8 <= hard_end) {
      std::memcpy(&w, p, 8);  // fixed-size: one unaligned load
      w &= (~0ull) >> (8 * (8 - len));
    } else
#endif
    {
      w = 0;
      for (int64_t i = 0; i < len; ++i)
        w |= static_cast<uint64_t>(p[i]) << (8 * i);
    }
    h = (h ^ w) * 0x100000001B3ull;
  }
  return mix(h);
}

int dict_build_bytes(const uint8_t* data, const int64_t* offsets, size_t n,
                     int64_t* uniq_pos_out, uint32_t* idx_out, uint32_t max_k,
                     uint32_t* k_out) {
  const uint8_t* hard_end = data + (n ? offsets[n] : 0);
  size_t cap = 1024;
  std::vector<uint32_t> ids(cap, UINT32_MAX);
  std::vector<BytesView> uniq;
  std::vector<int64_t> first_pos;
  uniq.reserve(1024);
  first_pos.reserve(1024);
  size_t mask = cap - 1;
  auto grow = [&]() {
    cap <<= 1;
    mask = cap - 1;
    ids.assign(cap, UINT32_MAX);
    for (uint32_t id = 0; id < uniq.size(); ++id) {
      size_t s =
          static_cast<size_t>(hash_bytes(uniq[id].p, uniq[id].len, hard_end)) &
          mask;
      while (ids[s] != UINT32_MAX) s = (s + 1) & mask;
      ids[s] = id;
    }
  };
  for (size_t i = 0; i < n; ++i) {
    const BytesView v{data + offsets[i], offsets[i + 1] - offsets[i]};
    size_t s = static_cast<size_t>(hash_bytes(v.p, v.len, hard_end)) & mask;
    for (;;) {
      const uint32_t id = ids[s];
      if (id == UINT32_MAX) {
        ids[s] = static_cast<uint32_t>(uniq.size());
        idx_out[i] = static_cast<uint32_t>(uniq.size());
        uniq.push_back(v);
        first_pos.push_back(static_cast<int64_t>(i));
        if (uniq.size() > max_k) return 1;  // dictionary infeasible
        if (2 * uniq.size() >= cap) grow();
        break;
      }
      if (view_eq(uniq[id], v)) {
        idx_out[i] = id;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  const size_t k = uniq.size();
  std::vector<uint32_t> order(k);
  for (uint32_t x = 0; x < k; ++x) order[x] = x;
  std::sort(order.begin(), order.end(),
            [&](uint32_t a, uint32_t b) { return view_lt(uniq[a], uniq[b]); });
  std::vector<uint32_t> rank(k);
  for (uint32_t r = 0; r < k; ++r) {
    rank[order[r]] = r;
    uniq_pos_out[r] = first_pos[order[r]];
  }
  for (size_t i = 0; i < n; ++i) idx_out[i] = rank[idx_out[i]];
  *k_out = static_cast<uint32_t>(k);
  return 0;
}

}  // namespace

extern "C" {

int kpw_dict_build_u32(const uint32_t* vals, size_t n, uint32_t* dict_out,
                       uint32_t* idx_out, uint32_t max_k, uint32_t* k_out) {
  return dict_build(vals, n, dict_out, idx_out, max_k, k_out);
}

// Fused min/max/gcd column stats (the affine dictionary planner's one
// host pass over the raw values; see int_stats above).  min/max are
// returned widened: int64 slots for signed, uint64 for unsigned.
void kpw_int_stats_i64(const int64_t* v, size_t n, int64_t* mn, int64_t* mx,
                       uint64_t* g) {
  int_stats(v, n, mn, mx, g);
}

void kpw_int_stats_i32(const int32_t* v, size_t n, int64_t* mn, int64_t* mx,
                       uint64_t* g) {
  int32_t m1, m2;
  int_stats(v, n, &m1, &m2, g);
  *mn = m1;
  *mx = m2;
}

void kpw_int_stats_u64(const uint64_t* v, size_t n, uint64_t* mn,
                       uint64_t* mx, uint64_t* g) {
  int_stats(v, n, mn, mx, g);
}

void kpw_int_stats_u32(const uint32_t* v, size_t n, uint64_t* mn,
                       uint64_t* mx, uint64_t* g) {
  uint32_t m1, m2;
  int_stats(v, n, &m1, &m2, g);
  *mn = m1;
  *mx = m2;
}

int kpw_dict_build_u64(const uint64_t* vals, size_t n, uint64_t* dict_out,
                       uint32_t* idx_out, uint32_t max_k, uint32_t* k_out) {
  return dict_build(vals, n, dict_out, idx_out, max_k, k_out);
}

// Output bound: 4 header varints (<=10 B each) + per 128-delta block one
// min-delta varint (<=10 B) + 4 width bytes + 4 miniblocks of 32 values at
// <=64 bits (256 B each).
size_t kpw_delta_bp_cap(size_t n) {
  return 64 + ((n + 127) / 128) * (14 + 4 * 256);
}

int kpw_delta_bp32(const int32_t* v, size_t n, uint8_t* out, size_t* out_len) {
  return delta_bp<int32_t, uint32_t>(v, n, out, out_len);
}

int kpw_delta_bp64(const int64_t* v, size_t n, uint8_t* out, size_t* out_len) {
  return delta_bp<int64_t, uint64_t>(v, n, out, out_len);
}

// Lexicographic min/max of a byte-array column (column statistics) — one
// memcmp pass instead of two python iterations.
void kpw_bytes_min_max(const uint8_t* data, const int64_t* offsets, size_t n,
                       size_t* min_idx, size_t* max_idx) {
  size_t mn = 0, mx = 0;
  if (n == 0) {  // keep the C entry point n==0-safe (no offsets[1] read)
    *min_idx = *max_idx = 0;
    return;
  }
  // first-byte pruning: only values whose first byte ties the current
  // min/max first byte need a full lexicographic compare — on realistic
  // string columns this skips the memcmp for almost every row
  int mn_first = (offsets[1] > offsets[0]) ? data[offsets[0]] : -1;
  int mx_first = mn_first;
  for (size_t i = 1; i < n; ++i) {
    const int64_t off = offsets[i];
    const int64_t len = offsets[i + 1] - off;
    const int first = len > 0 ? data[off] : -1;
    if (first > mn_first && first < mx_first) continue;
    const BytesView v{data + off, len};
    if (first <= mn_first) {
      const BytesView m{data + offsets[mn], offsets[mn + 1] - offsets[mn]};
      if (view_lt(v, m)) { mn = i; mn_first = first; }
    }
    if (first >= mx_first) {
      const BytesView M{data + offsets[mx], offsets[mx + 1] - offsets[mx]};
      if (view_lt(M, v)) { mx = i; mx_first = first; }
    }
  }
  *min_idx = mn;
  *max_idx = mx;
}

int kpw_dict_build_bytes(const uint8_t* data, const int64_t* offsets, size_t n,
                         int64_t* uniq_pos_out, uint32_t* idx_out,
                         uint32_t max_k, uint32_t* k_out) {
  return dict_build_bytes(data, offsets, n, uniq_pos_out, idx_out, max_k, k_out);
}

// Worst-case output bound for the hybrid stream: each 8-value group costs at
// most a 5-byte varint header plus `width` packed bytes; RLE runs are
// strictly smaller per value.
size_t kpw_rle_hybrid_cap(size_t n, int width) {
  return 64 + ((n + 7) / 8) * (5 + static_cast<size_t>(width));
}

int kpw_rle_hybrid_u32(const uint32_t* v, size_t n, int width, uint8_t* out,
                       size_t* out_len) {
  uint8_t* op = out;
  if (n == 0) {
    *out_len = 0;
    return 0;
  }
  if (width == 0) {  // single possible value: one RLE run, no value bytes
    op += varint(static_cast<uint64_t>(n) << 1, op);
    *out_len = static_cast<size_t>(op - out);
    return 0;
  }
  // Long-run mass decides pure-bitpack vs mixed (mirrors the numpy oracle).
  //
  // The scalar run scan below mispredicts on every short run, which makes
  // it the dominant cost on random low-cardinality data — exactly the data
  // that has NO long runs.  So first answer "is there any run of >= 8 equal
  // values?" branchlessly: build a bitmap of adjacent-equal pairs (a value
  // run of length L is L-1 consecutive set bits) and AND seven shifted
  // copies over a 128-bit window so cross-word runs are seen.  Only when a
  // long run exists (runny data, where the scalar scan is cheap — few run
  // boundaries) does the exact mass computation run.
  uint64_t long_mass = 0;
  bool any_long = false;
  {
    // rolling two-word window: test starts in `prev` with `cur` appended
    // so cross-word runs are seen; early-exits on the first hit (an
    // all-equal column is detected after ~two words), no allocation
    const size_t pairs = n - 1;
    const size_t words = (pairs + 63) / 64;
    auto window_hit = [](uint64_t low, uint64_t high) -> bool {
      const unsigned __int128 x =
          static_cast<unsigned __int128>(low) |
          (static_cast<unsigned __int128>(high) << 64);
      unsigned __int128 t = x;
      for (int s = 1; s <= 6; ++s) t &= x >> s;
      return static_cast<uint64_t>(t) != 0;  // a 7-pair start in `low`
    };
    uint64_t prev = 0;
    for (size_t w = 0; w < words; ++w) {
      const size_t base = w * 64;
      const size_t m = std::min<size_t>(64, pairs - base);
      uint64_t bits = 0;
#ifdef __AVX512BW__
      if (m == 64) {
        // 16 adjacent-equal pairs per mask compare: the pair bitmap falls
        // straight out of _mm512_cmpeq_epi32_mask on (v[i], v[i+1]) lanes
        // — the scalar loop below was the detector's whole cost on
        // run-free data (the common cfg2 shape).
        for (int q = 0; q < 4; ++q) {
          const __m512i a =
              _mm512_loadu_si512(reinterpret_cast<const void*>(v + base + 16 * q));
          const __m512i b = _mm512_loadu_si512(
              reinterpret_cast<const void*>(v + base + 16 * q + 1));
          bits |= static_cast<uint64_t>(_mm512_cmpeq_epi32_mask(a, b))
                  << (16 * q);
        }
      } else
#endif
      {
        for (size_t b = 0; b < m; ++b)
          bits |= static_cast<uint64_t>(v[base + b] == v[base + b + 1]) << b;
      }
      if (w > 0 && window_hit(prev, bits)) {
        any_long = true;
        break;
      }
      prev = bits;
    }
    if (!any_long && words > 0 && window_hit(prev, 0)) any_long = true;
  }
  if (any_long) {
    for (size_t i = 0; i < n;) {
      size_t j = i + 1;
      while (j < n && v[j] == v[i]) ++j;
      if (j - i >= 8) long_mass += j - i;
      i = j;
    }
  }
  uint64_t thresh = n / 10;
  if (thresh < 8) thresh = 8;
  if (long_mass < thresh) {
    const size_t groups = (n + 7) / 8;
    op += varint((static_cast<uint64_t>(groups) << 1) | 1, op);
    const size_t full = n & ~static_cast<size_t>(7);
    op = bitpack_stream(v, full, width, op);
    if (n != full) {
      uint32_t tail[8] = {0};
      std::memcpy(tail, v + full, (n - full) * sizeof(uint32_t));
      op = bitpack_stream(tail, 8, width, op);
    }
    *out_len = static_cast<size_t>(op - out);
    return 0;
  }
  const int nbytes = (width + 7) / 8;
  std::vector<uint32_t> buf;
  buf.reserve(4096);
  auto flush = [&]() {
    if (buf.empty()) return;
    const size_t groups = (buf.size() + 7) / 8;
    buf.resize(groups * 8, 0);
    op += varint((static_cast<uint64_t>(groups) << 1) | 1, op);
    op = bitpack_stream(buf.data(), buf.size(), width, op);
    buf.clear();
  };
  for (size_t i = 0; i < n;) {
    const uint32_t rv = v[i];
    size_t j = i + 1;
    while (j < n && v[j] == rv) ++j;
    size_t rl = j - i;
    i = j;
    if (buf.size() % 8) {  // top up the open 8-value group first
      const size_t take = std::min(8 - buf.size() % 8, rl);
      buf.insert(buf.end(), take, rv);
      rl -= take;
    }
    if (rl >= 8) {
      flush();
      op += varint(static_cast<uint64_t>(rl) << 1, op);
      for (int b = 0; b < nbytes; ++b) *op++ = static_cast<uint8_t>(rv >> (8 * b));
      rl = 0;
    }
    if (rl) buf.insert(buf.end(), rl, rv);
  }
  flush();
  *out_len = static_cast<size_t>(op - out);
  return 0;
}

// Mixed RLE/bit-pack assembly driven from a precomputed run list — the C
// twin of core.encodings.rle_hybrid_from_runs (byte-identical by
// construction: same top-up / flush / RLE-threshold walk), so a device
// run-scan (ops/levels.py) can hand its compact run table STRAIGHT to the
// nogil page assembler instead of replaying the runs through a Python
// loop.  ``out`` needs kpw_rle_hybrid_cap(sum(run_lens), width) bytes;
// non-positive run lengths are skipped (padded device slots).
int kpw_rle_hybrid_from_runs_u32(const uint32_t* run_vals,
                                 const int32_t* run_lens, size_t n_runs,
                                 int width, uint8_t* out, size_t* out_len) {
  uint8_t* op = out;
  if (width == 0) {  // single possible value: one RLE run, no value bytes
    uint64_t total = 0;
    for (size_t r = 0; r < n_runs; r++)
      if (run_lens[r] > 0) total += static_cast<uint64_t>(run_lens[r]);
    if (total) op += varint(total << 1, op);
    *out_len = static_cast<size_t>(op - out);
    return 0;
  }
  const int nbytes = (width + 7) / 8;
  std::vector<uint32_t> buf;
  buf.reserve(4096);
  auto flush = [&]() {
    if (buf.empty()) return;
    const size_t groups = (buf.size() + 7) / 8;
    buf.resize(groups * 8, 0);
    op += varint((static_cast<uint64_t>(groups) << 1) | 1, op);
    op = bitpack_stream(buf.data(), buf.size(), width, op);
    buf.clear();
  };
  for (size_t r = 0; r < n_runs; r++) {
    if (run_lens[r] <= 0) continue;
    const uint32_t rv = run_vals[r];
    size_t rl = static_cast<size_t>(run_lens[r]);
    if (buf.size() % 8) {  // top up the open 8-value group first
      const size_t take = std::min(8 - buf.size() % 8, rl);
      buf.insert(buf.end(), take, rv);
      rl -= take;
    }
    if (rl >= 8) {
      flush();
      op += varint(static_cast<uint64_t>(rl) << 1, op);
      for (int b = 0; b < nbytes; ++b)
        *op++ = static_cast<uint8_t>(rv >> (8 * b));
      rl = 0;
    }
    if (rl) buf.insert(buf.end(), rl, rv);
  }
  flush();
  *out_len = static_cast<size_t>(op - out);
  return 0;
}

// BYTE_STREAM_SPLIT: scatter the K byte planes of n K-byte
// values — plane j collects byte j of every value in order.  Output is
// exactly n*width bytes (same count as PLAIN; the win is that grouped
// same-significance bytes compress far better).  The C twin of
// core.encodings.byte_stream_split_encode and the object code the
// nogil assembler's kOpBss op shares (both .so builds compile this file).
int kpw_byte_stream_split(const uint8_t* in, size_t n, size_t width,
                          uint8_t* out) {
  if (width == 0) return 1;
  // plane-major walk: each output plane is a sequential write while the
  // strided reads stay within one cache line per value — measurably
  // faster than value-major scatter for the 4/8-byte widths used here
  for (size_t w = 0; w < width; w++) {
    uint8_t* op = out + w * n;
    const uint8_t* ip = in + w;
    for (size_t i = 0; i < n; i++) op[i] = ip[i * width];
  }
  return 0;
}

}  // extern "C"
