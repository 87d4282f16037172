// DELTA_BINARY_PACKED page streams of P page windows on Hopper (sm_90a).
//
// Stands for the JAX package's XLA code kpw_tpu/ops/delta.py:_delta_window
// (vmapped over pages by delta_pages_multi) together with the host loop
// that turns its outputs into page bytes (assemble_delta_page); the JAX
// package has no Pallas kernel for it.
//
// Function.  streams is a (rows, ld) batch of signed values, int64 for the
// 64-bit ring or int32 for the 32-bit ring.  Page p is a row of the (P, 3)
// int32 page table, (row, start, count); its window values are
// w[i] = streams[row, start + i] (0 past ld) and its deltas
// d[i] = w[i+1] - w[i] in the ring, for i < count - 1.  The page's deltas
// fall in ceil((count - 1) / 128) blocks; bstart (P + 1 int32) is the
// exclusive prefix of those block counts, so the launch holds
// nblocks = bstart[P] blocks in page order and no padding.  Each block
// writes, back to back after the blocks before it:
//   - the ULEB128 varint of zigzag(min), min the signed minimum of its
//     deltas (sign-extended to 64 bits: up to 10 bytes);
//   - the four miniblock bit widths, one byte each (the width of the
//     largest rel = d - min of the miniblock's deltas, 0 without one);
//   - for each miniblock of width w > 0, its 32 rel values packed LSB-first
//     in 4 w bytes (rel past the last delta packs as 0).
// This is exactly the part of core.encodings.delta_binary_packed_encode
// after the page header.  offsets[p] (P + 1 int64) is the byte offset of
// page p's first block, offsets[P] the total.  Bytes at or past `capacity`
// are not written: the host sizes capacity from a bound on every width
// (max_bits), so a miniblock wider than max_bits means that bound was wrong;
// the launch then records the widest such width in over, and the host
// refuses the pages instead of writing them short.
//
// Bound on the H100: memory.  The least it must move is each page's count
// values once, the page table and block prefix, the body bytes and the
// offsets once.  A few dozen integer operations a value are far below the
// card's operations-per-byte line.
//
// Design.  One 128-thread block per delta block, so warp m owns miniblock m
// and thread t owns delta t.  The block index is an atomic ticket, not
// blockIdx, so that the look-back below waits only on blocks that already
// run (a grid larger than the resident set cannot deadlock).  The block
// stages its 129 window values in shared memory with one coalesced load a
// thread (the 129th by thread 0), so every value is read from device memory
// once, bar one at each block edge.  The minimum is a warp shuffle reduction
// plus four words of shared memory; each width one __reduce_max_sync; the
// pack needs no shared memory: for each output word k < width (a
// warp-uniform loop) every lane shifts its value to where it lands in word
// k and __reduce_or_sync joins them.  The block's bytes are staged in
// shared memory, its byte length L = varint + 4 + 4 * sum(w) is known, and
// its byte offset comes from a single-pass exclusive scan over the blocks
// with decoupled look-back (Merrill & Garland, 2016): the block publishes L
// as its aggregate, then warp 0 reads the states of the 32 blocks before it
// at once, sums them back to the nearest inclusive prefix (a ballot finds
// it), moves 32 blocks further back if there is none, and publishes the
// block's own inclusive prefix.  (A single thread walking back one block a
// read measured 0.036 ms for 4,096 blocks on the H100: a chain of
// dependent reads.)
// Each state word holds the flag and the value together, so one 64-bit
// exchange publishes both.  The offsets are byte-granular, so the block's
// threads copy its staged bytes out with byte stores.  The state arrives
// zeroed with the page table in the host's one upload, so a launch needs no
// memset before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 128;  // deltas a block, 4 miniblocks of 32
constexpr int kMaxBytes = 10 + 4 + 4 * 4 * 64;  // the widest block
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

// the page that holds launch block g: bstart[lo] <= g < bstart[lo + 1]
__device__ int page_of(const int* __restrict__ bstart, int P, int g) {
  int lo = 0, hi = P;  // bstart[0] = 0 <= g < bstart[P] = nblocks
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (bstart[mid] <= g) lo = mid;
    else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
delta_streams_kernel(const T* __restrict__ streams, int rows, long long ld,
                     const int* __restrict__ table,
                     const int* __restrict__ bstart, int P, int nblocks,
                     int max_bits, unsigned long long capacity,
                     uint8_t* __restrict__ out, long long* __restrict__ offsets,
                     unsigned long long* state) {
  using U = typename std::make_unsigned<T>::type;
  constexpr int kBits = 8 * sizeof(T);
  constexpr T kMax = (T)(~(U)0 >> 1);
  __shared__ T vals[kBlock + 1];
  __shared__ T warp_min[kBlock / 32];
  __shared__ int warp_w[kBlock / 32];
  __shared__ uint8_t stage[kMaxBytes];
  __shared__ int s_g;
  __shared__ unsigned long long s_excl;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_g = (int)atomicAdd(&state[nblocks], 1ull);
  __syncthreads();
  const int g = s_g;
  const int p = page_of(bstart, P, g);
  const int b = g - bstart[p];
  const int row = table[3 * p], start = table[3 * p + 1];
  const int count = table[3 * p + 2];

  // the window values of this block's deltas, each loaded once
  const bool row_ok = row >= 0 && row < rows && start >= 0;
  const T* src = streams + (long long)(row_ok ? row : 0) * ld + start;
  long long lim = row_ok ? ld - start : 0;  // window positions that exist
  if (lim > count) lim = count;             // and that a delta reads
  const long long base = (long long)b * kBlock;
  vals[tid] = base + tid < lim ? __ldg(src + base + tid) : (T)0;
  if (tid == 0) vals[kBlock] = base + kBlock < lim ? __ldg(src + base + kBlock) : (T)0;
  __syncthreads();
  const bool valid = base + tid < (long long)count - 1;
  const T d = (T)(U)((U)vals[tid + 1] - (U)vals[tid]);  // ring subtraction

  // signed minimum over the block's deltas (every block holds one)
  T key = valid ? d : kMax;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
    key = other < key ? other : key;
  }
  if (lane == 0) warp_min[warp] = key;
  __syncthreads();
  T mn = warp_min[0];
#pragma unroll
  for (int k = 1; k < kBlock / 32; ++k) mn = warp_min[k] < mn ? warp_min[k] : mn;

  // this miniblock's width and its LSB-first pack
  const U rel = valid ? (U)((U)d - (U)mn) : (U)0;
  int bits;
  if constexpr (kBits == 64) {
    bits = 64 - __clzll((long long)rel);
  } else {
    bits = 32 - __clz((int)rel);
  }
  const int w = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)bits);
  if (lane == 0) {
    warp_w[warp] = w;
    if (w > max_bits) atomicMax(&state[nblocks + 1], (unsigned long long)w);
  }
  uint32_t mine0 = 0, mine1 = 0;  // words lane and 32 + lane of the pack
  for (int k = 0; k < w; ++k) {
    const int off = lane * w - 32 * k;  // where this lane's bit 0 lands in word k
    uint32_t c = 0;
    if (off >= 0 && off < 32) {
      c = (uint32_t)(rel << off);
    } else if (off < 0 && off + w > 0) {
      c = (uint32_t)(rel >> -off);
    }
    const uint32_t word = __reduce_or_sync(0xFFFFFFFFu, c);
    if (lane == (k & 31)) {
      if (k < 32) mine0 = word;
      else mine1 = word;
    }
  }
  __syncthreads();  // warp_w complete

  // the block's byte layout: varint(zigzag(min)), 4 widths, packed miniblocks
  const long long m64 = (long long)mn;
  const unsigned long long z =
      ((unsigned long long)m64 << 1) ^ (unsigned long long)(m64 >> 63);
  int vlen = 1;
  while (vlen < 10 && (z >> (7 * vlen)) != 0) ++vlen;
  const int hdr = vlen + 4;
  int mb_off = hdr, L = hdr;
#pragma unroll
  for (int k = 0; k < kBlock / 32; ++k) {
    if (k < warp) mb_off += 4 * warp_w[k];
    L += 4 * warp_w[k];
  }
  if (tid < vlen) {
    const uint8_t low = (uint8_t)((z >> (7 * tid)) & 0x7F);
    stage[tid] = tid + 1 < vlen ? (uint8_t)(low | 0x80) : low;
  } else if (tid < hdr) {
    stage[tid] = (uint8_t)warp_w[tid - vlen];
  }
  if (lane < w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) stage[mb_off + 4 * lane + j] = (uint8_t)(mine0 >> (8 * j));
  }
  if (32 + lane < w) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage[mb_off + 4 * (32 + lane) + j] = (uint8_t)(mine1 >> (8 * j));
  }

  // the block's byte offset: warp 0 looks back over 32 blocks at a time
  if (warp == 0) {
    unsigned long long excl = 0;
    if (g == 0) {
      if (lane == 0) atomicExch(&state[0], kPrefix | (unsigned long long)L);
    } else {
      if (lane == 0) atomicExch(&state[g], kAggregate | (unsigned long long)L);
      for (int j = g - 1;; j -= 32) {
        const int idx = j - lane;  // lane 0 is the nearest block
        unsigned long long s = kPrefix;  // before block 0: a prefix of 0
        if (idx >= 0) {
          while (((s = *(volatile unsigned long long*)&state[idx]) >> 62) == 0) {
            __nanosleep(20);
          }
        }
        const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, (s >> 62) == 2);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned long long v = lane <= stop ? (s & kValue) : 0ull;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
        excl += v;
        if (prefixes) break;
      }
      if (lane == 0) atomicExch(&state[g], kPrefix | (excl + (unsigned long long)L));
    }
    if (lane == 0) s_excl = excl;
  }
  if (tid == 0) {
    const unsigned long long excl = s_excl;
    // the offsets of the pages that start here (empty pages share them)
    if (b == 0) {
      for (int q = p; q >= 0 && bstart[q] == g; --q) offsets[q] = (long long)excl;
    }
    if (g == nblocks - 1) {
      for (int q = P; q >= 0 && bstart[q] == nblocks; --q)
        offsets[q] = (long long)(excl + (unsigned long long)L);
    }
  }
  __syncthreads();
  const unsigned long long excl = s_excl;
  for (int k = tid; k < L; k += kBlock) {
    const unsigned long long pos = excl + (unsigned long long)k;
    if (pos < capacity) out[pos] = stage[k];
  }
}

template <typename T>
void launch(const void* streams, int rows, long long ld, const int* meta, int P,
            int nblocks, int max_bits, unsigned long long capacity, void* out,
            void* offsets, void* state, cudaStream_t s) {
  delta_streams_kernel<T><<<(unsigned)nblocks, kBlock, 0, s>>>(
      (const T*)streams, rows, ld, meta, meta + 3 * P, P, nblocks, max_bits,
      capacity, (uint8_t*)out, (long long*)offsets, (unsigned long long*)state);
}

}  // namespace

// streams: (rows, ld) int64 (ring64 != 0) or int32; meta: the (P, 3) int32
// page table (row, start, count) followed by the P + 1 int32 block prefix
// bstart (nblocks = bstart[P] > 0); max_bits: 1..64 (1..32 for the 32-bit
// ring), the width bound capacity was sized from; out: capacity bytes;
// offsets: P + 1 int64; state: nblocks + 2 uint64, zero (look-back states,
// the ticket, the widest width over max_bits), so a launch runs once on a
// state.  Launches on `stream` of `device`; returns the first cudaError_t of
// the launch.
extern "C" int kpw_delta_streams(const void* streams, int rows, long long ld,
                                 int ring64, const void* meta, int P, int nblocks,
                                 int max_bits, unsigned long long capacity,
                                 void* out, void* offsets, void* state, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ring_bits = ring64 ? 64 : 32;
  if (P <= 0 || nblocks <= 0 || ld < 0 || max_bits < 1 || max_bits > ring_bits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* m = (const int*)meta;
  if (ring64) {
    launch<long long>(streams, rows, ld, m, P, nblocks, max_bits, capacity, out,
                      offsets, state, s);
  } else {
    launch<int>(streams, rows, ld, m, P, nblocks, max_bits, capacity, out,
                offsets, state, s);
  }
  return (int)cudaGetLastError();
}
