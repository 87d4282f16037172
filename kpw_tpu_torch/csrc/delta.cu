// DELTA_BINARY_PACKED device phase of P page windows on Hopper (sm_90a).
//
// Stands for the JAX package's XLA code kpw_tpu/ops/delta.py:_delta_window
// (vmapped over pages by delta_pages_multi); the JAX package has no Pallas
// kernel for it.
//
// Function.  streams is a (rows, ld) batch of signed values, int64 for the
// 64-bit ring or int32 for the 32-bit ring.  Page p is a row of the (P, 3)
// int32 page table, (row, start, count); its window holds bucket + 1 values
// w[i] = streams[row, start + i] (0 past ld) and its deltas are
// d[i] = w[i+1] - w[i] in the ring, valid for i < count - 1.  For each block
// of 128 deltas the kernel writes
//   - mins[p, b]: the signed minimum of the block's valid deltas, as int64
//     (a block with no valid delta keeps its first delta, d[128 b]);
//   - widths[p, b, m]: the bit width of the largest rel = d - min over the
//     valid deltas of miniblock m (32 deltas), 0 when it has none;
//   - packed[p, b, m, :]: a slot of 4 * max_bits bytes holding the 32 rel
//     values of miniblock m packed LSB-first at that width (invalid deltas
//     pack as 0), zero past 4 * width bytes.  A width above max_bits is cut
//     at the slot's end; the host sees every width and refuses such a page.
//
// Bound on the H100: memory.  The least it must move is each page's count
// values once, the page table, and the outputs of the ceil((count - 1) / 128)
// blocks that hold deltas once (8 + 16 + 16 * max_bits bytes a block); the
// blocks past them up to the bucket, which the host never reads, are written
// too, as overhead outside the bound.  A few dozen integer operations a value
// are far below the card's operations-per-byte line.
//
// Design.  One 128-thread block per (page, delta block), so warp m owns
// miniblock m and thread t owns delta t.  Each thread loads the two values
// of its delta (the second load of a neighbour's value hits L1).  The block
// minimum is a warp shuffle reduction plus four words of shared memory; the
// width is one __reduce_max_sync of (bits - clz).  The pack needs no shared
// memory: for each output word k < width (a warp-uniform loop) every lane
// shifts its value to where it lands in word k and __reduce_or_sync joins
// them (bit ranges of different lanes are disjoint); lane k % 32 keeps the
// word and the lanes store their words, and the zero tail of the slot, with
// 4-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 128;  // deltas a block, 4 miniblocks of 32

template <typename T>
__global__ void __launch_bounds__(kBlock)
delta_kernel(const T* __restrict__ streams, int rows, long long ld,
             const int* __restrict__ table, int blocks, int max_bits,
             long long* __restrict__ mins, int* __restrict__ widths,
             uint32_t* __restrict__ packed) {
  using U = typename std::make_unsigned<T>::type;
  constexpr int kBits = 8 * sizeof(T);
  constexpr T kMax = (T)(~(U)0 >> 1);
  __shared__ T warp_min[kBlock / 32];
  __shared__ int warp_any[kBlock / 32];
  __shared__ T first_delta;

  const long long p = blockIdx.x / blocks;
  const int b = blockIdx.x % blocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = table[3 * p], start = table[3 * p + 1];
  const int count = table[3 * p + 2];

  const long long i = (long long)b * kBlock + tid;  // this thread's delta
  const bool row_ok = row >= 0 && row < rows && start >= 0;
  const T* src = streams + (long long)(row_ok ? row : 0) * ld + start;
  const long long lim = row_ok ? ld - start : 0;  // window positions < lim exist
  const U w0 = i < lim ? (U)__ldg(src + i) : 0;
  const U w1 = i + 1 < lim ? (U)__ldg(src + i + 1) : 0;
  const T d = (T)(U)(w1 - w0);  // ring subtraction, wrapping
  const bool valid = i < (long long)count - 1;

  // signed minimum over the block's valid deltas
  T key = valid ? d : kMax;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
    key = other < key ? other : key;
  }
  const int any = __any_sync(0xFFFFFFFFu, valid);
  if (lane == 0) {
    warp_min[warp] = key;
    warp_any[warp] = any;
  }
  if (tid == 0) first_delta = d;
  __syncthreads();
  T mn = kMax;
  bool block_any = false;
#pragma unroll
  for (int k = 0; k < kBlock / 32; ++k) {
    if (warp_any[k]) {
      block_any = true;
      mn = warp_min[k] < mn ? warp_min[k] : mn;
    }
  }
  if (!block_any) mn = first_delta;

  // this miniblock's width and its LSB-first pack
  const U rel = valid ? (U)((U)d - (U)mn) : (U)0;
  int bits;
  if constexpr (kBits == 64) {
    bits = 64 - __clzll((long long)rel);
  } else {
    bits = 32 - __clz((int)rel);
  }
  const int w = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)bits);
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

  const long long blk = p * blocks + b;
  uint32_t* slot = packed + (blk * 4 + warp) * (long long)max_bits;
  if (lane < max_bits) slot[lane] = lane < w ? mine0 : 0u;
  if (32 + lane < max_bits) slot[32 + lane] = 32 + lane < w ? mine1 : 0u;
  if (lane == 0) widths[blk * 4 + warp] = w;
  if (tid == 0) mins[blk] = (long long)mn;
}

}  // namespace

// streams: (rows, ld) int64 (ring64 != 0) or int32; table: (P, 3) int32
// (row, start, count); bucket: deltas a page, a positive multiple of 128;
// max_bits: 1..64 (1..32 for the 32-bit ring), the slot size in words.
// Outputs: mins (P, bucket/128) int64, widths (P, bucket/128, 4) int32,
// packed (P, bucket/128, 4, 4*max_bits) bytes, 4-byte aligned.  Launches on
// `stream` of `device`; returns the first cudaError_t of the launch.
extern "C" int kpw_delta_pages(const void* streams, int rows, long long ld,
                               int ring64, const void* table, int P, int bucket,
                               int max_bits, void* mins, void* widths,
                               void* packed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ring_bits = ring64 ? 64 : 32;
  if (bucket <= 0 || bucket % kBlock || P < 0 || ld < 0 || max_bits < 1 ||
      max_bits > ring_bits)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int blocks = bucket / kBlock;
  const unsigned grid = (unsigned)((long long)P * blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  const int* tab = (const int*)table;
  if (ring64) {
    delta_kernel<long long><<<grid, kBlock, 0, s>>>(
        (const long long*)streams, rows, ld, tab, blocks, max_bits,
        (long long*)mins, (int*)widths, (uint32_t*)packed);
  } else {
    delta_kernel<int><<<grid, kBlock, 0, s>>>(
        (const int*)streams, rows, ld, tab, blocks, max_bits,
        (long long*)mins, (int*)widths, (uint32_t*)packed);
  }
  return (int)cudaGetLastError();
}
