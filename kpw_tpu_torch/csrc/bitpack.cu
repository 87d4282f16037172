// Fused page-window bit-pack of P pages on Hopper (sm_90a).
//
// Replaces the TPU kernel kpw_tpu/ops/pallas_bitpack.py:_bitpack_kernel
// together with the window slice, the mask and the run statistics that the
// JAX package runs around it (kpw_tpu/ops/packing.py:pack_pages_multi over
// _slice_mask_stats and _run_long_stats).
//
// Function.  idx is a (rows, ld) batch of 32-bit values; page p is described
// by a row of the (P, 3) int32 page table, (row, start, count).  Value i of
// page p is idx[row, start + i] for i < count and start + i < ld, else 0.
// The page packs LSB-first at `width` bits a value (bit j of value i at
// stream bit i*width + j) into bucket*width/8 bytes.  Optionally long_sum[p]
// is the total length of the runs of >= 8 equal values among the page's
// first `count` values: #(>= 8th element of its run) + 7 * #(exactly 8th),
// the decision mass of the RLE-vs-bit-pack choice, and optionally n_runs[p]
// the number of run starts among those values (the page's first value always
// starts one; no position before `start` ever does).  A null page table means
// page p is row p, start 0, and one count for every page, read on the
// device from count_ptr when that is not null.
//
// Bound on the H100: memory.  The least it must move is each page's valid
// values once (4 bytes each), the packed bytes once, and 4 bytes of long_sum
// a page; a few integer operations a value are far below the card's
// operations-per-byte line.
//
// Design.  A block owns a span of kSpan values of one page.  It stages the
// span plus the 8 values before it (the halo that run starts at the span's
// head need) into shared memory, with 16-byte loads over the aligned middle
// of the window (start is arbitrary) and zeros wherever the window holds no
// valid value; no padded copy of idx is made.  Shared memory is padded by
// one word every 32, so that thread t reading its 40 consecutive values
// (32 own + 8 halo) hits 32 distinct banks.  Each thread then owns 32
// values, which make exactly `width` output words: the width is a template
// parameter, so the packing is straight register code with constant
// shifts.  The run statistics come from the same registers as 64-bit masks
// (run starts, the 6 positions behind each, the one 7 behind), are summed
// by warp shuffles and land with one integer atomicAdd a block into a
// long_sum zeroed on the same stream (integer sums: exact in any order);
// n_runs is the popcount of the same run-start mask, summed the same way.
// The words go back into the padded shared memory and leave with 16-byte
// stores.  Spans that lie wholly past the page's count store zeros only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 32;  // 32 values of w bits make exactly w words
constexpr int kSpan = kThreads * kPerThread;
constexpr int kHalo = 8;

__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

constexpr int kSmemWords = kHalo + kSpan + (kHalo + kSpan) / 32 + 1;

template <int W>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ idx, int rows, long long ld,
            const int* __restrict__ table, const int* __restrict__ count_ptr,
            int all_count, int bucket, int spans, uint8_t* __restrict__ out,
            int* __restrict__ long_sum, int* __restrict__ n_runs) {
  __shared__ uint32_t sm[kSmemWords];
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int warp_runs[kThreads / 32];
  const int tid = threadIdx.x;
  const long long p = blockIdx.x / spans;
  const int s0 = (int)(blockIdx.x % spans) * kSpan;
  const int n = min(kSpan, bucket - s0);  // values of this span, a multiple of 8

  int row = (int)p, start = 0;
  int count = count_ptr ? *count_ptr : all_count;
  if (table) {
    row = table[3 * p];
    start = table[3 * p + 1];
    count = table[3 * p + 2];
  }
  const int cnt = max(0, min(count, bucket));
  uint8_t* dst = out + p * ((long long)bucket * W / 8) + (long long)s0 * W / 8;
  const int nbytes = n * W / 8;
  const bool wide = ((uintptr_t)dst & 15) == 0 && (nbytes & 15) == 0;

  if (s0 >= cnt) {  // the whole span lies past the count: zeros
    if (wide) {
      for (int i = tid; i < nbytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
    } else {
      for (int i = tid; i < nbytes; i += kThreads) dst[i] = 0;
    }
    return;
  }

  // Page positions [r0, r0 + rtot) are staged at sm[padded(pos - r0)];
  // only [lo, hi) hold values read from idx, everything else is 0.
  const int r0 = s0 - kHalo;
  const int rtot = kHalo + ((n + 31) & ~31);
  int lo = max(r0, 0), hi = min(s0 + n, cnt);
  if (row < 0 || row >= rows || start < 0) hi = lo;
  const long long lim = ld - start;  // positions at or past it read as 0
  if ((long long)hi > lim) hi = (int)max((long long)lo, lim);
  const uint32_t* src = idx + (long long)(row < 0 ? 0 : row) * ld + start;

  // every 16-byte load of the thread in flight before anything else
  const long long a0 = (long long)(src - idx) + lo;  // element offset
  const int head = min((int)((4 - (a0 & 3)) & 3), hi - lo);
  const int m0 = lo + head;
  const int n4 = (hi - m0) >> 2;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + m0);
  constexpr int kLoads = (kSpan + kHalo) / 4 / kThreads + 1;
  uint4 q[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = u * kThreads + tid;
    if (i < n4) q[u] = __ldg(s4 + i);
  }
  const int t0 = m0 + 4 * n4;  // the unaligned head and tail: 0..3 values each
  if (tid < head) sm[padded(lo + tid - r0)] = __ldg(src + lo + tid);
  if (t0 + tid < hi) sm[padded(t0 + tid - r0)] = __ldg(src + t0 + tid);
  // zeros where the window holds no value: before lo and from hi on
  for (int r = tid; r < lo - r0; r += kThreads) sm[padded(r)] = 0;
  for (int r = hi - r0 + tid; r < rtot; r += kThreads) sm[padded(r)] = 0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = u * kThreads + tid;
    if (i < n4) {
      const int r = m0 + 4 * i - r0;
      sm[padded(r)] = q[u].x;
      sm[padded(r + 1)] = q[u].y;
      sm[padded(r + 2)] = q[u].z;
      sm[padded(r + 3)] = q[u].w;
    }
  }
  __syncthreads();

  // thread t: values at staged positions 32t .. 32t+39, the first 8 the halo
  const bool active = kPerThread * tid < n;
  uint32_t v[kHalo + kPerThread];
#pragma unroll
  for (int b = 0; b < kHalo + kPerThread; ++b)
    v[b] = active ? sm[padded(kPerThread * tid + b)] : 0u;

  if (long_sum || n_runs) {
    int sum = 0, runs = 0;
    if (active) {
      // bit b of each mask stands for page position q0 + b
      const int q0 = r0 + kPerThread * tid;
      uint64_t valid = 0, starts = 0;
#pragma unroll
      for (int b = 1; b < kHalo + kPerThread; ++b) {
        const int q = q0 + b;
        if (q >= 0 && q < cnt) {
          valid |= 1ull << b;
          if (q == 0 || v[b] != v[b - 1]) starts |= 1ull << b;
        }
      }
      uint64_t near = starts;
#pragma unroll
      for (int k = 1; k < 7; ++k) near |= starts << k;
      const uint64_t own = 0xFFFFFFFFull << kHalo;
      const uint64_t ge8 = valid & ~near & own;
      const uint64_t ex8 = ge8 & (starts << 7);
      sum = __popcll(ge8) + 7 * __popcll(ex8);
      runs = __popcll(starts & own);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    if (n_runs) {  // the same for every thread: no divergence
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        runs += __shfl_down_sync(0xFFFFFFFFu, runs, off);
    }
    if ((tid & 31) == 0) {
      warp_sums[tid >> 5] = sum;
      warp_runs[tid >> 5] = runs;
    }
  }

  uint32_t words[W];
#pragma unroll
  for (int k = 0; k < W; ++k) words[k] = 0;
  const uint32_t mask = (W == 32) ? 0xFFFFFFFFu : ((1u << (W & 31)) - 1u);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const uint32_t x = v[kHalo + j] & mask;
    const int bit = j * W;
    const int q = bit >> 5, s = bit & 31;
    words[q] |= x << s;
    if (s + W > 32) words[q + 1] |= x >> (32 - s);
  }
  __syncthreads();  // every thread has read its values: reuse sm for words
  if (active) {
#pragma unroll
    for (int k = 0; k < W; ++k) sm[padded(W * tid + k)] = words[k];
  }
  __syncthreads();

  if ((long_sum || n_runs) && tid == 0) {
    int total = 0, runs = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      total += warp_sums[w];
      runs += warp_runs[w];
    }
    if (long_sum && total) atomicAdd(long_sum + p, total);
    if (n_runs && runs) atomicAdd(n_runs + p, runs);
  }
  if (wide) {
    for (int i = tid; i < nbytes / 16; i += kThreads) {
      uint4 q;
      q.x = sm[padded(4 * i)];
      q.y = sm[padded(4 * i + 1)];
      q.z = sm[padded(4 * i + 2)];
      q.w = sm[padded(4 * i + 3)];
      reinterpret_cast<uint4*>(dst)[i] = q;
    }
  } else {
    for (int i = tid; i < nbytes; i += kThreads)
      dst[i] = (uint8_t)(sm[padded(i >> 2)] >> (8 * (i & 3)));
  }
}

}  // namespace

// idx: (rows, ld) 32-bit values, 16-byte aligned; table: (P, 3) int32
// (row, start, count), or null for rows 0..P-1 from start 0 with one
// count each (from count_ptr on the device when it is not null, else
// all_count); out: (P,
// bucket*width/8) bytes; long_sum, n_runs: (P,) int32, each zeroed here,
// or null for none.  bucket % 8 == 0, width in 1..32.  Launches on `stream`
// of `device`; returns the first cudaError_t of the memset and the launch.
extern "C" int kpw_pack_pages(const void* idx, int rows, long long ld,
                              const void* table, const void* count_ptr,
                              int all_count, int P,
                              int bucket, int width, void* out, void* long_sum,
                              void* n_runs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bucket <= 0 || bucket % 8 || width < 1 || width > 32 || P < 0 || ld < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  void* const stats[2] = {long_sum, n_runs};
  for (void* stat : stats) {
    if (!stat) continue;
    err = cudaMemsetAsync(stat, 0, (size_t)P * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (P == 0) return 0;
  const int spans = (bucket + kSpan - 1) / kSpan;
  const unsigned blocks = (unsigned)((long long)P * spans);
  const uint32_t* in = (const uint32_t*)idx;
  const int* tab = (const int*)table;
  const int* cp = (const int*)count_ptr;
  uint8_t* o = (uint8_t*)out;
  int* ls = (int*)long_sum;
  int* nr = (int*)n_runs;
  switch (width) {
#define KPW_PACK_CASE(W)                                                   \
  case W:                                                                  \
    pack_kernel<W><<<blocks, kThreads, 0, s>>>(in, rows, ld, tab, cp,     \
                                               all_count, bucket, spans,  \
                                               o, ls, nr);                \
    break;
    KPW_PACK_CASE(1) KPW_PACK_CASE(2) KPW_PACK_CASE(3) KPW_PACK_CASE(4)
    KPW_PACK_CASE(5) KPW_PACK_CASE(6) KPW_PACK_CASE(7) KPW_PACK_CASE(8)
    KPW_PACK_CASE(9) KPW_PACK_CASE(10) KPW_PACK_CASE(11) KPW_PACK_CASE(12)
    KPW_PACK_CASE(13) KPW_PACK_CASE(14) KPW_PACK_CASE(15) KPW_PACK_CASE(16)
    KPW_PACK_CASE(17) KPW_PACK_CASE(18) KPW_PACK_CASE(19) KPW_PACK_CASE(20)
    KPW_PACK_CASE(21) KPW_PACK_CASE(22) KPW_PACK_CASE(23) KPW_PACK_CASE(24)
    KPW_PACK_CASE(25) KPW_PACK_CASE(26) KPW_PACK_CASE(27) KPW_PACK_CASE(28)
    KPW_PACK_CASE(29) KPW_PACK_CASE(30) KPW_PACK_CASE(31) KPW_PACK_CASE(32)
#undef KPW_PACK_CASE
  }
  return (int)cudaGetLastError();
}
