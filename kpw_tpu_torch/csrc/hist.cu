// Per-column histogram of bounded values and the dictionary built from it,
// in one launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel kpw_tpu/ops/pallas_rank.py:_hist_kernel together
// with the presence -> dictionary step after it
// (kpw_tpu/ops/pallas_rank.py:presence_to_dict).  For each column c of a
// (C, n) batch of 32-bit values, counting only rows below `count` and
// values below nb = nhi*64:
//
//   counts[c, v]  the number of such rows holding v          (C, nb) int32
//   rt[c, v]      #(present values <= v) - 1, absent v too   (C, nb) int32
//   ulo[c, j]     the j-th present value ascending, j < k;
//                 0xFFFFFFFF for k <= j < ulo_ld             (C, ulo_ld) int64
//   k[c]          the number of present values               (C,) int32
//
// Every entry of ulo is written, so a row wider than nb (the flagship
// step's (C, n) dictionary) leaves with its pad.  The TPU version summed
// one-hot bf16 matmuls in f32 (exact below 2^24); these counts are exact
// int32.
//
// Bound on the H100: memory.  The least the function moves is each value
// read once (4 bytes) and counts, rt, ulo (C * ulo_ld) and k written once.
//
// Design.  A thread-block cluster of two blocks serves one column.  Block
// rank r counts its contiguous share of the column's rows into its own
// table of nb int32 bins in shared memory (at most 8192 bins, 32 KiB),
// with four 16-byte loads of each thread in flight at a time, while the
// cluster's threads write ulo's pad past nb.  After cluster.sync() rank r
// owns bins [r*nb/2, (r+1)*nb/2), one bin a thread a round: it sums them
// across the cluster's tables through distributed shared memory (the two
// remote loads of a bin in flight together, neighbouring threads on
// neighbouring bins) into its own table, whose slice no other rank reads,
// and counts the present ones (__syncthreads_count).  The slice totals
// pass through distributed shared memory to give every rank its offset;
// a block-wide prefix of presence, round by round (ballots within a warp,
// warp totals across the block), gives rt and the scatter ulo[rt[v]] = v
// over the present bins (no sort), and ulo is padded from k on.  Counts,
// rt and ulo leave with plain stores: no memset, no global atomic.  A last
// cluster.sync() keeps every block's shared memory alive until its
// readers are done.  The cluster size is a compile-time constant, so a
// bin's remote loads unroll.
//
// Why two blocks a column and plain shared-memory atomics: an earlier
// version of this kernel took the cluster size (2, 4, 8) and a
// warp-aggregated count (__match_any_sync + __popc, one atomic a group of
// equal values) as launch arguments, and chip_smoke.py as it stood then
// timed every pair (CUDA events, median of 25, L2 flushed; 64 x 65,536
// int32, count 65,499, ulo 8,192 entries a column; NVIDIA H100 80GB HBM3,
// 700 W), in ms:
//
//                      cs 2     cs 4     cs 8
//   values < 270, nhi 8
//     aggregation off  0.0172   0.0174   0.0215
//     aggregation on   0.0439   0.0594   0.0539
//   values < 8192, nhi 128
//     aggregation off  0.0215   0.0228   0.0282
//     aggregation on   0.0502   0.0660   0.0600
//
// __match_any_sync costs more than the shared-memory conflicts it saves on
// both distributions, and two blocks a column (128 blocks at 64 columns)
// are enough to read the batch: larger clusters only add merge rounds and
// syncs.  Both choices were then fixed and the arguments removed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;  // blocks a column (measured above)
constexpr int kThreads = 512;
constexpr int kLoads = 4;  // 16-byte loads in flight per thread while counting
constexpr int kMaxBins = 128 * 64;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 3)
hist_dict_kernel(const uint32_t* __restrict__ in, int n,
                 const int* __restrict__ count_ptr, int count_val, int nhi,
                 int* __restrict__ counts, int* __restrict__ rt,
                 long long* __restrict__ ulo, int ulo_ld,
                 int* __restrict__ k_out) {
  __shared__ __align__(16) int bins[kMaxBins];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int slice_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = nhi * 64;
  long long* urow = ulo + (long long)c * ulo_ld;

  for (int i = tid; i < nb / 4; i += kThreads)
    reinterpret_cast<int4*>(bins)[i] = make_int4(0, 0, 0, 0);
  // ulo's pad past nb depends on nothing: the cluster writes it first
  for (int j = nb + rank * kThreads + tid; j < ulo_ld; j += kCluster * kThreads)
    urow[j] = 0xFFFFFFFFll;
  __syncthreads();

  // this rank's rows [r0, r1): whole 16-byte words, cut at the count
  const int cnt = max(0, min(count_ptr ? *count_ptr : count_val, n));
  const int chunk = ((n / 4 + kCluster - 1) / kCluster) * 4;
  const int r0 = min(rank * chunk, n);
  const int r1 = min(r0 + chunk, cnt);
  const uint4* v4 = reinterpret_cast<const uint4*>(in + (long long)c * n);
  const int end4 = (r1 + 3) >> 2;
  const uint32_t unb = (uint32_t)nb;
  // kLoads loads issued before any of them is used
  for (int w0 = (r0 >> 2) + tid; w0 < end4; w0 += kLoads * kThreads) {
    uint4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = w0 + u * kThreads;
      q[u] = i < end4 ? __ldg(v4 + i)
                      : make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int row = 4 * (w0 + u * kThreads);
      const uint32_t vals[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row + e < r1 && vals[e] < unb) atomicAdd(&bins[vals[e]], 1);
    }
  }
  cluster.sync();  // every table of the cluster is complete

  // This rank's slice of bins, [b0, b0 + sl), one bin a thread a round.
  // Pass 1: sum the slice across the cluster's tables (coalesced loads
  // from every rank in flight together) into this block's own table,
  // whose slice no other rank reads, and count the present bins.
  const int sl = nb / kCluster;
  const int b0 = rank * sl;
  int present_total = 0;
  for (int j = tid; j - tid < sl; j += kThreads) {
    int t = 0;
    if (j < sl) {
      int part[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        part[q] = cluster.map_shared_rank(bins, q)[b0 + j];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) t += part[q];
    }
    present_total += __syncthreads_count(t > 0);
    if (j < sl) bins[b0 + j] = t;
  }
  if (tid == 0) slice_total = present_total;
  cluster.sync();  // every slice total is published

  int offset = 0, k = 0;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    const int t = *cluster.map_shared_rank(&slice_total, q);
    offset += q < rank ? t : 0;
    k += t;
  }
  // Pass 2: the block-wide prefix of presence, round by round (ballots
  // within a warp, warp totals across the block), gives rt and the
  // scatter of ulo; ulo is padded from k to nb.
  const long long cb = (long long)c * nb;
  const int ulim = min(nb, ulo_ld);
  int base = offset;  // present bins of this rank before the round
  for (int j = tid; j - tid < sl; j += kThreads) {
    const int b = b0 + j;
    const int t = j < sl ? bins[b] : 0;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, t > 0);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = 0, round = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int wt = warp_tot[w];
      before += w < warp ? wt : 0;
      round += wt;
    }
    const int incl = base + before + __popc(bal & ((2u << lane) - 1u));
    if (j < sl) {
      counts[cb + b] = t;
      rt[cb + b] = incl - 1;
      if (t > 0 && incl - 1 < ulo_ld) urow[incl - 1] = b;
      if (b >= k && b < ulim) urow[b] = 0xFFFFFFFFll;
    }
    base += round;
    __syncthreads();  // warp_tot is rewritten next round
  }
  if (rank == 0 && tid == 0) k_out[c] = k;
  cluster.sync();  // no block leaves while another may read its memory
}

}  // namespace

// in: (C, n) 32-bit values, 16-byte aligned, n % 128 == 0; count: the
// valid row count, read from count_ptr on the device when it is not null;
// counts, rt: (C, nhi*64) int32; ulo: (C, ulo_ld) int64; k: (C,) int32.
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int kpw_hist_dict(const void* in, int C, int n,
                             const void* count_ptr, int count_val, int nhi,
                             void* counts, void* rt, void* ulo, int ulo_ld,
                             void* k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nhi < 1 || nhi * 64 > kMaxBins || n < 0 || n % 128 || ulo_ld < 0)
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  hist_dict_kernel<<<C * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, n, (const int*)count_ptr, count_val, nhi,
      (int*)counts, (int*)rt, (long long*)ulo, ulo_ld, (int*)k);
  return (int)cudaGetLastError();
}
