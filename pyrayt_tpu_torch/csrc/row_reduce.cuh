// The deterministic table sums of the wide backward kernels (wide_grad.cu
// K6/K7, wide_fused_grad.cu K8).  Each differentiated ray (K8: each ray and
// generation) leaves an entry: one reduce row key (-1: none) and 18 values
// (rows 0-2 of its winning leaf's object transform, its 6 params), stored
// entry-major, (n, 18).  The reduce adds the values of each row in float64
// and writes the sums, cast to T, into rows 0-2 of d_objtx and into d_prim
// of slot reduce_slots[r].
//
// What it replaces: the TPU kernels accumulate these cotangents into one
// scalar-memory output over a grid that runs in order (pyrayt_tpu/ops/
// fused_grad.py:17-19, :268-289).  GPU blocks run in no order, so the sum
// takes passes of its own, and float atomics would make it change from run
// to run.
//
// The design: a stable counting sort of the entry indices by key, then a
// segmented sum over fixed pieces of each row.
//
//   sort_segments<false>  one warp per segment of `seg` consecutive entries
//       counts the segment's keys per row in its own shared-memory counters
//       (one leader lane per distinct key of a step, __match_any_sync), and
//       writes counts[row][segment];
//   scan_rows             one block per row: exclusive scan of the row's
//       segment counts in place, and the row's total;
//   plan_rows             one block: exclusive scans over the rows of the
//       totals (row_start) and of the pieces of kPiece entries (piece_start);
//   sort_segments<true>   each warp scatters its entry indices to
//       row_start + counts[row][segment] + the rank among the earlier lanes
//       of the step with the same key, steps in entry order, so each row's
//       segment of perm lists its entries in ascending entry order;
//   sum_pieces            one warp per piece: each lane adds its entries in
//       order in float64, then a fixed butterfly over the lanes;
//   finish_rows           one block per row adds its pieces in a fixed tree.
//
// Keys -1 (and any key outside [0, rows)) take no part: they are counted
// nowhere, scattered nowhere and their values are never read, so a launch
// with no valid key sorts nothing, has no pieces and writes zero sums.
// Integer counters are private to a warp and the positions come from
// integer scans, so the sort and every sum run in an order fixed by the
// keys alone: two launches give bit-identical sums.  No atomics.  A row
// that holds every entry (K7's detector, a third of K8's entries) is split
// into pieces of kPiece entries summed by as many warps, then finished by
// one block in a fixed tree: no row serializes on one SM.
//
// What bounds it on an H100: bytes.  The least it must move is every key
// once (4 n), the 18 values of each valid entry once (18 sizeof(T) per
// entry) and the sums; the design reads the keys twice, writes and reads
// one int32 index per valid entry and counts[rows][segments] (segments of
// at least 4 rows entries keep those int64 counts at most half the keys'
// bytes), and gathers each valid entry's 72 (f32) or 144 (f64) contiguous
// bytes once.
// The work is O(entries + rows), not O(rows x entries).

#pragma once

#include "adjoint_common.cuh"

namespace pyrayt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSortWarps = 8;           // warps per block of the sort passes
constexpr int kSortBatch = 8;           // keys per lane loaded ahead
constexpr long long kMinSegment = 2048;  // least entries per warp segment
constexpr int kPiece = 1024;            // entries per piece of the row sums
constexpr int kPieceWarps = 8;
constexpr int kScanThreads = 256;
constexpr int kPlanThreads = 1024;
constexpr int kFinishThreads = 128;
// shared memory for the per-warp row counters (one int per row and warp)
constexpr long long kCounterBytes = 200 * 1024;
constexpr int kMaxReduceRows = static_cast<int>(kCounterBytes / 4);

// The launch geometry and the scratch layout (byte offsets) of one reduce
// of n entries into n_rows rows; bytes < 0 where the reduce cannot run
// (more rows than the counters hold, or entries past int32 indices).
struct ReducePlan {
  long long seg, n_segs, max_pieces;
  int warps;
  long long counts, row_start, piece_start, piece_sums, perm, bytes;
};

inline ReducePlan reduce_plan(long long n, int n_rows) {
  ReducePlan p{};
  if (n < 0 || n > 0x7fffffffLL || n_rows < 0 || n_rows > kMaxReduceRows) {
    p.bytes = -1;
    return p;
  }
  const long long batch = 32LL * kSortBatch;
  const long long want = 4LL * n_rows > kMinSegment ? 4LL * n_rows : kMinSegment;
  p.seg = (want + batch - 1) / batch * batch;
  p.n_segs = (n + p.seg - 1) / p.seg;
  const long long by_smem = kCounterBytes / (4LL * (n_rows > 0 ? n_rows : 1));
  p.warps = static_cast<int>(by_smem < kSortWarps ? (by_smem > 1 ? by_smem : 1) : kSortWarps);
  p.max_pieces = (n + kPiece - 1) / kPiece + n_rows;
  long long off = 0;
  auto take = [&off](long long bytes) {
    const long long at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  p.counts = take(8LL * n_rows * p.n_segs);
  p.row_start = take(8LL * (n_rows + 1));
  p.piece_start = take(8LL * (n_rows + 1));
  p.piece_sums = take(8LL * kGeo * p.max_pieces);
  p.perm = take(4LL * n);
  p.bytes = off > 0 ? off : 256;
  return p;
}

// Exclusive scan of one value per thread in thread order; the block's total
// goes to total.  blockDim.x is a multiple of 32; warp_sums holds 32 values.
__device__ inline long long block_exclusive_scan(long long v, long long* warp_sums,
                                                 long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < n_warps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[n_warps - 1];
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();
  return before + x - v;
}

// Count (SCATTER false) or scatter (true) the keys of one segment per warp.
// Counting: counts[r * n_segs + s] = entries of segment s with key r.
// Scattering: perm[row_start[r] + counts[r * n_segs + s] + rank] = entry.
template <bool SCATTER>
__global__ void __launch_bounds__(kSortWarps * 32) sort_segments(
    const int* keys, long long n, int n_rows, long long seg, long long n_segs, long long* counts,
    const long long* row_start, int* perm) {
  extern __shared__ int row_counters[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = row_counters + static_cast<long long>(warp) * n_rows;
  const long long s = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (s >= n_segs) return;  // the whole warp
  for (int r = lane; r < n_rows; r += 32) {
    cnt[r] = SCATTER ? static_cast<int>(row_start[r] + counts[r * n_segs + s]) : 0;
  }
  __syncwarp();
  const long long i0 = s * seg;
  const long long i1 = i0 + seg < n ? i0 + seg : n;
  const unsigned lanes_before = (1u << lane) - 1u;
  for (long long base = i0; base < i1; base += 32 * kSortBatch) {
    int k[kSortBatch];
    for (int u = 0; u < kSortBatch; ++u) {
      const long long i = base + 32 * u + lane;
      const int key = i < i1 ? keys[i] : -1;
      k[u] = key >= 0 && key < n_rows ? key : -1;
    }
    for (int u = 0; u < kSortBatch; ++u) {
      const int key = k[u];
      if (__ballot_sync(kFullMask, key >= 0) == 0u) continue;
      const unsigned same = __match_any_sync(kFullMask, key);
      if (SCATTER && key >= 0) {
        perm[cnt[key] + __popc(same & lanes_before)] = static_cast<int>(base + 32 * u + lane);
      }
      __syncwarp();
      if (key >= 0 && lane == __ffs(same) - 1) cnt[key] += __popc(same);
      __syncwarp();
    }
  }
  if (!SCATTER) {
    for (int r = lane; r < n_rows; r += 32) counts[r * n_segs + s] = cnt[r];
  }
}

// Block r: the exclusive scan of row r's segment counts, in place; the
// row's total into row_total[r].
__global__ void __launch_bounds__(kScanThreads) scan_rows(long long* counts, long long n_segs,
                                                          long long* row_total) {
  __shared__ long long warp_sums[32];
  long long* row = counts + static_cast<long long>(blockIdx.x) * n_segs;
  long long carry = 0;
  for (long long base = 0; base < n_segs; base += blockDim.x) {
    const long long s = base + threadIdx.x;
    const long long v = s < n_segs ? row[s] : 0;
    long long total;
    const long long before = block_exclusive_scan(v, warp_sums, total);
    if (s < n_segs) row[s] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) row_total[blockIdx.x] = carry;
}

// One block: row_start (totals in, n_rows + 1 starts out) and piece_start
// (n_rows + 1), exclusive scans in row order.
__global__ void __launch_bounds__(kPlanThreads) plan_rows(long long* row_start, int n_rows,
                                                          long long* piece_start) {
  __shared__ long long warp_sums[32];
  long long carry_e = 0, carry_p = 0;
  for (int base = 0; base < n_rows; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const long long entries = r < n_rows ? row_start[r] : 0;
    long long total_e, total_p;
    const long long e = block_exclusive_scan(entries, warp_sums, total_e);
    const long long p = block_exclusive_scan((entries + kPiece - 1) / kPiece, warp_sums, total_p);
    if (r < n_rows) {
      row_start[r] = carry_e + e;
      piece_start[r] = carry_p + p;
    }
    carry_e += total_e;
    carry_p += total_p;
  }
  if (threadIdx.x == 0) {
    row_start[n_rows] = carry_e;
    piece_start[n_rows] = carry_p;
  }
}

// the 18 values of one entry, added in float64 (72 or 144 contiguous bytes,
// 8-byte aligned for float, 16-byte for double)
template <typename T>
__device__ inline void add_entry(const T* v, double acc[kGeo]) {
  if constexpr (sizeof(T) == 4) {
    const float2* v2 = reinterpret_cast<const float2*>(v);
    for (int q = 0; q < kGeo / 2; ++q) {
      const float2 x = v2[q];
      acc[2 * q] += static_cast<double>(x.x);
      acc[2 * q + 1] += static_cast<double>(x.y);
    }
  } else {
    const double2* v2 = reinterpret_cast<const double2*>(v);
    for (int q = 0; q < kGeo / 2; ++q) {
      const double2 x = v2[q];
      acc[2 * q] += x.x;
      acc[2 * q + 1] += x.y;
    }
  }
}

// an entry's 18 values, as add_entry reads them
template <typename T>
__device__ inline void store_entry(T* out, const T geo[kGeo]) {
  if constexpr (sizeof(T) == 4) {
    float2* o2 = reinterpret_cast<float2*>(out);
    for (int q = 0; q < kGeo / 2; ++q) o2[q] = make_float2(geo[2 * q], geo[2 * q + 1]);
  } else {
    double2* o2 = reinterpret_cast<double2*>(out);
    for (int q = 0; q < kGeo / 2; ++q) o2[q] = make_double2(geo[2 * q], geo[2 * q + 1]);
  }
}

// One warp per piece: piece_sums[p] = the float64 sums of its <= kPiece
// entries, each lane in entry order, then a butterfly; lane 0's result.
template <typename T>
__global__ void __launch_bounds__(kPieceWarps * 32) sum_pieces(
    const int* perm, const T* vals, const long long* row_start, const long long* piece_start,
    int n_rows, double* piece_sums) {
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kPieceWarps + (threadIdx.x >> 5);
  if (p >= piece_start[n_rows]) return;  // the whole warp
  // the row whose pieces hold p: piece_start[lo] <= p < piece_start[lo + 1]
  int lo = 0, hi = n_rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (piece_start[mid] <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const long long first = row_start[lo] + (p - piece_start[lo]) * kPiece;
  const long long end = first + kPiece < row_start[lo + 1] ? first + kPiece : row_start[lo + 1];
  double acc[kGeo];
  for (int k = 0; k < kGeo; ++k) acc[k] = 0.0;
  for (long long pos = first + lane; pos < end; pos += 32) {
    add_entry(vals + static_cast<long long>(perm[pos]) * kGeo, acc);
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < kGeo; ++k) acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
  }
  if (lane == 0) {
    for (int k = 0; k < kGeo; ++k) piece_sums[p * kGeo + k] = acc[k];
  }
}

// Block r: row r's pieces added in a fixed tree, cast to T, into rows 0-2
// of d_objtx and into d_prim of slot reduce_slots[r].
template <typename T>
__global__ void __launch_bounds__(kFinishThreads) finish_rows(
    const double* piece_sums, const long long* piece_start, const int* reduce_slots, T* d_objtx,
    T* d_prim) {
  __shared__ double red[kGeo][kFinishThreads];
  const int r = blockIdx.x, t = threadIdx.x;
  double acc[kGeo];
  for (int k = 0; k < kGeo; ++k) acc[k] = 0.0;
  for (long long p = piece_start[r] + t; p < piece_start[r + 1]; p += kFinishThreads) {
    for (int k = 0; k < kGeo; ++k) acc[k] += piece_sums[p * kGeo + k];
  }
  for (int k = 0; k < kGeo; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half /= 2) {
    if (t < half) {
      for (int k = 0; k < kGeo; ++k) red[k][t] += red[k][t + half];
    }
    __syncthreads();
  }
  if (t < kGeo) {
    const int s = reduce_slots[r];
    if (t < 12) {
      d_objtx[16 * s + t] = static_cast<T>(red[t][0]);
    } else {
      d_prim[6 * s + t - 12] = static_cast<T>(red[t][0]);
    }
  }
}

// Sum the n entries (keys (n,) int32, vals (n, 18) T) into the n_rows
// reduce rows.  scratch holds reduce_plan(n, n_rows).bytes bytes.
template <typename T>
int launch_row_reduce(const void* keys, const void* vals, long long n, int n_rows,
                      const void* reduce_slots, void* scratch, void* d_objtx, void* d_prim,
                      cudaStream_t s) {
  if (n_rows == 0) return 0;
  const ReducePlan p = reduce_plan(n, n_rows);
  if (p.bytes < 0 || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  long long* counts = reinterpret_cast<long long*>(base + p.counts);
  long long* row_start = reinterpret_cast<long long*>(base + p.row_start);
  long long* piece_start = reinterpret_cast<long long*>(base + p.piece_start);
  double* piece_sums = reinterpret_cast<double*>(base + p.piece_sums);
  int* perm = reinterpret_cast<int*>(base + p.perm);
  const int* k = static_cast<const int*>(keys);
  const size_t smem = sizeof(int) * static_cast<size_t>(p.warps) * n_rows;
  const unsigned sort_blocks = static_cast<unsigned>((p.n_segs + p.warps - 1) / p.warps);
  cudaError_t err;
  if (p.n_segs > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sort_segments<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(sort_segments<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sort_segments<false><<<sort_blocks, p.warps * 32, smem, s>>>(k, n, n_rows, p.seg, p.n_segs,
                                                                 counts, row_start, perm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_rows<<<static_cast<unsigned>(n_rows), kScanThreads, 0, s>>>(counts, p.n_segs,
                                                                     row_start);
    err = cudaGetLastError();
  } else {
    err = cudaMemsetAsync(row_start, 0, sizeof(long long) * n_rows, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_rows<<<1, kPlanThreads, 0, s>>>(row_start, n_rows, piece_start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.n_segs > 0) {
    sort_segments<true><<<sort_blocks, p.warps * 32, smem, s>>>(k, n, n_rows, p.seg, p.n_segs,
                                                                counts, row_start, perm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_pieces<T><<<static_cast<unsigned>((p.max_pieces + kPieceWarps - 1) / kPieceWarps),
                    kPieceWarps * 32, 0, s>>>(perm, static_cast<const T*>(vals), row_start,
                                              piece_start, n_rows, piece_sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finish_rows<T><<<static_cast<unsigned>(n_rows), kFinishThreads, 0, s>>>(
      piece_sums, piece_start, static_cast<const int*>(reduce_slots), static_cast<T*>(d_objtx),
      static_cast<T*>(d_prim));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pyrayt
