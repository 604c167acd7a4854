// The deterministic table sums of the wide backward kernels (wide_grad.cu
// K6/K7, wide_fused_grad.cu K8): each differentiated ray leaves one reduce
// row key (-1: none) and 18 values (rows 0-2 of its winning leaf's object
// transform, its 6 params), and these kernels add the values of each row in
// a fixed order, without float atomics.
//
// Block (r, c) sums, in float64 and key order, the values of the entries of
// chunk c whose key is row r, and reduces its threads in a fixed tree;
// finish_rows then adds the chunks of each row in order into rows 0-2 of
// d_objtx and d_prim of slot reduce_slots[r].  The chunks spread a row over
// many blocks: the singles' launch of K7 has one row per single leaf (the
// detector alone, in a microlens array).  A launch none of whose entries
// names a row (flag_winners leaves any_winner 0) skips the key scan: its
// blocks write zero sums and return.  Two launches give bit-identical sums.
// The scan reads every key once per row (rows x entries); a counting sort
// by key would make it O(entries).

#pragma once

#include "adjoint_common.cuh"

namespace pyrayt {

constexpr int kRowThreads = 256;
constexpr int kFlagBlocks = 264;
constexpr int kTargetBlocks = 2048;
constexpr long long kMinChunk = 4096;

// chunks per reduce row for n entries and n_rows rows
inline int fold_chunks(long long n, int n_rows) {
  const long long by_rays = (n + kMinChunk - 1) / kMinChunk;
  const long long by_rows = (kTargetBlocks + (n_rows > 0 ? n_rows : 1) - 1) / (n_rows > 0 ? n_rows : 1);
  const long long c = by_rays < by_rows ? by_rays : by_rows;
  return static_cast<int>(c > 1 ? c : 1);
}

// any_winner = 1 where some entry's key names a reduce row (zeroed before)
__global__ void __launch_bounds__(kRowThreads) flag_winners(const int* __restrict__ keys,
                                                            long long n, int* any_winner) {
  bool won = false;
  for (long long i = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kRowThreads) {
    won = won || keys[i] >= 0;
  }
  if (__syncthreads_or(won) && threadIdx.x == 0) atomicOr(any_winner, 1);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) reduce_rows(
    const int* __restrict__ keys, const T* __restrict__ vals, long long n, long long chunk,
    const int* __restrict__ any_winner, double* __restrict__ partials) {
  __shared__ double red[kGeo][kRowThreads];
  const int r = blockIdx.x;
  if (*any_winner == 0) {
    if (threadIdx.x < kGeo) {
      partials[(static_cast<long long>(r) * gridDim.y + blockIdx.y) * kGeo + threadIdx.x] = 0.0;
    }
    return;
  }
  const long long i0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long i1 = i0 + chunk < n ? i0 + chunk : n;
  double acc[kGeo];
  for (int k = 0; k < kGeo; ++k) acc[k] = 0.0;
  for (long long i = i0 + threadIdx.x; i < i1; i += kRowThreads) {
    if (keys[i] == r) {
      for (int k = 0; k < kGeo; ++k) acc[k] += static_cast<double>(vals[k * n + i]);
    }
  }
  for (int k = 0; k < kGeo; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int half = kRowThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      for (int k = 0; k < kGeo; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < kGeo) {
    partials[(static_cast<long long>(r) * gridDim.y + blockIdx.y) * kGeo + threadIdx.x] =
        red[threadIdx.x][0];
  }
}

template <typename T>
__global__ void finish_rows(const double* __restrict__ partials, int n_chunks,
                            const int* __restrict__ reduce_slots, T* __restrict__ d_objtx,
                            T* __restrict__ d_prim) {
  const int r = blockIdx.x, k = threadIdx.x;
  if (k >= kGeo) return;
  double sum = 0.0;
  for (int c = 0; c < n_chunks; ++c) {
    sum += partials[(static_cast<long long>(r) * n_chunks + c) * kGeo + k];
  }
  const int s = reduce_slots[r];
  if (k < 12) {
    d_objtx[16 * s + k] = static_cast<T>(sum);
  } else {
    d_prim[6 * s + k - 12] = static_cast<T>(sum);
  }
}

// Sum the n entries' values (vals (18, n), keys (n,)) into the n_rows
// reduce rows; partials holds n_rows * fold_chunks(n, n_rows) * 18 float64.
template <typename T>
int launch_row_reduce(const void* keys, const void* vals, long long n, int n_rows,
                      const void* reduce_slots, void* partials, void* any_winner, void* d_objtx,
                      void* d_prim, cudaStream_t s) {
  if (n_rows == 0) return 0;
  cudaError_t err = cudaMemsetAsync(any_winner, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long flag_blocks = (n + kRowThreads - 1) / kRowThreads;
  if (flag_blocks > kFlagBlocks) flag_blocks = kFlagBlocks;
  if (flag_blocks < 1) flag_blocks = 1;
  flag_winners<<<static_cast<unsigned>(flag_blocks), kRowThreads, 0, s>>>(
      static_cast<const int*>(keys), n, static_cast<int*>(any_winner));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = fold_chunks(n, n_rows);
  const long long chunk = (n + n_chunks - 1) / n_chunks;
  reduce_rows<T><<<dim3(static_cast<unsigned>(n_rows), static_cast<unsigned>(n_chunks)),
                   kRowThreads, 0, s>>>(static_cast<const int*>(keys), static_cast<const T*>(vals),
                                        n, chunk, static_cast<const int*>(any_winner),
                                        static_cast<double*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_rows<T><<<static_cast<unsigned>(n_rows), 32, 0, s>>>(
      static_cast<const double*>(partials), n_chunks, static_cast<const int*>(reduce_slots),
      static_cast<T*>(d_objtx), static_cast<T*>(d_prim));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pyrayt
