// Wide forward trace kernel (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pyrayt_tpu/ops/fused_trace.py:
// _make_step_wide (_make_wide_fold with _wide_tree_eval and
// _block_any_hit, then _wide_tail), built by _make_kernel(wide=True) and
// launched by build_fused_trace_fn for scenes past 32 leaves whose trees
// batch into groups of one CSG shape: lens and microlens arrays, lens walls.
// One thread runs one ray's whole bounce loop:
//
//   PROPAGATE  the single (ungrouped) trees through the scene program, then
//              per group the spatially sorted trees in two cull levels: a
//              ray skips a chunk of 16 trees whose box it does not enter,
//              and inside a chunk each tree whose own box it does not
//              enter (wide_common.cuh: cull_hit on the tight boxes of
//              ops/fused_trace.py:wide_cull_tables, padded and grown so it
//              never drops a hit), or enters only past its best hit; a
//              strict < fold in ascending sorted order keeps the JAX
//              kernel's win codes;
//   INTERACT   the winner's normal computed once, after the fold (the TPU
//              computes it for every tree because it cannot re-index a
//              traced slot): the object-space hit lo + d ld, the
//              inverse-transpose, the zero-guarded normalization and the
//              slot's normal scale; material slot and public id from the
//              per-leaf table; then trace_common.cuh's step_tail, as K1;
//   RECORD     as K1; with save_fold also fold5 = [best_d, n_xyz, best_mat]
//              and the win code per generation (the staged backward's input).
//
// Contract: K1's per-ray exit (ops/fused_trace.py, module docstring);
// generations a ray did not run are zero in records, masks and fold5, and
// -1 in win.
//
// Tables: the program prefix, the single leaves' tables (at most 32) and
// the glass rows sit in shared memory; the groups' transforms, params,
// sorted slots, the per-leaf table and the cull table are read from global
// memory through __ldg (L1/L2-cached: the 16x16 array's 513 leaves are
// 45 KB at float32).  The JAX package's 4096-leaf cap existed for the TPU's
// scalar memory and is dropped.
//
// What bounds it on an H100: per ray and generation, the box tests of every
// chunk and of the trees in the chunks it enters, and the leaf
// intersections of the trees whose boxes it enters (all counted by
// chip_smoke.py from the run's data), against the record writes of K1
// (15 G n itemsize bytes) plus fold5 and win with save_fold.  Branchy
// scalar math.

#include "wide_common.cuh"

namespace {

using namespace pyrayt;

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_trace_wide_kernel(
    const T* state, long long n, int generations,
    const T* objtx, const T* prim, const T* glass,
    const int* program, int prefix_len, int n_single_leaves, int n_glass,
    const int* slots, const T* cull,
    T* records, bool* masks, T* fstate,
    T* fold5, int* win,
    T ray_offset, T world_index, T threshold, int apply_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideScene<T> ws = load_wide_scene(smem, program, prefix_len, n_single_leaves, objtx, prim,
                                          glass, n_glass, slots, cull);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  RayState<T> x;
  for (int c = 0; c < 3; ++c) {
    x.p[c] = state[c * n + i];
    x.v[c] = state[(4 + c) * n + i];
  }
  x.gen = state[8 * n + i];
  x.inten = state[9 * n + i];
  x.wav = state[10 * n + i];
  x.ridx = state[11 * n + i];
  x.rid = state[12 * n + i];

  bool alive = true;
  int g = 0;
  for (; g < generations && alive; ++g) {
    // PROPAGATE: the wide fold
    WideHit<T> h;
    wide_nearest(ws, x.p, x.v, h);
    const bool no_hit = h.leaf < 0;
    const T t = no_hit ? T(0) : h.best;

    // the winner's normal, material slot and public id
    T nrm[3] = {T(0), T(0), T(0)};
    int slot = -1;
    T public_id = T(0);
    if (!no_hit) {
      const int* L = ws.leaf + 5 * h.leaf;
      slot = L[1];
      public_id = static_cast<T>(L[4]);
      const int needs = h.group >= 0 ? group_at(ws.prog, h.group).needs[h.pos] : L[3];
      if (needs) {
        const T* m = objtx + 16 * h.leaf;
        T o[3], d[3], lh[3];
        local_ray(m, x.p, x.v, o, d);
        for (int r = 0; r < 3; ++r) lh[r] = o[r] + t * d[r];
        world_normal(L[0], m, prim + 6 * h.leaf, lh, static_cast<T>(L[2]), nrm);
      }
    }
    if (fold5 != nullptr) {
      const T f[5] = {h.best, nrm[0], nrm[1], nrm[2], no_hit ? T(0) : static_cast<T>(slot)};
      for (int c = 0; c < 5; ++c) fold5[(static_cast<long long>(g) * 5 + c) * n + i] = f[c];
      win[static_cast<long long>(g) * n + i] = h.win;
    }

    // INTERACT, death rules, RECORD, state update (as K1)
    T row[kRecordCols];
    const bool living = step_tail(ws.singles.kinds, ws.singles.glass, ray_offset, world_index,
                                  threshold, apply_threshold, t, slot, public_id, nrm, x, row,
                                  alive);
    T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
#pragma unroll
    for (int c = 0; c < kRecordCols; ++c) rec[c * n] = row[c];
    masks[static_cast<long long>(g) * n + i] = living;
  }
  for (; g < generations; ++g) {
    T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
#pragma unroll
    for (int c = 0; c < kRecordCols; ++c) rec[c * n] = T(0);
    masks[static_cast<long long>(g) * n + i] = false;
    if (fold5 != nullptr) {
      for (int c = 0; c < 5; ++c) fold5[(static_cast<long long>(g) * 5 + c) * n + i] = T(0);
      win[static_cast<long long>(g) * n + i] = -1;
    }
  }
  const T out[13] = {x.p[0], x.p[1], x.p[2], T(1), x.v[0], x.v[1], x.v[2], T(0),
                     x.gen, x.inten, x.wav, x.ridx, x.rid};
#pragma unroll
  for (int c = 0; c < 13; ++c) fstate[c * n + i] = out[c];
}

template <typename T>
int launch(const void* state, long long n, int generations, const void* objtx, const void* prim,
           const void* glass, const void* program, int prefix_len, int n_single_leaves,
           int n_glass, const void* slots, const void* cull, void* records, void* masks,
           void* fstate, void* fold5, void* win, double ray_offset, double world_index,
           double threshold, int apply_threshold, void* stream) {
  if (prefix_len < kWideHeader || n_single_leaves < 0 || n_single_leaves > kMaxSingleLeaves ||
      n_glass < 0 || generations < 0 || ((fold5 == nullptr) != (win == nullptr)) ||
      cull == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t smem = wide_smem_bytes<T>(prefix_len, n_single_leaves, n_glass);
  auto kernel = fused_trace_wide_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(state), n, generations, static_cast<const T*>(objtx),
      static_cast<const T*>(prim), static_cast<const T*>(glass), static_cast<const int*>(program),
      prefix_len, n_single_leaves, n_glass, static_cast<const int*>(slots),
      static_cast<const T*>(cull), static_cast<T*>(records), static_cast<bool*>(masks),
      static_cast<T*>(fstate), static_cast<T*>(fold5), static_cast<int*>(win),
      static_cast<T>(ray_offset), static_cast<T>(world_index), static_cast<T>(threshold),
      apply_threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PYRAYT_WIDE_ARGS                                                                       \
  const void *state, long long n, int generations, const void *objtx, const void *prim,        \
      const void *glass, const void *program, int prefix_len, int n_single_leaves, int n_glass, \
      const void *slots, const void *cull, void *records, void *masks, void *fstate,            \
      void *fold5, void *win, double ray_offset, double world_index, double threshold,          \
      int apply_threshold, void *stream
#define PYRAYT_WIDE_PASS                                                                       \
  state, n, generations, objtx, prim, glass, program, prefix_len, n_single_leaves, n_glass,    \
      slots, cull, records, masks, fstate, fold5, win, ray_offset, world_index, threshold,      \
      apply_threshold, stream

extern "C" {

// fold5 and win are both null (a plain trace) or both set (save_fold)
int pyrayt_fused_trace_wide_f32(PYRAYT_WIDE_ARGS) { return launch<float>(PYRAYT_WIDE_PASS); }
int pyrayt_fused_trace_wide_f64(PYRAYT_WIDE_ARGS) { return launch<double>(PYRAYT_WIDE_PASS); }

const char* pyrayt_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
