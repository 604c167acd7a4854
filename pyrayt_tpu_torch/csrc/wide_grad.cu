// Staged wide backward kernels (K5 tail, K6 group, K7 singles) for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels of pyrayt_tpu/ops/fused_grad.py run by
// _run_bwd_staged, the default wide backward (wide_grad None or "staged"):
//
//   K5  _make_staged_tail_kernel: one generation's adjoint of _wide_tail.
//       One thread per ray rebuilds the generation's input state (the true
//       initial state at g = 0, else the record's rows), builds the record
//       cotangent (from a loss plan's scalar row, or read from d_records),
//       and maps it with the carried cotangent through trace_common.cuh's
//       step_tail with the fold's hit distance and normal as inputs
//       (adjoint_common.cuh: tail_adjoint, shared with K3/K4).  It writes
//       buf = [p3, v3, d_best_d, d_best_n], the input state's carried
//       cotangent, and per-block float64 partials of the glass cotangents
//       that reduce_partials sums in a fixed order.  A ray that did not run
//       the generation (K2's rule, ops/fused_grad.py: generations_ran)
//       passes the carried cotangent through.
//   K6  _make_staged_group_kernel: the winner-masked adjoint of
//       _wide_tree_eval over a group.  The TPU evaluates the vjp of every
//       tree of a chunk with a zero cotangent for the losers; here each ray
//       reads its win code, and if it names a tree of the group it
//       re-evaluates that one tree (O(L), not O(T L)), differentiates the
//       winning endpoint by its hit code and the winner's normal chain.
//   K7  _make_staged_singles_kernel: as K6 for the single (ungrouped) trees,
//       whose codes and slots are static; same kernel template, group = -1.
//
// The hit distance and the normal of a tree both come from one leaf (CSG
// only selects values), so each ray's table cotangent is 18 values (rows
// 0-2 of that leaf's transform, its 6 params) for one row of the launch's
// reduce table (group: sorted tree t's leaf j is row t L + j; singles: the
// compact single leaf).  The TPU kernels accumulate these into one
// scalar-memory output over a sequential grid (pyrayt_tpu/ops/
// fused_grad.py:17-19, :268-289); here a ray writes its row key (-1: it won
// none of the launch's trees) and its 18 values (n, 18; zeros without a
// row; a warp's 32 entries leave through shared memory as coalesced
// stores), and row_reduce.cuh sums them per row without atomics: a stable
// counting sort of the rays by key, float64 sums over fixed pieces of each
// row, a fixed-order finish.  Two launches give bit-identical gradients.  The
// reduce does O(n + rows) work: it reads the keys twice and each winner's
// 18 values once, and splits a row that holds every ray (K7's detector)
// over many warps.  A launch none of whose rays won one of its trees sorts
// nothing and writes zero sums.
//
// What bounds them on an H100: K5 reads 15 record rows, the mask, 5 fold
// rows and 11 carried rows (K4 mode: 15 d_records rows) and writes 10 + 11
// rows per ray; K6/K7 read 10 buf rows and win and write 6 + 1 + 18 rows
// per ray, of which the reduce reads the winners' 18 once.  Per ray the
// arithmetic is a few hundred operations, so bytes bind.

#include "row_reduce.cuh"
#include "wide_common.cuh"

namespace {

using namespace pyrayt;

// ---------------------------------------------------------------------------
// K5: the staged tail
// ---------------------------------------------------------------------------

template <typename T, bool LOSS>
__global__ void __launch_bounds__(kThreads) staged_tail_kernel(
    const T* __restrict__ state0, long long n, const T* __restrict__ rec,
    const bool* __restrict__ mask, const bool* __restrict__ pmask, const T* __restrict__ fold5,
    const T* __restrict__ glass, const int* __restrict__ program, int n_glass,
    const T* __restrict__ drec, int plan, const T* __restrict__ scal, int n_scal,
    const T* __restrict__ carry_bar, T ray_offset, T world_index, T threshold,
    int apply_threshold, T* __restrict__ buf, T* __restrict__ dcarry,
    double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* st_gl = reinterpret_cast<double*>(smem);
  T* s_glass = reinterpret_cast<T*>(st_gl + kGlass * kThreads);
  T* s_scal = s_glass + kGlass * n_glass;
  int* s_kinds = reinterpret_cast<int*>(s_scal + kMaxScal);
  int* st_slot = s_kinds + n_glass;
  const int tid = threadIdx.x;
  for (int k = tid; k < kGlass * n_glass; k += blockDim.x) s_glass[k] = glass[k];
  for (int k = tid; k < n_glass; k += blockDim.x) s_kinds[k] = program[kWideHeader + k];
  if (LOSS) {
    for (int k = tid; k < n_scal; k += blockDim.x) s_scal[k] = scal[k];
  }
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  int slot_out = -1;
  T gl[kGlass];
  if (i < n) {
    T r[kRecordCols];
    for (int c = 0; c < kRecordCols; ++c) r[c] = rec[c * n + i];
    // the generation's input state: state0 at g = 0 (pmask null), else the
    // record's rows; generation g > 0 ran iff mask[g-1] and nonzero tilt
    Carry<T> x;
    bool ran = true;
    if (pmask == nullptr) {
      for (int c = 0; c < 3; ++c) {
        x.p[c] = state0[c * n + i];
        x.v[c] = state0[(4 + c) * n + i];
      }
      x.gen = state0[8 * n + i];
      x.inten = state0[9 * n + i];
      x.wav = state0[10 * n + i];
      x.ridx = state0[11 * n + i];
      x.rid = state0[12 * n + i];
    } else {
      for (int c = 0; c < 3; ++c) {
        x.p[c] = r[6 + c];
        x.v[c] = r[12 + c];
      }
      x.gen = r[0];
      x.inten = r[1];
      x.wav = r[2];
      x.ridx = r[3];
      x.rid = r[4];
      ran = pmask[i] && (r[12] != T(0) || r[13] != T(0) || r[14] != T(0));
    }
    for (int c = 0; c < 3; ++c) {
      buf[c * n + i] = x.p[c];
      buf[(3 + c) * n + i] = x.v[c];
    }
    Carry<T> bar;
    for (int c = 0; c < 3; ++c) {
      bar.p[c] = carry_bar[c * n + i];
      bar.v[c] = carry_bar[(3 + c) * n + i];
    }
    bar.gen = carry_bar[6 * n + i];
    bar.inten = carry_bar[7 * n + i];
    bar.wav = carry_bar[8 * n + i];
    bar.ridx = carry_bar[9 * n + i];
    bar.rid = carry_bar[10 * n + i];
    T t_bar = T(0), nrm_bar[3] = {T(0), T(0), T(0)};
    if (ran) {
      T rb[kRecordCols];
      if (LOSS) {
        plan_drec(plan, s_scal, r, mask[i], rb);
      } else {
        for (int c = 0; c < kRecordCols; ++c) rb[c] = drec[c * n + i];
      }
      const T best = fold5[i];
      const bool no_hit = isinf(best);
      const T nrm[3] = {fold5[n + i], fold5[2 * n + i], fold5[3 * n + i]};
      const int slot = no_hit ? -1 : static_cast<int>(fold5[4 * n + i]);
      TailAdjoint<T> a;
      tail_adjoint(s_kinds, s_glass, ray_offset, world_index, threshold, apply_threshold, x,
                   no_hit, slot, nrm, rb, bar, a, slot_out, gl);
      const T tb = hit_point_adjoint(a, x, no_hit ? T(0) : best);
      if (!no_hit) {
        t_bar = tb;
        for (int c = 0; c < 3; ++c) nrm_bar[c] = a.nrm_bar[c];
      }
      bar = input_bar(a);
    }
    buf[6 * n + i] = t_bar;
    for (int c = 0; c < 3; ++c) buf[(7 + c) * n + i] = nrm_bar[c];
    const T out[11] = {bar.p[0], bar.p[1], bar.p[2], bar.v[0], bar.v[1], bar.v[2],
                       bar.gen, bar.inten, bar.wav, bar.ridx, bar.rid};
    for (int c = 0; c < 11; ++c) dcarry[c * n + i] = out[c];
  }

  // glass cotangents: stage, then fold the block's rays in ray order
  st_slot[tid] = slot_out;
  if (slot_out >= 0) {
    for (int k = 0; k < kGlass; ++k) st_gl[k * kThreads + tid] = static_cast<double>(gl[k]);
  }
  __syncthreads();
  for (int e = tid; e < kGlass * n_glass; e += blockDim.x) {
    const int mslot = e / kGlass, col = e % kGlass;
    double sum = 0.0;
    for (int r = 0; r < kThreads; ++r) {
      if (st_slot[r] == mslot) sum += st_gl[col * kThreads + r];
    }
    partials[static_cast<long long>(e) * gridDim.x + blockIdx.x] = sum;
  }
}

template <typename T, bool LOSS>
int launch_tail(const void* state0, long long n, const void* rec, const void* mask,
                const void* pmask, const void* fold5, const void* glass, const void* program,
                int program_len, int n_glass, const void* drec, int plan, const void* scal,
                int n_scal, const void* carry_bar, double ray_offset, double world_index,
                double threshold, int apply_threshold, void* buf, void* dcarry, void* partials,
                void* d_glass, void* stream) {
  if (program_len < kWideHeader + n_glass || n_glass < 0 || n_scal < 0 || n_scal > kMaxScal ||
      (LOSS && (plan < 0 || plan > 2 || scal == nullptr)) || (!LOSS && drec == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(double) * kGlass * kThreads +
                      sizeof(T) * (kGlass * static_cast<size_t>(n_glass) + kMaxScal) +
                      sizeof(int) * (static_cast<size_t>(n_glass) + kThreads);
  auto kernel = staged_tail_kernel<T, LOSS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(state0), n, static_cast<const T*>(rec),
      static_cast<const bool*>(mask), static_cast<const bool*>(pmask),
      static_cast<const T*>(fold5), static_cast<const T*>(glass),
      static_cast<const int*>(program), n_glass, static_cast<const T*>(drec), plan,
      static_cast<const T*>(scal), n_scal, static_cast<const T*>(carry_bar),
      static_cast<T>(ray_offset), static_cast<T>(world_index), static_cast<T>(threshold),
      apply_threshold, static_cast<T*>(buf), static_cast<T*>(dcarry),
      static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_glass == 0) return static_cast<int>(err);
  reduce_partials<T><<<static_cast<unsigned>(kGlass * n_glass), kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), static_cast<int>(blocks), 0, nullptr, nullptr,
      static_cast<T*>(d_glass));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6 / K7: the fold adjoint of a group's trees or of the single trees
// ---------------------------------------------------------------------------

// the winner among this launch's trees: its hit distance, leaf slot, type,
// needs-normal and reduce row (-1: the ray won no tree of the launch)
template <typename T>
struct Winner {
  T best;
  int slot, type, needs, row;
};

// Kept out of line: inlined into the kernel at -O3 (nvcc 12.9, sm_90a), the
// singles' launch faults with an illegal address on the card, where a -G
// build or the out-of-line call runs; PERF.md (PR 3) records what the
// machine code shows.
template <typename T>
__device__ __noinline__ Winner<T> find_winner(const WideScene<T>& ws, int group, int code, const T p[3],
                                 const T v[3]) {
  Winner<T> w = {inf_v<T>(), -1, 0, 0, -1};
  if (group >= 0) {
    const Group G = group_at(ws.prog, group);
    const int t = code - G.code_base;
    if (t < 0 || t >= G.n_trees) return w;
    Intervals<T> iv;
    int ts[kMaxGroupLeaves];
    group_tree(ws, G, t, p, v, ts, iv);
    int pos;
    w.best = nearest_of(iv, pos);
    if (pos < 0) return w;
    w.slot = ts[pos];
    w.type = G.type[pos];
    w.needs = G.needs[pos];
    w.row = t * G.n_leaves + pos;
    return w;
  }
  const int* trees = ws.prog + ws.prog[W_TREES_OFF];  // [code, first, end instruction]
  for (int k = 0; k < ws.prog[W_SINGLE_TREES]; ++k) {
    if (trees[3 * k] != code) continue;
    int id = -1;
    T best = inf_v<T>();
    run_program(
        ws.singles, p, v, trees[3 * k + 1], trees[3 * k + 2],
        [&](T cand, int c, int) {
          cand = cand > T(0) ? cand : inf_v<T>();
          if (cand < best) {
            best = cand;
            id = c;
          }
        },
        [](const int*) {});
    if (id < 0) return w;
    const int* L = ws.singles.leaf + 5 * id;
    w.best = best;
    w.slot = single_slot(ws, id);
    w.type = L[0];
    w.needs = L[3];
    w.row = id;
    return w;
  }
  return w;
}

// shared bytes ahead of the scene copy: each thread's 18 table values
template <typename T>
__host__ __device__ constexpr size_t fold_stage_bytes() {
  return sizeof(T) * kGeo * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) staged_fold_kernel(
    long long n, const T* buf, const int* win,
    const T* objtx, const T* prim, const int* program,
    int prefix_len, int n_single_leaves, const int* slots, int group,
    T* dpv, int* keys, T* vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideScene<T> ws = load_wide_scene(smem + fold_stage_bytes<T>(), program, prefix_len,
                                          n_single_leaves, objtx, prim,
                                          static_cast<const T*>(nullptr), 0, slots,
                                          static_cast<const T*>(nullptr));
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  T geo[kGeo];
  for (int k = 0; k < kGeo; ++k) geo[k] = T(0);
  if (i < n) {
    const T p[3] = {buf[i], buf[n + i], buf[2 * n + i]};
    const T v[3] = {buf[3 * n + i], buf[4 * n + i], buf[5 * n + i]};
    T p_bar[3] = {T(0), T(0), T(0)}, v_bar[3] = {T(0), T(0), T(0)};
    const Winner<T> w = find_winner(ws, group, win[i], p, v);
    int row = -1;
    if (w.row >= 0 && isfinite(w.best)) {
      row = w.row;
      const T* m = objtx + 16 * w.slot;
      const T* pr = prim + 6 * w.slot;
      const T t = w.best;
      T t_bar = buf[6 * n + i];
      const T nrm_bar[3] = {buf[7 * n + i], buf[8 * n + i], buf[9 * n + i]};
      T* m_bar = geo;
      T* pr_bar = geo + 12;
      T o_bar[3] = {T(0), T(0), T(0)}, d_bar[3] = {T(0), T(0), T(0)};
      if (w.needs) {
        // the normal at the object-space hit lh = o + t d (_wide_tree_eval)
        T o[3], d[3], lh[3], lh_bar[3];
        local_ray(m, p, v, o, d);
        for (int r = 0; r < 3; ++r) lh[r] = o[r] + t * d[r];
        const T scale = static_cast<T>(ws.leaf[5 * w.slot + 2]);
        world_normal_adjoint(w.type, m, pr, lh, scale, nrm_bar, m_bar, pr_bar, lh_bar);
        for (int r = 0; r < 3; ++r) {
          o_bar[r] += lh_bar[r];
          d_bar[r] += t * lh_bar[r];
        }
        t_bar += dot3(lh_bar, d);
      }
      const int code = endpoint_code(leaf_pair_at(w.type, m, pr, p, v), t);
      hit_distance_adjoint(w.type, m, pr, p, v, code, t, t_bar, o_bar, d_bar, m_bar, pr_bar, p_bar,
                           v_bar);
    }
    for (int c = 0; c < 3; ++c) {
      dpv[c * n + i] = p_bar[c];
      dpv[(3 + c) * n + i] = v_bar[c];
    }
    keys[i] = row;
  }
  // the warp's 32 entries (zeros for a ray without a row) leave through
  // shared memory as 32 x 18 contiguous values, so the stores coalesce
  T* stage = reinterpret_cast<T*>(smem) + static_cast<long long>(threadIdx.x - lane) * kGeo;
  for (int k = 0; k < kGeo; ++k) stage[lane * kGeo + k] = geo[k];
  __syncwarp();
  const long long first = (i - lane) * kGeo;
  for (int q = 0; q < kGeo; ++q) {
    const long long e = first + 32 * q + lane;
    if (e < n * kGeo) vals[e] = stage[32 * q + lane];
  }
}

template <typename T>
int launch_fold(long long n, const void* buf, const void* win, const void* objtx,
                const void* prim, const void* program, int prefix_len, int n_single_leaves,
                const void* slots, int group, void* dpv, void* keys, void* vals, void* d_objtx,
                void* d_prim, const void* reduce_slots, int n_rows, void* scratch,
                void* stream) {
  if (prefix_len < kWideHeader || n_single_leaves < 0 || n_single_leaves > kMaxSingleLeaves ||
      group < -1 || n_rows < 0 || (n_rows > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t smem = fold_stage_bytes<T>() + wide_smem_bytes<T>(prefix_len, n_single_leaves, 0);
  auto kernel = staged_fold_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      n, static_cast<const T*>(buf), static_cast<const int*>(win), static_cast<const T*>(objtx),
      static_cast<const T*>(prim), static_cast<const int*>(program), prefix_len, n_single_leaves,
      static_cast<const int*>(slots), group, static_cast<T*>(dpv), static_cast<int*>(keys),
      static_cast<T*>(vals));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_row_reduce<T>(keys, vals, n, n_rows, reduce_slots, scratch, d_objtx, d_prim, s);
}

}  // namespace

#define PYRAYT_TAIL_ARGS                                                                      \
  const void *state0, long long n, const void *rec, const void *mask, const void *pmask,      \
      const void *fold5, const void *glass, const void *program, int program_len, int n_glass, \
      const void *drec, int plan, const void *scal, int n_scal, const void *carry_bar,         \
      double ray_offset, double world_index, double threshold, int apply_threshold, void *buf, \
      void *dcarry, void *partials, void *d_glass, void *stream
#define PYRAYT_TAIL_PASS                                                                      \
  state0, n, rec, mask, pmask, fold5, glass, program, program_len, n_glass, drec, plan, scal, \
      n_scal, carry_bar, ray_offset, world_index, threshold, apply_threshold, buf, dcarry,     \
      partials, d_glass, stream
#define PYRAYT_FOLD_ARGS                                                                      \
  long long n, const void *buf, const void *win, const void *objtx, const void *prim,         \
      const void *program, int prefix_len, int n_single_leaves, const void *slots, int group, \
      void *dpv, void *keys, void *vals, void *d_objtx, void *d_prim,                          \
      const void *reduce_slots, int n_rows, void *scratch, void *stream
#define PYRAYT_FOLD_PASS                                                                      \
  n, buf, win, objtx, prim, program, prefix_len, n_single_leaves, slots, group, dpv, keys,    \
      vals, d_objtx, d_prim, reduce_slots, n_rows, scratch, stream

extern "C" {

// K5: plan < 0 reads the record cotangent from drec (generic mode); plan >= 0
// builds it from the loss plan's scalar row (loss mode); pmask null means
// generation 0
int pyrayt_staged_tail_f32(PYRAYT_TAIL_ARGS) {
  return plan < 0 ? launch_tail<float, false>(PYRAYT_TAIL_PASS)
                  : launch_tail<float, true>(PYRAYT_TAIL_PASS);
}
int pyrayt_staged_tail_f64(PYRAYT_TAIL_ARGS) {
  return plan < 0 ? launch_tail<double, false>(PYRAYT_TAIL_PASS)
                  : launch_tail<double, true>(PYRAYT_TAIL_PASS);
}

// K6 (group >= 0: that group's trees) and K7 (group = -1: the single trees)
int pyrayt_staged_fold_f32(PYRAYT_FOLD_ARGS) { return launch_fold<float>(PYRAYT_FOLD_PASS); }
int pyrayt_staged_fold_f64(PYRAYT_FOLD_ARGS) { return launch_fold<double>(PYRAYT_FOLD_PASS); }

// bytes of the reduce's scratch for n entries and n_rows rows (K6/K7 and
// the reduce alone); -1 past the reduce's limits (row_reduce.cuh)
long long pyrayt_staged_reduce_scratch(long long n, int n_rows) {
  return reduce_plan(n, n_rows).bytes;
}

// The reduce alone: sums the n entries (keys (n,) int32, vals (n, 18)) per
// row into rows 0-2 of d_objtx and into d_prim of slot reduce_slots[r]
int pyrayt_row_reduce_f32(const void* keys, const void* vals, long long n, int n_rows,
                          const void* reduce_slots, void* scratch, void* d_objtx, void* d_prim,
                          void* stream) {
  return launch_row_reduce<float>(keys, vals, n, n_rows, reduce_slots, scratch, d_objtx, d_prim,
                                  static_cast<cudaStream_t>(stream));
}
int pyrayt_row_reduce_f64(const void* keys, const void* vals, long long n, int n_rows,
                          const void* reduce_slots, void* scratch, void* d_objtx, void* d_prim,
                          void* stream) {
  return launch_row_reduce<double>(keys, vals, n, n_rows, reduce_slots, scratch, d_objtx, d_prim,
                                   static_cast<cudaStream_t>(stream));
}

// threads per block of K5: the wrapper sizes the glass partials from it
int pyrayt_staged_block_threads() { return kThreads; }

const char* pyrayt_staged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
