// Monolithic wide backward kernel (K8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pyrayt_tpu/ops/fused_grad.py:
// _make_bwd_kernel_wide, run by _run_bwd when wide_grad_mode returns
// "fused" (TraceConfig(wide_grad="fused")): the whole reverse sweep of a
// wide scene in one launch, from the records and masks of a K2 trace
// without save_fold.  One thread per ray sweeps the generations, last first,
// with the carried cotangent in registers.  Per generation the ray ran (K2's
// rule, ops/fused_grad.py: generations_ran) it
//
//   rebuilds the generation's input state: the true initial state at g = 0,
//     else the record's rows;
//   recomputes the fold with wide_common.cuh's wide_nearest, the device code
//     K2 runs, so the winning tree, leaf and hit distance are K2's; the
//     winner's normal as K2 computes it;
//   builds the record cotangent from the loss plan's scalar row (loss mode)
//     or reads it from d_records (generic mode), and maps it with the carried
//     cotangent through the step after the fold (adjoint_common.cuh:
//     tail_adjoint, shared with K3/K4/K5);
//   differentiates the winning leaf's normal and hit distance
//     (world_normal_adjoint, hit_distance_adjoint, as K6/K7), adding the
//     ray's share to the carried cotangent.
//
// A generation the ray did not run passes the carried cotangent through.
// At the end it writes d_state0 (13, n) with zero homogeneous w rows.
//
// Sums over rays, deterministic and without float atomics.  The TPU kernel
// accumulates into scalar memory over its sequential grid (pyrayt_tpu/ops/
// fused_grad.py:17-19, :268-289); here blocks run in parallel, so every sum
// takes a second pass.  Per generation it ran and hit, a ray writes its
// winning leaf's slot as a row key (-1 otherwise: no values written) and
// the leaf's 18 table cotangents (transform rows 0-2, 6 params) as one
// entry of (G, n) keys and (G, n, 18) values; row_reduce.cuh sums them per
// leaf: a stable counting sort of the entries by key, float64 sums over
// fixed pieces of each leaf's entries in (generation, ray) order, a
// fixed-order finish.  It reads the keys twice and each hit's 18 values
// once (O(G n + leaves) work), and the detector, a third of the entries,
// spreads over as many warps as it has pieces.  The glass cotangents go
// per generation into per-block float64 partials, folded in ray order
// within the block, which reduce_partials adds in a fixed order.  Two
// launches give bit-identical gradients.
//
// Tables: as K2, the program prefix, the single leaves' tables (at most 32)
// and the glass rows sit in shared memory beside the glass staging (7.8 KB);
// the groups' tables and the cull table are read from global memory through
// __ldg.  So the leaf count has no
// cap of its own (the JAX kernel's 300-leaf cap guarded a TPU compiler
// crash; the reduce's shared-memory row counters cap it at 51,200 leaves),
// and with the rays grows the (G, n, 18) value buffer in device memory.
//
// What bounds it on an H100: per ray and generation run, the fold's box
// tests and the leaf intersections of the trees whose boxes it enters (as
// K2), the tail adjoint and one leaf's adjoint, against 15 record rows, the
// mask and the 13 state rows in and out per ray (generic mode: 15
// d_records and 13 d_fstate rows more): operations bind.  The reduce adds
// two reads of the G n keys and one of each hit's 18 values.
//
// No pointer here is __restrict__ and the fold stays wide_nearest: nvcc
// 12.9 at -O3 miscompiled two wide kernels whose shared-memory pointers
// carried __restrict__ (wide_common.cuh: load_wide_scene).

#include "row_reduce.cuh"
#include "wide_common.cuh"

namespace {

using namespace pyrayt;

// shared bytes ahead of the scene copy: the glass staging (float64 values
// and slots per thread) and the loss plan's scalar row
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return (sizeof(double) * kGlass * kThreads + sizeof(int) * kThreads + sizeof(T) * kMaxScal +
          15) / 16 * 16;
}

template <typename T, bool LOSS>
__global__ void __launch_bounds__(kThreads) wide_fused_bwd_kernel(
    const T* state0, long long n, int generations,
    const T* objtx, const T* prim, const T* glass, const int* program,
    int prefix_len, int n_single_leaves, int n_glass, const int* slots, const T* cull,
    const T* records, const bool* masks, const T* d_records, const T* d_fstate,
    int plan, const T* scal, int n_scal,
    T ray_offset, T world_index, T threshold, int apply_threshold,
    T* d_state0, int* keys, T* vals, double* partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* st_gl = reinterpret_cast<double*>(smem);
  int* st_slot = reinterpret_cast<int*>(st_gl + kGlass * kThreads);
  T* s_scal = reinterpret_cast<T*>(st_slot + kThreads);
  const int tid = threadIdx.x;
  if (LOSS) {
    for (int k = tid; k < n_scal; k += blockDim.x) s_scal[k] = scal[k];
  }
  const WideScene<T> ws = load_wide_scene(smem + stage_bytes<T>(), program, prefix_len,
                                          n_single_leaves, objtx, prim, glass, n_glass, slots,
                                          cull);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const bool active = i < n;

  // the carried cotangent: of the final state (generic mode) or zero
  Carry<T> bar;
  for (int c = 0; c < 3; ++c) bar.p[c] = bar.v[c] = T(0);
  bar.gen = bar.inten = bar.wav = bar.ridx = bar.rid = T(0);
  if (!LOSS && active) {
    for (int c = 0; c < 3; ++c) {
      bar.p[c] = d_fstate[c * n + i];
      bar.v[c] = d_fstate[(4 + c) * n + i];
    }
    bar.gen = d_fstate[8 * n + i];
    bar.inten = d_fstate[9 * n + i];
    bar.wav = d_fstate[10 * n + i];
    bar.ridx = d_fstate[11 * n + i];
    bar.rid = d_fstate[12 * n + i];
  }

  // every thread runs every generation: the block folds its glass
  // cotangents per generation between two barriers
  for (int g = generations - 1; g >= 0; --g) {
    int slot_out = -1;
    T gl[kGlass];
    if (active) {
      const T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
      int key = -1;
      // generation g > 0 ran iff mask[g-1] and its tilt rows are nonzero
      bool ran = true;
      if (g > 0) {
        ran = masks[static_cast<long long>(g - 1) * n + i] &&
              (rec[12 * n] != T(0) || rec[13 * n] != T(0) || rec[14 * n] != T(0));
      }
      if (ran) {
        T r[kRecordCols];
        for (int c = 0; c < kRecordCols; ++c) r[c] = rec[c * n];
        Carry<T> x;
        if (g == 0) {
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
        }

        // the fold, recomputed as K2 runs it, and the winner's normal
        WideHit<T> h;
        wide_nearest(ws, x.p, x.v, h);
        const bool no_hit = h.leaf < 0;
        const T t = no_hit ? T(0) : h.best;
        T nrm[3] = {T(0), T(0), T(0)};
        int slot = -1, type = 0, needs = 0;
        T scale = T(0);
        const T* m = objtx;
        const T* pr = prim;
        T lh[3] = {T(0), T(0), T(0)}, d[3] = {T(0), T(0), T(0)};
        if (!no_hit) {
          const int* L = ws.leaf + 5 * h.leaf;
          type = L[0];
          slot = L[1];
          scale = static_cast<T>(L[2]);
          needs = h.group >= 0 ? group_at(ws.prog, h.group).needs[h.pos] : L[3];
          m = objtx + 16 * h.leaf;
          pr = prim + 6 * h.leaf;
          if (needs) {
            T o[3];
            local_ray(m, x.p, x.v, o, d);
            for (int c = 0; c < 3; ++c) lh[c] = o[c] + t * d[c];
            world_normal(type, m, pr, lh, scale, nrm);
          }
        }

        // the tail: record and carried cotangents to the hit and the input
        T rb[kRecordCols];
        if (LOSS) {
          plan_drec(plan, s_scal, r, masks[static_cast<long long>(g) * n + i], rb);
        } else {
          const T* dr = d_records + static_cast<long long>(g) * kRecordCols * n + i;
          for (int c = 0; c < kRecordCols; ++c) rb[c] = dr[c * n];
        }
        TailAdjoint<T> a;
        tail_adjoint(ws.singles.kinds, ws.singles.glass, ray_offset, world_index, threshold,
                     apply_threshold, x, no_hit, slot, nrm, rb, bar, a, slot_out, gl);
        T t_bar = hit_point_adjoint(a, x, t);
        bar = input_bar(a);

        // the winning leaf: its normal and hit distance
        if (!no_hit) {
          T geo[kGeo];
          for (int k = 0; k < kGeo; ++k) geo[k] = T(0);
          T* m_bar = geo;
          T* pr_bar = geo + 12;
          T o_bar[3] = {T(0), T(0), T(0)}, d_bar[3] = {T(0), T(0), T(0)};
          T p_bar[3] = {T(0), T(0), T(0)}, v_bar[3] = {T(0), T(0), T(0)};
          if (needs) {
            T lh_bar[3];
            world_normal_adjoint(type, m, pr, lh, scale, a.nrm_bar, m_bar, pr_bar, lh_bar);
            for (int c = 0; c < 3; ++c) {
              o_bar[c] += lh_bar[c];
              d_bar[c] += t * lh_bar[c];
            }
            t_bar += dot3(lh_bar, d);
          }
          const int code = endpoint_code(leaf_pair_at(type, m, pr, x.p, x.v), t);
          hit_distance_adjoint(type, m, pr, x.p, x.v, code, t, t_bar, o_bar, d_bar, m_bar, pr_bar,
                               p_bar, v_bar);
          for (int c = 0; c < 3; ++c) {
            bar.p[c] += p_bar[c];
            bar.v[c] += v_bar[c];
          }
          key = h.leaf;
          store_entry(vals + (static_cast<long long>(g) * n + i) * kGeo, geo);
        }
      }
      keys[static_cast<long long>(g) * n + i] = key;
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
      partials[(static_cast<long long>(e) * generations + g) * gridDim.x + blockIdx.x] = sum;
    }
    __syncthreads();
  }

  if (active) {
    const T out[13] = {bar.p[0], bar.p[1], bar.p[2], T(0), bar.v[0], bar.v[1], bar.v[2], T(0),
                       bar.gen, bar.inten, bar.wav, bar.ridx, bar.rid};
    for (int c = 0; c < 13; ++c) d_state0[c * n + i] = out[c];
  }
}

template <typename T, bool LOSS>
int launch(const void* state0, long long n, int generations, const void* objtx,
           const void* prim, const void* glass, const void* program, int prefix_len,
           int n_single_leaves, int n_glass, const void* slots, const void* cull,
           const void* records, const void* masks, const void* d_records, const void* d_fstate,
           int plan, const void* scal, int n_scal, double ray_offset, double world_index,
           double threshold, int apply_threshold, void* d_state0, void* keys, void* vals,
           void* glass_partials, const void* reduce_slots, int n_rows, void* scratch,
           void* d_objtx, void* d_prim, void* d_glass, void* stream) {
  if (prefix_len < kWideHeader || n_single_leaves < 0 || n_single_leaves > kMaxSingleLeaves ||
      n_glass < 0 || generations < 0 || n_scal < 0 || n_scal > kMaxScal || n_rows < 0 ||
      (n_rows > 0 && scratch == nullptr) || cull == nullptr ||
      (LOSS && (plan < 0 || plan > 2 || scal == nullptr)) ||
      (!LOSS && (d_records == nullptr || d_fstate == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t smem = stage_bytes<T>() + wide_smem_bytes<T>(prefix_len, n_single_leaves, n_glass);
  auto kernel = wide_fused_bwd_kernel<T, LOSS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(state0), n, generations, static_cast<const T*>(objtx),
      static_cast<const T*>(prim), static_cast<const T*>(glass), static_cast<const int*>(program),
      prefix_len, n_single_leaves, n_glass, static_cast<const int*>(slots),
      static_cast<const T*>(cull), static_cast<const T*>(records), static_cast<const bool*>(masks),
      static_cast<const T*>(d_records), static_cast<const T*>(d_fstate), plan,
      static_cast<const T*>(scal), n_scal, static_cast<T>(ray_offset), static_cast<T>(world_index),
      static_cast<T>(threshold), apply_threshold, static_cast<T*>(d_state0),
      static_cast<int*>(keys), static_cast<T*>(vals), static_cast<double*>(glass_partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_glass > 0) {
    reduce_partials<T><<<static_cast<unsigned>(kGlass * n_glass), kReduceThreads, 0, s>>>(
        static_cast<const double*>(glass_partials), static_cast<int>(blocks * generations), 0,
        nullptr, nullptr, static_cast<T*>(d_glass));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_row_reduce<T>(keys, vals, static_cast<long long>(generations) * n, n_rows,
                              reduce_slots, scratch, d_objtx, d_prim, s);
}

}  // namespace

#define PYRAYT_FUSED_WIDE_ARGS                                                                  \
  const void *state0, long long n, int generations, const void *objtx, const void *prim,        \
      const void *glass, const void *program, int prefix_len, int n_single_leaves, int n_glass,  \
      const void *slots, const void *cull, const void *records, const void *masks,               \
      const void *d_records, const void *d_fstate, int plan, const void *scal, int n_scal,       \
      double ray_offset, double world_index, double threshold, int apply_threshold,              \
      void *d_state0, void *keys, void *vals, void *glass_partials, const void *reduce_slots,    \
      int n_rows, void *scratch, void *d_objtx, void *d_prim, void *d_glass, void *stream
#define PYRAYT_FUSED_WIDE_PASS                                                                  \
  state0, n, generations, objtx, prim, glass, program, prefix_len, n_single_leaves, n_glass,    \
      slots, cull, records, masks, d_records, d_fstate, plan, scal, n_scal, ray_offset,          \
      world_index, threshold, apply_threshold, d_state0, keys, vals, glass_partials,             \
      reduce_slots, n_rows, scratch, d_objtx, d_prim, d_glass, stream

extern "C" {

// plan < 0 reads the record cotangents from d_records and the final state's
// from d_fstate (generic mode); plan >= 0 builds the record cotangents from
// the loss plan's scalar row, with a zero final-state cotangent (loss mode)
int pyrayt_wide_fused_bwd_f32(PYRAYT_FUSED_WIDE_ARGS) {
  return plan < 0 ? launch<float, false>(PYRAYT_FUSED_WIDE_PASS)
                  : launch<float, true>(PYRAYT_FUSED_WIDE_PASS);
}
int pyrayt_wide_fused_bwd_f64(PYRAYT_FUSED_WIDE_ARGS) {
  return plan < 0 ? launch<double, false>(PYRAYT_FUSED_WIDE_PASS)
                  : launch<double, true>(PYRAYT_FUSED_WIDE_PASS);
}

// bytes of the reduce's scratch for n entries (G x rays) and n_rows rows;
// -1 past the reduce's limits (row_reduce.cuh)
long long pyrayt_wide_fused_reduce_scratch(long long n, int n_rows) {
  return reduce_plan(n, n_rows).bytes;
}

// threads per block: the wrapper sizes the glass partials (7 M x G blocks)
int pyrayt_wide_fused_block_threads() { return kThreads; }

const char* pyrayt_wide_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
