// Narrow backward kernels (K3 loss-fused, K4 generic) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pyrayt_tpu/ops/fused_grad.py:
// _make_bwd_kernel (both modes), run by _run_bwd and wrapped by
// build_fused_value_and_grad_fn (K3) and build_fused_vjp_trace_fn (K4).
// The TPU kernel gets its adjoint from jax.vjp of the forward step traced
// into the kernel; CUDA has no autodiff, so the adjoint here is written by
// hand, formula by formula, against the plain engine's autograd
// (pyrayt_tpu_torch/ops/fused_grad.py: fused_bwd_plain is the oracle).
//
// One thread per ray sweeps the generations that ray ran, last first:
//
//   * which generations ran: K1 writes zero records and false masks for the
//     generations a ray did not run, so generation g > 0 ran iff mask[g-1]
//     is set and the record's tilt rows (the unit input direction of g) are
//     nonzero.  A skipped generation passes the state cotangent through:
//     a stopped ray keeps its state.
//   * state reconstruction: generation 0 starts from the true initial state;
//     generation g > 0 from its record rows (positions x0..z0, directions
//     from the tilt rows, metadata rows 0-4).
//   * forward recompute of that generation (the same nearest hit as K1,
//     with the hit code of the winning endpoint carried out of the fold,
//     so the winner's intersector runs once), then the adjoint: record
//     cotangent + carried state cotangent -> input-state cotangent and the
//     cotangents of the hit leaf's 16 transform and 6 primitive entries
//     and of the glass row.
//   * the record cotangent is read from d_records (K4) or synthesized from
//     the loss plan's scalar row (K3: RmsSpotRadius, FocusError,
//     SoftFocusError, the formulas of ops/fused_grad.py's plans); K3's
//     final-state cotangent is zero.
//
// The hit distance is one endpoint of one leaf (CSG only selects values),
// so its adjoint is the derivative of the formula named by that endpoint's
// hit code (a root with its safe_sqrt guard, the linear root, a slab or cap
// bound, a plane, a cube face).  Normals are differentiated in K1's form
// (lp = M p_hit + m, inverse-transpose, guarded normalization, scale).
//
// Deterministic parameter sums, per warp: after each generation the 32
// lanes of a warp fold their hit leaf's 18 values and their glass slot's 7
// into the warp's own float64 row of entries in shared memory, choosing by
// the number of distinct keys (__match_any_sync, __ballot_sync).  Up to
// three: key by key, the lanes of a key found in ascending lane order and
// each value summed over the warp by a fixed xor butterfly of
// __shfl_xor_sync, lane 0 adding the sums.  More: column by column, the
// values staged in the warp's rows of shared memory and lane j < 25 adding
// value j of the 32 lanes in lane order into its entries (distinct entries
// per lane, a run of lanes with one key summed in a register first).  The
// butterfly's cost grows with the keys, the column fold's does not (PERF.md:
// the condenser's warps hold one or two keys a generation, a warp of the
// hetero row's unsorted line about ten).  Only __syncwarp orders the
// fold: no barrier inside the generation loop, and every lane runs all G
// generations (a lane that did not run one has no key), so the warp's
// collectives see the full mask.  After the loop the block adds its warps'
// rows in warp order into its per-block partial (float64), and a second
// kernel reduces the partials in fixed order.  Fixed lanes, shuffle trees,
// warp and block orders and no atomics: two launches on the same inputs
// give bit-identical gradients.
//
// Numerics: FMA contraction stays on (as in K1), so at float64 the result
// differs from the plain autograd version by rounding and sum order; sums
// are float64 at either precision.
//
// What bounds it on an H100: per ray it reads the 15 record rows (and, in
// K4, the 15 d_records rows) of each generation it ran, at most the 3 tilt
// rows of the first generation it did not run (to see the skip), the masks,
// the initial state and, in K4, d_fstate, and writes d_state0 (13*n); no
// other row of a generation it did not run is read.  Per ray and
// generation it recomputes the whole forward step and its adjoint: branchy
// scalar math, with the CSG lists in local memory, as K1.  The fold costs a
// warp a few hundred instructions per generation, whatever the scene's
// size (the block-wide scan it replaced read every entry of the scene for
// each of the block's 128 rays in every generation, behind two block
// barriers).

#include "adjoint_common.cuh"

namespace {

using namespace pyrayt;

constexpr int kBwdThreads = 128;  // threads per block
constexpr int kWarps = kBwdThreads / 32;

// a candidate's leaf and the hit code of its endpoint in one id, so the
// interval and network payloads carry the code to the nearest hit
__device__ __forceinline__ int coded(int s, int code) { return s * 16 + code + 1; }

// trace_common.cuh's iv_apply with each endpoint of b tagged with its hit
// code (coded ids)
template <typename T>
__device__ __forceinline__ void iv_apply_coded(Intervals<T>& iv, int op, Pair<T> b, int s) {
  const int s_lo = coded(s, b.clo), s_hi = coded(s, b.chi);
  if (op == IV_LOAD) {
    iv.lo[0] = b.lo; iv.hi[0] = b.hi; iv.lo_id[0] = s_lo; iv.hi_id[0] = s_hi;
    iv.n = 1;
  } else if (op == IV_AND) {
    for (int j = 0; j < iv.n; ++j) {
      T a0 = iv.lo[j], a1 = iv.hi[j];
      T lo = mx(a0, b.lo), hi = mn(a1, b.hi);
      iv.lo_id[j] = b.lo > a0 ? s_lo : iv.lo_id[j];
      iv.hi_id[j] = b.hi < a1 ? s_hi : iv.hi_id[j];
      bool empty = lo > hi;
      iv.lo[j] = empty ? inf_v<T>() : lo;
      iv.hi[j] = empty ? inf_v<T>() : hi;
    }
  } else {  // IV_SUB
    for (int j = iv.n - 1; j >= 0; --j) {
      T a0 = iv.lo[j], a1 = iv.hi[j];
      int i0 = iv.lo_id[j], i1 = iv.hi_id[j];
      T p1_hi = mn(a1, b.lo);
      int p1_hi_id = b.lo < a1 ? s_lo : i1;
      bool e1 = a0 > p1_hi;
      T p2_lo = mx(a0, b.hi);
      int p2_lo_id = b.hi > a0 ? s_hi : i0;
      bool e2 = p2_lo > a1;
      iv.lo[2 * j] = e1 ? inf_v<T>() : a0;
      iv.hi[2 * j] = e1 ? inf_v<T>() : p1_hi;
      iv.lo_id[2 * j] = i0;
      iv.hi_id[2 * j] = p1_hi_id;
      iv.lo[2 * j + 1] = e2 ? inf_v<T>() : p2_lo;
      iv.hi[2 * j + 1] = e2 ? inf_v<T>() : a1;
      iv.lo_id[2 * j + 1] = p2_lo_id;
      iv.hi_id[2 * j + 1] = i1;
    }
    iv.n *= 2;
  }
}

// trace_common.cuh's nearest_hit (the same candidates in the same fold
// order, strict <), which also returns the hit code of the winning
// endpoint, so the adjoint need not evaluate the winner's intersector again
template <typename T>
__device__ void nearest_hit_coded(const Scene<T>& sc, const T p[3], const T v[3], T& best,
                                  int& leaf, int& code) {
  Intervals<T> iv;
  iv.n = 0;
  T row_key[kMaxRows];
  int row_id[kMaxRows];
  int top = 0;
  int win = -1;
  best = inf_v<T>();
  auto fold = [&](T cand, int id) {
    cand = cand > T(0) ? cand : inf_v<T>();
    if (cand < best) {
      best = cand;
      win = id;
    }
  };
  for (int k = 0; k < sc.n_instr; ++k) {
    const int* in = sc.instr + kInstrWidth * k;
    const int s = in[1];
    switch (in[0]) {
      case IV_LOAD:
      case IV_AND:
      case IV_SUB:
        iv_apply_coded(iv, in[0], leaf_pair(sc, s, p, v), s);
        break;
      case IV_FOLD:
        for (int j = 0; j < iv.n; ++j) {
          fold(iv.lo[j], iv.lo_id[j]);
          fold(iv.hi[j], iv.hi_id[j]);
        }
        break;
      case NET_PUSH: {
        Pair<T> h = leaf_pair(sc, s, p, v);
        row_key[top] = h.lo; row_id[top] = coded(s, h.clo);
        row_key[top + 1] = h.hi; row_id[top + 1] = coded(s, h.chi);
        top += 2;
        break;
      }
      case NET_COMBINE: {
        // the network sorts its ids as payloads: coded ids ride along
        int base = top - in[2] - in[3];
        network_combine(sc, in, row_key + base, row_id + base);
        break;
      }
      case NET_FOLD:
        for (int j = 0; j < top; ++j) fold(row_key[j], row_id[j]);
        top = 0;
        break;
      default:  // a narrow program has no wide group
        break;
    }
  }
  leaf = win < 0 ? -1 : win / 16;
  code = win < 0 ? C_NONE : win % 16 - 1;
}

constexpr int kFoldValues = kGeo + kGlass;  // values a lane hands to the fold
constexpr int kStageRow = 33;                // lanes per staged value, padded
constexpr unsigned kFullMask = 0xffffffffu;
// distinct keys (leaves and glass slots) up to which a warp folds key by key
constexpr int kKeyFoldMax = 3;

// the lanes holding the lowest lane of each distinct key >= 0
__device__ __forceinline__ unsigned key_leaders(int key) {
  const unsigned peers = __match_any_sync(kFullMask, key);
  return __ballot_sync(kFullMask, key >= 0 && __ffs(peers) - 1 == (threadIdx.x & 31));
}

// the sum of v over the warp's 32 lanes by a fixed xor butterfly: every
// lane ends with the same bits (each step adds the same two values in
// either lane)
__device__ __forceinline__ double warp_sum(double v) {
  for (int offset = 16; offset > 0; offset /= 2) v += __shfl_xor_sync(kFullMask, v, offset);
  return v;
}

// For each key of `leaders` in ascending lane order, each of the COUNT
// values summed over the lanes holding that key (the others adding 0);
// lane 0 adds sum k to row[entry(key, k)].
template <int COUNT, typename T, typename Entry>
__device__ __forceinline__ void fold_keys(double* row, int key, const T* vals, unsigned leaders,
                                          Entry entry) {
  while (leaders) {
    const int target = __shfl_sync(kFullMask, key, __ffs(leaders) - 1);
    leaders &= leaders - 1;
    const bool mine = key == target;
#pragma unroll
    for (int k = 0; k < COUNT; ++k) {
      const double sum = warp_sum(mine ? static_cast<double>(vals[k]) : 0.0);
      if ((threadIdx.x & 31) == 0) row[entry(target, k)] += sum;
    }
  }
}

// One generation of a warp into its accumulator row `row` (entries:
// d_objtx (16 S), d_prim (6 S), d_glass (7 M)) from each lane's hit leaf's
// 18 values (transform rows 0-2, then prim; row 3 of the transform never
// enters the step) and its glass slot's 7 (keys -1: none).  With few
// distinct keys, key by key: each value summed over the warp by a shuffle
// butterfly.  With more, column by column: the lanes stage their keys and
// values in the warp's rows of shared memory, then lane j < 25 adds value
// j of the 32 lanes in lane order into its entries, a run of lanes with
// one key summed in a register first.  Both orders are fixed and need no
// atomics (in the column fold the lanes add into distinct entries).
template <typename T>
__device__ __forceinline__ void warp_fold(double* row, T* stage, int* keys, int n_leaves, int leaf,
                                          const T geo[kGeo], int slot, const T gl[kGlass]) {
  auto geo_entry = [n_leaves](int s, int k) {
    return k < 12 ? 16 * s + k : 16 * n_leaves + 6 * s + (k - 12);
  };
  auto glass_entry = [n_leaves](int m, int k) { return 22 * n_leaves + kGlass * m + k; };
  const unsigned geo_leaders = key_leaders(leaf), glass_leaders = key_leaders(slot);
  if (__popc(geo_leaders) + __popc(glass_leaders) <= kKeyFoldMax) {
    fold_keys<kGeo>(row, leaf, geo, geo_leaders, geo_entry);
    fold_keys<kGlass>(row, slot, gl, glass_leaders, glass_entry);
    return;
  }
  const int lane = threadIdx.x & 31;
  keys[lane] = leaf;
  keys[32 + lane] = slot;
  if (leaf >= 0) {
    for (int k = 0; k < kGeo; ++k) stage[k * kStageRow + lane] = geo[k];
  }
  if (slot >= 0) {
    for (int k = 0; k < kGlass; ++k) stage[(kGeo + k) * kStageRow + lane] = gl[k];
  }
  __syncwarp();
  if (lane < kFoldValues) {
    const bool is_glass = lane >= kGeo;
    const int k = is_glass ? lane - kGeo : lane;
    const int* key = keys + (is_glass ? 32 : 0);
    const T* value = stage + lane * kStageRow;
    auto entry = [&](int s) { return is_glass ? glass_entry(s, k) : geo_entry(s, k); };
    int run = -1;
    double sum = 0.0;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int s = key[r];
      if (s != run) {
        if (run >= 0) row[entry(run)] += sum;
        run = s;
        sum = 0.0;
      }
      if (s >= 0) sum += static_cast<double>(value[r]);
    }
    if (run >= 0) row[entry(run)] += sum;
  }
  __syncwarp();
}

// dynamic shared memory of a block: the warps' accumulator rows and
// staging rows, the scene's tables, the loss plan's scalars, the warps'
// staged keys and the program
template <typename T>
size_t bwd_smem_bytes(int n_leaves, int n_glass, int program_len) {
  const size_t n_entries = 22 * static_cast<size_t>(n_leaves) + kGlass * static_cast<size_t>(n_glass);
  return sizeof(double) * kWarps * n_entries +
         sizeof(T) * (kWarps * kFoldValues * kStageRow + n_entries + kMaxScal) +
         sizeof(int) * (kWarps * 64 + static_cast<size_t>(program_len));
}

// One generation of one ray: recompute the forward step from `x`, then map
// the cotangents of its outputs (the next state `bar` and the record `rb`)
// to the cotangent of its input state (written to `bar`) and to the
// parameter cotangents of the hit leaf (`geo`: transform rows 0-2, then
// prim) and of the glass slot (`gl`).  `leaf_out` / `slot_out` are -1 when
// nothing lands there.
template <typename T>
__device__ void step_adjoint(const Scene<T>& sc, T ray_offset, T world_index, T threshold,
                             int apply_threshold, const Carry<T>& x, const T rb[kRecordCols],
                             Carry<T>& bar, int& leaf_out, T geo[kGeo], int& slot_out,
                             T gl[kGlass]) {
  leaf_out = -1;
  for (int k = 0; k < kGeo; ++k) geo[k] = T(0);

  // ---- forward recompute (fused_trace.cu, one generation) ----------------
  T best;
  int leaf, code;
  nearest_hit_coded(sc, x.p, x.v, best, leaf, code);
  const bool no_hit = leaf < 0;
  const T t = no_hit ? T(0) : best;
  T ph[3];
  for (int c = 0; c < 3; ++c) ph[c] = x.p[c] + t * x.v[c];
  const int* L = sc.leaf + 5 * (no_hit ? 0 : leaf);
  const T* m = sc.objtx + 16 * (no_hit ? 0 : leaf);
  const T* pr = sc.prim + 6 * (no_hit ? 0 : leaf);
  T lp[3] = {T(0), T(0), T(0)}, nrm[3] = {T(0), T(0), T(0)};
  if (!no_hit && L[3]) {
    for (int r = 0; r < 3; ++r) {
      lp[r] = m[4 * r] * ph[0] + m[4 * r + 1] * ph[1] + m[4 * r + 2] * ph[2] + m[4 * r + 3];
    }
    world_normal(L[0], m, pr, lp, static_cast<T>(L[2]), nrm);
  }

  // ---- adjoint: next state, record and material --------------------------
  TailAdjoint<T> a;
  tail_adjoint(sc.kinds, sc.glass, ray_offset, world_index, threshold, apply_threshold, x, no_hit,
               no_hit ? -1 : L[1], nrm, rb, bar, a, slot_out, gl);
  T* m_bar = geo;        // 12 entries: rows 0-2 of the object transform
  T* pr_bar = geo + 12;  // 6 entries
  if (!no_hit) {
    leaf_out = leaf;
    // normal adjoint: nrm = scale * wn / |wn|, wn = M^T ln(lp), lp = M ph + m
    if (L[3]) {
      T lp_bar[3];
      world_normal_adjoint(L[0], m, pr, lp, static_cast<T>(L[2]), a.nrm_bar, m_bar, pr_bar, lp_bar);
      for (int r = 0; r < 3; ++r) {
        for (int j = 0; j < 3; ++j) {
          m_bar[4 * r + j] += lp_bar[r] * ph[j];
          a.ph_bar[j] += m[4 * r + j] * lp_bar[r];
        }
        m_bar[4 * r + 3] += lp_bar[r];
      }
    }
  }
  // p_hit = p + t v
  const T t_bar = hit_point_adjoint(a, x, t);
  if (!no_hit) {
    // the hit distance: the winning endpoint of the hit leaf
    T o_bar[3] = {T(0), T(0), T(0)}, d_bar[3] = {T(0), T(0), T(0)};
    hit_distance_adjoint(L[0], m, pr, x.p, x.v, code, best, t_bar, o_bar, d_bar, m_bar, pr_bar,
                         a.p_bar, a.v_bar);
  }
  bar = input_bar(a);
}

template <typename T, bool LOSS>
__global__ void __launch_bounds__(kBwdThreads) fused_bwd_kernel(
    const T* __restrict__ state0, long long n, int generations,
    const T* __restrict__ objtx, const T* __restrict__ prim, const T* __restrict__ glass,
    const int* __restrict__ program, int program_len, int n_leaves, int n_glass,
    const T* __restrict__ records, const bool* __restrict__ masks,
    const T* __restrict__ drec, const T* __restrict__ dfstate,
    int plan, const T* __restrict__ scal, int n_scal,
    T ray_offset, T world_index, T threshold, int apply_threshold,
    T* __restrict__ dstate0, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_entries = 22 * n_leaves + kGlass * n_glass;
  double* acc = reinterpret_cast<double*>(smem);  // (kWarps, n_entries)
  T* stage = reinterpret_cast<T*>(acc + kWarps * n_entries);  // (kWarps, 25, kStageRow)
  T* s_objtx = stage + kWarps * kFoldValues * kStageRow;
  T* s_prim = s_objtx + 16 * n_leaves;
  T* s_glass = s_prim + 6 * n_leaves;
  T* s_scal = s_glass + kGlass * n_glass;
  int* keys = reinterpret_cast<int*>(s_scal + kMaxScal);  // (kWarps, 2, 32)
  int* s_prog = keys + kWarps * 64;
  const int tid = threadIdx.x;
  for (int k = tid; k < 16 * n_leaves; k += blockDim.x) s_objtx[k] = objtx[k];
  for (int k = tid; k < 6 * n_leaves; k += blockDim.x) s_prim[k] = prim[k];
  for (int k = tid; k < kGlass * n_glass; k += blockDim.x) s_glass[k] = glass[k];
  for (int k = tid; k < program_len; k += blockDim.x) s_prog[k] = program[k];
  for (int k = tid; k < kWarps * n_entries; k += blockDim.x) acc[k] = 0.0;
  if (LOSS) {
    for (int k = tid; k < n_scal; k += blockDim.x) s_scal[k] = scal[k];
  }
  __syncthreads();
  const Scene<T> sc = make_scene(s_objtx, s_prim, s_glass, s_prog, n_leaves);
  const int warp = tid / 32;
  double* row = acc + warp * n_entries;  // this warp's entries
  T* warp_stage = stage + warp * kFoldValues * kStageRow;
  int* warp_keys = keys + warp * 64;

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const bool active = i < n;
  Carry<T> bar;
  for (int c = 0; c < 3; ++c) {
    bar.p[c] = (!LOSS && active) ? dfstate[c * n + i] : T(0);
    bar.v[c] = (!LOSS && active) ? dfstate[(4 + c) * n + i] : T(0);
  }
  bar.gen = (!LOSS && active) ? dfstate[8 * n + i] : T(0);
  bar.inten = (!LOSS && active) ? dfstate[9 * n + i] : T(0);
  bar.wav = (!LOSS && active) ? dfstate[10 * n + i] : T(0);
  bar.ridx = (!LOSS && active) ? dfstate[11 * n + i] : T(0);
  bar.rid = (!LOSS && active) ? dfstate[12 * n + i] : T(0);

  for (int g = generations - 1; g >= 0; --g) {
    const T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
    bool run = false;
    if (active) {
      run = g == 0 || (masks[static_cast<long long>(g - 1) * n + i] &&
                       (rec[12 * n] != T(0) || rec[13 * n] != T(0) || rec[14 * n] != T(0)));
    }
    int leaf = -1, slot = -1;
    T geo[kGeo], gl[kGlass];
    if (run) {
      T r[kRecordCols], rb[kRecordCols];
      for (int c = 0; c < kRecordCols; ++c) r[c] = rec[c * n];
      if (LOSS) {
        plan_drec(plan, s_scal, r, masks[static_cast<long long>(g) * n + i], rb);
      } else {
        const T* d = drec + static_cast<long long>(g) * kRecordCols * n + i;
        for (int c = 0; c < kRecordCols; ++c) rb[c] = d[c * n];
      }
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
      step_adjoint(sc, ray_offset, world_index, threshold, apply_threshold, x, rb, bar, leaf,
                   geo, slot, gl);
    }
    warp_fold(row, warp_stage, warp_keys, n_leaves, leaf, geo, slot, gl);
  }

  if (active) {
    const T out[13] = {bar.p[0], bar.p[1], bar.p[2], T(0), bar.v[0], bar.v[1], bar.v[2], T(0),
                       bar.gen, bar.inten, bar.wav, bar.ridx, bar.rid};
    for (int c = 0; c < 13; ++c) dstate0[c * n + i] = out[c];
  }
  // per-block partials, entry-major: partials[e * gridDim.x + block], the
  // warps' rows added in warp order
  __syncthreads();
  for (int e = tid; e < n_entries; e += blockDim.x) {
    double sum = acc[e];
    for (int w = 1; w < kWarps; ++w) sum += acc[w * n_entries + e];
    partials[static_cast<long long>(e) * gridDim.x + blockIdx.x] = sum;
  }
}

template <typename T, bool LOSS>
int launch(const void* state0, long long n, int generations, const void* objtx,
           const void* prim, const void* glass, const void* program, int program_len,
           int n_leaves, int n_glass, const void* records, const void* masks, const void* drec,
           const void* dfstate, int plan, const void* scal, int n_scal, double ray_offset,
           double world_index, double threshold, int apply_threshold, void* dstate0,
           void* partials, void* d_objtx, void* d_prim, void* d_glass, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_glass < 0 || program_len < 4 ||
      generations < 0 || n_scal < 0 || n_scal > kMaxScal || (LOSS && (plan < 0 || plan > 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const long long blocks = (n + kBwdThreads - 1) / kBwdThreads;
  const size_t n_entries = 22 * static_cast<size_t>(n_leaves) + kGlass * static_cast<size_t>(n_glass);
  const size_t smem = bwd_smem_bytes<T>(n_leaves, n_glass, program_len);
  auto kernel = fused_bwd_kernel<T, LOSS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, s>>>(
      static_cast<const T*>(state0), n, generations, static_cast<const T*>(objtx),
      static_cast<const T*>(prim), static_cast<const T*>(glass),
      static_cast<const int*>(program), program_len, n_leaves, n_glass,
      static_cast<const T*>(records), static_cast<const bool*>(masks),
      static_cast<const T*>(drec), static_cast<const T*>(dfstate), plan,
      static_cast<const T*>(scal), n_scal, static_cast<T>(ray_offset),
      static_cast<T>(world_index), static_cast<T>(threshold), apply_threshold,
      static_cast<T*>(dstate0), static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<T><<<static_cast<unsigned>(n_entries), kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), static_cast<int>(blocks), n_leaves,
      static_cast<T*>(d_objtx), static_cast<T*>(d_prim), static_cast<T*>(d_glass));
  return static_cast<int>(cudaGetLastError());
}

// the kernel instance of (T, LOSS), for the occupancy query
template <typename T, bool LOSS>
const void* occupancy_kernel() {
  return reinterpret_cast<const void*>(fused_bwd_kernel<T, LOSS>);
}

}  // namespace

#define PYRAYT_BWD_ARGS                                                                      \
  const void *state0, long long n, int generations, const void *objtx, const void *prim,     \
      const void *glass, const void *program, int program_len, int n_leaves, int n_glass,    \
      const void *records, const void *masks, const void *drec, const void *dfstate,         \
      int plan, const void *scal, int n_scal, double ray_offset, double world_index,         \
      double threshold, int apply_threshold, void *dstate0, void *partials, void *d_objtx,   \
      void *d_prim, void *d_glass, void *stream
#define PYRAYT_BWD_PASS                                                                      \
  state0, n, generations, objtx, prim, glass, program, program_len, n_leaves, n_glass,       \
      records, masks, drec, dfstate, plan, scal, n_scal, ray_offset, world_index, threshold, \
      apply_threshold, dstate0, partials, d_objtx, d_prim, d_glass, stream

extern "C" {

// K4: record and final-state cotangents from buffers (plan, scal unused)
int pyrayt_fused_bwd_f32(PYRAYT_BWD_ARGS) { return launch<float, false>(PYRAYT_BWD_PASS); }
int pyrayt_fused_bwd_f64(PYRAYT_BWD_ARGS) { return launch<double, false>(PYRAYT_BWD_PASS); }

// K3: record cotangents from a loss plan's scalar row (drec, dfstate unused)
int pyrayt_fused_bwd_loss_f32(PYRAYT_BWD_ARGS) { return launch<float, true>(PYRAYT_BWD_PASS); }
int pyrayt_fused_bwd_loss_f64(PYRAYT_BWD_ARGS) { return launch<double, true>(PYRAYT_BWD_PASS); }

// threads per block of the backward kernel: the wrapper sizes the
// per-block partials (n_entries, ceil(n / threads)) from it
int pyrayt_bwd_block_threads() { return kBwdThreads; }

// blocks of the K3 (loss != 0) or K4 kernel an SM can hold for a scene of
// these sizes (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative
// CUDA error code on failure)
int pyrayt_bwd_occupancy(int f64, int loss, int n_leaves, int n_glass, int program_len) {
  const size_t smem = f64 ? bwd_smem_bytes<double>(n_leaves, n_glass, program_len)
                          : bwd_smem_bytes<float>(n_leaves, n_glass, program_len);
  auto kernel = f64 ? (loss ? occupancy_kernel<double, true>() : occupancy_kernel<double, false>())
                    : (loss ? occupancy_kernel<float, true>() : occupancy_kernel<float, false>());
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBwdThreads, smem);
  }
  cudaGetLastError();  // leave no error for the next launch to report
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* pyrayt_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
