// Narrow forward trace kernel (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pyrayt_tpu/ops/fused_trace.py:
// _make_step (the generation step), driven by _run_while_kernel and
// launched by build_fused_trace_fn.  One thread runs one ray's whole
// bounce loop in registers:
//
//   PROPAGATE  every leaf's affine transform, the five primitive
//              intersectors, interval CSG (left-deep intersect/difference
//              chains) or the comparator-network CSG (general trees), and
//              the nearest positive hit (strict <, first candidate wins);
//   INTERACT   the hit leaf's world normal (absorber-only leaves skip it),
//              absorb / reflect / Sellmeier refraction with TIR;
//   RECORD     one 15-column row and its mask per generation, then the
//              1e-6 push-off.
//
// The scene is runtime data: a host-built int32 "scene program"
// (pyrayt_tpu_torch/ops/fused_trace.py:scene_program) and the obj_tx
// (S,16) / prim (S,6) / glass (M,7) tables, copied into shared memory per
// block.  One build serves every scene.
//
// Contract (per-ray exit; the TPU kernel exits per block of rays):
//   * a ray runs generation g when it was alive after g-1 (every ray runs
//     generation 0); it stops after the generation in which it died or was
//     absorbed (new direction zero), and keeps that state;
//   * masks, masked records, the final state and generations_run equal the
//     plain version's (fused_trace_plain); records and masks of generations
//     a ray did not run are written as zero / false, which the backward
//     kernel of a later slice relies on;
//   * a global loop (the JAX engines) keeps stepping dead rays, so its
//     final state differs where a dead ray still moves: with
//     apply_intensity_threshold a threshold-killed ray keeps advancing
//     there, and a zero-direction ray inside a glass paraboloid's volume
//     "hits" it and refracts to a nonzero direction.  Here both stop.
//   * the final state restores the homogeneous w rows (1 and 0); rays are
//     neither padded nor tiled, the ragged tail is masked by the index test.
//
// Numerics: nvcc contracts a*b+c into FMAs (the default, kept here), which
// eager PyTorch does not.  Results therefore differ from the plain version
// by rounding: at float64 records agree to ~1e-12 and a mask flips only
// for a ray that grazes an edge to within rounding; at float32 the same
// holds at ~1e-6 relative.  The Sellmeier denominator is guarded at its
// pole (wl^2 == c), as in the TPU kernel.
//
// What bounds it on an H100: the record writes, 15*G*n*itemsize bytes of
// coalesced stores (377 MB at 2^20 rays, 6 generations, float32: ~0.11 ms
// at 3.35 TB/s), against per-ray compute whose CSG lists live in local
// memory (L1-resident) and whose divergence follows the scene.  No TMA,
// no tensor cores: the work is branchy scalar math per ray.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kMaxIntervals = 16;  // = MAX_INTERVALS in ops/fused_trace.py
constexpr int kMaxRows = 16;       // = MAX_NET_ROWS in ops/fused_trace.py
constexpr int kRecordCols = 15;
constexpr int kThreads = 128;
constexpr int kInstrWidth = 6;

enum Opcode { IV_LOAD = 0, IV_AND, IV_SUB, IV_FOLD, NET_PUSH, NET_COMBINE, NET_FOLD };
enum Prim { SPHERE = 0, PARABOLOID, PLANE, CUBE, CYLINDER };
enum Kind { ABSORB = 0, MIRROR, GLASS };
enum CsgOp { UNION = 1, INTERSECT, DIFFERENCE };

template <typename T>
__device__ __forceinline__ T inf_v() {
  return static_cast<T>(INFINITY);
}

template <typename T>
__device__ __forceinline__ T mn(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T mx(T a, T b) {
  return b > a ? b : a;
}

// numpy.isclose(a, 0): |a| <= atol
template <typename T>
__device__ __forceinline__ bool isclose0(T a) {
  return fabs(a) <= T(1e-8);
}

// numpy.isclose(a, b): |a - b| <= atol + rtol * |b|
template <typename T>
__device__ __forceinline__ bool isclose(T a, T b) {
  return a == b || fabs(a - b) <= T(1e-8) + T(1e-5) * fabs(b);
}

template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) {
  return x > T(0) ? sqrt(x) : T(0);
}

template <typename T>
struct Pair {
  T lo, hi;
};

template <typename T>
__device__ __forceinline__ Pair<T> sort2(T a, T b) {
  return {mn(a, b), mx(a, b)};
}

// clip a sorted interval against another; (inf, inf) when disjoint
template <typename T>
__device__ __forceinline__ Pair<T> slab_clip(Pair<T> h, T lo, T hi) {
  T entry = mx(h.lo, lo);
  T exit_ = mn(h.hi, hi);
  if (entry <= exit_) return {entry, exit_};
  return {inf_v<T>(), inf_v<T>()};
}

// entry/exit parameters of the z in [z_lo, z_hi] slab
template <typename T>
__device__ __forceinline__ Pair<T> slab(T oz, T dz, T z_lo, T z_hi) {
  bool parallel = isclose0(dz);
  bool inside = oz >= z_lo && oz <= z_hi;
  T den = dz + (parallel ? T(1) : T(0));
  Pair<T> s = sort2((z_lo - oz) / den, (z_hi - oz) / den);
  if (parallel) return {inside ? -inf_v<T>() : inf_v<T>(), inf_v<T>()};
  return s;
}

template <typename T>
__device__ Pair<T> sphere_hit(const T o[3], const T d[3], T r) {
  T a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  T b = T(2) * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
  T c = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) - r * r;
  T disc = b * b - T(4) * a * c;
  T root = safe_sqrt(disc);
  bool degenerate = isclose0(a);  // zero-direction rays never hit
  if (!(disc >= T(0)) || degenerate) return {inf_v<T>(), inf_v<T>()};
  T den = T(2) * a;
  return {(-b + root) / den, (-b - root) / den};
}

template <typename T>
__device__ Pair<T> paraboloid_hit(const T o[3], const T d[3], T focus, T height) {
  T a = d[0] * d[0] + d[1] * d[1];
  T b = T(2) * (o[0] * d[0] + o[1] * d[1]) - T(4) * focus * d[2];
  T c = (o[0] * o[0] + o[1] * o[1]) - T(4) * focus * o[2];
  T disc = b * b - T(4) * a * c;
  bool linear = isclose0(a);
  T root = safe_sqrt(disc);
  T h0, h1;
  if (linear) {
    // one real hit plus a signed infinity by travel direction
    h0 = -c / (b + (isclose0(b) ? T(1) : T(0)));
    h1 = d[2] >= T(0) ? inf_v<T>() : -inf_v<T>();
  } else if (disc >= T(0)) {
    T den = T(2) * a;
    h0 = (-b + root) / den;
    h1 = (-b - root) / den;
  } else {
    h0 = h1 = inf_v<T>();
  }
  Pair<T> s = slab(o[2], d[2], T(0), height);
  return slab_clip(sort2(h0, h1), s.lo, s.hi);
}

template <typename T>
__device__ Pair<T> plane_hit(const T o[3], const T d[3], T width, T length) {
  T lo[2], hi[2];
  const T dims[2] = {width, length};
  for (int axis = 0; axis < 2; ++axis) {
    T half = dims[axis] / T(2);
    bool is_zero = isclose0(d[axis]);
    T den = d[axis] + (is_zero ? T(1) : T(0));
    T skew = fabs(o[axis]) <= half ? -inf_v<T>() : inf_v<T>();
    T hit1 = -(o[axis] - half) / den;
    T hit2 = -(o[axis] + half) / den;
    Pair<T> p = sort2(is_zero ? skew : hit1, is_zero ? inf_v<T>() : hit2);
    lo[axis] = p.lo;
    hi[axis] = p.hi;
  }
  T max_of_min = mx(lo[0], lo[1]);
  T min_of_max = mn(hi[0], hi[1]);
  bool skew_ray = isclose0(d[2]);
  T t = skew_ray ? inf_v<T>() : -o[2] / d[2];
  if (!(t >= max_of_min && t <= min_of_max)) t = inf_v<T>();
  return {t, t};  // duplicated: a zero-volume solid has an even hit count
}

template <typename T>
__device__ Pair<T> cube_hit(const T o[3], const T d[3], const T* pr) {
  T entry = -inf_v<T>(), exit_ = inf_v<T>();
  for (int axis = 0; axis < 3; ++axis) {
    T lo = pr[2 * axis], hi = pr[2 * axis + 1];
    bool is_zero = isclose0(d[axis]);
    bool inside = o[axis] >= lo && o[axis] <= hi;
    T den = d[axis] + (is_zero ? T(1) : T(0));
    T skew_min = inside ? -inf_v<T>() : inf_v<T>();
    T hit_lo = -(o[axis] - lo) / den;
    T hit_hi = -(o[axis] - hi) / den;
    Pair<T> p = sort2(is_zero ? skew_min : hit_lo, is_zero ? inf_v<T>() : hit_hi);
    entry = axis == 0 ? p.lo : mx(entry, p.lo);
    exit_ = axis == 0 ? p.hi : mn(exit_, p.hi);
  }
  // strict <: a corner graze is a miss
  if (entry < exit_) return {entry, exit_};
  return {inf_v<T>(), inf_v<T>()};
}

template <typename T>
__device__ Pair<T> cylinder_hit(const T o[3], const T d[3], T r, T h_min, T h_max) {
  T a = d[0] * d[0] + d[1] * d[1];
  T b = T(2) * (d[0] * o[0] + d[1] * o[1]);
  T c = (o[0] * o[0] + o[1] * o[1]) - r * r;
  // binomial_root with its CSG edge conventions
  T disc = b * b - T(4) * a * c;
  bool linear = isclose0(a);
  T root = safe_sqrt(disc);
  T r0, r1;
  if (linear) {
    if (isclose0(b)) {
      r0 = c <= T(0) ? -inf_v<T>() : inf_v<T>();  // always / never inside
      r1 = inf_v<T>();
    } else {
      r0 = r1 = -c / b;
    }
  } else if (disc >= T(0)) {
    T den = T(2) * a;
    r0 = (-b + root) / den;
    r1 = (-b - root) / den;
  } else {
    r0 = r1 = inf_v<T>();
  }
  Pair<T> s = slab(o[2], d[2], h_min, h_max);
  return slab_clip(sort2(r0, r1), s.lo, s.hi);
}

template <typename T>
struct Scene {
  const T* objtx;     // (S, 16) row-major object transforms (world inverse)
  const T* prim;      // (S, 6)
  const T* glass;     // (M, 7)
  const int* leaf;    // (S, 5): type, mat_slot, normal_scale, needs_normal, id
  const int* kinds;   // (M,)
  const int* instr;   // (n_instr, 6)
  const int* pairs;   // comparator (i, j) pairs
  int n_instr;
};

// sorted (entry, exit) pair of leaf s for the world ray (p, v)
template <typename T>
__device__ Pair<T> leaf_pair(const Scene<T>& sc, int s, const T p[3], const T v[3]) {
  const T* m = sc.objtx + 16 * s;
  const T* pr = sc.prim + 6 * s;
  T o[3], d[3];
  for (int i = 0; i < 3; ++i) {
    o[i] = m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2] + m[4 * i + 3];
    d[i] = m[4 * i] * v[0] + m[4 * i + 1] * v[1] + m[4 * i + 2] * v[2];
  }
  Pair<T> h;
  switch (sc.leaf[5 * s]) {
    case SPHERE: h = sphere_hit(o, d, pr[0]); break;
    case PARABOLOID: h = paraboloid_hit(o, d, pr[0], pr[1]); break;
    case PLANE: h = plane_hit(o, d, pr[0], pr[1]); break;
    case CUBE: h = cube_hit(o, d, pr); break;
    default: h = cylinder_hit(o, d, pr[0], pr[1], pr[2]); break;
  }
  return sort2(h.lo, h.hi);
}

// stable Batcher network over rows [0, m) of (key, rank, payloads)
template <typename T>
__device__ void network_sort(const int* pairs, int n_pairs, int m, T* key, int* id, int* sign) {
  int rank[kMaxRows];
  for (int r = 0; r < m; ++r) rank[r] = r;
  for (int k = 0; k < n_pairs; ++k) {
    int a = pairs[2 * k], b = pairs[2 * k + 1];
    bool swap = key[b] < key[a] || (key[b] == key[a] && rank[b] < rank[a]);
    if (swap) {
      T tk = key[a]; key[a] = key[b]; key[b] = tk;
      int tr = rank[a]; rank[a] = rank[b]; rank[b] = tr;
      int ti = id[a]; id[a] = id[b]; id[b] = ti;
      if (sign) { int ts = sign[a]; sign[a] = sign[b]; sign[b] = ts; }
    }
  }
}

// combine the two children on top of the row stack (core/csg.py)
template <typename T>
__device__ void network_combine(const Scene<T>& sc, const int* in, T* key, int* id) {
  const int op = in[1], m1 = in[2], m2 = in[3], m = m1 + m2;
  const int* pairs = sc.pairs + 2 * in[4];
  const int n_pairs = in[5];
  int sign[kMaxRows], count[kMaxRows];
  for (int r = 0; r < m; ++r) {
    bool even = (r < m1 ? r : r - m1) % 2 == 0;
    bool subtracted = op == DIFFERENCE && r >= m1;
    sign[r] = (even != subtracted) ? 1 : -1;
  }
  network_sort(pairs, n_pairs, m, key, id, sign);
  int running = 0;
  for (int r = 0; r < m; ++r) {
    running += sign[r];
    count[r] = running + (op == DIFFERENCE ? 1 : 0);
  }
  bool keep[kMaxRows];
  for (int r = 0; r < m; ++r) {
    int prev = r == 0 ? m - 1 : r - 1;  // wraparound pairing
    keep[r] = op == UNION ? ((count[r] != 0) != (count[prev] != 0))
                          : (count[r] == 2 || count[prev] == 2);
  }
  for (int r = 0; r < m; ++r) {
    if (!keep[r]) key[r] = inf_v<T>();
  }
  network_sort(pairs, n_pairs, m, key, id, static_cast<int*>(nullptr));
}

// nearest positive hit over every tree of the scene program
template <typename T>
__device__ void nearest_hit(const Scene<T>& sc, const T p[3], const T v[3], T& best, int& leaf) {
  T iv_lo[kMaxIntervals], iv_hi[kMaxIntervals];
  int iv_lo_id[kMaxIntervals], iv_hi_id[kMaxIntervals];
  T row_key[kMaxRows];
  int row_id[kMaxRows];
  int n_iv = 0, top = 0;
  best = inf_v<T>();
  leaf = -1;
  auto fold = [&](T cand, int id) {
    cand = cand > T(0) ? cand : inf_v<T>();
    if (cand < best) {
      best = cand;
      leaf = id;
    }
  };
  for (int k = 0; k < sc.n_instr; ++k) {
    const int* in = sc.instr + kInstrWidth * k;
    const int s = in[1];
    switch (in[0]) {
      case IV_LOAD: {
        Pair<T> h = leaf_pair(sc, s, p, v);
        iv_lo[0] = h.lo; iv_hi[0] = h.hi; iv_lo_id[0] = s; iv_hi_id[0] = s;
        n_iv = 1;
        break;
      }
      case IV_AND: {
        Pair<T> b = leaf_pair(sc, s, p, v);
        for (int j = 0; j < n_iv; ++j) {
          T a0 = iv_lo[j], a1 = iv_hi[j];
          T lo = mx(a0, b.lo), hi = mn(a1, b.hi);
          iv_lo_id[j] = b.lo > a0 ? s : iv_lo_id[j];
          iv_hi_id[j] = b.hi < a1 ? s : iv_hi_id[j];
          bool empty = lo > hi;
          iv_lo[j] = empty ? inf_v<T>() : lo;
          iv_hi[j] = empty ? inf_v<T>() : hi;
        }
        break;
      }
      case IV_SUB: {
        Pair<T> b = leaf_pair(sc, s, p, v);
        // interval j -> pieces 2j (before b) and 2j+1 (after b); walking j
        // downwards never overwrites an interval not yet read
        for (int j = n_iv - 1; j >= 0; --j) {
          T a0 = iv_lo[j], a1 = iv_hi[j];
          int i0 = iv_lo_id[j], i1 = iv_hi_id[j];
          T p1_hi = mn(a1, b.lo);
          int p1_hi_id = b.lo < a1 ? s : i1;
          bool e1 = a0 > p1_hi;
          T p2_lo = mx(a0, b.hi);
          int p2_lo_id = b.hi > a0 ? s : i0;
          bool e2 = p2_lo > a1;
          iv_lo[2 * j] = e1 ? inf_v<T>() : a0;
          iv_hi[2 * j] = e1 ? inf_v<T>() : p1_hi;
          iv_lo_id[2 * j] = i0;
          iv_hi_id[2 * j] = p1_hi_id;
          iv_lo[2 * j + 1] = e2 ? inf_v<T>() : p2_lo;
          iv_hi[2 * j + 1] = e2 ? inf_v<T>() : a1;
          iv_lo_id[2 * j + 1] = p2_lo_id;
          iv_hi_id[2 * j + 1] = i1;
        }
        n_iv *= 2;
        break;
      }
      case IV_FOLD:
        for (int j = 0; j < n_iv; ++j) {
          fold(iv_lo[j], iv_lo_id[j]);
          fold(iv_hi[j], iv_hi_id[j]);
        }
        break;
      case NET_PUSH: {
        Pair<T> h = leaf_pair(sc, s, p, v);
        row_key[top] = h.lo; row_id[top] = s;
        row_key[top + 1] = h.hi; row_id[top + 1] = s;
        top += 2;
        break;
      }
      case NET_COMBINE: {
        int base = top - in[2] - in[3];
        network_combine(sc, in, row_key + base, row_id + base);
        break;
      }
      default:  // NET_FOLD
        for (int j = 0; j < top; ++j) fold(row_key[j], row_id[j]);
        top = 0;
        break;
    }
  }
}

// unnormalized object-space normal of leaf s at local point lp
template <typename T>
__device__ void leaf_normal_raw(int type, const T* pr, const T lp[3], T ln[3]) {
  switch (type) {
    case SPHERE:
      ln[0] = lp[0]; ln[1] = lp[1]; ln[2] = lp[2];
      break;
    case PARABOLOID: {
      bool cap = isclose(lp[2], pr[1]);
      ln[0] = cap ? T(0) : lp[0];
      ln[1] = cap ? T(0) : lp[1];
      ln[2] = cap ? T(1) : T(0) - T(2) * pr[0];
      break;
    }
    case PLANE:
      ln[0] = T(0); ln[1] = T(0); ln[2] = T(1);
      break;
    case CUBE:
      for (int a = 0; a < 3; ++a) {
        bool neg = isclose(lp[a], pr[2 * a]);
        bool pos = isclose(lp[a], pr[2 * a + 1]);
        ln[a] = pos ? T(1) : (neg ? T(-1) : T(0));
      }
      break;
    default: {  // CYLINDER
      bool capped = pr[3] != T(0);
      bool lo_cap = isclose(lp[2], pr[1]) && capped;
      bool hi_cap = isclose(lp[2], pr[2]) && capped;
      bool cap = lo_cap || hi_cap;
      ln[0] = cap ? T(0) : lp[0];
      ln[1] = cap ? T(0) : lp[1];
      ln[2] = hi_cap ? T(1) : (lo_cap ? T(-1) : T(0));
      break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_trace_kernel(
    const T* __restrict__ state, long long n, int generations,
    const T* __restrict__ objtx, const T* __restrict__ prim, const T* __restrict__ glass,
    const int* __restrict__ program, int program_len, int n_leaves, int n_glass,
    T* __restrict__ records, bool* __restrict__ masks, T* __restrict__ fstate,
    T ray_offset, T world_index, T threshold, int apply_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_objtx = reinterpret_cast<T*>(smem);
  T* s_prim = s_objtx + 16 * n_leaves;
  T* s_glass = s_prim + 6 * n_leaves;
  int* s_prog = reinterpret_cast<int*>(s_glass + 7 * n_glass);
  for (int k = threadIdx.x; k < 16 * n_leaves; k += blockDim.x) s_objtx[k] = objtx[k];
  for (int k = threadIdx.x; k < 6 * n_leaves; k += blockDim.x) s_prim[k] = prim[k];
  for (int k = threadIdx.x; k < 7 * n_glass; k += blockDim.x) s_glass[k] = glass[k];
  for (int k = threadIdx.x; k < program_len; k += blockDim.x) s_prog[k] = program[k];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Scene<T> sc;
  const int n_mats = s_prog[1];
  sc.objtx = s_objtx;
  sc.prim = s_prim;
  sc.glass = s_glass;
  sc.leaf = s_prog + 4;
  sc.kinds = sc.leaf + 5 * n_leaves;
  sc.instr = sc.kinds + n_mats;
  sc.n_instr = s_prog[2];
  sc.pairs = s_prog + s_prog[3];

  T p[3] = {state[i], state[n + i], state[2 * n + i]};
  T v[3] = {state[4 * n + i], state[5 * n + i], state[6 * n + i]};
  T gen = state[8 * n + i], inten = state[9 * n + i], wav = state[10 * n + i];
  T ridx = state[11 * n + i], rid = state[12 * n + i];

  bool alive = true;
  int g = 0;
  for (; g < generations && alive; ++g) {
    // PROPAGATE
    T best;
    int leaf;
    nearest_hit(sc, p, v, best, leaf);
    const bool no_hit = leaf < 0;
    const T t = no_hit ? T(0) : best;
    const T ph[3] = {p[0] + t * v[0], p[1] + t * v[1], p[2] + t * v[2]};

    // INTERACT
    T nd[3] = {T(0), T(0), T(0)};
    T nidx = ridx;
    T public_id = T(0);
    if (!no_hit) {
      const int* L = sc.leaf + 5 * leaf;
      const int slot = L[1];
      const int kind = sc.kinds[slot];
      public_id = static_cast<T>(L[4]);
      T nrm[3] = {T(0), T(0), T(0)};
      if (L[3]) {
        const T* m = sc.objtx + 16 * leaf;
        T lp[3], ln[3];
        for (int r = 0; r < 3; ++r) {
          lp[r] = m[4 * r] * ph[0] + m[4 * r + 1] * ph[1] + m[4 * r + 2] * ph[2] + m[4 * r + 3];
        }
        leaf_normal_raw(L[0], sc.prim + 6 * leaf, lp, ln);
        // inverse-transpose: world_c = sum_r m[r][c] * ln_r
        for (int c = 0; c < 3; ++c) {
          nrm[c] = m[c] * ln[0] + m[4 + c] * ln[1] + m[8 + c] * ln[2];
        }
        T sq = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2];
        T norm = sq == T(0) ? T(1) : sqrt(sq);
        for (int c = 0; c < 3; ++c) nrm[c] = nrm[c] / norm * static_cast<T>(L[2]);
      }
      if (kind == MIRROR) {
        T dot = v[0] * nrm[0] + v[1] * nrm[1] + v[2] * nrm[2];
        for (int c = 0; c < 3; ++c) nd[c] = v[c] - T(2) * nrm[c] * dot;
      } else if (kind == GLASS) {
        // Sellmeier index from the packed [A, b1..b3, c1..c3] row, with
        // the denominator guarded at its pole
        const T* gr = sc.glass + 7 * slot;
        T wl2 = wav * wav;
        T n2sq = gr[0];
        for (int k = 0; k < 3; ++k) {
          T den = wl2 - gr[4 + k];
          den = den == T(0) ? T(1) : den;
          n2sq = n2sq + gr[1 + k] * wl2 / den;
        }
        T n2 = sqrt(n2sq);
        // refract: enter/exit by the sign of v.n, TIR reflects
        T vs[3] = {v[0], v[1], v[2]};
        T vsq = vs[0] * vs[0] + vs[1] * vs[1] + vs[2] * vs[2];
        if (vsq != T(0)) {
          T norm = sqrt(vsq);
          for (int c = 0; c < 3; ++c) vs[c] = vs[c] / norm;
        }
        T cos_p = vs[0] * nrm[0] + vs[1] * nrm[1] + vs[2] * nrm[2];
        bool exiting = cos_p > T(0);
        T n2_local = exiting ? world_index : n2;
        T flip = exiting ? T(-1) : T(1);
        T r = ridx / n2_local;
        T cos1 = exiting ? cos_p : -cos_p;
        T radicand = T(1) - (r * r) * (T(1) - cos1 * cos1);
        T cos2 = safe_sqrt(radicand);
        for (int c = 0; c < 3; ++c) {
          T nn = flip * nrm[c];
          nd[c] = radicand > T(0) ? r * vs[c] + (r * cos1 - cos2) * nn
                                  : vs[c] + T(2) * cos1 * nn;
        }
        T osq = nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2];
        if (osq != T(0)) {
          T norm = sqrt(osq);
          for (int c = 0; c < 3; ++c) nd[c] = nd[c] / norm;
        }
        nidx = radicand > T(0) ? n2_local : ridx;
      }
      // ABSORB leaves nd = 0
    }

    // death rules (the intensity test is opt-in)
    T vsq_old = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
    bool absorbed = isclose0(sqrt(vsq_old));
    bool dead = absorbed || no_hit || (apply_threshold && inten < threshold);
    bool living = !dead;

    // RECORD: old metadata, public id, p_old, p_hit, tilt
    T tilt_norm = vsq_old == T(0) ? T(1) : sqrt(vsq_old);
    const T row[kRecordCols] = {
        gen, inten, wav, ridx, rid, public_id,
        p[0], p[1], p[2], ph[0], ph[1], ph[2],
        v[0] / tilt_norm, v[1] / tilt_norm, v[2] / tilt_norm};
    T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
#pragma unroll
    for (int c = 0; c < kRecordCols; ++c) rec[c * n] = row[c];
    masks[static_cast<long long>(g) * n + i] = living;

    // state update: push-off, generation bump
    for (int c = 0; c < 3; ++c) {
      p[c] = living ? ph[c] + ray_offset * nd[c] : ph[c];
      v[c] = nd[c];
    }
    gen = living ? gen + T(1) : gen;
    ridx = nidx;
    // a ray absorbed this generation (direction now zero) never records again
    alive = living && (nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2]) != T(0);
  }
  for (; g < generations; ++g) {
    T* rec = records + static_cast<long long>(g) * kRecordCols * n + i;
#pragma unroll
    for (int c = 0; c < kRecordCols; ++c) rec[c * n] = T(0);
    masks[static_cast<long long>(g) * n + i] = false;
  }
  const T out[13] = {p[0], p[1], p[2], T(1), v[0], v[1], v[2], T(0), gen, inten, wav, ridx, rid};
#pragma unroll
  for (int c = 0; c < 13; ++c) fstate[c * n + i] = out[c];
}

template <typename T>
int launch(const void* state, long long n, int generations, const void* objtx,
           const void* prim, const void* glass, const void* program, int program_len,
           int n_leaves, int n_glass, void* records, void* masks, void* fstate,
           double ray_offset, double world_index, double threshold, int apply_threshold,
           void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_glass < 0 || program_len < 4 ||
      generations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t smem =
      sizeof(T) * (22 * static_cast<size_t>(n_leaves) + 7 * static_cast<size_t>(n_glass)) +
      sizeof(int) * static_cast<size_t>(program_len);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  fused_trace_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(state), n, generations, static_cast<const T*>(objtx),
      static_cast<const T*>(prim), static_cast<const T*>(glass),
      static_cast<const int*>(program), program_len, n_leaves, n_glass,
      static_cast<T*>(records), static_cast<bool*>(masks), static_cast<T*>(fstate),
      static_cast<T>(ray_offset), static_cast<T>(world_index), static_cast<T>(threshold),
      apply_threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pyrayt_fused_trace_f32(const void* state, long long n, int generations, const void* objtx,
                           const void* prim, const void* glass, const void* program,
                           int program_len, int n_leaves, int n_glass, void* records,
                           void* masks, void* fstate, double ray_offset, double world_index,
                           double threshold, int apply_threshold, void* stream) {
  return launch<float>(state, n, generations, objtx, prim, glass, program, program_len,
                       n_leaves, n_glass, records, masks, fstate, ray_offset, world_index,
                       threshold, apply_threshold, stream);
}

int pyrayt_fused_trace_f64(const void* state, long long n, int generations, const void* objtx,
                           const void* prim, const void* glass, const void* program,
                           int program_len, int n_leaves, int n_glass, void* records,
                           void* masks, void* fstate, double ray_offset, double world_index,
                           double threshold, int apply_threshold, void* stream) {
  return launch<double>(state, n, generations, objtx, prim, glass, program, program_len,
                        n_leaves, n_glass, records, masks, fstate, ray_offset, world_index,
                        threshold, apply_threshold, stream);
}

const char* pyrayt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
