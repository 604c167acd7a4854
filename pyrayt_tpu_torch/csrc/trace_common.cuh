// Device code shared by the forward kernels (fused_trace.cu K1, wide_trace.cu
// K2) and the backward kernels (fused_grad.cu K3/K4, wide_grad.cu K5-K7,
// wide_fused_grad.cu K8): the scene program and its interpreter, the five
// primitive intersectors, interval and comparator-network CSG, the nearest
// positive hit, the world normal, and the material step with its death
// rules and record.  Every
// kernel runs exactly this code, so a backward's forward recompute finds the
// same hit as the forward did.
//
// Every intersector endpoint carries a "hit code" naming the formula that
// produced it (a quadratic root, the linear root, a slab bound, the plane,
// a cube face).  The forward kernel ignores the codes (they are dead code
// there once inlined); the backward differentiates the formula the code
// names (adjoint_common.cuh: endpoint_grad).  min/max keep the code of the value
// they return, with the same tie rule as the value.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pyrayt {

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
// hit codes: which formula an endpoint came from (CUBE_FACE + 2 * axis +
// side for a cube face, side 0 = the axis minimum)
enum HitCode {
  C_NONE = -1,
  C_PLUS = 0,    // (-b + sqrt(disc)) / 2a
  C_MINUS,       // (-b - sqrt(disc)) / 2a
  C_LINEAR,      // -c / b
  C_SLAB_LO,     // (z_lo - o_z) / d_z
  C_SLAB_HI,     // (z_hi - o_z) / d_z
  C_PLANE,       // -o_z / d_z
  C_CUBE_FACE,   // (bound - o_a) / d_a
};

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
  int clo, chi;  // hit codes of lo and hi
};

template <typename T>
__device__ __forceinline__ Pair<T> sort2(T a, int ca, T b, int cb) {
  return {mn(a, b), mx(a, b), b < a ? cb : ca, b > a ? cb : ca};
}

// clip a sorted interval against another; (inf, inf) when disjoint
template <typename T>
__device__ __forceinline__ Pair<T> slab_clip(Pair<T> h, Pair<T> s) {
  T entry = mx(h.lo, s.lo);
  T exit_ = mn(h.hi, s.hi);
  if (entry <= exit_) return {entry, exit_, s.lo > h.lo ? s.clo : h.clo, s.hi < h.hi ? s.chi : h.chi};
  return {inf_v<T>(), inf_v<T>(), C_NONE, C_NONE};
}

// entry/exit parameters of the z in [z_lo, z_hi] slab
template <typename T>
__device__ __forceinline__ Pair<T> slab(T oz, T dz, T z_lo, T z_hi) {
  bool parallel = isclose0(dz);
  bool inside = oz >= z_lo && oz <= z_hi;
  T den = dz + (parallel ? T(1) : T(0));
  Pair<T> s = sort2((z_lo - oz) / den, C_SLAB_LO, (z_hi - oz) / den, C_SLAB_HI);
  if (parallel) return {inside ? -inf_v<T>() : inf_v<T>(), inf_v<T>(), C_NONE, C_NONE};
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
  if (!(disc >= T(0)) || degenerate) return {inf_v<T>(), inf_v<T>(), C_NONE, C_NONE};
  T den = T(2) * a;
  return {(-b + root) / den, (-b - root) / den, C_PLUS, C_MINUS};
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
  int c0, c1;
  if (linear) {
    // one real hit plus a signed infinity by travel direction
    h0 = -c / (b + (isclose0(b) ? T(1) : T(0)));
    h1 = d[2] >= T(0) ? inf_v<T>() : -inf_v<T>();
    c0 = C_LINEAR;
    c1 = C_NONE;
  } else if (disc >= T(0)) {
    T den = T(2) * a;
    h0 = (-b + root) / den;
    h1 = (-b - root) / den;
    c0 = C_PLUS;
    c1 = C_MINUS;
  } else {
    h0 = h1 = inf_v<T>();
    c0 = c1 = C_NONE;
  }
  return slab_clip(sort2(h0, c0, h1, c1), slab(o[2], d[2], T(0), height));
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
    Pair<T> p = sort2(is_zero ? skew : hit1, C_NONE, is_zero ? inf_v<T>() : hit2, C_NONE);
    lo[axis] = p.lo;
    hi[axis] = p.hi;
  }
  T max_of_min = mx(lo[0], lo[1]);
  T min_of_max = mn(hi[0], hi[1]);
  bool skew_ray = isclose0(d[2]);
  T t = skew_ray ? inf_v<T>() : -o[2] / d[2];
  if (!(t >= max_of_min && t <= min_of_max)) t = inf_v<T>();
  // duplicated: a zero-volume solid has an even hit count
  return {t, t, C_PLANE, C_PLANE};
}

template <typename T>
__device__ Pair<T> cube_hit(const T o[3], const T d[3], const T* pr) {
  T entry = -inf_v<T>(), exit_ = inf_v<T>();
  int c_entry = C_NONE, c_exit = C_NONE;
  for (int axis = 0; axis < 3; ++axis) {
    T lo = pr[2 * axis], hi = pr[2 * axis + 1];
    bool is_zero = isclose0(d[axis]);
    bool inside = o[axis] >= lo && o[axis] <= hi;
    T den = d[axis] + (is_zero ? T(1) : T(0));
    T skew_min = inside ? -inf_v<T>() : inf_v<T>();
    T hit_lo = -(o[axis] - lo) / den;
    T hit_hi = -(o[axis] - hi) / den;
    Pair<T> p = sort2(is_zero ? skew_min : hit_lo, is_zero ? C_NONE : C_CUBE_FACE + 2 * axis,
                      is_zero ? inf_v<T>() : hit_hi, is_zero ? C_NONE : C_CUBE_FACE + 2 * axis + 1);
    if (axis == 0) {
      entry = p.lo;
      exit_ = p.hi;
      c_entry = p.clo;
      c_exit = p.chi;
    } else {
      c_entry = p.lo > entry ? p.clo : c_entry;
      c_exit = p.hi < exit_ ? p.chi : c_exit;
      entry = mx(entry, p.lo);
      exit_ = mn(exit_, p.hi);
    }
  }
  // strict <: a corner graze is a miss
  if (entry < exit_) return {entry, exit_, c_entry, c_exit};
  return {inf_v<T>(), inf_v<T>(), C_NONE, C_NONE};
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
  int c0 = C_NONE, c1 = C_NONE;
  if (linear) {
    if (isclose0(b)) {
      r0 = c <= T(0) ? -inf_v<T>() : inf_v<T>();  // always / never inside
      r1 = inf_v<T>();
    } else {
      r0 = r1 = -c / b;
      c0 = c1 = C_LINEAR;
    }
  } else if (disc >= T(0)) {
    T den = T(2) * a;
    r0 = (-b + root) / den;
    r1 = (-b - root) / den;
    c0 = C_PLUS;
    c1 = C_MINUS;
  } else {
    r0 = r1 = inf_v<T>();
  }
  return slab_clip(sort2(r0, c0, r1, c1), slab(o[2], d[2], h_min, h_max));
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

// the scene program's views over a block's shared copy of it
template <typename T>
__device__ __forceinline__ Scene<T> make_scene(const T* objtx, const T* prim, const T* glass,
                                               const int* prog, int n_leaves) {
  Scene<T> sc;
  const int n_mats = prog[1];
  sc.objtx = objtx;
  sc.prim = prim;
  sc.glass = glass;
  sc.leaf = prog + 4;
  sc.kinds = sc.leaf + 5 * n_leaves;
  sc.instr = sc.kinds + n_mats;
  sc.n_instr = prog[2];
  sc.pairs = prog + prog[3];
  return sc;
}

// object-space ray (o, d) of leaf s for the world ray (p, v)
template <typename T>
__device__ __forceinline__ void local_ray(const T* m, const T p[3], const T v[3], T o[3], T d[3]) {
  for (int i = 0; i < 3; ++i) {
    o[i] = m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2] + m[4 * i + 3];
    d[i] = m[4 * i] * v[0] + m[4 * i + 1] * v[1] + m[4 * i + 2] * v[2];
  }
}

// sorted (entry, exit) pair of a leaf of type `type` with object transform
// `m` (16, row-major) and params `pr` for the world ray (p, v)
template <typename T>
__device__ Pair<T> leaf_pair_at(int type, const T* m, const T* pr, const T p[3], const T v[3]) {
  T o[3], d[3];
  local_ray(m, p, v, o, d);
  Pair<T> h;
  switch (type) {
    case SPHERE: h = sphere_hit(o, d, pr[0]); break;
    case PARABOLOID: h = paraboloid_hit(o, d, pr[0], pr[1]); break;
    case PLANE: h = plane_hit(o, d, pr[0], pr[1]); break;
    case CUBE: h = cube_hit(o, d, pr); break;
    default: h = cylinder_hit(o, d, pr[0], pr[1], pr[2]); break;
  }
  return sort2(h.lo, h.clo, h.hi, h.chi);
}

// sorted (entry, exit) pair of leaf s of the scene for the world ray (p, v)
template <typename T>
__device__ __forceinline__ Pair<T> leaf_pair(const Scene<T>& sc, int s, const T p[3], const T v[3]) {
  return leaf_pair_at(sc.leaf[5 * s], sc.objtx + 16 * s, sc.prim + 6 * s, p, v);
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

// the interval list of a left-deep interval tree (core/intervals.py): each
// interval carries the leaf ids of its two endpoints
template <typename T>
struct Intervals {
  T lo[kMaxIntervals], hi[kMaxIntervals];
  int lo_id[kMaxIntervals], hi_id[kMaxIntervals];
  int n;
};

// apply one interval opcode (IV_LOAD, IV_AND, IV_SUB) with the leaf pair b
// of leaf id s
template <typename T>
__device__ __forceinline__ void iv_apply(Intervals<T>& iv, int op, Pair<T> b, int s) {
  if (op == IV_LOAD) {
    iv.lo[0] = b.lo; iv.hi[0] = b.hi; iv.lo_id[0] = s; iv.hi_id[0] = s;
    iv.n = 1;
  } else if (op == IV_AND) {
    for (int j = 0; j < iv.n; ++j) {
      T a0 = iv.lo[j], a1 = iv.hi[j];
      T lo = mx(a0, b.lo), hi = mn(a1, b.hi);
      iv.lo_id[j] = b.lo > a0 ? s : iv.lo_id[j];
      iv.hi_id[j] = b.hi < a1 ? s : iv.hi_id[j];
      bool empty = lo > hi;
      iv.lo[j] = empty ? inf_v<T>() : lo;
      iv.hi[j] = empty ? inf_v<T>() : hi;
    }
  } else {  // IV_SUB
    // interval j -> pieces 2j (before b) and 2j+1 (after b); walking j
    // downwards never overwrites an interval not yet read
    for (int j = iv.n - 1; j >= 0; --j) {
      T a0 = iv.lo[j], a1 = iv.hi[j];
      int i0 = iv.lo_id[j], i1 = iv.hi_id[j];
      T p1_hi = mn(a1, b.lo);
      int p1_hi_id = b.lo < a1 ? s : i1;
      bool e1 = a0 > p1_hi;
      T p2_lo = mx(a0, b.hi);
      int p2_lo_id = b.hi > a0 ? s : i0;
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

// Interpret instructions [k0, k1) of the scene program for the world ray
// (p, v): every candidate hit goes to fold(distance, leaf id, code) in fold
// order (lo then hi per interval, or the network's rows), where `code` is
// the IV_FOLD / NET_FOLD instruction's operand (a wide scene's win code, 0
// in a narrow program); an opcode past NET_FOLD (a wide group) goes to
// group(instruction).
template <typename T, typename Fold, typename Group>
__device__ __forceinline__ void run_program(const Scene<T>& sc, const T p[3], const T v[3],
                                            int k0, int k1, Fold fold, Group group) {
  Intervals<T> iv;
  iv.n = 0;
  T row_key[kMaxRows];
  int row_id[kMaxRows];
  int top = 0;
  for (int k = k0; k < k1; ++k) {
    const int* in = sc.instr + kInstrWidth * k;
    const int s = in[1];
    switch (in[0]) {
      case IV_LOAD:
      case IV_AND:
      case IV_SUB:
        iv_apply(iv, in[0], leaf_pair(sc, s, p, v), s);
        break;
      case IV_FOLD:
        for (int j = 0; j < iv.n; ++j) {
          fold(iv.lo[j], iv.lo_id[j], s);
          fold(iv.hi[j], iv.hi_id[j], s);
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
      case NET_FOLD:
        for (int j = 0; j < top; ++j) fold(row_key[j], row_id[j], s);
        top = 0;
        break;
      default:
        group(in);
        break;
    }
  }
}

// nearest positive hit over every tree of a narrow scene program (strict <:
// the first of equal candidates wins)
template <typename T>
__device__ void nearest_hit(const Scene<T>& sc, const T p[3], const T v[3], T& best, int& leaf) {
  best = inf_v<T>();
  leaf = -1;
  run_program(
      sc, p, v, 0, sc.n_instr,
      [&](T cand, int id, int) {
        cand = cand > T(0) ? cand : inf_v<T>();
        if (cand < best) {
          best = cand;
          leaf = id;
        }
      },
      [](const int*) {});
}

// unnormalized object-space normal of a leaf of type `type` at local point lp
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

// Sellmeier index from a packed [A, b1..b3, c1..c3] row, the denominator
// guarded at its pole (wl^2 == c)
template <typename T>
__device__ __forceinline__ T sellmeier(const T* gr, T wav) {
  T wl2 = wav * wav;
  T n2sq = gr[0];
  for (int k = 0; k < 3; ++k) {
    T den = wl2 - gr[4 + k];
    den = den == T(0) ? T(1) : den;
    n2sq = n2sq + gr[1 + k] * wl2 / den;
  }
  return sqrt(n2sq);
}

// world normal at local point lp of a leaf of type `type` with object
// transform m: the raw object-space normal, the inverse-transpose
// (world_c = sum_r m[r][c] ln_r), normalized with a zero-length guard, times
// the leaf's normal scale
template <typename T>
__device__ __forceinline__ void world_normal(int type, const T* m, const T* pr, const T lp[3],
                                             T scale, T nrm[3]) {
  T ln[3];
  leaf_normal_raw(type, pr, lp, ln);
  for (int c = 0; c < 3; ++c) nrm[c] = m[c] * ln[0] + m[4 + c] * ln[1] + m[8 + c] * ln[2];
  T sq = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2];
  T norm = sq == T(0) ? T(1) : sqrt(sq);
  for (int c = 0; c < 3; ++c) nrm[c] = nrm[c] / norm * scale;
}

// INTERACT for a ray that hit a surface of material kind `kind` (glass row
// `gr`) with world normal nrm: the new direction nd (zero for the absorber)
// and the new index nidx
template <typename T>
__device__ __forceinline__ void apply_material(int kind, const T* gr, const T v[3], const T nrm[3],
                                               T ridx, T wav, T world_index, T nd[3], T& nidx) {
  nd[0] = nd[1] = nd[2] = T(0);
  nidx = ridx;
  if (kind == MIRROR) {
    T dot = v[0] * nrm[0] + v[1] * nrm[1] + v[2] * nrm[2];
    for (int c = 0; c < 3; ++c) nd[c] = v[c] - T(2) * nrm[c] * dot;
  } else if (kind == GLASS) {
    // Sellmeier index, the denominator guarded at its pole
    T n2 = sellmeier(gr, wav);
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
      nd[c] = radicand > T(0) ? r * vs[c] + (r * cos1 - cos2) * nn : vs[c] + T(2) * cos1 * nn;
    }
    T osq = nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2];
    if (osq != T(0)) {
      T norm = sqrt(osq);
      for (int c = 0; c < 3; ++c) nd[c] = nd[c] / norm;
    }
    nidx = radicand > T(0) ? n2_local : ridx;
  }
}

// one ray's state between generations (homogeneous w rows implied)
template <typename T>
struct RayState {
  T p[3], v[3], gen, inten, wav, ridx, rid;
};

// The step after the nearest hit: INTERACT (slot < 0: no hit; kind and
// glass row of material slot `slot`), the death rules, the record row and
// the state update with the push-off.  `t` is the hit distance (0 on no
// hit), `public_id` the hit surface's id (0 on no hit).  Returns whether
// the ray lives (the record's mask); `alive` is whether it runs the next
// generation (it lives and its new direction is nonzero).
template <typename T>
__device__ __forceinline__ bool step_tail(const int* kinds, const T* glass, T ray_offset,
                                          T world_index, T threshold, int apply_threshold, T t,
                                          int slot, T public_id, const T nrm[3], RayState<T>& x,
                                          T row[kRecordCols], bool& alive) {
  const bool no_hit = slot < 0;
  const T ph[3] = {x.p[0] + t * x.v[0], x.p[1] + t * x.v[1], x.p[2] + t * x.v[2]};
  T nd[3] = {T(0), T(0), T(0)};
  T nidx = x.ridx;
  if (!no_hit) apply_material(kinds[slot], glass + 7 * slot, x.v, nrm, x.ridx, x.wav, world_index,
                              nd, nidx);

  // death rules (the intensity test is opt-in)
  T vsq_old = x.v[0] * x.v[0] + x.v[1] * x.v[1] + x.v[2] * x.v[2];
  bool absorbed = isclose0(sqrt(vsq_old));
  bool dead = absorbed || no_hit || (apply_threshold && x.inten < threshold);
  bool living = !dead;

  // RECORD: old metadata, public id, p_old, p_hit, tilt
  T tilt_norm = vsq_old == T(0) ? T(1) : sqrt(vsq_old);
  const T r[kRecordCols] = {
      x.gen, x.inten, x.wav, x.ridx, x.rid, public_id,
      x.p[0], x.p[1], x.p[2], ph[0], ph[1], ph[2],
      x.v[0] / tilt_norm, x.v[1] / tilt_norm, x.v[2] / tilt_norm};
  for (int c = 0; c < kRecordCols; ++c) row[c] = r[c];

  // state update: push-off, generation bump
  for (int c = 0; c < 3; ++c) {
    x.p[c] = living ? ph[c] + ray_offset * nd[c] : ph[c];
    x.v[c] = nd[c];
  }
  x.gen = living ? x.gen + T(1) : x.gen;
  x.ridx = nidx;
  // a ray absorbed this generation (direction now zero) never records again
  alive = living && (nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2]) != T(0);
  return living;
}

}  // namespace pyrayt
