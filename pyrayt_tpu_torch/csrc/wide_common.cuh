// Device code shared by the wide forward kernel (wide_trace.cu, K2) and the
// wide backward kernels (wide_grad.cu K5-K7, wide_fused_grad.cu K8): the
// wide scene program's views, its shared-memory copy, the per-ray cull
// tests and the wide nearest-hit fold.
//
// The wide program (ops/fused_trace.py:wide_program) is the narrow scene
// program's instruction stream in wide fold order, where a GROUP
// instruction folds one group of same-shape interval trees, plus the
// tables the fold needs.  A block copies everything but the per-leaf table
// into shared memory, together with the object transforms and params of
// the single (ungrouped) trees' leaves, at most 32, renumbered compactly.
// The groups' leaf tables (transforms, params, the sorted slot vector and
// the per-leaf table) and the cull table stay in global memory and are read
// through the read-only path (__ldg): 513 leaves x 22 values is 45 KB at
// float32 and 90 KB at float64, too much to copy per block, and a warp
// reads one cull box at a time, a broadcast from L1.
//
// The fold culls in two levels (ops/fused_trace.py:wide_cull_tables): per
// group a ray tests each chunk's box, then inside a chunk it enters each
// tree's box, and evaluates only the trees whose box it enters.  A tree's
// box folds its interval opcodes (the intersection of its loaded and
// intersected leaves' boxes), so a lenslet's box is its 1 x 1 x 0.25 mm
// aperture, not the 4 mm box of its sphere: on the 16x16 microlens array a
// ray evaluates about one tree per generation where the union boxes of the
// TPU's chunk scan let it evaluate 61.  The boxes are tested as cones: box
// grown by the group's slope times t, which bounds how far the
// intersectors' near-parallel conventions and their rounding let a leaf's
// interval stray from its box, with reciprocal directions computed once per
// ray and group.

#pragma once

#include "trace_common.cuh"

namespace pyrayt {

constexpr int kMaxGroupLeaves = 8;  // = MAX_GROUP_LEAVES in ops/fused_trace.py
constexpr int kChunkTrees = 16;     // = WIDE_CHUNK_TREES
constexpr int kMaxSingleLeaves = 32;
constexpr int kWideHeader = 11;
constexpr int kGroupWidth = 8 + 3 * kMaxGroupLeaves;

// header fields of the wide program
enum WideField {
  W_LEAVES = 0, W_MATS, W_INSTR, W_PAIRS, W_SINGLE_LEAVES, W_GROUPS, W_GROUPS_OFF,
  W_SINGLES_OFF, W_LEAF_OFF, W_SINGLE_TREES, W_TREES_OFF
};

// one group row: T trees of L leaves; leaf j of sorted tree t is slot
// slots[slot_off + t L + j]; n_chunks chunks of 16 sorted trees (0:
// unchunked); tree t's win code is code_base + t; the group's rows of the
// cull table start at cull_off: its slope, its n_chunks chunk boxes, its T
// tree boxes; per leaf position the interval opcode, the needs-normal OR
// over the members, the primitive type
struct Group {
  int n_trees, n_leaves, slot_off, chunk_off, n_chunks, code_base, cull_off;
  const int* op;
  const int* needs;
  const int* type;
};

__device__ __forceinline__ Group group_at(const int* prog, int g) {
  const int* r = prog + prog[W_GROUPS_OFF] + kGroupWidth * g;
  return {r[0], r[1], r[2], r[3], r[4], r[5], r[6], r + 8, r + 8 + kMaxGroupLeaves,
          r + 8 + 2 * kMaxGroupLeaves};
}

template <typename T>
struct WideScene {
  Scene<T> singles;       // compact tables of the single trees' leaves (shared)
  const int* prog;        // the program up to its per-leaf table (shared)
  const int* leaf;        // (S, 5) per-leaf table: type, mat slot, scale, needs, id
  const T* objtx;         // (S, 16) object transforms
  const T* prim;          // (S, 6)
  const int* slots;       // the sorted flat slot vector (global)
  const T* cull;          // (rows, 6) cull table (global)
};

// shared-memory bytes of load_wide_scene
template <typename T>
size_t wide_smem_bytes(int prefix_len, int n_single_leaves, int n_glass) {
  return sizeof(T) * (22 * static_cast<size_t>(n_single_leaves) + 7 * static_cast<size_t>(n_glass)) +
         sizeof(int) * (5 * static_cast<size_t>(n_single_leaves) + static_cast<size_t>(prefix_len));
}

// Copy the program prefix, the single leaves' compact tables and the glass
// rows into the block's shared memory; every thread of the block calls it.
// No pointer of the wide kernels is __restrict__: the intersectors read a
// leaf's tables through one pointer that may point into shared memory (a
// single) or global memory (a group).  Built at -O3 with __restrict__ kernel
// parameters (nvcc 12.9, sm_90a), K2 faults with an illegal address on the
// card, where a -G build runs; PERF.md (PR 3) records what its machine code
// shows.
template <typename T>
__device__ WideScene<T> load_wide_scene(unsigned char* smem, const int* program,
                                        int prefix_len, int ns, const T* objtx,
                                        const T* prim, const T* glass,
                                        int n_glass, const int* slots, const T* cull) {
  T* s_objtx = reinterpret_cast<T*>(smem);
  T* s_prim = s_objtx + 16 * ns;
  T* s_glass = s_prim + 6 * ns;
  int* s_leaf = reinterpret_cast<int*>(s_glass + 7 * n_glass);
  int* s_prog = s_leaf + 5 * ns;
  const int* singles = program + program[W_SINGLES_OFF];  // [global slot, type] per leaf
  const int* leaf_table = program + program[W_LEAF_OFF];
  for (int k = threadIdx.x; k < prefix_len; k += blockDim.x) s_prog[k] = program[k];
  for (int k = threadIdx.x; k < 16 * ns; k += blockDim.x) {
    s_objtx[k] = objtx[16 * singles[2 * (k / 16)] + k % 16];
  }
  for (int k = threadIdx.x; k < 6 * ns; k += blockDim.x) {
    s_prim[k] = prim[6 * singles[2 * (k / 6)] + k % 6];
  }
  for (int k = threadIdx.x; k < 5 * ns; k += blockDim.x) {
    s_leaf[k] = leaf_table[5 * singles[2 * (k / 5)] + k % 5];
  }
  for (int k = threadIdx.x; k < 7 * n_glass; k += blockDim.x) s_glass[k] = glass[k];
  __syncthreads();
  WideScene<T> ws;
  ws.singles.objtx = s_objtx;
  ws.singles.prim = s_prim;
  ws.singles.glass = s_glass;
  ws.singles.leaf = s_leaf;
  ws.singles.kinds = s_prog + kWideHeader;
  ws.singles.instr = ws.singles.kinds + s_prog[W_MATS];
  ws.singles.pairs = s_prog + s_prog[W_PAIRS];
  ws.singles.n_instr = s_prog[W_INSTR];
  ws.prog = s_prog;
  ws.leaf = leaf_table;
  ws.objtx = objtx;
  ws.prim = prim;
  ws.slots = slots;
  ws.cull = cull;
  return ws;
}

// global slot of single leaf c (compact index)
template <typename T>
__device__ __forceinline__ int single_slot(const WideScene<T>& ws, int c) {
  return ws.prog[ws.prog[W_SINGLES_OFF] + 2 * c];
}

// value k of the cull table
template <typename T>
__device__ __forceinline__ T cull_at(const WideScene<T>& ws, int k) {
  return __ldg(ws.cull + k);
}

// A ray's view of one group's cull boxes.  Each box (padded by 64 ulps of
// its coordinates on the host, as the JAX kernel's _block_any_hit pads) is
// tested as the cone lo - s t <= p + t v <= hi + s t for t > 0, s the
// group's slope: per axis t (v + s) >= lo - p and t (v - s) <= hi - p.  The
// reciprocals r1 = 1 / (v + s), r2 = 1 / (v - s) are taken once per ray
// and group, so a box test multiplies.  Axis class: 0 when v > s (the
// first bound is the entry, the second the exit), 1 when v < -s (the
// reverse), 2 when |v| <= s (both are entries).  A zero v + s or v - s
// gets the infinity of its class, so (lo - p) r is +-inf by the side the
// origin lies on, or NaN where it lies on the face, which mn/mx drop: a ray
// parallel to a slab is inside it or misses (ops/fused_trace.py:_box_hit).
template <typename T>
struct RayCull {
  T p[3], r1[3], r2[3];
  int cls[3];
};

template <typename T>
__device__ __forceinline__ void ray_cull(const WideScene<T>& ws, const Group& G, const T p[3],
                                         const T v[3], RayCull<T>& rc) {
  for (int a = 0; a < 3; ++a) {
    const T s = cull_at(ws, 6 * G.cull_off + a);
    const T u1 = v[a] + s, u2 = v[a] - s;
    rc.p[a] = p[a];
    rc.r1[a] = u1 == T(0) ? inf_v<T>() : T(1) / u1;
    rc.r2[a] = u2 == T(0) ? -inf_v<T>() : T(1) / u2;
    rc.cls[a] = u2 > T(0) ? 0 : (u1 < T(0) ? 1 : 2);
  }
}

// Does the ray enter box row `row` of the cull table at some t > 0 no later
// than `best`?  A box it enters after best holds no winner: the fold keeps
// strict <, and every candidate of the box's trees lies inside it.
template <typename T>
__device__ __forceinline__ bool cull_hit(const WideScene<T>& ws, int row, const RayCull<T>& rc,
                                         T best) {
  T tmin = -inf_v<T>(), tmax = inf_v<T>();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T x = (cull_at(ws, 6 * row + a) - rc.p[a]) * rc.r1[a];
    const T y = (cull_at(ws, 6 * row + 3 + a) - rc.p[a]) * rc.r2[a];
    const int c = rc.cls[a];
    tmin = mx(tmin, c == 1 ? y : x);
    if (c == 2) {
      tmin = mx(tmin, y);
    } else {
      tmax = mn(tmax, c == 0 ? y : x);
    }
  }
  return tmin <= tmax && tmax > T(0) && tmin < inf_v<T>() && !(tmin > best);
}

// sorted (entry, exit) pair of group leaf slot s (type `type`), its tables
// read through the read-only path
template <typename T>
__device__ __forceinline__ Pair<T> group_leaf_pair(const WideScene<T>& ws, int type, int s,
                                                   const T p[3], const T v[3]) {
  T m[12], pr[6];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(ws.objtx + 16 * s + k);
#pragma unroll
  for (int k = 0; k < 6; ++k) pr[k] = __ldg(ws.prim + 6 * s + k);
  return leaf_pair_at(type, m, pr, p, v);
}

// the intervals of sorted tree t of group G for the ray (p, v); ts[j] is
// its leaf j's global slot, interval ids are leaf positions
template <typename T>
__device__ __forceinline__ void group_tree(const WideScene<T>& ws, const Group& G, int t,
                                           const T p[3], const T v[3], int ts[kMaxGroupLeaves],
                                           Intervals<T>& iv) {
  iv.n = 0;
  for (int j = 0; j < G.n_leaves; ++j) {
    const int s = __ldg(ws.slots + G.slot_off + t * G.n_leaves + j);
    ts[j] = s;
    iv_apply(iv, G.op[j], group_leaf_pair(ws, G.type[j], s, p, v), j);
  }
}

// the nearest positive candidate of interval list iv: distance and
// position (-1: none), strict < in fold order
template <typename T>
__device__ __forceinline__ T nearest_of(const Intervals<T>& iv, int& pos) {
  T best = inf_v<T>();
  pos = -1;
  for (int j = 0; j < iv.n; ++j) {
    const T c0 = iv.lo[j] > T(0) ? iv.lo[j] : inf_v<T>();
    if (c0 < best) { best = c0; pos = iv.lo_id[j]; }
    const T c1 = iv.hi[j] > T(0) ? iv.hi[j] : inf_v<T>();
    if (c1 < best) { best = c1; pos = iv.hi_id[j]; }
  }
  return best;
}

// the winner of the wide fold
template <typename T>
struct WideHit {
  T best;     // nearest positive distance (inf: no hit)
  int win;    // win code of the winning tree (-1: none)
  int leaf;   // global slot of the winning leaf (-1: none)
  int group;  // the winner's group (-1: a single tree)
  int pos;    // the winning leaf's position in its group tree
};

// Wide nearest hit: singles fold in program order, each group's sorted
// trees in ascending order, a ray skipping a chunk whose box it does not
// enter before its best hit so far, and inside a chunk each tree whose box
// it does not enter before it; strict < throughout, so the first of equal
// candidates wins (a group tree's ties go to the lower sorted index, as in
// the JAX kernel).  A skipped tree has no positive candidate at or before
// the best, so the winner and its win code are those of the unculled fold.
template <typename T>
__device__ void wide_nearest(const WideScene<T>& ws, const T p[3], const T v[3], WideHit<T>& h) {
  h.best = inf_v<T>();
  h.win = h.leaf = h.group = h.pos = -1;
  run_program(
      ws.singles, p, v, 0, ws.singles.n_instr,
      [&](T cand, int id, int code) {
        cand = cand > T(0) ? cand : inf_v<T>();
        if (cand < h.best) {
          h.best = cand;
          h.win = code;
          h.leaf = single_slot(ws, id);
          h.group = -1;
        }
      },
      [&](const int* in) {
        const int g = in[1];
        const Group G = group_at(ws.prog, g);
        RayCull<T> rc;
        ray_cull(ws, G, p, v, rc);
        const int tree_row = G.cull_off + 1 + G.n_chunks;
        // the boxes of up to 32 chunks, then of a chunk's trees, are tested
        // into a bit mask before any tree is evaluated (independent tests,
        // which the compiler overlaps); the set bits run in ascending order
        for (int c0 = 0; c0 < max(G.n_chunks, 1); c0 += 32) {
          unsigned chunks = 1u;
          if (G.n_chunks > 0) {
            chunks = 0u;
            const int cn = min(32, G.n_chunks - c0);
            for (int k = 0; k < cn; ++k) {
              chunks |= static_cast<unsigned>(cull_hit(ws, G.cull_off + 1 + c0 + k, rc, h.best)) << k;
            }
          }
          while (chunks != 0u) {
            const int c = c0 + __ffs(static_cast<int>(chunks)) - 1;
            chunks &= chunks - 1u;
            const int t0 = G.n_chunks > 0 ? c * kChunkTrees : 0;
            const int t1 = G.n_chunks > 0 ? min(t0 + kChunkTrees, G.n_trees) : G.n_trees;
            for (int b0 = t0; b0 < t1; b0 += 32) {
              unsigned trees = 0u;
              const int bn = min(32, t1 - b0);
#pragma unroll 16
              for (int k = 0; k < bn; ++k) {
                trees |= static_cast<unsigned>(cull_hit(ws, tree_row + b0 + k, rc, h.best)) << k;
              }
              while (trees != 0u) {
                const int t = b0 + __ffs(static_cast<int>(trees)) - 1;
                trees &= trees - 1u;
                Intervals<T> iv;
                int ts[kMaxGroupLeaves];
                group_tree(ws, G, t, p, v, ts, iv);
                int pos;
                const T d = nearest_of(iv, pos);
                if (d < h.best) {
                  h.best = d;
                  h.win = G.code_base + t;
                  h.leaf = __ldg(ws.slots + G.slot_off + t * G.n_leaves + pos);
                  h.group = g;
                  h.pos = pos;
                }
              }
            }
          }
        }
      });
}

}  // namespace pyrayt
