// Device code shared by the wide forward kernel (wide_trace.cu, K2) and the
// wide backward kernels (wide_grad.cu K5-K7, wide_fused_grad.cu K8): the
// wide scene program's views, its shared-memory copy, the per-ray chunk-box
// test and the wide nearest-hit fold.
//
// The wide program (ops/fused_trace.py:wide_program) is the narrow scene
// program's instruction stream in wide fold order, where a GROUP
// instruction folds one group of same-shape interval trees, plus the
// tables the fold needs.  A block copies everything but the per-leaf table
// into shared memory, together with the object transforms and params of
// the single (ungrouped) trees' leaves, at most 32, renumbered compactly.
// The groups' tables (transforms, params, the sorted slot vector, the chunk
// boxes and the per-leaf table) stay in global memory and are read through
// the read-only path: 513 leaves x 22 values is 45 KB at float32 and 90 KB
// at float64, too much to copy per block.

#pragma once

#include <float.h>

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
// slots[slot_off + t L + j]; chunk boxes aabb[chunk_off .. + n_chunks) (0:
// unchunked); tree t's win code is code_base + t; per leaf position the
// interval opcode, the needs-normal OR over the members, the primitive type
struct Group {
  int n_trees, n_leaves, slot_off, chunk_off, n_chunks, code_base;
  const int* op;
  const int* needs;
  const int* type;
};

__device__ __forceinline__ Group group_at(const int* prog, int g) {
  const int* r = prog + prog[W_GROUPS_OFF] + kGroupWidth * g;
  return {r[0], r[1], r[2], r[3], r[4], r[5], r + 8, r + 8 + kMaxGroupLeaves,
          r + 8 + 2 * kMaxGroupLeaves};
}

template <typename T>
struct WideScene {
  Scene<T> singles;       // compact tables of the single trees' leaves (shared)
  const int* prog;        // the program up to its per-leaf table (shared)
  const int* leaf;        // (S, 5) per-leaf table: type, mat slot, scale, needs, id
  const T* objtx;         // (S, 16) object transforms
  const T* prim;          // (S, 6)
  const int* slots;       // the sorted flat slot vector
  const T* aabb;          // (chunks, 6) chunk boxes
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
                                        int n_glass, const int* slots,
                                        const T* aabb) {
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
  ws.aabb = aabb;
  return ws;
}

// global slot of single leaf c (compact index)
template <typename T>
__device__ __forceinline__ int single_slot(const WideScene<T>& ws, int c) {
  return ws.prog[ws.prog[W_SINGLES_OFF] + 2 * c];
}

// Does the ray (p, v) meet the box [lo_xyz, hi_xyz] at a positive t?  The
// per-ray counterpart of the JAX kernel's per-block _block_any_hit, with its
// zero-direction conventions (a ray parallel to a slab is inside it or
// misses).  The box grows by 64 ulps of its coordinates so rounding here
// never rejects a real hit at the rim: the growth changes only what is
// skipped, never a candidate (ops/fused_trace.py:_box_hit is the same test).
template <typename T>
__device__ __forceinline__ bool box_hit(const T* box, const T p[3], const T v[3]) {
  const T eps = sizeof(T) == 4 ? T(FLT_EPSILON) : T(DBL_EPSILON);
  T tmin = -inf_v<T>(), tmax = inf_v<T>();
  for (int a = 0; a < 3; ++a) {
    const T pad = T(64) * eps * (T(1) + fabs(box[a]) + fabs(box[3 + a]));
    const T lo = box[a] - pad, hi = box[3 + a] + pad;
    T a_lo, a_hi;
    if (v[a] == T(0)) {
      const bool inside = p[a] >= lo && p[a] <= hi;
      a_lo = inside ? -inf_v<T>() : inf_v<T>();
      a_hi = inside ? inf_v<T>() : -inf_v<T>();
    } else {
      const T t0 = (lo - p[a]) / v[a], t1 = (hi - p[a]) / v[a];
      a_lo = mn(t0, t1);
      a_hi = mx(t0, t1);
    }
    tmin = mx(tmin, a_lo);
    tmax = mn(tmax, a_hi);
  }
  return tmax >= tmin && tmax > T(0);
}

// the intervals of sorted tree t of group G for the ray (p, v); ts[j] is
// its leaf j's global slot, interval ids are leaf positions
template <typename T>
__device__ __forceinline__ void group_tree(const WideScene<T>& ws, const Group& G, int t,
                                           const T p[3], const T v[3], int ts[kMaxGroupLeaves],
                                           Intervals<T>& iv) {
  iv.n = 0;
  for (int j = 0; j < G.n_leaves; ++j) {
    const int s = ws.slots[G.slot_off + t * G.n_leaves + j];
    ts[j] = s;
    iv_apply(iv, G.op[j], leaf_pair_at(G.type[j], ws.objtx + 16 * s, ws.prim + 6 * s, p, v), j);
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
// trees chunk by chunk in ascending order, a ray skipping a chunk whose box
// it misses; strict < throughout, so the first of equal candidates wins (a
// group tree's ties go to the lower sorted index, as in the JAX kernel).
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
        const int n_spans = G.n_chunks > 0 ? G.n_chunks : 1;
        for (int c = 0; c < n_spans; ++c) {
          int t0 = 0, t1 = G.n_trees;
          if (G.n_chunks > 0) {
            if (!box_hit(ws.aabb + 6 * (G.chunk_off + c), p, v)) continue;
            t0 = c * kChunkTrees;
            t1 = min(t0 + kChunkTrees, G.n_trees);
          }
          for (int t = t0; t < t1; ++t) {
            Intervals<T> iv;
            int ts[kMaxGroupLeaves];
            group_tree(ws, G, t, p, v, ts, iv);
            int pos;
            const T d = nearest_of(iv, pos);
            if (d < h.best) {
              h.best = d;
              h.win = G.code_base + t;
              h.leaf = ts[pos];
              h.group = g;
              h.pos = pos;
            }
          }
        }
      });
}

}  // namespace pyrayt
