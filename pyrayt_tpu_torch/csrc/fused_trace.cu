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
// The step's device code (intersectors, CSG, nearest hit, normals) lives in
// trace_common.cuh, shared with the backward kernel (fused_grad.cu).
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
//     kernel (fused_grad.cu) reads to tell which generations a ray ran;
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

#include "trace_common.cuh"

namespace {

using namespace pyrayt;

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

  const Scene<T> sc = make_scene(s_objtx, s_prim, s_glass, s_prog, n_leaves);

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
        // Sellmeier index, the denominator guarded at its pole
        T n2 = sellmeier(sc.glass + 7 * slot, wav);
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
