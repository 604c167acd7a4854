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
//   * forward recompute of that generation (trace_common.cuh: the same
//     nearest hit as K1), then the adjoint: record cotangent + carried
//     state cotangent -> input-state cotangent and the cotangents of the
//     hit leaf's 16 transform and 6 primitive entries and of the glass row.
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
// Deterministic parameter sums: after each generation every thread stages
// its (leaf, 18 geometry values, glass slot, 7 values) in shared memory and
// thread j folds the staged rays, in ray order, into the block's entries j,
// j + 128, ...; per-block partials (float64) go to a scratch buffer that a
// second kernel reduces in fixed order.  No atomics: two launches on the
// same inputs give bit-identical gradients.
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
// scalar math, with the CSG lists in local memory, as K1.

#include "trace_common.cuh"

namespace {

using namespace pyrayt;

constexpr int kGeo = 18;   // staged transform rows 0-2 (12) + prim (6)
constexpr int kGlass = 7;  // staged glass row
constexpr int kMaxScal = 16;

enum Plan { PLAN_RMS = 0, PLAN_FOCUS = 1, PLAN_SOFT_FOCUS = 2 };

template <typename T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// cotangent of x through x / |x| (|x| = norm != 0): (y_bar - y (y . y_bar)) / norm
template <typename T>
__device__ __forceinline__ void normalize_bar(const T y[3], T norm, const T y_bar[3], T x_bar[3]) {
  T yd = dot3(y, y_bar);
  for (int c = 0; c < 3; ++c) x_bar[c] = (y_bar[c] - y[c] * yd) / norm;
}

// derivative of the endpoint named by `code` of a leaf of type `type` at
// the local ray (o, d): d t / d o, d t / d d and d t / d prim
template <typename T>
__device__ void endpoint_grad(int type, int code, const T o[3], const T d[3], const T* pr, T t,
                              T go[3], T gd[3], T gp[6]) {
  for (int k = 0; k < 3; ++k) go[k] = gd[k] = T(0);
  for (int k = 0; k < 6; ++k) gp[k] = T(0);
  if (code == C_PLUS || code == C_MINUS || code == C_LINEAR) {
    // partials of the quadratic's a, b, c (a does not enter the linear root)
    T a_d[3] = {T(2) * d[0], T(2) * d[1], T(0)};
    T b_o[3] = {T(2) * d[0], T(2) * d[1], T(0)};
    T b_d[3] = {T(2) * o[0], T(2) * o[1], T(0)};
    T c_o[3] = {T(2) * o[0], T(2) * o[1], T(0)};
    T b_p[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T c_p[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T a, b, c;
    if (type == SPHERE) {
      a_d[2] = T(2) * d[2];
      b_o[2] = T(2) * d[2];
      b_d[2] = T(2) * o[2];
      c_o[2] = T(2) * o[2];
      c_p[0] = T(-2) * pr[0];
      a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      b = T(2) * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
      c = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) - pr[0] * pr[0];
    } else if (type == PARABOLOID) {
      b_d[2] = T(-4) * pr[0];
      c_o[2] = T(-4) * pr[0];
      b_p[0] = T(-4) * d[2];
      c_p[0] = T(-4) * o[2];
      a = d[0] * d[0] + d[1] * d[1];
      b = T(2) * (o[0] * d[0] + o[1] * d[1]) - T(4) * pr[0] * d[2];
      c = (o[0] * o[0] + o[1] * o[1]) - T(4) * pr[0] * o[2];
    } else {  // CYLINDER
      c_p[0] = T(-2) * pr[0];
      a = d[0] * d[0] + d[1] * d[1];
      b = T(2) * (d[0] * o[0] + d[1] * o[1]);
      c = (o[0] * o[0] + o[1] * o[1]) - pr[0] * pr[0];
    }
    T t_a = T(0), t_b, t_c;
    if (code == C_LINEAR) {
      // -c / b' with b' = b (+1 where b ~ 0, the paraboloid's guard)
      T bb = b + (type == PARABOLOID && isclose0(b) ? T(1) : T(0));
      t_c = T(-1) / bb;
      t_b = c / (bb * bb);
    } else {
      T s = code == C_PLUS ? T(1) : T(-1);
      T disc = b * b - T(4) * a * c;
      // d sqrt(disc) / d disc, zero where safe_sqrt is guarded
      T rf = disc > T(0) ? T(1) / (T(2) * sqrt(disc)) : T(0);
      T den = T(2) * a;
      t_a = s * rf * (T(-4) * c) / den - T(2) * t / den;
      t_b = (T(-1) + s * rf * (T(2) * b)) / den;
      t_c = s * rf * (T(-4) * a) / den;
    }
    for (int k = 0; k < 3; ++k) {
      go[k] = t_b * b_o[k] + t_c * c_o[k];
      gd[k] = t_a * a_d[k] + t_b * b_d[k];
    }
    for (int k = 0; k < 6; ++k) gp[k] = t_b * b_p[k] + t_c * c_p[k];
    return;
  }
  if (code == C_SLAB_LO || code == C_SLAB_HI || code == C_PLANE) {
    // (bound - o_z) / d_z; the paraboloid's slab is [0, height], the
    // cylinder's [h_min, h_max], the plane's bound is 0
    go[2] = T(-1) / d[2];
    gd[2] = -t / d[2];
    if (type == PARABOLOID && code == C_SLAB_HI) gp[1] = T(1) / d[2];
    if (type == CYLINDER) gp[code == C_SLAB_LO ? 1 : 2] = T(1) / d[2];
    return;
  }
  if (code >= C_CUBE_FACE) {
    int axis = (code - C_CUBE_FACE) / 2, side = (code - C_CUBE_FACE) % 2;
    go[axis] = T(-1) / d[axis];
    gd[axis] = -t / d[axis];
    gp[2 * axis + side] = T(1) / d[axis];
  }
}

// the ray state of one generation's input (homogeneous w rows implied)
template <typename T>
struct Carry {
  T p[3], v[3], gen, inten, wav, ridx, rid;
};

// smoothstep and its derivative (analysis/metrics.py)
template <typename T>
__device__ __forceinline__ T smoothstep(T u) {
  u = mn(mx(u, T(0)), T(1));
  return u * u * (T(3) - T(2) * u);
}

template <typename T>
__device__ __forceinline__ T smoothstep_prime(T u) {
  return (u > T(0) && u < T(1)) ? T(6) * u * (T(1) - u) : T(0);
}

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// the record cotangent of a loss plan (ops/fused_grad.py: _rms_plan,
// _focus_plan, _soft_focus_plan), from the recorded row and its mask
template <typename T>
__device__ void plan_drec(int plan, const T* scal, const T r[kRecordCols], bool mask,
                          T rb[kRecordCols]) {
  for (int c = 0; c < kRecordCols; ++c) rb[c] = T(0);
  if (plan == PLAN_RMS) {
    // scal: cy, cz, W, L, g, surface_id
    bool m = mask && r[5] == scal[5];
    T L = scal[3];
    T safe = L > T(0) ? scal[2] * L : T(1);
    T coef = (m && L > T(0)) ? scal[4] / safe : T(0);
    rb[10] = coef * (r[10] - scal[0]);
    rb[11] = coef * (r[11] - scal[1]);
  } else if (plan == PLAN_FOCUS) {
    // scal: W, value, g, surface_id, min_tilt, target
    T yt = r[13];
    bool tilted = fabs(yt) > scal[4];
    bool m = mask && r[5] == scal[3] && tilted;
    T safe_yt = tilted ? yt : T(1);
    T t = r[6] - r[12] * r[7] / safe_yt;
    T base = m ? T(2) * (t - scal[5]) * scal[2] / scal[0] : T(0);
    rb[6] = base;
    rb[12] = base * (-r[7] / safe_yt);
    rb[7] = base * (-r[12] / safe_yt);
    rb[13] = base * (r[12] * r[7] / (safe_yt * safe_yt));
  } else {
    // scal: W, value, g, surface_id, target, hy, hz, ramp, t0, t1
    T W = scal[0], L = scal[1], g = scal[2];
    T hy = scal[5], hz = scal[6], ramp = scal[7], t0 = scal[8], t1 = scal[9];
    T y1 = r[10], z1 = r[11], yt = r[13];
    bool m = mask && r[5] == scal[3];
    T uy = (hy - fabs(y1)) / ramp, uz = (hz - fabs(z1)) / ramp;
    T ut = (fabs(yt) - t0) / (t1 - t0);
    T wy = smoothstep(uy), wz = smoothstep(uz), wt = smoothstep(ut);
    T w = (m ? wy * wz : T(0)) * wt;
    bool tilted = fabs(yt) > t0;
    T safe_yt = tilted ? yt : t0;
    T t = r[6] - r[12] * r[7] / safe_yt;
    T e = t - scal[4];
    T base = T(2) * e * w / W * g;
    T dE = (e * e - L) / W * g;
    T dwy = smoothstep_prime(uy) * (-sgn(y1) / ramp);
    T dwz = smoothstep_prime(uz) * (-sgn(z1) / ramp);
    T dwt = smoothstep_prime(ut) * (sgn(yt) / (t1 - t0));
    T mf = m ? T(1) : T(0);
    T t_yt = tilted ? base * r[12] * r[7] / (safe_yt * safe_yt) : T(0);
    rb[6] = base;
    rb[12] = base * (-r[7] / safe_yt);
    rb[7] = base * (-r[12] / safe_yt);
    rb[13] = t_yt + mf * wy * wz * dwt * dE;
    rb[10] = mf * dwy * wz * wt * dE;
    rb[11] = mf * wy * dwz * wt * dE;
  }
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
  slot_out = -1;
  for (int k = 0; k < kGeo; ++k) geo[k] = T(0);
  for (int k = 0; k < kGlass; ++k) gl[k] = T(0);

  // ---- forward recompute (fused_trace.cu, one generation) ----------------
  T best;
  int leaf;
  nearest_hit(sc, x.p, x.v, best, leaf);
  const bool no_hit = leaf < 0;
  const T t = no_hit ? T(0) : best;
  T ph[3];
  for (int c = 0; c < 3; ++c) ph[c] = x.p[c] + t * x.v[c];
  const T vsq_old = dot3(x.v, x.v);
  const bool absorbed = isclose0(sqrt(vsq_old));
  const bool living = !(absorbed || no_hit || (apply_threshold && x.inten < threshold));

  // ---- adjoint: next state and record ------------------------------------
  T ph_bar[3], nd_bar[3], p_bar[3], v_bar[3];
  for (int c = 0; c < 3; ++c) {
    ph_bar[c] = bar.p[c] + rb[9 + c];
    nd_bar[c] = bar.v[c] + (living ? ray_offset * bar.p[c] : T(0));
    p_bar[c] = rb[6 + c];
  }
  T nidx_bar = bar.ridx;
  Carry<T> in;
  in.gen = bar.gen + rb[0];
  in.inten = bar.inten + rb[1];
  in.wav = bar.wav + rb[2];
  in.ridx = rb[3];
  in.rid = bar.rid + rb[4];
  // tilt = v / |v| (identity where |v| = 0)
  {
    const T tb[3] = {rb[12], rb[13], rb[14]};
    if (vsq_old != T(0)) {
      const T norm = sqrt(vsq_old);
      const T tilt[3] = {x.v[0] / norm, x.v[1] / norm, x.v[2] / norm};
      normalize_bar(tilt, norm, tb, v_bar);
    } else {
      for (int c = 0; c < 3; ++c) v_bar[c] = tb[c];
    }
  }

  if (no_hit) {
    // no hit: direction zeroed, index kept, position kept (t = 0)
    in.ridx += nidx_bar;
    for (int c = 0; c < 3; ++c) {
      in.p[c] = p_bar[c] + ph_bar[c];
      in.v[c] = v_bar[c];
    }
    bar = in;
    return;
  }

  const int* L = sc.leaf + 5 * leaf;
  const int type = L[0], slot = L[1];
  const int kind = sc.kinds[slot];
  const T scale = static_cast<T>(L[2]);
  const T* m = sc.objtx + 16 * leaf;
  const T* pr = sc.prim + 6 * leaf;
  leaf_out = leaf;
  T* m_bar = geo;       // 12 entries: rows 0-2 of the object transform
  T* pr_bar = geo + 12;  // 6 entries

  // normal (forward), K1's form
  T lp[3] = {T(0), T(0), T(0)}, ln[3] = {T(0), T(0), T(0)}, wn[3] = {T(0), T(0), T(0)};
  T nrm[3] = {T(0), T(0), T(0)}, nsq = T(0);
  if (L[3]) {
    for (int r = 0; r < 3; ++r) {
      lp[r] = m[4 * r] * ph[0] + m[4 * r + 1] * ph[1] + m[4 * r + 2] * ph[2] + m[4 * r + 3];
    }
    leaf_normal_raw(type, pr, lp, ln);
    for (int c = 0; c < 3; ++c) wn[c] = m[c] * ln[0] + m[4 + c] * ln[1] + m[8 + c] * ln[2];
    nsq = dot3(wn, wn);
    const T norm = nsq == T(0) ? T(1) : sqrt(nsq);
    for (int c = 0; c < 3; ++c) nrm[c] = wn[c] / norm * scale;
  }

  // material adjoint: nd_bar -> v_bar, nrm_bar, index and glass cotangents
  T nrm_bar[3] = {T(0), T(0), T(0)};
  if (kind == MIRROR) {
    in.ridx += nidx_bar;
    const T D = dot3(x.v, nrm);
    const T E = dot3(nd_bar, nrm);
    for (int c = 0; c < 3; ++c) {
      v_bar[c] += nd_bar[c] - T(2) * E * nrm[c];
      nrm_bar[c] += T(-2) * (nd_bar[c] * D + E * x.v[c]);
    }
  } else if (kind == GLASS) {
    const T* gr = sc.glass + 7 * slot;
    const T n2 = sellmeier(gr, x.wav);
    // refract, forward
    T vs[3] = {x.v[0], x.v[1], x.v[2]};
    const T vsq = vsq_old;
    const T vnorm = vsq != T(0) ? sqrt(vsq) : T(1);
    if (vsq != T(0)) {
      for (int c = 0; c < 3; ++c) vs[c] = vs[c] / vnorm;
    }
    const T cos_p = dot3(vs, nrm);
    const bool exiting = cos_p > T(0);
    const T n2_local = exiting ? world_index : n2;
    const T flip = exiting ? T(-1) : T(1);
    const T r = x.ridx / n2_local;
    const T cos1 = exiting ? cos_p : -cos_p;
    const T radicand = T(1) - (r * r) * (T(1) - cos1 * cos1);
    const T cos2 = safe_sqrt(radicand);
    const bool refracts = radicand > T(0);
    T nn[3], pre[3];
    for (int c = 0; c < 3; ++c) {
      nn[c] = flip * nrm[c];
      pre[c] = refracts ? r * vs[c] + (r * cos1 - cos2) * nn[c] : vs[c] + T(2) * cos1 * nn[c];
    }
    const T osq = dot3(pre, pre);
    // refract, adjoint
    T pre_bar[3];
    if (osq != T(0)) {
      const T onorm = sqrt(osq);
      const T nd[3] = {pre[0] / onorm, pre[1] / onorm, pre[2] / onorm};
      normalize_bar(nd, onorm, nd_bar, pre_bar);
    } else {
      for (int c = 0; c < 3; ++c) pre_bar[c] = nd_bar[c];
    }
    T vs_bar[3], nn_bar[3], r_bar = T(0), cos1_bar, n2_local_bar = T(0);
    if (refracts) {
      n2_local_bar += nidx_bar;
      const T coef = r * cos1 - cos2;
      const T coef_bar = dot3(pre_bar, nn);
      r_bar = dot3(pre_bar, vs) + coef_bar * cos1;
      cos1_bar = coef_bar * r;
      const T cos2_bar = -coef_bar;
      const T rad_bar = cos2 > T(0) ? cos2_bar / (T(2) * cos2) : T(0);
      r_bar += rad_bar * (T(-2) * r * (T(1) - cos1 * cos1));
      cos1_bar += rad_bar * (r * r * T(2) * cos1);
      for (int c = 0; c < 3; ++c) {
        vs_bar[c] = r * pre_bar[c];
        nn_bar[c] = coef * pre_bar[c];
      }
    } else {
      // total internal reflection keeps the incident index
      in.ridx += nidx_bar;
      cos1_bar = T(2) * dot3(pre_bar, nn);
      for (int c = 0; c < 3; ++c) {
        vs_bar[c] = pre_bar[c];
        nn_bar[c] = T(2) * cos1 * pre_bar[c];
      }
    }
    const T cos_p_bar = exiting ? cos1_bar : -cos1_bar;
    in.ridx += r_bar / n2_local;
    n2_local_bar += -r_bar * r / n2_local;
    for (int c = 0; c < 3; ++c) {
      nrm_bar[c] += flip * nn_bar[c] + cos_p_bar * vs[c];
      vs_bar[c] += cos_p_bar * nrm[c];
    }
    if (vsq != T(0)) {
      T tmp[3];
      normalize_bar(vs, vnorm, vs_bar, tmp);
      for (int c = 0; c < 3; ++c) v_bar[c] += tmp[c];
    } else {
      for (int c = 0; c < 3; ++c) v_bar[c] += vs_bar[c];
    }
    // Sellmeier adjoint: n2 = sqrt(A + sum b wl2 / den)
    if (!exiting && n2_local_bar != T(0)) {
      const T n2sq_bar = n2_local_bar / (T(2) * n2);
      const T wl2 = x.wav * x.wav;
      T wl2_bar = T(0);
      gl[0] = n2sq_bar;
      for (int k = 0; k < 3; ++k) {
        const T raw = wl2 - gr[4 + k];
        const bool pole = raw == T(0);
        const T den = pole ? T(1) : raw;
        gl[1 + k] = n2sq_bar * wl2 / den;
        const T b = gr[1 + k];
        if (pole) {
          wl2_bar += n2sq_bar * b;
        } else {
          gl[4 + k] = n2sq_bar * b * wl2 / (den * den);
          wl2_bar += n2sq_bar * (b / den - b * wl2 / (den * den));
        }
      }
      in.wav += wl2_bar * T(2) * x.wav;
      slot_out = slot;
    }
  } else {  // ABSORB: the direction is zeroed
    in.ridx += nidx_bar;
  }

  // normal adjoint: nrm = scale * wn / |wn|, wn = M^T ln(lp), lp = M ph + m
  if (L[3]) {
    T u_bar[3], wn_bar[3];
    for (int c = 0; c < 3; ++c) u_bar[c] = scale * nrm_bar[c];
    if (nsq != T(0)) {
      const T norm = sqrt(nsq);
      const T u[3] = {wn[0] / norm, wn[1] / norm, wn[2] / norm};
      normalize_bar(u, norm, u_bar, wn_bar);
    } else {
      for (int c = 0; c < 3; ++c) wn_bar[c] = u_bar[c];
    }
    T ln_bar[3];
    for (int r = 0; r < 3; ++r) {
      ln_bar[r] = m[4 * r] * wn_bar[0] + m[4 * r + 1] * wn_bar[1] + m[4 * r + 2] * wn_bar[2];
      for (int c = 0; c < 3; ++c) m_bar[4 * r + c] += ln[r] * wn_bar[c];
    }
    T lp_bar[3] = {T(0), T(0), T(0)};
    if (type == SPHERE) {
      for (int r = 0; r < 3; ++r) lp_bar[r] = ln_bar[r];
    } else if (type == PARABOLOID) {
      if (!isclose(lp[2], pr[1])) {
        lp_bar[0] = ln_bar[0];
        lp_bar[1] = ln_bar[1];
        pr_bar[0] += T(-2) * ln_bar[2];
      }
    } else if (type == CYLINDER) {
      const bool capped = pr[3] != T(0);
      const bool cap = capped && (isclose(lp[2], pr[1]) || isclose(lp[2], pr[2]));
      if (!cap) {
        lp_bar[0] = ln_bar[0];
        lp_bar[1] = ln_bar[1];
      }
    }
    for (int r = 0; r < 3; ++r) {
      for (int j = 0; j < 3; ++j) {
        m_bar[4 * r + j] += lp_bar[r] * ph[j];
        ph_bar[j] += m[4 * r + j] * lp_bar[r];
      }
      m_bar[4 * r + 3] += lp_bar[r];
    }
  }

  // p_hit = p + t v
  const T t_bar = dot3(ph_bar, x.v);
  for (int c = 0; c < 3; ++c) {
    p_bar[c] += ph_bar[c];
    v_bar[c] += t * ph_bar[c];
  }

  // the hit distance: the winning endpoint of the hit leaf
  {
    // the endpoint nearest to the winning distance: equal to it unless the
    // compiler contracted this second evaluation differently
    const Pair<T> h = leaf_pair(sc, leaf, x.p, x.v);
    const int code = fabs(best - h.lo) <= fabs(best - h.hi) ? h.clo : h.chi;
    T o[3], d[3], go[3], gd[3], gp[6];
    local_ray(m, x.p, x.v, o, d);
    endpoint_grad(type, code, o, d, pr, best, go, gd, gp);
    T o_bar[3], d_bar[3];
    for (int r = 0; r < 3; ++r) {
      o_bar[r] = t_bar * go[r];
      d_bar[r] = t_bar * gd[r];
    }
    for (int k = 0; k < 6; ++k) pr_bar[k] += t_bar * gp[k];
    for (int r = 0; r < 3; ++r) {
      for (int j = 0; j < 3; ++j) {
        m_bar[4 * r + j] += o_bar[r] * x.p[j] + d_bar[r] * x.v[j];
        p_bar[j] += m[4 * r + j] * o_bar[r];
        v_bar[j] += m[4 * r + j] * d_bar[r];
      }
      m_bar[4 * r + 3] += o_bar[r];
    }
  }

  for (int c = 0; c < 3; ++c) {
    in.p[c] = p_bar[c];
    in.v[c] = v_bar[c];
  }
  bar = in;
}

template <typename T, bool LOSS>
__global__ void __launch_bounds__(kThreads) fused_bwd_kernel(
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
  double* acc = reinterpret_cast<double*>(smem);
  double* st_geo = acc + n_entries;
  double* st_gl = st_geo + kGeo * kThreads;
  T* s_objtx = reinterpret_cast<T*>(st_gl + kGlass * kThreads);
  T* s_prim = s_objtx + 16 * n_leaves;
  T* s_glass = s_prim + 6 * n_leaves;
  T* s_scal = s_glass + kGlass * n_glass;
  int* st_leaf = reinterpret_cast<int*>(s_scal + kMaxScal);
  int* st_slot = st_leaf + kThreads;
  int* s_prog = st_slot + kThreads;
  const int tid = threadIdx.x;
  for (int k = tid; k < 16 * n_leaves; k += blockDim.x) s_objtx[k] = objtx[k];
  for (int k = tid; k < 6 * n_leaves; k += blockDim.x) s_prim[k] = prim[k];
  for (int k = tid; k < kGlass * n_glass; k += blockDim.x) s_glass[k] = glass[k];
  for (int k = tid; k < program_len; k += blockDim.x) s_prog[k] = program[k];
  for (int k = tid; k < n_entries; k += blockDim.x) acc[k] = 0.0;
  if (LOSS) {
    for (int k = tid; k < n_scal; k += blockDim.x) s_scal[k] = scal[k];
  }
  __syncthreads();
  const Scene<T> sc = make_scene(s_objtx, s_prim, s_glass, s_prog, n_leaves);

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
    st_leaf[tid] = leaf;
    st_slot[tid] = slot;
    if (leaf >= 0) {
      for (int k = 0; k < kGeo; ++k) st_geo[k * kThreads + tid] = static_cast<double>(geo[k]);
    }
    if (slot >= 0) {
      for (int k = 0; k < kGlass; ++k) st_gl[k * kThreads + tid] = static_cast<double>(gl[k]);
    }
    // fold the staged rays into the block's entries, in ray order
    if (__syncthreads_or(leaf >= 0)) {
      for (int e = tid; e < n_entries; e += blockDim.x) {
        double sum = acc[e];
        if (e < 22 * n_leaves) {
          const int s = e < 16 * n_leaves ? e / 16 : (e - 16 * n_leaves) / 6;
          const int col = e < 16 * n_leaves ? e % 16 : 16 + (e - 16 * n_leaves) % 6;
          // staged geometry: transform rows 0-2 (cols 0-11), prim (12-17);
          // row 3 of the transform never enters the step
          const int k = col < 12 ? col : (col < 16 ? -1 : col - 4);
          if (k >= 0) {
            for (int r = 0; r < kThreads; ++r) {
              if (st_leaf[r] == s) sum += st_geo[k * kThreads + r];
            }
          }
        } else {
          const int q = e - 22 * n_leaves;
          const int mslot = q / kGlass, col = q % kGlass;
          for (int r = 0; r < kThreads; ++r) {
            if (st_slot[r] == mslot) sum += st_gl[col * kThreads + r];
          }
        }
        acc[e] = sum;
      }
    }
    __syncthreads();
  }

  if (active) {
    const T out[13] = {bar.p[0], bar.p[1], bar.p[2], T(0), bar.v[0], bar.v[1], bar.v[2], T(0),
                       bar.gen, bar.inten, bar.wav, bar.ridx, bar.rid};
    for (int c = 0; c < 13; ++c) dstate0[c * n + i] = out[c];
  }
  // per-block partials, entry-major: partials[e * gridDim.x + block]
  for (int e = tid; e < n_entries; e += blockDim.x) {
    partials[static_cast<long long>(e) * gridDim.x + blockIdx.x] = acc[e];
  }
}

// out[e] = sum over blocks of partials[e, :], in a fixed order
constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads) reduce_partials(
    const double* __restrict__ partials, int n_blocks, int n_leaves, T* __restrict__ d_objtx,
    T* __restrict__ d_prim, T* __restrict__ d_glass) {
  __shared__ double buf[kReduceThreads];
  const int e = blockIdx.x;
  const double* row = partials + static_cast<long long>(e) * n_blocks;
  double sum = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads) sum += row[b];
  buf[threadIdx.x] = sum;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const T value = static_cast<T>(buf[0]);
    if (e < 16 * n_leaves) {
      d_objtx[e] = value;
    } else if (e < 22 * n_leaves) {
      d_prim[e - 16 * n_leaves] = value;
    } else {
      d_glass[e - 22 * n_leaves] = value;
    }
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
  const long long blocks = (n + kThreads - 1) / kThreads;
  const size_t n_entries = 22 * static_cast<size_t>(n_leaves) + kGlass * static_cast<size_t>(n_glass);
  const size_t smem = sizeof(double) * (n_entries + (kGeo + kGlass) * kThreads) +
                      sizeof(T) * (n_entries + kMaxScal) +
                      sizeof(int) * (2 * kThreads + static_cast<size_t>(program_len));
  auto kernel = fused_bwd_kernel<T, LOSS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
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
int pyrayt_bwd_block_threads() { return kThreads; }

const char* pyrayt_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
