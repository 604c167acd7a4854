// Adjoint device code shared by the narrow backward kernels (fused_grad.cu,
// K3/K4) and the wide backward kernels (wide_grad.cu K5-K7,
// wide_fused_grad.cu K8): the loss plans' record cotangents, the adjoint of
// trace_common.cuh's step_tail (material, death rules, record, push-off),
// the adjoint of the world normal and of a hit distance (the derivative of
// the formula its hit code names), and the fixed-order reduce of per-block
// partial sums.
//
// CUDA has no autodiff: every adjoint here is written by hand against the
// plain versions' autograd (ops/fused_grad.py), which are the oracles.

#pragma once

#include "trace_common.cuh"

namespace pyrayt {

constexpr int kGeo = 18;   // staged transform rows 0-2 (12) + prim (6)
constexpr int kGlass = 7;  // staged glass row
constexpr int kMaxScal = 16;

enum Plan { PLAN_RMS = 0, PLAN_FOCUS = 1, PLAN_SOFT_FOCUS = 2 };

// the ray state of one generation's input, and its cotangent
template <typename T>
using Carry = RayState<T>;

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

// the hit code of the endpoint of pair h nearest to the winning distance
// `best`: equal to it unless the compiler contracted the second evaluation
// differently
template <typename T>
__device__ __forceinline__ int endpoint_code(const Pair<T>& h, T best) {
  return fabs(best - h.lo) <= fabs(best - h.hi) ? h.clo : h.chi;
}

// Adjoint of a hit distance t = endpoint(M p + m, M v): the cotangent
// t_bar (plus o_bar, d_bar of the local ray already gathered) goes to the
// transform rows 0-2 (m_bar, 12), the params (pr_bar) and the world ray
// (p_bar, v_bar)
template <typename T>
__device__ void hit_distance_adjoint(int type, const T* m, const T* pr, const T p[3], const T v[3],
                                     int code, T t, T t_bar, T o_bar[3], T d_bar[3], T m_bar[12],
                                     T pr_bar[6], T p_bar[3], T v_bar[3]) {
  T o[3], d[3], go[3], gd[3], gp[6];
  local_ray(m, p, v, o, d);
  endpoint_grad(type, code, o, d, pr, t, go, gd, gp);
  for (int r = 0; r < 3; ++r) {
    o_bar[r] += t_bar * go[r];
    d_bar[r] += t_bar * gd[r];
  }
  for (int k = 0; k < 6; ++k) pr_bar[k] += t_bar * gp[k];
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) {
      m_bar[4 * r + j] += o_bar[r] * p[j] + d_bar[r] * v[j];
      p_bar[j] += m[4 * r + j] * o_bar[r];
      v_bar[j] += m[4 * r + j] * d_bar[r];
    }
    m_bar[4 * r + 3] += o_bar[r];
  }
}

// Adjoint of world_normal (trace_common.cuh) at local point lp: nrm_bar ->
// the local point's cotangent lp_bar (written), transform rows 0-2 (m_bar)
// and params (pr_bar)
template <typename T>
__device__ void world_normal_adjoint(int type, const T* m, const T* pr, const T lp[3], T scale,
                                     const T nrm_bar[3], T m_bar[12], T pr_bar[6], T lp_bar[3]) {
  T ln[3], wn[3];
  leaf_normal_raw(type, pr, lp, ln);
  for (int c = 0; c < 3; ++c) wn[c] = m[c] * ln[0] + m[4 + c] * ln[1] + m[8 + c] * ln[2];
  const T nsq = dot3(wn, wn);
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
  for (int r = 0; r < 3; ++r) lp_bar[r] = T(0);
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
}

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

// the cotangents flowing back through step_tail: the input state's
// (metadata rows in `in`; positions and directions in p_bar, v_bar), the
// hit point's (ph_bar) and the world normal's (nrm_bar)
template <typename T>
struct TailAdjoint {
  Carry<T> in;
  T p_bar[3], v_bar[3], ph_bar[3], nrm_bar[3];
};

// Adjoint of step_tail (trace_common.cuh) up to the hit point: given the
// generation's input `x`, its hit (no_hit; material slot `slot` and normal
// nrm otherwise) and the cotangents of its outputs (next state `bar`,
// record `rb`), fill `a` and the glass row's cotangent `gl` (slot_out = the
// glass slot, -1 when nothing lands there).  The hit point's cotangent
// ph_bar still has to reach p, v and the hit distance (hit_point_adjoint).
template <typename T>
__device__ void tail_adjoint(const int* kinds, const T* glass, T ray_offset, T world_index,
                             T threshold, int apply_threshold, const Carry<T>& x, bool no_hit,
                             int slot, const T nrm[3], const T rb[kRecordCols],
                             const Carry<T>& bar, TailAdjoint<T>& a, int& slot_out,
                             T gl[kGlass]) {
  slot_out = -1;
  for (int k = 0; k < kGlass; ++k) gl[k] = T(0);
  const T vsq_old = dot3(x.v, x.v);
  const bool absorbed = isclose0(sqrt(vsq_old));
  const bool living = !(absorbed || no_hit || (apply_threshold && x.inten < threshold));

  // next state and record
  T nd_bar[3];
  for (int c = 0; c < 3; ++c) {
    a.ph_bar[c] = bar.p[c] + rb[9 + c];
    nd_bar[c] = bar.v[c] + (living ? ray_offset * bar.p[c] : T(0));
    a.p_bar[c] = rb[6 + c];
    a.nrm_bar[c] = T(0);
  }
  const T nidx_bar = bar.ridx;
  a.in.gen = bar.gen + rb[0];
  a.in.inten = bar.inten + rb[1];
  a.in.wav = bar.wav + rb[2];
  a.in.ridx = rb[3];
  a.in.rid = bar.rid + rb[4];
  // tilt = v / |v| (identity where |v| = 0)
  {
    const T tb[3] = {rb[12], rb[13], rb[14]};
    if (vsq_old != T(0)) {
      const T norm = sqrt(vsq_old);
      const T tilt[3] = {x.v[0] / norm, x.v[1] / norm, x.v[2] / norm};
      normalize_bar(tilt, norm, tb, a.v_bar);
    } else {
      for (int c = 0; c < 3; ++c) a.v_bar[c] = tb[c];
    }
  }

  if (no_hit) {
    // no hit: direction zeroed, index kept, position kept (t = 0)
    a.in.ridx += nidx_bar;
    return;
  }

  // material adjoint: nd_bar -> v_bar, nrm_bar, index and glass cotangents
  const int kind = kinds[slot];
  if (kind == MIRROR) {
    a.in.ridx += nidx_bar;
    const T D = dot3(x.v, nrm);
    const T E = dot3(nd_bar, nrm);
    for (int c = 0; c < 3; ++c) {
      a.v_bar[c] += nd_bar[c] - T(2) * E * nrm[c];
      a.nrm_bar[c] += T(-2) * (nd_bar[c] * D + E * x.v[c]);
    }
  } else if (kind == GLASS) {
    const T* gr = glass + 7 * slot;
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
      a.in.ridx += nidx_bar;
      cos1_bar = T(2) * dot3(pre_bar, nn);
      for (int c = 0; c < 3; ++c) {
        vs_bar[c] = pre_bar[c];
        nn_bar[c] = T(2) * cos1 * pre_bar[c];
      }
    }
    const T cos_p_bar = exiting ? cos1_bar : -cos1_bar;
    a.in.ridx += r_bar / n2_local;
    n2_local_bar += -r_bar * r / n2_local;
    for (int c = 0; c < 3; ++c) {
      a.nrm_bar[c] += flip * nn_bar[c] + cos_p_bar * vs[c];
      vs_bar[c] += cos_p_bar * nrm[c];
    }
    if (vsq != T(0)) {
      T tmp[3];
      normalize_bar(vs, vnorm, vs_bar, tmp);
      for (int c = 0; c < 3; ++c) a.v_bar[c] += tmp[c];
    } else {
      for (int c = 0; c < 3; ++c) a.v_bar[c] += vs_bar[c];
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
      a.in.wav += wl2_bar * T(2) * x.wav;
      slot_out = slot;
    }
  } else {  // ABSORB: the direction is zeroed
    a.in.ridx += nidx_bar;
  }
}

// p_hit = p + t v: route ph_bar to the input position and direction and
// return the hit distance's cotangent
template <typename T>
__device__ __forceinline__ T hit_point_adjoint(TailAdjoint<T>& a, const Carry<T>& x, T t) {
  const T t_bar = dot3(a.ph_bar, x.v);
  for (int c = 0; c < 3; ++c) {
    a.p_bar[c] += a.ph_bar[c];
    a.v_bar[c] += t * a.ph_bar[c];
  }
  return t_bar;
}

// the input state's cotangent once p_bar and v_bar are complete
template <typename T>
__device__ __forceinline__ Carry<T> input_bar(const TailAdjoint<T>& a) {
  Carry<T> in = a.in;
  for (int c = 0; c < 3; ++c) {
    in.p[c] = a.p_bar[c];
    in.v[c] = a.v_bar[c];
  }
  return in;
}

// out[e] = sum over blocks of partials[e, :], in a fixed order: entries
// [0, 16 S) go to d_objtx, [16 S, 22 S) to d_prim, the rest to d_glass
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

}  // namespace pyrayt
