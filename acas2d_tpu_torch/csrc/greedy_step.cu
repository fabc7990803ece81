// The greedy eval's env step: one step of every env under its policy's
// clipped mean action, and the bookkeeping of each env's first episode, in
// one launch, in place on the eval's carry.
//
// Replaces no TPU kernel: the JAX package's greedy eval is one `lax.scan`
// of the engine's step that XLA fuses (acas2d_tpu/ppo/learner.py), where the
// port's eager step (envs/core.py:step) is ~100 torch ops, ~430 launches a
// step with the bookkeeping.  Inside the eval's CUDA graphs those launches,
// ~1.1 us each, are the eval's time; this kernel is one.
// Plain version: acas2d_tpu_torch/ops/greedy_step.py:step_plain (the eager
// step, which the CPU runs).  Wrapper: ops/greedy_step.py:greedy_step.
//
// What it computes, per env, in the order of core.step and of the eval's
// loop (ppo/learner.py:_greedy_steps):
//   the mean clamped to [-1, 1] and cast to the env's dtype; a_lat;
//   the player's and the active traffic slots' integration;
//   the observation (steps + 1): t, heading, plan deviation, goal distance
//     and bearing, and per active slot separation, CPA and closing speed;
//   the shaped reward of slot 0's closing speed and CPA, times the time
//     discount, plus the collision and goal terms; total_reward;
//   termination, timeout > collision > goal;
//   the first episode's return, length and outcome, and done_seen.
// An env whose episode has ended keeps stepping, as in the eager loop.
//
// Bit for bit with the eager step on the card, in float32 and float64:
// every operation is rounded once, as torch's one-op CUDA kernels round it,
// and nothing is contracted (__fmul_rn, __fadd_rn, __fdiv_rn and their
// double forms, which nvcc never fuses); the library functions are those
// torch's kernels call (sinf, cosf, atan2f, atanf, fmodf, IEEE sqrt, and
// the double versions).  torch divides a tensor by a Python scalar as a
// product with the scalar's reciprocal rounded in the tensor's dtype, and
// 0.0 / t as t's reciprocal times 0.0: the wrapper hands those reciprocals
// over (GreedyConsts), and the kernel takes every product in torch's order.
//
// What bounds it on an H100: at the eval's shapes (1,024 or 100 envs) the
// work is a few hundred dependent operations an env (a dozen sines and
// arctangents), one thread each: the launch and that chain's latency.  The
// carry is read and written once (about 150 bytes an env with one traffic
// aircraft).  Design: one thread an env, 64 a block so that more SMs take
// the chain; the env's dtype and the mean's are template parameters, the
// traffic slots, their mask and bug_compat are read at run time.
#include <cuda_runtime.h>
#include <math.h>

namespace acas {

// The step's constants as the eager step's torch ops see them, each a value
// of the env's dtype held in a double: a Python scalar rounded to that
// dtype, and for a division by a Python scalar, that scalar's reciprocal
// rounded in that dtype.  Filled by ops/greedy_step.py:constants.
struct GreedyConsts {
  double acc;               // acc_lat_limit
  double inv_vdt;           // 1 / (airspeed * dt), a Python product
  double inv_v;             // 1 / airspeed
  double v;                 // airspeed
  double dt;
  double inv_dt;
  double inv360;
  double pi;
  double two_pi;
  double rad2deg;
  double inv_max_steps;
  double goal_x;
  double goal_y;
  double inv_d_sep_max;
  double inv_d_cpa_max;
  double inv_v_closing_max;
  double inv_d_dev_max;
  double inv_d_goal_max;
  double inv180;
  double inv_safe;
  double inv_d_dev_max_reward;
  double inv_d_goal_max_reward;
  double coll_dist;         // 2 * collision_radius
  double goal_radius;
  double reward_collision;
  double reward_goal;
  int max_steps;
  int max_traffic;
  int bug_compat;
};

}  // namespace acas

namespace {

using acas::GreedyConsts;
constexpr int THREADS = 64;

// The carry's tensors, in ops/greedy_step.py:OPERANDS' order.
constexpr int N_PTRS = 18;
enum {
  PX, PY, PPSI, PA_LAT, TX, TY, TV, TPSI, NUM_TRAFFIC, STEPS, TOTAL_REWARD,
  ENV_OUTCOME, OBS, RET, LENGTH, OUTCOME, DONE_SEEN, MEAN
};

struct Ptrs {
  void* p[N_PTRS];
};

template <typename V>
__device__ __forceinline__ V* at(const Ptrs& p, int i) {
  return static_cast<V*>(p.p[i]);
}

// Each operation rounded once, as one torch op rounds it.
template <typename T>
struct R;

template <>
struct R<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float atan(float a) { return atanf(a); }
  static __device__ __forceinline__ float atan2(float y, float x) {
    return atan2f(y, x);
  }
  static __device__ __forceinline__ float fmod(float a, float b) {
    return fmodf(a, b);
  }
};

template <>
struct R<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double abs(double a) {
    return ::fabs(a);
  }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double atan(double a) {
    return ::atan(a);
  }
  static __device__ __forceinline__ double atan2(double y, double x) {
    return ::atan2(y, x);
  }
  static __device__ __forceinline__ double fmod(double a, double b) {
    return ::fmod(a, b);
  }
};

// torch.remainder's CUDA kernel
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T m = R<T>::fmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = R<T>::add(m, b);
  return m;
}

// torch.clamp's with one bound, and torch.minimum: NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return isnan(x) ? x : (x < hi ? x : hi);
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : (x > lo ? x : lo);
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}

// The step's constants in the env's dtype.
template <typename T>
struct Consts {
  T acc, inv_vdt, inv_v, v, dt, inv_dt, inv360, pi, two_pi, rad2deg,
      inv_max_steps, goal_x, goal_y, inv_d_sep_max, inv_d_cpa_max,
      inv_v_closing_max, inv_d_dev_max, inv_d_goal_max, inv180, inv_safe,
      inv_d_dev_max_reward, inv_d_goal_max_reward, coll_dist, goal_radius,
      reward_collision, reward_goal;

  __device__ explicit Consts(const GreedyConsts& k)
      : acc(T(k.acc)), inv_vdt(T(k.inv_vdt)), inv_v(T(k.inv_v)), v(T(k.v)),
        dt(T(k.dt)), inv_dt(T(k.inv_dt)), inv360(T(k.inv360)), pi(T(k.pi)),
        two_pi(T(k.two_pi)), rad2deg(T(k.rad2deg)),
        inv_max_steps(T(k.inv_max_steps)), goal_x(T(k.goal_x)),
        goal_y(T(k.goal_y)), inv_d_sep_max(T(k.inv_d_sep_max)),
        inv_d_cpa_max(T(k.inv_d_cpa_max)),
        inv_v_closing_max(T(k.inv_v_closing_max)),
        inv_d_dev_max(T(k.inv_d_dev_max)),
        inv_d_goal_max(T(k.inv_d_goal_max)), inv180(T(k.inv180)),
        inv_safe(T(k.inv_safe)),
        inv_d_dev_max_reward(T(k.inv_d_dev_max_reward)),
        inv_d_goal_max_reward(T(k.inv_d_goal_max_reward)),
        coll_dist(T(k.coll_dist)), goal_radius(T(k.goal_radius)),
        reward_collision(T(k.reward_collision)),
        reward_goal(T(k.reward_goal)) {}

  // kinematics.deg_to_rad: (psi / 360) * 2 * pi
  __device__ __forceinline__ T deg_to_rad(T psi) const {
    return R<T>::mul(R<T>::mul(R<T>::mul(psi, inv360), T(2)), pi);
  }

  // kinematics.relative_angle: bearing 1 -> 2 in degrees
  __device__ __forceinline__ T relative_angle(T x1, T y1, T x2, T y2) const {
    const T rads = remainder(R<T>::atan2(R<T>::sub(y2, y1),
                                         R<T>::sub(x2, x1)), two_pi);
    return R<T>::mul(rads, rad2deg);
  }
};

template <typename T>
__device__ __forceinline__ T distance(T x1, T y1, T x2, T y2) {
  const T dx = R<T>::sub(x1, x2), dy = R<T>::sub(y1, y2);
  return R<T>::sqrt(R<T>::add(R<T>::mul(dx, dx), R<T>::mul(dy, dy)));
}

// kinematics.integrate of one aircraft; a_lat / (v * dt) is handed in
template <typename T>
__device__ __forceinline__ void integrate(const Consts<T>& c, T& x, T& y,
                                          T v, T& psi, T psi_dot) {
  psi = remainder(R<T>::add(psi, R<T>::mul(psi_dot, c.dt)), T(360));
  const T r = c.deg_to_rad(psi);
  x = R<T>::add(x, R<T>::mul(R<T>::mul(v, R<T>::cos(r)), c.dt));
  y = R<T>::add(y, R<T>::mul(R<T>::mul(v, R<T>::sin(r)), c.dt));
}

// core._pair_metrics of the player against one traffic slot: the closing
// speed (kinematics.closing_speed, traffic a_lat 0.0) and the CPA
// (kinematics.distance_closest_approach); `d` is their distance and
// `psi_rad` the player's heading in radians
template <typename T>
__device__ __forceinline__ void pair_metrics(
    const Consts<T>& c, bool bug, T px, T py, T psi, T psi_rad, T a_lat,
    T tx, T ty, T tv, T tpsi, T d, T* v_closing, T* d_cpa) {
  using O = R<T>;
  // closing speed: the one-step lookahead of both aircraft
  T pd1, pd2;
  if (bug) {
    pd1 = O::mul(a_lat, c.inv_v);                  // a_lat / v (no dt)
    pd2 = O::mul(O::div(T(1), tv), T(0));          // 0.0 / tv
  } else {
    pd1 = O::mul(a_lat, c.inv_vdt);                // a_lat / (v * dt)
    pd2 = O::mul(O::div(T(1), O::mul(tv, c.dt)), T(0));
  }
  const T r1 = c.deg_to_rad(remainder(O::add(psi, O::mul(pd1, c.dt)),
                                      T(360)));
  const T r2 = c.deg_to_rad(remainder(O::add(tpsi, O::mul(pd2, c.dt)),
                                      T(360)));
  const T s2 = O::sin(r2);
  const T vx1 = O::mul(O::mul(c.v, O::cos(r1)), c.dt);
  const T vy1 = O::mul(O::mul(c.v, O::sin(r1)), c.dt);
  const T nx1 = O::add(px, vx1), ny1 = O::add(py, vy1);
  const T vx2 = O::mul(O::mul(tv, O::cos(r2)), c.dt);
  const T vy2 = O::mul(O::mul(bug ? c.v : tv, s2), c.dt);
  const T ny2_vy = O::mul(O::mul(tv, s2), c.dt);
  const T nx2 = O::add(tx, vx2), ny2 = O::add(ty, ny2_vy);
  const T num = O::add(O::mul(O::sub(vx1, vx2), O::sub(nx1, nx2)),
                       O::mul(O::sub(vy1, vy2), O::sub(ny1, ny2)));
  const T d_next = distance(nx1, ny1, nx2, ny2);
  *v_closing = O::mul(O::div(num, d_next == T(0) ? T(1) : d_next),
                      c.inv_dt);
  // CPA
  const T a_rel = c.deg_to_rad(c.relative_angle(px, py, tx, ty));
  const T r_t = c.deg_to_rad(tpsi);
  const T v12x = O::sub(O::mul(c.v, O::cos(psi_rad)),
                        O::mul(tv, O::cos(r_t)));
  const T v12y = O::sub(O::mul(c.v, O::sin(psi_rad)),
                        O::mul(tv, O::sin(r_t)));
  T h_rel;
  if (bug) {
    const T denom = (v12x == T(0) && v12y == T(0)) ? T(1) : v12x;
    h_rel = O::atan(O::div(v12y, denom));
  } else {
    h_rel = O::atan2(v12y, v12x);
  }
  *d_cpa = O::mul(d, O::sin(O::sub(a_rel, h_rel)));
}

template <typename T, typename M>
__global__ void __launch_bounds__(THREADS) greedy_step_kernel(
    const GreedyConsts k, int B, const Ptrs p) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B) return;
  using O = R<T>;
  const Consts<T> c(k);
  const int MT = k.max_traffic;
  const bool bug = k.bug_compat != 0;

  // the action: torch.clamp(mean, -1, 1) in the mean's dtype, then cast
  M m = at<const M>(p, MEAN)[e];
  if (!isnan(m)) m = m > M(-1) ? (m < M(1) ? m : M(1)) : M(-1);
  const T a_lat = O::mul(static_cast<T>(m), c.acc);

  // action phase: the player, then the active traffic slots (a_lat 0)
  T px = at<T>(p, PX)[e], py = at<T>(p, PY)[e], psi = at<T>(p, PPSI)[e];
  integrate(c, px, py, c.v, psi, O::mul(a_lat, c.inv_vdt));
  const T psi_rad = c.deg_to_rad(psi);

  // observe phase: steps + 1, the goal's distance and bearing
  const int steps = at<int>(p, STEPS)[e] + 1;
  const T t_frac = O::mul(static_cast<T>(steps), c.inv_max_steps);
  const T d_goal = distance(px, py, c.goal_x, c.goal_y);
  const T h_goal = c.relative_angle(px, py, c.goal_x, c.goal_y);
  const T d_dev = O::mul(d_goal, O::sin(c.deg_to_rad(h_goal)));
  T* const obs = at<T>(p, OBS) + (size_t)e * (5 + 3 * MT);
  obs[0] = t_frac;
  obs[1] = O::mul(psi, c.inv360);
  obs[2] = O::mul(d_dev, c.inv_d_dev_max);
  obs[3] = O::mul(d_goal, c.inv_d_goal_max);
  obs[4] = O::mul(h_goal, c.inv360);

  const int nt = at<int>(p, NUM_TRAFFIC)[e];
  bool collided = false;
  T v_c0 = T(0), d_cpa0 = T(0);
  for (int j = 0; j < MT; ++j) {
    const size_t i = (size_t)e * MT + j;
    const bool active = j < nt;
    T tx = at<T>(p, TX)[i], ty = at<T>(p, TY)[i], tpsi = at<T>(p, TPSI)[i];
    const T tv = at<T>(p, TV)[i];
    if (active) {
      // zeros / (v * dt): 0, as the eager step divides it
      integrate(c, tx, ty, tv, tpsi, O::div(T(0), O::mul(tv, c.dt)));
      at<T>(p, TX)[i] = tx;
      at<T>(p, TY)[i] = ty;
      at<T>(p, TPSI)[i] = tpsi;
    }
    T* const o = obs + 5 + 3 * j;
    if (active || j == 0) {
      const T d = distance(px, py, tx, ty);
      T v_c, d_cpa;
      pair_metrics(c, bug, px, py, psi, psi_rad, a_lat, tx, ty, tv, tpsi, d,
                   &v_c, &d_cpa);
      if (j == 0) {
        v_c0 = v_c;
        d_cpa0 = d_cpa;
      }
      if (active) {
        collided = collided || d < c.coll_dist;
        o[0] = O::mul(d, c.inv_d_sep_max);
        o[1] = O::mul(d_cpa, c.inv_d_cpa_max);
        o[2] = O::mul(v_c, c.inv_v_closing_max);
        continue;
      }
    }
    o[0] = T(0);
    o[1] = T(0);
    o[2] = T(0);
  }

  // evaluate phase: rewards.step_reward on slot 0, the time discount, the
  // terminal terms
  const T dh_abs = O::abs(O::sub(psi, h_goal));
  const T dh = minimum(dh_abs, O::sub(T(360), dh_abs));
  const T hb = O::sub(T(1), O::mul(dh, c.inv180));
  const T hb2 = O::mul(hb, hb);
  const T heading = O::mul(hb2, hb2);
  const T q = O::mul(d_cpa0, c.inv_safe);
  const T q2 = O::mul(q, q);
  const T cpa_r = v_c0 > T(0) ? T(1) : clamp_max(O::mul(q2, q2), T(1));
  const T frac = O::mul(O::abs(d_dev), c.inv_d_dev_max_reward);
  const T inside = O::sqrt(clamp_min(O::sub(T(1), frac), T(0)));
  const T dev_r = frac > T(1) ? T(0) : inside;
  const T approach = O::mul(cpa_r, dev_r);
  const T g = O::sub(T(1), O::mul(d_goal, c.inv_d_goal_max_reward));
  const T g2 = O::mul(g, g);
  const T separating = clamp_max(O::mul(g2, g2), T(1));
  const T r_step = O::mul(heading, v_c0 <= T(0) ? approach : separating);
  const T tdf = O::sub(T(1), O::mul(static_cast<T>(steps), c.inv_max_steps));
  const bool at_goal = d_goal < c.goal_radius;
  const T reward = O::add(
      O::add(O::mul(r_step, tdf), collided ? c.reward_collision : T(0)),
      at_goal ? c.reward_goal : T(0));

  // termination: timeout > collision > goal
  const int outcome = steps > k.max_steps ? 3
                      : collided          ? 2
                      : at_goal           ? 1
                                          : 0;
  const bool done = outcome != 0;

  at<T>(p, PX)[e] = px;
  at<T>(p, PY)[e] = py;
  at<T>(p, PPSI)[e] = psi;
  at<T>(p, PA_LAT)[e] = a_lat;
  at<int>(p, STEPS)[e] = steps;
  at<T>(p, TOTAL_REWARD)[e] = O::add(at<T>(p, TOTAL_REWARD)[e], reward);
  at<int>(p, ENV_OUTCOME)[e] = outcome;

  // the first episode's bookkeeping (learner._greedy_steps)
  bool* const seen = at<bool>(p, DONE_SEEN);
  const bool active = !seen[e];
  at<T>(p, RET)[e] = O::add(at<T>(p, RET)[e], active ? reward : T(0));
  at<int>(p, LENGTH)[e] += active ? 1 : 0;
  if (active && done) at<int>(p, OUTCOME)[e] = outcome;
  seen[e] = seen[e] || done;
}

template <typename T, typename M>
cudaError_t launch(const GreedyConsts& k, int B, const Ptrs& p,
                   cudaStream_t stream) {
  greedy_step_kernel<T, M><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                             stream>>>(k, B, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One greedy step of B envs, in place.  env_double: the env's floats are
// float64 (else float32); mean_double: the mean is float64 (else float32).
// ptrs: N_PTRS device pointers in the enum's order: px, py, ppsi, pa_lat
// (B,), tx, ty, tv, tpsi (B, max_traffic), num_traffic, steps (B,) int32,
// total_reward (B,), the env's outcome (B,) int32, obs (B, 5 + 3 *
// max_traffic), ret (B,), length, outcome (B,) int32, done_seen (B,) bool,
// mean (B,).  Returns the launch's cudaGetLastError().
int acas_greedy_step(const acas::GreedyConsts* k, int env_double, int mean_double,
                     int B, void* const* ptrs, void* stream) {
  Ptrs p;
  for (int i = 0; i < N_PTRS; ++i) p.p[i] = ptrs[i];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (env_double)
    err = mean_double ? launch<double, double>(*k, B, p, st)
                      : launch<double, float>(*k, B, p, st);
  else
    err = mean_double ? launch<float, double>(*k, B, p, st)
                      : launch<float, float>(*k, B, p, st);
  return (int)err;
}

}  // extern "C"
