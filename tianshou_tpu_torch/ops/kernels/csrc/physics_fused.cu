// Fused physics step for Hopper: frame_skip x substeps semi-implicit Euler
// substeps of articulated rigid-body dynamics with MuJoCo-style soft-constraint
// contacts and joint limits, for a batch of independent envs, in ONE kernel.
//
// Replaces the TPU kernel tianshou_tpu/ops/pallas/physics_fused.py:fused_step
// (chain body _make_chain; the math is env/physics/batched.py:substep_b and
// _remap_free_b). That kernel is a traced program of lane-wide elementwise ops
// whose derivatives were taken by autodiff at trace time, with every candidate
// constraint row computed and the full [nr, nr] QP matrix formed per env. None
// of that carries over. Here one thread owns one env and runs the algorithm
// itself:
//
//  - Derivatives. Forward kinematics is one template over its scalar type,
//    instantiated with a first-order dual number carrying the NQ basis tangents
//    (body Jacobians J_v = d pcom/dq, J_w = vee(dR R^T), contact Jacobians) and
//    with a second-order jet along qd (body velocities v, w and the
//    accelerations at qdd = 0: a = d2/dt2 pcom, alpha = vee(Rdd R^T), and the
//    contact points' Jdot qd). Then M = sum_b m J_v^T J_v + J_w^T I J_w + armature
//    and the bias force is c = sum_b J_v^T m a + J_w^T (I alpha + w x I w), which
//    equals the Lagrangian form -(dT/dq - Mdot qd) in any chart, the rotation
//    vector of a free joint included. rotvec_to_mat keeps the reference's
//    EPS = 1e-9 so values and derivatives agree at r ~ 0.
//  - The contact QP without its matrix. With M = L L^T and Y_r = L^-1 J_r^T,
//    A = J M^-1 J^T = Y^T Y. Only rows of ACTIVE contacts and limits are built
//    (an inactive row is zero in the reference and keeps lambda = 0), each
//    stored as its Y_r [NQ]. One APGD iteration is u = sum_r Y_r y_r, then
//    grad_r = Y_r . u + R_r y_r + g0_r: 4 nr nq operations against nr^2. The
//    Gershgorin step bound needs every |A_rs| once per substep: they are
//    computed on the fly (symmetric, s >= r) and only the row sums are kept.
//    Inactive rows still enter the bound as the reference has them: their
//    regulariser, clamped at 1e-10 (contacts) or (1-d)/d Minv_ii (limits).
//  - Memory. Per-env scratch (the dual FK of all bodies, the Y rows, M and its
//    factor) is thread-local: the compiler places it in local memory, which is
//    interleaved so that the threads of a warp read neighbouring addresses.
//  - Sizes (NQ, NB, NJ, NC, NL, NU) are compile-time: one library per model
//    signature, built with -DNQ=.. etc. The model's constants come in as two
//    device arrays (float and int) in the layout below, packed by the wrapper
//    from the model's float64 tables, cast to float32 once.
//
// Bound on an H100 SXM: state in and out is a few hundred KB (0.1 us at
// 3.35 TB/s); the work is float32 operations outside the tensor cores
// (67 TFLOP/s). One thread per env gives E threads, far fewer than the card
// holds, so this first version is bound by the latency of one warp's serial
// instruction stream, not by the card's rate; a team of threads per env is
// later work. Measured times are in PERF.md.
//
// No fast-math: IEEE division and square root, sinf/cosf/powf in full
// precision. The kernel differs from the plain version by reassociation (and
// FMA contraction) only.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
// Without nvcc the file also compiles as plain C++ (g++ -x c++), which gives
// tt_physics_fused_host: the same per-env code in a loop on the CPU.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TT_FN __device__ __forceinline__
#define TT_BIG __device__ __noinline__
#else
#define TT_FN inline
#define TT_BIG static
#endif

#if !defined(NQ) || !defined(NB) || !defined(NJ) || !defined(NC) || !defined(NL) || !defined(NU)
#error "build with -DNQ= -DNB= -DNJ= -DNC= -DNL= -DNU= (the model's sizes)"
#endif

namespace {

constexpr int NR = 4 * NC + NL;            // candidate QP rows
constexpr int NRA = NR > 0 ? NR : 1;
constexpr int JT_FREE = 0, JT_SLIDE = 1;   // model.py joint type codes (HINGE = 2)
constexpr float ROT_EPS = 1e-9f;
constexpr float PI_F = 3.14159265358979323846f;

// ---- layout of the float constants (wrapper: physics_fused.py:pack_model) ----
constexpr int P_BODY_POS = 0;                              // [NB][3]
constexpr int P_BODY_ROT = P_BODY_POS + 3 * NB;            // [NB][9] static offset rotation
constexpr int P_BODY_COM = P_BODY_ROT + 9 * NB;            // [NB][3]
constexpr int P_BODY_MASS = P_BODY_COM + 3 * NB;           // [NB]
constexpr int P_BODY_INERTIA = P_BODY_MASS + NB;           // [NB][9] about COM, body frame
constexpr int P_FLUID_DEQ = P_BODY_INERTIA + 9 * NB;       // [NB]
constexpr int P_FLUID_AREA = P_FLUID_DEQ + NB;             // [NB][3]
constexpr int P_FLUID_IT = P_FLUID_AREA + 3 * NB;          // [NB][3]
constexpr int P_JOINT_AXIS = P_FLUID_IT + 3 * NB;          // [NJ][3]
constexpr int P_JOINT_ANCHOR = P_JOINT_AXIS + 3 * NJ;      // [NJ][3]
constexpr int P_JOINT_REF = P_JOINT_ANCHOR + 3 * NJ;       // [NJ]
constexpr int P_ARMATURE = P_JOINT_REF + NJ;               // [NQ]
constexpr int P_DAMPING = P_ARMATURE + NQ;                 // [NQ]
constexpr int P_STIFFNESS = P_DAMPING + NQ;                // [NQ]
constexpr int P_SPRINGREF = P_STIFFNESS + NQ;              // [NQ]
constexpr int P_GRAVITY = P_SPRINGREF + NQ;                // [3]
constexpr int P_CON_E = P_GRAVITY + 3;                     // [NC][3] sphere centre - body COM
constexpr int P_CON_RADIUS = P_CON_E + 3 * NC;             // [NC]
constexpr int P_CON_MARGIN = P_CON_RADIUS + NC;            // [NC]
constexpr int P_CON_MU = P_CON_MARGIN + NC;                // [NC]
constexpr int P_CON_SOLREF = P_CON_MU + NC;                // [NC][2]
constexpr int P_CON_SOLIMP = P_CON_SOLREF + 2 * NC;        // [NC][5]
constexpr int P_LIM_LO = P_CON_SOLIMP + 5 * NC;            // [NL]
constexpr int P_LIM_HI = P_LIM_LO + NL;                    // [NL]
constexpr int P_LIM_SOLREF = P_LIM_HI + NL;                // [NL][2]
constexpr int P_LIM_SOLIMP = P_LIM_SOLREF + 2 * NL;        // [NL][5]
constexpr int P_GEAR = P_LIM_SOLIMP + 5 * NL;              // [NU]
constexpr int P_CTRL_LO = P_GEAR + NU;                     // [NU]
constexpr int P_CTRL_HI = P_CTRL_LO + NU;                  // [NU]
constexpr int P_FLUID = P_CTRL_HI + NU;                    // viscosity, density
constexpr int P_SIZE = P_FLUID + 2;
// ---- layout of the int constants; joints are sorted by body ----
constexpr int I_PARENT = 0;                                // [NB], -1 = world
constexpr int I_BODY_JOINTS = I_PARENT + NB;               // [NB + 1] first joint of each body
constexpr int I_JOINT_TYPE = I_BODY_JOINTS + NB + 1;       // [NJ]
constexpr int I_JOINT_QIDX = I_JOINT_TYPE + NJ;            // [NJ]
constexpr int I_CON_BODY = I_JOINT_QIDX + NJ;              // [NC]
constexpr int I_LIM_QIDX = I_CON_BODY + NC;                // [NL]
constexpr int I_ACT_QIDX = I_LIM_QIDX + NL;                // [NU]
constexpr int I_SIZE = I_ACT_QIDX + NU;

// ---------------------------------------------------------------------------
// truncated Taylor scalars
// ---------------------------------------------------------------------------
template <int K>
struct Dual {  // value and K tangents
  float v;
  float t[K];
};
struct Jet2 {  // value, first and second derivative along one direction
  float v, d, dd;
};

template <int K> TT_FN Dual<K> operator+(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r; r.v = a.v + b.v;
  for (int k = 0; k < K; ++k) r.t[k] = a.t[k] + b.t[k];
  return r;
}
template <int K> TT_FN Dual<K> operator-(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r; r.v = a.v - b.v;
  for (int k = 0; k < K; ++k) r.t[k] = a.t[k] - b.t[k];
  return r;
}
template <int K> TT_FN Dual<K> operator*(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r; r.v = a.v * b.v;
  for (int k = 0; k < K; ++k) r.t[k] = a.t[k] * b.v + a.v * b.t[k];
  return r;
}
template <int K> TT_FN Dual<K> operator*(const Dual<K>& a, float s) {
  Dual<K> r; r.v = a.v * s;
  for (int k = 0; k < K; ++k) r.t[k] = a.t[k] * s;
  return r;
}
template <int K> TT_FN Dual<K> operator+(const Dual<K>& a, float s) {
  Dual<K> r = a; r.v = a.v + s;
  return r;
}
template <int K> TT_FN Dual<K> chain(const Dual<K>& a, float f, float f1, float) {
  Dual<K> r; r.v = f;
  for (int k = 0; k < K; ++k) r.t[k] = f1 * a.t[k];
  return r;
}
template <int K> TT_FN void set_const(Dual<K>& r, float x) {
  r.v = x;
  for (int k = 0; k < K; ++k) r.t[k] = 0.0f;
}
template <int K> TT_FN float val(const Dual<K>& a) { return a.v; }

TT_FN Jet2 operator+(const Jet2& a, const Jet2& b) { return Jet2{a.v + b.v, a.d + b.d, a.dd + b.dd}; }
TT_FN Jet2 operator-(const Jet2& a, const Jet2& b) { return Jet2{a.v - b.v, a.d - b.d, a.dd - b.dd}; }
TT_FN Jet2 operator*(const Jet2& a, const Jet2& b) {
  return Jet2{a.v * b.v, a.d * b.v + a.v * b.d, a.dd * b.v + 2.0f * (a.d * b.d) + a.v * b.dd};
}
TT_FN Jet2 operator*(const Jet2& a, float s) { return Jet2{a.v * s, a.d * s, a.dd * s}; }
TT_FN Jet2 operator+(const Jet2& a, float s) { return Jet2{a.v + s, a.d, a.dd}; }
TT_FN Jet2 chain(const Jet2& a, float f, float f1, float f2) {
  return Jet2{f, f1 * a.d, f2 * (a.d * a.d) + f1 * a.dd};
}
TT_FN void set_const(Jet2& r, float x) { r = Jet2{x, 0.0f, 0.0f}; }
TT_FN float val(const Jet2& a) { return a.v; }

template <class T> TT_FN T t_sin(const T& a) {
  const float s = sinf(val(a)), c = cosf(val(a));
  return chain(a, s, c, -s);
}
template <class T> TT_FN T t_cos(const T& a) {
  const float s = sinf(val(a)), c = cosf(val(a));
  return chain(a, c, -s, -c);
}
template <class T> TT_FN T t_sqrt(const T& a) {
  const float r = sqrtf(val(a));
  return chain(a, r, 0.5f / r, -0.25f / (r * val(a)));
}
template <class T> TT_FN T t_recip(const T& a) {
  const float r = 1.0f / val(a);
  return chain(a, r, -r * r, 2.0f * r * r * r);
}

// 3x3 helpers, row-major
template <class T> TT_FN void mm33(const T* A, const T* B, T* C) {  // C = A B
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
template <class T> TT_FN void mm33c(const T* A, const float* B, T* C) {  // C = A B, B constant
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
template <class T> TT_FN void mv33(const T* A, const T* x, T* y) {
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
template <class T> TT_FN void mv33c(const T* A, const float* x, T* y) {
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
TT_FN void mm33_abt(const float* A, const float* B, float* C) {  // C = A B^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}
TT_FN void vee33(const float* W, float* w) {
  w[0] = 0.5f * (W[7] - W[5]);
  w[1] = 0.5f * (W[2] - W[6]);
  w[2] = 0.5f * (W[3] - W[1]);
}
TT_FN void mvf(const float* A, const float* x, float* y) {  // y = A x
  for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
TT_FN void mtvf(const float* A, const float* x, float* y) {  // y = A^T x
  for (int i = 0; i < 3; ++i) y[i] = A[i] * x[0] + A[3 + i] * x[1] + A[6 + i] * x[2];
}
TT_FN float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// rotation vector (exp map) -> rotation matrix, sinc-style Rodrigues
template <class T> TT_FN void rotvec_to_mat(const T* r, T* R) {
  const T t2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const T t2e = t2 + ROT_EPS;
  const T t = t_sqrt(t2e);
  const T a = t_sin(t) * t_recip(t);
  const T b = (t_cos(t) * -1.0f + 1.0f) * t_recip(t2e);
  T zero; set_const(zero, 0.0f);
  T k[9] = {zero, r[2] * -1.0f, r[1], r[2], zero, r[0] * -1.0f, r[1] * -1.0f, r[0], zero};
  T kk[9];
  mm33(k, k, kk);
  for (int i = 0; i < 9; ++i) R[i] = a * k[i] + b * kk[i] + ((i % 4 == 0) ? 1.0f : 0.0f);
}

// body frame poses p [NB][3], R [NB][9] for joint coordinates q [NQ]
template <class T> TT_BIG void forward_kinematics(const float* __restrict__ P, const int* __restrict__ I,
                                                  const T* q, T* p, T* R) {
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    const int js = I[I_BODY_JOINTS + b], je = I[I_BODY_JOINTS + b + 1];
    T pb[3], Rb[9];
    if (je > js && I[I_JOINT_TYPE + js] == JT_FREE) {
      const int i = I[I_JOINT_QIDX + js];  // q holds the global pose (pos, rotvec)
      pb[0] = q[i]; pb[1] = q[i + 1]; pb[2] = q[i + 2];
      rotvec_to_mat(q + i + 3, Rb);
    } else {
      const int par = I[I_PARENT + b];
      const float* bp = P + P_BODY_POS + 3 * b;
      const float* br = P + P_BODY_ROT + 9 * b;
      if (par < 0) {
        for (int i = 0; i < 3; ++i) set_const(pb[i], bp[i]);
        for (int i = 0; i < 9; ++i) set_const(Rb[i], br[i]);
      } else {
        T off[3];
        mv33c(R + 9 * par, bp, off);
        for (int i = 0; i < 3; ++i) pb[i] = p[3 * par + i] + off[i];
        mm33c(R + 9 * par, br, Rb);
      }
#pragma unroll 1
      for (int j = js; j < je; ++j) {
        const T qi = q[I[I_JOINT_QIDX + j]] + (-P[P_JOINT_REF + j]);
        const float* ax = P + P_JOINT_AXIS + 3 * j;
        if (I[I_JOINT_TYPE + j] == JT_SLIDE) {
          T dir[3];
          mv33c(Rb, ax, dir);
          for (int i = 0; i < 3; ++i) pb[i] = pb[i] + dir[i] * qi;
        } else {  // hinge about the anchor: Rodrigues with a static axis
          const float* an = P + P_JOINT_ANCHOR + 3 * j;
          const float k[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
          float kk[9];
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) kk[3 * r + c] = k[3 * r] * k[c] + k[3 * r + 1] * k[3 + c] + k[3 * r + 2] * k[6 + c];
          const T s = t_sin(qi);
          const T omc = t_cos(qi) * -1.0f + 1.0f;
          T Rj[9];
          for (int i = 0; i < 9; ++i) Rj[i] = s * k[i] + omc * kk[i] + ((i % 4 == 0) ? 1.0f : 0.0f);
          T ra[3], d[3], shift[3], Rn[9];
          mv33c(Rj, an, ra);
          for (int i = 0; i < 3; ++i) d[i] = ra[i] * -1.0f + an[i];
          mv33(Rb, d, shift);
          for (int i = 0; i < 3; ++i) pb[i] = pb[i] + shift[i];
          mm33(Rb, Rj, Rn);
          for (int i = 0; i < 9; ++i) Rb[i] = Rn[i];
        }
      }
    }
    for (int i = 0; i < 3; ++i) p[3 * b + i] = pb[i];
    for (int i = 0; i < 9; ++i) R[9 * b + i] = Rb[i];
  }
}

// p <- p + R com: body origins to centres of mass
template <class T> TT_FN void to_com(const float* __restrict__ P, T* p, const T* R) {
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    T off[3];
    mv33c(R + 9 * b, P + P_BODY_COM + 3 * b, off);
    for (int i = 0; i < 3; ++i) p[3 * b + i] = p[3 * b + i] + off[i];
  }
}

// ---------------------------------------------------------------------------
// dense helpers on [NQ] / [NQ][NQ]
// ---------------------------------------------------------------------------
TT_FN void cholesky(const float* A, float* L) {  // lower factor of SPD A; L's upper part is not written
  for (int j = 0; j < NQ; ++j) {
    float d = A[j * NQ + j];
    for (int k = 0; k < j; ++k) d -= L[j * NQ + k] * L[j * NQ + k];
    d = sqrtf(fmaxf(d, 1e-30f));
    L[j * NQ + j] = d;
    for (int i = j + 1; i < NQ; ++i) {
      float s = A[i * NQ + j];
      for (int k = 0; k < j; ++k) s -= L[i * NQ + k] * L[j * NQ + k];
      L[i * NQ + j] = s / d;
    }
  }
}
TT_FN void forward_solve(const float* L, float* x) {  // x <- L^-1 x
  for (int i = 0; i < NQ; ++i) {
    float s = x[i];
    for (int k = 0; k < i; ++k) s -= L[i * NQ + k] * x[k];
    x[i] = s / L[i * NQ + i];
  }
}
TT_FN void backward_solve(const float* L, float* x) {  // x <- L^-T x
  for (int i = NQ - 1; i >= 0; --i) {
    float s = x[i];
    for (int k = i + 1; k < NQ; ++k) s -= L[k * NQ + i] * x[k];
    x[i] = s / L[i * NQ + i];
  }
}
TT_FN float dotq(const float* a, const float* b) {
  float s = 0.0f;
  for (int k = 0; k < NQ; ++k) s += a[k] * b[k];
  return s;
}

// (d, k, b) of MuJoCo's solref/solimp at violation pos
TT_FN void sol_kb(const float* solref, const float* solimp, float pos, float& d, float& k, float& b) {
  const float d0 = solimp[0], dmax = solimp[1], width = fmaxf(solimp[2], 1e-12f), mid = solimp[3], power = solimp[4];
  const float x = fminf(fmaxf(fabsf(pos) / width, 0.0f), 1.0f);
  const float lo = mid * powf(x / mid, power);
  const float hi = 1.0f - (1.0f - mid) * powf((1.0f - x) / (1.0f - mid), power);
  const float s = x < mid ? lo : hi;
  d = fminf(fmaxf(d0 + s * (dmax - d0), 1e-4f), 0.9999f);
  const float tau = solref[0], zeta = solref[1];
  k = d / (dmax * dmax * tau * tau * zeta * zeta);
  b = 2.0f / (dmax * tau);
}

// per-env scratch; thread-local, so it lives in (warp-interleaved) local memory
struct Work {
  Dual<NQ> p1[NB * 3], R1[NB * 9];  // FK with the NQ basis tangents; p1 holds COM positions
  Jet2 p2[NB * 3], R2[NB * 9];      // FK along qd
  float Jw[NB * NQ * 3];            // angular Jacobians
  float M[NQ * NQ], L[NQ * NQ];
  float Y[NRA * NQ];                // active QP rows, as L^-1 J_r^T
  float Rreg[NRA], g0[NRA], lam[NRA], y[NRA], rowsum[NRA];
};

// generalized constraint force of the active contact and limit rows, added to f
TT_BIG void constraint_force(const float* __restrict__ P, const int* __restrict__ I, const float* q,
                             const float* qd, float* f, const float* D, int n_iter, Work& w) {
  cholesky(w.M, w.L);
  float z[NQ];  // L^-1 (f - D qd): a0_r = Y_r . z
  for (int k = 0; k < NQ; ++k) z[k] = f[k] - D[k] * qd[k];
  forward_solve(w.L, z);
  int na = 0;
  float lmax = 1e-10f;  // the clamped regulariser of an inactive contact row

#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int b = I[I_CON_BODY + c];
    const float* e = P + P_CON_E + 3 * c;
    const Dual<NQ>* pc = w.p1 + 3 * b;
    const Dual<NQ>* Rc = w.R1 + 9 * b;
    const float xz = pc[2].v + (Rc[6].v * e[0] + Rc[7].v * e[1] + Rc[8].v * e[2]);
    const float dist = xz - P[P_CON_RADIUS + c];
    const float margin = P[P_CON_MARGIN + c];
    if (!(dist < margin)) continue;
    const float pos = dist - margin;
    float Yx[3][NQ], v[3], bias[3];
    for (int i = 0; i < 3; ++i) {
      float vi = 0.0f;
      for (int k = 0; k < NQ; ++k) {
        const float J = pc[i].t[k] + (Rc[3 * i].t[k] * e[0] + Rc[3 * i + 1].t[k] * e[1] + Rc[3 * i + 2].t[k] * e[2]);
        Yx[i][k] = J;
        vi += J * qd[k];
      }
      v[i] = vi;
      bias[i] = w.p2[3 * b + i].dd +
                (w.R2[9 * b + 3 * i].dd * e[0] + w.R2[9 * b + 3 * i + 1].dd * e[1] + w.R2[9 * b + 3 * i + 2].dd * e[2]);
      forward_solve(w.L, Yx[i]);
    }
    float d, kk, bb;
    sol_kb(P + P_CON_SOLREF + 2 * c, P + P_CON_SOLIMP + 5 * c, pos, d, kk, bb);
    const float mu = P[P_CON_MU + c];
    const float muc = fmaxf(mu, 1.0f);
    const float Ann = dotq(Yx[2], Yx[2]);
    const float Rc_reg = fmaxf((1.0f - d) / d * 2.0f * muc * muc * (1.0f + muc * muc) * Ann, 1e-10f);
    for (int fct = 0; fct < 4; ++fct) {  // pyramid facets z + mu (s0 x + s1 y)
      const float s0 = fct == 0 ? 1.0f : (fct == 1 ? -1.0f : 0.0f);
      const float s1 = fct == 2 ? 1.0f : (fct == 3 ? -1.0f : 0.0f);
      float* Yr = w.Y + na * NQ;
      for (int k = 0; k < NQ; ++k) Yr[k] = Yx[2][k] + mu * (s0 * Yx[0][k] + s1 * Yx[1][k]);
      const float vel = v[2] + mu * (s0 * v[0] + s1 * v[1]);
      const float bs = bias[2] + mu * (s0 * bias[0] + s1 * bias[1]);
      const float aref = -bb * vel - kk * pos;
      w.g0[na] = dotq(Yr, z) + bs - aref;
      w.Rreg[na] = Rc_reg;
      ++na;
    }
  }

#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
    const int qi = I[I_LIM_QIDX + l];
    const float d_lo = q[qi] - P[P_LIM_LO + l];
    const float d_hi = P[P_LIM_HI + l] - q[qi];
    const float side = d_lo < d_hi ? 1.0f : -1.0f;  // +1: lower limit row
    const float dist = fminf(d_lo, d_hi);
    float d, kk, bb;
    sol_kb(P + P_LIM_SOLREF + 2 * l, P + P_LIM_SOLIMP + 5 * l, dist, d, kk, bb);
    float col[NQ];  // L^-1 e_qi; its squared norm is Minv[qi][qi]
    for (int k = 0; k < NQ; ++k) col[k] = k == qi ? 1.0f : 0.0f;
    forward_solve(w.L, col);
    const float reg = fmaxf((1.0f - d) / d * dotq(col, col), 1e-10f);
    if (!(dist < 0.0f)) {  // inactive: a zero row, but its regulariser still bounds the step
      lmax = fmaxf(lmax, reg);
      continue;
    }
    float* Yr = w.Y + na * NQ;
    for (int k = 0; k < NQ; ++k) Yr[k] = side * col[k];
    const float vel = side * qd[qi];
    const float aref = -bb * vel - kk * dist;
    w.g0[na] = dotq(Yr, z) - aref;
    w.Rreg[na] = reg;
    ++na;
  }
  if (na == 0) return;

  // Gershgorin bound of A + R over the active rows, A_rs = Y_r . Y_s
  for (int r = 0; r < na; ++r) w.rowsum[r] = w.Rreg[r];
#pragma unroll 1
  for (int r = 0; r < na; ++r) {
    float own = 0.0f;
    for (int s = r; s < na; ++s) {
      const float a = fabsf(dotq(w.Y + r * NQ, w.Y + s * NQ));
      own += a;
      if (s != r) w.rowsum[s] += a;
    }
    w.rowsum[r] += own;
    lmax = fmaxf(lmax, w.rowsum[r]);
  }
  const float Lip = lmax + 1e-8f;

  // accelerated projected gradient, fixed iterations
  for (int r = 0; r < na; ++r) { w.lam[r] = 0.0f; w.y[r] = 0.0f; }
  float t = 1.0f;
#pragma unroll 1
  for (int it = 0; it < n_iter; ++it) {
    float u[NQ];
    for (int k = 0; k < NQ; ++k) u[k] = 0.0f;
    for (int r = 0; r < na; ++r) {
      const float yr = w.y[r];
      for (int k = 0; k < NQ; ++k) u[k] += w.Y[r * NQ + k] * yr;
    }
    const float t_new = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
    const float beta = (t - 1.0f) / t_new;
    for (int r = 0; r < na; ++r) {
      const float grad = dotq(w.Y + r * NQ, u) + w.Rreg[r] * w.y[r] + w.g0[r];
      const float lam_new = fmaxf(w.y[r] - grad / Lip, 0.0f);
      w.y[r] = lam_new + beta * (lam_new - w.lam[r]);
      w.lam[r] = lam_new;
    }
    t = t_new;
  }

  // J^T lam = L (sum_r Y_r lam_r)
  float u[NQ];
  for (int k = 0; k < NQ; ++k) u[k] = 0.0f;
  for (int r = 0; r < na; ++r)
    for (int k = 0; k < NQ; ++k) u[k] += w.Y[r * NQ + k] * w.lam[r];
  for (int i = 0; i < NQ; ++i) {
    float s = 0.0f;
    for (int k = 0; k <= i; ++k) s += w.L[i * NQ + k] * u[k];
    f[i] += s;
  }
}

// one semi-implicit Euler substep
TT_BIG void substep(const float* __restrict__ P, const int* __restrict__ I, float* q, float* qd,
                    const float* tau_act, float dt, int n_iter, Work& w) {
  {
    Dual<NQ> qs[NQ];
    for (int k = 0; k < NQ; ++k) {
      set_const(qs[k], q[k]);
      qs[k].t[k] = 1.0f;
    }
    forward_kinematics(P, I, qs, w.p1, w.R1);
    to_com(P, w.p1, w.R1);
  }
  {
    Jet2 qs[NQ];
    for (int k = 0; k < NQ; ++k) qs[k] = Jet2{q[k], qd[k], 0.0f};
    forward_kinematics(P, I, qs, w.p2, w.R2);
    to_com(P, w.p2, w.R2);
  }

  const float visc = P[P_FLUID], dens = P[P_FLUID + 1];
  const bool has_fluid = visc > 0.0f || dens > 0.0f;
  float f[NQ];  // accumulates -c + gravity + fluid drag
  for (int k = 0; k < NQ; ++k) f[k] = 0.0f;
  for (int i = 0; i < NQ * NQ; ++i) w.M[i] = 0.0f;

#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    float Rv[9], Rd[9], Rdd[9];
    for (int i = 0; i < 9; ++i) {
      Rv[i] = w.R1[9 * b + i].v;
      Rd[i] = w.R2[9 * b + i].d;
      Rdd[i] = w.R2[9 * b + i].dd;
    }
    float* Jw = w.Jw + b * NQ * 3;
    for (int k = 0; k < NQ; ++k) {
      float dR[9], W[9];
      for (int i = 0; i < 9; ++i) dR[i] = w.R1[9 * b + i].t[k];
      mm33_abt(dR, Rv, W);
      vee33(W, Jw + 3 * k);
    }
    const float* Ib = P + P_BODY_INERTIA + 9 * b;
    float RI[9], Iw[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) RI[3 * i + j] = Rv[3 * i] * Ib[j] + Rv[3 * i + 1] * Ib[3 + j] + Rv[3 * i + 2] * Ib[6 + j];
    mm33_abt(RI, Rv, Iw);
    const float mass = P[P_BODY_MASS + b];
    // mass matrix, lower triangle
    for (int k = 0; k < NQ; ++k) {
      float IJ[3];
      mvf(Iw, Jw + 3 * k, IJ);
      const float jv[3] = {w.p1[3 * b].t[k], w.p1[3 * b + 1].t[k], w.p1[3 * b + 2].t[k]};
      for (int i = k; i < NQ; ++i) {
        const float lin = w.p1[3 * b].t[i] * jv[0] + w.p1[3 * b + 1].t[i] * jv[1] + w.p1[3 * b + 2].t[i] * jv[2];
        w.M[i * NQ + k] += mass * lin + dot3(Jw + 3 * i, IJ);
      }
    }
    // body wrench: -(m a, I alpha + w x I w) + gravity + fluid drag
    float W[9], omega[3], alpha[3], Iom[3], Ial[3];
    mm33_abt(Rd, Rv, W);
    vee33(W, omega);
    mm33_abt(Rdd, Rv, W);
    vee33(W, alpha);  // the symmetric Rd Rd^T drops out of vee
    mvf(Iw, omega, Iom);
    mvf(Iw, alpha, Ial);
    float force[3], torque[3];
    for (int i = 0; i < 3; ++i) force[i] = mass * P[P_GRAVITY + i] - mass * w.p2[3 * b + i].dd;
    torque[0] = -(Ial[0] + (omega[1] * Iom[2] - omega[2] * Iom[1]));
    torque[1] = -(Ial[1] + (omega[2] * Iom[0] - omega[0] * Iom[2]));
    torque[2] = -(Ial[2] + (omega[0] * Iom[1] - omega[1] * Iom[0]));
    if (has_fluid) {
      const float vcom[3] = {w.p2[3 * b].d, w.p2[3 * b + 1].d, w.p2[3 * b + 2].d};
      float vl[3], wl[3], Fl[3], Tl[3], Fw[3], Tw[3];
      mtvf(Rv, vcom, vl);  // world -> body
      mtvf(Rv, omega, wl);
      const float deq = P[P_FLUID_DEQ + b];
      for (int i = 0; i < 3; ++i) {
        Fl[i] = -3.0f * PI_F * visc * deq * vl[i];
        Tl[i] = -PI_F * visc * (deq * deq * deq) * wl[i];
        if (dens > 0.0f) {
          Fl[i] -= 0.5f * dens * P[P_FLUID_AREA + 3 * b + i] * fabsf(vl[i]) * vl[i];
          Tl[i] -= 0.5f * dens * P[P_FLUID_IT + 3 * b + i] * fabsf(wl[i]) * wl[i];
        }
      }
      mvf(Rv, Fl, Fw);
      mvf(Rv, Tl, Tw);
      for (int i = 0; i < 3; ++i) { force[i] += Fw[i]; torque[i] += Tw[i]; }
    }
    for (int k = 0; k < NQ; ++k) {
      const float jv[3] = {w.p1[3 * b].t[k], w.p1[3 * b + 1].t[k], w.p1[3 * b + 2].t[k]};
      f[k] += dot3(jv, force) + dot3(Jw + 3 * k, torque);
    }
  }
  for (int i = 0; i < NQ; ++i) {
    w.M[i * NQ + i] += P[P_ARMATURE + i];
    for (int k = 0; k < i; ++k) w.M[k * NQ + i] = w.M[i * NQ + k];
  }

  float D[NQ];
  for (int k = 0; k < NQ; ++k) {
    D[k] = P[P_DAMPING + k];
    f[k] += tau_act[k] - P[P_STIFFNESS + k] * (q[k] - P[P_SPRINGREF + k]);
  }
  if (NR > 0) constraint_force(P, I, q, qd, f, D, n_iter, w);

  // (M + dt diag(D)) qd' = M qd + dt f
  float rhs[NQ];
  for (int i = 0; i < NQ; ++i) {
    rhs[i] = dotq(w.M + i * NQ, qd) + dt * f[i];
    w.M[i * NQ + i] += dt * D[i];
  }
  cholesky(w.M, w.L);
  forward_solve(w.L, rhs);
  backward_solve(w.L, rhs);
  for (int k = 0; k < NQ; ++k) {
    qd[k] = rhs[k];
    q[k] += dt * rhs[k];
  }
}

// B(r) with omega = B(r) rdot, from the tangents of the exp map
TT_FN void rotvec_jacobian(const float* r, float* B) {
  Dual<3> rs[3], R[9];
  for (int k = 0; k < 3; ++k) {
    set_const(rs[k], r[k]);
    rs[k].t[k] = 1.0f;
  }
  rotvec_to_mat(rs, R);
  float Rv[9];
  for (int i = 0; i < 9; ++i) Rv[i] = R[i].v;
  for (int k = 0; k < 3; ++k) {
    float dR[9], W[9], wk[3];
    for (int i = 0; i < 9; ++i) dR[i] = R[i].t[k];
    mm33_abt(dR, Rv, W);
    vee33(W, wk);
    for (int i = 0; i < 3; ++i) B[3 * i + k] = wk[i];
  }
}

// keep free-joint rotation vectors in |r| <= pi (the exp map is singular at 2 pi)
TT_BIG void remap_free_rotations(const int* __restrict__ I, float* q, float* qd) {
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) {
    if (I[I_JOINT_TYPE + j] != JT_FREE) continue;
    const int i = I[I_JOINT_QIDX + j] + 3;
    float* r = q + i;
    float* rd = qd + i;
    const float norm = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + 1e-12f);
    if (!(norm > PI_F)) continue;
    const float scale = 1.0f - 2.0f * PI_F / norm;
    const float rn[3] = {r[0] * scale, r[1] * scale, r[2] * scale};
    float B0[9], B1[9], omega[3];
    rotvec_jacobian(r, B0);
    rotvec_jacobian(rn, B1);
    mvf(B0, rd, omega);
    // adjugate inverse of B1
    const float a = B1[0], b = B1[1], c = B1[2], d = B1[3], e = B1[4], f = B1[5], g = B1[6], h = B1[7], k = B1[8];
    const float co[9] = {e * k - f * h, c * h - b * k, b * f - c * e, f * g - d * k, a * k - c * g,
                         c * d - a * f, d * h - e * g, b * g - a * h, a * e - b * d};
    const float det = a * co[0] + b * co[3] + c * co[6];
    for (int m = 0; m < 3; ++m) {
      r[m] = rn[m];
      rd[m] = (co[3 * m] * omega[0] + co[3 * m + 1] * omega[1] + co[3 * m + 2] * omega[2]) / det;
    }
  }
}

// the whole step chain of one env
TT_FN void step_env(const float* __restrict__ P, const int* __restrict__ I, const float* q_in, const float* qd_in,
                    const float* ctrl, float* q_out, float* qd_out, int n_steps, float dt, int n_iter, int has_free,
                    Work& w) {
  float q[NQ], qd[NQ], tau[NQ];
  for (int k = 0; k < NQ; ++k) {
    q[k] = q_in[k];
    qd[k] = qd_in[k];
    tau[k] = 0.0f;
  }
  for (int u = 0; u < NU; ++u)
    tau[I[I_ACT_QIDX + u]] += P[P_GEAR + u] * fminf(fmaxf(ctrl[u], P[P_CTRL_LO + u]), P[P_CTRL_HI + u]);
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    substep(P, I, q, qd, tau, dt, n_iter, w);
    if (has_free) remap_free_rotations(I, q, qd);
  }
  for (int k = 0; k < NQ; ++k) {
    q_out[k] = q[k];
    qd_out[k] = qd[k];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32) fused_step_kernel(const float* __restrict__ P, const int* __restrict__ I,
                                                        const float* __restrict__ q_in, const float* __restrict__ qd_in,
                                                        const float* __restrict__ ctrl, float* __restrict__ q_out,
                                                        float* __restrict__ qd_out, int n_envs, int n_steps, float dt,
                                                        int n_iter, int has_free) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_envs) return;  // the ragged edge: no padding envs
  Work w;
  step_env(P, I, q_in + e * NQ, qd_in + e * NQ, ctrl + e * NU, q_out + e * NQ, qd_out + e * NQ, n_steps, dt, n_iter,
           has_free, w);
}
#endif

}  // namespace

// sizes this library was built for, and the lengths of the two constant arrays it expects
extern "C" void tt_physics_fused_signature(int* out) {
  const int sig[8] = {NQ, NB, NJ, NC, NL, NU, P_SIZE, I_SIZE};
  for (int i = 0; i < 8; ++i) out[i] = sig[i];
}

#ifdef __CUDACC__
extern "C" int tt_physics_fused(const void* P, int n_float, const void* I, int n_int, const void* q_in,
                                const void* qd_in, const void* ctrl, void* q_out, void* qd_out, int n_envs,
                                int n_steps, float dt, int n_iter, int has_free, int threads, void* stream) {
  // threads: envs per block, at most one warp; the wrapper picks it so that the blocks fill the SMs
  if (n_float != P_SIZE || n_int != I_SIZE || n_envs <= 0 || n_steps < 0 || n_iter < 0 || threads < 1 ||
      threads > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_envs + threads - 1) / threads;
  fused_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const int*>(I), static_cast<const float*>(q_in),
      static_cast<const float*>(qd_in), static_cast<const float*>(ctrl), static_cast<float*>(q_out),
      static_cast<float*>(qd_out), n_envs, n_steps, dt, n_iter, has_free);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int tt_physics_fused_host(const float* P, int n_float, const int* I, int n_int, const float* q_in,
                                     const float* qd_in, const float* ctrl, float* q_out, float* qd_out, int n_envs,
                                     int n_steps, float dt, int n_iter, int has_free) {
  if (n_float != P_SIZE || n_int != I_SIZE) return 1;
  Work* w = new Work;
  for (int e = 0; e < n_envs; ++e)
    step_env(P, I, q_in + e * NQ, qd_in + e * NQ, ctrl + e * NU, q_out + e * NQ, qd_out + e * NQ, n_steps, dt, n_iter,
             has_free, *w);
  delete w;
  return 0;
}
#endif
