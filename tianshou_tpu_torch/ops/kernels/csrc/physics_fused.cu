// Fused physics step: frame_skip x substeps semi-implicit Euler
// substeps of articulated rigid-body dynamics with MuJoCo-style soft-constraint
// contacts and joint limits, for a batch of independent envs, in ONE kernel.
//
// Replaces the TPU kernel tianshou_tpu/ops/pallas/physics_fused.py:fused_step
// (chain body _make_chain; the math is env/physics/batched.py:substep_b and
// _remap_free_b). That kernel is a traced program of lane-wide elementwise ops
// whose derivatives were taken by autodiff at trace time, with every candidate
// constraint row computed and the full [nr, nr] QP matrix formed per env. None
// of that carries over. Here a TEAM of LANES threads (a power of two, at most a
// warp) owns one env, a warp holds 32 / LANES envs, and the env's scratch lives
// in shared memory:
//
//  - Kinematics, one body per lane and one tree level at a time: pose, angular
//    and linear velocity, and the accelerations at qdd = 0 (the recursion of
//    the Newton-Euler forward pass: a hinge adds axis*qd to omega and
//    (omega x axis)*qd to alpha; a slide adds its Coriolis terms). A free joint
//    keeps the reference's rotation-vector chart: R, omega and alpha come from
//    a second-order jet of the exp map along (r, rd), and its angular Jacobian
//    B(r) from first-order duals; rotvec_to_mat keeps the reference's
//    EPS = 1e-9 so values and derivatives agree at r ~ 0.
//  - Jacobians are geometric and never stored. Each degree of freedom has a
//    world axis and, if it turns, an anchor: it moves the bodies below its
//    joint as a twist (omega = axis, v = axis x (point - anchor)), or as a
//    translation along the axis. M = sum_b m J_v^T J_v + J_w^T I J_w + armature
//    and f = sum_b J_v^T F_b + J_w^T T_b, with the body wrench F = m (g - a),
//    T = -(I alpha + w x I w) plus fluid drag (the Lagrangian bias force in any
//    chart, the rotation vector's included), are taken through composites:
//    lane B sums mass, first moment, inertia and wrench of the bodies below
//    body B about B's origin (offsets stay small however far the robot has
//    run), and then an entry M_ik is the momentum of the deeper dof's
//    composite under one twist, paired with the other: O(1), and 0 when
//    neither dof is below the other. A contact point's Jacobian row is formed
//    from axes and anchors where it is needed.
//  - Cholesky by rows over the lanes: lane i owns row i, and every lane works
//    out a column's pivot for itself, so a column costs one team sync; the
//    triangular solves multiply by the stored reciprocal pivots. The
//    right-hand side rides along as row NQ, so L^-1 rhs costs nothing extra;
//    the one back substitution per substep runs on one lane. The first of the
//    substep's two factorizations serves the constraint rows only and is
//    skipped when none is active.
//  - The contact QP without its matrix. With M = L L^T and Y_r = L^-1 J_r^T,
//    A = J M^-1 J^T = Y^T Y. Lanes test the contact spheres and limits in
//    parallel; one lane compacts the active ones in the reference's row order,
//    so nothing depends on timing. Only rows of ACTIVE contacts and limits are
//    built (an inactive row is zero in the reference and keeps lambda = 0): the
//    forward solves are independent, one lane each. The Gershgorin step bound
//    is one lane per row over every |A_rs|; with at most 16 active rows (the
//    usual case) those A_rs are kept, and an APGD iteration is
//    grad_r = A_r . y + R_r y_r + g0_r by lane r and one sync, over 16 terms
//    without a branch (zeros beyond the active rows). With more rows it is
//    u[k] = sum_r Y_r[k] y_r by lane k, a sync, grad_r = Y_r . u + ... by
//    lane r, a sync. The momentum weights are tabulated once per launch and
//    the step 1/L is one division per substep. Inactive rows still enter the
//    bound as the reference has them: their regulariser, clamped at 1e-10
//    (contacts) or (1-d)/d Minv_ii (limits).
//  - Memory. Work (below) is the per-env scratch in dynamic shared memory,
//    padded so that the teams of a warp fall on different banks; rows of odd
//    length keep a lane per row free of conflicts. It holds YCAP rows of Y; an
//    env with more active rows keeps the rest in a global scratch array the
//    wrapper passes in (Ant has 108 candidate rows and a handful active). No
//    row is dropped.
//  - Every element of every sum is computed by one lane in a fixed order, so
//    the result does not depend on LANES, on the envs that share a warp or on
//    timing. Every lane of a team takes the same branches, on values read from
//    shared memory; teams of one warp may diverge, so a team syncs with
//    __syncwarp(its own lanes).
//  - The legacy contact_model="penalty" (batched.py:substep_b with use_constraint false) is a compile-time
//    branch, -DTT_PENALTY=1: no QP and one factorization per substep. A body's lane adds its contact
//    spheres' spring-dampers (normal kp depth - kd v_z where the sphere dips into the floor, viscous
//    friction capped by mu fn) to the body's wrench, so they reach f through the composites as gravity
//    does; after M, a dof's lane adds its violated limit's spring (m_ii omega^2 viol, omega = 2 / 0.02) to
//    f and its damping 2 m_ii omega to the implicit integrator's diagonal. kp and kd come packed with the
//    model's constants (P_CON_KP).
//  - Sizes (NQ, NB, NJ, NC, NL, NU) are compile-time: one library per model
//    signature, built with -DNQ=.. etc.; -DTEAM= and -DYCAP= override the
//    defaults below. The model's constants come in as two device arrays (float
//    and int) in the layout below, packed by the wrapper from the model's
//    float64 tables, cast to float32 once.
//
// The per-env code is written as phases over lanes (TT_LANES) with team syncs
// (TT_SYNC) between them, and what crosses a sync lives in Work. So the file
// also compiles as plain C++ (g++ -x c++), where a phase runs its lanes in a
// loop and a sync is nothing: tt_physics_fused_host runs the same code on the
// CPU (-DTT_REVERSE_LANES runs the lanes of each phase in the opposite order:
// a phase that read what another lane wrote in it would then give another
// result).
//
// Bound on an H100 SXM: state in and out is a few hundred KB (0.1 us at
// 3.35 TB/s); the work is float32 operations outside the tensor cores
// (67 TFLOP/s). The kernel is far from that bound: its time is the length of
// a substep's chain of some 50 dependent phases. A lone warp pays about 25
// cycles for a taken branch, 50-70 for a division or square root, 45 for a
// round trip through shared memory and 90 for a team sync, so sums are
// unrolled and loops kept few; the 7-8 warps an SM holds at E = 2048 overlap
// only part of that. Measured times, and the cycles by phase from a
// -DTT_PROFILE build, are in PERF.md.
//
// No fast-math: IEEE division and square root, sincosf/powf in full
// precision. The kernel differs from the plain version by reassociation, FMA
// contraction and products with reciprocals (of the factor's pivots and of
// the solver's step bound) where the plain version divides.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, allocates nothing and returns the launch's error code.

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

#ifndef TT_PENALTY
#define TT_PENALTY 0
#endif

namespace {

// contact_model="penalty" (-DTT_PENALTY=1): no QP; contact spring-dampers in the body wrenches and joint-limit
// springs in the force, their damping in the implicit integrator
constexpr bool PENALTY = TT_PENALTY != 0;
constexpr int NR = PENALTY ? 0 : 4 * NC + NL;  // candidate QP rows
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
constexpr int P_CON_KP = P_FLUID + 2;                      // penalty contact stiffness, damping
constexpr int P_SIZE = P_CON_KP + 2;
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

template <class T> TT_FN void t_sincos(const T& a, T& sn, T& cs) {
  float s, c;
  sincosf(val(a), &s, &c);  // one range reduction for both
  sn = chain(a, s, c, -s);
  cs = chain(a, c, -s, -c);
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
  T sn, cs;
  t_sincos(t, sn, cs);
  const T a = sn * t_recip(t);
  const T b = (cs * -1.0f + 1.0f) * t_recip(t2e);
  T zero; set_const(zero, 0.0f);
  T k[9] = {zero, r[2] * -1.0f, r[1], r[2], zero, r[0] * -1.0f, r[1] * -1.0f, r[0], zero};
  T kk[9];
  mm33(k, k, kk);
  for (int i = 0; i < 9; ++i) R[i] = a * k[i] + b * kk[i] + ((i % 4 == 0) ? 1.0f : 0.0f);
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

TT_FN void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
// c += alpha x s + omega x (omega x s): acceleration of a point at offset s on a turning frame
TT_FN void add_point_accel(const float* al, const float* om, const float* s, float* c) {
  float a[3], os[3], oos[3];
  cross3(al, s, a);
  cross3(om, s, os);
  cross3(om, os, oos);
  for (int i = 0; i < 3; ++i) c[i] += a[i] + oos[i];
}

// (d, k, b) of MuJoCo's solref/solimp at violation pos
TT_FN void sol_kb(const float* solref, const float* solimp, float pos, float& d, float& k, float& b) {
  const float d0 = solimp[0], dmax = solimp[1], width = fmaxf(solimp[2], 1e-12f), mid = solimp[3], power = solimp[4];
  const float x = fminf(fmaxf(fabsf(pos) / width, 0.0f), 1.0f);
  // mid (x / mid)^power below mid, 1 - (1 - mid) ((1 - x) / (1 - mid))^power above: only the side that counts
  const bool below = x < mid;
  const float pw = powf(below ? x / mid : (1.0f - x) / (1.0f - mid), power);
  const float s = below ? mid * pw : 1.0f - (1.0f - mid) * pw;
  d = fminf(fmaxf(d0 + s * (dmax - d0), 1e-4f), 0.9999f);
  const float tau = solref[0], zeta = solref[1];
  k = d / (dmax * dmax * tau * tau * zeta * zeta);
  b = 2.0f / (dmax * tau);
}

// ---------------------------------------------------------------------------
// the team and its scratch
// ---------------------------------------------------------------------------
#ifdef TEAM
constexpr int LANES = TEAM;
#else  // the least power of two that gives each row of the augmented Cholesky its own lane
constexpr int LANES = NQ + 1 <= 4 ? 4 : (NQ + 1 <= 8 ? 8 : (NQ + 1 <= 16 ? 16 : 32));
#endif
static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0, "TEAM must be a power of two, at most 32");
static_assert(NB <= 32, "the subtree masks hold 32 bodies");

constexpr int NQP = NQ | 1;           // odd row length: a lane per row hits distinct banks
constexpr int ROWP = (NQP + 5) | 1;   // a QP row: Y_r [NQ], then the five scalars below
constexpr int R_REG = NQP, R_G0 = NQP + 1, R_LAM = NQP + 2, R_Y = NQP + 3, R_SUM = NQP + 4;
constexpr int NCA = NC > 0 ? NC : 1, NLA = NL > 0 ? NL : 1;
constexpr int AMAX = NRA < 16 ? NRA : 16;  // with at most AMAX active rows the QP matrix A = Y Y^T is kept
constexpr int AP = AMAX | 1;
constexpr int COMP = 16, C_M = 0, C_H = 1, C_I = 4, C_F = 10, C_T = 13;  // layout of a body's composite
constexpr int TT_N_PHASES = 11;  // see TT_PHASE; the names are in physics_fused.py:PHASES
constexpr int MAX_BETA = 32;  // solver iterations whose momentum weight is tabulated once per launch

// what an env needs besides its QP rows, in floats (kept in step with struct Work by a static_assert)
constexpr int FIXED_FLOATS = 7 * NQ + 24 * NB + 9 * NB + 9 * NB + 6 * NB + 6 * NQ + COMP * NB + NQ * NQP +
                             (NQ + 1) * NQP + NLA + 1 + MAX_BETA + 1 + AMAX * AP + 5 * AMAX + 3 * NQ + NB + 3 * NB + 2 + 2 * NCA + NLA + 2;
// rows kept in shared memory: all of them, or a multiple of four (a contact's four rows stay together)
#ifdef YCAP
constexpr int ROWS_FIT = YCAP < 4 ? 4 : (YCAP + 3) / 4 * 4;
#else  // as many as keep an env near 14 KB, so that an SM's 227 KB hold the 16 envs it gets at E = 2048
constexpr int ROWS_FIT = (3500 - FIXED_FLOATS) / ROWP < 8 ? 8 : (3500 - FIXED_FLOATS) / ROWP / 4 * 4;
#endif
constexpr int ROWS_CAP = ROWS_FIT >= NRA ? NRA : ROWS_FIT;
constexpr int EXT_FLOATS = (NRA - ROWS_CAP) * ROWP;  // per env, in the global scratch array

struct Work {
  float q[NQ], qd[NQ], tau[NQ], f[NQ], u[NQ], rhs[NQ];
  float invd[NQ];                // 1 / L[i][i] of the last factorization
  // per body: origin (o) and centre of mass (c) position, velocity and acceleration at qdd = 0,
  // rotation, angular velocity and acceleration
  float po[NB * 3], vo[NB * 3], ao[NB * 3], pc[NB * 3], vc[NB * 3], ac[NB * 3], om[NB * 3], al[NB * 3], R[NB * 9];
  float Iw[NB * 9];              // world-frame inertia about the centre of mass
  float wr[NB * 6];              // body wrench: force, torque
  float axis[NQ * 3], anchor[NQ * 3];  // per degree of freedom, world frame
  // per body, of the bodies below it and about its origin: mass, first moment, inertia (xx xy xz yy yz zz),
  // force, torque
  float comp[NB * COMP];
  float M[NQ * NQP];
  float L[(NQ + 1) * NQP];       // Cholesky factor; row NQ is L^-1 of the right-hand side
  float limreg[NLA];             // regulariser of each inactive limit row (0 for an active one)
  float lip;
  float beta[MAX_BETA], t_after;                 // the momentum weights of the first solver iterations
  // the small QP: matrix, y (two copies, read one, write one), lambda, regulariser and g0 of each row
  float A[AMAX * AP], ya[2 * AMAX], lama[AMAX], rega[AMAX], g0a[AMAX];
  float rows[ROWS_CAP * ROWP];   // the first ROWS_CAP active QP rows
  int dofBody[NQ], dofLin[NQ], dofSub[NQ];  // body of the dof's joint, 1 = translation, mask of the bodies it moves
  int bodySub[NB];                          // mask of the bodies below a body, itself included
  int depth[NB], lvlBody[NB], lvlStart[NB + 1], nlev;  // bodies sorted by tree depth
  int conFlag[NCA], acList[NCA], limRow[NLA], nac, na;  // active contacts in order; row of each limit or -1
};
static_assert(sizeof(Work) == 4 * (FIXED_FLOATS + ROWS_CAP * ROWP), "FIXED_FLOATS is out of step with struct Work");
// padded so that the 32 / LANES teams of a warp start LANES banks apart
constexpr int WORK_FLOATS = (FIXED_FLOATS + ROWS_CAP * ROWP + 31 - LANES % 32) / 32 * 32 + LANES % 32;

// -DTT_PROFILE: thread 0 of block 0 adds the cycles between the marks below to tt_cycles, by phase
// (scripts/torch_port_profile.py reads them; at a few envs, so that what shows is one warp's latency)
#if defined(__CUDACC__) && defined(TT_PROFILE)
__device__ long long tt_cycles[TT_N_PHASES];
__device__ long long tt_mark;
#define TT_PHASE(i)                                 \
  if (blockIdx.x == 0 && threadIdx.x == 0) {        \
    const long long now = clock64();                \
    if (i >= 0) tt_cycles[i < 0 ? 0 : i] += now - tt_mark; \
    tt_mark = now;                                  \
  }
#else
#define TT_PHASE(i)
#endif

struct Team {
  int lane;       // this thread's lane in its team (device)
  unsigned mask;  // the team's lanes within the warp (device)
};
#ifdef __CUDACC__
#define TT_LANES(l) for (int l = tm.lane, tt_end = tm.lane + 1; l < tt_end; ++l)
#define TT_SYNC() __syncwarp(tm.mask)
#elif defined(TT_REVERSE_LANES)
#define TT_LANES(l) for (int l = LANES - 1; l >= 0; --l)
#define TT_SYNC() ((void)0)
#else
#define TT_LANES(l) for (int l = 0; l < LANES; ++l)
#define TT_SYNC() ((void)0)
#endif

#ifdef __CUDACC__
#define TT_CTZ(x) (__ffs(static_cast<int>(x)) - 1)
#else
#define TT_CTZ(x) __builtin_ctz(x)
#endif

// f(row) on QP row r, and f(r, row) on rows 0..n-1 in order. A row lives in shared memory or, beyond
// ROWS_CAP, in the global scratch; each branch keeps its pointer's address space known to the compiler.
template <class F> TT_FN void with_row(Work& w, float* ext, int r, F f) {
  if (EXT_FLOATS == 0 || r < ROWS_CAP) {
    f(w.rows + r * ROWP);
  } else {
    f(ext + (r - ROWS_CAP) * ROWP);
  }
}
template <class F> TT_FN void for_rows(Work& w, float* ext, int n, F f) {
  const int n_shared = (EXT_FLOATS == 0 || n < ROWS_CAP) ? n : ROWS_CAP;
  for (int r = 0; r < n_shared; ++r) f(r, w.rows + r * ROWP);
  if (EXT_FLOATS > 0)
    for (int r = ROWS_CAP; r < n; ++r) f(r, ext + (r - ROWS_CAP) * ROWP);
}
TT_FN float dotq(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NQ; ++k) s += a[k] * b[k];
  return s;
}
// x <- L^-1 x with x in registers (every index is a compile-time constant once unrolled); a product with the
// reciprocal pivot keeps a division out of each step of the chain
TT_FN void forward_solve(const float* L, const float* invd, float* x) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i * NQP + k] * x[k];
    x[i] = s * invd[i];
  }
}

// ---------------------------------------------------------------------------
// phases of one env; P and I are the model's constants
// ---------------------------------------------------------------------------

// once per launch: state in, actuation, bodies by depth, the dof tables
TT_FN void setup_env(const float* __restrict__ P, const int* __restrict__ I, const float* q_in, const float* qd_in,
                     const float* ctrl, Work& w, const Team& tm) {
  TT_LANES(l) {
    for (int k = l; k < NQ; k += LANES) {
      w.q[k] = q_in[k];
      w.qd[k] = qd_in[k];
      for (int i = 0; i < 3; ++i) w.anchor[3 * k + i] = 0.0f;  // a translation has none; a turning dof writes its own
    }
    if (l == 0) {
      for (int k = 0; k < NQ; ++k) w.tau[k] = 0.0f;
      for (int u = 0; u < NU; ++u)
        w.tau[I[I_ACT_QIDX + u]] += P[P_GEAR + u] * fminf(fmaxf(ctrl[u], P[P_CTRL_LO + u]), P[P_CTRL_HI + u]);
      int nlev = 0;
      for (int b = 0; b < NB; ++b) {
        const int par = I[I_PARENT + b];
        w.depth[b] = par < 0 ? 0 : w.depth[par] + 1;
        nlev = w.depth[b] + 1 > nlev ? w.depth[b] + 1 : nlev;
        for (int j = I[I_BODY_JOINTS + b]; j < I[I_BODY_JOINTS + b + 1]; ++j) {
          const int i = I[I_JOINT_QIDX + j], type = I[I_JOINT_TYPE + j];
          if (type == JT_FREE) {
            for (int m = 0; m < 6; ++m) {
              w.dofBody[i + m] = b;
              w.dofLin[i + m] = m < 3;
            }
          } else {
            w.dofBody[i] = b;
            w.dofLin[i] = type == JT_SLIDE;
          }
        }
      }
      int pos = 0;
      for (int d = 0; d < nlev; ++d) {
        w.lvlStart[d] = pos;
        for (int b = 0; b < NB; ++b)
          if (w.depth[b] == d) w.lvlBody[pos++] = b;
      }
      w.lvlStart[nlev] = pos;
      w.nlev = nlev;
      float t = 1.0f;  // beta_n = (t_n - 1) / t_n+1, t_n+1 = (1 + sqrt(1 + 4 t_n^2)) / 2: the same for every substep
      for (int it = 0; it < MAX_BETA; ++it) {
        const float t_new = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
        w.beta[it] = (t - 1.0f) / t_new;
        t = t_new;
      }
      w.t_after = t;
    }
  }
  TT_SYNC();
  TT_LANES(l) {
    for (int top = l; top < NB; top += LANES) {  // the bodies below body top: parents come before children
      unsigned sub = 0;
      for (int b = top; b < NB; ++b) {
        const int par = I[I_PARENT + b];
        if (b == top || (par >= 0 && ((sub >> par) & 1u))) sub |= 1u << b;
      }
      w.bodySub[top] = static_cast<int>(sub);
    }
  }
  TT_SYNC();
  TT_LANES(l) {
    for (int k = l; k < NQ; k += LANES) w.dofSub[k] = w.bodySub[w.dofBody[k]];  // the bodies that dof k moves
  }
  TT_SYNC();
}

// pose, velocity and qdd = 0 acceleration of body b from its parent's; axis and anchor of its dofs
TT_BIG void body_kinematics(const float* __restrict__ P, const int* __restrict__ I, Work& w, int b) {
  const int js = I[I_BODY_JOINTS + b], je = I[I_BODY_JOINTS + b + 1];
  float pb[3], Rb[9], v[3], om[3], acc[3], al[3];
  if (je > js && I[I_JOINT_TYPE + js] == JT_FREE) {
    const int i = I[I_JOINT_QIDX + js];  // q holds the global pose (pos, rotvec)
    Jet2 r[3], Rj[9];
    for (int m = 0; m < 3; ++m) {
      pb[m] = w.q[i + m];
      v[m] = w.qd[i + m];
      acc[m] = 0.0f;
      r[m] = Jet2{w.q[i + 3 + m], w.qd[i + 3 + m], 0.0f};
    }
    rotvec_to_mat(r, Rj);
    float Rd[9], Rdd[9], W[9];
    for (int m = 0; m < 9; ++m) {
      Rb[m] = Rj[m].v;
      Rd[m] = Rj[m].d;
      Rdd[m] = Rj[m].dd;
    }
    mm33_abt(Rd, Rb, W);
    vee33(W, om);
    mm33_abt(Rdd, Rb, W);
    vee33(W, al);  // the symmetric Rd Rd^T drops out of vee
    float B[9];
    rotvec_jacobian(w.q + i + 3, B);
    for (int m = 0; m < 3; ++m)
      for (int c = 0; c < 3; ++c) {
        w.axis[3 * (i + m) + c] = c == m ? 1.0f : 0.0f;
        w.axis[3 * (i + 3 + m) + c] = B[3 * c + m];
        w.anchor[3 * (i + 3 + m) + c] = pb[c];
      }
  } else {
    const int par = I[I_PARENT + b];
    const float* bp = P + P_BODY_POS + 3 * b;
    const float* br = P + P_BODY_ROT + 9 * b;
    if (par < 0) {
      for (int i = 0; i < 3; ++i) {
        pb[i] = bp[i];
        v[i] = om[i] = acc[i] = al[i] = 0.0f;
      }
      for (int i = 0; i < 9; ++i) Rb[i] = br[i];
    } else {
      float off[3], ov[3];
      mvf(w.R + 9 * par, bp, off);
      mm33(w.R + 9 * par, br, Rb);
      for (int i = 0; i < 3; ++i) {
        om[i] = w.om[3 * par + i];
        al[i] = w.al[3 * par + i];
      }
      cross3(om, off, ov);
      for (int i = 0; i < 3; ++i) {
        pb[i] = w.po[3 * par + i] + off[i];
        v[i] = w.vo[3 * par + i] + ov[i];
        acc[i] = w.ao[3 * par + i];
      }
      add_point_accel(al, om, off, acc);
    }
#pragma unroll 1
    for (int j = js; j < je; ++j) {
      const int k = I[I_JOINT_QIDX + j];
      const float qi = w.q[k] + (-P[P_JOINT_REF + j]), qdi = w.qd[k];
      const float* ax = P + P_JOINT_AXIS + 3 * j;
      float aw[3], oa[3];
      mvf(Rb, ax, aw);  // the world axis, carried by the frame before the joint
      cross3(om, aw, oa);
      for (int i = 0; i < 3; ++i) w.axis[3 * k + i] = aw[i];
      if (I[I_JOINT_TYPE + j] == JT_SLIDE) {
        // p += aw q: v += aw qd + (om x aw) q, acc += (al x aw + om x (om x aw)) q + 2 (om x aw) qd
        float c[3] = {0.0f, 0.0f, 0.0f};
        add_point_accel(al, om, aw, c);
        for (int i = 0; i < 3; ++i) {
          pb[i] = pb[i] + aw[i] * qi;
          v[i] += aw[i] * qdi + oa[i] * qi;
          acc[i] += c[i] * qi + 2.0f * (oa[i] * qdi);
        }
      } else {  // hinge about the anchor: Rodrigues with a static axis; the anchor point stays where it is
        const float* an = P + P_JOINT_ANCHOR + 3 * j;
        float s0[3], os[3], cpt[3], cv[3], ca[3];
        mvf(Rb, an, s0);
        cross3(om, s0, os);
        for (int i = 0; i < 3; ++i) {
          cpt[i] = pb[i] + s0[i];
          cv[i] = v[i] + os[i];
          ca[i] = acc[i];
          w.anchor[3 * k + i] = cpt[i];
        }
        add_point_accel(al, om, s0, ca);
        const float kx[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
        float kk[9], Rj[9], Rn[9];
        mm33(kx, kx, kk);
        float s, c;
        sincosf(qi, &s, &c);
        const float omc = c * -1.0f + 1.0f;
        for (int i = 0; i < 9; ++i) Rj[i] = s * kx[i] + omc * kk[i] + ((i % 4 == 0) ? 1.0f : 0.0f);
        mm33(Rb, Rj, Rn);
        for (int i = 0; i < 9; ++i) Rb[i] = Rn[i];
        for (int i = 0; i < 3; ++i) {
          al[i] += oa[i] * qdi;  // with omega before the joint
          om[i] += aw[i] * qdi;
        }
        float s1[3], c1[3] = {0.0f, 0.0f, 0.0f};
        mvf(Rb, an, s1);
        cross3(om, s1, os);
        add_point_accel(al, om, s1, c1);
        for (int i = 0; i < 3; ++i) {
          pb[i] = cpt[i] - s1[i];
          v[i] = cv[i] - os[i];
          acc[i] = ca[i] - c1[i];
        }
      }
    }
  }
  float sc[3], osc[3];
  mvf(Rb, P + P_BODY_COM + 3 * b, sc);
  cross3(om, sc, osc);
  for (int i = 0; i < 3; ++i) {
    w.po[3 * b + i] = pb[i];
    w.vo[3 * b + i] = v[i];
    w.ao[3 * b + i] = acc[i];
    w.om[3 * b + i] = om[i];
    w.al[3 * b + i] = al[i];
    w.pc[3 * b + i] = pb[i] + sc[i];
    w.vc[3 * b + i] = v[i] + osc[i];
  }
  add_point_accel(al, om, sc, acc);
  for (int i = 0; i < 3; ++i) w.ac[3 * b + i] = acc[i];
  for (int i = 0; i < 9; ++i) w.R[9 * b + i] = Rb[i];
}

// the penalty model's force on contact sphere c (of body b) and its torque about b's centre of mass, added to
// force and torque: a spring-damper along z where the sphere dips below the floor, and viscous friction
// capped by the Coulomb cone
TT_FN void penalty_contact(const float* __restrict__ P, const Work& w, int b, int c, float* force, float* torque) {
  float re[3], ore[3], f[3], rxf[3];
  mvf(w.R + 9 * b, P + P_CON_E + 3 * c, re);
  cross3(w.om + 3 * b, re, ore);
  const float vx = w.vc[3 * b] + ore[0], vy = w.vc[3 * b + 1] + ore[1], vz = w.vc[3 * b + 2] + ore[2];
  const float kp = P[P_CON_KP], kd = P[P_CON_KP + 1];
  const float depth = P[P_CON_RADIUS + c] - (w.pc[3 * b + 2] + re[2]);
  const float fn = depth > 0.0f ? fmaxf(kp * depth - kd * vz, 0.0f) : 0.0f;
  const float speed = sqrtf(vx * vx + vy * vy + 1e-12f);
  const float ft = fminf(2.0f * kd * speed, P[P_CON_MU + c] * fn) / speed;
  f[0] = -vx * ft;
  f[1] = -vy * ft;
  f[2] = fn;
  cross3(re, f, rxf);
  for (int i = 0; i < 3; ++i) {
    force[i] += f[i];
    torque[i] += rxf[i];
  }
}

// world inertia and wrench of body b: -(m a, I alpha + w x I w) + gravity + fluid drag, and under the penalty
// model the forces of the body's contact spheres
TT_FN void body_wrench(const float* __restrict__ P, const int* __restrict__ I, Work& w, int b) {
  const float* Rv = w.R + 9 * b;
  const float* Ib = P + P_BODY_INERTIA + 9 * b;
  float RI[9], Iw[9];
  mm33(Rv, Ib, RI);
  mm33_abt(RI, Rv, Iw);
  for (int i = 0; i < 9; ++i) w.Iw[9 * b + i] = Iw[i];
  const float mass = P[P_BODY_MASS + b];
  const float* omega = w.om + 3 * b;
  float Iom[3], Ial[3], force[3], torque[3];
  mvf(Iw, omega, Iom);
  mvf(Iw, w.al + 3 * b, Ial);
  for (int i = 0; i < 3; ++i) force[i] = mass * P[P_GRAVITY + i] - mass * w.ac[3 * b + i];
  torque[0] = -(Ial[0] + (omega[1] * Iom[2] - omega[2] * Iom[1]));
  torque[1] = -(Ial[1] + (omega[2] * Iom[0] - omega[0] * Iom[2]));
  torque[2] = -(Ial[2] + (omega[0] * Iom[1] - omega[1] * Iom[0]));
  const float visc = P[P_FLUID], dens = P[P_FLUID + 1];
  if (visc > 0.0f || dens > 0.0f) {
    float vl[3], wl[3], Fl[3], Tl[3], Fw[3], Tw[3];
    mtvf(Rv, w.vc + 3 * b, vl);  // world -> body
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
    for (int i = 0; i < 3; ++i) {
      force[i] += Fw[i];
      torque[i] += Tw[i];
    }
  }
  if (PENALTY) {
#pragma unroll 1
    for (int c = 0; c < NC; ++c)
      if (I[I_CON_BODY + c] == b) penalty_contact(P, w, b, c, force, torque);
  }
  for (int i = 0; i < 3; ++i) {
    w.wr[6 * b + i] = force[i];
    w.wr[6 * b + 3 + i] = torque[i];
  }
}

// how dof k moves a point p - ref of a body below its joint: angular and linear velocity per unit qd
TT_FN void dof_twist(const Work& w, int k, const float* ref, float* om, float* v) {
  const float* a = w.axis + 3 * k;
  if (w.dofLin[k]) {
    for (int i = 0; i < 3; ++i) {
      om[i] = 0.0f;
      v[i] = a[i];
    }
  } else {
    const float d[3] = {ref[0] - w.anchor[3 * k], ref[1] - w.anchor[3 * k + 1], ref[2] - w.anchor[3 * k + 2]};
    cross3(a, d, v);
    for (int i = 0; i < 3; ++i) om[i] = a[i];
  }
}

// composite of the bodies below body top about top's origin, summed in body order
TT_FN void body_composite(const float* __restrict__ P, Work& w, int top) {
  float m = 0.0f, h[3] = {0.0f, 0.0f, 0.0f}, In[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float F[3] = {0.0f, 0.0f, 0.0f}, T[3] = {0.0f, 0.0f, 0.0f};
  unsigned sub = static_cast<unsigned>(w.bodySub[top]);
#pragma unroll 1
  while (sub) {
    const int b = TT_CTZ(sub);
    sub &= sub - 1;
    const float mb = P[P_BODY_MASS + b];
    const float d[3] = {w.pc[3 * b] - w.po[3 * top], w.pc[3 * b + 1] - w.po[3 * top + 1],
                        w.pc[3 * b + 2] - w.po[3 * top + 2]};
    const float* Ib = w.Iw + 9 * b;
    const float* Fb = w.wr + 6 * b;
    const float dd = dot3(d, d);
    float dxF[3];
    cross3(d, Fb, dxF);
    m += mb;
    In[0] += Ib[0] + mb * (dd - d[0] * d[0]);
    In[1] += Ib[1] - mb * (d[0] * d[1]);
    In[2] += Ib[2] - mb * (d[0] * d[2]);
    In[3] += Ib[4] + mb * (dd - d[1] * d[1]);
    In[4] += Ib[5] - mb * (d[1] * d[2]);
    In[5] += Ib[8] + mb * (dd - d[2] * d[2]);
    for (int i = 0; i < 3; ++i) {
      h[i] += mb * d[i];
      F[i] += Fb[i];
      T[i] += Fb[3 + i] + dxF[i];
    }
  }
  float* c = w.comp + COMP * top;
  c[C_M] = m;
  for (int i = 0; i < 3; ++i) {
    c[C_H + i] = h[i];
    c[C_F + i] = F[i];
    c[C_T + i] = T[i];
  }
  for (int i = 0; i < 6; ++i) c[C_I + i] = In[i];
}

// entries p, p + LANES, ... of the lower triangle of M (mirrored): the momentum of the deeper dof's composite
// under one dof's twist, paired with the other's; 0 when neither dof is below the other (a tree)
TT_FN void mass_entries(const float* __restrict__ P, Work& w, int first) {
#pragma unroll 1
  for (int p = first; p < NQ * (NQ + 1) / 2; p += LANES) {
    int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);  // row of entry p of the triangle
    i += (i + 1) * (i + 2) / 2 <= p;
    i -= i * (i + 1) / 2 > p;
    const int k = p - i * (i + 1) / 2;
    const int bi = w.dofBody[i], bk = w.dofBody[k];
    const bool i_below_k = (static_cast<unsigned>(w.dofSub[k]) >> bi) & 1u;
    float s = 0.0f;
    if (i_below_k || ((static_cast<unsigned>(w.dofSub[i]) >> bk) & 1u)) {
      const int top = i_below_k ? bi : bk;
      const float* c = w.comp + COMP * top;
      const float* h = c + C_H;
      const float* In = c + C_I;
      float om_i[3], v_i[3], om_k[3], v_k[3], oxh[3], hxv[3];
      dof_twist(w, i, w.po + 3 * top, om_i, v_i);
      dof_twist(w, k, w.po + 3 * top, om_k, v_k);
      cross3(om_k, h, oxh);
      cross3(h, v_k, hxv);
      float lin = 0.0f, ang = 0.0f;
      const float Io[3] = {In[0] * om_k[0] + In[1] * om_k[1] + In[2] * om_k[2],
                           In[1] * om_k[0] + In[3] * om_k[1] + In[4] * om_k[2],
                           In[2] * om_k[0] + In[4] * om_k[1] + In[5] * om_k[2]};
      for (int x = 0; x < 3; ++x) {
        lin += v_i[x] * (c[C_M] * v_k[x] + oxh[x]);
        ang += om_i[x] * (Io[x] + hxv[x]);
      }
      s = lin + ang;
    }
    if (i == k) s += P[P_ARMATURE + k];
    w.M[i * NQP + k] = s;
    w.M[k * NQP + i] = s;
  }
}

// entry k of f: the composite wrench below the dof's body through its twist, actuation and the spring
TT_FN void force_entry(const float* __restrict__ P, Work& w, int k) {
  const int top = w.dofBody[k];
  const float* c = w.comp + COMP * top;
  float om[3], v[3];
  dof_twist(w, k, w.po + 3 * top, om, v);
  w.f[k] = (dot3(v, c + C_F) + dot3(om, c + C_T)) + (w.tau[k] - P[P_STIFFNESS + k] * (w.q[k] - P[P_SPRINGREF + k]));
}

// the penalty model's joint-limit spring on dof k, added to w.f, and the dof's damping with the limit's,
// into damp: k = m_kk omega^2 and d = 2 m_kk omega (omega = 2 / 0.02, m_kk the diagonal of M with armature)
// where the limit is violated
TT_FN void penalty_limit(const float* __restrict__ P, const int* __restrict__ I, Work& w, float* damp, int k) {
  float d_k = P[P_DAMPING + k];
#pragma unroll 1
  for (int m = 0; m < NL; ++m) {
    if (I[I_LIM_QIDX + m] != k) continue;
    const float omega = 2.0f / 0.02f;
    const float m_kk = w.M[k * NQP + k];
    const float k_lim = m_kk * omega * omega, d_lim = 2.0f * m_kk * omega;
    const float viol_hi = fmaxf(w.q[k] - P[P_LIM_HI + m], 0.0f), viol_lo = fmaxf(P[P_LIM_LO + m] - w.q[k], 0.0f);
    w.f[k] += -k_lim * viol_hi + k_lim * viol_lo;
    if (viol_hi > 0.0f || viol_lo > 0.0f) d_k += d_lim;
  }
  damp[k] = d_k;
}

// L <- the Cholesky factor of M (lower part read), row NQ of L <- L^-1 w.rhs, invd <- 1 / diag(L). Lane i owns
// row i. Every lane works out the pivot of column j for itself from row j, to the same bits, so a column
// costs one team sync. (Two columns per sync, with the entry between the pivots also worked out by every
// lane, measured no faster.) Columns and sums are unrolled: a loop iteration costs a lone warp some 25
// cycles, a sum's term 4.
TT_FN void cholesky_with_rhs(Work& w, const Team& tm) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    TT_LANES(l) {
      const float* Lj = w.L + j * NQP;
      float d = w.M[j * NQP + j];
#pragma unroll
      for (int k = 0; k < j; ++k) d -= Lj[k] * Lj[k];
      d = sqrtf(fmaxf(d, 1e-30f));
      const float inv = 1.0f / d;
#pragma unroll 1
      for (int i = j + 1 + ((l - j - 1) & (LANES - 1)); i <= NQ; i += LANES) {  // this lane's rows below j
        float s = i < NQ ? w.M[i * NQP + j] : w.rhs[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= w.L[i * NQP + k] * Lj[k];
        w.L[i * NQP + j] = s * inv;
      }
      if (l == (j & (LANES - 1))) {
        w.L[j * NQP + j] = d;
        w.invd[j] = inv;
      }
    }
    TT_SYNC();
  }
}

// which contact spheres and limits are active, and their rows: w.acList, w.limRow, w.nac, w.na
TT_FN void active_set(const float* __restrict__ P, const int* __restrict__ I, Work& w, const Team& tm) {
  TT_LANES(l) {
    for (int c = l; c < NC; c += LANES) {
      const float* Rc = w.R + 9 * I[I_CON_BODY + c];
      const float* e = P + P_CON_E + 3 * c;
      const float xz = w.pc[3 * I[I_CON_BODY + c] + 2] + (Rc[6] * e[0] + Rc[7] * e[1] + Rc[8] * e[2]);
      w.conFlag[c] = xz - P[P_CON_RADIUS + c] < P[P_CON_MARGIN + c];
    }
    for (int m = l; m < NL; m += LANES) {
      const float qv = w.q[I[I_LIM_QIDX + m]];
      w.limRow[m] = fminf(qv - P[P_LIM_LO + m], P[P_LIM_HI + m] - qv) < 0.0f;
    }
  }
  TT_SYNC();
  // their rows, in the reference's order: four per contact, then the limits
  TT_LANES(l) {
    if (l == 0) {
      int nac = 0, na = 0;
      for (int c = 0; c < NC; ++c)
        if (w.conFlag[c]) w.acList[nac++] = c;
      na = 4 * nac;
      for (int m = 0; m < NL; ++m) w.limRow[m] = w.limRow[m] ? na++ : -1;
      w.nac = nac;
      w.na = na;
    }
  }
  TT_SYNC();
}

// beta of solver iteration it: from the table, or computed on from t beyond it
TT_FN float momentum_weight(const Work& w, int it, float& t) {
  if (it < MAX_BETA) return w.beta[it];
  const float t_new = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
  const float beta = (t - 1.0f) / t_new;
  t = t_new;
  return beta;
}

// generalized constraint force of the active contact and limit rows (at least one), added to w.f;
// w.L holds the factor of M and, in row NQ, z = L^-1 (f - D qd): a0_r = Y_r . z
TT_FN void constraint_force(const float* __restrict__ P, const int* __restrict__ I, int n_iter, Work& w, float* ext,
                            const Team& tm) {
  const float* z = w.L + NQ * NQP;
  const int nac = w.nac, na = w.na;
  // forward solves, one lane each: every limit's L^-1 e_qi, and L^-1 of the three Jacobian rows of each
  // active contact (kept in the contact's first three rows until the facets are formed)
  TT_LANES(l) {
#pragma unroll 1
    for (int job = l; job < NL + 3 * nac; job += LANES) {
      float x[NQ];
      if (job < NL) {
        const int qi = I[I_LIM_QIDX + job];
#pragma unroll
        for (int k = 0; k < NQ; ++k) x[k] = k == qi ? 1.0f : 0.0f;
      } else {
        const int c = w.acList[(job - NL) / 3], i = (job - NL) % 3, b = I[I_CON_BODY + c];
        float re[3], xc[3];
        mvf(w.R + 9 * b, P + P_CON_E + 3 * c, re);
        for (int m = 0; m < 3; ++m) xc[m] = w.pc[3 * b + m] + re[m];
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
        for (int k = 0; k < NQ; ++k) {  // component i of how dof k moves the contact point
          const float* a = w.axis + 3 * k;
          const float* an = w.anchor + 3 * k;
          const float turn = a[i1] * (xc[i2] - an[i2]) - a[i2] * (xc[i1] - an[i1]);
          x[k] = ((static_cast<unsigned>(w.dofSub[k]) >> b) & 1u) ? (w.dofLin[k] ? a[i] : turn) : 0.0f;
        }
      }
      forward_solve(w.L, w.invd, x);
      if (job < NL) {
        const int qi = I[I_LIM_QIDX + job];
        const float d_lo = w.q[qi] - P[P_LIM_LO + job];
        const float d_hi = P[P_LIM_HI + job] - w.q[qi];
        const float side = d_lo < d_hi ? 1.0f : -1.0f;  // +1: lower limit row
        const float dist = fminf(d_lo, d_hi);
        float d, kk, bb;
        sol_kb(P + P_LIM_SOLREF + 2 * job, P + P_LIM_SOLIMP + 5 * job, dist, d, kk, bb);
        const float reg = fmaxf((1.0f - d) / d * dotq(x, x), 1e-10f);  // |L^-1 e_qi|^2 = Minv[qi][qi]
        const int r = w.limRow[job];
        w.limreg[job] = r < 0 ? reg : 0.0f;  // inactive: a zero row, but its regulariser still bounds the step
        if (r >= 0) {
          const float aref = -bb * (side * w.qd[qi]) - kk * dist;
          with_row(w, ext, r, [&](float* row) {
#pragma unroll
            for (int k = 0; k < NQ; ++k) row[k] = side * x[k];
            row[R_G0] = dotq(row, z) - aref;
            row[R_REG] = reg;
          });
        }
      } else {
        with_row(w, ext, 4 * ((job - NL) / 3) + (job - NL) % 3, [&](float* row) {
#pragma unroll
          for (int k = 0; k < NQ; ++k) row[k] = x[k];
        });
      }
    }
  }
  TT_SYNC();
  TT_PHASE(5);
  // per active contact: regulariser and the part of g0 that does not need the facet rows
  TT_LANES(l) {
#pragma unroll 1
    for (int m = l; m < nac; m += LANES) {
      const int c = w.acList[m], b = I[I_CON_BODY + c];
      float re[3], v[3], bias[3], ore[3];
      mvf(w.R + 9 * b, P + P_CON_E + 3 * c, re);
      cross3(w.om + 3 * b, re, ore);
      for (int i = 0; i < 3; ++i) {
        v[i] = w.vc[3 * b + i] + ore[i];
        bias[i] = w.ac[3 * b + i];
      }
      add_point_accel(w.al + 3 * b, w.om + 3 * b, re, bias);
      const float pos = (w.pc[3 * b + 2] + re[2]) - P[P_CON_RADIUS + c] - P[P_CON_MARGIN + c];
      float d, kk, bb;
      sol_kb(P + P_CON_SOLREF + 2 * c, P + P_CON_SOLIMP + 5 * c, pos, d, kk, bb);
      const float mu = P[P_CON_MU + c];
      const float muc = fmaxf(mu, 1.0f);
      with_row(w, ext, 4 * m, [&](float* rows4) {  // a contact's four rows lie together
        const float* Yn = rows4 + 2 * ROWP;
        const float Ann = dotq(Yn, Yn);
        const float reg = fmaxf((1.0f - d) / d * 2.0f * muc * muc * (1.0f + muc * muc) * Ann, 1e-10f);
        for (int fct = 0; fct < 4; ++fct) {  // pyramid facets z + mu (s0 x + s1 y)
          const float s0 = fct == 0 ? 1.0f : (fct == 1 ? -1.0f : 0.0f);
          const float s1 = fct == 2 ? 1.0f : (fct == 3 ? -1.0f : 0.0f);
          const float vel = v[2] + mu * (s0 * v[0] + s1 * v[1]);
          const float bs = bias[2] + mu * (s0 * bias[0] + s1 * bias[1]);
          rows4[fct * ROWP + R_G0] = bs - (-bb * vel - kk * pos);
          rows4[fct * ROWP + R_REG] = reg;
        }
      });
    }
  }
  TT_SYNC();
  // the facet rows, in place: entry k of a contact's four rows from entry k of its three
  TT_LANES(l) {
    for (int idx = l; idx < nac * NQ; idx += LANES) {
      const int m = idx / NQ, k = idx % NQ;
      const float mu = P[P_CON_MU + w.acList[m]];
      with_row(w, ext, 4 * m, [&](float* rows4) {
        const float yx = rows4[k], yy = rows4[ROWP + k], yn = rows4[2 * ROWP + k];
        rows4[k] = yn + mu * yx;
        rows4[ROWP + k] = yn + mu * -yx;
        rows4[2 * ROWP + k] = yn + mu * yy;
        rows4[3 * ROWP + k] = yn + mu * -yy;
      });
    }
  }
  TT_SYNC();
  // g0 of the contact rows; Gershgorin row sums of A + R over the active rows, A_rs = Y_r . Y_s
  const bool small = na <= AMAX;
  TT_LANES(l) {
#pragma unroll 1
    for (int r = l; r < na; r += LANES) {
      with_row(w, ext, r, [&](float* row) {
        float x[NQ];
#pragma unroll
        for (int k = 0; k < NQ; ++k) x[k] = row[k];
        if (r < 4 * nac) row[R_G0] = dotq(x, z) + row[R_G0];
        float sum = row[R_REG];
        for_rows(w, ext, na, [&](int s, const float* other) {
          const float a = dotq(x, other);
          if (small) w.A[r * AP + s] = a;
          sum += fabsf(a);
        });
        row[R_SUM] = sum;
        row[R_LAM] = 0.0f;
        row[R_Y] = 0.0f;
        if (small) {  // zeros beyond na, so that the solver's sums run over AMAX terms without a branch
#pragma unroll
          for (int s = 0; s < AMAX; ++s)
            if (s >= na) w.A[r * AP + s] = 0.0f;
          w.lama[r] = 0.0f;
          w.rega[r] = row[R_REG];
          w.g0a[r] = row[R_G0];
        }
      });
    }
    if (small)
      for (int s = l; s < 2 * AMAX; s += LANES) w.ya[s] = 0.0f;
  }
  TT_SYNC();
  TT_LANES(l) {
    if (l == 0) {
      float lmax = 1e-10f;  // the clamped regulariser of an inactive contact row
      for (int m = 0; m < NL; ++m) lmax = fmaxf(lmax, w.limreg[m]);
      for_rows(w, ext, na, [&](int, const float* row) { lmax = fmaxf(lmax, row[R_SUM]); });
      w.lip = lmax + 1e-8f;
    }
  }
  TT_SYNC();
  TT_PHASE(6);
  const float inv_lip = 1.0f / w.lip;  // the step; one division per substep instead of one per row and iteration

  // accelerated projected gradient, fixed iterations. Small QP: grad = A y + R y + g0, one lane per row and
  // one sync per iteration. Else without the matrix: u = sum_r Y_r y_r by lane k, grad_r = Y_r . u by lane r.
  float t = w.t_after;  // used beyond the table only
  int cur = 0;
#pragma unroll 1
  for (int it = 0; small && it < n_iter; ++it) {
    const float beta = momentum_weight(w, it, t);
    TT_LANES(l) {
      const float* y = w.ya + cur * AMAX;
      for (int r = l; r < na; r += LANES) {
        float even = 0.0f, odd = 0.0f;  // two chains of half the length; terms beyond na are 0 * 0
#pragma unroll
        for (int s = 0; s + 1 < AMAX; s += 2) {
          even += w.A[r * AP + s] * y[s];
          odd += w.A[r * AP + s + 1] * y[s + 1];
        }
        if (AMAX % 2) even += w.A[r * AP + AMAX - 1] * y[AMAX - 1];
        const float grad = (even + odd) + w.rega[r] * y[r] + w.g0a[r];
        const float lam_new = fmaxf(y[r] - grad * inv_lip, 0.0f);
        w.ya[(cur ^ 1) * AMAX + r] = lam_new + beta * (lam_new - w.lama[r]);
        w.lama[r] = lam_new;
      }
    }
    TT_SYNC();
    cur ^= 1;
  }
#pragma unroll 1
  for (int it = 0; !small && it < n_iter; ++it) {
    TT_LANES(l) {
      for (int k = l; k < NQ; k += LANES) {
        float s = 0.0f;
        for_rows(w, ext, na, [&](int, const float* row) { s += row[k] * row[R_Y]; });
        w.u[k] = s;
      }
    }
    TT_SYNC();
    const float beta = momentum_weight(w, it, t);
    TT_LANES(l) {
      for (int r = l; r < na; r += LANES) {
        with_row(w, ext, r, [&](float* row) {
          const float grad = dotq(row, w.u) + row[R_REG] * row[R_Y] + row[R_G0];
          const float lam_new = fmaxf(row[R_Y] - grad * inv_lip, 0.0f);
          row[R_Y] = lam_new + beta * (lam_new - row[R_LAM]);
          row[R_LAM] = lam_new;
        });
      }
    }
    TT_SYNC();
  }

  TT_PHASE(7);
  // J^T lam = L (sum_r Y_r lam_r)
  TT_LANES(l) {
    for (int k = l; k < NQ; k += LANES) {
      float s = 0.0f;
      for_rows(w, ext, na, [&](int r, const float* row) { s += row[k] * (small ? w.lama[r] : row[R_LAM]); });
      w.u[k] = s;
    }
  }
  TT_SYNC();
  TT_LANES(l) {
    for (int i = l; i < NQ; i += LANES) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < NQ; ++k)
        if (k <= i) s += w.L[i * NQP + k] * w.u[k];
      w.f[i] += s;
    }
  }
  TT_SYNC();
  TT_PHASE(8);
}

// keep free-joint rotation vectors in |r| <= pi (the exp map is singular at 2 pi); one lane
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

// one semi-implicit Euler substep of the env whose state is in w.q, w.qd
TT_FN void substep(const float* __restrict__ P, const int* __restrict__ I, float dt, int n_iter, int has_free, Work& w,
                   float* ext, const Team& tm) {
  const int nlev = w.nlev;
  TT_PHASE(-1);
#pragma unroll 1
  for (int d = 0; d < nlev; ++d) {  // a body per lane, parents before children
    TT_LANES(l) {
      for (int x = w.lvlStart[d] + l; x < w.lvlStart[d + 1]; x += LANES) body_kinematics(P, I, w, w.lvlBody[x]);
    }
    TT_SYNC();
  }
  TT_PHASE(0);
  TT_LANES(l) {
    for (int b = l; b < NB; b += LANES) body_wrench(P, I, w, b);
  }
  TT_SYNC();
  TT_LANES(l) {
    for (int b = l; b < NB; b += LANES) body_composite(P, w, b);
  }
  TT_SYNC();
  TT_PHASE(1);
  TT_LANES(l) {
    mass_entries(P, w, l);
    for (int k = l; k < NQ; k += LANES) force_entry(P, w, k);
  }
  TT_SYNC();
  // the damping of each dof in the implicit integrator: the joint's, and under the penalty model a violated
  // limit's (kept in w.u, which only the QP uses)
  float* damp = w.u;
  if (PENALTY) {
    TT_LANES(l) {
      for (int k = l; k < NQ; k += LANES) penalty_limit(P, I, w, damp, k);
    }
    TT_SYNC();
  }
  TT_PHASE(2);
  // two factorizations through one copy of the code: of M with z = L^-1 (f - D qd) for the constraint
  // rows (not needed when no row is active: an inactive row's force is zero), then of M + dt diag(D)
  // with the right-hand side of (M + dt diag(D)) qd' = M qd + dt f
  if (NR > 0) active_set(P, I, w, tm);
  TT_PHASE(3);
#pragma unroll 1
  for (int pass = NR > 0 && w.na > 0 ? 0 : 1; pass < 2; ++pass) {
    TT_LANES(l) {
      for (int i = l; i < NQ; i += LANES) {
        if (pass == 0) {
          w.rhs[i] = w.f[i] - P[P_DAMPING + i] * w.qd[i];
        } else {
          w.rhs[i] = dotq(w.M + i * NQP, w.qd) + dt * w.f[i];
          w.M[i * NQP + i] += dt * (PENALTY ? damp[i] : P[P_DAMPING + i]);
        }
      }
    }
    TT_SYNC();
    cholesky_with_rhs(w, tm);
    TT_PHASE(pass == 0 ? 4 : 9);
    if (pass == 0) constraint_force(P, I, n_iter, w, ext, tm);
  }
  TT_LANES(l) {
    if (l == 0) {  // x <- L^-T (L^-1 rhs), in registers
      float x[NQ];
#pragma unroll
      for (int i = NQ - 1; i >= 0; --i) {
        float s = w.L[NQ * NQP + i];
#pragma unroll
        for (int k = i + 1; k < NQ; ++k) s -= w.L[k * NQP + i] * x[k];
        x[i] = s * w.invd[i];
      }
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        w.qd[k] = x[k];
        w.q[k] += dt * x[k];
      }
      if (has_free) remap_free_rotations(I, w.q, w.qd);
    }
  }
  TT_SYNC();
  TT_PHASE(10);
}

// the whole step chain of one env
TT_FN void step_env(const float* __restrict__ P, const int* __restrict__ I, const float* q_in, const float* qd_in,
                    const float* ctrl, float* q_out, float* qd_out, int n_steps, float dt, int n_iter, int has_free,
                    Work& w, float* ext, const Team& tm) {
  setup_env(P, I, q_in, qd_in, ctrl, w, tm);
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) substep(P, I, dt, n_iter, has_free, w, ext, tm);
  TT_LANES(l) {
    for (int k = l; k < NQ; k += LANES) {
      q_out[k] = w.q[k];
      qd_out[k] = w.qd[k];
    }
  }
}

#ifdef __CUDACC__
// blockDim.x = LANES * (envs per block); dynamic shared memory: one padded Work per env of the block
__global__ void __launch_bounds__(256) fused_step_kernel(const float* __restrict__ P, const int* __restrict__ I,
                                                         const float* __restrict__ q_in, const float* __restrict__ qd_in,
                                                         const float* __restrict__ ctrl, float* __restrict__ q_out,
                                                         float* __restrict__ qd_out, float* __restrict__ ext, int n_envs,
                                                         int n_steps, float dt, int n_iter, int has_free) {
  extern __shared__ float tt_smem[];
  const int slot = threadIdx.x / LANES;
  const int e = blockIdx.x * (blockDim.x / LANES) + slot;
  if (e >= n_envs) return;  // the ragged edge: a whole team leaves, and no barrier is wider than a team
  Team tm;
  tm.lane = threadIdx.x % LANES;
  tm.mask = LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u) << ((threadIdx.x % 32) / LANES * LANES);
  Work& w = *reinterpret_cast<Work*>(tt_smem + slot * WORK_FLOATS);
  step_env(P, I, q_in + e * NQ, qd_in + e * NQ, ctrl + e * NU, q_out + e * NQ, qd_out + e * NQ, n_steps, dt, n_iter,
           has_free, w, ext + static_cast<int64_t>(e) * EXT_FLOATS, tm);
}
#endif

}  // namespace

// the sizes this library was built for, the lengths of the two constant arrays it expects, the lanes of a team,
// the QP rows an env keeps in shared memory, an env's shared memory in bytes, and the floats of global scratch
// an env needs for the rows beyond (0 when every candidate row fits)
extern "C" void tt_physics_fused_signature(int* out) {
  const int sig[12] = {NQ, NB, NJ, NC, NL, NU, P_SIZE, I_SIZE, LANES, ROWS_CAP, 4 * WORK_FLOATS, EXT_FLOATS};
  for (int i = 0; i < 12; ++i) out[i] = sig[i];
}

#if defined(__CUDACC__) && defined(TT_PROFILE)
// copies the cycles per phase to out [TT_N_PHASES] and zeroes them; synchronizes the device
extern "C" int tt_physics_fused_cycles(long long* out) {
  const long long zero[TT_N_PHASES] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(out, tt_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tt_cycles, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

#ifdef __CUDACC__
extern "C" int tt_physics_fused(const void* P, int n_float, const void* I, int n_int, const void* q_in,
                                const void* qd_in, const void* ctrl, void* q_out, void* qd_out, void* ext, int n_envs,
                                int n_steps, float dt, int n_iter, int has_free, int envs_per_block, void* stream) {
  constexpr int kMaxShared = 232448;  // 227 KB, what a block may use on sm_90
  static unsigned raised = 0;         // dynamic shared memory above 48 KB must be asked for, once per device
  const int64_t shared = static_cast<int64_t>(envs_per_block) * 4 * WORK_FLOATS;
  if (n_float != P_SIZE || n_int != I_SIZE || n_envs <= 0 || n_steps < 0 || n_iter < 0 || envs_per_block < 1 ||
      envs_per_block * LANES > 256 || shared > kMaxShared || (EXT_FLOATS > 0 && ext == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && !((raised >> (device & 31)) & 1u)) {
    err = cudaFuncSetAttribute(fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err == cudaSuccess) raised |= 1u << (device & 31);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_envs + envs_per_block - 1) / envs_per_block;
  fused_step_kernel<<<blocks, envs_per_block * LANES, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const int*>(I), static_cast<const float*>(q_in),
      static_cast<const float*>(qd_in), static_cast<const float*>(ctrl), static_cast<float*>(q_out),
      static_cast<float*>(qd_out), static_cast<float*>(ext), n_envs, n_steps, dt, n_iter, has_free);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int tt_physics_fused_host(const float* P, int n_float, const int* I, int n_int, const float* q_in,
                                     const float* qd_in, const float* ctrl, float* q_out, float* qd_out, int n_envs,
                                     int n_steps, float dt, int n_iter, int has_free) {
  if (n_float != P_SIZE || n_int != I_SIZE) return 1;
  Work* w = new Work;
  float* ext = new float[EXT_FLOATS + 1];
  const Team tm = {0, 0u};
  for (int e = 0; e < n_envs; ++e)
    step_env(P, I, q_in + e * NQ, qd_in + e * NQ, ctrl + e * NU, q_out + e * NQ, qd_out + e * NQ, n_steps, dt, n_iter,
             has_free, *w, ext, tm);
  delete[] ext;
  delete w;
  return 0;
}
#endif
