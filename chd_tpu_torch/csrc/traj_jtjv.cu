// Gauss-Newton products of the kinematic trajectory residual for Hopper:
// out[m, b] = J_bᵀ J_b v[m, b] at the linearization point x, or the exact
// diagonal of J_bᵀ J_b, for the residual of
// kinematics/residuals.py::trajectory_residuals.
//
// Replaces no TPU kernel: chd_tpu's LM (chd_tpu/kinematics/lm.py) forms the
// product by jax.linearize and jax.linear_transpose, which XLA fuses. The
// port formed it by a double vjp through torch.func, ~519 small kernels a
// product at 16 x 100 frames (PERF.md), so a replayed LM step of 80 CG
// iterations spent ~175 ms launching and running elementwise kernels of a
// few microseconds each. kinematics/jtjv.py is the wrapper and holds a
// plain-torch emulation of this file's algorithm (traj_jtjv_plain), which
// the CPU tests hold against autograd.
//
// What bounds it: one product at 16 x 100 frames, 28 joints and 87 dofs a
// frame reads x, v and the problem data (~3 MB in float32) and writes
// 0.56 MB, ~1 µs of HBM traffic; the FK at x, its tangent and its transpose
// are ~20-40 kFLOP a frame, ~1 µs of the card's float32 rate. The work is a
// chain of seven dependent tree levels a pass, so the kernel is bound by
// latency: its design keeps every level's exchange inside one warp.
//
// The design:
// - A warp is one frame and a lane one skeleton joint (lane j: joint j,
//   lane 31: the root translation), so FK walks the tree's depth levels as
//   core/fk.py does, each child reading its parent's values by a warp
//   shuffle; no level needs a barrier. Quaternions follow core/quat.py's
//   formulas (Hamilton product, v + 2w(u×v) + 2u×(u×v), the euler axis
//   quaternions with from_angle_axis's 1/(1 + 1e-10)), and the tangent and
//   transpose are derived by hand from them.
// - Product mode: a block is one (tangent m, sequence b, tile of kTile
//   frames) and holds kTile + 2 kHalo warps, because the acceleration term
//   couples frames f..f+2. Every warp recomputes its frame's FK at x and
//   its tangent, and puts the data-order joint tangents (the root slot holds
//   the root translation's) in shared memory. After one barrier, each of
//   the tile's own frames forms, per data-order joint (lane k), the
//   cotangent of the seven residual blocks' tangents with the weights and
//   frame_mask products of residuals.py, reading its neighbours' tangents
//   from shared memory; then the warp runs the transpose through the tree,
//   deepest level first, a parent summing its children in a fixed order.
// - Diagonal mode: a warp is one (sequence, frame, group of dofs) and
//   computes, for each of its dofs d, ‖J e_d‖², which is what lm.py's
//   coloring masks give as Σₖ mₖ ⊙ JᵀJ mₖ (no residual couples frames three
//   apart, so their cross terms are exact zeros): the tangent of the one
//   dof through the joint's subtree, the squared residual tangents of the
//   one frame, and one butterfly sum over the lanes.
// - Determinism: every output element is written by one thread; sums run
//   in a fixed order (the butterfly's too), with no atomics, so launches
//   and CUDA-graph replays repeat bit for bit.
// - Types: float and double, the same code. Launches on the caller's
//   stream, allocates nothing and returns the CUDA error.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlots = 28;        // data-order joints of the residual
constexpr int kRootLane = 31;     // the lane of the root translation
constexpr int kMaxJoints = 31;    // skeleton joints: lanes 0..30
constexpr int kMaxChildren = 6;
constexpr int kHalo = 2;          // frames on each side of a tile
constexpr int kTile = 12;         // a product block's own frames
constexpr int kTileWarps = kTile + 2 * kHalo;
constexpr int kDiagGroups = 3;    // warps that share one frame's diagonal
constexpr int kDiagWarps = 8;
constexpr int kCols = 4 + kMaxChildren;  // columns of the per-lane table
constexpr unsigned kFull = 0xffffffffu;

// Per-lane table (ints): the lane's joint's parent (itself for the root and
// unused lanes), depth (-1 for unused lanes), data-order slot (-1 for
// none), the skeleton joint of the lane's data-order slot (-1 for lanes
// >= 28), and up to kMaxChildren children (-1).
enum Col { kParent, kDepth, kSlotOf, kJointOf, kChild0 };
enum Weight { kProj, kSmoothVel, kSmoothAcc, kData, kVel, kFloor, kWeights };
// ptrs[] and ints[] of chd_traj_jtjv, in the wrapper's order.
enum Ptr { pX, pV, pOut, pProjW, pDataW, pSmoothW, pVc, pNormal, pOffsets, pFmask,
           pW0, pSmoothXyz = pW0 + kWeights, pTables };
enum Int { iM, iB, iF, iJ, iRootSlot, iMaxDepth, iMaxChildren, iVSm, iVSb, iProjWSb,
           iDataWSb, iSmoothWSb, iVcSb, iNormalSb, iOffsetsSb, iFmaskSb };

template <typename T>
struct Args {
  const T* x;        // (B, F, D)
  const T* v;        // (M, B, F, D), strides v_sm, v_sb
  T* out;            // (M, B, F, D)
  const T* proj_w;   // (B, F, 28)
  const T* data_w;   // (B, F, 28)
  const T* smooth_w; // (B, 28)
  const T* vc;       // (B, F, 28)
  const T* normal;   // (B, 3)
  const T* offsets;  // (B, J, 3)
  const T* fmask;    // (B, F), or null: every frame real
  const T* w[kWeights];
  const T* smooth_xyz;  // (3,)
  const int* tables;    // (32, kCols)
  int M, B, F, J, root_slot, max_depth, max_children;
  long long v_sm, v_sb, proj_w_sb, data_w_sb, smooth_w_sb, vc_sb, normal_sb, offsets_sb,
      fmask_sb;
};

template <typename T>
struct Q {
  T w, x, y, z;
};
template <typename T>
struct V {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ Q<T> qzero() {
  return {T(0), T(0), T(0), T(0)};
}
template <typename T>
__device__ __forceinline__ V<T> vzero() {
  return {T(0), T(0), T(0)};
}
template <typename T>
__device__ __forceinline__ Q<T> mul(const Q<T>& a, const Q<T>& b) {  // quat.mul
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
template <typename T>
__device__ __forceinline__ Q<T> conj(const Q<T>& a) {
  return {a.w, -a.x, -a.y, -a.z};
}
template <typename T>
__device__ __forceinline__ Q<T> add(const Q<T>& a, const Q<T>& b) {
  return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V<T> add(const V<T>& a, const V<T>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V<T> sub(const V<T>& a, const V<T>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V<T> scale(T s, const V<T>& a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ T dot(const V<T>& a, const V<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V<T> cross(const V<T>& a, const V<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ __forceinline__ V<T> im(const Q<T>& q) {
  return {q.x, q.y, q.z};
}

// quat.rotate: v + 2 (w (u × v) + u × (u × v))
template <typename T>
__device__ __forceinline__ V<T> rotate(const Q<T>& q, const V<T>& v) {
  const V<T> u = im(q), uv = cross(u, v);
  return add(v, scale(T(2), add(scale(q.w, uv), cross(u, uv))));
}
// its tangent in q along dq
template <typename T>
__device__ __forceinline__ V<T> rotate_t(const Q<T>& q, const Q<T>& dq, const V<T>& v) {
  const V<T> u = im(q), du = im(dq), uv = cross(u, v);
  return scale(T(2), add(add(scale(dq.w, uv), scale(q.w, cross(du, v))),
                         add(cross(du, uv), cross(u, cross(du, v)))));
}
// its transpose in q: the cotangent of q from the cotangent pb of the result
template <typename T>
__device__ __forceinline__ Q<T> rotate_tt(const Q<T>& q, const V<T>& v, const V<T>& pb) {
  const V<T> u = im(q);
  const V<T> uu = add(add(scale(dot(u, v), pb), scale(dot(u, pb), v)),
                      scale(T(-2) * dot(v, pb), u));
  const V<T> ub = scale(T(2), add(scale(q.w, cross(v, pb)), uu));
  return {T(2) * dot(cross(u, v), pb), ub.x, ub.y, ub.z};
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(kFull, v, src);
}
template <typename T>
__device__ __forceinline__ Q<T> shfl(const Q<T>& a, int src) {
  return {shfl(a.w, src), shfl(a.x, src), shfl(a.y, src), shfl(a.z, src)};
}
template <typename T>
__device__ __forceinline__ V<T> shfl(const V<T>& a, int src) {
  return {shfl(a.x, src), shfl(a.y, src), shfl(a.z, src)};
}
// the sum over the warp's lanes, in the same order on every lane and call
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
  for (int o = kWarp / 2; o > 0; o /= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}
template <typename T>
__device__ __forceinline__ V<T> warp_sum(const V<T>& a) {
  return {warp_sum(a.x), warp_sum(a.y), warp_sum(a.z)};
}

template <typename T>
__device__ __forceinline__ V<T> load3(const T* p) {
  return {p[0], p[1], p[2]};
}
template <typename T>
__device__ __forceinline__ void store3(T* p, const V<T>& a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
template <typename T>
__device__ __forceinline__ T comp(const V<T>& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : a.z;
}

// One lane's joint at the linearization point: its euler axis quaternions
// (quat.from_euler(world=True): q = q_z ⊗ q_y ⊗ q_x), its local and global
// rotations, its parent's global rotation (the identity at the root) and
// its global position.
template <typename T>
struct Joint {
  T c[3], s[3];  // cos, sin of the half eulers
  Q<T> q, pq, gq;
  V<T> gp, off;
};

// from_angle_axis's normalization of a unit axis: 1 / (1 + 1e-10) in T
template <typename T>
__device__ __forceinline__ T axis_norm() {
  return T(1.0 / (1.0 + 1e-10));
}
template <typename T>
__device__ __forceinline__ Q<T> axis_q(T c, T s, int a) {
  const T z = T(0), ss = s * axis_norm<T>();
  return {c, a == 0 ? ss : z, a == 1 ? ss : z, a == 2 ? ss : z};
}
// d q_a / d e_a
template <typename T>
__device__ __forceinline__ Q<T> axis_dq(T c, T s, int a) {
  const T z = T(0), cc = T(0.5) * c * axis_norm<T>();
  return {T(-0.5) * s, a == 0 ? cc : z, a == 1 ? cc : z, a == 2 ? cc : z};
}

template <typename T>
__device__ __forceinline__ void set_angles(Joint<T>& jt, const V<T>& e) {
  for (int a = 0; a < 3; ++a) {
    const T h = comp(e, a) / T(2);
    jt.c[a] = cos(h);
    jt.s[a] = sin(h);
  }
  const Q<T> q0 = axis_q(jt.c[0], jt.s[0], 0), q1 = axis_q(jt.c[1], jt.s[1], 1),
             q2 = axis_q(jt.c[2], jt.s[2], 2);
  jt.q = mul(q2, mul(q1, q0));
}

// tangent of the local rotation along euler tangent de
template <typename T>
__device__ __forceinline__ Q<T> local_t(const Joint<T>& jt, const V<T>& de) {
  const Q<T> q0 = axis_q(jt.c[0], jt.s[0], 0), q1 = axis_q(jt.c[1], jt.s[1], 1),
             q2 = axis_q(jt.c[2], jt.s[2], 2);
  Q<T> d0 = axis_dq(jt.c[0], jt.s[0], 0), d1 = axis_dq(jt.c[1], jt.s[1], 1),
       d2 = axis_dq(jt.c[2], jt.s[2], 2);
  d0 = {d0.w * de.x, d0.x * de.x, d0.y * de.x, d0.z * de.x};
  d1 = {d1.w * de.y, d1.x * de.y, d1.y * de.y, d1.z * de.y};
  d2 = {d2.w * de.z, d2.x * de.z, d2.y * de.z, d2.z * de.z};
  return add(mul(d2, mul(q1, q0)), mul(q2, add(mul(d1, q0), mul(q1, d0))));
}

// transpose of local_t: the euler cotangent of the local rotation's cotangent
template <typename T>
__device__ __forceinline__ V<T> local_tt(const Joint<T>& jt, const Q<T>& qb) {
  const Q<T> q0 = axis_q(jt.c[0], jt.s[0], 0), q1 = axis_q(jt.c[1], jt.s[1], 1),
             q2 = axis_q(jt.c[2], jt.s[2], 2);
  const Q<T> a = mul(q1, q0);
  const Q<T> b2 = mul(qb, conj(a)), ab = mul(conj(q2), qb);
  const Q<T> b1 = mul(ab, conj(q0)), b0 = mul(conj(q1), ab);
  const Q<T> d0 = axis_dq(jt.c[0], jt.s[0], 0), d1 = axis_dq(jt.c[1], jt.s[1], 1),
             d2 = axis_dq(jt.c[2], jt.s[2], 2);
  return {d0.w * b0.w + d0.x * b0.x + d0.y * b0.y + d0.z * b0.z,
          d1.w * b1.w + d1.x * b1.x + d1.y * b1.y + d1.z * b1.z,
          d2.w * b2.w + d2.x * b2.x + d2.y * b2.y + d2.z * b2.z};
}

struct Lane {
  int parent, depth, slot, joint_of_slot, children[kMaxChildren];
};

__device__ __forceinline__ Lane lane_table(const int* tables, int lane) {
  Lane ln;
  const int* row = tables + lane * kCols;
  ln.parent = row[kParent];
  ln.depth = row[kDepth];
  ln.slot = row[kSlotOf];
  ln.joint_of_slot = row[kJointOf];
  for (int c = 0; c < kMaxChildren; ++c) ln.children[c] = row[kChild0 + c];
  return ln;
}

// The lane's joint at x, and FK down the tree's levels (core/fk.py): a
// joint at depth d takes its parent's global rotation and position, final
// since level d - 1.
template <typename T>
__device__ void fk(const Args<T>& a, const Lane& ln, int lane, int b, int f, Joint<T>& jt) {
  const int D = 3 + 3 * a.J;
  const T* xf = a.x + ((long long)b * a.F + f) * D;
  const bool joint = lane < a.J;
  set_angles(jt, joint ? load3(xf + 3 + 3 * lane) : vzero<T>());
  jt.off = joint ? load3(a.offsets + b * a.offsets_sb + 3 * lane) : vzero<T>();
  jt.pq = {T(1), T(0), T(0), T(0)};
  jt.gq = jt.q;
  jt.gp = jt.off;
  for (int d = 1; d <= a.max_depth; ++d) {
    const Q<T> pq = shfl(jt.gq, ln.parent);
    const V<T> pp = shfl(jt.gp, ln.parent);
    if (ln.depth == d) {
      jt.pq = pq;
      jt.gp = add(pp, rotate(pq, jt.off));
      jt.gq = mul(pq, jt.q);
    }
  }
}

// FK's tangent from level `from` down, given each lane's local-rotation
// tangent dq: returns the lane's global position tangent.
template <typename T>
__device__ V<T> fk_t(const Args<T>& a, const Lane& ln, const Joint<T>& jt, const Q<T>& dq,
                     int from) {
  Q<T> dgq = ln.depth == from - 1 ? mul(jt.pq, dq) : qzero<T>();
  V<T> dgp = vzero<T>();
  for (int d = from; d <= a.max_depth; ++d) {
    const Q<T> dpq = shfl(dgq, ln.parent);
    const V<T> dpp = shfl(dgp, ln.parent);
    if (ln.depth == d) {
      dgp = add(dpp, rotate_t(jt.pq, dpq, jt.off));
      dgq = add(mul(dpq, jt.q), mul(jt.pq, dq));
    }
  }
  return dgp;
}

template <typename T>
__device__ __forceinline__ T frame_mask(const Args<T>& a, int b, int f) {
  if (f < 0 || f >= a.F) return T(0);
  return a.fmask == nullptr ? T(1) : a.fmask[b * a.fmask_sb + f];
}

// The residual's coefficients at (sequence b, frame f, data-order slot k),
// and the frame masks of frames f-2..f+2 (zero outside the sequence).
template <typename T>
struct Coef {
  T fm[5];
  T wproj, wsv, wsa, wdata, wvel, wfloor, sxyz[3];
  T pw, dw, sw;
  bool vc_prev, vc;  // contact at (f-1, k), at (f, k)
  V<T> n;
};

template <typename T>
__device__ Coef<T> coef(const Args<T>& a, int b, int f, int k) {
  Coef<T> c;
  for (int o = 0; o < 5; ++o) c.fm[o] = frame_mask(a, b, f + o - 2);
  c.wproj = *a.w[kProj];
  c.wsv = *a.w[kSmoothVel];
  c.wsa = *a.w[kSmoothAcc];
  c.wdata = *a.w[kData];
  c.wvel = *a.w[kVel];
  c.wfloor = *a.w[kFloor];
  for (int i = 0; i < 3; ++i) c.sxyz[i] = a.smooth_xyz[i];
  const bool slot = k < kSlots;
  const long long e = (long long)f * kSlots + k;
  c.pw = slot ? a.proj_w[b * a.proj_w_sb + e] : T(0);
  c.dw = slot ? a.data_w[b * a.data_w_sb + e] : T(0);
  c.sw = slot ? a.smooth_w[b * a.smooth_w_sb + k] : T(0);
  c.vc = slot && a.vc[b * a.vc_sb + e] == T(1);
  c.vc_prev = slot && f >= 1 && a.vc[b * a.vc_sb + e - kSlots] == T(1);
  c.n = load3(a.normal + b * a.normal_sb);
  return c;
}

// The projection's tangent (2 values) of slot k's numerator tangent dn, at
// numerator nx (its depth nx.z), with coefficient alpha.
template <typename T>
__device__ __forceinline__ void proj_t(T alpha, const V<T>& nx, const V<T>& dn, T* t) {
  const T z2 = nx.z * nx.z;
  t[0] = alpha * (dn.x / nx.z - nx.x * dn.z / z2);
  t[1] = alpha * (dn.y / nx.z - nx.y * dn.z / z2);
}

// ---------------------------------------------------------------- products

template <typename T>
__global__ void __launch_bounds__(kTileWarps* kWarp, 1) product_kernel(const Args<T> a) {
  __shared__ T yd[kTileWarps][kSlots][3];  // data-order tangents of the tile's frames
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tiles = (a.F + kTile - 1) / kTile;
  long long blk = blockIdx.x;
  const int tile = (int)(blk % tiles);
  blk /= tiles;
  const int b = (int)(blk % a.B), m = (int)(blk / a.B);
  const int f = tile * kTile - kHalo + warp;
  const bool in = f >= 0 && f < a.F;
  const bool own = in && warp >= kHalo && warp < kHalo + kTile;
  const int D = 3 + 3 * a.J;
  const Lane ln = lane_table(a.tables, lane);
  const bool root_slot = lane == a.root_slot;
  const int src = lane < kSlots && !root_slot ? ln.joint_of_slot : lane;
  const T* vb = a.v + m * a.v_sm + b * a.v_sb;

  Joint<T> jt;
  V<T> yx = vzero<T>(), rx = vzero<T>();  // slot position and root translation at x
  if (in) {
    fk(a, ln, lane, b, f, jt);
    const T* vf = vb + (long long)f * D;
    const Q<T> dq = local_t(jt, lane < a.J ? load3(vf + 3 + 3 * lane) : vzero<T>());
    const V<T> dgp = fk_t(a, ln, jt, dq, 1);
    const V<T> dy = shfl(dgp, src);
    yx = shfl(jt.gp, src);
    rx = load3(a.x + ((long long)b * a.F + f) * D);
    if (lane < kSlots) store3(yd[warp][lane], root_slot ? load3(vf) : dy);
  } else if (lane < kSlots) {
    store3(yd[warp][lane], vzero<T>());
  }
  __syncthreads();
  if (!own) return;

  // cotangent of slot `lane`'s position (ybar) and its share of the root
  // translation's (rho), from the seven blocks' tangents around frame f
  const Coef<T> c = coef(a, b, f, lane);
  V<T> ybar = vzero<T>(), rho = vzero<T>();
  if (lane < kSlots) {
    V<T> Y[5], W[5];
    for (int o = 0; o < 5; ++o) {
      Y[o] = load3(yd[warp + o - 2][lane]);
      W[o] = add(Y[o], load3(yd[warp + o - 2][a.root_slot]));  // world = y + root
    }
    // projection: numerator y + root (the root slot's: the root translation)
    if (c.pw > T(0)) {
      const T alpha = c.wproj * c.pw * c.fm[2];
      const V<T> nx = root_slot ? rx : add(yx, rx);
      const V<T> dn = root_slot ? Y[2] : W[2];
      T t[2];
      proj_t(alpha, nx, dn, t);
      const T z2 = nx.z * nx.z;
      const V<T> nb = {alpha * t[0] / nx.z, alpha * t[1] / nx.z,
                       -alpha * (t[0] * nx.x + t[1] * nx.y) / z2};
      ybar = add(ybar, nb);
      if (!root_slot) rho = add(rho, nb);
    }
    // velocity smoothness, pairs (f-1, f) and (f, f+1); acceleration,
    // triples from f-2, f-1, f; data
    const T pair_prev = c.fm[1] * c.fm[2], pair_next = c.fm[2] * c.fm[3];
    const T g0 = c.wsa * (c.fm[2] * c.fm[3] * c.fm[4]);
    const T g1 = c.wsa * (c.fm[1] * c.fm[2] * c.fm[3]);
    const T g2 = c.wsa * (c.fm[0] * c.fm[1] * c.fm[2]);
    const T delta = c.wdata * c.dw * c.fm[2];
    T yb[3];
    for (int i = 0; i < 3; ++i) {
      const T y0 = comp(Y[0], i), y1 = comp(Y[1], i), y2 = comp(Y[2], i), y3 = comp(Y[3], i),
              y4 = comp(Y[4], i);
      const T base = c.wsv * c.sw * c.sxyz[i];
      const T bp = base * pair_prev, bn = base * pair_next;
      T s = bn * (bn * (y2 - y3)) - bp * (bp * (y1 - y2));
      s += g0 * (g0 * ((y4 - y3) - (y3 - y2)));
      s -= T(2) * g1 * (g1 * ((y3 - y2) - (y2 - y1)));
      s += g2 * (g2 * ((y2 - y1) - (y1 - y0)));
      s += delta * (delta * y2);
      yb[i] = s;
    }
    ybar = add(ybar, V<T>{yb[0], yb[1], yb[2]});
    // contact zero-velocity (mask at the pair's first frame) and floor
    V<T> wb = vzero<T>();
    if (c.vc_prev) {
      const T e = c.wvel * pair_prev;
      wb = sub(wb, scale(e * e, sub(W[1], W[2])));
    }
    if (c.vc) {
      const T e = c.wvel * pair_next;
      wb = add(wb, scale(e * e, sub(W[2], W[3])));
      const T z = c.wfloor * c.fm[2];
      wb = add(wb, scale(z * (z * dot(c.n, W[2])), c.n));
    }
    ybar = add(ybar, wb);
    rho = add(rho, wb);
  }
  // the root translation's cotangent: its slot's and every slot's share
  const V<T> rbar = warp_sum(root_slot ? add(rho, ybar) : rho);

  // transpose through the tree, deepest level first; a parent adds its
  // children's cotangents in the order of its table
  V<T> pb = shfl(ybar, ln.slot >= 0 ? ln.slot : lane);
  if (!(lane < a.J && ln.slot >= 0 && ln.slot != a.root_slot)) pb = vzero<T>();
  Q<T> qb = qzero<T>();
  V<T> eb = vzero<T>();
  for (int d = a.max_depth; d >= 0; --d) {
    Q<T> cq = qzero<T>();
    V<T> cp = vzero<T>();
    if (ln.depth == d) {
      eb = local_tt(jt, mul(conj(jt.pq), qb));
      cq = add(rotate_tt(jt.pq, jt.off, pb), mul(qb, conj(jt.q)));
      cp = pb;
    }
    if (d == 0) break;
    for (int i = 0; i < a.max_children; ++i) {
      const int ch = ln.children[i];
      const Q<T> xq = shfl(cq, ch >= 0 ? ch : lane);
      const V<T> xp = shfl(cp, ch >= 0 ? ch : lane);
      if (ch >= 0) {
        qb = add(qb, xq);
        pb = add(pb, xp);
      }
    }
  }

  // euler-velocity smoothness on the raw variables, root translation
  // included (xr row 0: lane 31; row j + 1: lane j), and the output
  const int col = lane == kRootLane ? 0 : lane < a.J ? 3 + 3 * lane : -1;
  if (col < 0) return;
  const T eta = c.wsv * T(10);
  const T ep = eta * (c.fm[1] * c.fm[2]), en = eta * (c.fm[2] * c.fm[3]);
  const V<T> v1 = load3(vb + (long long)f * D + col);
  const V<T> v0 = f >= 1 ? load3(vb + (long long)(f - 1) * D + col) : vzero<T>();
  const V<T> v2 = f + 1 < a.F ? load3(vb + (long long)(f + 1) * D + col) : vzero<T>();
  const V<T> es = sub(scale(en, scale(en, sub(v1, v2))), scale(ep, scale(ep, sub(v0, v1))));
  T* out = a.out + ((long long)m * a.B + b) * a.F * D + (long long)f * D + col;
  store3(out, add(lane == kRootLane ? rbar : eb, es));
}

// ---------------------------------------------------------------- diagonal

// Σ over the residual blocks at frame f of the squared tangents of slot
// k's, for a tangent that is zero off frame f: Y the slot's position
// tangent (the root slot's: the root translation's, R).
template <typename T>
__device__ T slot_sq(const Coef<T>& c, bool root_slot, const V<T>& nx, const V<T>& Y,
                     const V<T>& R) {
  T s = T(0);
  const V<T> W = add(Y, R);
  if (c.pw > T(0)) {
    T t[2];
    proj_t(c.wproj * c.pw * c.fm[2], nx, root_slot ? Y : W, t);
    s += t[0] * t[0] + t[1] * t[1];
  }
  const T pair_prev = c.fm[1] * c.fm[2], pair_next = c.fm[2] * c.fm[3];
  const T g0 = c.wsa * (c.fm[2] * c.fm[3] * c.fm[4]);
  const T g1 = T(2) * (c.wsa * (c.fm[1] * c.fm[2] * c.fm[3]));
  const T g2 = c.wsa * (c.fm[0] * c.fm[1] * c.fm[2]);
  const T delta = c.wdata * c.dw * c.fm[2];
  const T ep = c.vc_prev ? c.wvel * pair_prev : T(0), en = c.vc ? c.wvel * pair_next : T(0);
  for (int i = 0; i < 3; ++i) {
    const T y = comp(Y, i), w = comp(W, i);
    const T base = c.wsv * c.sw * c.sxyz[i];
    const T bp = base * pair_prev * y, bn = base * pair_next * y;
    const T a0 = g0 * y, a1 = g1 * y, a2 = g2 * y, dd = delta * y, vp = ep * w, vn = en * w;
    s += bp * bp + bn * bn + a0 * a0 + a1 * a1 + a2 * a2 + dd * dd + vp * vp + vn * vn;
  }
  if (c.vc) {
    const T fl = c.wfloor * c.fm[2] * dot(c.n, W);
    s += fl * fl;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kDiagWarps* kWarp) diag_kernel(const Args<T> a) {
  const int lane = threadIdx.x % kWarp;
  const long long gw = (long long)blockIdx.x * kDiagWarps + threadIdx.x / kWarp;
  if (gw >= (long long)a.B * a.F * kDiagGroups) return;
  const int g = (int)(gw % kDiagGroups);
  const int f = (int)(gw / kDiagGroups % a.F), b = (int)(gw / kDiagGroups / a.F);
  const int D = 3 + 3 * a.J;
  const Lane ln = lane_table(a.tables, lane);
  const bool root_slot = lane == a.root_slot;
  const int src = lane < kSlots && !root_slot ? ln.joint_of_slot : lane;

  Joint<T> jt;
  fk(a, ln, lane, b, f, jt);
  const V<T> rx = load3(a.x + ((long long)b * a.F + f) * D);
  const V<T> yx = shfl(jt.gp, src);  // every lane shuffles: a full-mask shuffle waits for all
  const V<T> nx = root_slot ? rx : add(yx, rx);
  const Coef<T> c = coef(a, b, f, lane);
  const T eta = c.wsv * T(10);
  const T ep = eta * (c.fm[1] * c.fm[2]), en = eta * (c.fm[2] * c.fm[3]);
  T* out = a.out + ((long long)b * a.F + f) * D;
  for (int d = g; d < D; d += kDiagGroups) {
    V<T> Y = vzero<T>(), R = vzero<T>();
    if (d < 3) {  // a root translation dof: every slot's world position moves
      R = {T(d == 0), T(d == 1), T(d == 2)};
      if (root_slot) Y = R;
    } else {      // an euler dof of joint jc: the positions below it move
      const int jc = (d - 3) / 3, ax = (d - 3) % 3;
      const V<T> de = {T(lane == jc && ax == 0), T(lane == jc && ax == 1),
                       T(lane == jc && ax == 2)};
      const int depth = shfl(ln.depth, jc);
      const V<T> dgp = fk_t(a, ln, jt, lane == jc ? local_t(jt, de) : qzero<T>(), depth + 1);
      const V<T> dy = shfl(dgp, src);
      if (!root_slot) Y = dy;
    }
    const T s = warp_sum(lane < kSlots ? slot_sq(c, root_slot, nx, Y, R) : T(0));
    if (lane == 0) out[d] = s + (en * en + ep * ep);
  }
}

template <typename T>
Args<T> args_of(const long long* p, const long long* n) {
  Args<T> a;
  a.x = reinterpret_cast<const T*>(p[pX]);
  a.v = reinterpret_cast<const T*>(p[pV]);
  a.out = reinterpret_cast<T*>(p[pOut]);
  a.proj_w = reinterpret_cast<const T*>(p[pProjW]);
  a.data_w = reinterpret_cast<const T*>(p[pDataW]);
  a.smooth_w = reinterpret_cast<const T*>(p[pSmoothW]);
  a.vc = reinterpret_cast<const T*>(p[pVc]);
  a.normal = reinterpret_cast<const T*>(p[pNormal]);
  a.offsets = reinterpret_cast<const T*>(p[pOffsets]);
  a.fmask = reinterpret_cast<const T*>(p[pFmask]);
  for (int i = 0; i < kWeights; ++i) a.w[i] = reinterpret_cast<const T*>(p[pW0 + i]);
  a.smooth_xyz = reinterpret_cast<const T*>(p[pSmoothXyz]);
  a.tables = reinterpret_cast<const int*>(p[pTables]);
  a.M = (int)n[iM];
  a.B = (int)n[iB];
  a.F = (int)n[iF];
  a.J = (int)n[iJ];
  a.root_slot = (int)n[iRootSlot];
  a.max_depth = (int)n[iMaxDepth];
  a.max_children = (int)n[iMaxChildren];
  a.v_sm = n[iVSm];
  a.v_sb = n[iVSb];
  a.proj_w_sb = n[iProjWSb];
  a.data_w_sb = n[iDataWSb];
  a.smooth_w_sb = n[iSmoothWSb];
  a.vc_sb = n[iVcSb];
  a.normal_sb = n[iNormalSb];
  a.offsets_sb = n[iOffsetsSb];
  a.fmask_sb = n[iFmaskSb];
  return a;
}

template <typename T>
int launch(int mode, const long long* p, const long long* n, cudaStream_t stream) {
  const Args<T> a = args_of<T>(p, n);
  if (mode == 0) {
    const long long blocks = (long long)a.M * a.B * ((a.F + kTile - 1) / kTile);
    product_kernel<T><<<(unsigned)blocks, kTileWarps * kWarp, 0, stream>>>(a);
  } else {
    const long long warps = (long long)a.B * a.F * kDiagGroups;
    diag_kernel<T><<<(unsigned)((warps + kDiagWarps - 1) / kDiagWarps), kDiagWarps * kWarp, 0,
                     stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// JᵀJ·v (mode 0: out (M, B, F, D) for tangents v (M, B, F, D)) or the
// exact diagonal of JᵀJ (mode 1: out (B, F, D)) of the trajectory residual
// at x, in float (dtype 0) or double (1). ptrs and ints in the order of
// Ptr and Int (kinematics/jtjv.py builds them). Launches on `stream` and
// returns the CUDA error of the launch (cudaErrorInvalidValue for shapes
// or a mode the kernel does not take).
int chd_traj_jtjv(int dtype, int mode, const long long* ptrs, const long long* ints,
                  void* stream) {
  const long long M = ints[iM], B = ints[iB], F = ints[iF], J = ints[iJ];
  if ((mode != 0 && mode != 1) || (dtype != 0 && dtype != 1) || B < 1 || F < 1 || J < 1 ||
      J > kMaxJoints || M < 1 || ints[iRootSlot] < 0 || ints[iRootSlot] >= kSlots ||
      ints[iMaxDepth] < 0 || ints[iMaxDepth] >= kWarp || ints[iMaxChildren] < 0 ||
      ints[iMaxChildren] > kMaxChildren)
    return (int)cudaErrorInvalidValue;
  const long long blocks = mode == 0 ? M * B * ((F + kTile - 1) / kTile)
                                     : (B * F * kDiagGroups + kDiagWarps - 1) / kDiagWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(mode, ptrs, ints, s) : launch<double>(mode, ptrs, ints, s);
}

}  // extern "C"
