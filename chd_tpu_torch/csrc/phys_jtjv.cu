// Gauss-Newton products of the physics stages' augmented-Lagrangian residual
// for Hopper: out[m, b] = J_bᵀ J_b v[m, b] at the linearization point x, or
// the coloring diagonal Σₖ mₖ ⊙ J_bᵀ J_b mₖ over lm.frame_coloring_masks(F,
// 30)'s 90 masks, for the residual of
// physics/collocation.py::_al_residual_fn (the cost residuals, then √ρ-scaled
// constraint blocks: Newton–Euler, friction cone, heel-toe distance, height,
// leg length, no slip, terrain).
//
// Replaces no TPU kernel: chd_tpu's LM (chd_tpu/kinematics/lm.py) forms the
// product by jax.linearize and its transpose, which XLA fuses. The port
// formed it by a double vjp through torch.func, ~1,074 small kernels a
// product at 32 x 100 frames (PERF.md), 50 a replayed LM step, each a few
// microseconds: a DYN step spent ~90 ms launching them. physics/jtjv.py is
// the wrapper and holds a plain-torch emulation of this file's algorithm
// (phys_jtjv_plain), which the CPU tests hold against autograd.
//
// What bounds it: one product at 32 x 100 frames reads x, v and the
// problem's data (inertia, hips, contacts, masks, the hinge factors: ~1.7 MB
// in float32) and writes 0.38 MB, ~0.6 µs of HBM traffic; the arithmetic is
// ~3 kFLOP a frame (3x3 products of R·I·Rᵀ, its tangent and transposes, the
// blocks' rows), ~0.15 µs of the card's float32 rate. Both are far below a
// launch, so the kernel is bound by latency: a chain of dependent levels a
// frame (ω from θ̇, ω̇ from ω, the rows, then back), each level reading its
// neighbours. The design keeps every level's exchange inside one warp.
//
// The design:
// - A warp is one (tangent m, sequence b, tile of kTile frames) and a lane
//   one frame of the tile and its kHalo frames on each side. Lanes exchange
//   a level's values through the warp's shared memory after a __syncwarp,
//   never through global memory, and no block-wide barrier is needed.
// - Levels: (0) from x and v at f and f ± 1 in global memory, each lane's
//   R(θ), M(θ), θ̇, ω = M θ̇, and the tangents dω and the first difference
//   of the base position; (1) from the neighbours' values, ω̇, dω̇ and the
//   acceleration's tangent, so the rows at f and their cotangents, scaled by
//   √ρ, the frame masks and the hinge factors twice; (2) the cotangents of ω
//   and θ̇ and of the first difference, from the neighbours' cotangents of ω̇
//   and of the acceleration; (3) those of θ and the base position. A level
//   read from shared memory is wrong one lane further in from the window's
//   edge, so levels 1-3 leave lanes 3 .. 28 right: kHalo = 3 (a halo of 4
//   would be needed if level 0 read its neighbours from shared memory too).
// - Hinge factors (1, ½ at an exact tie, 0) come from the wrapper, taken at
//   x once an LM step through the residual's own operations, so the product
//   and autograd's gradient take the same rows.
// - Diagonal mode: the same product with the 90 coloring tangents made in the
//   kernel (tangent m: dof m / 3 at frames ≡ m % 3 mod 3), each lane writing
//   the one output where its tangent is 1. Every (frame, dof) has one such
//   tangent, so out is written once, with no sum and no atomics.
// - Determinism: every output element is written by one thread; sums run in
//   a fixed order, so launches and CUDA-graph replays repeat bit for bit.
// - Arithmetic in plain float or double (FMA contraction as nvcc does by
//   default), never TF32: the 3x3 products are written out. Launches on the
//   caller's stream, allocates nothing, and returns the CUDA error.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kHalo = 3;                    // frames on each side of a tile
constexpr int kTile = kWarp - 2 * kHalo;    // a warp's own frames
constexpr int kWarps = 4;                   // independent warps a block
constexpr int kDof = 30;                    // base_lin, base_ang, 4 ee, 4 forces
constexpr int kEe = 4;
constexpr int kColors = 3;                  // coloring masks' bandwidth 2 + 1
constexpr double kFriction = 0.5;           // collocation.FRICTION

enum Cost { cDataLin, cDataAng, cDataEe, cSvLin, cSvAng, cSvEe, cSa, cPin, kCosts };
enum Block { bDyn, bForce, bHeel, bHeight, bLeg, bSlip, bTerrain, kBlocks };
// ptrs[] and ints[] of chd_phys_jtjv, in the wrapper's order
enum Ptr { pX, pV, pOut, pDt, pMass, pNormal, pContact, pLHip, pRHip, pInertia, pFmask,
           pHForce, pHHeight, pHLeg, pW0, pRho0 = pW0 + kCosts, kPtrs = pRho0 + kBlocks };
enum Int { iM, iB, iF, iFlags, iVSm, iVSb, iDtSb, iMassSb, iNormalSb, iContactSb, iLHipSb,
           iRHipSb, iInertiaSb, iFmaskSb, iHForceSb, iHHeightSb, iHLegSb, kInts };

template <typename T>
struct Args {
  const T* x;        // (B, F, 30)
  const T* v;        // (M, B, F, 30), strides v_sm, v_sb; null in diagonal mode
  T* out;            // (M, B, F, 30), or (B, F, 30) in diagonal mode
  // (B,) (B,) (B,3) (B,4,F) (B,F,3) (B,F,3) (B,F,3,3)
  const T *dt, *mass, *normal, *contact, *lhip, *rhip, *inertia;
  const T* fmask;    // (B, F), or null: every frame real
  const T *hforce, *hheight, *hleg;  // (B,4,F,3) (B,4,F) (B,4,F), null where the block is off
  const T* w[kCosts];
  const T* rho[kBlocks];
  int M, B, F, flags;
  long long v_sm, v_sb, dt_sb, mass_sb, normal_sb, contact_sb, lhip_sb, rhip_sb, inertia_sb,
      fmask_sb, hforce_sb, hheight_sb, hleg_sb;
  __device__ bool on(int blk) const { return (flags >> (1 + blk)) & 1; }
  __device__ bool accel() const { return flags & 1; }
};

template <typename T>
struct V {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V<T> vzero() {
  return {T(0), T(0), T(0)};
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
__device__ __forceinline__ void acc3(T* p, const V<T>& a) {
  p[0] += a.x;
  p[1] += a.y;
  p[2] += a.z;
}
// row-major 3x3: m v, mᵀ v, a b
template <typename T>
__device__ __forceinline__ V<T> mv(const T* m, const V<T>& v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[3] * v.x + m[4] * v.y + m[5] * v.z,
          m[6] * v.x + m[7] * v.y + m[8] * v.z};
}
template <typename T>
__device__ __forceinline__ V<T> mtv(const T* m, const V<T>& v) {
  return {m[0] * v.x + m[3] * v.y + m[6] * v.z, m[1] * v.x + m[4] * v.y + m[7] * v.z,
          m[2] * v.x + m[5] * v.y + m[8] * v.z};
}
template <typename T>
__device__ __forceinline__ void mm(const T* a, const T* b, T* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
// a bᵀ
template <typename T>
__device__ __forceinline__ void mmt(const T* a, const T* b, T* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] =
          a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] + a[3 * i + 2] * b[3 * j + 2];
}
// aᵀ b
template <typename T>
__device__ __forceinline__ void mtm(const T* a, const T* b, T* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}
template <typename T>
__device__ __forceinline__ T comp(const V<T>& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : a.z;
}
// k·(k·t): a row's tangent back through its scale
template <typename T>
__device__ __forceinline__ T sq(T k, T t) {
  return k * (k * t);
}

// sin and cos of the three base angles: R = Rz·Ry·Rx (srbd.rot_zyx), its
// partials, M with ω = M θ̇ (srbd.euler_rate_matrix) and its partials
template <typename T>
struct Trig {
  T cx, sx, cy, sy, cz, sz;
};
template <typename T>
__device__ __forceinline__ Trig<T> trig(const V<T>& th) {
  return {cos(th.x), sin(th.x), cos(th.y), sin(th.y), cos(th.z), sin(th.z)};
}
template <typename T>
__device__ __forceinline__ void rot(const Trig<T>& t, T* R) {
  R[0] = t.cz * t.cy;
  R[1] = t.cz * t.sy * t.sx - t.sz * t.cx;
  R[2] = t.cz * t.sy * t.cx + t.sz * t.sx;
  R[3] = t.sz * t.cy;
  R[4] = t.sz * t.sy * t.sx + t.cz * t.cx;
  R[5] = t.sz * t.sy * t.cx - t.cz * t.sx;
  R[6] = -t.sy;
  R[7] = t.cy * t.sx;
  R[8] = t.cy * t.cx;
}
template <typename T>
__device__ __forceinline__ void rot_d(const Trig<T>& t, int a, T* d) {
  if (a == 0) {
    d[0] = T(0);
    d[1] = t.cz * t.sy * t.cx + t.sz * t.sx;
    d[2] = -t.cz * t.sy * t.sx + t.sz * t.cx;
    d[3] = T(0);
    d[4] = t.sz * t.sy * t.cx - t.cz * t.sx;
    d[5] = -t.sz * t.sy * t.sx - t.cz * t.cx;
    d[6] = T(0);
    d[7] = t.cy * t.cx;
    d[8] = -t.cy * t.sx;
  } else if (a == 1) {
    d[0] = -t.cz * t.sy;
    d[1] = t.cz * t.cy * t.sx;
    d[2] = t.cz * t.cy * t.cx;
    d[3] = -t.sz * t.sy;
    d[4] = t.sz * t.cy * t.sx;
    d[5] = t.sz * t.cy * t.cx;
    d[6] = -t.cy;
    d[7] = -t.sy * t.sx;
    d[8] = -t.sy * t.cx;
  } else {
    d[0] = -t.sz * t.cy;
    d[1] = -t.sz * t.sy * t.sx - t.cz * t.cx;
    d[2] = -t.sz * t.sy * t.cx + t.cz * t.sx;
    d[3] = t.cz * t.cy;
    d[4] = t.cz * t.sy * t.sx - t.sz * t.cx;
    d[5] = t.cz * t.sy * t.cx + t.sz * t.sx;
    d[6] = T(0);
    d[7] = T(0);
    d[8] = T(0);
  }
}
template <typename T>
__device__ __forceinline__ V<T> rate_mv(const Trig<T>& t, const V<T>& v) {  // M v
  return {t.cz * t.cy * v.x - t.sz * v.y, t.sz * t.cy * v.x + t.cz * v.y, -t.sy * v.x + v.z};
}
template <typename T>
__device__ __forceinline__ V<T> rate_mtv(const Trig<T>& t, const V<T>& v) {  // Mᵀ v
  return {t.cz * t.cy * v.x + t.sz * t.cy * v.y - t.sy * v.z, -t.sz * v.x + t.cz * v.y, v.z};
}
// ∂M/∂θ_y v and ∂M/∂θ_z v (∂M/∂θ_x = 0)
template <typename T>
__device__ __forceinline__ V<T> rate_dy(const Trig<T>& t, const V<T>& v) {
  return {-t.cz * t.sy * v.x, -t.sz * t.sy * v.x, -t.cy * v.x};
}
template <typename T>
__device__ __forceinline__ V<T> rate_dz(const Trig<T>& t, const V<T>& v) {
  return {-t.sz * t.cy * v.x - t.cz * v.y, t.cz * t.cy * v.x - t.sz * v.y, T(0)};
}

template <typename T>
__device__ __forceinline__ T frame_mask(const Args<T>& a, int b, int f) {
  return a.fmask == nullptr ? T(1) : a.fmask[b * a.fmask_sb + f];
}
template <typename T>
__device__ __forceinline__ T contact(const Args<T>& a, int b, int e, int f) {
  return a.contact[b * a.contact_sb + (long long)e * a.F + f];
}

// The tangent: v[m, b] in product mode; coloring mask m (dof m / 3 at frames
// ≡ m % 3) in diagonal mode.
template <typename T, bool kDiag>
struct Tangent {
  const T* p;
  int d, c;
  __device__ __forceinline__ T at(int f, int dof) const {
    if (kDiag) return (dof == d && f % kColors == c) ? T(1) : T(0);
    return p[(long long)f * kDof + dof];
  }
  __device__ __forceinline__ V<T> at3(int f, int dof) const {
    return {at(f, dof), at(f, dof + 1), at(f, dof + 2)};
  }
};

// central_diff at frame f of a frame-indexed vector read by `get`: one-sided
// at the sequence's ends, central inside (srbd.central_diff)
template <typename T, typename Get>
__device__ __forceinline__ V<T> cdiff(int f, int F, T dt, Get get) {
  if (f == 0) return scale(T(1) / dt, sub(get(1), get(0)));
  if (f == F - 1) return scale(T(1) / dt, sub(get(F - 1), get(F - 2)));
  return scale(T(1) / (T(2) * dt), sub(get(f + 1), get(f - 1)));
}

// the warp's shared values: a level's results, one row a lane
template <typename T>
struct Smem {
  T om[kWarp][3], dom[kWarp][3], dcb[kWarp][3];    // level 0
  T odb[kWarp][3], accb[kWarp][3], slip[kWarp][kEe][3];  // level 1
  T thdb[kWarp][3], cbb[kWarp][3];                 // level 2
};

__device__ __forceinline__ int lane_at(int lane, int o) {
  const int l = lane + o;
  return l < 0 ? 0 : l >= kWarp ? kWarp - 1 : l;  // edge lanes read junk they never pass on
}
// central_diff at frame f of a level held in shared memory
template <typename T>
__device__ __forceinline__ V<T> cd_s(const T (*s)[3], int lane, int f, int F, T dt) {
  const V<T> here = load3(s[lane]), nxt = load3(s[lane_at(lane, 1)]),
             prv = load3(s[lane_at(lane, -1)]);
  if (f == 0) return scale(T(1) / dt, sub(nxt, here));
  if (f == F - 1) return scale(T(1) / dt, sub(here, prv));
  return scale(T(1) / (T(2) * dt), sub(nxt, prv));
}
// its transpose at frame f: the cotangent of frame f's value from the
// cotangents of the differences at f - 1, f, f + 1
template <typename T>
__device__ __forceinline__ V<T> cdt_s(const T (*s)[3], int lane, int f, int F, T dt) {
  V<T> r = vzero<T>();
  if (f - 1 >= 0) r = scale(T(1) / (f - 1 == 0 ? dt : T(2) * dt), load3(s[lane_at(lane, -1)]));
  const V<T> here = load3(s[lane]);
  if (f == 0) r = sub(r, scale(T(1) / dt, here));
  else if (f == F - 1) r = add(r, scale(T(1) / dt, here));
  if (f + 1 <= F - 1)
    r = sub(r, scale(T(1) / (f + 1 == F - 1 ? dt : T(2) * dt), load3(s[lane_at(lane, 1)])));
  return r;
}

template <typename T, bool kDiag>
__global__ void __launch_bounds__(kWarps* kWarp) product_kernel(const Args<T> a) {
  __shared__ Smem<T> smem[kWarps];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tiles = (a.F + kTile - 1) / kTile;
  long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)a.M * a.B * tiles) return;  // the whole warp
  const int tile = (int)(item % tiles);
  item /= tiles;
  const int b = (int)(item % a.B), m = (int)(item / a.B);
  const int F = a.F, f = tile * kTile - kHalo + lane;
  const bool in = f >= 0 && f < F;
  const bool own = in && lane >= kHalo && lane < kHalo + kTile;
  Smem<T>& s = smem[warp];

  Tangent<T, kDiag> v;
  v.p = kDiag ? nullptr : a.v + m * a.v_sm + b * a.v_sb;
  v.d = m / kColors;
  v.c = m % kColors;
  const T dt = a.dt[b * a.dt_sb];
  const T* xb = a.x + (long long)b * F * kDof;

  // -- level 0: θ̇, ω at x; the tangents dω and the first difference
  Trig<T> tr = {};
  V<T> thd = vzero<T>(), om = vzero<T>();
  if (in) {
    tr = trig(load3(xb + (long long)f * kDof + 3));
    thd = cdiff<T>(f, F, dt, [&](int k) { return load3(xb + (long long)k * kDof + 3); });
    om = rate_mv(tr, thd);
    const V<T> dth = v.at3(f, 3);
    const V<T> dthd = cdiff<T>(f, F, dt, [&](int k) { return v.at3(k, 3); });
    const V<T> dom = add(add(rate_mv(tr, dthd), scale(dth.y, rate_dy(tr, thd))),
                         scale(dth.z, rate_dz(tr, thd)));
    store3(s.om[lane], om);
    store3(s.dom[lane], dom);
    store3(s.dcb[lane], cdiff<T>(f, F, dt, [&](int k) { return v.at3(k, 0); }));
  } else {
    store3(s.om[lane], vzero<T>());
    store3(s.dom[lane], vzero<T>());
    store3(s.dcb[lane], vzero<T>());
  }
  __syncwarp();

  // -- level 1: the rows at frame f and their cotangents; o holds the
  // cotangent of frame f's 30 variables
  T o[kDof];
  for (int i = 0; i < kDof; ++i) o[i] = T(0);
  T Rb[9];
  for (int i = 0; i < 9; ++i) Rb[i] = T(0);
  V<T> omb = vzero<T>(), odb = vzero<T>(), accb = vzero<T>();
  V<T> slipcb[kEe];
  for (int e = 0; e < kEe; ++e) slipcb[e] = vzero<T>();
  const V<T> n = load3(a.normal + b * a.normal_sb);
  const T fm = in ? frame_mask(a, b, f) : T(0);
  if (in) {
    const T* xf = xb + (long long)f * kDof;
    const V<T> bl = load3(xf), dbl = v.at3(f, 0), dth = v.at3(f, 3);
    T R[9], dRv[9], dR[9];
    rot(tr, R);
    for (int i = 0; i < 9; ++i) dRv[i] = T(0);
    for (int ax = 0; ax < 3; ++ax) {
      rot_d(tr, ax, dR);
      const T d = comp(dth, ax);
      for (int i = 0; i < 9; ++i) dRv[i] += dR[i] * d;
    }
    T c[kEe];
    for (int e = 0; e < kEe; ++e) c[e] = contact(a, b, e, f);

    if (a.on(bDyn)) {  // Newton–Euler (srbd.dynamic_violation), masked by fm3
      const V<T> omd = cd_s<T>(s.om, lane, f, F, dt), domd = cd_s<T>(s.dom, lane, f, F, dt);
      const V<T> dom = load3(s.dom[lane]), dacc = cd_s<T>(s.dcb, lane, f, F, dt);
      const T* In = a.inertia + b * a.inertia_sb + (long long)f * 9;
      T Ib[9], IRt[9], Iw[9], A[9], Bm[9], dIw[9];
      for (int i = 0; i < 9; ++i) Ib[i] = In[i];
      mmt(Ib, R, IRt);          // I Rᵀ
      mm(R, IRt, Iw);           // R I Rᵀ
      mm(dRv, IRt, A);          // dR I Rᵀ
      mm(R, Ib, Bm);
      mmt(Bm, dRv, dIw);        // R I dRᵀ
      for (int i = 0; i < 9; ++i) dIw[i] += A[i];
      const V<T> u = mv(Iw, om);
      V<T> dtau = vzero<T>(), fsum = vzero<T>();
      for (int e = 0; e < kEe; ++e) {
        const V<T> fe = scale(c[e], load3(xf + 18 + 3 * e));
        const V<T> dfe = scale(c[e], v.at3(f, 18 + 3 * e));
        const V<T> arm = sub(bl, load3(xf + 6 + 3 * e));
        dtau = add(dtau, add(cross(dfe, arm), cross(fe, sub(dbl, v.at3(f, 6 + 3 * e)))));
        fsum = add(fsum, dfe);
      }
      const V<T> dang = sub(add(add(add(mv(dIw, omd), mv(Iw, domd)), cross(dom, u)),
                                cross(om, add(mv(dIw, om), mv(Iw, dom)))),
                            dtau);
      const T mass = a.mass[b * a.mass_sb];
      const V<T> dlin = sub(scale(mass, dacc), fsum);
      const T fm3 = fm * frame_mask(a, b, f + 1 < F ? f + 1 : F - 1) *
                    frame_mask(a, b, f >= 1 ? f - 1 : 0);
      const T k = sqrt(*a.rho[bDyn]) * fm3;
      const V<T> ab = {sq(k, dang.x), sq(k, dang.y), sq(k, dang.z)};
      const V<T> lb = {sq(k, dlin.x), sq(k, dlin.y), sq(k, dlin.z)};
      // Ī = ā ω̇ᵀ + (ā × ω) ωᵀ, R̄ = Ī R Iᵀ + Īᵀ R I
      const V<T> axo = cross(ab, om);
      T Ibar[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          Ibar[3 * i + j] = comp(ab, i) * comp(omd, j) + comp(axo, i) * comp(om, j);
      mmt(R, Ib, A);            // R Iᵀ
      mm(Ibar, A, Bm);          // Ī R Iᵀ
      for (int i = 0; i < 9; ++i) Rb[i] += Bm[i];
      mm(R, Ib, A);             // R I
      mtm(Ibar, A, Bm);         // Īᵀ R I
      for (int i = 0; i < 9; ++i) Rb[i] += Bm[i];
      odb = mtv(Iw, ab);
      omb = add(cross(u, ab), mtv(Iw, axo));
      const V<T> tb = scale(T(-1), ab);
      for (int e = 0; e < kEe; ++e) {
        const V<T> fe = scale(c[e], load3(xf + 18 + 3 * e));
        const V<T> arm = sub(bl, load3(xf + 6 + 3 * e));
        const V<T> tf = cross(tb, fe);
        acc3(o, tf);
        acc3(o + 6 + 3 * e, scale(T(-1), tf));
        acc3(o + 18 + 3 * e, sub(scale(c[e], cross(arm, tb)), scale(c[e], lb)));
      }
      accb = scale(mass, lb);
    }
    if (a.on(bLeg)) {  // ½‖ee − (R hip + base)‖² ≤ ½L², hinged
      const T sr = sqrt(*a.rho[bLeg]);
      const V<T> hl = load3(a.lhip + b * a.lhip_sb + (long long)f * 3),
                 hr = load3(a.rhip + b * a.rhip_sb + (long long)f * 3);
      for (int e = 0; e < kEe; ++e) {
        const V<T> hip = (e & 1) ? hr : hl;
        const V<T> d = sub(load3(xf + 6 + 3 * e), add(mv(R, hip), bl));
        const T t = dot(d, sub(sub(v.at3(f, 6 + 3 * e), mv(dRv, hip)), dbl));
        const T k = sr * a.hleg[b * a.hleg_sb + (long long)e * F + f] * fm;
        const V<T> cd = scale(sq(k, t), d);
        acc3(o + 6 + 3 * e, cd);
        acc3(o, scale(T(-1), cd));
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) Rb[3 * i + j] -= comp(cd, i) * comp(hip, j);
      }
    }
    if (a.on(bHeel)) {  // toe-heel distance, pairs (0, 2), (1, 3)
      const T k = sqrt(*a.rho[bHeel]) * fm;
      for (int e = 0; e < 2; ++e) {
        const V<T> dh = sub(load3(xf + 6 + 3 * e), load3(xf + 12 + 3 * e));
        const T t = dot(dh, sub(v.at3(f, 6 + 3 * e), v.at3(f, 12 + 3 * e)));
        const V<T> cd = scale(sq(k, t), dh);
        acc3(o + 6 + 3 * e, cd);
        acc3(o + 12 + 3 * e, scale(T(-1), cd));
      }
    }
    if (a.on(bHeight)) {  // −(ee − p0)·n ≤ 0, hinged
      const T sr = sqrt(*a.rho[bHeight]);
      for (int e = 0; e < kEe; ++e) {
        const T k = sr * a.hheight[b * a.hheight_sb + (long long)e * F + f] * fm;
        acc3(o + 6 + 3 * e, scale(-sq(k, -dot(n, v.at3(f, 6 + 3 * e))), n));
      }
    }
    if (a.on(bTerrain)) {  // c (ee − p0)·n = 0
      const T sr = sqrt(*a.rho[bTerrain]);
      for (int e = 0; e < kEe; ++e) {
        const T k = sr * c[e] * fm;
        acc3(o + 6 + 3 * e, scale(sq(k, dot(n, v.at3(f, 6 + 3 * e))), n));
      }
    }
    if (a.on(bSlip) && f + 1 <= F - 1) {  // the pair (f, f + 1); (f - 1, f) is the lane below's
      const T sr = sqrt(*a.rho[bSlip]);
      const T pr = fm * frame_mask(a, b, f + 1);
      for (int e = 0; e < kEe; ++e) {
        const T k = sr * (c[e] * contact(a, b, e, f + 1) * pr);
        const V<T> dd = sub(v.at3(f + 1, 6 + 3 * e), v.at3(f, 6 + 3 * e));
        slipcb[e] = {sq(k, dd.x), sq(k, dd.y), sq(k, dd.z)};
        acc3(o + 6 + 3 * e, scale(T(-1), slipcb[e]));
      }
    }
    if (a.on(bForce)) {  // −fn ≤ 0, fn − limit ≤ 0, |ft|² − μ² fn² ≤ 0, hinged
      const T sr = sqrt(*a.rho[bForce]), mu2 = T(kFriction) * T(kFriction);
      for (int e = 0; e < kEe; ++e) {
        const V<T> fe = scale(c[e], load3(xf + 18 + 3 * e));
        const V<T> dfe = scale(c[e], v.at3(f, 18 + 3 * e));
        const T fn = dot(fe, n), dfn = dot(n, dfe);
        const V<T> ft = sub(fe, scale(fn, n));
        const T t2 = T(2) * dot(ft, sub(dfe, scale(dfn, n))) - T(2) * mu2 * fn * dfn;
        const T* h = a.hforce + b * a.hforce_sb + ((long long)e * F + f) * 3;
        const T k0 = sr * h[0] * fm, k1 = sr * h[1] * fm, k2 = sr * h[2] * fm;
        const T c0 = sq(k0, -dfn), c1 = sq(k1, dfn), c2 = sq(k2, t2);
        const V<T> gft = sub(sub(scale(T(2), ft), scale(T(2) * dot(ft, n), n)),
                             scale(T(2) * mu2 * fn, n));
        acc3(o + 18 + 3 * e, scale(c[e], add(scale(c1 - c0, n), scale(c2, gft))));
      }
    }
  }
  store3(s.odb[lane], odb);
  store3(s.accb[lane], accb);
  for (int e = 0; e < kEe; ++e) store3(s.slip[lane][e], slipcb[e]);
  __syncwarp();

  // -- level 2: ω̇ → ω → θ̇, θ; the acceleration → the first difference
  if (in) {
    omb = add(omb, cdt_s<T>(s.odb, lane, f, F, dt));
    const V<T> thdb = rate_mtv(tr, omb);
    o[4] += dot(rate_dy(tr, thd), omb);
    o[5] += dot(rate_dz(tr, thd), omb);
    T dR[9];
    for (int ax = 0; ax < 3; ++ax) {
      rot_d(tr, ax, dR);
      T sum = T(0);
      for (int i = 0; i < 9; ++i) sum += Rb[i] * dR[i];
      o[3 + ax] += sum;
    }
    if (lane >= 1)
      for (int e = 0; e < kEe; ++e) acc3(o + 6 + 3 * e, load3(s.slip[lane - 1][e]));
    store3(s.thdb[lane], thdb);
    store3(s.cbb[lane], cdt_s<T>(s.accb, lane, f, F, dt));
  } else {
    store3(s.thdb[lane], vzero<T>());
    store3(s.cbb[lane], vzero<T>());
  }
  __syncwarp();
  if (!own) return;

  // -- level 3: θ̇ → θ, the first difference → the base position
  acc3(o + 3, cdt_s<T>(s.thdb, lane, f, F, dt));
  acc3(o, cdt_s<T>(s.cbb, lane, f, F, dt));

  // -- the cost residuals (linear): data, velocity and acceleration
  // smoothness of base and feet, the force pins, the end frames' pins
  const int cw_data[3] = {cDataLin, cDataAng, cDataEe}, cw_sv[3] = {cSvLin, cSvAng, cSvEe};
  const int lo[3] = {0, 3, 6}, hi[3] = {3, 6, 18};
  const T sa = sqrt(*a.w[cSa]);
  for (int g = 0; g < 3; ++g) {
    const T sd = sqrt(*a.w[cw_data[g]]) * fm, ss = sqrt(*a.w[cw_sv[g]]);
    const T ap = f - 1 >= 0 ? ss * (frame_mask(a, b, f - 1) * fm) : T(0);
    const T an = f + 1 <= F - 1 ? ss * (fm * frame_mask(a, b, f + 1)) : T(0);
    T aq[3];  // the triples from f, f - 1, f - 2
    for (int j = 0; j < 3; ++j) {
      const int q = f - j;
      aq[j] = a.accel() && q >= 0 && q + 2 <= F - 1
                  ? sa * (frame_mask(a, b, q) * frame_mask(a, b, q + 1) * frame_mask(a, b, q + 2))
                  : T(0);
    }
    for (int i = lo[g]; i < hi[g]; ++i) {
      const T vf = v.at(f, i);
      T r = sq(sd, vf);
      if (f - 1 >= 0) r += sq(ap, vf - v.at(f - 1, i));
      if (f + 1 <= F - 1) r -= sq(an, v.at(f + 1, i) - vf);
      const T coef[3] = {T(1), T(-2), T(1)};
      for (int j = 0; j < 3; ++j) {
        const int q = f - j;
        if (aq[j] != T(0))
          r += coef[j] * sq(aq[j], v.at(q + 2, i) - T(2) * v.at(q + 1, i) + v.at(q, i));
      }
      o[i] += r;
    }
  }
  for (int e = 0; e < kEe; ++e) {
    const T cf = contact(a, b, e, f) * fm;
    const T k1 = T(1e-2) * (T(1) - cf), k2 = T(1e-4) * cf;
    for (int i = 18 + 3 * e; i < 21 + 3 * e; ++i) {
      const T vf = v.at(f, i);
      o[i] += sq(k1, vf) + sq(k2, vf);
    }
  }
  const T p = sqrt(*a.w[cPin]);
  if (f == 0 || f == F - 1)
    for (int i = 0; i < 6; ++i) o[i] += sq(p, v.at(f, i));
  const int ends[2][2] = {{0, 1}, {F - 2, F - 1}};
  for (int pi = 0; pi < 2; ++pi) {
    const int f0 = ends[pi][0], f1 = ends[pi][1];
    if (f != f0 && f != f1) continue;
    for (int i = 0; i < 3; ++i) {
      const T t = p * (T(0.1) * ((v.at(f1, i) - v.at(f0, i)) / dt));
      const T back = p * (T(0.1) * (t / dt));
      o[i] += f == f1 ? back : -back;
    }
  }

  if (kDiag) {
    if (f % kColors != v.c) return;
    T* out = a.out + ((long long)b * F + f) * kDof;
    for (int i = 0; i < kDof; ++i)
      if (i == v.d) out[i] = o[i];
  } else {
    T* out = a.out + (((long long)m * a.B + b) * F + f) * kDof;
    for (int i = 0; i < kDof; ++i) out[i] = o[i];
  }
}

template <typename T>
Args<T> args_of(const long long* p, const long long* n) {
  Args<T> a;
  auto ptr = [&](int i) { return reinterpret_cast<const T*>(p[i]); };
  a.x = ptr(pX);
  a.v = ptr(pV);
  a.out = reinterpret_cast<T*>(p[pOut]);
  a.dt = ptr(pDt);
  a.mass = ptr(pMass);
  a.normal = ptr(pNormal);
  a.contact = ptr(pContact);
  a.lhip = ptr(pLHip);
  a.rhip = ptr(pRHip);
  a.inertia = ptr(pInertia);
  a.fmask = ptr(pFmask);
  a.hforce = ptr(pHForce);
  a.hheight = ptr(pHHeight);
  a.hleg = ptr(pHLeg);
  for (int i = 0; i < kCosts; ++i) a.w[i] = ptr(pW0 + i);
  for (int i = 0; i < kBlocks; ++i) a.rho[i] = ptr(pRho0 + i);
  a.M = (int)n[iM];
  a.B = (int)n[iB];
  a.F = (int)n[iF];
  a.flags = (int)n[iFlags];
  a.v_sm = n[iVSm];
  a.v_sb = n[iVSb];
  a.dt_sb = n[iDtSb];
  a.mass_sb = n[iMassSb];
  a.normal_sb = n[iNormalSb];
  a.contact_sb = n[iContactSb];
  a.lhip_sb = n[iLHipSb];
  a.rhip_sb = n[iRHipSb];
  a.inertia_sb = n[iInertiaSb];
  a.fmask_sb = n[iFmaskSb];
  a.hforce_sb = n[iHForceSb];
  a.hheight_sb = n[iHHeightSb];
  a.hleg_sb = n[iHLegSb];
  return a;
}

long long blocks_of(long long M, long long B, long long F) {
  return (M * B * ((F + kTile - 1) / kTile) + kWarps - 1) / kWarps;
}

template <typename T>
int launch(int mode, const long long* p, const long long* n, cudaStream_t stream) {
  const Args<T> a = args_of<T>(p, n);
  const unsigned blocks = (unsigned)blocks_of(a.M, a.B, a.F);
  if (mode == 0)
    product_kernel<T, false><<<blocks, kWarps * kWarp, 0, stream>>>(a);
  else
    product_kernel<T, true><<<blocks, kWarps * kWarp, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// JᵀJ·v (mode 0: out (M, B, F, 30) for tangents v (M, B, F, 30)) or the
// coloring diagonal (mode 1: out (B, F, 30); M is the 90 masks) of the AL
// residual at x, in float (dtype 0) or double (1). ptrs and ints in the
// order of Ptr and Int (physics/jtjv.py builds them); a block's pointers
// are read only where the flags turn it on. Launches on `stream` and
// returns the CUDA error of the launch (cudaErrorInvalidValue for shapes or
// a mode the kernel does not take).
int chd_phys_jtjv(int dtype, int mode, const long long* ptrs, const long long* ints,
                  void* stream) {
  const long long M = ints[iM], B = ints[iB], F = ints[iF], flags = ints[iFlags];
  if ((mode != 0 && mode != 1) || (dtype != 0 && dtype != 1) || B < 1 || F < 2 || M < 1 ||
      (mode == 1 && M != kColors * kDof) || flags < 0 || flags >= (1 << (1 + kBlocks)) ||
      (mode == 0 && ptrs[pV] == 0) || ((flags >> (1 + bForce)) & 1 && ptrs[pHForce] == 0) ||
      ((flags >> (1 + bHeight)) & 1 && ptrs[pHHeight] == 0) ||
      ((flags >> (1 + bLeg)) & 1 && ptrs[pHLeg] == 0))
    return (int)cudaErrorInvalidValue;
  if (blocks_of(M, B, F) > 0x7fffffffLL || B * F * kDof > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(mode, ptrs, ints, s) : launch<double>(mode, ptrs, ints, s);
}

}  // extern "C"
