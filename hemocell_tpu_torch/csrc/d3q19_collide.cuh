// D3Q19 lattice constants and the collision of one node on 19 registers,
// shared by every stream-collide kernel (K1/K7 stream_collide.cu, K8/K9
// stream_collide_kx.cu, K10 stream_collide_2d.cu), so that all of them
// evaluate the same expression on the same operands.
//
// Replaces: hemocell_tpu/fluid/pallas_lbm.py::_collide_local, which the TPU
//   kernels share in the same way.
//
// Bitwise agreement between the kernels (the contract of the k-step kernels:
// k fused steps equal k one-step launches bit for bit) rests on two things:
// every kernel calls this one function, and the library is built with
// -fmad=false (hemocell_tpu_torch/_build.py), so that nvcc contracts no
// a*b+c into an FMA at one call site and not at another.  Without fast-math
// nvcc neither re-associates nor approximates, and `/` is the IEEE division.

#pragma once

#include <stdint.h>

namespace d3q19 {

constexpr uint8_t kWall = 1;
constexpr uint8_t kVelocity = 2;
constexpr uint8_t kPressure = 3;

// The lattice tables as function-local constants: inside fully unrolled
// loops the compiler folds every entry into the instruction stream.
#define D3Q19_TABLES                                                                      \
  const int kCX[19] = {0, -1, 1, 0, 0, 0, 0, -1, 1, -1, 1, -1, 1, -1, 1, 0, 0, 0, 0};     \
  const int kCY[19] = {0, 0, 0, -1, 1, 0, 0, -1, 1, 1, -1, 0, 0, 0, 0, -1, 1, -1, 1};     \
  const int kCZ[19] = {0, 0, 0, 0, 0, -1, 1, 0, 0, 0, 0, -1, 1, 1, -1, -1, 1, 1, -1};     \
  const int kOPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17}; \
  (void)kCX; (void)kCY; (void)kCZ; (void)kOPP;

__device__ __forceinline__ float weight(int i) {
  return i == 0 ? 1.0f / 3.0f : (i < 7 ? 1.0f / 18.0f : 1.0f / 36.0f);
}

// c . v for a lattice velocity c with components in {-1, 0, 1}: the signed
// sum of the components of v that c selects, in x, y, z order (each term is
// exact, so only the additions round).
__device__ __forceinline__ float dot_c(int cx, int cy, int cz, float vx, float vy, float vz) {
  float s = 0.0f;
  bool empty = true;
  if (cx != 0) {
    s = cx > 0 ? vx : -vx;
    empty = false;
  }
  if (cy != 0) {
    const float t = cy > 0 ? vy : -vy;
    s = empty ? t : s + t;
    empty = false;
  }
  if (cz != 0) {
    const float t = cz > 0 ? vz : -vz;
    s = empty ? t : s + t;
  }
  return s;
}

// Periodic index: a mod n for any int a (tiles may hang over the box and the
// box may be narrower than a tile).
__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Post-collision populations ``res`` of one node from its pre-collision
// deviation populations ``h``:
//   wall node            bounce-back, res_i = h_opp(i);
//   velocity node        (velocity_node: flag == kVelocity and the caller has
//                        a bc velocity (bux, buy, buz)) moving bounce-back,
//                        res_i = h_opp(i) + 6 w_i c_i . u_wall;
//   otherwise            BGK + Guo forcing with force (Fx, Fy, Fz) and
//                        relaxation frequency om; at a pressure node with
//                        has_rho0 the equilibrium is shifted to rho0.
// drho = sum h is kept beside rho = 1 + drho: (rho - 1) would lose up to 6e-8
// of it in f32, which the collision turns into lost mass.
__device__ __forceinline__ void collide_node(
    const float (&h)[19], float (&res)[19], uint8_t flag,
    float Fx, float Fy, float Fz, float om,
    bool velocity_node, float bux, float buy, float buz,
    bool has_rho0, float rho0) {
  D3Q19_TABLES
  if (flag == kWall) {
#pragma unroll
    for (int i = 0; i < 19; ++i) res[i] = h[kOPP[i]];
    return;
  }
  if (velocity_node) {
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      const float cu = dot_c(kCX[i], kCY[i], kCZ[i], bux, buy, buz);
      res[i] = h[kOPP[i]] + 6.0f * weight(i) * cu;
    }
    return;
  }
  float drho = 0.f, mx = 0.f, my = 0.f, mz = 0.f;
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    drho += h[i];
    if (kCX[i] > 0) mx += h[i];
    if (kCX[i] < 0) mx -= h[i];
    if (kCY[i] > 0) my += h[i];
    if (kCY[i] < 0) my -= h[i];
    if (kCZ[i] > 0) mz += h[i];
    if (kCZ[i] < 0) mz -= h[i];
  }
  const float rho = 1.0f + drho;
  const float ux = (mx + 0.5f * Fx) / rho;
  const float uy = (my + 0.5f * Fy) / rho;
  const float uz = (mz + 0.5f * Fz) / rho;
  const float usq = ux * ux + uy * uy + uz * uz;
  const float uF = ux * Fx + uy * Fy + uz * Fz;
  const float src = 1.0f - 0.5f * om;
  const bool pressure = (flag == kPressure) && has_rho0;
  // population i from a = 3 c.u, b = 4.5 (c.u)^2, its c.F and g = 9 (c.u)(c.F):
  //   poly = 3 c.u + 4.5 (c.u)^2 - 1.5 u.u,  feq = w (drho + rho poly),
  //   S = w (3 (c.F - u.F) + 9 (c.u)(c.F)),  res = h - om (h - feq) + src S
  auto relax = [&](int i, float a, float b, float cF, float g) {
    const float poly = a + b - 1.5f * usq;
    const float feq = weight(i) * (drho + rho * poly);
    const float S = weight(i) * (3.0f * (cF - uF) + g);
    float v = h[i] - om * (h[i] - feq) + src * S;
    if (pressure) v += weight(i) * (rho0 - rho) * (1.0f + poly);
    res[i] = v;
  };
  // The rest population, then the pairs (i, i + 1) of opposite velocities
  // (c_{i+1} = -c_i).  Rounding is symmetric under negation, so c.u, c.F,
  // 3 c.u of population i + 1 are exactly the negated ones of i, and its
  // 4.5 (c.u)^2 and 9 (c.u)(c.F) exactly those of i: computing them once a
  // pair gives the bits of computing each, with 45 multiplications and 12
  // additions fewer a node.
  {
    const float cu = dot_c(kCX[0], kCY[0], kCZ[0], ux, uy, uz);
    const float cF = dot_c(kCX[0], kCY[0], kCZ[0], Fx, Fy, Fz);
    relax(0, 3.0f * cu, 4.5f * cu * cu, cF, 9.0f * cu * cF);
  }
#pragma unroll
  for (int i = 1; i < 19; i += 2) {
    const float cu = dot_c(kCX[i], kCY[i], kCZ[i], ux, uy, uz);
    const float cF = dot_c(kCX[i], kCY[i], kCZ[i], Fx, Fy, Fz);
    const float a = 3.0f * cu, b = 4.5f * cu * cu, g = 9.0f * cu * cF;
    relax(i, a, b, cF, g);
    relax(i + 1, -a, b, -cF, g);
  }
}

}  // namespace d3q19
