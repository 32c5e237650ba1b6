// The x-neighbour rows of a slab in the halo (sharded) mode of the
// stream-collide kernels K1 (stream_collide.cu) and K10
// (stream_collide_2d.cu).
//
// A rank that holds the x-slab [x0, x0 + X) of the lattice streams with
// the last x row of the previous rank (lo, at slab x = -1) and the first x
// row of the next (hi, at slab x = X) in place of the periodic wrap in x;
// y and z stay periodic.  Each row is shaped like one x row of its
// operand: f [19, 1, Y, Z], force and bc velocity [3, 1, Y, Z], flags and
// omega [1, Y, Z], Lees-Edwards planes [38, 1, Y].  A row is null where
// its operand is absent (a uniform force, no flags, scalar omega, ...).
//
// The C entries take the twelve pointers as one host array, in the order
// of the members below: f lo, f hi, force lo, force hi, and so on.

#pragma once

#include <stdint.h>

struct HaloRows {
  const float* f[2];
  const float* force[2];
  const uint8_t* flags[2];
  const float* bc[2];
  const float* omega[2];
  const float* le[2];
};

// Row ``side`` (0 lo, 1 hi) of a pair.  A select, not an index: indexing
// the kernel's parameter struct with a run-time side makes every thread copy
// the struct to local memory.
template <class T>
__device__ __forceinline__ T pick(const T (&pair)[2], int side) {
  return side ? pair[1] : pair[0];
}

inline HaloRows halo_rows_from(const void* const* p) {
  HaloRows h;
  for (int s = 0; s < 2; ++s) {
    h.f[s] = (const float*)p[0 + s];
    h.force[s] = (const float*)p[2 + s];
    h.flags[s] = (const uint8_t*)p[4 + s];
    h.bc[s] = (const float*)p[6 + s];
    h.omega[s] = (const float*)p[8 + s];
    h.le[s] = (const float*)p[10 + s];
  }
  return h;
}
