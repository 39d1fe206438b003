// How the row-by-row embedding kernels on Hopper (sm_90a) pack their lanes
// and size their grids: the row gather (gather_rows.cu, B1), the
// gather+pool (gather_pool.cu, B2) and the int8 row gather
// (gather_int8.cu, B9). Each kernel keeps its own body; this is the one
// policy they share.
//
// A row is `units` copy units wide. Lanes are packed to the row width:
//
//   kStraight  units <= 32 and the grid has a slot for every row: a warp
//              takes 32 / units whole rows at once, neighbouring lanes on
//              neighbouring units of one row, one row a thread, no loop;
//   kLoop      units <= 32 past the card's resident threads: the grid is
//              capped at blocks_per_sm blocks an SM and walks the rows in a
//              grid-stride loop;
//   kWide      units > 32: a warp a row, every lane busy, a warp for every
//              row (a grid of at most 2^31 - 1 blocks).
//
// A lane finds its row as (lane * lane_div) >> 16, a multiply by a
// reciprocal the host computes, exact for lane < 32: a division before the
// first load costs a launch-bound call a quarter of a microsecond.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace azt_rows {

enum class RowPath { kStraight, kLoop, kWide };

struct RowGrid {
  int units;          // copy units a row
  int lanes;          // lanes a row: min(units, 32)
  int rows_per_warp;  // 32 / lanes
  int lane_div;       // lane / lanes as (lane * lane_div) >> 16
  unsigned grid;      // blocks
  RowPath path;
};

// The current device's SM count, read once a device.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (counts[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = c > 0 ? c : 132;
  }
  return counts[dev];
}

// The grid for n rows of `units` units in blocks of `threads` (a multiple
// of 32), at most blocks_per_sm blocks an SM once capped; false where the
// launch cannot be made (a row of 2^31 units or more, a wide grid of 2^31
// blocks or more).
inline bool row_grid(long long n, long long units, int threads,
                     int blocks_per_sm, RowGrid& g) {
  if (units <= 0 || units > 0x7fffffff) return false;
  g.units = (int)units;
  g.lanes = g.units < 32 ? g.units : 32;
  g.rows_per_warp = 32 / g.lanes;
  g.lane_div = (65536 + g.lanes - 1) / g.lanes;
  const long long per_block = (long long)(threads / 32) * g.rows_per_warp;
  const long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  if (g.units > 32) {
    if (blocks > 0x7fffffff) return false;
    g.path = RowPath::kWide;
  } else {
    g.path = blocks <= cap ? RowPath::kStraight : RowPath::kLoop;
  }
  g.grid = (unsigned)(g.path == RowPath::kLoop ? cap : blocks);
  return true;
}

// rows - 1, at most INT32_MAX: no int32 id lies past a longer table, so
// 32-bit compares test an id's range.
inline int last_row(long long rows) {
  return (int)(rows - 1 < 0x7fffffff ? rows - 1 : 0x7fffffff);
}

// The widest unit (max_unit, then halves down to 4 bytes) that divides the
// row's bytes and both base pointers, else the element size.
inline int copy_unit(const void* table, const void* out, long long dim,
                     int elem_bytes, int max_unit = 16) {
  const long long row_bytes = dim * (long long)elem_bytes;
  for (int unit = max_unit; unit > elem_bytes; unit >>= 1)
    if (row_bytes % unit == 0 && (uintptr_t)table % unit == 0 &&
        (uintptr_t)out % unit == 0)
      return unit;
  return elem_bytes;
}

}  // namespace azt_rows
