// The per-centre block cull shared by K4 (sorted_ball_query.cu) and K5
// (ball_max.cu).
//
// A block's box is stored as blk_bbox rows: lo = (minx, miny, minz, maxx),
// hi = (maxy, maxz, 0, 0). Both predicates round every operation on its own
// (no FMA), as the point test d2 = ((dx*dx) + dy*dy) + dz*dz < r2 does:
//  * the gap test is block_hitmask's gap expression with the centre a box
//    of size zero, g = max(bmin - c, c - bmax, 0) per axis. It is never
//    stricter than the point test: fl(c - p) is monotone in p, so
//    |fl(c - p)| >= g for every point p of the box (rounding is
//    odd-symmetric, fl(-x) = -fl(x)), and the rounded squares and sums are
//    monotone too, so d2(p) >= g2.
//  * the covered test: f = max(|fl(c - bmin)|, |fl(c - bmax)|) per axis bounds
//    |fl(c - p)| for every point p of the box by the same monotonicity, so
//    ((fx*fx) + fy*fy) + fz*fz < r2 means every point of the box is in the
//    ball.
// A contracted FMA would round differently and break both arguments.
#pragma once

#include "common.cuh"

// F3D_CULL_BLOCK sets the two predicates of the box (lo, hi) for the centre
// (cx, cy, cz): pass, the box may hold a point p with sqdist3(c - p) < r2
// (the gap test); cov, every point of the box has it (the covered test,
// asked only of a box that passes). It is a macro and not a function: as an
// inlined function the same arithmetic scheduled K4's walk differently
// (another order of the same instructions), and the move must leave K4's
// SASS as it was.
#define F3D_CULL_BLOCK(cx, cy, cz, lo, hi, r2, pass, cov)                      \
  do {                                                                         \
    const float gx = fmaxf(fmaxf(lo.x - cx, cx - lo.w), 0.f);                  \
    const float gy = fmaxf(fmaxf(lo.y - cy, cy - hi.x), 0.f);                  \
    const float gz = fmaxf(fmaxf(lo.z - cz, cz - hi.y), 0.f);                  \
    pass = f3d::sqdist3(gx, gy, gz) < r2;                                      \
    const float fx = fmaxf(fabsf(cx - lo.x), fabsf(cx - lo.w));                \
    const float fy = fmaxf(fabsf(cy - lo.y), fabsf(cy - hi.x));                \
    const float fz = fmaxf(fabsf(cz - lo.z), fabsf(cz - hi.y));                \
    cov = pass && f3d::sqdist3(fx, fy, fz) < r2;                               \
  } while (0)
