// K5's arithmetic on the host: csrc/replay_path.h compiled with g++ (no
// fused multiply-adds), for the CPU tests only.  One loop over the rows
// calls the same per-row forward and adjoint as the kernels; the adjoint
// sums every row's derivatives in float64.  The port's CPU path does not
// use this library: it runs the plain torch replay.
#include <stdint.h>

#include "replay_path.h"

namespace {

struct HostAcc {
  double* bc_tab;
  double* rad_tab;
  void bc(int32_t row, int c, float v) { bc_tab[3 * row + c] += (double)v; }
  void rad(int32_t row, int c, float v) { rad_tab[3 * row + c] += (double)v; }
};

}  // namespace

extern "C" {

int m3t_replay_args_size() { return (int)sizeof(rp::ReplayArgs); }

int m3t_replay_forward_host(const rp::ReplayArgs* a) {
  for (int64_t r = 0; r < a->n_rows; ++r) {
    rp::V3 L = rp::replay_row(*a, r);
    a->L[3 * r] = L.x;
    a->L[3 * r + 1] = L.y;
    a->L[3 * r + 2] = L.z;
  }
  return 0;
}

// d_base_color (n_mats, 3) and d_radiance (n_emitters, 3) in float64 are
// added to; a->scratch must hold depth * 6 * n_rows floats
int m3t_replay_adjoint_host(const rp::ReplayArgs* a, double* d_base_color, double* d_radiance) {
  HostAcc acc{d_base_color, d_radiance};
  for (int64_t r = 0; r < a->n_rows; ++r) {
    rp::V3 g = rp::v3(a->dL[3 * r], a->dL[3 * r + 1], a->dL[3 * r + 2]);
    if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f) rp::replay_row_adjoint(*a, r, g, acc);
  }
  return 0;
}

}  // extern "C"
