// K6's arithmetic on the host: csrc/shade_lane.h compiled with g++ (no
// fused multiply-adds), for the CPU tests only.  One loop over the lanes
// calls the same per-lane function as the kernel.  The port's CPU path does
// not use this library: it runs the plain torch `_shade`.
#include <stdint.h>

#include "shade_lane.h"

extern "C" {

int m3t_shade_args_size() { return (int)sizeof(rp::ShadeArgs); }

int m3t_shade_wavefront_host(const rp::ShadeArgs* s) {
  for (int64_t i = 0; i < s->n; ++i) rp::shade_row(*s, i);
  return 0;
}

}  // extern "C"
