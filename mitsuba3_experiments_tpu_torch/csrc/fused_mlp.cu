// Fused multi-layer perceptron forward on bf16 tensor cores: every layer of
// the MLP in one kernel, the activations kept in registers from the input
// to the output.
//
// Replaces the TPU kernel fused_mlp_forward
// (mitsuba3_experiments_tpu/models/pallas_mlp.py:28).  Per layer it
// computes what models/mlp.py::apply_mlp computes:
//
//   h_{l+1} = bf16( act( bf16(h_l) @ bf16(W_l) + b_l ) )     hidden layers
//   out     =            bf16(h_L) @ bf16(W_L) + b_L          last layer
//
// Products of bf16 operands are summed in float32 by the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulators); the bias and the
// activation are applied in float32 and rounded to bf16 to nearest even.
// The tensor cores add the products in their own order, so a hidden
// activation that lies at a bf16 rounding boundary may round to its
// neighbour.
//
// What bounds it on an H100: bytes.  The (n, sizes[0]) float32 input is
// read once and the (n, sizes[L]) output written once; at 32-64-64-64-3 that
// is 140 B a row against 10.9 k bf16 operations, far under the tensor cores'
// 295 operations a byte, so the kernel has to keep the input stream busy.
// What the design does about it:
//
//   * Tensor cores.  A warp owns 16 rows at a time.  Each layer is a loop
//     of mma.sync over k16 slices and n8 tiles.
//   * Activations in registers.  The float32 accumulators of two
//     neighbouring n8 tiles of layer l are exactly the A fragment of one
//     k16 slice of layer l+1 (rows g and g+8, columns 2t, 2t+1 and 2t+8,
//     2t+9 of lane 4g+t), so bias, activation and bf16 packing turn one
//     into the other in place.  Nothing goes through shared memory between
//     layers; only the last layer's real columns reach device memory.
//   * Widths fixed at compile time.  The input is padded with zero weights
//     to 32, 64 or 128 columns, every hidden layer to one width of 32, 64
//     or 128 (at least the input's), the output to a multiple of 8 (3 ->
//     8); zero weights and zero bias give zero activations, which the next
//     layer multiplies by zero weights.  Six instantiations (input, hidden)
//     cover every MLP the check takes, and only the last layer's tile
//     count is a runtime loop, so no mma sits under a branch: with a
//     runtime guard around each mma (one per width), the kernel issued
//     ~2,100 instructions with 227 branches and 32 warp syncs for its 32
//     HMMA, and the issue rate, not the bytes, set its time.
//   * Weights once per block.  The block rounds every layer's weights to
//     bf16 once and stores them in shared memory in fragment order:
//     [layer][k16 slice][n8 tile][lane] -> the lane's two bf16x2 B
//     registers as one 8-byte word, so a warp reads 256 contiguous bytes per
//     mma (no bank conflict, no ldmatrix).  About 21 KB at full width.
//   * A persistent grid.  Only as many blocks as fit on the card at once;
//     each walks `tile`-row steps (block b takes tiles b, b + grid, ...), so
//     the weights are staged once per block, not once per tile.
//   * The input streamed behind the compute.  Each warp issues the loads of
//     its next 16 rows (sector-complete float2 loads straight into
//     registers) before it computes the current ones, so one group's loads
//     are in flight for the whole of another group's layers.  Two or three
//     groups ahead, or a register cap for more warps, measured slower on an
//     H100 (PERF.md).
//
// Limits (layers, widths, tile, shared memory) are checked in one place,
// check_config.  Built with nvcc into a shared library with a plain C
// interface (models/fused_mlp_cuda.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;
constexpr int kWarps = 4;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQuantum = 16 * kWarps; // a tile is a whole number of 16-row groups per warp
constexpr int kMaxTile = 1024;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

struct MlpArgs {
  const float* w[kMaxLayers];   // (sizes[l], sizes[l+1]) row-major, float32
  const float* b[kMaxLayers];   // (sizes[l+1],) float32
  int sizes[kMaxLayers + 1];
  int n_layers;
  int act;
};

__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// leaky ReLU with slope 0.01, ReLU with slope 0, none with slope 1:
// max(v, slope v), branch-free (ReLU gives -0 where v < 0, equal to 0)
__device__ inline float activate(float v, float slope) { return fmaxf(v, slope * v); }

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Widths as the kernel lays them out: the input padded to kin, every hidden
// layer to kh (32, 64 or 128, kin <= kh), the output to a multiple of 8.
// pad_in(l) / pad_out(l): layer l's padded shape.
struct Padded {
  int kin, kh, out8, n_layers;
  __host__ __device__ int pad_in(int l) const { return l == 0 ? kin : kh; }
  __host__ __device__ int pad_out(int l) const { return l == n_layers - 1 ? out8 : kh; }
};

__host__ __device__ inline int width_class(int v) { return v <= 32 ? 32 : v <= 64 ? 64 : 128; }

__host__ __device__ inline Padded padded(const int* sizes, int n_layers) {
  int hidden = 0;
  for (int l = 1; l < n_layers; ++l) hidden = sizes[l] > hidden ? sizes[l] : hidden;
  Padded p;
  p.kin = width_class(sizes[0]);
  p.kh = width_class(hidden);
  if (p.kin > p.kh) p.kh = p.kin;
  p.out8 = pad8(sizes[n_layers]);
  p.n_layers = n_layers;
  return p;
}

// the first row of the q-th 16-row group of `warp` in this block: tile step
// q / per_warp of the block, group (q % per_warp) * kWarps + warp in it
__device__ inline long long group_row(long long q, int per_warp, int tile, int warp) {
  const long long step = q / per_warp;
  const int i = static_cast<int>(q - step * per_warp);
  return (blockIdx.x + step * gridDim.x) * static_cast<long long>(tile) +
         static_cast<long long>(i * kWarps + warp) * 16;
}

// The input fragments of rows r0 + g and r0 + g + 8: pf[s][2h + rr] holds
// columns 16s + 8h + 2t, +1 of row r0 + g + 8rr (zero past n or sizes[0]).
template <int SIN>
__device__ inline void load_input(float2 (&pf)[SIN][4], const float* __restrict__ x,
                                  long long r0, long long n, int in0, bool vec2, int g, int t) {
#pragma unroll
  for (int s = 0; s < SIN; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long long row = r0 + g + 8 * rr;
        const int col = 16 * s + 8 * h + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (row < n) {
          const float* p = x + row * in0 + col;
          if (vec2) {   // in0 even: col < in0 implies col + 1 < in0
            if (col < in0) v = __ldg(reinterpret_cast<const float2*>(p));
          } else {
            if (col < in0) v.x = __ldg(p);
            if (col + 1 < in0) v.y = __ldg(p + 1);
          }
        }
        pf[s][2 * h + rr] = v;
      }
    }
  }
}

// One layer of N8 n8 tiles over SK k16 slices: acc = A @ W, then bias and
// activation, and tiles 2s, 2s + 1 become slice s of the next A fragment
// (rows g / g + 8, columns 16s + 2t, +1 and 16s + 8 + 2t, +1).
template <int SK, int N8>
__device__ inline void hidden_layer(const uint32_t (&a)[SK][4], uint32_t (&next)[N8 / 2][4],
                                    const uint2* __restrict__ wl, const float* __restrict__ bl,
                                    float slope, int t) {
  float c[N8][4];
#pragma unroll
  for (int j = 0; j < N8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < SK; ++s) {
#pragma unroll
    for (int j = 0; j < N8; ++j) mma_bf16(c[j], a[s], wl[(s * N8 + j) * 32]);
  }
#pragma unroll
  for (int s = 0; s < N8 / 2; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1, r = 2 * (i & 1), col = 16 * s + 8 * h + 2 * t;
      next[s][i] = pack_bf16(activate(c[2 * s + h][r] + bl[col], slope),
                             activate(c[2 * s + h][r + 1] + bl[col + 1], slope));
    }
  }
}

// The last layer: out8 / 8 n8 tiles (a runtime count) over SK k16 slices,
// plus bias; only the real columns of rows below n are stored.
template <int SK>
__device__ inline void last_layer(const uint32_t (&a)[SK][4], const uint2* __restrict__ wl,
                                  const float* __restrict__ bl, int out8, int o,
                                  float* __restrict__ out, long long r0, long long n, int g,
                                  int t) {
  const int nt = out8 / 8;
  for (int j = 0; j < nt; ++j) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < SK; ++s) mma_bf16(c, a[s], wl[(s * nt + j) * 32]);
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row = r0 + g + 8 * rr;
      if (row < n) {
        float* orow = out + row * o;
        if (col < o) orow[col] = c[2 * rr] + bl[col];
        if (col + 1 < o) orow[col + 1] = c[2 * rr + 1] + bl[col + 1];
      }
    }
  }
}

// All layers of one 16-row group from its input fragments `ain`.
template <int KIN, int KH>
__device__ __forceinline__ void mlp_group(const uint32_t (&ain)[KIN / 16][4],
                                          const uint2* __restrict__ wfrag,
                                          const float* __restrict__ bias, const Padded& p,
                                          float slope, int o, float* __restrict__ out,
                                          long long r0, long long n, int lane) {
  constexpr int SIN = KIN / 16, SH = KH / 16, TH = KH / 8;
  const int L = p.n_layers, g = lane >> 2, t = lane & 3;
  if (L == 1) {
    last_layer<SIN>(ain, wfrag + lane, bias, p.out8, o, out, r0, n, g, t);
    return;
  }
  // where layer l >= 1's fragments and biases start (layer 0's at 0)
  const int w1 = KIN * KH / 4, b1 = KH;
  uint32_t h[SH][4];
  hidden_layer<SIN, TH>(ain, h, wfrag + lane, bias, slope, t);
  for (int l = 1; l < L - 1; ++l) {
    uint32_t h2[SH][4];
    hidden_layer<SH, TH>(h, h2, wfrag + w1 + (l - 1) * (KH * KH / 4) + lane,
                         bias + b1 + (l - 1) * KH, slope, t);
#pragma unroll
    for (int s = 0; s < SH; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[s][i] = h2[s][i];
    }
  }
  last_layer<SH>(h, wfrag + w1 + (L - 2) * (KH * KH / 4) + lane, bias + b1 + (L - 2) * KH,
                 p.out8, o, out, r0, n, g, t);
}

// KIN: the padded input width; KH: the padded hidden width.  Every loop but
// the last layer's tiles has a compile-time trip count, so no mma sits under
// a branch.
template <int KIN, int KH>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(MlpArgs a, const float* __restrict__ x, float* __restrict__ out, long long n,
                 int tile, int vec2) {
  constexpr int SIN = KIN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.n_layers;
  const Padded p = padded(a.sizes, L);

  int frag_total = 0;   // 8-byte fragment words: 4 bf16 weights each
  for (int l = 0; l < L; ++l) frag_total += p.pad_in(l) * p.pad_out(l) / 4;
  uint2* wfrag = reinterpret_cast<uint2*>(smem);
  float* bias = reinterpret_cast<float*>(wfrag + frag_total);

  // ---- weights (bf16, fragment order) and biases into shared memory ----
  {
    int woff = 0, boff = 0;
    for (int l = 0; l < L; ++l) {
      const int in = a.sizes[l], o = a.sizes[l + 1], np = p.pad_out(l);
      const int nt = np / 8, count = p.pad_in(l) / 16 * nt * 32;
      const float* w = a.w[l];
#pragma unroll 4
      for (int e = threadIdx.x; e < count; e += kThreads) {
        const int lane = e & 31, j = (e >> 5) % nt, s = (e >> 5) / nt;
        const int col = 8 * j + (lane >> 2), k = 16 * s + 2 * (lane & 3);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = k + (i & 1) + 8 * (i >> 1);
          v[i] = kk < in && col < o ? w[kk * o + col] : 0.0f;
        }
        wfrag[woff + e] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
      for (int j = threadIdx.x; j < np; j += kThreads) bias[boff + j] = j < o ? a.b[l][j] : 0.0f;
      woff += count;
      boff += np;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int in0 = a.sizes[0], o = a.sizes[L];
  const int per_warp = tile / kTileQuantum;
  const float slope = a.act == kLeakyRelu ? 0.01f : a.act == kRelu ? 0.0f : 1.0f;

  // a warp's groups come in increasing row order, so once one lies past n,
  // every later one does
  float2 pf[SIN][4];
  long long q = 0;
  long long r0 = group_row(q, per_warp, tile, warp);
  if (r0 < n) load_input<SIN>(pf, x, r0, n, in0, vec2 != 0, g, t);
  while (r0 < n) {
    uint32_t ain[SIN][4];
#pragma unroll
    for (int k = 0; k < SIN; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ain[k][i] = pack_bf16(pf[k][i].x, pf[k][i].y);
    }
    // the next group's loads go out before this group's layers
    const long long r1 = group_row(++q, per_warp, tile, warp);
    if (r1 < n) load_input<SIN>(pf, x, r1, n, in0, vec2 != 0, g, t);
    mlp_group<KIN, KH>(ain, wfrag, bias, p, slope, o, out, r0, n, lane);
    r0 = r1;
  }
}

size_t smem_bytes(const int* sizes, int n_layers) {
  const Padded p = padded(sizes, n_layers);
  size_t bytes = 0;
  for (int l = 0; l < n_layers; ++l)   // bf16 weights, float32 bias
    bytes += (size_t)p.pad_in(l) * p.pad_out(l) * 2 + (size_t)p.pad_out(l) * 4;
  return bytes;
}

// The one place the kernel's limits are checked: 0 when it takes this MLP
// and tile on the current device, else -1 with the reason written to msg.
int check_config(const int* sizes, int n_layers, int tile, char* msg, int len) {
  if (n_layers < 1 || n_layers > kMaxLayers) {
    snprintf(msg, len, "%d layers, the kernel takes 1..%d", n_layers, kMaxLayers);
    return -1;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (sizes[l] < 1 || sizes[l] > kMaxWidth) {
      snprintf(msg, len, "width %d of layer input %d, the kernel takes 1..%d", sizes[l], l,
               kMaxWidth);
      return -1;
    }
  }
  if (tile < kTileQuantum || tile > kMaxTile || tile % kTileQuantum != 0) {
    snprintf(msg, len, "tile %d must be a multiple of %d in %d..%d", tile, kTileQuantum,
             kTileQuantum, kMaxTile);
    return -1;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) {
    snprintf(msg, len, "cannot read the card's shared memory limit: CUDA error %d", (int)err);
    return -1;
  }
  const size_t bytes = smem_bytes(sizes, n_layers);
  if (bytes > (size_t)optin) {
    snprintf(msg, len, "the weights need %zu bytes of shared memory, more than the card's %d",
             bytes, optin);
    return -1;
  }
  return 0;
}

using KernelFn = void (*)(MlpArgs, const float*, float*, long long, int, int);

KernelFn pick(const int* sizes, int n_layers) {
  const Padded p = padded(sizes, n_layers);
  if (p.kin == 32)
    return p.kh == 32 ? fused_mlp_kernel<32, 32>
                      : p.kh == 64 ? fused_mlp_kernel<32, 64> : fused_mlp_kernel<32, 128>;
  if (p.kin == 64) return p.kh == 64 ? fused_mlp_kernel<64, 64> : fused_mlp_kernel<64, 128>;
  return fused_mlp_kernel<128, 128>;
}

// Blocks of the persistent grid: as many as are resident at once on the
// current device (per kernel instantiation and shared memory size), and no
// more than there are tiles.  Sets the kernel's shared memory limit.
int resident_blocks(KernelFn fn, size_t bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : -1;
}

}  // namespace

// sizes: n_layers + 1 widths; tile: rows per block step.  Returns 0 when
// m3t_fused_mlp takes them on the current device, else -1 with the reason
// in msg (len bytes).
extern "C" int m3t_fused_mlp_check(const int* sizes, int n_layers, int tile, char* msg,
                                   int len) {
  return check_config(sizes, n_layers, tile, msg, len);
}

// The persistent grid's block count for n rows (at most the resident
// blocks, at least 1 for n > 0), or -1 for a configuration the kernel does
// not take.
extern "C" long long m3t_fused_mlp_grid(const int* sizes, int n_layers, long long n, int tile) {
  char msg[160];
  if (n <= 0 || check_config(sizes, n_layers, tile, msg, sizeof msg) != 0) return -1;
  int resident = 0;
  if (resident_blocks(pick(sizes, n_layers), smem_bytes(sizes, n_layers), &resident) != 0)
    return -1;
  const long long tiles = (n + tile - 1) / tile;
  return tiles < resident ? tiles : resident;
}

// w, b: n_layers device pointers each; sizes: n_layers + 1 widths; x (n,
// sizes[0]) and out (n, sizes[n_layers]) float32.  act: 0 none, 1 relu,
// 2 leaky relu (slope 0.01).  tile: rows per block step, a multiple of 64.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the
// kernel does not take (m3t_fused_mlp_check says why).
extern "C" int m3t_fused_mlp(const void* const* w, const void* const* b, const int* sizes,
                             int n_layers, int act, const void* x, void* out, long long n,
                             int tile, void* stream) {
  char msg[160];
  if (n <= 0 || act < kNone || act > kLeakyRelu) return -1;
  if (check_config(sizes, n_layers, tile, msg, sizeof msg) != 0) return -1;
  MlpArgs a;
  for (int l = 0; l <= n_layers; ++l) a.sizes[l] = sizes[l];
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
  }
  a.n_layers = n_layers;
  a.act = act;
  const KernelFn fn = pick(sizes, n_layers);
  const size_t bytes = smem_bytes(sizes, n_layers);
  int resident = 0;
  const int rc = resident_blocks(fn, bytes, &resident);
  if (rc != 0) return rc;
  const long long tiles = (n + tile - 1) / tile;
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  const int vec2 = sizes[0] % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  fn<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(x), static_cast<float*>(out), n, tile, vec2);
  return (int)cudaGetLastError();
}
