// Fused multi-layer perceptron forward: every layer of the MLP in one
// kernel, the activations kept on chip from the input to the output.
//
// Replaces the TPU kernel fused_mlp_forward
// (mitsuba3_experiments_tpu/models/pallas_mlp.py:28).  Per layer it
// computes what models/mlp.py::apply_mlp computes:
//
//   h_{l+1} = bf16( act( bf16(h_l) @ bf16(W_l) + b_l ) )     hidden layers
//   out     =            bf16(h_L) @ bf16(W_L) + b_L          last layer
//
// with products of bf16 operands accumulated in float32 (a product of two
// bf16 values is exact in float32, so fmaf adds it exactly as a separate
// multiply would), the bias and the activation in float32.
//
// Layout and schedule.  One block takes `tile` rows, one thread per row.
// The block first copies every layer's weights, rounded to bf16 and held
// as float32, and biases into shared memory (padded to a multiple of 4
// outputs per layer, for float4 reads), then the tile's input rows,
// transposed: act[k * (tile + 1) + row] (the +1 keeps the stores of the
// cooperative copy off a single bank).  Each thread then walks the layers
// of its own row: its WMAX accumulators live in registers, the inputs are
// read from its own column of `act` (consecutive threads, consecutive
// banks) and the weights by float4 broadcast (the whole warp reads the
// same address).  The layer's output overwrites the thread's own column,
// which it alone reads, so no barrier is needed between layers.  Only the
// last layer's (n, sizes[L]) output is written to device memory.
//
// Bound: float32 FMA throughput (one float4 shared-memory load per 4 FMAs).
// Widths are taken as given, up to 128; the TPU kernel's padding to 128
// lanes is not needed.  Tensor cores (mma.sync / wgmma) are not used.
//
// Built with nvcc into a shared library with a plain C interface
// (models/fused_mlp_cuda.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

struct MlpArgs {
  const float* w[kMaxLayers];   // (sizes[l], sizes[l+1]) row-major, float32
  const float* b[kMaxLayers];   // (sizes[l+1],) float32
  int sizes[kMaxLayers + 1];
  int n_layers;
  int act;
};

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float activate(float v, int act) {
  if (act == kRelu) return v > 0.0f ? v : 0.0f;
  if (act == kLeakyRelu) return v >= 0.0f ? v : 0.01f * v;
  return v;
}

// the largest tile (threads per block) each instantiation is built for
template <int WMAX> struct MaxTile { static constexpr int value = WMAX <= 64 ? 512 : 256; };

template <int WMAX>
__global__ void __launch_bounds__(MaxTile<WMAX>::value)
fused_mlp_kernel(MlpArgs a, const float* __restrict__ x, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockDim.x;
  const int stride = tile + 1;
  const int L = a.n_layers;

  int w_total = 0, b_total = 0;
  for (int l = 0; l < L; ++l) {
    w_total += a.sizes[l] * pad4(a.sizes[l + 1]);
    b_total += pad4(a.sizes[l + 1]);
  }
  float* ws = smem;
  float* bs = ws + w_total;
  float* act = bs + b_total;

  // ---- weights (bf16-rounded) and biases into shared memory ----
  {
    int woff = 0, boff = 0;
    for (int l = 0; l < L; ++l) {
      const int in = a.sizes[l], o = a.sizes[l + 1], op = pad4(o);
      const float* w = a.w[l];
      for (int e = threadIdx.x; e < in * op; e += tile) {
        const int k = e / op, j = e - k * op;
        ws[woff + e] = j < o ? bf16_round(w[k * o + j]) : 0.0f;
      }
      for (int j = threadIdx.x; j < op; j += tile) bs[boff + j] = j < o ? a.b[l][j] : 0.0f;
      woff += in * op;
      boff += op;
    }
  }
  // ---- the tile's input rows, bf16-rounded, transposed ----
  const long long row0 = (long long)blockIdx.x * tile;
  const long long left = (long long)n - row0;
  const int rows = left < tile ? (int)left : tile;
  const int in0 = a.sizes[0];
  const float* xt = x + row0 * in0;
  for (int e = threadIdx.x; e < rows * in0; e += tile) {
    const int r = e / in0, k = e - r * in0;
    act[k * stride + r] = bf16_round(xt[e]);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= rows) return;
  int woff = 0, boff = 0;
  for (int l = 0; l < L; ++l) {
    const int in = a.sizes[l], o = a.sizes[l + 1], op = pad4(o);
    float acc[WMAX];
#pragma unroll
    for (int j = 0; j < WMAX; ++j) acc[j] = 0.0f;
    for (int k = 0; k < in; ++k) {
      const float hk = act[k * stride + t];
      const float4* wr = reinterpret_cast<const float4*>(ws + woff + k * op);
#pragma unroll
      for (int c = 0; c < WMAX / 4; ++c) {
        if (4 * c < op) {
          const float4 w = wr[c];
          acc[4 * c + 0] = fmaf(hk, w.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(hk, w.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(hk, w.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(hk, w.w, acc[4 * c + 3]);
        }
      }
    }
    const bool last = l == L - 1;
    float* orow = out + (row0 + t) * o;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
      if (j < o) {
        const float v = acc[j] + bs[boff + j];
        if (last) {
          orow[j] = v;
        } else {
          act[j * stride + t] = bf16_round(activate(v, a.act));
        }
      }
    }
    woff += in * op;
    boff += op;
  }
}

size_t smem_bytes(const int* sizes, int n_layers, int tile) {
  size_t w = 0, b = 0;
  int amax = 0;
  for (int l = 0; l < n_layers; ++l) {
    w += (size_t)sizes[l] * pad4(sizes[l + 1]);
    b += pad4(sizes[l + 1]);
    amax = sizes[l] > amax ? sizes[l] : amax;
  }
  return (w + b + (size_t)amax * (tile + 1)) * sizeof(float);
}

// The one place the kernel's limits are checked: 0 when it takes this MLP
// and tile on the current device, else -1 with the reason written to msg.
int check_config(const int* sizes, int n_layers, int tile, char* msg, int len) {
  if (n_layers < 1 || n_layers > kMaxLayers) {
    snprintf(msg, len, "%d layers, the kernel takes 1..%d", n_layers, kMaxLayers);
    return -1;
  }
  int wmax = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (sizes[l] < 1 || sizes[l] > kMaxWidth) {
      snprintf(msg, len, "width %d of layer input %d, the kernel takes 1..%d", sizes[l], l,
               kMaxWidth);
      return -1;
    }
    if (l > 0 && sizes[l] > wmax) wmax = sizes[l];
  }
  const int max_tile = wmax <= 64 ? MaxTile<64>::value : MaxTile<128>::value;
  if (tile < 32 || tile % 32 != 0 || tile > max_tile) {
    snprintf(msg, len, "tile %d must be a multiple of 32 in 32..%d for output widths up to %d",
             tile, max_tile, wmax);
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
  const size_t bytes = smem_bytes(sizes, n_layers, tile);
  if (bytes > (size_t)optin) {
    snprintf(msg, len, "tile %d needs %zu bytes of shared memory, more than the card's %d",
             tile, bytes, optin);
    return -1;
  }
  return 0;
}

template <int WMAX>
int launch(const MlpArgs& a, const float* x, float* out, int n, int tile, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.sizes, a.n_layers, tile);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<WMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((long long)n + tile - 1) / tile);
  fused_mlp_kernel<WMAX><<<blocks, tile, bytes, s>>>(a, x, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// sizes: n_layers + 1 widths; tile: rows per block.  Returns 0 when
// m3t_fused_mlp takes them on the current device, else -1 with the reason
// in msg (len bytes).
extern "C" int m3t_fused_mlp_check(const int* sizes, int n_layers, int tile, char* msg,
                                   int len) {
  return check_config(sizes, n_layers, tile, msg, len);
}

// w, b: n_layers device pointers each; sizes: n_layers + 1 widths; x (n,
// sizes[0]) and out (n, sizes[n_layers]) float32.  act: 0 none, 1 relu,
// 2 leaky relu (slope 0.01).  tile: rows per block, a multiple of 32.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the
// kernel does not take (m3t_fused_mlp_check says why).
extern "C" int m3t_fused_mlp(const void* const* w, const void* const* b, const int* sizes,
                             int n_layers, int act, const void* x, void* out, int n, int tile,
                             void* stream) {
  char msg[160];
  if (n <= 0 || act < kNone || act > kLeakyRelu) return -1;
  if (check_config(sizes, n_layers, tile, msg, sizeof msg) != 0) return -1;
  MlpArgs a;
  int wmax = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.sizes[l] = sizes[l];
    if (l > 0 && sizes[l] > wmax) wmax = sizes[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
  }
  a.n_layers = n_layers;
  a.act = act;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wmax <= 64) return launch<64>(a, xp, op, n, tile, s);
  return launch<128>(a, xp, op, n, tile, s);
}
