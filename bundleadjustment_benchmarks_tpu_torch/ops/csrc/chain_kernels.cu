// Hopper (sm_90a) kernels of the df32 BA chain, with a plain C interface
// loaded through ctypes by ops/cuda_chain.py.
//
// They replace the two Pallas TPU kernels of the reference package,
// bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:
//   chain_blocks_kernel  <- _blocks_kernel (fused_blocks_energy)
//   chain_energy_kernel  <- _energy_kernel (fused_energy)
//
// Design: one thread per observation, 256 threads per block. Each thread
// gathers its own operands by cam_idx[k] / pt_idx[k] (the camera pack is
// (N, 27) float32 and stays in L2; points are DF hi/lo (3, M) rows), so the
// TPU's pre-gathered tiles are not needed. The per-observation math is
// chain_math.cuh. Both kernels are bound by device memory: per observation
// the blocks kernel reads ~40 B and writes 104 B of rows, the energy kernel
// only reads; ~250 float ops per observation are negligible next to that.
//
// Energy: each block reduces its threads' DF energies with a fixed shared-
// memory tree of DF adds and writes one DF partial; chain_sum_kernel then
// tree-sums the partials in DF in one block and writes hi + lo as float64.
// No atomics, so repeat launches give bit-identical energies (the LM accept
// test and the 1e-8 flatline test compare them). Observations at or past
// valid_count contribute exact zeros (the reference's _valid_mask).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

struct Operands {
  const float *cam;     // (N, 27)
  const float *pts_hi;  // (3, M)
  const float *pts_lo;  // (3, M)
  const float *meas;    // (2, K)
  const int *cam_idx;   // (K,)
  const int *pt_idx;    // (K,)
  int K, M, valid;
  float tau2;
};

__device__ __forceinline__ void load_point(const Operands &op, int k,
                                           float xh[3], float xl[3]) {
  const int p = __ldg(op.pt_idx + k);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xh[i] = __ldg(op.pts_hi + (size_t)i * op.M + p);
    xl[i] = __ldg(op.pts_lo + (size_t)i * op.M + p);
  }
}

__device__ __forceinline__ void load_cam(const Operands &op, int k,
                                         float cam[chain::kCamPack]) {
  const float *src = op.cam + (size_t)__ldg(op.cam_idx + k) * chain::kCamPack;
#pragma unroll
  for (int i = 0; i < chain::kCamPack; ++i) cam[i] = __ldg(src + i);
}

// Fixed-shape DF tree over the block; thread 0 writes the block's partial.
__device__ __forceinline__ void block_reduce_store(chain::DF v, float *part) {
  __shared__ float sh[kThreads], sl[kThreads];
  const int t = threadIdx.x;
  sh[t] = v.hi;
  sl[t] = v.lo;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      chain::DF r = chain::df_add(chain::DF{sh[t], sl[t]},
                                  chain::DF{sh[t + s], sl[t + s]});
      sh[t] = r.hi;
      sl[t] = r.lo;
    }
    __syncthreads();
  }
  if (t == 0) {
    part[2 * blockIdx.x] = sh[0];
    part[2 * blockIdx.x + 1] = sl[0];
  }
}

__global__ void __launch_bounds__(kThreads)
    chain_blocks_kernel(Operands op, float *__restrict__ rows,
                        float *__restrict__ part) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  chain::DF v{0.0f, 0.0f};
  if (k < op.K) {
    float cam[chain::kCamPack], xh[3], xl[3], out[chain::kBlockRows];
    load_cam(op, k, cam);
    load_point(op, k, xh, xl);
    chain::blocks_chain(cam, xh, xl, __ldg(op.meas + k),
                        __ldg(op.meas + op.K + k), op.tau2, out);
#pragma unroll
    for (int r = 0; r < chain::kBlockRows; ++r)
      rows[(size_t)r * op.K + k] = out[r];
    if (k < op.valid)
      v = chain::df_add(chain::prod_ff(out[0], out[0]),
                        chain::prod_ff(out[1], out[1]));
  }
  block_reduce_store(v, part);
}

__global__ void __launch_bounds__(kThreads)
    chain_energy_kernel(Operands op, float *__restrict__ part) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  chain::DF v{0.0f, 0.0f};
  if (k < op.K && k < op.valid) {
    float cam[chain::kCamPack], xh[3], xl[3];
    load_cam(op, k, cam);
    load_point(op, k, xh, xl);
    chain::DF RX[3], XX[3];
    chain::transform_df(cam, xh, xl, RX, XX);
    v = chain::energy_df(cam, XX, __ldg(op.meas + k),
                         __ldg(op.meas + op.K + k), op.tau2);
  }
  block_reduce_store(v, part);
}

// One block: strided DF accumulation in a fixed order, then a fixed tree.
__global__ void __launch_bounds__(kSumThreads)
    chain_sum_kernel(const float *__restrict__ part, int n,
                     double *__restrict__ out) {
  __shared__ float sh[kSumThreads], sl[kSumThreads];
  const int t = threadIdx.x;
  chain::DF acc{0.0f, 0.0f};
  for (int i = t; i < n; i += kSumThreads)
    acc = chain::df_add(acc, chain::DF{part[2 * i], part[2 * i + 1]});
  sh[t] = acc.hi;
  sl[t] = acc.lo;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      chain::DF r = chain::df_add(chain::DF{sh[t], sl[t]},
                                  chain::DF{sh[t + s], sl[t + s]});
      sh[t] = r.hi;
      sl[t] = r.lo;
    }
    __syncthreads();
  }
  if (t == 0) out[0] = (double)sh[0] + (double)sl[0];
}

int n_blocks(int K) { return K > 0 ? (K + kThreads - 1) / kThreads : 1; }

}  // namespace

extern "C" {

// Number of DF partials (float pairs) the launches below need as scratch.
int chain_num_partials(int K) { return n_blocks(K); }

// rows: (26, K) float32 out; part: 2 * chain_num_partials(K) float32
// scratch; energy: one float64 out. Returns the CUDA error of the launches.
int chain_blocks(const float *cam, const float *pts_hi, const float *pts_lo,
                 const float *meas, const int *cam_idx, const int *pt_idx,
                 int K, int M, int valid, float tau2, float *rows,
                 float *part, double *energy, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Operands op{cam, pts_hi, pts_lo, meas, cam_idx, pt_idx, K, M, valid, tau2};
  const int nb = n_blocks(K);
  chain_blocks_kernel<<<nb, kThreads, 0, st>>>(op, rows, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chain_sum_kernel<<<1, kSumThreads, 0, st>>>(part, nb, energy);
  return (int)cudaGetLastError();
}

int chain_energy(const float *cam, const float *pts_hi, const float *pts_lo,
                 const float *meas, const int *cam_idx, const int *pt_idx,
                 int K, int M, int valid, float tau2, float *part,
                 double *energy, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Operands op{cam, pts_hi, pts_lo, meas, cam_idx, pt_idx, K, M, valid, tau2};
  const int nb = n_blocks(K);
  chain_energy_kernel<<<nb, kThreads, 0, st>>>(op, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chain_sum_kernel<<<1, kSumThreads, 0, st>>>(part, nb, energy);
  return (int)cudaGetLastError();
}

const char *chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
