// Hopper (sm_90a) kernels of the df32 BA chain, with a plain C interface
// loaded through ctypes by ops/cuda_chain.py.
//
// They replace the two Pallas TPU kernels of the reference package,
// bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:
//   chain_blocks_kernel  <- _blocks_kernel (fused_blocks_energy): the 26
//                           planar rows (26, K) float32 and the energy;
//   chain_energy_kernel  <- _energy_kernel (fused_energy): the energy.
// The per-observation math is chain_math.cuh; the energy is float64 hi + lo
// of a DF sum over the first `valid` observations.
//
// What bounds them on the H100 (stage_profile.py --chain; PERF.md). The
// blocks kernel writes 104 B of rows per observation against ~24 B read
// (indices, measurements; points and cameras are reused from L2): 25 MB at
// K = 238k, so device memory once it runs (~2.2 TB/s measured). The energy
// kernel reads ~5 MB and issues ~236 float instructions per observation
// (none contracted under --fmad=false, plus IEEE division and square-root
// sequences); once it runs it fills neither memory (~1 TB/s) nor issue (a
// third of the rate): with <= 2 observations per thread the latency of the
// dependent gathers (index -> point and camera) stays exposed. Both pay
// fixed costs: the launch, the cold chain before the first observation can
// start, the camera staging and the cross-block energy fold at the end.
//
// Design:
//  * One launch per call. The grid is as many blocks as the card holds at
//    once (resident blocks per SM x SMs, by the occupancy API), capped at
//    what the observations need; threads walk the observations with a
//    fixed grid stride.
//  * Memory-level parallelism: the indices of the observation after next
//    and the operands of the next one are loaded before the current one is
//    computed, so the dependent gathers of two observations overlap.
//  * The cameras are read as the state holds them (float64 R, T, K, k1, k2)
//    and split into DF halves exactly as twofloat.from_f64 does, so no
//    camera pack is built per call. Each block first splits every camera
//    into shared memory ((N, 27) float32), so the float64 conversions (16
//    per clock per SM) run once per camera and block, not once per
//    observation, and the per-observation camera reads are shared memory
//    reads instead of divergent global gathers. It stages only while the
//    table fits and leaves the blocks resident per SM as registers allow
//    (N up to ~1,050 on the H100); past that, each observation fetches and
//    splits its own camera. Staging was measured only at N = 257.
//  * Deterministic single-pass energy: each thread keeps a DF partial in
//    registers, a warp folds with __shfl_down_sync DF adds, the block's
//    warps fold in one shared-memory step, and each block writes one DF
//    partial. The last block to finish (a __threadfence + atomicAdd ticket)
//    folds the partials in block-index order, writes hi + lo as float64 and
//    resets the ticket to 0. Every sum's order is fixed by the grid, not by
//    arrival, so repeat launches are bit-identical (the LM accept test and
//    the 1e-8 flatline test compare energies). The caller owns the ticket
//    and the partials (one workspace per device and stream).
// Row stores stay coalesced: thread k writes rows[r * K + k].
//
// The float64 pair, chain_blocks_f64_kernel and chain_energy_f64_kernel
// (math in chain_f64.cuh), replaces no TPU kernel: the JAX package's
// float64 chain is XLA-fused jnp. In the port they take the place of ~150
// plain PyTorch ops a prepare and ~45 a trial, and equal them bit for bit
// (the energies up to the order of their sums). Bytes bound
// them: the blocks kernel writes 26 float64 rows (208 B) an observation
// against ~40 B read (indices, measurements, the point; cameras from shared
// memory or L2), the energy kernel reads the same and writes nothing per
// observation. Their design is the df32 pair's: one launch with a resident
// grid and a fixed grid stride, the next observation's indices and
// operands loaded before the current one is computed, the cameras' 15
// float64 staged in shared memory while the table fits (N x 120 B) without
// lowering the resident blocks per SM, planar (26, K) rows in the df32
// kernel's layout with coalesced stores, and the same deterministic energy
// fold in float64 (a double partial per thread, __shfl_down_sync, one
// partial per block, the last block by a ticket folds them in block order
// and resets the ticket).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_f64.cuh"
#include "chain_math.cuh"

// The split camera table, (N, 27) float32, when a kernel stages it.
extern __shared__ float staged_cams[];
// The float64 kernels' camera table, (N, 15) float64.
extern __shared__ double staged_cams64[];

namespace {

// 512 measured best of 256, 512 and 1024 (PERF.md).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// The float64 kernels hold twice the registers an operand.
constexpr int kThreads64 = 256;
constexpr int kWarps64 = kThreads64 / 32;
constexpr int kMaxDevices = 64;

struct Operands {
  const double *R;     // (N, 3, 3)
  const double *T;     // (N, 3)
  const double *Kmat;  // (N, 3, 3); the focal length is K[n, 0, 0]
  const double *k1;    // (N,)
  const double *k2;    // (N,)
  const float *pts_hi; // (3, M)
  const float *pts_lo; // (3, M)
  const float *meas;   // (2, K)
  const int *cam_idx;  // (K,)
  const int *pt_idx;   // (K,)
  int N, K, M;
  int valid;  // observations in the energy, 0 <= valid <= K
  float tau2;
};

// The caller's workspace: the ticket and one DF partial per block.
struct Scratch {
  unsigned *ticket;
  float *part;
  double *energy;
};

// One camera as the state holds it: R (9), T (3), K[0, 0], k1, k2.
template <class Op>
__device__ __forceinline__ void fetch_cam(const Op &op, int c, double d[15]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] = __ldg(op.R + (size_t)c * 9 + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[9 + i] = __ldg(op.T + (size_t)c * 3 + i);
  d[12] = __ldg(op.Kmat + (size_t)c * 9);
  d[13] = __ldg(op.k1 + c);
  d[14] = __ldg(op.k2 + c);
}

// The camera pack of projection.planar_camera_pack: R and T split as
// twofloat.from_f64 (hi = (float)x, lo = (float)(x - (double)hi)), the
// focal length, k1 and k2 cast to float.
__device__ __forceinline__ void split_cam(const double d[15],
                                          float cam[chain::kCamPack]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    cam[i] = (float)d[i];
    cam[9 + i] = (float)(d[i] - (double)cam[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cam[18 + i] = (float)d[9 + i];
    cam[21 + i] = (float)(d[9 + i] - (double)cam[18 + i]);
  }
  cam[24] = (float)d[12];
  cam[25] = (float)d[13];
  cam[26] = (float)d[14];
}

// One observation's operands, loaded ahead of its computation.
struct Gathered {
  int c;
  float xh[3], xl[3], m0, m1;
};

__device__ __forceinline__ void gather(const Operands &op, int k, int c, int p,
                                       Gathered &g) {
  g.c = c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.xh[i] = __ldg(op.pts_hi + (size_t)i * op.M + p);
    g.xl[i] = __ldg(op.pts_lo + (size_t)i * op.M + p);
  }
  g.m0 = __ldg(op.meas + k);
  g.m1 = __ldg(op.meas + op.K + k);
}

// DF sum over the warp in a fixed shuffle tree; lane 0 holds it.
__device__ __forceinline__ chain::DF warp_sum(chain::DF v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const chain::DF o{__shfl_down_sync(0xffffffffu, v.hi, off),
                      __shfl_down_sync(0xffffffffu, v.lo, off)};
    v = chain::df_add(v, o);
  }
  return v;
}

// DF sum over the block in a fixed order; thread 0 holds it. Every thread
// of the block must call it.
__device__ __forceinline__ chain::DF block_sum(chain::DF v) {
  __shared__ float sh[kWarps], sl[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) {
    sh[warp] = v.hi;
    sl[warp] = v.lo;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? chain::DF{sh[lane], sl[lane]} : chain::DF{0.0f, 0.0f};
    v = warp_sum(v);
  }
  return v;
}

// The block's partial, then the last block's fold of all partials.
__device__ __forceinline__ void finish_energy(chain::DF v, const Scratch &s) {
  __shared__ bool last;
  v = block_sum(v);
  if (threadIdx.x == 0) {
    s.part[2 * blockIdx.x] = v.hi;
    s.part[2 * blockIdx.x + 1] = v.lo;
    __threadfence();
    last = atomicAdd(s.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  chain::DF acc{0.0f, 0.0f};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
    acc = chain::df_add(acc, chain::DF{__ldcg(s.part + 2 * b),
                                       __ldcg(s.part + 2 * b + 1)});
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    *s.energy = (double)acc.hi + (double)acc.lo;
    *s.ticket = 0u;
  }
}

// One body for both kernels: kBlocks writes the rows of all K observations
// and sums f0^2 + f1^2 over the first `valid`; the energy kernel visits
// only the first `valid`. kStaged: the block first splits every camera into
// shared memory; else each observation fetches and splits its camera.
template <bool kBlocks, bool kStaged>
__device__ __forceinline__ void chain_body(const Operands &op,
                                           float *__restrict__ rows,
                                           const Scratch &s) {
  const int n = kBlocks ? op.K : op.valid;
  const int stride = gridDim.x * kThreads;
  int k = blockIdx.x * kThreads + threadIdx.x;
  int kn = k + stride;
  // Loads first, in the order nothing waits: the indices of this and the
  // next observation and this thread's first staged camera; then this
  // observation's operands (which wait on its indices); then the staging.
  int c = 0, p = 0, cn = 0, pn = 0;
  if (k < n) {
    c = __ldg(op.cam_idx + k);
    p = __ldg(op.pt_idx + k);
  }
  if (kn < n) {
    cn = __ldg(op.cam_idx + kn);
    pn = __ldg(op.pt_idx + kn);
  }
  double d[15];
  if (kStaged && (int)threadIdx.x < op.N) fetch_cam(op, threadIdx.x, d);
  Gathered g;
  if (k < n) gather(op, k, c, p, g);
  if (kStaged) {
    for (int i = threadIdx.x; i < op.N; i += kThreads) {
      if (i != (int)threadIdx.x) fetch_cam(op, i, d);
      float cam[chain::kCamPack];
      split_cam(d, cam);
#pragma unroll
      for (int j = 0; j < chain::kCamPack; ++j)
        staged_cams[i * chain::kCamPack + j] = cam[j];
    }
    __syncthreads();
  }
  chain::DF acc{0.0f, 0.0f};
  for (; k < n; k += stride, kn += stride) {
    const Gathered cur = g;
    if (kn < n) {
      gather(op, kn, cn, pn, g);
      const int knn = kn + stride;
      if (knn < n) {
        cn = __ldg(op.cam_idx + knn);
        pn = __ldg(op.pt_idx + knn);
      }
    }
    float cam[chain::kCamPack];
    if (kStaged) {
      const float *src = staged_cams + cur.c * chain::kCamPack;
#pragma unroll
      for (int j = 0; j < chain::kCamPack; ++j) cam[j] = src[j];
    } else {
      fetch_cam(op, cur.c, d);
      split_cam(d, cam);
    }
    if (kBlocks) {
      float out[chain::kBlockRows];
      chain::blocks_chain(cam, cur.xh, cur.xl, cur.m0, cur.m1, op.tau2, out);
#pragma unroll
      for (int r = 0; r < chain::kBlockRows; ++r)
        rows[(size_t)r * op.K + k] = out[r];
      if (k < op.valid)
        acc = chain::df_add(acc, chain::df_add(chain::prod_ff(out[0], out[0]),
                                               chain::prod_ff(out[1], out[1])));
    } else {
      chain::DF RX[3], XX[3];
      chain::transform_df(cam, cur.xh, cur.xl, RX, XX);
      acc = chain::df_add(
          acc, chain::energy_df(cam, XX, cur.m0, cur.m1, op.tau2));
    }
  }
  finish_energy(acc, s);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chain_blocks_kernel(Operands op, float *__restrict__ rows, Scratch s) {
  chain_body<true, kStaged>(op, rows, s);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    chain_energy_kernel(Operands op, float *__restrict__ rows, Scratch s) {
  chain_body<false, kStaged>(op, rows, s);
}

// ---- the float64 pair ----------------------------------------------------

struct Operands64 {
  const double *R;       // (N, 3, 3)
  const double *T;       // (N, 3)
  const double *Kmat;    // (N, 3, 3); the focal length is K[n, 0, 0]
  const double *k1;      // (N,)
  const double *k2;      // (N,)
  const double *points;  // (M, 3)
  const double *meas;    // (K, 2)
  const int *cam_idx;    // (K,)
  const int *pt_idx;     // (K,)
  int N, K, M;
  double tau2, inv_tau2;  // inv_tau2 = 1 / tau2, rounded on the host
};

// The caller's workspace: the ticket, then one float64 partial per block
// from the third word (8-byte aligned).
struct Scratch64 {
  unsigned *ticket;
  double *part;
  double *energy;
};

struct Gathered64 {
  int c;
  double X[3], m0, m1;
};

__device__ __forceinline__ void gather64(const Operands64 &op, int k, int c,
                                         int p, Gathered64 &g) {
  g.c = c;
#pragma unroll
  for (int i = 0; i < 3; ++i) g.X[i] = __ldg(op.points + (size_t)p * 3 + i);
  g.m0 = __ldg(op.meas + (size_t)k * 2);
  g.m1 = __ldg(op.meas + (size_t)k * 2 + 1);
}

__device__ __forceinline__ double warp_sum64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double block_sum64(double v) {
  __shared__ double sv[kWarps64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum64(v);
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum64(lane < kWarps64 ? sv[lane] : 0.0);
  return v;
}

__device__ __forceinline__ void finish_energy64(double v, const Scratch64 &s) {
  __shared__ bool last;
  v = block_sum64(v);
  if (threadIdx.x == 0) {
    s.part[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(s.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads64)
    acc += __ldcg(s.part + b);
  acc = block_sum64(acc);
  if (threadIdx.x == 0) {
    *s.energy = acc;
    *s.ticket = 0u;
  }
}

// chain_body's walk for the float64 chain: kBlocks writes the 26 rows of
// every observation, both kernels sum f0^2 + f1^2 over all of them.
template <bool kBlocks, bool kStaged>
__device__ __forceinline__ void chain64_body(const Operands64 &op,
                                             double *__restrict__ rows,
                                             const Scratch64 &s) {
  const int n = op.K;
  const int stride = gridDim.x * kThreads64;
  int k = blockIdx.x * kThreads64 + threadIdx.x;
  int kn = k + stride;
  int c = 0, p = 0, cn = 0, pn = 0;
  if (k < n) {
    c = __ldg(op.cam_idx + k);
    p = __ldg(op.pt_idx + k);
  }
  if (kn < n) {
    cn = __ldg(op.cam_idx + kn);
    pn = __ldg(op.pt_idx + kn);
  }
  double cam[chain64::kCam];
  if (kStaged && (int)threadIdx.x < op.N) fetch_cam(op, threadIdx.x, cam);
  Gathered64 g;
  if (k < n) gather64(op, k, c, p, g);
  if (kStaged) {
    for (int i = threadIdx.x; i < op.N; i += kThreads64) {
      if (i != (int)threadIdx.x) fetch_cam(op, i, cam);
#pragma unroll
      for (int j = 0; j < chain64::kCam; ++j)
        staged_cams64[i * chain64::kCam + j] = cam[j];
    }
    __syncthreads();
  }
  double acc = 0.0;
  for (; k < n; k += stride, kn += stride) {
    const Gathered64 cur = g;
    if (kn < n) {
      gather64(op, kn, cn, pn, g);
      const int knn = kn + stride;
      if (knn < n) {
        cn = __ldg(op.cam_idx + knn);
        pn = __ldg(op.pt_idx + knn);
      }
    }
    if (kStaged) {
      const double *src = staged_cams64 + cur.c * chain64::kCam;
#pragma unroll
      for (int j = 0; j < chain64::kCam; ++j) cam[j] = src[j];
    } else {
      fetch_cam(op, cur.c, cam);
    }
    if (kBlocks)
      acc += chain64::blocks(cam, cur.X, cur.m0, cur.m1, op.tau2,
                             op.inv_tau2, rows + k, (size_t)op.K);
    else
      acc += chain64::energy(cam, cur.X, cur.m0, cur.m1, op.tau2,
                             op.inv_tau2);
  }
  finish_energy64(acc, s);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads64)
    chain_blocks_f64_kernel(Operands64 op, double *__restrict__ rows,
                            Scratch64 s) {
  chain64_body<true, kStaged>(op, rows, s);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads64)
    chain_energy_f64_kernel(Operands64 op, double *__restrict__ rows,
                            Scratch64 s) {
  chain64_body<false, kStaged>(op, rows, s);
}

// ---- launches -----------------------------------------------------------------

enum Which {
  kBlocksKernel = 0,
  kEnergyKernel = 1,
  kBlocksF64 = 2,
  kEnergyF64 = 3,
  kKinds = 4
};
// By Which, then staged.
const void *const kKernels[kKinds][2] = {
    {(const void *)chain_blocks_kernel<false>,
     (const void *)chain_blocks_kernel<true>},
    {(const void *)chain_energy_kernel<false>,
     (const void *)chain_energy_kernel<true>},
    {(const void *)chain_blocks_f64_kernel<false>,
     (const void *)chain_blocks_f64_kernel<true>},
    {(const void *)chain_energy_f64_kernel<false>,
     (const void *)chain_energy_f64_kernel<true>}};
// Threads a block and staged bytes a camera, by Which.
constexpr int kKindThreads[kKinds] = {kThreads, kThreads, kThreads64,
                                      kThreads64};
constexpr int kCamBytes[kKinds] = {
    chain::kCamPack * (int)sizeof(float), chain::kCamPack * (int)sizeof(float),
    chain64::kCam * (int)sizeof(double), chain64::kCam * (int)sizeof(double)};

// What a launch needs to know of the current device, found once per device:
// SMs, thread slots per SM and the shared memory a block may opt in to; and,
// per kernel, the resident blocks per SM unstaged and staged (for the last
// staging size asked).
struct Device {
  int sms = 0, threads_per_sm = 0, smem_optin = 0;
  int plain_per_sm[kKinds] = {-1, -1, -1, -1};
  int staged_smem[kKinds] = {-1, -1, -1, -1}, staged_per_sm[kKinds] = {};
};

cudaError_t device(Device **out) {
  static Device devices[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device &d = devices[dev];
  if (d.sms == 0) {
    int sms = 0, threads = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int w = 0; w < kKinds && err == cudaSuccess; ++w)
      err = cudaFuncSetAttribute(kKernels[w][1],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - 1024);  // the static shared memory
    if (err != cudaSuccess) return err;
    d.threads_per_sm = threads;
    d.smem_optin = optin - 1024;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

struct Shape {
  const void *kernel;
  int grid, threads, per_sm, smem;
  bool staged;
};

// The launch of kernel `which` over `n` observations with N cameras:
// staged when the cameras fit in a block's shared memory and staging keeps
// as many blocks resident per SM as the unstaged kernel (for the df32 pair
// registers allow 2 of 512 per SM, so up to ~1,050 cameras on the H100);
// as many blocks as the card holds at once, but no more than the
// observations need.
cudaError_t shape_for(int which, int N, int n, Shape *out) {
  Device *d;
  cudaError_t err = device(&d);
  if (err != cudaSuccess) return err;
  const int threads = kKindThreads[which];
  if (d->plain_per_sm[which] < 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kKernels[which][0], threads, 0);
    if (err != cudaSuccess) return err;
    d->plain_per_sm[which] = per_sm;
  }
  const int smem = N * kCamBytes[which];
  bool staged = smem <= d->smem_optin;
  if (staged && d->staged_smem[which] != smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kKernels[which][1], threads, smem);
    if (err != cudaSuccess) return err;
    d->staged_per_sm[which] = per_sm;
    d->staged_smem[which] = smem;
  }
  staged = staged && d->staged_per_sm[which] >= d->plain_per_sm[which];
  const int per_sm =
      staged ? d->staged_per_sm[which] : d->plain_per_sm[which];
  const int need = n > 0 ? (n + threads - 1) / threads : 1;
  const int resident = per_sm * d->sms;
  *out = Shape{kKernels[which][staged],
               need < resident ? need : (resident > 0 ? resident : 1),
               threads, per_sm, staged ? smem : 0, staged};
  return cudaSuccess;
}

Operands operands(const double *R, const double *T, const double *Kmat,
                  const double *k1, const double *k2, const float *pts_hi,
                  const float *pts_lo, const float *meas, const int *cam_idx,
                  const int *pt_idx, int N, int K, int M, int valid,
                  float tau2) {
  valid = valid < 0 ? 0 : (valid > K ? K : valid);
  return Operands{R,      T,       Kmat,   k1, k2, pts_hi, pts_lo, meas,
                  cam_idx, pt_idx, N, K, M, valid, tau2};
}

// One launch of `which` over `n` observations; `args` are its three
// arguments (operands, rows, scratch).
int launch(int which, int N, int n, void **args, void *stream) {
  Shape sh;
  cudaError_t err = shape_for(which, N, n, &sh);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(sh.kernel, dim3(sh.grid), dim3(sh.threads), args,
                         sh.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch32(int which, const Operands &op, float *rows, int *workspace,
             double *energy, void *stream) {
  Operands o = op;
  Scratch s{reinterpret_cast<unsigned *>(workspace),
            reinterpret_cast<float *>(workspace + 1), energy};
  void *args[] = {&o, &rows, &s};
  return launch(which, op.N, which == kBlocksKernel ? op.K : op.valid, args,
                stream);
}

int launch64(int which, Operands64 op, double *rows, int *workspace,
             double *energy, void *stream) {
  Scratch64 s{reinterpret_cast<unsigned *>(workspace),
              reinterpret_cast<double *>(workspace + 2), energy};
  void *args[] = {&op, &rows, &s};
  return launch(which, op.N, op.K, args, stream);
}

}  // namespace

extern "C" {

// int32 words of the workspace the launches need on the current device: a
// ticket (zero between launches), a pad word, and room for one float64 (or
// DF) partial per block of the largest grid the device can hold at once.
int chain_workspace_words(int *words) {
  Device *d;
  cudaError_t err = device(&d);
  if (err != cudaSuccess) return (int)err;
  *words = 2 + 2 * d->sms * (d->threads_per_sm / kThreads64);
  return 0;
}

// The launch of kernel `which` (0 blocks, 1 energy, 2 float64 blocks, 3
// float64 energy) for N cameras and K observations, `valid` of them in the
// df32 energy: out = {grid, threads, resident blocks per SM, SMs, staged
// (0 or 1)}.
int chain_launch_shape(int which, int N, int K, int valid, int *out) {
  Device *d;
  Shape sh;
  if (which < 0 || which >= kKinds) return (int)cudaErrorInvalidValue;
  valid = valid < 0 ? 0 : (valid > K ? K : valid);
  cudaError_t err = device(&d);
  if (err == cudaSuccess)
    err = shape_for(which, N, which == kEnergyKernel ? valid : K, &sh);
  if (err != cudaSuccess) return (int)err;
  out[0] = sh.grid;
  out[1] = sh.threads;
  out[2] = sh.per_sm;
  out[3] = d->sms;
  out[4] = sh.staged;
  return 0;
}

// rows: (26, K) float32 out; workspace: chain_workspace_words int32, its
// first word 0; energy: one float64 out. Returns the launch's CUDA error.
int chain_blocks(const double *R, const double *T, const double *Kmat,
                 const double *k1, const double *k2, const float *pts_hi,
                 const float *pts_lo, const float *meas, const int *cam_idx,
                 const int *pt_idx, int N, int K, int M, int valid, float tau2,
                 float *rows, int *workspace, double *energy, void *stream) {
  return launch32(kBlocksKernel,
                  operands(R, T, Kmat, k1, k2, pts_hi, pts_lo, meas, cam_idx,
                           pt_idx, N, K, M, valid, tau2),
                  rows, workspace, energy, stream);
}

int chain_energy(const double *R, const double *T, const double *Kmat,
                 const double *k1, const double *k2, const float *pts_hi,
                 const float *pts_lo, const float *meas, const int *cam_idx,
                 const int *pt_idx, int N, int K, int M, int valid, float tau2,
                 int *workspace, double *energy, void *stream) {
  return launch32(kEnergyKernel,
                  operands(R, T, Kmat, k1, k2, pts_hi, pts_lo, meas, cam_idx,
                           pt_idx, N, K, M, valid, tau2),
                  nullptr, workspace, energy, stream);
}

// The float64 pair. points (M, 3), measurements (K, 2); rows: (26, K)
// float64 out, or null for the energy kernel (which = 3); workspace and
// energy as above.
int chain_f64(int which, const double *R, const double *T, const double *Kmat,
              const double *k1, const double *k2, const double *points,
              const double *meas, const int *cam_idx, const int *pt_idx,
              int N, int K, int M, double tau2, double inv_tau2, double *rows,
              int *workspace, double *energy, void *stream) {
  if (which != kBlocksF64 && which != kEnergyF64)
    return (int)cudaErrorInvalidValue;
  return launch64(which,
                  Operands64{R, T, Kmat, k1, k2, points, meas, cam_idx, pt_idx,
                             N, K, M, tau2, inv_tau2},
                  rows, workspace, energy, stream);
}

const char *chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
