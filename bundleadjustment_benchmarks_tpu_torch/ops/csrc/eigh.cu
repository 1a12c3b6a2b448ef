// Symmetric eigendecomposition by block Jacobi, for CUDA graphs (sm_90a).
//
// qrkit on a problem without pair tables factors its augmented camera gram
// (9N+1 square) once per LM iteration through a Jacobi-scaled
// eigendecomposition (solvers/schur.py, _gram_sqrt_factor). The JAX package
// leaves that to XLA's eigh; it is no Pallas kernel. torch.linalg.eigh on
// CUDA reads its info flag on the host, and cuSOLVER's syevd and syevj
// synchronize inside (probed on an H100: both invalidate a stream capture),
// so neither can sit in the jit drive's graph. This file is a two-sided
// block Jacobi method whose every step is a kernel launch with no host read:
// a captured run replays the same launches, and convergence is a device
// flag that makes the remaining launches return at once.
//
// The matrix is padded to n_pad = a multiple of 2B (padding rows and columns
// are zero, so no rotation ever couples them). It is cut into n_pad / B
// blocks of B rows; each round of the circle method pairs every block with
// one other, and each pair's 2B x 2B subproblem is diagonalized in shared
// memory by cyclic Jacobi (pair_eig, one thread block per pair), giving an
// orthogonal Q_k. The rounds then apply all Q_k at once: A <- P^T A P and
// V <- V P (apply_rows, apply_cols), P the block-diagonal product of the
// Q_k. n_pad / B - 1 rounds are a sweep, in which every pair of blocks
// meets once. A rotation is skipped where |a_pq| <= thr (eps ||A||_F, set by
// the caller on the device); a sweep in which no subproblem rotated leaves A
// as it was, so its end sets `done`. Bounded by memory: each round reads
// and writes A twice and V once (6 n_pad^2 elements), so a sweep moves
// about 6 n_pad^3 / B elements; a subproblem that did not rotate skips its
// tiles of the apply kernels. Everything runs in float64 (a float32 caller's
// matrix too): the many rounds leave V orthonormal only to ~1e-11 at
// n = 2,314 (measured on the H100), which the caller's Newton-Schulz step and
// Rayleigh quotients in float64 take to ~1e-13 (ops/cuda_eigh.py).
//
// Plain C interface, loaded with ctypes (ops/cuda_eigh.py); jacobi_eigh
// returns a cudaError_t as int (0 = success).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int B = 16;        // rows of a block
constexpr int P = 2 * B;     // size of a pair's subproblem
constexpr int TILE = 64;     // columns (rows) of A per block of the apply kernels
constexpr int THREADS = 256;
constexpr int INNER_SWEEPS = 8;  // cap of a subproblem's cyclic Jacobi sweeps
using T = double;  // float32 callers' matrices run in float64 too

// Pair k of round r among m + 1 players (m odd): players 0..m-1 on a circle,
// player m fixed. Over m rounds every two players meet once.
__host__ __device__ inline void pair_of(int r, int k, int players, int *a, int *b) {
  const int m = players - 1;
  if (k == 0) {
    *a = r;
    *b = m;
  } else {
    *a = (r + k) % m;
    *b = (r - k + m) % m;
  }
}

// Global row of local index i (0..P-1) of the subproblem of blocks I, J.
__device__ inline int row_of(int I, int J, int i) {
  return i < B ? I * B + i : J * B + (i - B);
}

// Diagonalize the subproblem of pair blockIdx.x of round `round` by cyclic
// Jacobi; write its Q (P x P, row-major) and whether it rotated.
__global__ void __launch_bounds__(THREADS)
pair_eig(const T *__restrict__ A, T *__restrict__ Qs, int *__restrict__ moved,
         int n_pad, int round, const T *thr_p, const int *done, int *rotated) {
  if (*done) return;
  __shared__ T a[P][P + 1];
  __shared__ T q[P][P + 1];
  __shared__ T cs[B], sn[B], dp[B], dq[B];
  __shared__ int pp[B], qq[B], rot[B];
  __shared__ int any, ever;
  int I, J;
  pair_of(round, blockIdx.x, n_pad / B, &I, &J);
  const T thr = *thr_p;
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) {
    const int i = e / P, j = e % P;
    a[i][j] = A[(size_t)row_of(I, J, i) * n_pad + row_of(I, J, j)];
    q[i][j] = i == j ? T(1) : T(0);
  }
  if (threadIdx.x == 0) ever = 0;
  for (int sweep = 0; sweep < INNER_SWEEPS; ++sweep) {
    if (threadIdx.x == 0) any = 0;
    __syncthreads();
    for (int r = 0; r < P - 1; ++r) {
      if (threadIdx.x < B) {
        const int t = threadIdx.x;
        int p, s;
        pair_of(r, t, P, &p, &s);
        const T apq = a[p][s];
        T app = a[p][p], ass = a[s][s], c = 1, sv = 0;
        const bool go = fabs(apq) > thr;
        if (go) {
          // Golub and Van Loan's symmetric Schur rotation (Alg. 8.5.1).
          const T theta = (ass - app) / (T(2) * apq);
          const T tt = copysign(T(1), theta) / (fabs(theta) + hypot(T(1), theta));
          c = T(1) / sqrt(T(1) + tt * tt);
          sv = tt * c;
          app -= tt * apq;
          ass += tt * apq;
          any = 1;
        }
        pp[t] = p;
        qq[t] = s;
        rot[t] = go;
        cs[t] = c;
        sn[t] = sv;
        dp[t] = app;
        dq[t] = ass;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < B * P; e += blockDim.x) {  // rows: J^T A
        const int t = e / P, j = e % P;
        if (!rot[t]) continue;
        const T x = a[pp[t]][j], y = a[qq[t]][j];
        a[pp[t]][j] = cs[t] * x - sn[t] * y;
        a[qq[t]][j] = sn[t] * x + cs[t] * y;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < B * P; e += blockDim.x) {  // columns: A J, Q J
        const int t = e / P, i = e % P;
        if (!rot[t]) continue;
        const int p = pp[t], s = qq[t];
        const T x = a[i][p], y = a[i][s];
        a[i][p] = cs[t] * x - sn[t] * y;
        a[i][s] = sn[t] * x + cs[t] * y;
        const T u = q[i][p], v = q[i][s];
        q[i][p] = cs[t] * u - sn[t] * v;
        q[i][s] = sn[t] * u + cs[t] * v;
      }
      __syncthreads();
      if (threadIdx.x < B && rot[threadIdx.x]) {
        const int t = threadIdx.x;
        a[pp[t]][pp[t]] = dp[t];
        a[qq[t]][qq[t]] = dq[t];
        a[pp[t]][qq[t]] = T(0);
        a[qq[t]][pp[t]] = T(0);
      }
      __syncthreads();
    }
    const bool again = any;
    __syncthreads();  // every thread has read `any` before it is reset
    if (again && threadIdx.x == 0) ever = 1;
    if (!again) break;
  }
  __syncthreads();
  T *Q = Qs + (size_t)blockIdx.x * P * P;
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) Q[e] = q[e / P][e % P];
  if (threadIdx.x == 0) {
    moved[blockIdx.x] = ever;
    if (ever) atomicAdd(rotated, 1);
  }
}

// Rows of pair blockIdx.x, columns of tile blockIdx.y: A[rows] <- Q^T A[rows].
__global__ void __launch_bounds__(THREADS)
apply_rows(T *__restrict__ A, const T *__restrict__ Qs, const int *__restrict__ moved,
           int n_pad, int round, const int *done) {
  if (*done || !moved[blockIdx.x]) return;
  __shared__ T q[P][P + 1];
  __shared__ T m[P][TILE + 1];
  int I, J;
  pair_of(round, blockIdx.x, n_pad / B, &I, &J);
  const int col0 = blockIdx.y * TILE;
  const int cols = min(TILE, n_pad - col0);
  const T *Q = Qs + (size_t)blockIdx.x * P * P;
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) q[e / P][e % P] = Q[e];
  for (int e = threadIdx.x; e < P * TILE; e += blockDim.x) {
    const int i = e / TILE, j = e % TILE;
    if (j < cols) m[i][j] = A[(size_t)row_of(I, J, i) * n_pad + col0 + j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * TILE; e += blockDim.x) {
    const int i = e / TILE, j = e % TILE;
    if (j >= cols) continue;
    T acc = 0;
    for (int l = 0; l < P; ++l) acc += q[l][i] * m[l][j];
    A[(size_t)row_of(I, J, i) * n_pad + col0 + j] = acc;
  }
}

// Columns of pair blockIdx.x, rows of tile blockIdx.y, of A (z = 0) or V
// (z = 1): M[:, cols] <- M[:, cols] Q.
__global__ void __launch_bounds__(THREADS)
apply_cols(T *__restrict__ A, T *__restrict__ V, const T *__restrict__ Qs,
           const int *__restrict__ moved, int n_pad, int round, const int *done) {
  if (*done || !moved[blockIdx.x]) return;
  __shared__ T q[P][P + 1];
  __shared__ T m[TILE][P + 1];
  T *M = blockIdx.z == 0 ? A : V;
  int I, J;
  pair_of(round, blockIdx.x, n_pad / B, &I, &J);
  const int row0 = blockIdx.y * TILE;
  const int rows = min(TILE, n_pad - row0);
  const T *Q = Qs + (size_t)blockIdx.x * P * P;
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) q[e / P][e % P] = Q[e];
  for (int e = threadIdx.x; e < TILE * P; e += blockDim.x) {
    const int i = e / P, l = e % P;
    if (i < rows) m[i][l] = M[(size_t)(row0 + i) * n_pad + row_of(I, J, l)];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * P; e += blockDim.x) {
    const int i = e / P, j = e % P;
    if (i >= rows) continue;
    T acc = 0;
    for (int l = 0; l < P; ++l) acc += m[i][l] * q[l][j];
    M[(size_t)(row0 + i) * n_pad + row_of(I, J, j)] = acc;
  }
}

// A sweep's end: done where no subproblem rotated in it; count the sweep.
__global__ void sweep_end(int *done, int *rotated, int *sweeps) {
  if (*done) return;
  if (*rotated == 0) *done = 1;
  *rotated = 0;
  *sweeps += 1;
}

cudaError_t run(T *A, T *V, T *Qs, int *moved, int n_pad, const T *thr,
                int *flags, int max_sweeps, cudaStream_t stream) {
  int *done = flags, *rotated = flags + 1, *sweeps = flags + 2;
  const int blocks = n_pad / B, pairs = blocks / 2;
  const int tiles = (n_pad + TILE - 1) / TILE;
  for (int s = 0; s < max_sweeps; ++s) {
    for (int r = 0; r < blocks - 1; ++r) {
      pair_eig<<<pairs, THREADS, 0, stream>>>(A, Qs, moved, n_pad, r, thr,
                                                 done, rotated);
      apply_rows<<<dim3(pairs, tiles), THREADS, 0, stream>>>(A, Qs, moved, n_pad,
                                                                r, done);
      apply_cols<<<dim3(pairs, tiles, 2), THREADS, 0, stream>>>(
          A, V, Qs, moved, n_pad, r, done);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    sweep_end<<<1, 1, 0, stream>>>(done, rotated, sweeps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Eigenvalues of the symmetric n_pad x n_pad float64 `A` (row-major) on its
// diagonal and eigenvectors in the columns of `V` (which must hold the
// identity), in place, on `stream`. `Qs` holds n_pad / (2B) P x P
// matrices, `moved` as many ints; `flags` three device ints, zeroed: done,
// rotations in the current sweep, sweeps run. `thr` is the device scalar
// below which an off-diagonal entry is not rotated.
int jacobi_eigh(void *A, void *V, void *Qs, int *moved, int n_pad,
                const void *thr, int *flags, int max_sweeps, void *stream) {
  if (n_pad % P != 0 || n_pad < P) return (int)cudaErrorInvalidValue;
  return (int)run(static_cast<T *>(A), static_cast<T *>(V), static_cast<T *>(Qs),
                  moved, n_pad, static_cast<const T *>(thr), flags, max_sweeps,
                  static_cast<cudaStream_t>(stream));
}

int jacobi_block_rows() { return B; }

const char *jacobi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
