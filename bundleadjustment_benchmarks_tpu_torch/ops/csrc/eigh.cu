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
// The matrix is padded to n_pad = a multiple of P = 2B (padding rows and
// columns are zero, so no rotation ever couples them) and cut into
// n_pad / B blocks of B rows. Each round of the circle method pairs every
// block with one other; n_pad / B - 1 rounds are a sweep, in which every
// two blocks meet once. A round is two launches:
//
//   pair_solve  a block of 4 warps per pair diagonalizes the pair's P x P
//               subproblem in shared memory by cyclic Jacobi, B disjoint
//               rotations a step, two barriers a step, for at most
//               INNER_SWEEPS (one) cyclic sweeps. It writes Q_k and whether
//               the pair rotated. The
//               same launch's other blocks update V with the round before's
//               Q_k: V feeds no pair solve, so its update runs beside the
//               pair solves, whose blocks are bound by latency, and not on
//               the path from one round's A to the next's.
//   update      A <- P^T A P, P the block-diagonal product of the Q_k: a
//               block owns the tile of a row pair a and a column pair
//               b >= a and writes Q_a^T A[a, b] Q_b; a tile whose pairs did
//               not rotate returns at once.
//
// A is symmetric, so only its blocks (X, Y) with X <= Y are kept (`canon`):
// the update reads and writes half of A, a block X > Y as the transpose of
// (Y, X). V is kept transposed, so a round's V update reads and writes
// rows of P contiguous values. A round thus moves A once and V twice (read
// and write), 3 n_pad^2 float64 values, ~131 MB at n = 2,314: ~39 µs at
// 3.35 TB/s, against 2 n_pad^2 P multiply-adds (0.70 GFLOP, ~10 µs on the
// FP64 tensor cores, where the tiles' products run: mma.sync m8n8k4, 4
// warps a P x P product). The pair solves are bound by the latency of their
// steps, 31 steps of two barriers each a round. A rotation is skipped where
// |a_pq| <= thr (eps ||A||_F, set by the caller on the device); a sweep in
// which no subproblem rotated leaves A as it was, so its end sets `done`.
// Everything runs in float64 (a float32 caller's matrix too): the many
// rounds leave V orthonormal only to ~1e-11 at n = 2,314 (measured on the
// H100), which the caller's Newton-Schulz step and Rayleigh quotients in
// float64 take to ~1e-13 (ops/cuda_eigh.py). The times and the split
// between the two launches are in PERF.md (chip_smoke.py eigh_capture).
//
// Plain C interface, loaded with ctypes (ops/cuda_eigh.py); jacobi_eigh
// returns a cudaError_t as int (0 = success).

#include <cuda_runtime.h>

namespace {

using T = double;  // float32 callers' matrices run in float64 too
constexpr unsigned FULL = 0xffffffffu;
constexpr int B = 16;      // rows of a block
constexpr int P = 2 * B;   // a pair's subproblem is P x P
constexpr int LD = P + 4;  // row stride of the tiles in shared memory
constexpr int UT = 128;    // threads of every block of the solve: 4 warps
// Cap of a pair solve's cyclic sweeps a round. Block Jacobi converges on
// subproblems that are only partly diagonalized, since every two blocks meet
// again in the next sweep: on the H100 at n = 2,314 (the p257 gram) caps of
// 1, 2, 4 and 8 took 17, 18, 17 and 18 outer sweeps, and a cap of 8 twice
// the time of 1 (PERF.md, the eigensolver's design runs).
constexpr int INNER_SWEEPS = 1;

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

// Where element (r, c) of the symmetric n x n matrix is kept: in block
// (r / B, c / B) where that is on or above the block diagonal, else at
// (c, r).
__device__ inline size_t canon(int r, int c, int n) {
  return r / B <= c / B ? (size_t)r * n + c : (size_t)c * n + r;
}

__host__ __device__ constexpr size_t pair_solve_smem() {
  return (2 * P * (P + 1) + 2 * 4 * B) * sizeof(T) + 2 * B * sizeof(int) +
         (P - 1) * B * sizeof(char2);
}

// Diagonalize the subproblem of pair k of round `round` by at most
// INNER_SWEEPS cyclic Jacobi sweeps; write its Q (P x P, row-major) and
// whether it rotated. A step of B disjoint rotations is two phases between
// two barriers: warp 0 computes the step's rotations while the other warps
// apply the step before's to Q's columns; then every thread applies the
// step's rotations to 2 x 2 blocks of the subproblem, rows and columns at
// once (the upper blocks computed and mirrored, so it stays exactly
// symmetric), its loads issued before its stores. `stats` (or null)
// gathers, per outer sweep, the pairs that rotated, the inner sweeps run
// and the rotations.
__device__ inline void solve_pair(const T *__restrict__ A, T *__restrict__ Qs,
                                  int *__restrict__ moved, int k, int n, int round,
                                  const T *thr_p, const int *flags, int *rotated,
                                  int *stats) {
  constexpr int NT = UT, NQ = NT - 32;
  constexpr int UA = (B * B + NT - 1) / NT, UQ = (P * B + NQ - 1) / NQ;
  extern __shared__ __align__(16) T smem[];
  T(*a)[P + 1] = reinterpret_cast<T(*)[P + 1]>(smem);
  T(*q)[P + 1] = reinterpret_cast<T(*)[P + 1]>(smem + P * (P + 1));
  // Per step parity: cosine, sine, new a_pp, new a_ss of each rotation.
  T(*rv)[4][B] = reinterpret_cast<T(*)[4][B]>(smem + 2 * P * (P + 1));
  int(*rot)[B] = reinterpret_cast<int(*)[B]>(smem + 2 * P * (P + 1) + 2 * 4 * B);
  char2(*at)[B] = reinterpret_cast<char2(*)[B]>(rot + 2 * B);  // step r's pair t
  const int tid = threadIdx.x;
  int I, J;
  pair_of(round, k, n / B, &I, &J);
  for (int e = tid; e < (P - 1) * B; e += NT) {
    int p, s;
    pair_of(e / B, e % B, P, &p, &s);
    at[e / B][e % B] = make_char2(p, s);
  }
  for (int e = tid; e < P * P; e += NT) {
    const int i = e / P, j = e % P;
    const int r = i < B ? I * B + i : J * B + i - B;
    const int c = j < B ? I * B + j : J * B + j - B;
    a[i][j] = A[canon(r, c, n)];
    q[i][j] = i == j ? T(1) : T(0);
  }
  const T thr = *thr_p;
  int ever = 0, inner = 0, rots = 0;
  __syncthreads();
  for (int sweep = 0; sweep < INNER_SWEEPS; ++sweep) {
    int any = 0;
    for (int r = 0; r < P; ++r) {  // step P - 1 only finishes Q
      if (tid < B && r < P - 1) {
        // The symmetric Schur rotation of rows and columns p, s (Golub and
        // Van Loan, Alg. 8.5.1), its tangent as sgn(d) 2 a_ps / (|d| + r),
        // d = a_ss - a_pp, r = sqrt(d^2 + 4 a_ps^2).
        const int p = at[r][tid].x, s = at[r][tid].y;
        const T apq = a[p][s], app = a[p][p], ass = a[s][s];
        const bool go = fabs(apq) > thr;
        T c = 1, sv = 0;
        if (go) {
          const T d = ass - app, b2 = T(2) * apq;
          const T t = copysign(T(1), d) * b2 / (fabs(d) + sqrt(d * d + b2 * b2));
          c = rsqrt(T(1) + t * t);
          sv = t * c;
          rv[r & 1][2][tid] = app - t * apq;
          rv[r & 1][3][tid] = ass + t * apq;
        }
        rv[r & 1][0][tid] = c;
        rv[r & 1][1][tid] = sv;
        rot[r & 1][tid] = go;
        any |= go;
        rots += go;
      } else if (tid >= 32 && r > 0) {  // Q J of step r - 1
        const int pr = (r - 1) & 1;
        T x[UQ], y[UQ];
        int p[UQ], s[UQ];
#pragma unroll
        for (int u = 0; u < UQ; ++u) {
          const int e = tid - 32 + u * NQ, t = e / P, i = e % P;
          p[u] = -1;
          if (e < P * B && rot[pr][t]) {
            p[u] = at[r - 1][t].x;
            s[u] = at[r - 1][t].y;
            x[u] = q[i][p[u]];
            y[u] = q[i][s[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < UQ; ++u) {
          if (p[u] < 0) continue;
          const int e = tid - 32 + u * NQ, t = e / P, i = e % P;
          const T c = rv[pr][0][t], sv = rv[pr][1][t];
          q[i][p[u]] = c * x[u] - sv * y[u];
          q[i][s[u]] = sv * x[u] + c * y[u];
        }
      }
      __syncthreads();
      if (r == P - 1) break;
      const int pr = r & 1;
      T z[UA][4];
      int p1[UA], s1[UA], p2[UA], s2[UA];
      bool on[UA];
#pragma unroll
      for (int u = 0; u < UA; ++u) {  // block (t1, t2): J1^T X J2
        const int e = tid + u * NT, t1 = e / B, t2 = e % B;
        on[u] = e < B * B && t1 < t2 && (rot[pr][t1] | rot[pr][t2]);
        if (!on[u]) continue;
        p1[u] = at[r][t1].x;
        s1[u] = at[r][t1].y;
        p2[u] = at[r][t2].x;
        s2[u] = at[r][t2].y;
        const T c1 = rv[pr][0][t1], n1 = rv[pr][1][t1];
        const T c2 = rv[pr][0][t2], n2 = rv[pr][1][t2];
        const T x11 = a[p1[u]][p2[u]], x12 = a[p1[u]][s2[u]];
        const T x21 = a[s1[u]][p2[u]], x22 = a[s1[u]][s2[u]];
        const T y11 = c1 * x11 - n1 * x21, y12 = c1 * x12 - n1 * x22;
        const T y21 = n1 * x11 + c1 * x21, y22 = n1 * x12 + c1 * x22;
        z[u][0] = c2 * y11 - n2 * y12;
        z[u][1] = n2 * y11 + c2 * y12;
        z[u][2] = c2 * y21 - n2 * y22;
        z[u][3] = n2 * y21 + c2 * y22;
      }
#pragma unroll
      for (int u = 0; u < UA; ++u) {
        if (!on[u]) continue;
        a[p1[u]][p2[u]] = a[p2[u]][p1[u]] = z[u][0];
        a[p1[u]][s2[u]] = a[s2[u]][p1[u]] = z[u][1];
        a[s1[u]][p2[u]] = a[p2[u]][s1[u]] = z[u][2];
        a[s1[u]][s2[u]] = a[s2[u]][s1[u]] = z[u][3];
      }
      if (tid < B && rot[pr][tid]) {  // the diagonal blocks, exactly
        const int p = at[r][tid].x, s = at[r][tid].y;
        a[p][p] = rv[pr][2][tid];
        a[s][s] = rv[pr][3][tid];
        a[p][s] = T(0);
        a[s][p] = T(0);
      }
      __syncthreads();
    }
    ++inner;
    if (!__syncthreads_or(any)) break;
    ever = 1;
  }
  T *Q = Qs + (size_t)k * P * P;
  for (int e = tid; e < P * P; e += NT) Q[e] = q[e / P][e % P];
  if (tid < 32) rots = __reduce_add_sync(FULL, rots);
  if (tid == 0) {
    moved[k] = ever;
    if (ever) atomicAdd(rotated, 1);
    if (stats) {
      int *row = stats + 3 * flags[2];
      atomicAdd(row, ever);
      atomicAdd(row + 1, inner);
      atomicAdd(row + 2, rots);
    }
  }
}

__host__ __device__ constexpr size_t update_smem() {
  return 3 * P * LD * sizeof(T);
}

// d += a b on the FP64 tensor cores: one 8 x 8 x 4 product of the warp.
__device__ inline void dmma(T (&d)[2], T a, T b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// O = op(L) R for P x P matrices in shared memory (row stride LD), op(L) = L
// or L^T: warp w computes rows [w P / 4, (w + 1) P / 4) with DMMA. Each warp
// reads only its own rows of L (L^T: its own columns), so O may be L.
template <bool LT>
__device__ inline void mma_product(const T *L, const T *R, T *O) {
  constexpr int RW = P / 4, TR = RW / 8, TC = P / 8;
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * RW;
  const int lr = lane >> 2, lc = lane & 3;
  T acc[TR][TC][2];
#pragma unroll
  for (int tr = 0; tr < TR; ++tr)
#pragma unroll
    for (int tc = 0; tc < TC; ++tc) acc[tr][tc][0] = acc[tr][tc][1] = T(0);
#pragma unroll 2
  for (int k0 = 0; k0 < P; k0 += 4) {
    T af[TR], bf[TC];
#pragma unroll
    for (int tr = 0; tr < TR; ++tr) {
      const int row = r0 + tr * 8 + lr, col = k0 + lc;
      af[tr] = LT ? L[col * LD + row] : L[row * LD + col];
    }
#pragma unroll
    for (int tc = 0; tc < TC; ++tc) bf[tc] = R[(k0 + lc) * LD + tc * 8 + lr];
#pragma unroll
    for (int tr = 0; tr < TR; ++tr)
#pragma unroll
      for (int tc = 0; tc < TC; ++tc) dmma(acc[tr][tc], af[tr], bf[tc]);
  }
  __syncwarp();
#pragma unroll
  for (int tr = 0; tr < TR; ++tr)
#pragma unroll
    for (int tc = 0; tc < TC; ++tc)
      *reinterpret_cast<double2 *>(&O[(r0 + tr * 8 + lr) * LD + tc * 8 + 2 * lc]) =
          make_double2(acc[tr][tc][0], acc[tr][tc][1]);
}

constexpr int VT = 3;  // tiles of V a block: the loads of all are in flight at once

__host__ __device__ constexpr size_t v_tile_smem() {
  return (VT + 2) * P * LD * sizeof(T);
}

// Vt[rows of pair b, cols] <- Q_b^T Vt[rows of pair b, cols] for the VT
// tiles of P columns of group `task` of a round's V update (b = task %
// pairs), read and written a row of P columns at a time; a pair that did
// not rotate returns.
__device__ inline void v_tiles(T *__restrict__ Vt, const T *__restrict__ Qs,
                               const int *__restrict__ moved, int n, int round, int task) {
  const int pairs = n / P, b = task % pairs, col0 = task / pairs * VT * P;
  const int tid = threadIdx.x;
  if (!moved[b]) return;
  const int tiles = min(VT, (n - col0) / P);
  extern __shared__ __align__(16) T smem[];
  T *qb = smem, *o = qb + P * LD, *m = o + P * LD;  // tile v at m + v P LD; row stride LD
  int Ib, Jb;
  pair_of(round, b, n / B, &Ib, &Jb);
  const T *Qb = Qs + (size_t)b * P * P;
  for (int e = tid; e < P * P; e += UT) qb[e / P * LD + e % P] = Qb[e];
  for (int e = tid; e < tiles * P * P; e += UT) {
    const int v = e / (P * P), k = e / P % P, j = e % P;
    m[(v * P + k) * LD + j] =
        Vt[(size_t)(k < B ? Ib * B + k : Jb * B + k - B) * n + col0 + v * P + j];
  }
  __syncthreads();
  for (int v = 0; v < tiles; ++v) {
    // Tile v's product goes to o, then into tile v - 1's buffer, read by now.
    T *out = v == 0 ? o : m + (v - 1) * P * LD;
    mma_product<true>(qb, m + v * P * LD, out);
    __syncthreads();
    for (int e = tid; e < P * P; e += UT) {
      const int k = e / P, j = e % P;
      Vt[(size_t)(k < B ? Ib * B + k : Jb * B + k - B) * n + col0 + v * P + j] =
          out[k * LD + j];
    }
  }
}

// A[a, b] <- Q_a^T A[a, b] Q_b for the tile `task` of a round, the task-th
// pair a <= b in row order; a tile whose pairs did not rotate returns.
__device__ inline void a_tile(T *__restrict__ A, const T *__restrict__ Qs,
                              const int *__restrict__ moved, int n, int round, int task) {
  const int pairs = n / P, blocks = n / B, tid = threadIdx.x;
  int a = 0;
  for (; task >= pairs - a; ++a) task -= pairs - a;
  const int b = a + task;
  if (!moved[a] && !moved[b]) return;
  extern __shared__ __align__(16) T smem[];
  T *qb = smem, *qa = qb + P * LD, *m = qa + P * LD;  // row stride LD
  int Ia, Ja, Ib, Jb;
  pair_of(round, a, blocks, &Ia, &Ja);
  pair_of(round, b, blocks, &Ib, &Jb);
  const T *Qa = Qs + (size_t)a * P * P, *Qb = Qs + (size_t)b * P * P;
  for (int e = tid; e < P * P; e += UT) {
    qa[e / P * LD + e % P] = Qa[e];
    qb[e / P * LD + e % P] = Qb[e];
  }
  for (int sb = 0; sb < 4; ++sb) {  // sub-block (X, Y): kept, or its transpose
    const int X = sb & 2 ? Ja : Ia, Y = sb & 1 ? Jb : Ib;
    T *d = m + (sb & 2 ? B : 0) * LD + (sb & 1 ? B : 0);
    if (X <= Y) {
      for (int e = tid; e < B * B; e += UT)
        d[e / B * LD + e % B] = A[(size_t)(X * B + e / B) * n + Y * B + e % B];
    } else {
      for (int e = tid; e < B * B; e += UT)
        d[e % B * LD + e / B] = A[(size_t)(Y * B + e / B) * n + X * B + e % B];
    }
  }
  __syncthreads();
  mma_product<false>(m, qb, m);  // W = M Q_b, in place
  __syncthreads();
  mma_product<true>(qa, m, qb);  // Q_a^T W
  __syncthreads();
  for (int sb = 0; sb < 4; ++sb) {
    const int X = sb & 2 ? Ja : Ia, Y = sb & 1 ? Jb : Ib;
    if (a == b && X > Y) continue;  // the diagonal tile's (Y, X) holds it
    const T *s = qb + (sb & 2 ? B : 0) * LD + (sb & 1 ? B : 0);
    if (X <= Y) {
      for (int e = tid; e < B * B; e += UT)
        A[(size_t)(X * B + e / B) * n + Y * B + e % B] = s[e / B * LD + e % B];
    } else {
      for (int e = tid; e < B * B; e += UT)
        A[(size_t)(Y * B + e / B) * n + X * B + e % B] = s[e % B * LD + e / B];
    }
  }
}

__host__ __device__ constexpr size_t solve_smem() {
  return pair_solve_smem() > v_tile_smem() ? pair_solve_smem() : v_tile_smem();
}

// Blocks [0, pairs) solve round `round`'s pairs (unless `solve` is 0 or
// the solve is done) into the Q and moved buffers `buf`; the other blocks
// are the V update of round `prev` (none where prev < 0) from the other
// buffers, VT tiles each.
__global__ void __launch_bounds__(UT)
pair_solve(const T *__restrict__ A, T *__restrict__ Vt, T *__restrict__ Qs,
           int *__restrict__ moved, int n, int round, int prev, int buf, int solve,
           const T *thr_p, const int *flags, int *rotated, int *stats) {
  const int pairs = n / P;
  const size_t qsize = (size_t)pairs * P * P;
  if ((int)blockIdx.x < pairs) {
    if (!solve) return;
    if (!flags[0]) {
      solve_pair(A, Qs + buf * qsize, moved + buf * pairs, blockIdx.x, n, round, thr_p,
                 flags, rotated, stats);
    } else if (threadIdx.x == 0) {
      moved[buf * pairs + blockIdx.x] = 0;  // so the next launch updates no V
    }
    return;
  }
  if (prev >= 0)
    v_tiles(Vt, Qs + (1 - buf) * qsize, moved + (1 - buf) * pairs, n, prev,
            blockIdx.x - pairs);
}

// One round's A <- P^T A P, P the block-diagonal product of the Q_k: a
// block a tile of A.
__global__ void __launch_bounds__(UT)
update(T *__restrict__ A, const T *__restrict__ Qs, const int *__restrict__ moved,
       int n, int round, const int *flags) {
  if (flags[0]) return;
  a_tile(A, Qs, moved, n, round, blockIdx.x);
}

// A sweep's end: done where no subproblem rotated in it; count the sweep.
__global__ void sweep_end(int *flags) {
  if (flags[0]) return;
  if (flags[1] == 0) flags[0] = 1;
  flags[1] = 0;
  flags[2] += 1;
}

cudaError_t run(T *A, T *Vt, T *Qs, int *moved, int n, const T *thr, int *flags,
                int max_sweeps, int *stats, cudaStream_t stream) {
  static_assert(solve_smem() <= 48 * 1024 && update_smem() <= 48 * 1024,
                "above 48 KB needs cudaFuncSetAttribute");
  const int rounds = n / B - 1, pairs = n / P;
  const int solve_blocks = pairs + pairs * ((pairs + VT - 1) / VT);
  const size_t qsize = (size_t)pairs * P * P;
  cudaError_t err;
  int g = 0;  // rounds launched: the buffers alternate with it
  for (int s = 0; s < max_sweeps; ++s) {
    for (int r = 0; r < rounds; ++r, ++g) {
      const int buf = g & 1, prev = g == 0 ? -1 : (r + rounds - 1) % rounds;
      pair_solve<<<solve_blocks, UT, solve_smem(), stream>>>(
          A, Vt, Qs, moved, n, r, prev, buf, 1, thr, flags, flags + 1, stats);
      update<<<pairs * (pairs + 1) / 2, UT, update_smem(), stream>>>(
          A, Qs + buf * qsize, moved + buf * pairs, n, r, flags);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    sweep_end<<<1, 1, 0, stream>>>(flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // The last round's V update.
  pair_solve<<<solve_blocks, UT, solve_smem(), stream>>>(
      A, Vt, Qs, moved, n, 0, rounds - 1, g & 1, 0, thr, flags, flags + 1, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Eigenvalues of the symmetric n_pad x n_pad float64 `A` (row-major; its
// blocks of jacobi_block_rows() rows on and above the block diagonal are
// read and kept) on its diagonal and eigenvectors in the rows of `Vt`
// (which must hold the identity), in place, on `stream`; n_pad a multiple
// of 2 jacobi_block_rows(). `Qs` holds two buffers of n_pad /
// (2 jacobi_block_rows()) matrices of (2 jacobi_block_rows())^2, `moved`
// two of as many ints, zeroed; `flags` three device ints, zeroed: done,
// rotations in the current sweep, sweeps run. `thr` is the device scalar
// below which an off-diagonal entry is not rotated. `stats` is null or 3
// max_sweeps zeroed ints: per outer sweep, pairs that rotated, inner sweeps
// and rotations, summed over the sweep's pair solves.
int jacobi_eigh(void *A, void *Vt, void *Qs, int *moved, int n_pad, const void *thr,
                int *flags, int max_sweeps, int *stats, void *stream) {
  if (n_pad % (2 * B) != 0 || n_pad < 2 * B)
    return (int)cudaErrorInvalidValue;
  auto *a = static_cast<T *>(A), *v = static_cast<T *>(Vt), *q = static_cast<T *>(Qs);
  auto *t = static_cast<const T *>(thr);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)run(a, v, q, moved, n_pad, t, flags, max_sweeps, stats, s);
}

int jacobi_block_rows() { return B; }

const char *jacobi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
