// apg_fused.cu -- the fused APG process-MLE solve for 2Q (dim = 4) and 1Q
// (dim = 2) channels, and the standalone cyclic-Jacobi CP projection of
// 16x16 Hermitian matrices; f32, hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels:
// - forest_benchmarking_tpu/ops/lanes_apg.py: `apg_fused` (its pallas_call
//   in `_run_pallas`, body `apg_fused_lanes`, helpers `_dykstra`, `_warm_cp`,
//   `_multi_sweep`, `_rotation_coeffs`, `_proj_tp`), at dim = 4 and dim = 2;
// - forest_benchmarking_tpu/ops/pallas_eigh.py: `cp_project_pallas` (body
//   `_jacobi_pos_part`), which shares the Jacobi sweep of the fused solve.
// Same algorithm and op order as the plain PyTorch versions
// `apg_fused_reference` (ops/lanes_apg.py) and `cp_project_reference`
// (ops/pallas_eigh.py) in forest_benchmarking_tpu_torch:
//
//   est = Dykstra(rho0)                       (init_iters, init_sweeps)
//   for each phase (outer, dykstra, sweeps, sweeps_rest), outer times:
//     t' = (1 + sqrt(1 + 4 t^2)) / 2,  y = est + (t - 1)/t' (est - prev)
//     z  = y - (1/mu) grad(y),  grad = -A_r^T eta + i A_i^T eta,
//          eta = n / max(Re(A vec y), 1e-6)
//     cand = Dykstra(z)                       (dykstra, sweeps, sweeps_rest)
//     restart: t = 1 if cost(cand) > cost(est) else t'
//   return Dykstra(est)             (final_iters, final_sweeps, final_sweeps_rest)
//
// A Dykstra projection runs `sweeps` Jacobi sweeps in its first iteration
// and `sweeps_rest` in each later one (the JAX package's optional fourth
// phase entry and `final_sweeps_rest`; equal to `sweeps` unless given).
// Both kernels are built twice, and the launcher takes the build with
// SPLIT only for a schedule where the two differ: the other keeps the
// Dykstra loop as it was, one sweep count live (the shipped schedules).
//
// Dykstra alternates the CP projection (rotate H into the carried eigenbasis
// V, run cyclic-Jacobi sweeps, clip negative eigenvalues, reconstruct) and
// the TP projection; V carries across Dykstra iterations and outer steps.
//
// Layout at D = 4: a problem's Choi entries (i, j), n = 16 of each, are
// held one per thread by a group of 256 threads, P = PROBLEMS_2Q = 4 groups
// a block. The schedule is static, so every problem of a block runs the same
// steps; Dykstra's steps wait on the group's named barrier, the passes over
// A on __syncthreads. The elementwise APG/Dykstra state (est, prev, the two
// Dykstra corrections, the Dykstra iterate) lives in the thread's registers;
// the matrices that threads exchange (operand, H, HV, M, V) and the counts
// and eta vectors live in shared memory. The TPU kernel's pair-layout
// permutations, fences and vreg tiling are not carried: a Jacobi round
// rotates the pairs (p, q) of `_round_robin_pairs` in place.
//
// What bounds it on an H100:
// - D = 4: L2 bytes of A. Both A contractions are computed here, by hand,
//   in FP32 FMAs. The two f32 planes of A (1080 x 256) are 2.2 MB, and the
//   wrapper also passes A^T (256 x 1080, 2.2 MB more); both are shared by
//   all blocks and resident in the 50 MB L2. A block reads one of them on
//   each pass: 1 pass for the first cost plus 3 per outer step (p and
//   A^T eta at y, p for the cost of the candidate), 16 passes on the
//   headline schedule and 133 on parity. Every element a block loads serves
//   all P of its problems, so a solve moves 16 x 2.2 MB / P (headline) from
//   L2. The p pass (a_pass_2q) reads A^T[k, r] coalesced over the rows r
//   and the P operands x_g[k] as one broadcast shared-memory load; the
//   A^T eta pass (grad_2q) reads A[r, j] coalesced over the columns j and
//   the P values eta_g[r] as one broadcast load. Neither order of summation
//   depends on which problems share the block, so a problem's estimate does
//   not depend on its block-mates. Then the serial Jacobi rounds, n - 1 per
//   sweep, each three steps (coefficients, column rotations, row rotations)
//   with a barrier between them.
// - D = 2 (apg_fused_1q_kernel): one problem per quad of lanes, lane j
//   holding column j of each matrix in registers, eight problems a warp;
//   A is 36 x 16 (4.6 KB in two planes), staged in shared memory once per
//   block of PROBLEMS_1Q = 64 problems with A^T beside it, so no pass
//   touches device memory. The one __syncthreads is the staging's. What is
//   left is instruction issue and latency: the serial Jacobi rounds (one
//   set of rotation coefficients a lane and round serves its quad's
//   column pair), the shuffles that gather a matrix into the quad, and the
//   FMAs of the passes over A.
//
// cp_project (cp_project_kernel): one warp per 16x16 matrix, CP_PER_BLOCK =
// 8 a block, M and V in the warp's slice of shared memory, __syncwarp
// between the steps of a round; H is read as given (complex64, interleaved),
// V = I, `sweeps` Jacobi sweeps, then V diag(max(m_kk, 0)) V^dag is written.
// Bound: the 90 serial rounds of 6 sweeps; its bytes (4 KB per matrix) take
// a tenth of its operations' time at the card's peaks.

#include <cuda_runtime.h>

#define APG_MAX_PHASES 8  // must match MAX_PHASES in kernels/__init__.py

// The schedule as the host lays it out: the phases, then the sweep counts
// of the Dykstra iterations after the first. The kernels take the two
// parts as separate arguments, so that a build without SPLIT has the
// parameters, and the code, of a schedule with one sweep count.
struct ApgPhases {
  int n_phases;
  int outer[APG_MAX_PHASES];
  int dykstra[APG_MAX_PHASES];
  int sweeps[APG_MAX_PHASES];
  int init_iters, init_sweeps, final_iters, final_sweeps;
  float inv_mu;
};

struct ApgSweepsRest {
  int sweeps_rest[APG_MAX_PHASES];
  int final_sweeps_rest;
};

struct ApgSchedule {
  ApgPhases phases;
  ApgSweepsRest rest;
};

namespace {

constexpr int THREADS = 256;
constexpr float EPS_ROT = 1e-18f;  // f32 rotation threshold of _rotation_coeffs
constexpr float EPS_P = 1e-6f;     // probability clamp
constexpr int PAD_1Q = 20;         // row stride of A in shared memory at D = 2
constexpr int PROBLEMS_2Q = 4;     // problems per block at D = 4

// Shapes of the problem at Hilbert-space dimension D.
template <int D>
struct Dims {
  static constexpr int N = D * D;           // Choi matrix side
  static constexpr int NN = N * N;          // Choi matrix entries
  static constexpr int NPAIRS = N / 2;
  static constexpr int NROUNDS = N - 1;
  static constexpr int HALF = NN / 2;       // (row, pair) tasks of a rotation
};

// _round_robin_pairs(16): 15 rounds of 8 disjoint pairs (p < q).
__constant__ unsigned char c_pairs16[15][8][2] = {
    {{0, 15}, {1, 14}, {2, 13}, {3, 12}, {4, 11}, {5, 10}, {6, 9}, {7, 8}},
    {{0, 14}, {13, 15}, {1, 12}, {2, 11}, {3, 10}, {4, 9}, {5, 8}, {6, 7}},
    {{0, 13}, {12, 14}, {11, 15}, {1, 10}, {2, 9}, {3, 8}, {4, 7}, {5, 6}},
    {{0, 12}, {11, 13}, {10, 14}, {9, 15}, {1, 8}, {2, 7}, {3, 6}, {4, 5}},
    {{0, 11}, {10, 12}, {9, 13}, {8, 14}, {7, 15}, {1, 6}, {2, 5}, {3, 4}},
    {{0, 10}, {9, 11}, {8, 12}, {7, 13}, {6, 14}, {5, 15}, {1, 4}, {2, 3}},
    {{0, 9}, {8, 10}, {7, 11}, {6, 12}, {5, 13}, {4, 14}, {3, 15}, {1, 2}},
    {{0, 8}, {7, 9}, {6, 10}, {5, 11}, {4, 12}, {3, 13}, {2, 14}, {1, 15}},
    {{0, 7}, {6, 8}, {5, 9}, {4, 10}, {3, 11}, {2, 12}, {1, 13}, {14, 15}},
    {{0, 6}, {5, 7}, {4, 8}, {3, 9}, {2, 10}, {1, 11}, {12, 15}, {13, 14}},
    {{0, 5}, {4, 6}, {3, 7}, {2, 8}, {1, 9}, {10, 15}, {11, 14}, {12, 13}},
    {{0, 4}, {3, 5}, {2, 6}, {1, 7}, {8, 15}, {9, 14}, {10, 13}, {11, 12}},
    {{0, 3}, {2, 4}, {1, 5}, {6, 15}, {7, 14}, {8, 13}, {9, 12}, {10, 11}},
    {{0, 2}, {1, 3}, {4, 15}, {5, 14}, {6, 13}, {7, 12}, {8, 11}, {9, 10}},
    {{0, 1}, {2, 15}, {3, 14}, {4, 13}, {5, 12}, {6, 11}, {7, 10}, {8, 9}},
};

template <int D>
using Pairs = unsigned char[Dims<D>::NROUNDS][Dims<D>::NPAIRS][2];

// Copy the pair table into shared memory (threads < its size).
template <int D>
__device__ __forceinline__ void load_pairs(Pairs<D>& pairs, int t) {
  static_assert(D == 4, "the block-wide sweeps serve the D = 4 kernel");
  constexpr int SIZE = Dims<D>::NROUNDS * Dims<D>::NPAIRS * 2;
  if (t < SIZE) (&pairs[0][0][0])[t] = (&c_pairs16[0][0][0])[t];
}

// The matrices the Jacobi sweeps rotate: M, V and one round's coefficients.
template <int D>
struct Eig {
  float mr[Dims<D>::NN], mi[Dims<D>::NN];  // M, rotated in place by the sweeps
  float vr[Dims<D>::NN], vi[Dims<D>::NN];  // eigenbasis
  float rot[4][Dims<D>::NPAIRS];           // this round's c, s, e_r, e_i
};

// One problem's shared matrices in the fused solve.
template <int D>
struct Mats {
  float sr[Dims<D>::NN], si[Dims<D>::NN];  // operand of the A products, CP
                                           // input, TP input
  float hr[Dims<D>::NN], hi[Dims<D>::NN];  // hermitianized CP input H
  float tr[Dims<D>::NN], ti[Dims<D>::NN];  // H V
  Eig<D> e;                                // M = V^dag H V and V
  float ptr[D * D], pti[D * D];            // Tr_out of the TP input
};

// Jacobi rotation coefficients, exactly as _rotation_coeffs.
__device__ __forceinline__ void rotation_coeffs(float apq_r, float apq_i,
                                                float app, float aqq,
                                                float& c, float& s,
                                                float& e_r, float& e_i) {
  const float m = sqrtf(apq_r * apq_r + apq_i * apq_i);
  const bool small = m < EPS_ROT;
  const float msafe = small ? 1.f : m;
  e_r = small ? 1.f : apq_r / msafe;
  e_i = small ? 0.f : apq_i / msafe;
  const float tau = (aqq - app) / (2.f * msafe);
  const float sign_tau = tau < 0.f ? -1.f : 1.f;
  const float t = tau == 0.f ? 1.f
                             : sign_tau / (fabsf(tau) + sqrtf(1.f + tau * tau));
  const float cc = rsqrtf(1.f + t * t);
  c = small ? 1.f : cc;
  s = small ? 0.f : t * cc;
}

// The barriers of the shared device code below (Jacobi, warm CP, TP,
// Dykstra), whose threads exchange data only within one problem's group.
// BlockSync, the default, is __syncthreads. GroupSync is the named barrier
// `id` of the group's 256 threads (D = 4), so that the groups of a block
// wait only for their own threads between two block-wide passes.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
  }
};

// `sweeps` cyclic-Jacobi sweeps: M <- G^dag M G and V <- V G, round by round.
// l is the thread's entry within its problem's group of NN threads.
template <int D, class Sync = BlockSync>
__device__ void jacobi_sweeps(Eig<D>& s, const Pairs<D>& pairs, int sweeps,
                              int l, Sync sync = Sync()) {
  using C = Dims<D>;
  constexpr int N = C::N;
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < C::NROUNDS; ++r) {
      if (l < C::NPAIRS) {
        const int p = pairs[r][l][0], q = pairs[r][l][1];
        float c, sn, er, ei;
        rotation_coeffs(s.mr[p * N + q], s.mi[p * N + q], s.mr[p * N + p],
                        s.mr[q * N + q], c, sn, er, ei);
        s.rot[0][l] = c;
        s.rot[1][l] = sn;
        s.rot[2][l] = er;
        s.rot[3][l] = ei;
      }
      sync();
      {
        // columns p, q of M (first half of the group) and of V (second half):
        // p <- c p - s conj(e) q,  q <- s e p + c q
        const unsigned u = static_cast<unsigned>(l) & (C::HALF - 1);
        const int row = u / C::NPAIRS, k = u & (C::NPAIRS - 1);
        const int p = pairs[r][k][0], q = pairs[r][k][1];
        float* xr = l < C::HALF ? s.mr : s.vr;
        float* xi = l < C::HALF ? s.mi : s.vi;
        const float c = s.rot[0][k], sn = s.rot[1][k];
        const float er = s.rot[2][k], ei = s.rot[3][k];
        const float pr = xr[row * N + p], pi = xi[row * N + p];
        const float qr = xr[row * N + q], qi = xi[row * N + q];
        const float tqr = er * qr + ei * qi, tqi = er * qi - ei * qr;
        const float tpr = er * pr - ei * pi, tpi = er * pi + ei * pr;
        xr[row * N + p] = c * pr - sn * tqr;
        xi[row * N + p] = c * pi - sn * tqi;
        xr[row * N + q] = sn * tpr + c * qr;
        xi[row * N + q] = sn * tpi + c * qi;
      }
      sync();
      if (l < C::HALF) {
        // rows p, q of M: p <- c p - s e q,  q <- s conj(e) p + c q
        const unsigned u = static_cast<unsigned>(l);
        const int col = u / C::NPAIRS, k = u & (C::NPAIRS - 1);
        const int p = pairs[r][k][0], q = pairs[r][k][1];
        const float c = s.rot[0][k], sn = s.rot[1][k];
        const float er = s.rot[2][k], ei = s.rot[3][k];
        const float pr = s.mr[p * N + col], pi = s.mi[p * N + col];
        const float qr = s.mr[q * N + col], qi = s.mi[q * N + col];
        const float tqr = er * qr - ei * qi, tqi = er * qi + ei * qr;
        const float tpr = er * pr + ei * pi, tpi = er * pi - ei * pr;
        s.mr[p * N + col] = c * pr - sn * tqr;
        s.mi[p * N + col] = c * pi - sn * tqi;
        s.mr[q * N + col] = sn * tpr + c * qr;
        s.mi[q * N + col] = sn * tpi + c * qi;
      }
      sync();
    }
  }
}

// Entry (i, j) = (l / N, l % N) of W diag(max(m_kk, 0)) W^dag, W = s.vr/vi.
template <int D>
__device__ __forceinline__ void pos_part_entry(const Eig<D>& s, int l,
                                               float& pos_r, float& pos_i) {
  constexpr int N = Dims<D>::N;
  const unsigned u = static_cast<unsigned>(l);
  const int i = u / N, j = u % N;
  pos_r = 0.f;
  pos_i = 0.f;
  for (int k = 0; k < N; ++k) {
    const float w = fmaxf(s.mr[k * N + k], 0.f);
    const float xr = s.vr[i * N + k] * w, xi = s.vi[i * N + k] * w;
    const float yr = s.vr[j * N + k], yi = -s.vi[j * N + k];
    pos_r = pos_r + xr * yr - xi * yi;
    pos_i = pos_i + xr * yi + xi * yr;
  }
}

// CP projection of the matrix in s.sr/s.si (written and synced by the
// caller) in the carried eigenbasis; this thread's entry of the positive part.
template <int D, class Sync = BlockSync>
__device__ void warm_cp(Mats<D>& s, const Pairs<D>& pairs, int sweeps, int l,
                        float& pos_r, float& pos_i, Sync sync = Sync()) {
  constexpr int N = Dims<D>::N;
  const unsigned u = static_cast<unsigned>(l);
  const int i = u / N, j = u % N;
  s.hr[l] = (s.sr[i * N + j] + s.sr[j * N + i]) / 2.f;
  s.hi[l] = (s.si[i * N + j] - s.si[j * N + i]) / 2.f;
  sync();
  // T = H V
  float ar = s.hr[i * N] * s.e.vr[j] - s.hi[i * N] * s.e.vi[j];
  float ai = s.hr[i * N] * s.e.vi[j] + s.hi[i * N] * s.e.vr[j];
  for (int k = 1; k < N; ++k) {
    const float hr = s.hr[i * N + k], hi = s.hi[i * N + k];
    const float vr = s.e.vr[k * N + j], vi = s.e.vi[k * N + j];
    ar = ar + hr * vr - hi * vi;
    ai = ai + hr * vi + hi * vr;
  }
  s.tr[l] = ar;
  s.ti[l] = ai;
  sync();
  // M = V^dag T
  ar = s.e.vr[i] * s.tr[j] + s.e.vi[i] * s.ti[j];
  ai = s.e.vr[i] * s.ti[j] - s.e.vi[i] * s.tr[j];
  for (int k = 1; k < N; ++k) {
    const float vr = s.e.vr[k * N + i], vi = s.e.vi[k * N + i];
    const float tr = s.tr[k * N + j], ti = s.ti[k * N + j];
    ar = ar + vr * tr + vi * ti;
    ai = ai + vr * ti - vi * tr;
  }
  s.e.mr[l] = ar;
  s.e.mi[l] = ai;
  sync();
  jacobi_sweeps<D>(s.e, pairs, sweeps, l, sync);
  pos_part_entry<D>(s.e, l, pos_r, pos_i);
}

// TP projection X - kron(Tr_out(X) - I, I) / D of the matrix whose entry l
// is (xr, xi).
template <int D, class Sync = BlockSync>
__device__ void proj_tp(Mats<D>& s, int l, float xr, float xi, float& out_r,
                        float& out_i, Sync sync = Sync()) {
  constexpr int N = Dims<D>::N;
  s.sr[l] = xr;
  s.si[l] = xi;
  sync();
  if (l < D * D) {
    const unsigned u = static_cast<unsigned>(l);
    const int a = u / D, c = u % D;
    float accr = s.sr[(a * D) * N + c * D], acci = s.si[(a * D) * N + c * D];
    for (int b = 1; b < D; ++b) {
      accr += s.sr[(a * D + b) * N + c * D + b];
      acci += s.si[(a * D + b) * N + c * D + b];
    }
    s.ptr[l] = accr;
    s.pti[l] = acci;
  }
  sync();
  const unsigned u = static_cast<unsigned>(l);
  const unsigned i = u / N, j = u % N;
  const unsigned a = i / D, b = i % D, c = j / D, d = j % D;
  out_r = xr;
  out_i = xi;
  if (b == d) {
    out_r = xr - (s.ptr[a * D + c] - (a == c ? 1.f : 0.f)) / D;
    out_i = xi - s.pti[a * D + c] / D;
  }
}

// `iters` Dykstra iterations (CP then TP) on the matrix whose entry l is
// (zr, zi), with `sweeps` Jacobi sweeps each; with SPLIT, the iterations
// after the first run `sweeps_rest`. Ends on the TP half-step. The result
// replaces (zr, zi).
template <int D, bool SPLIT = false, class Sync = BlockSync>
__device__ void dykstra(Mats<D>& s, const Pairs<D>& pairs, int l, int iters,
                        int sweeps, int sweeps_rest, float& zr, float& zi,
                        Sync sync = Sync()) {
  float cp_r = 0.f, cp_i = 0.f, tp_r = 0.f, tp_i = 0.f;
  float st_r = zr, st_i = zi;
  for (int it = 0; it < iters; ++it) {
    const float pre_r = st_r - cp_r, pre_i = st_i - cp_i;
    s.sr[l] = pre_r;
    s.si[l] = pre_i;
    sync();
    float pos_r, pos_i;
    warm_cp<D>(s, pairs, SPLIT && it > 0 ? sweeps_rest : sweeps, l, pos_r,
               pos_i, sync);
    cp_r = pos_r - pre_r;
    cp_i = pos_i - pre_i;
    const float pre2_r = pos_r - tp_r, pre2_i = pos_i - tp_i;
    proj_tp<D>(s, l, pre2_r, pre2_i, st_r, st_i, sync);
    tp_r = st_r - pre2_r;
    tp_i = st_i - pre2_i;
  }
  zr = st_r;
  zi = st_i;
}

// ---------------------------------------------------------------------------
// The passes over A. D = 4: A and A^T in device memory (L2), P problems per
// block; every element of A or A^T that a block loads serves all P.
// ---------------------------------------------------------------------------

// Four consecutive floats of shared memory (16-byte aligned), one a problem
// of the block, in one load, and back.
template <int P>
__device__ __forceinline__ void load_p(const float* src, float (&v)[P]) {
  static_assert(P == 4, "the loads of the D = 4 passes hold four problems");
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <int P>
__device__ __forceinline__ void store_p(float* dst, const float (&v)[P]) {
  static_assert(P == 4, "the stores of the D = 4 passes hold four problems");
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The shared memory of a D = 4 block of P problems. The block's counts and
// eta follow it in the dynamic allocation, rows x P floats each, laid out
// [r][g] so that one load gives row r of all P problems.
template <int P>
struct Shared2q {
  static constexpr int NN = Dims<4>::NN;
  static constexpr int WARPS = THREADS * P / 32;
  Mats<4> mats[P];            // problem g's matrices
  float xr[NN * P], xi[NN * P];  // operand x of the p pass, [k][g]
  float part[2 * P * P * NN];  // A^T eta partial sums, [g'][re, im][g][j]
  float red[WARPS * P];        // per-warp cost sums, [w][g]
  Pairs<4> pairs;
};

// Bytes of Shared2q<P>, rounded up to 16 (where the counts start).
template <int P>
__host__ __device__ constexpr size_t shared2q_head() {
  return (sizeof(Shared2q<P>) + 15) & ~static_cast<size_t>(15);
}

// p_g[r] = max(Re(A x_g)[r], EPS_P) for the block's P problems, x_g in
// sh.xr/xi (written and synced by the caller). A half-warp takes 16
// consecutive rows r, one a lane, and one half of k: it loads A^T[k, r]
// (coalesced over the rows) and x_g[k] of all P problems (one broadcast
// load a plane), and keeps P sums; the halves join by a shuffle. With `cost`
// false it stores eta_g[r] = n_g[r] / p_g[r]; with `cost` true it returns
// -sum_r n_g[r] log p_g[r] of this thread's problem g, the same value in each
// of the group's threads (per-thread sums over its rows, a shuffle tree in
// the warp, then the warps in order). Ends with a __syncthreads.
template <int P>
__device__ float a_pass_2q(Shared2q<P>& sh, const float* __restrict__ at_r,
                           const float* __restrict__ at_i, const float* sn,
                           float* seta, int rows, int t, bool cost) {
  constexpr int NN = Dims<4>::NN, KH = NN / 2, NW = Shared2q<P>::WARPS;
  const int w = t >> 5, lane = t & 31, half = lane >> 4;
  const float* xr = sh.xr + half * KH * P;
  const float* xi = sh.xi + half * KH * P;
  float part[P];
#pragma unroll
  for (int g = 0; g < P; ++g) part[g] = 0.f;
  for (int q = w; 16 * q < rows; q += NW) {
    const int r = 16 * q + (lane & 15);
    float acc[P];
#pragma unroll
    for (int g = 0; g < P; ++g) acc[g] = 0.f;
    if (r < rows) {
      const float* cr = at_r + static_cast<size_t>(half * KH) * rows + r;
      const float* ci = at_i + static_cast<size_t>(half * KH) * rows + r;
#pragma unroll 4
      for (int k = 0; k < KH; ++k) {
        const float vr = __ldg(cr + static_cast<size_t>(k) * rows);
        const float vi = __ldg(ci + static_cast<size_t>(k) * rows);
        float x_r[P], x_i[P];
        load_p<P>(xr + k * P, x_r);
        load_p<P>(xi + k * P, x_i);
#pragma unroll
        for (int g = 0; g < P; ++g)
          acc[g] = fmaf(-vi, x_i[g], fmaf(vr, x_r[g], acc[g]));
      }
    }
#pragma unroll
    for (int g = 0; g < P; ++g)
      acc[g] += __shfl_down_sync(0xffffffffu, acc[g], 16);
    if (half == 0 && r < rows) {
      float nv[P], e[P];
      load_p<P>(sn + r * P, nv);
#pragma unroll
      for (int g = 0; g < P; ++g) {
        const float p = fmaxf(acc[g], EPS_P);
        if (cost)
          part[g] = fmaf(nv[g], logf(p), part[g]);
        else
          e[g] = nv[g] / p;
      }
      if (!cost) store_p<P>(seta + r * P, e);
    }
  }
  if (!cost) {
    __syncthreads();
    return 0.f;
  }
#pragma unroll
  for (int g = 0; g < P; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < P; ++g) sh.red[w * P + g] = part[g];
  }
  __syncthreads();
  const int g = t / NN;
  float total = 0.f;
  for (int k = 0; k < NW; ++k) total += sh.red[k * P + g];
  return -total;
}

// The cost of the matrix whose entry l of problem g is (xr, xi).
template <int P>
__device__ float cost_2q(Shared2q<P>& sh, const float* __restrict__ at_r,
                         const float* __restrict__ at_i, const float* sn,
                         int rows, int t, float xr, float xi) {
  const int g = t / Dims<4>::NN, l = t % Dims<4>::NN;
  sh.xr[l * P + g] = xr;
  sh.xi[l * P + g] = xi;
  __syncthreads();
  return a_pass_2q<P>(sh, at_r, at_i, sn, nullptr, rows, t, true);
}

// Gradient entry j of this thread's problem g: g_r = -sum_r A_r[r, j] eta_r,
// g_i = sum_r A_i[r, j] eta_r, eta in seta (written and synced by the
// caller). Thread (g', j) sums column j over the rows r = g' (mod P) for all
// P problems: it loads A[r, j] (coalesced over j) and eta_g[r] of all P (one
// broadcast load), and keeps 2P sums. Then thread (g, j) adds the P partial
// sums of its entry in the order g' = 0, 1, ... through shared memory.
template <int P>
__device__ void grad_2q(Shared2q<P>& sh, const float* __restrict__ a_r,
                        const float* __restrict__ a_i, const float* seta,
                        int rows, int t, float& g_r, float& g_i) {
  constexpr int NN = Dims<4>::NN;
  const int gp = t / NN, j = t % NN;
  float sr[P], si[P];
#pragma unroll
  for (int g = 0; g < P; ++g) sr[g] = si[g] = 0.f;
#pragma unroll 4
  for (int r = gp; r < rows; r += P) {
    const float vr = __ldg(a_r + static_cast<size_t>(r) * NN + j);
    const float vi = __ldg(a_i + static_cast<size_t>(r) * NN + j);
    float e[P];
    load_p<P>(seta + r * P, e);
#pragma unroll
    for (int g = 0; g < P; ++g) {
      sr[g] = fmaf(vr, e[g], sr[g]);
      si[g] = fmaf(vi, e[g], si[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < P; ++g) {
    sh.part[((2 * gp) * P + g) * NN + j] = sr[g];
    sh.part[((2 * gp + 1) * P + g) * NN + j] = si[g];
  }
  __syncthreads();
  float tr = sh.part[gp * NN + j], ti = sh.part[(P + gp) * NN + j];
  for (int q = 1; q < P; ++q) {
    tr += sh.part[((2 * q) * P + gp) * NN + j];
    ti += sh.part[((2 * q + 1) * P + gp) * NN + j];
  }
  g_r = -tr;
  g_i = ti;
}

template <int P, bool SPLIT>
__global__ void __launch_bounds__(THREADS * P, 1)
    apg_fused_kernel(const float* __restrict__ a_r,
                     const float* __restrict__ a_i,
                     const float* __restrict__ at_r,
                     const float* __restrict__ at_i,
                     const float* __restrict__ n,
                     const float* __restrict__ rho0_r,
                     const float* __restrict__ rho0_i,
                     float* __restrict__ out_r, float* __restrict__ out_i,
                     int batch, int rows, const ApgPhases sch,
                     const ApgSweepsRest rest) {
  constexpr int NN = Dims<4>::NN;
  extern __shared__ __align__(16) unsigned char smem2q[];
  Shared2q<P>& sh = *reinterpret_cast<Shared2q<P>*>(smem2q);
  float* sn = reinterpret_cast<float*>(smem2q + shared2q_head<P>());
  float* seta = sn + static_cast<size_t>(rows) * P;  // n / p, [r][g]
  const int t = threadIdx.x, g = t / NN, l = t % NN;
  const size_t first = static_cast<size_t>(blockIdx.x) * P;
  const size_t b = first + g;
  const bool live = b < static_cast<size_t>(batch);
  Mats<4>& s = sh.mats[g];

  load_pairs<4>(sh.pairs, t);
  // problems past the batch run on zero counts and a zero start, and are
  // not written back
  const size_t n_end = static_cast<size_t>(batch) * rows;
  for (int k = t; k < P * rows; k += THREADS * P) {
    const int q = k / rows;
    const size_t idx = first * rows + k;
    sn[(k - q * rows) * P + q] = idx < n_end ? n[idx] : 0.f;
  }
  s.e.vr[l] = (l >> 4) == (l & 15) ? 1.f : 0.f;
  s.e.vi[l] = 0.f;
  float est_r = live ? rho0_r[b * NN + l] : 0.f;
  float est_i = live ? rho0_i[b * NN + l] : 0.f;
  // the pair table and the counts are written by threads of other groups
  __syncthreads();
  // Dykstra touches only the group's own matrices: its barriers are the
  // group's; the passes over A between two projections are block-wide
  const GroupSync gsync{1 + g};
  dykstra<4>(s, sh.pairs, l, sch.init_iters, sch.init_sweeps,
             sch.init_sweeps, est_r, est_i, gsync);

  float prev_r = est_r, prev_i = est_i;
  float tk = 1.f;
  float old_cost = cost_2q<P>(sh, at_r, at_i, sn, rows, t, est_r, est_i);
  for (int ph = 0; ph < sch.n_phases; ++ph) {
    for (int it = 0; it < sch.outer[ph]; ++it) {
      const float t_next = (1.f + sqrtf(1.f + 4.f * tk * tk)) / 2.f;
      const float beta = (tk - 1.f) / t_next;
      const float y_r = est_r + beta * (est_r - prev_r);
      const float y_i = est_i + beta * (est_i - prev_i);
      sh.xr[l * P + g] = y_r;
      sh.xi[l * P + g] = y_i;
      __syncthreads();
      a_pass_2q<P>(sh, at_r, at_i, sn, seta, rows, t, false);
      float g_r, g_i;
      grad_2q<P>(sh, a_r, a_i, seta, rows, t, g_r, g_i);
      float z_r = y_r - sch.inv_mu * g_r;
      float z_i = y_i - sch.inv_mu * g_i;
      dykstra<4, SPLIT>(s, sh.pairs, l, sch.dykstra[ph], sch.sweeps[ph],
                        rest.sweeps_rest[ph], z_r, z_i, gsync);
      const float new_cost = cost_2q<P>(sh, at_r, at_i, sn, rows, t, z_r,
                                        z_i);
      // O'Donoghue-Candes function restart
      tk = new_cost > old_cost ? 1.f : t_next;
      prev_r = est_r;
      prev_i = est_i;
      est_r = z_r;
      est_i = z_i;
      old_cost = new_cost;
    }
  }
  dykstra<4, SPLIT>(s, sh.pairs, l, sch.final_iters, sch.final_sweeps,
                    rest.final_sweeps_rest, est_r, est_i, gsync);
  if (live) {
    out_r[b * NN + l] = est_r;
    out_i[b * NN + l] = est_i;
  }
}

// ---------------------------------------------------------------------------
// D = 2: one problem per four lanes (a quad), its state in registers.
//
// Lane j of a quad holds column j of each of its problem's 4 x 4 matrices:
// est, prev, the Dykstra iterate and both corrections, M = V^dag H V and
// the carried eigenbasis V. A warp serves eight problems. A Jacobi round's
// column rotations exchange whole columns with the partner lane and its row
// rotations are local; each lane computes the rotation coefficients of its
// column's pair once for the round and takes the other pair's from a lane
// of it. The products H V, V^dag T and V diag(w) V^dag gather the matrix
// they need into every lane of the quad (__shfl_sync, width 4). No step
// after the staging of A and the counts waits on a barrier. The schedule
// is static and the problems past the batch run on zero counts and a zero
// start, so every shuffle runs with the whole warp converged.
// ---------------------------------------------------------------------------

constexpr int PROBLEMS_1Q = 64;  // problems per block at D = 2
static_assert(PROBLEMS_1Q * 4 == THREADS, "a problem is a quad of lanes");
constexpr int SLOTS_1Q = 9;    // rows a lane takes in each chunk of A's rows
constexpr int CHUNK_1Q = SLOTS_1Q * 4;  // rows of a chunk: the 1Q A's 36
// floats of a problem's operand slice: 32, and 4 more so that the two
// problems of a quarter-warp read their float4s from distinct banks
constexpr int X_STRIDE_1Q = 36;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Rows of A and of the counts as the D = 2 kernel stages them: padded with
// zero rows to whole chunks.
__host__ __device__ constexpr int padded_rows_1q(int rows) {
  return (rows + CHUNK_1Q - 1) / CHUNK_1Q * CHUNK_1Q;
}

// Column j of a 4 x 4 complex matrix: entry (i, j) in (re[i], im[i]).
struct Col {
  float re[4], im[4];
};

// x in lane `src` of this thread's quad.
__device__ __forceinline__ float q4(float x, int src) {
  return __shfl_sync(FULL_MASK, x, src, 4);
}

// a[idx] for an index that depends on the lane, by selects: a register
// array takes only constant indices.
__device__ __forceinline__ float pick(const float (&a)[4], int idx) {
  return idx == 0 ? a[0] : (idx == 1 ? a[1] : (idx == 2 ? a[2] : a[3]));
}

// The quad's matrix, whose column j lane j holds in c, in every lane:
// out[k] = column k.
__device__ __forceinline__ void gather(const Col& c, Col (&out)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[k].re[i] = q4(c.re[i], k);
      out[k].im[i] = q4(c.im[i], k);
    }
  }
}

// Rows p, q of this column: p <- c p - s e q, q <- s conj(e) p + c q, as
// jacobi_sweeps (p, q constant).
__device__ __forceinline__ void rotate_rows_1q(Col& x, int p, int q, float c,
                                               float sn, float er, float ei) {
  const float pr = x.re[p], pi = x.im[p], qr = x.re[q], qi = x.im[q];
  const float tqr = er * qr - ei * qi, tqi = er * qi + ei * qr;
  const float tpr = er * pr + ei * pi, tpi = er * pi - ei * pr;
  x.re[p] = c * pr - sn * tqr;
  x.im[p] = c * pi - sn * tqi;
  x.re[q] = sn * tpr + c * qr;
  x.im[q] = sn * tpi + c * qi;
}

// This column x, one of the pair (p, q), after the rotation of columns p
// and q, y the other column: p <- c p - s conj(e) q, q <- s e p + c q, as
// jacobi_sweeps; written x <- c x -+ s g y, the phase g and the sign picked
// by selects, so that the lanes of p and of q run one instruction stream.
__device__ __forceinline__ void rotate_col_1q(Col& x, const Col& y, bool is_p,
                                              float c, float sn, float er,
                                              float ei) {
  const float gi = is_p ? -ei : ei;
  const float ss = is_p ? -sn : sn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float tr = er * y.re[i] - gi * y.im[i];
    const float ti = er * y.im[i] + gi * y.re[i];
    x.re[i] = c * x.re[i] + ss * tr;
    x.im[i] = c * x.im[i] + ss * ti;
  }
}

// `sweeps` cyclic-Jacobi sweeps of M and V (this lane's columns m and v),
// rotation by rotation as jacobi_sweeps<2> would: round r pairs index x
// with x ^ (3 - r), which is _round_robin_pairs(4)[r]. The lanes of the pair of column j
// compute its coefficients from M as the round starts; the row rotations
// take the other pair's from lane j ^ 1 (j ^ 2 in round 2).
__device__ void jacobi_1q(Col& m, Col& v, int sweeps, int j) {
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int mm = 3 - r;             // round r pairs x with x ^ mm
      const int jp = j ^ mm;
      const bool is_p = j < jp;
      const int p = is_p ? j : jp, q = is_p ? jp : j;
      // M(p, q) is entry p ^ mm = p of column q; M(x, x) of column x
      const float off_r = pick(m.re, jp), off_i = pick(m.im, jp);
      const float dg = pick(m.re, j);
      float c, sn, er, ei;
      rotation_coeffs(q4(off_r, q), q4(off_i, q), q4(dg, p), q4(dg, q), c, sn,
                      er, ei);
      const int other = j ^ (mm == 1 ? 2 : 1);  // a lane of the other pair
      const float c2 = q4(c, other), s2 = q4(sn, other);
      const float er2 = q4(er, other), ei2 = q4(ei, other);
      Col ym, yv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ym.re[i] = q4(m.re[i], jp);
        ym.im[i] = q4(m.im[i], jp);
        yv.re[i] = q4(v.re[i], jp);
        yv.im[i] = q4(v.im[i], jp);
      }
      rotate_col_1q(m, ym, is_p, c, sn, er, ei);
      rotate_col_1q(v, yv, is_p, c, sn, er, ei);
      // the round's pairs: (0, mm) and (pb, qb)
      const int pb = mm == 1 ? 2 : 1, qb = mm == 3 ? 2 : 3;
      const bool in_a = j == 0 || j == mm;
      rotate_rows_1q(m, 0, mm, in_a ? c : c2, in_a ? sn : s2,
                     in_a ? er : er2, in_a ? ei : ei2);
      rotate_rows_1q(m, pb, qb, in_a ? c2 : c, in_a ? s2 : sn,
                     in_a ? er2 : er, in_a ? ei2 : ei);
    }
  }
}

// CP projection, as warm_cp<2>, of the matrix whose column j is s, in the
// carried eigenbasis (column v, rotated in place): hermitianize, T = H V,
// M = V^dag T, the sweeps, then column j of V diag(max(m_kk, 0)) V^dag.
// Every sum over k runs in order.
__device__ void warm_cp_1q(const Col& s, Col& v, int sweeps, int j,
                           Col& pos) {
  Col g[4];
  gather(s, g);
  Col h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h.re[i] = (s.re[i] + pick(g[i].re, j)) / 2.f;
    h.im[i] = (s.im[i] - pick(g[i].im, j)) / 2.f;
  }
  gather(h, g);  // g[k].re[i] = H(i, k)
  Col t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ar = g[0].re[i] * v.re[0] - g[0].im[i] * v.im[0];
    float ai = g[0].re[i] * v.im[0] + g[0].im[i] * v.re[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      ar = ar + g[k].re[i] * v.re[k] - g[k].im[i] * v.im[k];
      ai = ai + g[k].re[i] * v.im[k] + g[k].im[i] * v.re[k];
    }
    t.re[i] = ar;
    t.im[i] = ai;
  }
  gather(v, g);  // g[i].re[k] = V(k, i)
  Col m;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ar = g[i].re[0] * t.re[0] + g[i].im[0] * t.im[0];
    float ai = g[i].re[0] * t.im[0] - g[i].im[0] * t.re[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      ar = ar + g[i].re[k] * t.re[k] + g[i].im[k] * t.im[k];
      ai = ai + g[i].re[k] * t.im[k] - g[i].im[k] * t.re[k];
    }
    m.re[i] = ar;
    m.im[i] = ai;
  }
  jacobi_1q(m, v, sweeps, j);
  const float w = fmaxf(pick(m.re, j), 0.f);  // max(m_jj, 0)
  gather(v, g);                               // g[k].re[i] = V(i, k)
#pragma unroll
  for (int i = 0; i < 4; ++i) pos.re[i] = pos.im[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wk = q4(w, k);
    const float yr = pick(g[k].re, j), yi = -pick(g[k].im, j);  // V(j, k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xr = g[k].re[i] * wk, xi = g[k].im[i] * wk;
      pos.re[i] = pos.re[i] + xr * yr - xi * yi;
      pos.im[i] = pos.im[i] + xr * yi + xi * yr;
    }
  }
}

// TP projection X - kron(Tr_out(X) - I, I) / 2 of the matrix whose column
// j is x, as proj_tp<2>: Tr_out(X)[a, c] = X[2a, 2c] + X[2a+1, 2c+1].
__device__ void proj_tp_1q(const Col& x, int j, Col& out) {
  const int c = j >> 1, d = j & 1;
  float ptr[2], pti[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    ptr[a] = q4(x.re[2 * a], 2 * c) + q4(x.re[2 * a + 1], 2 * c + 1);
    pti[a] = q4(x.im[2 * a], 2 * c) + q4(x.im[2 * a + 1], 2 * c + 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = i >> 1, b = i & 1;
    const bool on = b == d;
    out.re[i] = on ? x.re[i] - (ptr[a] - (a == c ? 1.f : 0.f)) / 2.f
                   : x.re[i];
    out.im[i] = on ? x.im[i] - pti[a] / 2.f : x.im[i];
  }
}

// `iters` Dykstra iterations (CP then TP), as dykstra<2, SPLIT>, on the
// matrix whose column j is z, which the result replaces.
template <bool SPLIT>
__device__ void dykstra_1q(int j, int iters, int sweeps, int sweeps_rest,
                           Col& v, Col& z) {
  Col cp, tp, st = z;
#pragma unroll
  for (int i = 0; i < 4; ++i) cp.re[i] = cp.im[i] = tp.re[i] = tp.im[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    Col pre, pos, pre2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pre.re[i] = st.re[i] - cp.re[i];
      pre.im[i] = st.im[i] - cp.im[i];
    }
    warm_cp_1q(pre, v, SPLIT && it > 0 ? sweeps_rest : sweeps, j, pos);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp.re[i] = pos.re[i] - pre.re[i];
      cp.im[i] = pos.im[i] - pre.im[i];
      pre2.re[i] = pos.re[i] - tp.re[i];
      pre2.im[i] = pos.im[i] - tp.im[i];
    }
    proj_tp_1q(pre2, j, st);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tp.re[i] = st.re[i] - pre2.re[i];
      tp.im[i] = st.im[i] - pre2.im[i];
    }
  }
  z = st;
}

// The shared memory of a D = 2 block, in floats from the start of the
// dynamic allocation, for A padded to `rp` rows (a whole number of chunks).
// Each array starts on 16 bytes, so that float4 loads reach it.
struct Smem1q {
  int at_stride;  // row stride of A^T: rp or rp + 4, whichever is 4 mod 8
  int ar, ai;     // A, two planes, rp x PAD_1Q
  int atr, ati;   // A^T, two planes, 16 x at_stride
  int n;          // the counts of the block's problems, P x rp
  int eta;        // eta of each problem, P x (rp + 4)
  int x;          // the operand of each problem, P x X_STRIDE_1Q
  int total;
  __host__ __device__ explicit Smem1q(int rp) {
    at_stride = (rp & 7) ? rp : rp + 4;
    ar = 0;
    ai = ar + rp * PAD_1Q;
    atr = ai + rp * PAD_1Q;
    ati = atr + 16 * at_stride;
    n = ati + 16 * at_stride;
    eta = n + PROBLEMS_1Q * rp;
    x = eta + PROBLEMS_1Q * (rp + 4);
    total = x + PROBLEMS_1Q * X_STRIDE_1Q;
  }
};

// A pass of the quad's problem g at the operand x (column j of it in x):
// p_r = max(Re(A x)_r, EPS_P), in chunks of CHUNK_1Q rows, lane j taking
// rows j, j + 4, ... of a chunk. x goes through the problem's slice of
// shared memory and is read back as float4 broadcasts; rows of A are read
// as float4 (row stride PAD_1Q = 20 floats: the rows of a quarter-warp
// fall in distinct banks). Each p_r sums its k in order, A_r x_r then
// -A_i x_i for each k. `rp` rows are a whole number of chunks: the kernel
// pads A and the counts with zero rows, which add exactly nothing
// (eta = 0, n log p = -0). With GRAD it sets the gradient entries of
// column j, g_r = -sum_r A_r[r, e] eta_r and g_i = sum_r A_i[r, e] eta_r
// for e = 4 i + j, r in order, eta through shared memory and rows of A^T as
// float4, and returns 0; without, it returns -sum_r n_r log p_r, the same
// in the quad's four lanes (per-lane sums over its rows, then an xor
// tree).
template <bool GRAD>
__device__ float a_pass_1q(float* sm, const Smem1q& lay, int rp, int g, int j,
                           const Col& x, Col& grad) {
  constexpr int NN = Dims<2>::NN;
  const float* sn = sm + lay.n + g * rp;
  float* seta = sm + lay.eta + g * (rp + 4);
  float* sx = sm + lay.x + g * X_STRIDE_1Q;
  __syncwarp();  // the last pass's reads of x and eta are done
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sx[4 * i + j] = x.re[i];
    sx[NN + 4 * i + j] = x.im[i];
  }
  __syncwarp();
  float part = 0.f, sum_r[4] = {0.f, 0.f, 0.f, 0.f};
  float sum_i[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < rp; base += CHUNK_1Q) {
    float acc[SLOTS_1Q];
#pragma unroll
    for (int s = 0; s < SLOTS_1Q; ++s) acc[s] = 0.f;
#pragma unroll 1
    for (int k = 0; k < NN; k += 4) {
      const float4 x_r = *reinterpret_cast<const float4*>(sx + k);
      const float4 x_i = *reinterpret_cast<const float4*>(sx + NN + k);
#pragma unroll
      for (int s = 0; s < SLOTS_1Q; ++s) {
        const int at = (base + 4 * s + j) * PAD_1Q + k;
        const float4 a_r = *reinterpret_cast<const float4*>(sm + lay.ar + at);
        const float4 a_i = *reinterpret_cast<const float4*>(sm + lay.ai + at);
        float u = acc[s];
        u = fmaf(-a_i.x, x_i.x, fmaf(a_r.x, x_r.x, u));
        u = fmaf(-a_i.y, x_i.y, fmaf(a_r.y, x_r.y, u));
        u = fmaf(-a_i.z, x_i.z, fmaf(a_r.z, x_r.z, u));
        u = fmaf(-a_i.w, x_i.w, fmaf(a_r.w, x_r.w, u));
        acc[s] = u;
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS_1Q; ++s) {
      const float p = fmaxf(acc[s], EPS_P);
      const float nv = sn[base + 4 * s + j];
      if (GRAD)
        seta[base + 4 * s + j] = nv / p;
      else
        part += nv * logf(p);
    }
    if (GRAD) {
      __syncwarp();
#pragma unroll
      for (int r = 0; r < CHUNK_1Q; r += 4) {
        const float4 e = *reinterpret_cast<const float4*>(seta + base + r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (4 * i + j) * lay.at_stride + base + r;
          const float4 ar = *reinterpret_cast<const float4*>(sm + lay.atr + at);
          const float4 ai = *reinterpret_cast<const float4*>(sm + lay.ati + at);
          sum_r[i] = fmaf(ar.w, e.w, fmaf(ar.z, e.z, fmaf(ar.y, e.y,
                          fmaf(ar.x, e.x, sum_r[i]))));
          sum_i[i] = fmaf(ai.w, e.w, fmaf(ai.z, e.z, fmaf(ai.y, e.y,
                          fmaf(ai.x, e.x, sum_i[i]))));
        }
      }
    }
  }
  if (GRAD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      grad.re[i] = -sum_r[i];
      grad.im[i] = sum_i[i];
    }
    return 0.f;
  }
  part += __shfl_xor_sync(FULL_MASK, part, 2);
  part += __shfl_xor_sync(FULL_MASK, part, 1);
  return -part;
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
    apg_fused_1q_kernel(const float* __restrict__ a_r,
                        const float* __restrict__ a_i,
                        const float* __restrict__ n,
                        const float* __restrict__ rho0_r,
                        const float* __restrict__ rho0_i,
                        float* __restrict__ out_r, float* __restrict__ out_i,
                        int batch, int rows, const ApgPhases sch,
                        const ApgSweepsRest rest) {
  constexpr int NN = Dims<2>::NN, P = PROBLEMS_1Q;
  extern __shared__ __align__(16) float dyn[];
  const int rp = padded_rows_1q(rows);
  const Smem1q lay(rp);
  const int t = threadIdx.x, g = t >> 2, j = t & 3;
  const size_t first = static_cast<size_t>(blockIdx.x) * P;
  const size_t b = first + g;
  const bool live = b < static_cast<size_t>(batch);

  // A, A^T and the counts, padded with zero rows
  for (int k = t; k < rp * NN; k += THREADS) {
    const int r = k / NN, c = k % NN;
    const float vr = r < rows ? a_r[k] : 0.f, vi = r < rows ? a_i[k] : 0.f;
    dyn[lay.ar + r * PAD_1Q + c] = vr;
    dyn[lay.ai + r * PAD_1Q + c] = vi;
    dyn[lay.atr + c * lay.at_stride + r] = vr;
    dyn[lay.ati + c * lay.at_stride + r] = vi;
  }
  // problems past the batch run on zero counts and a zero start, and are
  // not written back
  for (int k = t; k < P * rp; k += THREADS) {
    const int q = k / rp, r = k - q * rp;
    const size_t prob = first + q;
    dyn[lay.n + k] = prob < static_cast<size_t>(batch) && r < rows
                         ? n[prob * rows + r] : 0.f;
  }
  Col v, est;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v.re[i] = i == j ? 1.f : 0.f;
    v.im[i] = 0.f;
    est.re[i] = live ? rho0_r[b * NN + 4 * i + j] : 0.f;
    est.im[i] = live ? rho0_i[b * NN + 4 * i + j] : 0.f;
  }
  // A and the counts are staged by the whole block: the kernel's one barrier
  __syncthreads();
  Col grad;
  dykstra_1q<false>(j, sch.init_iters, sch.init_sweeps, sch.init_sweeps, v,
                    est);

  Col prev = est;
  float tk = 1.f;
  float old_cost = a_pass_1q<false>(dyn, lay, rp, g, j, est, grad);
  for (int ph = 0; ph < sch.n_phases; ++ph) {
    for (int it = 0; it < sch.outer[ph]; ++it) {
      const float t_next = (1.f + sqrtf(1.f + 4.f * tk * tk)) / 2.f;
      const float beta = (tk - 1.f) / t_next;
      Col y, z;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y.re[i] = est.re[i] + beta * (est.re[i] - prev.re[i]);
        y.im[i] = est.im[i] + beta * (est.im[i] - prev.im[i]);
      }
      a_pass_1q<true>(dyn, lay, rp, g, j, y, grad);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z.re[i] = y.re[i] - sch.inv_mu * grad.re[i];
        z.im[i] = y.im[i] - sch.inv_mu * grad.im[i];
      }
      dykstra_1q<SPLIT>(j, sch.dykstra[ph], sch.sweeps[ph],
                        rest.sweeps_rest[ph], v, z);
      const float new_cost = a_pass_1q<false>(dyn, lay, rp, g, j, z, grad);
      // O'Donoghue-Candes function restart
      tk = new_cost > old_cost ? 1.f : t_next;
      prev = est;
      est = z;
      old_cost = new_cost;
    }
  }
  dykstra_1q<SPLIT>(j, sch.final_iters, sch.final_sweeps,
                    rest.final_sweeps_rest, v, est);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out_r[b * NN + 4 * i + j] = est.re[i];
      out_i[b * NN + 4 * i + j] = est.im[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The standalone CP projection (cold start, V = I): one warp a matrix.
//
// A warp keeps its matrix's M and V in a slice of shared memory, complex
// entries as float2 with row stride CP_STRIDE, and its lanes wait only on
// __syncwarp. Lane l works on pair k = l % 8 of every round: it computes
// that pair's coefficients itself (the four lanes of a pair compute the
// same bits), rotates columns p_k, q_k of M and of V in four rows and rows
// p_k, q_k of M in four columns: rows (columns) 8 u + 4 h + t, t = 0..3,
// u = (l / 8) % 2, h = l / 16. A half-warp's sixteen 8-byte accesses then
// touch rows (columns) t and 8 + t, in distinct banks unless the round
// pairs some p with p + 8.
// ---------------------------------------------------------------------------

constexpr int CP_PER_BLOCK = 8;  // matrices per block
static_assert(CP_PER_BLOCK * 32 == THREADS, "a matrix is a warp");
constexpr int CP_STRIDE = 17;  // row stride of M and V, in complex entries

struct CpWarp {
  float2 m[16 * CP_STRIDE];  // M, rotated in place by the sweeps
  float2 v[16 * CP_STRIDE];  // eigenbasis
};

// The seat of a player of _round_robin_pairs(16) one round later: seat 0
// stays, the others move down by one, 1 wrapping to 15. Pair k of round r
// (c_pairs16[r][k]) is the players at seats k and 15 - k of round 0, moved
// r times, sorted.
__device__ __forceinline__ int next_seat(int x) {
  return x == 0 ? 0 : (x == 1 ? 15 : x - 1);
}

// Entries p and q of a row of M or V: p <- c p - s conj(e) q,
// q <- s e p + c q (columns p, q rotated), as jacobi_sweeps.
__device__ __forceinline__ void rotate_cols_cp(float2* row, int p, int q,
                                               float c, float sn, float er,
                                               float ei) {
  const float2 x = row[p], y = row[q];
  const float tqr = er * y.x + ei * y.y, tqi = er * y.y - ei * y.x;
  const float tpr = er * x.x - ei * x.y, tpi = er * x.y + ei * x.x;
  row[p] = make_float2(c * x.x - sn * tqr, c * x.y - sn * tqi);
  row[q] = make_float2(sn * tpr + c * y.x, sn * tpi + c * y.y);
}

// Entries (p, col) and (q, col) of M: p <- c p - s e q,
// q <- s conj(e) p + c q (rows p, q rotated), as jacobi_sweeps.
__device__ __forceinline__ void rotate_rows_cp(float2* m, int col, int p,
                                               int q, float c, float sn,
                                               float er, float ei) {
  const float2 x = m[p * CP_STRIDE + col], y = m[q * CP_STRIDE + col];
  const float tqr = er * y.x - ei * y.y, tqi = er * y.y + ei * y.x;
  const float tpr = er * x.x + ei * x.y, tpi = er * x.y - ei * x.x;
  m[p * CP_STRIDE + col] = make_float2(c * x.x - sn * tqr, c * x.y - sn * tqi);
  m[q * CP_STRIDE + col] = make_float2(sn * tpr + c * y.x, sn * tpi + c * y.y);
}

__global__ void __launch_bounds__(THREADS)
    cp_project_kernel(const float2* __restrict__ h, float2* __restrict__ out,
                      int batch, int sweeps) {
  constexpr int NN = Dims<4>::NN;
  __shared__ CpWarp warps[CP_PER_BLOCK];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const size_t b = static_cast<size_t>(blockIdx.x) * CP_PER_BLOCK + w;
  // a warp past the batch leaves at once: no barrier spans two warps
  if (b >= static_cast<size_t>(batch)) return;
  CpWarp& s = warps[w];
#pragma unroll
  for (int t = 0; t < NN / 32; ++t) {
    const int e = l + 32 * t, r = e >> 4, c = e & 15;
    s.m[r * CP_STRIDE + c] = h[b * NN + e];
    s.v[r * CP_STRIDE + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncwarp();
  const int k = l & 7;
  const int base = 8 * ((l >> 3) & 1) + 4 * (l >> 4);
  for (int sw = 0; sw < sweeps; ++sw) {
    int x = k, y = 15 - k;  // the seats of pair k in round 0
    for (int r = 0; r < Dims<4>::NROUNDS; ++r) {
      const int p = min(x, y), q = max(x, y);
      const float2 apq = s.m[p * CP_STRIDE + q];
      float c, sn, er, ei;
      rotation_coeffs(apq.x, apq.y, s.m[p * CP_STRIDE + p].x,
                      s.m[q * CP_STRIDE + q].x, c, sn, er, ei);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        rotate_cols_cp(s.m + (base + t) * CP_STRIDE, p, q, c, sn, er, ei);
        rotate_cols_cp(s.v + (base + t) * CP_STRIDE, p, q, c, sn, er, ei);
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        rotate_rows_cp(s.m, base + t, p, q, c, sn, er, ei);
      __syncwarp();
      x = next_seat(x);
      y = next_seat(y);
    }
  }
  // entries (i, j) = (l / 16 + 2 t, l % 16), t = 0..7, of
  // V diag(max(m_kk, 0)) V^dag, k in order
  const int j = l & 15, i0 = l >> 4;
  float pos_r[8], pos_i[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) pos_r[t] = pos_i[t] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float wk = fmaxf(s.m[kk * CP_STRIDE + kk].x, 0.f);
    const float2 vj = s.v[j * CP_STRIDE + kk];
    const float yr = vj.x, yi = -vj.y;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 vi = s.v[(i0 + 2 * t) * CP_STRIDE + kk];
      const float xr = vi.x * wk, xi = vi.y * wk;
      pos_r[t] = pos_r[t] + xr * yr - xi * yi;
      pos_i[t] = pos_i[t] + xr * yi + xi * yr;
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
    out[b * NN + (i0 + 2 * t) * 16 + j] = make_float2(pos_r[t], pos_i[t]);
}

// Whether a projection of the schedule runs another sweep count after its
// first iteration. The kernels without SPLIT, which the shipped schedules
// run, keep one sweep count less live through the Dykstra loop.
bool splits(const ApgSchedule& sch) {
  if (sch.rest.final_sweeps_rest != sch.phases.final_sweeps) return true;
  for (int ph = 0; ph < sch.phases.n_phases; ++ph)
    if (sch.rest.sweeps_rest[ph] != sch.phases.sweeps[ph]) return true;
  return false;
}

template <bool SPLIT>
cudaError_t launch_apg(const float* a_r, const float* a_i, const float* at_r,
                       const float* at_i, const float* n, const float* rho0_r,
                       const float* rho0_i, float* out_r, float* out_i,
                       int batch, int rows, int dim, const ApgSchedule& sch,
                       cudaStream_t st) {
  cudaError_t err;
  if (dim == 4) {
    // at_r/at_i: A^T, (256, rows) planes, read by the p pass
    constexpr int P = PROBLEMS_2Q;
    const size_t dyn = shared2q_head<P>() +
                       2 * P * static_cast<size_t>(rows) * sizeof(float);
    err = cudaFuncSetAttribute(apg_fused_kernel<P, SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that no later check reports it
      return err;
    }
    apg_fused_kernel<P, SPLIT><<<(batch + P - 1) / P, THREADS * P, dyn, st>>>(
        a_r, a_i, at_r, at_i, n, rho0_r, rho0_i, out_r, out_i, batch, rows,
        sch.phases, sch.rest);
  } else if (dim == 2) {
    constexpr int P = PROBLEMS_1Q;
    const size_t dyn = Smem1q(padded_rows_1q(rows)).total * sizeof(float);
    err = cudaFuncSetAttribute(apg_fused_1q_kernel<SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that no later check reports it
      return err;
    }
    apg_fused_1q_kernel<SPLIT><<<(batch + P - 1) / P, THREADS, dyn, st>>>(
        a_r, a_i, n, rho0_r, rho0_i, out_r, out_i, batch, rows, sch.phases,
        sch.rest);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int apg_fused_launch(const float* a_r, const float* a_i,
                                const float* at_r, const float* at_i,
                                const float* n, const float* rho0_r,
                                const float* rho0_i, float* out_r,
                                float* out_i, int batch, int rows, int dim,
                                const ApgSchedule* sched, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      splits(*sched)
          ? launch_apg<true>(a_r, a_i, at_r, at_i, n, rho0_r, rho0_i, out_r,
                             out_i, batch, rows, dim, *sched, st)
          : launch_apg<false>(a_r, a_i, at_r, at_i, n, rho0_r, rho0_i, out_r,
                              out_i, batch, rows, dim, *sched, st);
  return static_cast<int>(err);
}

extern "C" int cp_project_launch(const void* h, void* out, int batch,
                                 int sweeps, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  cp_project_kernel<<<(batch + CP_PER_BLOCK - 1) / CP_PER_BLOCK, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), static_cast<float2*>(out), batch, sweeps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
