// apg_fused.cu -- the fused APG process-MLE solve for 2Q (dim = 4), f32,
// hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel in forest_benchmarking_tpu/ops/lanes_apg.py:
// `apg_fused` (its pallas_call in `_run_pallas`, body `apg_fused_lanes`,
// helpers `_dykstra`, `_warm_cp`, `_multi_sweep`, `_rotation_coeffs`,
// `_proj_tp`). Same algorithm and op order as the plain PyTorch version
// `apg_fused_reference` in forest_benchmarking_tpu_torch/ops/lanes_apg.py:
//
//   est = Dykstra(rho0)                       (init_iters, init_sweeps)
//   for each phase (outer, dykstra, sweeps), outer times:
//     t' = (1 + sqrt(1 + 4 t^2)) / 2,  y = est + (t - 1)/t' (est - prev)
//     z  = y - (1/mu) grad(y),  grad = -A_r^T eta + i A_i^T eta,
//          eta = n / max(Re(A vec y), 1e-6)
//     cand = Dykstra(z)                       (dykstra, sweeps)
//     restart: t = 1 if cost(cand) > cost(est) else t'
//   return Dykstra(est)                       (final_iters, final_sweeps)
//
// Dykstra alternates the CP projection (rotate H into the carried eigenbasis
// V, run cyclic-Jacobi sweeps, clip negative eigenvalues, reconstruct) and
// the TP projection; V carries across Dykstra iterations and outer steps.
//
// Layout: one thread block per problem, 256 threads, thread t owning Choi
// entry (i, j) = (t / 16, t % 16). The elementwise APG/Dykstra state (est,
// prev, the two Dykstra corrections, the Dykstra iterate) lives in that
// thread's registers; the matrices that threads exchange (operand, H, HV,
// M, V) and the counts and eta vectors live in shared memory (~19 KB per
// block at R = 1080 rows). The TPU kernel's pair-layout permutations, fences
// and vreg tiling are not carried: a Jacobi round rotates the pairs (p, q)
// of `_round_robin_pairs` in place.
//
// What bounds it on an H100:
// - L2 bytes of A. Both A contractions are computed here, by hand: p =
//   Re(A x) with one warp per row (lanes read the row coalesced, shuffle
//   reduction), and A^T eta with thread j summing column j over the rows.
//   The two f32 planes of A (1080 x 256) are 2.2 MB, shared by all blocks
//   and resident in the 50 MB L2, and every block re-reads them on each
//   pass: 1 pass for the first cost plus 3 per outer step (p and A^T eta at
//   y, p for the cost of the candidate). Headline schedule: 16 passes =
//   35 MB from L2 per solve; parity schedule: 133 passes = 294 MB per solve.
//   Tiles of P problems per block would divide that by P (later work).
// - The serial Jacobi rounds: 15 rounds per sweep, each three steps
//   (coefficients, column rotations, row rotations) with a __syncthreads
//   between them. Many resident blocks per SM (small shared-memory and
//   register footprint) hide that latency.

#include <cuda_runtime.h>

#define APG_MAX_PHASES 8  // must match MAX_PHASES in kernels/__init__.py

struct ApgSchedule {
  int n_phases;
  int outer[APG_MAX_PHASES];
  int dykstra[APG_MAX_PHASES];
  int sweeps[APG_MAX_PHASES];
  int init_iters, init_sweeps, final_iters, final_sweeps;
  float inv_mu;
};

namespace {

constexpr int D = 4;             // Hilbert-space dimension (2 qubits)
constexpr int N = D * D;         // Choi matrix side
constexpr int NN = N * N;        // Choi matrix entries
constexpr int THREADS = NN;      // one thread per entry
constexpr int WARPS = THREADS / 32;
constexpr int NPAIRS = N / 2;
constexpr int NROUNDS = N - 1;
constexpr float EPS_ROT = 1e-18f;  // f32 rotation threshold of _rotation_coeffs
constexpr float EPS_P = 1e-6f;     // probability clamp

// _round_robin_pairs(16): NROUNDS rounds of NPAIRS disjoint pairs (p < q).
__constant__ unsigned char c_pairs[NROUNDS][NPAIRS][2] = {
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

struct Shared {
  float sr[NN], si[NN];    // operand of the A products, CP input, TP input
  float hr[NN], hi[NN];    // hermitianized CP input H
  float tr[NN], ti[NN];    // H V
  float mr[NN], mi[NN];    // M = V^dag H V, rotated in place by the sweeps
  float vr[NN], vi[NN];    // eigenbasis carried across projections
  float rot[4][NPAIRS];    // this round's c, s, e_r, e_i per pair
  float ptr[D * D], pti[D * D];  // Tr_out of the TP input
  float red[WARPS];        // per-warp partial sums of the cost
  unsigned char pairs[NROUNDS][NPAIRS][2];
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

// `sweeps` cyclic-Jacobi sweeps: M <- G^dag M G and V <- V G, round by round.
__device__ void jacobi_sweeps(Shared& s, int sweeps, int t) {
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < NROUNDS; ++r) {
      if (t < NPAIRS) {
        const int p = s.pairs[r][t][0], q = s.pairs[r][t][1];
        float c, sn, er, ei;
        rotation_coeffs(s.mr[p * N + q], s.mi[p * N + q], s.mr[p * N + p],
                        s.mr[q * N + q], c, sn, er, ei);
        s.rot[0][t] = c;
        s.rot[1][t] = sn;
        s.rot[2][t] = er;
        s.rot[3][t] = ei;
      }
      __syncthreads();
      {
        // columns p, q of M (threads 0..127) and of V (threads 128..255):
        // p <- c p - s conj(e) q,  q <- s e p + c q
        const int u = t & 127, row = u >> 3, k = u & 7;
        const int p = s.pairs[r][k][0], q = s.pairs[r][k][1];
        float* xr = t < 128 ? s.mr : s.vr;
        float* xi = t < 128 ? s.mi : s.vi;
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
      __syncthreads();
      if (t < 128) {
        // rows p, q of M: p <- c p - s e q,  q <- s conj(e) p + c q
        const int col = t >> 3, k = t & 7;
        const int p = s.pairs[r][k][0], q = s.pairs[r][k][1];
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
      __syncthreads();
    }
  }
}

// CP projection of the matrix in s.sr/s.si (written and synced by the
// caller) in the carried eigenbasis; this thread's entry of the positive part.
__device__ void warm_cp(Shared& s, int sweeps, int t, float& pos_r,
                        float& pos_i) {
  const int i = t >> 4, j = t & 15;
  s.hr[t] = (s.sr[i * N + j] + s.sr[j * N + i]) / 2.f;
  s.hi[t] = (s.si[i * N + j] - s.si[j * N + i]) / 2.f;
  __syncthreads();
  // T = H V
  float ar = s.hr[i * N] * s.vr[j] - s.hi[i * N] * s.vi[j];
  float ai = s.hr[i * N] * s.vi[j] + s.hi[i * N] * s.vr[j];
  for (int k = 1; k < N; ++k) {
    const float hr = s.hr[i * N + k], hi = s.hi[i * N + k];
    const float vr = s.vr[k * N + j], vi = s.vi[k * N + j];
    ar = ar + hr * vr - hi * vi;
    ai = ai + hr * vi + hi * vr;
  }
  s.tr[t] = ar;
  s.ti[t] = ai;
  __syncthreads();
  // M = V^dag T
  ar = s.vr[i] * s.tr[j] + s.vi[i] * s.ti[j];
  ai = s.vr[i] * s.ti[j] - s.vi[i] * s.tr[j];
  for (int k = 1; k < N; ++k) {
    const float vr = s.vr[k * N + i], vi = s.vi[k * N + i];
    const float tr = s.tr[k * N + j], ti = s.ti[k * N + j];
    ar = ar + vr * tr + vi * ti;
    ai = ai + vr * ti - vi * tr;
  }
  s.mr[t] = ar;
  s.mi[t] = ai;
  __syncthreads();
  jacobi_sweeps(s, sweeps, t);
  // pos = W diag(max(m_kk, 0)) W^dag, W = the rotated V
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

// TP projection X - kron(Tr_out(X) - I, I) / D of the matrix whose entry t
// is (xr, xi).
__device__ void proj_tp(Shared& s, int t, float xr, float xi, float& out_r,
                        float& out_i) {
  s.sr[t] = xr;
  s.si[t] = xi;
  __syncthreads();
  if (t < D * D) {
    const int a = t >> 2, c = t & 3;
    float accr = s.sr[(a * D) * N + c * D], acci = s.si[(a * D) * N + c * D];
    for (int b = 1; b < D; ++b) {
      accr += s.sr[(a * D + b) * N + c * D + b];
      acci += s.si[(a * D + b) * N + c * D + b];
    }
    s.ptr[t] = accr;
    s.pti[t] = acci;
  }
  __syncthreads();
  const int i = t >> 4, j = t & 15;
  const int a = i >> 2, b = i & 3, c = j >> 2, d = j & 3;
  out_r = xr;
  out_i = xi;
  if (b == d) {
    out_r = xr - (s.ptr[a * D + c] - (a == c ? 1.f : 0.f)) / D;
    out_i = xi - s.pti[a * D + c] / D;
  }
}

// `iters` Dykstra iterations (CP then TP) on the matrix whose entry t is
// (zr, zi); ends on the TP half-step. The result replaces (zr, zi).
__device__ void dykstra(Shared& s, int t, int iters, int sweeps, float& zr,
                        float& zi) {
  float cp_r = 0.f, cp_i = 0.f, tp_r = 0.f, tp_i = 0.f;
  float st_r = zr, st_i = zi;
  for (int it = 0; it < iters; ++it) {
    const float pre_r = st_r - cp_r, pre_i = st_i - cp_i;
    s.sr[t] = pre_r;
    s.si[t] = pre_i;
    __syncthreads();
    float pos_r, pos_i;
    warm_cp(s, sweeps, t, pos_r, pos_i);
    cp_r = pos_r - pre_r;
    cp_i = pos_i - pre_i;
    const float pre2_r = pos_r - tp_r, pre2_i = pos_i - tp_i;
    proj_tp(s, t, pre2_r, pre2_i, st_r, st_i);
    tp_r = st_r - pre2_r;
    tp_i = st_i - pre2_i;
  }
  zr = st_r;
  zi = st_i;
}

// One pass over A: p_r = max(Re(A x)_r, EPS_P) for x in s.sr/s.si (written
// and synced by the caller), one warp per row. With `cost` false it stores
// eta_r = n_r / p_r; with `cost` true it returns -sum_r n_r log p_r, the same
// value in every thread. Ends with a __syncthreads.
__device__ float a_pass(Shared& s, const float* __restrict__ a_r,
                        const float* __restrict__ a_i, const float* sn,
                        float* seta, int rows, int t, bool cost) {
  const int w = t >> 5, lane = t & 31;
  float part = 0.f;
  for (int r = w; r < rows; r += WARPS) {
    const float* rr = a_r + static_cast<size_t>(r) * NN;
    const float* ri = a_i + static_cast<size_t>(r) * NN;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < NN / 32; ++m) {
      const int k = lane + 32 * m;
      acc += __ldg(rr + k) * s.sr[k] - __ldg(ri + k) * s.si[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float p = fmaxf(acc, EPS_P);
    if (cost)
      part += sn[r] * logf(p);  // lane 0's sum is the one used
    else if (lane == 0)
      seta[r] = sn[r] / p;
  }
  if (!cost) {
    __syncthreads();
    return 0.f;
  }
  if (lane == 0) s.red[w] = part;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < WARPS; ++k) total += s.red[k];
  return -total;
}

__device__ float cost_of(Shared& s, const float* __restrict__ a_r,
                         const float* __restrict__ a_i, const float* sn,
                         int rows, int t, float xr, float xi) {
  s.sr[t] = xr;
  s.si[t] = xi;
  __syncthreads();
  return a_pass(s, a_r, a_i, sn, nullptr, rows, t, true);
}

__global__ void __launch_bounds__(THREADS)
    apg_fused_kernel(const float* __restrict__ a_r,
                     const float* __restrict__ a_i,
                     const float* __restrict__ n,
                     const float* __restrict__ rho0_r,
                     const float* __restrict__ rho0_i,
                     float* __restrict__ out_r, float* __restrict__ out_i,
                     int rows, const ApgSchedule sch) {
  __shared__ Shared s;
  extern __shared__ float dyn[];
  float* sn = dyn;            // counts of this problem, rows entries
  float* seta = dyn + rows;   // n / p, rows entries
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;

  if (t < NROUNDS * NPAIRS * 2)
    (&s.pairs[0][0][0])[t] = (&c_pairs[0][0][0])[t];
  for (int r = t; r < rows; r += THREADS) sn[r] = n[b * rows + r];
  s.vr[t] = (t >> 4) == (t & 15) ? 1.f : 0.f;
  s.vi[t] = 0.f;
  float est_r = rho0_r[b * NN + t], est_i = rho0_i[b * NN + t];
  // every shared buffer above is read only after the first __syncthreads
  dykstra(s, t, sch.init_iters, sch.init_sweeps, est_r, est_i);

  float prev_r = est_r, prev_i = est_i;
  float tk = 1.f;
  float old_cost = cost_of(s, a_r, a_i, sn, rows, t, est_r, est_i);
  for (int ph = 0; ph < sch.n_phases; ++ph) {
    for (int it = 0; it < sch.outer[ph]; ++it) {
      const float t_next = (1.f + sqrtf(1.f + 4.f * tk * tk)) / 2.f;
      const float beta = (tk - 1.f) / t_next;
      const float y_r = est_r + beta * (est_r - prev_r);
      const float y_i = est_i + beta * (est_i - prev_i);
      s.sr[t] = y_r;
      s.si[t] = y_i;
      __syncthreads();
      a_pass(s, a_r, a_i, sn, seta, rows, t, false);
      // gradient entry t: -sum_r A_r[r, t] eta_r + i sum_r A_i[r, t] eta_r
      float sum_r = 0.f, g_i = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float e = seta[r];
        sum_r += __ldg(a_r + static_cast<size_t>(r) * NN + t) * e;
        g_i += __ldg(a_i + static_cast<size_t>(r) * NN + t) * e;
      }
      const float g_r = -sum_r;
      float z_r = y_r - sch.inv_mu * g_r;
      float z_i = y_i - sch.inv_mu * g_i;
      dykstra(s, t, sch.dykstra[ph], sch.sweeps[ph], z_r, z_i);
      const float new_cost = cost_of(s, a_r, a_i, sn, rows, t, z_r, z_i);
      // O'Donoghue-Candes function restart
      tk = new_cost > old_cost ? 1.f : t_next;
      prev_r = est_r;
      prev_i = est_i;
      est_r = z_r;
      est_i = z_i;
      old_cost = new_cost;
    }
  }
  dykstra(s, t, sch.final_iters, sch.final_sweeps, est_r, est_i);
  out_r[b * NN + t] = est_r;
  out_i[b * NN + t] = est_i;
}

}  // namespace

extern "C" int apg_fused_launch(const float* a_r, const float* a_i,
                                const float* n, const float* rho0_r,
                                const float* rho0_i, float* out_r,
                                float* out_i, int batch, int rows,
                                const ApgSchedule* sched, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const size_t dyn = 2 * static_cast<size_t>(rows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      apg_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  apg_fused_kernel<<<batch, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
      a_r, a_i, n, rho0_r, rho0_i, out_r, out_i, rows, *sched);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
