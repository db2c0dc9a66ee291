// qv_traj.cu -- quantum-volume statevector kernels, f32, hand-written for
// NVIDIA Hopper (sm_90a): Kraus-trajectory probabilities of noisy model
// circuits, and ideal output probabilities.
//
// Replaces the TPU kernels in forest_benchmarking_tpu/ops/pallas_traj.py:
// `traj_probs_pallas` (:301) and `ideal_probs_pallas` (:410), both of which
// reach `pl.pallas_call` in `_traj_pallas_call` (:374) with the body
// `_kernel` (:81). Same math as the plain PyTorch versions
// `traj_probs_reference` / `ideal_probs_reference` in
// forest_benchmarking_tpu_torch/ops/pallas_traj.py:
//
//   psi = |0...0>
//   for each layer l:
//     psi[x] <- psi[h_l[x]]                       (boundary index map)
//     for each slot j (qubits j, j+1 = bits s + 1, s of x, s = d - 2 - j):
//       ideal: psi <- U_lj psi
//       noisy: rho = the 4x4 pair-reduced density of psi on the slot
//              p_k = max(Re sum_ab M'_k[a,b] rho[b,a], 0),  p /= sum_k p_k
//              k*  = #{k : p_0 + ... + p_k < u_lj}, clamped to K - 1
//              psi <- W_k* psi,  W_k = K_k U_lj,  M'_k = U_lj^dag K_k^dag K_k U_lj
//     noisy: psi /= |psi|                         (once per layer)
//   psi[x] <- psi[h_d[x]];  out = |psi|^2 / sum |psi|^2
//
// Trajectory kernel (`traj_probs_kernel<D>`, one instantiation per depth D
// from 2 to 10). One warp evolves one trajectory, and its state lives in
// registers: lane `lane` holds R = max(4, 2^D / 32) amplitudes, register r
// holding amplitude (r << LB) | lane at the start of a layer (LB = D - log2
// R lane bits). The slots of a layer touch the top D/2 + 1 bits of x, two
// neighbouring bits at a time, from the top down. The register bits hold
// the top log2 R bits, so the first log2 R - 1 slots apply without any
// exchange; each later slot first swaps the register bit whose slot is done
// with the lane bit it needs: R/2 complex values a lane, R shuffles. The
// boundary gather is the one trip through shared memory per layer: the
// warp writes its state at the index of the layout the slots left it in
// (XOR-swizzled over the banks) and reads it back gathered by h_l in the
// start layout. At each end of the range:
// - D = 10: 32 amplitudes, 64 registers of state a lane; four slots run in
//   place and one swap (32 shuffles) precedes the fifth. Eight warps a
//   block, so that ptxas may give a thread up to 255 registers.
// - D = 8, the main path: 8 amplitudes a lane, two swaps (8 shuffles each)
//   a layer. D = 7: 4 amplitudes.
// - D <= 6: four amplitudes a lane on the first 2^(D-2) lanes; the other
//   lanes hold zeros and take part only in the shuffles (one trajectory a
//   warp; these depths are small and the quantum-volume entry point runs
//   them by the density method unless asked otherwise).
// A slot: each lane sums its share of the pair density (16 reals: 4 on the
// diagonal, 6 complex above it) over its R/4 groups of four amplitudes;
// the warp reduces the 16 sums by transpose-and-halve (exchange half the
// values with lane ^ 16, add, then ^ 8, ^ 4, ^ 2: 15 shuffles, and one
// more for the last pair), so that lanes 2i and 2i + 1 hold entry i, and
// 16 broadcast shuffles give every lane all of them. Lane k < K forms p_k
// from M'_k's 16 hermitian-half entries, a warp scan gives the cumulative
// sums, a ballot counts those whose share of the total is below u, and
// every lane reads the chosen W_k* (32 floats, one broadcast) and applies
// it to its groups. The order of every sum is fixed by the lane and register
// positions, so a trajectory's column does not depend on which
// trajectories share its block.
//
// A block is WARPS trajectories of one circuit (16, and 8 at D = 10). It
// copies the circuit's gates and index maps and the Kraus stack into
// shared memory once, forms K_k^dag K_k, and then forms W_k and M'_k for
// every slot of a layer itself, into one of two buffers, while the warps
// evolve the previous layer; one __syncthreads per layer. Nothing but the
// function's own inputs and the index maps comes from device memory. Warps
// past the last trajectory evolve a copy of it and write nothing, so that
// no shuffle sits under a branch. At the end the block stages its WARPS
// columns in shared memory and writes the (C, 2^d, T) output in runs of
// WARPS floats. Every loop over registers has constant bounds and is
// unrolled (the reduction's steps are a template): an array indexed by a
// loop the compiler keeps rolled is emulated with predicated moves.
//
// What bounds it on an H100, at C = 1600 circuits, T = 1000 trajectories,
// d = 8, K = 16: the arithmetic. Per trajectory ~426 kFLOP (see
// `traj_flops_per_circuit`: per slot 16 * 2^d for the pair density, 32 K for
// the branch weights on their hermitian halves, 32 * 2^d for the W apply;
// per layer 7 * 2^d for the renormalization; the permutations are gathers
// and do no arithmetic), so 0.68 TFLOP in all, 10.2 ms at 67 TFLOP/s f32
// outside the tensor cores. The function's bytes are ~1.85 GB (output
// 1.64 GB, uniforms 0.2 GB, gates 6.6 MB, permutations 0.8 MB): 0.55 ms at
// 3.35 TB/s. Between the kernel and that bound stand the instructions that
// are not FMAs: per slot and lane at d = 8 some 210 FMAs beside ~35
// shuffles, the selects of the reduction, the loads of M', the scan and
// the broadcast loads of W; per layer the shared-memory round trip of the
// gather and the formation of the next layer's W and M' (~48 kFLOP a
// block). The kernel is bound by instruction throughput. The ideal
// function does 0.42 GFLOP and needs ~9 MB (permutations, gates, output) at
// C = 1600: bound by operations at 0.0063 ms; at ~12 circuits an SM the
// kernel is held back by the latency of each warp's chain (the gather's
// shared-memory round trip, the shuffles of the bit swaps) more than by issue.
//
// Ideal kernel (`ideal_probs_kernel<D>`, one instantiation per depth D from
// 2 to 10): the trajectory kernel's register layout without the noise, so
// the state stays in registers and a slot is one 4x4 apply. It takes the
// function's own inputs, the (C, d, d) permutations and the gates, and forms
// the boundary maps itself: every h_l is a bit permutation of the amplitude
// index, so the warp derives, per circuit and boundary, the D source bit
// positions (four bits each, one 64-bit word) from perm_l and the inverse of
// perm_{l-1}, and a lane's gather source is its lane part ORed with the
// parts of its register bits; no map is read from memory. From depth 7 on a
// warp holds one circuit (R = max(4, 2^D / 32) amplitudes a lane); below, a
// circuit is a group of 2^(D-2) lanes with four amplitudes a lane, 32 /
// 2^(D-2) circuits a warp, whose shuffles and normalization stay in the
// group (their lane bits are below LB). Each warp copies its circuits'
// gates and permutations into its slice of shared memory with coalesced
// loads, and waits on no other warp (no __syncthreads). Lane groups past the
// last circuit evolve a copy of it and write nothing; warps past it return
// at once. A register row of the output is a run of 2^LB floats (32 from
// depth 7 on).

#include <cuda_runtime.h>

#include <utility>

#define QV_MIN_DEPTH 2   // MIN_DEPTH in ops/pallas_traj.py
#define QV_MAX_DEPTH 10  // MAX_DEPTH in ops/pallas_traj.py
#define QV_MAX_KRAUS 32  // MAX_KRAUS in ops/pallas_traj.py: a lane per operator

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Position of the pair (a, b), a < b, in the order (0,1) (0,2) (0,3) (1,2)
// (1,3) (2,3).
__host__ __device__ constexpr int pair_index(int a, int b) {
  return a * (7 - a) / 2 + (b - a - 1);
}

// ---------------------------------------------------------------------------
// Trajectory kernel: the state in registers.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ilog2(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return r;
}

// The layout of one trajectory at depth D, and the block.
template <int D>
struct Traj {
  static constexpr int N = 1 << D;                  // amplitudes
  static constexpr int R = N / 32 > 4 ? N / 32 : 4; // amplitudes a lane
  static constexpr int RB = ilog2(R);               // register bits
  static constexpr int LB = D - RB;                 // lane bits
  static constexpr int L = 1 << LB;                 // lanes holding amplitudes
  static constexpr int S = D / 2;                   // slots a layer
  static constexpr int WARPS = D >= 10 ? 8 : 16;    // trajectories a block
  static constexpr int THREADS = 32 * WARPS;
};

// Slot j's two amplitude bits s + 1 and s (s = D - 2 - j) sit in register
// bits `hi` and `lo`; if `swap_reg` >= 0, register bit `swap_reg` is first
// exchanged with lane bit `swap_lane` (= s): the register bit then holds s
// and the lane bit s + 2, whose slot is done.
struct SlotPlan {
  int hi, lo, swap_reg, swap_lane;
};

template <int D>
__host__ __device__ constexpr SlotPlan slot_plan(int j) {
  constexpr int RB = Traj<D>::RB;
  const int s = D - 2 - j;
  if (j < RB - 1) return {s + 1 - (D - RB), s - (D - RB), -1, -1};
  const int q = (j - (RB - 1)) % 2 == 0 ? 1 : 0;
  return {1 - q, q, q, s};
}

// The amplitude bit held by register bit i once a layer's slots are done.
template <int D>
__host__ __device__ constexpr int end_reg_bit(int i) {
  constexpr int RB = Traj<D>::RB, S = Traj<D>::S;
  if (i >= 2 || S - 1 < RB - 1) return D - RB + i;
  const int s = D - 2 - (S - 1);
  return i == slot_plan<D>(S - 1).hi ? s + 1 : s;
}

// The amplitude bit held by lane bit k once a layer's slots are done.
template <int D>
__host__ __device__ constexpr int end_lane_bit(int k) {
  for (int j = Traj<D>::RB - 1; j < Traj<D>::S; ++j)
    if (D - 2 - j == k) return k + 2;
  return k;
}

// Register r's part of its amplitude index once a layer's slots are done.
template <int D>
__host__ __device__ constexpr int end_reg_index(int r) {
  int x = 0;
  for (int i = 0; i < Traj<D>::RB; ++i) x |= ((r >> i) & 1) << end_reg_bit<D>(i);
  return x;
}

// Shared-memory position of amplitude x: its 32-blocks XOR-ed into its
// bank, so that a bit permutation's gather meets few bank conflicts.
__device__ __forceinline__ int swz(int x) { return x ^ ((x >> 5) & 31); }

// Exchange register bit Q with lane bit LP: a lane whose lane bit is 0
// keeps its values with register bit 0 and takes its partner's with
// register bit 0 into register bit 1; its partner the other way round.
template <int R, int Q, int LP>
__device__ __forceinline__ void swap_bits(float (&re)[R], float (&im)[R],
                                          int lane) {
  const bool up = (lane >> LP) & 1;
#pragma unroll
  for (int r0 = 0; r0 < R; ++r0) {
    if (r0 & (1 << Q)) continue;
    const int r1 = r0 | (1 << Q);
    const float send_r = up ? re[r0] : re[r1];
    const float send_i = up ? im[r0] : im[r1];
    const float got_r = __shfl_xor_sync(FULL, send_r, 1 << LP);
    const float got_i = __shfl_xor_sync(FULL, send_i, 1 << LP);
    if (up) {
      re[r0] = got_r;
      im[r0] = got_i;
    } else {
      re[r1] = got_r;
      im[r1] = got_i;
    }
  }
}

// One step of transpose-and-halve: a lane keeps the half of v[0, 2 HALF)
// that its lane bit 2 HALF selects, sends the other half to lane ^ 2 HALF
// and adds what that lane sends into v[0, HALF). A template, so that every
// index is a constant and v stays in registers.
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * HALF);
  }
}

// The warp sum of 16 values by transpose-and-halve: lanes 2i and 2i + 1
// return the sum over all 32 lanes of v[i]. v is consumed.
__device__ __forceinline__ float reduce16(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// Slot J of a layer on the state (re, im). w: the layer's W planes,
// [slot][k][16 complex, row-major, interleaved]; m: its M' planes,
// [slot][16][k] (4 diagonal, 6 upper real, 6 upper imaginary parts);
// u_lanes: lane j holds slot j's uniform.
template <int D, int J>
__device__ __forceinline__ void traj_slot(float (&re)[Traj<D>::R],
                                          float (&im)[Traj<D>::R],
                                          const float* w, const float* m,
                                          int K, float u_lanes, int lane) {
  constexpr int R = Traj<D>::R;
  constexpr SlotPlan P = slot_plan<D>(J);
  if constexpr (P.swap_reg >= 0)
    swap_bits<R, P.swap_reg, P.swap_lane>(re, im, lane);

  // the lane's share of the pair density
  float acc[16] = {};
#pragma unroll
  for (int base = 0; base < R; ++base) {
    if (base & ((1 << P.hi) | (1 << P.lo))) continue;
    float xr[4], xi[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = base | ((a >> 1) << P.hi) | ((a & 1) << P.lo);
      xr[a] = re[r];
      xi[a] = im[r];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a] = fmaf(xi[a], xi[a], fmaf(xr[a], xr[a], acc[a]));
#pragma unroll
      for (int b = a + 1; b < 4; ++b) {
        const int pm = pair_index(a, b);
        acc[4 + 2 * pm] = fmaf(xi[a], xi[b], fmaf(xr[a], xr[b], acc[4 + 2 * pm]));
        acc[5 + 2 * pm] = fmaf(-xr[a], xi[b], fmaf(xi[a], xr[b], acc[5 + 2 * pm]));
      }
    }
  }
  const float own = reduce16(acc, lane);
  float rho[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) rho[i] = __shfl_sync(FULL, own, 2 * i);

  // lane k < K: p_k = max(Re tr(M'_k rho), 0) from the hermitian halves,
  // Re tr(M rho) = sum_a M[a,a] rho[a,a] + 2 sum_{a<b} Re(M[a,b] conj(rho[a,b]))
  // (lanes from K on read operator K - 1 and drop it: no branch)
  const float* mk = m + J * 16 * K + min(lane, K - 1);
  float p = 0.f, upper = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) p = fmaf(mk[a * K], rho[a], p);
#pragma unroll
  for (int pm = 0; pm < 6; ++pm)
    upper = fmaf(mk[(10 + pm) * K], rho[5 + 2 * pm],
                 fmaf(mk[(4 + pm) * K], rho[4 + 2 * pm], upper));
  p = lane < K ? fmaxf(fmaf(2.f, upper, p), 0.f) : 0.f;
  float cum = p;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, cum, off);
    if (lane >= off) cum += y;
  }
  // cum_k / total < u, without the division
  const float total = __shfl_sync(FULL, cum, 31);
  const float u = __shfl_sync(FULL, u_lanes, J);
  const unsigned below = __ballot_sync(FULL, lane < K && cum < u * total);
  const int k = min(__popc(below), K - 1);

  // psi <- W_k psi on the slot's groups
  const float4* wk = reinterpret_cast<const float4*>(w + (J * K + k) * 32);
  float wr[16], wi[16];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = wk[q];
    wr[2 * q] = v.x;
    wi[2 * q] = v.y;
    wr[2 * q + 1] = v.z;
    wi[2 * q + 1] = v.w;
  }
#pragma unroll
  for (int base = 0; base < R; ++base) {
    if (base & ((1 << P.hi) | (1 << P.lo))) continue;
    int idx[4];
    float xr[4], xi[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      idx[a] = base | ((a >> 1) << P.hi) | ((a & 1) << P.lo);
      xr[a] = re[idx[a]];
      xi[a] = im[idx[a]];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float ar = wr[a * 4] * xr[0], ai = wr[a * 4] * xi[0];
      ar = fmaf(-wi[a * 4], xi[0], ar);
      ai = fmaf(wi[a * 4], xr[0], ai);
#pragma unroll
      for (int b = 1; b < 4; ++b) {
        ar = fmaf(-wi[a * 4 + b], xi[b], fmaf(wr[a * 4 + b], xr[b], ar));
        ai = fmaf(wi[a * 4 + b], xr[b], fmaf(wr[a * 4 + b], xi[b], ai));
      }
      re[idx[a]] = ar;
      im[idx[a]] = ai;
    }
  }
}

template <int D, int... J>
__device__ __forceinline__ void traj_slots(std::integer_sequence<int, J...>,
                                           float (&re)[Traj<D>::R],
                                           float (&im)[Traj<D>::R],
                                           const float* w, const float* m,
                                           int K, float u_lanes, int lane) {
  (traj_slot<D, J>(re, im, w, m, K, u_lanes, lane), ...);
}

// psi[x] <- psi[h[x]]: the warp writes its state at the indices of the
// layout a layer ends in, and reads it back gathered, in the start layout.
template <int D>
__device__ __forceinline__ void permute(float (&re)[Traj<D>::R],
                                        float (&im)[Traj<D>::R], float* sr,
                                        float* si, const int* h,
                                        int lane_end, int lane) {
  using C = Traj<D>;
  const bool holds = lane < C::L;   // every lane from D = 7
  int from[C::R];
  if (holds) {
#pragma unroll
    for (int r = 0; r < C::R; ++r) from[r] = h[(r << C::LB) | lane];
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      const int x = swz(lane_end | end_reg_index<D>(r));
      sr[x] = re[r];
      si[x] = im[r];
    }
  }
  __syncwarp();
  if (holds) {
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      re[r] = sr[swz(from[r])];
      im[r] = si[swz(from[r])];
    }
  }
  __syncwarp();
}

// Layer l's planes into w (W, [slot][k][16 complex]) and m (M', [slot][16][k])
// from its gates g (S x 16 complex, interleaved), the Kraus operators kr
// and K_k^dag K_k mk (K x 16 complex each), all in shared memory: one task
// per (slot, operator, row a) for W and one for M', strided over the
// block's threads.
template <int D>
__device__ void form_layer(float* w, float* m, const float* g,
                           const float* kr, const float* mk, int K,
                           int tid) {
  constexpr int S = Traj<D>::S;
  for (int task = tid; task < 2 * S * K * 4; task += Traj<D>::THREADS) {
    const bool of_w = task < S * K * 4;
    const int row = of_w ? task : task - S * K * 4;
    const int a = row & 3, k = (row >> 2) % K, j = (row >> 2) / K;
    const float* u = g + j * 32;         // U_j [c][b] at (c * 4 + b) * 2
    if (of_w) {
      const float* krow = kr + k * 32 + a * 8;
      float* wrow = w + (j * K + k) * 32 + a * 8;
#pragma unroll
      for (int b = 0; b < 4; ++b) {      // W[a][b] = sum_c K[a][c] U[c][b]
        float sr = 0.f, si = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xr = krow[2 * c], xi = krow[2 * c + 1];
          const float yr = u[(c * 4 + b) * 2], yi = u[(c * 4 + b) * 2 + 1];
          sr += xr * yr - xi * yi;
          si += xr * yi + xi * yr;
        }
        wrow[2 * b] = sr;
        wrow[2 * b + 1] = si;
      }
      continue;
    }
    const float* mm = mk + k * 32;
    float vr[4], vi[4];                  // V[e] = sum_c conj(U[c][a]) MK[c][e]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float xr = u[(c * 4 + a) * 2], xi = u[(c * 4 + a) * 2 + 1];
        const float yr = mm[(c * 4 + e) * 2], yi = mm[(c * 4 + e) * 2 + 1];
        sr += xr * yr + xi * yi;
        si += xr * yi - xi * yr;
      }
      vr[e] = sr;
      vi[e] = si;
    }
    float* mj = m + j * 16 * K + k;
#pragma unroll
    for (int b = 0; b < 4; ++b) {        // M'[a][b] = sum_e V[e] U[e][b], b >= a
      if (b < a) continue;
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float yr = u[(e * 4 + b) * 2], yi = u[(e * 4 + b) * 2 + 1];
        sr += vr[e] * yr - vi[e] * yi;
        si += vr[e] * yi + vi[e] * yr;
      }
      if (b == a) {
        mj[a * K] = sr;
      } else {
        const int pm = pair_index(a, b);
        mj[(4 + pm) * K] = sr;
        mj[(10 + pm) * K] = si;
      }
    }
  }
}

// Shared memory of a block at depth D with K operators, in floats: the
// Kraus operators and K_k^dag K_k, the circuit's gates and index maps, two
// layers' W and M' planes, and each warp's scratch for the gathers.
template <int D>
constexpr size_t traj_smem_floats(int K) {
  using C = Traj<D>;
  return 64 * static_cast<size_t>(K) + D * C::S * 32 + (D + 1) * C::N +
         2 * static_cast<size_t>(C::S) * K * 48 +
         static_cast<size_t>(C::WARPS) * 2 * C::N;
}

// Trajectory kernel. hmaps (C, d+1, 2^d) int32; gates (C, d, d/2, 4, 4) and
// kraus (K, 4, 4) complex64 (interleaved floats); uniforms (C, d, d/2, T)
// f32; out (C, 2^d, T) f32. Block b: circuit b / tiles, trajectories
// (b % tiles) * WARPS onwards.
template <int D>
__global__ void __launch_bounds__(Traj<D>::THREADS)
    traj_probs_kernel(const int* __restrict__ hmaps,
                      const float* __restrict__ gates,
                      const float* __restrict__ kraus,
                      const float* __restrict__ uniforms,
                      float* __restrict__ out, int K, int T, int tiles) {
  using C = Traj<D>;
  constexpr int N = C::N, R = C::R, LB = C::LB, S = C::S, W = C::WARPS;
  extern __shared__ __align__(16) float smem[];
  const int layer_floats = S * K * 48;
  float* kr = smem;                      // K_k, K x 32
  float* mk = kr + K * 32;               // K_k^dag K_k, K x 32
  float* gs = mk + K * 32;               // the circuit's gates, D x S x 32
  int* hs = reinterpret_cast<int*>(gs + D * S * 32);  // its maps, (D+1) x N
  float* bufs = reinterpret_cast<float*>(hs + (D + 1) * N);  // W, then M'
  float* scratch = bufs + 2 * layer_floats;  // 2N a warp; the output stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  // warps past the last trajectory evolve a copy of it and write nothing:
  // every warp runs the same code, with no branch around its shuffles
  const int t = min(tile * W + warp, T - 1);
  float* sr = scratch + warp * 2 * N;
  float* si = sr + N;
  const int* h = hmaps + static_cast<size_t>(c) * (D + 1) * N;
  const float* g = gates + static_cast<size_t>(c) * D * S * 32;

  for (int i = tid; i < K * 32; i += C::THREADS) kr[i] = __ldg(kraus + i);
  for (int i = tid; i < D * S * 32; i += C::THREADS) gs[i] = __ldg(g + i);
  for (int i = tid; i < (D + 1) * N; i += C::THREADS) hs[i] = __ldg(h + i);
  __syncthreads();
  for (int i = tid; i < K * 16; i += C::THREADS) {
    // K_k^dag K_k [a][b] = sum_c conj(K_k[c][a]) K_k[c][b]
    const int k = i >> 4, a = (i >> 2) & 3, b = i & 3;
    const float* kk = kr + k * 32;
    float s_r = 0.f, s_i = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float xr = kk[(cc * 4 + a) * 2], xi = kk[(cc * 4 + a) * 2 + 1];
      const float yr = kk[(cc * 4 + b) * 2], yi = kk[(cc * 4 + b) * 2 + 1];
      s_r += xr * yr + xi * yi;
      s_i += xr * yi - xi * yr;
    }
    mk[k * 32 + (a * 4 + b) * 2] = s_r;
    mk[k * 32 + (a * 4 + b) * 2 + 1] = s_i;
  }
  __syncthreads();
  form_layer<D>(bufs, bufs + S * K * 32, gs, kr, mk, K, tid);

  // |0...0> after the first gather: amplitude x is 1 where h_0[x] = 0
  float re[R], im[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    re[r] = lane < C::L && hs[(r << LB) | lane] == 0 ? 1.f : 0.f;
    im[r] = 0.f;
  }
  // lane j < S holds slot j's uniform, loaded a layer ahead
  auto uniform = [&](int l) {
    return lane < S
        ? __ldg(uniforms + ((static_cast<size_t>(c) * D + l) * S + lane) * T + t)
        : 0.f;
  };
  float u_next = uniform(0);
  // the lane's part of an amplitude index in the layout a layer ends in
  int lane_end = 0;
#pragma unroll
  for (int kb = 0; kb < LB; ++kb)
    lane_end |= ((lane >> kb) & 1) << end_lane_bit<D>(kb);

  for (int l = 0; l < D; ++l) {
    // layer l's planes are formed, and every warp is done with layer l - 1's
    __syncthreads();
    if (l + 1 < D) {
      float* next = bufs + ((l + 1) & 1) * layer_floats;
      form_layer<D>(next, next + S * K * 32, gs + (l + 1) * S * 32, kr, mk,
                    K, tid);
    }
    const float u = u_next;
    if (l + 1 < D) u_next = uniform(l + 1);
    if (l > 0) permute<D>(re, im, sr, si, hs + l * N, lane_end, lane);
    const float* wl = bufs + (l & 1) * layer_floats;
    traj_slots<D>(std::make_integer_sequence<int, S>(), re, im, wl,
                  wl + S * K * 32, K, u, lane);
    float nrm = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) nrm = fmaf(im[r], im[r], fmaf(re[r], re[r], nrm));
    const float inv = rsqrtf(fmaxf(warp_sum(nrm), 1e-30f));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      re[r] *= inv;
      im[r] *= inv;
    }
  }

  // probabilities in the original basis
  permute<D>(re, im, sr, si, hs + D * N, lane_end, lane);
  float p[R], tot = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = re[r] * re[r] + im[r] * im[r];
    tot += p[r];
  }
  const float inv = 1.f / warp_sum(tot);
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] *= inv;
  __syncthreads();  // every warp is done with its scratch
  float* stage = scratch;  // [x][W + 1]
  if (lane < C::L) {
#pragma unroll
    for (int r = 0; r < R; ++r) stage[((r << LB) | lane) * (W + 1) + warp] = p[r];
  }
  __syncthreads();
  for (int i = tid; i < N * W; i += C::THREADS) {
    const int x = i / W, w = i % W;
    const int tw = tile * W + w;
    if (tw < T) out[(static_cast<size_t>(c) * N + x) * T + tw] = stage[x * (W + 1) + w];
  }
}

template <int D>
cudaError_t launch_traj(const int* hmaps, const float* gates,
                        const float* kraus, const float* uniforms, float* out,
                        int circuits, int K, int T, cudaStream_t stream) {
  using C = Traj<D>;
  const int tiles = (T + C::WARPS - 1) / C::WARPS;
  if (static_cast<long long>(circuits) * tiles >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = traj_smem_floats<D>(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      traj_probs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later check reports it
    return err;
  }
  traj_probs_kernel<D><<<circuits * tiles, C::THREADS, smem, stream>>>(
      hmaps, gates, kraus, uniforms, out, K, T, tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Ideal kernel: the state in registers, the boundary maps from the
// permutations.
// ---------------------------------------------------------------------------

constexpr int IDEAL_WARPS = 4;  // warps a block; a warp waits on no other
// circuits a warp holds, by depth: a lane group of 2^(D-2) lanes a circuit
// (four amplitudes a lane) up to depth 7, one warp a circuit from there on
constexpr int IDEAL_CIRCUITS_PER_WARP[QV_MAX_DEPTH + 1] = {0, 0, 32, 16, 8,
                                                           4, 2, 1, 1, 1, 1};

// The layout of the ideal kernel at depth D: Traj<D>'s registers and lane
// bits, on a lane group of G = Traj<D>::L lanes a circuit, and a warp's
// slice of shared memory (bytes): its circuits' gates (a circuit's GATES
// floats at a stride of GSTRIDE, which puts circuit g's entry e in bank
// 4g + e), the scratch of the gathers (32 R floats each for the real and
// imaginary parts), the boundary words (TS a circuit, an odd count, so that
// the circuits' words of one layer fall in different banks), and the
// permutations and their inverses (a byte an entry).
template <int D>
struct Ideal {
  static constexpr int R = Traj<D>::R, G = Traj<D>::L, S = Traj<D>::S;
  static constexpr int CPW = IDEAL_CIRCUITS_PER_WARP[D];
  static_assert(CPW * G == 32, "lane groups fill the warp");
  static constexpr int GATES = D * S * 32;
  static constexpr int GSTRIDE = GATES + 4;
  static constexpr int TS = (D + 1) | 1;
  static constexpr int GATE_BYTES = CPW * GSTRIDE * 4;
  static constexpr int SCRATCH_BYTES = 2 * 32 * R * 4;
  static constexpr int WORD_BYTES = CPW * TS * 8;
  static constexpr int PERM_BYTES = 2 * CPW * D * D;
  static constexpr int WARP_BYTES =
      (GATE_BYTES + SCRATCH_BYTES + WORD_BYTES + PERM_BYTES + 15) / 16 * 16;
};

// psi[x] <- psi[h[x]] for a boundary map h that is a bit permutation: bit k
// of x comes from bit (word >> 4k) & 15 of h[x]. The lane group writes its
// state at the indices of the layout a layer ends in and reads it back in the
// start layout, register r of sub-lane `sub` at h((r << LB) | sub) =
// h(r << LB) | h(sub): a lane part, and a part for each register bit.
// Circuit g's amplitude y sits at swz(y) * CPW + g of the warp's scratch.
template <int D>
__device__ __forceinline__ void ideal_permute(float (&re)[Traj<D>::R],
                                              float (&im)[Traj<D>::R],
                                              float* sr, float* si,
                                              unsigned long long word,
                                              int lane_end, int sub, int g) {
  constexpr int R = Traj<D>::R, RB = Traj<D>::RB, LB = Traj<D>::LB;
  constexpr int CPW = Ideal<D>::CPW;
  int lane_from = 0;
#pragma unroll
  for (int k = 0; k < LB; ++k)
    lane_from |= ((sub >> k) & 1) << static_cast<int>((word >> (4 * k)) & 15);
  int reg_bit[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i)
    reg_bit[i] = 1 << static_cast<int>((word >> (4 * (LB + i))) & 15);
  int from[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    from[r] = lane_from;
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if ((r >> i) & 1) from[r] |= reg_bit[i];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = swz(lane_end | end_reg_index<D>(r)) * CPW + g;
    sr[x] = re[r];
    si[x] = im[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = swz(from[r]) * CPW + g;
    re[r] = sr[y];
    im[r] = si[y];
  }
  __syncwarp();
}

// Slot J of a layer: U (row-major, interleaved, in shared memory at u + J
// * 32) on the slot's groups, after the register/lane bit swap of the slot
// plan. The apply is the trajectory kernel's, written out again: with one
// helper for both, nvcc scheduled the trajectory kernel's instructions
// differently from depth 4 on, and its source is kept as it was.
template <int D, int J>
__device__ __forceinline__ void ideal_slot(float (&re)[Traj<D>::R],
                                           float (&im)[Traj<D>::R],
                                           const float* u, int lane) {
  constexpr int R = Traj<D>::R;
  constexpr SlotPlan P = slot_plan<D>(J);
  if constexpr (P.swap_reg >= 0)
    swap_bits<R, P.swap_reg, P.swap_lane>(re, im, lane);
  const float4* u4 = reinterpret_cast<const float4*>(u + J * 32);
  float wr[16], wi[16];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = u4[q];
    wr[2 * q] = v.x;
    wi[2 * q] = v.y;
    wr[2 * q + 1] = v.z;
    wi[2 * q + 1] = v.w;
  }
#pragma unroll
  for (int base = 0; base < R; ++base) {
    if (base & ((1 << P.hi) | (1 << P.lo))) continue;
    int idx[4];
    float xr[4], xi[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      idx[a] = base | ((a >> 1) << P.hi) | ((a & 1) << P.lo);
      xr[a] = re[idx[a]];
      xi[a] = im[idx[a]];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float ar = wr[a * 4] * xr[0], ai = wr[a * 4] * xi[0];
      ar = fmaf(-wi[a * 4], xi[0], ar);
      ai = fmaf(wi[a * 4], xr[0], ai);
#pragma unroll
      for (int b = 1; b < 4; ++b) {
        ar = fmaf(-wi[a * 4 + b], xi[b], fmaf(wr[a * 4 + b], xr[b], ar));
        ai = fmaf(wi[a * 4 + b], xr[b], fmaf(wr[a * 4 + b], xi[b], ai));
      }
      re[idx[a]] = ar;
      im[idx[a]] = ai;
    }
  }
}

template <int D, int... J>
__device__ __forceinline__ void ideal_slots(std::integer_sequence<int, J...>,
                                            float (&re)[Traj<D>::R],
                                            float (&im)[Traj<D>::R],
                                            const float* u, int lane) {
  (ideal_slot<D, J>(re, im, u, lane), ...);
}

// Ideal kernel. perms (C, d, d) int64; gates (C, d, d/2, 4, 4) complex64
// (interleaved floats); out (C, 2^d) f32. Warp w of block b holds circuits
// (b * IDEAL_WARPS + w) * CPW onwards, one a lane group.
template <int D>
__global__ void __launch_bounds__(32 * IDEAL_WARPS)
    ideal_probs_kernel(const long long* __restrict__ perms,
                       const float* __restrict__ gates,
                       float* __restrict__ out, int circuits) {
  using I = Ideal<D>;
  constexpr int N = Traj<D>::N, R = I::R, LB = Traj<D>::LB, S = I::S;
  constexpr int G = I::G, CPW = I::CPW, TS = I::TS;
  extern __shared__ __align__(16) unsigned char ideal_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * IDEAL_WARPS + warp) * CPW;
  if (c0 >= circuits) return;  // whole warps; no barrier follows
  const int g = lane / G, sub = lane % G;
  // lane groups past the last circuit evolve a copy of it and write nothing:
  // every lane runs the same code, with no branch around its shuffles
  const int c = c0 + g, last = circuits - 1;
  unsigned char* slice = ideal_smem + warp * I::WARP_BYTES;
  float* sg = reinterpret_cast<float*>(slice);
  float* sr = reinterpret_cast<float*>(slice + I::GATE_BYTES);
  float* si = sr + 32 * R;
  auto* words = reinterpret_cast<unsigned long long*>(
      slice + I::GATE_BYTES + I::SCRATCH_BYTES);
  unsigned char* sp = reinterpret_cast<unsigned char*>(words + CPW * TS);
  unsigned char* sv = sp + CPW * D * D;  // sv[row][perm[row][i]] = i

  // the warp's circuits' gates and permutations, in coalesced runs
  constexpr int Q = I::GATES / 4;
  for (int e = lane; e < CPW * Q; e += 32) {
    const int gg = e / Q, q = e - gg * Q;
    const float4* src = reinterpret_cast<const float4*>(
        gates + static_cast<size_t>(min(c0 + gg, last)) * I::GATES);
    reinterpret_cast<float4*>(sg + gg * I::GSTRIDE)[q] = __ldg(src + q);
  }
  for (int e = lane; e < CPW * D * D; e += 32) {
    const int gg = e / (D * D);
    const long long p = __ldg(perms + static_cast<size_t>(min(c0 + gg, last))
                                          * D * D + (e - gg * D * D));
    const int v = static_cast<int>(min(max(p, 0LL), D - 1LL));
    sp[e] = static_cast<unsigned char>(v);
    sv[e - e % D + v] = static_cast<unsigned char>(e % D);
  }
  __syncwarp();
  // boundary l (1..D) of circuit gg: bit k = D-1-i of an index of layer l's
  // basis, qubit i's, comes from bit D-1-inv_{l-1}[perm_l[i]] of layer
  // l-1's (perm_D: the identity); four bits a position. Boundary 0 maps
  // |0...0> to itself, so the kernel needs none.
  for (int t = lane; t < CPW * D; t += 32) {
    const int gg = t / D, l = 1 + t % D;
    const unsigned char* pl = sp + (gg * D + l) * D;
    const unsigned char* vp = sv + (gg * D + l - 1) * D;
    unsigned long long word = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int a = l < D ? pl[i] : i;
      const int from = D - 1 - min(static_cast<int>(vp[a]), D - 1);
      word |= static_cast<unsigned long long>(from) << (4 * (D - 1 - i));
    }
    words[gg * TS + l] = word;
  }
  __syncwarp();

  // |0...0> in the start layout: the first gather fixes it
  float re[R], im[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    re[r] = r == 0 && sub == 0 ? 1.f : 0.f;
    im[r] = 0.f;
  }
  // the sub-lane's part of an amplitude index in the layout a layer ends in
  int lane_end = 0;
#pragma unroll
  for (int kb = 0; kb < LB; ++kb)
    lane_end |= ((sub >> kb) & 1) << end_lane_bit<D>(kb);
  const float* u = sg + g * I::GSTRIDE;
  const unsigned long long* h = words + g * TS;
  for (int l = 0; l < D; ++l) {
    if (l > 0) ideal_permute<D>(re, im, sr, si, h[l], lane_end, sub, g);
    ideal_slots<D>(std::make_integer_sequence<int, S>(), re, im,
                   u + l * S * 32, lane);
  }
  ideal_permute<D>(re, im, sr, si, h[D], lane_end, sub, g);

  // probabilities in the original basis, normalized over the lane group;
  // register r of sub-lane `sub` holds (r << LB) | sub: from depth 7 on
  // each register row is a run of 32 floats
  float p[R], tot = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = re[r] * re[r] + im[r] * im[r];
    tot += p[r];
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    tot += __shfl_xor_sync(FULL, tot, off);
  const float inv = 1.f / tot;
  if (c < circuits) {
    float* o = out + static_cast<size_t>(c) * N + sub;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r << LB] = p[r] * inv;
  }
}

template <int D>
cudaError_t launch_ideal(const long long* perms, const float* gates,
                         float* out, int circuits, cudaStream_t stream) {
  constexpr int per_block = IDEAL_WARPS * Ideal<D>::CPW;
  constexpr size_t smem =
      static_cast<size_t>(IDEAL_WARPS) * Ideal<D>::WARP_BYTES;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ideal_probs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that no later check reports it
      return err;
    }
  }
  ideal_probs_kernel<D><<<(circuits + per_block - 1) / per_block,
                          32 * IDEAL_WARPS, smem, stream>>>(perms, gates, out,
                                                            circuits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int traj_probs_launch(const int* hmaps, const void* gates,
                                 const void* kraus, const float* uniforms,
                                 float* out, int circuits, int depth,
                                 int n_kraus, int trajectories, void* stream) {
  if (circuits <= 0 || trajectories <= 0) return static_cast<int>(cudaSuccess);
  if (n_kraus < 1 || n_kraus > QV_MAX_KRAUS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gates);
  const float* k = static_cast<const float*>(kraus);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
#define QV_TRAJ_CASE(D)                                                      \
  case D:                                                                    \
    err = launch_traj<D>(hmaps, g, k, uniforms, out, circuits, n_kraus,      \
                         trajectories, st);                                  \
    break;
    QV_TRAJ_CASE(2) QV_TRAJ_CASE(3) QV_TRAJ_CASE(4) QV_TRAJ_CASE(5)
    QV_TRAJ_CASE(6) QV_TRAJ_CASE(7) QV_TRAJ_CASE(8) QV_TRAJ_CASE(9)
    QV_TRAJ_CASE(10)
#undef QV_TRAJ_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  static_assert(QV_MIN_DEPTH == 2 && QV_MAX_DEPTH == 10,
                "the switch above covers depths 2 to 10");
  return static_cast<int>(err);
}

extern "C" int ideal_probs_launch(const long long* perms, const void* gates,
                                  float* out, int circuits, int depth,
                                  void* stream) {
  if (circuits <= 0) return static_cast<int>(cudaSuccess);
  const float* g = static_cast<const float*>(gates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
#define QV_IDEAL_CASE(D)                                                     \
  case D:                                                                    \
    err = launch_ideal<D>(perms, g, out, circuits, st);                      \
    break;
    QV_IDEAL_CASE(2) QV_IDEAL_CASE(3) QV_IDEAL_CASE(4) QV_IDEAL_CASE(5)
    QV_IDEAL_CASE(6) QV_IDEAL_CASE(7) QV_IDEAL_CASE(8) QV_IDEAL_CASE(9)
    QV_IDEAL_CASE(10)
#undef QV_IDEAL_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
