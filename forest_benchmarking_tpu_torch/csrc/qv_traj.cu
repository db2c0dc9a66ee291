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
// Layout. One warp evolves one state: a trajectory, or an ideal circuit.
// The state, 2^d complex f32 (2 KB at d = 8), lives in the warp's slice of
// shared memory twice over, so that a permutation is a gather from one copy
// into the other. A slot splits the 2^d amplitudes into 2^d / 4 groups of
// four (the four values of the slot's two bits); lane g applies the 4x4 to
// groups g, g + 32, ... in place. The pair-reduced density is summed over
// the same groups and reduced across the warp by shuffles (16 reals: 4 on
// the diagonal, 6 complex above it). Lane k < K forms p_k; a warp scan gives
// the cumulative sums and a ballot counts those below u. Not carried from
// the TPU kernel: the one-hot permutation matmuls, the bf16 three-term split
// and the 128 redundant lanes per ideal circuit.
//
// Trajectory kernel: one block per (circuit, tile of 8 trajectories), one
// warp per trajectory. For each layer the block stages that layer's W and
// M' planes (4 x d/2 x K x 16 f32: 16 KB at d = 8, K = 16) in shared memory
// for all its warps. At the end it writes the tile's 8 columns of the
// (C, 2^d, T) output as 32-byte runs. Ideal kernel: 8 circuits per block,
// one per warp; the gates come through the read-only cache.
//
// What bounds it on an H100, at C = 1600 circuits, T = 1000 trajectories,
// d = 8, K = 16: the arithmetic. Per trajectory ~426 kFLOP (see
// `traj_flops_per_circuit`: per slot 16 * 2^d for the pair density, 32 K for
// the branch weights on their hermitian halves, 32 * 2^d for the W apply;
// per layer 7 * 2^d for the renormalization; the permutations are gathers
// and do no arithmetic), so 0.68 TFLOP in all, 10.2 ms at 67 TFLOP/s f32
// outside the tensor cores. The function's bytes are ~1.85 GB (output
// 1.64 GB, uniforms 0.2 GB, gates 6.6 MB, permutations 0.8 MB): 0.55 ms at
// 3.35 TB/s. Every intermediate stays on chip; the W and M' planes (0.2 GB)
// and the index maps (15 MB) the wrapper lays out are read once more.
// Between the kernel and its arithmetic bound stand the shared-memory
// traffic (each slot reads the state twice and writes it once) and the 80
// shuffles of each slot's density reduction; holding the state in registers
// is later work. The ideal function does 0.42 GFLOP and needs ~9 MB
// (permutations, gates, output) at C = 1600: bound by operations at
// 0.0063 ms, and in practice by launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;             // states per block, one per warp
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Index of amplitude 0 of group g of a slot whose low bit is s; amplitude a
// of the group sits at group_base + (a << s).
__device__ __forceinline__ int group_base(int g, int s) {
  return ((g >> s) << (s + 2)) | (g & ((1 << s) - 1));
}

// Position of the pair (a, b), a < b, in the order (0,1) (0,2) (0,3) (1,2)
// (1,3) (2,3).
__host__ __device__ constexpr int pair_index(int a, int b) {
  return a * (7 - a) / 2 + (b - a - 1);
}

// dst[x] = src[h[x]] for x < n. Ends with __syncwarp.
__device__ __forceinline__ void gather(const float* src_r, const float* src_i,
                                       float* dst_r, float* dst_i,
                                       const int* __restrict__ h, int n,
                                       int lane) {
  for (int x = lane; x < n; x += 32) {
    const int from = __ldg(h + x);
    dst_r[x] = src_r[from];
    dst_i[x] = src_i[from];
  }
  __syncwarp();
}

// psi <- M psi on the slot with low bit s; M row-major (16 real, 16 imag).
// Ends with __syncwarp.
__device__ __forceinline__ void apply4(float* pr, float* pi,
                                       const float (&mr)[16],
                                       const float (&mi)[16], int n, int s,
                                       int lane) {
  for (int g = lane; g < (n >> 2); g += 32) {
    const int base = group_base(g, s);
    float xr[4], xi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      xr[b] = pr[base + (b << s)];
      xi[b] = pi[base + (b << s)];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ar += mr[a * 4 + b] * xr[b] - mi[a * 4 + b] * xi[b];
        ai += mr[a * 4 + b] * xi[b] + mi[a * 4 + b] * xr[b];
      }
      pr[base + (a << s)] = ar;
      pi[base + (a << s)] = ai;
    }
  }
  __syncwarp();
}

// The pair-reduced density rho[a][b] = sum psi_a conj(psi_b) over the
// groups of the slot with low bit s, summed over the warp (every lane gets
// it): acc[a] = rho[a][a]; acc[4 + 2m], acc[5 + 2m] = Re, Im rho[a][b] for
// the pair m = pair_index(a, b), a < b.
__device__ __forceinline__ void pair_density(const float* pr, const float* pi,
                                             int n, int s, int lane,
                                             float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int g = lane; g < (n >> 2); g += 32) {
    const int base = group_base(g, s);
    float xr[4], xi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      xr[b] = pr[base + (b << s)];
      xi[b] = pi[base + (b << s)];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a] += xr[a] * xr[a] + xi[a] * xi[a];
#pragma unroll
      for (int b = a + 1; b < 4; ++b) {
        const int m = pair_index(a, b);
        acc[4 + 2 * m] += xr[a] * xr[b] + xi[a] * xi[b];
        acc[5 + 2 * m] += xi[a] * xr[b] - xr[a] * xi[b];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = warp_sum(acc[i]);
}

// The sampled branch: lane k < K forms p_k = max(Re tr(M'_k rho), 0) from
// the planes mt_r/mt_i laid out [a * 4 + b][k]. Both matrices are hermitian,
// so the diagonal terms and twice the six above it make the trace:
// Re tr(M rho) = sum_a M[a,a] rho[a,a] + 2 sum_{a<b} Re(M[a,b] conj(rho[a,b])).
// The weights are normalized and k* is the number of cumulative sums
// strictly below u, clamped to K - 1. Every lane returns k*.
__device__ __forceinline__ int select_branch(const float (&acc)[16],
                                             const float* mt_r,
                                             const float* mt_i, int K,
                                             float u, int lane) {
  float p = 0.f;
  if (lane < K) {
    float upper = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      p += mt_r[a * 5 * K + lane] * acc[a];
#pragma unroll
      for (int b = a + 1; b < 4; ++b) {
        const int m = pair_index(a, b);
        upper += mt_r[(a * 4 + b) * K + lane] * acc[4 + 2 * m] +
                 mt_i[(a * 4 + b) * K + lane] * acc[5 + 2 * m];
      }
    }
    p = fmaxf(p + 2.f * upper, 0.f);
  }
  p = p / warp_sum(p);
  float cum = p;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, cum, off);
    if (lane >= off) cum += y;
  }
  const unsigned below = __ballot_sync(FULL, lane < K && cum < u);
  return min(__popc(below), K - 1);
}

// Trajectory kernel. hmaps (C, d+1, 2^d) int32; planes (C, d, 4, d/2*K*16)
// f32 holding, per layer, W real [slot][k][ab], W imag, M' real
// [slot][ab][k], M' imag; uniforms (C, d, d/2, T) f32; out (C, 2^d, T) f32.
__global__ void __launch_bounds__(THREADS)
    traj_probs_kernel(const int* __restrict__ hmaps,
                      const float* __restrict__ planes,
                      const float* __restrict__ uniforms,
                      float* __restrict__ out, int depth, int K, int T,
                      int tiles) {
  extern __shared__ float smem[];
  const int n = 1 << depth, slots = depth >> 1;
  const int plane = slots * K * 16;     // floats in one plane of one layer
  const int stride = 4 * n + 4;         // floats per warp (padded)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int t = tile * WARPS + warp;
  const bool active = t < T;
  float* layer = smem;                  // this layer's 4 planes
  float* state = smem + 4 * plane;
  float* cur_r = state + warp * stride;
  float* cur_i = cur_r + n;
  float* oth_r = cur_r + 2 * n;
  float* oth_i = cur_r + 3 * n;
  const int* h = hmaps + static_cast<size_t>(c) * (depth + 1) * n;

  for (int x = lane; x < n; x += 32) {
    cur_r[x] = x == 0 ? 1.f : 0.f;
    cur_i[x] = 0.f;
  }
  __syncwarp();
  for (int l = 0; l < depth; ++l) {
    __syncthreads();  // every warp is done with the previous layer's planes
    const float* src = planes + (static_cast<size_t>(c) * depth + l) * 4 * plane;
    for (int i = threadIdx.x; i < 4 * plane; i += THREADS) layer[i] = __ldg(src + i);
    __syncthreads();
    if (!active) continue;
    gather(cur_r, cur_i, oth_r, oth_i, h + static_cast<size_t>(l) * n, n, lane);
    float* tr = cur_r; cur_r = oth_r; oth_r = tr;
    float* ti = cur_i; cur_i = oth_i; oth_i = ti;
    for (int j = 0; j < slots; ++j) {
      const int s = depth - 2 - j;
      float acc[16];
      pair_density(cur_r, cur_i, n, s, lane, acc);
      const float u = __ldg(
          uniforms + ((static_cast<size_t>(c) * depth + l) * slots + j) * T + t);
      const int k = select_branch(acc, layer + 2 * plane + j * 16 * K,
                                  layer + 3 * plane + j * 16 * K, K, u, lane);
      float wr[16], wi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        wr[i] = layer[(j * K + k) * 16 + i];
        wi[i] = layer[plane + (j * K + k) * 16 + i];
      }
      apply4(cur_r, cur_i, wr, wi, n, s, lane);
    }
    float nrm = 0.f;
    for (int x = lane; x < n; x += 32) nrm += cur_r[x] * cur_r[x] + cur_i[x] * cur_i[x];
    const float inv = rsqrtf(fmaxf(warp_sum(nrm), 1e-30f));
    for (int x = lane; x < n; x += 32) {
      cur_r[x] *= inv;
      cur_i[x] *= inv;
    }
    __syncwarp();
  }
  // probabilities in the original basis, staged in the other copy's real
  // plane: after d gathers that copy is copy (d + 1) % 2 of every warp
  if (active) {
    const int* hd = h + static_cast<size_t>(depth) * n;
    float tot = 0.f;
    for (int x = lane; x < n; x += 32) {
      const int from = __ldg(hd + x);
      const float p = cur_r[from] * cur_r[from] + cur_i[from] * cur_i[from];
      oth_r[x] = p;
      tot += p;
    }
    const float inv = 1.f / warp_sum(tot);
    for (int x = lane; x < n; x += 32) oth_r[x] *= inv;
  }
  __syncthreads();
  const int staged = ((depth + 1) & 1) * 2 * n;
  for (int i = threadIdx.x; i < n * WARPS; i += THREADS) {
    const int x = i / WARPS, w = i % WARPS;
    const int tw = tile * WARPS + w;
    if (tw < T)
      out[(static_cast<size_t>(c) * n + x) * T + tw] = state[w * stride + staged + x];
  }
}

// Ideal kernel. hmaps (C, d+1, 2^d) int32; gates (C, d, d/2, 2, 16) f32
// (real then imaginary part of each row-major 4x4); out (C, 2^d) f32.
__global__ void __launch_bounds__(THREADS)
    ideal_probs_kernel(const int* __restrict__ hmaps,
                       const float* __restrict__ gates,
                       float* __restrict__ out, int depth, int circuits) {
  extern __shared__ float smem[];
  const int n = 1 << depth, slots = depth >> 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= circuits) return;  // whole warps only; no block barrier follows
  float* cur_r = smem + warp * (4 * n + 4);
  float* cur_i = cur_r + n;
  float* oth_r = cur_r + 2 * n;
  float* oth_i = cur_r + 3 * n;
  const int* h = hmaps + static_cast<size_t>(c) * (depth + 1) * n;

  for (int x = lane; x < n; x += 32) {
    cur_r[x] = x == 0 ? 1.f : 0.f;
    cur_i[x] = 0.f;
  }
  __syncwarp();
  for (int l = 0; l < depth; ++l) {
    gather(cur_r, cur_i, oth_r, oth_i, h + static_cast<size_t>(l) * n, n, lane);
    float* tr = cur_r; cur_r = oth_r; oth_r = tr;
    float* ti = cur_i; cur_i = oth_i; oth_i = ti;
    for (int j = 0; j < slots; ++j) {
      const float* g = gates + ((static_cast<size_t>(c) * depth + l) * slots + j) * 32;
      float gr[16], gi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        gr[i] = __ldg(g + i);
        gi[i] = __ldg(g + 16 + i);
      }
      apply4(cur_r, cur_i, gr, gi, n, depth - 2 - j, lane);
    }
  }
  const int* hd = h + static_cast<size_t>(depth) * n;
  float tot = 0.f;
  for (int x = lane; x < n; x += 32) {
    const int from = __ldg(hd + x);
    tot += cur_r[from] * cur_r[from] + cur_i[from] * cur_i[from];
  }
  const float inv = 1.f / warp_sum(tot);
  for (int x = lane; x < n; x += 32) {
    const int from = __ldg(hd + x);
    out[static_cast<size_t>(c) * n + x] =
        (cur_r[from] * cur_r[from] + cur_i[from] * cur_i[from]) * inv;
  }
}

size_t state_bytes(int depth) {
  return static_cast<size_t>(WARPS) * (4 * (1 << depth) + 4) * sizeof(float);
}

}  // namespace

extern "C" int traj_probs_launch(const int* hmaps, const float* planes,
                                 const float* uniforms, float* out,
                                 int circuits, int depth, int n_kraus,
                                 int trajectories, void* stream) {
  if (circuits <= 0 || trajectories <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = state_bytes(depth) +
                      4 * static_cast<size_t>(depth / 2) * n_kraus * 16 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      traj_probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (trajectories + WARPS - 1) / WARPS;
  traj_probs_kernel<<<circuits * tiles, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      hmaps, planes, uniforms, out, depth, n_kraus, trajectories, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ideal_probs_launch(const int* hmaps, const float* gates,
                                  float* out, int circuits, int depth,
                                  void* stream) {
  if (circuits <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = state_bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      ideal_probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ideal_probs_kernel<<<(circuits + WARPS - 1) / WARPS, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      hmaps, gates, out, depth, circuits);
  return static_cast<int>(cudaGetLastError());
}
