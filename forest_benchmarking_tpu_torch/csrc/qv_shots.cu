// qv_shots.cu -- the quantum-volume trajectory route's shots, hand-written
// for NVIDIA Hopper (sm_90a): one shot from each trajectory, its heavy flag
// and the heavy tally of each circuit, in one pass over the probabilities.
//
// Replaces no TPU kernel: the JAX package draws these shots with
// `jax.random.categorical` (forest_benchmarking_tpu/quantum_volume.py,
// `sample_heavy_outputs_batched`), which XLA compiles; the port drew them
// with `torch.multinomial` on a transposed copy of the trajectory kernel's
// output. The plain PyTorch version is `heavy_tallies_reference` in
// forest_benchmarking_tpu_torch/ops/pallas_traj.py.
//
// What it computes. `torch.multinomial(rows, 1, replacement=True,
// generator=g)` on (R, n) rows checks them, draws q = Exp(1) of the rows'
// shape and dtype from g, and returns argmax(rows / q, -1). The wrapper
// makes the same draw (`q.exponential_(generator=g)` on a (C * T, n) tensor
// of the rows' dtype), so the generator advances as it did, and this kernel
// does the rest on the trajectory kernel's (C, n, T) float32 output as it
// lies, row (c, t) being column t of circuit c:
//
//   o*(c, t) = the first o of the largest p[c, o, t] / q[c * T + t, o]
//              (IEEE division rounded to nearest, as at::div: __fdiv_rn,
//              or __ddiv_rn on p widened to double where q is float64;
//              a NaN quotient counts as the largest, as in ATen's argmax)
//   out[c]  += heavy[c, o*(c, t)]                     (int64 tallies)
//   out[C]  += rows with an element that is NaN, infinite or < 0
//   out[C+1] += rows that are all zero, among the others
//   out[C+3]  = 1 where both counts are 0, else 0 (set by the last block)
//
// The two counts are torch.multinomial's two checks. The wrapper hands the
// flag out[C+3] to `torch._assert_async`, as torch.multinomial hands its
// checks on the card, so no host waits for the kernel. The tallies are sums
// of integers, so the order of the atomics does not change them, and the
// samples are torch.multinomial's, so the tallies are bitwise what the copy,
// `torch.multinomial`, `gather` and `sum` gave.
//
// What bounds it on an H100, at C = 1600 circuits, T = 1000 trajectories,
// d = 8 (n = 256): the bytes. It reads the probabilities (1.64 GB of float32)
// and q (1.64 GB) once, the heavy sets (0.4 MB) and writes 12.8 KB: 3.28 GB,
// 0.98 ms at 3.35 TB/s. Its ~20 instructions an element (the division with
// its range check, the compare and select, the two checks) are ~0.3 ms of
// issue. The draw of q (1.64 GB written) is ATen's own kernel.
//
// Design. A block holds ROWS = 128 trajectories of one circuit, one a
// thread, and walks the outputs in steps of W = min(32, n). In a step the
// block copies its rows' W values of q (16-byte loads, W * sizeof(q) bytes
// of each row contiguous: 128-byte runs of float32) into shared memory,
// padded by one value a row so that the transposed reads below hit every
// bank once, while each thread loads its W probabilities p[c, o, t] (a
// warp's 32 threads read 32 neighbouring t: 128 bytes). Then each thread
// divides, compares and keeps the running (largest quotient, first index)
// of its row, in output order, so ties go to the lowest index with no
// reduction. At the end each warp sums its heavy flags by shuffles and adds
// them with one 64-bit atomic, and counts the checks' rows by ballots.
// Then each block takes a ticket, out[C+2], and the block that takes the
// last one sets the flag from the counts (the pattern of CUDA's
// threadFenceReduction sample: every block's adds are fenced before its
// ticket). Threads past the last trajectory of a circuit load nothing and
// count nothing, but take part in every barrier and shuffle.

#include <cuda_runtime.h>

#include <cstdint>

#define QV_SHOTS_MIN_DEPTH 2   // MIN_DEPTH in ops/pallas_traj.py
#define QV_SHOTS_MAX_DEPTH 10  // MAX_DEPTH in ops/pallas_traj.py

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 128;   // trajectories a block, one a thread
constexpr int STEP = 32;    // outputs a step at depth >= 5 (n at lower depths)
constexpr float FLOAT_MAX = 3.40282347e+38f;

__device__ __forceinline__ float quotient(float p, float q) {
  return __fdiv_rn(p, q);
}
__device__ __forceinline__ double quotient(float p, double q) {
  return __ddiv_rn(static_cast<double>(p), q);
}

// 16 bytes of q at `p` (16-byte aligned) into v.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = x.x; v[1] = x.y;
}

// Block b: circuit b / tiles, trajectories (b % tiles) * ROWS onwards.
// Dynamic shared memory: ROWS rows of W + 1 values of q, then the heavy row.
template <class Q, int W>
__global__ void __launch_bounds__(ROWS)
heavy_tally_kernel(const float* __restrict__ traj, const Q* __restrict__ q,
                   const unsigned char* __restrict__ heavy,
                   unsigned long long* __restrict__ out, int circuits, int n,
                   int trajectories, int tiles) {
  constexpr int VEC = 16 / sizeof(Q);   // values of q a 16-byte load
  constexpr int PER_ROW = W / VEC;      // loads a row a step; a thread's too
  extern __shared__ __align__(16) unsigned char shots_smem[];
  Q(*sq)[W + 1] = reinterpret_cast<Q(*)[W + 1]>(shots_smem);
  unsigned char* sh = shots_smem + sizeof(Q) * ROWS * (W + 1);

  const int tid = threadIdx.x;
  const int c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * ROWS;
  const int rows = min(ROWS, trajectories - t0);
  const bool live = tid < rows;
  for (int o = tid; o < n; o += ROWS) sh[o] = heavy[static_cast<size_t>(c) * n + o];

  // this thread's p[c, o, t0 + tid] is p[o * trajectories]
  const float* p = traj + static_cast<size_t>(c) * n * trajectories + t0 + tid;
  // the block's first row of q
  const Q* qb = q + (static_cast<size_t>(c) * trajectories + t0) * n;
  Q best = -static_cast<Q>(INFINITY);
  int arg = 0;
  bool bad = false, nonzero = false;
  for (int o0 = 0; o0 < n; o0 += W) {
    Q v[PER_ROW][VEC];
#pragma unroll
    for (int k = 0; k < PER_ROW; ++k) {
      const int j = tid + k * ROWS, r = j / PER_ROW;
      if (r < rows) {
        load16(qb + static_cast<size_t>(r) * n + o0 + (j % PER_ROW) * VEC, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[k][e] = 0;
      }
    }
    float pv[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      pv[i] = live ? __ldg(p + static_cast<size_t>(o0 + i) * trajectories) : 0.f;
    __syncthreads();  // every thread is done with the last step's values
#pragma unroll
    for (int k = 0; k < PER_ROW; ++k) {
      const int j = tid + k * ROWS, r = j / PER_ROW, col = (j % PER_ROW) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sq[r][col + e] = v[k][e];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float x = pv[i];
      bad |= !(x >= 0.f && x <= FLOAT_MAX);
      nonzero |= x != 0.f;
      const Q y = quotient(x, sq[tid][i]);
      // ATen's argmax order: a NaN above every number, then the lower index
      if (best == best && (y != y || y > best)) {
        best = y;
        arg = o0 + i;
      }
    }
  }

  int h = live ? sh[arg] : 0;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) h += __shfl_xor_sync(FULL, h, m);
  const unsigned n_bad = __ballot_sync(FULL, live && bad);
  const unsigned n_zero = __ballot_sync(FULL, live && !bad && !nonzero);
  if ((tid & 31) == 0) {
    if (h) atomicAdd(out + c, static_cast<unsigned long long>(h));
    if (n_bad) atomicAdd(out + circuits, static_cast<unsigned long long>(__popc(n_bad)));
    if (n_zero) atomicAdd(out + circuits + 1, static_cast<unsigned long long>(__popc(n_zero)));
    __threadfence();  // this warp's adds are seen before the block's ticket
  }
  __syncthreads();
  if (tid == 0 && atomicAdd(out + circuits + 2, 1ull) ==
                      static_cast<unsigned long long>(circuits) * tiles - 1) {
    __threadfence();
    const volatile unsigned long long* checks = out + circuits;
    out[circuits + 3] = checks[0] == 0 && checks[1] == 0;
  }
}

template <class Q, int W>
cudaError_t launch_shots(const float* traj, const void* q,
                         const unsigned char* heavy, unsigned long long* out,
                         int circuits, int n, int trajectories,
                         cudaStream_t stream) {
  const int tiles = (trajectories + ROWS - 1) / ROWS;
  const size_t smem = sizeof(Q) * ROWS * (W + 1) + (1 << QV_SHOTS_MAX_DEPTH);
  static_assert(sizeof(double) * ROWS * (STEP + 1) + (1 << QV_SHOTS_MAX_DEPTH)
                    <= 48 * 1024, "fits the default dynamic shared memory");
  heavy_tally_kernel<Q, W><<<circuits * tiles, ROWS, smem, stream>>>(
      traj, static_cast<const Q*>(q), heavy, out, circuits, n, trajectories,
      tiles);
  return cudaGetLastError();
}

template <class Q>
cudaError_t launch_width(const float* traj, const void* q,
                         const unsigned char* heavy, unsigned long long* out,
                         int circuits, int depth, int trajectories,
                         cudaStream_t st) {
  const int n = 1 << depth;
  switch (depth) {
    case 2: return launch_shots<Q, 4>(traj, q, heavy, out, circuits, n, trajectories, st);
    case 3: return launch_shots<Q, 8>(traj, q, heavy, out, circuits, n, trajectories, st);
    case 4: return launch_shots<Q, 16>(traj, q, heavy, out, circuits, n, trajectories, st);
    default: return launch_shots<Q, STEP>(traj, q, heavy, out, circuits, n, trajectories, st);
  }
}

}  // namespace

// out: circuits + 4 zeroed int64 (the tallies, the two checks' counts, the
// blocks' tickets, the flag).
// q_bytes: 4 (float32 q) or 8 (float64 q).
extern "C" int heavy_tallies_launch(const float* traj, const void* q,
                                    const unsigned char* heavy, void* out,
                                    int circuits, int depth, int trajectories,
                                    int q_bytes, void* stream) {
  if (circuits <= 0 || trajectories <= 0) return static_cast<int>(cudaSuccess);
  if (depth < QV_SHOTS_MIN_DEPTH || depth > QV_SHOTS_MAX_DEPTH ||
      (q_bytes != 4 && q_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      q_bytes == 4
          ? launch_width<float>(traj, q, heavy, o, circuits, depth, trajectories, st)
          : launch_width<double>(traj, q, heavy, o, circuits, depth, trajectories, st);
  return static_cast<int>(err);
}
