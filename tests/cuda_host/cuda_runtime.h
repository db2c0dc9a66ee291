// cuda_runtime.h for a host build of csrc/qv_traj.cu, csrc/qv_shots.cu and
// csrc/apg_fused.cu: the CUDA features the kernels use, emulated on the CPU.
// Every thread of a block is a std::thread; a warp's lanes meet at a barrier
// for each shuffle and __syncwarp, a block's threads for __syncthreads, and
// the threads of a named barrier (`bar.sync id, n`, which the tests route
// to emu::bar_sync) at a barrier of n made on first use. Blocks run one
// after another, so a static __shared__ array is the running block's.
// Shared memory starts out as garbage, as on the card. Only full-warp masks
// are emulated. tests/test_torch_qv_kernels.py, tests/test_torch_qv_shots.py
// and tests/test_torch_apg_host.py build the kernel sources against it with
// g++ (C++20) and run them against the plain versions.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x) alignas(x)
#define __constant__
#define __shared__ static

using cudaError_t = int;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
using cudaStream_t = void*;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct double2 { double x, y; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t buf[32];
};
struct Block {
  std::barrier<>* all;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<unsigned char> smem;
  std::mutex named_lock;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};
inline thread_local dim3 tid, bid;
inline thread_local Block* blk;
inline int lane() { return tid.x & 31; }
inline Warp& warp() { return *blk->warps[tid.x >> 5]; }
template <class T> T xchg(T v, int src) {
  static_assert(sizeof(T) == 4);
  Warp& w = warp();
  uint32_t u; std::memcpy(&u, &v, 4);
  w.buf[lane()] = u;
  w.bar.arrive_and_wait();
  uint32_t got = w.buf[src & 31];
  w.bar.arrive_and_wait();
  T out; std::memcpy(&out, &got, 4);
  return out;
}
// bar.sync id, n: the n threads that name barrier id meet there
inline void bar_sync(int id, int n) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> hold(blk->named_lock);
    auto& slot = blk->named[id];
    if (!slot) slot.reset(new std::barrier<>(n));
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
template <class K, class... A>
void launch(K kernel, int grid, int threads, size_t smem, void*, A... args) {
  for (int b = 0; b < grid; ++b) {
    Block block;
    std::barrier<> all(threads);
    block.all = &all;
    for (int w = 0; w < threads / 32; ++w) block.warps.emplace_back(new Warp);
    block.smem.assign(smem + 16, 0xFF);  // garbage (NaN floats), as on the card
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        tid.x = t; bid.x = b; blk = &block;
        kernel(args...);
        // a thread that is done, or returned early, waits at no barrier
        // again: the others stop counting it
        warp().bar.arrive_and_drop();
        block.all->arrive_and_drop();
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace emu

#define threadIdx (emu::tid)
#define blockIdx (emu::bid)
inline void __syncwarp() { emu::warp().bar.arrive_and_wait(); }
inline void __syncthreads() { emu::blk->all->arrive_and_wait(); }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  return emu::xchg(v, emu::lane() ^ m);
}
template <class T> T __shfl_sync(unsigned, T v, int s, int width = 32) {
  return emu::xchg(v, (emu::lane() & ~(width - 1)) + (s & (width - 1)));
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  int l = emu::lane(); return emu::xchg(v, l + d < 32 ? l + d : l);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  int l = emu::lane(); return emu::xchg(v, l >= d ? l - d : l);
}
inline unsigned __ballot_sync(unsigned, int p) {
  emu::Warp& w = emu::warp();
  w.buf[emu::lane()] = p != 0;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (w.buf[i] ? 1u : 0u) << i;
  w.bar.arrive_and_wait();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> T __ldg(const T* p) { return *p; }
using std::min; using std::max;
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
// the host's IEEE division rounds to nearest, as these intrinsics do
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
