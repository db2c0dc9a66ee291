"""The dim = 4 fused APG kernel's own code on the CPU.

``csrc/apg_fused.cu`` is built with g++ against
``tests/cuda_host/cuda_runtime.h``, which runs each thread of a block as a
host thread, each shuffle and ``__syncwarp`` on a barrier of the warp's
lanes, ``__syncthreads`` on one of the block and the groups' named barriers
(``bar.sync id, 256``, routed here to ``emu::bar_sync``) on one of their 256
threads. The kernel is then held against the plain version,
``lanes_apg.apg_fused_reference``, by the on-card bar of
``tests/test_torch_cuda.py``, at a batch of one full block of four problems
and a tail, and a problem's estimate is held bitwise to its estimate alone.
Only the card can show that nvcc takes the source and time it
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch import kernels
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops import lanes_apg

# The program reads the inputs from argv[1], one raw array after another
# (A's planes, A^T's planes, the counts, rho0's planes, the schedule), and
# writes out_r, then out_i, to argv[2].
HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}
int main(int argc, char** argv) {
  const int batch = atoi(argv[3]), rows = atoi(argv[4]);
  const size_t a = size_t(rows) * 256, x = size_t(batch) * 256;
  FILE* f = fopen(argv[1], "rb");
  auto a_r = take<float>(f, a), a_i = take<float>(f, a);
  auto at_r = take<float>(f, a), at_i = take<float>(f, a);
  auto n = take<float>(f, size_t(batch) * rows);
  auto rho_r = take<float>(f, x), rho_i = take<float>(f, x);
  auto sched = take<ApgSchedule>(f, 1);
  fclose(f);
  std::vector<float> out(2 * x);
  const int err = apg_fused_launch(
      a_r.data(), a_i.data(), at_r.data(), at_i.data(), n.data(),
      rho_r.data(), rho_i.data(), out.data(), out.data() + x, batch, rows, 4,
      sched.data(), nullptr);
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return err;
}
"""

NAMED_BARRIER = 'asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");'


@pytest.fixture(scope="module")
def host_apg(tmp_path_factory):
    """Run the host build of the dim = 4 kernel: ``run(ar, ai, n, rho0_r,
    rho0_i, **schedule)`` on float32 CPU tensors returns (est_r, est_i)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel source for the host")
    out = tmp_path_factory.mktemp("apg_host")
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    for kind, name in (("unsigned char", "smem2q"), ("float", "dyn")):
        line = f"extern __shared__ __align__(16) {kind} {name}[];"
        assert src.count(line) == 1, line
        src = src.replace(line, f"{kind}* {name} = reinterpret_cast<{kind}*>"
                                f"(emu::blk->smem.data());")
    assert src.count(NAMED_BARRIER) == 1
    src = src.replace(NAMED_BARRIER, "emu::bar_sync(id, 256);")
    # kernel<...><<<grid, block, smem, stream>>>(args) -> emu::launch(...)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ",
                 src, flags=re.S)
    (out / "apg_host.cpp").write_text(src + HOST_MAIN)
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{kernels.CSRC.parents[1] / 'tests' / 'cuda_host'}",
                    "-o", str(out / "apg_host"), str(out / "apg_host.cpp")],
                   check=True, capture_output=True)

    def run(ar, ai, n, rho0_r, rho0_i, **schedule):
        sched = lanes_apg.kernel_schedule(4, **schedule)
        arrays = (ar, ai, ar.T, ai.T, n, rho0_r, rho0_i)
        (out / "in.bin").write_bytes(
            b"".join(x.contiguous().numpy().tobytes() for x in arrays)
            + bytes(sched))
        batch, rows = n.shape
        subprocess.run([str(out / "apg_host"), str(out / "in.bin"),
                        str(out / "out.bin"), str(batch), str(rows)],
                       check=True)
        got = torch.from_numpy(np.fromfile(out / "out.bin", np.float32))
        return got.reshape(2, batch, 16, 16).unbind(0)
    return run


@pytest.fixture(scope="module")
def case():
    """B = 5 (one full block of four problems and one in a part-empty
    block) at 2000 shots, with the f32 and f64 inputs and warm starts."""
    a = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a, np.zeros((1, 1080)), device="cpu")
    in64 = inputs_from_numpy(a, np.zeros((1, 1080)), device="cpu",
                             dtype=torch.float64)
    n, _ = synth_process_datasets(torch.Generator().manual_seed(26), in32.a,
                                  4, 5, 2000)
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
    return in32, in64, n, rho0


def test_host_built_kernel_against_plain_version(host_apg, case):
    """Headline schedule: the kernel's max deviation from the plain f64
    solve is at most twice the plain f32 solve's + 1e-5, and its estimates'
    partial trace within 1e-5 of I, the card's bar."""
    in32, in64, n, rho0 = case
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    kern = torch.complex(*host_apg(in32.ar, in32.ai, n, *rho0, **cfg))
    plain32 = torch.complex(*lanes_apg.apg_fused_reference(
        in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
    rho64 = lanes_apg.linear_inversion_start(in64.a_pinv, n.double(), 4)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n.double(), *rho64, dim=4, **cfg))
    dev_k = (kern.to(plain64.dtype) - plain64).abs().max().item()
    dev_p = (plain32.to(plain64.dtype) - plain64).abs().max().item()
    assert dev_k <= 2 * dev_p + 1e-5
    pt = torch.diagonal(kern.reshape(-1, 4, 4, 4, 4), dim1=2, dim2=4).sum(-1)
    assert (pt - torch.eye(4)).abs().max() < 1e-5


def test_host_built_estimate_does_not_depend_on_block_mates(host_apg, case):
    """Problem 1's estimate is bitwise the same solved among the block-mates
    of B = 5 and alone (B = 1, three empty slots)."""
    in32, _, n, rho0 = case
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    everything = host_apg(in32.ar, in32.ai, n, *rho0, **cfg)
    alone = host_apg(in32.ar, in32.ai, n[1:2], *(x[1:2] for x in rho0), **cfg)
    for got, want in zip(alone, everything):
        assert torch.equal(got, want[1:2])
