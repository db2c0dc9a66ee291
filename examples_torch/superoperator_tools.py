"""Example: superoperator representations, projections, and random operators.

The port's counterpart of ``examples/superoperator_tools.py``: convert a
noisy channel between Kraus / Choi / chi / Pauli-Liouville representations,
validate physicality, project an unphysical estimate back to CPTP, and
sample the random-operator menagerie from a seeded ``torch.Generator``.

Run on the card with ``python examples_torch/superoperator_tools.py``, or
on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops import (
    apply_choi_matrix_2_state, apply_kraus_ops_2_state, choi2chi,
    choi2pauli_liouville, choi_is_cptp, choi_is_unital, kraus2choi,
    proj_choi_to_physical)
from forest_benchmarking_tpu_torch.ops.random_operators import (
    bures_measure_state_matrix, ginibre_state_matrix, haar_rand_unitary,
    rand_map_with_BCSZ_dist)
from forest_benchmarking_tpu_torch.sim.noise import damping_kraus_map
from forest_benchmarking_tpu_torch.utils import entry_device


def main(device="cuda", out_dir="/tmp"):
    dev = entry_device(device)

    # --- representations of a 1Q amplitude-damping channel
    kraus = torch.tensor(np.stack(damping_kraus_map(0.1)), device=dev)
    choi = kraus2choi(kraus)
    out = {"cptp": bool(choi_is_cptp(choi)), "unital": bool(choi_is_unital(choi)),
           "chi00": float(choi2chi(choi)[0, 0].real),
           "ptm": choi2pauli_liouville(choi).real.cpu().numpy()}
    print("amplitude damping p=0.1:")
    print("  CPTP:", out["cptp"], " unital:", out["unital"])
    print("  chi[0,0] (identity weight):", out["chi00"])
    print("  PTM:\n", np.round(out["ptm"], 3))

    # applying the channel: Kraus and Choi forms agree
    rho = torch.tensor([[0.2, 0.3], [0.3, 0.8]], dtype=torch.complex128,
                       device=dev)
    out_k = apply_kraus_ops_2_state(kraus, rho)
    out_c = apply_choi_matrix_2_state(choi, rho)
    out["apply_agreement"] = float((out_k - out_c).abs().max())
    print("  apply agreement (Kraus vs Choi):", out["apply_agreement"])

    # --- projection: corrupt the Choi, project back to the physical set
    rng = np.random.RandomState(0)
    noise = 0.05 * (rng.randn(4, 4) + 1j * rng.randn(4, 4))
    corrupted = choi + torch.tensor(noise + noise.conj().T, device=dev)
    out["corrupted_cptp"] = bool(choi_is_cptp(corrupted))
    print("corrupted is CPTP:", out["corrupted_cptp"])
    repaired = proj_choi_to_physical(corrupted, tol=1e-8, max_iters=5000)
    out["repaired_cptp"] = bool(choi_is_cptp(repaired, atol=1e-3))
    out["moved"] = float((repaired - corrupted).abs().max())
    print("projected back:    CPTP:", out["repaired_cptp"],
          " distance moved:", out["moved"])

    # --- random operators (all take an explicit seeded torch.Generator)
    gen = torch.Generator(device=dev).manual_seed(42)
    u = haar_rand_unitary(gen, 4)
    eye = torch.eye(4, dtype=u.dtype, device=dev)
    out["unitarity"] = float((u @ u.conj().T - eye).abs().max())
    print("Haar unitary: max |U U^dag - I| =", out["unitarity"])
    rho_g = ginibre_state_matrix(gen, 2, 2)
    rho_b = bures_measure_state_matrix(gen, 2)
    out["ginibre_purity"] = float(torch.trace(rho_g @ rho_g).real)
    out["bures_purity"] = float(torch.trace(rho_b @ rho_b).real)
    print("Ginibre state purity:", out["ginibre_purity"],
          " Bures state purity:", out["bures_purity"])
    rand_choi = rand_map_with_BCSZ_dist(gen, 2, 4)
    out["bcsz_cptp"] = bool(choi_is_cptp(rand_choi, atol=1e-8))
    print("BCSZ random channel is CPTP:", out["bcsz_cptp"])
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
