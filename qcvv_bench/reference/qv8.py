"""Plain reference of the ``qv8`` configuration: quantum-volume model
circuits, their heavy sets and heavy-output tallies, in plain PyTorch.

The program's entry point, ``quantum_volume.sample_heavy_outputs_batched``,
draws everything from the ``torch.Generator`` it is given, in this order:
the qubit permutations (the argsort of uniforms), the Haar gates (a complex
Ginibre draw, real parts then imaginary parts), the branch uniforms of the
Kraus trajectories (noisy calls), then the shots (``torch.multinomial``).
The reference starts a generator of its own from the state the caller's
generator had before the call and makes the same draws, so it sees the
same randomness; everything the program derives from them it works out
again here:

- the gates, by a QR decomposition of the Ginibre matrices with the phase
  fix (the unique Haar Q), in float64 on the host;
- the circuits' output probabilities by statevector simulation: layer l
  applies gate j to qubits (perm_l[j], perm_l[j + 1]), the first the more
  significant, for j < depth // 2 (the program's model circuit);
- the heavy sets: outputs whose ideal probability exceeds the median (the
  mean of the two middle values);
- noisy calls: Kraus trajectories, one a shot; after each gate the branch
  k is drawn with weight ||K_k psi||^2 over their sum: k is the number of
  cumulative weights strictly below the trajectory's uniform (at most
  K - 1), and psi becomes K_k psi, renormalized;
- the shots, by ``torch.multinomial`` on the same generator state, and the
  heavy tallies.

``dtype`` float64 is the reference; bfloat16 is the control (the states,
gates and Kraus operators in bfloat16, every operation rounded to it), the
step below the configuration's float32. Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 200    # circuits whose trajectories are simulated at a time


def draws(state: torch.Tensor, device, circuits: int, depth: int,
          trajectories: int = 0):
    """The call's draws from a generator at ``state``: (generator after
    them, permutations (C, d, d), Ginibre real and imaginary parts
    (C, d, d//2, 4, 4), branch uniforms (C, d, d//2, T) or None)."""
    g = torch.Generator(device=device)
    g.set_state(state)
    f32 = torch.float32
    perms = torch.argsort(torch.rand((circuits, depth, depth), generator=g,
                                     device=device, dtype=f32), dim=-1)
    shape = (circuits, depth, depth // 2, 4, 4)
    re = torch.randn(shape, generator=g, device=device, dtype=f32)
    im = torch.randn(shape, generator=g, device=device, dtype=f32)
    uniforms = None
    if trajectories:
        uniforms = torch.rand((circuits, depth, depth // 2, trajectories),
                              generator=g, device=device, dtype=f32)
    return g, perms, re, im, uniforms


def haar_gates(re: torch.Tensor, im: torch.Tensor) -> np.ndarray:
    """The Haar unitaries of Ginibre draws: Q of z = QR with R's diagonal
    made real positive, float64 on the host (complex128, same shape)."""
    z = (re.double().cpu().numpy() + 1j * im.double().cpu().numpy())
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    return q * (d / np.abs(d))[..., None, :]


def _planes(x, dtype, device):
    x = torch.as_tensor(x)
    return (x.real.to(device=device, dtype=dtype),
            x.imag.to(device=device, dtype=dtype))


def _source_index(perms: torch.Tensor, depth: int) -> torch.Tensor:
    """(..., 2^d) source indices of the basis in which layer positions j,
    j + 1 hold qubits perm[j], perm[j + 1]: bit depth-1-i of the new index
    is bit depth-1-perm[i] of the old one."""
    x = torch.arange(2 ** depth, device=perms.device)
    out = torch.zeros(perms.shape[:-1] + (2 ** depth,), dtype=torch.long,
                      device=perms.device)
    for i in range(depth):
        bit = (x >> (depth - 1 - i)) & 1
        out |= bit << (depth - 1 - perms[..., i, None])
    return out


def _apply(psi_r, psi_i, g_r, g_i, j, depth):
    """psi (N, 2^d) <- G psi on positions (j, j + 1); G is (N, 4, 4)."""
    n = psi_r.shape[0]
    shape = (n, 2 ** j, 4, 2 ** (depth - j - 2))
    x_r, x_i = psi_r.reshape(shape), psi_i.reshape(shape)
    y_r = (torch.einsum("nab,nlbr->nlar", g_r, x_r)
           - torch.einsum("nab,nlbr->nlar", g_i, x_i))
    y_i = (torch.einsum("nab,nlbr->nlar", g_r, x_i)
           + torch.einsum("nab,nlbr->nlar", g_i, x_r))
    return y_r.reshape(n, -1), y_i.reshape(n, -1)


def _branch(psi_r, psi_i, m_r, m_i, u, j, depth):
    """The branch of each trajectory after the gate at positions (j, j+1):
    weights Re tr(M_k rho) with rho the pair's reduced density and
    M_k = K_k^dag K_k, normalized; (N,) indices."""
    n = psi_r.shape[0]
    shape = (n, 2 ** j, 4, 2 ** (depth - j - 2))
    x_r, x_i = psi_r.reshape(shape), psi_i.reshape(shape)
    rho_r = (torch.einsum("nlar,nlbr->nab", x_r, x_r)
             + torch.einsum("nlar,nlbr->nab", x_i, x_i))
    rho_i = (torch.einsum("nlar,nlbr->nab", x_i, x_r)
             - torch.einsum("nlar,nlbr->nab", x_r, x_i))
    w = (torch.einsum("kab,nba->nk", m_r, rho_r)
         - torch.einsum("kab,nba->nk", m_i, rho_i)).clamp(min=0.0)
    w = w / w.sum(-1, keepdim=True)
    below = torch.cumsum(w, -1) < u[:, None]
    return below.sum(-1).clamp(max=m_r.shape[0] - 1)


def _normalize(psi_r, psi_i):
    nrm = torch.sqrt((psi_r * psi_r + psi_i * psi_i).sum(-1, keepdim=True))
    return psi_r / nrm, psi_i / nrm


def simulate(perms, gates_r, gates_i, depth, kraus=None, uniforms=None):
    """Output probabilities of model circuits in the gates' real dtype.

    :param perms: (C, d, d) permutations.
    :param gates_r, gates_i: (C, d, d//2, 4, 4) planes of the gates.
    :param kraus: optional (K_r, K_i) planes of the (K, 4, 4) Kraus stack.
    :param uniforms: (C, d, d//2, T) branch uniforms, with ``kraus``.
    :return: (C, 2^d) ideal probabilities, or (C, T, 2^d) per trajectory.
    """
    c, dim = perms.shape[0], 2 ** depth
    t = 1 if uniforms is None else uniforms.shape[-1]
    dtype, dev = gates_r.dtype, gates_r.device
    src = _source_index(perms, depth)                     # (C, d, 2^d)
    inv = torch.argsort(src, dim=-1)
    psi_r = torch.zeros((c * t, dim), dtype=dtype, device=dev)
    psi_i = torch.zeros_like(psi_r)
    psi_r[:, 0] = 1.0
    if kraus is not None:
        k_r, k_i = kraus
        kt_r, kt_i = k_r.transpose(-1, -2), -k_i.transpose(-1, -2)
        m_r = kt_r @ k_r - kt_i @ k_i
        m_i = kt_r @ k_i + kt_i @ k_r

    def per_row(x):                     # (C, ...) -> (C * T, ...)
        return x.repeat_interleave(t, dim=0)

    for layer in range(depth):
        idx = per_row(src[:, layer])
        psi_r, psi_i = psi_r.gather(1, idx), psi_i.gather(1, idx)
        for j in range(depth // 2):
            psi_r, psi_i = _apply(psi_r, psi_i, per_row(gates_r[:, layer, j]),
                                  per_row(gates_i[:, layer, j]), j, depth)
            if kraus is not None:
                u = uniforms[:, layer, j].reshape(-1).to(dtype)
                k = _branch(psi_r, psi_i, m_r, m_i, u, j, depth)
                psi_r, psi_i = _apply(psi_r, psi_i, k_r[k], k_i[k], j, depth)
                psi_r, psi_i = _normalize(psi_r, psi_i)
        idx = per_row(inv[:, layer])
        psi_r, psi_i = psi_r.gather(1, idx), psi_i.gather(1, idx)
    p = psi_r * psi_r + psi_i * psi_i
    p = p / p.sum(-1, keepdim=True)
    return p if uniforms is None else p.reshape(c, t, dim)


def heavy_sets(probs: torch.Tensor) -> torch.Tensor:
    """(C, 2^d) bool: outputs above the median ideal probability."""
    s = torch.sort(probs, dim=-1).values
    half = probs.shape[-1] // 2
    return probs > ((s[..., half - 1] + s[..., half]) / 2)[..., None]


def tallies(state: torch.Tensor, device, *, depth: int, circuits: int,
            shots: int, kraus: np.ndarray = None, trajectories: int = 0,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(C,) heavy-output tallies of the call whose generator stood at
    ``state``: the reference (float64) or the control (bfloat16)."""
    noisy = kraus is not None
    g, perms, re, im, uniforms = draws(state, device, circuits, depth,
                                       trajectories if noisy else 0)
    gates_r, gates_i = _planes(haar_gates(re, im), dtype, device)
    ideal = simulate(perms, gates_r, gates_i, depth)
    heavy = heavy_sets(ideal)
    if not noisy:
        samples = torch.multinomial(ideal.float(), shots, replacement=True,
                                    generator=g)
        return heavy.gather(1, samples).sum(1)
    k = _planes(kraus, dtype, device)
    rows = torch.empty((circuits * trajectories, 2 ** depth),
                       dtype=torch.float32, device=device)
    for c0 in range(0, circuits, BLOCK):
        c1 = min(circuits, c0 + BLOCK)
        p = simulate(perms[c0:c1], gates_r[c0:c1], gates_i[c0:c1], depth,
                     kraus=k, uniforms=uniforms[c0:c1])
        rows[c0 * trajectories:c1 * trajectories] = p.reshape(
            -1, 2 ** depth).float()
    samples = torch.multinomial(rows, shots // trajectories,
                                replacement=True, generator=g)
    return heavy.gather(1, samples.reshape(circuits, shots)).sum(1)
