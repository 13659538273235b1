"""One-bit gradient transport for the prototype uplink (paper Sec. V-B),
the port of ``repro.core.quantize``: clients send sign(ǧ) by FSK, the
server recovers each coordinate by a non-coherent majority vote.

    vote_n = sign(ǧ_{n,t});  energy = Σ_n vote_n + noise;  ǧ_t = sign(energy)

The channel noise is ``noise_std · z`` with ``z`` a standard-normal draw
passed as a tensor (JAX draws it from a key inside).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.oac import reconstruct
from repro_torch.kernels import ops

Tensor = torch.Tensor


def one_bit(x: Tensor) -> Tensor:
    """Client-side quantizer; sign with 0 mapped to +1 (a carrier is always
    sent)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def fsk_majority_from_energy(energy: Tensor, z: Optional[Tensor] = None,
                             noise_std: float = 0.0,
                             mode: Optional[str] = None) -> Tensor:
    """Majority vote over a pre-reduced (k,) vote-energy row: noise
    ``noise_std · z`` on the energy, then the sign — one
    ``sign_from_energy`` kernel that scales the draw itself."""
    return ops.sign_from_energy(energy, z=z, noise_std=noise_std,
                                mode=mode)[0]


def fsk_majority_vote(votes: Tensor, z: Optional[Tensor] = None,
                      noise_std: float = 0.0,
                      mode: Optional[str] = None) -> Tensor:
    """Server-side majority vote over (N, k) one-bit votes."""
    return fsk_majority_from_energy(votes.sum(dim=0), z, noise_std, mode)


def one_bit_round(g_prev: Tensor, idx: Tensor, client_grads: Tensor,
                  z: Optional[Tensor] = None, noise_std: float = 0.0,
                  mode: Optional[str] = None) -> Tensor:
    """One-bit variant of ``oac.oac_round``: majority-vote signs on the
    selected coordinates, stale values elsewhere."""
    votes = one_bit(client_grads[:, idx])
    return reconstruct(g_prev, idx,
                       fsk_majority_vote(votes, z, noise_std, mode))
