"""Wrappers of the FSK majority-vote kernels (``csrc/sign_mv.cu``).

Replace ``src/repro/kernels/sign_mv.py:_sign_mv_kernel`` /
``_sign_mv_noise_kernel`` (``sign_mv_pallas``) and
``_sign_from_energy_kernel`` / ``_sign_from_energy_noise_kernel``
(``sign_from_energy_pallas``).  Bound on the H100: device-memory bytes
(the (N, k) vote matrix is read once; one compare and one integer add per
vote).  One thread owns a column and walks the N rows, so the row reads
coalesce and the vote count is an exact integer.

Each wrapper checks its tensors, allocates the outputs and launches on the
current stream without synchronising; ``SIGN_MV_LAUNCHES`` and
``SIGN_FROM_ENERGY_LAUNCHES`` count the launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import check_vec

Tensor = torch.Tensor

SIGN_MV_LAUNCHES = 0
SIGN_FROM_ENERGY_LAUNCHES = 0


def sign_mv_cuda(votes: Tensor, noise: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """(N, k) votes (+ (k,) noise) -> (signs, energy), both (k,) float32."""
    global SIGN_MV_LAUNCHES
    if votes.dim() != 2:
        raise ValueError(f"votes must be (N, k), got {tuple(votes.shape)}")
    n, k = votes.shape
    if votes.device.type != "cuda":
        raise ValueError(f"votes must lie on a CUDA device, got "
                         f"{votes.device}")
    if votes.dtype != torch.float32 or not votes.is_contiguous():
        raise ValueError("votes must be contiguous float32")
    if noise is not None:
        check_vec("noise", noise, k, votes.device)
    lib = build.load()
    signs = torch.empty(k, dtype=torch.float32, device=votes.device)
    energy = torch.empty_like(signs)
    stream = torch.cuda.current_stream(votes.device).cuda_stream
    p = build.ptr
    rc = lib.repro_sign_mv(p(votes), p(noise), p(signs), p(energy), n, k,
                           stream)
    build.check(rc, "sign_mv")
    SIGN_MV_LAUNCHES += 1
    return signs, energy


def sign_from_energy_cuda(energy: Tensor, noise: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """(k,) energy (+ (k,) noise) -> (signs, energy'), both (k,) float32."""
    global SIGN_FROM_ENERGY_LAUNCHES
    k = energy.shape[0] if energy.dim() == 1 else -1
    check_vec("energy", energy, k, energy.device)
    if noise is not None:
        check_vec("noise", noise, k, energy.device)
    lib = build.load()
    signs = torch.empty_like(energy)
    energy_out = torch.empty_like(energy)
    stream = torch.cuda.current_stream(energy.device).cuda_stream
    p = build.ptr
    rc = lib.repro_sign_from_energy(p(energy), p(noise), p(signs),
                                    p(energy_out), k, stream)
    build.check(rc, "sign_from_energy")
    SIGN_FROM_ENERGY_LAUNCHES += 1
    return signs, energy_out
