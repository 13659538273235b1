"""Empirical estimation of the smoothness constants of paper Table I (the
port of ``repro.core.lipschitz``).

Three quantities, estimated by sampling perturbation pairs around a model:

* ``L_tilde^2`` — the conventional per-client smoothness
  ``max_n ||∇f_n(w) − ∇f_n(v)||² / ||w − v||²``;
* ``L_g^2`` — global smoothness, Assumption 1:
  ``||∇f(w) − ∇f(v)||² / ||w − v||²``;
* ``L_h^2`` — the heterogeneity-driven pseudo-Lipschitz constant,
  Assumption 2: ``||(1/N)Σ_n ∇f_n(w_n) − ∇f(w̄)||² / ((1/N)Σ_n ||w_n −
  w̄||²)``.

Estimates are suprema over the sampled pairs.  The perturbations are
standard-normal draws scaled by ``perturb_scale``: per pair a (d,) draw
for the pair ``(w, w + δ)`` and an (N, d) draw for the per-client models,
given as ``draws`` or taken from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.cnn import ravel_params

Tensor = torch.Tensor
Params = Any
GradFn = Callable[[Params, int], Params]   # (params, client) -> grad tree


def _flat(tree) -> Tensor:
    return ravel_params(tree)[0]


def estimate_constants(params: Params, grad_fn: GradFn, n_clients: int,
                       n_pairs: int = 8, perturb_scale: float = 0.05, *,
                       draws: Optional[Sequence[Tuple[Any, Any]]] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, float]:
    """Estimate ``{"L_tilde2", "L_g2", "L_h2"}`` around ``params``.

    ``grad_fn(params, n)`` returns client ``n``'s full-batch local gradient
    as a parameter tree (for example ``torch.func.grad`` of its loss); the
    global gradient is the client average (Eq. 1).  ``draws``: ``n_pairs``
    pairs of standard-normal ``(delta (d,), noise (N, d))``; else they are
    drawn from ``generator`` (a fresh one seeded 0 when None)."""
    flat0, unravel = ravel_params(params)
    d, dev = flat0.shape[0], flat0.device
    if draws is None:
        gen = generator
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        draws = [(torch.randn(d, generator=gen, device=dev),
                  torch.randn(n_clients, d, generator=gen, device=dev))
                 for _ in range(n_pairs)]

    def grads_all(flat_w: Tensor) -> Tensor:
        w = unravel(flat_w)
        return torch.stack([_flat(grad_fn(w, n)) for n in range(n_clients)])

    l_tilde2 = l_g2 = l_h2 = 0.0
    for delta_z, noise_z in draws[:n_pairs]:
        delta = perturb_scale * torch.as_tensor(delta_z, dtype=torch.float32,
                                                device=dev)
        ga, gb = grads_all(flat0), grads_all(flat0 + delta)      # (N, d)
        dn2 = float(torch.sum(delta ** 2))
        # conventional per-client constant
        per_client = torch.sum((ga - gb) ** 2, dim=1) / dn2
        l_tilde2 = max(l_tilde2, float(per_client.max()))
        # global constant (Assumption 1)
        l_g2 = max(l_g2, float(torch.sum((ga.mean(0) - gb.mean(0)) ** 2)
                               / dn2))
        # heterogeneity constant (Assumption 2): per-client models w_n
        noise = perturb_scale * torch.as_tensor(noise_z, dtype=torch.float32,
                                                device=dev)
        w_n = flat0[None, :] + noise
        w_bar = w_n.mean(dim=0)
        g_mix = torch.stack([_flat(grad_fn(unravel(w_n[n]), n))
                             for n in range(n_clients)]).mean(dim=0)
        g_bar = torch.stack([_flat(grad_fn(unravel(w_bar), n))
                             for n in range(n_clients)]).mean(dim=0)
        denom = float(torch.mean(torch.sum((w_n - w_bar[None, :]) ** 2,
                                           dim=1)))
        l_h2 = max(l_h2, float(torch.sum((g_mix - g_bar) ** 2))
                   / max(denom, 1e-12))
    return {"L_tilde2": l_tilde2, "L_g2": l_g2, "L_h2": l_h2}
