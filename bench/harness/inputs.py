"""The inputs the benchmark draws from ``--seed`` and hands to the port
and to the reference alike: the weights, each round's batch and the
update cell's pool of gradient trees.  Each comes from its own device
generator, seeded from ``SeedSequence([seed, tag, ...])``, in a few large
calls.  Nothing here imports the port."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from bench.reference import tree

Tensor = torch.Tensor
TAG_WEIGHTS, TAG_BATCH, TAG_POOL = 1, 2, 3


def generator(device, seed: int, *tags: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def weights(spec: Sequence, seed: int, device, dtype=torch.float32) -> Any:
    """The parameter tree of ``spec`` ((path, shape, init) triples)."""
    gen = generator(device, seed, TAG_WEIGHTS)
    paths, vals = [], []
    for path, shape, init in spec:
        if init[0] == "normal":
            x = torch.randn(shape, generator=gen, device=device) * init[1]
        elif init[0] == "ones":
            x = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            x = torch.zeros(shape, device=device)
        elif init[0] == "alog":
            x = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                         device=device)).expand(shape)
        else:
            raise ValueError(f"unknown init {init!r}")
        paths.append(path)
        vals.append(x.to(dtype).contiguous())
    return tree.unflatten(paths, vals)


def train_batch(model: Dict[str, Any], wl: Dict[str, Any], seed: int,
                t: int, device) -> Dict[str, Tensor]:
    """Round ``t``'s batch: ``tokens`` / ``labels`` (n_micro, mb, S_text)
    int32, uniform over the vocabulary (labels the next token), and for a
    VLM ``embeds`` (n_micro, mb, P, D), normals at 0.02 in the compute
    dtype."""
    gen = generator(device, seed, TAG_BATCH, t)
    b, n_micro = wl["batch"], wl["n_micro"]
    p = model.get("n_patches", 0) if model["family"] == "vlm" else 0
    s_text = wl["seq_len"] - p
    seq = torch.randint(0, model["vocab"], (b, s_text + 1), generator=gen,
                        device=device, dtype=torch.int64)
    shape = (n_micro, b // n_micro, s_text)
    out = {"tokens": seq[:, :-1].to(torch.int32).reshape(shape),
           "labels": seq[:, 1:].to(torch.int32).reshape(shape)}
    if p:
        cdt = getattr(torch, model["compute_dtype"])
        emb = 0.02 * torch.randn(b, p, model["d_model"], generator=gen,
                                 device=device)
        out["embeds"] = emb.to(cdt).reshape(n_micro, b // n_micro, p,
                                            model["d_model"])
    return out


def rows(batch: Dict[str, Tensor]) -> List[Dict[str, Tensor]]:
    """The batch as its sequences, microbatch by microbatch."""
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in flat.items()}
            for i in range(flat["tokens"].shape[0])]


def leaf_rms(spec: Sequence, table: Dict[str, Any], device) -> List[Tensor]:
    """Each leaf's scale from ``table`` (path name -> RMS): a number for
    the whole leaf, or a list over its leading (layer) axis, read at
    evenly spaced entries where the leaf has fewer layers."""
    out = []
    for path, shape, _ in spec:
        rms = table[tree.path_name(path)]
        if isinstance(rms, (int, float)):
            out.append(torch.tensor(float(rms), device=device))
            continue
        n = shape[0]
        pick = [rms[(i * len(rms)) // n] for i in range(n)]
        out.append(torch.tensor(pick, device=device).view(
            (n,) + (1,) * (len(shape) - 1)))
    return out


def grad_tree(spec: Sequence, table: Dict[str, Any], seed: int, i: int,
              device) -> Any:
    """Pool tree ``i``: each leaf normals times its RMS from ``table``,
    float32, drawn in one call."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator(device, seed,
                                                       TAG_POOL, i),
                       device=device)
    parts = [x.view(shape) for x, (_, shape, _) in
             zip(flat.split(sizes), spec)]
    for x, s in zip(parts, leaf_rms(spec, table, device)):
        x.mul_(s)
    return tree.unflatten([p for p, _, _ in spec], parts)
