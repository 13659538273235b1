"""Small vision models for the FL experiments (paper Sec. V), in PyTorch.

Parameters are plain dicts of tensors in the JAX package's layout (conv
weights HWIO, fc weights (in, out)), so weights carry across with
``params_from_numpy`` and ``ravel_params`` flattens in
``jax.flatten_util.ravel_pytree`` order (sorted keys at every level): the
flat index decides the selection jitter, the histogram sample and the
selected set.  The forward takes NHWC input, as the JAX model does, and
permutes internally; features are flattened in NHWC (h, w, c) order
before ``fc`` so the fc weights line up.

``init_prototype_cnn`` on EMNIST-shaped input (28x28x1, 26 classes,
widths (24, 32, 48), fc 192) has d = 109,210 parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tree as tree_util

Tensor = torch.Tensor
Params = Dict[str, Any]


def _normal(gen, shape, scale, device) -> Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=device)


def _conv_init(gen, kh, kw, cin, cout, device) -> Params:
    scale = 1.0 / (kh * kw * cin) ** 0.5
    return {"w": _normal(gen, (kh, kw, cin, cout), scale, device),
            "b": torch.zeros(cout, dtype=torch.float32, device=device)}


def _fc_init(gen, d_in, d_out, device) -> Params:
    scale = 1.0 / d_in ** 0.5
    return {"w": _normal(gen, (d_in, d_out), scale, device),
            "b": torch.zeros(d_out, dtype=torch.float32, device=device)}


def _conv(p: Params, x: Tensor) -> Tensor:
    """3x3 'SAME' convolution, NCHW activations, HWIO weights."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)


def init_prototype_cnn(gen: torch.Generator, image_shape=(28, 28, 1),
                       n_classes: int = 26,
                       widths: Sequence[int] = (24, 32, 48),
                       fc_width: int = 192, device="cpu") -> Params:
    """Random prototype-CNN weights from ``gen`` (same shapes and scales
    as the JAX init; the numbers differ — carry JAX weights across with
    ``params_from_numpy``)."""
    h, w, c = image_shape
    params = {
        "conv1": _conv_init(gen, 3, 3, c, widths[0], device),
        "conv2": _conv_init(gen, 3, 3, widths[0], widths[1], device),
        "conv3": _conv_init(gen, 3, 3, widths[1], widths[2], device),
    }
    feat = (h // 8) * (w // 8) * widths[2]
    params["fc"] = _fc_init(gen, feat, fc_width, device)
    params["head"] = _fc_init(gen, fc_width, n_classes, device)
    return params


def prototype_cnn(params: Params, x: Tensor) -> Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    y = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2", "conv3"):
        y = F.max_pool2d(F.relu(_conv(params[name], y)), 2)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    y = F.relu(y @ params["fc"]["w"] + params["fc"]["b"])
    return y @ params["head"]["w"] + params["head"]["b"]


def init_mlp_classifier(gen: torch.Generator, d_in: int, n_classes: int,
                        hidden: Sequence[int] = (128, 64),
                        device="cpu") -> Params:
    dims = [d_in, *hidden, n_classes]
    return {f"fc{i}": _fc_init(gen, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)}


def mlp_classifier(params: Params, x: Tensor) -> Tensor:
    y = x.reshape(x.shape[0], -1)
    n = len(params)
    for i in range(n):
        y = y @ params[f"fc{i}"]["w"] + params[f"fc{i}"]["b"]
        if i < n - 1:
            y = F.relu(y)
    return y


def softmax_xent(logits: Tensor, labels: Tensor) -> Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: Tensor, labels: Tensor) -> Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def param_count(params: Params) -> int:
    return sum(int(leaf.numel()) for _, leaf in tree_util.leaves(params))


def params_from_numpy(tree: Any, device="cpu") -> Params:
    """A parameter tree of numpy arrays (e.g. the JAX model's, through
    ``np.asarray``) -> the same tree of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def ravel_params(params: Params) -> Tuple[Tensor, Callable[[Tensor], Params]]:
    """Flatten in ``ravel_pytree`` order -> ``(flat, unravel)``;
    ``unravel(flat)`` rebuilds the tree as views into ``flat``."""
    leaves = tree_util.leaves(params)
    flat = torch.cat([leaf.reshape(-1) for _, leaf in leaves])
    spec = [(path, tuple(leaf.shape), leaf.numel()) for path, leaf in leaves]

    def unravel(vec: Tensor) -> Params:
        out, offset = [], 0
        for _, shape, size in spec:
            out.append(vec[offset:offset + size].reshape(shape))
            offset += size
        return tree_util.unflatten([path for path, _, _ in spec], out)

    return flat, unravel


class PrototypeCNN(nn.Module):
    """``nn.Module`` wrapper over ``prototype_cnn``: holds the parameters
    (JAX layout) as ``nn.Parameter``s and runs the functional forward."""

    def __init__(self, params: Params):
        super().__init__()
        self._paths = [path for path, _ in tree_util.leaves(params)]
        self.weights = nn.ParameterDict({
            "_".join(path): nn.Parameter(leaf)
            for path, leaf in tree_util.leaves(params)})

    def params(self) -> Params:
        return tree_util.unflatten(self._paths, [self.weights["_".join(path)]
                                            for path in self._paths])

    def forward(self, x: Tensor) -> Tensor:
        return prototype_cnn(self.params(), x)
