"""Checkpoints of the port (``repro.checkpoint.io``), in the reference's
on-disk format, so that either package restores the other's files.

``save`` / ``restore``: trees (dicts, lists, tuples, ``None``) of tensors
as ``.npz`` files under path-encoded keys (``/d:<key>``, ``/l:<i>``,
``/t:<i>``, ``/none``, ``/a``).  A bfloat16 leaf is written as the
reference writes it, its raw 2-byte words as numpy void ``|V2`` (numpy
has no bfloat16), and a ``|V2`` array restores as bfloat16.

``save_server_state`` / ``restore_server_state``: the launch path's
persisted packed server buffers (flat bf16 ``g``, int8 ``age``, float32
``res`` / ``theta`` / ``ctrl`` / ``fad``, bf16 ``shadow`` / ``pending``)
with a JSON record of their dtypes (bf16 stored as a ``uint16`` view with
the tag ``"bfloat16"``), a CRC32 per stored array and the
``PackedLayout`` block table.

Writes are atomic (a temporary file in the target directory, then a
rename).  Restored tensors are rebuilt with ``torch.from_numpy`` on
``device`` (the card unless asked otherwise), without ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import channel as chan
from repro_torch.core import packing
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_SEP = "/"
_BF16 = "bfloat16"


def _bf16_words(t: Tensor) -> np.ndarray:
    """A bfloat16 tensor's raw words as a uint16 array."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _bf16_from_words(words: np.ndarray, device) -> Tensor:
    u16 = np.ascontiguousarray(words).view(np.uint16)
    return torch.from_numpy(u16.view(np.int16).copy()).view(
        torch.bfloat16).to(device)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, Tensor):
        if leaf.dtype == torch.bfloat16:
            return _bf16_words(leaf).view("V2")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, device) -> Tensor:
    if arr.dtype == np.dtype("V2"):
        return _bf16_from_words(arr, device)
    return torch.from_numpy(np.array(arr)).to(device)


def _flatten(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{_SEP}d:{k}")
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{_SEP}{tag}:{i}")
    elif tree is None:
        yield prefix + f"{_SEP}none", np.zeros((0,))
    else:
        yield prefix + f"{_SEP}a", _to_numpy(tree)


def _insert(root, parts, value):
    key = parts[0]
    kind, _, name = key.partition(":")
    if kind == "a":
        return value
    if kind == "none":
        return None
    if kind == "d":
        node = root if isinstance(root, dict) else {}
        node[name] = _insert(node.get(name), parts[1:], value)
        return node
    if kind in ("l", "t"):
        node = root if isinstance(root, list) else []
        i = int(name)
        while len(node) <= i:
            node.append(None)
        node[i] = _insert(node[i], parts[1:], value)
        return node
    raise ValueError(f"bad checkpoint key part {key!r}")


def _fix_tuples(tree, spec):
    if isinstance(spec, dict):
        return {k: _fix_tuples(tree[k], spec[k]) for k in spec}
    if isinstance(spec, list):
        return [_fix_tuples(t, s) for t, s in zip(tree, spec)]
    if isinstance(spec, tuple):
        return tuple(_fix_tuples(t, s) for t, s in zip(tree, spec))
    return tree


def _atomic_savez(path: str, **arrays) -> None:
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)       # tmp ends in .npz: no suffix added
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Save a tree; with ``step``, as ``<path>/step_<step>.npz``."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"step_{step:08d}.npz")
    _atomic_savez(path, **dict(_flatten(tree)))
    return path


def restore(path: str, like: Any = None, device: DeviceLike = None) -> Any:
    """Load a tree of tensors on ``device``; ``like`` (optional) restores
    the tuple-versus-list distinction."""
    dev = resolve_device(device)
    data = np.load(path)
    root: Any = None
    for key in data.files:
        parts = key.split(_SEP)[1:]
        value = data[key]
        if parts[-1] != "none":
            value = _to_tensor(value, dev)
        root = _insert(root, parts, value)
    if like is not None:
        root = _fix_tuples(root, like)
    return root


# ---------------------------------------------------------------------------
# packed server-state checkpoints (flat buffers + layout metadata)
# ---------------------------------------------------------------------------

class CorruptCheckpointError(ValueError):
    """A stored content checksum does not match the loaded bytes (bit rot,
    a torn write, a truncated copy): recoverable by falling back to the
    previous checkpoint, unlike a layout or field mismatch (a plain
    ``ValueError``)."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_server_state(path: str, server: Dict[str, Tensor],
                      layout: Optional[packing.PackedLayout] = None,
                      step: Optional[int] = None) -> str:
    """Save a flat packed server-state dict; with ``step``, as
    ``<path>/server_<step>.npz``.  ``layout`` records the block table, so
    that a restoring process can check its own layout against it."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"server_{step:08d}.npz")
    arrays, dtypes, checksums = {}, {}, {}
    for name, val in server.items():
        if isinstance(val, Tensor) and val.dtype == torch.bfloat16:
            dtypes[name] = _BF16
            arr = _bf16_words(val)
        else:
            arr = _to_numpy(val)
            dtypes[name] = str(arr.dtype)
        arrays[name] = arr
        # over the stored bytes: restore checks what it hands back
        checksums[name] = _crc(arr)
    meta = {"dtypes": dtypes, "checksums": checksums,
            "layout": (packing.layout_to_meta(layout)
                       if layout is not None else None)}
    _atomic_savez(path, __server_meta__=np.asarray(json.dumps(meta)),
                  **arrays)
    return path


def restore_server_state(path: str,
                         layout: Optional[packing.PackedLayout] = None,
                         device: DeviceLike = None
                         ) -> Tuple[Dict[str, Tensor],
                                    Optional[Dict[str, Any]]]:
    """Load a ``save_server_state`` file -> (server dict of tensors on
    ``device``, layout record).  Every recorded checksum is verified
    (``CorruptCheckpointError``; files without checksums load unchecked);
    with ``layout``, the saved block table must match it (``ValueError``:
    flat buffers on another layout would scramble every parameter)."""
    dev = resolve_device(device)
    data = np.load(path)
    meta = json.loads(str(data["__server_meta__"][()]))
    crcs = meta.get("checksums")
    server = {}
    for name in data.files:
        if name == "__server_meta__":
            continue
        arr = data[name]
        if crcs is not None:
            if name not in crcs:
                raise CorruptCheckpointError(
                    f"{path}: array {name!r} has no recorded checksum")
            got = _crc(arr)
            if got != crcs[name]:
                raise CorruptCheckpointError(
                    f"{path}: array {name!r} fails its content checksum "
                    f"(stored {crcs[name]:#010x}, loaded {got:#010x}) — "
                    "checkpoint is corrupt")
        tag = meta["dtypes"][name]
        server[name] = (_bf16_from_words(arr, dev) if tag == _BF16
                        else torch.from_numpy(
                            np.array(arr, dtype=np.dtype(tag))).to(dev))
    lay_meta = meta.get("layout")
    if layout is not None:
        if lay_meta is None:
            raise ValueError(f"{path} was saved without layout metadata — "
                             "cannot verify buffer geometry")
        if not packing.layout_matches(layout, lay_meta):
            raise ValueError(f"{path} holds buffers for a different "
                             "PackedLayout (leaf shapes/offsets differ); "
                             "refusing to restore onto this model")
    return server, lay_meta


# the async double buffers start cold (zeros), so a synchronous checkpoint
# resumed under async rounds migrates exactly
ASYNC_FIELDS = ("shadow", "pending")

# the wireless fading chain: its cold start is the deterministic
# stationary draw ``channel.init_block_fading`` (not zeros, which would be
# a channel in permanent outage)
CHANNEL_FIELDS = ("fad",)


def migrate_server_state(server: Dict[str, Tensor],
                         like: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Reconcile a restored server dict with the configured field set:
    missing ``ASYNC_FIELDS`` come back as zeros shaped like ``like``,
    a missing ``CHANNEL_FIELDS`` entry as the port's cold-start fading
    draw; any other missing field, and any field the configuration does
    not expect, raises ``ValueError`` naming them."""
    missing = sorted(set(like) - set(server))
    extra = sorted(set(server) - set(like))
    synth = ASYNC_FIELDS + CHANNEL_FIELDS
    hard_missing = [f for f in missing if f not in synth]
    if hard_missing or extra:
        raise ValueError(
            f"checkpoint fields {sorted(server)} do not match the "
            f"configured server state {sorted(like)} "
            f"(missing: {hard_missing or 'none'}, "
            f"unexpected: {extra or 'none'}) — resume with the same "
            "--ef/--one-bit/--adaptive-km/--async-agg/--channel flags "
            f"(only the async fields {list(ASYNC_FIELDS)} and the fading "
            f"chain {list(CHANNEL_FIELDS)} can be synthesized, and only "
            "in the off -> on direction)")
    out = dict(server)
    for name in missing:
        ref = like[name]
        if name in CHANNEL_FIELDS:
            out[name] = chan.init_block_fading(int(ref.shape[0]) // 2,
                                               ref.device)
        else:
            out[name] = torch.zeros_like(ref)
    return out


def server_steps(ckpt_dir: str) -> List[int]:
    """Every server checkpoint step under ``ckpt_dir``, newest first (the
    order in which a resume tries them)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"server_(\d+)\.npz", f))]
    return sorted(steps, reverse=True)


def latest_server_step(ckpt_dir: str) -> Optional[int]:
    steps = server_steps(ckpt_dir)
    return steps[0] if steps else None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None
