"""Weight conversion between the JAX parameter tree and the port's state_dict.

The JAX tree is given as nested dicts of arrays (the ``'params'`` collection,
e.g. ``jax.tree.map(np.asarray, variables['params'])``); it needs no JAX to
read. The mapping:

  * Dense ``kernel`` [in, out] <-> Linear ``weight`` [out, in] (transposed);
  * LayerNorm ``scale`` <-> ``weight``; ``bias`` stays ``bias``;
  * ``pos_embed`` stays NHWC [1, gh, gw, C]; ``logit_scale`` keeps its shape;
  * unrolled ``block{i}`` <-> ``blocks.{i}``. The scanned layout
    (``scan_blocks: true``) stores ``pairs/{block0,block1}`` with a stacked
    leading axis over block pairs; it is unstacked on the way in (a numpy
    port of ``convert_block_layout``) and produced on request on the way out.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK = re.compile(r"block(\d+)")


def _unstack_pairs(node: dict) -> dict:
    """Scanned ``pairs/{block0,block1}`` -> unrolled ``block{i}``, recursively."""
    out = {}
    for key, val in node.items():
        if key == "pairs":
            for i in range(_first_leaf(val).shape[0]):
                out[f"block{2 * i}"] = _take(val["block0"], i)
                out[f"block{2 * i + 1}"] = _take(val["block1"], i)
        elif isinstance(val, dict):
            out[key] = _unstack_pairs(val)
        else:
            out[key] = val
    return out


def _first_leaf(node: dict) -> np.ndarray:
    val = next(iter(node.values()))
    return _first_leaf(val) if isinstance(val, dict) else np.asarray(val)


def _take(node: dict, i: int) -> dict:
    return {
        k: _take(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in node.items()
    }


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (either block layout) -> the port's state_dict."""
    state: Dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: list) -> None:
        for key, val in node.items():
            m = _BLOCK.fullmatch(key)
            name = f"blocks.{m.group(1)}" if m else key
            if isinstance(val, dict):
                walk(val, prefix + [name])
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                name, arr = "weight", arr.T
            elif key == "scale":
                name = "weight"
            state[".".join(prefix + [name])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(_unstack_pairs(tree), [])
    return state


def jax_top_level_name(name: str) -> str:
    """The JAX tree's top-level module of a state_dict key, under the model
    wrapper: ``model.blocks.3.attn.qkv.weight`` -> ``block3``,
    ``model.patch_embed.proj.bias`` -> ``patch_embed``, ``model.pos_embed`` ->
    ``pos_embed``, ``model.head.weight`` -> ``head``."""
    parts = name.split(".")
    if parts[0] == "model" and len(parts) > 1:
        parts = parts[1:]
    return f"block{parts[1]}" if parts[0] == "blocks" else parts[0]


def params_to_jax(state_dict: Dict[str, torch.Tensor], scan_blocks: bool = False) -> dict:
    """The port's state_dict -> JAX parameter tree of numpy arrays.

    A 2-D ``weight`` is a Linear weight (-> transposed ``kernel``), a 1-D one a
    LayerNorm scale. ``scan_blocks=True`` stacks the blocks into the scanned
    ``pairs`` layout.
    """
    tree: dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == "blocks":
                path.append(f"block{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        arr = t.detach().cpu().float().numpy()
        if path[-1] == "weight":
            if arr.ndim == 2:
                path[-1], arr = "kernel", arr.T
            else:
                path[-1] = "scale"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return _stack_pairs(tree) if scan_blocks else tree


def _stack_pairs(node: dict) -> dict:
    """Unrolled ``block{i}`` -> scanned ``pairs/{block0,block1}``, recursively."""
    blocks = sorted((k for k in node if _BLOCK.fullmatch(k)), key=lambda k: int(k[5:]))
    out = {k: _stack_pairs(v) if isinstance(v, dict) else v
           for k, v in node.items() if k not in blocks}
    if blocks:
        if len(blocks) % 2:
            raise ValueError(f"cannot pair {len(blocks)} blocks for the scanned layout")

        def stack(items):
            if isinstance(items[0], dict):
                return {k: stack([it[k] for it in items]) for k in items[0]}
            return np.stack(items)

        out["pairs"] = {
            "block0": stack([node[k] for k in blocks[0::2]]),
            "block1": stack([node[k] for k in blocks[1::2]]),
        }
    return out
