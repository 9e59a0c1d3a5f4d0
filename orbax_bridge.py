"""Convert an orbax checkpoint to a neutral file and back.

    python orbax_bridge.py to-npz ORBAX_DIR NPZ_DIR
    python orbax_bridge.py from-npz NPZ_DIR ORBAX_DIR

The JAX package writes its Trainer checkpoints and its registry weights with
orbax, in the OCDBT layout with zstd-compressed chunks: reading or writing
them needs tensorstore, which only an installation of JAX and orbax brings.
The PyTorch port (``swin_v2_weather_torch``) runs where neither is installed,
so the two meet in a neutral directory that numpy alone reads:

  * ``tree.npz``: every array leaf, keyed by its tree path joined with ``/``
    (list items by index);
  * ``tree.json``: ``{"format": FORMAT, "tree": node}``, node ``null``,
    ``{"dict": {key: node}}``, ``{"list": [node, ...]}`` or
    ``{"leaf": path}``, so the exact tree (empty optax states as ``None``,
    ``{}``, lists) is rebuilt.

``to-npz`` is an orbax restore with no template (optax's namedtuples come
back as dicts by field name); ``from-npz`` saves the rebuilt tree, which the
JAX Trainer restores with its own template. The port's
``training/interchange.py`` maps the neutral tree to and from its own
checkpoints and registries. This script runs where JAX and orbax are
installed and imports nothing of either package of this repository.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import orbax.checkpoint as ocp

FORMAT = "swin-weather-neutral-tree/1"
TREE_NPZ = "tree.npz"
TREE_JSON = "tree.json"


def to_npz(orbax_dir: str, npz_dir: str) -> None:
    with warnings.catch_warnings():
        # no template: orbax reads each array's sharding from the checkpoint
        warnings.simplefilter("ignore", UserWarning)
        with ocp.PyTreeCheckpointer() as ckptr:
            tree = ckptr.restore(os.path.abspath(orbax_dir))
    arrays = {}

    def encode(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {"dict": {str(k): encode(v, path + [str(k)]) for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"list": [encode(v, path + [str(i)]) for i, v in enumerate(node)]}
        key = "/".join(path)
        arrays[key] = np.asarray(node)
        return {"leaf": key}

    skeleton = encode(tree, [])
    os.makedirs(npz_dir, exist_ok=True)
    with open(os.path.join(npz_dir, TREE_NPZ), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(npz_dir, TREE_JSON), "w") as f:
        json.dump({"format": FORMAT, "tree": skeleton}, f)


def from_npz(npz_dir: str, orbax_dir: str) -> None:
    with open(os.path.join(npz_dir, TREE_JSON)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{npz_dir}: not a neutral tree ({meta.get('format')!r})")
    with np.load(os.path.join(npz_dir, TREE_NPZ), allow_pickle=False) as z:
        def decode(node):
            if node is None:
                return None
            if "dict" in node:
                return {k: decode(v) for k, v in node["dict"].items()}
            if "list" in node:
                return [decode(v) for v in node["list"]]
            return z[node["leaf"]]

        tree = decode(meta["tree"])
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(orbax_dir), tree, force=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser("to-npz", help="an orbax checkpoint -> a neutral directory")
    a.add_argument("orbax_dir")
    a.add_argument("npz_dir")
    b = sub.add_parser("from-npz", help="a neutral directory -> an orbax checkpoint")
    b.add_argument("npz_dir")
    b.add_argument("orbax_dir")
    args = p.parse_args(argv)
    if args.command == "to-npz":
        to_npz(args.orbax_dir, args.npz_dir)
    else:
        from_npz(args.npz_dir, args.orbax_dir)


if __name__ == "__main__":
    main()
