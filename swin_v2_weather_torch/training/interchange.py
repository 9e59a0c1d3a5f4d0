"""The JAX package's checkpoints and registries in the port, and back.

Counterpart of the layout logic of ``swin_v2_weather_tpu/training/
checkpoint.py`` (``_convert_layout_anywhere``, ``_is_scan_layout``): a JAX
Trainer checkpoint (an orbax tree of ``iters``, ``epoch``,
``step_in_epoch``, ``params``, ``opt_state`` and ``scheduler``) becomes a
port ``checkpoint.pt`` that the port Trainer resumes unchanged, and a port
checkpoint becomes the tree the JAX Trainer restores with its template, in
either block layout.

The port reads no orbax: the orbax checkpoint (OCDBT, zstd-compressed,
which only tensorstore reads) crosses through a **neutral file** that
``orbax_bridge.py`` at the repository root writes and reads where JAX is
installed. A neutral directory holds

  * ``tree.npz``: every array leaf, keyed by its orbax tree path joined with
    ``/`` (``params/model/pairs/block0/attn/qkv/kernel``,
    ``opt_state/inner_state/0/mu/...``; list items by index);
  * ``tree.json``: the tree's skeleton, ``{"format": ..., "tree": node}``
    with node ``null`` (an empty optax state), ``{"dict": {key: node}}``
    (``{}`` included), ``{"list": [node, ...]}`` or ``{"leaf": path}``.

The mapping, with no knowledge of the model beyond its parameter names:

  * the weights through ``models/convert.params_from_jax`` /
    ``params_to_jax`` (Dense ``kernel`` transposed, LayerNorm ``scale`` ->
    ``weight``, the scanned ``pairs`` unstacked or stacked);
  * Adam's ``mu``/``nu`` (optax ``scale_by_adam``, under ``inject_hyperparams``
    and, for LAMB, the chain ``clip_by_global_norm``, ``lamb``) -> the port
    optimizer's ``exp_avg``/``exp_avg_sq`` with the same renames and
    transposes; optax's int32 ``count`` -> the port's step count (a host fp32
    tensor for ``torch.optim.Adam``, an int for ``training.optim.Lamb``);
  * the injected ``learning_rate`` -> the optimizer's group ``lr``, checked
    against the scheduler state; ``iters``, ``epoch``, ``step_in_epoch`` and
    ``scheduler`` as they are.

A JAX leaf with no port counterpart, or a port parameter with no JAX leaf,
raises, as the port's restore refuses a partial restore. Import followed by
export gives back every leaf bit for bit (dtypes included).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax

TREE_NPZ = "tree.npz"
TREE_JSON = "tree.json"
FORMAT = "swin-weather-neutral-tree/1"

# optax's state under inject_hyperparams(make)(learning_rate): the inner
# state of each optimizer, ADAM standing for scale_by_adam's {count, mu, nu}
ADAM = "scale_by_adam"
INNER_STATES = {
    # optax.adam: chain(scale_by_adam, scale_by_learning_rate)
    "adam": [ADAM, None],
    # chain(clip_by_global_norm, lamb); lamb = chain(scale_by_adam,
    # add_decayed_weights, scale_by_trust_ratio, scale_by_learning_rate)
    "lamb": [None, [ADAM, None, None, None]],
}


# --------------------------------------------------------------------------
# the neutral file
# --------------------------------------------------------------------------


def write_tree(tree, npz_dir: str) -> None:
    """Write a tree of dicts, lists, ``None`` and arrays as a neutral
    directory."""
    arrays: Dict[str, np.ndarray] = {}

    def encode(node, path: List[str]):
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


def read_tree(npz_dir: str):
    """The tree of a neutral directory (arrays read into memory)."""
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

        return decode(meta["tree"])


def leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """Every array leaf by its ``/``-joined path."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return out
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# --------------------------------------------------------------------------
# the port's side: parameter names and the optimizer's groups
# --------------------------------------------------------------------------


def _model_params(params):
    """The port model's parameter shapes by name, in ``parameters()`` order,
    and the model itself, built on the meta device from a copy of the config
    ``params`` (a YParams or a dict)."""
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.inference.registry import _DictParams
    from swin_v2_weather_torch.models.wrappers import get_model

    params = _DictParams({k: params[k] for k in params})
    params["in_channels"] = np.asarray(params["in_channels"])
    params["out_channels"] = np.asarray(params["out_channels"])
    params["n_in_channels"], params["n_out_channels"] = derived_channel_counts(params)
    with torch.device("meta"):
        model = get_model(params, device="meta")
    return {name: p.shape for name, p in model.named_parameters()}, model


def _refuse(what: str, names) -> None:
    names = sorted(names)
    if names:
        raise ValueError(f"{what} {names[:8]}{'...' if len(names) > 8 else ''} — "
                         "refusing a partial conversion")


def _check_names(state: Dict[str, torch.Tensor], shapes: Dict[str, torch.Size], what: str):
    _refuse(f"{what}: JAX leaves with no port parameter", set(state) - set(shapes))
    _refuse(f"{what}: port parameters with no JAX leaf", set(shapes) - set(state))
    _refuse(f"{what}: leaves of another shape than the port parameter",
            [k for k in shapes if tuple(state[k].shape) != tuple(shapes[k])])


def _optimizer_kind(params) -> str:
    opt_type = str(params.optimizer_type)
    if opt_type == "adam":
        return "adam"
    if opt_type in ("FusedLAMB", "lamb"):
        return "lamb"
    raise ValueError(f"optimizer type {opt_type} not implemented")


def _float32_tree(tree, where: str):
    for path, leaf in leaves(tree).items():
        if np.asarray(leaf).dtype != np.float32:
            raise ValueError(f"{where}/{path} is {np.asarray(leaf).dtype}, not float32")


def _check_learning_rate(lr: float, params, scheduler: Optional[dict], epoch: int,
                         step_in_epoch: int) -> None:
    """The injected learning rate against the scheduler state. The Trainer
    sets the scheduler's rate at each epoch's start and steps the scheduler
    after a completed epoch, before the save (a preempted save: not
    stepped), so a cosine state counts the checkpoint's epochs and a plateau
    state's rate is the injected one, or the injected one cut by its factor
    after a completed epoch. The cosine value itself depends on the saving
    run's ``max_epochs``, which a resume may change: it is held to (0, the
    base rate] only."""
    from swin_v2_weather_torch.training.optim import ReduceLROnPlateau

    scheduler = scheduler or {}
    problem = None
    if not 0.0 < lr <= max(float(params.lr), float(scheduler.get("lr", 0.0))) * (1 + 1e-6):
        problem = f"outside (0, {params.lr}]"
    elif "epoch" in scheduler and int(scheduler["epoch"]) != epoch:
        problem = f"the scheduler counts {scheduler['epoch']} epochs, the checkpoint {epoch}"
    elif "lr" in scheduler:
        factor = ReduceLROnPlateau(1.0).factor
        allowed = [scheduler["lr"]] if step_in_epoch else [scheduler["lr"],
                                                            scheduler["lr"] / factor]
        if not any(np.isclose(np.float32(a), np.float32(lr), rtol=1e-6, atol=0)
                   for a in allowed):
            problem = f"not the plateau scheduler's rate {allowed}"
    if problem:
        raise ValueError(f"the injected learning rate {lr} disagrees with the scheduler "
                         f"state {scheduler} at epoch {epoch}, step {step_in_epoch}: {problem}")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

_TOP = {"iters", "epoch", "step_in_epoch", "params", "opt_state", "scheduler"}


def _adam_state(inner, template, where: str):
    """The scale_by_adam node of ``inner``, which must have the skeleton
    ``template`` with no other leaf (None where ``template`` holds none)."""
    if template is None:
        _refuse(f"{where}: optimizer state leaves with no port counterpart",
                [f"{where}/{p}" for p in leaves(inner)])
        return None
    if template == ADAM:
        if not isinstance(inner, dict) or set(inner) != {"count", "mu", "nu"}:
            raise ValueError(f"{where}: not optax's scale_by_adam state {{count, mu, nu}}")
        return inner
    if not isinstance(inner, list) or len(inner) != len(template):
        raise ValueError(f"{where}: an optimizer state of another structure than optax's")
    found = None
    for n, (node, sub) in enumerate(zip(inner, template)):
        found = _adam_state(node, sub, f"{where}/{n}") or found
    return found


def checkpoint_from_jax(npz_dir: str, out_ckpt_dir: str, params) -> str:
    """Write the port checkpoint directory ``out_ckpt_dir`` (``checkpoint.pt``)
    from the neutral form of a JAX Trainer checkpoint, for the config
    ``params`` (its optimizer and model); either block layout."""
    from swin_v2_weather_torch.training.checkpoint import _write
    from swin_v2_weather_torch.training.optim import build_optimizer

    tree = read_tree(npz_dir)
    _refuse(f"{npz_dir}: top-level keys the port does not know", set(tree) - _TOP)
    _refuse(f"{npz_dir}: missing requested keys",
            {"iters", "epoch", "params", "opt_state"} - set(tree))
    shapes, model = _model_params(params)
    _float32_tree(tree["params"], "params")
    weights = params_from_jax(tree["params"])
    _check_names(weights, shapes, f"{npz_dir} params")

    opt = tree["opt_state"]
    kind = _optimizer_kind(params)
    if not isinstance(opt, dict) or set(opt) != {"count", "hyperparams", "hyperparams_states",
                                                 "inner_state"}:
        raise ValueError(f"{npz_dir}: opt_state is not optax's inject_hyperparams state")
    _refuse(f"{npz_dir}: injected hyperparameters the port does not know",
            set(opt["hyperparams"]) - {"learning_rate"})
    _refuse(f"{npz_dir}: hyperparameter states the port does not know",
            leaves(opt["hyperparams_states"]))
    adam = _adam_state(opt["inner_state"], INNER_STATES[kind], "opt_state/inner_state")
    if adam is None:
        raise ValueError(f"{npz_dir}: no scale_by_adam state for optimizer {kind}")
    for name in ("mu", "nu"):
        _float32_tree(adam[name], f"opt_state/.../{name}")
    moments = {name: params_from_jax(adam[name]) for name in ("mu", "nu")}
    for name, state in moments.items():
        _check_names(state, shapes, f"{npz_dir} opt_state {name}")

    iters = int(tree["iters"])
    counts = {int(opt["count"]), int(adam["count"])}
    if counts != {iters}:
        raise ValueError(f"{npz_dir}: optax counts {sorted(counts)} disagree with iters {iters}")
    epoch = int(tree["epoch"])
    step_in_epoch = int(tree.get("step_in_epoch", 0))
    scheduler = {k: float(v) for k, v in tree.get("scheduler", {}).items()} or None
    lr = float(np.float32(opt["hyperparams"]["learning_rate"]))
    _check_learning_rate(lr, params, scheduler, epoch, step_in_epoch)

    optimizer = build_optimizer(params, model.parameters())
    groups = optimizer.state_dict()["param_groups"]
    names = list(shapes)
    state = {}
    for idx, name in enumerate(names):
        step = torch.tensor(float(iters), dtype=torch.float32) if kind == "adam" else iters
        state[idx] = {"step": step, "exp_avg": moments["mu"][name],
                      "exp_avg_sq": moments["nu"][name]}
    for g in groups:
        g["lr"] = lr
    payload = {
        "iters": iters,
        "epoch": epoch,
        "step_in_epoch": step_in_epoch,
        "model": {name: weights[name] for name in names},
        "optimizer": {"state": state, "param_groups": groups},
    }
    if scheduler:
        payload["scheduler"] = scheduler
    _write(out_ckpt_dir, payload)
    return out_ckpt_dir


def _scan_blocks(params) -> bool:
    value = params.get("scan_blocks")
    return True if value is None else bool(value)


def checkpoint_to_jax(ckpt_dir: str, out_npz_dir: str, params) -> str:
    """Write the neutral form of the JAX Trainer checkpoint equivalent to the
    port checkpoint directory ``ckpt_dir``, in the block layout of
    ``params.scan_blocks`` (true where unset, as JAX's model factory)."""
    from swin_v2_weather_torch.training.checkpoint import CHECKPOINT_FILE

    payload = torch.load(os.path.join(ckpt_dir, CHECKPOINT_FILE), map_location="cpu",
                         weights_only=True)
    _refuse(f"{ckpt_dir}: missing requested keys",
            {"iters", "epoch", "model", "optimizer"} - set(payload))
    shapes, _ = _model_params(params)
    names = list(shapes)
    model_state = payload["model"]
    _check_names(model_state, shapes, f"{ckpt_dir} model")
    scan = _scan_blocks(params)
    kind = _optimizer_kind(params)

    opt = payload["optimizer"]
    indices = [i for g in opt["param_groups"] for i in g["params"]]
    if len(indices) != len(names):
        raise ValueError(f"{ckpt_dir}: the optimizer holds {len(indices)} parameters, the "
                         f"model {len(names)}")
    lrs = {float(g["lr"]) for g in opt["param_groups"]}
    if len(lrs) != 1:
        raise ValueError(f"{ckpt_dir}: parameter groups with different learning rates {lrs}")
    missing = [names[n] for n, i in enumerate(indices) if not opt["state"].get(i)]
    _refuse(f"{ckpt_dir}: port parameters with no optimizer state", missing)
    iters = int(payload["iters"])
    steps = {int(float(opt["state"][i]["step"])) for i in indices}
    if steps != {iters}:
        raise ValueError(f"{ckpt_dir}: optimizer step counts {sorted(steps)} disagree with "
                         f"iters {iters}")
    count = np.asarray(iters, np.int32)
    adam = {"count": count}
    for jax_name, port_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        adam[jax_name] = params_to_jax(
            {names[n]: opt["state"][i][port_name] for n, i in enumerate(indices)}, scan)

    def inner(template):
        if template == ADAM:
            return adam
        if template is None:
            return None
        return [inner(t) for t in template]

    tree = {
        "iters": count,
        "epoch": np.asarray(int(payload["epoch"])),
        "step_in_epoch": np.asarray(int(payload.get("step_in_epoch", 0))),
        "params": params_to_jax(model_state, scan),
        "opt_state": {
            "count": count,
            "hyperparams": {"learning_rate": np.asarray(lrs.pop(), np.float32)},
            "hyperparams_states": {},
            "inner_state": inner(INNER_STATES[kind]),
        },
    }
    if payload.get("scheduler"):
        tree["scheduler"] = {k: np.asarray(float(v)) for k, v in payload["scheduler"].items()}
    write_tree(tree, out_npz_dir)
    return out_npz_dir


# --------------------------------------------------------------------------
# registries
# --------------------------------------------------------------------------


def _registry_params(registry_dir: str):
    from swin_v2_weather_torch.inference.registry import _DictParams
    import yaml

    with open(os.path.join(registry_dir, "hyperparams.yaml")) as f:
        params = _DictParams(yaml.safe_load(f))
    params["n_future"] = 0  # serving's single-step core, as swin_from_yaml builds it
    return params


def _copy_registry_files(src: str, dst: str, skip) -> None:
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        if name not in skip and os.path.isfile(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def registry_from_jax(npz_dir_of_weights: str, jax_registry_dir: str, out_dir: str) -> str:
    """A port registry (``weights.pt`` and the JAX registry's other files:
    ``hyperparams.yaml``, statistics, ``metadata.json``) from a JAX registry
    whose orbax ``weights`` the bridge has written as ``npz_dir_of_weights``."""
    tree = read_tree(npz_dir_of_weights)
    _refuse(f"{npz_dir_of_weights}: keys other than params", set(tree) - {"params"})
    _float32_tree(tree["params"], "params")
    weights = params_from_jax(tree["params"])
    shapes, _ = _model_params(_registry_params(jax_registry_dir))
    _check_names(weights, shapes, f"{npz_dir_of_weights} params")
    _copy_registry_files(jax_registry_dir, out_dir, skip={"weights", "weights.pt"})
    torch.save({name: weights[name] for name in shapes}, os.path.join(out_dir, "weights.pt"))
    return out_dir


def registry_to_jax(registry_dir: str, out_npz_dir: str, jax_registry_dir: str) -> str:
    """The other direction: the neutral form of a port registry's weights
    (``{"params": tree}`` in the layout of its config's ``scan_blocks``, true
    where unset) for the bridge's ``from-npz`` into ``<jax_registry_dir>/
    weights``, and the registry's other files copied into
    ``jax_registry_dir``."""
    params = _registry_params(registry_dir)
    state = torch.load(os.path.join(registry_dir, "weights.pt"), map_location="cpu",
                       weights_only=True)
    shapes, _ = _model_params(params)
    _check_names(state, shapes, f"{registry_dir} weights.pt")
    write_tree({"params": params_to_jax(state, _scan_blocks(params))}, out_npz_dir)
    _copy_registry_files(registry_dir, jax_registry_dir, skip={"weights", "weights.pt"})
    return out_npz_dir
