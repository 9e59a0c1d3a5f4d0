"""PyTorch port, the JAX checkpoint interchange (``training/interchange.py``
with ``orbax_bridge.py``), with Adam: JAX Trainer checkpoints of
``swin_micro_test`` in the scanned layout (``scan_blocks: true``, the
config's own) and in the unrolled one resume in the port, a port checkpoint
resumes in JAX, import followed by export gives every leaf back bit for bit
(also through orbax), a preempted JAX checkpoint resumes at the right batch,
registries convert both ways, and a missing or extra leaf raises. LAMB's
cases are in tests/test_torch_interchange_lamb.py, on this file's helpers.

Settings of tests/test_torch_trainer.py's JAX comparison: fp32,
``drop_path_rate: 0``, the JAX Trainer on a 1-device mesh; 2 steps and 2
validation batches per epoch. A resume is held to the other side's resume of
the same checkpoint at the bounds of ``test_trainer_matches_jax``
(``STEP_RTOL["float32"]`` for the loss and gradient norms, the eval step's
bounds for validation, ``PARAM_TOL["float32"]`` for the parameters).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbax_bridge
from swin_v2_weather_tpu.config.yparams import YParams as JaxYParams
from swin_v2_weather_tpu.inference import registry as jax_registry
from swin_v2_weather_tpu.parallel import mesh as jax_mesh
from swin_v2_weather_tpu.training import trainer as jax_trainer
from swin_v2_weather_torch.inference.registry import load_model
from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
from swin_v2_weather_torch.training import interchange as ic
from swin_v2_weather_torch.training.checkpoint import CHECKPOINT_FILE

from test_torch_trainer import MICRO, TriggerAfter, Trainer, logs, micro_yparams, state_equal
from test_torch_training import PARAM_TOL, STEP_RTOL, check_step_params

torch.set_num_threads(1)

DETERMINISTIC = dict(compute_dtype="float32", drop_path_rate=0.0, n_synthetic_samples=4,
                     batch_size=2, num_data_workers=2)


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    """The JAX Trainer on one device (under tests/conftest.py's 8 virtual
    devices its loss would be scaled by 1/8), as test_trainer_matches_jax."""
    mp = pytest.MonkeyPatch()
    make_mesh = jax_mesh.make_mesh
    mp.setattr(jax_trainer, "make_mesh",
               lambda params: make_mesh(params, devices=jax.devices()[:1]))
    yield
    mp.undo()


def port_params(root, optimizer, scan, **over):
    return micro_yparams(root, optimizer_type=optimizer, scan_blocks=scan,
                         **{**DETERMINISTIC, **over})


def ckpt_dir(root):
    return os.path.join(str(root), MICRO, "t", "training_checkpoints", "ckpt")


def run_jax(root, optimizer, scan, max_epochs, preempt=None):
    p = micro_yparams(root, JaxYParams, optimizer_type=optimizer, scan_blocks=scan,
                      **{**DETERMINISTIC, "max_epochs": max_epochs})
    t = jax_trainer.Trainer(p, MICRO, "t")
    t.preempt = preempt
    t.build()
    t.train()
    return t


def run_port(root, optimizer, scan, max_epochs, checkpoint=None):
    """The port Trainer, resuming from the port checkpoint ``checkpoint``
    where one is given."""
    if checkpoint is not None:
        shutil.copytree(checkpoint, ckpt_dir(root))
    t = Trainer(port_params(root, optimizer, scan, max_epochs=max_epochs), MICRO, "t",
                device="cpu")
    t.build()
    assert t.params["resuming"] == (checkpoint is not None)
    t.train()
    return t


def unrolled(tree):
    """A JAX parameter tree in the unrolled layout (an exact conversion)."""
    return params_to_jax(params_from_jax(tree))


def assert_trees_bit_equal(a_dir, b_dir):
    """Two neutral trees: the same skeleton, every leaf of the same dtype,
    shape and bits."""
    skeletons = []
    for d in (a_dir, b_dir):
        with open(os.path.join(d, ic.TREE_JSON)) as f:
            skeletons.append(json.load(f)["tree"])
    assert skeletons[0] == skeletons[1]
    a, b = ic.leaves(ic.read_tree(a_dir)), ic.leaves(ic.read_tree(b_dir))
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def assert_epoch_matches(port_line, jax_line, port_model, jax_params, start, lr):
    """One epoch's logged metrics and the parameters after it, port against
    JAX, at the bounds of test_trainer_matches_jax."""
    loss_rtol, norm_rtol = STEP_RTOL["float32"]
    assert port_line["epoch"] == jax_line["epoch"] and port_line["lr"] == jax_line["lr"]
    port_line = dict(port_line)
    if "grad_norm/pairs" in jax_line:
        # the scanned layout logs one norm over the stacked blocks
        blocks = [k for k in port_line if k.startswith("grad_norm/block")]
        port_line["grad_norm/pairs"] = float(np.sqrt(sum(port_line.pop(k) ** 2 for k in blocks)))
    assert set(port_line) == set(jax_line)
    for key, want in jax_line.items():
        if key.endswith("_time") or key.startswith("step_time"):
            continue  # wall clocks
        if key.startswith("valid_"):
            np.testing.assert_allclose(port_line[key], want, rtol=2e-3, atol=1e-4, err_msg=key)
        elif key == "loss" or key.startswith("grad_norm"):
            rtol = loss_rtol if key == "loss" else norm_rtol
            assert port_line[key] == pytest.approx(want, rel=rtol), key
    check_step_params(unrolled(jax.tree.map(np.asarray, jax_params)), port_model,
                      unrolled(start), lr, *PARAM_TOL["float32"])


def interchange_run(root, optimizer, scan):
    """The JAX Trainer's epoch 1, its checkpoint through ``to-npz``, the JAX
    Trainer's own resume for epoch 2, and the port's resume of the imported
    checkpoint for epoch 2."""
    run_jax(root / "jax", optimizer, scan, max_epochs=1)
    npz1 = str(root / "npz1")
    orbax_bridge.main(["to-npz", ckpt_dir(root / "jax"), npz1])
    jax_resumed = run_jax(root / "jax", optimizer, scan, max_epochs=2)
    assert jax_resumed.start_epoch == 1
    imported = str(root / "imported")
    ic.checkpoint_from_jax(npz1, imported, port_params(root / "port", optimizer, scan))
    port = run_port(root / "port", optimizer, scan, max_epochs=2, checkpoint=imported)
    assert port.start_epoch == 1 and port.resume_step_in_epoch == 0
    return dict(root=root, optimizer=optimizer, scan=scan, npz1=npz1, imported=imported,
                jax=jax_resumed, port=port)


@pytest.fixture(scope="module", params=[True, False], ids=["scanned", "unrolled"])
def adam(request, tmp_path_factory):
    layout = "scanned" if request.param else "unrolled"
    return interchange_run(tmp_path_factory.mktemp(f"adam_{layout}"), "adam", request.param)


def check_import_resume(run):
    """The port's resume of the imported checkpoint against JAX's own resume:
    epoch 2's logged metrics and the parameters after it."""
    (line,) = logs(run["root"] / "port")
    assert_epoch_matches(line, logs(run["root"] / "jax")[-1], run["port"].model,
                         run["jax"].state.params, ic.read_tree(run["npz1"])["params"],
                         float(run["port"].params.lr))
    assert run["port"].host_step == int(run["jax"].state.step) == 4


def check_round_trip(run):
    """Import followed by export: the same tree as ``to-npz`` wrote, bit for
    bit; and again after an orbax save and restore of the export."""
    params = port_params(run["root"], run["optimizer"], run["scan"])
    back = str(run["root"] / "npz_back")
    ic.checkpoint_to_jax(run["imported"], back, params)
    assert_trees_bit_equal(run["npz1"], back)
    orbax_bridge.main(["from-npz", back, str(run["root"] / "orbax_back")])
    orbax_bridge.main(["to-npz", str(run["root"] / "orbax_back"), str(run["root"] / "npz_2")])
    assert_trees_bit_equal(run["npz1"], str(run["root"] / "npz_2"))


def check_export_resume(run):
    """The port's epoch-2 checkpoint, exported in the config's layout and
    written by ``from-npz``, restores in the JAX Trainer with its template;
    JAX's epoch 3 from it against the port's own resume."""
    root, optimizer, scan = run["root"], run["optimizer"], run["scan"]
    npz2 = str(root / "npz2")
    ic.checkpoint_to_jax(ckpt_dir(root / "port"), npz2, port_params(root, optimizer, scan))
    # imported back under a config of more epochs (the cosine rate of the
    # saving run's max_epochs differs): the port's own checkpoint, bit for bit
    back = str(root / "reimported")
    ic.checkpoint_from_jax(npz2, back, port_params(root, optimizer, scan, max_epochs=3))
    own, got = (torch.load(os.path.join(d, CHECKPOINT_FILE), weights_only=True)
                for d in (ckpt_dir(root / "port"), back))
    for group in got["optimizer"]["param_groups"]:
        assert group.pop("lr") == pytest.approx(own["optimizer"]["param_groups"][0]["lr"],
                                                rel=1e-7)
    for group in own["optimizer"]["param_groups"]:
        group.pop("lr")
    state_equal(got, own)
    orbax_bridge.main(["from-npz", npz2, ckpt_dir(root / "jax_from_port")])
    jax_resumed = run_jax(root / "jax_from_port", optimizer, scan, max_epochs=3)
    assert jax_resumed.start_epoch == 2 and jax_resumed.host_step == 6
    port = run_port(root / "port3", optimizer, scan, max_epochs=3,
                    checkpoint=ckpt_dir(root / "port"))
    (jax_line,) = logs(root / "jax_from_port")
    (port_line,) = logs(root / "port3")
    assert_epoch_matches(port_line, jax_line, port.model, jax_resumed.state.params,
                         ic.read_tree(npz2)["params"], float(port.params.lr))


def test_import_resumes_like_jax(adam):
    check_import_resume(adam)


def test_import_export_round_trip_bit_exact(adam):
    check_round_trip(adam)


@pytest.mark.parametrize("adam", [True], ids=["scanned"], indirect=True)
def test_export_resumes_in_jax(adam):
    check_export_resume(adam)


@pytest.mark.parametrize("adam", [True], ids=["scanned"], indirect=True)
def test_preempted_jax_checkpoint_resumes_at_its_batch(adam):
    """A JAX checkpoint saved at step 1 of epoch 0 (``step_in_epoch: 1``):
    the port skips the consumed batch and ends epoch 0 where the JAX run
    that was not preempted did (JAX's own resume of such a checkpoint is
    bit-equal to that run: tests/test_training.py::TestPreemption)."""
    root = adam["root"]
    jax_pre = run_jax(root / "jax_pre", "adam", True, max_epochs=1, preempt=TriggerAfter(1))
    assert jax_pre._preempted_at == 1
    npz = str(root / "npz_pre")
    orbax_bridge.main(["to-npz", ckpt_dir(root / "jax_pre"), npz])
    tree = ic.read_tree(npz)
    assert int(tree["step_in_epoch"]) == 1 and int(tree["epoch"]) == 0
    imported = str(root / "imported_pre")
    ic.checkpoint_from_jax(npz, imported, port_params(root, "adam", True))
    t = Trainer(port_params(root / "port_pre", "adam", True, max_epochs=1), MICRO, "t",
                device="cpu")
    shutil.copytree(imported, ckpt_dir(root / "port_pre"))
    t.build()
    assert t.start_epoch == 0 and t.resume_step_in_epoch == 1 and t.host_step == 1
    t.train()
    assert t.host_step == 2
    check_step_params(unrolled(ic.read_tree(adam["npz1"])["params"]), t.model,
                      unrolled(tree["params"]), float(t.params.lr), *PARAM_TOL["float32"])


@pytest.mark.parametrize("adam", [True], ids=["scanned"], indirect=True)
def test_registry_converts_both_ways(adam):
    """JAX registry -> port registry: the port serves the JAX weights (the
    forward within the CLI tests' fp32 bounds of JAX's); port registry ->
    JAX registry: JAX's ``load_model`` gets the same weights bit for bit."""
    root = adam["root"]
    jreg = str(root / "jax_registry")
    jax_registry.export_model(os.path.join(str(root / "jax"), MICRO, "t"), jreg)
    orbax_bridge.main(["to-npz", os.path.join(jreg, "weights"), str(root / "npz_reg")])
    preg = str(root / "port_registry")
    ic.registry_from_jax(str(root / "npz_reg"), jreg, preg)
    assert sorted(os.listdir(preg)) == sorted(
        n if n != "weights" else "weights.pt" for n in os.listdir(jreg))

    model, params = load_model(preg, "cpu")
    jmodel, variables, _ = jax_registry.load_model(jreg)
    x = np.random.default_rng(0).standard_normal(
        (1, int(params["n_in_channels"]), 24, 48)).astype(np.float32)
    with torch.no_grad():
        served = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(served, ref, rtol=1e-3, atol=1e-3)

    jreg2 = str(root / "jax_registry_back")
    ic.registry_to_jax(preg, str(root / "npz_reg_back"), jreg2)
    orbax_bridge.main(["from-npz", str(root / "npz_reg_back"), os.path.join(jreg2, "weights")])
    assert_trees_bit_equal(str(root / "npz_reg"), str(root / "npz_reg_back"))
    _, variables2, _ = jax_registry.load_model(jreg2)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(variables["params"]),
                                 jax.tree_util.tree_leaves_with_path(variables2["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    for name in ("hyperparams.yaml", "metadata.json"):
        with open(os.path.join(jreg, name)) as f, open(os.path.join(jreg2, name)) as g:
            assert f.read() == g.read()


def edited(src, dst, edit):
    tree = ic.read_tree(src)
    edit(tree)
    ic.write_tree(tree, dst)
    return dst


EDITS = {
    "missing param": (lambda t: t["params"]["model"].pop("pos_embed"),
                      "port parameters with no JAX leaf"),
    "extra param": (lambda t: t["params"]["model"].update(extra={"kernel": np.zeros(
        (2, 2), np.float32)}), "JAX leaves with no port parameter"),
    "missing moment": (lambda t: t["opt_state"]["inner_state"][0]["nu"]["model"].pop(
        "pos_embed"), "port parameters with no JAX leaf"),
    "extra optimizer leaf": (lambda t: t["opt_state"]["inner_state"].__setitem__(
        1, {"trace": np.zeros(3, np.float32)}), "leaves with no port counterpart"),
    "missing opt_state": (lambda t: t.pop("opt_state"), "missing requested keys"),
    "foreign learning rate": (lambda t: t["opt_state"]["hyperparams"].update(
        learning_rate=np.asarray(0.123, np.float32)), "disagrees with the scheduler"),
    "foreign scheduler epoch": (lambda t: t["scheduler"].update(epoch=np.asarray(5.0)),
                                "disagrees with the scheduler"),
}


@pytest.mark.parametrize("adam", [True], ids=["scanned"], indirect=True)
@pytest.mark.parametrize("case", list(EDITS))
def test_partial_or_foreign_import_raises(adam, case, tmp_path):
    edit, message = EDITS[case]
    src = edited(adam["npz1"], str(tmp_path / "npz"), edit)
    with pytest.raises(ValueError, match=message):
        ic.checkpoint_from_jax(src, str(tmp_path / "out"),
                               port_params(tmp_path, "adam", True))
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("adam", [True], ids=["scanned"], indirect=True)
def test_partial_export_raises(adam, tmp_path):
    """A port checkpoint short of a weight, or of a parameter's optimizer
    state, does not export."""
    from swin_v2_weather_torch.training.checkpoint import _write

    payload = torch.load(os.path.join(adam["imported"], CHECKPOINT_FILE), weights_only=True)
    params = port_params(tmp_path, "adam", True)
    short = {**payload, "model": dict(payload["model"])}
    short["model"].pop("model.pos_embed")
    _write(str(tmp_path / "short"), short)
    with pytest.raises(ValueError, match="port parameters with no JAX leaf"):
        ic.checkpoint_to_jax(str(tmp_path / "short"), str(tmp_path / "npz"), params)
    no_state = {**payload, "optimizer": {**payload["optimizer"],
                                         "state": dict(payload["optimizer"]["state"])}}
    no_state["optimizer"]["state"].pop(0)
    _write(str(tmp_path / "no_state"), no_state)
    with pytest.raises(ValueError, match="no optimizer state"):
        ic.checkpoint_to_jax(str(tmp_path / "no_state"), str(tmp_path / "npz"), params)
