"""PyTorch port, the training runtime on the GPU (``cuda`` marker; each test
skips without a CUDA device): the prefetch delivers batches bit-equal to the
host's while the compute stream is busy, and a micro Trainer run on the card
(the qkv-fused route: K1-K4 at micro size) round-trips its checkpoint and
resumes a preempted run bit for bit. Imports no JAX, so it runs on the H100
with ``python -m pytest --noconftest -m cuda tests/test_torch_trainer_cuda.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.pipeline import HostBatch, ThreadedLoader, cuda_prefetch
from swin_v2_weather_torch.data.synthetic import SyntheticDataset
from swin_v2_weather_torch.training import checkpoint as ckpt
from swin_v2_weather_torch.training.trainer import Trainer

MICRO = "swin_micro_test"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetch streams and the kernels run on the GPU")
    return torch.device("cuda")


class SyntheticParams(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def checksum(a: np.ndarray) -> int:
    """The fp32 bits summed as integers: exact, whatever the order."""
    return int(np.ascontiguousarray(a).view(np.int32).sum(dtype=np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
def test_cuda_prefetch_bit_equal_under_load(cuda_device, depth):
    """20 batches (73 channels on [180, 360], 19 MB each) through the pinned
    ring and the copy stream while matmuls keep the compute stream busy:
    each batch, checksummed on the consuming stream as it is handed out,
    equals the host batch the loader handed over."""
    p = SyntheticParams(dt=1, n_future=0, in_channels=list(range(73)),
                        out_channels=list(range(73)), img_size=[180, 360], add_zenith=True,
                        seed=5, n_synthetic_samples=20)
    loader = ThreadedLoader(SyntheticDataset(p), batch_size=1, num_workers=4,
                            prefetch_batches=2, pin_memory=True)
    host, device = [], []

    def tap(batches):
        for batch in batches:
            assert isinstance(batch, HostBatch) and batch.tensors["inp"].is_pinned()
            host.append({k: checksum(v) for k, v in batch.items()})
            yield batch

    busy = torch.randn(4096, 4096, device=cuda_device)
    last = None
    for dev_batch in cuda_prefetch(tap(iter(loader)), cuda_device, depth=depth):
        device.append({k: v.view(torch.int32).sum(dtype=torch.int64) for k, v in dev_batch.items()})
        for _ in range(6):
            busy = busy @ busy
            busy = busy / busy.norm()
        last = dev_batch
    torch.cuda.synchronize()
    assert len(host) == len(device) == 20
    for h, d in zip(host, device):
        assert h == {k: int(v) for k, v in d.items()}
    ref = SyntheticDataset(p)[int(loader._shard_indices()[-1])]
    for key, want in zip(("inp", "tar", "zen_inp", "zen_tar"), ref):
        assert torch.equal(last[key].cpu()[0], torch.from_numpy(want))
    loader.close()


def micro_params(root, **over):
    p = YParams(default_config_path(), MICRO)
    for key, val in dict(exp_dir=str(root), max_epochs=2, n_synthetic_samples=6, batch_size=2,
                         attn_impl="pallas_qkv", scan_blocks=False, drop_path_rate=0.3,
                         **over).items():
        p[key] = val
    return p


def states_equal(a, b):
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            states_equal(v, w)
        elif isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and v.device == w.device and torch.equal(v, w), k
        else:
            assert v == w, k


@pytest.mark.cuda
def test_micro_trainer_on_the_card(cuda_device, tmp_path):
    """Two epochs on the card, a checkpoint round trip through a resuming
    Trainer (weights, Adam's moments on the card, its step counts on the
    host), and a run preempted at step 2 that resumes to the uninterrupted
    run's parameters bit for bit (drop-path 0.3 from the device generator)."""
    ta = Trainer(micro_params(tmp_path / "a"), MICRO, run_num="t", device=cuda_device)
    ta.build_and_launch()
    with open(os.path.join(ta.params["experiment_dir"], "logs.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 2 and all(np.isfinite(line["valid_rmse_u10m"]) for line in lines)
    assert next(ta.model.parameters()).is_cuda

    again = Trainer(micro_params(tmp_path / "a"), MICRO, run_num="t", device=cuda_device)
    again.build()
    assert again.params["resuming"] and again.start_epoch == 2 and again.host_step == 6
    states_equal(again.model.state_dict(), ta.model.state_dict())
    states_equal(again.optimizer.state_dict()["state"], ta.optimizer.state_dict()["state"])
    step = next(iter(again.optimizer.state.values()))["step"]
    assert step.device.type == "cpu" and step.dtype == torch.float32
    assert ckpt.latest_checkpoint_exists(again.params["best_checkpoint_path"])

    class TriggerAfter:
        polls = 0

        @property
        def triggered(self):
            TriggerAfter.polls += 1
            return TriggerAfter.polls >= 2

        def install(self):
            return self

        def uninstall(self):
            pass

    tb = Trainer(micro_params(tmp_path / "b"), MICRO, run_num="t", device=cuda_device)
    tb.preempt = TriggerAfter()
    tb.build_and_launch()
    assert tb._preempted_at == 2
    tc = Trainer(micro_params(tmp_path / "b"), MICRO, run_num="t", device=cuda_device)
    tc.build()
    assert (tc.start_epoch, tc.resume_step_in_epoch, tc.host_step) == (0, 2, 2)
    tc.train()
    states_equal(tc.model.state_dict(), ta.model.state_dict())
