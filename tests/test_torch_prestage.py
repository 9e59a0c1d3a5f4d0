"""PyTorch port, K13: the prestage probe's consumer (``ops/prestage.py``) and
the probe's layout moves (``swin_v2_weather_torch/scripts/prestage_probe.py``).

``consume_reference`` is held bit for bit to a ``pallas_call`` of the JAX
probe's ``_consume`` body (copied here: ``_consume`` is a closure inside the
JAX script's ``main()``, and ``scripts/prestage_probe.py`` stays as it is)
in interpret mode: there ``s0 + s1 + s2`` on bf16 rounds after each add, and
so does the plain version (``torch.sum(s, 0)``, which rounds once, differs).
The CUDA kernel is held bit for bit to the plain version on the GPU
(tests/test_torch_kernels.py, ``-m cuda``; chip_smoke.py phase 37).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swin_v2_weather_torch.ops import prestage
from swin_v2_weather_torch.scripts import prestage_probe as probe

torch.set_num_threads(1)


def _consume(s_ref, o_ref):  # the JAX probe's kernel body (scripts/prestage_probe.py)
    o_ref[...] = s_ref[0] + s_ref[1] + s_ref[2]


def jax_consume(s):
    return pl.pallas_call(_consume, out_shape=jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                          interpret=True)(s)


@pytest.mark.parametrize("shape", [(3, 1, 4, 2, 168, 16), (3, 2, 2, 8, 8, 96)])
def test_consume_reference_is_bit_exact_to_jax(shape):
    s = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_consume(jnp.asarray(s, jnp.bfloat16)), np.float32)
    ts = torch.from_numpy(s).bfloat16()
    got = prestage.consume_reference(ts)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # the entry point takes the plain version on a CPU tensor
    assert torch.equal(prestage.consume(ts), got)
    # one rounding (the library call) is another function at the bf16 level
    assert not torch.equal(torch.sum(ts, 0), got)


def test_consume_refuses_strided_and_misshaped_input():
    """A permuted view is refused (the probe must time a materialised
    prestage), as are a leading dim other than 3 and a non-bf16 tensor; the
    kernel is never reached from a CPU tensor."""
    s = torch.zeros((3, 2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        prestage.consume(s.permute(0, 2, 1, 3))
    with pytest.raises(ValueError):
        prestage.consume(s[:2])
    with pytest.raises(ValueError):
        prestage.consume(s.float())
    before = prestage.consume.launches
    prestage.consume(s)
    assert prestage.consume.launches == before


def test_probe_layout_moves_match_the_jax_probe():
    """prestage and unstage as the JAX script writes them: [B, H, W, 3C] ->
    [3, B, nW, heads, Lp, hd] (materialised, pad rows zero) and back; the
    round trip through consume gives q + k + v per channel, rounded as the
    kernel rounds."""
    b, h, w, c, heads, window, lp = 1, 18, 36, 64, 2, (9, 18), 168
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((b, h, w, 3 * c)).astype(np.float32)).bfloat16()
    s = probe.prestage(t, heads, window, lp)
    assert tuple(s.shape) == (3, b, 4, heads, lp, c // heads) and s.is_contiguous()
    assert torch.count_nonzero(s[..., 162:, :]) == 0
    # the JAX script's prestage, written out: reshape, transpose, pad
    ref = np.asarray(t.float().numpy()).reshape(b, 2, 9, 2, 18, 3, heads, c // heads)
    ref = ref.transpose(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, 4, heads, 162, c // heads)
    np.testing.assert_array_equal(s[..., :162, :].float().numpy(), ref)
    u = probe.unstage(prestage.consume(s), (h, w), window)
    want = (t[..., :c] + t[..., c:2 * c]) + t[..., 2 * c:]
    assert torch.equal(u, want)
    out = probe.chain(t, 2, heads=heads, window=window, lp=lp)
    assert out.shape == t.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())


def test_probe_bounds_and_cpu_refusal(monkeypatch):
    """The byte bounds the probe prints at the flagship shapes (consume 309.7
    MB read, 103.2 MB written: 0.123 ms at 3.35 TB/s); without a GPU the
    probe exits non-zero."""
    n = 3 * 1 * 400 * 8 * 168 * 96 * 2
    assert round(n / 1e6, 1) == 309.7 and round(n / 3 / 1e6, 1) == 103.2
    assert abs(probe.bound_ms(n + n / 3) - 0.123) < 5e-4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main()
    assert exc.value.code not in (0, None)
