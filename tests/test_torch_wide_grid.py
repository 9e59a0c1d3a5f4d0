"""PyTorch port, K8/K9 at head dims 128 and 256: the grid (``attn_impl:
'pallas'``) and windowed (``'pallas_v1'``) attention at the e2048 family's
widths.

On the card, K8/K9's forward is one streamed kernel at head dims 32-256 and
any L (q rows of a block staged, k and v through a ring), whose shared memory
does not grow with L beyond a table of L words. So is each one's backward:
the streamed kernels of ``csrc/streamed_bwd.cuh`` (K8 form FORM_GRID, K9
form FORM_V1), a rows and a columns kernel of 8 warps with the streamed
side through a ring, whose shared memory grows with L only by its token
table and its row statistics. The tables here pin the bytes, the blocks per
(window, head) and the kernel each wrapper picks, computed from the same
formulas as the CUDA sources; head dims no kernel takes raise.

On the CPU the plain versions run at any head dim: at 128 and 256 they are
held to the JAX grid and windowed kernels (interpret mode; JAX's kernels have
no head-dim limit) at a small window (L = 12), forward and gradients, with
the bias and the shift mask, in bf16. Tolerances: those of
tests/test_torch_grid_attention.py (``GRAD_ULPS``), in bf16 ulps of each
output's scale -- both sides keep the TPU kernels' rounding sites, so they
differ only where an fp32 sum in another order flips one bf16 rounding. The
CUDA kernels are held to these plain versions on the GPU
(tests/test_torch_kernels.py, ``-m cuda``, and chip_smoke.py phases 33-34).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_grid_attention import GRAD_ULPS
from test_torch_kernels import assert_close_ulps

torch.set_num_threads(1)

FWD_96_162, FWD_128_162, FWD_256_162, FWD_128_256, FWD_256_12 = (76432, 96912, 100496, 97280,
                                                                  78384)
# (head dim, L) -> bytes of the (forward, backward) kernels' shared memory
# (the streamed forward; the streamed backward's larger kernel, K8's form)
# and the kernel each direction takes
ATTN_SMEM_TABLE = {
    (96, 162): ((FWD_96_162, 79568), ("streamed", "streamed")),
    (128, 162): ((FWD_128_162, 100048), ("streamed", "streamed")),
    (256, 162): ((FWD_256_162, 181968), ("streamed", "streamed")),
    (128, 256): ((FWD_128_256, 101376), ("streamed", "streamed")),
    (256, 12): ((FWD_256_12, 121072), ("streamed", "streamed")),
}


@pytest.mark.parametrize("hd, l", list(ATTN_SMEM_TABLE))
def test_attn_variant_table(hd, l):
    (fwd, bwd), variants = ATTN_SMEM_TABLE[hd, l]
    sm = wa.attn_smem_bytes(hd, l)
    assert (sm["fwd"], max(sm["streamed_rows"], sm["streamed_cols"])) == (fwd, bwd)
    assert (wa.attn_variant("t", hd, l, False), wa.attn_variant("t", hd, l, True)) == variants
    assert sm["fwd"] <= 232448  # the forward fits
    assert bwd <= 232448  # the backward's kernels fit


def test_attn_variant_large_bytes_at_e2048():
    """Head dim 256, L = 162: 100,496 B for the forward (two blocks an SM),
    175,792 / 181,968 B for the rows and columns kernels of K8's large-head
    backward and 175,136 / 181,344 B for K9's (the streamed kernels: 8 warps,
    one block an SM; K9's slabs need no token table)."""
    sm = wa.attn_smem_bytes(256, 162)
    assert sm["fwd"] == wa.attn_smem_bytes(256, 162, "v1")["fwd"] == FWD_256_162
    assert (sm["streamed_rows"], sm["streamed_cols"]) == (175792, 181968)
    sm1 = wa.attn_smem_bytes(256, 162, "v1")
    assert (sm1["streamed_rows"], sm1["streamed_cols"]) == (175136, 181344)
    assert 2 * (sm["fwd"] + 1024) <= 233472  # two blocks (and their reserve) fit the SM


# (head dim, L) -> K8's streamed rows and columns kernels' shared memory
STREAMED_SMEM = {(128, 162): (93872, 100048), (256, 162): (175792, 181968),
                 (128, 256): (94240, 101376), (256, 224): (176032, 182784)}


@pytest.mark.parametrize("hd, l", list(STREAMED_SMEM))
def test_attn_streamed_backward_bytes(hd, l):
    """K8's streamed backward (``csrc/streamed_bwd.cuh``, three row
    statistics) at head dims 128 and 256: its shared memory fits two blocks
    an SM at head dim 128 and one at 256 (8 warps either way), does not grow
    with L but for its tables, and 'streamed' is chosen at every L."""
    sm = wa.attn_smem_bytes(hd, l)
    assert (sm["streamed_rows"], sm["streamed_cols"]) == STREAMED_SMEM[hd, l]
    per_sm = 233472 // (max(sm["streamed_rows"], sm["streamed_cols"]) + 1024)
    assert per_sm == (2 if hd == 128 else 1)
    assert wa.attn_variant("t", hd, l, True) == "streamed"
    assert wa.streamed_bwd_plan(hd, l, grid=True)["threads"] == 256


# (head dim, L, backward) -> the kernel that takes it, or None where none does
VARIANT_CASES = {(96, 256, False): "streamed", (64, 256, True): "streamed",
                 (192, 162, True): None, (256, 256, True): "streamed", (48, 12, False): None}


@pytest.mark.parametrize("hd, l, backward", list(VARIANT_CASES))
def test_attn_variant_refuses_what_no_kernel_takes(hd, l, backward):
    """Every shape the wrappers let through has a kernel whose shared memory
    fits; the others raise a ValueError before any launch. Both directions
    take L = 256 and 264 here at head dims 32/64/96/128/256, never 48 or
    192: the streamed kernels take every head dim at every such L, and the
    backward refuses a window only where its tables would outgrow shared
    memory (head dim 256 past L = 3,328 on the grid)."""
    want = VARIANT_CASES[hd, l, backward]
    if want is None:
        with pytest.raises(ValueError):
            wa.attn_variant("t", hd, l, backward)
    else:
        assert wa.attn_variant("t", hd, l, backward) == want
        sm = wa.attn_smem_bytes(hd, l)
        assert (max(sm["streamed_rows"], sm["streamed_cols"]) if backward else sm["fwd"]) <= 232448
    assert wa.attn_variant("t", 64, 264, backward) == "streamed"
    if backward:
        assert wa.attn_variant("t", 256, 3328, backward) == "streamed"
        with pytest.raises(ValueError, match="shared memory"):
            wa.attn_variant("t", 256, 3329, backward)
    else:
        assert wa.attn_fwd_plan(64, 264)["smem"] == wa.attn_smem_bytes(64, 264)["fwd"] <= 232448


# (head dim, L) -> K9's streamed rows and columns kernels' shared memory
# (csrc/streamed_bwd.cuh, form FORM_V1: three row statistics, no token
# table) and the blocks an SM their shared memory allows
V1_STREAMED = {(96, 162): (72736, 78944, 2), (128, 162): (93216, 99424, 2),
               (256, 162): (175136, 181344, 1), (128, 256): (93216, 100384, 2),
               (256, 256): (175136, 182304, 1)}


@pytest.mark.parametrize("hd, l", list(V1_STREAMED))
def test_v1_streamed_backward_plan(hd, l):
    """K9's backward takes the streamed kernels at every head dim (K8 its
    own streamed form): 8 warps a block, one block per 64 rows of a (window, head)
    (one d(scale) partial each), the bytes the CUDA source computes -- K8's
    form's less its token table, and in the columns kernel the warps'
    d(scale) sums (32 B) in its place. Registers allow the rows kernel one
    block an SM at L = 162 and the columns kernel two up to head dim 128
    (``streamed_bwd_info`` on the card)."""
    rows, cols, per_sm = V1_STREAMED[hd, l]
    plan = wa.streamed_bwd_plan(hd, l, v1=True)
    sm = wa.attn_smem_bytes(hd, l, "v1")
    assert (plan["rows_smem"], plan["cols_smem"]) == (sm["streamed_rows"], sm["streamed_cols"])
    assert (plan["rows_smem"], plan["cols_smem"]) == (rows, cols)
    lp = -(-l // 16) * 16
    assert plan["threads"] == 256 and plan["nchunk"] == wa._row_chunks("streamed", lp)
    assert 233472 // (max(rows, cols) + 1024) == per_sm
    assert wa.attn_variant("t", hd, l, True, "v1") == "streamed"
    assert wa.attn_variant("t", hd, l, True, "grid") == "streamed"
    table = (l + 3) // 4 * 16
    grid = wa.streamed_bwd_plan(hd, l, grid=True)
    assert (grid["rows_smem"] - rows, grid["cols_smem"] - cols) == (table, table - 32)


# (layout, head dim, L) -> (rows kernel bytes, columns kernel bytes, blocks
# per (window, head), blocks an SM the shared memory allows): K8's form
# (three row statistics, a token table) at the head dims its one-block and
# chunked kernels took before, and both forms past L = 256
STREAMED_PLANS = {("grid", 32, 162): (32432, 38608, 3, 5), ("grid", 64, 162): (52912, 59088, 3, 3),
                  ("grid", 96, 162): (73392, 79568, 3, 2), ("grid", 96, 288): (73888, 81408, 5, 2),
                  ("grid", 256, 288): (176288, 183808, 5, 1),
                  ("grid", 96, 576): (75040, 86016, 9, 2), ("v1", 96, 288): (72736, 80288, 5, 2),
                  ("v1", 256, 288): (175136, 182688, 5, 1)}


@pytest.mark.parametrize("layout, hd, l", list(STREAMED_PLANS))
def test_streamed_backward_plan_every_head_dim_and_l(layout, hd, l):
    """The streamed backward's launch where the one-block and chunked
    kernels ran before: 8 warps a block (at L = 288, 18 tiles in five blocks
    of at most four), one d(scale) partial a block (``_row_chunks``), the
    bytes the CUDA source computes; the shared memory of K8's kernels at
    head dims up to
    96 allows the two blocks an SM their launch bounds ask for, and grows
    with L (here from L = 64, the same four tiles a block) only by the token
    table (4 B a row) and the row statistics (12 B a row)."""
    rows, cols, nchunk, per_sm = STREAMED_PLANS[layout, hd, l]
    plan = wa.streamed_bwd_plan(hd, l, grid=layout == "grid", v1=layout == "v1")
    assert (plan["rows_smem"], plan["cols_smem"], plan["nchunk"]) == (rows, cols, nchunk)
    lp = -(-l // 16) * 16
    assert plan["threads"] == 256 and plan["rt"] * nchunk >= lp // 16 > (plan["rt"] - 1) * nchunk
    assert nchunk == wa._row_chunks("streamed", lp)
    assert 233472 // (max(rows, cols) + 1024) == per_sm
    assert wa.attn_variant("t", hd, l, True, layout) == "streamed"
    short = wa.streamed_bwd_plan(hd, 64, grid=layout == "grid", v1=layout == "v1")  # rt 4 too
    table = -(-l // 4) * 16 - 256 if layout == "grid" else 0  # the token table's growth
    assert rows - short["rows_smem"] == table
    assert cols - short["cols_smem"] == 12 * (lp - 64) + table


def test_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 6, 8, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_grid(q, q, q, torch.ones(2), (3, 4))
    qw = torch.zeros((4, 2, 12, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_v1_bwd(qw, qw, qw, torch.ones(2), qw, (2, 2))


# --------------------------------------------------------------------------
# K8/K9's plain versions at head dims 128 and 256 against JAX
# --------------------------------------------------------------------------

B, H, W, HEADS = 1, 6, 8, 2
WINDOW = (3, 4)
GRID = (H // WINDOW[0], W // WINDOW[1])
L = WINDOW[0] * WINDOW[1]


def operands(hd, layout, seed=7):
    """bf16-valued q, k, v and g (grid [B, H, W, C] or windowed [B * nW,
    heads, L, hd]), scale, raw bias and the shift mask."""
    rng = np.random.default_rng(seed)
    c = HEADS * hd
    shape = (B, H, W, c) if layout == "grid" else (B * GRID[0] * GRID[1], HEADS, L, hd)
    q, k, v, g = (np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16), np.float32)
                  for _ in range(4))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, L, L)) * 0.5).astype(np.float32)
    patt = make_shift_mask((H, W), WINDOW, (1, 2))[-1]
    return q, k, v, g, scale, bias, patt


@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("hd", [128, 256])
def test_wide_plain_versions_match_jax(layout, hd):
    """The port's entry point (K8's or K9's plain versions and, for K8, the
    normalization and its VJP around them) against JAX's at head dim ``hd``,
    with the raw bias and the shift mask: the output, dq, dk, dv, dscale and
    dbias (jax.vjp of the custom_vjp, the backward kernel interpreted)."""
    q, k, v, g, scale, bias, patt = operands(hd, layout)
    jargs = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)] + [jnp.asarray(scale),
                                                                  jnp.asarray(bias)]
    leaves = [torch.from_numpy(t).bfloat16().requires_grad_() for t in (q, k, v)]
    leaves += [torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    if layout == "grid":
        out_ref, vjp = jax.vjp(lambda q_, k_, v_, s_, b_: jax_wa.fused_window_attention_grid(
            q_, k_, v_, s_, WINDOW, bias=b_, mask_pattern=patt), *jargs)
        out = wa.fused_window_attention_grid(*leaves[:4], WINDOW, bias=leaves[4],
                                             mask_pattern=patt)
    else:
        out_ref, vjp = jax.vjp(lambda q_, k_, v_, s_, b_: jax_wa.fused_window_attention(
            q_, k_, v_, s_, bias=b_, mask_pattern=patt, window_grid=GRID), *jargs)
        out = wa.fused_window_attention(*leaves[:4], bias=leaves[4], mask_pattern=patt,
                                        window_grid=GRID)
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == q.shape
    assert_close_ulps(out.detach().float().numpy(), np.asarray(out_ref, np.float32), 1, 0.01)
    for name, leaf, r in zip(("dq", "dk", "dv", "dscale", "dbias"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype, name
        assert_close_ulps(leaf.grad.float().numpy(), np.asarray(r, np.float32), *GRAD_ULPS[name])


WIN288 = (12, 24)  # L = 288: the streamed backward past KEEP_L = 192 on the card


@pytest.mark.parametrize("layout", ["grid", "windowed"])
def test_window_288_plain_versions_match_jax(layout):
    """At L = 288 (window 12 x 24, two windows of two heads of 32) the port's
    K8 and K9 entry points against JAX's, with the raw bias and the shift
    mask: the output and every gradient (bounds as at head dims 128/256);
    the streamed backward takes the shape on the card."""
    rng = np.random.default_rng(8)
    h, w, heads, hd, grid = 12, 48, 2, 32, (1, 2)
    l = WIN288[0] * WIN288[1]
    shape = (1, h, w, heads * hd) if layout == "grid" else (2, heads, l, hd)
    q, k, v, g = (np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16), np.float32)
                  for _ in range(4))
    scale = np.exp(rng.standard_normal(heads) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((heads, l, l)) * 0.5).astype(np.float32)
    patt = make_shift_mask((h, w), WIN288, (6, 12))[-1]
    jargs = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)] + [jnp.asarray(scale),
                                                                  jnp.asarray(bias)]
    leaves = [torch.from_numpy(t).bfloat16().requires_grad_() for t in (q, k, v)]
    leaves += [torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    assert wa.attn_variant("t", hd, l, True) == "streamed"
    if layout == "grid":
        out_ref, vjp = jax.vjp(lambda q_, k_, v_, s_, b_: jax_wa.fused_window_attention_grid(
            q_, k_, v_, s_, WIN288, bias=b_, mask_pattern=patt), *jargs)
        out = wa.fused_window_attention_grid(*leaves[:4], WIN288, bias=leaves[4],
                                             mask_pattern=patt)
    else:
        out_ref, vjp = jax.vjp(lambda q_, k_, v_, s_, b_: jax_wa.fused_window_attention(
            q_, k_, v_, s_, bias=b_, mask_pattern=patt, window_grid=grid), *jargs)
        out = wa.fused_window_attention(*leaves[:4], bias=leaves[4], mask_pattern=patt,
                                        window_grid=grid)
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    out.backward(torch.from_numpy(g).bfloat16())
    assert_close_ulps(out.detach().float().numpy(), np.asarray(out_ref, np.float32), 1, 0.01)
    for name, leaf, r in zip(("dq", "dk", "dv", "dscale", "dbias"), leaves, ref):
        assert_close_ulps(leaf.grad.float().numpy(), np.asarray(r, np.float32), *GRAD_ULPS[name])
