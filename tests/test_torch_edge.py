"""The port's edge stack against the JAX package's, bit for bit.

Same numpy inputs through ``magnify_tpu.ops.edge`` / ``pallas_kernels`` and
``magnify_tpu_torch.ops.edge`` / ``hysteresis``; every comparison is exact
(``assert_array_equal``): the stack is integer math or single f32 ops in
the reference's order. The JAX functions run under ``jax.jit``, as the
detector runs them (XLA then fuses the quantile interpolation into an FMA,
which the port reproduces). The Pallas hysteresis runs as the JAX
package's own tests run it on the CPU (interpret mode). The CUDA
hysteresis computes the fixpoint as ``F & (the 8-connected component of F
holds a strong pixel)``, ``F = weak | strong``; that form, computed here
with ``scipy.ndimage.label``, is held against both Pallas kernels and the
plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from magnify_tpu.ops import edge as jedge
from magnify_tpu.ops.pallas_kernels import hysteresis as pallas_hysteresis
from magnify_tpu_torch.ops import detect as tdetect
from magnify_tpu_torch.ops import edge as tedge
from magnify_tpu_torch.ops import hysteresis as thyst
from tests.synth import draw_beads

QS = (np.float32(0.1), np.float32(0.9))
_jax_quantiles = jax.jit(jedge.histogram_quantiles)


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _planes():
    """Random uint8 planes of ~96x160, plus one plane with many ties."""
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (96, 160)).astype(np.uint8)
              for _ in range(2)]
    ties = np.repeat(np.repeat(rng.integers(0, 4, (12, 20)), 8, 0), 8, 1)
    planes.append((ties * 60).astype(np.uint8))
    return planes


def _bead_plane(shape=(128, 160)):
    img = draw_beads(shape, [[40, 40], [40, 110], [90, 70]], diameters=20)
    img = img + np.random.default_rng(5).normal(100, 5, shape).astype(
        np.uint16)
    return tdetect.normalize_planes_u8(img[None])[0]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("idx", range(3))
def test_blur_scharr_quantiles_nms_match(idx):
    u8 = _planes()[idx]
    jb = jedge.gaussian_blur5_u8(jnp.asarray(u8))
    tb = tedge.gaussian_blur5_u8(_t(u8))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())

    jdx, jdy = jedge.scharr(jb)
    tdx, tdy = tedge.scharr(tb)
    np.testing.assert_array_equal(np.asarray(jdx), tdx.numpy())
    np.testing.assert_array_equal(np.asarray(jdy), tdy.numpy())

    grad = np.asarray(jnp.sqrt(jdx * jdx + jdy * jdy))
    np.testing.assert_array_equal(grad, tedge.sqrt_f32(tdx * tdx + tdy * tdy))
    for qs in (QS, (np.float32(0.0), np.float32(1.0)),
               (np.float32(0.37), np.float32(0.73))):
        jq = _jax_quantiles(jnp.asarray(grad), jnp.asarray(qs, jnp.float32))
        tq = tedge.histogram_quantiles(_t(grad), qs)
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())

    jlo, jhi = _jax_quantiles(jnp.asarray(grad), jnp.asarray(QS, jnp.float32))
    lo, hi = tedge.histogram_quantiles(_t(grad), QS)
    js, jw = jedge.canny_nms(jdx, jdy, jlo, jhi)
    ts, tw = tedge.canny_nms(tdx, tdy, lo, hi)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_quantile_interpolation_rounds_like_the_jitted_reference():
    """1,000 random draws: the jitted reference interpolates with one FMA,
    and two-rounding arithmetic misses it on a few of these (5 here)."""
    rng = np.random.default_rng(21)
    for _ in range(1000):
        v = (rng.random(1001) * 1000).astype(np.float32)
        qs = rng.random(2).astype(np.float32)
        want = np.asarray(_jax_quantiles(jnp.asarray(v), jnp.asarray(qs)))
        got = tedge.histogram_quantiles(_t(v), qs).numpy()
        np.testing.assert_array_equal(want, got)


def test_edge_pipeline_matches_on_bead_plane():
    u8 = _bead_plane()
    je, jdx, jdy, _ = jax.jit(
        lambda x: jedge.edge_pipeline(x, 0.1, 0.9, normalized=True))(
            jnp.asarray(u8))
    te, tdx, tdy = tedge.edge_pipeline(_t(u8), 0.1, 0.9)
    np.testing.assert_array_equal(np.asarray(jdx), tdx.numpy())
    np.testing.assert_array_equal(np.asarray(jdy), tdy.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    assert te.sum() > 0


def test_normalize_planes_u8_matches():
    from magnify_tpu.ops.detect import normalize_planes_u8

    rng = np.random.default_rng(2)
    planes = rng.integers(0, 4000, (3, 40, 50)).astype(np.uint16)
    planes[2] = 7  # a flat plane: peak 0
    np.testing.assert_array_equal(tdetect.normalize_planes_u8(planes),
                                  normalize_planes_u8(planes))


def _xla_fixpoint(s, w):
    def cond(state):
        return state[1]

    def body(state):
        cur, _ = state
        grown = jedge.dilate8(cur) & w | cur
        return grown, jnp.any(grown != cur)

    return jax.lax.while_loop(cond, body, (s, jnp.asarray(True)))[0]


def test_hysteresis_plain_matches_pallas_whole_plane():
    rng = np.random.default_rng(12)
    strong = rng.random((64, 128)) > 0.97
    weak = strong | (rng.random((64, 128)) > 0.7)
    want = np.asarray(pallas_hysteresis(jnp.asarray(strong),
                                        jnp.asarray(weak)))
    got = thyst.hysteresis(_t(strong), _t(weak))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(_xla_fixpoint)(jnp.asarray(strong),
                                          jnp.asarray(weak))),
        thyst.hysteresis_plain(_t(strong), _t(weak)).numpy())


def _serpentine():
    img = np.zeros((96, 150), bool)
    img[5, 10:140] = True      # top H run
    img[5:90, 140] = True      # long V run down
    img[90, 20:141] = True     # bottom H run back
    img[20:91, 20] = True      # V run back up
    strong = np.zeros_like(img)
    strong[5, 10] = True
    return strong, img


@pytest.mark.parametrize("tile_rows", [8, 16, 48])
def test_hysteresis_plain_matches_pallas_tiled(tile_rows):
    rng = np.random.default_rng(12)
    strong = rng.random((100, 150)) > 0.99
    weak = strong | (rng.random((100, 150)) > 0.65)
    want = np.asarray(pallas_hysteresis(jnp.asarray(strong),
                                        jnp.asarray(weak),
                                        tile_rows=tile_rows))
    got = thyst.hysteresis(_t(strong), _t(weak), tile_rows=tile_rows)
    np.testing.assert_array_equal(want, got.numpy())

    strong2, chain = _serpentine()
    want2 = np.asarray(pallas_hysteresis(jnp.asarray(strong2),
                                         jnp.asarray(chain),
                                         tile_rows=tile_rows))
    got2 = thyst.hysteresis(_t(strong2), _t(chain), tile_rows=tile_rows)
    np.testing.assert_array_equal(want2, got2.numpy())
    assert got2.sum() == chain.sum()  # the whole chain lights up


def test_hysteresis_plain_matches_xla_dilate_loop():
    rng = np.random.default_rng(4)
    for shape in ((33, 47), (128, 96)):
        strong = rng.random(shape) > 0.98
        weak = strong | (rng.random(shape) > 0.6)
        want = np.asarray(jax.jit(_xla_fixpoint)(jnp.asarray(strong),
                                                 jnp.asarray(weak)))
        got = thyst.hysteresis_plain(_t(strong), _t(weak))
        np.testing.assert_array_equal(want, got.numpy())


def _component_form(strong, weak):
    """``F & (the 8-connected component of F holds a strong pixel)``."""
    f = strong | weak
    lab, _ = ndimage.label(f, structure=np.ones((3, 3), int))
    seeded = np.unique(lab[strong])
    return f & np.isin(lab, seeded[seeded > 0])


def _hysteresis_case(case):
    rng = np.random.default_rng(31)
    if case == "serpentine":
        return _serpentine()
    if case == "strong outside weak":
        strong = rng.random((90, 140)) > 0.985
        weak = rng.random((90, 140)) > 0.62
        assert (strong & ~weak).any()
        return strong, weak
    shape = {"random 100x150": (100, 150), "random 257x131": (257, 131)}[case]
    strong = rng.random(shape) > 0.99
    return strong, strong | (rng.random(shape) > 0.65)


@pytest.mark.parametrize("case", ["random 100x150", "random 257x131",
                                  "serpentine", "strong outside weak"])
def test_hysteresis_component_form_matches_pallas_and_plain(case):
    strong, weak = _hysteresis_case(case)
    want = _component_form(strong, weak)
    assert want.any() and not want.all()
    for tile_rows in (None, 16):
        got = pallas_hysteresis(jnp.asarray(strong), jnp.asarray(weak),
                                tile_rows=tile_rows)
        np.testing.assert_array_equal(want, np.asarray(got),
                                      err_msg=f"tile_rows={tile_rows}")
    np.testing.assert_array_equal(
        want, thyst.hysteresis_plain(_t(strong), _t(weak)).numpy())


# ----------------------------------------------------------------------
# A batch of planes (the chip path's per-chamber crops)
# ----------------------------------------------------------------------

def _roi_batch():
    """Five 48 x 52 uint16 crops: buttons on noise, a dim one, a constant
    plane (peak 0 after the min is taken) and pure noise."""
    rng = np.random.default_rng(21)
    rois = rng.normal(300, 12, (5, 48, 52)).astype(np.uint16)
    rois[0] += draw_beads((48, 52), [[24, 26]], diameters=14)
    rois[1] += draw_beads((48, 52), [[20, 30]], diameters=18) // 8
    rois[2] += draw_beads((48, 52), [[30, 14], [12, 40]], diameters=10)
    rois[3] = 77
    return rois


@pytest.mark.parametrize("normalized", [False, True])
def test_batched_edge_pipeline_matches_per_plane_and_vmap(normalized):
    """(N, H, W) through the port == the port plane by plane == the JAX
    package under ``jax.vmap`` (as ``_detect_rois_dense`` runs it), with
    per-plane normalization and per-plane quantiles. Exact."""
    rois = _roi_batch()
    if normalized:
        rois = tdetect.normalize_planes_u8(rois)
    want = jax.jit(jax.vmap(lambda x: jedge.edge_pipeline(
        x, 0.1, 0.95, normalized=normalized)[:3]))(
            jnp.asarray(rois.astype(np.float32)))
    got = tedge.edge_pipeline(_t(rois.astype(np.float32)), 0.1, 0.95,
                              normalized=normalized)
    for k in range(len(rois)):
        one = tedge.edge_pipeline(_t(rois[k].astype(np.float32)), 0.1, 0.95,
                                  normalized=normalized)
        for a, b in zip(got, one):
            assert torch.equal(a[k], b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[0][0].sum() > 0 and got[0][3].sum() == 0


def test_normalize_to_u8_matches_per_plane():
    rois = _roi_batch()
    want = jax.jit(jax.vmap(jedge.normalize_to_u8))(jnp.asarray(rois))
    got = tedge.normalize_to_u8(_t(rois.astype(np.float32)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        got.numpy(), tdetect.normalize_planes_u8(rois).astype(np.float32))
    assert torch.equal(tedge.normalize_to_u8(_t(rois[1].astype(np.float32))),
                       got[1])


def test_batched_quantiles_are_per_plane():
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 50, (6, 31, 17)).astype(np.float32)
    vals[2] = np.round(vals[2] / 40)  # many ties
    got = tedge.histogram_quantiles(_t(vals), QS, batched=True)
    assert got.shape == (2, 6)
    for k in range(6):
        want = _jax_quantiles(jnp.asarray(vals[k]), jnp.asarray(QS))
        np.testing.assert_array_equal(np.asarray(want), got[:, k].numpy())
        assert torch.equal(tedge.histogram_quantiles(_t(vals[k]), QS),
                           got[:, k])


def test_hysteresis_plain_batch_grows_planes_apart():
    """The batched plain twin == plane by plane == the XLA dilate loop under
    vmap, on widths that are no multiple of 4 or 128; and a batch whose
    planes would join if rows ran on from one plane into the next."""
    rng = np.random.default_rng(8)
    strong = rng.random((6, 40, 72)) < 0.01
    weak = strong | (rng.random((6, 40, 72)) < 0.4)
    got = thyst.hysteresis(_t(strong), _t(weak))
    want = jax.jit(jax.vmap(_xla_fixpoint))(jnp.asarray(strong),
                                            jnp.asarray(weak))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for k in range(6):
        assert torch.equal(got[k], thyst.hysteresis_plain(_t(strong[k]),
                                                          _t(weak[k])))
    strong = np.zeros((4, 24, 17), bool)
    weak = np.zeros_like(strong)
    strong[0::2, -1, :] = True
    weak[0::2, -1, :] = True
    weak[1::2, 0:3, :] = True
    got = thyst.hysteresis(_t(strong), _t(weak)).numpy()
    assert not got[1::2].any() and got[0::2, -1].all()
