"""The port's device meshes (``magnify_tpu_torch.parallel.mesh`` and
``multihost``) on CPU meshes, against the port without a mesh and against
the JAX package.

A CPU mesh names the CPU several times (``make_mesh(2, 4, devices=["cpu"] *
8)``), as the JAX package's tests run on 8 virtual CPU devices. Held here:
the halo exchange against a padded plane (both fills); the sharded edge
stack against the port's ``edge_pipeline`` and, in-process, against the
JAX package's jitted ``sharded_edge_pipeline`` on conftest's 8 virtual
devices (2 x 96 x 128 with ``valid_h`` 91 and a serpentine weak chain that
crosses every band boundary), ``edges``, ``dx`` and ``dy`` exact; the
sharded hysteresis against ``hysteresis_plain`` at 1-4 bands; the sharded
dense detection against ``ops.detect.detect_dense`` on every (batch, space)
factorization of 8 and the oversharded-rows error; RANSAC with the
proposals split over the mesh against one device (``num_iter`` 20,001, not
a multiple of 8, and an empty plane) and the slice form of the sampler
against the whole stream; ``beads``, ``mrbles`` and ``microfluidic_chip``
under ``use_mesh`` against the port without one, exactly, and against the
JAX package's single-chip outputs (refined chambers exact, blank ones
within ``GRID_ATOL``); the out-of-core x mesh branch; ``find_circles_stack``;
``stream_planes`` with a mesh; the multihost skeleton in one process; and
a two-process gloo run (each process detects its own planes and matches its
local single-device run; counts and RANSAC's proposal union cross the
processes).

The JAX references come from ONE subprocess for the file (this file run as
a script) with ``MAGNIFY_TPU_SCORE_QUANT=int8`` and the detector named, as
in test_torch_slice.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_chip as tchip  # noqa: E402
import test_torch_slice as tslice  # noqa: E402

torch.set_num_threads(1)

#: Tolerance (pixels) of a blank chamber's grid intersection, as in
#: test_torch_chip.
GRID_ATOL = tchip.GRID_ATOL
BEAD_CASES = ("two_channel", "mrbles")
CHIP_CASES = ("3x3_blanks",)
JAX_CASES = BEAD_CASES + CHIP_CASES  # "2ch2t" runs against the port only
RANSAC_ITER = 20001  # not a multiple of the mesh's 8 devices
RANSAC_KW = dict(low_edge_quantile=0.1, high_edge_quantile=0.9,
                 grid_length=16, min_radius=5, max_radius=14,
                 min_roundness=0.25, min_dist=8, seed=1)
STACK_KW = dict(low_edge_quantile=0.1, high_edge_quantile=0.9, min_radius=4,
                max_radius=8, min_roundness=0.2, min_dist=4)


def cpu_mesh(batch, space):
    from magnify_tpu_torch.parallel import make_mesh

    return make_mesh(batch, space, devices=["cpu"] * (batch * space))


def _disks(shape, discs, seed, noise=5.0, base=100.0):
    from magnify_tpu_torch.utils import filled_circle_points

    rng = np.random.default_rng(seed)
    img = rng.normal(base, noise, shape).astype(np.float32)
    for r, c, rad, value in discs:
        pts = filled_circle_points(rad)
        img[pts[:, 0] + r, pts[:, 1] + c] = value
    return img


def ransac_plane():
    """The JAX package's mesh RANSAC fixture: four discs on noise."""
    img = _disks((192, 160), [], 3, noise=6.0, base=30.0)
    from magnify_tpu_torch.utils import filled_circle_points

    for (r, c, rad) in [(40, 50, 9), (100, 90, 12), (150, 30, 7),
                        (60, 130, 10)]:
        pts = filled_circle_points(rad)
        img[pts[:, 0] + r, pts[:, 1] + c] += 140
    return img


def stack_planes():
    return np.stack([_disks((96, 128), [(30, 40, 6, 900), (60, 90, 7, 900)],
                            k) for k in range(4)])


def serpentine_plane(seed, h=91, w=128, passes=3):
    """A weak chain that runs down and up the plane ``passes`` times (so it
    crosses every band boundary of 4 bands ``passes`` times). It fades
    from bright to dim over its first 40 rows, so only its start is strong
    at a high Canny quantile of 0.998."""
    rng = np.random.default_rng(seed)
    img = rng.normal(60, 1.5, (h, w)).astype(np.float32)
    rows = np.arange(3, h - 3)
    cols = list(range(8, 8 + 16 * passes, 16))
    for k, c in enumerate(cols):
        along = k * len(rows) + (rows - 3 if k % 2 == 0 else h - 4 - rows)
        fade = 14 + 30 * np.clip(1 - along / 40, 0, 1)
        img[3:h - 3, c:c + 2] += fade[:, None].astype(np.float32)
        if k + 1 < len(cols):
            r = h - 5 if k % 2 == 0 else 3
            img[r:r + 2, c:cols[k + 1] + 2] += 14
    return img


def serpentine_batch():
    """Two 91-row planes with 5 rows of REFLECT_101 padding appended, as
    the mesh detector pads them for 4 bands."""
    planes = np.stack([serpentine_plane(0), serpentine_plane(1)[::-1]])
    return np.concatenate([planes, planes[:, 85:90][:, ::-1]], 1)


# ----------------------------------------------------------------------
# The JAX references (one subprocess)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_parallel_ref") / "ref.npz"
    env = dict(os.environ, MAGNIFY_TPU_SCORE_QUANT="int8",
               MAGNIFY_TPU_DETECTOR="dense", JAX_PLATFORMS="cpu",
               MAGNIFY_TPU_CACHE_DIR=os.path.join(ROOT, ".cache", "test_xla"))
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, os.path.abspath(__file__), "reference",
                    str(path)], env=env, cwd=ROOT, check=True, timeout=600)
    return dict(np.load(path))


def _write_reference(path):
    import magnify_tpu as mg
    from magnify_tpu.ops.detect import find_circles, find_circles_stack

    out = {}
    for case in BEAD_CASES:
        out.update(tslice.flatten(tslice.run_case(mg, case), case))
    for case in CHIP_CASES:
        out.update(tslice.flatten(tchip.run_case(mg, case), case))
    for k, (c, s) in enumerate(find_circles_stack(stack_planes(),
                                                  **STACK_KW)):
        out[f"stack/{k}/circles"], out[f"stack/{k}/scores"] = c, s
    os.environ["MAGNIFY_TPU_DETECTOR"] = "ransac"
    os.environ["MAGNIFY_TPU_SCORER"] = "gather"
    c, s = find_circles(ransac_plane(), detector="ransac",
                        num_iter=RANSAC_ITER, **RANSAC_KW)
    out["ransac/circles"], out["ransac/scores"] = c, s
    np.savez(path, **out)


# ----------------------------------------------------------------------
# Mesh, halo, edges, hysteresis
# ----------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    from magnify_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"batch": 1, "space": 8} and mesh.size == 8
    mesh2 = cpu_mesh(2, 4)
    assert mesh2.shape == {"batch": 2, "space": 4}
    assert mesh2.devices.shape == (2, 4)
    assert make_mesh(batch=4, devices=["cpu"] * 8).shape["space"] == 2
    with pytest.raises(ValueError, match="device count"):
        make_mesh(batch=3, space=3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        # No card: no mesh, never a silent CPU one.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("boundary,mode", [("zero", "constant"),
                                           ("reflect", "reflect")])
@pytest.mark.parametrize("halo", [1, 2, 5])
def test_exchange_halo(boundary, mode, halo):
    """Band s with its halo is rows s*L - halo .. (s+1)*L + halo of the
    whole plane padded with zeros or REFLECT_101 (numpy's "reflect")."""
    from magnify_tpu_torch.parallel.mesh import _exchange_halo

    plane = np.random.default_rng(halo).normal(0, 1, (2, 24, 10))
    bands = [torch.as_tensor(b) for b in np.split(plane, 4, axis=1)]
    padded = np.pad(plane, ((0, 0), (halo, halo), (0, 0)), mode=mode)
    for s, got in enumerate(_exchange_halo(bands, halo, boundary)):
        np.testing.assert_array_equal(got.numpy(),
                                      padded[:, s * 6:s * 6 + 6 + 2 * halo])


def test_sharded_edges_match_port_and_jax(monkeypatch):
    """The sharded edge stack, with rows past ``valid_h`` masked and a weak
    chain crossing every band boundary three times, equals the port's
    single-plane edge stack and the JAX package's jitted sharded one."""
    from magnify_tpu.parallel.mesh import make_mesh as jmake_mesh
    from magnify_tpu.parallel.mesh import sharded_edge_pipeline as jsharded
    from magnify_tpu_torch.ops.edge import edge_pipeline
    from magnify_tpu_torch.parallel import mesh as tmesh

    if len(jax.devices()) < 8:
        pytest.skip("needs conftest's 8 virtual CPU devices")
    rounds = []
    real_rounds = tmesh._hysteresis_rounds

    def count_rounds(*args):
        edges, n = real_rounds(*args)
        rounds.append(n)
        return edges, n

    monkeypatch.setattr(tmesh, "_hysteresis_rounds", count_rounds)
    batch = serpentine_batch()
    edges, dx, dy = tmesh.sharded_edge_pipeline(batch, cpu_mesh(2, 4), 0.5,
                                                0.998, valid_h=91)
    # The chain crosses 3 band boundaries on each of its 3 passes.
    assert len(rounds) == 1 and rounds[0] >= 9
    for k in range(2):
        want = edge_pipeline(torch.as_tensor(batch[k, :91]), 0.5, 0.998,
                             normalized=False)
        for got, ref in zip((edges, dx, dy), want):
            assert torch.equal(got[k, :91], ref)
    assert int(edges[0].sum()) > 400
    jmesh = jmake_mesh(batch=2, space=4)
    run = jax.jit(lambda x: jsharded(x, jmesh, 0.5, 0.998, valid_h=91))
    for got, ref in zip((edges, dx, dy), run(jnp.asarray(batch))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _serpentine_masks():
    chain = np.zeros((2, 45, 60), bool)
    for k, c in enumerate(range(3, 57, 6)):
        chain[0, 2:43, c] = True
        if c + 6 < 57:
            chain[0, 42 if k % 2 == 0 else 2, c:c + 7] = True
    chain[1] = np.random.default_rng(5).random((45, 60)) < 0.4
    strong = np.zeros_like(chain)
    strong[0, 2, 3] = True
    strong[1] = np.random.default_rng(6).random((45, 60)) < 0.01
    return torch.as_tensor(strong), torch.as_tensor(chain | strong)


@pytest.mark.parametrize("space", [1, 2, 3, 4])
def test_sharded_hysteresis_matches_plain(space):
    """Two planes over (2, space): a serpentine that crosses each band
    boundary nine times, and random masks; 45 rows, padded to the bands."""
    from magnify_tpu_torch.ops.hysteresis import hysteresis_plain
    from magnify_tpu_torch.parallel.mesh import sharded_hysteresis

    strong, weak = _serpentine_masks()
    got, rounds = sharded_hysteresis(strong, weak, cpu_mesh(2, space))
    want = hysteresis_plain(strong, weak)
    assert torch.equal(got, want)
    assert int(got[0].sum()) == int(weak[0].sum())  # the whole chain
    assert rounds >= (1 if space == 1 else 9)
    one, _r = sharded_hysteresis(strong[1], weak[1], cpu_mesh(1, space))
    assert torch.equal(one, want[1])


# ----------------------------------------------------------------------
# Dense detection
# ----------------------------------------------------------------------

def _detect_planes(h=192):
    return np.stack([
        _disks((h, 224), [(50, 60, 8, 1000), (120, 150, 8, 1000),
                          (160, 60, 8, 1000)], 11),
        _disks((h, 224), [(40, 40, 9, 800), (100, 180, 7, 900)], 12)])


@pytest.mark.parametrize("batch,space", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_find_circles_batch_geometries(batch, space):
    """Every factorization of 8, 2 planes (cyclically padded to the batch
    axis) of 190 rows (reflect-padded to the bands): each plane equals
    ``detect_dense`` on one device, circles and scores."""
    from magnify_tpu_torch.ops import detect
    from magnify_tpu_torch.parallel import sharded_find_circles_batch

    planes = _detect_planes(190)
    args = (0.1, 0.9, 0.3)
    kw = dict(min_radius=6, max_radius=10, min_dist=6)
    got = sharded_find_circles_batch(planes, cpu_mesh(batch, space), *args,
                                     **kw)
    assert len(got) == 2
    for plane, (c, s) in zip(planes, got):
        wc, ws = detect.detect_dense(torch.as_tensor(plane), *args,
                                     normalized=False, **kw)
        assert torch.equal(c, wc) and torch.equal(s, ws)
    assert len(got[0][0]) == 3 and len(got[1][0]) >= 2


def test_sharded_detector_rejects_oversharded_rows():
    from magnify_tpu_torch.parallel import sharded_find_circles_batch

    tiny = np.zeros((1, 64, 64), np.float32)  # 8 rows a band < 2R halo
    with pytest.raises(ValueError, match="halo"):
        sharded_find_circles_batch(tiny, cpu_mesh(1, 8), 0.1, 0.9, 0.3,
                                   min_radius=6, max_radius=10, min_dist=6)


def test_sharded_detect_step_finds_the_best_circle():
    from magnify_tpu_torch.parallel import sharded_detect_step

    planes = np.stack([_disks((64, 128), [(30, 70, 6, 1000)], 1, noise=0),
                       _disks((64, 128), [(50, 40, 7, 1000)], 2, noise=0)])
    out = sharded_detect_step(planes, cpu_mesh(2, 4), min_radius=4,
                              max_radius=8, min_roundness=0.2)
    assert torch.isfinite(out["best_score"]).all()
    assert out["best_circle"].tolist() == [[30, 70, 6], [50, 40, 7]]
    assert out["edges"].shape == (2, 64, 128)
    assert out["edge_count"].tolist() == out["edges"].sum((1, 2)).tolist()


def test_find_circles_stack_on_mesh(reference):
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.parallel import use_mesh

    planes = stack_planes()
    want = mt.ops.find_circles_stack(planes, **STACK_KW, device="cpu")
    with use_mesh(cpu_mesh(2, 4)):
        got = mt.ops.find_circles_stack(planes, **STACK_KW, device="cpu")
    assert len(got) == len(want) == 4
    for k, ((c, s), (wc, ws)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(c, reference[f"stack/{k}/circles"])
        np.testing.assert_array_equal(s, reference[f"stack/{k}/scores"])


# ----------------------------------------------------------------------
# RANSAC
# ----------------------------------------------------------------------

def test_candidate_slices_equal_the_whole_stream():
    from magnify_tpu_torch.ops import prng
    from magnify_tpu_torch.ops.ransac import candidate_circles

    edges = torch.as_tensor(
        np.random.default_rng(2).random((40, 50)) < 0.1)
    key = prng.prng_key(3)
    whole, _ = candidate_circles(edges, 8, 100, key)
    part, _ = candidate_circles(edges, 8, 100, key,
                                start=torch.tensor([0, 40, 90]), count=10)
    sel = np.r_[0:10, 40:50, 90:100]
    for w, p in zip(whole, part):
        assert torch.equal(w[sel], p)
    with pytest.raises(ValueError, match="leave"):
        candidate_circles(edges, 8, 100, key, start=torch.tensor([95]),
                          count=10)


def test_mesh_ransac_matches_one_device(reference, monkeypatch):
    """The proposals split over 8 devices (the last slice clamped) give the
    one-device result and the JAX package's; an edge-free plane gives
    nothing; above the raster limit find_circles stays on one device and
    the mesh function refuses."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.ops import score
    from magnify_tpu_torch.parallel import mesh as tmesh
    from magnify_tpu_torch.parallel import use_mesh
    from magnify_tpu_torch.parallel.mesh import sharded_ransac_find_circles

    monkeypatch.delenv("MAGNIFY_TPU_DETECTOR", raising=False)
    monkeypatch.delenv("MAGNIFY_TPU_SCORER", raising=False)
    img = ransac_plane()
    kw = dict(RANSAC_KW, detector="ransac", num_iter=RANSAC_ITER,
              device="cpu")
    want = mt.ops.find_circles(img, **kw)
    mesh = cpu_mesh(2, 4)
    with use_mesh(mesh):
        got = mt.ops.find_circles(img, **kw)
        flat = mt.ops.find_circles(np.full((96, 128), 50.0, np.float32),
                                   **dict(kw, num_iter=8000))
    for g, w, r in zip(got, want, ("circles", "scores")):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, reference[f"ransac/{r}"])
    assert len(got[0]) >= 3 and len(flat[0]) == 0
    monkeypatch.setattr(score, "RASTER_KEY_LIMIT", 1000)
    with pytest.raises(ValueError, match="raster dedupe"):
        sharded_ransac_find_circles(
            img, mesh, 0.1, 0.9, grid_length=16, num_iter=1000, min_radius=5,
            max_radius=14, min_roundness=0.25, min_dist=8)
    small = dict(kw, num_iter=1000)
    alone = mt.ops.find_circles(img, **small)
    monkeypatch.setattr(tmesh, "ransac_on_mesh", None)  # never reached
    with use_mesh(mesh):
        kept = mt.ops.find_circles(img, **small)
    for g, w in zip(kept, alone):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# The pipelines under use_mesh
# ----------------------------------------------------------------------

def _assert_same(got, want, chip_tag=None):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        if chip_tag is not None and key.endswith(("/x", "/y")):
            refined = np.broadcast_to(chip_tag != "", val.shape)
            np.testing.assert_array_equal(got[key][refined], val[refined],
                                          err_msg=key)
            np.testing.assert_allclose(got[key][~refined], val[~refined],
                                       rtol=0, atol=GRID_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", JAX_CASES + ("2ch2t",))
def test_pipelines_on_mesh_match(reference, case):
    """``beads``, ``mrbles`` and ``microfluidic_chip`` under a (2, 4) CPU
    mesh equal the port without one in every variable, and the JAX
    package's single-chip outputs."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.parallel import use_mesh

    chip = case not in BEAD_CASES
    run = tchip.run_case if chip else tslice.run_case
    want = tslice.flatten(run(mt, case, device="cpu"), case)
    with use_mesh(cpu_mesh(2, 4)):
        got = tslice.flatten(run(mt, case, device="cpu"), case)
    _assert_same(got, want)
    if case in JAX_CASES:
        ref = {k: v for k, v in reference.items()
               if k.startswith(case + "/")}
        _assert_same(got, ref, got[f"{case}/tag"] if chip else None)


def test_out_of_core_on_mesh(monkeypatch):
    """A lazy stack above MAX_RESIDENT_BYTES under a mesh: its search planes
    normalized one at a time, streamed onto the mesh's bands and detected
    as ONE batch over the mesh; marks, masks and crops equal the in-memory
    run."""
    import magnify_tpu_torch as mt
    from magnify_tpu_torch.components import find
    from magnify_tpu_torch.core import lazy
    from magnify_tpu_torch.core.lazy import ChunkedArray
    from magnify_tpu_torch.parallel import use_mesh

    h, w = 96, 160
    truth = {0: [(30, 40, 7, 1000), (60, 110, 7, 1000)],
             1: [(40, 80, 7, 1000)]}

    def plane(ci, t):
        rng = np.random.default_rng(10 * ci + t)
        return (_disks((h, w), truth[ci], 0, noise=0.0, base=0.0)
                * (1.0 + 0.1 * t) + rng.normal(0, 3, (h, w))
                ).astype(np.float32)

    full = np.stack([[plane(c, t) for t in range(2)] for c in range(2)])
    lazy_stack = ChunkedArray(lambda idx: plane(idx[0], idx[1])[None, None],
                              shape=(2, 2, h, w), dtype=np.float32,
                              chunks=(1, 1, h, w))
    kw = dict(overlap=0, min_bead_diameter=10, max_bead_diameter=18,
              num_iter=2000, min_roundness=0.2, detector="dense",
              device="cpu")
    dims = ("channel", "time", "y", "x")
    mesh = cpu_mesh(2, 4)
    with use_mesh(mesh):
        ref = mt.beads(mt.DataArray(full, dims=dims), **kw)
    calls = []
    real = find.BeadFinder.detect_planes

    def spy(self, planes):
        calls.append([(type(p).__name__, len(p.bands), p.height)
                      for p in planes])
        return real(self, planes)

    monkeypatch.setattr(find.BeadFinder, "detect_planes", spy)
    monkeypatch.setattr(find, "MAX_RESIDENT_BYTES", 1)
    monkeypatch.setattr(lazy, "RESIDENT_BYTES_LIMIT", 1)
    with use_mesh(mesh):
        got = mt.beads(mt.DataArray(lazy_stack, dims=dims), **kw)
    # Both search planes streamed onto the mesh's bands, one batch.
    assert calls == [[("PlaneBands", 4, h)] * 2]
    assert got.roi.sizes["mark"] == ref.roi.sizes["mark"] == 3
    for name in ("x", "y", "fg", "bg", "roi"):
        np.testing.assert_array_equal(np.asarray(got[name].values),
                                      np.asarray(ref[name].values))


@pytest.mark.parametrize("h", [64, 190])
def test_stream_planes_on_mesh(h):
    """Each streamed plane arrives as its row bands on one batch row's
    devices, REFLECT_101-padded where the bands do not divide it; a list
    of them is a batch the mesh detector takes as it is, with the result
    of the whole stack."""
    from magnify_tpu_torch.core import Dataset
    from magnify_tpu_torch.parallel import (sharded_find_circles_batch,
                                            stream_planes)

    planes = _detect_planes(h) if h > 64 else np.arange(
        2 * 64 * 16, dtype=np.float32).reshape(2, 64, 16)
    data = np.stack([planes, planes[::-1]], axis=1)  # (channel, time, H, W)
    ds = Dataset({"image": (("channel", "time", "im_y", "im_x"), data)})
    mesh = cpu_mesh(2, 4)
    local = {64: 16, 190: 49}[h]  # 190 rows reflect-padded by 6
    seen = {}
    for key, plane in stream_planes(ds, depth=2, device="cpu", mesh=mesh):
        assert plane.height == h
        assert [tuple(b.shape) for b in plane.bands] == (
            [(local, data.shape[-1])] * 4)
        whole = torch.cat(plane.bands).numpy()
        np.testing.assert_array_equal(whole[:h], data[key])
        np.testing.assert_array_equal(whole[h:], data[key][h - 2::-1][
            :whole.shape[0] - h])
        seen[key] = plane
    assert len(seen) == 4
    if h == 64:
        return
    kw = dict(min_radius=6, max_radius=10, min_dist=6)
    streamed = sharded_find_circles_batch(list(seen.values()), mesh, 0.1,
                                          0.9, 0.3, **kw)
    stacked = sharded_find_circles_batch(data.reshape(4, h, -1), mesh, 0.1,
                                         0.9, 0.3, **kw)
    assert len(streamed) == 4 and len(stacked[0][0]) == 3
    for (c, sc), (wc, ws) in zip(streamed, stacked):
        assert torch.equal(c, wc) and torch.equal(sc, ws)


# ----------------------------------------------------------------------
# Several processes
# ----------------------------------------------------------------------

def test_multihost_skeleton_single_process():
    """One process: key sharding is the identity, the hosts-outer mesh
    builds, and the detector takes the global stack with one-device
    results."""
    from magnify_tpu_torch.ops import detect
    from magnify_tpu_torch.parallel import (host_shard_keys,
                                            make_global_stack, multihost_mesh,
                                            sharded_find_circles_batch)

    keys = [("c0", t) for t in range(6)]
    assert host_shard_keys(keys) == keys
    assert host_shard_keys(keys, 1, 3) == keys[2:4]
    with pytest.raises(ValueError, match="out of range"):
        host_shard_keys(keys, 3, 3)
    with pytest.raises(ValueError, match="multiple of the host count"):
        host_shard_keys(keys[:5], 0, 3)
    mesh = multihost_mesh(batch=2, space=4, devices=["cpu"] * 8)
    assert mesh.shape == {"batch": 2, "space": 4}
    planes = _detect_planes()[:, :96]
    stack = make_global_stack(detect.normalize_planes_u8(planes), mesh)
    assert (stack.global_batch, stack.offset) == (2, 0)
    got = sharded_find_circles_batch(stack, mesh, 0.1, 0.9, 0.2, min_radius=4,
                                     max_radius=8, min_dist=4,
                                     normalized=True)
    for plane, (c, s) in zip(planes, got):
        wc, ws = detect.detect_dense(torch.as_tensor(plane), 0.1, 0.9, 0.2,
                                     min_radius=4, max_radius=8, min_dist=4,
                                     normalized=False)
        assert torch.equal(c, wc) and torch.equal(s, ws)


def _worker(pid: int, port: int, out_path: str) -> None:
    """One of two gloo processes: each owns one plane (its key block),
    detects it on its 2 x 2 CPU mesh rows, matches its local single-device
    detection, gathers the counts of both, and runs RANSAC with the
    proposals split over both processes' devices."""
    import torch.distributed as dist

    from magnify_tpu_torch.ops import detect
    from magnify_tpu_torch.parallel import (host_shard_keys,
                                            make_global_stack, multihost_mesh,
                                            sharded_find_circles_batch)
    from magnify_tpu_torch.parallel.mesh import sharded_ransac_find_circles

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=pid, world_size=2)
    try:
        mine = host_shard_keys([0, 1])
        assert mine == [pid], mine
        planes = _detect_planes()
        mesh = multihost_mesh(batch=4, space=2, devices=["cpu"] * 4)
        assert mesh.shape == {"batch": 4, "space": 2} and mesh.size == 8
        stack = make_global_stack(
            detect.normalize_planes_u8(planes[mine]), mesh)
        assert (stack.global_batch, stack.offset) == (2, pid)
        kw = dict(min_radius=6, max_radius=10, min_dist=6)
        (c, s), = sharded_find_circles_batch(stack, mesh, 0.1, 0.9, 0.3,
                                             normalized=True, **kw)
        wc, ws = detect.detect_dense(torch.as_tensor(planes[pid]), 0.1, 0.9,
                                     0.3, normalized=False, **kw)
        match = bool(torch.equal(c, wc) and torch.equal(s, ws))
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
        dist.all_gather(counts, torch.tensor([len(c)]))
        img = ransac_plane()
        kw = dict(RANSAC_KW, num_iter=RANSAC_ITER)
        rc, rs = sharded_ransac_find_circles(img, mesh, **kw)
        one = detect.find_circles(img, detector="ransac", device="cpu", **kw)
        ransac_match = bool(np.array_equal(rc, one[0])
                            and np.array_equal(rs, one[1]))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"pid": pid, "match": match, "found": len(c),
                   "counts": [int(n) for n in counts],
                   "ransac_match": ransac_match, "ransac_found": len(rc)}, f)


def test_multihost_two_process_gloo(tmp_path):
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env.pop("MAGNIFY_TPU_DETECTOR", None)
    env.pop("MAGNIFY_TPU_SCORER", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(pid),
         str(port), str(tmp_path / f"out{pid}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for pid in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode()[-3000:]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    got = [json.loads((tmp_path / f"out{pid}.json").read_text())
           for pid in range(2)]
    found = [g["found"] for g in got]
    assert found[0] == 3 and found[1] >= 2, got
    for pid, g in enumerate(got):
        assert g["pid"] == pid and g["match"] and g["counts"] == found, g
        assert g["ransac_match"] and g["ransac_found"] >= 3, g


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        _write_reference(sys.argv[2])
