"""Port B2 (fused projection + BC1 + collapse) vs the JAX reference.

The reference is `pallas_project.project_batches(interpret=True)`,
compiled with XLA's LLVM backend at optimisation level 0 (`per_op`).
At the default level XLA-CPU contracts the interpreted kernel's
multiply-adds into FMAs (1-ulp depth differences on ~6% of entries of
a real view), while the TPU, the CUDA kernel and eager torch round
every f32 op on its own.  At O0 nothing is contracted, so the
(pid, dep, pay) streams must be BIT-identical — for a real orbit camera
as well as for the exact power-of-two frame of
`tests/test_pallas_project.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import read_tpc_batch, read_tpc_header
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render import pallas_project as ref
from pcrhpg24_tpu.render.camera import Camera, OrbitControls, batch_translations
from pcrhpg24_tpu.render.native_decode_xla import decode_fixed_xla
from pcrhpg24_tpu.render.pallas_decode_fixed import pack_fixed_batches
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud
from pcrhpg24_tpu_torch.render import project as port
from pcrhpg24_tpu_torch.render.bc1_layout import colors_kernel_layout
from pcrhpg24_tpu_torch.tools import crafted
from pcrhpg24_tpu_torch.u32 import from_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 320, 180


def per_op(jitted, *args, **static):
    """Run a jitted reference function with every f32 op rounded on its
    own (no FMA contraction): LLVM backend at optimisation level 0."""
    return jitted.lower(*args, **static).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The 130k-point scene of tests/test_pallas_project.py, decoded."""
    xyz, rgb = terrain_cloud(130_000, seed=11, extent=600.0)
    grid = cloud_to_grid(xyz)
    d = tmp_path_factory.mktemp("tproj")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    hdr = read_tpc_header(tpc)
    items = [read_tpc_batch(tpc, hdr, i) for i in range(hdr.num_batches)]
    pk = pack_fixed_batches([fb for fb, _c in items])
    coords = np.asarray(decode_fixed_xla(*(jnp.asarray(pk[k]) for k in
                                           ("widths", "streams", "ptrs", "starts"))))
    colors = np.stack([c for _fb, c in items]).astype(np.uint32)
    anchors = np.stack([fb.start_values.reshape(-1, 3).min(axis=0)
                        for fb, _c in items]).astype(np.int64)
    return dict(coords=coords, colors=colors, anchors=anchors, hdr=hdr)


def test_colors_kernel_layout_equal(scene):
    got = colors_kernel_layout(scene["colors"])
    want = np.asarray(ref.colors_kernel_layout(scene["colors"]))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _frame(scene, kind):
    """-> (frame12 f32, tbc (B,4) f32) for a real camera or the exact
    power-of-two frame (every f32 op exact)."""
    B = scene["coords"].shape[0]
    hdr = scene["hdr"]
    if kind == "pow2":
        frame = np.zeros(12, np.float32)
        frame[0] = frame[4] = frame[8] = 2.0 ** -19  # t00, t11, t32
        frame[9:12] = 1.0
        tbc = np.zeros((B, 4), np.float32)
        tbc[:, 3] = 2.0
        return frame, tbc
    cam = Camera(width=W, height=H)
    cam.world = OrbitControls(yaw=0.7, pitch=-0.7, radius=800.0,
                              target=np.array([300.0, 300.0, 50.0])).world()
    wvp = cam.proj() @ cam.view()
    t = wvp.astype(np.float32)
    frame = np.concatenate([t[0, :3], t[1, :3], t[3, :3],
                            np.asarray(hdr.scale, np.float32)])
    tbc = batch_translations(wvp, scene["anchors"], hdr.scale, hdr.offset,
                             hdr.las_min)
    return frame.astype(np.float32), tbc


CASES = [  # (frame, points, lodn, collapse, chain_collapse)
    ("pow2", 64, (64, 64), True, True),
    ("pow2", 16, (3, 10), True, True),
    ("orbit", 64, (64, 64), True, True),
    ("orbit", 64, (64, 64), True, False),
    ("orbit", 64, (64, 64), False, False),
    ("orbit", 48, (40, 13), True, True),
]


@pytest.mark.parametrize("kind,points,lodn,collapse,chain", CASES)
def test_project_plain_bit_exact(scene, kind, points, lodn, collapse, chain):
    frame, tbc = _frame(scene, kind)
    coords = scene["coords"][:, :points].copy()
    colors_k = colors_kernel_layout(scene["colors"])
    anchors = scene["anchors"].astype(np.int32)
    lodn = np.asarray(lodn, np.int32)
    got = port.project_batches(
        torch.from_numpy(coords), from_u32(colors_k), torch.from_numpy(anchors),
        torch.from_numpy(tbc), torch.from_numpy(lodn), torch.from_numpy(frame),
        W, H, points=points, chain_collapse=chain, collapse=collapse)
    want = per_op(
        ref.project_batches, jnp.asarray(coords), jnp.asarray(colors_k),
        jnp.asarray(anchors), jnp.asarray(tbc), jnp.asarray(lodn),
        jnp.asarray(frame), width=W, height=H, points=points,
        chain_collapse=chain, collapse=collapse, interpret=True)
    for name, g, w in zip(("pid", "dep", "pay"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w, err_msg=name)
    size = port.swizzle_dims(W, H)[2]
    assert (np.asarray(want[0]) < size).sum() > 1000  # the view sees points


# crafted chunks (pcrhpg24_tpu_torch/tools/crafted.py): pids that repeat
# non-contiguously along a chain (A B A, A B..B A at gaps 1-40), equal
# chain heads with other heads between them, sentinels, tied depths and a
# partial lodn, under the exact pow2 frame
CRAFTED = [  # (points, steps, collapse, chain_collapse)
    (16, 6, True, True), (32, 6, True, True), (48, 6, True, True),
    (64, 6, True, True), (16, 3, True, True), (32, 3, True, True),
    (48, 3, True, True), (64, 3, True, True), (64, 6, True, False),
    (48, 3, True, False), (64, 6, False, False), (16, 3, False, False),
    (40, 6, True, True), (40, 3, True, False),  # no LOD bucket: the run-time count
]


@pytest.mark.parametrize("points,steps,collapse,chain", CRAFTED)
def test_project_plain_bit_exact_crafted(points, steps, collapse, chain):
    a = crafted.project_inputs(2, points, W, H, seed=points + steps)
    args = (a["coords"], a["colors_k"].view(np.int32), a["anchors"], a["tbc"],
            a["lodn"], a["frame"])
    got = port.project_batches(*map(torch.from_numpy, args), W, H, points=points,
                               steps=steps, chain_collapse=chain, collapse=collapse)
    want = per_op(
        ref.project_batches, *map(jnp.asarray, args[:1]),
        jnp.asarray(a["colors_k"]), *map(jnp.asarray, args[2:]), width=W, height=H,
        points=points, steps=steps, chain_collapse=chain, collapse=collapse,
        interpret=True)
    for name, g, w in zip(("pid", "dep", "pay"), got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w),
                                      err_msg=name)
    # the raw stream repeats pids non-contiguously along the chains
    raw = port.project_plain(*map(torch.from_numpy, args), W, H, points=points,
                             collapse=False)[0].numpy()
    size = port.swizzle_dims(W, H)[2]
    aba = (raw[:, :-2] == raw[:, 2:]) & (raw[:, :-2] != raw[:, 1:-1]) & (raw[:, 2:] < size)
    assert aba.sum() > 100
