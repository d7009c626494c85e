"""Port `parametric` (surface generation, projection, sorted resolve
through B6's plain version) vs the JAX reference, on the CPU.

XLA-CPU's `sin`/`cos` are not torch's (about 9% of the sphere's
coordinates differ, by at most 4 ulp, at any XLA optimisation level),
so generation is held within 8 ulp, and the UV colour, which reads the
height through a truncation, equal on at least 99.9% of the points.
Projection and resolve are held bit for bit: the reference's own points
and colours (its surface functions and colour formula) go through the
port's projection and resolve and must give the planes and the image of
the reference's projection and resolve (`parametric.py:56-71`) on those
points, compiled at `xla_backend_optimization_level=0` (no FMA
contraction).  They are not held bit for bit to `render_parametric` as
one program: there XLA's algebraic simplifier (an HLO pass, whatever the
backend's optimisation level) reassociates the transform into the generation (`t30 * (10 *
cos(phi) * cos(theta))` becomes `(t30 * 10 cos(phi)) * cos(theta)`) and
folds `u * 2 * pi` into one constant, which moves 3% of the depths by
an ulp.  The whole frame is held to `render_parametric` on the image
instead: equal on at least 99% of the pixels (all of them in the three
cases here, where no such ulp changes a winner).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcrhpg24_tpu.render import raster as ref_raster
from pcrhpg24_tpu.render.methods import parametric as ref
from pcrhpg24_tpu_torch import app
from pcrhpg24_tpu_torch.engine.method import Runtime
from pcrhpg24_tpu_torch.render import raster
from pcrhpg24_tpu_torch.render.camera import Camera, OrbitControls
from pcrhpg24_tpu_torch.render.methods import parametric as port
from pcrhpg24_tpu_torch.u32 import from_u32, to_u32
from tests.torch_fixtures import one_torch_thread  # noqa: F401  (autouse)

W, H = 192, 108
O0 = {"xla_backend_optimization_level": 0}
# cameras that frame the radius-10 sphere at the origin
CAMERAS = {"near": dict(yaw=0.4, pitch=-0.3, radius=22.0),
           "far": dict(yaw=-1.2, pitch=-0.7, radius=35.0)}


@pytest.fixture(autouse=True)
def _clear_runtime():
    yield
    Runtime.clear()


@partial(jax.jit, static_argnames=("surface",))
def _reference_points(surface: str):
    """`parametric.py:45-54`: the reference's points and UV colours."""
    u = (jnp.arange(ref.N_U) + 0.5) / ref.N_U
    v = (jnp.arange(ref.N_V) + 0.5) / ref.N_V
    uu, vv = jnp.meshgrid(u, v, indexing="ij")
    fx, fy, fz = ref.SURFACES[surface](uu.reshape(-1), vv.reshape(-1))
    r = (uu.reshape(-1) * 255).astype(jnp.uint32)
    g = (vv.reshape(-1) * 255).astype(jnp.uint32)
    b = ((fz - fz.min()) / (fz.max() - fz.min() + 1e-9) * 255).astype(jnp.uint32)
    return fx, fy, fz, r | (g << 8) | (b << 16)


_COMPILED = {}


def _per_op(fn, *args, **static):
    key = (fn.__name__, tuple(sorted(static.items())))
    if key not in _COMPILED:
        _COMPILED[key] = fn.lower(*args, **static).compile(compiler_options=O0)
    return _COMPILED[key](*args)


@partial(jax.jit, static_argnames=("width", "height"))
def _reference_project_resolve(fx, fy, fz, rgba, transform, width: int, height: int):
    """`parametric.py:56-71` on given points, the reference's op order."""
    t = transform.astype(jnp.float32)
    cx = t[0, 0] * fx + t[0, 1] * fy + t[0, 2] * fz + t[0, 3]
    cy = t[1, 0] * fx + t[1, 1] * fy + t[1, 2] * fz + t[1, 3]
    w = t[3, 0] * fx + t[3, 1] * fy + t[3, 2] * fz + t[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    sx = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    size = width * height
    pid = jnp.where(ok, sx + sy * width, size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return ref_raster.sorted_resolve_u64_min(pid, depth, rgba, size, True, False)


def _ulps(a, b):
    """|a - b| in units of the last place of the larger magnitude."""
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("surface", ["sphere", "wave"])
def test_generation_within_8_ulp(surface):
    want = [np.asarray(x) for x in _per_op(_reference_points, surface=surface)]
    got = port.surface_points(surface, "cpu")
    uu, vv = port.uv_grid("cpu")
    assert uu.shape == vv.shape == (port.N_U * port.N_V,)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        assert _ulps(g.numpy(), w).max() <= 8
    same = (to_u32(got[3]) == want[3]).mean()
    assert same >= 0.999, same


def _transform(camera: dict):
    controls = OrbitControls(target=np.zeros(3), **camera)
    cam = Camera(width=W, height=H, world=controls.world())
    return (cam.proj() @ cam.view()).astype(np.float32)


@pytest.mark.parametrize("surface,camera", [("sphere", "near"), ("sphere", "far"),
                                            ("wave", "far")])
def test_projection_and_resolve_bit_exact(surface, camera):
    wvp = _transform(CAMERAS[camera])
    pts = [np.array(x) for x in _per_op(_reference_points, surface=surface)]
    want_d, want_p = _per_op(_reference_project_resolve, *map(jnp.asarray, pts),
                             jnp.asarray(wvp), width=W, height=H)
    want_img = np.asarray(ref_raster.resolve(want_p, W, H))
    fb_d, fb_p = port.render_points(*map(torch.from_numpy, pts[:3]),
                                    from_u32(pts[3]), torch.from_numpy(wvp), W, H)
    np.testing.assert_array_equal(to_u32(fb_d), np.asarray(want_d))
    np.testing.assert_array_equal(to_u32(fb_p), np.asarray(want_p))
    img = to_u32(raster.resolve(fb_p, W, H))
    np.testing.assert_array_equal(img, want_img)
    assert (want_img != 0x00443322).mean() > 0.05
    # the whole frame against the reference's render_parametric
    _d, whole_p = _per_op(ref.render_parametric, jnp.asarray(wvp), surface=surface,
                          width=W, height=H)
    _d, mine_p = port.render_parametric(torch.from_numpy(wvp), surface, W, H)
    whole = np.asarray(ref_raster.resolve(whole_p, W, H))
    mine = to_u32(raster.resolve(mine_p, W, H))
    assert ((whole != 0x00443322) == (mine != 0x00443322)).mean() >= 0.999
    assert (whole == mine).mean() >= 0.99, (whole == mine).mean()


def test_app_renders_parametric(tmp_path):
    out = tmp_path / "p.png"
    c = CAMERAS["near"]
    rr = app.run(["--scene", "parametric", "--device", "cpu", "--width", str(W),
                  "--height", str(H), "--yaw", str(c["yaw"]), "--pitch",
                  str(c["pitch"]), "--radius", str(c["radius"]), "--screenshot",
                  str(out)])
    assert Runtime.selected.name == "parametric"
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    fb_d, fb_p = rr.last_fb
    assert fb_d.shape == fb_p.shape == (W * H,)
    shown = (rr.last_image != 0x00443322).float().mean().item()
    assert shown > 0.05
    # the method's frame is render_parametric's, plain resolve included
    want_d, want_p = port.render_parametric(
        torch.from_numpy(_transform(c)), "sphere", W, H, plain=True)
    assert torch.equal(fb_d, want_d) and torch.equal(fb_p, want_p)
