"""The port never loads jax nor the JAX package, and never carries on
without its device.

The machine with the card has no jax at all, so importing any module of
`pcrhpg24_tpu_torch` must leave `jax` out of `sys.modules`; and the port
keeps its own copy of whatever it needs of `pcrhpg24_tpu`, so no module
of the port, and not `chip_smoke.py`, imports that package at all.  The
import checks run in a fresh interpreter because this test process
(tests/conftest.py) has imported jax already.
"""

import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import pcrhpg24_tpu_torch
from pcrhpg24_tpu_torch import app, device_of
from pcrhpg24_tpu_torch.convert import dev_from_numpy
from pcrhpg24_tpu_torch.engine.renderer import Renderer
from pcrhpg24_tpu_torch.kernels import build
from pcrhpg24_tpu_torch.render.raster import u64_min_planes

REPO = Path(__file__).resolve().parents[1]


def _modules():
    names = [pcrhpg24_tpu_torch.__name__]
    for m in pkgutil.walk_packages(pcrhpg24_tpu_torch.__path__,
                                   pcrhpg24_tpu_torch.__name__ + "."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 15
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
            assert "jax" not in sys.modules, name
            assert "jaxlib" not in sys.modules, name
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_every_module_imports_without_the_jax_package():
    mods = _modules()
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "pcrhpg24_tpu" or k.startswith("pcrhpg24_tpu."))
        assert not bad, bad
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports_of_the_jax_package(path: Path) -> list[str]:
    """`import pcrhpg24_tpu[...]` / `from pcrhpg24_tpu[...] import` lines."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for n in names:
            if n == "pcrhpg24_tpu" or n.startswith("pcrhpg24_tpu."):
                found.append(f"{path.name}:{node.lineno} {n}")
    return found


def test_no_source_imports_the_jax_package(tmp_path):
    files = sorted((REPO / "pcrhpg24_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 30
    parallel = REPO / "pcrhpg24_tpu_torch" / "parallel"
    assert {parallel / f for f in ("mesh.py", "mesh_native.py", "dryrun.py")} <= set(files)
    bad = [hit for f in files for hit in _imports_of_the_jax_package(f)]
    assert not bad, bad
    # the scan sees what it looks for
    probe = tmp_path / "import_probe.py"
    probe.write_text("import pcrhpg24_tpu.constants\nfrom pcrhpg24_tpu import app\n"
                     "from pcrhpg24_tpu_torch import app as ok\n")
    assert len(_imports_of_the_jax_package(probe)) == 2


def test_rank_processes_load_no_jax(tmp_path):
    """The sharded frames' rank entry point (`python -m
    pcrhpg24_tpu_torch.parallel.dryrun`), run as a rank of a one-rank
    gloo group on the reference's tiny `.huffman` scene, loads nothing of
    jax or the JAX package."""
    from __graft_entry__ import _tiny_scene
    from pcrhpg24_tpu_torch.parallel.dryrun import dryrun_multichip

    scene = {k: np.asarray(v) for k, v in _tiny_scene(1).items()}
    transform = np.eye(4, dtype=np.float32)
    transform[3] = (0.0, 0.0, 1e-3, 1.0)
    np.savez(tmp_path / "tiny.npz", **scene, lod_n=np.full(1, 64, np.int32),
             transform=transform, scale=np.full(3, 0.01, np.float32),
             offset_rel=np.zeros(3, np.float32))
    task = dict(kind="huffman", name="tiny", scene=str(tmp_path / "tiny.npz"), dp=1, sp=1,
                width=64, height=64)
    res = dryrun_multichip(1, [task], "gloo", "cpu", workdir=str(tmp_path), reps=0)
    assert res["foreign_modules"] == []
    assert res["tiny"]["ranks"][0]["frames"]["frame"]["equal"]


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_of("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(64, 32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dev_from_numpy({"anchor": np.zeros((1, 3), np.int32)}, "cuda")


def test_kernel_source_hash_tracks_sources():
    import pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs  # noqa: F401  (all wrappers)
    import pcrhpg24_tpu_torch.render.merge  # noqa: F401
    import pcrhpg24_tpu_torch.render.tile_sort  # noqa: F401

    srcs = {p.name for p in build.sources()}
    assert {"decode_fixed.cu", "project.cu", "raster.cu", "hqs.cu",
            "decode_native.cu", "merge.cu", "tile_sort.cu", "decode_huffman.cu"} <= srcs
    assert len(build.source_hash()) == 16
    assert "-fmad=false" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    assert set(build.KERNELS) >= {"pcr_decode_fixed", "pcr_project", "pcr_u64_min",
                                  "pcr_hqs_sums", "pcr_decode_native", "pcr_merge_nk1",
                                  "pcr_merge_heads", "pcr_hqs_sorted", "pcr_tile_sort3",
                                  "pcr_decode_huffman"}


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version and counts no launch."""
    before = build.KERNELS["pcr_u64_min"].launches
    pid = torch.tensor([3, 3, 9], dtype=torch.int32)
    dep = torch.tensor([5, 4, 1], dtype=torch.int32)
    pay = torch.tensor([1, 2, 3], dtype=torch.int32)
    fb_d, fb_p = u64_min_planes([(pid, dep, pay)], 8)
    assert fb_d[3] == 4 and fb_p[3] == 2 and fb_p[0] == -1
    assert build.KERNELS["pcr_u64_min"].launches == before


@pytest.mark.parametrize("scene,item", [("raw.tpc", "A11c")])
def test_unported_scene_kinds_name_their_roadmap_item(tmp_path, scene, item):
    """A `.tpc` with raw colours, written by the reference's preprocessor:
    the last scene kind the port refused, until its ROADMAP item (A11c)
    ported the raw and BC7 payloads.  The app now builds both `.tpc`
    methods on it, over its raw colours."""
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc

    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 100_000, (65536, 3)).astype(np.int32)
    las = str(tmp_path / "s.las")
    write_las(las, xyz[:, 0], xyz[:, 1], xyz[:, 2],
              rng.integers(0, 256, (65536, 3)).astype(np.uint8))
    path = str(tmp_path / scene)
    preprocess_las_tpc(las, path, verbose=False, color_fmt=scene.split(".")[0])
    r = Renderer(64, 32, device="cpu")
    methods = app.build_methods(r, path)
    assert [m.name for m in methods] == ["huffman_tpu", "huffman_tpu_hqs"], item
    assert all(m.las.color_fmt == "raw" for m in methods)


def test_parametric_scene_builds_its_method():
    r = Renderer(64, 32, device="cpu")
    methods = app.build_methods(r, "parametric")
    assert [m.name for m in methods] == ["parametric"]
    assert not hasattr(methods[0], "las")  # run() waits on no resource
