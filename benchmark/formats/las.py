"""A raw `.las` scene: the points in the generator's order, LAS 1.2
point format 2 (26 B a point), written by the port's
`formats.las.write_las` into memory: an anonymous in-memory file
(`memfd_create`), named `scene.las` in the run's directory by a link, so
that a run writes no disk blocks for its scene and the port reads it
through its own path-based reader."""

from __future__ import annotations

import os

SUFFIX = ".las"


def write(points, directory: str, pmap=map) -> dict:
    """-> {"path", "fd"}: the caller closes `fd` once the port has read
    the file, which frees it."""
    from pcrhpg24_tpu_torch.formats.las import write_las

    fd = os.memfd_create("scene.las")
    target = f"/proc/{os.getpid()}/fd/{fd}"
    g = points.grid
    write_las(target, g[:, 0], g[:, 1], g[:, 2], points.rgb, points.scale, points.offset)
    path = os.path.join(directory, "scene.las")
    os.symlink(target, path)
    return dict(path=path, fd=fd)


def kernel_bytes(info: dict, ref, views, hqs: bool) -> dict:
    """Least bytes a frame's launches of each port kernel move, by C
    symbol (the bounds of `chip_smoke.py`): flat B3 reads the (pid, depth,
    index) entry of every point of the loaded batches and writes the
    8-byte plane once; flat B4 reads the entries with the colour as the
    payload and the depth plane, and writes the 16-byte sums once."""
    size = views[0].width * views[0].height
    entries = 12 * ref.B * 65536
    out = {"pcr_u64_min_flat": entries + 8 * size}
    if hqs:
        out["pcr_hqs_sums_flat"] = entries + 4 * size + 16 * size
    return out
