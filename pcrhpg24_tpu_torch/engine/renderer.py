"""Offscreen renderer and main loop.

Counterpart of `pcrhpg24_tpu/engine/renderer.py`: owns the camera and
orbit controls, drives update/render, applies eye-dome lighting to a
frame that left a depth plane (`Debug.edl`), aggregates frame timings,
and saves screenshots through `utils/png.write_png` and depth planes
through `utils/exr.write_exr_z` (or `.npy`).  Where the reference blocks
on the image with `block_until_ready`, this loop calls
`torch.cuda.synchronize()`; on a CUDA device each frame's render and
EDL are also bracketed by CUDA events, whose elapsed time lands in
`frame_ms` (the GLTimerQueries equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device_of
from ..render.camera import Camera, OrbitControls
from ..render.raster import edl_shade, image_to_rgb8
from ..u32 import to_u32
from ..utils.exr import write_exr_z
from ..utils.png import write_png
from .debug import Debug
from .timing import Timings


@dataclass
class Setting:
    """Camera preset of a scene (reference: src/main.cpp:66-74)."""

    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 1.0
    target: tuple = (0.0, 0.0, 0.0)


class Renderer:
    def __init__(self, width: int = 1920, height: int = 1080, device="cuda"):
        self.device = device_of(device)
        self.width = width
        self.height = height
        self.camera = Camera(width=width, height=height)
        self.controls = OrbitControls()
        self.timings = Timings()
        self.frame_ms: list[float] = []  # device ms per frame (CUDA events)
        self.frame_count = 0
        self.last_image = None
        self.last_fb = None
        # when False, colour methods may leave the depth plane out
        # (`need_depth`); set True before rendering a frame whose depth
        # `save_depth_exr` or another pass will read from last_fb[0]
        self.capture_depth = False

    def apply_setting(self, setting: Setting) -> None:
        """Load a scene Setting's camera preset (main.cpp:215-218)."""
        self.controls.yaw = setting.yaw
        self.controls.pitch = setting.pitch
        self.controls.radius = setting.radius
        self.controls.target = np.asarray(setting.target, np.float64)

    def loop(self, update, render, frames: int = 1, block: bool = True):
        """Run `frames` iterations of update+render (Renderer.cpp:239-766).

        With `block` the frame time includes device completion; without
        it the loop never waits for the card (a method may still read a
        small result back, as `huffman_tpu`'s live-chunk list).
        """
        cuda = self.device.type == "cuda"
        for _ in range(frames):
            with self.timings.span("frame"):
                self.controls_update()
                with self.timings.span("update"):
                    update(self)
                with self.timings.span("render"):
                    if cuda:
                        ev0 = torch.cuda.Event(enable_timing=True)
                        ev1 = torch.cuda.Event(enable_timing=True)
                        ev0.record()
                    img = render(self)
                    if (Debug.edl and img is not None and self.last_fb is not None
                            and self.last_fb[0] is not None):
                        img = edl_shade(img, self.last_fb[0].reshape(-1), self.width,
                                        self.height, Debug.edl_strength)
                    if cuda:
                        ev1.record()
                    if block and cuda:
                        torch.cuda.synchronize(self.device)
                        self.frame_ms.append(ev0.elapsed_time(ev1))
            self.last_image = img
            self.frame_count += 1
            Debug.clear_frame_stats()
        return self.last_image

    def controls_update(self) -> None:
        self.camera.world = self.controls.world()

    def save_screenshot(self, path: str) -> None:
        """Resolve the last frame to a PNG (Renderer.cpp:94-107)."""
        if self.last_image is None:
            raise RuntimeError("no frame rendered yet")
        write_png(path, image_to_rgb8(self.last_image).cpu().numpy())

    def depth_image(self) -> np.ndarray:
        """The last frame's depth plane as the depth dump holds it: (H, W)
        f32, empty pixels 0, rows y-down."""
        if self.last_fb is None:
            raise RuntimeError("no framebuffer available")
        fb_d, _ = self.last_fb
        if fb_d is None:
            raise RuntimeError(
                "depth plane not captured; set renderer.capture_depth = True "
                "before rendering the frame"
            )
        bits = to_u32(fb_d)
        d = bits.view(np.float32).reshape(self.height, self.width)
        return np.where(bits.reshape(self.height, self.width) == 0xFFFFFFFF, 0.0, d)[::-1]

    def save_depth_exr(self, path: str) -> None:
        """Dump the depth plane (huffman_mem_iter_cuda.h:200-220): a
        single-channel Z EXR for `.exr` paths, `.npy` otherwise."""
        d = self.depth_image()
        if path.endswith(".exr"):
            write_exr_z(path, d.astype(np.float32))
        else:
            np.save(path, d)
