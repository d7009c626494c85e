"""Global debug/config flags and per-frame stats.

Role-equivalent of the reference's Debug singleton (reference:
include/Debug.h:10-68): runtime-togglable rendering flags plus a
key/value frame-stat sink (the reference renders these in ImGui; we
expose them programmatically and via the CLI viewer).  The port's own
copy of `pcrhpg24_tpu/engine/debug.py`: its flags are separate from
the reference's.
"""

from __future__ import annotations


class Debug:
    update_enabled: bool = True
    update_frustum: bool = True
    show_bounding_box: bool = False
    lod: float = 0.1  # LOD floor percentage (Debug.h:20)
    lod_enabled: bool = False
    frustum_culling_enabled: bool = True
    colorize_chunks: bool = False
    colorize_overdraw: bool = False
    show_num_points: bool = False
    save_depth_map: bool = False
    # eye-dome lighting in the resolve (reference:
    # modules/compute_loop_las/resolve.cs:143-188, shipped disabled
    # there; --edl here)
    edl: bool = False
    edl_strength: float = 0.0005
    # Potree per-node point budget (loop_nodes.node_budget): target
    # candidate density per covered pixel; 0 disables (render every
    # point of every accepted node).  The nodes-path analogue of the
    # flagship LOD% heuristic (huffman_mem_iter_cuda/render.cu:346-379).
    node_budget: float = 0.0

    frame_stats: list[tuple[str, str]] = []
    values: dict[str, str] = {}

    @classmethod
    def set(cls, key: str, value: str) -> None:
        cls.values[key] = value

    @classmethod
    def get(cls, key: str) -> str:
        return cls.values.get(key, "undefined")

    @classmethod
    def push_frame_stat(cls, key: str, value: str) -> None:
        cls.frame_stats.append((key, value))

    @classmethod
    def clear_frame_stats(cls) -> None:
        cls.frame_stats.clear()
