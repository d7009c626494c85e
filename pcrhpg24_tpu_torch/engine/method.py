"""Method interface and runtime registry.

Role-equivalent of the reference's Method/Runtime pair (reference:
include/Method.h:10-24, include/Runtime.h:15-52): each render algorithm
is a named Method with update()/render() hooks, registered globally and
selected at runtime.  The port's own copy of
`pcrhpg24_tpu/engine/method.py`: its registry is separate from the
reference's.
"""

from __future__ import annotations


class Method:
    name: str = ""
    description: str = ""
    group: str = ""

    def update(self, renderer) -> None:  # resource management
        raise NotImplementedError

    def render(self, renderer):  # returns (H, W) u32 image
        raise NotImplementedError


class Runtime:
    methods: list[Method] = []
    selected: Method | None = None
    resource = None

    @classmethod
    def add_method(cls, method: Method) -> None:
        cls.methods.append(method)
        if cls.selected is None:
            cls.selected = method

    @classmethod
    def set_selected(cls, name: str) -> None:
        for m in cls.methods:
            if m.name == name:
                cls.selected = m
                return
        raise KeyError(f"no method named {name!r}")

    @classmethod
    def get_method(cls, name: str) -> Method:
        for m in cls.methods:
            if m.name == name:
                return m
        raise KeyError(f"no method named {name!r}")

    @classmethod
    def clear(cls) -> None:
        cls.methods = []
        cls.selected = None
        cls.resource = None
