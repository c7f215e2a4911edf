"""FPS-style camera controller.

Pure-function port of the reference's `ViewController`
(src/ViewController.cpp:9-99, .hpp:13-59): WASD translate
along front/left, arrows up/down along up, Q/E roll (fixed 0.01 rad per
update), left-drag yaw/pitch at 0.01 rad per pixel; on any movement the view
matrix is rebuilt with lookAt(position, position + front, cross(front,
left)) and the caller resets accumulation (`hasMoved`).

Input is decoupled from any window system via `ControllerInput`, so the same
controller drives the interactive app, replayed scripts, and tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from l2n_tpu_torch.maths import linalg


@dataclasses.dataclass
class ControllerInput:
    """One frame of input. Key fields mirror the GLFW polls in
    ViewController::update (ViewController.cpp:21-51)."""

    forward: bool = False   # W
    backward: bool = False  # S
    left: bool = False      # A
    right: bool = False     # D
    up: bool = False        # UP arrow
    down: bool = False      # DOWN arrow
    roll_left: bool = False   # Q
    roll_right: bool = False  # E
    dragging: bool = False    # left mouse button held
    cursor_dx: float = 0.0    # cursor delta since last update (pixels)
    cursor_dy: float = 0.0


class ViewController:
    def __init__(self, speed: float = 1.0,
                 view_matrix: np.ndarray | None = None):
        self._speed = float(speed)
        self.set_view_matrix(linalg.DEFAULT_VIEW_MATRIX if view_matrix is None
                             else view_matrix)

    # -- speed knobs (ViewController.hpp:19-34) ------------------------------
    @property
    def speed(self) -> float:
        return self._speed

    def set_speed(self, speed: float) -> None:
        self._speed = float(speed)

    def increase_speed(self, delta: float) -> None:
        self._speed = max(self._speed + float(delta), 0.0)

    # -- matrices (ViewController.hpp:38-49) ---------------------------------
    def set_view_matrix(self, view: np.ndarray) -> None:
        self._view = np.asarray(view, np.float32).copy()
        self._rcp_view = linalg.inverse(self._view)

    @property
    def view_matrix(self) -> np.ndarray:
        return self._view

    @property
    def rcp_view_matrix(self) -> np.ndarray:
        return self._rcp_view

    # -- per-frame update (ViewController.cpp:9-99) --------------------------
    def update(self, inp: ControllerInput, elapsed_time: float) -> bool:
        """Apply one frame of input; returns has_moved."""
        m = self._rcp_view
        front, left, up = linalg.camera_axes(m)
        position = linalg.camera_position(m)

        has_moved = False
        translation = np.zeros(3, np.float32)
        step = np.float32(self._speed * elapsed_time)
        if inp.forward:
            translation += step * front
        if inp.backward:
            translation -= step * front
        if inp.left:
            translation += step * left
        if inp.right:
            translation -= step * left
        if inp.up:
            translation += step * up
        if inp.down:
            translation -= step * up
        position = position + translation
        if np.any(translation != 0.0):
            has_moved = True

        # Roll: fixed 0.01 rad per update regardless of dt
        # (ViewController.cpp:29-34,69-73).
        lateral = 0.0
        if inp.roll_left:
            lateral += 0.01
        if inp.roll_right:
            lateral -= 0.01

        new_rcp = m
        if lateral:
            new_rcp = linalg.rotate(new_rcp, lateral, np.array([0, 0, 1], np.float32))
            has_moved = True

        if inp.dragging and (inp.cursor_dx or inp.cursor_dy):
            # Yaw then pitch at -0.01 rad per cursor pixel
            # (ViewController.cpp:83-84).
            new_rcp = linalg.rotate(new_rcp, -0.01 * float(inp.cursor_dx),
                                    np.array([0, 1, 0], np.float32))
            new_rcp = linalg.rotate(new_rcp, -0.01 * float(inp.cursor_dy),
                                    np.array([1, 0, 0], np.float32))
            has_moved = True

        if has_moved:
            front = -new_rcp[:3, 2]
            left = -new_rcp[:3, 0]
            up = np.cross(front, left)
            self.set_view_matrix(linalg.look_at(position, position + front, up))
        return has_moved
