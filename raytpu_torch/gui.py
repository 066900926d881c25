"""Optional live progressive preview (the reference's --gui mode,
src/main.rs:196-286: an SDL2 window that presents the SAMPLES texture
after every chunk, polls Quit/Escape each iteration, and after the render
finishes parks in an event loop until Quit/Escape before the PNG is
written).

Kept deliberately thin so it cannot contaminate the pure renderer: every
backend simply consumes the progressive tile generator. Backend order:

1. tkinter window — the closest parity to the reference loop: a real
   event-pumped window, per-tile present, Escape/close handling both
   during and after the render;
2. matplotlib interactive window (if tkinter is unavailable but a GUI
   backend exists);
3. a terminal progress line (headless hosts have no display).

Torch counterpart of ``raytpu.gui``: the same backends over the port's
``render_frame_tiles``. With no display it returns the ``render_frame``
result bit for bit.
"""

from __future__ import annotations

import sys

import numpy as np

from .engine.render import render_frame_tiles
from .io.png import quantize_rgba32f


def _frame_to_ppm(frame_u8: np.ndarray) -> bytes:
    """RGBA8 -> binary PPM (P6), the format tk.PhotoImage decodes
    natively (no PIL dependency)."""
    h, w = frame_u8.shape[:2]
    header = f"P6 {w} {h} 255 ".encode()
    return header + frame_u8[:, :, :3].tobytes()


def _try_tk(width: int, height: int):
    """A realised Tk window, or None when no display server exists."""
    try:
        import tkinter as tk

        root = tk.Tk()
    except Exception:
        return None
    root.title("raytpu")
    root.geometry(f"{width}x{height}")
    return root


def _run_tk(root, pack, camera, config) -> np.ndarray:
    """The reference's GUI loop shape: present per tile, poll events each
    iteration (Escape/close stops the render), then park until
    Escape/close (src/main.rs:196-286)."""
    import tkinter as tk

    state = {"quit": False}

    def on_quit(_event=None):
        state["quit"] = True

    root.protocol("WM_DELETE_WINDOW", on_quit)
    root.bind("<Escape>", on_quit)
    canvas = tk.Canvas(root, width=config.width, height=config.height,
                       highlightthickness=0)
    canvas.pack()
    frame = np.zeros((config.height, config.width, 4), np.float32)
    # ONE persistent frame image; each present blits only the finished
    # tile's rows into it via Tk's image `copy` subcommand — O(tile)
    # per present instead of O(W*H) full-frame requantise + re-decode
    # (the reference blits a GPU-resident texture, src/state.rs:199-252)
    photo = tk.PhotoImage(width=config.width, height=config.height)
    canvas.create_image((0, 0), image=photo, anchor="nw")

    def present(y0, rows):
        tile_img = tk.PhotoImage(
            data=_frame_to_ppm(quantize_rgba32f(frame[y0 : y0 + rows]))
        )
        photo.tk.call(str(photo), "copy", str(tile_img),
                      "-to", 0, int(y0))
        root.update()

    for y0, rows, tile in render_frame_tiles(pack, camera, config):
        frame[y0 : y0 + rows] = tile
        present(y0, rows)
        if state["quit"]:
            break
    # park in the event loop until Quit/Escape, like the reference
    # (src/main.rs:270-281), then hand the frame back for PNG output
    while not state["quit"]:
        try:
            root.update()
        except Exception:
            break
        root.after(16)  # ~60 Hz event pump without busy-waiting
    try:
        root.destroy()
    except Exception:
        pass
    return frame


def _try_matplotlib():
    """Return pyplot only when a window can actually appear: a non-Agg
    interactive backend, or a display server for Agg to be switched away
    from. (get_backend() is always truthy, so it alone proves nothing —
    headless boxes default to Agg, which would 'show' invisibly.)"""
    try:
        import os

        import matplotlib

        backend = matplotlib.get_backend().lower()
        if "agg" in backend and not os.environ.get("DISPLAY"):
            return None  # headless: fall back to the progress line
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def run_gui(pack, camera, config) -> np.ndarray:
    root = _try_tk(config.width, config.height)
    if root is not None:
        return _run_tk(root, pack, camera, config)

    frame = np.zeros((config.height, config.width, 4), np.float32)
    plt = _try_matplotlib()
    im = None
    if plt is not None:
        try:
            plt.ion()
            fig, ax = plt.subplots(num="raytpu")
            im = ax.imshow(quantize_rgba32f(frame))
            ax.set_axis_off()
        except Exception:
            plt, im = None, None

    done_rows = 0
    for y0, rows, tile in render_frame_tiles(pack, camera, config):
        frame[y0 : y0 + rows] = tile
        done_rows += rows
        if im is not None:
            im.set_data(quantize_rgba32f(frame))
            plt.pause(0.001)
        else:
            pct = 100.0 * done_rows / config.height
            print(f"\rraytpu: {pct:5.1f}% ({done_rows}/{config.height} rows)",
                  end="", file=sys.stderr, flush=True)
    if im is None:
        print(file=sys.stderr)
    elif plt is not None:
        plt.ioff()
        plt.show()
    return frame
