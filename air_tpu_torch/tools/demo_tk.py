"""Tk live-inference demo (GUI), the port's copy of
``air_tpu/tools/demo_tk.py``.

Functional rebuild of the reference demo UI (reference demo/demo_window.py,
demo/pixel_canvas.py): a drawable 50x50 pixel canvas, a reconstruction
canvas, three VAE-window panes, controls (draw/erase, line width, refresh
period 10-1000 ms, bounding-box toggle), and a status bar showing the
reconstruction NLL. The model re-infers the drawn image on a timer
(reference demo/demo_window.py:149-174).

Import is deferred so headless environments never touch tkinter.
"""

from __future__ import annotations

import math

import numpy as np


# -- pure geometry helpers (headlessly testable; used by PixelCanvas) --------

def paint_stroke(image: np.ndarray, x1, y1, x2, y2, rw, rh,
                 line_width: int, value: float) -> None:
    """Rasterize a stroke segment into ``image`` ([h, w], modified in
    place). (x1,y1)-(x2,y2) are CANVAS coordinates; ``rw``/``rh`` are the
    canvas-pixels-per-image-pixel ratios (canvas_w / w, canvas_h / h);
    ``value`` is 1.0 for draw, 0.0 for erase. The brush is a disc of
    diameter ``line_width`` image pixels stamped along the segment
    (reference demo/pixel_canvas.py:102-158 semantics)."""
    h, w = image.shape
    length = max(math.hypot(x2 - x1, y2 - y1), 1.0)
    steps = int(length / (min(rw, rh) / 2)) + 1
    half = (line_width - 1) / 2.0
    for i in range(steps + 1):
        cx = x1 + (x2 - x1) * i / steps
        cy = y1 + (y2 - y1) * i / steps
        pi, pj = int(cy / rh), int(cx / rw)
        r = int(math.ceil(half))
        for di in range(-r, r + 1):
            for dj in range(-r, r + 1):
                if di * di + dj * dj <= half * half + 0.5:
                    ii, jj = pi + di, pj + dj
                    if 0 <= ii < h and 0 <= jj < w:
                        image[ii, jj] = value


def bbox_canvas_coords(s, sx, sy, cw, ch):
    """Attention box (scale, shift_x, shift_y) in ST space [-1, 1] ->
    canvas rectangle (x1, y1, x2, y2): center (1+shift)/2 * canvas, half
    side scale/2 * canvas (reference demo/pixel_canvas.py:160-191)."""
    hx, hy = s * cw / 2.0, s * ch / 2.0
    cx, cy = (1 + sx) * cw / 2.0, (1 + sy) * ch / 2.0
    return cx - hx, cy - hy, cx + hx, cy + hy


def upscale_for_display(image: np.ndarray, cw: int, ch: int) -> np.ndarray:
    """Pixel-exact integer upscale (np.kron) of [h, w] float image in [0,1]
    to a [<=ch, <=cw] uint8 frame (reference demo/pixel_canvas.py:51-67)."""
    h, w = image.shape
    zy = max(int(math.ceil(ch / h)), 1)
    zx = max(int(math.ceil(cw / w)), 1)
    z = np.kron(image, np.ones((zy, zx)))[:ch, :cw]
    return (z * 255).astype(np.uint8)


class PixelCanvas:
    """Drawable/displayable pixel canvas (reference demo/pixel_canvas.py:8-223).

    Renders a float image [h, w] in [0,1] as a zoomed Tk PhotoImage, rasterizes
    mouse-drag strokes into pixels, and overlays colored attention bboxes from
    (scale, shift_x, shift_y) triples.
    """

    COLORS = ["#F00", "#0F0", "#00F", "#0FF", "#F0F", "#FF0", "#FFF"]

    def __init__(self, master, w, h, drawable=True, line_width=3, **kw):
        import tkinter as tk
        self.tk = tk
        self.canvas = tk.Canvas(master, **kw)
        self.w, self.h = w, h
        self.image = np.zeros((h, w), np.float32)
        self.erasing = False
        self.line_width = line_width
        self.photo = tk.PhotoImage(width=1, height=1)
        self.photo_id = self.canvas.create_image(0, 0, image=self.photo,
                                                 anchor=tk.NW)
        self.bbox_ids = [
            self.canvas.create_rectangle((0, 0, 0, 0), width=2,
                                         outline=self.COLORS[i % 7])
            for i in range(10)]
        self.bbox_positions = []
        self.bbox_visibility = True
        self.canvas.bind("<Configure>", lambda e: self.redraw())
        if drawable:
            self.canvas.bind("<Button-1>", self._click)
            self.canvas.bind("<B1-Motion>", self._drag)
            self.canvas.bind("<Button-3>", lambda *_: self.clear_image())

    # -- geometry -------------------------------------------------------------
    def _scale(self):
        cw = max(self.canvas.winfo_width(), 1)
        ch = max(self.canvas.winfo_height(), 1)
        return cw, ch, cw / self.w, ch / self.h

    def _to_pixel(self, cx, cy):
        _, _, rw, rh = self._scale()
        return int(cy / rh), int(cx / rw)

    # -- drawing --------------------------------------------------------------
    def _click(self, e):
        self.last = (e.x, e.y)
        self._paint(e.x, e.y, e.x, e.y)

    def _drag(self, e):
        self._paint(*self.last, e.x, e.y)
        self.last = (e.x, e.y)

    def _paint(self, x1, y1, x2, y2):
        """Rasterize a stroke segment with the current line width."""
        _, _, rw, rh = self._scale()
        paint_stroke(self.image, x1, y1, x2, y2, rw, rh,
                     self.line_width, 0.0 if self.erasing else 1.0)
        self.redraw()

    # -- rendering ------------------------------------------------------------
    def redraw(self):
        cw, ch, _, _ = self._scale()
        z = upscale_for_display(self.image, cw, ch)
        header = f"P5 {z.shape[1]} {z.shape[0]} 255 ".encode()
        self.photo.configure(width=z.shape[1], height=z.shape[0],
                             data=header + z.tobytes(), format="PPM")
        self._redraw_bboxes()

    def _redraw_bboxes(self):
        cw, ch, _, _ = self._scale()
        for i, bid in enumerate(self.bbox_ids):
            if self.bbox_visibility and i < len(self.bbox_positions):
                s, sx, sy = self.bbox_positions[i]
                self.canvas.coords(bid, *bbox_canvas_coords(s, sx, sy,
                                                            cw, ch))
                self.canvas.itemconfig(bid, state="normal")
            else:
                self.canvas.itemconfig(bid, state="hidden")

    # -- public API (reference pixel_canvas.py:200-223) -----------------------
    def get_image(self):
        return self.image.copy()

    def set_image(self, image):
        self.image = np.asarray(image, np.float32).copy()
        self.redraw()

    def clear_image(self):
        self.image.fill(0.0)
        self.redraw()

    def set_erasing_mode(self, erasing=True):
        self.erasing = erasing

    def set_bbox_positions(self, positions):
        self.bbox_positions = list(positions)
        self._redraw_bboxes()

    def set_bbox_visibility(self, visible=True):
        self.bbox_visibility = visible
        self._redraw_bboxes()

    def set_line_width(self, width):
        self.line_width = int(width)

    def grid(self, **kw):
        self.canvas.grid(**kw)


class DemoWindow:
    """Main demo window (reference demo/demo_window.py:7-186)."""

    def __init__(self, master, model_wrapper, canvas_size=50, window_size=28,
                 refresh_period=50, test_image=None):
        import tkinter as tk
        from tkinter import ttk
        self.master = master
        self.wrapper = model_wrapper
        self.refresh_period = refresh_period

        controls = ttk.Frame(master, padding=10)
        controls.grid(row=0, column=0, columnspan=3, sticky="nsew")
        self.draw_mode = tk.IntVar(value=1)
        ttk.Radiobutton(controls, text="Draw", variable=self.draw_mode,
                        value=1).grid(row=0, column=0)
        ttk.Radiobutton(controls, text="Erase", variable=self.draw_mode,
                        value=0).grid(row=0, column=1)
        ttk.Button(controls, text="Clear Image",
                   command=lambda: self.cnv_orig.clear_image()
                   ).grid(row=0, column=2, padx=10)
        self.width_var = tk.StringVar(value="3")
        tk.Spinbox(controls, values=(1, 2, 3, 4, 5), width=5,
                   textvariable=self.width_var).grid(row=0, column=3)
        self.rate_var = tk.StringVar(value=str(refresh_period))
        tk.Spinbox(controls, values=(10, 20, 50, 100, 200, 500, 1000),
                   width=6, textvariable=self.rate_var).grid(row=0, column=4)
        self.bbox_var = tk.IntVar(value=1)
        ttk.Checkbutton(controls, text="Bounding Boxes",
                        variable=self.bbox_var).grid(row=0, column=5)

        self.cnv_orig = PixelCanvas(master, canvas_size, canvas_size,
                                    drawable=True, width=400, height=400,
                                    highlightthickness=0)
        self.cnv_orig.grid(row=1, column=0, sticky="nsew")
        self.cnv_rec = PixelCanvas(master, canvas_size, canvas_size,
                                   drawable=False, width=400, height=400,
                                   highlightthickness=0)
        self.cnv_rec.grid(row=1, column=1, sticky="nsew")
        win_frame = ttk.Frame(master)
        win_frame.grid(row=1, column=2, sticky="nsew")
        self.cnv_win = []
        for i in range(3):
            c = PixelCanvas(win_frame, window_size, window_size,
                            drawable=False, width=120, height=120,
                            highlightthickness=0)
            c.grid(row=i, column=0, pady=2)
            self.cnv_win.append(c)
        self.status = ttk.Label(master, relief="sunken", padding=(5, 2))
        self.status.grid(row=2, column=0, columnspan=3, sticky="nsew")

        self.draw_mode.trace_add(
            "write", lambda *_: self.cnv_orig.set_erasing_mode(
                self.draw_mode.get() == 0))
        self.width_var.trace_add(
            "write", lambda *_: self.cnv_orig.set_line_width(
                int(self.width_var.get())))
        self.rate_var.trace_add(
            "write", lambda *_: setattr(self, "refresh_period",
                                        int(self.rate_var.get())))
        self.bbox_var.trace_add("write", lambda *_: self._toggle_bbox())

        if test_image is not None:
            self.cnv_orig.set_image(test_image)
        master.after(100, self._reconstruct)

    def _toggle_bbox(self):
        vis = self.bbox_var.get() == 1
        self.cnv_orig.set_bbox_visibility(vis)
        self.cnv_rec.set_bbox_visibility(vis)

    def _reconstruct(self):
        dig, pos, rec, win, lat, loss = self.wrapper.infer(
            [self.cnv_orig.get_image()])
        self.cnv_rec.set_image(rec[0])
        self.cnv_rec.set_bbox_positions(pos[0])
        self.cnv_orig.set_bbox_positions(pos[0])
        for i, c in enumerate(self.cnv_win):
            if i < len(win[0]):
                c.set_image(win[0][i])
                c.set_bbox_positions([[0.0, -2.0, -2.0]] * i
                                     + [[0.99, 0.0, 0.0]])
            else:
                c.clear_image()
                c.set_bbox_positions([])
        self.status.configure(
            text="Reconstruction loss (negative log-likelihood): "
                 f"{abs(float(loss[0])):.3f}")
        self.master.after(self.refresh_period, self._reconstruct)
