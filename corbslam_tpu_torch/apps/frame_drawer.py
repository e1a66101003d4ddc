"""Annotated-frame drawing — the FrameDrawer capability (port of
`corbslam_tpu/apps/frame_drawer.py`; it reads the port's tensors on the
host with `host`).

The reference's `FrameDrawer` (ref: corbslam_client/src/FrameDrawer.cc:
DrawFrame draws each tracked keypoint as a rectangle+dot — green for
map-point matches, blue for visual-odometry-only points — and DrawTextInfo
:150 writes the status bar "SLAM MODE | KFs: n, MPs: m, Matches: k").
Here the same annotation is rasterized into an RGB numpy array with no GUI
dependency: pure-host post-processing of the tracker's retired frame state
(keypoint xy, mp_idx bindings, TrackState), suitable for dumping PNG
sequences or streaming.

    drawer = FrameDrawer()
    rgb = drawer.draw(img_gray, tracker)      # after process_stereo(...)
    save_png(rgb, "frame_000123.png")
"""

from __future__ import annotations

import numpy as np


def host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array on the host."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


GREEN = np.array([40, 220, 60], np.uint8)    # tracked map point
BLUE = np.array([80, 120, 255], np.uint8)    # detected, unmatched
RED = np.array([230, 60, 50], np.uint8)      # LOST banner
WHITE = np.array([245, 245, 245], np.uint8)

# 5x3 bitmap glyphs for the status text (digits + the few letters used).
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", "K": "101110100110101", "F": "111100110100100",
    "M": "101111111101101", "P": "111101111100100", "S": "111100111001111",
    "L": "100100100100111", "A": "010101111101101", "O": "111101101101111",
    "T": "111010010010010", "k": "101110110101101", " ": "000000000000000",
    ":": "000010000010000", "|": "010010010010010", "-": "000000111000000",
}


def _draw_text(rgb: np.ndarray, text: str, x: int, y: int,
               color=WHITE, scale: int = 2) -> None:
    """Rasterize `text` at (x, y) top-left with the 5x3 bitmap font."""
    h, w, _ = rgb.shape
    cx = x
    for ch in text:
        g = _GLYPHS.get(ch, _GLYPHS[" "])
        for r in range(5):
            for c in range(3):
                if g[r * 3 + c] == "1":
                    y0, x0 = y + r * scale, cx + c * scale
                    rgb[max(0, y0):min(h, y0 + scale),
                        max(0, x0):min(w, x0 + scale)] = color
        cx += 4 * scale


def _draw_rect(rgb: np.ndarray, x: float, y: float, r: int, color) -> None:
    h, w, _ = rgb.shape
    xi, yi = int(round(x)), int(round(y))
    x0, x1 = max(0, xi - r), min(w - 1, xi + r)
    y0, y1 = max(0, yi - r), min(h - 1, yi + r)
    if x1 <= x0 or y1 <= y0:
        return
    rgb[y0, x0:x1 + 1] = color
    rgb[y1, x0:x1 + 1] = color
    rgb[y0:y1 + 1, x0] = color
    rgb[y0:y1 + 1, x1] = color
    # center dot
    rgb[max(0, yi - 1):min(h, yi + 2), max(0, xi - 1):min(w, xi + 2)] = color


class FrameDrawer:
    """Stateless frame annotator over a tracker's retired frame."""

    def draw(self, img_gray, tracker) -> np.ndarray:
        """Annotate the last retired frame of a StereoTracker (or any object
        with .last_frame/.state/.map/.stats). `img_gray` is the [H, W] image
        that produced that frame (uint8 or float)."""
        tracker.flush()
        f = tracker.last_frame
        img = host(img_gray)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        rgb = np.repeat(img[:, :, None], 3, axis=2).copy()
        if f is None:
            return rgb

        xy = host(f.xy)
        fv = host(f.fvalid)
        tracked = fv & (host(f.mp_idx) >= 0)
        octave = host(f.octave)
        n_tracked = 0
        for i in np.nonzero(fv)[0]:
            r = 3 + int(octave[i])
            if tracked[i]:
                _draw_rect(rgb, xy[i, 0], xy[i, 1], r, GREEN)
                n_tracked += 1
            else:
                _draw_rect(rgb, xy[i, 0], xy[i, 1], 2, BLUE)

        # Status bar (DrawTextInfo, FrameDrawer.cc:150): darken a strip,
        # write mode + counts.
        from ..frontend.tracking import TrackState

        h = rgb.shape[0]
        rgb[h - 18:h] = (rgb[h - 18:h] * 0.25).astype(np.uint8)
        state = tracker._state
        n_kf = int(tracker.stats.n_keyframes)
        n_mp = int(host(tracker.map.mp.valid).sum())
        if state == TrackState.LOST:
            _draw_text(rgb, "LOST", 6, h - 14, RED)
        else:
            _draw_text(rgb, "SLAM", 6, h - 14, WHITE)
        _draw_text(
            rgb, f"| KF:{n_kf} MP:{n_mp} T:{n_tracked}", 50, h - 14, WHITE)
        return rgb


def png_bytes(rgb: np.ndarray) -> bytes:
    """Minimal PNG encoder (no imaging dependency): zlib + struct."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(rgb: np.ndarray, path: str) -> str:
    with open(path, "wb") as fp:
        fp.write(png_bytes(rgb))
    return path
