"""Visualization: BEV canvas and image-space box rendering on the host
(counterpart of ``detmatch_tpu/utils/visualize.py``; the reference's
Vis3D / Vis2D_Kitti SSL consumers, ``ssl_modules/consumers/
visualize.py:40-310``), in numpy alone, and a PNG writer.

Lines are drawn as OpenCV draws a 1-pixel ``LINE_8`` line: the end points
clipped to the image as ``cv::clipLine`` clips them, then the 8-connected
Bresenham walk of ``cv::LineIterator`` from the left end. A polygon
(``cv2.polylines``) and a rectangle (``cv2.rectangle``) are their closed
chains of such lines, drawn in OpenCV's order, so the pixels equal
``cv2``'s. Score text is not OpenCV's Hershey font: it is set in a
built-in 3 x 5 bitmap font (digits, ``.``, ``d``, space), its bottom row
one pixel above the text origin, so its pixels differ from ``cv2.putText``'s.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..data.np_geometry import boxes_3d_to_2d, boxes_to_corners_bev

CLASS_COLORS = ((66, 135, 245), (245, 179, 66), (66, 245, 114))  # BGR-ish

# 3 x 5 glyphs, rows top to bottom, bit 2 the left column
_FONT = {
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
    "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
    "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 1, 1), "8": (7, 5, 7, 5, 7),
    "9": (7, 5, 7, 1, 7), ".": (0, 0, 0, 0, 2), "d": (1, 1, 7, 5, 7),
    " ": (0, 0, 0, 0, 0), "-": (0, 0, 7, 0, 0),
}


def _clip_line(w, h, x1, y1, x2, y2):
    """``cv::clipLine`` on a (w, h) image: the segment's end points moved
    onto the image border (integer arithmetic, divisions truncated toward
    zero as OpenCV's int64 casts), or None if it misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def line_pixels(w, h, p1, p2):
    """The (xs, ys) pixels of a 1-pixel 8-connected line from ``p1`` to
    ``p2`` on a (w, h) image (``cv::LineIterator``, left to right)."""
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    xs, ys = np.empty(dx + 1, np.int64), np.empty(dx + 1, np.int64)
    x, y = x1, y1
    for i in range(dx + 1):
        xs[i], ys[i] = x, y
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0
    return xs, ys


def draw_line(img, p1, p2, color):
    """``cv2.line(img, p1, p2, color, 1)`` in place."""
    xs, ys = line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[ys, xs] = color


def draw_polyline(img, pts, color, closed=True):
    """``cv2.polylines(img, [pts], closed, color, 1)`` in place."""
    pts = [tuple(int(v) for v in p) for p in np.asarray(pts).reshape(-1, 2)]
    if not pts:
        return
    prev = pts[-1] if closed else pts[0]
    for p in pts[0 if closed else 1:]:
        draw_line(img, prev, p, color)
        prev = p


def draw_rectangle(img, p1, p2, color):
    """``cv2.rectangle(img, p1, p2, color, 1)`` in place."""
    (x1, y1), (x2, y2) = p1, p2
    draw_polyline(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], color)


def draw_text(img, text, org, color):
    """``text`` in the built-in 3 x 5 font, its bottom row on row
    ``org[1] - 1``, from column ``org[0]``, one blank column between
    glyphs; characters outside the font are skipped; clipped to the
    image."""
    h, w = img.shape[:2]
    x0, y_bottom = int(org[0]), int(org[1]) - 1
    for ch in text:
        rows = _FONT.get(ch)
        if rows is None:
            continue
        for r, bits in enumerate(rows):
            y = y_bottom - 4 + r
            for c in range(3):
                x = x0 + c
                if bits & (4 >> c) and 0 <= x < w and 0 <= y < h:
                    img[y, x] = color
        x0 += 4


def bev_canvas(points, boxes_list, colors=None,
               point_cloud_range=(0, -40, -3, 70.4, 40, 1),
               canvas_hw=(800, 704)):
    """Render points + box sets onto a BEV canvas.

    Args:
        points: (N, 3+) lidar points.
        boxes_list: sequence of boxes (M, 7) or (boxes, valid (M,) or
            None) sets.
    Returns:
        (H, W, 3) uint8.
    """
    h, w = canvas_hw
    pcr = np.asarray(point_cloud_range, np.float32)
    img = np.zeros((h, w, 3), np.uint8)

    def to_px(xy):
        u = (xy[:, 0] - pcr[0]) / (pcr[3] - pcr[0]) * (h - 1)
        v = (xy[:, 1] - pcr[1]) / (pcr[4] - pcr[1]) * (w - 1)
        return np.stack([v, (h - 1) - u], axis=-1).astype(np.int32)

    if points is not None and len(points):
        px = to_px(points[:, :2])
        ok = ((px[:, 0] >= 0) & (px[:, 0] < w)
              & (px[:, 1] >= 0) & (px[:, 1] < h))
        img[px[ok, 1], px[ok, 0]] = (90, 90, 90)

    colors = colors or [(0, 255, 0), (0, 128, 255), (255, 64, 64)]
    for si, entry in enumerate(boxes_list):
        boxes, valid = entry if isinstance(entry, tuple) else (entry, None)
        if boxes is None or len(boxes) == 0:
            continue
        corners = boxes_to_corners_bev(np.asarray(boxes, np.float32))
        for i, c in enumerate(corners):
            if valid is not None and not valid[i]:
                continue
            draw_polyline(img, to_px(c), colors[si % len(colors)])
    return img


def draw_boxes_2d(img_bgr, boxes, labels=None, scores=None, valid=None):
    """Draw xyxy boxes on an image (uint8 BGR, copied); ``scores`` as
    text above each box."""
    out = np.ascontiguousarray(np.asarray(img_bgr, np.uint8).copy())
    for i, b in enumerate(np.asarray(boxes)):
        if valid is not None and not valid[i]:
            continue
        color = CLASS_COLORS[int(labels[i]) % 3] if labels is not None \
            else (0, 255, 0)
        p1, p2 = (int(b[0]), int(b[1])), (int(b[2]), int(b[3]))
        draw_rectangle(out, p1, p2, color)
        if scores is not None:
            draw_text(out, f"{float(scores[i]):.2f}",
                      (p1[0], max(p1[1] - 2, 8)), color)
    return out


CAFFE_MEAN = np.array([103.530, 116.280, 123.675], np.float32)  # BGR


def denormalize_caffe(img, mean=CAFFE_MEAN):
    """Invert the caffe normalization for display."""
    return np.clip(np.asarray(img) + np.asarray(mean), 0, 255
                   ).astype(np.uint8)


def matched_pair_canvas(img_bgr, boxes3d, boxes2d, valid, lidar2img,
                        img_shape, scores3d=None, scores2d=None):
    """Matched teacher 3D↔2D pair canvas (the reference's Vis2D_Kitti
    consumer): each fusion-matched pair drawn as the PROJECTED 3D box
    (green) and its matched 2D box (orange) joined center to center,
    annotated with both scores.

    Args:
        img_bgr: (H, W, 3) uint8; boxes3d: (M, 7) internal lidar boxes;
        boxes2d: (M, 4) xyxy; valid: (M,) pair validity (None: the
        projection's); lidar2img: (4, 4); img_shape: (h, w).
    Returns:
        (H, W, 3) uint8.
    """
    out = np.ascontiguousarray(np.asarray(img_bgr, np.uint8).copy())
    boxes3d = np.asarray(boxes3d, np.float32)
    boxes2d = np.asarray(boxes2d, np.float32)
    if len(boxes3d) == 0:
        return out
    boxes_p, proj_valid = boxes_3d_to_2d(
        boxes3d, np.asarray(lidar2img, np.float32),
        np.asarray(img_shape, np.float32))
    if valid is None:
        valid = proj_valid
    for i in range(len(boxes3d)):
        if not valid[i]:
            continue
        p3, p2 = boxes_p[i], boxes2d[i]
        draw_rectangle(out, (int(p3[0]), int(p3[1])),
                       (int(p3[2]), int(p3[3])), (0, 255, 0))
        draw_rectangle(out, (int(p2[0]), int(p2[1])),
                       (int(p2[2]), int(p2[3])), (0, 160, 255))
        c3 = (int((p3[0] + p3[2]) / 2), int((p3[1] + p3[3]) / 2))
        c2 = (int((p2[0] + p2[2]) / 2), int((p2[1] + p2[3]) / 2))
        draw_line(out, c3, c2, (255, 255, 255))
        txt = []
        if scores3d is not None:
            txt.append(f"3d{float(np.max(scores3d[i])):.2f}")
        if scores2d is not None:
            txt.append(f"2d{float(np.max(scores2d[i])):.2f}")
        if txt:
            draw_text(out, " ".join(txt), (c3[0], max(c3[1] - 4, 8)),
                      (255, 255, 255))
    return out


def write_png(path, img):
    """(H, W, 3) uint8 RGB → an 8-bit PNG file (zlib, no filter)."""
    h, w, _ = img.shape
    img = np.ascontiguousarray(img, np.uint8)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def write_png_bgr(path, img):
    """A BGR uint8 picture (cv2's order, as the JAX tools' ``cv2.imwrite``)
    → an RGB PNG (:func:`write_png`)."""
    write_png(path, np.asarray(img, np.uint8)[:, :, ::-1])


def read_png(path):
    """An 8-bit RGB PNG as :func:`write_png` writes it (one IDAT, no
    filter) → (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3).copy()
