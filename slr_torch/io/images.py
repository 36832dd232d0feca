"""Per-scan image-folder IO, the capture layout (port of
``slr/io/images.py``).

A scan is a directory of numbered frames, one per projected pattern,
loaded into a single (F, H, W) float32 stack in [0, 1]. Formats: PNG
through cv2 (imported only where a PNG is read or written) and binary PGM
(a numpy codec, always available). 16-bit PNG/PGM round-trips losslessly
for HDR rigs. Pure numpy: the caller puts the stack on its device.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from slr_torch.io.checkpoint import as_numpy

_FRAME_RE = re.compile(r"(\d+)\D*\.(png|pgm|ppm|bmp|jpg|jpeg|tif|tiff)$",
                       re.IGNORECASE)


# ------------------------------------------------------------- PGM codec

def write_pgm(path, img: np.ndarray) -> None:
    """Binary PGM (P5). float inputs in [0,1] are encoded as uint16."""
    img = as_numpy(img)
    if img.dtype in (np.float32, np.float64):
        img = np.clip(img, 0.0, 1.0)
        img = (img * 65535.0 + 0.5).astype(np.uint16)
    maxval = 255 if img.dtype == np.uint8 else 65535
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
        # PGM 16-bit is big-endian per spec
        f.write(img.astype(">u2" if maxval == 65535 else np.uint8).tobytes())


def read_pgm(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval — whitespace/comment separated
    toks, i = [], 0
    while len(toks) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[i:])
        if m is None:
            raise ValueError(f"truncated PGM header in {path}")
        i += m.end()
        if not m.group(1).startswith(b"#"):
            toks.append(m.group(1))
    magic, w, h, maxval = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
    if magic != b"P5":
        raise ValueError(f"not a binary PGM: {path}")
    i += 1  # exactly one whitespace byte separates maxval from pixel data
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    pix = np.frombuffer(data[i:], dtype=dt, count=w * h).reshape(h, w)
    return pix


def _to_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype.kind == "u":
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


# --------------------------------------------------------- folder contract

def save_scan_folder(folder, frames, fmt: str = "pgm",
                     prefix: str = "frame") -> list:
    """Write an (F, H, W) stack (float [0,1] or uint) as numbered frame
    files, one per projected pattern — the reference's scan-folder layout."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    frames = as_numpy(frames)
    paths = []
    for i, img in enumerate(frames):
        p = folder / f"{prefix}_{i:03d}.{fmt}"
        if fmt == "pgm":
            write_pgm(p, img)
        else:
            import cv2
            out = img
            if out.dtype in (np.float32, np.float64):
                out = (np.clip(out, 0, 1) * 65535 + 0.5).astype(np.uint16)
            if not cv2.imwrite(str(p), out):
                raise IOError(f"cv2.imwrite failed for {p}")
        paths.append(p)
    return paths


def load_scan_folder(folder) -> np.ndarray:
    """Load a scan folder into an (F, H, W) float32 stack in [0, 1].

    Frames are ordered by the integer embedded in each filename (the
    reference numbers capture files by pattern index); color images are
    converted to luma.  Raises on missing/odd-sized frames so a corrupt
    capture fails loudly instead of decoding garbage.
    """
    folder = Path(folder)
    entries = []
    for p in sorted(folder.iterdir()):
        m = _FRAME_RE.search(p.name)
        if m:
            entries.append((int(m.group(1)), p))
    if not entries:
        raise FileNotFoundError(f"no numbered frame images in {folder}")
    entries.sort()
    imgs = []
    for _, p in entries:
        if p.suffix.lower() == ".pgm":
            img = read_pgm(p)
        else:
            import cv2
            img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            if img is None:
                raise IOError(f"cv2 could not read {p}")
            if img.ndim == 3:  # BGR -> luma
                img = (0.114 * img[..., 0] + 0.587 * img[..., 1]
                       + 0.299 * img[..., 2]).astype(img.dtype)
        imgs.append(_to_float(np.asarray(img)))
    shapes = {im.shape for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent frame shapes in {folder}: {shapes}")
    return np.stack(imgs).astype(np.float32)
