"""OpenCV cv::FileStorage YAML compatibility, read and write (port of
``slr/io/opencv_fs.py``).

Calibration files in the cv::FileStorage layout load directly and export
back, without cv2 at run time (cv2 is only the parity oracle of the
tests). Supported subset: scalars (int/float/string), flat sequences,
nested maps and ``!!opencv-matrix`` nodes ``{rows, cols, dt, data}``.
Matrices parse to ``np.ndarray``; writing emits cv2-parseable
``%YAML:1.0``. Pure text and numpy; the calibration adapters take and
return the port's cameras.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from slr_torch.device import require_device
from slr_torch.geom.camera import make_camera
from slr_torch.io.checkpoint import as_numpy

_DT = {"f": np.float32, "d": np.float64, "i": np.int32, "u": np.uint8,
       "s": np.int16, "w": np.uint16}
_DT_INV = {np.dtype(np.float32): "f", np.dtype(np.float64): "d",
           np.dtype(np.int32): "i", np.dtype(np.uint8): "u",
           np.dtype(np.int16): "s", np.dtype(np.uint16): "w"}


# ---------------------------------------------------------------- writing

def _fmt_scalar(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return f"{f:.1f}"  # cv2 style: trailing .0 keeps it a float
        return repr(f)
    return f'"{v}"'


def _write_matrix(lines, key, arr, indent):
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[None, :]
    dt = _DT_INV.get(arr.dtype)
    if dt is None:
        arr = arr.astype(np.float64)
        dt = "d"
    pad = " " * indent
    lines.append(f"{pad}{key}: !!opencv-matrix")
    lines.append(f"{pad}   rows: {arr.shape[0]}")
    lines.append(f"{pad}   cols: {arr.shape[1]}")
    lines.append(f'{pad}   dt: {dt}')
    data = ", ".join(_fmt_scalar(x) for x in arr.reshape(-1).tolist())
    lines.append(f"{pad}   data: [ {data} ]")


def _write_node(lines, key, v, indent):
    pad = " " * indent
    if isinstance(v, np.ndarray) or (
        isinstance(v, (list, tuple)) and v
        and isinstance(v[0], (list, tuple, np.ndarray))
    ):
        _write_matrix(lines, key, np.asarray(v), indent)
    elif isinstance(v, dict):
        lines.append(f"{pad}{key}:")
        for k2, v2 in v.items():
            _write_node(lines, k2, v2, indent + 3)
    elif isinstance(v, (list, tuple)):
        data = ", ".join(_fmt_scalar(x) for x in v)
        lines.append(f"{pad}{key}: [ {data} ]")
    else:
        lines.append(f"{pad}{key}: {_fmt_scalar(v)}")


def write_opencv_yaml(path, nodes: dict) -> None:
    """Write a dict of {name: scalar | list | ndarray | dict} as
    cv::FileStorage-compatible YAML. 2-D (or 1-D, stored as 1×N) float/int
    arrays become ``!!opencv-matrix`` nodes."""
    lines = ["%YAML:1.0", "---"]
    for k, v in nodes.items():
        _write_node(lines, k, v, 0)
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------- reading

def _parse_scalar(tok: str):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _parse_flow_seq(s: str):
    body = s.strip()
    assert body.startswith("[") and body.endswith("]"), s
    body = body[1:-1].strip()
    if not body:
        return []
    return [_parse_scalar(t) for t in body.split(",")]


def read_opencv_yaml(path) -> dict:
    """Parse a cv::FileStorage YAML file into a dict; ``!!opencv-matrix``
    nodes become np.ndarray of the declared dtype and shape."""
    text = Path(path).read_text()
    # strip directive/doc markers and comments
    lines = []
    for raw in text.splitlines():
        if raw.strip().startswith(("%YAML", "---")):
            continue
        # drop comments (naive: '#' not inside quotes — fine for cv2 output)
        if '"' not in raw:
            raw = raw.split("#", 1)[0]
        if raw.strip():
            lines.append(raw.rstrip())

    # join continuation lines of flow sequences: data: [ 1., 2.,\n  3. ]
    joined: list[str] = []
    for ln in lines:
        if joined and joined[-1].count("[") > joined[-1].count("]"):
            joined[-1] += " " + ln.strip()
        else:
            joined.append(ln)

    def parse_block(idx: int, indent: int):
        out: dict = {}
        while idx < len(joined):
            ln = joined[idx]
            cur = len(ln) - len(ln.lstrip())
            if cur < indent:
                break
            if cur > indent:  # stray deeper line (shouldn't happen)
                idx += 1
                continue
            m = re.match(r"([^:]+):\s*(.*)$", ln.strip())
            if not m:
                idx += 1
                continue
            key, rest = m.group(1).strip(), m.group(2).strip()
            if rest == "!!opencv-matrix" or rest == "":
                sub, idx = parse_block(idx + 1, -1 if idx + 1 >= len(joined)
                                       else len(joined[idx + 1])
                                       - len(joined[idx + 1].lstrip()))
                if rest == "!!opencv-matrix" or (
                    isinstance(sub, dict) and {"rows", "cols", "dt", "data"}
                    <= set(sub)
                ):
                    dt = _DT.get(str(sub["dt"]), np.float64)
                    arr = np.asarray(sub["data"], dtype=dt)
                    out[key] = arr.reshape(int(sub["rows"]), int(sub["cols"]))
                else:
                    out[key] = sub
            elif rest.startswith("["):
                out[key] = _parse_flow_seq(rest)
                idx += 1
            else:
                out[key] = _parse_scalar(rest)
                idx += 1
        return out, idx

    nodes, _ = parse_block(0, 0)
    return nodes


# ------------------------------------------------- calibration adapters

def save_calibration_opencv(path, cam, proj, meta: dict | None = None):
    """Export a (camera, projector) rig in the cv::FileStorage layout:
    camera_matrix / distortion_coefficients per device plus the
    camera -> projector relative extrinsics R, T (the cv::stereoCalibrate
    contract)."""

    def K(c):
        return np.asarray(
            [[float(c.fx), 0.0, float(c.cx)],
             [0.0, float(c.fy), float(c.cy)],
             [0.0, 0.0, 1.0]], np.float64)

    Rc = as_numpy(cam.R).astype(np.float64)
    tc = as_numpy(cam.t).astype(np.float64)
    Rp = as_numpy(proj.R).astype(np.float64)
    tp = as_numpy(proj.t).astype(np.float64)
    # relative pose mapping camera coords -> projector coords
    R_rel = Rp @ Rc.T
    t_rel = tp - R_rel @ tc
    nodes = {
        "camera_matrix": K(cam),
        "distortion_coefficients": as_numpy(cam.dist).astype(np.float64)[None, :],
        "projector_matrix": K(proj),
        "projector_distortion": as_numpy(proj.dist).astype(np.float64)[None, :],
        "R": R_rel,
        "T": t_rel[:, None],
        "cam_R": Rc, "cam_T": tc[:, None],
    }
    for k, v in (meta or {}).items():
        if isinstance(v, (int, float, str)):
            nodes[f"meta_{k}"] = v
    write_opencv_yaml(path, nodes)


def load_calibration_opencv(path, device="cuda"):
    """Load a cv::FileStorage-style calibration file (ours, or one written
    by cv2) into (camera, projector, meta), the cameras on ``device`` (the
    card unless the caller asks for the CPU).

    Accepts the common key spellings: camera_matrix / cameraMatrix / M1,
    distortion_coefficients / distCoeffs / D1, projector_matrix / M2, R, T.
    Without per-device world poses (cam_R/cam_T) the camera sits at the
    world origin and the projector at the relative pose, the usual
    convention of a stereo YAML."""
    device = require_device(device)
    nodes = read_opencv_yaml(path)

    def pick(*names, default=None):
        for n in names:
            if n in nodes:
                return nodes[n]
        return default

    Kc = pick("camera_matrix", "cameraMatrix", "M1")
    Dc = pick("distortion_coefficients", "distCoeffs", "D1",
              default=np.zeros((1, 5)))
    Kp = pick("projector_matrix", "projectorMatrix", "M2", default=Kc)
    Dp = pick("projector_distortion", "D2", default=np.zeros((1, 5)))
    R = pick("R", default=np.eye(3))
    T = np.asarray(pick("T", default=np.zeros((3, 1)))).reshape(3)
    Rc = pick("cam_R", default=np.eye(3))
    tc = np.asarray(pick("cam_T", default=np.zeros((3, 1)))).reshape(3)

    def cam_of(K, D, Rw, tw):
        K = np.asarray(K, np.float64)
        D = np.asarray(D, np.float64).reshape(-1)[:5]
        return make_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                           dist=D.astype(np.float32),
                           R=np.asarray(Rw, np.float32),
                           t=np.asarray(tw, np.float32), device=device)

    Rp = np.asarray(R) @ np.asarray(Rc)
    tp = np.asarray(R) @ np.asarray(tc) + T
    meta = {k[5:]: v for k, v in nodes.items() if k.startswith("meta_")}
    return cam_of(Kc, Dc, Rc, tc), cam_of(Kp, Dp, Rp, tp), meta
