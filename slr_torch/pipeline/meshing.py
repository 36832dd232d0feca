"""Minimal meshing of organized scan clouds (port of ``slr/pipeline/meshing.py``).

An organized (H, W) cloud meshes directly: each 2x2 pixel quad yields up to
two triangles when all their corners are valid and no edge spans a depth
discontinuity. Faces are index triples computed on the cloud's device; the
OBJ writer compacts them on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_faces(points, mask, max_edge: float = 5.0):
    """Triangle faces over an organized cloud (H, W, 3), mask (H, W).

    Returns (faces (2*(H-1)*(W-1), 3) int32 flat pixel indices, face_valid
    (2*(H-1)*(W-1),) bool): every quad's (p00, p10, p01) first, then every
    quad's (p01, p10, p11). A face is valid when its three corners are
    valid and every edge is shorter than ``max_edge``.
    """
    H, W = mask.shape
    idx = torch.arange(H * W, dtype=torch.int32, device=points.device).reshape(H, W)

    def edge_ok(a, b):
        return torch.linalg.norm(a - b, dim=-1) < max_edge

    p00, p01, p10, p11 = points[:-1, :-1], points[:-1, 1:], points[1:, :-1], points[1:, 1:]
    m00, m01, m10, m11 = mask[:-1, :-1], mask[:-1, 1:], mask[1:, :-1], mask[1:, 1:]
    i00, i01, i10, i11 = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    t1_ok = m00 & m10 & m01 & edge_ok(p00, p10) & edge_ok(p10, p01) & edge_ok(p01, p00)
    t2_ok = m01 & m10 & m11 & edge_ok(p01, p10) & edge_ok(p10, p11) & edge_ok(p11, p01)
    faces = torch.cat([torch.stack([i00, i10, i01], dim=-1).reshape(-1, 3),
                       torch.stack([i01, i10, i11], dim=-1).reshape(-1, 3)])
    return faces, torch.cat([t1_ok.reshape(-1), t2_ok.reshape(-1)])


def write_mesh_obj(path, points, mask, max_edge: float = 5.0,
                   colors=None) -> tuple[int, int]:
    """Mesh an organized cloud and write an OBJ with faces; returns
    (n_vertices, n_faces). The vertices are the valid pixels in row-major
    order, and the face indices are remapped to them."""
    faces, fvalid = grid_faces(points, mask, max_edge=max_edge)
    pts = points.reshape(-1, 3).cpu().numpy()
    m = mask.reshape(-1).cpu().numpy()
    faces = faces[fvalid].cpu().numpy()
    remap = -np.ones(m.shape[0], np.int64)
    remap[m] = np.arange(int(m.sum()))
    v = pts[m].tolist()
    f = remap[faces].tolist()
    if colors is None:
        lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in v]
    else:
        col = np.clip(colors.reshape(-1).cpu().numpy()[m], 0.0, 1.0).tolist()
        lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c:.4f} {c:.4f} {c:.4f}\n"
                 for p, c in zip(v, col)]
    lines += [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f]
    with open(path, "w") as fh:
        fh.write("# slr mesh export\n")
        fh.writelines(lines)
    return len(v), len(f)
