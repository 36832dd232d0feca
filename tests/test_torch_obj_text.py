"""The OBJ text formatter (``slr_torch.kernels.obj_text``) on the CPU: its
plain version, the kernel's integer digit arithmetic in int64 tensor ops,
against Python's f-strings byte for byte.

The spec is the OBJ writer the port had before the formatter
(``chip_smoke.fstring_obj_lines``: ``.tolist()`` widens each float32
exactly to a double, then ``format(x, ".6f")`` / ``".4f"``), and the edge
table ``chip_smoke.OBJ_EDGES`` / ``OBJ_EDGE_FACES``, the card's cases too.
Cases: the edge table (signed zeros,
tiny negatives, ties at the 7th and 5th decimal, carries into a new
integer digit, subnormals, the largest magnitudes inside the domain, NaN
and infinities, face indices up to 2^31 - 2), a seeded sweep of 2^20
float32 values (millimetre coordinates and random bit patterns inside the
domain), and ``write_tsdf_mesh_obj``'s whole file, with and without
colours. The kernel itself is held to this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``obj_text_vs_plain``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (OBJ_BEYOND4, OBJ_BEYOND6, OBJ_EDGE_FACES, OBJ_EDGES, OBJ_HEADER,
                        OBJ_LIMIT4, OBJ_LIMIT6, fstring_obj_lines)
from slr_torch.kernels import obj_text as ot
from slr_torch.pipeline import tsdf

torch.set_num_threads(2)


NO_FACES = torch.zeros((0, 3), dtype=torch.int32)


def _same_as_spec(verts, cols, faces):
    want = fstring_obj_lines(verts, cols, faces)
    ends = ot.line_ends(verts, cols, faces)
    n = ot.text_length(ends)
    got = ot.to_host(ot.write_text(verts, cols, faces, ends, n)).numpy().tobytes()
    assert n == len(want)
    assert got == want
    # every line's end where the spec's line ends
    stops = np.cumsum([len(line) for line in want.decode().splitlines(keepends=True)])
    np.testing.assert_array_equal(ends[:-1].numpy(), stops)
    assert int(ends[-1]) == n


@pytest.mark.parametrize("with_colors", [True, False])
@pytest.mark.parametrize("edge", sorted(OBJ_EDGES))
def test_edge_values_match_fstrings(edge, with_colors):
    x = OBJ_EDGES[edge]
    xs = torch.from_numpy(np.resize(x, 3 * len(x)).reshape(-1, 3).copy())
    # each value in each column, and as a colour (.4f)
    verts = torch.cat([xs, xs.roll(1, 1), xs.roll(2, 1)])
    cols = torch.from_numpy(np.resize(x, verts.shape[0]).copy()) if with_colors else None
    if edge == "largest_in_domain" and with_colors:
        cols = torch.from_numpy(np.resize(np.array([OBJ_LIMIT4, -OBJ_LIMIT4, 1e14, 0.5],
                                                   np.float32), verts.shape[0]))
    _same_as_spec(verts, cols, NO_FACES)


@pytest.mark.parametrize("faces", OBJ_EDGE_FACES)
def test_face_indices_match_fstrings(faces):
    f = torch.tensor(faces, dtype=torch.int32)
    _same_as_spec(torch.tensor([[1.5, -2.25, 0.0]]), torch.tensor([0.25]), f)


@pytest.mark.parametrize("kind,seed", [("mm", 0), ("mm", 1), ("bits", 2), ("bits", 3)])
def test_seeded_sweep_matches_fstrings(kind, seed):
    """2^18 float32 values a case (2^20 over the four): millimetre
    coordinates of a scan volume, or any bit pattern inside the domain."""
    rng = np.random.default_rng(seed)
    n = 1 << 18
    if kind == "mm":
        x = (rng.uniform(-2000.0, 2000.0, n) * 10.0 ** rng.integers(-6, 1, n)).astype(np.float32)
    else:
        x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
        x = np.where(np.abs(x) < OBJ_LIMIT6, x, rng.uniform(-1e4, 1e4, n).astype(np.float32))
        x[::997] = np.nan
    verts = torch.from_numpy(np.ascontiguousarray(x[: n - n % 3].reshape(-1, 3)))
    cols = torch.from_numpy(x[: verts.shape[0]].copy()) if seed % 2 else None
    faces = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (4096, 3)).astype(np.int32))
    _same_as_spec(verts, cols, faces)


@pytest.mark.parametrize("verts,cols", [
    ([[OBJ_BEYOND6, 0.0, 0.0]], None),
    ([[0.0, -OBJ_BEYOND6, 0.0]], [0.5]),
    ([[0.0, 0.0, 3.4e38]], None),
    ([[1.0, 2.0, 3.0]], [OBJ_BEYOND4]),
    ([[1.0, 2.0, 3.0]], [-1e16]),
])
def test_outside_the_domain_raises(verts, cols):
    v = torch.tensor(verts, dtype=torch.float32)
    c = None if cols is None else torch.tensor(cols, dtype=torch.float32)
    ends = ot.line_ends(v, c, NO_FACES)
    with pytest.raises(ValueError, match="domain"):
        ot.text_length(ends)
    with pytest.raises(ValueError, match="domain"):
        ot.format_obj(v, c, NO_FACES)


def test_empty_mesh_and_bad_inputs():
    empty = torch.zeros((0, 3), dtype=torch.float32)
    assert ot.format_obj(empty, None, NO_FACES).numel() == 0
    assert ot.format_obj(empty, torch.zeros(0), NO_FACES).numel() == 0
    with pytest.raises(ValueError, match="contiguous"):
        ot.line_ends(torch.zeros((2, 3), dtype=torch.float64), None, NO_FACES)
    with pytest.raises(ValueError, match="contiguous"):
        ot.line_ends(torch.zeros((2, 3)), torch.zeros(3), NO_FACES)
    with pytest.raises(ValueError, match="contiguous"):
        ot.line_ends(torch.zeros((2, 3)), None, torch.zeros((1, 3), dtype=torch.int64))


def _sphere_volume(n=24, voxel=2.0):
    """A sphere's truncated distance on an n^3 grid, colour by height."""
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float32),) * 3, indexing="ij")
    c = (n - 1) / 2
    d = torch.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) * voxel
    trunc = 3 * voxel
    sdf = torch.clamp((0.35 * n * voxel - d) / trunc, -1.0, 1.0)
    weight = torch.ones_like(sdf) * 2.0
    color = (z / n * 1.4 - 0.2) * weight        # some colours clip at 0 and 1
    return tsdf.TSDFVolume(sdf, weight, color, torch.tensor([-40.0, 12.5, 480.0]),
                           torch.tensor(voxel), torch.tensor(trunc))


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_tsdf_mesh_obj_file_matches_fstring_writer(tmp_path, with_colors):
    vol = _sphere_volume()
    got = tsdf.write_tsdf_mesh_obj(tmp_path / "m.obj", vol, with_colors=with_colors)
    if with_colors:
        verts, faces, cols = tsdf.extract_mesh(vol, with_colors=True)
        cols = torch.clamp(cols, 0.0, 1.0)
    else:
        (verts, faces), cols = tsdf.extract_mesh(vol), None
    assert got == (verts.shape[0], faces.shape[0]) and faces.shape[0] > 100
    want = OBJ_HEADER + fstring_obj_lines(verts, cols, faces)
    assert (tmp_path / "m.obj").read_bytes() == want
