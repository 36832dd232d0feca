"""The two-camera merge's spans and its tiled route, on the CPU.

A 256x192 two-camera rig (256x192 projector, 5 + 5 Gray bits, 3-step phase
on both axes, cast shadows, uint8 frames) rendered by ``slr_torch.synth``.
The route rule is forced to the tiled route (``FUSED_BUDGET`` 0), the one
a 2448x2048 pair takes on the card (``crossing_interp``: the pairs and
their payload, K6's bin sums, the unpack). The merge is held to the plain
reference of the benchmark's ``merge_twocam_5mp`` cell
(``portbench/reference/twocam.py``) under that cell's configuration's
decode thresholds and tolerances. As in ``portbench/tests``, the program
decodes by K1's plain version with the card's rounding of ``phi + 2 pi
order`` (one FMA, as the reference), the arithmetic the card runs; the
CPU's ``decode_stack`` differs from it by an ulp now and then.

The span trees: one ``scan`` root a merge, its stages by name, and the
crossing passes' spans on each route. On the CPU the merge decodes with
``decode_stack``, which reads nothing to the host: no wait.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench.reference import twocam as ref
from slr_torch import observability as obs
from slr_torch.codec.patterns import DecodeResult
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.kernels import fused_scan as fs
from slr_torch.pipeline import twocam as tw
from slr_torch.synth.render import quantize_frames, render_scan, two_camera_rig
from slr_torch.synth.scene import spheres_scene
from test_torch_observability import _leaves, _mark, _tree

torch.set_num_threads(2)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                     / "twocam_2448x2048.json").read_text())
CAM_W, CAM_H = 256, 192
PROJ_W, PROJ_H = 256, 192
PATTERN = dict(gray_bits=5, row_gray_bits=5, phase_steps=3, row_phase_steps=3)
CFG = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, **PATTERN)
DEC = DecodeConfig(**CONFIG["decode"])
REC = ReconstructConfig(**CONFIG["reconstruct"])
# the reference's configuration: the cell's, at the small rig's size
SMALL = {**CONFIG, "pattern": {**CONFIG["pattern"], **PATTERN},
         "projector": {"width": PROJ_W, "height": PROJ_H}}


def _rig(seed: int):
    c1, c2, proj = two_camera_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=PROJ_W, proj_h=PROJ_H)
    gen = torch.Generator().manual_seed(seed)
    frames = [quantize_frames(render_scan(c, proj, spheres_scene(c, CAM_H, CAM_W), CFG,
                                          noise_std=0.003, generator=gen,
                                          cast_shadows=True).frames)
              for c in (c1, c2)]
    return c1, c2, frames


def _merge(c1, c2, frames, **kw):
    return tw.reconstruct_two_camera(frames[0], frames[1], c1, c2, CFG, DEC, REC, **kw)


def _k1_decode(frames, cam, cfg, dec):
    o = fs.fused_decode_triangulate(frames, cam, None, cfg, dec, decode_only=True)
    return DecodeResult(x_p=o.x_p, y_p=o.y_p, mask=o.mask > 0.5, quality=o.quality)


def _unwrap_rounded_once(phi, code, bits, scale, period, fold):
    """K1's unwrap as the card computes it: phi + 2 pi order in one fused
    multiply-add (the plain version rounds the product and the sum)."""
    order = code - (phi >= math.pi).to(torch.int32)
    order = torch.where(order < 0, order + (1 << bits), order)
    two_pi = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))
    x = (phi.double() + two_pi * order.double()).float() * scale
    return torch.where(x > fold, x - period, x)


@pytest.fixture
def tiled(monkeypatch):
    """The route rule sends every crossing pass to the tiled route."""
    monkeypatch.setattr(tw, "FUSED_BUDGET", 0)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_tiled_merge_equals_the_plain_reference(seed, tiled, monkeypatch):
    monkeypatch.setattr(tw, "_decode", _k1_decode)
    monkeypatch.setattr(fs, "_unwrap_cyclic", _unwrap_rounded_once)
    c1, c2, frames = _rig(seed)
    mark = _mark()
    got = _merge(c1, c2, frames)
    names = [s.name for s in obs.snapshot().spans if s.id > mark]
    assert names.count("crossing.k6") == 4 and "crossing.k7" not in names
    want = ref.merge(frames[0], frames[1], ref.rig_cam(c1), ref.rig_cam(c2), SMALL)
    assert torch.equal(got.mask, want.mask)
    assert int(got.mask.sum()) > PROJ_W * PROJ_H // 2
    tol = CONFIG["checks"]["tolerances"]
    judged = (got.points, got.mask, got.colors, got.quality)
    assert ref.off_cell_share(judged, want, tol) == 0.0
    both = got.mask & want.mask
    assert float(torch.linalg.norm(got.points - want.points, dim=-1)[both].max()) \
        <= tol["points_mm"]
    assert float((got.quality - want.quality).abs().max()) <= tol["quality"]
    assert float((got.colors - want.colors)[both].abs().max()) <= tol["color"]


def _payload_bytes(rows: int, codes: int) -> int:
    """lo, hi and the 7-term payload of a pass over (rows, codes): 4 B each
    of 9 terms a pair."""
    return 4 * 9 * rows * (codes - 1)


@pytest.mark.parametrize("route", ["tiled", "fused"])
def test_merge_span_tree(route, monkeypatch):
    """One ``scan`` root a merge: both decodes, the edge masks, both
    cameras' inversions (two crossing passes each) and the midpoint. The
    tiled route records the pairs, K6's sums and the unpack of each pass,
    and counts the payload it built; the fused route one ``crossing.k7`` a
    pass, around K7's plain version on the CPU, which builds the same
    payload (K7 on the card builds none)."""
    if route == "tiled":
        monkeypatch.setattr(tw, "FUSED_BUDGET", 0)
    c1, c2, frames = _rig(5)
    before = obs.snapshot().counts.get("bytes.crossing_payload", 0)
    mark = _mark()
    _merge(c1, c2, frames)
    spans = [s for s in obs.snapshot().spans if s.id > mark]
    tiled = _leaves("crossing.pairs", "crossing.k6", "crossing.unpack")
    passes = tiled * 2 if route == "tiled" else [("crossing.k7", tiled)] * 2
    assert _tree(spans) == [("scan", [*_leaves("merge.decode", "merge.decode", "merge.edges"),
                                      ("merge.invert", passes), ("merge.invert", passes),
                                      ("merge.midpoint", [])])]
    assert sum(s.wait for s in spans) == 0
    assert len({s.request for s in spans}) == 1
    # from the shapes: pass 1 over the camera rows, pass 2 over the
    # projector columns' camera rows, for each camera
    payload = obs.snapshot().counts["bytes.crossing_payload"] - before
    assert payload == 2 * (_payload_bytes(CAM_H, CAM_W) + _payload_bytes(PROJ_W, CAM_H))


@pytest.mark.parametrize("method", ["splat", "search"])
def test_oracle_span_tree(method):
    """The oracles share the decodes and the edge masks; their rendezvous
    runs in the root."""
    c1, c2, frames = _rig(7)
    mark = _mark()
    _merge(c1, c2, frames, method=method, search_iters=4)
    spans = [s for s in obs.snapshot().spans if s.id > mark]
    assert _tree(spans) == [("scan", _leaves("merge.decode", "merge.decode", "merge.edges"))]
