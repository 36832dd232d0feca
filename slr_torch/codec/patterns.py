"""Full pattern-stack assembly and decoding (port of ``slr/codec/patterns.py``).

Frame-stack layout:

    0: all-white, 1: all-black,
    2 .. 2+B-1:       column Gray-code patterns (MSB first),
    2+B .. 2+2B-1:    their inverses            (if use_inverse),
    [row Gray codes + inverses, if row_gray_bits > 0]
    last N:           phase-shift fringes k = 0..N-1.

``coding="multifreq"`` is white, black and then ``phase_steps`` fringes for
each pitch of ``cfg.mf_pitches`` (``slr_torch.codec.multifreq``).

``decode_stack`` is the unfused per-pixel decode; the fused kernel
(``slr_torch.kernels.fused_scan``) is held to it by the tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slr_torch.codec.graycode import decode_gray, generate_gray_patterns
from slr_torch.codec.multifreq import decode_multifreq, generate_multifreq_stack
from slr_torch.codec.phaseshift import TWO_PI, decode_phase, generate_phase_patterns
from slr_torch.codec.unwrap import unwrap_temporal
from slr_torch.config import DecodeConfig, PatternConfig


class DecodeResult(NamedTuple):
    x_p: torch.Tensor          # (H,W) sub-pixel projector column
    y_p: Optional[torch.Tensor]  # (H,W) projector row (None if not coded)
    mask: torch.Tensor         # (H,W) bool valid-pixel mask
    quality: torch.Tensor      # (H,W) phase modulation B (or contrast)


def generate_pattern_stack(cfg: PatternConfig, device="cpu"):
    """(num_frames, proj_height, proj_width) float32 in [0,1]."""
    W, H = cfg.proj_width, cfg.proj_height
    if cfg.coding == "multifreq":
        stack = generate_multifreq_stack(W, H, cfg.mf_pitches,
                                         steps=cfg.phase_steps, device=device)
        assert stack.shape[0] == cfg.num_frames, (stack.shape, cfg.num_frames)
        return stack
    frames = [torch.ones((1, H, W), device=device),
              torch.zeros((1, H, W), device=device)]

    col = generate_gray_patterns(W, cfg.gray_bits, half_shift=cfg.phase_steps > 0,
                                 antialias=True, device=device)
    col_imgs = col[:, None, :].expand(cfg.gray_bits, H, W)
    frames.append(col_imgs)
    if cfg.use_inverse:
        frames.append(1.0 - col_imgs)

    if cfg.row_gray_bits:
        row = generate_gray_patterns(H, cfg.row_gray_bits,
                                     half_shift=cfg.row_phase_steps > 0,
                                     antialias=True, device=device)
        row_imgs = row[:, :, None].expand(cfg.row_gray_bits, H, W)
        frames.append(row_imgs)
        if cfg.use_inverse:
            frames.append(1.0 - row_imgs)

    if cfg.phase_steps:
        ph = generate_phase_patterns(W, cfg.fringe_pitch, cfg.phase_steps,
                                     device=device)
        frames.append(ph[:, None, :].expand(cfg.phase_steps, H, W))

    if cfg.row_phase_steps:
        rp = generate_phase_patterns(H, cfg.row_fringe_pitch,
                                     cfg.row_phase_steps, device=device)
        frames.append(rp[:, :, None].expand(cfg.row_phase_steps, H, W))

    stack = torch.cat(frames, dim=0)
    assert stack.shape[0] == cfg.num_frames, (stack.shape, cfg.num_frames)
    return stack


def _slices(cfg: PatternConfig):
    """Frame-index bookkeeping for the stack layout above."""
    i = 2
    s = {"white": 0, "black": 1}
    s["col"] = (i, i + cfg.gray_bits); i += cfg.gray_bits
    if cfg.use_inverse:
        s["col_inv"] = (i, i + cfg.gray_bits); i += cfg.gray_bits
    if cfg.row_gray_bits:
        s["row"] = (i, i + cfg.row_gray_bits); i += cfg.row_gray_bits
        if cfg.use_inverse:
            s["row_inv"] = (i, i + cfg.row_gray_bits); i += cfg.row_gray_bits
    if cfg.phase_steps:
        s["phase"] = (i, i + cfg.phase_steps); i += cfg.phase_steps
    if cfg.row_phase_steps:
        s["row_phase"] = (i, i + cfg.row_phase_steps); i += cfg.row_phase_steps
    assert i == cfg.num_frames
    return s


def decode_stack(frames, cfg: PatternConfig, dec: DecodeConfig,
                 bit_depth: int | None = None) -> DecodeResult:
    """Captured (F,H,W) stack -> sub-pixel projector coords + mask + quality.

    Accepts float32 frames in [0,1] or raw integer camera frames, which are
    normalized to [0,1] by the ADC range (``bit_depth`` bits, default the
    container's full range) so thresholds keep one meaning.
    """
    if not frames.is_floating_point():
        m = ((1 << bit_depth) - 1 if bit_depth is not None
             else torch.iinfo(frames.dtype).max)
        frames = frames.to(torch.float32) / float(m)
    if cfg.coding == "multifreq":
        x_p, mask, quality = decode_multifreq(
            frames, cfg.mf_pitches, steps=cfg.phase_steps,
            black_threshold=dec.black_threshold,
            modulation_threshold=dec.modulation_threshold)
        return DecodeResult(x_p=x_p, y_p=None, mask=mask, quality=quality)
    s = _slices(cfg)
    white, black = frames[s["white"]], frames[s["black"]]

    def inverse_or_mid(key, pat):
        if cfg.use_inverse:
            a, b = s[key]
            return frames[a:b]
        return 0.5 * (white + black)[None] * torch.ones_like(pat)

    a, b = s["col"]
    col_pat = frames[a:b]
    code, mask = decode_gray(
        col_pat, inverse_or_mid("col_inv", col_pat), white, black,
        cfg.gray_bits, dec.black_threshold, dec.white_threshold,
    )

    if cfg.phase_steps:
        pa, pb = s["phase"]
        phi, modulation = decode_phase(frames[pa:pb], cfg.phase_steps)
        mask = mask & (modulation > dec.modulation_threshold)
        Phi = unwrap_temporal(phi, code, cfg.gray_bits, half_shifted=True)
        x_p = Phi * cfg.fringe_pitch / TWO_PI
        # the half-shifted code is cyclic with period == coded width, so the
        # coordinate is recovered modulo W_coded; wrap the top edge back
        w_coded = cfg.fringe_pitch * (1 << cfg.gray_bits)
        x_p = torch.where(x_p > w_coded - 0.5, x_p - w_coded, x_p)
        quality = modulation
    else:
        # Gray-code only: stripe centre, half-stripe resolution
        x_p = (code.to(torch.float32) + 0.5) * cfg.fringe_pitch
        quality = white - black

    y_p = None
    if cfg.row_gray_bits:
        ra, rb = s["row"]
        row_pat = frames[ra:rb]
        row_code, row_mask = decode_gray(
            row_pat, inverse_or_mid("row_inv", row_pat), white, black,
            cfg.row_gray_bits, dec.black_threshold, dec.white_threshold,
        )
        mask = mask & row_mask
        if cfg.row_phase_steps:
            rpa, rpb = s["row_phase"]
            rphi, rmod = decode_phase(frames[rpa:rpb], cfg.row_phase_steps)
            mask = mask & (rmod > dec.modulation_threshold)
            rPhi = unwrap_temporal(rphi, row_code, cfg.row_gray_bits,
                                   half_shifted=True)
            y_p = rPhi * cfg.row_fringe_pitch / TWO_PI
            h_coded = cfg.row_fringe_pitch * (1 << cfg.row_gray_bits)
            y_p = torch.where(y_p > h_coded - 0.5, y_p - h_coded, y_p)
        else:
            y_p = (row_code.to(torch.float32) + 0.5) * cfg.row_fringe_pitch

    return DecodeResult(x_p=x_p, y_p=y_p, mask=mask, quality=quality)
