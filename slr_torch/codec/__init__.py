"""slr_torch.codec — Gray-code + phase-shift pattern generation and the
unfused per-pixel decode (port of ``slr.codec``, gray_phase coding)."""

from slr_torch.codec.graycode import (
    decode_gray,
    generate_gray_patterns,
    gray_decode_int,
    gray_encode,
)
from slr_torch.codec.patterns import decode_stack, generate_pattern_stack
from slr_torch.codec.phaseshift import decode_phase, generate_phase_patterns
from slr_torch.codec.unwrap import unwrap_temporal
