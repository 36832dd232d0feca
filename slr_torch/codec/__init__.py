"""slr_torch.codec — Gray-code + phase-shift and multi-frequency pattern
generation, the unfused per-pixel decode, exposure-bracket fusion and phase
unwrapping, temporal and spatial (port of ``slr.codec``)."""

from slr_torch.codec.exposure import decode_multi_exposure
from slr_torch.codec.graycode import (
    decode_gray,
    generate_gray_patterns,
    gray_decode_int,
    gray_encode,
)
from slr_torch.codec.multifreq import (
    decode_multifreq,
    default_pitches,
    generate_multifreq_stack,
)
from slr_torch.codec.patterns import decode_stack, generate_pattern_stack
from slr_torch.codec.phaseshift import decode_phase, generate_phase_patterns
from slr_torch.codec.unwrap import (
    propagation_step,
    quality_guided_repair,
    quality_guided_unwrap,
    spatial_quality_unwrap,
    unwrap_temporal,
)
