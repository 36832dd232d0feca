"""slr_torch.synth — the config-3 subset of the synthetic virtual scanner
(port of ``slr.synth``)."""

from slr_torch.synth.render import RenderedScan, default_rig, render_scan
from slr_torch.synth.scene import bumps_depth
