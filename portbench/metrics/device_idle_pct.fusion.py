"""The share of the slice's unprofiled wall in which nothing ran on the card,
over the whole fused-model job: ``device_idle_pct.scan``'s reader."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("device_idle_pct.scan.py")).read
