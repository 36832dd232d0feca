"""The share of the device's idle time in which the host was in the
program's own work, over the whole fused-model job:
``idle_in_program_pct.scan``'s reader."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("idle_in_program_pct.scan.py")).read
