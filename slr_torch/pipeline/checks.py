"""Runtime value checks (port of ``slr/pipeline/checks.py``).

- ``checked_reconstruct``: reconstruction followed by the reference's
  checks (no non-finite point under the mask, the mask not nearly empty),
  read to the host in one transfer; returns an error object and the cloud
  instead of a broken cloud in silence;
- ``validate_cloud``: the same checks on a cloud already reconstructed;
- ``nan_guard``: a context manager under which an operation that produces
  a NaN raises ``FloatingPointError``, the counterpart of
  ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.pipeline.reconstruct import reconstruct_dense, reconstruct_scan


class CheckError:
    """The outcome of a check: ``get()`` is None when every check passed,
    else the first failure's message; ``throw()`` raises it."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise RuntimeError(self._message)


# allocations whose uninitialised contents are no operation's result
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _has_nan(tensors) -> bool:
    return any(t.is_floating_point() and bool(torch.isnan(t).any()) for t in tensors)


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = [t for t in tree_flatten((args, kwargs))[0] if torch.is_tensor(t)]
        # read before the call, which may write its inputs in place
        had_nan = _has_nan(inputs)
        out = func(*args, **kwargs)
        if (not had_nan and func.overloadpacket not in _ALLOCATIONS
                and _has_nan(t for t in tree_flatten(out)[0] if torch.is_tensor(t))):
            raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise ``FloatingPointError`` where a torch operation inside the
    block produces a NaN from inputs free of NaN (a NaN that enters as an
    input does not count, as under ``jax_debug_nans``). Every operation's
    inputs and outputs are read on the host, so it is a debugging tool, not
    a production gate. It sees torch operations only: a kernel launched
    through ctypes (K1 writes NaN points for invalid pixels on purpose) is
    not a torch operation and is not seen, nor are the allocations its
    wrapper makes; torch operations reading its outputs see NaN inputs.
    Leaving the block restores the previous state."""
    with _NanGuard():
        yield


def _cloud_checks(points, mask, min_valid_fraction: float) -> CheckError:
    """The reference's two checks on a cloud, read in one transfer."""
    pts_ok = torch.isfinite(torch.where(mask[..., None], points, 0.0)).all()
    fill = mask.to(torch.float32).mean()
    ok, fill = torch.stack([pts_ok.to(torch.float32), fill]).tolist()
    if not ok:
        return CheckError("non-finite points in masked region")
    if not fill >= min_valid_fraction:
        return CheckError(f"decoded mask nearly empty: fill={fill} (shadowed scan, bad "
                          "thresholds, or wrong pattern config)")
    return CheckError()


def checked_reconstruct(frames, cam, proj, cfg: PatternConfig,
                        dec: DecodeConfig = DecodeConfig(),
                        rec: ReconstructConfig = ReconstructConfig(),
                        min_valid_fraction: float = 0.01,
                        fused: bool = True,
                        spatial_iters: int = 0):
    """Reconstruction with the checks on its cloud.

    Guards the production path: when K1 serves the pattern (multifreq, or
    inverse patterns with phase steps) and ``fused`` is left on, it checks
    ``reconstruct_dense``; else ``reconstruct_scan``. Returns (err, cloud);
    ``err.throw()`` raises, ``err.get()`` gives the message or None.
    """
    kernel_ok = cfg.coding == "multifreq" or (cfg.use_inverse and cfg.phase_steps > 0)
    if fused and kernel_ok:
        cloud = reconstruct_dense(frames, cam, proj, cfg, dec, rec,
                                  spatial_iters=spatial_iters)
    else:
        cloud = reconstruct_scan(frames, cam, proj, cfg, dec, rec)
    return _cloud_checks(cloud.points, cloud.mask, min_valid_fraction), cloud


def validate_cloud(cloud, min_valid_fraction: float = 0.01) -> CheckError:
    """The checks on an already reconstructed cloud (the session's gate)."""
    return _cloud_checks(cloud.points, cloud.mask, min_valid_fraction)
