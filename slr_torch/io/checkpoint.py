"""Stage checkpoints (port of ``slr/io/checkpoint.py``).

Every stage of a session is a file, so any stage re-runs from disk:
decoded maps and clouds as .npz, and the bundle adjustment's iteration
state (poses, landmarks, iteration, cost). Arrays are saved from tensors
(any device) or numpy, and load back as numpy: the caller puts them on its
device.
"""

from __future__ import annotations

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_stage(path, **arrays):
    """Save named arrays (tensors or numpy) as one compressed .npz stage file."""
    np.savez_compressed(path, **{k: as_numpy(v) for k, v in arrays.items()})


def load_stage(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def peek_stage(path) -> dict:
    """Array names -> shapes without decompressing the data: reads only the
    .npy headers inside the zip, so a route decision (is scan 0 an exposure
    bracket?) does not load a 100 MB stack."""
    import zipfile

    from numpy.lib import format as npformat

    # the public header readers, by the format's magic version
    readers = {
        (1, 0): npformat.read_array_header_1_0,
        (2, 0): npformat.read_array_header_2_0,
    }
    out = {}
    with zipfile.ZipFile(path) as z:
        for n in z.namelist():
            with z.open(n) as f:
                version = npformat.read_magic(f)
                reader = readers.get(version)
                if reader is None:  # unknown format: pay the full load
                    with z.open(n) as f2:
                        shape = np.load(f2, allow_pickle=False).shape
                else:
                    shape, _, _ = reader(f)
                out[n[:-4] if n.endswith(".npy") else n] = shape
    return out


def save_ba_state(path, R, t, X, iteration: int, cost: float):
    save_stage(
        path, R=R, t=t, X=X,
        iteration=np.asarray(iteration), cost=np.asarray(cost),
    )


def load_ba_state(path):
    d = load_stage(path)
    return d["R"], d["t"], d["X"], int(d["iteration"]), float(d["cost"])
