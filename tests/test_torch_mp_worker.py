"""Ranks of the port's multi-process tests (``tests/test_torch_dist.py``,
``tests/test_torch_dist_product.py``). It defines no tests.

``run_world(n, workdir, cases)`` writes nothing itself: the test puts its
numpy inputs in ``<workdir>/inputs.npz`` and its settings in
``<workdir>/params.json``, then this starts ``n`` ranks, each
``python tests/test_torch_mp_worker.py <rank> <n> <workdir> <cases>``. A
rank takes one torch thread, joins a Gloo process group through a file
store under ``workdir`` (no port, so parallel test workers never collide),
runs the named cases in order (every rank the same, as SPMD needs) and
writes each case's result to ``<workdir>/<case>.rank<r>.pt``. A world that
outlives its timeout is killed and the test fails. Imports neither ``jax``
nor ``slr``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 150


def run_world(n: int, workdir, cases, timeout: float = TIMEOUT_S) -> list:
    """Runs ``cases`` in a world of ``n`` ranks; returns each rank's
    results, a dict {case: result} per rank."""
    import torch

    workdir = Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "wb") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(n), str(workdir),
                               ",".join(cases)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=REPO) for r in range(n)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"a world of {n} ranks outlived {timeout} s:\n" + _tails(workdir, n))
    finally:
        for f in logs:
            f.close()
    if any(p.returncode for p in procs):
        raise AssertionError(f"ranks exited {[p.returncode for p in procs]}:\n"
                             + _tails(workdir, n))
    return [{c: torch.load(workdir / f"{c}.rank{r}.pt") for c in cases} for r in range(n)]


def _tails(workdir, n):
    return "\n".join(f"--- rank {r}\n" + (Path(workdir) / f"rank{r}.log").read_text()[-3000:]
                     for r in range(n))


# --- the cases, run in every rank ---------------------------------------------


def _camera(inp, prefix):
    import torch

    from slr_torch.geom.camera import Camera

    return Camera(*(torch.from_numpy(inp[f"{prefix}_{f}"]) for f in Camera._fields))


def _t(inp, name):
    import torch

    return torch.from_numpy(inp[name])


def case_mesh(rank, n, inp, prm):
    from slr_torch.dist import make_mesh

    out = {}
    for name, kw in (("default", {}), ("tiles_only", dict(pixel_tiles=n // 2 or 1)),
                     ("blocks_only", dict(map_blocks=n // 2 or 1)),
                     ("all_blocks", dict(pixel_tiles=1, map_blocks=n))):
        m = make_mesh(**kw)
        out[name] = (dict(m.shape), dict(m.coords))
    errors = []
    for kw in (dict(pixel_tiles=n, map_blocks=2), dict(pixel_tiles=1, map_blocks=1)):
        try:
            make_mesh(**kw)
            errors.append(None)
        except (AssertionError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    out["errors"] = errors
    return out


def case_halo(rank, n, inp, prm):
    from slr_torch.dist import comm, halo_exchange_rows, make_mesh

    mesh = make_mesh(pixel_tiles=n)
    x = _t(inp, "halo_x")
    rows = x.shape[0] // n
    x_l = x[rank * rows:(rank + 1) * rows]
    comm.reset()
    out = {h: halo_exchange_rows(x_l, mesh, "pixel_tile", h) for h in (1, 2)}
    out["ring_calls"] = comm.calls["ring"]
    out["ring_bytes"] = comm.sent_bytes["ring"]
    return out


def case_unwrap(rank, n, inp, prm):
    from slr_torch.dist import comm, make_mesh, sharded_unwrap

    mesh = make_mesh(pixel_tiles=prm["unwrap_tiles"])
    Phi, q, mask = _t(inp, "uw_phi"), _t(inp, "uw_q"), _t(inp, "uw_mask")
    out = {}
    for ee in prm["exchange_every"]:
        comm.reset()
        out[ee] = sharded_unwrap(Phi, q, mask, mesh, iters=prm["unwrap_iters"],
                                 exchange_every=ee)
        out[f"ring_calls_{ee}"] = comm.calls["ring"]
    return out


def case_reconstruct(rank, n, inp, prm):
    from slr_torch.config import DecodeConfig, PatternConfig
    from slr_torch.dist import comm, make_mesh, sharded_reconstruct

    mesh = make_mesh(pixel_tiles=n)
    cfg = PatternConfig(**prm["pattern"])
    frames = _t(inp, "frames")
    cam, proj = _camera(inp, "cam"), _camera(inp, "proj")
    out = {}
    for it in prm["spatial_iters"]:
        comm.reset()
        out[it] = sharded_reconstruct(frames, cam, proj, cfg, DecodeConfig(), mesh,
                                      spatial_iters=it)
        out[f"ring_calls_{it}"] = comm.calls["ring"]
    return out


def _ba_args(inp):
    return [_t(inp, k) for k in ("ba_R0", "ba_t0", "ba_X0", "ba_s", "ba_p", "ba_w")]


def case_ba(rank, n, inp, prm):
    from slr_torch.dist import comm, distributed_bundle_adjust, make_mesh

    layouts = [("blocks", dict(pixel_tiles=1, map_blocks=n))]
    if n == 4:
        layouts.append(("2x2", dict(pixel_tiles=2, map_blocks=2)))
    out = {}
    for name, kw in layouts:
        mesh = make_mesh(**kw)
        for rows in ("point", "plane"):
            comm.reset()
            obs_n = _t(inp, "ba_n") if rows == "plane" else None
            res = distributed_bundle_adjust(*_ba_args(inp), mesh, iters=prm["ba_iters"],
                                            huber_delta=prm["huber"], obs_n=obs_n)
            out[(name, rows)] = (tuple(res), comm.calls["all_reduce"],
                                 comm.calls["all_gather"])
    return out


def case_recovery(rank, n, inp, prm):
    from slr_torch.dist import comm, distributed_bundle_adjust, make_mesh, resume_ba
    from slr_torch.io import save_ba_state

    args = [_t(inp, k) for k in ("rc_R", "rc_t0", "rc_X0", "rc_s", "rc_p", "rc_w")]
    mesh = make_mesh(pixel_tiles=1, map_blocks=n)
    part = distributed_bundle_adjust(*args, mesh, iters=2)
    ckpt = Path(prm["workdir"]) / "ba.npz"
    comm.rank0_writes(lambda: save_ba_state(ckpt, part.R, part.t, part.X, iteration=2,
                                            cost=float(part.cost)))
    keep = _t(inp, "rc_keep")
    small = make_mesh(pixel_tiles=2, map_blocks=n // 2)
    res = resume_ba(ckpt, args[3], args[4], args[5], args[2], keep, small, iters=8)
    return tuple(res)


def case_batch(rank, n, inp, prm):
    from slr_torch.config import PatternConfig
    from slr_torch.dist import batched_reconstruct, make_mesh

    mesh = make_mesh(pixel_tiles=n // prm["batch_blocks"], map_blocks=prm["batch_blocks"])
    cam, proj = _camera(inp, "cam"), _camera(inp, "proj")
    cfg = PatternConfig(**prm["pattern"])
    batch = _t(inp, "batch")
    out = {}
    for fused in (True, False):
        out[fused] = tuple(batched_reconstruct(batch, cam, proj, cfg, mesh=mesh, fused=fused))
    try:
        batched_reconstruct(batch[:3], cam, proj, cfg, mesh=mesh)
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _clouds(inp):
    from slr_torch.pipeline.reconstruct import ScanCloud

    return [ScanCloud(*(_t(inp, f"c{s}_{f}") for f in ScanCloud._fields))
            for s in range(int(inp["n_clouds"]))]


def case_register(rank, n, inp, prm):
    import slr_torch.config as tcfg
    import slr_torch.pipeline.registerfuse as treg
    from slr_torch.dist import comm, make_mesh

    mesh = make_mesh(pixel_tiles=n // prm["reg_blocks"], map_blocks=prm["reg_blocks"])
    clouds = _clouds(inp)
    rc = tcfg.RegistrationConfig(**prm["reg"])
    comm.reset()
    reg = treg.register_scans_batched(clouds, rc, use_features=True,
                                      cam=_camera(inp, "cam"), mesh=mesh)
    gathers = comm.calls["all_gather"]
    comm.reset()
    ba = treg.ba_refine(clouds, reg, n_landmarks=prm["landmarks"], iters=4, mesh=mesh)
    return dict(reg=tuple(reg), ba=tuple(ba), gathers=gathers,
                ba_all_reduce=comm.calls["all_reduce"])


def case_session(rank, n, inp, prm):
    import slr_torch.pipeline.session as sess_mod
    from slr_torch.pipeline import Session

    writes = []
    real = sess_mod.save_stage

    def counted(path, **arrays):
        writes.append(str(path))
        real(path, **arrays)

    sess_mod.save_stage = counted
    s = Session(prm["session"], device="cpu")
    mesh = s.mesh
    shape = None if mesh is None else dict(mesh.shape)
    count = s.reconstruct_all()
    reg = s.register(use_features=True)
    clouds = [tuple(s.load_cloud(i)) for i in range(count)]
    return dict(mesh=shape, clouds=clouds, reg=tuple(reg), writes=writes)


def case_add_scan(rank, n, inp, prm):
    """Every rank opens a fresh session and adds three scans; rank 1 comes
    late to each call, after rank 0 could have written its file."""
    import time

    import torch

    from slr_torch.pipeline import Session

    frames = torch.zeros(2, 4, 6)
    time.sleep(0.5 * rank)
    s = Session(prm["add_root"], device="cpu")
    got = []
    for _ in range(3):
        time.sleep(0.5 * rank)
        got.append(s.add_scan(frames))
    return dict(indices=got, scans=len(s.scan_paths()))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main():
    rank, n, workdir, cases = (int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
                               sys.argv[4].split(","))
    import numpy as np
    import torch
    import torch.distributed as dist

    from slr_torch.dist import init_distributed

    torch.set_num_threads(1)
    store = f"file://{workdir / 'store'}"
    if n == 1:   # a real process group of one rank (init_distributed skips it)
        from datetime import timedelta

        dist.init_process_group("gloo", init_method=store, world_size=1, rank=0,
                                timeout=timedelta(seconds=TIMEOUT_S))
    else:
        init_distributed(store, n, rank, device="cpu", timeout_s=TIMEOUT_S)
    inp = dict(np.load(workdir / "inputs.npz")) if (workdir / "inputs.npz").exists() else {}
    prm = json.loads((workdir / "params.json").read_text())
    prm["workdir"] = str(workdir)
    for c in cases:
        torch.save(CASES[c](rank, n, inp, prm), workdir / f"{c}.rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
