"""Monotone-crossing interpolation on the card: kernels K6 and K7.

Port of ``slr/kernels/crossing.py``. Along each row of a decoded map the
projector code is a (noisy) monotone sequence; the two-camera merge needs
its inverse on the integer projector grid: for every integer code k, the
sub-pixel position where the code crosses k, and any other per-pixel
quantity linearly interpolated there. A pair (u, u + 1) with codes
lo <= k < hi crosses bin k, and any channel q is affine in k along it:

    q*(k) = q[u] + (k - lo) * g = a + k * g,  g = (q[u + 1] - q[u]) / d

so each pair carries a payload of per-channel (a, g) (or one nearest
value), bins sum the payloads of their crossings, and q*(k) =
(A + k * B) / cnt, averaged over the crossings of a noisy wiggle.

- K6, ``crossing_bin_sum``: the bare per-bin sum of a payload given as
  (R, N, U) float32, pair axis innermost, into (R, N, K).
- K7, ``crossing_interp_fused``: pair build, per-bin sums and the
  interpolation of one row in one launch.

Both live in ``csrc/crossing.cu``. Their plain versions are
``crossing_bin_sum_reference`` (the reference's one-hot, chunked over
bins, each bin summed in ascending pair order as the kernels sum it) and
``crossing_interp_fused_reference`` (payload build, plain contraction and
unpack, with the carried-channel ``gates`` as a pair veto:
``crossing_interp(..., pair_gate=...)``). The payload is plain float32: per
interpolated channel (a, g), per nearest channel one term, plus the count,
so N = 7 for ``invert_to_projector``'s layout. The TPU's bf16 3-split, its
bf16 storage of nearest channels, the 8-channel and 128-lane padding and
the activity table do not exist here; the tiling knobs (``utile``,
``usub``, ``ksub``, ``ktile``, ``rt``) are accepted for signature parity
and ignored. The sums are float32 adds, no matrix product.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; ``crossing_bin_sum.launches`` and
``crossing_interp_fused.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slr_torch.kernels.build import load_library

MAX_CHANNELS = 8     # SLR_XING_MAX_C in csrc/crossing.cu
MAX_GATES = 8        # SLR_XING_MAX_GATES
SMEM_MAX = 232448    # shared memory a block may use on Hopper


def _fma(a, b, c):
    """a * b + c rounded once to float32 from the exact product: the
    single-precision FMA into which XLA contracts the reference's
    ``lo - cl * g`` and ``A + k * B``. The exact product of two float32
    fits a float64, so this is the float64 sum rounded to float32; it
    differs from a true FMA only where the float64 sum lands on a float32
    rounding tie. K6 and K7 compute it the same way."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(
        torch.float32)


def build_payload(pair_valid, code_lo, channels_lo, channels_hi, d, interp: tuple):
    """Pack the crossing payload: term 0 = pair validity (the count), then
    per channel (a, g) (linear interpolation) or its left value (nearest).

    Returns (payload (R, N, U) float32, pair axis innermost, and unpack)
    where unpack(out (R, N, K), kgrid) -> (cnt, [vals...])."""
    terms = [pair_valid.to(torch.float32)]
    layout = []
    d_safe = torch.where(pair_valid, d, 1.0)
    for c in range(channels_lo.shape[0]):
        layout.append(("interp" if interp[c] else "nearest", len(terms)))
        if interp[c]:
            g = (channels_hi[c] - channels_lo[c]) / d_safe
            a = _fma(-code_lo, g, channels_lo[c])
            terms += [torch.where(pair_valid, a, 0.0), torch.where(pair_valid, g, 0.0)]
        else:
            terms.append(torch.where(pair_valid, channels_lo[c], 0.0))
    payload = torch.stack(terms, dim=1)

    def unpack(out, kgrid):
        cnt = out[:, 0, :]
        safe = torch.clamp(cnt, min=1e-9)
        vals = [_fma(kgrid, out[:, i0 + 1], out[:, i0]) / safe if kind == "interp"
                else out[:, i0] / safe for kind, i0 in layout]
        return cnt, vals

    return payload, unpack


def crossing_bin_sum_reference(code_lo, code_hi, payload, num_bins: int,
                               chunk: int = 128):
    """K6's plain version, ``chunk`` bins at a time: the one-hot of the
    pairs that cross each bin, and each bin's crossings added in ascending
    pair order, the kernels' order. The running count of the one-hot along
    the pairs is exact (integers), so the j-th crossing of a bin is the
    first pair where it reaches j; the j-th crossings are added, one float32
    add a bin, for j = 1, 2, ... in turn. So K6 and K7 equal it bit for bit
    however many crossings a bin has."""
    R, U = code_lo.shape
    N = payload.shape[1]
    payload = payload.to(torch.float32)
    outs = [torch.zeros((R, N, 0), device=payload.device)]
    for k0 in range(0, num_bins, chunk):
        k = torch.arange(k0, min(k0 + chunk, num_bins), dtype=torch.float32,
                         device=payload.device)[None, :, None]
        fire = (code_lo[:, None, :] <= k) & (code_hi[:, None, :] > k)      # (R, kc, U)
        rank = torch.cumsum(fire, dim=2, dtype=torch.int32)
        count = rank[:, :, -1]
        n_max = int(count.max()) if count.numel() else 0
        js = torch.arange(1, n_max + 1, dtype=torch.int32, device=payload.device)
        u_j = torch.searchsorted(rank, js.expand(R, k.shape[1], n_max).contiguous())
        u_j = u_j.clamp(max=U - 1)
        acc = torch.zeros((R, N, k.shape[1]), device=payload.device)
        for j in range(n_max):
            term = torch.gather(payload, 2, u_j[:, None, :, j].expand(R, N, -1))
            acc = torch.where((count > j)[:, None, :], acc + term, acc)
        outs.append(acc)
    return torch.cat(outs, dim=2)


@functools.cache
def library() -> ctypes.CDLL:
    """``csrc/crossing.cu`` (K6 and K7), built and typed on first use."""
    lib = load_library("crossing")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slr_crossing_bin_sum.argtypes = [ptr] * 3 + [i32] * 4 + [ptr, i32, ptr]
    lib.slr_crossing_interp_fused.argtypes = ([ptr] * 3 + [i32] * 6 + [ptr] * 2
                                              + [f32] * 2 + [ptr] * 2 + [i32, ptr])
    lib.slr_crossing_launch_shape.argtypes = [i32] * 7 + [ptr] * 2
    for fn in (lib.slr_crossing_bin_sum, lib.slr_crossing_interp_fused,
               lib.slr_crossing_launch_shape):
        fn.restype = ctypes.c_int
    lib.slr_bin_sum_smem.argtypes = [i32] * 2
    lib.slr_interp_fused_smem.argtypes = [i32] * 3
    for fn in (lib.slr_bin_sum_smem, lib.slr_interp_fused_smem):
        fn.restype = ctypes.c_longlong
    lib.slr_cuda_error_string.argtypes = [i32]
    lib.slr_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _gate_arrays(gates: tuple):
    """K7's gate channels and thresholds as C arrays, built once per gates."""
    ch = (ctypes.c_int * MAX_GATES)(*(c for c, _ in gates))
    thr = (ctypes.c_float * MAX_GATES)(*(t for _, t in gates))
    return ch, thr


def _check(what: str, want):
    """Every (tensor, shape, dtype): contiguous, of that shape and type, on
    the first tensor's CUDA device."""
    first = want[0][0]
    if not first.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got {first.device}")
    index = first.get_device()
    for x, shape, dtype in want:
        if (x.shape != shape or x.dtype != dtype or x.get_device() != index
                or not x.is_contiguous()):
            raise ValueError(f"{what}: expected a contiguous {dtype} tensor of shape "
                             f"{shape} on {first.device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device} (contiguous: {x.is_contiguous()})")


def _raise_on(lib, name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.slr_cuda_error_string(err).decode())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_shape(kernel: str, R: int, U: int, n: int, num_bins: int,
                 interp: tuple = ()) -> tuple:
    """(grid, blocks an SM) that a launch of ``kernel`` ("K6": ``n``
    payload rows of U pairs; "K7": ``n`` channels of U codes, ``interp``)
    takes on the current CUDA device."""
    lib = library()
    grid, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    mask = sum(1 << c for c, i in enumerate(interp) if i)
    _raise_on(lib, f"{kernel} launch shape", lib.slr_crossing_launch_shape(
        {"K6": 6, "K7": 7}[kernel], R, U, n, num_bins, mask, torch.cuda.current_device(),
        ctypes.byref(grid), ctypes.byref(per_sm)))
    return grid.value, per_sm.value


def launch_bin_sum(code_lo, code_hi, payload, num_bins: int):
    """K6, one launch. Returns (R, N, num_bins) float32."""
    R, U = code_lo.shape
    N = payload.shape[1]
    f32 = torch.float32
    _check("K6", [(code_lo, (R, U), f32), (code_hi, (R, U), f32),
                  (payload, (R, N, U), f32)])
    lib = library()
    if lib.slr_bin_sum_smem(U, num_bins) > SMEM_MAX:
        raise ValueError(f"K6: {U} pairs a row exceed one block's shared memory")
    out = torch.empty((R, N, num_bins), device=payload.device)
    _raise_on(lib, "K6 crossing_bin_sum", lib.slr_crossing_bin_sum(
        code_lo.data_ptr(), code_hi.data_ptr(), payload.data_ptr(), R, U, N,
        num_bins, out.data_ptr(), payload.device.index, _stream(payload)))
    crossing_bin_sum.launches += 1
    return out


def crossing_bin_sum(code_lo, code_hi, payload, num_bins: int, utile=None, rt=None,
                     usub=None, ksub=None, ktile=None):
    """out[r, n, k] = sum_u [code_lo[r, u] <= k < code_hi[r, u]] payload[r, n, u]
    for the integer bins k in [0, num_bins). Invalid pairs must arrive with
    code_lo == code_hi (they never fire) and zero payload. code_lo/hi
    (R, U) float32, payload (R, N, U) float32 -> (R, N, num_bins) float32.
    A CPU tensor takes the plain version, a CUDA tensor launches K6. The
    tiling knobs are ignored."""
    if payload.device.type == "cpu":
        return crossing_bin_sum_reference(code_lo, code_hi, payload, num_bins)
    return launch_bin_sum(code_lo, code_hi, payload, num_bins)


def crossing_pairs(code, valid, channels, interp: tuple, dmin: float = 0.125,
                   dmax: float = 4.0, pair_gate=None):
    """``crossing_interp``'s pairs as K6 takes them: (lo, hi, payload,
    unpack), with lo == hi == -1 and a zero payload where a pair is
    invalid; lo, hi (R, U - 1) and payload (R, N, U - 1) contiguous (K6
    reads rows as contiguous; a transposed code map, the merge's pass 2,
    would leave them transposed)."""
    code = code.to(torch.float32)
    cl, ch = code[:, :-1], code[:, 1:]
    d = ch - cl
    pv = valid[:, :-1] & valid[:, 1:] & (d > dmin) & (d < dmax)
    if pair_gate is not None:
        pv = pv & pair_gate
    payload, unpack = build_payload(pv, cl, channels[:, :, :-1], channels[:, :, 1:],
                                    d, interp)
    return (torch.where(pv, cl, -1.0).contiguous(), torch.where(pv, ch, -1.0).contiguous(),
            payload.contiguous(), unpack)


def crossing_interp(code, valid, channels, num_bins: int, interp: tuple,
                    dmin: float = 0.125, dmax: float = 4.0, use_kernel: bool = True,
                    pair_gate=None):
    """Invert a per-row monotone code sequence onto the integer bin grid.

    code (R, U) float32; valid (R, U) bool; channels (C, R, U) float32 to
    carry to the crossings; ``interp`` per channel: linear interpolation at
    the crossing, or the left pixel's value. A pair (u, u + 1) counts only
    when both pixels are valid and its code step d lies in (dmin, dmax), and
    where ``pair_gate`` (R, U - 1) bool, if given, allows it.

    Returns (cnt (R, K), vals (C, R, K)): crossings per bin, and each
    channel interpolated there (averaged over several crossings, 0 where
    there is none). ``use_kernel``: the contraction through
    ``crossing_bin_sum`` (K6 on a CUDA tensor), else its plain version.
    """
    lo, hi, payload, unpack = crossing_pairs(code, valid, channels, interp, dmin, dmax,
                                             pair_gate)
    bin_sum = crossing_bin_sum if use_kernel else crossing_bin_sum_reference
    out = bin_sum(lo, hi, payload, num_bins)
    kgrid = torch.arange(num_bins, dtype=torch.float32, device=code.device)[None, :]
    cnt, vals = unpack(out, kgrid)
    return cnt, torch.stack(vals)


def gate_mask(channels, gates: tuple):
    """(R, U - 1) bool: the pairs whose carried channels c step less than
    their max jump, for every (c, max_jump) of ``gates``; None if none."""
    mask = None
    for c, thr in gates:
        q = channels[c]
        ok = (q[:, 1:] - q[:, :-1]).abs() < thr
        mask = ok if mask is None else mask & ok
    return mask


def crossing_interp_fused_reference(code, valid, channels, num_bins: int,
                                    interp: tuple, gates: tuple = (),
                                    dmin: float = 0.125, dmax: float = 4.0):
    """K7's plain version: ``crossing_interp``'s plain route with the
    carried-channel ``gates`` as its pair veto."""
    return crossing_interp(code, valid, channels, num_bins, interp, dmin, dmax,
                           use_kernel=False, pair_gate=gate_mask(channels, gates))


def launch_interp_fused(code, valid, channels, num_bins: int, interp: tuple,
                        gates: tuple = (), dmin: float = 0.125, dmax: float = 4.0):
    """K7, one launch. Returns (cnt (R, K), vals (C, R, K)) float32."""
    R, U = code.shape
    C = channels.shape[0]
    _check("K7", [(code, (R, U), torch.float32), (valid, (R, U), torch.bool),
                  (channels, (C, R, U), torch.float32)])
    if len(interp) != C or C > MAX_CHANNELS or len(gates) > MAX_GATES or U < 2:
        raise ValueError(f"K7: {C} channels, interp {interp}, {len(gates)} gates, "
                         f"{U} codes a row")
    lib = library()
    if lib.slr_interp_fused_smem(U, C, num_bins) > SMEM_MAX:
        raise ValueError(f"K7: a row of {U} codes exceeds one block's shared memory; "
                         "take crossing_interp's tiled route")
    out = torch.empty((1 + C, R, num_bins), device=code.device)
    cnt, vals = out[0], out[1:]
    gate_ch, gate_thr = _gate_arrays(tuple(gates))
    mask = sum(1 << c for c, i in enumerate(interp) if i)
    _raise_on(lib, "K7 crossing_interp_fused", lib.slr_crossing_interp_fused(
        code.data_ptr(), valid.data_ptr(), channels.data_ptr(), R, U, C, num_bins,
        mask, len(gates), ctypes.addressof(gate_ch), ctypes.addressof(gate_thr), dmin,
        dmax, cnt.data_ptr(), vals.data_ptr(), code.device.index, _stream(code)))
    crossing_interp_fused.launches += 1
    return cnt, vals


def crossing_interp_fused(code, valid, channels, num_bins: int, interp: tuple,
                          gates: tuple = (), dmin: float = 0.125, dmax: float = 4.0,
                          rt=None):
    """``crossing_interp`` in one kernel (K7): pair build, per-bin sums and
    interpolation of each row in one block. ``gates``: (channel, max_jump)
    continuity vetoes on carried channels, the fused form of
    ``crossing_interp``'s ``pair_gate``. A CPU tensor takes the plain
    version; a CUDA tensor launches K7, which needs contiguous inputs and
    a whole row in one block's shared memory. Returns (cnt (R, K), vals
    (C, R, K)). ``rt`` is ignored."""
    if code.device.type == "cpu":
        return crossing_interp_fused_reference(code, valid, channels, num_bins,
                                               interp, gates, dmin, dmax)
    if code.dtype != torch.float32:
        code = code.to(torch.float32)
    return launch_interp_fused(code, valid, channels, num_bins, interp, gates, dmin, dmax)


crossing_bin_sum.launches = 0
crossing_interp_fused.launches = 0
